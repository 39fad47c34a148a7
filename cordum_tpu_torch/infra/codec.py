"""The port's msgpack codec: the subset of msgpack the statebus wire, bus
packets and stored records use, carried by the package so that a worker
runs where no ``msgpack`` is installed.

* :func:`packb` gives the bytes ``msgpack.packb(obj, use_bin_type=True)``
  gives, for nil, bool, int (-2**63 .. 2**64 - 1), float (always float64),
  str, bytes (bytearray, memoryview), list and tuple (arrays) and dict
  (maps, in iteration order, any key of these types).  Subclasses of those
  types pack as their base type, as msgpack's do; anything else raises
  ``TypeError``, and an int out of range ``OverflowError``.
* :func:`unpackb` and :class:`Unpacker` read what msgpack writes, as
  ``raw=False, strict_map_key=False`` do: str as str, bin as bytes, arrays
  as lists, maps as dicts with keys of any type, float32 and float64.  An
  ext type or a reserved byte raises :class:`FormatError`.
* :func:`pack_record` and :func:`unpack_record` encode the job store's
  records (event-log entries, safety decisions, approvals) as msgpack and
  read them back, JSON records of older builds included;
  :func:`dumps_env_json` and :func:`loads_env_json` own the JSON that
  stays JSON (values embedded in worker env vars).  They write the bytes
  the reference's codec (``cordum_tpu/infra/codec.py``) writes.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Iterator, Optional

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_f = struct.Struct(">f")
_d = struct.Struct(">d")


class FormatError(ValueError):
    """The bytes are not msgpack this codec reads."""


class ExtraData(ValueError):
    """:func:`unpackb` found bytes after the object."""


class OutOfData(Exception):
    """:meth:`Unpacker.unpack` needs more bytes than were fed."""


def _pack_int(o: int, out: bytearray) -> None:
    if 0 <= o < 0x80:
        out.append(o)
    elif -0x20 <= o < 0:
        out.append(o & 0xFF)
    elif o >= 0:
        if o < 0x100:
            out += b"\xcc" + _B.pack(o)
        elif o < 0x10000:
            out += b"\xcd" + _H.pack(o)
        elif o < 0x100000000:
            out += b"\xce" + _I.pack(o)
        elif o < 0x10000000000000000:
            out += b"\xcf" + _Q.pack(o)
        else:
            raise OverflowError("Integer value out of range")
    elif o >= -0x80:
        out += b"\xd0" + _b.pack(o)
    elif o >= -0x8000:
        out += b"\xd1" + _h.pack(o)
    elif o >= -0x80000000:
        out += b"\xd2" + _i.pack(o)
    elif o >= -0x8000000000000000:
        out += b"\xd3" + _q.pack(o)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, small: int, small_max: int, codes: bytes, out: bytearray) -> None:
    """A length header: the fix form ``small | n`` below ``small_max``, else
    the 8- (if ``codes[0]``), 16- or 32-bit form."""
    if n < small_max:
        out.append(small | n)
    elif codes[0] and n < 0x100:
        out.append(codes[0])
        out.append(n)
    elif n < 0x10000:
        out.append(codes[1])
        out += _H.pack(n)
    elif n < 0x100000000:
        out.append(codes[2])
        out += _I.pack(n)
    else:
        raise ValueError("object too large for msgpack")


_STR = bytes((0xD9, 0xDA, 0xDB))
_ARRAY = bytes((0, 0xDC, 0xDD))
_MAP = bytes((0, 0xDE, 0xDF))


def _pack(o: Any, out: bytearray) -> None:
    t = type(o)
    if o is None:
        out.append(0xC0)
    elif o is True:
        out.append(0xC3)
    elif o is False:
        out.append(0xC2)
    elif t is int:
        _pack_int(o, out)
    elif t is str:
        b = o.encode("utf-8")
        _pack_len(len(b), 0xA0, 32, _STR, out)
        out += b
    elif t is float:
        out += b"\xcb" + _d.pack(o)
    elif t is dict:
        _pack_len(len(o), 0x80, 16, _MAP, out)
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    elif t is list or t is tuple:
        _pack_len(len(o), 0x90, 16, _ARRAY, out)
        for v in o:
            _pack(v, out)
    elif t is bytes or t is bytearray or t is memoryview:
        n = o.nbytes if t is memoryview else len(o)
        if n < 0x100:
            out += b"\xc4" + _B.pack(n)
        elif n < 0x10000:
            out += b"\xc5" + _H.pack(n)
        else:
            out += b"\xc6" + _I.pack(n)
        out += o
    # subclasses, in msgpack's order of checks
    elif isinstance(o, int):
        _pack_int(int(o), out)
    elif isinstance(o, float):
        out += b"\xcb" + _d.pack(o)
    elif isinstance(o, (bytes, bytearray)):
        _pack(bytes(o), out)
    elif isinstance(o, str):
        _pack(str(o), out)
    elif isinstance(o, dict):
        _pack(dict(o.items()), out)
    elif isinstance(o, (list, tuple)):
        _pack(list(o), out)
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def packb(obj: Any) -> bytes:
    """``obj`` as ``msgpack.packb(obj, use_bin_type=True)`` packs it."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _need(b: memoryview, i: int, n: int) -> None:
    if i + n > len(b):
        raise OutOfData


def _unpack(b: memoryview, i: int) -> tuple[Any, int]:
    """The object at ``b[i:]`` and the offset past it; :class:`OutOfData`
    when ``b`` ends inside it."""
    _need(b, i, 1)
    c = b[i]
    i += 1
    if c < 0x80:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0xA0 <= c < 0xC0:
        n = c & 0x1F
        _need(b, i, n)
        return str(b[i:i + n], "utf-8"), i + n
    if 0x90 <= c < 0xA0:
        return _unpack_array(b, i, c & 0x0F)
    if 0x80 <= c < 0x90:
        return _unpack_map(b, i, c & 0x0F)
    if c == 0xC0:
        return None, i
    if c == 0xC2:
        return False, i
    if c == 0xC3:
        return True, i
    if c == 0xCB:
        _need(b, i, 8)
        return _d.unpack_from(b, i)[0], i + 8
    if c == 0xCA:
        _need(b, i, 4)
        return _f.unpack_from(b, i)[0], i + 4
    fixed = _FIXED_INTS.get(c)
    if fixed is not None:
        _need(b, i, fixed.size)
        return fixed.unpack_from(b, i)[0], i + fixed.size
    sized = _SIZED.get(c)
    if sized is None:
        raise FormatError(f"msgpack type byte 0x{c:02x} is not read by this codec")
    kind, head = sized
    _need(b, i, head.size)
    n = head.unpack_from(b, i)[0]
    i += head.size
    if kind == "array":
        return _unpack_array(b, i, n)
    if kind == "map":
        return _unpack_map(b, i, n)
    _need(b, i, n)
    if kind == "str":
        return str(b[i:i + n], "utf-8"), i + n
    return bytes(b[i:i + n]), i + n


def _unpack_array(b: memoryview, i: int, n: int) -> tuple[list, int]:
    out = []
    for _ in range(n):
        v, i = _unpack(b, i)
        out.append(v)
    return out, i


def _unpack_map(b: memoryview, i: int, n: int) -> tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _unpack(b, i)
        v, i = _unpack(b, i)
        out[k] = v
    return out, i


_FIXED_INTS = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q, 0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}
_SIZED = {
    0xC4: ("bin", _B), 0xC5: ("bin", _H), 0xC6: ("bin", _I),
    0xD9: ("str", _B), 0xDA: ("str", _H), 0xDB: ("str", _I),
    0xDC: ("array", _H), 0xDD: ("array", _I),
    0xDE: ("map", _H), 0xDF: ("map", _I),
}


def unpackb(b: bytes) -> Any:
    """The one object ``b`` holds, as ``msgpack.unpackb(b, raw=False,
    strict_map_key=False)`` reads it; ``ValueError`` on incomplete input,
    :class:`ExtraData` on bytes after the object."""
    view = memoryview(b)
    try:
        obj, i = _unpack(view, 0)
    except OutOfData:
        raise ValueError("Unpack failed: incomplete input") from None
    if i < len(view):
        raise ExtraData(f"{len(view) - i} bytes after the object")
    return obj


class Unpacker:
    """Streaming reads, as ``msgpack.Unpacker(raw=False,
    strict_map_key=False)``: :meth:`feed` bytes, then iterate (stops where
    the fed bytes end inside an object) or :meth:`unpack` (raises
    :class:`OutOfData` there); :meth:`tell` is the offset past the last
    object read."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._pos = 0
        self._consumed = 0

    def feed(self, data: bytes) -> None:
        if self._pos:
            del self._buf[:self._pos]
            self._pos = 0
        self._buf += data

    def unpack(self) -> Any:
        view = memoryview(self._buf)
        try:
            obj, i = _unpack(view, self._pos)
        finally:
            view.release()
        self._consumed += i - self._pos
        self._pos = i
        return obj

    def tell(self) -> int:
        return self._consumed

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        try:
            return self.unpack()
        except OutOfData:
            raise StopIteration from None



# ---------------------------------------------------------------------------
# stored records and the env-var JSON contract
# ---------------------------------------------------------------------------

# records of older builds were json.dumps(dict): they start with one of
# these bytes (after any whitespace), which msgpack would misread
_JSON_HEADS = frozenset(b"{[\"")


def pack_record(obj: Any) -> bytes:
    """Encode a stored record (event-log entry, decision, approval)."""
    return packb(obj)


def unpack_record(b: bytes) -> Any:
    """Decode a stored record written by this build (msgpack) or an older
    one (JSON)."""
    head = b.lstrip()[:1] if b else b""
    if head and head[0] in _JSON_HEADS:
        return json.loads(b)
    return unpackb(b)


_PARSE_CACHE: dict[str, Any] = {}
_PARSE_CACHE_CAP = 256


def dumps_env_json(obj: Any, *, sort_keys: bool = False) -> str:
    """JSON for values embedded in worker env vars (CORDUM_POLICY_CONSTRAINTS
    etc.): the env contract is JSON so that non-Python workers read it."""
    return json.dumps(obj, sort_keys=sort_keys)


def loads_env_json(s: str) -> Optional[Any]:
    """Parse a JSON env-contract string, interning the result: the scheduler
    sees the same effective-config string once per job, so the parse is
    cached by the exact string.  Callers treat the returned object as
    read-only (it is shared across calls).  None on invalid JSON."""
    hit = _PARSE_CACHE.get(s)
    if hit is not None:
        return hit
    try:
        parsed = json.loads(s)
    except (ValueError, TypeError):
        return None
    if len(_PARSE_CACHE) >= _PARSE_CACHE_CAP:
        _PARSE_CACHE.clear()  # tiny cache; a wholesale reset is fine
    _PARSE_CACHE[s] = parsed
    return parsed
