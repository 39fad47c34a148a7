"""The port's msgpack codec (``cordum_tpu_torch/infra/codec.py``) against
``msgpack`` itself: byte for byte on write (``packb(obj,
use_bin_type=True)``), and as ``raw=False, strict_map_key=False`` on read,
one object at a time and streamed (``Unpacker``), both ways.

Objects are drawn with hypothesis over the types the statebus frames, bus
packets and stored records hold: nil, bool, ints of every width (negative
and uint64 included), float64, str, bin, arrays and maps with any scalar
key; and at the lengths where msgpack switches header forms.
"""
from __future__ import annotations

import enum
import math

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from cordum_tpu_torch.infra import codec

scalars = (st.none() | st.booleans()
           | st.integers(min_value=-2**63, max_value=2**64 - 1)
           | st.floats(allow_nan=True, allow_infinity=True)
           | st.text() | st.binary())
keys = (st.none() | st.booleans() | st.integers(min_value=-2**63, max_value=2**64 - 1)
        | st.floats(allow_nan=False) | st.text() | st.binary())
objects = st.recursive(
    scalars,
    lambda inner: (st.lists(inner, max_size=20) | st.tuples(inner, inner)
                   | st.dictionaries(keys, inner, max_size=20)),
    max_leaves=60,
)


def _ref_pack(obj):
    return msgpack.packb(obj, use_bin_type=True)


def _ref_unpack(b):
    return msgpack.unpackb(b, raw=False, strict_map_key=False)


@settings(max_examples=300, deadline=None)
@given(objects)
def test_packb_equals_msgpack_byte_for_byte(obj):
    assert codec.packb(obj) == _ref_pack(obj)


@settings(max_examples=300, deadline=None)
@given(objects)
def test_unpackb_reads_what_msgpack_wrote_and_msgpack_reads_ours(obj):
    wire = _ref_pack(obj)
    # NaN != NaN: compare the decoded objects by their encodings
    assert _ref_pack(codec.unpackb(wire)) == _ref_pack(_ref_unpack(wire))
    assert _ref_pack(_ref_unpack(codec.packb(obj))) == wire


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_header_forms_at_their_edges(n):
    for obj in ("x" * n, b"y" * n, list(range(n)), {i: None for i in range(n)}):
        wire = codec.packb(obj)
        assert wire == _ref_pack(obj)
        assert codec.unpackb(wire) == _ref_unpack(wire)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.0, -0.0, 1.5, math.inf, -math.inf, True, False, None,
])
def test_scalar_widths(value):
    assert codec.packb(value) == _ref_pack(value)
    assert codec.unpackb(codec.packb(value)) == value


def test_subclasses_pack_as_their_base_type():
    class Kind(enum.IntEnum):
        A = 7

    class Name(str):
        pass

    obj = {Name("k"): [Kind.A, bytearray(b"ab"), memoryview(b"cd"), (1, 2)]}
    assert codec.packb(obj) == _ref_pack(obj)


@pytest.mark.parametrize("obj, error", [
    ({1, 2}, TypeError), (object(), TypeError), (1j, TypeError),
    (2**64, OverflowError), (-2**63 - 1, OverflowError),
], ids=["set", "object", "complex", "too-big", "too-small"])
def test_anything_else_raises(obj, error):
    with pytest.raises(error):
        codec.packb(obj)
    with pytest.raises(error):
        _ref_pack(obj)


def test_unpackb_refuses_bad_input():
    with pytest.raises(ValueError, match="incomplete"):
        codec.unpackb(_ref_pack([1, 2, 3])[:-1])
    with pytest.raises(codec.ExtraData):
        codec.unpackb(_ref_pack(1) + _ref_pack(2))
    with pytest.raises(codec.FormatError):
        codec.unpackb(_ref_pack(msgpack.ExtType(5, b"xy")))
    with pytest.raises(codec.FormatError):
        codec.unpackb(b"\xc1")  # never used


@settings(max_examples=60, deadline=None)
@given(st.lists(objects, min_size=1, max_size=8), st.integers(min_value=1, max_value=7))
def test_streaming_both_ways(objs, chunk):
    """A stream of msgpack's frames fed in chunks to the port's Unpacker,
    and the port's stream fed to msgpack's: the same objects, in order,
    and ``tell`` at the stream's end."""
    ours = b"".join(codec.packb(o) for o in objs)
    assert ours == b"".join(_ref_pack(o) for o in objs)
    mine, ref = codec.Unpacker(), msgpack.Unpacker(raw=False, strict_map_key=False)
    got_mine, got_ref = [], []
    for i in range(0, len(ours), chunk):
        mine.feed(ours[i:i + chunk])
        ref.feed(ours[i:i + chunk])
        got_mine.extend(mine)
        got_ref.extend(ref)
    assert mine.tell() == ref.tell() == len(ours)
    assert [_ref_pack(o) for o in got_mine] == [_ref_pack(o) for o in objs]
    assert [_ref_pack(o) for o in got_ref] == [_ref_pack(o) for o in objs]


def test_unpacker_signals_out_of_data():
    wire = _ref_pack({"a": [1, 2, 3]})
    u = codec.Unpacker()
    u.feed(wire[:3])
    with pytest.raises(codec.OutOfData):
        u.unpack()
    assert list(u) == []
    u.feed(wire[3:])
    assert u.unpack() == {"a": [1, 2, 3]}
    assert u.tell() == len(wire)

