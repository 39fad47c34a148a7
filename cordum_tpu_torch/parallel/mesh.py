"""The mesh vocabulary of ``cordum_tpu/parallel/mesh.py``: the five axis
names and :class:`MeshSpec` with its ``resolve``.

  * ``dp`` — data parallel (batch)
  * ``tp`` — tensor/model parallel
  * ``sp`` — sequence/context parallel (long-context activations)
  * ``ep`` — expert parallel (MoE routing)
  * ``pp`` — pipeline parallel (layer stages)

A training job on one card needs no device mesh: the train step runs on the
card, and the resolved axis sizes (all 1 there) are what the job reports.

:class:`TPGroup` is the rank group of a tensor-parallel serving gang: a
``torch.distributed`` process group over the gang's ranks, built either
across processes, from a ``TCPStore`` rank 0 opens on an ephemeral port
(:func:`open_store`, :func:`connect_store`, :meth:`TPGroup.join`), or inside
one process, one gloo group a thread over a shared ``HashStore``
(:func:`in_process_groups`).  The backend is NCCL when every rank owns a
distinct CUDA card and gloo otherwise (CPU ranks, or ranks that share one
card).  The reference's ``simple_mesh`` and ``rank_mesh`` have nothing to
map onto: they build ``jax.sharding.Mesh`` objects for GSPMD, which places
arrays over the devices it sees; here each rank holds its own slices and
the sums across ranks are explicit all-reduces.

:class:`TrainMesh` is the training counterpart of the reference's
``build_mesh(MeshSpec(...))``: one rank's coordinates on the (dp, tp, sp,
ep, pp) grid, pp fastest, as ``np.array(devices).reshape(shape)`` lays the
devices out, with a world group, one group per axis line (the dp, tp,
sp, ep and pp lines through the rank) and one over the tp × ep plane
through it (the ranks that share the rank's dp, sp and pp coordinates:
the MoE layer's partial sums, its experts' and its ``d_ff`` blocks', in
one collective), built from one store as :meth:`TPGroup.join` builds its
group.  It sums, gathers and reduce-scatters over any of them, sends and
receives between pp neighbours, and shifts tensors one hop round a line
(the ring of ring attention over sp).
"""
from __future__ import annotations

import datetime
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..infra import logging as logx

AXIS_DP = "dp"
AXIS_TP = "tp"
AXIS_SP = "sp"
AXIS_EP = "ep"
AXIS_PP = "pp"


@dataclass
class MeshSpec:
    """Logical mesh shape; -1 on one axis means "absorb remaining devices"."""

    dp: int = -1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    def resolve(self, n_devices: int) -> dict[str, int]:
        """Each axis's size over ``n_devices`` devices, in the order dp, tp,
        sp, ep, pp.  Raises ``ValueError`` for an axis below 1 other than
        -1, more than one -1, or sizes that do not multiply out to
        ``n_devices``."""
        if n_devices < 1:
            raise ValueError("need at least one device")
        sizes = {"dp": self.dp, "tp": self.tp, "sp": self.sp, "ep": self.ep, "pp": self.pp}
        bad = {k: v for k, v in sizes.items() if v != -1 and v < 1}
        if bad:
            raise ValueError(f"mesh axes must be -1 or >= 1, got {bad}")
        fixed = math.prod(v for v in sizes.values() if v > 0)
        free = [k for k, v in sizes.items() if v == -1]
        if len(free) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if fixed > n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        if free:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[free[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


# ---------------------------------------------------------------------------
# the rank group of a tensor-parallel gang
# ---------------------------------------------------------------------------

#: the address rank 0 advertises for its rendezvous store by default: the
#: gang's members share a host
STORE_HOST = "127.0.0.1"


def _device_id(device: torch.device) -> str:
    """What the backend choice compares: ``cpu``, or the card's UUID."""
    if device.type != "cuda":
        return "cpu"
    index = torch.cuda.current_device() if device.index is None else device.index
    return f"cuda:{torch.cuda.get_device_properties(index).uuid}"


def choose_backend(device_ids: list[str]) -> str:
    """``nccl`` when every rank owns a distinct CUDA card, else ``gloo``
    (CPU ranks, and ranks that share a card: NCCL refuses two ranks on one
    device, while gloo stages CUDA tensors through host memory)."""
    if all(d.startswith("cuda:") for d in device_ids) and len(set(device_ids)) == len(device_ids):
        return "nccl"
    return "gloo"


def _agree_backend(store: Any, rank: int, size: int, device: torch.device,
                   timeout: datetime.timedelta) -> str:
    """Publish this rank's device on ``store``, read every rank's and
    choose the backend (:func:`choose_backend`)."""
    store.set_timeout(timeout)
    store.set(f"dev/{rank}", _device_id(device))
    return choose_backend([store.get(f"dev/{r}").decode() for r in range(size)])


def _process_group(store: Any, rank: int, size: int, backend: str,
                   timeout: datetime.timedelta) -> Any:
    """A bare ``torch.distributed`` process group of ``size`` ranks over
    ``store`` (not registered as the process's default group)."""
    pg_store = dist.PrefixStore(backend, store)
    if backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(pg_store, rank, size, opts)
    return dist.ProcessGroupGloo(pg_store, rank, size, timeout)


@dataclass
class TPGroup:
    """One rank's view of a tensor-parallel group: its ``rank`` of
    ``size``, the ``torch.distributed`` process group (built directly, not
    registered as the process's default group, so a worker can belong to
    one gang after another), its ``backend`` and the rank's ``device``.
    Every collective waits at most the ``timeout_s`` it was joined with
    (a gang's peer timeout); :meth:`close` tears the group down, which
    makes a peer blocked in a collective with this rank fail at once
    instead of at its timeout."""

    rank: int
    size: int
    pg: Any
    backend: str
    device: torch.device

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the group, in place; returns ``t``."""
        if self.pg is None:
            raise RuntimeError(f"rank {self.rank}: the group was closed")
        self.pg.allreduce([t]).wait()
        return t

    def close(self) -> None:
        """Tear the group down (idempotent).  A collective this rank is
        itself blocked in still ends at its timeout."""
        pg, self.pg = self.pg, None
        if pg is not None:
            pg.abort()

    # -- construction ----------------------------------------------------
    @classmethod
    def join(cls, store: Any, rank: int, size: int, device: torch.device, *,
             timeout_s: float) -> "TPGroup":
        """Join the group over ``store``: publish this rank's device,
        read every rank's, choose the backend (:func:`choose_backend`) and
        build the process group, which keeps ``store`` (rank 0's server
        included) alive until it is closed.  Blocks until all ``size``
        ranks have joined or ``timeout_s`` passes."""
        timeout = datetime.timedelta(seconds=timeout_s)
        backend = _agree_backend(store, rank, size, device, timeout)
        pg = _process_group(store, rank, size, backend, timeout)
        logx.info("tensor-parallel group joined", rank=rank, size=size,
                  collective=backend, device=str(device))
        return cls(rank=rank, size=size, pg=pg, backend=backend, device=device)


def open_store(size: int, *, timeout_s: float,
               advertise_host: Optional[str] = None) -> tuple[Any, str]:
    """Rank 0's rendezvous store: a ``TCPStore`` server on an ephemeral
    port.  Returns the store and the ``host:port`` rank 0 hands its peers
    (the gang's ``ready`` message), naming ``advertise_host`` (default
    :data:`STORE_HOST`): a gang whose ranks live on other hosts advertises
    an address they can route to.  torch's server listens on every
    interface of the host, whatever host name the store is given (that
    name is only where rank 0's own client connects), so the store is
    reachable at any of the host's addresses."""
    store = dist.TCPStore(STORE_HOST, 0, size, True, datetime.timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    return store, f"{advertise_host or STORE_HOST}:{store.port}"


def connect_store(addr: str, size: int, *, timeout_s: float) -> Any:
    """A peer's client of rank 0's rendezvous store at ``host:port``."""
    host, port = addr.rsplit(":", 1)
    return dist.TCPStore(host, int(port), size, False, datetime.timedelta(seconds=timeout_s))


def in_process_groups(size: int, device: torch.device, *, timeout_s: float) -> list[TPGroup]:
    """``size`` groups of one process, one a thread, over a shared
    ``HashStore``: the in-process gang's ranks (gloo, since the ranks
    share the device).  Built in parallel threads, as gloo's rendezvous
    needs every rank at once."""
    store = dist.HashStore()
    groups: list[Any] = [None] * size
    errors: list[BaseException] = []

    def build(r: int) -> None:
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            groups[r] = TPGroup.join(dist.PrefixStore("tp", store), r, size, device,
                                     timeout_s=timeout_s)
        except BaseException as e:  # noqa: BLE001 - re-raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(r,), name=f"tp-join-{r}")
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s + 5.0)
    if errors or any(g is None for g in groups):
        for g in groups:
            if g is not None:
                g.close()
        raise RuntimeError(f"in-process group of {size} ranks did not form: {errors}")
    return groups


# ---------------------------------------------------------------------------
# the rank mesh of a training job
# ---------------------------------------------------------------------------

#: the reference's axis order (``build_mesh``); the last axis varies fastest
AXES = (AXIS_DP, AXIS_TP, AXIS_SP, AXIS_EP, AXIS_PP)
#: the axis lines a training mesh builds a group for
LINE_AXES = (AXIS_DP, AXIS_TP, AXIS_SP, AXIS_EP, AXIS_PP)
#: the group over the tp × ep plane through a rank (the MoE layer's
#: partial sums), and its axes
EXPERT_PLANE = "tp_ep"
EXPERT_PLANE_AXES = (AXIS_TP, AXIS_EP)


def mesh_coords(sizes: dict[str, int], rank: int) -> dict[str, int]:
    """``rank``'s index on each axis of a grid of ``sizes``, in the order
    of :data:`AXES` with pp fastest: where device ``rank`` sits in the
    reference's ``np.array(devices).reshape(shape)``."""
    coords = {}
    for axis in reversed(AXES):
        rank, coords[axis] = divmod(rank, sizes[axis])
    return {axis: coords[axis] for axis in AXES}


def mesh_rank(sizes: dict[str, int], coords: dict[str, int]) -> int:
    """The inverse of :func:`mesh_coords`."""
    rank = 0
    for axis in AXES:
        rank = rank * sizes[axis] + coords[axis]
    return rank


def line_ranks(sizes: dict[str, int], rank: int, axis: str) -> list[int]:
    """The world ranks of ``rank``'s line along ``axis``: the ranks whose
    coordinates differ from its own on that axis alone, by their index on
    it (a rank's index in its line is its coordinate on the axis)."""
    coords = mesh_coords(sizes, rank)
    return [mesh_rank(sizes, {**coords, axis: i}) for i in range(sizes[axis])]


def plane_ranks(sizes: dict[str, int], rank: int, axes: Sequence[str]) -> list[int]:
    """The world ranks of ``rank``'s plane over ``axes``: the ranks whose
    coordinates differ from its own on those axes alone, in world order."""
    coords = mesh_coords(sizes, rank)
    return [r for r in range(math.prod(sizes.values()))
            if all(c == coords[a] for a, c in mesh_coords(sizes, r).items() if a not in axes)]


#: what :class:`TrainMesh` counts in ``host_s`` and ``calls``
COLLECTIVES = ("p2p", "all_reduce", "all_gather", "reduce_scatter")


@dataclass
class TrainMesh:
    """One rank of a training mesh: its ``rank`` on the grid of ``sizes``
    (:func:`mesh_coords`), the ``backend`` every group uses (NCCL when each
    rank owns its own card, :func:`choose_backend`), the rank's ``device``
    and its process groups: ``world``, the ``dp``, ``tp``, ``sp``, ``ep``
    and ``pp`` lines through the rank (:func:`line_ranks`) and the tp × ep
    plane through it (``tp_ep``, :func:`plane_ranks`); ``None`` for a group
    of one rank, the world group for one that spans the world, and the
    line's own group for a plane that is one line.  Like
    :class:`TPGroup`'s, the groups are bare process groups, not the
    process's default group, and every call waits at most the caller's
    ``timeout_s``.  ``host_s`` and ``calls`` count the host seconds spent
    inside, and the number of, point-to-point calls (``p2p``: a
    :meth:`send`, a :meth:`recv` or a :meth:`shift`'s exchange), all-reduces
    (``all_reduce``), all-gathers (``all_gather``) and reduce-scatters
    (``reduce_scatter``); over NCCL a call returns once the operation is
    queued on the card, over gloo once it is done."""

    sizes: dict[str, int]
    rank: int
    backend: str
    device: torch.device
    groups: dict[str, Any]
    host_s: dict[str, float] = field(default_factory=lambda: dict.fromkeys(COLLECTIVES, 0.0))
    calls: dict[str, int] = field(default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))

    @property
    def size(self) -> int:
        return math.prod(self.sizes.values())

    @property
    def coords(self) -> dict[str, int]:
        return mesh_coords(self.sizes, self.rank)

    @property
    def dp(self) -> int:
        return self.sizes[AXIS_DP]

    @property
    def tp(self) -> int:
        return self.sizes[AXIS_TP]

    @property
    def sp(self) -> int:
        return self.sizes[AXIS_SP]

    @property
    def ep(self) -> int:
        return self.sizes[AXIS_EP]

    @property
    def pp(self) -> int:
        return self.sizes[AXIS_PP]

    @property
    def dp_rank(self) -> int:
        return self.coords[AXIS_DP]

    @property
    def tp_rank(self) -> int:
        return self.coords[AXIS_TP]

    @property
    def sp_rank(self) -> int:
        return self.coords[AXIS_SP]

    @property
    def ep_rank(self) -> int:
        return self.coords[AXIS_EP]

    @property
    def pp_rank(self) -> int:
        return self.coords[AXIS_PP]

    def dp_rows(self, tokens: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's block of ``tokens`` along ``axis``: the reference
        shards the batch over dp in contiguous blocks.  ``ValueError``
        when dp does not divide it."""
        n, dp = tokens.shape[axis], self.dp
        if n % dp:
            raise ValueError(f"{n} rows do not split over dp {dp}")
        return tokens.narrow(axis, self.dp_rank * (n // dp), n // dp)

    def sp_span(self, t: int) -> tuple[int, int]:
        """``(start, length)`` of this rank's chunk of a sequence of ``t``
        positions: the reference shards the sequence over sp in contiguous
        blocks (``P('dp', 'sp')``).  ``ValueError`` when sp does not divide
        it."""
        if t % self.sp:
            raise ValueError(f"a sequence of {t} does not split over sp {self.sp}")
        return self.sp_rank * (t // self.sp), t // self.sp

    def _group(self, over: str) -> Any:
        if over not in self.groups:
            raise ValueError(f"no group {over!r}: world, dp, tp, sp, ep, pp or tp_ep")
        pg = self.groups[over]
        if pg is None and self._line_size(over) > 1:
            raise RuntimeError(f"rank {self.rank}: the mesh was closed")
        return pg

    def _timed(self, kind: str, fn: Callable[[], Any]) -> Any:
        t0 = time.perf_counter()
        out = fn()
        self.host_s[kind] += time.perf_counter() - t0
        self.calls[kind] += 1
        return out

    def all_reduce(self, t: torch.Tensor, over: str = AXIS_DP) -> torch.Tensor:
        """Sum ``t`` in place over ``over`` (an axis line or ``"world"``);
        returns ``t``.  A line of one rank leaves it as it
        is."""
        pg = self._group(over)
        if pg is not None:
            self._timed("all_reduce", lambda: pg.allreduce([t]).wait())
        return t

    def _line_size(self, over: str) -> int:
        if over == "world":
            return self.size
        if over == EXPERT_PLANE:
            return math.prod(self.sizes[a] for a in EXPERT_PLANE_AXES)
        return self.sizes[over]

    def _index(self, over: str) -> int:
        """This rank's index in the group ``over``."""
        if over == "world":
            return self.rank
        if over == EXPERT_PLANE:
            return plane_ranks(self.sizes, self.rank, EXPERT_PLANE_AXES).index(self.rank)
        return self.coords[over]

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as gloo takes it in a gather: contiguous, and in host
        memory when it lives on a card (as :meth:`send` stages it)."""
        buf = t.contiguous()
        return buf.cpu() if self.backend == "gloo" and buf.is_cuda else buf

    def all_gather(self, t: torch.Tensor, over: str, dim: int) -> torch.Tensor:
        """Every rank's ``t`` along ``over``, joined along ``dim`` in the
        order of the ranks' coordinates on the axis (a new tensor on
        ``t``'s device).  A line of one rank returns ``t`` as it is."""
        pg, n = self._group(over), self._line_size(over)
        if pg is None:
            return t
        buf = self._staged(t)
        parts = [torch.empty_like(buf) for _ in range(n)]
        self._timed("all_gather", lambda: pg.allgather([parts], [buf]).wait())
        return torch.cat(parts, dim).to(t.device)

    def reduce_scatter(self, t: torch.Tensor, over: str, dim: int) -> torch.Tensor:
        """The sum of ``t`` over ``over``, cut along ``dim`` into as many
        equal blocks as the line has ranks: this rank's block (its
        coordinate on the axis), a new tensor.  NCCL reduce-scatters.  gloo
        sums the whole tensor with an all-reduce and keeps the block: one
        implementation for every torch this runs on, since gloo's own
        reduce-scatter is missing from some versions and takes no CUDA
        tensor where it exists (the sum is the same; gloo moves every block
        to every rank).  ``ValueError`` when the line does not divide
        ``dim``; a line of one rank returns ``t`` as it is."""
        pg, n = self._group(over), self._line_size(over)
        if pg is None:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"dimension {t.shape[dim]} does not split over {over} {n}")
        idx = self._index(over)
        per = t.shape[dim] // n
        if self.backend == "gloo":
            buf = self._staged(t).clone()
            self._timed("reduce_scatter", lambda: pg.allreduce([buf]).wait())
            return buf.narrow(dim, idx * per, per).contiguous().to(t.device)
        parts = [c.contiguous() for c in t.chunk(n, dim)]
        out = torch.empty_like(parts[idx])
        self._timed("reduce_scatter", lambda: pg.reduce_scatter([out], [parts]).wait())
        return out

    def send(self, t: torch.Tensor, stage: int, tag: int) -> None:
        """Send ``t`` to the rank of pp index ``stage`` on this rank's pp
        line.  gloo has no send of a CUDA tensor: it goes through host
        memory."""
        pg = self._group(AXIS_PP)
        buf = t.detach().contiguous()
        if self.backend == "gloo" and buf.is_cuda:
            buf = buf.cpu()
        self._timed("p2p", lambda: pg.send([buf], stage, tag).wait())

    def recv(self, shape: tuple, dtype: torch.dtype, stage: int, tag: int) -> torch.Tensor:
        """Receive a tensor of ``shape`` and ``dtype`` on this rank's
        device from the rank of pp index ``stage`` on its pp line."""
        pg = self._group(AXIS_PP)
        staged = self.backend == "gloo" and self.device.type == "cuda"
        buf = torch.empty(shape, dtype=dtype, device="cpu" if staged else self.device)
        self._timed("p2p", lambda: pg.recv([buf], stage, tag).wait())
        return buf.to(self.device) if staged else buf

    def shift(self, tensors: Sequence[torch.Tensor], over: str = AXIS_SP) -> list[torch.Tensor]:
        """One hop of a ring along ``over``: send ``tensors`` to the rank
        of the next coordinate on the line (``(i + 1) % n``) and return
        the previous one's (``(i - 1) % n``), each of the same shape and
        dtype, on this rank's device.  The tensors travel packed into one
        byte buffer, one exchange a hop (gloo through host memory for a
        CUDA tensor, as :meth:`send`).  Ranks of even coordinate post the
        send first and odd ones the receive, so the two sides of a pair
        post in the same order (NCCL's point-to-point calls between two
        ranks are matched in order; at n 2 the next rank is the previous
        one).  A line of one rank returns the tensors as they are."""
        pg, n = self._group(over), self._line_size(over)
        if pg is None:
            return list(tensors)
        idx = self._index(over)
        buf, layout = _pack(tensors)
        send = self._staged(buf)
        recv = torch.empty_like(send)

        def exchange():
            ops = [(pg.send, send, (idx + 1) % n), (pg.recv, recv, (idx - 1) % n)]
            works = [post([t], peer, 0) for post, t, peer in ops[::1 if idx % 2 == 0 else -1]]
            for w in works:
                w.wait()

        self._timed("p2p", exchange)
        return _unpack(recv.to(self.device), layout)

    def close(self) -> None:
        """Abort every group (idempotent): a peer blocked in a call with
        this rank fails at once instead of at its timeout."""
        groups, self.groups = self.groups, {k: None for k in self.groups}
        for pg in {id(pg): pg for pg in groups.values() if pg is not None}.values():
            pg.abort()

    # -- construction ----------------------------------------------------
    @classmethod
    def join(cls, store: Any, rank: int, world: int, device: torch.device, *,
             spec: MeshSpec, timeout_s: float) -> "TrainMesh":
        """Join the mesh ``spec`` over ``world`` ranks (:meth:`MeshSpec.resolve`)
        as ``rank``, over ``store``: agree the backend, then build the world
        group, this rank's dp, tp, sp, ep and pp lines and its tp × ep
        plane, each under its own prefix of the store, in that order on
        every rank.  Blocks until every rank of each group has joined or
        ``timeout_s`` passes."""
        sizes = spec.resolve(world)
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a world of {world}")
        timeout = datetime.timedelta(seconds=timeout_s)
        if world == 1:
            return cls(sizes=sizes, rank=rank, backend="none", device=device,
                       groups={"world": None, **dict.fromkeys((*LINE_AXES, EXPERT_PLANE))})
        backend = _agree_backend(store, rank, world, device, timeout)
        world_pg = _process_group(dist.PrefixStore("world", store), rank, world, backend, timeout)
        groups = {"world": world_pg}
        lines = {axis: line_ranks(sizes, rank, axis) for axis in LINE_AXES}
        lines[EXPERT_PLANE] = plane_ranks(sizes, rank, EXPERT_PLANE_AXES)
        for name, line in lines.items():
            same = [a for a in EXPERT_PLANE_AXES if name == EXPERT_PLANE and lines[a] == line]
            if len(line) == 1:
                groups[name] = None
            elif len(line) == world:
                groups[name] = world_pg
            elif same:  # a plane that is one line: that line's group
                groups[name] = groups[same[0]]
            else:  # the group's first rank names it
                groups[name] = _process_group(dist.PrefixStore(f"{name}/{min(line)}", store),
                                              line.index(rank), len(line), backend, timeout)
        logx.info("training mesh joined", rank=rank, size=world,
                  mesh={k: v for k, v in sizes.items() if v > 1}, collective=backend,
                  device=str(device))
        return cls(sizes=sizes, rank=rank, backend=backend, device=device, groups=groups)


#: bytes each tensor of a packed hop starts at a multiple of (the widest
#: dtype's element, and aligned for the kernels that read the tensors)
_PACK_ALIGN = 16


def _pack(tensors: Sequence[torch.Tensor]) -> tuple[torch.Tensor, list]:
    """``tensors`` copied into one uint8 buffer on the first one's device,
    each from a multiple of :data:`_PACK_ALIGN` bytes; and the layout
    :func:`_unpack` reads them back by."""
    layout, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        layout.append((size, nbytes, t.dtype, tuple(t.shape)))
        size += -(-nbytes // _PACK_ALIGN) * _PACK_ALIGN
    buf = torch.empty(size, dtype=torch.uint8, device=tensors[0].device)
    for t, (off, nbytes, _, _) in zip(tensors, layout):
        buf[off:off + nbytes].copy_(t.detach().reshape(-1).view(torch.uint8))
    return buf, layout


def _unpack(buf: torch.Tensor, layout: list) -> list[torch.Tensor]:
    return [buf[off:off + nbytes].view(dtype).view(shape)
            for off, nbytes, dtype, shape in layout]


def in_process_meshes(spec: MeshSpec, world: int, device: torch.device, *,
                      timeout_s: float) -> list[TrainMesh]:
    """``world`` ranks of the mesh ``spec`` in one process, one a thread,
    over a shared ``HashStore`` (gloo: the ranks share the device); built
    in parallel threads, as gloo's rendezvous needs every rank at once.
    The CPU tests' mesh."""
    store = dist.HashStore()
    meshes: list[Any] = [None] * world
    errors: list[BaseException] = []

    def build(r: int) -> None:
        try:
            if device.type == "cuda":
                torch.cuda.set_device(device)
            meshes[r] = TrainMesh.join(dist.PrefixStore("train", store), r, world, device,
                                       spec=spec, timeout_s=timeout_s)
        except BaseException as e:  # noqa: BLE001 - re-raised below, in the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=build, args=(r,), name=f"mesh-join-{r}")
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s + 5.0)
    if errors or any(m is None for m in meshes):
        for m in meshes:
            if m is not None:
                m.close()
        if errors and isinstance(errors[0], ValueError):
            raise errors[0]
        raise RuntimeError(f"in-process mesh of {world} ranks did not form: {errors}")
    return meshes
