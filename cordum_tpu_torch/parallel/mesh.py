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
the sums across ranks are explicit all-reduces.  Meshes for training over
several ranks (dp, tp, sp, ep, pp) come with ROADMAP A9b, A14, A12 and
A11.
"""
from __future__ import annotations

import datetime
import math
import threading
from dataclasses import dataclass
from typing import Any, Optional

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
        store.set_timeout(timeout)
        store.set(f"dev/{rank}", _device_id(device))
        ids = [store.get(f"dev/{r}").decode() for r in range(size)]
        backend = choose_backend(ids)
        pg_store = dist.PrefixStore(backend, store)
        if backend == "nccl":
            opts = dist.ProcessGroupNCCL.Options()
            opts._timeout = timeout
            pg = dist.ProcessGroupNCCL(pg_store, rank, size, opts)
        else:
            pg = dist.ProcessGroupGloo(pg_store, rank, size, timeout)
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
