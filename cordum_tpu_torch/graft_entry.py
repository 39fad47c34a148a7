"""Driver entry points of the port: the counterpart of ``__graft_entry__.py``.

``entry()``      — the flagship forward step (the Llama-family decoder at
                   the reference's entry widths) and its inputs, on the card.
``dryrun_multichip(n)`` — one training step of each mesh family over ``n``
                   ranks, on tiny shapes: dense Llama over dp × tp × sp,
                   MoE over dp × tp × ep and the pipeline over dp × pp.

Where the reference forces ``n`` virtual CPU devices into one JAX process,
the port starts ``n`` rank processes (:func:`.parallel.launch.run_ranks`):
one a card over NCCL, or gloo CPU ranks with ``device="cpu"``.  Each rank
joins the three meshes, draws its slices of the weights from the seeds the
reference uses (0, 2 and 4; the tokens from 1, 3 and 5) with the port's
torch generators, and takes one step through its family's
``make_train_step(mesh=)``.  The draws are not ``jax.random``'s, so the
losses are not the reference's numbers; the parity tests hold the port to
the JAX dry run on the JAX draws.

    python -m cordum_tpu_torch.graft_entry              # entry()'s forward
    python -m cordum_tpu_torch.graft_entry --dryrun 8 --cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from typing import Any, Callable, Optional, Sequence

import torch

from .device import DeviceLike, resolve_device
from .models import llama, moe, pipeline
from .parallel.launch import run_ranks
from .parallel.mesh import MeshSpec, TrainMesh

#: ``entry()``'s model, the reference's (``__graft_entry__.py:19-21``)
ENTRY_CONFIG = dict(vocab_size=32000, d_model=512, n_layers=4, n_heads=8, n_kv_heads=4,
                    d_ff=1536)
ENTRY_TOKENS = (4, 128)
#: the dry run's three families, in the reference's order and names
DRYRUN_NAMES = ("dense dp×tp×sp", "moe dp×tp×ep", "pipeline dp×pp")
DRYRUN_TIMEOUT_S = 600.0
DRYRUN_PEER_TIMEOUT_S = 300.0


def entry(*, device: DeviceLike = None):
    """``(fn, (params, tokens))``: ``fn`` is :func:`.models.llama.forward`
    at the reference's entry widths (vocab 32000, d_model 512, 4 layers, 8
    heads, 4 KV heads, d_ff 1536), the params drawn from seed 0 and the
    ``[4, 128]`` tokens from seed 1, on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    cfg = llama.LlamaConfig(**ENTRY_CONFIG)
    params = llama.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    tokens = torch.randint(0, cfg.vocab_size, ENTRY_TOKENS, dtype=torch.int32, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))

    def fn(params, tokens):
        return llama.forward(params, tokens, cfg)

    return fn, (params, tokens)


def factor2(n, k):
    """k axis sizes of 2 where divisible, else 1."""
    out = []
    for _ in range(k):
        if n % 2 == 0:
            out.append(2)
            n //= 2
        else:
            out.append(1)
    return out, n


@dataclasses.dataclass(frozen=True)
class DryrunCase:
    """One family of the dry run: its name, mesh, config, the tokens'
    shape (dp resolved over the world) and the weights' and tokens'
    seeds."""

    name: str
    spec: MeshSpec
    cfg: Any
    tokens: tuple
    seeds: tuple


def dryrun_cases(n: int, dtype: Optional[torch.dtype] = None) -> list[DryrunCase]:
    """The reference's three steps over ``n`` ranks (``__graft_entry__.py:
    84-121``): dense ``MeshSpec(dp=-1, tp, sp)`` on ``LlamaConfig.tiny()``
    with tokens ``[dp·2, max(16, sp·8)]``; MoE ``MeshSpec(dp=-1, tp, ep)``
    on ``MoEConfig.tiny()`` with ``[dp·2, 16]``; the pipeline
    ``MeshSpec(dp=-1, pp)`` on a tiny base with ``pp`` stages and 2
    microbatches, ``[dp·4, 16]``.  ``dtype`` replaces the weights' dtype."""
    base = llama.LlamaConfig.tiny()
    if dtype is not None:
        base = dataclasses.replace(base, dtype=dtype)
    (tp, sp), _ = factor2(n, 2)
    dense = MeshSpec(dp=-1, tp=tp, sp=sp)
    (tp2, ep), _ = factor2(n, 2)
    experts = MeshSpec(dp=-1, tp=tp2, ep=ep)
    pp = 2 if n % 2 == 0 else 1
    stages = MeshSpec(dp=-1, pp=pp)

    def dp(spec):
        return spec.resolve(n)["dp"]

    return [
        DryrunCase(DRYRUN_NAMES[0], dense, base, (dp(dense) * 2, max(16, sp * 8)), (0, 1)),
        DryrunCase(DRYRUN_NAMES[1], experts, dataclasses.replace(moe.MoEConfig.tiny(), base=base),
                   (dp(experts) * 2, 16), (2, 3)),
        DryrunCase(DRYRUN_NAMES[2], stages,
                   pipeline.PipelineConfig(base=base, n_stages=pp, n_microbatches=2),
                   (dp(stages) * 2 * 2, 16), (4, 5)),
    ]


def _train_step(case: DryrunCase, device: torch.device, mesh: Optional[TrainMesh]):
    if isinstance(case.cfg, pipeline.PipelineConfig):
        return pipeline.make_train_step(case.cfg, device=device, mesh=mesh)
    if isinstance(case.cfg, moe.MoEConfig):
        return moe.make_train_step(case.cfg, device=device, mesh=mesh)
    return llama.make_train_step(case.cfg, device=device, mesh=mesh)


def _step_loss(case: DryrunCase, device: torch.device, mesh: Optional[TrainMesh]) -> float:
    """One step of ``case`` from its seeds: the rank's when ``mesh`` is
    given (its slices, the whole batch), else one process's.  The tokens
    come from a CPU generator, so every device draws the same."""
    init, step = _train_step(case, device, mesh)
    params, state = init(case.seeds[0])
    cfg = case.cfg.base if hasattr(case.cfg, "base") else case.cfg
    tokens = torch.randint(0, cfg.vocab_size, case.tokens, dtype=torch.int32,
                           generator=torch.Generator().manual_seed(case.seeds[1]))
    if isinstance(case.cfg, pipeline.PipelineConfig):
        tokens = pipeline.microbatch(tokens, case.cfg.n_microbatches)
    _, _, loss = step(params, state, tokens.to(device))
    return loss.item()


def kernel_launches() -> dict:
    """The launch counts of the hand-written kernels a training step runs
    in this process: B9's forward and backward (and of them a sequence
    chunk's, ``Tq != Tk``) and B7's six modes (and the route with a
    room).  The CPU runs the plain versions and counts none."""
    from .ops import dense_attention as da
    from .ops import moe_dispatch as md

    fwd, bwd, route = da.dense_attention_fwd, da.dense_attention_bwd, md.moe_route_kernel
    return {"dense_attention_fwd": fwd.launches, "dense_attention_bwd": bwd.launches,
            "dense_attention_fwd_sp": fwd.chunk_launches,
            "dense_attention_bwd_sp": bwd.chunk_launches,
            "moe_route": route.launches, "moe_route_room": route.room_launches,
            **{name: getattr(md, name).launches for name in (
                "moe_slot_gather", "moe_slot_gather_scaled", "moe_token_gather",
                "moe_token_sum", "moe_token_dot")}}


def _dtype_name(dtype: Optional[torch.dtype]) -> Optional[str]:
    return None if dtype is None else str(dtype).split(".")[-1]


def dryrun_rank(job: dict, meshes: list[TrainMesh]) -> dict:
    """One rank of :func:`dryrun_multichip` (the launcher's target): for
    each dtype asked, the three steps on the rank's meshes; each step's
    loss, mesh and the kernel launches it made."""
    runs = []
    for name in job["dtypes"]:
        out = []
        cases = dryrun_cases(job["n"], None if name is None else getattr(torch, name))
        for case, mesh in zip(cases, meshes):
            before = kernel_launches()
            loss = _step_loss(case, mesh.device, mesh)
            after = kernel_launches()
            out.append({"name": case.name, "mesh": dict(mesh.sizes), "loss": loss,
                        "launches": {k: v - before[k] for k, v in after.items()}})
        runs.append(out)
    return {"rank": meshes[0].rank, "device": str(meshes[0].device),
            "collective": meshes[0].backend, "runs": runs}


def dryrun_multichip(n_devices: int, *, device: DeviceLike = None,
                     dtypes: Sequence[Optional[torch.dtype]] = (None,),
                     log: Callable[[str], Any] = print) -> list[dict]:
    """The three training steps over ``n_devices`` rank processes (one a
    card, NCCL; ``device="cpu"``: gloo CPU ranks), once for each of
    ``dtypes`` (``None``: the configs' bf16; another replaces the weights'
    dtype) on the same meshes, in one launch.  Every rank must return the
    same loss, and it must be finite; prints the reference's line for each
    (``dryrun_multichip ok: <name> mesh={...} loss=...``, the dtype after
    the name when one was given).  Returns, for each dtype, ``{name:
    {"mesh", "loss", "launches"}}`` (``launches``: the ranks' kernel
    launches summed) plus ``"ranks"``: each rank's device and collective."""
    names = [_dtype_name(d) for d in dtypes]
    cases = dryrun_cases(n_devices)
    docs = run_ranks("cordum_tpu_torch.graft_entry:dryrun_rank",
                     {"n": n_devices, "dtypes": names}, world=n_devices,
                     spec=[c.spec for c in cases], device=device,
                     timeout_s=DRYRUN_TIMEOUT_S, peer_timeout_s=DRYRUN_PEER_TIMEOUT_S)
    out = []
    for j, dtype_name in enumerate(names):
        results: dict = {}
        for i, case in enumerate(cases):
            got = [d["runs"][j][i] for d in docs]
            label = case.name if dtype_name is None else f"{case.name} [{dtype_name}]"
            losses = [g["loss"] for g in got]
            if not all(math.isfinite(x) for x in losses):
                raise RuntimeError(f"non-finite loss in {label}: {losses}")
            if any(x != losses[0] for x in losses):
                raise RuntimeError(f"the ranks of {label} disagree on the loss: {losses}")
            launches = {k: sum(g["launches"][k] for g in got) for k in got[0]["launches"]}
            results[case.name] = {"mesh": got[0]["mesh"], "loss": losses[0],
                                  "launches": launches}
            log(f"dryrun_multichip ok: {label} mesh={got[0]['mesh']} loss={losses[0]:.4f}")
        results["ranks"] = [{"device": d["device"], "collective": d["collective"]}
                            for d in docs]
        out.append(results)
    return out


def dryrun_one_process(n_devices: int, *, device: DeviceLike = None,
                       dtype: Optional[torch.dtype] = None) -> dict:
    """The dry run's three steps in this process on one device (no mesh,
    the pipeline's stages as its one-process schedule), from the same
    seeds: what the ranks' losses are held to.  ``{name: loss}``."""
    dev = resolve_device(device)
    return {case.name: _step_loss(case, dev, None) for case in dryrun_cases(n_devices, dtype)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="one training step of each mesh family over N ranks")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo CPU ranks)")
    a = ap.parse_args(argv)
    device = "cpu" if a.cpu else None
    if a.dryrun:
        dryrun_multichip(a.dryrun, device=device)
        return 0
    fn, (params, tokens) = entry(device=device)
    with torch.no_grad():
        logits = fn(params, tokens)
    print(f"entry ok: logits {tuple(logits.shape)} {logits.dtype} on {logits.device}, "
          f"finite {bool(torch.isfinite(logits).all())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
