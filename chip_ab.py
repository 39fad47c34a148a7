#!/usr/bin/env python3
"""Compare this tree's port with another tree's (its parent, say) on one
card, by one method, each leg in a process of its own, in the order
other, this, this, other.

    git archive <commit> | tar -x -C build/parent   # a git-ignored directory
    python3 chip_ab.py --other build/parent [--legs kernels,serve,dense,train,moe,pipe]

Legs:

* ``kernels``: the paged-attention kernel on ``chip_smoke.py``'s
  8192-token case and the embedder's attention kernel on its B 256, L 128
  case, fp32 and bf16.  Each tree's kernel is checked against that tree's
  plain version at ``chip_smoke.py``'s tolerances, then timed with this
  tree's ``chip_smoke.time_ms`` (L2 flushed before each launch) twice:
  with the sleep kernel that hides the host's own work for the next call
  (``sleep``) and without it (``nosleep``, the method of the timings
  before the sleep was added).  SDPA on the embedder case is timed both
  ways too, as a yardstick of the method.  A tree whose wrapper takes a
  step plan gets one built outside the timed window, as the serving step
  builds it.
* ``serve``: ``chip_smoke.py``'s phase 4 — bf16 Llama-3-8B, 32 layers,
  random weights from a seeded CUDA generator, 8 requests of 8-300 prompt
  tokens and 32 new tokens each through ``make_serving_engine`` — three
  times in one process; the first run warms up, the other two are kept:
  step p50, TTFT p50, wall, and the plan's host time per step where the
  tree builds one.
* ``dense``: the dense causal attention kernels (B9) on ``chip_smoke.py``'s
  phase 7.1 shapes (``DENSE_SHAPES``), bf16 and fp32, forward alone and
  backward alone: each tree's kernels checked against that tree's plain
  version at ``chip_smoke.py``'s gates (``measure_dense``: fp32 tolerances;
  the bf16 row gate and its three planted faults; two backward calls with
  the same bits), then timed with this tree's ``time_ms``, beside the
  plain version and SDPA timed in the same process; in bf16 also the dq
  rows beyond the row gate's limit, by their count of live keys; in fp32 a
  digest of the forward's and backward's outputs (equal digests: the same
  bits in both trees).
* ``train``: ``chip_smoke.py``'s phase 7.3 — bf16 train steps at
  Llama-3-8B widths, 2 layers, B 4, T 2048, on one seeded batch through
  ``make_train_step`` — 10 steps; the step p50 over steps 2-10.
* ``moe``: the MoE kernels (B7) at ``chip_smoke.py``'s phase 9.1 shapes
  (N 8192, D 4096, E 8, k 2, C 2560), bf16 and fp32, through this tree's
  ``measure_moe``: each tree's six launch modes checked against that
  tree's plain versions at phase 9.1's gates (the main, capacity-drop and
  exact-tie cases), then timed with this tree's ``time_ms`` beside the
  plain versions and the library calls; the route also at other widths
  (``MOE_ROUTE_SHAPES``: 64 and 256 experts, 65536 tokens), equal to that
  tree's plain route; then phase 9.3's bf16 MoE train steps
  (Mixtral-8x7B widths on the Llama-3-8B base, 2 layers, B 4, T 2048, 10
  steps on one seeded batch): the step p50 over steps 2-10.
* ``pipe``: ``chip_smoke.py``'s phase 11.2 — bf16 pipeline train steps
  (Llama-3-8B widths, 2 layers, S 2, M 4, B 4, T 2048, the pipeline's
  AdamW) on one seeded batch, 10 steps: the step p50 over steps 2-10 and
  the run's peak memory.

Prints each leg's numbers, then a summary (per measure: the two legs of
each tree and this tree's median over the other's) and writes it all to
``--out``, each leg process's own output beside it
(``<out>.<leg>.<i>.<tree>.log``).  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
MARK = "[ab-json] "


def load_smoke():
    """This tree's ``chip_smoke.py`` (its timer and cases), whichever tree
    ``cordum_tpu_torch`` is imported from."""
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def leg_kernels(torch, cs, dev):
    from cordum_tpu_torch.ops import embed_attention as ea
    from cordum_tpu_torch.ops import paged_attention as pa

    import torch.nn.functional as F

    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def flush():
        flush_buf.zero_()

    def timed(fn, iters):
        return {"sleep": cs.time_ms(torch, fn, iters=iters, flush=flush),
                "nosleep": cs.time_ms(torch, fn, iters=iters, flush=flush, sleep_cycles=0)}

    res = {}
    long32 = cs.attention_case(torch, dev, cs.LONG_ROWS)
    qkv32, mask, _ = cs.embed_attention_case(torch, dev)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v = (x.to(dtype) for x in long32[:3])
        args = (q, k, v, *long32[3:])
        kw = {}
        if hasattr(pa, "build_plan"):
            _, ps, kvh, _ = k.shape
            kw["plan"] = pa.build_plan(
                args[4].cpu().numpy(), args[5].cpu().numpy(), page_size=ps,
                pages_per_seq=args[3].shape[1], n_heads=q.shape[1], n_kv_heads=kvh,
                dtype=dtype, device=dev)
        err = (pa.paged_attention(*args, **kw).float()
               - pa.paged_attention_reference(*args).float()).abs().max().item()
        if not err <= cs.KERNEL_ATOL[name]:
            raise AssertionError(f"paged_attention {name}: max abs err {err}")
        res[f"paged_attention_{name}"] = {
            "max_abs_err": err, **timed(lambda: pa.paged_attention(*args, **kw), 20)}
        del q, k, v, args, kw

        qkv = qkv32.to(dtype)
        eargs = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask)
        err = (ea.embed_attention(*eargs).float()
               - ea.embed_attention_reference(*eargs).float()).abs().max().item()
        if not err <= cs.EMBED_KERNEL_ATOL[name]:
            raise AssertionError(f"embed_attention {name}: max abs err {err}")
        res[f"embed_attention_{name}"] = {
            "max_abs_err": err, **timed(lambda: ea.embed_attention(*eargs), 50)}
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in eargs[:3])
        bmask = (mask > 0)[:, None, None, :]
        res[f"sdpa_embed_{name}"] = timed(
            lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bmask), 20)
        del qkv, eargs, qh, kh, vh
        torch.cuda.empty_cache()
    return res


def leg_serve(torch, cs, dev, *, runs=3, n_requests=8, n_new=32, cache_pages=1024):
    import asyncio

    import numpy as np

    from cordum_tpu_torch.models import llama
    from cordum_tpu_torch.worker.handlers import make_serving_engine

    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    params = llama.init_params(cfg, generator=gen, device=dev)
    rng = np.random.default_rng(cs.SEED + 2)
    lengths = np.linspace(8, 300, n_requests).astype(int).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    out = []
    for run in range(runs):
        engine = make_serving_engine(cfg, params, device=dev, cache_pages=cache_pages,
                                     max_new_tokens=n_new)
        t0 = time.monotonic()
        asyncio.run(cs.serve_waves(engine, [prompts], n_new, f"ab{run}"))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        st = engine.stats
        plan = list(getattr(engine.backend, "plan_seconds", []))
        out.append({
            "steps": st.steps, "wall_s": wall,
            "step_p50_ms": statistics.median(st.step_seconds) * 1e3,
            "ttft_p50_ms": statistics.median(st.ttft_seconds) * 1e3,
            "plan_p50_ms": statistics.median(plan) * 1e3 if plan else None,
        })
    res = {"runs": out[1:], "warmup": out[0]}
    from cordum_tpu_torch.ops import paged_attention as pa

    if hasattr(pa, "build_plan"):
        res["plan_parts"] = plan_parts(torch, cs, pa, cfg, dev)
    return res


def plan_parts(torch, cs, pa, cfg, dev, *, calls=500):
    """The plan's host time on the serving step's shape (24 tokens, 512
    pages a row): median ms of ``build_plan`` without a device (numpy
    only) and with the card (numpy and the copy)."""
    import numpy as np

    rows = cs.serving_rows()
    seq = np.full(24, len(rows), np.int32)
    pos = np.zeros(24, np.int32)
    ti = 0
    for s, (start, n) in enumerate(rows):
        seq[ti:ti + n], pos[ti:ti + n] = s, np.arange(start, start + n)
        ti += n
    kw = dict(page_size=16, pages_per_seq=512, n_heads=cfg.n_heads,
              n_kv_heads=cfg.n_kv_heads, dtype=cfg.dtype)
    out = {}
    for key, device in (("numpy_ms", None), ("with_copy_ms", dev)):
        ts = []
        for _ in range(calls):
            t0 = time.perf_counter()
            pa.build_plan(seq, pos, device=device, **kw)
            ts.append(time.perf_counter() - t0)
        out[key] = statistics.median(ts) * 1e3
    return out


def dense_digest(torch, cs, dev, shape, dtype):
    """sha256 of the forward's out and lse and the backward's dq, dk, dv on
    ``chip_smoke.dense_case``'s seeded inputs: equal digests in two trees
    mean bit-identical results."""
    import hashlib

    from cordum_tpu_torch.ops import dense_attention as da

    _, b, t, h, kvh, hd = shape
    q, k, v, do, pos = cs.dense_case(torch, dev, b, t, h, kvh, hd, dtype)
    fwd = da.dense_attention_fwd(q, k, v, pos)
    grads = da.dense_attention_bwd(q, k, v, pos, *fwd, do)
    digest = hashlib.sha256()
    for x in (*fwd[:2], *grads):
        digest.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()


def leg_dense(torch, cs, dev):
    """B9 at phase 7.1's shapes: ``measure_dense``'s gates, then its times."""
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def flush():
        flush_buf.zero_()

    card = torch.cuda.get_device_name(0)
    res = {}
    for shape in cs.DENSE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            got = cs.measure_dense(torch, dev, card, shape, dtype, flush)
            if "dq_fails" in got:
                res[f"{shape[0]}_{name}_dq_fails"] = got["dq_fails"]
            else:
                res[f"{shape[0]}_{name}_sha256"] = dense_digest(torch, cs, dev, shape, dtype)
            for kind in ("fwd", "bwd"):
                r = got[kind]
                res[f"{shape[0]}_{name}_{kind}"] = {
                    "ms": r["ms"], "plain_ms": r["plain_ms"], "sdpa_ms": r["library_ms"],
                    "bound_ms": r["bound_ms"], "max_abs_err": r["max_abs_err"]}
    return res


def leg_train(torch, cs, dev, *, batch=4, seq=2048, steps=10):
    """Phase 7.3's bf16 train steps: the step p50 over steps 2 on."""
    import dataclasses

    import numpy as np

    from cordum_tpu_torch.models import llama

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    init, step = llama.make_train_step(cfg, device=dev)
    params, state = init(cs.SEED)
    rng = np.random.default_rng(cs.SEED + 9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)).to(dev)
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, state, loss = step(params, state, toks)
        losses.append(loss.item())  # waits for the step
        secs.append(time.perf_counter() - t0)
    return {"step_p50_ms": statistics.median(secs[1:]) * 1e3, "loss_first": losses[0],
            "loss_last": losses[-1]}


def leg_pipe(torch, cs, dev, *, batch=4, seq=2048, steps=10, stages=2, micro=4):
    """Phase 11.2's bf16 pipeline train steps: the step p50 over steps 2
    on, and the peak memory of the run."""
    import dataclasses

    import numpy as np

    from cordum_tpu_torch.models import llama, pipeline

    base = dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2)
    cfg = pipeline.PipelineConfig(base=base, n_stages=stages, n_microbatches=micro)
    init, step = pipeline.make_train_step(cfg, device=dev)
    params, state = init(cs.SEED)
    rng = np.random.default_rng(cs.SEED + 31)
    toks = pipeline.microbatch(torch.from_numpy(
        rng.integers(0, base.vocab_size, (batch, seq)).astype(np.int32)).to(dev), micro)
    torch.cuda.reset_peak_memory_stats(dev)
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, state, loss = step(params, state, toks)
        losses.append(loss.item())  # waits for the step
        secs.append(time.perf_counter() - t0)
    return {"step_p50_ms": statistics.median(secs[1:]) * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "loss_first": losses[0], "loss_last": losses[-1]}


#: (N, E, k) of the route's other widths: DeepSeek- and Qwen-style expert
#: counts, and a larger batch of tokens
MOE_ROUTE_SHAPES = ((8192, 64, 8), (8192, 256, 8), (65536, 8, 2))


def leg_moe(torch, cs, dev, *, batch=4, seq=2048, steps=10):
    """B7 through ``measure_moe`` (gates, then times), the route at
    ``MOE_ROUTE_SHAPES``, then phase 9.3's bf16 MoE step p50 over steps 2
    on."""
    import dataclasses
    import gc

    import numpy as np

    from cordum_tpu_torch.models import moe

    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def flush():
        flush_buf.zero_()

    card = torch.cuda.get_device_name(0)
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for mode, r in cs.measure_moe(torch, dev, card, dtype, flush).items():
            res[f"{mode}_{name}"] = {key: r[key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
    from cordum_tpu_torch.ops import moe_dispatch as md

    for n, e, k in MOE_ROUTE_SHAPES:
        case = cs.moe_case(torch, dev, torch.float32, n=n, d=64, e=e, k=k)
        probs, cap = case["probs"], case["cap"]
        got, want = md.moe_route_kernel(probs, k, cap), md.moe_route_reference(probs, k, cap)
        if not all((a is None and b is None) or torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"moe_route N {n} E {e} k {k}: differs from the plain route")
        res[f"moe_route_N{n}_E{e}_k{k}"] = {"ms": cs.time_ms(
            torch, lambda: md.moe_route_kernel(probs, k, cap), iters=20, flush=flush),
            "library_ms": None}
    del flush_buf
    gc.collect()
    torch.cuda.empty_cache()
    cfg = cs.moe_config()
    cfg = dataclasses.replace(cfg, base=dataclasses.replace(cfg.base, n_layers=2))
    init, step = moe.make_train_step(cfg, device=dev)
    params, state = init(cs.SEED)
    rng = np.random.default_rng(cs.SEED + 11)
    toks = torch.from_numpy(rng.integers(0, cfg.base.vocab_size, (batch, seq))
                            .astype(np.int32)).to(dev)
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, state, loss = step(params, state, toks)
        losses.append(loss.item())  # waits for the step
        secs.append(time.perf_counter() - t0)
    res["train"] = {"step_p50_ms": statistics.median(secs[1:]) * 1e3,
                    "loss_first": losses[0], "loss_last": losses[-1]}
    return res


LEGS = {"kernels": leg_kernels, "serve": leg_serve, "dense": leg_dense, "train": leg_train,
        "moe": leg_moe, "pipe": leg_pipe}


def run_leg(leg: str, root: str) -> int:
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    import cordum_tpu_torch

    pkg = Path(cordum_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in pkg.parents:
        raise RuntimeError(f"cordum_tpu_torch came from {pkg}, not {root}")
    cs = load_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    res = LEGS[leg](torch, cs, dev)
    print(MARK + json.dumps(res), flush=True)
    return 0


def summarise(leg, results):
    """Per measure: each tree's legs and this tree's median over the
    other's."""
    lines = []

    def row(key, this, other):
        ratio = statistics.median(this) / statistics.median(other)
        lines.append(f"[ab] {leg} {key}: other {other} this {this} "
                     f"this/other {ratio:.4f}")

    by = {"this": [r for t, r in results if t == "this"],
          "other": [r for t, r in results if t == "other"]}
    if leg == "kernels":
        for name in by["this"][0]:
            for how in ("sleep", "nosleep"):
                row(f"{name} {how} ms", [r[name][how] for r in by["this"]],
                    [r[name][how] for r in by["other"]])
    elif leg == "dense":
        for name in by["this"][0]:
            if "ms" not in by["this"][0][name]:  # the dq fail counts and fp32 digests
                lines.append(f"[ab] dense {name}: other {[r[name] for r in by['other']]} "
                             f"this {[r[name] for r in by['this']]}")
                continue
            for key in ("ms", "plain_ms", "sdpa_ms"):
                row(f"{name} {key}", [r[name][key] for r in by["this"]],
                    [r[name][key] for r in by["other"]])
    elif leg in ("train", "pipe"):
        for key in ("step_p50_ms", "peak_gib") if leg == "pipe" else ("step_p50_ms",):
            row(key, [r[key] for r in by["this"]], [r[key] for r in by["other"]])
    elif leg == "moe":
        for name in by["this"][0]:
            keys = ("step_p50_ms",) if name == "train" else ("ms", "library_ms")
            for key in keys:
                if by["this"][0][name][key] is not None:
                    row(f"{name} {key}", [r[name][key] for r in by["this"]],
                        [r[name][key] for r in by["other"]])
    else:
        for key in ("step_p50_ms", "ttft_p50_ms", "wall_s"):
            row(key, [x[key] for r in by["this"] for x in r["runs"]],
                [x[key] for r in by["other"] for x in r["runs"]])
        plan = [x["plan_p50_ms"] for r in by["this"] for x in r["runs"]]
        parts = [r.get("plan_parts") for r in by["this"]]
        lines.append(f"[ab] serve plan_p50_ms (this tree): {plan}; alone: {parts}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="an unpacked tree to compare with")
    ap.add_argument("--legs", default="kernels,serve,dense,train")
    ap.add_argument("--out", default=str(HERE / "build" / "ab.json"))
    ap.add_argument("--leg", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.leg:
        return run_leg(a.leg, a.root)
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    if not a.other or not (Path(a.other) / "cordum_tpu_torch").is_dir():
        print("chip_ab: --other must name an unpacked tree", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[ab] {smi}", flush=True)
    report = {"device": smi, "legs": {}}
    summary = []
    other = str(Path(a.other).resolve())
    order = [("other", other), ("this", str(HERE)), ("this", str(HERE)), ("other", other)]
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    for leg in a.legs.split(","):
        results = []
        for i, (tag, root) in enumerate(order):
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--leg", leg, "--root", root],
                capture_output=True, text=True, timeout=900, cwd=root,
                env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
            # each process's own log (gates, device splits) beside the report
            Path(a.out).with_suffix(f".{leg}.{i}.{tag}.log").write_text(proc.stdout
                                                                      + proc.stderr)
            if proc.returncode:
                print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
                raise RuntimeError(f"leg {leg} on {tag} ({root}) exited {proc.returncode}")
            res = json.loads(next(x for x in proc.stdout.splitlines()
                                  if x.startswith(MARK))[len(MARK):])
            print(f"[ab] {leg} {tag} ({time.monotonic() - t0:.1f} s): {json.dumps(res)}",
                  flush=True)
            results.append((tag, res))
        report["legs"][leg] = results
        summary += summarise(leg, results)
    for line in summary:
        print(line, flush=True)
    report["summary"] = summary
    Path(a.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
