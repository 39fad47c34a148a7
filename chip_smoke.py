#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cordum_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernel is built for ``sm_90a``) and
``nvcc``; it builds the hand-written kernel from ``cordum_tpu_torch/csrc``
into ``build/`` and exits non-zero, printing no result, without a card.
Every phase raises on failure.  Phases:

1. Device: the card's name and power limit, the kernel build (with the
   ``-Xptxas -v`` report when it compiles), TF32 turned off.
2. Kernel vs plain version at the main path's shapes (Llama-3-8B heads:
   h 32, kvh 8, hd 128; page size 16, a 24-token buffer over 8 sequences,
   512 pages a row for an 8192-token context, a 1200-page arena) on one
   buffer mixing decode rows, a prefill chunk across a page boundary, a
   draft row and padding, in fp32 and bf16, with times.
3. fp32 serving oracle at Llama-3-8B width, depth cut to 2 layers: the
   serving entry point (``make_serving_engine``) must emit exactly the
   tokens of a dense greedy oracle (``forward`` over the growing sequence)
   with speculative decoding off and on, through prefix sharing and a
   copy-on-write page copy.
4. bf16 Llama-3-8B, all 32 layers, random weights from a seeded CUDA
   generator: 8 requests served to completion through the same entry
   point; TTFT p50, decode tokens/s, peak memory; then the same requests
   once more under ``torch.profiler`` for where the device time goes.

Tolerances (kernel vs plain version, max abs error): fp32 1e-4 — the sums
run in another order over up to 8192 keys, on O(1) outputs; bf16 6e-2 —
the plain version rounds scores and probabilities to bf16 before the PV
product while the kernel keeps both in fp32, a few bf16 ulps (2^-8
relative) on outputs of magnitude up to ~3.

Near-tie rule of phase 3, fixed before any run: tokens are compared up to
the first generated position where the oracle's top-2 logits differ by
less than 1e-4 (fp32 sums in another order may flip such a tie); the
number of such positions is printed.

The line before the last two is a JSON object with each kernel's numbers;
then the ``nvidia-smi`` name and power-limit line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 without tensor cores; bf16 dense
KERNEL_ATOL = {"float32": 1e-4, "bfloat16": 6e-2}
NEAR_TIE = 1e-4
SEED = 0
KERNEL_SOURCE = "cordum_tpu_torch/csrc/paged_attention.cu"
REPLACES = "cordum_tpu/models/llama.py:467"


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------


def attention_case(torch, dev, *, h=32, kvh=8, hd=128, ps=16, s_rows=8,
                   p_cols=512, num_pages=1200, seed=SEED):
    """One ragged buffer at the main path's shapes: five decode rows (the
    longest at the last position an 8192-token context holds), a 12-token
    prefill chunk crossing a page boundary, a draft row of k+1 = 5 tokens
    and two padding tokens on the null row.  Returns fp32 operands."""
    rng = np.random.default_rng(seed)
    rows = [(5, 1), (300, 1), (1500, 1), (4000, 1), (p_cols * ps - 1, 1),
            (10, 12), (2040, 5)]  # (start, n) per sequence
    t_buf = 24
    tables = np.zeros((s_rows + 1, p_cols), np.int32)
    free = rng.permutation(np.arange(1, num_pages)).tolist()
    tokens_pos = np.zeros(t_buf, np.int32)
    token_seq = np.full(t_buf, s_rows, np.int32)
    ti = 0
    for s, (start, n) in enumerate(rows):
        need = (start + n - 1) // ps + 1
        tables[s, :need] = [free.pop() for _ in range(need)]
        tokens_pos[ti:ti + n] = np.arange(start, start + n)
        token_seq[ti:ti + n] = s
        ti += n
    assert ti <= t_buf
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((t_buf, h, hd), generator=g, device=dev)
    k = torch.randn((num_pages, ps, kvh, hd), generator=g, device=dev)
    v = torch.randn((num_pages, ps, kvh, hd), generator=g, device=dev)
    meta = [torch.from_numpy(a).to(dev) for a in (tables, token_seq, tokens_pos)]
    return q, k, v, *meta


def work_of(q, k, tables, token_seq, positions):
    """Bytes the call must move (q read, out written, the K/V pages the
    buffer's sequences reach, counted once, and the metadata it reads) and
    the operations it does (QK and PV: 4*hd per key and query head)."""
    t, h, hd = q.shape
    _, ps, kvh, _ = k.shape
    el = q.element_size()
    tab = tables.cpu().numpy()
    seq = token_seq.cpu().numpy()
    pos = positions.cpu().numpy()
    pages = set()
    table_reads = 0
    for s in np.unique(seq):
        n = int(pos[seq == s].max()) // ps + 1
        pages.update(tab[s, :n].tolist())
        table_reads += n
    kv_bytes = len(pages) * ps * kvh * hd * el * 2
    nbytes = 2 * t * h * hd * el + kv_bytes + 4 * (2 * t + table_reads)
    ops = 4 * h * hd * int((pos.astype(np.int64) + 1).sum())
    return nbytes, ops


def time_ms(torch, fn, *, iters, flush):
    """Median CUDA-event time of ``fn`` with the L2 cache flushed before
    each launch (the serving step finds each layer's pages cold)."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def phase_kernel(torch, dev, card):
    from cordum_tpu_torch.ops import paged_attention as pa

    import torch.nn.functional as F

    q32, k32, v32, tables, token_seq, positions = attention_case(torch, dev)
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v = (x.to(dtype) for x in (q32, k32, v32))
        args = (q, k, v, tables, token_seq, positions)
        got = pa.paged_attention(*args)
        torch.cuda.synchronize()
        want = pa.paged_attention_reference(*args)
        err = (got.float() - want.float()).abs().max().item()
        if not (err <= KERNEL_ATOL[name]) or not torch.isfinite(got).all():
            raise AssertionError(
                f"kernel vs plain {name}: max abs err {err} > {KERNEL_ATOL[name]}")
        # the library yardstick: SDPA over K/V already gathered and expanded
        # to the query heads (the gather itself is left out of its time)
        t, h, hd = q.shape
        kvh = k.shape[2]
        pt_tok = tables[token_seq.long()].long()
        kc = k[pt_tok].reshape(t, -1, kvh, hd).repeat_interleave(h // kvh, 2)
        vc = v[pt_tok].reshape(t, -1, kvh, hd).repeat_interleave(h // kvh, 2)
        kh, vh = kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()
        del kc, vc
        qh = q[:, :, None, :]
        mask = (torch.arange(kh.shape[2], device=dev)[None, :]
                <= positions[:, None])[:, None, None, :]
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)[:, :, 0]
        lib_err = (lib_out.float() - want.float()).abs().max().item()

        def flush():
            flush_buf.zero_()

        kernel_ms = time_ms(torch, lambda: pa.paged_attention(*args), iters=20, flush=flush)
        plain_ms = time_ms(torch, lambda: pa.paged_attention_reference(*args), iters=5, flush=flush)
        library_ms = time_ms(
            torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
            iters=10, flush=flush)
        del kh, vh, lib_out
        nbytes, ops = work_of(q, k, tables, token_seq, positions)
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS[name] * 1e3
        bound_ms = max(mem_ms, ops_ms)
        results[name] = dict(
            max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms, bound_by="bytes" if mem_ms >= ops_ms else "operations",
        )
        log(f"[kernel] {name}: max_abs_err {err:.3e} (tolerance {KERNEL_ATOL[name]:.0e}), "
            f"sdpa vs plain {lib_err:.3e}")
        log(f"[kernel] {name}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
            f"library_ms {library_ms:.4f}  bound_ms {bound_ms:.4f} "
            f"({results[name]['bound_by']}: {nbytes} bytes, {ops} ops)  [{card}]")
        torch.cuda.empty_cache()
    del flush_buf
    return results


# ---------------------------------------------------------------------------
# phase 3: fp32 serving oracle
# ---------------------------------------------------------------------------


def dense_greedy(torch, llama, params, cfg, prompt, n_new, dev):
    """The sequential oracle: ``forward`` over the growing sequence, greedy
    argmax.  Returns the tokens and the generated positions whose top-2
    logits differ by less than the near-tie threshold."""
    toks, out, ties = list(prompt), [], []
    with torch.no_grad():
        for i in range(n_new):
            logits = llama.forward(params, torch.tensor([toks], device=dev), cfg)[0, -1]
            top = torch.topk(logits.float(), 2).values
            if (top[0] - top[1]).item() < NEAR_TIE:
                ties.append(i)
            nxt = int(torch.argmax(logits))
            out.append(nxt)
            toks.append(nxt)
    return out, ties


def serving_prompts(vocab, seed=SEED):
    """Wave 1: four concurrent prompts of 5 to 300 tokens, one opening with
    a 16-token system page.  Wave 2: the system page plus a new turn (a
    prefix hit), the system page alone (the hit ends at the prompt's end,
    so its last token is written into the shared page: copy-on-write), and
    a repetitive prompt for the n-gram drafter."""
    rng = np.random.default_rng(seed + 1)

    def rand(n):
        return rng.integers(0, vocab, n).tolist()

    system = rand(16)
    wave1 = [rand(5), system + rand(24), rand(150), rand(300)]
    a, b = rand(2)
    wave2 = [system + rand(20), list(system), [a, b] * 12]
    return wave1, wave2


async def serve_waves(engine, waves, n_new, tag, emits=None):
    """Submit each wave's prompts concurrently, wave after wave; returns
    the generated tokens.  ``emits``, when given, collects one
    ``(monotonic time, request, tokens)`` entry per streamed packet."""
    from cordum_tpu_torch.serving.engine import GenRequest

    def sink(key):
        async def on_tokens(new, n_generated, done):
            emits.append((time.monotonic(), key, len(new)))
        return on_tokens

    outs = []
    for w, prompts in enumerate(waves):
        res = await asyncio.gather(*[
            engine.submit(GenRequest(prompt=p, max_new_tokens=n_new,
                                     stream=emits is not None),
                          job_id=f"{tag}-{w}-{i}",
                          on_tokens=None if emits is None else sink(f"{w}-{i}"))
            for i, p in enumerate(prompts)
        ])
        outs.extend(r["tokens"] for r in res)
    await engine.stop()
    return outs


def decode_rate(emits):
    """Per-request decode tokens/s, p50 over requests: the tokens streamed
    after a request's first packet over the time from it to its last."""
    by_key = {}
    for t, key, n in emits:
        by_key.setdefault(key, []).append((t, n))
    rates = [sum(n for _, n in ev[1:]) / (ev[-1][0] - ev[0][0])
             for ev in by_key.values() if len(ev) > 1 and ev[-1][0] > ev[0][0]]
    return statistics.median(rates) if rates else float("nan")


def phase_oracle(torch, dev, card, cfg, *, n_new=16):
    from cordum_tpu_torch.models import llama
    from cordum_tpu_torch.ops import paged_attention as pa
    from cordum_tpu_torch.worker.handlers import make_serving_engine

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = llama.init_params(cfg, generator=gen, device=dev)
    waves = serving_prompts(cfg.vocab_size)
    prompts = [p for w in waves for p in w]
    oracle = [dense_greedy(torch, llama, params, cfg, p, n_new, dev) for p in prompts]
    n_ties = sum(len(t) for _, t in oracle)
    launches = 0
    for speculative in (False, True):
        engine = make_serving_engine(cfg, params, device=dev, speculative=speculative,
                                     max_new_tokens=n_new)
        pa.paged_attention.launches = 0
        outs = asyncio.run(serve_waves(engine, waves, n_new, f"spec{int(speculative)}"))
        run_launches = pa.paged_attention.launches
        st = engine.stats
        engine.allocator.check_consistency()
        for p, out, (want, ties) in zip(prompts, outs, oracle):
            upto = ties[0] if ties else n_new
            if out[:upto] != want[:upto] or len(out) != n_new:
                raise AssertionError(
                    f"speculative={speculative}: prompt of {len(p)} tokens served "
                    f"{out}, oracle {want} (compared up to {upto})")
        if run_launches != cfg.n_layers * st.steps or run_launches == 0:
            raise AssertionError(
                f"kernel launches {run_launches} != layers {cfg.n_layers} x steps {st.steps}")
        if st.prefix_hits < 1 or st.cow_copies < 1:
            raise AssertionError(f"prefix sharing did not run: {st}")
        if speculative and st.drafted_tokens < 1:
            raise AssertionError("speculative run drafted nothing")
        if engine.backend.compiled_programs() != 1:
            raise AssertionError("more than one step shape")
        launches += run_launches
        log(f"[oracle] fp32 speculative={speculative}: {len(prompts)} requests token-identical "
            f"to the dense oracle; steps {st.steps}, launches {run_launches} "
            f"(= {cfg.n_layers} layers x {st.steps} steps), prefix hits {st.prefix_hits}, "
            f"cow copies {st.cow_copies}, drafted {st.drafted_tokens}, "
            f"accepted {st.accepted_tokens}")
    log(f"[oracle] near-tie positions (top-2 gap < {NEAR_TIE:g}): {n_ties}  [{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 4: bf16 Llama-3-8B
# ---------------------------------------------------------------------------


def phase_serve(torch, dev, card, cfg, *, n_requests=8, n_new=32, cache_pages=1024):
    from cordum_tpu_torch.models import llama
    from cordum_tpu_torch.ops import paged_attention as pa
    from cordum_tpu_torch.worker.handlers import make_serving_engine

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.monotonic()
    params = llama.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.n_layers}-layer bf16 weights initialised in {time.monotonic() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 2)
    lengths = np.linspace(8, 300, n_requests).astype(int).tolist()
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]
    engine = make_serving_engine(cfg, params, device=dev, cache_pages=cache_pages,
                                 max_new_tokens=n_new)
    torch.cuda.reset_peak_memory_stats(dev)
    pa.paged_attention.launches = 0
    emits = []
    t0 = time.monotonic()
    outs = asyncio.run(serve_waves(engine, [prompts], n_new, "serve", emits))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = pa.paged_attention.launches
    st = engine.stats
    engine.allocator.check_consistency()
    for out in outs:
        if len(out) != n_new or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"bad output {out}")
    if launches != cfg.n_layers * st.steps or launches == 0:
        raise AssertionError(
            f"kernel launches {launches} != layers {cfg.n_layers} x steps {st.steps}")
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    ttft = sorted(st.ttft_seconds)
    step_ms = statistics.median(st.step_seconds) * 1e3
    log(f"[serve] {n_requests} requests, prompts {lengths[0]}..{lengths[-1]} tokens, "
        f"{n_new} new each: wall {wall:.3f} s, steps {st.steps}, "
        f"TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms, "
        f"decode p50 {decode_rate(emits):.1f} tokens/s per request, "
        f"output {st.decoded_tokens / wall:.1f} tokens/s (whole run), step p50 {step_ms:.2f} ms, "
        f"peak memory {peak_gib:.2f} GiB, launches {launches}, "
        f"drafted {st.drafted_tokens} accepted {st.accepted_tokens}  [{card}]")
    profile_serving(torch, dev, card, cfg, params, prompts, cache_pages=cache_pages)
    return launches


def profile_serving(torch, dev, card, cfg, params, prompts, *, n_new=8, cache_pages=1024):
    """Where a serving step's device time goes: the same prompts once more
    (a fresh engine, fewer new tokens) under ``torch.profiler``; device time
    by kernel, the paged-attention kernel's share, and the device's busy
    share of the window's wall time.  Informational: it gates nothing."""
    from torch.profiler import ProfilerActivity, profile

    from cordum_tpu_torch.worker.handlers import make_serving_engine

    engine = make_serving_engine(cfg, params, device=dev, cache_pages=cache_pages,
                                 max_new_tokens=n_new)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        asyncio.run(serve_waves(engine, [prompts], n_new, "profile"))
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0]
    total = sum(r[1] for r in rows)
    if not total:
        log("[profile] the profiler recorded no device time")
        return
    rows.sort(key=lambda r: -r[1])
    attn = sum(r[1] for r in rows if "paged_attention" in r[0])
    log(f"[profile] {engine.stats.steps} steps, wall {wall_us / 1e3:.1f} ms, device busy "
        f"{total / 1e3:.1f} ms ({100 * total / wall_us:.1f}% of wall), paged_attention "
        f"{attn / 1e3:.2f} ms ({100 * attn / total:.1f}% of device time)  [{card}]")
    for key, us, count in rows[:8]:
        log(f"[profile]   {us / 1e3:9.2f} ms {100 * us / total:5.1f}%  x{count:<6d} {key[:90]}")


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from cordum_tpu_torch.models import llama
    from cordum_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    t0 = time.monotonic()
    path, build_log = pa.build()
    log(f"[device] kernel library {path} ({time.monotonic() - t0:.1f} s)")
    if build_log:
        log(build_log.rstrip())

    kernel = phase_kernel(torch, dev, smi)
    torch.cuda.empty_cache()

    cfg8b = llama.LlamaConfig.llama3_8b()
    fp32_launches = phase_oracle(
        torch, dev, smi, dataclasses.replace(cfg8b, n_layers=2, dtype=torch.float32))
    torch.cuda.empty_cache()
    bf16_launches = phase_serve(torch, dev, smi, cfg8b)

    launches = {"float32": fp32_launches, "bfloat16": bf16_launches}
    line = {"kernels": [
        {"name": f"paged_attention_{name}", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": launches[name], **kernel[name]}
        for name in ("bfloat16", "float32")
    ]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
