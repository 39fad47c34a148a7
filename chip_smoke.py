#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cordum_tpu_torch``) on one card.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for ``sm_90a``) and
``nvcc``; it builds the hand-written kernels from ``cordum_tpu_torch/csrc``
into ``build/`` and exits non-zero, printing no result, without a card.
Every phase raises on failure.  Phases:

1. Device: the card's name and power limit, the kernel builds (one
   ``nvcc`` per source, started together; the ``-Xptxas -v`` report when
   they compile), TF32 turned off.
2. Kernel vs plain version at the main path's shapes (Llama-3-8B heads:
   h 32, kvh 8, hd 128; page size 16, a 24-token buffer over 8 sequences,
   512 pages a row for an 8192-token context, a 1200-page arena) on one
   buffer mixing decode rows, a prefill chunk across a page boundary, a
   draft row and padding, in fp32 and bf16, with times and each kernel's
   share of its bound; then, informational, the same at phase 4's own step
   shape (8 sequences of 8-300 tokens, decode rows and one prefill chunk).
   The step's plan is built once per buffer, as the serving step does.
3. fp32 serving oracle at Llama-3-8B width, depth cut to 2 layers: the
   serving entry point (``make_serving_engine``) must emit exactly the
   tokens of a dense greedy oracle (``forward`` over the growing sequence,
   on the dense attention's plain version, so the oracle does not run the
   kernels it judges) with speculative decoding off and on, through prefix
   sharing and a copy-on-write page copy.
4. bf16 Llama-3-8B, all 32 layers, random weights from a seeded CUDA
   generator: 8 requests served to completion through the same entry
   point; TTFT p50, decode tokens/s, peak memory, the host time of each
   step's paged-attention plan; then the same requests once more under
   ``torch.profiler`` for where the device time goes.
5. The embedder's attention kernel vs its plain version at the shape of a
   full micro-batch (B 256, L 128, h 4, hd 64; rows of mixed lengths, one
   all-pad row, one length-1 row, q/k/v as views of one fused projection),
   fp32 and bf16, with times, the bound and SDPA's time as the yardstick.
6. The port ``Worker`` on the card, built with
   ``attach_default_gpu_worker`` over the port's ``LoopbackBus`` and
   ``MemoryStore``; the script plays the scheduler, publishing
   ``JobRequest`` s to the worker's subject.  One worker serves phase 3's
   fp32 2-layer model with an fp32 embedder: its ``llm.generate`` results
   must equal phase 3's dense oracle, its embeddings the plain-version
   embedder's.  One serves phase 4's bf16 Llama-3-8B weights (no second
   copy) with the default bf16 embedder: ``echo``, ``matmul``, ``infer``
   (its ``forward`` launches the dense attention kernel, counted),
   ``embed`` one job at a time and coalesced by the micro-batcher, and
   ``llm.generate``; its heartbeat must name the card.  Prints echo
   jobs/s, p50 dispatch→result per op, single-job and batched embeds/s
   and TTFT p50 through the worker.
7. Training, once phase 4's weights are freed.  (1) The dense attention
   kernels (B9, forward and backward) against autograd of their plain
   version on the same seeded inputs and ``dO``, at the main shape
   (Llama-3-8B heads: B 4, T 2048, H 32, KVH 8, hd 128) and at
   ``LlamaConfig()``'s (B 8, T 2048, H 8, KVH 4, hd 64), bf16 and fp32,
   with times, bounds and SDPA (``is_causal``, K/V expanded) as the
   yardstick, forward alone and backward alone; first the ptxas report of
   every B9 kernel (registers, spills) from the build, and each backward
   run twice, which must give the same bits.  (2) An fp32 train-step
   oracle at Llama-3-8B widths, depth cut to 2 layers: B 2, T 256, 3
   AdamW steps on seeded batches, the B9 path against the plain-attention
   path from one initial copy of the params, one path after the other.
   (3) A bf16 run at the same widths, B 4, T 2048, 10 steps on one batch:
   the loss falls; step p50, tokens/s, peak memory, then two steps under
   ``torch.profiler``.  (4) ``train`` jobs through a port worker: a
   ``llama`` job (``LlamaConfig()``, B 8, T 2048, 6 steps, a checkpoint
   every 2) cancelled after step 2 (the runner waits for the cancel sent
   when step 2 reports), re-dispatched to resume from step 2 and complete;
   then a ``llama-tiny`` job; result keys as the reference's.
8. The worker as its own process: ``python -m cordum_tpu_torch.cmd.statebus``
   and ``python -m cordum_tpu_torch.cmd.worker`` (``LlamaConfig.tiny()`` in
   fp32, the default bf16 embedder, micro-batches up to 256 rows) as
   subprocesses; this script plays the dispatcher over TCP with the port's
   statebus client: 2000 ``echo`` jobs with 200 in flight, ``matmul``,
   ``infer``, ``embed`` one at a time and 512 texts coalesced, and 8
   ``llm.generate`` prompts whose tokens must equal a dense greedy run on
   the worker's own weights (drawn here from a generator on the card seeded
   as the worker seeds its own); embeddings against the plain-version
   embedder; the heartbeat names the card and a telemetry beacon arrives;
   SIGTERM drains the worker to exit 0 with no cancelled session; the
   kernel launches are the worker process's own (its exit line).  Prints
   echo jobs/s, p50 dispatch→result per op, embeds/s and TTFT p50 beside
   phase 6's (informational).  Both processes are stopped on every path.
9. The MoE family, once phase 8 is done.  (1) The MoE kernels (B7: the
   route, the slot gather plain and scaled, the token gather weighted,
   unweighted and as a dot; a kernel row each) against the plain versions
   (the reference's sort, cumsum and dense one-hot einsums, and autograd
   of them) at Mixtral-8x7B's layer widths on the Llama-3-8B base (N 8192
   = B 4 x T 2048, D 4096, 8 experts, top 2, capacity 2560), bf16 and
   fp32, forward
   and backward, each backward twice (the same bits); then a capacity-drop
   case (capacity factor 0.25, three quarters of the tokens routed to one
   expert) and an exact-tie case; times against the bounds, the plain
   versions and the library calls (``index_select`` for the dispatch,
   ``embedding_bag`` for d_out, the combine and the dispatch backward; no
   one call computes the route or d_w), and each row's device us per CUDA
   kernel (the route's pick and place launches apart); then the token
   gathers at k 36 of E 40 (more than 32 kept slots a token) to their
   n-term bound (``check_token_gathers``).  (2) An fp32 oracle at those
   widths, depth cut to 2 layers, B 2, T 256: ``moe.loss_fn`` and every
   gradient on the kernel path (B7 + B9) against the plain path, one copy
   of the params, no optimizer step; at capacity factor 1.25 and again at
   0.5, where layer 0 drops slots to the residual path.  (3)
   A bf16 run at the same widths and cut, B 4, T 2048, 10 steps on one
   batch: the loss falls; step p50, tokens/s, peak memory, then two steps
   under ``torch.profiler`` with B7's and B9's shares of device time.  (4)
   ``train`` jobs through a port worker: ``moe-tiny`` (B 8, T 128, 6 steps,
   a checkpoint every 2) cancelled after step 2 and resumed, then ``moe``;
   result keys as the reference's, the mesh's ``ep`` 1.  B7 and B9 launches
   equal layers x steps in (2)-(4).

10. Serving gangs, once phase 9 is done.  (1) B1 at a tensor-parallel
    rank's heads: Llama-3-8B at tp 2 (h 16, kvh 4, hd 128) on phase 2's
    8192-token case, bf16 and fp32, phase 2's gates (its own kernel row).
    (2) An fp32 oracle of ``ServingGangGroup(tp=2)`` on the card: two
    ranks as threads of this process over in-process gloo groups (CUDA
    tensors staged through host memory), each holding its slices
    (``reduced``: n_layers 32 -> 2), on phase 3's weights (drawn again from
    the seed) and prompts, speculative off and on: tokens equal to phase
    3's single-rank engine and to the dense oracle under the near-tie
    rule, B1 launches = 2 ranks x layers x steps, one step shape a rank;
    then one session's per-rank export merged and held to one rank's
    export (within d_ff x 2^-24 of each record's largest value, the CPU
    tests' rule), imported into a single-rank backend that decodes on to
    the oracle's tokens.  (3) bf16 Llama-3-8B at tp 2, all 32 layers, as
    two rank processes of this script on the one card (``--gang-rank``):
    each draws its slices leaf by leaf from the seed, they meet at a
    TCPStore and join a gloo group; rank 0 serves phase 4's 8 requests
    through a ``ServingEngine`` over ``ShardedServingBackend(rank=0)``,
    putting each step's entries into the store ahead of the step, and rank
    1 replays them (``StepReplay``, the replay of a gang worker's
    followers, with the store for the statebus); each rank's peak memory (below the peak of phase 4's
    own weights and serving, gated), step p50, TTFT p50, output tokens/s,
    host time inside the all-reduces, then a shorter run under
    ``torch.profiler`` (device busy share, the all-reduces' part of it);
    gated on B1 launches = 32 x steps
    on each rank and each rank's parameter bytes below the whole model's;
    no token gate in bf16 and no speed gate.  (4) A serving gang job
    through two port worker processes (``WORKER_GANG=1``) over the TCP
    statebus, this script playing the gang scheduler (the gang labels on
    each member's ``JobRequest``): the reference's payload (tiny config,
    fp32, a seed); ``ready`` then ``done`` from both ranks, rank 0's
    tokens equal to a dense greedy run on the seed's weights (near-tie
    rule), ``steps_replayed == steps``, only rank 0 streams, B1 launches =
    layers x steps in each process; then a ``gang_test`` failing rank 1
    (rank 1 aborts, rank 0 leaves its spin: both heartbeats show no active
    job), then a ``gang_echo`` that both finish; SIGTERM drains both.
    ``--cards``, on two or more cards (:func:`main_cards`): 10.3's rank
    processes one a card (NCCL) at tp 2 and 4, in fp32 (2 layers) held to
    phase 3's oracle and one rank, then in bf16 beside phase 4.
11. The pipeline family and MPMD gangs, once phase 10 is done.  (1) An
    fp32 oracle at Llama-3-8B widths (``reduced``: n_layers 32 -> 2; S 2,
    one layer a stage; M 2, B 2, T 256): the pipeline loss and every
    gradient on the B9 path against the pipeline's plain-attention path and
    against ``llama.loss_fn`` on the same weights unstacked, one copy of the
    params, no optimizer step; B9 launches = layers x M.  (2) A bf16 run at
    the same widths and cut, S 2, M 4, B 4, T 2048 (7.3's 8192 tokens a
    step), 10 steps on one batch with the pipeline's AdamW (weight decay
    1e-4): the loss falls; step p50, tokens/s and peak memory beside 7.3's
    dense step, then two steps under ``torch.profiler``.  (3) ``pipeline``
    train jobs through a port worker (``LlamaConfig.tiny()``, 6 steps, a
    checkpoint every 2), cancelled after step 2 and resumed, then one at M
    4; result keys as the reference's, ``mesh.pp`` 1.  (4) An MPMD gang job
    (pp 2) through two port worker processes over the TCP statebus: both
    ranks done with ``mode: "mpmd"``, rank 0's loss None, rank 1's first
    loss equal to the one-process pipeline loss (plain attention) on the
    weights and tokens the seed draws, each process's B9 launches = its
    stage's layers x microbatches x steps; the workers run with
    ``WORKER_GANG_ADDR`` set to a non-loopback address of the host (skipped,
    and said so, where it has none), and a serving gang job whose store
    rank 0 advertises there must be token-identical to the dense greedy
    run; SIGTERM drains both.
12. Multi-rank training over a rank mesh (``TrainMesh``), once phase 11
    is done: rank processes started by the package's launcher
    (``cordum_tpu_torch.parallel.launch.run_ranks``, the target
    :func:`mesh_rank`), each joining the mesh at the launcher's TCPStore,
    drawing its slice of the one-process
    weights from the seed and taking the whole batch; every leg's
    one-process step runs first on card 0 and is freed (its losses, first
    gradients and last params written to files the ranks read), and each
    rank is held to it.  (1) The pipeline at pp 2 x dp 1, 11.1's
    configuration (fp32, Llama-3-8B widths, ``reduced``: n_layers 32 ->
    2; M 2, B 2, T 256), one AdamW step, two processes sharing the card
    over gloo.  (2) dp 2 x pp 2, fp32, ``LlamaConfig.tiny()`` with 4
    layers, M 2, B 4, T 64, 3 steps on one batch, four processes; the
    loss falls.  Every rank's B9 launches = its stage's layers x
    microbatches x steps.  ``--cards`` (:func:`cards_train_legs`), one
    rank a card over NCCL: (3) fp32 at 8B widths, 4 layers, B 4, T 256,
    one step: pp 4 (M 4), dp 2 x pp 2 (M 2) and dense dp 4, each held to
    its one-process step; (4) bf16 Llama-3-8B at all 32 layers, 8192
    tokens a step (B 4, T 2048), 10 steps on one batch at pp 4 (M 4) and
    dp 2 x pp 2 (M 2): the loss falls; step p50, tokens/s, tokens/s a
    card, peak memory and host time in the collectives a rank, two steps
    profiled on the first and last stage beside the bubble model; (5)
    phase 7.3's run on card 0, then dense dp 4 at 7.3's configuration a
    rank.
13. Ring attention over the sp line, once phase 12 is done.  (1) B9's
    ring entries and the merge kernel (B6) at a tp 2 x sp 2 rank of
    Llama-3-8B at T 8192 (B 1, chunks of 4096, H 16, KVH 4, hd 128),
    bf16 and fp32: rank 1's queries against rank 0's chunk (every key
    live) and against its own diagonal chunk, the forward, "D only" and
    "D given" against their plain versions by 7.1's gates (the row's
    exact lse, output and D fed to every version; each chunk's lse
    within 1e-3 of the plain version's), the merge of the two chunks'
    pairs; then the whole ring of rank 1 and of rank 0 built chunk by
    chunk against ``gqa_attention`` on the whole row by 7.1's gates;
    times (CUDA events, L2 flushed) against the bounds, the plain
    versions and SDPA (unmasked with ``enable_gqa`` for the earlier chunk,
    ``is_causal`` for the diagonal; none for "D only" and the merge).
    (2) ``use_ring_attention`` rank processes sharing the card over gloo:
    fp32 ``LlamaConfig.tiny()`` with 4 layers at tp 2 x sp 2 and at sp 4,
    held to the one-process step as 12.7 is; bf16 at 12.8's job (8B
    widths, 2 layers, tp 2 x sp 2, T 4096): a falling loss, its first
    loss within 1e-2 relative of 12.8's, and 12.4's numbers beside
    12.8's.  Every rank's launches and hops are the design's
    (:func:`ring_design`: rank r of the sp line runs r + 1 chunks a
    layer) and it makes no all-gather or reduce-scatter.  ``--cards``:
    (3) the ring at sp 4, tp 2 x sp 2 and dp 2 x sp 2 at 12.9's fp32
    configuration, held to its oracle; (4) the ring at 12.10's bf16
    Llama-3-8B tp 2 x sp 2 leg (32 layers, B 1, T 8192), beside that leg
    in the same call.
14. Expert parallelism, the MoE family over dp x tp x ep, once phase 13 is
    done.  (1) B7's route with a room (a dp rank's: the rows the lower dp
    ranks' tokens leave each expert; the pick, the room from its counts,
    then the place) against its plain version, equal (the integers), at
    9.1's shape (N 8192, E 8, top 2) with the capacity of a dp 2 mesh's
    whole batch (C 5120): rank 1's room after a random rank 0, a room of 0
    (rank 0 sends three quarters of its tokens to expert 0), every token
    of rank 1 to one expert, exact ties; rank 1's kept slots equal to the
    whole batch's route's rows; the dispatch and combine of rank 1 of
    an ep 2 line (experts 4-7, the other pairs' idx negative or past 3)
    against the plain versions; times by 9.1's method beside the route
    without a room.  (2) MoE rank processes sharing the card over gloo:
    fp32 ``LlamaConfig.tiny()`` widths (E 4, top 2, 4 layers, capacity
    factor 0.5, a router skewed to expert 0: tokens drop) at dp 2 x ep 2,
    tp 2 x ep 2 and ep 4, held to the one-process step as 12.7 is; bf16 at
    Mixtral-8x7B widths (9.3's config and batch, 2 layers) at ep 2: a
    falling loss, its first loss within 1e-2 relative of 9.3's one-card
    run.  Every rank's B7 and B9 launches are layers x steps, the route
    with a room's too where dp is above 1, else none.  ``--cards``
    (``--legs moe``): (3) fp32 Mixtral widths, 2 layers, B 2, T 256, one
    AdamW step, skewed and at capacity factor 0.5: ep 4, dp 2 x ep 2 and
    tp 2 x ep 2, each held to its one-process step on card 0; (4) bf16
    Mixtral widths at 8 of 32 layers, 9.3's batch (B 4, T 2048), 10 steps:
    ep 4 and tp 2 x ep 2, a falling loss; step p50, tokens/s a card, peak
    memory a rank and host ms a step in the collectives.
15. The driver's entry points (``cordum_tpu_torch/graft_entry.py``), once
    phase 14 is done.  (1) ``entry()``'s forward at the reference's entry
    widths (Llama, vocab 32000, d 512, 4 layers, bf16, tokens [4, 128]):
    finite logits, B9 once a layer, and in fp32 the kernel path held to
    the plain path.  (2) ``dryrun_multichip(1)``: one rank process of the
    package's launcher on the card, every axis 1, the dense, MoE and
    pipeline steps (``LlamaConfig.tiny()`` widths, 2 layers; M 2), each
    loss equal to the one-process step's on the same draws.  (3) A
    ``train`` job of each family (``llama-tiny``, ``moe-tiny``,
    ``pipeline``; B 4, T 32, 3 steps on one batch) through ``TrainRunner``
    at world 1: the reference's keys, every axis 1, a falling loss.  B9 and
    B7 launches as each step's design gives.  ``--cards`` (``--legs
    dryrun``, four cards): a port worker that owns the four cards: an
    ``embed`` job at ``WORKER_TP`` 2 (two replicas of the fp32 embedder,
    one a card) equal to one card's embeddings of each replica's block and
    near one card's of the whole batch, its heartbeat's ``chip_count`` 4,
    and an fp32 ``train`` job of each family over the four cards (rank
    processes, mesh as the reference resolves it) held to the same job on
    one card; then ``dryrun_multichip(4)`` over NCCL, one rank a card
    (dense tp 2 x sp 2, MoE tp 2 x ep 2, pipeline dp 2 x pp 2), in bf16
    and in fp32 in one launch, the losses finite and equal on every rank,
    each fp32 loss held to the one-process step on card 0.
16. The scheduler service, run right after phase 6 on phase 6's bf16
    worker (Llama-3-8B, the default bf16 embedder; the same weights), and
    after phase 8 as processes.  The port's ``Engine`` is built as
    ``python -m cordum_tpu_torch.cmd.scheduler`` builds it by default: the
    embedded ``SafetyKernel`` on ``config/safety.yaml``,
    ``ThroughputAwareStrategy`` with its capacity view, serving placer and
    decode rebalancer, and the native C scan (built with ``cc`` into
    ``build/``; a failed build fails the phase).  Jobs are submitted on
    ``sys.job.submit`` as the gateway submits them (context in the KV, a
    PENDING record, the request).  The pools document is phase 16's own
    (``SCHED_POOLS``: ``job.gpu.>`` to pool ``gpu``, which requires
    ``gpu`` and one card).  (1) Phase 6's ``echo``, ``infer``, one-text
    ``embed`` and ``llm.generate`` jobs, one at a time, straight to the
    worker and then through the scheduler: each reaches SUCCEEDED in the
    job store with a result pointer, dispatched to the card's worker; the
    scheduled tokens, next tokens and embeddings equal the direct ones bit
    for bit (one job at a time on one worker: the same shapes, the same
    kernels), the embeddings equal phase 6's own too, and B1, B5 and B9
    launch as often as on the direct path.  (2) The policy gate: a
    ``require_approval`` rule for ``llm.generate`` jobs that require
    ``gpu`` parks one in APPROVAL_REQUIRED; the same request republished
    with the approval label completes with 16.1's tokens; a request
    edited after the decision and republished with the label stays parked
    (the hash check) and is never dispatched; a ``deny`` rule sends its
    job to DENIED and the DLQ with code ``SAFETY_DENY``.  (3) 1000
    synthetic workers (two pools, 1-8 cards, three topologies, varied load,
    capabilities and health) beside the card's worker, answered by a
    responder on their direct subjects; 20,000 ``echo`` jobs in bursts of
    256 a tick: each is dispatched once and ends SUCCEEDED once; then
    10,000 picks of the C scan equal the Python scan's on the same
    registry.  Prints scheduled jobs/s (submit to DISPATCHED), submit to
    result p50 and p99 and the C scan's share of the picks.  (4) The
    port's statebus, scheduler and worker (phase 8's fp32
    ``LlamaConfig.tiny()``) as processes over TCP: ``echo``, ``infer``,
    ``embed`` and ``llm.generate`` complete with phase 8's results
    (tokens under the near-tie rule, next tokens and one-text embeddings
    equal); SIGTERM stops the scheduler with exit 0; every process is
    stopped on every path.
17. The API gateway, run right after phase 16 on phase 6's bf16 worker,
    and after 16.4 as processes.  The port's ``Gateway`` is built as
    ``python -m cordum_tpu_torch.cmd.gateway`` builds it (the embedded
    ``SafetyKernel``, the embedded workflow engine, the ``ContextService``
    whose embeds leave as ``embed`` jobs through ``BusEmbedder``), beside
    a workflow engine service as ``python -m
    cordum_tpu_torch.cmd.workflow_engine`` builds it and a scheduler built
    as phase 16's; it listens on 127.0.0.1 and this script is its HTTP
    client.
    The pools are phase 16's with ``job.tpu.>`` (``BusEmbedder``'s topic,
    the reference's) routed to pool ``gpu`` too.  (1) Phase 6's
    ``llm.generate`` jobs over ``POST /api/v1/jobs``, one at a time: the
    tokens equal 16.1's direct and scheduled tokens bit for bit, and B1
    launches as often as in 16.1.  (2) Sixteen chunks (one embed job)
    over ``PUT /api/v1/context/chunks`` and a RAG window over ``POST
    /api/v1/context/window``: the stored vectors equal the same texts'
    ``embed`` job sent straight to the worker bit for bit, the window ranks
    the chunks by their cosine to the query's vector, and B5 launches as
    often as on the direct path; then a workflow (``context.update``,
    ``context.window``, ``llm.generate``) over ``POST /api/v1/workflows``
    and its run: SUCCEEDED, the run's memory holds the same vectors, B5
    and B1 launched; then 256 chunks for context embeds/s, within 2e-2 of
    the plain-version embedder.  (3) 16.3's fleet of 1000 synthetic
    workers and 5000 ``echo`` jobs (a quarter of 16.3's backlog, for the
    time limit) over ``POST /api/v1/jobs:batch`` in batches of 256: each
    accepted, dispatched once and SUCCEEDED once.  Prints accepted and
    scheduled jobs/s, dispatch→result p50 and p99 and context embeds/s,
    each beside the card's name and power limit.  (4) The port's
    statebus, scheduler, workflow engine, gateway and worker (16.4's
    config) as processes over TCP: 16.4's jobs over HTTP complete with
    phase 8's results, each dispatched once; a context window's embeds
    and a workflow with ``context.*`` steps run on the worker process (its
    ``embed`` job's vectors bit for bit; the workflow's tokens under the
    near-tie rule); SIGTERM stops every process with exit 0; every
    process is stopped on every path.

Tolerances (kernel vs plain version, max abs error), paged attention:
fp32 1e-4 — the sums run in another order over up to 8192 keys, on O(1)
outputs; bf16 6e-2 — the kernel rounds scores to bf16 as the plain version
does, but rounds unnormalised online-softmax weights to bf16 for PV where
the plain version rounds the normalised probabilities, a few bf16 ulps
(2^-8 relative) on outputs of magnitude up to ~3.  Paged attention also
holds each token's max error to its own largest |output| (over all heads):
fp32 1e-5; bf16 three ulps of that output, 3 * 2^-7 (readings on an
H100: 6.7e-3 and 7.0e-3 in bf16, 1.3e-6 in fp32).  The long rows' outputs
are 0.02-0.04: a merge that lost or doubled one run of keys moves them
by far more than this bound, but can stay under 6e-2
(``tests/test_torch_paged_attention.py`` holds both on a plain emulation
of the merge).  Embedder
attention: fp32 1e-5 — sums of at most 128 terms in another order on O(1)
outputs; bf16 6e-2 — both versions round scores and probabilities to bf16
at the same points, so only a rounding flipped by the fp32 sum order
differs: two bf16 ulps at outputs up to ~4.  Worker embeddings vs the
plain-version embedder (unit L2 vectors): fp32 1e-5; bf16 2e-2 (rounding
flips carried through four layers, LayerNorm and pooling).

Dense attention (phase 7), fp32: the output's max abs error 1e-5 (sums
over up to 2048 keys in another order, on O(1) outputs), each gradient's
max error over its largest |value| 1e-4.  bf16 is held row by row, since
a long row's output (about sqrt(e/n) over n keys) and a late key's dk and
dv are small beside their tensor's max: for each query row of out and dq
and each key row of dk and dv, the max error from the exact result (the
plain version in fp32 on the same bf16 inputs) over the row's largest
|exact| value (at least 2^-8 of the tensor's largest); the kernel's worst
row within twice the bf16 plain version's worst row, plus 2^-9.  Three
planted faults must fail that gate, each logged beside what the earlier
gate (6e-2 absolute, 5e-2 of the max) said of it: the backward with one
query head of each KV group left out of dK/dV for the second half of
the keys, the plain version with
the keys of each later row's own 64-row tile masked out, and the plain
version on inputs rounded to float8_e4m3.  fp32 train oracle: each step's
loss within 1e-4 relative; every param within 6 lr = 1.8e-3 after 3
steps (Adam moves an element by about lr * sign(g), so a gradient within
fp32 noise of 0 flips an update by 2 lr a step), and at most a 1e-4 share
of the elements further apart than 1e-6.

MoE kernels (phase 9): the route, the dispatch and the combine backward's
d_out equal to the plain version's (indices; a gather; one fp32 product
rounded once); the combine and the dispatch backward, fp32 sums of k terms
in another order rounded once to the dtype, within 2^-22 of the sum of the
terms' magnitudes plus one ulp of the dtype (2^-7 bf16, 2^-23 fp32,
relative to the plain value); d_w, a D-long fp32 dot in another order,
within 1e-4 of the sum of its products' magnitudes (two orders' worst case
2 D 2^-24 = 4.9e-4 at D 4096, typical sqrt(D) 2^-24 = 3.8e-6).  At k 36
the three token gathers are held to a bound for n terms instead
(``moe_sum_limit``): per order n - 1 roundings of the running sum plus one
of each product, each within 2^-24 of the terms' magnitudes, twice that
for two orders, plus one ulp of the dtype; n is k for the two sums, D for
d_w.  fp32 MoE
oracle: the loss within 1e-5 relative, each gradient within 1e-4 of its
largest |value| (B9's fp32 gate).  The fp32 pipeline oracle (phase 11)
holds its loss and gradients to the same two gates; an MPMD gang's first
loss is held to the one-process loss within 1e-5 relative.  Phase 12's
ranks against their one-process step: each loss within 1e-6 relative,
each first-step gradient within 1e-4 of its largest |value| (11.1's
gate: the token sums split at other places when dp cuts the rows), each
param after the last step within 2 lr a step (an Adam update is about lr
sign(g)); every rank returns the same losses.  Phase 13: the ring's chunks
by 7.1's gates (fp32: output 1e-5, gradients and D 1e-4 of their max;
bf16: the row gate, D element by element, each against the exact
result); the merge kernel within 2^-20 of the largest value (fp32
elementwise arithmetic, a few ulps); the ring's ranks by phase 12's gates.
Phase 14: the route with a room equal to its plain version, and rank 1's
dispatch and d_out equal and its combine within 9.1's bound; the MoE
ranks by phase 12's gates (the expert slices against the slices of the
one-process gradients and params); the bf16 ep 2 leg's first loss within
1e-2 relative of 9.3's (the same weights and batch; the combine's partial
sums are added over the ranks in bf16, in another order than one card's
sum).  Phase 15: every dry-run and ``train`` loss on ranks within 1e-5
relative of one process on the same draws in fp32 (the same sums, split
over tp, sp, ep and pp at other places; the bf16 dry run is held only to
finite losses equal on every rank); entry()'s fp32 logits on the kernel
path within 1e-4 of the largest plain logit (B9's 1e-5 output gate
carried through 4 layers and lm_head); the embed at ``WORKER_TP`` 2 equal
to one card's embeddings of the same blocks of rows, and within 1e-6 of
one card's of the whole batch (unit vectors: cuBLAS picks its fp32 GEMM
by the row count, so another batch size may sum in another order; 5.2e-08
read on four H100s).

Near-tie rule of phase 3, fixed before any run: tokens are compared up to
the first generated position where the oracle's top-2 logits differ by
less than 1e-4 (fp32 sums in another order may flip such a tie); the
number of such positions is printed.  Phase 10 holds every gang token to
the same rule, against the oracle and against the single rank.

The line before the last two is a JSON object with each kernel's numbers;
then the ``nvidia-smi`` name and power-limit line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 without tensor cores; bf16 dense
KERNEL_ATOL = {"float32": 1e-4, "bfloat16": 6e-2}
#: paged attention, per token: max abs error over the token's largest
#: |output| (all heads); bf16: three ulps of that output (2^-7 relative
#: each at the top of a binade)
KERNEL_ROW_REL = {"float32": 1e-5, "bfloat16": 3 * 2.0**-7}
EMBED_KERNEL_ATOL = {"float32": 1e-5, "bfloat16": 6e-2}
EMBED_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
NEAR_TIE = 1e-4
SEED = 0
#: B7's launch modes, a kernel row each: wrapper → what it computes on the
#: MoE path, where each is launched once a layer a step
MOE_KERNELS = {
    "moe_route": "route",
    "moe_slot_gather": "dispatch forward",
    "moe_slot_gather_scaled": "combine backward d_out",
    "moe_token_gather": "combine forward",
    "moe_token_sum": "dispatch backward",
    "moe_token_dot": "combine backward d_w",
}
#: kernel row → (its module under cordum_tpu_torch.ops, the JAX-side function it replaces)
KERNELS = {
    "paged_attention": ("paged_attention", "cordum_tpu/models/llama.py:467"),
    # B1 at a tensor-parallel rank's heads (phase 10): Llama-3-8B at tp 2
    "paged_attention_tp2": ("paged_attention", "cordum_tpu/models/llama.py:467"),
    "embed_attention": ("embed_attention", "cordum_tpu/models/embedder.py:123"),
    "dense_attention_fwd": ("dense_attention", "cordum_tpu/models/llama.py:179-197"),
    "dense_attention_bwd": ("dense_attention", "cordum_tpu/models/llama.py:179-197"),
    # B9 at a sequence-parallel rank's shapes (phase 12.6): a chunk of Tq
    # queries at their global positions against the gathered Tk keys, as
    # _block calls _attention over an sp mesh (llama.py:216-222)
    "dense_attention_fwd_sp": ("dense_attention", "cordum_tpu/models/llama.py:179-197"),
    "dense_attention_bwd_sp": ("dense_attention", "cordum_tpu/models/llama.py:179-197"),
    **{name: ("moe_dispatch", "cordum_tpu/models/moe.py:73-113") for name in MOE_KERNELS},
    # ring attention over sp (phase 13): B9's "D only" and "D given" entries
    # on a visiting chunk, and the merge of the chunks' (out, lse) (B6)
    **{name: (module, "cordum_tpu/ops/ring_attention.py:32-75") for name, module in (
        ("dense_attention_d", "dense_attention"), ("dense_attention_bwd_given", "dense_attention"),
        ("ring_merge", "ring_attention"))},
    # B7's route on a dp rank (phase 14): a room from the lower dp ranks'
    # counts, the reference's global capacity and queue under jit over a
    # dp-sharded batch
    "moe_route_room": ("moe_dispatch", "cordum_tpu/models/moe.py:82-94"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain version
# ---------------------------------------------------------------------------


#: (start, n) per sequence of phase 2's 8192-token case: five decode rows
#: (the longest at the last position an 8192-token context holds), a
#: 12-token prefill chunk crossing a page boundary and a draft row of
#: k+1 = 5 tokens; two padding tokens fill the 24-token buffer
LONG_ROWS = [(5, 1), (300, 1), (1500, 1), (4000, 1), (8191, 1), (10, 12), (2040, 5)]


def serving_rows(n_requests=8, n_new=32, chunk=16):
    """Phase 4's own step shape: 8 sequences with prompts of 8..300
    tokens, seven of them decoding halfway through their 32 new tokens and
    the longest prompt's last prefill chunk — 24 tokens, the serving
    buffer (8 sessions + a 16-token prefill budget)."""
    lengths = np.linspace(8, 300, n_requests).astype(int).tolist()
    rows = [(n + n_new // 2, 1) for n in lengths[:-1]]
    return rows + [(lengths[-1] - chunk, chunk)]


def attention_case(torch, dev, rows, *, h=32, kvh=8, hd=128, ps=16, s_rows=8,
                   p_cols=512, num_pages=1200, t_buf=24, seed=SEED):
    """One ragged buffer at the main path's widths (Llama-3-8B heads, page
    size 16, 512-page rows for an 8192-token context): ``rows`` gives each
    sequence's (start, n); padding tokens sit on the null row.  Returns
    fp32 operands."""
    rng = np.random.default_rng(seed)
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


#: device cycles of the sleep kernel queued after each flush (~0.3 ms): the
#: host's own work for the next call (argument checks, allocation, the
#: launch) then overlaps the sleep and never shows as device idle time
#: inside the timed window
SLEEP_CYCLES = 500_000


def time_ms(torch, fn, *, iters, flush, sleep_cycles=SLEEP_CYCLES):
    """Median CUDA-event time of ``fn`` with the L2 cache flushed before
    each launch (the serving step finds each layer's pages cold) and the
    device kept busy while the host prepares the call (``sleep_cycles``
    0: not, so the host's own work inside ``fn`` can show in the window,
    as in this script's timings before the sleep was added)."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush()
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def measure_paged(torch, dev, card, case, name, tag, flush):
    """The kernel vs its plain version on one buffer (gated on the
    tolerance), then kernel, plain and SDPA times and the bound.  The plan
    is built once, as the serving step builds it, and is not timed with
    the kernel; its host time is logged."""
    from cordum_tpu_torch.ops import paged_attention as pa

    import torch.nn.functional as F

    q, k, v, tables, token_seq, positions = case
    args = (q, k, v, tables, token_seq, positions)
    t, h, hd = q.shape
    _, ps, kvh, _ = k.shape
    t0 = time.perf_counter()
    plan = pa.build_plan(token_seq.cpu().numpy(), positions.cpu().numpy(), page_size=ps,
                         pages_per_seq=tables.shape[1], n_heads=h, n_kv_heads=kvh,
                         dtype=q.dtype, device=dev)
    plan_ms = (time.perf_counter() - t0) * 1e3
    got = pa.paged_attention(*args, plan=plan)
    torch.cuda.synchronize()
    want = pa.paged_attention_reference(*args)
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    if not (err <= KERNEL_ATOL[name]) or not torch.isfinite(got).all():
        raise AssertionError(
            f"kernel vs plain {name} ({tag}): max abs err {err} > {KERNEL_ATOL[name]}")
    # per token: its row's max error over its row's largest output, which
    # the absolute gate cannot see on the long rows' small outputs
    row_rel = (diff.amax((1, 2)) / want.float().abs().amax((1, 2))).max().item()
    if not row_rel <= KERNEL_ROW_REL[name]:
        raise AssertionError(
            f"kernel vs plain {name} ({tag}): a token's max error over its largest "
            f"output {row_rel} > {KERNEL_ROW_REL[name]}")
    # the library yardstick: SDPA over K/V already gathered and expanded
    # to the query heads (the gather itself is left out of its time)
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
    kernel_ms = time_ms(torch, lambda: pa.paged_attention(*args, plan=plan), iters=20,
                        flush=flush)
    plain_ms = time_ms(torch, lambda: pa.paged_attention_reference(*args), iters=5, flush=flush)
    library_ms = time_ms(
        torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask),
        iters=10, flush=flush)
    del kh, vh, lib_out
    split = device_split(torch, lambda: pa.paged_attention(*args, plan=plan), flush)
    nbytes, ops = work_of(q, k, tables, token_seq, positions)
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[name] * 1e3
    bound_ms = max(mem_ms, ops_ms)
    res = dict(
        max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        bound_ms=bound_ms, bound_by="bytes" if mem_ms >= ops_ms else "operations",
    )
    log(f"[kernel] {tag} {name}: max_abs_err {err:.3e} (tolerance {KERNEL_ATOL[name]:.0e}), "
        f"per token max err / max |out| {row_rel:.3e} (bound {KERNEL_ROW_REL[name]:.3e}), "
        f"sdpa vs plain {lib_err:.3e}; plan: {plan.n_items} items x {kvh} KV heads, "
        f"span {plan.span} pages, {plan.n_splits} split groups, built in {plan_ms:.3f} ms (host)")
    log(f"[kernel] {tag} {name}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
        f"library_ms {library_ms:.4f}  bound_ms {bound_ms:.4f} "
        f"({res['bound_by']}: {nbytes} bytes, {ops} ops), share of bound "
        f"{bound_ms / kernel_ms:.3f}; device us per call: {split}  [{card}]")
    torch.cuda.empty_cache()
    return res


def device_split(torch, fn, flush, *, calls=10):
    """Device time per call of each CUDA kernel ``fn`` launches, from
    ``torch.profiler`` over ``calls`` calls (the L2 flushes left out):
    what a kernel's time is made of.  Informational: "not measured" when
    the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush()
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0 and "fill" not in e.key.lower():
            key = e.key.replace("(anonymous namespace)::", "")
            name = key.split("(")[0].split("<")[0].split()[-1].split("::")[-1]
            per[name] = per.get(name, 0.0) + us / calls
    return ", ".join(f"{k} {v:.1f}" for k, v in sorted(per.items(), key=lambda kv: -kv[1])) \
        or "not measured (the profiler recorded no device time)"


def kernel_rows(prof):
    """``(name, device us, count)`` of each kernel a profile recorded, from
    the device's own events only: a host op's row repeats the device time of
    the kernels it launched, so a sum over every row counts it twice."""
    from torch.autograd import DeviceType

    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def phase_kernel(torch, dev, card):
    """The 8192-token case (its numbers go into the kernel line), then the
    serving step's own shape (informational times, gated on the
    tolerance)."""
    long32 = attention_case(torch, dev, LONG_ROWS)
    serve32 = attention_case(torch, dev, serving_rows(), num_pages=1024)
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def flush():
        flush_buf.zero_()

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for tag, case in (("8192-token", long32), ("serving-shape", serve32)):
            q, k, v = (x.to(dtype) for x in case[:3])
            res = measure_paged(torch, dev, card, (q, k, v, *case[3:]), name, tag, flush)
            results.setdefault(name, res)
            del q, k, v
    del flush_buf
    return results


# ---------------------------------------------------------------------------
# phase 3: fp32 serving oracle
# ---------------------------------------------------------------------------


def plain_attention(q, k, v, cfg, *, q_offset=None):
    """The dense attention's plain version as ``forward``'s ``attention``
    core: the oracles run on it, independent of the kernels they judge."""
    from cordum_tpu_torch.ops.dense_attention import gqa_attention

    return gqa_attention(q, k, v, q_offset=q_offset)


def dense_greedy(torch, llama, params, cfg, prompt, n_new, dev):
    """The sequential oracle: ``forward`` over the growing sequence on the
    plain attention, greedy argmax.  Returns the tokens and the generated
    positions whose top-2 logits differ by less than the near-tie
    threshold."""
    toks, out, ties = list(prompt), [], []
    with torch.no_grad():
        for i in range(n_new):
            logits = llama.forward(params, torch.tensor([toks], device=dev), cfg,
                                   attention=plain_attention)[0, -1]
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
    """Returns the main path's kernel launches, the weights, the prompts,
    the dense oracle's (tokens, near-tie positions) per prompt and the
    engine's tokens per prompt for speculative off and on."""
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
    served = {}
    for speculative in (False, True):
        engine = make_serving_engine(cfg, params, device=dev, speculative=speculative,
                                     max_new_tokens=n_new)
        pa.paged_attention.launches = 0
        outs = asyncio.run(serve_waves(engine, waves, n_new, f"spec{int(speculative)}"))
        served[speculative] = outs
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
    return launches, params, prompts, oracle, served


# ---------------------------------------------------------------------------
# phase 4: bf16 Llama-3-8B
# ---------------------------------------------------------------------------


def phase_serve(torch, dev, card, cfg, *, n_requests=8, n_new=32, cache_pages=1024):
    """Returns the main path's kernel launches, the weights, which phase 6
    serves again (one copy), and the run's numbers that phase 10.3 prints
    beside its own (step p50, TTFT p50, output tokens/s, and the peak
    memory of this run's own weights and serving, without what earlier
    phases left allocated)."""
    from cordum_tpu_torch.models import llama
    from cordum_tpu_torch.ops import paged_attention as pa
    from cordum_tpu_torch.worker.handlers import make_serving_engine

    before = torch.cuda.memory_allocated(dev)
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
    plan_ms = sorted(x * 1e3 for x in engine.backend.plan_seconds)
    ttft = sorted(st.ttft_seconds)
    step_ms = statistics.median(st.step_seconds) * 1e3
    log(f"[serve] {n_requests} requests, prompts {lengths[0]}..{lengths[-1]} tokens, "
        f"{n_new} new each: wall {wall:.3f} s, steps {st.steps}, "
        f"TTFT p50 {statistics.median(ttft) * 1e3:.1f} ms, "
        f"decode p50 {decode_rate(emits):.1f} tokens/s per request, "
        f"output {st.decoded_tokens / wall:.1f} tokens/s (whole run), step p50 {step_ms:.2f} ms, "
        f"peak memory {peak_gib:.2f} GiB, launches {launches}, "
        f"drafted {st.drafted_tokens} accepted {st.accepted_tokens}  [{card}]")
    log(f"[serve] paged-attention plan, host time per step (once per step, all "
        f"{cfg.n_layers} layers): p50 {statistics.median(plan_ms):.3f} ms, max "
        f"{plan_ms[-1]:.3f} ms over {len(plan_ms)} steps")
    profile_serving(torch, dev, card, cfg, params, prompts, cache_pages=cache_pages)
    return launches, params, {"peak_gib": peak_gib - before / 2**30, "step_p50_ms": step_ms,
                              "ttft_p50_ms": statistics.median(ttft) * 1e3,
                              "tokens_per_s": st.decoded_tokens / wall}


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
    rows = kernel_rows(prof)
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
# phase 5: the embedder's attention kernel vs plain version
# ---------------------------------------------------------------------------


def embed_attention_case(torch, dev, *, b=256, length=128, h=4, hd=64, seed=SEED):
    """A full micro-batch at the embedder's widths: q, k, v as views of one
    fused ``[B, L, 3, h, hd]`` projection (the forward's layout), rows of
    mixed lengths, one full row, one all-pad row (batch padding) and one
    length-1 row.  Returns the fp32 projection, the mask and the lengths."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(2, length + 1, b)
    lens[0], lens[1], lens[2] = length, 0, 1
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.float32)
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, length, 3, h, hd), generator=g, device=dev)
    return qkv, torch.from_numpy(mask).to(dev), lens


def embed_work_of(lens, length, h, hd, el):
    """Bytes the call must move (q read and out written in full; of k and
    v the keys each row attends to, all ``L`` on an all-pad row; the fp32
    mask) and its operations (QK and PV: 4*hd per query, attended key and
    head)."""
    keys = int(np.where(lens > 0, lens, length).astype(np.int64).sum())
    b = len(lens)
    nbytes = 2 * b * length * h * hd * el + 2 * keys * h * hd * el + 4 * b * length
    return nbytes, 4 * hd * h * length * keys


def phase_embed_kernel(torch, dev, card):
    from cordum_tpu_torch.ops import embed_attention as ea

    import torch.nn.functional as F

    qkv32, mask, lens = embed_attention_case(torch, dev)
    b, length, _, h, hd = qkv32.shape
    real = torch.from_numpy(lens > 0).to(dev)
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def flush():
        flush_buf.zero_()

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        qkv = qkv32.to(dtype)
        args = (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], mask)
        got = ea.embed_attention(*args)
        torch.cuda.synchronize()
        want = ea.embed_attention_reference(*args)
        err = (got.float() - want.float()).abs().max().item()
        if not (err <= EMBED_KERNEL_ATOL[name]) or not torch.isfinite(got).all():
            raise AssertionError(
                f"embed_attention vs plain {name}: max abs err {err} > "
                f"{EMBED_KERNEL_ATOL[name]} (or not finite)")
        # the library yardstick: SDPA on [B, h, L, hd] copies under the same
        # boolean key mask (the copies are left out of its time; it has no
        # defined output on the all-pad row, so that row is not compared)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in args[:3])
        bmask = (mask > 0)[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bmask)

        lib_err = (sdpa().transpose(1, 2)[real].float() - want[real].float()).abs().max().item()
        kernel_ms = time_ms(torch, lambda: ea.embed_attention(*args), iters=50, flush=flush)
        plain_ms = time_ms(torch, lambda: ea.embed_attention_reference(*args), iters=10,
                           flush=flush)
        library_ms = time_ms(torch, sdpa, iters=20, flush=flush)
        nbytes, ops = embed_work_of(lens, length, h, hd, qkv.element_size())
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS[name] * 1e3
        results[name] = dict(
            max_abs_err=err, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=max(mem_ms, ops_ms), bound_by="bytes" if mem_ms >= ops_ms else "operations",
        )
        log(f"[embed-kernel] {name}: max_abs_err {err:.3e} (tolerance "
            f"{EMBED_KERNEL_ATOL[name]:.0e}), sdpa vs plain {lib_err:.3e} (real rows)")
        log(f"[embed-kernel] {name}: kernel_ms {kernel_ms:.4f}  plain_ms {plain_ms:.4f}  "
            f"library_ms {library_ms:.4f}  bound_ms {results[name]['bound_ms']:.4f} "
            f"({results[name]['bound_by']}: {nbytes} bytes, {ops} ops), share of bound "
            f"{results[name]['bound_ms'] / kernel_ms:.3f}  [{card}]")
        del qh, kh, vh
        torch.cuda.empty_cache()
    del flush_buf
    return results


# ---------------------------------------------------------------------------
# phase 6: the port worker on the card
# ---------------------------------------------------------------------------

WORDS = ("agent", "workflow", "context", "token", "page", "card", "batch", "queue",
         "scheduler", "safety", "policy", "result", "stream", "embed", "recall", "job")


def make_texts(rng, n, min_words, max_words):
    """Texts of ``min_words``..``max_words`` words (each a token) with some
    punctuation, so their token counts spread over the length buckets."""
    return [" ".join(rng.choice(WORDS, rng.integers(min_words, max_words + 1)))
            + rng.choice(["", ".", "!", " ?"]) for _ in range(n)]


class JobDispatcher:
    """Plays the scheduler for one port worker: publishes ``JobRequest`` s
    on the worker's direct subject and collects the results, the streamed
    tokens and the heartbeats from the bus."""

    def __init__(self, bus, store, worker_id):
        self.bus, self.store, self.worker_id = bus, store, worker_id
        self.sent: dict = {}
        self.done: dict = {}
        self.first_token: dict = {}
        self.streams: dict = {}
        self.heartbeats: list = []
        #: called with every ``JobProgress`` of this dispatcher's jobs
        self.on_progress = None
        self._waiters: dict = {}
        self._n = 0

    async def start(self):
        from cordum_tpu_torch.protocol import subjects as subj

        await self.bus.subscribe(subj.RESULT, self._on_result)
        await self.bus.subscribe(subj.PROGRESS, self._on_progress)
        await self.bus.subscribe(subj.HEARTBEAT, self._on_heartbeat)

    async def _on_result(self, subject, pkt):
        r = pkt.job_result
        if r is None or r.job_id not in self._waiters or r.status == "RUNNING":
            return  # RUNNING is a requeue hint, not a terminal result
        self.done[r.job_id] = time.monotonic()
        fut = self._waiters.pop(r.job_id)
        if not fut.done():
            fut.set_result(r)

    async def _on_progress(self, subject, pkt):
        from cordum_tpu_torch.protocol.types import STATUS_HINT_STREAM

        pr = pkt.job_progress
        if pr is not None and pr.status_hint == STATUS_HINT_STREAM:
            self.first_token.setdefault(pr.job_id, time.monotonic())
            self.streams.setdefault(pr.job_id, []).extend(pr.tokens)
        if pr is not None and self.on_progress is not None and pr.job_id in self.sent:
            await self.on_progress(pr)

    async def cancel(self, job_id, reason=""):
        from cordum_tpu_torch.protocol import subjects as subj
        from cordum_tpu_torch.protocol.types import BusPacket, JobCancel

        await self.bus.publish(subj.CANCEL, BusPacket.wrap(JobCancel(job_id=job_id,
                                                                     reason=reason)))

    async def _on_heartbeat(self, subject, pkt):
        if pkt.heartbeat is not None:
            self.heartbeats.append(pkt.heartbeat)

    async def _submit(self, payload, tag):
        from cordum_tpu_torch.protocol import subjects as subj
        from cordum_tpu_torch.protocol.types import BusPacket, JobRequest

        self._n += 1
        jid = f"{tag}-{self._n}"
        ptr = await self.store.put_context(jid, payload)
        fut = asyncio.get_running_loop().create_future()
        self._waiters[jid] = fut
        self.sent[jid] = time.monotonic()
        await self.bus.publish(subj.direct_subject(self.worker_id), BusPacket.wrap(
            JobRequest(job_id=jid, topic=f"job.gpu.{payload['op']}", context_ptr=ptr)))
        return jid, fut

    async def run(self, payloads, tag, *, in_flight=None, timeout_s=600.0):
        """Submit ``payloads`` (all together, or at most ``in_flight`` at a
        time) and wait for all; returns ``[(job id, result doc)]`` and
        raises on any job that did not succeed."""
        window = asyncio.Semaphore(in_flight or len(payloads) or 1)

        async def one(payload):
            async with window:
                jid, fut = await self._submit(payload, tag)
                r = await fut
            if r.status != "SUCCEEDED":
                raise AssertionError(f"{jid}: {r.status} {r.error_code} {r.error_message}")
            return jid

        jids = await asyncio.wait_for(asyncio.gather(*(one(p) for p in payloads)), timeout_s)
        docs = await asyncio.gather(*(self.store.get_result(j) for j in jids))
        return list(zip(jids, docs))

    def p50_ms(self, jids):
        return statistics.median((self.done[j] - self.sent[j]) * 1e3 for j in jids)


def make_port_worker(torch, dev, worker_id, chips=1, topics=(), **compute_kw):
    """A port ``Worker`` over the port's ``LoopbackBus`` and ``MemoryStore``,
    wired by ``attach_default_gpu_worker`` (micro-batches up to 256 rows,
    the embedder's largest batch bucket), owning ``chips`` cards: one (the
    script's card, whatever the host has) unless a phase asks for more.
    It listens on its direct subject, and on ``topics`` (queue group: its
    pool) where given."""
    from cordum_tpu_torch.infra.bus import LoopbackBus
    from cordum_tpu_torch.infra.kv import MemoryKV
    from cordum_tpu_torch.infra.memstore import MemoryStore
    from cordum_tpu_torch.worker.handlers import attach_default_gpu_worker
    from cordum_tpu_torch.worker.runtime import Worker

    bus, store = LoopbackBus(), MemoryStore(MemoryKV())
    w = Worker(bus=bus, store=store, worker_id=worker_id, pool="gpu", topics=list(topics),
               capabilities=["gpu"], heartbeat_interval_s=2.0, device=dev, chips=chips)
    compute = attach_default_gpu_worker(
        w, max_batch_rows=256, serving_cache_pages=256, seed=SEED, **compute_kw)
    return w, compute, JobDispatcher(bus, store, worker_id)


def plain_embeddings(torch, embedder, texts):
    """The embedder's forward with the attention's plain version, on the
    card, over ``texts`` at ``max_len``: what the worker's embeddings are
    held to."""
    from cordum_tpu_torch.models import embedder as em
    from cordum_tpu_torch.ops.embed_attention import embed_attention_reference

    ids, mask = em.batch_tokenize(texts, embedder.cfg)
    dev = embedder.device
    with torch.no_grad():
        out = em.forward(embedder.params, torch.from_numpy(ids).to(dev),
                         torch.from_numpy(mask).to(dev), embedder.cfg,
                         attention=embed_attention_reference)
    return out.cpu().numpy()


def check_embeddings(torch, compute, jobs, texts_of, name):
    """Every embed job's vectors against the plain-version embedder; returns
    the max abs error."""
    texts = [t for jid, _ in jobs for t in texts_of[jid]]
    got = np.concatenate([np.asarray(doc["embeddings"], np.float32) for _, doc in jobs])
    want = plain_embeddings(torch, compute.embedder, texts)
    err = float(np.abs(got - want).max())
    if not err <= EMBED_ATOL[name] or got.shape != want.shape:
        raise AssertionError(f"worker embeddings {name}: max abs err {err} > {EMBED_ATOL[name]}")
    return err


async def embed_jobs(sched, texts, per_job, tag, *, one_at_a_time):
    """Embed ``texts`` as jobs of ``per_job`` texts, all together or one job
    at a time; returns the jobs, each job's texts and the wall seconds."""
    payloads = [{"op": "embed", "texts": texts[i:i + per_job]}
                for i in range(0, len(texts), per_job)]
    t0 = time.monotonic()
    if one_at_a_time:
        jobs = [j for p in payloads for j in await sched.run([p], tag)]
    else:
        jobs = await sched.run(payloads, tag)
    wall = time.monotonic() - t0
    return jobs, {jid: p["texts"] for (jid, _), p in zip(jobs, payloads)}, wall


def launch_counters():
    """Each kernel row's launch counter (the wrapper's ``launches``)."""
    from cordum_tpu_torch.ops import dense_attention as da
    from cordum_tpu_torch.ops import embed_attention as ea
    from cordum_tpu_torch.ops import moe_dispatch as md
    from cordum_tpu_torch.ops import paged_attention as pa
    from cordum_tpu_torch.ops import ring_attention as ra

    return {"paged_attention": pa.paged_attention, "embed_attention": ea.embed_attention,
            "dense_attention_fwd": da.dense_attention_fwd,
            "dense_attention_bwd": da.dense_attention_bwd,
            "dense_attention_d": da.dense_attention_d, "ring_merge": ra.ring_merge,
            "moe_route": md.moe_route_kernel, "moe_slot_gather": md.moe_slot_gather,
            "moe_slot_gather_scaled": md.moe_slot_gather_scaled,
            "moe_token_gather": md.moe_token_gather, "moe_token_sum": md.moe_token_sum,
            "moe_token_dot": md.moe_token_dot}


#: the kernel rows that count a subset of a wrapper's launches: B9's
#: launches whose queries and keys differ in length (``chunk_launches``)
CHUNK_ROWS = {"dense_attention_fwd_sp": "dense_attention_fwd",
              "dense_attention_bwd_sp": "dense_attention_bwd"}
#: the kernel row of B9's "D given" backward, a launch mode of the backward's
#: wrapper counted apart from its ``launches`` (``given_launches``)
GIVEN_ROW = "dense_attention_bwd_given"
#: the kernel row of B7's route with a room, counted apart too
#: (``room_launches``)
ROOM_ROW = "moe_route_room"


def set_launches(counts=None):
    """Every counter to ``counts`` (a :func:`read_launches` dict), or 0."""
    fns = launch_counters()
    for name, fn in fns.items():
        fn.launches = counts[name] if counts else 0
    for name, of in CHUNK_ROWS.items():
        fns[of].chunk_launches = counts[name] if counts else 0
    fns["dense_attention_bwd"].given_launches = counts[GIVEN_ROW] if counts else 0
    fns["moe_route"].room_launches = counts[ROOM_ROW] if counts else 0


def zero_launches():
    set_launches()


def read_launches():
    fns = launch_counters()
    return {**{name: fn.launches for name, fn in fns.items()},
            **{name: fns[of].chunk_launches for name, of in CHUNK_ROWS.items()},
            GIVEN_ROW: fns["dense_attention_bwd"].given_launches,
            ROOM_ROW: fns["moe_route"].room_launches}


def check_worker_launches(n_layers_embed, n_layers_llama, steps, *, infer):
    """The launches of the worker run just driven; every kernel of the path
    must have launched, and as often as its layers and calls say: the paged
    kernel once a layer a serving step, the embedder's once a layer a
    flush, the dense forward once a layer an ``infer`` call (none without
    ``infer`` jobs), the dense backward never."""
    n = read_launches()
    pa_n, ea_n, fwd_n = n["paged_attention"], n["embed_attention"], n["dense_attention_fwd"]
    if pa_n == 0 or pa_n != n_layers_llama * steps:
        raise AssertionError(f"paged_attention launches {pa_n} != {n_layers_llama} x {steps}")
    if ea_n == 0 or ea_n % n_layers_embed:
        raise AssertionError(f"embed_attention launches {ea_n} (layers {n_layers_embed})")
    if (fwd_n == 0) == infer or fwd_n % n_layers_llama or n["dense_attention_bwd"]:
        raise AssertionError(f"dense_attention launches {fwd_n} forward, "
                             f"{n['dense_attention_bwd']} backward (infer jobs: {infer})")
    return n


async def drive_fp32_worker(torch, dev, card, cfg, params, prompts, oracle, *, n_new):
    """Phase 3's fp32 model behind a port worker: generate must equal the
    dense oracle token for token; embeds (fp32 embedder) the plain version."""
    from cordum_tpu_torch.models.embedder import EmbedderConfig

    w, compute, sched = make_port_worker(
        torch, dev, "w-fp32", llama_cfg=cfg, llama_params=params,
        embedder_cfg=EmbedderConfig(dtype=torch.float32))
    await sched.start()
    await w.start()
    rng = np.random.default_rng(SEED + 6)
    try:
        zero_launches()
        gens = await sched.run([{"op": "llm.generate", "tokens": p, "max_new_tokens": n_new}
                                 for p in prompts], "gen32")
        texts = make_texts(rng, 48, 1, 126)
        emb, texts_of, _ = await embed_jobs(sched, texts, 4, "emb32", one_at_a_time=False)
        torch.cuda.synchronize()
        launches = check_worker_launches(compute.embedder.cfg.n_layers, cfg.n_layers,
                                         w.serving.stats.steps, infer=False)
    finally:
        await w.stop()
    for p, (jid, doc), (want, ties) in zip(prompts, gens, oracle):
        upto = ties[0] if ties else n_new
        if doc["tokens"][:upto] != want[:upto] or len(doc["tokens"]) != n_new:
            raise AssertionError(f"worker fp32 generate of a {len(p)}-token prompt gave "
                                 f"{doc['tokens']}, oracle {want} (compared up to {upto})")
        if sched.streams.get(jid) != doc["tokens"]:
            raise AssertionError(f"{jid}: streamed tokens differ from the result")
    err = check_embeddings(torch, compute, emb, texts_of, "float32")
    log(f"[worker] fp32: {len(prompts)} llm.generate jobs token-identical to the dense "
        f"oracle; {len(texts)} embeddings within {err:.3e} of the plain version; launches "
        f"paged_attention {launches['paged_attention']}, embed_attention "
        f"{launches['embed_attention']}  [{card}]")
    return launches


async def drive_bf16_worker(torch, dev, card, cfg, params, *, n_new=16, then=None):
    """Llama-3-8B bf16 (phase 4's weights) and the default bf16 embedder
    behind a port worker: every op of the table through the bus.  ``then``,
    when given, is awaited with the worker, the dispatcher, the record of
    the jobs and the worker's compute (phases 16 and 17) before the worker
    stops; its result is returned third."""
    # the worker binary's default topics: phase 16's scheduler sends a job
    # there when the worker's heartbeat reads overloaded (a busy duty
    # cycle); job.tpu.embed is the context service's embed topic (phase 17)
    w, compute, sched = make_port_worker(torch, dev, "w-bf16",
                                          topics=["job.gpu.>", GATEWAY_EMBED_TOPIC],
                                          llama_cfg=cfg, llama_params=params)
    await sched.start()
    await w.start()
    rng = np.random.default_rng(SEED + 7)
    kind = torch.cuda.get_device_name(dev)
    try:
        zero_launches()
        t0 = time.monotonic()
        echo = await sched.run([{"op": "echo", "i": i} for i in range(200)], "echo")
        echo_rate = len(echo) / (time.monotonic() - t0)
        mm = [j for _ in range(4) for j in await sched.run(
            [{"op": "matmul", "b": 8, "n": 512, "k": 512, "m": 512, "iters": 4}], "matmul")]
        infer_jobs = [{"op": "infer", "tokens": [
            rng.integers(0, cfg.vocab_size, 32).tolist(),
            rng.integers(0, cfg.vocab_size, 20).tolist()]} for _ in range(4)]
        infer = await sched.run(infer_jobs, "infer")
        single, single_texts, single_wall = await embed_jobs(
            sched, make_texts(rng, 16, 1, 126), 1, "embed1", one_at_a_time=True)
        batched, batched_texts, batched_wall = await embed_jobs(
            sched, make_texts(rng, 256, 70, 126), 4, "embedB", one_at_a_time=False)
        await profile_embeds(torch, card, sched, make_texts(rng, 256, 70, 126))
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (8, 50, 120, 200)]
        gen_jobs = [{"op": "llm.generate", "tokens": p, "max_new_tokens": n_new} for p in prompts]
        gens = await sched.run(gen_jobs, "gen")
        torch.cuda.synchronize()
        launches = check_worker_launches(compute.embedder.cfg.n_layers, cfg.n_layers,
                                         w.serving.stats.steps, infer=True)
        for jid, doc in echo:
            if doc["echo"]["op"] != "echo" or doc["worker"] != "w-bf16":
                raise AssertionError(f"{jid}: bad echo {doc}")
        for jid, doc in mm:
            if doc["shape"] != [8, 512, 512] or not math.isfinite(doc["checksum"]):
                raise AssertionError(f"{jid}: bad matmul {doc}")
        for jid, doc in infer:
            if len(doc["next_tokens"]) != 2 or not all(0 <= t < cfg.vocab_size
                                                       for t in doc["next_tokens"]):
                raise AssertionError(f"{jid}: bad infer {doc}")
        for jid, doc in gens:
            if len(doc["tokens"]) != n_new or not all(0 <= t < cfg.vocab_size for t in doc["tokens"]):
                raise AssertionError(f"{jid}: bad generate {doc}")
            if sched.streams.get(jid) != doc["tokens"]:
                raise AssertionError(f"{jid}: streamed tokens differ from the result")
        err = max(check_embeddings(torch, compute, single, single_texts, "bfloat16"),
                  check_embeddings(torch, compute, batched, batched_texts, "bfloat16"))
        hb = sched.heartbeats[0] if sched.heartbeats else None
        if hb is None or hb.device_kind != kind or hb.type != "gpu" or not hb.devices_healthy:
            raise AssertionError(f"the worker's heartbeat does not name the card: {hb}")
        ttft = statistics.median((sched.first_token[j] - sched.sent[j]) * 1e3 for j, _ in gens)
        p50 = {op: sched.p50_ms([j for j, _ in jobs]) for op, jobs in (
            ("echo", echo), ("matmul", mm), ("infer", infer), ("embed (one at a time)", single),
            ("embed (coalesced)", batched), ("llm.generate", gens))}
        n_single = sum(len(t) for t in single_texts.values())
        n_batched = sum(len(t) for t in batched_texts.values())
        log(f"[worker] bf16: heartbeat device_kind {hb.device_kind!r}, hbm "
            f"{hb.hbm_used_gb:.1f}/{hb.hbm_total_gb:.1f} GB, healthy {hb.devices_healthy}")
        log(f"[worker] bf16: echo {echo_rate:.1f} jobs/s ({len(echo)} jobs together); "
            f"embeds/s one job at a time {n_single / single_wall:.1f} ({n_single} texts), "
            f"coalesced {n_batched / batched_wall:.1f} ({n_batched} texts in {len(batched)} jobs); "
            f"TTFT p50 through the worker {ttft:.1f} ms ({len(gens)} requests, {n_new} new "
            f"tokens each); embeddings within {err:.3e} of the plain version  [{card}]")
        log("[worker] bf16: p50 dispatch->result ms: " + ", ".join(
            f"{op} {ms:.2f}" for op, ms in p50.items()) + f"  [{card}]")
        log(f"[worker] bf16: launches paged_attention {launches['paged_attention']} (= "
            f"{cfg.n_layers} layers x {launches['paged_attention'] // cfg.n_layers} steps), "
            f"embed_attention {launches['embed_attention']}, dense_attention_fwd "
            f"{launches['dense_attention_fwd']} (= {cfg.n_layers} layers x "
            f"{launches['dense_attention_fwd'] // cfg.n_layers} infer calls)  [{card}]")
        numbers = worker_numbers(echo_rate, n_single / single_wall, n_batched / batched_wall, ttft, p50)
        record = {"infer": list(zip(infer_jobs, (doc for _, doc in infer))),
                  "embed1": [({"op": "embed", "texts": single_texts[jid]}, doc) for jid, doc in single],
                  "gen": list(zip(gen_jobs, (doc for _, doc in gens)))}
        after = None if then is None else await then(w, sched, record, compute)
    finally:
        await w.stop()
    return launches, numbers, after


def worker_numbers(echo_rate, single_rate, coalesced_rate, ttft_ms, p50):
    """The worker's end-to-end numbers, as phases 6 and 8 print them."""
    return {"echo jobs/s": echo_rate, "embeds/s one at a time": single_rate,
            "embeds/s coalesced": coalesced_rate, "TTFT p50 ms": ttft_ms,
            **{f"p50 ms {op}": ms for op, ms in p50.items()}}


async def profile_embeds(torch, card, sched, texts):
    """Where the coalesced embed path's time goes: 256 texts as 64 jobs
    once more under ``torch.profiler``; the device's busy share of the
    window, the attention kernel's share of device time and the top
    kernels.  Informational: it gates nothing (its launches are not counted
    as the main path's)."""
    from torch.profiler import ProfilerActivity, profile

    from cordum_tpu_torch.ops import embed_attention as ea

    launches = ea.embed_attention.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        await embed_jobs(sched, texts, 4, "embedP", one_at_a_time=False)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    ea.embed_attention.launches = launches
    rows = kernel_rows(prof)
    total = sum(r[1] for r in rows)
    if not total:
        log("[profile-embed] the profiler recorded no device time")
        return
    rows.sort(key=lambda r: -r[1])
    attn = sum(r[1] for r in rows if "embed_attention" in r[0])
    log(f"[profile-embed] {len(texts)} texts in 64 jobs: wall {wall_us / 1e3:.1f} ms, device "
        f"busy {total / 1e3:.2f} ms ({100 * total / wall_us:.1f}% of wall), embed_attention "
        f"{attn / 1e3:.2f} ms ({100 * attn / total:.1f}% of device time)  [{card}]")
    for key, us, count in rows[:6]:
        log(f"[profile-embed]   {us / 1e3:8.3f} ms {100 * us / total:5.1f}%  x{count:<5d} {key[:80]}")


def phase_worker(torch, dev, card, *, fp32, bf16, n_new=16):
    """``fp32`` = (cfg, params, prompts, oracle) of phase 3; ``bf16`` =
    (cfg, params) of phase 4.  Returns each dtype's main-path launches, the
    bf16 worker's end-to-end numbers, phase 16.1-16.3's launches and
    numbers and phase 17.1-17.3's launches and numbers (both run on the
    bf16 worker)."""
    cfg32, params32, prompts, oracle = fp32
    launches32 = asyncio.run(drive_fp32_worker(torch, dev, card, cfg32, params32, prompts,
                                               oracle, n_new=n_new))

    async def scheduler(w, sched, record, compute):
        seen = {}
        launches, cluster = await phase_scheduler(torch, dev, card, w, sched, record, out=seen)
        return launches, cluster, await phase_gateway(torch, dev, card, w, sched, compute,
                                                      record, seen)

    launches16, numbers, sched16 = asyncio.run(drive_bf16_worker(
        torch, dev, card, *bf16, n_new=n_new, then=scheduler))
    return {"float32": launches32, "bfloat16": launches16}, numbers, sched16


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------

#: B9 fp32 vs its plain version: the output's max abs error, and each
#: gradient's max abs error over its largest |value|
DENSE_OUT_ATOL = 1e-5
DENSE_GRAD_REL = 1e-4
#: B9 bf16, per row (a query row of out and dq, a key row of dk and dv):
#: the row's max error from the exact result (the plain version in fp32 on
#: the same bf16 inputs and dO) over the row's largest |exact| value, a row
#: smaller than DENSE_ROW_FLOOR of its tensor's largest |value| held to that
#: instead.  The kernel's worst row must stay within DENSE_ROW_FACTOR times
#: the bf16 plain version's worst row, plus DENSE_ROW_SLACK (half a bf16 ulp,
#: for a tensor the plain version gets exactly: dq and dk at T 1).  A row
#: that is wrong (a GQA head left out of dk/dv, a tile dropped) is off by a
#: large share of its own value, whatever its size beside the tensor's max.
DENSE_ROW_FLOOR = 2.0**-8
DENSE_ROW_FACTOR = 2.0
DENSE_ROW_SLACK = 2.0**-9
#: out's and dq's query rows with more live keys than this are also held
#: apart, to the plain version's worst such row: on a row of two or three
#: keys dP - D cancels, and there the plain version's worst dq row is ten
#: times its worst longer row (0.179 against 0.0217 at LlamaConfig()'s
#: shape on the card, a row at position 1), which left every longer row a
#: limit ten times too loose (ROADMAP C2)
SHORT_ROW_KEYS = 3
#: (tag, B, T, H, KVH, hd): phase 7's main shape (Llama-3-8B heads; its
#: numbers go into the kernel line), ``LlamaConfig()``'s, the ``train``
#: job's, and one microbatch of phase 11.2's bf16 pipeline run
DENSE_SHAPES = (("llama3-8b", 4, 2048, 32, 8, 128), ("llama-default", 8, 2048, 8, 4, 64),
                ("pipeline-mb", 1, 2048, 32, 8, 128))
#: phase 12.6, (tag, B, Tq, H, KVH, hd, Tk, first position): B9 at a
#: sequence-parallel rank's shapes at Llama-3-8B and T 8192, Tq queries at
#: positions first .. first + Tq against all Tk keys: tp 2 x sp 2 (16 of
#: the 32 heads, the first and the second chunk; the second's numbers go
#: into the kernel line) and sp 4 (all heads, the last chunk)
SP_CHUNK_SHAPES = (("tp2-sp2-chunk0", 1, 4096, 16, 4, 128, 8192, 0),
                   ("tp2-sp2-chunk1", 1, 4096, 16, 4, 128, 8192, 4096),
                   ("sp4-chunk3", 1, 2048, 32, 8, 128, 8192, 6144))
SP_CHUNK_ROW = "tp2-sp2-chunk1"
#: phase 7.2, the B9 path against the plain-attention path: each step's
#: loss (relative); every param element within six learning rates (each of
#: three Adam steps moves an element by about lr * sign(g), so a gradient
#: within the fp32 noise of 0 may flip an update by 2 lr), and at most a
#: 1e-4 share of the elements further apart than 1e-6
TRAIN_LOSS_REL = 1e-4
TRAIN_PARAM_ATOL = 6 * 3e-4
TRAIN_PARAM_NEAR = 1e-6
TRAIN_PARAM_FAR_SHARE = 1e-4
#: the keys of the reference's ``TrainRunner.train`` result
#: (``cordum_tpu/worker/training.py:168-178``)
TRAIN_RESULT_KEYS = {"model", "mesh", "resumed_from", "steps_done", "completed",
                     "final_loss", "loss_first", "seconds", "checkpointed"}


def dense_case(torch, dev, b, t, h, kvh, hd, dtype, seed=SEED, *, tk=None, first=0):
    """Seeded q ``[B, T]``, k and v ``[B, tk]`` (default T) and dO in
    ``dtype``, positions ``first + arange(T)`` as ``forward`` passes them
    (a sequence-parallel rank's chunk starts at ``first``)."""
    tk = t if tk is None else tk
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, t, h, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((b, tk, kvh, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((b, tk, kvh, hd), generator=g, device=dev).to(dtype)
    do = torch.randn((b, t, h, hd), generator=g, device=dev).to(dtype)
    pos = torch.arange(first, first + t, dtype=torch.int32, device=dev).expand(b, t).contiguous()
    return q, k, v, do, pos


def dense_work_of(b, t, h, kvh, hd, el, positions, tk=None):
    """(bytes, operations) of the forward and of the backward of T queries
    against ``tk`` keys (default T): each input read once and each output
    written once (q, k, v, positions, out, lse; the backward also dO, dq,
    dk, dv); QK and PV, 4 hd a live (query, key) pair, forward; QK again,
    dP, dV, dK and dQ, 10 hd a pair, backward — over the pairs these
    positions make live (a row at a negative position attends to all
    ``tk`` keys).  The bf16 kernels' D pass (S and dP once more) is a means
    of theirs, not the function's, and is not counted."""
    tk = t if tk is None else tk
    pos = positions.long().cpu()
    live = (pos + 1).clamp(max=tk)
    live[pos < 0] = tk
    pairs = int(live.sum())
    q_el, kv_el = b * t * h * hd, b * tk * kvh * hd
    small = 4 * b * t + 4 * b * h * t
    fwd = (el * (2 * q_el + 2 * kv_el) + small, 4 * hd * h * pairs)
    bwd = (el * (4 * q_el + 4 * kv_el) + small, 10 * hd * h * pairs)
    return fwd, bwd


def worst_row(got, exact, scale, rows=None):
    """The largest over rows (the last axis; those ``rows`` selects, a
    boolean mask of the leading axes, when given) of a row's max ``|got -
    exact|`` over the larger of the row's largest ``|exact|`` and
    ``DENSE_ROW_FLOOR * scale``."""
    exact = exact.float()
    big = exact.abs().amax(-1)
    diff = (got.float() - exact).abs().amax(-1)
    err = diff / big.clamp(min=max(DENSE_ROW_FLOOR * scale, 1e-30))
    return (err if rows is None else err[rows]).max().item()


#: upper ends of the live-key buckets of :func:`dq_fails_by_live_keys`
LIVE_KEY_BUCKETS = (1, 2, 3, 7, 63, 511)


def dq_fails_by_live_keys(dq, exact_dq, scale, limit, pos, tk=None):
    """How many dq rows (a query position of one head) are each beyond the
    bf16 row gate's ``limit`` on their own (their error measured as
    :func:`worst_row` measures a row), counted by the row's number of live
    keys: ``{"1": n, "2": n, "3": n, "4-7": n, .., "512+": n}``."""
    exact = exact_dq.float()
    big = exact.abs().amax(-1).clamp(min=max(DENSE_ROW_FLOOR * scale, 1e-30))
    bad = ((dq.float() - exact).abs().amax(-1) / big > limit).cpu()  # [B, T, H]
    live = (pos.long().cpu() + 1).clamp(min=0, max=tk or pos.shape[1])  # [B, T]
    counts, lo = {}, 1
    for hi in LIVE_KEY_BUCKETS + (None,):
        sel = live >= lo if hi is None else (live >= lo) & (live <= hi)
        label = f"{lo}+" if hi is None else (str(lo) if lo == hi else f"{lo}-{hi}")
        counts[label] = int(bad[sel].sum())
        lo = None if hi is None else hi + 1
    return counts


def dense_grads(torch, fn, q, k, v, pos, do):
    """``fn(q, k, v, pos)`` and its (dq, dk, dv) for ``do``, through autograd."""
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
    out = fn(qr, kr, vr, pos)
    return (out.detach(), *torch.autograd.grad(out, (qr, kr, vr), do))


def bf16_row_gate(got, plain, exact, pos=None):
    """Each of out, dq, dk, dv: the kernel's and the plain version's worst
    row (:func:`worst_row`, scaled by the tensor's largest ``|exact|``, or
    dv's where the tensor is exactly 0: dq and dk at T 1), the limit, and
    whether the kernel is within.  With the positions ``pos [B, Tq]``,
    out's and dq's rows of more than :data:`SHORT_ROW_KEYS` live keys are
    also held to a limit of their own (``long``: the plain version's worst
    such row), never wider than the first."""
    res = {}
    dv_scale = exact[3].abs().max().item()
    for name, g, p, e in zip(("out", "dq", "dk", "dv"), got, plain, exact):
        scale = e.abs().max().item() or dv_scale
        kernel, ref = worst_row(g, e, scale), worst_row(p, e, scale)
        limit = DENSE_ROW_FACTOR * ref + DENSE_ROW_SLACK
        res[name] = dict(kernel=kernel, plain=ref, limit=limit, ok=kernel <= limit)
        if pos is None or name not in ("out", "dq"):
            continue
        rows = (pos.to(g.device).long() + 1 > SHORT_ROW_KEYS)[..., None].expand(g.shape[:-1])
        if bool(rows.any()):
            k_long, p_long = worst_row(g, e, scale, rows), worst_row(p, e, scale, rows)
            lim_long = DENSE_ROW_FACTOR * p_long + DENSE_ROW_SLACK
            res[name]["long"] = dict(kernel=k_long, plain=p_long, limit=lim_long)
            res[name]["ok"] = res[name]["ok"] and k_long <= lim_long
    return res


def dense_gate_controls(torch, q, k, v, pos, do, plain, exact):
    """Planted faults the bf16 row gate must refuse, each beside what the
    earlier gate (out within 6e-2 absolute of the bf16 plain version, each
    gradient within 5e-2 of its largest |value|) said of it:

    * ``gqa-head-dropped``: dK/dV from the kernel's backward with the last
      query head of each KV group left out (its dO zeroed) for the second
      half of the keys, whose dk and dv are small beside the early keys':
      a GQA sum that skips a head over half the sequence;
    * ``diagonal-tile-dropped``: the plain version with the keys of a row's
      own 64-row tile masked out in the second half of the rows;
    * ``fp8-inputs``: the plain version on q, k, v and dO rounded to
      float8_e4m3 (3 mantissa bits against bf16's 7).

    Raises if the row gate passes a control."""
    from cordum_tpu_torch.ops import dense_attention as da

    rep, late = q.shape[2] // k.shape[2], q.shape[1] // 2
    do_drop = do.clone()
    do_drop[:, :, rep - 1::rep] = 0
    fwd = da.dense_attention_fwd(q, k, v, pos)
    dq, dk, dv = da.dense_attention_bwd(q, k, v, pos, *fwd, do)
    _, dk_drop, dv_drop = da.dense_attention_bwd(q, k, v, pos, *fwd, do_drop)
    dk[:, late:], dv[:, late:] = dk_drop[:, late:], dv_drop[:, late:]
    controls = {
        "gqa-head-dropped": (fwd[0], dq, dk, dv),
        "diagonal-tile-dropped": dense_grads(
            torch, da.dense_attention_reference, q, k, v,
            torch.where(pos >= q.shape[1] // 2, (pos // 64) * 64 - 1, pos), do),
        "fp8-inputs": dense_grads(
            torch, da.dense_attention_reference,
            *(x.to(torch.float8_e4m3fn).to(q.dtype) for x in (q, k, v)), pos,
            do.to(torch.float8_e4m3fn).to(q.dtype)),
    }
    readings = {}
    for cname, got in controls.items():
        gate = bf16_row_gate(got, plain, exact)
        failed = [t for t in gate if not gate[t]["ok"]]
        old_out = (got[0].float() - plain[0].float()).abs().max().item()
        old_grads = [(g.float() - p.float()).abs().max().item() / p.float().abs().max().item()
                     for g, p in zip(got[1:], plain[1:])]
        old_ok = old_out <= 6e-2 and all(e <= 5e-2 for e in old_grads)
        readings[cname] = {t: gate[t]["kernel"] for t in gate}
        log(f"[dense-gate] control {cname}: worst row "
            + ", ".join(f"{t} {gate[t]['kernel']:.3e} (limit {gate[t]['limit']:.3e})"
                        for t in gate)
            + f"; refused on {failed}; earlier gate: out {old_out:.3e}, gradients "
            + ", ".join(f"{e:.3e}" for e in old_grads) + f" -> {'pass' if old_ok else 'fail'}")
        if not failed or (cname == "gqa-head-dropped" and not {"dk", "dv"} <= set(failed)):
            raise AssertionError(f"the bf16 row gate passed the planted fault {cname}: {gate}")
    return readings


def measure_dense(torch, dev, card, shape, dtype, flush):
    """B9's forward and backward against the plain version on one seeded
    case (fp32: against autograd of it, on the absolute and max-relative
    tolerances; bf16: the row gate against the exact result, which must also
    refuse three planted faults), then kernel, plain and SDPA times (forward
    alone; backward alone on a kept graph) and the bounds.  ``shape`` is a
    :data:`DENSE_SHAPES` row, or a :data:`SP_CHUNK_SHAPES` row (Tq queries
    from a first position against Tk keys; the planted faults, which the
    7.1 shapes check the gate with, are not repeated there)."""
    import torch.nn.functional as F

    from cordum_tpu_torch.ops import dense_attention as da

    tag, b, t, h, kvh, hd = shape[:6]
    tk, first = shape[6:] if len(shape) > 6 else (t, 0)
    name = str(dtype).split(".")[-1]
    q, k, v, do, pos = dense_case(torch, dev, b, t, h, kvh, hd, dtype, tk=tk, first=first)
    fwd = da.dense_attention_fwd(q, k, v, pos)  # an older tree's (chip_ab.py) returns three
    out = fwd[0]
    grads = da.dense_attention_bwd(q, k, v, pos, *fwd, do)
    again = da.dense_attention_bwd(q, k, v, pos, *fwd, do)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(a, b) for a, b in zip(grads, again))
    if not same_bits:
        raise AssertionError(f"dense_attention {dtype} ({shape[0]}): two backward calls differ")
    del again
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (q, k, v))
    ref = da.dense_attention_reference(qr, kr, vr, pos)
    ref_grads = torch.autograd.grad(ref, (qr, kr, vr), do, retain_graph=True)
    errs = {"out": (out.float() - ref.float()).abs().max().item()}
    grad_abs = 0.0
    for gname, got, want in zip(("dq", "dk", "dv"), grads, ref_grads):
        diff = (got.float() - want.float()).abs().max().item()
        grad_abs = max(grad_abs, diff)
        errs[gname] = diff / want.float().abs().max().item()
    finite = all(torch.isfinite(x).all().item() for x in (out, *grads))
    if not finite:
        raise AssertionError(f"dense_attention {name} ({tag}): a value is not finite")
    if dtype == torch.float32:
        if not (errs["out"] <= DENSE_OUT_ATOL
                and all(errs[g] <= DENSE_GRAD_REL for g in ("dq", "dk", "dv"))):
            raise AssertionError(
                f"dense_attention vs plain {name} ({tag}): {errs}; tolerances out "
                f"{DENSE_OUT_ATOL}, gradients {DENSE_GRAD_REL} of their max")
        gate_msg = (f"out {errs['out']:.3e} (tolerance {DENSE_OUT_ATOL:.0e}); gradients' max "
                    f"err over their max |value| dq {errs['dq']:.3e}, dk {errs['dk']:.3e}, dv "
                    f"{errs['dv']:.3e} (tolerance {DENSE_GRAD_REL:.0e})")
    else:
        plain = (ref.detach(), *ref_grads)
        exact = dense_grads(torch, da.dense_attention_reference,
                            *(x.float() for x in (q, k, v)), pos, do.float())
        gate = bf16_row_gate((out, *grads), plain, exact, pos)
        fails = dq_fails_by_live_keys(grads[0], exact[1], exact[1].abs().max().item(),
                                      gate["dq"]["limit"], pos, tk)
        log(f"[dense-gate] {tag} {name}: dq rows beyond the row gate's limit "
            f"({gate['dq']['limit']:.3e}) each, by live keys: {fails}  [{card}]")
        if not all(g["ok"] for g in gate.values()):
            raise AssertionError(f"dense_attention {name} ({tag}): bf16 row gate {gate}")
        if tk == t and first == 0:
            dense_gate_controls(torch, q, k, v, pos, do, plain, exact)
        gate_msg = ("worst row's err from exact over its max |exact| (kernel / plain bf16 / "
                    "limit; rows past " + str(SHORT_ROW_KEYS) + " live keys apart): " + ", ".join(
                        f"{g} {r['kernel']:.3e} / {r['plain']:.3e} / {r['limit']:.3e}"
                        + (f" (long rows {r['long']['kernel']:.3e} / {r['long']['plain']:.3e} / "
                           f"{r['long']['limit']:.3e})" if "long" in r else "")
                        for g, r in gate.items())
                    + f"; against plain bf16: out max abs {errs['out']:.3e}, gradients' max "
                    f"err over their max dq {errs['dq']:.3e}, dk {errs['dk']:.3e}, dv "
                    f"{errs['dv']:.3e}")
        del plain, exact
    # the library yardstick: SDPA on [B, H, T, hd] copies, K/V expanded to
    # the query heads (the copies are left out of its time); causal, or a
    # boolean [Tq, Tk] mask from the chunk's positions
    rep = h // kvh
    qh = q.transpose(1, 2).contiguous().requires_grad_()
    kh = k.repeat_interleave(rep, 2).transpose(1, 2).contiguous().requires_grad_()
    vh = v.repeat_interleave(rep, 2).transpose(1, 2).contiguous().requires_grad_()
    doh = do.transpose(1, 2).contiguous()
    sdpa_kw = {"is_causal": True} if tk == t and first == 0 else {
        "attn_mask": pos[0][:, None] >= torch.arange(tk, device=dev)[None, :]}
    lib = F.scaled_dot_product_attention(qh, kh, vh, **sdpa_kw)
    lib_err = (lib.detach().transpose(1, 2).float() - ref.detach().float()).abs().max().item()
    kernel_fwd = time_ms(torch, lambda: da.dense_attention_fwd(q, k, v, pos), iters=20,
                         flush=flush)
    kernel_bwd = time_ms(torch, lambda: da.dense_attention_bwd(q, k, v, pos, *fwd, do),
                         iters=20, flush=flush)
    with torch.no_grad():
        plain_fwd = time_ms(torch, lambda: da.dense_attention_reference(q, k, v, pos), iters=5,
                            flush=flush)
        lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, **sdpa_kw),
                          iters=10, flush=flush)
    plain_bwd = time_ms(torch, lambda: torch.autograd.grad(ref, (qr, kr, vr), do,
                                                           retain_graph=True),
                        iters=5, flush=flush)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(lib, (qh, kh, vh), doh,
                                                         retain_graph=True),
                      iters=10, flush=flush)
    split = device_split(torch, lambda: da.dense_attention_bwd(q, k, v, pos, *fwd, do), flush)
    fwd_work, bwd_work = dense_work_of(b, t, h, kvh, hd, q.element_size(), pos, tk)
    res = {"dq_fails": fails} if dtype == torch.bfloat16 else {}
    for kind, ms, plain_ms, lib_ms, (nbytes, ops), err in (
            ("fwd", kernel_fwd, plain_fwd, lib_fwd, fwd_work, errs["out"]),
            ("bwd", kernel_bwd, plain_bwd, lib_bwd, bwd_work, grad_abs)):
        mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_OPS[name] * 1e3
        res[kind] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=max(mem_ms, ops_ms),
                         bound_by="bytes" if mem_ms >= ops_ms else "operations")
        log(f"[dense-kernel] {tag} {name} {kind}: kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  "
            f"library_ms {lib_ms:.4f}  bound_ms {res[kind]['bound_ms']:.4f} "
            f"({res[kind]['bound_by']}: {nbytes} bytes, {ops} ops), share of bound "
            f"{res[kind]['bound_ms'] / ms:.3f}  [{card}]")
    chunk = f", Tk {tk}, positions {first}..{first + t - 1}" if (tk, first) != (t, 0) else ""
    log(f"[dense-kernel] {tag} {name} (B {b}, T {t}, H {h}, KVH {kvh}, hd {hd}{chunk}): {gate_msg}; "
        f"sdpa vs plain {lib_err:.3e}; backward bits equal on two calls: {same_bits}; "
        f"backward device us per call: {split}")
    del q, k, v, do, fwd, out, grads, qr, kr, vr, ref, ref_grads, qh, kh, vh, doh, lib, sdpa_kw
    torch.cuda.empty_cache()
    return res


def _kernel_label(mangled):
    """``name<dtype, head_dim>`` of a kernel's mangled name: the identifier
    ending in ``_kernel`` that its length prefix names, and its template
    arguments."""
    import re

    end = mangled.index("_kernelI") + len("_kernel")
    name = mangled
    for n in range(len("_kernel") + 1, 60):
        if mangled[end - n - len(str(n)):end - n] == str(n):
            name = mangled[end - n:end]
            break
    tail = mangled[end + 1:]
    hd = re.search(r"Li(\d+)E", tail)
    if tail.startswith("13__nv_bfloat16") or "_wgmma_" in name or "_mma_" in name:
        dtype = "bf16"
    else:
        dtype = "fp32"
    return f"{name}<{dtype}, {hd.group(1) if hd else '?'}>"


def ptxas_report(build_log):
    """``(kernel, registers, spill store bytes, spill load bytes)`` of each
    kernel in an ``nvcc -Xptxas -v`` log."""
    import re

    rows, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": _kernel_label(m.group(1))}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["stores"], cur["loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            rows.append((cur["kernel"], int(m.group(1)), cur.get("stores", 0), cur.get("loads", 0)))
            cur = None
    return rows


def log_ptxas(build_log):
    """Phase 7.1's build lines: registers and spills of every B9 kernel
    (the Hopper kernels' count is the launch's; setmaxnreg then moves
    registers from the producer warpgroup to the consumers)."""
    if not build_log:
        log("[dense-build] the library was not built in this run: no ptxas report")
        return
    rows = ptxas_report(build_log)
    for kernel, regs, stores, loads in rows:
        log(f"[dense-build] {kernel}: {regs} registers, spill stores {stores} B, spill loads "
            f"{loads} B")
    hopper = [r for r in rows if "_wgmma_" in r[0]]
    log(f"[dense-build] bf16 wgmma kernels (head_dim 64, 128): {len(hopper)}, spill stores "
        f"{sum(r[2] for r in hopper)} B in all")


def phase_dense_kernel(torch, dev, card):
    """Both shapes in both dtypes; returns the main shape's rows."""
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def flush():
        flush_buf.zero_()

    rows = {"dense_attention_fwd": {}, "dense_attention_bwd": {}}
    for shape in DENSE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            res = measure_dense(torch, dev, card, shape, dtype, flush)
            if shape is DENSE_SHAPES[0]:
                name = str(dtype).split(".")[-1]
                rows["dense_attention_fwd"][name] = res["fwd"]
                rows["dense_attention_bwd"][name] = res["bwd"]
    del flush_buf
    return rows


def phase_sp_chunk_kernel(torch, dev, card):
    """12.6: B9 at a sequence-parallel rank's shapes (:data:`SP_CHUNK_SHAPES`)
    against its plain version, in both dtypes, by phase 7.1's gates
    (:func:`measure_dense`); returns the :data:`SP_CHUNK_ROW` shape's rows."""
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def flush():
        flush_buf.zero_()

    rows = {"dense_attention_fwd_sp": {}, "dense_attention_bwd_sp": {}}
    for shape in SP_CHUNK_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            res = measure_dense(torch, dev, card, shape, dtype, flush)
            if shape[0] == SP_CHUNK_ROW:
                name = str(dtype).split(".")[-1]
                rows["dense_attention_fwd_sp"][name] = res["fwd"]
                rows["dense_attention_bwd_sp"][name] = res["bwd"]
    del flush_buf
    torch.cuda.empty_cache()
    return rows


def dense_launches(n_layers, steps):
    """The dense kernels' launches of the run just driven: one forward and
    one backward a layer a step."""
    n = read_launches()
    fwd, bwd = n["dense_attention_fwd"], n["dense_attention_bwd"]
    if fwd != n_layers * steps or bwd != n_layers * steps or fwd == 0:
        raise AssertionError(f"dense_attention launches forward {fwd}, backward {bwd}; "
                             f"{n_layers} layers x {steps} steps expected")
    return {"dense_attention_fwd": fwd, "dense_attention_bwd": bwd}


def phase_train_oracle(torch, dev, card, cfg, *, batch=2, seq=256, steps=3):
    """fp32 train steps (AdamW 3e-4, wd 0.01) at ``cfg``'s widths: the B9
    path against the plain-attention path, both from one initial copy of the
    params (kept on the host), one path after the other so that one
    optimizer state lives at a time.  Returns the B9 path's launches."""
    from cordum_tpu_torch import optim
    from cordum_tpu_torch.models import llama

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = llama.init_params(cfg, generator=gen, device=dev)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    initial = [p.detach().to("cpu", copy=True) for p in leaves]
    rng = np.random.default_rng(SEED + 8)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32))
               .to(dev) for _ in range(steps)]

    def run(attention):
        with torch.no_grad():
            for p, x in zip(leaves, initial):
                p.copy_(x)
        _, step = llama.make_train_step(cfg, device=dev, attention=attention)
        state = optim.adamw_init(params)
        losses = []
        for toks in batches:
            _, state, loss = step(params, state, toks)
            losses.append(loss.item())
        del state
        torch.cuda.synchronize()
        return losses

    zero_launches()
    kernel_losses = run(llama._attention)
    launches = dense_launches(cfg.n_layers, steps)
    kernel_params = [p.detach().clone() for p in leaves]
    torch.cuda.empty_cache()
    zero_launches()
    plain_losses = run(plain_attention)
    if any(read_launches()[k] for k in ("dense_attention_fwd", "dense_attention_bwd")):
        raise AssertionError("the plain-attention path launched the dense kernels")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(kernel_losses, plain_losses))
    max_diff, far, total = 0.0, 0, 0
    for a, b in zip(kernel_params, leaves):
        diff = (a - b.detach()).abs()
        max_diff = max(max_diff, diff.max().item())
        far += int((diff > TRAIN_PARAM_NEAR).sum().item())
        total += diff.numel()
    finite = all(math.isfinite(x) for x in kernel_losses + plain_losses)
    if not (finite and loss_rel <= TRAIN_LOSS_REL and max_diff <= TRAIN_PARAM_ATOL
            and far <= TRAIN_PARAM_FAR_SHARE * total):
        raise AssertionError(
            f"fp32 train oracle: losses {kernel_losses} (B9) vs {plain_losses} (plain), rel "
            f"{loss_rel:.3e} (tolerance {TRAIN_LOSS_REL:g}); params max abs diff {max_diff:.3e} "
            f"(tolerance {TRAIN_PARAM_ATOL:g}), {far} of {total} elements apart by more than "
            f"{TRAIN_PARAM_NEAR:g} (allowed share {TRAIN_PARAM_FAR_SHARE:g})")
    log(f"[train-oracle] fp32 {cfg.n_layers}-layer Llama-3-8B widths, B {batch}, T {seq}, "
        f"{steps} AdamW steps: losses B9 {kernel_losses}, plain {plain_losses} (max rel diff "
        f"{loss_rel:.3e}); params after step {steps}: max abs diff {max_diff:.3e}, {far} of "
        f"{total} elements apart by more than {TRAIN_PARAM_NEAR:g}; launches {launches}  [{card}]")
    del params, leaves, initial, kernel_params, batches
    torch.cuda.empty_cache()
    return launches


def phase_train_bf16(torch, dev, card, cfg, *, batch=4, seq=2048, steps=10):
    """bf16 train steps on one fixed batch through ``make_train_step``: the
    loss must be finite and fall from the first step to the last.  Then two
    steps more under ``torch.profiler`` (informational, not counted).
    Returns the launches and the step's numbers (p50 ms, tokens/s, peak
    GiB)."""
    from cordum_tpu_torch.models import llama

    init, step = llama.make_train_step(cfg, device=dev)
    params, state = init(SEED)
    rng = np.random.default_rng(SEED + 9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated(dev) / 2**30  # params, moments, the batch
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, state, loss = step(params, state, toks)
        losses.append(loss.item())  # waits for the step
        secs.append(time.perf_counter() - t0)
    launches = dense_launches(cfg.n_layers, steps)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 train run: losses {losses} (finite, falling expected)")
    p50 = statistics.median(secs[1:])
    log(f"[train] bf16 {cfg.n_layers}-layer Llama-3-8B widths, B {batch}, T {seq}, {steps} "
        f"steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f} ({', '.join(f'{x:.4f}' for x in losses)}); "
        f"step p50 {p50 * 1e3:.2f} ms (steps 2-{steps}), first step {secs[0] * 1e3:.2f} ms, "
        f"{batch * seq / p50:.1f} tokens/s, peak memory {peak_gib:.2f} GiB ({state_gib:.2f} "
        f"GiB allocated before the first step); launches "
        f"{launches}  [{card}]")
    profile_train(torch, card, lambda: step(params, state, toks))
    del params, state
    torch.cuda.empty_cache()
    return launches, {"p50_ms": p50 * 1e3, "tokens_s": batch * seq / p50, "peak_gib": peak_gib}


def profile_train(torch, card, one_step, *, steps=2, families=("dense_attention",)):
    """Where a train step's device time goes: ``steps`` steps under
    ``torch.profiler``; the device's busy share of the window, the share of
    device time of the kernels whose names hold each of ``families`` and
    the top kernels.  Informational."""
    from torch.profiler import ProfilerActivity, profile

    saved = read_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    set_launches(saved)
    rows = kernel_rows(prof)
    total = sum(r[1] for r in rows)
    if not total:
        log("[profile-train] the profiler recorded no device time")
        return
    rows.sort(key=lambda r: -r[1])
    shares = []
    for family in families:
        us = sum(r[1] for r in rows if family in r[0])
        shares.append(f"{family} kernels {us / 1e3:.2f} ms ({100 * us / total:.1f}% of device "
                      f"time)")
    log(f"[profile-train] {steps} steps: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{total / 1e3:.1f} ms ({100 * total / wall_us:.1f}% of wall), {', '.join(shares)}  "
        f"[{card}]")
    for key, us, count in rows[:8]:
        log(f"[profile-train]   {us / 1e3:9.2f} ms {100 * us / total:5.1f}%  x{count:<6d} {key[:90]}")


async def run_train_jobs(torch, dev, ckpt_root, worker_id, payload, other_payload):
    """``train`` jobs through a port worker: ``payload`` (checkpointed
    every 2 steps) cancelled after step 2 (the cancel is sent when step 2
    reports, and the runner waits for it before step 3, so it lands there
    whatever the timing), re-dispatched to resume from step 2 and finish;
    then ``other_payload``.  Returns the three results, the launches of the
    whole run and the checkpointed steps; raises unless the results have the
    reference's keys and the cut and the resume happened as described."""
    from cordum_tpu_torch.worker import handlers
    from cordum_tpu_torch.worker.training import CheckpointDir, TrainRunner

    class StepBarrierRunner(TrainRunner):
        """A runner that, once step 2 has reported, waits until the job's
        cancel has landed."""

        def train(self, payload, *, cancelled=None, progress=None):
            def report_then_wait(frac, msg):
                progress(frac, msg)
                deadline = time.monotonic() + 120
                while msg.startswith("step 2/") and not cancelled():
                    if time.monotonic() > deadline:
                        raise AssertionError("the cancel sent at step 2 never landed")
                    time.sleep(0.005)

            return super().train(payload, cancelled=cancelled, progress=report_then_wait)

    w, _, sched = make_port_worker(torch, dev, worker_id, ckpt_root=ckpt_root)
    await sched.start()
    await w.start()

    async def cancel_at_step_2(pr):
        if pr.message.startswith("step 2/"):
            await sched.cancel(pr.job_id, "preempted")

    try:
        zero_launches()
        sched.on_progress = cancel_at_step_2
        handlers.TrainRunner = StepBarrierRunner
        try:
            [(_, first)] = await sched.run([payload], "train")
        finally:
            handlers.TrainRunner = TrainRunner
        sched.on_progress = None
        [(_, second)] = await sched.run([payload], "train")
        [(_, other)] = await sched.run([other_payload], "train-other")
        torch.cuda.synchronize()
        n = read_launches()
    finally:
        await w.stop()
    for doc in (first, second, other):
        if set(doc) != TRAIN_RESULT_KEYS:
            raise AssertionError(f"train result keys {sorted(doc)} != the reference's")
    steps = payload["steps"]
    if first["completed"] or first["steps_done"] != 2 or first["resumed_from"] != 0:
        raise AssertionError(f"the cancelled train job: {first}")
    if second["resumed_from"] != 2 or second["steps_done"] != steps or not second["completed"]:
        raise AssertionError(f"the re-dispatched train job: {second}")
    if not other["completed"] or not math.isfinite(other["final_loss"]):
        raise AssertionError(f"the {other_payload['model']} train job: {other}")
    saved = CheckpointDir(os.path.join(ckpt_root, payload["run_name"])).steps()
    if saved != list(range(2, steps + 1, 2))[-3:]:
        raise AssertionError(f"checkpoints {saved} of a {steps}-step run every 2 steps")
    return first, second, other, n, saved


async def drive_train_worker(torch, dev, card, ckpt_root, *, batch=8, seq=2048):
    """Phase 7.4: a ``llama`` run of 6 steps checkpointed every 2, cancelled
    after step 2 and resumed (:func:`run_train_jobs`); then a ``llama-tiny``
    run without checkpoints."""
    from cordum_tpu_torch.models import llama

    payload = {"op": "train", "model": "llama", "steps": 6, "batch": batch, "seq": seq,
               "checkpoint_every": 2, "run_name": "phase7"}
    tiny_payload = {"op": "train", "model": "llama-tiny", "steps": 3, "batch": 4, "seq": 64}
    first, second, tiny, n, steps = await run_train_jobs(
        torch, dev, ckpt_root, "w-train", payload, tiny_payload)
    if tiny["checkpointed"]:
        raise AssertionError(f"the llama-tiny train job: {tiny}")
    layers = llama.LlamaConfig().n_layers
    run_steps = first["steps_done"] + second["steps_done"] - second["resumed_from"]
    want = layers * run_steps + llama.LlamaConfig.tiny().n_layers * tiny["steps_done"]
    if not n["dense_attention_fwd"] == n["dense_attention_bwd"] == want:
        raise AssertionError(f"dense_attention launches {n}; {want} each expected")
    tokens = payload["batch"] * payload["seq"]
    log(f"[train-worker] llama (LlamaConfig(): {layers} layers, d 512, bf16), B {batch}, "
        f"T {seq}: "
        f"cancelled after {first['steps_done']} steps ({first['seconds']:.3f} s, loss "
        f"{first['loss_first']:.4f} -> {first['final_loss']:.4f}); re-dispatched: resumed from "
        f"{second['resumed_from']}, {second['steps_done']} steps done, completed, "
        f"{tokens * (second['steps_done'] - second['resumed_from']) / second['seconds']:.1f} "
        f"tokens/s over the job; checkpoints {steps}; llama-tiny: {tiny['steps_done']} steps, "
        f"loss {tiny['final_loss']:.4f}; launches forward {n['dense_attention_fwd']}, backward "
        f"{n['dense_attention_bwd']}  [{card}]")
    return {k: n[k] for k in ("dense_attention_fwd", "dense_attention_bwd")}


def phase_train(torch, dev, card, cfg8b, dense_log=""):
    """7.1 B9 vs its plain version and its times (``dense_log``: the B9
    library's build log, for its ptxas lines); 7.2 the fp32 train-step
    oracle; 7.3 the bf16 train run; 7.4 ``train`` jobs through a worker.
    Returns the kernel rows' numbers, each dtype's main-path launches and
    7.3's step numbers."""
    import tempfile

    log_ptxas(dense_log)
    rows = phase_dense_kernel(torch, dev, card)
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg8b, n_layers=2)
    fp32 = phase_train_oracle(torch, dev, card, dataclasses.replace(cfg2, dtype=torch.float32))
    bf16, dense_step = phase_train_bf16(torch, dev, card, cfg2)
    with tempfile.TemporaryDirectory(prefix="cordum-ckpt-") as ckpt_root:
        jobs = asyncio.run(drive_train_worker(torch, dev, card, ckpt_root))
    launches = {k: {"float32": fp32[k], "bfloat16": bf16[k] + jobs[k]} for k in fp32}
    return rows, launches, dense_step


# ---------------------------------------------------------------------------
# phase 8: the worker as its own process over the TCP statebus
# ---------------------------------------------------------------------------

#: the backlog a fleet worker sees: echo jobs and how many ride at once,
#: texts of the coalesced embed run, llm.generate prompts
PROC_ECHO_JOBS, PROC_IN_FLIGHT, PROC_EMBED_TEXTS, PROC_PROMPTS = 2000, 200, 512, 8
#: the seed the worker binary's GPUCompute draws its weights with
WORKER_SEED = 0


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_process(args, env, log_path):
    """``python -m <args>`` from the repo root, its stderr into
    ``log_path``.  A port worker process owns every card it sees, so on a
    host with more than one it is pinned to card 0, the script's card, with
    ``CUDA_VISIBLE_DEVICES`` (unless the caller set it): the phases hold
    its launches and heartbeat to one card."""
    if args[0] == "cordum_tpu_torch.cmd.worker" and "CUDA_VISIBLE_DEVICES" not in env:
        env = {**env, "CUDA_VISIBLE_DEVICES": "0"}
    log = open(log_path, "w")
    try:
        return subprocess.Popen([sys.executable, "-m", *args], env=env, stdout=log,
                                stderr=subprocess.STDOUT, cwd=os.path.dirname(
                                    os.path.abspath(__file__)))
    finally:
        log.close()


def stop_process(proc, sig=None, timeout_s=60.0):
    """Signal ``proc`` (SIGTERM by default) and wait; kill it if it
    outlives ``timeout_s``.  Returns its exit code."""
    import signal

    if proc.poll() is None:
        proc.send_signal(sig or signal.SIGTERM)
        try:
            proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.returncode


async def connect_when_up(statebus, url, proc, timeout_s=60.0):
    """The port's statebus client, once the server process accepts."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return await statebus.connect(url)
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                raise
            await asyncio.sleep(0.2)


def worker_exit_line(log_path):
    """The worker's ``worker stopped`` record (JSON log lines)."""
    for line in reversed(open(log_path).read().splitlines()):
        if line.startswith("{") and '"worker stopped"' in line:
            return json.loads(line)
    raise AssertionError(f"the worker process logged no exit line: see {log_path}")


async def drive_worker_process(torch, dev, card, workdir, *, n_new=16):
    """A port statebus process and a port worker process; this script plays
    the dispatcher over TCP with the port's client.  Every op of the table;
    generate against the dense oracle on the worker's own weights, embeds
    against the plain-version embedder; the heartbeat names the card, a
    telemetry beacon arrives; SIGTERM drains the worker to exit 0 with no
    cancelled session.  Returns the worker process's kernel launches and
    the end-to-end numbers."""
    from cordum_tpu_torch.infra import statebus
    from cordum_tpu_torch.infra.memstore import MemoryStore
    from cordum_tpu_torch.models import llama
    from cordum_tpu_torch.models.embedder import Embedder, EmbedderConfig
    from cordum_tpu_torch.protocol import subjects as subj

    port = free_port()
    url = f"statebus://127.0.0.1:{port}"
    worker_id = "w-proc"
    env = {**os.environ, "STATEBUS_PORT": str(port), "CORDUM_STATEBUS_URL": url,
           "WORKER_ID": worker_id, "WORKER_LLAMA_DTYPE": "float32",
           "WORKER_MAX_BATCH_SIZE": "256", "CORDUM_LOG_FORMAT": "json",
           "PYTHONDONTWRITEBYTECODE": "1"}
    # the worker runs where this script does (the CPU only in a rehearsal)
    env.pop("CORDUM_FORCE_CPU", None)
    if torch.device(dev).type == "cpu":
        env["CORDUM_FORCE_CPU"] = "1"
    bus_log, worker_log = os.path.join(workdir, "statebus.log"), os.path.join(workdir, "worker.log")
    server = start_process(["cordum_tpu_torch.cmd.statebus"], env, bus_log)
    procs = [server]
    conn = None
    try:
        kv, bus, conn = await connect_when_up(statebus, url, server)
        sched = JobDispatcher(bus, MemoryStore(kv), worker_id)
        await sched.start()
        beacons = []

        async def on_beacon(subject, pkt):
            beacons.append(pkt)

        await bus.subscribe(subj.telemetry_subject("worker"), on_beacon)
        t0 = time.monotonic()
        procs.append(start_process(["cordum_tpu_torch.cmd.worker"], env, worker_log))
        while not any(hb.worker_id == worker_id for hb in sched.heartbeats):
            if procs[1].poll() is not None or time.monotonic() - t0 > 600:
                raise AssertionError(f"the worker process never beat (rc {procs[1].poll()}); "
                                     f"see {worker_log}")
            await asyncio.sleep(0.1)
        boot_s = time.monotonic() - t0
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
        rng = np.random.default_rng(SEED + 10)
        t0 = time.monotonic()
        echo = await sched.run([{"op": "echo", "i": i} for i in range(PROC_ECHO_JOBS)], "echo",
                               in_flight=PROC_IN_FLIGHT)
        echo_rate = len(echo) / (time.monotonic() - t0)
        mm = [j for _ in range(4) for j in await sched.run(
            [{"op": "matmul", "b": 8, "n": 512, "k": 512, "m": 512, "iters": 4}], "matmul")]
        infer_jobs = [{"op": "infer", "tokens": [
            rng.integers(0, cfg.vocab_size, 32).tolist(),
            rng.integers(0, cfg.vocab_size, 20).tolist()]} for _ in range(4)]
        infer = await sched.run(infer_jobs, "infer")
        single, single_texts, single_wall = await embed_jobs(
            sched, make_texts(rng, 16, 1, 126), 1, "embed1", one_at_a_time=True)
        batched, batched_texts, batched_wall = await embed_jobs(
            sched, make_texts(rng, PROC_EMBED_TEXTS, 70, 126), 4, "embedB", one_at_a_time=False)
        prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
                   for n in np.linspace(4, 100, PROC_PROMPTS).astype(int)]
        gens = await sched.run([{"op": "llm.generate", "tokens": p, "max_new_tokens": n_new}
                                for p in prompts], "gen")
        deadline = time.monotonic() + 30
        while not beacons and time.monotonic() < deadline:
            await asyncio.sleep(0.1)
        rc = stop_process(procs[1])
    finally:
        if conn is not None:
            await conn.close()
        for proc in procs:
            stop_process(proc)
    exit_doc = worker_exit_line(worker_log)
    if rc != 0 or exit_doc.get("cancelled_sessions") != 0 or not exit_doc.get("drained"):
        raise AssertionError(f"SIGTERM: the worker exited {rc}, {exit_doc}")
    if not beacons or beacons[0].telemetry is None:
        raise AssertionError("no telemetry beacon arrived on sys.telemetry.worker")
    hb = next(h for h in sched.heartbeats if h.worker_id == worker_id)
    on_card = torch.device(dev).type == "cuda"
    if hb.device_kind != (torch.cuda.get_device_name(dev) if on_card else "cpu") \
            or hb.type != ("gpu" if on_card else "cpu"):
        raise AssertionError(f"the worker process's heartbeat does not name the card: {hb}")
    for jid, doc in echo:
        if doc["echo"]["op"] != "echo" or doc["worker"] != worker_id:
            raise AssertionError(f"{jid}: bad echo {doc}")
    for jid, doc in mm:
        if doc["shape"] != [8, 512, 512] or not math.isfinite(doc["checksum"]):
            raise AssertionError(f"{jid}: bad matmul {doc}")
    for jid, doc in infer:
        if len(doc["next_tokens"]) != 2 or not all(0 <= t < cfg.vocab_size
                                                   for t in doc["next_tokens"]):
            raise AssertionError(f"{jid}: bad infer {doc}")
    # the oracle on the worker's own weights: init_params from a generator
    # on the card seeded as GPUCompute seeds its own
    params = llama.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(WORKER_SEED),
                               device=dev)
    ties_n, all_ties = 0, []
    for p, (jid, doc) in zip(prompts, gens):
        want, ties = dense_greedy(torch, llama, params, cfg, p, n_new, dev)
        upto = ties[0] if ties else n_new
        ties_n += len(ties)
        all_ties.append(ties)
        if doc["tokens"][:upto] != want[:upto] or len(doc["tokens"]) != n_new:
            raise AssertionError(f"worker process generate of a {len(p)}-token prompt gave "
                                 f"{doc['tokens']}, oracle {want} (compared up to {upto})")
        if sched.streams.get(jid) != doc["tokens"]:
            raise AssertionError(f"{jid}: streamed tokens differ from the result")
    # the worker's embedder: the same config and seed
    same = types.SimpleNamespace(embedder=Embedder(EmbedderConfig(), seed=WORKER_SEED, device=dev))
    err = max(check_embeddings(torch, same, single, single_texts, "bfloat16"),
              check_embeddings(torch, same, batched, batched_texts, "bfloat16"))
    launches = exit_doc["kernel_launches"]
    steps = exit_doc["serving_steps"]
    ecfg = EmbedderConfig()
    if not (launches["paged_attention"] == cfg.n_layers * steps > 0
            and launches["embed_attention"] > 0 and launches["embed_attention"] % ecfg.n_layers == 0
            and launches["dense_attention_fwd"] > 0
            and launches["dense_attention_fwd"] % cfg.n_layers == 0
            and launches["dense_attention_bwd"] == 0):
        raise AssertionError(f"worker process launches {launches} ({steps} serving steps)")
    ttft = statistics.median((sched.first_token[j] - sched.sent[j]) * 1e3 for j, _ in gens)
    p50 = {op: sched.p50_ms([j for j, _ in jobs]) for op, jobs in (
        ("echo", echo), ("matmul", mm), ("infer", infer), ("embed (one at a time)", single),
        ("embed (coalesced)", batched), ("llm.generate", gens))}
    n_single = sum(len(t) for t in single_texts.values())
    n_batched = sum(len(t) for t in batched_texts.values())
    numbers = worker_numbers(echo_rate, n_single / single_wall, n_batched / batched_wall, ttft, p50)
    log(f"[worker-proc] statebus and worker processes over TCP; worker up in {boot_s:.1f} s "
        f"(first heartbeat), heartbeat device_kind {hb.device_kind!r}; {len(beacons)} telemetry "
        f"beacon(s); SIGTERM: exit {rc}, drained {exit_doc['drained']}, cancelled sessions "
        f"{exit_doc['cancelled_sessions']}  [{card}]")
    log(f"[worker-proc] {len(gens)} llm.generate jobs (LlamaConfig.tiny() fp32) token-identical "
        f"to the dense oracle ({ties_n} near-tie positions); {n_single + n_batched} embeddings "
        f"within {err:.3e} of the plain version; launches {launches} ({steps} serving steps)  "
        f"[{card}]")
    record = {"infer": list(zip(infer_jobs, (doc for _, doc in infer))),
              "embed1": [({"op": "embed", "texts": single_texts[jid]}, doc) for jid, doc in single],
              "gen": [({"op": "llm.generate", "tokens": p, "max_new_tokens": n_new}, doc)
                      for p, (_, doc) in zip(prompts, gens)],
              "ties": all_ties}
    return launches, numbers, record


def phase_worker_process(torch, dev, card, numbers6):
    """Phase 8, then its numbers beside phase 6's (in-process; phase 6
    serves Llama-3-8B bf16, phase 8 LlamaConfig.tiny() fp32).  Returns the
    launches and the record of the jobs phase 16.4 repeats."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="cordum-proc-") as workdir:
        launches, numbers, record = asyncio.run(drive_worker_process(torch, dev, card, workdir))
    for key, value in numbers.items():
        log(f"[worker-proc] {key}: process over TCP {value:.2f}, in-process (phase 6) "
            f"{numbers6.get(key, float('nan')):.2f}  [{card}]")
    return launches, record


# ---------------------------------------------------------------------------
# phase 9: the MoE family (B7)
# ---------------------------------------------------------------------------

#: phase 9's tokens a step at the main shape: B 4 x T 2048 (capacity 2560
#: at Mixtral-8x7B's 8 experts, top 2, capacity factor 1.25)
MOE_BATCH, MOE_SEQ = 4, 2048
#: B7 vs its plain version on the same inputs.  The route, the dispatch and
#: the combine backward's d_out must be equal (indices; a gather; one fp32
#: product rounded once).  The combine forward and the dispatch backward are
#: fp32 sums of k terms in another order, each rounded once to the dtype:
#: within MOE_SUM_ROUNDING of the sum of the terms' magnitudes, plus one ulp
#: of the dtype (MOE_ULP, relative to the plain value).  d_w is a D-long fp32
#: dot in another order: within MOE_DW_REL of the sum of its products'
#: magnitudes (two orders' worst case is 2 D 2^-24 = 4.9e-4 at D 4096, the
#: typical error sqrt(D) 2^-24 = 3.8e-6).
MOE_SUM_ROUNDING = 2.0**-22
MOE_ULP = {"float32": 2.0**-23, "bfloat16": 2.0**-7}
MOE_DW_REL = 1e-4
#: phase 9.2, the B7 + B9 path against the plain path in fp32: the loss
#: (relative), and each gradient's max abs difference over its largest
#: |value| (B9's fp32 gate: sums over up to 256 keys and over the tokens in
#: another order, carried through two layers)
MOE_LOSS_REL = 1e-5
MOE_GRAD_REL = 1e-4


def moe_config():
    """Mixtral-8x7B's layer widths on the Llama-3-8B base: D 4096, d_ff
    14336, 8 experts, top 2, capacity factor 1.25."""
    from cordum_tpu_torch.models import llama, moe

    return moe.MoEConfig(base=llama.LlamaConfig.llama3_8b(), n_experts=8, top_k=2)


def moe_case(torch, dev, dtype, *, n=MOE_BATCH * MOE_SEQ, d=4096, e=8, k=2, cf=1.25,
             kind="random", seed=SEED):
    """Seeded B7 operands: tokens ``[N, D]``, the fp32 probabilities of a
    random router over them (``kind`` "drop": three quarters of the tokens
    pushed to expert 0; "one": all of them; "ties": every other row uniform
    and every fourth row's top two equal), the capacity, expert outputs
    ``[E, C, D]`` and the upstream gradients of the combine (``dy``) and of
    the dispatch (``d_ei``)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randn((n, d), generator=g, device=dev).to(dtype)
    router = torch.randn((d, e), generator=g, device=dev) / math.sqrt(d)
    logits = tokens.float() @ router
    if kind in ("drop", "one"):
        logits[: n if kind == "one" else 3 * n // 4, 0] += 30.0
    probs = torch.softmax(logits, dim=-1)
    if kind == "ties":
        probs[::2] = 1.0 / e
        probs[1::4, :2] = probs[1::4].amax(-1, keepdim=True)
    cap = max(1, int(cf * n * k / e))
    expert_out = torch.randn((e, cap, d), generator=g, device=dev).to(dtype)
    dy = torch.randn((n, d), generator=g, device=dev).to(dtype)
    d_ei = torch.randn((e, cap, d), generator=g, device=dev).to(dtype)
    return {"tokens": tokens, "probs": probs.contiguous(), "k": k, "cap": cap,
            "expert_out": expert_out, "dy": dy, "d_ei": d_ei}


def routing_weights(torch, probs, route):
    """``moe_ffn``'s weights: the top-k probabilities renormalised."""
    w = torch.gather(probs, 1, route.idx.long())
    return w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)


def kept_rows(torch, rows, route):
    """``[N, k, D]`` fp32: each slot's row of ``rows [E, C, D]`` (zeros where
    the slot was dropped; a dropped slot may hold any idx, an ep rank's
    view a negative one)."""
    pos = torch.where(route.keep, route.pos, 0).long()
    idx = torch.where(route.keep, route.idx, 0).long()
    return rows.float()[idx, pos] * route.keep[..., None]


def check_moe(torch, case, tag):
    """The B7 kernels (through their autograd Functions, then each backward
    kernel once more) against the plain versions (autograd of the
    reference's einsums) on one case, gated as ``MOE_*`` says; empty
    capacity rows must be zeros and two calls must give the same bits.
    Returns the route, the weights and each launch mode's max abs error
    (``MOE_KERNELS``' names)."""
    from cordum_tpu_torch.ops import moe_dispatch as md

    probs, k, cap, tokens = case["probs"], case["k"], case["cap"], case["tokens"]
    route = md.moe_route_kernel(probs, k, cap)
    again = md.moe_route_kernel(probs, k, cap)
    plain_route = md.moe_route_reference(probs, k, cap)
    torch.cuda.synchronize()
    for field in md.MoERoute._fields:
        got, want, other = (getattr(r, field) for r in (route, plain_route, again))
        if got is None and want is None and other is None:  # no room
            continue
        if not torch.equal(got, want) or not torch.equal(got, other):
            raise AssertionError(f"moe_route ({tag}): {field} differs from the plain version's "
                                 "or between two calls")
    w = routing_weights(torch, probs, route)
    errs = check_moe_gathers(torch, case, route, w, tag)
    kept = int(route.keep.sum())
    log(f"[moe-kernel] {tag}: N {tokens.shape[0]}, D {tokens.shape[1]}, E {probs.shape[1]}, "
        f"k {k}, C {cap}: {kept} of {route.keep.numel()} slots kept, counts "
        f"{route.counts.tolist()}; route, dispatch and d_out equal to the plain version's; max "
        f"abs err " + ", ".join(f"{MOE_KERNELS[m]} {errs[m]:.3e}" for m in (
            "moe_token_gather", "moe_token_sum", "moe_token_dot"))
        + "; backward bits equal on two calls")
    return route, w, errs


def check_moe_gathers(torch, case, route, w, tag):
    """:func:`check_moe`'s gates on B7's five gathers over ``route`` (the
    kernels' and the plain versions', on the same route) with the routing
    weights ``w``: the case's tokens, expert outputs ``[E, C, D]`` (E the
    route's experts), ``dy`` and ``d_ei``.  Returns each launch mode's max
    abs error, the route's 0."""
    from cordum_tpu_torch.ops import moe_dispatch as md

    tokens, expert_out, dy, d_ei = (case[x] for x in ("tokens", "expert_out", "dy", "d_ei"))
    name = str(tokens.dtype).split(".")[-1]
    tok, out, wk = (x.clone().requires_grad_() for x in (tokens, expert_out, w))
    expert_in = md.moe_dispatch(tok, route)
    y = md.moe_combine(out, wk, route)
    (d_tokens,) = torch.autograd.grad(expert_in, tok, d_ei)
    d_out, d_w = torch.autograd.grad(y, (out, wk), dy)
    twice = (md.moe_token_sum(d_ei, route), md.moe_slot_gather_scaled(dy, route, w),
             md.moe_token_dot(dy, expert_out, route))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((d_tokens, d_out, d_w), twice)):
        raise AssertionError(f"moe backward ({tag}): two calls differ")
    tok_p, out_p, w_p = (x.clone().requires_grad_() for x in (tokens, expert_out, w))
    ei_p = md.moe_dispatch_reference(tok_p, route)
    y_p = md.moe_combine_reference(out_p, w_p, route)
    (d_tokens_p,) = torch.autograd.grad(ei_p, tok_p, d_ei)
    d_out_p, d_w_p = torch.autograd.grad(y_p, (out_p, w_p), dy)
    outs = (expert_in, y, d_tokens, d_out, d_w)
    if not all(torch.isfinite(x).all().item() for x in outs):
        raise AssertionError(f"moe ({tag}): a value is not finite")
    errs = {"moe_route": 0.0}
    for mode, got, want in (("moe_slot_gather", expert_in, ei_p),
                            ("moe_slot_gather_scaled", d_out, d_out_p)):
        errs[mode] = (got.float() - want.float()).abs().max().item()
        if not torch.equal(got, want):
            raise AssertionError(f"moe {MOE_KERNELS[mode]} ({tag}): not equal to the plain "
                                 f"version, max abs err {errs[mode]:.3e}")
        if (got[route.slot_token < 0] != 0).any():
            raise AssertionError(f"moe {MOE_KERNELS[mode]} ({tag}): an empty capacity row is "
                                 "not zero")
    for mode, got, want, mag in (
            ("moe_token_gather", y, y_p, (kept_rows(torch, expert_out, route).abs()
                                          * w.abs()[..., None]).sum(1)),
            ("moe_token_sum", d_tokens, d_tokens_p,
             kept_rows(torch, d_ei, route).abs().sum(1))):
        diff = (got.float() - want.float()).abs()
        limit = MOE_ULP[name] * want.float().abs() + MOE_SUM_ROUNDING * mag
        if not (diff <= limit).all():
            worst = (diff - limit).argmax()
            raise AssertionError(f"moe {MOE_KERNELS[mode]} ({tag}): error "
                                 f"{diff.flatten()[worst].item():.3e} beyond one rounding "
                                 f"({limit.flatten()[worst].item():.3e})")
        errs[mode] = diff.max().item()
    mag_w = (kept_rows(torch, expert_out, route).abs() * dy.float().abs()[:, None, :]).sum(-1)
    diff_w = (d_w - d_w_p).abs()
    if not (diff_w <= MOE_DW_REL * mag_w).all() or (d_w[~route.keep] != 0).any():
        raise AssertionError(f"moe d_w ({tag}): max err {diff_w.max().item():.3e}, limit "
                             f"{MOE_DW_REL:g} of the products' magnitudes")
    errs["moe_token_dot"] = diff_w.max().item()
    del tok, out, wk, tok_p, out_p, w_p, ei_p, y_p, d_tokens_p, d_out_p, d_w_p, outs
    return errs


#: C3, the token gathers at any k (a token's kept slots): an fp32 sum of n
#: terms in another order than the plain version's.  Per order, n - 1
#: roundings of the running sum plus one of each product (an FMA skips it),
#: each within 2^-24 of the terms' magnitudes; two orders apart by twice
#: that; then the final cast to the dtype, one ulp of it (``MOE_ULP``).
MOE_TERM_ROUNDING = 2.0**-24


def moe_sum_limit(n_terms, mag, want, name):
    """:data:`MOE_TERM_ROUNDING`'s bound on the difference of two fp32 sums
    of ``n_terms`` terms whose magnitudes sum to ``mag``, cast to the
    dtype ``name``: ``MOE_ULP[name] |want| + 2 n 2^-24 mag``."""
    return MOE_ULP[name] * want.float().abs() + 2 * n_terms * MOE_TERM_ROUNDING * mag


def check_token_gathers(torch, case, tag):
    """C3: B7's three token gathers on one case, through their counted
    wrappers on the case's route (``moe_route``: the kernel's on a card):
    the combine forward and the dispatch backward (sums of a token's k
    kept slots) and d_w (a D-long dot a slot), each against the plain
    version (autograd of the reference's einsums) within
    :func:`moe_sum_limit`.  Returns each one's max abs error and its worst
    share of its limit."""
    from cordum_tpu_torch.ops import moe_dispatch as md

    probs, k, cap = case["probs"], case["k"], case["cap"]
    tokens, expert_out, dy, d_ei = (case[x] for x in ("tokens", "expert_out", "dy", "d_ei"))
    name = str(tokens.dtype).split(".")[-1]
    route = md.moe_route(probs, k, cap)
    w = routing_weights(torch, probs, route)
    got = {"moe_token_gather": md.moe_token_gather(expert_out, route, w),
           "moe_token_sum": md.moe_token_sum(d_ei, route),
           "moe_token_dot": md.moe_token_dot(dy, expert_out, route)}
    tok_p, out_p, w_p = (x.clone().requires_grad_() for x in (tokens, expert_out, w))
    (d_tokens_p,) = torch.autograd.grad(md.moe_dispatch_reference(tok_p, route), tok_p, d_ei)
    y_p = md.moe_combine_reference(out_p, w_p, route)
    d_w_p = torch.autograd.grad(y_p, w_p, dy)[0]
    rows = kept_rows(torch, expert_out, route).abs()
    want = {
        "moe_token_gather": (y_p.detach(), k, (rows * w.abs()[..., None]).sum(1)),
        "moe_token_sum": (d_tokens_p, k, kept_rows(torch, d_ei, route).abs().sum(1)),
        "moe_token_dot": (d_w_p, tokens.shape[1], (rows * dy.float().abs()[:, None, :]).sum(-1)),
    }
    out = {}
    for mode, (plain, n_terms, mag) in want.items():
        diff = (got[mode].float() - plain.float()).abs()
        limit = moe_sum_limit(n_terms, mag, plain, "float32" if mode == "moe_token_dot"
                              else name)
        share = (diff / limit.clamp_min(1e-38)).max().item()
        if not torch.isfinite(got[mode]).all() or not (diff <= limit).all():
            worst = (diff - limit).argmax()
            raise AssertionError(
                f"moe {MOE_KERNELS[mode]} ({tag}): error {diff.flatten()[worst].item():.3e} "
                f"beyond the {n_terms}-term bound {limit.flatten()[worst].item():.3e}")
        out[mode] = (diff.max().item(), share)
    log(f"[moe-wide] {tag}: N {tokens.shape[0]}, D {tokens.shape[1]}, E {probs.shape[1]}, k "
        f"{k}, {int(route.keep.sum(1).max())} kept slots at most a token: " + ", ".join(
            f"{MOE_KERNELS[m]} max abs err {e:.3e} ({share:.3f} of its bound)"
            for m, (e, share) in out.items()))
    return out


def moe_work_of(route, n, d, e, cap, k, el):
    """(bytes, operations) of each B7 launch mode on this route: each input
    read once and each output written once, counting only the rows this
    run's route touches (the tokens with a kept slot, the kept slots'
    rows); a multiply-add is two operations."""
    kept = int(route.keep.sum())
    read_tokens = int(route.keep.any(1).sum())
    slots, rows_out, tokens_out = n * k, e * cap * d * el, n * d * el
    return {
        # probs in; idx, pos, keep, counts, slot_token, slot_k out; E
        # comparisons a (token, expert)
        "moe_route": (n * e * 4 + slots * 9 + e * 4 + 2 * e * cap * 4, n * e * e),
        # slot_token and the routed tokens in, the capacity buffer out
        "moe_slot_gather": (e * cap * 4 + read_tokens * d * el + rows_out, 0),
        # slot_token, slot_k, the kept slots' weights and the routed rows of
        # dy in, the capacity buffer out; a multiply a kept element
        "moe_slot_gather_scaled": (2 * e * cap * 4 + kept * 4 + read_tokens * d * el
                                   + rows_out, kept * d),
        # idx, pos, keep, w and the kept rows in, the tokens out; a
        # multiply-add a kept element
        "moe_token_gather": (slots * 13 + kept * d * el + tokens_out, 2 * kept * d),
        # idx, pos, keep and the kept rows in, the tokens out; an add a kept
        # element
        "moe_token_sum": (slots * 9 + kept * d * el + tokens_out, kept * d),
        # idx, pos, keep, the routed rows of dy and the kept rows in, d_w
        # out; a multiply-add a kept element
        "moe_token_dot": (slots * 9 + read_tokens * d * el + kept * d * el + slots * 4,
                          2 * kept * d),
    }


def measure_moe(torch, dev, card, dtype, flush):
    """Phase 9.1 for one dtype: the gates on the main shape and on the
    capacity-drop and exact-tie cases, then each launch mode's time beside
    its bound, its plain version's (the reference's einsum, or autograd of
    it for a backward mode) and the library call's.  A mode's error is its
    worst over the three cases."""
    import torch.nn.functional as F

    from cordum_tpu_torch.ops import moe_dispatch as md

    name = str(dtype).split(".")[-1]
    worst = dict.fromkeys(MOE_KERNELS, 0.0)
    for kind, cf in (("drop", 0.25), ("ties", 1.25), ("main", 1.25)):
        case = moe_case(torch, dev, dtype, kind="random" if kind == "main" else kind, cf=cf)
        route, w, errs = check_moe(torch, case, f"{name} {kind}")
        worst = {mode: max(worst[mode], errs[mode]) for mode in worst}
        torch.cuda.empty_cache()
    tokens, probs, k, cap = case["tokens"], case["probs"], case["k"], case["cap"]
    expert_out, dy, d_ei = case["expert_out"], case["dy"], case["d_ei"]
    (n, d), e = tokens.shape, probs.shape[1]
    # the plain backward modes: autograd of the reference's einsums, the
    # graph built once
    tok_p, out_p, w_p = (x.clone().requires_grad_() for x in (tokens, expert_out, w))
    ei_p = md.moe_dispatch_reference(tok_p, route)
    y_p = md.moe_combine_reference(out_p, w_p, route)
    # the library yardsticks: index_select over the tokens with a zero row
    # appended; embedding_bag over bags of one row scaled by its weight
    # (d_out), and summing each token's kept rows weighted by w or by keep
    # (in the dtype: embedding_bag takes weights of the table's dtype)
    rows = torch.where(route.slot_token >= 0, route.slot_token, n).reshape(-1).long()
    padded = torch.cat([tokens, tokens.new_zeros((1, d))])
    padded_dy = torch.cat([dy, dy.new_zeros((1, d))])
    row_w = torch.where(route.slot_token >= 0, w[route.slot_token.clamp_min(0).long(),
                                                 route.slot_k.clamp_min(0).long()], 0.0)
    row_w = row_w.reshape(-1, 1).to(dtype)
    flat = route.idx.long() * cap + torch.where(route.keep, route.pos, 0).long()
    psw, ones = (w * route.keep).to(dtype), route.keep.to(dtype)
    table, d_table = expert_out.reshape(e * cap, d), d_ei.reshape(e * cap, d)
    timed = {
        "moe_route": (lambda: md.moe_route_kernel(probs, k, cap),
                      lambda: md.moe_route_reference(probs, k, cap), None),
        "moe_slot_gather": (lambda: md.moe_slot_gather(tokens, route),
                            lambda: md.moe_dispatch_reference(tokens, route),
                            lambda: torch.index_select(padded, 0, rows)),
        "moe_slot_gather_scaled": (
            lambda: md.moe_slot_gather_scaled(dy, route, w),
            lambda: torch.autograd.grad(y_p, out_p, dy, retain_graph=True),
            lambda: F.embedding_bag(rows[:, None], padded_dy, per_sample_weights=row_w,
                                    mode="sum")),
        "moe_token_gather": (lambda: md.moe_token_gather(expert_out, route, w),
                             lambda: md.moe_combine_reference(expert_out, w, route),
                             lambda: F.embedding_bag(flat, table, per_sample_weights=psw,
                                                     mode="sum")),
        "moe_token_sum": (lambda: md.moe_token_sum(d_ei, route),
                          lambda: torch.autograd.grad(ei_p, tok_p, d_ei, retain_graph=True),
                          lambda: F.embedding_bag(flat, d_table, per_sample_weights=ones,
                                                  mode="sum")),
        "moe_token_dot": (lambda: md.moe_token_dot(dy, expert_out, route),
                          lambda: torch.autograd.grad(y_p, w_p, dy, retain_graph=True), None),
    }
    with torch.no_grad():
        lib_in = timed["moe_slot_gather"][2]()
        if not torch.equal(lib_in.reshape(e, cap, d), md.moe_slot_gather(tokens, route)):
            raise AssertionError("index_select yardstick differs from the dispatch")
        lib_err = {mode: (timed[mode][2]().float() - timed[mode][0]().reshape(-1, d).float())
                   .abs().max().item()
                   for mode in ("moe_slot_gather_scaled", "moe_token_gather", "moe_token_sum")}
        del lib_in
        work = moe_work_of(route, n, d, e, cap, k, tokens.element_size())
        res = {}
        for mode, (fn, plain, lib) in timed.items():
            ms = time_ms(torch, fn, iters=20, flush=flush)
            with torch.enable_grad():
                plain_ms = time_ms(torch, plain, iters=5, flush=flush)
            lib_ms = time_ms(torch, lib, iters=20, flush=flush) if lib else None
            nbytes, ops = work[mode]
            mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = ops / PEAK_OPS["float32" if mode == "moe_route" else name] * 1e3
            res[mode] = dict(max_abs_err=worst[mode], ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=max(mem_ms, ops_ms),
                             bound_by="bytes" if mem_ms >= ops_ms else "operations")
            lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "none (no one call)"
            log(f"[moe-kernel] {name} {mode} ({MOE_KERNELS[mode]}): kernel_ms {ms:.4f}  "
                f"plain_ms {plain_ms:.4f}  library_ms {lib_txt}  bound_ms "
                f"{res[mode]['bound_ms']:.4f} ({res[mode]['bound_by']}: {nbytes} bytes, {ops} "
                f"ops), share of bound {res[mode]['bound_ms'] / ms:.3f}, max abs err "
                f"{worst[mode]:.3e} (worst of the three cases); device us per call: "
                f"{device_split(torch, fn, flush)}  [{card}]")
    log(f"[moe-kernel] {name} library calls vs the kernels, max abs: " + ", ".join(
        f"{mode} {err:.3e}" for mode, err in lib_err.items()) + f"  [{card}]")
    del case, route, w, timed, tok_p, out_p, w_p, ei_p, y_p, padded, padded_dy, rows, row_w
    del flat, psw, ones, table, d_table
    torch.cuda.empty_cache()
    return res


def phase_moe_kernel(torch, dev, card):
    """9.1 in both dtypes; returns each kernel row's numbers by dtype."""
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def flush():
        flush_buf.zero_()

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for kernel, res in measure_moe(torch, dev, card, dtype, flush).items():
            rows.setdefault(kernel, {})[name] = res
        # the token gathers above 32 kept slots a token, to their n-term bound
        check_token_gathers(torch, moe_case(torch, dev, dtype, n=200, d=64, e=40, k=36,
                                            seed=11), f"k 36 of E 40, {name}")
    del flush_buf
    return rows


def moe_launches(n_layers, steps, *, dense=True):
    """The B7 (and B9) launches of the run just driven: a layer's forward
    and backward launch each B7 mode once, B9 once each way."""
    n = read_launches()
    want = dict.fromkeys(MOE_KERNELS, 1)
    if dense:
        want.update(dense_attention_fwd=1, dense_attention_bwd=1)
    want = {key: per * n_layers * steps for key, per in want.items()}
    got = {key: n[key] for key in want}
    if got != want or not steps:
        raise AssertionError(f"MoE path launches {got}; {n_layers} layers x {steps} steps give "
                             f"{want}")
    return got


def layer0_kept(torch, params, toks, cfg):
    """The kept slots of layer 0's route on ``toks`` (the plain path's
    arithmetic), out of N k."""
    from cordum_tpu_torch.models import llama, moe
    from cordum_tpu_torch.ops import moe_dispatch as md

    b, t = toks.shape
    layer = params["layers"][0]
    positions = torch.arange(t, dtype=torch.int32, device=toks.device).expand(b, t)
    with torch.no_grad():
        x = llama._attention_residual(params["embed"][toks.long()], layer, cfg.base, positions,
                                      plain_attention)
        x = llama.rms_norm(x, layer["mlp_norm"], cfg.base.norm_eps).reshape(b * t, -1)
        probs = torch.softmax(x.float() @ layer["moe"]["router"], dim=-1)
        route = md.moe_route_reference(probs, cfg.top_k, moe.capacity(cfg, b * t))
    return int(route.keep.sum()), route.keep.numel()


def worst_grad(got, want, names):
    """The largest of each gradient's max error over its largest |value|,
    and the leaf it is in; an error that is not finite (a NaN or inf in
    either gradient) is the worst at once."""
    worst = (0.0, None)
    for g, w, name in zip(got, want, names):
        err = (g - w).abs().max().item() / max(w.abs().max().item(), 1e-30)
        if not math.isfinite(err):
            return math.inf, name
        if err > worst[0]:
            worst = (err, name)
    return worst


def phase_moe_oracle(torch, dev, card, cfg, *, batch=2, seq=256, drop_cf=0.5):
    """9.2: ``moe.loss_fn`` and every gradient on the kernel path (B7 + B9)
    against the plain path (the plain route, dispatch and combine, the plain
    attention) on one copy of the fp32 params, at ``cfg``'s capacity factor
    and at ``drop_cf``, where layer 0 must drop slots to the residual path;
    no optimizer step (its moments would not fit beside two gradient sets).
    Returns the kernel path's launches."""
    from cordum_tpu_torch import optim
    from cordum_tpu_torch.models import moe

    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = moe.init_params(cfg, generator=gen, device=dev)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(SEED + 10)
    toks = torch.from_numpy(rng.integers(0, cfg.base.vocab_size, (batch, seq))
                            .astype(np.int32)).to(dev)
    n_params = sum(p.numel() for p in leaves)
    total = {}
    for run_cfg in (cfg, dataclasses.replace(cfg, capacity_factor=drop_cf)):
        kept, slots = layer0_kept(torch, params, toks, run_cfg)
        drops = run_cfg.capacity_factor < cfg.capacity_factor
        if drops and kept == slots:
            raise AssertionError(f"fp32 MoE oracle: capacity factor {drop_cf} dropped no slot")
        zero_launches()
        loss = moe.loss_fn(params, toks, run_cfg)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        launches = moe_launches(cfg.base.n_layers, 1)
        zero_launches()
        plain_loss = moe.loss_fn(params, toks, run_cfg, attention=plain_attention,
                                 kernels=False)
        plain_grads = torch.autograd.grad(plain_loss, leaves)
        torch.cuda.synchronize()
        if any(read_launches().values()):
            raise AssertionError(f"the plain MoE path launched kernels: {read_launches()}")
        loss_rel = abs(loss.item() - plain_loss.item()) / abs(plain_loss.item())
        worst, worst_at = worst_grad(grads, plain_grads, range(len(grads)))
        if not (math.isfinite(loss.item()) and loss_rel <= MOE_LOSS_REL
                and worst <= MOE_GRAD_REL):
            raise AssertionError(
                f"fp32 MoE oracle (capacity factor {run_cfg.capacity_factor}): loss "
                f"{loss.item()} (B7 + B9) vs {plain_loss.item()} (plain), rel {loss_rel:.3e} "
                f"(tolerance {MOE_LOSS_REL:g}); worst gradient (leaf {worst_at}) {worst:.3e} of "
                f"its max (tolerance {MOE_GRAD_REL:g})")
        log(f"[moe-oracle] fp32 {cfg.base.n_layers}-layer Mixtral-8x7B widths ({n_params} "
            f"params), B {batch}, T {seq}, capacity factor {run_cfg.capacity_factor} (C "
            f"{moe.capacity(run_cfg, batch * seq)}; layer 0 kept {kept} of {slots} slots): loss "
            f"B7 + B9 {loss.item():.6f}, plain {plain_loss.item():.6f} (rel {loss_rel:.3e}); "
            f"{len(grads)} gradients, worst max abs diff over its max {worst:.3e} (leaf "
            f"{worst_at}); launches {launches}; peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB  [{card}]")
        total = {key: total.get(key, 0) + n for key, n in launches.items()}
        del grads, plain_grads, loss, plain_loss
        gc.collect()
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_moe_bf16(torch, dev, card, cfg, *, batch=MOE_BATCH, seq=MOE_SEQ, steps=10):
    """9.3: bf16 train steps on one fixed batch through ``make_train_step``;
    the loss must be finite and fall.  Step p50, tokens/s, peak memory, then
    two steps more under ``torch.profiler`` (not counted).  Returns the
    launches and the losses."""
    from cordum_tpu_torch.models import moe

    init, step = moe.make_train_step(cfg, device=dev)
    params, state = init(SEED)
    rng = np.random.default_rng(SEED + 11)
    toks = torch.from_numpy(rng.integers(0, cfg.base.vocab_size, (batch, seq))
                            .astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, state, loss = step(params, state, toks)
        losses.append(loss.item())
        secs.append(time.perf_counter() - t0)
    launches = moe_launches(cfg.base.n_layers, steps)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 MoE train run: losses {losses} (finite, falling expected)")
    p50 = statistics.median(secs[1:])
    log(f"[moe-train] bf16 {cfg.base.n_layers}-layer Mixtral-8x7B widths, B {batch}, T {seq}, "
        f"{steps} steps on one batch: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({', '.join(f'{x:.4f}' for x in losses)}); step p50 {p50 * 1e3:.2f} ms (steps "
        f"2-{steps}), first step {secs[0] * 1e3:.2f} ms, {batch * seq / p50:.1f} tokens/s, peak "
        f"memory {peak_gib:.2f} GiB ({state_gib:.2f} GiB allocated before the first step); "
        f"launches {launches}  [{card}]")
    profile_train(torch, card, lambda: step(params, state, toks),
                  families=("moe_", "dense_attention"))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, losses


async def drive_moe_train_worker(torch, dev, card, ckpt_root, *, batch=8, seq=128):
    """9.4: a ``moe-tiny`` run of 6 steps checkpointed every 2, cancelled
    after step 2 and resumed; then a ``moe`` run (both ``MoEConfig.tiny()``,
    as the reference builds them).  Result keys and the mesh as the
    reference's, with ``ep`` 1."""
    from cordum_tpu_torch.models import moe

    payload = {"op": "train", "model": "moe-tiny", "steps": 6, "batch": batch, "seq": seq,
               "checkpoint_every": 2, "run_name": "phase9", "mesh": {"ep": 2}}
    other_payload = {"op": "train", "model": "moe", "steps": 3, "batch": batch, "seq": seq}
    first, second, other, _, saved = await run_train_jobs(
        torch, dev, ckpt_root, "w-moe", payload, other_payload)
    mesh = {"dp": 1, "tp": 1, "sp": 1, "ep": 1, "pp": 1}
    if any(doc["mesh"] != mesh for doc in (first, second, other)):
        raise AssertionError(f"MoE train job meshes {[d['mesh'] for d in (first, second, other)]}")
    run_steps = first["steps_done"] + second["steps_done"] - second["resumed_from"] \
        + other["steps_done"]
    launches = moe_launches(moe.MoEConfig.tiny().base.n_layers, run_steps)
    log(f"[moe-worker] moe-tiny (MoEConfig.tiny(): 2 layers, d 64, 4 experts, top 2, bf16), B "
        f"{batch}, T {seq}: cancelled after {first['steps_done']} steps (loss "
        f"{first['loss_first']:.4f} -> {first['final_loss']:.4f}); re-dispatched: resumed from "
        f"{second['resumed_from']}, {second['steps_done']} steps done, loss "
        f"{second['final_loss']:.4f}; checkpoints {saved}; moe: {other['steps_done']} steps, loss "
        f"{other['loss_first']:.4f} -> {other['final_loss']:.4f}; mesh {mesh} (ep 2 asked, one "
        f"card); launches {launches}  [{card}]")
    return launches


def phase_moe(torch, dev, card):
    """9.1 B7 vs its plain version and its times; 9.2 the fp32 gradient
    oracle; 9.3 the bf16 train run; 9.4 ``train`` jobs through a worker.
    Returns the B7 rows' numbers, each dtype's main-path launches of B7 and
    B9, and 9.3's first loss."""
    import tempfile

    rows = phase_moe_kernel(torch, dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    cfg = moe_config()
    cfg2 = dataclasses.replace(cfg, base=dataclasses.replace(cfg.base, n_layers=2))
    fp32 = phase_moe_oracle(torch, dev, card, dataclasses.replace(
        cfg2, base=dataclasses.replace(cfg2.base, dtype=torch.float32)))
    bf16, losses = phase_moe_bf16(torch, dev, card, cfg2)
    with tempfile.TemporaryDirectory(prefix="cordum-ckpt-") as ckpt_root:
        jobs = asyncio.run(drive_moe_train_worker(torch, dev, card, ckpt_root))
    launches = {key: {"float32": fp32[key], "bfloat16": bf16[key] + jobs[key]} for key in fp32}
    return rows, launches, losses[0]


# ---------------------------------------------------------------------------
# phase 10: tensor-parallel serving gangs
# ---------------------------------------------------------------------------

#: the gang's width: Llama-3-8B over two ranks is h 16, kvh 4 a rank
GANG_TP = 2
#: a gang's merged KV export against one rank's: the row-parallel outputs
#: are fp32 sums over up to d_ff terms in another order, which differ by at
#: most about n 2^-24 of the terms' magnitudes; a record must lie within
#: d_ff * GANG_ARENA_PER_TERM of its largest |value| (the CPU tests' rule,
#: tests/test_torch_shard.py: 8.5e-4 at d_ff 14336)
GANG_ARENA_PER_TERM = 2.0**-24
#: seconds any collective or store read of a gang may wait before it fails
GANG_TIMEOUT_S = 120.0
#: the phase 10.4 gang job: the reference's payload contract (tiny config,
#: fp32, a seed), two prompts, and the seed its ranks draw their weights from
GANG_JOB_SEED = 3


def phase_gang_kernel(torch, dev, card):
    """10.1: B1 at a tp-2 rank's heads (h 16, kvh 4, hd 128) on phase 2's
    8192-token case, bf16 and fp32, gated and timed as phase 2 does."""
    case = attention_case(torch, dev, LONG_ROWS, h=32 // GANG_TP, kvh=8 // GANG_TP)
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def flush():
        flush_buf.zero_()

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v = (x.to(dtype) for x in case[:3])
        results[name] = measure_paged(torch, dev, card, (q, k, v, *case[3:]), name,
                                      f"8192-token tp{GANG_TP} rank", flush)
        del q, k, v
    del flush_buf, case
    return results


def drive_gang_backend(backend, prompt, n_new, pages):
    """Prefill ``prompt`` and decode ``n_new - 1`` tokens through the
    backend's compat calls on ``pages``; returns the tokens and the next
    position."""
    first = backend.prefill(prompt, pages)
    out, pos = [first], len(prompt)
    for _ in range(n_new - 1):
        (nxt,) = backend.decode([(out[-1], pos, pages)])
        out.append(int(nxt))
        pos += 1
    return out, pos


def check_gang_export(cfg, merged, single):
    """The merged gang records against one rank's, within d_ff *
    GANG_ARENA_PER_TERM of each record's largest value; returns the worst
    ratio of error to that bound."""
    if len(merged) != len(single):
        raise AssertionError(f"gang export: {len(merged)} records, one rank {len(single)}")
    worst = 0.0
    for m, s in zip(merged, single):
        if (m["i"], m["used"], m["shape"]) != (s["i"], s["used"], s["shape"]):
            raise AssertionError(f"gang export record header {m['i'], m['used'], m['shape']}")
        for fld in ("k", "v"):
            a = np.frombuffer(m[fld], np.float32)
            b = np.frombuffer(s[fld], np.float32)
            bound = cfg.d_ff * GANG_ARENA_PER_TERM * float(np.abs(b).max())
            worst = max(worst, float(np.abs(a - b).max()) / bound)
    if not worst <= 1.0:
        raise AssertionError(f"gang export differs from one rank's: {worst:.3f} of the bound")
    return worst


def compare_near_tie(got, want, ties, what):
    """``got`` against the oracle's ``want`` up to its first near-tie
    position (phase 3's rule)."""
    upto = ties[0] if ties else len(want)
    if got[:upto] != want[:upto] or len(got) != len(want):
        raise AssertionError(f"{what}: {got}, oracle {want} (compared up to {upto})")


def phase_gang_oracle(torch, dev, card, cfg, prompts, oracle, served, *, n_new=16):
    """10.2: ``ServingGangGroup(tp=2)`` on the card (two threads, gloo over
    CUDA tensors) on phase 3's weights (drawn again from the seed) and
    prompts, speculative off and on; tokens against phase 3's single-rank
    engine and the dense oracle under the near-tie rule, B1 launches =
    ranks x layers x steps, the gang's merged export against one rank's,
    and the export imported into a single-rank backend decoding on.
    Returns the run's B1 launches (both ranks)."""
    from cordum_tpu_torch.models import llama
    from cordum_tpu_torch.ops import paged_attention as pa
    from cordum_tpu_torch.serving.backend import LlamaServingBackend
    from cordum_tpu_torch.serving.engine import ServingEngine
    from cordum_tpu_torch.serving.pager import PageAllocator
    from cordum_tpu_torch.serving.shard import ServingGangGroup, merge_rank_records

    params = llama.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
                               device=dev)
    waves = serving_prompts(cfg.vocab_size)
    sizing = dict(num_pages=1024, page_size=16, max_seqs=8, max_batch_tokens=8 + 16,
                  params_provider=lambda: params, device=dev)
    launches = 0
    for speculative in (False, True):
        gang = ServingGangGroup(cfg, tp=GANG_TP, **sizing)
        collective = gang.ranks[1].tp_group.backend
        engine = ServingEngine(gang, run_blocking=asyncio.to_thread, max_sessions=8,
                               max_new_tokens_cap=n_new, speculative=speculative)
        pa.paged_attention.launches = 0
        outs = asyncio.run(serve_waves(engine, waves, n_new, f"gang{int(speculative)}"))
        run_launches = pa.paged_attention.launches
        st = engine.stats
        engine.allocator.check_consistency()
        for p, out, single, (want, ties) in zip(prompts, outs, served[speculative], oracle):
            compare_near_tie(out, want, ties, f"gang speculative={speculative}, "
                             f"{len(p)}-token prompt")
            compare_near_tie(out, single, ties, f"gang vs one rank, speculative={speculative}")
        if run_launches != GANG_TP * cfg.n_layers * st.steps or run_launches == 0:
            raise AssertionError(f"gang B1 launches {run_launches} != {GANG_TP} ranks x "
                                 f"{cfg.n_layers} layers x {st.steps} steps")
        if gang.compiled_per_rank() != [1] * GANG_TP:
            raise AssertionError(f"step shapes per rank {gang.compiled_per_rank()}")
        if speculative and st.drafted_tokens < 1:
            raise AssertionError("speculative gang run drafted nothing")
        launches += run_launches
        log(f"[gang] fp32 tp{GANG_TP} speculative={speculative}: {len(prompts)} requests "
            f"token-identical to the dense oracle and to one rank; steps {st.steps}, launches "
            f"{run_launches} (= {GANG_TP} ranks x {cfg.n_layers} layers x {st.steps} steps), "
            f"prefix hits {st.prefix_hits}, cow copies {st.cow_copies}, drafted "
            f"{st.drafted_tokens}, accepted {st.accepted_tokens}; collective {collective}  "
            f"[{card}]")
        if not speculative:
            gang.close()
    # the export: one session on the gang and on one rank, merged and held
    # together; then the gang's records imported into a fresh rank
    prompt, n = prompts[2], 8
    single = LlamaServingBackend(cfg, **sizing)
    pages = PageAllocator(1024, 16).alloc("x", -(-(len(prompt) + n + 8) // 16))
    toks_g, end = drive_gang_backend(gang, prompt, n, pages)
    toks_s, _ = drive_gang_backend(single, prompt, n, pages)
    exp = gang.export_kv(pages, 0, end)
    worst = check_gang_export(cfg, merge_rank_records(exp), single.export_kv(pages, 0, end))
    fresh = LlamaServingBackend(cfg, **sizing)
    fresh.import_kv(pages, exp)
    cont_f, cont_g = [], []
    last_f = last_g = toks_g[-1]
    for i in range(6):
        (last_f,) = fresh.decode([(last_f, end + i, pages)])
        (last_g,) = gang.decode([(last_g, end + i, pages)])
        cont_f.append(int(last_f))
        cont_g.append(int(last_g))
    want, ties = dense_greedy(torch, llama, params, cfg, prompt + toks_g, 6, dev)
    compare_near_tie(cont_f, want, ties, "single rank after importing the gang's export")
    compare_near_tie(cont_g, want, ties, "gang decoding on")
    log(f"[gang] export: {len(exp)} per-rank records merged to {len(exp) // GANG_TP}, within "
        f"{worst:.3f} of the bound d_ff x 2^-24 = {cfg.d_ff * GANG_ARENA_PER_TERM:.3e} of each "
        f"record's largest value; imported into one rank, which decodes on to the oracle's "
        f"tokens ({len(ties)} near ties)  [{card}]")
    gang.close()
    del gang, single, fresh, params
    return launches


def gang_rank_config(torch, llama, on_card, fp32):
    """The rank processes' model: bf16 Llama-3-8B, or with ``fp32`` phase
    3's fp32 cut of it (``reduced``: n_layers 32 -> 2); off the card (the
    CPU rehearsal) the tiny widths with 4 KV heads, so that 4 ranks split
    them, and room for phase 4's prompts."""
    cfg = llama.LlamaConfig.llama3_8b() if on_card else dataclasses.replace(
        llama.LlamaConfig.tiny(), n_heads=8, n_kv_heads=4, max_seq_len=512)
    return dataclasses.replace(cfg, n_layers=2, dtype=torch.float32) if fp32 else cfg


def gang_rank_main(args):
    """One rank process of phase 10.3 (``python3 chip_smoke.py --gang-rank
    R --gang-port P --gang-out PATH [--gang-tp N] [--gang-spread]
    [--gang-fp32] [--gang-device cpu] [--gang-new N]``): its slices of the
    model (:func:`gang_rank_config`) drawn from the seed (on card 0, or on
    card R with ``--gang-spread``), a TCPStore rendezvous on 127.0.0.1:P
    (rank 0 hosts it), then rank 0 serves through a ServingEngine over
    ShardedServingBackend(rank=0) (phase 4's settings, prefix sharing off)
    and puts each step's entries into the store ahead of the step
    (``step_message``); the other ranks replay them (``StepReplay``, as a
    gang worker's followers do, with the store for the statebus).  In bf16:
    phase 4's requests, speculative decoding on, then a shorter run of the
    same requests under ``torch.profiler``.  With ``--gang-fp32``: phase
    3's prompts, speculative off and then on, and rank 0's tokens in the
    output for the oracle.  Writes its numbers to PATH as JSON."""
    import argparse
    import datetime

    import torch
    import torch.distributed as dist

    from cordum_tpu_torch.models import llama
    from cordum_tpu_torch.ops import paged_attention as pa
    from cordum_tpu_torch.parallel.mesh import TPGroup
    from cordum_tpu_torch.serving.engine import ServingEngine
    from cordum_tpu_torch.serving.shard import ShardedServingBackend, StepReplay, step_message

    ap = argparse.ArgumentParser()
    ap.add_argument("--gang-rank", type=int, required=True)
    ap.add_argument("--gang-port", type=int, required=True)
    ap.add_argument("--gang-out", required=True)
    ap.add_argument("--gang-device", default="cuda")
    ap.add_argument("--gang-new", type=int, default=32)
    ap.add_argument("--gang-tp", type=int, default=GANG_TP)
    ap.add_argument("--gang-spread", action="store_true")
    ap.add_argument("--gang-fp32", action="store_true")
    a = ap.parse_args(args)
    rank, tp = a.gang_rank, a.gang_tp
    dev = (torch.device(a.gang_device, rank if a.gang_spread else 0)
           if a.gang_device == "cuda" else torch.device("cpu"))
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gang_rank_config(torch, llama, on_card, a.gang_fp32)
    timeout = datetime.timedelta(seconds=GANG_TIMEOUT_S)
    store = dist.TCPStore("127.0.0.1", a.gang_port, tp, rank == 0, timeout,
                          wait_for_workers=False)
    group = TPGroup.join(store, rank, tp, dev, timeout_s=GANG_TIMEOUT_S)
    # host seconds inside the all-reduces, and their count
    ar = {"s": 0.0, "n": 0}
    inner = group.all_reduce

    def timed_all_reduce(t):
        t0 = time.perf_counter()
        out = inner(t)
        ar["s"] += time.perf_counter() - t0
        ar["n"] += 1
        return out

    group.all_reduce = timed_all_reduce
    t0 = time.monotonic()
    backend = ShardedServingBackend(cfg, rank=rank, tp=tp, group=group, num_pages=1024,
                                    page_size=16, max_seqs=8, max_batch_tokens=8 + 16,
                                    seed=SEED, device=dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    backend._ensure()
    if on_card:
        torch.cuda.synchronize(dev)
    init_s = time.monotonic() - t0
    param_bytes = sum(x.numel() * x.element_size() for x in _leaves(backend._params))
    d, hd = cfg.d_model, cfg.head_dim
    layer = 2 * d + 2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + 3 * d * cfg.d_ff
    full_bytes = (2 * cfg.vocab_size * d + d + cfg.n_layers * layer) * cfg.dtype.itemsize
    seq = {"n": 0}

    def send(msg):
        store.set(f"step/{seq['n']}", json.dumps(msg))
        seq["n"] += 1

    if a.gang_fp32:
        waves = serving_prompts(cfg.vocab_size)
    else:
        rng = np.random.default_rng(SEED + 2)
        lengths = np.linspace(8, 300, 8).astype(int).tolist()
        waves = [[rng.integers(0, cfg.vocab_size, n).tolist() for n in lengths]]
    out = {"rank": rank, "collective": group.backend, "init_s": init_s, "n_layers": cfg.n_layers,
           "param_bytes": param_bytes, "full_bytes": full_bytes}
    pa.paged_attention.launches = 0
    if rank == 0:
        backend.before_step = lambda entries: send(step_message(seq["n"], entries))

        def engine(speculative=True):
            # phase 4's engine settings, but for prefix sharing: its page
            # copies happen outside the step and would not reach the others
            return ServingEngine(backend, run_blocking=asyncio.to_thread, max_sessions=8,
                                 max_new_tokens_cap=a.gang_new, prefix_cache=False,
                                 speculative=speculative)

        if a.gang_fp32:
            tokens, steps = [], 0
            for speculative in (False, True):
                eng = engine(speculative)
                tokens.append(asyncio.run(serve_waves(eng, waves, a.gang_new,
                                                      f"gang{int(speculative)}")))
                steps += eng.stats.steps
            out.update(steps=steps, tokens=tokens)
            launches, ar_s, ar_n, prof = pa.paged_attention.launches, ar["s"], ar["n"], None
            send(step_message(seq["n"], final=True))
        else:
            eng = engine()
            emits = []
            t0 = time.monotonic()
            outs = asyncio.run(serve_waves(eng, waves, a.gang_new, "gang", emits))
            if on_card:
                torch.cuda.synchronize(dev)
            wall = time.monotonic() - t0
            st = eng.stats
            out.update(steps=st.steps, wall_s=wall, drafted=st.drafted_tokens,
                       accepted=st.accepted_tokens,
                       ttft_p50_ms=statistics.median(st.ttft_seconds) * 1e3,
                       step_p50_ms=statistics.median(st.step_seconds) * 1e3,
                       tokens_per_s=st.decoded_tokens / wall, decode_p50=decode_rate(emits),
                       outputs_ok=all(len(o) == a.gang_new
                                      and all(0 <= t < cfg.vocab_size for t in o)
                                      for o in outs))
            launches, ar_s, ar_n = pa.paged_attention.launches, ar["s"], ar["n"]
            # every rank's profiler starts before the window does, and the
            # window ends for all at the final marker
            ctx = gang_profile_start(torch, on_card)
            send(step_message(seq["n"], profile=True))
            for r in range(1, tp):
                store.get(f"profiling/{r}")
            ctx.t0 = time.monotonic()
            asyncio.run(serve_waves(engine(), waves, 4, "gang-profile"))
            send(step_message(seq["n"], final=True))
            prof = gang_profile_stop(torch, on_card, ctx)
        for r in range(1, tp):
            store.get(f"done/{r}")  # every rank read the final marker: the store may close
    else:
        replay, prof, ctx = StepReplay(backend), None, None
        launches, ar_s, ar_n, steps = None, 0.0, 0, 0
        while True:
            replay.offer(json.loads(store.get(f"step/{replay.expected}")))
            msg = replay.next()
            if msg.get("profile") or msg.get("final"):
                if launches is None:  # the numbers of the serving run
                    launches, ar_s, ar_n = pa.paged_attention.launches, ar["s"], ar["n"]
                    steps = replay.replayed
            if msg.get("profile"):
                ctx = gang_profile_start(torch, on_card)
                store.set(f"profiling/{rank}", "1")
                ctx.t0 = time.monotonic()
            elif msg.get("final"):
                if ctx is not None:
                    prof = gang_profile_stop(torch, on_card, ctx)
                store.set(f"done/{rank}", "1")
                break
            else:
                replay.step(msg)
        out.update(steps=steps)
    out.update(launches=launches, all_reduce_host_s=ar_s, all_reduces=ar_n, profile=prof,
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else 0.0)
    with open(a.gang_out, "w") as f:
        json.dump(out, f)
    group.close()
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def gang_profile_start(torch, on_card):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    ctx = profile(activities=acts)
    ctx.__enter__()
    ctx.t0 = time.monotonic()
    return ctx


def gang_profile_stop(torch, on_card, ctx):
    """The window's wall time, device busy time (every thread's kernels:
    the device trace is process-wide) and the all-reduces' part of it:
    gloo's host<->device copies (it stages each all-reduce through host
    memory) or NCCL's kernels, which also count the time they wait for
    their peers."""
    if on_card:
        torch.cuda.synchronize()
    wall = time.monotonic() - ctx.t0
    ctx.__exit__(None, None, None)
    rows = kernel_rows(ctx) if on_card else []
    total = sum(r[1] for r in rows)
    collective = sum(r[1] for r in rows if "memcpy" in r[0].lower() or "nccl" in r[0].lower())
    return {"wall_ms": wall * 1e3, "device_ms": total / 1e3, "collective_ms": collective / 1e3}


def phase_gang_processes(torch, dev, card, single, *, n_new=32):
    """10.3: two rank processes of this script on the one card, bf16
    Llama-3-8B at full depth; gated on each rank's launches = layers x
    steps, each rank's parameter bytes below the whole model's, its peak
    memory below one rank's (phase 4) and outputs in the vocabulary; phase
    4's numbers (``single``) printed beside.  Returns the B1 launches of
    both ranks."""
    ranks = run_gang_ranks(dev, n_new=n_new)
    return check_gang_ranks(dev, card, ranks, single, n_new=n_new)


def run_gang_ranks(dev, *, n_new, tp=GANG_TP, spread=False, fp32=False):
    """Spawn ``tp`` rank processes (on card 0, or rank r on card r with
    ``spread``; the fp32 oracle's model with ``fp32``); returns each rank's
    JSON document."""
    import tempfile

    port = free_port()
    with tempfile.TemporaryDirectory(prefix="cordum-gang-") as workdir:
        procs, outs, logs = [], [], []
        try:
            for rank in range(tp):
                outs.append(os.path.join(workdir, f"rank{rank}.json"))
                logs.append(os.path.join(workdir, f"rank{rank}.log"))
                args = [os.path.abspath(__file__), "--gang-rank", str(rank), "--gang-port",
                        str(port), "--gang-out", outs[-1], "--gang-new", str(n_new),
                        "--gang-tp", str(tp)]
                if spread:
                    args.append("--gang-spread")
                if fp32:
                    args.append("--gang-fp32")
                if dev.type == "cpu":
                    args += ["--gang-device", "cpu"]
                with open(logs[-1], "w") as log_f:
                    procs.append(subprocess.Popen([sys.executable, *args], stdout=log_f,
                                                  stderr=subprocess.STDOUT))
            deadline = time.monotonic() + 600
            for proc in procs:
                try:
                    proc.wait(max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        finally:
            rcs = [stop_process(p, timeout_s=10) for p in procs]
        if any(rcs):
            for path in logs:
                log(open(path).read()[-3000:])
            raise AssertionError(f"gang rank processes exited {rcs}")
        return [json.load(open(path)) for path in outs]


def check_gang_ranks(dev, card, ranks, single, *, n_new, where="one card", tag="gang-proc"):
    lead, tp = ranks[0], len(ranks)
    peak_single = single["peak_gib"]
    n_layers = lead["n_layers"]
    for r in ranks:
        if r["launches"] != n_layers * lead["steps"] or r["launches"] == 0:
            raise AssertionError(f"rank {r['rank']}: B1 launches {r['launches']} != "
                                 f"{n_layers} layers x {lead['steps']} steps")
        if not r["param_bytes"] < r["full_bytes"]:
            raise AssertionError(f"rank {r['rank']} holds {r['param_bytes']} bytes of "
                                 f"parameters, the whole model is {r['full_bytes']}")
        if r["steps"] != lead["steps"]:
            raise AssertionError(f"rank {r['rank']} replayed {r['steps']} of {lead['steps']} "
                                 f"steps")
    if not lead["outputs_ok"]:
        raise AssertionError("rank 0's outputs are not in the vocabulary")
    log(f"[{tag}] bf16 Llama-3-8B, {n_layers} layers, tp{tp}: {tp} rank processes on {where}, "
        f"collective {lead['collective']}; 8 requests, {n_new} new each: steps {lead['steps']}, "
        f"step p50 {lead['step_p50_ms']:.2f} ms, TTFT p50 {lead['ttft_p50_ms']:.1f} ms, output "
        f"{lead['tokens_per_s']:.1f} tokens/s (whole run), decode p50 "
        f"{lead['decode_p50']:.1f} tokens/s per request; drafted {lead['drafted']} accepted "
        f"{lead['accepted']}; launches {[r['launches'] for r in ranks]} "
        f"(= {n_layers} x {lead['steps']} each)  [{card}]")
    log(f"[{tag}] one rank on one card (phase 4, the same requests): step p50 "
        f"{single['step_p50_ms']:.2f} ms, TTFT p50 {single['ttft_p50_ms']:.1f} ms, output "
        f"{single['tokens_per_s']:.1f} tokens/s, peak memory of its own weights and serving "
        f"{peak_single:.2f} GiB  [{card}]")
    for r in ranks:
        ar_share = r["all_reduce_host_s"] / lead["wall_s"]
        prof = r["profile"] or {}
        log(f"[{tag}] rank {r['rank']}: peak memory {r['peak_gib']:.2f} GiB, parameters "
            f"{r['param_bytes'] / 2**30:.2f} of {r['full_bytes'] / 2**30:.2f} GiB, weights "
            f"drawn in {r['init_s']:.1f} s; {r['all_reduces']} all-reduces, "
            f"{r['all_reduce_host_s'] * 1e3:.1f} ms of host time in them ({100 * ar_share:.1f}% "
            f"of rank 0's serving wall)  [{card}]")
        if prof:
            dev_ms = prof["device_ms"]
            coll_ms = prof["collective_ms"]
            log(f"[{tag}] rank {r['rank']} profiled window: wall {prof['wall_ms']:.1f} ms, "
                f"device busy {dev_ms:.1f} ms ({100 * dev_ms / prof['wall_ms']:.1f}% of wall), "
                f"of it the all-reduces ({lead['collective']}: "
                f"{'NCCL kernels' if lead['collective'] == 'nccl' else 'host<->device copies'}) "
                f"{coll_ms:.2f} ms ({100 * coll_ms / dev_ms if dev_ms else 0.0:.1f}%), the rest "
                f"{(dev_ms - coll_ms) / prof['wall_ms'] * 100:.1f}% of wall  [{card}]")
    if dev.type == "cuda" and not all(r["peak_gib"] < peak_single for r in ranks):
        raise AssertionError(f"rank peaks {[r['peak_gib'] for r in ranks]} GiB not below one "
                             f"rank's {peak_single:.2f}")
    return sum(r["launches"] for r in ranks)


def check_gang_oracle_ranks(card, ranks, oracle, served, *, where):
    """The fp32 rank processes' tokens, speculative off and on, against
    the dense oracle and phase 3's single-rank engine under the near-tie
    rule; B1 launches = layers x steps on each rank, every rank replaying
    every step.  Returns the near-tie count."""
    lead, tp = ranks[0], len(ranks)
    n_layers = lead["n_layers"]
    for r in ranks:
        if r["launches"] != n_layers * lead["steps"] or r["launches"] == 0:
            raise AssertionError(f"rank {r['rank']}: B1 launches {r['launches']} != "
                                 f"{n_layers} layers x {lead['steps']} steps")
        if r["steps"] != lead["steps"]:
            raise AssertionError(f"rank {r['rank']} replayed {r['steps']} of {lead['steps']} "
                                 f"steps")
    for speculative, outs in enumerate(lead["tokens"]):
        for out, single, (want, ties) in zip(outs, served[bool(speculative)], oracle):
            compare_near_tie(out, want, ties, f"fp32 gang tp{tp} on {where}, "
                             f"speculative={bool(speculative)}")
            compare_near_tie(out, single, ties, f"fp32 gang tp{tp} vs one rank, "
                             f"speculative={bool(speculative)}")
    n_ties = sum(len(t) for _, t in oracle)
    log(f"[gang-oracle] fp32, {n_layers} layers, tp{tp}: {tp} rank processes on {where}, "
        f"collective {lead['collective']}; speculative off and on, "
        f"{len(lead['tokens'][0])} requests each token-identical to the dense oracle and to "
        f"one rank ({n_ties} near ties); steps {lead['steps']}, launches "
        f"{[r['launches'] for r in ranks]} (= {n_layers} x {lead['steps']} each)  [{card}]")
    return n_ties


def main_cards() -> int:
    """``python3 chip_smoke.py --cards [--legs train,gang,moe,dryrun]``, on a
    host with two or more cards, one rank a card (NCCL).  ``train``, with
    four cards: phase 12.3-12.5, 12.9, 12.10, 13.3 and 13.4
    (:func:`cards_train_legs`).  ``moe``, with four cards: phase 14.3 and
    14.4 (:func:`cards_moe_legs`).  ``dryrun``, with four cards: the
    multi-rank dry run and a worker that owns the four cards
    (:func:`cards_dryrun_leg`).  ``gang``: at tp 2 and, with
    four cards, tp 4: phase 3's fp32 oracle on one card, then the fp32 gang
    of rank processes on its weights and prompts, its tokens held to the
    oracle and to one rank (:func:`check_gang_oracle_ranks`); then phase
    4's serving run on one card and phase 10.3's bf16 gang, with 10.3's
    gates (no token gate in bf16, no speed gate).  Every leg unless
    ``--legs`` names some.  Ends with the card line and the ``{"ok": true,
    ...}`` line, as the default run does."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_smoke --cards: needs two or more CUDA cards", file=sys.stderr)
        return 2
    from cordum_tpu_torch.models import llama

    legs = ("train", "moe", "gang", "dryrun")
    if "--legs" in sys.argv:
        legs = tuple(sys.argv[sys.argv.index("--legs") + 1].split(","))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    n = torch.cuda.device_count()
    card = f"{n} x {smi[0]}"
    log(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; legs {legs}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_kernels()
    if "train" in legs:
        if n < 4:
            raise AssertionError(f"the training legs need four cards, this host has {n}")
        cards_train_legs(torch, dev, card)
        gc.collect()
        torch.cuda.empty_cache()
    if "moe" in legs:
        if n < 4:
            raise AssertionError(f"the MoE legs need four cards, this host has {n}")
        cards_moe_legs(torch, dev, card)
        gc.collect()
        torch.cuda.empty_cache()
    if "gang" in legs:
        cards_gang_legs(torch, dev, card, n)
        gc.collect()
        torch.cuda.empty_cache()
    if "dryrun" in legs:
        if n < 4:
            raise AssertionError(f"the dryrun leg needs four cards, this host has {n}")
        cards_dryrun_leg(torch, dev, card)
    print("\n".join(smi))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": n}}))
    return 0


def cards_gang_legs(torch, dev, card, n):
    """The serving gangs of :func:`main_cards`."""
    from cordum_tpu_torch.models import llama

    tps = [tp for tp in (2, 4) if tp <= n]
    cfg32 = gang_rank_config(torch, llama, True, True)
    _, params, _, oracle, served = phase_oracle(torch, dev, card, cfg32)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for tp in tps:
        ranks = run_gang_ranks(dev, n_new=16, tp=tp, spread=True, fp32=True)
        if ranks[0]["collective"] != "nccl":
            raise AssertionError(f"fp32 tp{tp} over {tp} cards chose {ranks[0]['collective']}")
        check_gang_oracle_ranks(card, ranks, oracle, served, where=f"{tp} cards")
    _, params, single = phase_serve(torch, dev, card, llama.LlamaConfig.llama3_8b())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for tp in tps:
        ranks = run_gang_ranks(dev, n_new=32, tp=tp, spread=True)
        if ranks[0]["collective"] != "nccl":
            raise AssertionError(f"tp{tp} over {tp} cards chose {ranks[0]['collective']}")
        check_gang_ranks(dev, card, ranks, single, n_new=32, where=f"{tp} cards",
                         tag="gang-cards")
    gc.collect()
    torch.cuda.empty_cache()


def cards_train_legs(torch, dev, card):
    """Phase 12 on four cards, one rank process a card over NCCL (every
    leg must choose it).  12.3: fp32 at Llama-3-8B widths, 4 layers, B 4,
    T 256, one AdamW step: pp 4 (M 4), dp 2 x pp 2 (M 2) and dense dp 4,
    each held to its one-process step on card 0, run first and freed.
    12.4: bf16 Llama-3-8B at all 32 layers, 8192 tokens a step (B 4, T
    2048), 10 steps on one batch: pp 4 (M 4) and dp 2 x pp 2 (M 2); the
    loss falls; step p50, tokens/s, peak memory, host time in the
    collectives, and two profiled steps on the first and the last stage.
    12.5: phase 7.3's bf16 run on card 0, then dense dp 4 at 7.3's
    configuration a rank (2 layers, B 4 a rank, T 2048).  12.9: the dense
    family over tp 4, sp 4, tp 2 x sp 2 and dp 2 x tp 2 at 12.3's fp32
    configuration, held to the one-process step 12.3's dense dp 4 was (one
    oracle for the five).  12.10: bf16 Llama-3-8B at all 32 layers, 10
    steps on one batch, at tp 4 (B 4, T 2048) and tp 2 x sp 2 (B 1, T
    8192): a falling loss and 12.4's numbers, beside 12.4's legs.  13.3:
    the ring (``use_ring_attention``) at sp 4, tp 2 x sp 2 and dp 2 x sp 2
    at 12.9's configuration, held to the same oracle; 13.4: the ring at
    12.10's tp 2 x sp 2 leg (bf16 Llama-3-8B, 32 layers, B 1, T 8192)
    right after it, their numbers side by side.  The legs new in 12.9,
    12.10 and 13 run first."""
    import tempfile

    from cordum_tpu_torch.models import llama

    dense = dict(widths="8b", layers=4, dtype="float32", batch=4, seq=256, steps=1)
    ring_gates = [mesh_job("llama", 1, 1, sp=4, ring=True, **dense),
                  mesh_job("llama", 1, 1, tp=2, sp=2, ring=True, **dense),
                  mesh_job("llama", 2, 1, sp=2, ring=True, **dense)]
    gates = [mesh_job("llama", 1, 1, tp=4, **dense), mesh_job("llama", 1, 1, sp=4, **dense),
             mesh_job("llama", 1, 1, tp=2, sp=2, **dense), mesh_job("llama", 2, 1, tp=2, **dense),
             *ring_gates, mesh_job("llama", 4, 1, **dense),
             mesh_job("pipeline", 1, 4, m=4, widths="8b", layers=4, dtype="float32", batch=4,
                      seq=256, steps=1),
             mesh_job("pipeline", 2, 2, m=2, widths="8b", layers=4, dtype="float32", batch=4,
                      seq=256, steps=1)]
    with tempfile.TemporaryDirectory(prefix="cordum-mesh-oracle-") as workdir:
        oracle = mesh_oracle(torch, dev, card, mesh_job("llama", 1, 1, **dense), workdir)
        for job in gates:
            mine = oracle if job["family"] == "llama" else True
            mesh_leg(torch, dev, card, job, oracle=mine, collective="nccl", tag="mesh-cards")
    numbers, sp_legs = {}, {}
    big = [("llama", dict(tp=4, batch=4, seq=2048)), ("llama", dict(tp=2, sp=2, batch=1, seq=8192)),
           ("llama", dict(tp=2, sp=2, batch=1, seq=8192, ring=True)),
           ("pipeline", dict(pp=4, m=4, batch=4, seq=2048)),
           ("pipeline", dict(dp=2, pp=2, m=2, batch=4, seq=2048))]
    for family, kw in big:
        dp, pp = kw.pop("dp", 1), kw.pop("pp", 1)
        job = mesh_job(family, dp, pp, widths="8b", layers=32, dtype="bfloat16", steps=10,
                       profile=family == "pipeline", **kw)
        docs, _ = mesh_leg(torch, dev, card, job, oracle=False, collective="nccl", falling=True,
                           tag="mesh-8b")
        numbers[mesh_label(job)] = mesh_numbers(card, job, docs, tag="mesh-8b")
        if job["sp"] > 1:
            sp_legs["ring" if job["ring"] else "gather"] = (job, docs)
    ring_versus_gather(card, sp_legs["gather"], sp_legs["ring"], "mesh-8b")
    log("[mesh-8b] bf16 Llama-3-8B, 32 layers, four cards, in this call: " + "; ".join(
        f"{label}: step p50 {n['p50_ms']:.2f} ms, {n['tokens_s']:.1f} tokens/s, "
        f"{n['tokens_s'] / 4:.1f} a card" for label, n in numbers.items()) + f"  [{card}]")
    _, one = phase_train_bf16(torch, dev, card,
                              dataclasses.replace(llama.LlamaConfig.llama3_8b(), n_layers=2))
    gc.collect()
    torch.cuda.empty_cache()
    job = mesh_job("llama", 4, 1, widths="8b", layers=2, dtype="bfloat16", batch=16, seq=2048,
                   steps=10, profile=True)
    docs, _ = mesh_leg(torch, dev, card, job, oracle=False, collective="nccl", falling=True,
                       tag="mesh-dp")
    dp4 = mesh_numbers(card, job, docs, tag="mesh-dp")
    log(f"[mesh-dp] dense dp 4 against phase 7.3's one card in this call: step p50 "
        f"{dp4['p50_ms']:.2f} against {one['p50_ms']:.2f} ms, {dp4['tokens_s']:.1f} against "
        f"{one['tokens_s']:.1f} tokens/s: {dp4['tokens_s'] / one['tokens_s']:.3f}x one card's "
        f"tokens/s on 4 cards  [{card}]")


class GangDispatcher:
    """Plays the gang scheduler for phase 10.4: publishes each member's
    ``JobRequest`` with the gang labels on its worker's subject and watches
    the gang subject for the members' ``ready``, ``done`` and ``abort``."""

    def __init__(self, bus, store, workers):
        self.bus, self.store, self.workers = bus, store, workers
        self.msgs: list = []
        self.stream_senders: set = set()
        #: worker id -> (arrival time, active jobs) of its latest heartbeat
        self.active: dict = {}

    async def start(self):
        from cordum_tpu_torch.protocol import subjects as subj
        from cordum_tpu_torch.protocol.types import STATUS_HINT_STREAM

        async def on_gang(subject, pkt):
            if pkt.gang_msg is not None:
                self.msgs.append(pkt.gang_msg)

        async def on_progress(subject, pkt):
            pr = pkt.job_progress
            if pr is not None and pr.status_hint == STATUS_HINT_STREAM:
                self.stream_senders.add(pr.worker_id)

        async def on_hb(subject, pkt):
            if pkt.heartbeat is not None:
                self.active[pkt.heartbeat.worker_id] = (time.monotonic(),
                                                        pkt.heartbeat.active_jobs)

        await self.bus.subscribe(subj.GANG_WILDCARD, on_gang)
        await self.bus.subscribe(subj.PROGRESS, on_progress)
        await self.bus.subscribe(subj.HEARTBEAT, on_hb)

    async def run(self, job_id, payload, *, kind="", want="done", timeout_s=180.0):
        """Dispatch one gang job; wait until every rank reported ``want``
        (``done`` or ``abort``); returns each rank's message."""
        from cordum_tpu_torch.protocol import subjects as subj
        from cordum_tpu_torch.protocol.types import (
            LABEL_GANG_ID, LABEL_GANG_KIND, LABEL_GANG_MEMBERS, LABEL_GANG_RANK,
            LABEL_GANG_SIZE, BusPacket, JobRequest,
        )

        gang_id = f"gang-{job_id}"
        ptr = await self.store.put_context(job_id, payload)
        for rank, wid in enumerate(self.workers):
            labels = {LABEL_GANG_ID: gang_id, LABEL_GANG_RANK: str(rank),
                      LABEL_GANG_SIZE: str(len(self.workers)),
                      LABEL_GANG_MEMBERS: ",".join(self.workers)}
            if kind:
                labels[LABEL_GANG_KIND] = kind
            await self.bus.publish(subj.direct_subject(wid), BusPacket.wrap(JobRequest(
                job_id=job_id, topic="job.gang", context_ptr=ptr, labels=labels)))
        deadline = time.monotonic() + timeout_s
        while True:
            mine = [m for m in self.msgs if m.gang_id == gang_id]
            got = {m.rank: m for m in mine if m.kind == want}
            if len(got) == len(self.workers):
                return [got[r] for r in range(len(self.workers))], mine
            if want == "done" and any(m.kind == "abort" for m in mine):
                raise AssertionError(f"gang {job_id} aborted: "
                                     f"{[m.reason for m in mine if m.kind == 'abort']}")
            if time.monotonic() > deadline:
                raise AssertionError(f"gang {job_id}: {len(got)} of {len(self.workers)} ranks "
                                     f"reported {want}: {[(m.kind, m.rank) for m in mine]}")
            await asyncio.sleep(0.05)


@contextlib.asynccontextmanager
async def gang_worker_stack(dev, workdir, workers, extra_env=None):
    """A statebus process and one port worker process with
    ``WORKER_GANG=1`` for each of ``workers`` (``extra_env`` on top of the
    gang settings); yields ``(sched, procs, logs)``: this script's
    :class:`GangDispatcher` over TCP, once every worker has beaten, the
    processes (the statebus first) and the workers' log paths.  Every
    process is stopped on the way out."""
    from cordum_tpu_torch.infra import statebus
    from cordum_tpu_torch.infra.memstore import MemoryStore

    port = free_port()
    url = f"statebus://127.0.0.1:{port}"
    base = {**os.environ, "STATEBUS_PORT": str(port), "CORDUM_STATEBUS_URL": url,
            "WORKER_GANG": "1", "WORKER_POOL": "gangpool", "WORKER_TOPICS": "job.gang",
            "WORKER_GANG_RENDEZVOUS_TIMEOUT": "60", "WORKER_GANG_PEER_TIMEOUT": "60",
            "WORKER_HEARTBEAT_INTERVAL": "0.5", "WORKER_SERVING": "0", "WORKER_BATCHING": "0",
            "CORDUM_LOG_FORMAT": "json", "PYTHONDONTWRITEBYTECODE": "1", **(extra_env or {})}
    base.pop("CORDUM_FORCE_CPU", None)
    if dev.type == "cpu":
        base["CORDUM_FORCE_CPU"] = "1"
    logs = [os.path.join(workdir, f"{w}.log") for w in workers]
    server = start_process(["cordum_tpu_torch.cmd.statebus"], base,
                           os.path.join(workdir, "statebus.log"))
    procs = [server]
    conn = None
    try:
        kv, bus, conn = await connect_when_up(statebus, url, server)
        sched = GangDispatcher(bus, MemoryStore(kv), workers)
        await sched.start()
        for wid, path in zip(workers, logs):
            procs.append(start_process(["cordum_tpu_torch.cmd.worker"],
                                       {**base, "WORKER_ID": wid}, path))
        t0 = time.monotonic()
        while not all(w in sched.active for w in workers):
            if any(p.poll() is not None for p in procs[1:]) or time.monotonic() - t0 > 300:
                raise AssertionError(f"gang workers never beat; see {logs}")
            await asyncio.sleep(0.1)
        yield sched, procs, logs
    finally:
        if conn is not None:
            await conn.close()
        for proc in procs:
            stop_process(proc)


async def serving_gang_job(torch, dev, sched, job_id, *, n_new):
    """A serving gang job (tiny config, fp32, a seed) on ``sched``'s two
    workers: both ranks ``ready`` then ``done``, rank 0's tokens equal a
    dense greedy run on the weights the seed draws (near-tie rule),
    ``steps_replayed == steps``, only rank 0 streams.  Returns rank 0's
    and rank 1's stats, the near ties, the seconds and the config."""
    from cordum_tpu_torch.models import llama

    rng = np.random.default_rng(SEED + 20)
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(), dtype=torch.float32)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (9, 40)]
    payload = {"op": "llm.generate", "gang": {"kind": "serving", "workers": 2},
               "prompts": prompts, "max_new_tokens": n_new, "dtype": "float32",
               "seed": GANG_JOB_SEED, "page_size": 16, "cache_pages": 64}
    sched.stream_senders.clear()
    t0 = time.monotonic()
    (lead, follow), msgs = await sched.run(job_id, payload, kind="serving")
    serve_s = time.monotonic() - t0
    if {m.rank for m in msgs if m.kind == "ready"} != {0, 1}:
        raise AssertionError("a rank never beaconed ready")
    ls, fs = lead.stats, follow.stats
    if fs["steps_replayed"] != ls["steps"] or ls["steps"] < 1:
        raise AssertionError(f"rank 1 replayed {fs['steps_replayed']} of {ls['steps']} steps")
    if sched.stream_senders != {sched.workers[0]}:
        raise AssertionError(f"streamed by {sched.stream_senders}, not rank 0 alone")
    params = llama.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(
        GANG_JOB_SEED), device=dev)
    ties_n = 0
    for p, res in zip(prompts, ls["results"]):
        want, ties = dense_greedy(torch, llama, params, cfg, p, n_new, dev)
        ties_n += len(ties)
        compare_near_tie(res["tokens"], want, ties, "gang job")
    return ls, fs, ties_n, serve_s, cfg, msgs


async def drive_gang_workers(torch, dev, card, workdir, *, n_new=12):
    """10.4: a statebus process and two port worker processes with
    ``WORKER_GANG=1``; this script plays the gang scheduler over TCP.  A
    serving gang job (:func:`serving_gang_job`).  Then a ``gang_test``
    failing rank 1: both members end (an abort, no member left active), and
    both finish a ``gang_echo``.  SIGTERM drains both to exit 0.  Returns
    the workers' B1 launches."""
    workers = ["gang-w0", "gang-w1"]
    async with gang_worker_stack(dev, workdir, workers) as (sched, procs, logs):
        ls, fs, ties_n, serve_s, cfg, _ = await serving_gang_job(
            torch, dev, sched, "gang-serve", n_new=n_new)
        # a member failure: rank 1 fails at once, rank 0 must leave its spin
        fail_msgs = await gang_abort_leg(sched, workers)
        echo, _ = await sched.run("gang-echo", {"op": "gang_echo"})
        if [m.stats.get("mode") for m in echo] != ["barrier", "barrier"]:
            raise AssertionError(f"gang_echo after the abort: {[m.stats for m in echo]}")
        rcs = [stop_process(p) for p in procs[1:]]
    exits = [worker_exit_line(path) for path in logs]
    if any(rcs) or any(e.get("cancelled_sessions") for e in exits):
        raise AssertionError(f"SIGTERM: the gang workers exited {rcs}, {exits}")
    launches = [e["kernel_launches"]["paged_attention"] for e in exits]
    if launches != [cfg.n_layers * ls["steps"]] * 2:
        raise AssertionError(f"gang workers' B1 launches {launches} != {cfg.n_layers} layers x "
                             f"{ls['steps']} steps each")
    log(f"[gang-job] serving gang over two worker processes (WORKER_GANG=1, TCP statebus): "
        f"ready then done from both ranks in {serve_s:.2f} s; collective {ls['collective']}; "
        f"{len(ls['results'])} prompts token-identical to the dense oracle on the seed's weights "
        f"({ties_n} near ties); steps {ls['steps']}, replayed {fs['steps_replayed']}; only rank 0 "
        f"streamed; B1 launches {launches}  [{card}]")
    log(f"[gang-job] gang_test failing rank 1: {fail_msgs}; then gang_echo done on both; "
        f"SIGTERM exits {rcs}  [{card}]")
    return sum(launches)


async def gang_abort_leg(sched, workers, *, spin_s=600.0, timeout_s=60.0):
    """A ``gang_test`` whose rank 1 fails: rank 1's abort must reach the
    gang and rank 0 must leave its spin (its heartbeat shows no active job)
    well before ``spin_s``."""
    from cordum_tpu_torch.protocol import subjects as subj
    from cordum_tpu_torch.protocol.types import (
        LABEL_GANG_ID, LABEL_GANG_MEMBERS, LABEL_GANG_RANK, LABEL_GANG_SIZE, BusPacket,
        JobRequest,
    )

    gang_id = "gang-fail"
    ptr = await sched.store.put_context(gang_id, {"op": "gang_test", "spin_s": spin_s,
                                                  "fail_workers": [workers[1]]})
    for rank, wid in enumerate(workers):
        await sched.bus.publish(subj.direct_subject(wid), BusPacket.wrap(JobRequest(
            job_id=gang_id, topic="job.gang", context_ptr=ptr, labels={
                LABEL_GANG_ID: gang_id, LABEL_GANG_RANK: str(rank),
                LABEL_GANG_SIZE: str(len(workers)), LABEL_GANG_MEMBERS: ",".join(workers)})))
    deadline = time.monotonic() + timeout_s
    seen_abort = None
    while True:
        mine = [m for m in sched.msgs if m.gang_id == gang_id]
        aborts = [m for m in mine if m.kind == "abort"]
        if aborts and seen_abort is None:
            seen_abort = time.monotonic()
        # each worker's heartbeat sent after the abort shows it idle
        idle = seen_abort is not None and all(
            sched.active.get(w, (0.0, 1))[0] > seen_abort + 0.5
            and sched.active[w][1] == 0 for w in workers)
        if idle:
            break
        if any(m.kind == "done" for m in mine) or time.monotonic() > deadline:
            raise AssertionError(f"gang_test abort leg: {[(m.kind, m.rank, m.reason) for m in mine]}"
                                 f", active {sched.active}")
        await asyncio.sleep(0.1)
    return [(m.rank, m.reason) for m in aborts]


def phase_gang(torch, dev, card, cfg32, prompts, oracle, served32, serve4):
    """10.1-10.4.  Returns the B1-at-rank-heads row's numbers and its
    launches per dtype."""
    import tempfile

    rows = phase_gang_kernel(torch, dev, card)
    torch.cuda.empty_cache()
    fp32 = phase_gang_oracle(torch, dev, card, cfg32, prompts, oracle, served32)
    gc.collect()
    torch.cuda.empty_cache()
    bf16 = phase_gang_processes(torch, dev, card, serve4)
    with tempfile.TemporaryDirectory(prefix="cordum-gang-") as workdir:
        jobs = asyncio.run(drive_gang_workers(torch, dev, card, workdir))
    return rows, {"float32": fp32 + jobs, "bfloat16": bf16}


# ---------------------------------------------------------------------------
# phase 11: the pipeline family and MPMD gangs
# ---------------------------------------------------------------------------

PIPE_STAGES = 2
# fp32 pipeline oracle: MoE oracle's gates (phase 9.2), B9's fp32 gradient gate
PIPE_LOSS_REL = 1e-5
PIPE_GRAD_REL = 1e-4
#: 11.4's gang job; an lr of 0.5 (the payload's default is 1e-3) so that a
#: wrong cotangent or SGD scale moves rank 1's second loss past the gate
MPMD_PAYLOAD = {"op": "train", "model": "pipeline", "steps": 2, "batch": 4, "seq": 16,
                "microbatches": 2, "mesh": {"pp": 2}, "gang": {"workers": 2}, "lr": 0.5}
MPMD_LOSS_REL = 1e-5


def leaf_names(tree, prefix=""):
    """The names of a param tree's leaves in ``optim.tree_leaves`` order
    (dict keys sorted, list items by index)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [n for i, x in enumerate(tree) for n in leaf_names(x, f"{prefix}{i}/")]
    return [prefix.rstrip("/")]


def phase_pipeline_oracle(torch, dev, card, cfg, *, batch=2, seq=256):
    """11.1: the pipeline loss and every gradient on the B9 path against
    (a) the pipeline's plain-attention path and (b) ``llama.loss_fn`` on
    the same weights unstacked into ``layers`` with plain attention; one
    copy of the params, no optimizer step.  Returns the B9 launches."""
    from cordum_tpu_torch import optim
    from cordum_tpu_torch.models import llama, pipeline

    params = pipeline.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
                                  device=dev)
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    names = leaf_names(params)
    rng = np.random.default_rng(SEED + 30)
    toks = torch.from_numpy(rng.integers(0, cfg.base.vocab_size, (batch, seq))
                            .astype(np.int32)).to(dev)
    toks_mb = pipeline.microbatch(toks, cfg.n_microbatches)

    def value_and_grads(loss):
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss.item(), grads

    zero_launches()
    k_loss, k_grads = value_and_grads(pipeline.make_loss_fn(cfg)(params, toks_mb))
    launches = dense_launches(cfg.base.n_layers, cfg.n_microbatches)
    p_loss, p_grads = value_and_grads(
        pipeline.make_loss_fn(cfg, attention=plain_attention)(params, toks_mb))
    l_loss, l_grads = value_and_grads(
        llama.loss_fn(pipeline.unstacked(params), toks, cfg.base, attention=plain_attention))
    if any(read_launches()[k] != launches[k] for k in launches):
        raise AssertionError("the plain-attention paths launched the dense kernels")
    rel_a, rel_b = abs(k_loss - p_loss) / abs(p_loss), abs(k_loss - l_loss) / abs(l_loss)
    grad_a, grad_b = worst_grad(k_grads, p_grads, names), worst_grad(k_grads, l_grads, names)
    finite = all(math.isfinite(x) for x in (k_loss, p_loss, l_loss))
    if not (finite and max(rel_a, rel_b) <= PIPE_LOSS_REL
            and max(grad_a[0], grad_b[0]) <= PIPE_GRAD_REL):
        raise AssertionError(
            f"fp32 pipeline oracle: loss B9 {k_loss}, plain pipeline {p_loss} (rel {rel_a:.3e}), "
            f"llama.loss_fn {l_loss} (rel {rel_b:.3e}), tolerance {PIPE_LOSS_REL:g}; worst "
            f"gradient {grad_a} / {grad_b} (tolerance {PIPE_GRAD_REL:g} of its max)")
    log(f"[pipe-oracle] fp32 {cfg.base.n_layers}-layer Llama-3-8B widths, S {cfg.n_stages}, M "
        f"{cfg.n_microbatches}, B {batch}, T {seq}: loss B9 {k_loss:.6f}; vs the plain pipeline "
        f"{p_loss:.6f} (rel {rel_a:.3e}), worst gradient {grad_a[0]:.3e} of its max ({grad_a[1]}); "
        f"vs llama.loss_fn unstacked {l_loss:.6f} (rel {rel_b:.3e}), worst gradient "
        f"{grad_b[0]:.3e} ({grad_b[1]}); launches {launches}  [{card}]")
    del params, leaves, k_grads, p_grads, l_grads
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_pipeline_bf16(torch, dev, card, cfg, dense_step, *, batch=4, seq=2048, steps=10):
    """11.2: bf16 pipeline train steps (the pipeline's AdamW, weight decay
    1e-4) on one fixed batch: the loss must be finite and fall.  Step p50,
    tokens/s and peak memory beside phase 7.3's dense step
    (``dense_step``), then two steps under ``torch.profiler``.  Returns the
    launches."""
    from cordum_tpu_torch.models import pipeline

    init, step = pipeline.make_train_step(cfg, device=dev)
    params, state = init(SEED)
    rng = np.random.default_rng(SEED + 31)
    toks = pipeline.microbatch(torch.from_numpy(
        rng.integers(0, cfg.base.vocab_size, (batch, seq)).astype(np.int32)).to(dev),
        cfg.n_microbatches)
    torch.cuda.synchronize()
    state_gib = torch.cuda.memory_allocated(dev) / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        _, state, loss = step(params, state, toks)
        losses.append(loss.item())  # waits for the step
        secs.append(time.perf_counter() - t0)
    launches = dense_launches(cfg.base.n_layers, steps * cfg.n_microbatches)
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"bf16 pipeline run: losses {losses} (finite, falling expected)")
    p50 = statistics.median(secs[1:])
    log(f"[pipe-train] bf16 {cfg.base.n_layers}-layer Llama-3-8B widths, S {cfg.n_stages}, M "
        f"{cfg.n_microbatches}, B {batch}, T {seq}, {steps} steps on one batch: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} ({', '.join(f'{x:.4f}' for x in losses)}); step "
        f"p50 {p50 * 1e3:.2f} ms (steps 2-{steps}), first step {secs[0] * 1e3:.2f} ms, "
        f"{batch * seq / p50:.1f} tokens/s, peak memory {peak_gib:.2f} GiB ({state_gib:.2f} GiB "
        f"allocated before the first step); phase 7.3's dense step: p50 "
        f"{dense_step['p50_ms']:.2f} ms, {dense_step['tokens_s']:.1f} tokens/s, peak "
        f"{dense_step['peak_gib']:.2f} GiB; launches {launches}  [{card}]")
    profile_train(torch, card, lambda: step(params, state, toks))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    return launches


async def drive_pipeline_worker(torch, dev, card, ckpt_root, *, batch=8, seq=128):
    """11.3: a ``pipeline`` run (``LlamaConfig.tiny()``, M 2) of 6 steps
    checkpointed every 2, cancelled after step 2 and resumed; then a run at
    M 4 asking for pp 2.  Result keys as the reference's, ``mesh.pp`` 1;
    B9 launches = layers x microbatches x steps, forward and backward."""
    from cordum_tpu_torch.models import llama

    payload = {"op": "train", "model": "pipeline", "steps": 6, "batch": batch, "seq": seq,
               "checkpoint_every": 2, "run_name": "phase11", "microbatches": 2}
    other_payload = {"op": "train", "model": "pipeline", "steps": 3, "batch": batch,
                     "seq": seq, "microbatches": 4, "mesh": {"pp": 2}}
    first, second, other, n, saved = await run_train_jobs(
        torch, dev, ckpt_root, "w-pipe", payload, other_payload)
    if any(doc["mesh"]["pp"] != 1 for doc in (first, second, other)):
        raise AssertionError(f"pipeline job meshes {[d['mesh'] for d in (first, second, other)]}")
    layers = llama.LlamaConfig.tiny().n_layers
    want = layers * (2 * (first["steps_done"] + second["steps_done"] - second["resumed_from"])
                     + 4 * other["steps_done"])
    if not n["dense_attention_fwd"] == n["dense_attention_bwd"] == want:
        raise AssertionError(f"dense_attention launches {n}; {want} each expected")
    log(f"[pipe-worker] pipeline (LlamaConfig.tiny(): {layers} layers, d 64, bf16), B {batch}, "
        f"T {seq}, M 2: cancelled after {first['steps_done']} steps (loss "
        f"{first['loss_first']:.4f} -> {first['final_loss']:.4f}); re-dispatched: resumed from "
        f"{second['resumed_from']}, {second['steps_done']} steps done, loss "
        f"{second['final_loss']:.4f}; checkpoints {saved}; M 4 (pp 2 asked): "
        f"{other['steps_done']} steps, loss {other['loss_first']:.4f} -> "
        f"{other['final_loss']:.4f}; mesh {first['mesh']}; launches forward "
        f"{n['dense_attention_fwd']}, backward {n['dense_attention_bwd']}  [{card}]")
    return {k: n[k] for k in ("dense_attention_fwd", "dense_attention_bwd")}


def routable_address():
    """A non-loopback IPv4 address of one of this host's interfaces, read
    with ``SIOCGIFADDR`` (nothing is sent), as ``(interface, address)``; or
    None."""
    import fcntl
    import socket
    import struct

    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
        for _, name in socket.if_nameindex():
            try:
                packed = fcntl.ioctl(sock.fileno(), 0x8915,  # SIOCGIFADDR
                                     struct.pack("256s", name[:15].encode()))
            except OSError:
                continue  # no IPv4 address on this interface
            addr = socket.inet_ntoa(packed[20:24])
            if not addr.startswith("127."):
                return name, addr
    return None


def mpmd_one_process_losses(torch, dev, payload):
    """Rank 1's two losses computed in this process: the pipeline's
    ``make_loss_fn`` with plain attention on the weights and the step-0
    tokens the seed draws (the gang's CPU generators), then one SGD step of
    the payload's ``lr`` on its gradient (the gang's sum over microbatches
    at ``lr / M``) and the loss on step 1's tokens."""
    from cordum_tpu_torch import optim
    from cordum_tpu_torch.models import pipeline
    from cordum_tpu_torch.worker import gang

    base = gang.mpmd_base()
    cfg = pipeline.PipelineConfig(base=base, n_stages=2, n_microbatches=payload["microbatches"])
    params = optim.tree_map(lambda t: t.to(dev), gang.mpmd_draw(payload, 2))
    leaves = optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss_fn = pipeline.make_loss_fn(cfg, attention=plain_attention)
    losses = []
    for step in range(2):
        toks = gang.mpmd_tokens(step, payload["batch"], payload["seq"], base.vocab_size).to(dev)
        loss = loss_fn(params, pipeline.microbatch(toks, cfg.n_microbatches))
        losses.append(loss.item())
        with torch.no_grad():
            for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
                p.sub_(payload["lr"] * g)
    return losses


async def drive_mpmd_workers(torch, dev, card, workdir, *, n_new=12):
    """11.4: an MPMD pipeline gang job (pp 2) through two port worker
    processes over the TCP statebus, this script playing the gang
    scheduler: both ranks ``done`` with ``mode: "mpmd"``, rank 0's loss
    None, rank 1's first and second losses (lr 0.5) equal to
    :func:`mpmd_one_process_losses`, each
    process's B9 launches = its stage's layers x microbatches x steps,
    forward and backward.  The workers run with ``WORKER_GANG_ADDR`` set to
    a non-loopback address of the host where it has one, and then serve a
    gang job (:func:`serving_gang_job`) whose store rank 0 advertises
    there.  SIGTERM drains both to exit 0.  Returns the workers' B9
    launches (fp32) and B1 launches."""
    from cordum_tpu_torch.worker import gang

    routable = routable_address()
    extra = {"WORKER_GANG_ADDR": routable[1]} if routable else {}
    workers = ["mpmd-w0", "mpmd-w1"]
    payload = dict(MPMD_PAYLOAD)
    async with gang_worker_stack(dev, workdir, workers, extra) as (sched, procs, logs):
        t0 = time.monotonic()
        (r0, r1), _ = await sched.run("mpmd-train", payload)
        train_s = time.monotonic() - t0
        serving = None
        if routable:
            serving = await serving_gang_job(torch, dev, sched, "gang-addr", n_new=n_new)
        rcs = [stop_process(p) for p in procs[1:]]
    exits = [worker_exit_line(path) for path in logs]
    if any(rcs) or any(e.get("cancelled_sessions") for e in exits):
        raise AssertionError(f"SIGTERM: the MPMD workers exited {rcs}, {exits}")
    s0, s1 = r0.stats, r1.stats
    if s0.get("mode") != "mpmd" or s1.get("mode") != "mpmd" or s0.get("loss") is not None \
            or s1.get("loss") is None or s1["steps_done"] != payload["steps"]:
        raise AssertionError(f"MPMD gang results: {s0}, {s1}")
    want = mpmd_one_process_losses(torch, dev, payload)
    got = [s1["loss_first"], s1["loss"]]
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    if not rel <= MPMD_LOSS_REL:
        raise AssertionError(f"MPMD rank 1's losses {got} vs one process {want} "
                             f"(rel {rel:.3e}, tolerance {MPMD_LOSS_REL:g})")
    per_stage = gang.mpmd_base().n_layers // 2 * payload["microbatches"] * payload["steps"]
    b9 = [(e["kernel_launches"]["dense_attention_fwd"], e["kernel_launches"]["dense_attention_bwd"])
          for e in exits]
    if b9 != [(per_stage, per_stage)] * 2:
        raise AssertionError(f"MPMD workers' B9 launches {b9}; {per_stage} each expected")
    b1 = [e["kernel_launches"]["paged_attention"] for e in exits]
    log(f"[mpmd-job] MPMD pipeline gang over two worker processes (pp 2, WORKER_GANG=1, TCP "
        f"statebus): done from both ranks in {train_s:.2f} s, mode mpmd; rank 1 loss "
        f"{s1['loss_first']:.6f} -> {s1['loss']:.6f} (lr {payload['lr']}), one process "
        f"{want[0]:.6f} -> {want[1]:.6f} (max rel {rel:.3e}); "
        f"rank 0 loss None; B9 launches (forward, backward) {b9}  [{card}]")
    if serving is None:
        log(f"[mpmd-job] WORKER_GANG_ADDR leg skipped: this host has no non-loopback IPv4 "
            f"address  [{card}]")
        b1_launches = 0
    else:
        ls, fs, ties_n, serve_s, cfg, msgs = serving
        stores = {(m.stats or {}).get("store", "") for m in msgs if m.kind == "ready" and m.rank == 0}
        if not stores or not all(a.startswith(f"{routable[1]}:") for a in stores):
            raise AssertionError(f"rank 0 advertised {stores}, not {routable[1]}")
        if b1 != [cfg.n_layers * ls["steps"]] * 2:
            raise AssertionError(f"B1 launches {b1} != {cfg.n_layers} x {ls['steps']} each")
        b1_launches = sum(b1)
        log(f"[mpmd-job] WORKER_GANG_ADDR={routable[1]} ({routable[0]}): rank 0 advertised "
            f"{sorted(stores)}; serving gang done in {serve_s:.2f} s, collective "
            f"{ls['collective']}, token-identical to the dense oracle ({ties_n} near ties), "
            f"steps {ls['steps']}, replayed {fs['steps_replayed']}; B1 launches {b1}  [{card}]")
    log(f"[mpmd-job] SIGTERM exits {rcs}  [{card}]")
    return sum(f for f, _ in b9), sum(b for _, b in b9), b1_launches


def phase_pipeline(torch, dev, card, cfg8b, dense_step):
    """11.1-11.4.  Returns B9's launches per dtype (forward and backward)
    and the B1 launches of 11.4's serving leg (fp32)."""
    import tempfile

    from cordum_tpu_torch.models import pipeline

    base2 = dataclasses.replace(cfg8b, n_layers=2)
    fp32 = phase_pipeline_oracle(torch, dev, card, pipeline.PipelineConfig(
        base=dataclasses.replace(base2, dtype=torch.float32), n_stages=PIPE_STAGES,
        n_microbatches=2))
    bf16 = phase_pipeline_bf16(torch, dev, card, pipeline.PipelineConfig(
        base=base2, n_stages=PIPE_STAGES, n_microbatches=4), dense_step)
    with tempfile.TemporaryDirectory(prefix="cordum-ckpt-") as ckpt_root:
        jobs = asyncio.run(drive_pipeline_worker(torch, dev, card, ckpt_root))
    with tempfile.TemporaryDirectory(prefix="cordum-mpmd-") as workdir:
        mpmd_fwd, mpmd_bwd, b1 = asyncio.run(drive_mpmd_workers(torch, dev, card, workdir))
    launches = {k: {"float32": fp32[k], "bfloat16": bf16[k] + jobs[k]} for k in fp32}
    launches["dense_attention_fwd"]["float32"] += mpmd_fwd
    launches["dense_attention_bwd"]["float32"] += mpmd_bwd
    return launches, b1


# ---------------------------------------------------------------------------
# phase 12: multi-rank training over a rank mesh
# ---------------------------------------------------------------------------

MESH_LR = 3e-4
#: 12.1-12.3: each rank against the one-process step on the same weights and
#: batch.  The loss within 1e-6 relative (the same operations; the nll sum
#: is split over ranks and summed again).  Each first-step gradient within
#: the fp32 gradient gate of 9.2 and 11.1, 1e-4 of its largest |value|:
#: where dp cuts the rows, the sums over the tokens run in another order
#: (each rank's GEMM over its rows, then the all-reduce) and every layer's
#: backward rounds at other places, as the kernel and plain paths of 11.1
#: do; a wrong dp scale or microbatch is an error of order one.  Each
#: param after the last step within 2 lr a step (:func:`mesh_param_atol`):
#: an Adam update is about lr * sign(g), so a gradient within fp32 noise
#: of zero may flip an update by 2 lr.
MESH_LOSS_REL = 1e-6
MESH_GRAD_REL = PIPE_GRAD_REL
MESH_TIMEOUT_S = 300.0
#: the batches' numpy seed
MESH_TOKEN_SEED = SEED + 40


def mesh_param_atol(steps):
    return 2 * MESH_LR * steps


def mesh_job(family, dp, pp, *, widths, layers, dtype, batch, seq, steps, m=1, device="cuda",
             profile=False, tp=1, sp=1, ring=False, ep=1, cf=None, skew=0.0,
             token_seed=MESH_TOKEN_SEED):
    """A phase-12 job: what every rank process and the one-process oracle
    of it are given (JSON).  ``widths`` ``"8b"`` (Llama-3-8B; the MoE
    family's Mixtral-8x7B widths on it, :func:`moe_config`) or ``"tiny"``
    (``LlamaConfig.tiny()``; the MoE family's ``MoEConfig.tiny()`` experts);
    ``m`` the pipeline's microbatches; ``tp`` and ``sp`` the Llama family's
    tensor- and sequence-parallel axes; ``ring`` its
    ``use_ring_attention`` (phase 13: ring attention over sp); ``ep`` the
    MoE family's expert-parallel axis, ``cf`` its capacity factor (None:
    the config's) and ``skew`` its router skew (:func:`skew_router`);
    ``token_seed`` the batch's numpy seed."""
    return {"family": family, "dp": dp, "tp": tp, "sp": sp, "ep": ep, "pp": pp,
            "widths": widths, "layers": layers, "dtype": dtype, "batch": batch, "seq": seq,
            "steps": steps, "m": m, "device": device, "profile": profile, "ring": ring,
            "cf": cf, "skew": skew, "token_seed": token_seed, "oracle": None}


def mesh_world(job):
    return job["dp"] * job["tp"] * job["sp"] * job.get("ep", 1) * job["pp"]


def mesh_label(job):
    if job["family"] == "moe":
        cut = f"{job['layers']} layers" + (", Mixtral-8x7B widths" if job["widths"] == "8b"
                                           else ", MoEConfig.tiny() widths")
    else:
        cut = f"{job['layers']} layers" + (", Llama-3-8B widths" if job["widths"] == "8b" else
                                           ", LlamaConfig.tiny() widths")
    if job["family"] == "pipeline":
        shape = f"pp {job['pp']} x dp {job['dp']}, M {job['m']}"
    elif job["family"] == "moe":
        shape = "moe " + " x ".join(f"{a} {job[a]}" for a in ("dp", "tp", "ep")
                                    if a == "dp" or job[a] > 1)
        shape += f", capacity factor {job['cf']}" if job.get("cf") else ""
        shape += f", router skew {job['skew']:g}" if job.get("skew") else ""
    else:
        shape = "dense " + " x ".join(f"{a} {job[a]}" for a in ("dp", "tp", "sp")
                                      if a == "dp" or job[a] > 1)
        shape += " (ring)" if job.get("ring") else ""
    return f"{shape}, {job['dtype']}, {cut}, B {job['batch']}, T {job['seq']}"


def mesh_config(torch, job):
    from cordum_tpu_torch.models import llama

    cfg = llama.LlamaConfig.llama3_8b() if job["widths"] == "8b" else llama.LlamaConfig.tiny()
    return dataclasses.replace(cfg, n_layers=job["layers"], dtype=getattr(torch, job["dtype"]),
                               use_ring_attention=bool(job.get("ring")))


def mesh_moe_config(torch, job):
    """A MoE job's config: :func:`moe_config` (``"8b"``) or
    ``MoEConfig.tiny()``'s experts on :func:`mesh_config`'s base, at the
    job's capacity factor."""
    from cordum_tpu_torch.models import moe

    like = moe_config() if job["widths"] == "8b" else moe.MoEConfig.tiny()
    cfg = dataclasses.replace(like, base=mesh_config(torch, job))
    return dataclasses.replace(cfg, capacity_factor=job["cf"]) if job.get("cf") else cfg


def skew_router(torch, params, skew):
    """Push most tokens to expert 0, the same way on every rank: ``embed``
    shifted by ``1 / sqrt(d)`` in every element (a direction all the
    tokens share, about ``1 / sqrt(2)`` of each element after the norm),
    and each router's column 0 by ``skew sqrt(2) / d``, so expert 0's
    logit gains about ``skew``.  Both leaves are whole on every rank."""
    with torch.no_grad():
        d = params["embed"].shape[1]
        params["embed"].add_(1.0 / math.sqrt(d))
        for layer in params["layers"]:
            layer["moe"]["router"][:, 0].add_(skew * math.sqrt(2.0) / d)


def mesh_train_step(torch, job, dev, mesh=None):
    """``(init, step, tokens, base config)`` of the job on ``dev``: the
    pipeline's, the Llama family's or the MoE family's
    ``make_train_step`` (its router skewed after the draw, as the job
    says), with ``mesh`` the rank's step; the tokens are the whole batch
    (every rank is given it), microbatched for the pipeline."""
    from cordum_tpu_torch.models import llama, moe, pipeline

    base = mesh_config(torch, job)
    rng = np.random.default_rng(job.get("token_seed", MESH_TOKEN_SEED))
    toks = torch.from_numpy(rng.integers(0, base.vocab_size, (job["batch"], job["seq"]))
                            .astype(np.int32)).to(dev)
    if job["family"] == "pipeline":
        cfg = pipeline.PipelineConfig(base=base, n_stages=job["pp"], n_microbatches=job["m"])
        init, step = pipeline.make_train_step(cfg, device=dev, mesh=mesh)
        toks = pipeline.microbatch(toks, job["m"])
    elif job["family"] == "moe":
        drawn, step = moe.make_train_step(mesh_moe_config(torch, job), device=dev, mesh=mesh)

        def init(seed):
            params, state = drawn(seed)
            if job.get("skew"):
                skew_router(torch, params, job["skew"])
            return params, state
    else:
        init, step = llama.make_train_step(base, device=dev, mesh=mesh)
    return init, step, toks, base


def mesh_oracle(torch, dev, card, job, workdir):
    """The one-process step of ``job`` on ``dev`` (the same seed, weights
    and batch as its ranks): each step's loss, then the first step's
    gradients and the params after the last step written under
    ``workdir/oracle`` one leaf a file (CPU tensors), for the ranks to
    hold theirs to; everything freed before it returns.  Returns the
    directory."""
    from cordum_tpu_torch import optim

    out = os.path.join(workdir, "oracle")
    os.makedirs(out, exist_ok=True)
    init, step, toks, _ = mesh_train_step(torch, job, dev)
    params, state = init(SEED)
    names = leaf_names(params)
    drops = ""
    if job["family"] == "moe" and job.get("cf"):
        kept, slots = layer0_kept(torch, params, toks, mesh_moe_config(torch, job))
        if kept == slots:
            raise AssertionError(f"{mesh_label(job)}: layer 0 dropped no slot")
        drops = f"; layer 0 kept {kept} of {slots} slots"
    grads, losses = [], []
    t0 = time.monotonic()
    for i in range(job["steps"]):
        _, state, loss = step(params, state, toks, grads_out=grads if i == 0 else None)
        losses.append(loss.item())
    step_s = time.monotonic() - t0
    for name, g, p in zip(names, grads, optim.tree_leaves(params)):
        torch.save(g.detach().cpu(), os.path.join(out, f"grad.{name.replace('/', '.')}.pt"))
        torch.save(p.detach().cpu(), os.path.join(out, f"param.{name.replace('/', '.')}.pt"))
    with open(os.path.join(out, "oracle.json"), "w") as f:
        json.dump({"losses": losses, "names": names}, f)
    log(f"[mesh-oracle] {mesh_label(job)}: one process, {job['steps']} steps in {step_s:.2f} s, "
        f"losses {losses}; {len(names)} leaves written{drops}  [{card}]")
    del params, state, grads, toks
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    job["oracle"] = out
    return out


def mesh_gate(torch, job, mesh, params, grads, losses):
    """This rank against the oracle's files: the worst relative loss over
    the steps, the worst first-step gradient (max abs error over the
    oracle leaf's largest |value|) and the worst param after the last step
    (max abs error), each with its leaf; a NaN or inf anywhere is inf.
    The oracle's pipeline stage leaves are sliced to the rank's stage, its
    layer weights to the rank's tensor-parallel slice (``param_specs``),
    slice against slice."""
    from cordum_tpu_torch import optim
    from cordum_tpu_torch.models import llama, moe

    split = llama.param_specs(mesh_config(torch, job))["layers"][0]
    experts = moe.moe_layer_specs()

    with open(os.path.join(job["oracle"], "oracle.json")) as f:
        want = json.load(f)
    loss_rel = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                   for a, b in zip(losses, want["losses"]))
    grad_worst, param_worst = (0.0, ""), (0.0, "")
    names = leaf_names(params)
    for name, g, p in zip(names, grads, optim.tree_leaves(params)):
        got = {}
        for kind in ("grad", "param"):
            # mapped, not read: a rank copies its slice alone
            o = torch.load(os.path.join(job["oracle"], f"{kind}.{name.replace('/', '.')}.pt"),
                           weights_only=True, mmap=True)
            if name.startswith("stages/"):
                o = o[mesh.pp_rank:mesh.pp_rank + 1]
            axis = split.get(name.split("/")[-1]) if name.startswith("layers/") else None
            if "/moe/" in name:
                o = moe.shard_leaf(o, experts[name.split("/")[-1]], (mesh.coords, mesh.sizes))
            elif mesh.tp > 1 and axis is not None:
                o = llama._slice(o, axis, mesh.tp_rank, mesh.tp)
            got[kind] = o.to(p.device).float()
        if tuple(got["param"].shape) != tuple(p.shape):
            raise AssertionError(f"rank {mesh.rank}: leaf {name} {tuple(p.shape)} against the "
                                 f"oracle's {tuple(got['param'].shape)}")
        g_err = ((g.float() - got["grad"]).abs().max() / got["grad"].abs().max()
                 .clamp_min(1e-30)).item()
        p_err = (p.detach().float() - got["param"]).abs().max().item()
        g_err = g_err if math.isfinite(g_err) else math.inf
        p_err = p_err if math.isfinite(p_err) else math.inf
        grad_worst = max(grad_worst, (g_err, name))
        param_worst = max(param_worst, (p_err, name))
    return {"loss_rel": loss_rel, "grad": list(grad_worst), "param": list(param_worst),
            "oracle_losses": want["losses"], "names": names}


def train_rank(job, rank, mesh):
    """One rank of a phase-12 job on its ``mesh`` (a rank process's, or
    the CPU tests' in-process meshes): draw the rank's params from the
    seed, take ``steps`` steps on the one batch; with an oracle, hold the
    rank to it (:func:`mesh_gate`); with ``profile``, two more steps, under
    ``torch.profiler`` on the first and the last stage.  Returns the rank's
    numbers."""
    import torch

    from cordum_tpu_torch import optim

    dev = mesh.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    init, step, toks, base = mesh_train_step(torch, job, dev, mesh)
    t0 = time.monotonic()
    params, state = init(SEED)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    init_s = time.monotonic() - t0
    param_bytes = sum(p.numel() * p.element_size() for p in optim.tree_leaves(params))
    grads, losses, secs = [], [], []
    # the collectives' host time and calls of steps 2 on (a one-step run's
    # all): the first step's calls also set the communicators up
    first = {"host_s": dict.fromkeys(mesh.host_s, 0.0), "calls": dict.fromkeys(mesh.calls, 0)}
    for i in range(job["steps"]):
        if i == 1:
            first = {k: dict(getattr(mesh, k)) for k in ("host_s", "calls")}
        t0 = time.perf_counter()
        _, state, loss = step(params, state, toks,
                              grads_out=grads if i == 0 and job["oracle"] else None)
        losses.append(loss.item())  # waits for the step
        secs.append(time.perf_counter() - t0)
    n = read_launches()
    doc = {"rank": rank, "coords": mesh.coords, "collective": mesh.backend,
           "device": str(dev), "losses": losses, "step_s": secs, "init_s": init_s,
           "param_bytes": param_bytes, "leaves": leaf_names(params),
           **{k: {c: v - first[k][c] for c, v in getattr(mesh, k).items()}
              for k in ("host_s", "calls")},
           "launches": [n["dense_attention_fwd"], n["dense_attention_bwd"]],
           "chunk_launches": [n["dense_attention_fwd_sp"], n["dense_attention_bwd_sp"]],
           "ring_launches": [n[row] for row in RING_ROWS],
           "moe_launches": {row: n[row] for row in (*MOE_KERNELS, ROOM_ROW)},
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else 0.0,
           "n_layers": base.n_layers}
    if job["oracle"]:
        doc["gate"] = mesh_gate(torch, job, mesh, params, grads, losses)
    del grads
    if job["profile"]:
        stage = mesh.coords["pp"]
        ctx = None
        if stage in (0, mesh.sizes["pp"] - 1) and mesh.coords["dp"] == 0:
            ctx = gang_profile_start(torch, on_card)
        for _ in range(2):
            step(params, state, toks)
        if ctx is not None:
            doc["profile"] = gang_profile_stop(torch, on_card, ctx)
    return doc


def mesh_rank(job, mesh):
    """A phase-12 rank process's body (the package launcher's target,
    ``chip_smoke:mesh_rank``): :func:`train_rank` on the rank's mesh, its
    kernel launches counted from 0."""
    zero_launches()
    return train_rank(job, mesh.rank, mesh)


def run_train_ranks(job, workdir):
    """The job's rank processes, one a mesh rank, through the package's
    launcher (``cordum_tpu_torch.parallel.launch.run_ranks``; their logs
    and results in ``workdir``): rank r on card r where the host has a card
    a rank, else every rank on card 0 (named: the ranks share it over
    gloo), CPU ranks for a CPU job.  Returns each rank's numbers.  A rank
    that fails or outlives the deadline fails the run (the others are
    stopped at once), with every rank's log tail printed."""
    import torch

    from cordum_tpu_torch.parallel.launch import RankError, run_ranks
    from cordum_tpu_torch.parallel.mesh import MeshSpec

    world = mesh_world(job)
    if job["device"] == "cpu":
        device = "cpu"
    else:
        device = None if torch.cuda.device_count() >= world else "cuda:0"
    spec = MeshSpec(dp=job["dp"], tp=job["tp"], sp=job["sp"], ep=job.get("ep", 1), pp=job["pp"])
    try:
        return run_ranks("chip_smoke:mesh_rank", job, world=world, spec=spec, device=device,
                         timeout_s=2 * MESH_TIMEOUT_S, peer_timeout_s=MESH_TIMEOUT_S,
                         workdir=workdir)
    except RankError as e:
        log(f"[mesh] {e}")
        raise AssertionError(f"{mesh_label(job)}: rank processes exited {e.codes}") from None


def mesh_launches(job, docs):
    """Each rank's B9 launches must be its layers x microbatches x steps
    (the pipeline: ``L/S`` layers a stage, M microbatches; the dense
    family: every layer once a step), forward and backward; with sp above
    1 every one of them a chunk's (queries and keys of other lengths), else
    none (so a chunk's launches sum to the returned sums where sp is
    above 1).  A ring job's are :func:`ring_launches`'.  Returns their
    sums."""
    if job.get("ring") and job["sp"] > 1:
        return ring_launches(job, docs)[:2]
    steps = job["steps"]
    layers = docs[0]["n_layers"]
    want = (layers // job["pp"] * job["m"] if job["family"] == "pipeline" else layers) * steps
    chunk = want if job["sp"] > 1 else 0
    for d in docs:
        if d["launches"] != [want, want] or d["chunk_launches"] != [chunk, chunk]:
            raise AssertionError(f"{mesh_label(job)}: rank {d['rank']}'s B9 launches "
                                 f"{d['launches']}, of them a chunk's {d['chunk_launches']}; "
                                 f"{want} each expected, {chunk} a chunk's")
        if job["family"] == "moe":
            expect = {**dict.fromkeys(MOE_KERNELS, want), ROOM_ROW: want if job["dp"] > 1 else 0}
            if d["moe_launches"] != expect:
                raise AssertionError(f"{mesh_label(job)}: rank {d['rank']}'s B7 launches "
                                     f"{d['moe_launches']}; {expect} expected (layers x steps, "
                                     "the route with a room where dp is above 1)")
    return [sum(d["launches"][0] for d in docs), sum(d["launches"][1] for d in docs)]


def check_mesh_ranks(card, job, docs, *, collective=None, falling=False, tag="mesh"):
    """Phase 12's gates on a job's ranks: every rank returns the same
    losses, finite (and falling from the first step to the last with
    ``falling``); with an oracle, each rank's loss, gradients and params
    within ``MESH_*`` of it and every leaf of the oracle's tree held by a
    rank of each dp index; the backend ``collective`` when given.  Then
    the launches (:func:`mesh_launches`); returns them."""
    label = mesh_label(job)
    losses = docs[0]["losses"]
    if any(d["losses"] != losses for d in docs) or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: the ranks' losses {[d['losses'] for d in docs]} "
                             f"(equal and finite expected)")
    if falling and not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses} (falling expected)")
    if collective and any(d["collective"] != collective for d in docs):
        raise AssertionError(f"{label}: collectives {[d['collective'] for d in docs]}, "
                             f"{collective} expected")
    atol = mesh_param_atol(job["steps"])
    if job["oracle"]:
        for d in docs:
            g = d["gate"]
            if not (g["loss_rel"] <= MESH_LOSS_REL and g["grad"][0] <= MESH_GRAD_REL
                    and g["param"][0] <= atol):
                raise AssertionError(
                    f"{label}: rank {d['rank']} {d['coords']} against the one-process step: "
                    f"losses {d['losses']} vs {g['oracle_losses']} (rel {g['loss_rel']:.3e}, "
                    f"tolerance {MESH_LOSS_REL:g}); worst gradient {g['grad']} (tolerance "
                    f"{MESH_GRAD_REL:g} of its max); worst param {g['param']} (tolerance "
                    f"{atol:g})")
        with open(os.path.join(job["oracle"], "oracle.json")) as f:
            names = json.load(f)["names"]
        for dp in range(job["dp"]):
            held = {n for d in docs if d["coords"]["dp"] == dp for n in d["gate"]["names"]}
            if held != set(names):
                raise AssertionError(f"{label}: the ranks of dp {dp} hold {sorted(held)}, the "
                                     f"one-process tree {sorted(names)}")
        log(f"[{tag}] {label}: {len(docs)} rank processes, collective {docs[0]['collective']}; "
            f"losses {losses} against one process {docs[0]['gate']['oracle_losses']}: max rel "
            f"{max(d['gate']['loss_rel'] for d in docs):.3e}; worst first-step gradient "
            f"{max(tuple(d['gate']['grad']) for d in docs)} of its max, worst param after step "
            f"{job['steps']} {max(tuple(d['gate']['param']) for d in docs)} (tolerances "
            f"{MESH_LOSS_REL:g}, {MESH_GRAD_REL:g}, {atol:g}); every leaf held by a rank of each "
            f"dp index  [{card}]")
    return mesh_launches(job, docs)


def mesh_numbers(card, job, docs, tag="mesh-train"):
    """12.4, 12.5 and 12.9's numbers: the loss, step p50 (steps 2 on; the
    ranks step together, so the slowest rank's), tokens/s and tokens/s a
    card, each rank's peak memory, parameter bytes and host ms inside each
    kind of collective a step, and the profiled stages' device busy share
    beside the bubble model (a stage computes at most M / (M + S - 1) of
    the time).  Returns step p50 ms and tokens/s."""
    world, steps = len(docs), job["steps"]
    p50 = max(statistics.median(d["step_s"][1:]) for d in docs)
    tokens = job["batch"] * job["seq"]
    losses = docs[0]["losses"]
    log(f"[{tag}] {mesh_label(job)}, {steps} steps on one batch over {world} rank processes "
        f"({docs[0]['collective']}): loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"({', '.join(f'{x:.4f}' for x in losses)}); step p50 {p50 * 1e3:.2f} ms (steps "
        f"2-{steps}, the slowest rank), first step {max(d['step_s'][0] for d in docs) * 1e3:.2f} "
        f"ms; {tokens / p50:.1f} tokens/s, {tokens / p50 / world:.1f} tokens/s a card  [{card}]")
    for d in docs:
        where = ",".join(str(d["coords"][a]) for a in ("dp", "tp", "sp", "ep", "pp"))
        inside = ", ".join(
            f"{kind} {d['host_s'][kind] / (steps - 1) * 1e3:.2f} "
            f"({d['calls'][kind] // (steps - 1)} calls)" for kind in d["host_s"])
        log(f"[{tag}] rank {d['rank']} {where} (dp,tp,sp,ep,pp): peak "
            f"{d['peak_gib']:.2f} GiB, parameters {d['param_bytes'] / 2**30:.2f} GiB, drawn in "
            f"{d['init_s']:.1f} s; host ms a step (steps 2-{steps}) inside {inside}  [{card}]")
        prof = d.get("profile")
        if prof:
            s, m = job["pp"], job["m"] if job["family"] == "pipeline" else 1
            busy = prof["device_ms"] / prof["wall_ms"]
            compute = (prof["device_ms"] - prof["collective_ms"]) / prof["wall_ms"]
            log(f"[{tag}] rank {d['rank']} (stage {d['coords']['pp']}) profiled 2 steps: wall "
                f"{prof['wall_ms']:.1f} ms, device busy {100 * busy:.1f}%, of it NCCL kernels "
                f"(which also wait for their peers) {prof['collective_ms']:.1f} ms; compute "
                f"{100 * compute:.1f}% of wall against the bubble model's bound M / (M + S - 1) "
                f"= {m}/{m + s - 1} = {100 * m / (m + s - 1):.1f}%  [{card}]")
    return {"p50_ms": p50 * 1e3, "tokens_s": tokens / p50}


def mesh_leg(torch, dev, card, job, *, oracle, collective=None, falling=False, tag="mesh"):
    """One job: its one-process oracle on ``dev`` first (freed before the
    ranks start) when ``oracle`` is True, the oracle directory of an
    earlier job of the same model, batch and steps when it is a path; then
    its rank processes, gated.  Returns the ranks' numbers and their B9
    launches."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="cordum-mesh-") as workdir:
        if oracle is True:
            mesh_oracle(torch, dev, card, job, workdir)
        elif oracle:
            job["oracle"] = oracle
        docs = run_train_ranks(job, workdir)
        launches = check_mesh_ranks(card, job, docs, collective=collective, falling=falling,
                                    tag=tag)
    return docs, launches


def phase_mesh(torch, dev, card):
    """12.1, 12.2, 12.7 and 12.8 on the one card (gloo rank processes
    sharing it).  Returns B9's launches by kernel row and dtype (the sp
    rows: the chunks' launches, 12.7's and 12.8's), and 12.8's ``(job,
    docs)``, which 13.2's ring leg is held to."""
    jobs = [
        # 12.1: 11.1's configuration over two ranks, one AdamW step
        (mesh_job("pipeline", 1, 2, widths="8b", layers=2, dtype="float32", batch=2, seq=256,
                  steps=1, m=2), True, False),
        # 12.2: dp 2 x pp 2, four processes, a falling loss over 3 steps
        (mesh_job("pipeline", 2, 2, widths="tiny", layers=4, dtype="float32", batch=4, seq=64,
                  steps=3, m=2), True, True),
        # 12.7: dense tp 2 x sp 2, four processes, held to the one-process step
        (mesh_job("llama", 1, 1, tp=2, sp=2, widths="tiny", layers=4, dtype="float32",
                  batch=4, seq=64, steps=3), True, True),
        # 12.8: the same mesh in bf16 at Llama-3-8B widths, 2 layers, T 4096
        # (half the --cards leg's sequence: four ranks share the card): a
        # falling loss
        (mesh_job("llama", 1, 1, tp=2, sp=2, widths="8b", layers=2, dtype="bfloat16",
                  batch=1, seq=4096, steps=3), False, True),
    ]
    launches = {row: {"float32": 0, "bfloat16": 0} for row in
                ("dense_attention_fwd", "dense_attention_bwd", *CHUNK_ROWS)}
    for job, oracle, falling in jobs:
        docs, (f, b) = mesh_leg(torch, dev, card, job, oracle=oracle, collective="gloo",
                                falling=falling)
        for row, n in zip(("dense_attention_fwd", "dense_attention_bwd"), (f, b)):
            launches[row][job["dtype"]] += n
            if job["sp"] > 1:
                launches[row + "_sp"][job["dtype"]] += n
    return launches, (job, docs)


# ---------------------------------------------------------------------------
# phase 13: ring attention over the sp line
# ---------------------------------------------------------------------------

#: 13.1's ring: a tp 2 x sp 2 rank of Llama-3-8B at T 8192, (B, T, H, KVH,
#: hd) with the sequence cut into RING_SP chunks of 4096
RING_SHAPE = (1, 8192, 16, 4, 128)
RING_SP = 2
#: the merge kernel against its plain version: fp32 elementwise arithmetic
#: (exp, log1p and a weighted sum, a few fp32 ulps each, in another
#: implementation), each output's max abs error over its largest |value|
RING_MERGE_REL = 2.0**-20
#: 13.2's bf16 ring leg: its first loss against the all-gather flavour's
#: (12.8's leg: the same seed, weights and batch), relative.  Fixed before
#: the first run: the two flavours round the attention's output at other
#: places (a bf16 output a chunk, merged in fp32), a few bf16 ulps on values
#: that feed a mean over 4095 tokens' nll
RING_BF16_LOSS_REL = 1e-2
#: the ring's kernel rows beside B9's forward: "D only", "D given", the merge
RING_ROWS = ("dense_attention_d", GIVEN_ROW, "ring_merge")


def ring_by_chunks(torch, steps, q, k, v, do, *, sp, rank, causal=True):
    """Rank ``rank`` of an sp ring built on one process, chunk by chunk,
    from the whole ``k`` and ``v`` ``[B, sp * Tq, KVH, hd]`` (no mesh):
    ``steps`` (an ``ops.ring_attention.ChunkSteps``) run on each live chunk
    in ring order, merged; D summed over the chunks (bf16) or taken once
    (fp32); "D given" on each.  Returns ``(out, dq, dk, dv)``, dk and dv
    over all keys (this rank's queries' share)."""
    from cordum_tpu_torch.ops import ring_attention as ra

    b, tq = q.shape[:2]
    tk = k.shape[1] // sp
    ks = [x.contiguous() for x in k.split(tk, 1)]
    vs = [x.contiguous() for x in v.split(tk, 1)]
    live = [(o, ra.chunk_positions(rank, o, b, tq, tk, causal, q.device))
            for o in ((rank - s) % sp for s in range(sp))]
    live = [(o, pos) for o, pos in live if pos is not None]
    acc = lse = None
    for o, pos in live:
        acc, lse = steps.merge(acc, lse, *steps.fwd(q, ks[o], vs[o], pos))
    out = acc.to(q.dtype)
    if q.dtype == torch.float32:
        d = steps.d(q, ks[rank], vs[rank], live[0][1], out, lse, do)
    else:
        d = sum(steps.d(q, ks[o], vs[o], pos, out, lse, do) for o, pos in live)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for o, pos in live:
        gq, gk, gv = steps.bwd(q, ks[o], vs[o], pos, out, lse, do, d=d)
        dq += gq
        dk[:, o * tk:(o + 1) * tk] += gk
        dv[:, o * tk:(o + 1) * tk] += gv
    return out, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def ring_gate(torch, got, plain, exact, pos, what):
    """7.1's gates on ``(out, dq, dk, dv)``: fp32 against the plain version
    (the output within ``DENSE_OUT_ATOL``, each gradient within
    ``DENSE_GRAD_REL`` of its largest |value|), bf16 the row gate against
    the exact result.  Raises naming ``what``; returns the readings."""
    if got[0].dtype == torch.float32:
        errs = {"out": (got[0] - plain[0]).abs().max().item()}
        for name, g, p in zip(("dq", "dk", "dv"), got[1:], plain[1:]):
            errs[name] = ((g - p).abs().max() / p.abs().max().clamp_min(1e-30)).item()
        ok = errs["out"] <= DENSE_OUT_ATOL and all(
            errs[n] <= DENSE_GRAD_REL for n in ("dq", "dk", "dv"))
        if not ok or not all(torch.isfinite(x).all().item() for x in got):
            raise AssertionError(f"{what}: {errs}; tolerances out {DENSE_OUT_ATOL}, gradients "
                                 f"{DENSE_GRAD_REL} of their max")
        return errs
    gate = bf16_row_gate(got, plain, exact, pos)
    if not all(g["ok"] for g in gate.values()) or not all(
            torch.isfinite(x).all().item() for x in got):
        raise AssertionError(f"{what}: bf16 row gate {gate}")
    return {name: g["kernel"] for name, g in gate.items()}


def check_ring_whole(torch, steps, q, k, v, do, *, sp, rank, what):
    """The ring of rank ``rank`` built chunk by chunk (:func:`ring_by_chunks`)
    against ``gqa_attention`` on the whole row (the rank's queries at their
    global positions against every key, autograd of the plain version) by
    :func:`ring_gate`."""
    from cordum_tpu_torch.ops import dense_attention as da

    b, tq = q.shape[:2]
    pos = torch.arange(rank * tq, (rank + 1) * tq, dtype=torch.int32,
                       device=q.device).expand(b, tq).contiguous()
    got = ring_by_chunks(torch, steps, q, k, v, do, sp=sp, rank=rank)
    plain = dense_grads(torch, da.dense_attention_reference, q, k, v, pos, do)
    exact = plain if q.dtype == torch.float32 else dense_grads(
        torch, da.dense_attention_reference, *(x.float() for x in (q, k, v)), pos, do.float())
    return ring_gate(torch, got, plain, exact, pos, what)


def ring_work_of(b, tq, h, kvh, hd, el, positions, tk):
    """(bytes, operations) of a ring chunk's three B9 entries and of the
    merge, by :func:`dense_work_of`'s count: the forward (4 hd a live
    pair); "D only", bf16 ``sum_k P dP`` (QK and dP, 4 hd a pair; q, k, v,
    dO, positions and lse read, D written) or fp32 ``rowsum(dO * out)``
    (out and dO read, D written, 2 hd a row); "D given" (10 hd a pair; q,
    k, v, dO, positions, lse and D read, dq, dk and dv written); the merge
    (acc read and written, out_c read, lse read and written, lse_c read; 3
    operations a value)."""
    fwd, _ = dense_work_of(b, tq, h, kvh, hd, el, positions, tk)
    pos = positions.long().cpu()
    pairs = int((pos + 1).clamp(max=tk).sum())
    q_el, kv_el, rows = b * tq * h * hd, b * tk * kvh * hd, b * h * tq
    if el == 4:
        d = (4 * 2 * q_el + 4 * rows, 2 * q_el)
    else:
        d = (el * (2 * q_el + 2 * kv_el) + 4 * b * tq + 8 * rows, 4 * hd * h * pairs)
    given = (el * (4 * q_el + 4 * kv_el) + 4 * b * tq + 8 * rows, 10 * hd * h * pairs)
    merge = ((8 + el) * q_el + 12 * rows, 3 * q_el)
    return {"fwd": fwd, "d": d, "given": given, "merge": merge}


def _sdpa_gqa(F, qh, kh, vh, **kw):
    """SDPA over ``[B, H, T, hd]`` queries and ``[B, KVH, T, hd]`` keys and
    values: ``enable_gqa`` where this torch has it, else K/V expanded first
    (outside the timed call)."""
    try:
        F.scaled_dot_product_attention(qh[:, :, :1], kh[:, :, :1], vh[:, :, :1], enable_gqa=True)
    except TypeError:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, 1).detach().requires_grad_()
        vh = vh.repeat_interleave(rep, 1).detach().requires_grad_()
        return kh, vh, lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw)
    return kh, vh, lambda: F.scaled_dot_product_attention(qh, kh, vh, enable_gqa=True, **kw)


def ring_row(name, kind, ms, plain_ms, lib_ms, work, err, tol, card):
    """A kernel-line row of phase 13, logged with its share of the bound."""
    nbytes, ops = work
    mem_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[name] * 1e3
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=max(mem_ms, ops_ms), bound_by="bytes" if mem_ms >= ops_ms else "operations")
    log(f"[ring-kernel] {kind} {name}: kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms "
        + (f"{lib_ms:.4f}" if lib_ms is not None else "none")
        + f"  bound_ms {row['bound_ms']:.4f} ({row['bound_by']}: {nbytes} bytes, {ops} ops), "
        f"share of bound {row['bound_ms'] / ms:.3f}; max abs err {err:.3e} ({tol})  [{card}]")
    return row


def measure_ring(torch, dev, card, dtype, flush):
    """13.1 in one dtype: rank 1's queries of :data:`RING_SHAPE` against
    rank 0's chunk (every key live) and its own diagonal chunk: B9's
    forward, "D only" and "D given" and the merge against their plain
    versions (bf16 by the row gate against the exact result, fp32 by 7.1's
    tolerances; lse, out and D the whole row's exact ones, fed to every
    version alike); then the whole ring built chunk by chunk, of rank 1
    and of rank 0, against ``gqa_attention`` on the whole row; then times
    (CUDA events, L2 flushed), bounds, plain times and SDPA's.  Returns
    the kernel-line rows, the earlier chunk's."""
    import torch.nn.functional as F

    from cordum_tpu_torch.ops import dense_attention as da
    from cordum_tpu_torch.ops import ring_attention as ra

    b, t, h, kvh, hd = RING_SHAPE
    tq = t // RING_SP
    name = str(dtype).split(".")[-1]
    q, k, v, do, pos = dense_case(torch, dev, b, tq, h, kvh, hd, dtype, tk=t, first=tq)
    with torch.no_grad():
        out_x, lse_x = da.dense_attention_fwd_reference(*(x.float() for x in (q, k, v)), pos)
        d_x = (do.float() * out_x).sum(-1).transpose(1, 2).contiguous()
    out_in = out_x.to(dtype).contiguous()
    chunks = {"earlier": (k[:, :tq].contiguous(), v[:, :tq].contiguous(),
                          ra.chunk_positions(1, 0, b, tq, tq, True, dev)),
              "diagonal": (k[:, tq:].contiguous(), v[:, tq:].contiguous(),
                           ra.chunk_positions(1, 1, b, tq, tq, True, dev))}
    rows, fwd_out = {}, {}
    for kind, (kc, vc, pc) in chunks.items():
        kern = [*da.dense_attention_fwd(q, kc, vc, pc)]
        d_k = da.dense_attention_d(q, kc, vc, pc, out_in, lse_x, do)
        g_k = da.dense_attention_bwd(q, kc, vc, pc, out_in, lse_x, do, d=d_x)
        torch.cuda.synchronize()
        with torch.no_grad():
            plain = [*da.dense_attention_fwd_reference(q, kc, vc, pc)]
            d_p = da.dense_attention_d_reference(q, kc, vc, pc, out_in, lse_x, do)
            g_p = da.dense_attention_bwd_reference(q, kc, vc, pc, out_in, lse_x, do, d=d_x)
            e_in = [x.float() for x in (q, kc, vc)]
            exact = [*da.dense_attention_fwd_reference(*e_in, pc)]
            d_e = da.d_from_weights(*e_in, pc, lse_x, do.float()) \
                if dtype == torch.bfloat16 else d_x
            g_e = da.dense_attention_bwd_reference(*e_in, pc, out_x, lse_x, do.float(), d=d_x)
        fwd_out[kind] = kern
        gates = ring_gate(torch, (kern[0], *g_k), (plain[0], *g_p), (exact[0], *g_e), pc,
                          f"ring chunk {kind} {name} (forward and D given)")
        lse_err = (kern[1] - plain[1]).abs().max().item()
        if dtype == torch.float32:
            d_err = ((d_k - d_p).abs().max() / d_p.abs().max()).item()
            d_ok = d_err <= DENSE_GRAD_REL
        else:
            scale = d_e.abs().max().item()
            d_err = worst_row(d_k[..., None], d_e[..., None], scale)
            d_ok = d_err <= DENSE_ROW_FACTOR * worst_row(d_p[..., None], d_e[..., None], scale) \
                + DENSE_ROW_SLACK
        if not d_ok or lse_err > 1e-3 or not torch.isfinite(d_k).all().item():
            raise AssertionError(f"ring chunk {kind} {name}: D only {d_err:.3e}, lse {lse_err:.3e}")
        log(f"[ring-gate] {kind} chunk {name}: forward and D given {gates}; D only "
            f"{d_err:.3e}; lse max abs err {lse_err:.3e}  [{card}]")
        # times: B9's three entries on this chunk, the plain versions, SDPA
        qh = q.transpose(1, 2).contiguous().requires_grad_()
        kh = kc.transpose(1, 2).contiguous().requires_grad_()
        vh = vc.transpose(1, 2).contiguous().requires_grad_()
        kh, vh, lib_call = _sdpa_gqa(F, qh, kh, vh, is_causal=kind == "diagonal")
        lib = lib_call()
        doh = do.transpose(1, 2).contiguous()
        ms = {
            "fwd": time_ms(torch, lambda: da.dense_attention_fwd(q, kc, vc, pc), iters=20,
                           flush=flush),
            "d": time_ms(torch, lambda: da.dense_attention_d(q, kc, vc, pc, out_in, lse_x, do),
                         iters=20, flush=flush),
            "given": time_ms(torch, lambda: da.dense_attention_bwd(q, kc, vc, pc, out_in, lse_x,
                                                                   do, d=d_x),
                             iters=20, flush=flush)}
        with torch.no_grad():
            plain_ms = {
                "fwd": time_ms(torch, lambda: da.dense_attention_fwd_reference(q, kc, vc, pc),
                               iters=3, flush=flush),
                "d": time_ms(torch, lambda: da.dense_attention_d_reference(
                    q, kc, vc, pc, out_in, lse_x, do), iters=3, flush=flush),
                "given": time_ms(torch, lambda: da.dense_attention_bwd_reference(
                    q, kc, vc, pc, out_in, lse_x, do, d=d_x), iters=3, flush=flush)}
            lib_fwd = time_ms(torch, lib_call, iters=10, flush=flush)
        lib_bwd = time_ms(torch, lambda: torch.autograd.grad(lib, (qh, kh, vh), doh,
                                                             retain_graph=True),
                          iters=10, flush=flush)
        work = ring_work_of(b, tq, h, kvh, hd, q.element_size(), pc, tq)
        errs = {"fwd": (kern[0].float() - plain[0].float()).abs().max().item(),
                "d": (d_k - d_p).abs().max().item(),
                "given": max((g - p).float().abs().max().item() for g, p in zip(g_k, g_p))}
        tol = "row gate" if dtype == torch.bfloat16 else "7.1's fp32 gates"
        for step, lib_ms in (("fwd", lib_fwd), ("d", None), ("given", lib_bwd)):
            row = ring_row(name, f"{kind} chunk {step}", ms[step], plain_ms[step], lib_ms,
                           work[step], errs[step], tol, card)
            if kind == "earlier" and step != "fwd":
                rows["dense_attention_d" if step == "d" else GIVEN_ROW] = row
        del qh, kh, vh, lib, doh, kern, plain, exact, g_k, g_p, g_e
        torch.cuda.empty_cache()
    # the merge: the earlier chunk's pair starts the accumulator, the
    # diagonal's is folded in
    (o_e, l_e), (o_d, l_d) = fwd_out["earlier"], fwd_out["diagonal"]
    acc, lse = ra.ring_merge(None, None, o_e, l_e)
    acc, lse = ra.ring_merge(acc, lse, o_d, l_d)
    p_acc, p_lse = ra.ring_merge_reference(*ra.ring_merge_reference(None, None, o_e, l_e), o_d, l_d)
    torch.cuda.synchronize()
    m_err = max(((acc - p_acc).abs().max() / p_acc.abs().max()).item(),
                ((lse - p_lse).abs().max() / p_lse.abs().max()).item())
    if not m_err <= RING_MERGE_REL:
        raise AssertionError(f"ring_merge {name}: {m_err:.3e} of the largest value (tolerance "
                             f"{RING_MERGE_REL:.3e})")
    base = (acc.clone(), lse.clone())

    def merge_once(fn):
        a, lv = base[0].clone(), base[1].clone()
        return lambda: fn(a, lv, o_d, l_d)

    k_merge = time_ms(torch, merge_once(ra.ring_merge), iters=20, flush=flush)
    p_merge = time_ms(torch, merge_once(ra.ring_merge_reference), iters=5, flush=flush)
    work = ring_work_of(b, tq, h, kvh, hd, q.element_size(), chunks["earlier"][2], tq)
    rows["ring_merge"] = ring_row(name, "merge", k_merge, p_merge, None, work["merge"],
                                  (acc - p_acc).abs().max().item(),
                                  f"{RING_MERGE_REL:.3e} of the largest value", card)
    del acc, lse, p_acc, p_lse, base, fwd_out
    # the whole ring, chunk by chunk, against the whole row
    whole = {1: check_ring_whole(torch, ra.KERNEL_STEPS, q, k, v, do, sp=RING_SP, rank=1,
                                 what=f"ring rank 1 {name}")}
    q0, _, _, do0, _ = dense_case(torch, dev, b, tq, h, kvh, hd, dtype, seed=SEED + 1, tk=t)
    whole[0] = check_ring_whole(torch, ra.KERNEL_STEPS, q0, k, v, do0, sp=RING_SP, rank=0,
                                what=f"ring rank 0 {name}")
    log(f"[ring-gate] the whole ring of sp {RING_SP} built chunk by chunk against gqa_attention "
        f"on the whole row ({name}; B {b}, T {t}, H {h}, KVH {kvh}, hd {hd}): rank 1 "
        f"{whole[1]}, rank 0 {whole[0]}  [{card}]")
    del q, k, v, do, q0, do0
    torch.cuda.empty_cache()
    return rows


def phase_ring_kernel(torch, dev, card):
    """13.1 in both dtypes; returns the kernel-line rows by row and dtype."""
    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def flush():
        flush_buf.zero_()

    rows = {row: {} for row in RING_ROWS}
    for dtype in (torch.bfloat16, torch.float32):
        for row, res in measure_ring(torch, dev, card, dtype, flush).items():
            rows[row][str(dtype).split(".")[-1]] = res
    del flush_buf
    torch.cuda.empty_cache()
    return rows


def ring_design(job, sp_rank):
    """A ring rank's launches and hops a layer a step
    (``ops/ring_attention.py``'s note): at sp coordinate ``s`` of ``n``,
    causal, ``s + 1`` forward chunks, merges and "D given", ``s + 1`` "D
    only" in bf16 (one in fp32); hops ``n - 1`` forward, ``n`` backward,
    ``n - 1`` more for the bf16 D ring."""
    n, live, bf16 = job["sp"], sp_rank + 1, job["dtype"] == "bfloat16"
    return {"fwd": live, "d": live if bf16 else 1, "given": live, "merge": live,
            "p2p": 2 * n - 1 + (n - 1 if bf16 else 0)}


def ring_launches(job, docs):
    """Each rank of a ring job against :func:`ring_design`: its B9 forward
    launches, "D only", "D given" and merges (layers x steps x the
    design's), no backward without D and no gathered chunk; its hops a step
    (steps 2 on, as ``calls`` counts them) and no all-gather or
    reduce-scatter.  Returns the sums ``[forward, backward (0), D only, D
    given, merge]``."""
    n = docs[0]["n_layers"] * job["steps"]
    per_step = docs[0]["n_layers"] * max(job["steps"] - 1, 1)
    sums = [0] * 5
    for d in docs:
        want = ring_design(job, d["coords"]["sp"])
        got = [*d["launches"], *d["ring_launches"]]
        expect = [n * want["fwd"], 0, n * want["d"], n * want["given"], n * want["merge"]]
        calls = d["calls"]
        if got != expect or d["chunk_launches"] != [0, 0] or calls["p2p"] != \
                per_step * want["p2p"] or calls["all_gather"] or calls["reduce_scatter"]:
            raise AssertionError(
                f"{mesh_label(job)}: rank {d['rank']} (sp {d['coords']['sp']}) launches "
                f"[forward, backward, D only, D given, merge] {got}, {expect} expected; gathered "
                f"chunks {d['chunk_launches']}; hops {calls['p2p']}, {per_step * want['p2p']} "
                f"expected; all-gathers {calls['all_gather']}, reduce-scatters "
                f"{calls['reduce_scatter']}, none expected")
        sums = [a + b for a, b in zip(sums, expect)]
    return sums


def ring_versus_gather(card, gather, ring, tag):
    """12.4's numbers of a ring leg beside the all-gather leg of the same
    job (``(job, docs)`` each, from one call): step p50, tokens/s a card,
    peak memory a rank, host ms a step inside P2P against the all-gathers
    and reduce-scatters."""
    out = {}
    for flavour, (job, docs) in (("gather", gather), ("ring", ring)):
        steps = job["steps"]
        p50 = max(statistics.median(d["step_s"][1:]) for d in docs)
        host = {k: max(d["host_s"][k] for d in docs) / (steps - 1) * 1e3
                for k in ("p2p", "all_gather", "reduce_scatter", "all_reduce")}
        out[flavour] = {"p50_ms": p50 * 1e3, "tokens_s_card": job["batch"] * job["seq"] / p50
                        / len(docs), "peak_gib": max(d["peak_gib"] for d in docs), **host}
    log(f"[{tag}] ring against all-gather, {mesh_label(ring[0])}: " + "; ".join(
        f"{f}: step p50 {n['p50_ms']:.2f} ms, {n['tokens_s_card']:.1f} tokens/s a card, peak "
        f"{n['peak_gib']:.2f} GiB a rank, host ms a step (the slowest rank) in P2P "
        f"{n['p2p']:.2f}, all-gather {n['all_gather']:.2f}, reduce-scatter "
        f"{n['reduce_scatter']:.2f}, all-reduce {n['all_reduce']:.2f}" for f, n in out.items())
        + f"  [{card}]")
    return out


def phase_ring_mesh(torch, dev, card, gather_bf16):
    """13.2 on the one card (gloo rank processes sharing it), the ring
    with ``use_ring_attention``: fp32 ``LlamaConfig.tiny()`` with 4 layers
    at tp 2 x sp 2 and at sp 4, held to the one-process step as 12.7 is;
    bf16 at Llama-3-8B widths, 2 layers, tp 2 x sp 2, T 4096 (12.8's job):
    a falling loss, its first loss within :data:`RING_BF16_LOSS_REL` of
    12.8's (``gather_bf16``: that leg's ``(job, docs)``) and 12.4's numbers
    beside it.  Each rank's launches and hops by :func:`ring_launches`.
    Returns the launches by kernel row and dtype."""
    tiny = dict(widths="tiny", layers=4, dtype="float32", batch=4, seq=64, steps=3, ring=True)
    jobs = [(mesh_job("llama", 1, 1, tp=2, sp=2, **tiny), True),
            (mesh_job("llama", 1, 1, sp=4, **tiny), True),
            (mesh_job("llama", 1, 1, tp=2, sp=2, widths="8b", layers=2, dtype="bfloat16",
                      batch=1, seq=4096, steps=3, ring=True), False)]
    launches = {row: {"float32": 0, "bfloat16": 0} for row in ("dense_attention_fwd", *RING_ROWS)}
    for job, oracle in jobs:
        docs, _ = mesh_leg(torch, dev, card, job, oracle=oracle, collective="gloo", falling=True,
                           tag="ring-mesh")
        fwd, _, *ring = ring_launches(job, docs)
        for row, n in zip(("dense_attention_fwd", *RING_ROWS), (fwd, *ring)):
            launches[row][job["dtype"]] += n
        if job["dtype"] == "bfloat16":
            first, want = docs[0]["losses"][0], gather_bf16[1][0]["losses"][0]
            rel = abs(first - want) / abs(want)
            log(f"[ring-mesh] {mesh_label(job)}: first loss {first:.6f} against the all-gather "
                f"flavour's {want:.6f} (12.8): rel {rel:.3e} (bound {RING_BF16_LOSS_REL:g})  "
                f"[{card}]")
            if not rel <= RING_BF16_LOSS_REL:
                raise AssertionError(f"{mesh_label(job)}: first loss {first} against the "
                                     f"all-gather flavour's {want} (rel {rel:.3e})")
            ring_versus_gather(card, gather_bf16, (job, docs), "ring-mesh")
    return launches


# ---------------------------------------------------------------------------
# phase 14: expert parallelism, the MoE family over dp x tp x ep
# ---------------------------------------------------------------------------

#: 14.1: rank 1 of a dp mesh of this many ranks, its room after rank 0
MOE_ROOM_DP = 2
#: 14.1's cases: (tag, rank 0's probabilities, rank 1's), ``moe_case`` kinds
MOE_ROOM_CASES = (("rank 1's room", "random", "random"),
                  ("a room of 0", "drop", "random"),
                  ("every token to one expert", "random", "one"),
                  ("exact ties", "ties", "ties"))
#: 14.2 and 14.3: the capacity factor and the router's skew toward expert 0
#: (:func:`skew_router`) under which tokens drop, so that a rank-local
#: capacity, a missing prefix or local counts in the aux loss move the loss
MOE_MESH_CF = 0.5
MOE_MESH_SKEW = 2.0
#: 14.2's bf16 ep 2 leg: its first loss against 9.3's one-card run on the
#: same weights and batch, relative (bf16: the combine's partial sums added
#: over the ranks in bf16, in another order)
MOE_MESH_BF16_REL = 1e-2


def room_of(torch, prefix, cap):
    """A dp rank's room from the lower ranks' counts: ``max(0, C - prefix)``."""
    return torch.clamp_min(cap - prefix, 0).to(torch.int32)


def check_room_route(torch, dev, dtype, tag, kind0, kind1, *, n=MOE_BATCH * MOE_SEQ, d=4096):
    """14.1 on one case: rank 1's route with the room rank 0 leaves it (the
    route's pick, the room from its counts, then its place), equal to the
    plain version's (every field) and the same on two calls, the counts
    handed to the room those of the plain version; its kept slots,
    positions and experts those of
    the whole batch's route on its rows; then B7's gathers on that route
    and on an ep 2 line's rank 1 view of it (experts 4-7: the other pairs'
    idx negative or past 3) by :func:`check_moe_gathers`.  Returns the
    case's rank-1 probabilities, capacity and room, and the gathers'
    errors."""
    from cordum_tpu_torch.ops import moe_dispatch as md

    cf = 1.25 * MOE_ROOM_DP  # C of the whole batch, dp x N tokens
    zero = moe_case(torch, dev, dtype, n=n, d=d, kind=kind0, cf=cf, seed=SEED + 30)["probs"]
    case = moe_case(torch, dev, dtype, n=n, d=d, kind=kind1, cf=cf, seed=SEED + 31)
    probs, k, cap = case["probs"], case["k"], case["cap"]
    prefix = md.moe_route_reference(zero, k, cap).counts
    room = room_of(torch, prefix, cap)
    seen = []

    def exchange(counts):
        seen.append(counts.clone())
        return room_of(torch, prefix, cap)

    plain = md.moe_route_reference(probs, k, cap, lambda counts: room)
    split = md.moe_route_kernel(probs, k, cap, exchange)
    again = md.moe_route_kernel(probs, k, cap, exchange)
    torch.cuda.synchronize()
    for what, got in (("first call", split), ("second call", again)):
        if not md.route_equal(got, plain):
            bad = [f for f, a, b in zip(md.MoERoute._fields, got, plain)
                   if (a is None) != (b is None) or (a is not None and not torch.equal(a, b))]
            raise AssertionError(f"moe_route with a room ({tag}, {what}): {bad} differ from "
                                 "the plain version's")
    if not all(torch.equal(c, plain.counts) for c in seen):
        raise AssertionError(f"moe_route with a room ({tag}): the counts handed to the exchange "
                             "differ from the plain version's")
    whole = md.moe_route_reference(torch.cat([zero, probs]), k, cap)
    shifted = split.pos + prefix.long()[split.idx.long()].to(torch.int32)
    if not (torch.equal(whole.idx[n:], split.idx) and torch.equal(whole.keep[n:], split.keep)
            and torch.equal(whole.pos[n:], shifted)):
        raise AssertionError(f"moe_route with a room ({tag}): rank 1's route is not the whole "
                             "batch's on its rows")
    if "room of 0" in tag and room.min().item() != 0:
        raise AssertionError(f"moe_route with a room ({tag}): no expert's room is 0: "
                             f"{room.tolist()}")
    w = routing_weights(torch, probs, split)
    errs = check_moe_gathers(torch, case, split, w, f"{tag}, room")
    view = md.local_experts(split, 4, 4)
    if not (view.idx < 0).any() and split.keep.any():
        raise AssertionError(f"moe ep view ({tag}): no negative idx on the other experts' pairs")
    local = dict(case, expert_out=case["expert_out"][4:].contiguous(),
                 d_ei=case["d_ei"][4:].contiguous())
    for mode, err in check_moe_gathers(torch, local, view, w, f"{tag}, ep rank 1").items():
        errs[mode] = max(errs[mode], err)
    log(f"[moe-room] {str(dtype).split('.')[-1]} {tag}: N {n}, D {d}, E 8, k {k}, C {cap} (a dp "
        f"{MOE_ROOM_DP} mesh's batch); room {room.tolist()}, rank 1 keeps "
        f"{int(split.keep.sum())} of {split.keep.numel()} slots (counts "
        f"{split.counts.tolist()}); the route equal to the plain version's and to the whole "
        f"batch's on rank 1's rows; gathers on the route and on ep rank 1's view "
        f"(experts 4-7) by 9.1's gates, max abs err " + ", ".join(
            f"{MOE_KERNELS[m]} {errs[m]:.3e}" for m in ("moe_token_gather", "moe_token_sum",
                                                       "moe_token_dot")))
    return probs, k, cap, room, errs


def phase_moe_room_kernel(torch, dev, card):
    """14.1: :func:`check_room_route` on every case in both dtypes, then
    the route's times on the first case (9.1's method: CUDA events, L2
    flushed) with a room (pick, the counts' sum, the room, place) beside
    the route without one (9.1's) and the plain version with the room.
    Returns the ``moe_route_room`` row (the probabilities are fp32
    whatever the model's dtype)."""
    from cordum_tpu_torch.ops import moe_dispatch as md

    flush_buf = torch.empty(256 * 1024 * 1024 // 4, device=dev)

    def flush():
        flush_buf.zero_()

    for dtype in (torch.bfloat16, torch.float32):
        for tag, kind0, kind1 in MOE_ROOM_CASES:
            got = check_room_route(torch, dev, dtype, tag, kind0, kind1)
            if tag == MOE_ROOM_CASES[0][0]:
                probs, k, cap, room, _ = got
            del got
            torch.cuda.empty_cache()
    n, e = probs.shape
    prefix = (cap - room).clamp_min(0)
    def exchange(counts):
        return room_of(torch, prefix, cap)

    timed = {"without a room": lambda: md.moe_route_kernel(probs, k, cap),
             "with a room": lambda: md.moe_route_kernel(probs, k, cap, exchange)}
    ms = {what: time_ms(torch, fn, iters=50, flush=flush) for what, fn in timed.items()}
    plain_ms = time_ms(torch, lambda: md.moe_route_reference(probs, k, cap, exchange),
                       iters=10, flush=flush)
    route = md.moe_route_reference(probs, k, cap, exchange)
    nbytes, ops = moe_work_of(route, n, 4096, e, cap, k, 4)["moe_route"]
    nbytes += e * 4  # the room
    bound = max(nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_OPS["float32"] * 1e3)
    by = "bytes" if nbytes / HBM_BYTES_PER_S >= ops / PEAK_OPS["float32"] else "operations"
    log(f"[moe-room] route times at N {n}, E {e}, k {k}, C {cap}: " + ", ".join(
        f"{what} {t:.4f} ms" for what, t in ms.items()) + f"; plain with the room "
        f"{plain_ms:.4f} ms; bound {bound:.4f} ms ({by}: {nbytes} bytes, {ops} ops), share of "
        f"bound {bound / ms['with a room']:.3f}; device us per call (with a room): "
        f"{device_split(torch, timed['with a room'], flush)}  [{card}]")
    del flush_buf
    torch.cuda.empty_cache()
    return {ROOM_ROW: {"float32": dict(max_abs_err=0.0, ms=ms["with a room"],
                                       plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                                       bound_by=by)}}


def moe_mesh_launches(docs):
    """The B7 launches of a MoE job's ranks, summed by kernel row (each
    rank's already held to its layers and steps by :func:`mesh_launches`)."""
    return {row: sum(d["moe_launches"][row] for d in docs) for row in (*MOE_KERNELS, ROOM_ROW)}


def phase_moe_mesh(torch, dev, card, first_loss):
    """14.2 on the one card (gloo rank processes sharing it): fp32
    ``MoEConfig.tiny()`` experts on ``LlamaConfig.tiny()``, 4 layers, B 4,
    T 64, 3 steps, capacity factor :data:`MOE_MESH_CF` and router skew
    :data:`MOE_MESH_SKEW` (layer 0 drops slots, checked on the oracle), at
    dp 2 x ep 2, tp 2 x ep 2 and ep 4, each held to the one-process step;
    then bf16 at 9.3's configuration and batch (Mixtral widths, 2 layers,
    B 4, T 2048) at ep 2, 3 steps: a falling loss, its first loss within
    :data:`MOE_MESH_BF16_REL` of 9.3's (``first_loss``).  Returns the
    launches by kernel row and dtype (B9's forward and backward, B7's six
    modes and the route with a room)."""
    tiny = dict(widths="tiny", layers=4, dtype="float32", batch=4, seq=64, steps=3,
                cf=MOE_MESH_CF, skew=MOE_MESH_SKEW)
    jobs = [(mesh_job("moe", 2, 1, ep=2, **tiny), True),
            (mesh_job("moe", 1, 1, tp=2, ep=2, **tiny), True),
            (mesh_job("moe", 1, 1, ep=4, **tiny), True),
            (mesh_job("moe", 1, 1, ep=2, widths="8b", layers=2, dtype="bfloat16",
                      batch=MOE_BATCH, seq=MOE_SEQ, steps=3, token_seed=SEED + 11), False)]
    rows = ("dense_attention_fwd", "dense_attention_bwd", *MOE_KERNELS, ROOM_ROW)
    launches = {row: {"float32": 0, "bfloat16": 0} for row in rows}
    for job, oracle in jobs:
        docs, (f, b) = mesh_leg(torch, dev, card, job, oracle=oracle, collective="gloo",
                                falling=True, tag="moe-mesh")
        for row, n in {"dense_attention_fwd": f, "dense_attention_bwd": b,
                       **moe_mesh_launches(docs)}.items():
            launches[row][job["dtype"]] += n
        if job["dtype"] == "bfloat16":
            first = docs[0]["losses"][0]
            rel = abs(first - first_loss) / abs(first_loss)
            log(f"[moe-mesh] {mesh_label(job)}: first loss {first:.6f} against 9.3's one card "
                f"{first_loss:.6f}: rel {rel:.3e} (bound {MOE_MESH_BF16_REL:g})  [{card}]")
            if not rel <= MOE_MESH_BF16_REL:
                raise AssertionError(f"{mesh_label(job)}: first loss {first} against 9.3's "
                                     f"{first_loss} (rel {rel:.3e})")
            mesh_numbers(card, job, docs, tag="moe-mesh")
    return launches


def cards_moe_legs(torch, dev, card):
    """14.3 and 14.4 on four cards, one rank process a card over NCCL.
    14.3: fp32 Mixtral widths (:func:`moe_config`), 2 layers, B 2, T 256,
    one AdamW step, capacity factor :data:`MOE_MESH_CF` and router skew
    :data:`MOE_MESH_SKEW`: ep 4, dp 2 x ep 2 and tp 2 x ep 2, each held to
    the one-process step on card 0, run first and freed.  14.4: bf16
    Mixtral widths at 8 of 32 layers, 9.3's batch (B 4, T 2048), 10 steps:
    ep 4 and tp 2 x ep 2, a falling loss; step p50, tokens/s a card, peak
    memory a rank, host ms a step in the collectives."""
    import tempfile

    fp32 = dict(widths="8b", layers=2, dtype="float32", batch=2, seq=256, steps=1,
                cf=MOE_MESH_CF, skew=MOE_MESH_SKEW)
    with tempfile.TemporaryDirectory(prefix="cordum-moe-oracle-") as workdir:
        oracle = mesh_oracle(torch, dev, card, mesh_job("moe", 1, 1, **fp32), workdir)
        for job in (mesh_job("moe", 1, 1, ep=4, **fp32), mesh_job("moe", 2, 1, ep=2, **fp32),
                    mesh_job("moe", 1, 1, tp=2, ep=2, **fp32)):
            mesh_leg(torch, dev, card, job, oracle=oracle, collective="nccl", tag="moe-cards")
    numbers = {}
    for kw in (dict(ep=4), dict(tp=2, ep=2)):
        job = mesh_job("moe", 1, 1, widths="8b", layers=8, dtype="bfloat16", batch=MOE_BATCH,
                       seq=MOE_SEQ, steps=10, token_seed=SEED + 11, **kw)
        docs, _ = mesh_leg(torch, dev, card, job, oracle=False, collective="nccl",
                           falling=True, tag="moe-8b")
        numbers[mesh_label(job)] = mesh_numbers(card, job, docs, tag="moe-8b")
    log("[moe-8b] bf16 Mixtral widths, 8 layers, four cards, in this call: " + "; ".join(
        f"{label}: step p50 {n['p50_ms']:.2f} ms, {n['tokens_s']:.1f} tokens/s, "
        f"{n['tokens_s'] / 4:.1f} a card" for label, n in numbers.items()) + f"  [{card}]")


#: phase 15: the ranks' and the in-process runner's losses against one
#: process on the same draws, fp32 (the same sums; tp, sp, ep and pp split
#: them at other places)
GRAFT_LOSS_REL = 1e-5
#: phase 15: entry()'s forward on the kernel path against the plain path,
#: fp32, max abs error over the plain logits' largest |value| (B9's fp32
#: output gate 1e-5 carried through 4 layers and lm_head)
GRAFT_ENTRY_REL = 1e-4
#: phase 15's train jobs and the dryrun leg's (fixed batch, fp32 in the leg)
GRAFT_TRAIN = {"op": "train", "steps": 3, "batch": 4, "seq": 32, "fixed_batch": True}
GRAFT_FAMILIES = ("llama-tiny", "moe-tiny", "pipeline")
#: the dryrun leg's embed job: texts, and the local mesh's tp (WORKER_TP)
GRAFT_EMBED_TEXTS = 24
GRAFT_EMBED_TP = 2
#: the dryrun leg's embed against one card's embeddings of the whole batch
#: (unit vectors, fp32): cuBLAS picks its GEMM by the row count, so a
#: replica's 12 rows may sum in another order than one card's 24 (5.2e-08
#: on four H100s); against one card's embeddings of the same blocks the
#: embed must be exact
GRAFT_EMBED_ATOL = 1e-6
GRAFT_LAUNCH_ROWS = ("dense_attention_fwd", "dense_attention_bwd", "dense_attention_fwd_sp",
                     "dense_attention_bwd_sp", *MOE_KERNELS, ROOM_ROW)


def graft_launches(case, sizes, n_layers=2, microbatches=2):
    """What one rank of a dry-run case launches in its one step: B9's
    forward and backward once a layer (the pipeline: its stage's layers
    once a microbatch), every one a chunk's where sp is above 1; the MoE
    step's B7 modes once a layer, the route with a room where dp is above
    1."""
    want = dict.fromkeys(GRAFT_LAUNCH_ROWS, 0)
    layers = n_layers // sizes["pp"] * microbatches if case.startswith("pipeline") else n_layers
    want["dense_attention_fwd"] = want["dense_attention_bwd"] = layers
    if sizes["sp"] > 1:
        want["dense_attention_fwd_sp"] = want["dense_attention_bwd_sp"] = layers
    if case.startswith("moe"):
        want.update(dict.fromkeys(MOE_KERNELS, n_layers))
        want[ROOM_ROW] = n_layers if sizes["dp"] > 1 else 0
    return want


def graft_embed_launches(replicas, n_layers):
    """The embedder's kernel once a layer on each replica, one call."""
    return replicas * n_layers


def check_dryrun(results, n, *, collective, tag):
    """The dry run's gates beyond its own (finite, equal on every rank):
    each mesh is ``factor2``'s over ``n`` ranks, every rank used
    ``collective``, and each case's launches are what its design gives
    (:func:`graft_launches`) on every rank, summed.  Returns the launches
    summed over the cases."""
    from cordum_tpu_torch import graft_entry

    cases = graft_entry.dryrun_cases(n)
    if any(r["collective"] != collective for r in results["ranks"]):
        raise AssertionError(f"[{tag}] the ranks' collectives {results['ranks']}; "
                             f"{collective} expected")
    total = dict.fromkeys(GRAFT_LAUNCH_ROWS, 0)
    for case in cases:
        got = results[case.name]
        sizes = case.spec.resolve(n)
        if got["mesh"] != sizes:
            raise AssertionError(f"[{tag}] {case.name}: mesh {got['mesh']}, factor2 gives {sizes}")
        want = {k: v * n for k, v in graft_launches(case.name, sizes).items()}
        if {k: got["launches"][k] for k in GRAFT_LAUNCH_ROWS} != want:
            raise AssertionError(f"[{tag}] {case.name}: launches {got['launches']}; {want} "
                                 "expected (the ranks' sum)")
        for k in GRAFT_LAUNCH_ROWS:
            total[k] += want[k]
    return total


def check_graft_losses(results, oracle, tag, card):
    """Each dry-run loss within :data:`GRAFT_LOSS_REL` of the one-process
    step's on the same draws."""
    for name, want in oracle.items():
        got = results[name]["loss"]
        rel = abs(got - want) / abs(want)
        log(f"[{tag}] {name} mesh={results[name]['mesh']}: loss {got:.8f}, one process "
            f"{want:.8f}, rel {rel:.3e} (bound {GRAFT_LOSS_REL:g})  [{card}]")
        if not rel <= GRAFT_LOSS_REL:
            raise AssertionError(f"[{tag}] {name}: loss {got} against one process's {want} "
                                 f"(rel {rel:.3e})")


def check_graft_train(got, want, mesh, tag):
    """A ``train`` job's result against the same job on one card: the
    reference's keys, complete, ``mesh`` as resolved, its first and last
    losses within :data:`GRAFT_LOSS_REL`."""
    if set(got) != TRAIN_RESULT_KEYS:
        raise AssertionError(f"[{tag}] train result keys {sorted(got)} != the reference's")
    if not got["completed"] or got["mesh"] != mesh:
        raise AssertionError(f"[{tag}] {got['model']}: {got}; mesh {mesh} expected")
    for k in ("loss_first", "final_loss"):
        rel = abs(got[k] - want[k]) / abs(want[k])
        if not rel <= GRAFT_LOSS_REL:
            raise AssertionError(f"[{tag}] {got['model']} on {mesh}: {k} {got[k]} against one "
                                 f"card's {want[k]} (rel {rel:.3e})")


def phase_graft(torch, dev, card, ckpt_root):
    """15. The driver's entry points on the one card.  (1) ``entry()``'s
    forward (Llama at vocab 32000, d 512, 4 layers, bf16, tokens [4, 128]):
    finite logits of the right shape, B9 launched once a layer; the same
    weights in fp32 held to the plain path (:data:`GRAFT_ENTRY_REL`).  (2)
    ``dryrun_multichip(1)``: one rank process, every axis 1, its three
    steps' launches as the design gives, each loss equal to the
    one-process step's on the same draws (:data:`GRAFT_LOSS_REL`).  (3) A
    ``train`` job of each family through ``TrainRunner`` at world 1 (fixed
    batch, 3 steps): the reference's keys, a falling loss, every axis 1.
    Returns the launches by kernel row (bf16)."""
    import dataclasses as dc

    from cordum_tpu_torch import graft_entry, optim
    from cordum_tpu_torch.models import llama
    from cordum_tpu_torch.worker.training import TrainRunner

    t0 = time.monotonic()
    launches = dict.fromkeys(GRAFT_LAUNCH_ROWS, 0)
    ones = {"dp": 1, "tp": 1, "sp": 1, "ep": 1, "pp": 1}
    fn, (params, tokens) = graft_entry.entry(device=dev)
    cfg = llama.LlamaConfig(**graft_entry.ENTRY_CONFIG)
    zero_launches()
    with torch.no_grad():
        logits = fn(params, tokens)
    n = read_launches()
    if tuple(logits.shape) != (*graft_entry.ENTRY_TOKENS, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[graft] entry(): logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    want = graft_launches("entry", ones, n_layers=cfg.n_layers)["dense_attention_fwd"]
    if n["dense_attention_fwd"] != want:
        raise AssertionError(f"[graft] entry(): B9 launched {n['dense_attention_fwd']} times, "
                             f"{want} expected (once a layer)")
    launches["dense_attention_fwd"] += n["dense_attention_fwd"]
    cfg32 = dc.replace(cfg, dtype=torch.float32)
    params32 = optim.tree_map(lambda t: t.float(), params)
    with torch.no_grad():
        got = llama.forward(params32, tokens, cfg32)
        want = llama.forward(params32, tokens, cfg32, attention=plain_attention)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    if not rel <= GRAFT_ENTRY_REL:
        raise AssertionError(f"[graft] entry() in fp32: kernel path against the plain path "
                             f"{rel:.3e} of the largest logit")
    del params, params32, logits, got, want
    log(f"[graft] entry(): logits {tuple(graft_entry.ENTRY_TOKENS)} x {cfg.vocab_size} bf16, "
        f"finite; B9 {n['dense_attention_fwd']} launches; fp32 kernel path against the plain path "
        f"{rel:.3e} of the largest logit (bound {GRAFT_ENTRY_REL:g})  [{card}]")

    [results] = graft_entry.dryrun_multichip(1, device=None if dev.type == "cuda" else "cpu",
                                             log=log)
    for k, v in check_dryrun(results, 1, collective="none", tag="graft").items():
        launches[k] += v
    check_graft_losses(results, graft_entry.dryrun_one_process(1, device=dev), "graft", card)

    runner = TrainRunner(ckpt_root=ckpt_root, device=dev, ranks=1)
    for model in GRAFT_FAMILIES:
        zero_launches()
        out = runner.train({**GRAFT_TRAIN, "model": model})
        n = read_launches()
        if set(out) != TRAIN_RESULT_KEYS or out["mesh"] != ones or not out["completed"] \
                or not out["final_loss"] < out["loss_first"]:
            raise AssertionError(f"[graft] {model} through TrainRunner at world 1: {out}")
        want = {k: v * GRAFT_TRAIN["steps"]
                for k, v in graft_launches(model, ones, microbatches=2).items()}
        if {k: n[k] for k in GRAFT_LAUNCH_ROWS} != want:
            raise AssertionError(f"[graft] {model}: launches {n}; {want} expected")
        for k in GRAFT_LAUNCH_ROWS:
            launches[k] += n[k]
        log(f"[graft] {model} at world 1: loss {out['loss_first']:.4f} -> "
            f"{out['final_loss']:.4f} in {out['steps_done']} steps  [{card}]")
    log(f"[graft] phase 15 in {time.monotonic() - t0:.1f} s; launches {launches}  [{card}]")
    return {row: {"bfloat16": v, "float32": 0} for row, v in launches.items()}


async def drive_graft_worker(torch, dev, card, n, ckpt_root):
    """The dryrun leg's worker: a port worker owning ``n`` cards
    (``chips=n``) with the embedder's local mesh at
    :data:`GRAFT_EMBED_TP` (``WORKER_TP``) in fp32.  An ``embed`` job must
    return exactly one card's embeddings of each replica's block (the same
    weights, texts and padding on one card) and one card's embeddings of
    the whole batch within :data:`GRAFT_EMBED_ATOL`, the embedder's kernel
    launched once a layer on each of the ``n / tp`` replicas; its
    heartbeat's ``chip_count`` is ``n``.
    Then an fp32 ``train`` job of each family (mesh ``factor2``'s) must
    report the resolved mesh and lose as one card does
    (:data:`GRAFT_LOSS_REL`)."""
    import dataclasses as dc

    from cordum_tpu_torch import graft_entry
    from cordum_tpu_torch.models.embedder import Embedder, EmbedderConfig, batch_tokenize
    from cordum_tpu_torch.worker.training import TrainRunner

    ecfg = dc.replace(EmbedderConfig(), dtype=torch.float32)
    w, compute, sched = make_port_worker(torch, dev, "w-graft", chips=n, tp=GRAFT_EMBED_TP,
                                         embedder_cfg=ecfg, batching=False, serving=False,
                                         gang=False, ckpt_root=ckpt_root)
    texts = make_texts(np.random.default_rng(SEED + 15), GRAFT_EMBED_TEXTS, 2, 40)
    from cordum_tpu_torch.parallel.mesh import MeshSpec

    (tp, sp), _ = graft_entry.factor2(n, 2)
    (tp2, ep), _ = graft_entry.factor2(n, 2)
    meshes = {"llama-tiny": {"tp": tp, "sp": sp}, "moe-tiny": {"tp": tp2, "ep": ep},
              "pipeline": {}}
    # the reference's resolution over n cards: the asked axes, dp the rest;
    # the pipeline's pp 2 on an even n
    resolved = {"llama-tiny": MeshSpec(dp=-1, tp=tp, sp=sp).resolve(n),
                "moe-tiny": MeshSpec(dp=-1, tp=tp2, ep=ep).resolve(n),
                "pipeline": MeshSpec(dp=-1, pp=2 if n % 2 == 0 else 1).resolve(n)}
    payloads = [{**GRAFT_TRAIN, "model": m, "dtype": "float32", "mesh": meshes[m]}
                for m in GRAFT_FAMILIES]
    one = Embedder(ecfg, seed=SEED, device=dev)
    whole = one.embed(texts)
    dp = n // compute.tp
    # one card's embeddings of each replica's block: the rows padded to a
    # multiple of n, cut into dp blocks (the worker's split, done here)
    ids, mask = batch_tokenize(texts, ecfg)
    pad = -len(texts) % n
    ids, mask = np.pad(ids, ((0, pad), (0, 0))), np.pad(mask, ((0, pad), (0, 0)))
    rows = len(ids) // dp
    blocks = np.concatenate([one.embed_tokens(ids[i * rows:(i + 1) * rows],
                                              mask[i * rows:(i + 1) * rows])
                             for i in range(dp)])[:len(texts)]
    await sched.start()
    await w.start()
    try:
        zero_launches()
        [(_, doc)] = await sched.run([{"op": "embed", "texts": texts}], "graft-embed")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        embed_launches = read_launches()["embed_attention"]
        got = np.asarray(doc["embeddings"], np.float32)
        err = float(np.abs(got - whole).max())
        if compute.tp != GRAFT_EMBED_TP or not np.array_equal(got, blocks) \
                or not err <= GRAFT_EMBED_ATOL:
            raise AssertionError(
                f"[graft-cards] embed at tp {compute.tp} over {n} cards: against one card's "
                f"embeddings of the same blocks max error "
                f"{float(np.abs(got - blocks).max()):.3e} (exact expected), against one card's "
                f"of the whole batch {err:.3e} (bound {GRAFT_EMBED_ATOL:g})")
        want = graft_embed_launches(dp, ecfg.n_layers)
        if embed_launches != want:
            raise AssertionError(f"[graft-cards] embed: B5 launched {embed_launches} times, "
                                 f"{want} expected ({dp} replicas x {ecfg.n_layers} layers)")
        await w.send_heartbeat()
        hb = sched.heartbeats[-1]
        if hb.chip_count != n:
            raise AssertionError(f"[graft-cards] heartbeat chip_count {hb.chip_count}, "
                                 f"{n} expected")
        log(f"[graft-cards] embed of {len(texts)} texts at WORKER_TP {compute.tp} over {n} "
            f"cards (dp {dp}), fp32: equal to one card's embeddings of the same {rows}-row "
            f"blocks; against one card's {len(texts)}-row batch max error {err:.3e} (bound "
            f"{GRAFT_EMBED_ATOL:g}); B5 {embed_launches} launches; heartbeat chip_count "
            f"{hb.chip_count}  [{card}]")
        trained = [doc_ for _, doc_ in await sched.run(payloads, "graft-train")]
    finally:
        await w.stop()
    runner = TrainRunner(ckpt_root=os.path.join(ckpt_root, "one"), device=dev, ranks=1)
    for payload, out in zip(payloads, trained):
        check_graft_train(out, runner.train(payload), resolved[payload["model"]], "graft-cards")
        log(f"[graft-cards] {payload['model']} on a worker of {n} cards, mesh "
            f"{ {k: v for k, v in out['mesh'].items() if v > 1} }: loss {out['loss_first']:.6f} "
            f"-> {out['final_loss']:.6f}, equal to one card's within {GRAFT_LOSS_REL:g}, "
            f"{out['seconds']:.2f} s  [{card}]")
    return embed_launches


def cards_dryrun_leg(torch, dev, card, n=4):
    """``--cards --legs dryrun``: the multi-rank dry run and a worker that
    owns the host's cards.  First :func:`drive_graft_worker`; then
    ``dryrun_multichip(n)`` over NCCL, one rank a card (``factor2``: at n 4
    dense tp 2 x sp 2, MoE tp 2 x ep 2, pipeline dp 2 x pp 2), the steps
    in bf16 and then in fp32 on the same meshes in one launch: each loss
    finite and equal on every rank, every launch as the design gives; each
    fp32 loss held to the one-process step on card 0
    (:data:`GRAFT_LOSS_REL`).  Returns the launches (the ranks' sums,
    bf16 and fp32, and the embed's)."""
    import tempfile

    from cordum_tpu_torch import graft_entry

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="cordum-graft-") as ckpt_root:
        embed = asyncio.run(drive_graft_worker(torch, dev, card, n, ckpt_root))
    # one rank a card, NCCL; the CPU rehearsal's gloo CPU ranks
    device, collective = (None, "nccl") if dev.type == "cuda" else ("cpu", "gloo")
    results, fp32 = graft_entry.dryrun_multichip(n, device=device,
                                                 dtypes=(None, torch.float32), log=log)
    launches = check_dryrun(results, n, collective=collective, tag="graft-cards")
    for k, v in check_dryrun(fp32, n, collective=collective, tag="graft-cards").items():
        launches[k] += v
    check_graft_losses(fp32, graft_entry.dryrun_one_process(n, device=dev, dtype=torch.float32),
                       "graft-cards", card)
    launches["embed_attention"] = embed
    log(f"[graft-cards] dryrun leg in {time.monotonic() - t0:.1f} s; launches of the dry runs "
        f"and the embed {launches}  [{card}]")
    return launches


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 16: the scheduler service
# ---------------------------------------------------------------------------

#: the pools document phase 16 loads.  config/pools.yaml routes job.tpu.> to
#: a pool that requires ``tpu``, which no port worker advertises: here
#: job.gpu.> goes to pool ``gpu`` (the port's workers run with
#: WORKER_POOL=gpu) and job.batch.> to a second pool of the synthetic fleet
SCHED_POOLS = {"topics": {"job.gpu.>": "gpu", "job.batch.>": "batch"},
               "pools": {"gpu": {"requires": ["gpu"], "min_chips": 1},
                         "batch": {"requires": ["gpu"], "min_chips": 1}}}
#: 16.2's rules, added after config/safety.yaml's own (the first match wins)
SCHED_RULES = (
    {"id": "approve-gpu-generate",
     "match": {"topics": ["job.gpu.llm.generate"], "requires": ["gpu"]},
     "decision": "require_approval", "reason": "generation that asks for a card needs approval"},
    {"id": "deny-exfiltration", "match": {"risk_tags": ["exfiltration"]},
     "decision": "deny", "reason": "exfiltration is never allowed"},
)
#: the reference's DLQ code for a safety denial
SCHED_DENY_CODE = "SAFETY_DENY"
#: 16.3: the synthetic fleet (README's scale), the backlog, its bursts and
#: the C-scan-against-Python picks
SCHED_WORKERS, SCHED_JOBS, SCHED_BURST, SCHED_PICKS = 1000, 20000, 256, 10000
#: the synthetic fleet beats this often (the registry's TTL is 30 s)
SCHED_BEAT_S = 5.0
SCHED_TIMEOUT_S = 300.0
#: 16.3's job shapes: (share, topic, requires); each has eligible workers
SCHED_SHAPES = ((0.45, "job.gpu.echo", ()), (0.25, "job.batch.echo", ()),
                (0.1, "job.gpu.echo", ("chips:4",)), (0.08, "job.batch.echo", ("topology:2x4",)),
                (0.07, "job.gpu.echo", ("fp8",)), (0.05, "job.gpu.echo", ("chips:2", "topology:2x2")))
REPO_DIR = os.path.dirname(os.path.abspath(__file__))


def sched_policy():
    """``config/safety.yaml`` with 16.2's rules after its own."""
    import yaml

    with open(os.path.join(REPO_DIR, "config", "safety.yaml")) as f:
        doc = yaml.safe_load(f) or {}
    doc["rules"] = list(doc.get("rules") or []) + [dict(r) for r in SCHED_RULES]
    return doc


class SchedStack:
    """The port's scheduler as ``cmd/scheduler.py`` builds it by default, in
    this process over ``bus`` and ``kv``: the embedded safety kernel on
    ``policy_doc``, ``ThroughputAwareStrategy`` with its capacity view,
    serving placer and decode rebalancer, and the native scan, which must
    have loaded (a failed build raises while the strategy is built)."""

    def __init__(self, bus, kv, *, policy_doc, pools_doc=SCHED_POOLS):
        from cordum_tpu_torch.controlplane.safetykernel.kernel import SafetyKernel
        from cordum_tpu_torch.controlplane.scheduler.engine import Engine
        from cordum_tpu_torch.controlplane.scheduler.placer import DecodeRebalancer, ServingPlacer
        from cordum_tpu_torch.controlplane.scheduler.safety_client import SafetyClient
        from cordum_tpu_torch.controlplane.scheduler.strategy import ThroughputAwareStrategy
        from cordum_tpu_torch.infra.config import parse_pool_config
        from cordum_tpu_torch.infra.jobstore import JobStore
        from cordum_tpu_torch.infra.memstore import MemoryStore
        from cordum_tpu_torch.infra.metrics import Metrics
        from cordum_tpu_torch.infra.registry import WorkerRegistry
        from cordum_tpu_torch.obs.capacity import CapacityView

        self.bus = bus
        self.registry = WorkerRegistry()
        self.pools = parse_pool_config(pools_doc)
        self.metrics = Metrics()
        self.capacity = CapacityView()
        self.strategy = ThroughputAwareStrategy(
            self.registry, self.pools, capacity=self.capacity,
            placer=ServingPlacer(self.capacity, metrics=self.metrics), metrics=self.metrics)
        self.packed = self.strategy._packed
        if self.packed is None:
            raise AssertionError("the native scan did not load: no C compiler on this host")
        self.rebalancer = DecodeRebalancer.from_config(
            bus, self.capacity, self.registry, self.pools.rebalancer, metrics=self.metrics)
        self.kernel = SafetyKernel(policy_doc=policy_doc)
        self.job_store = JobStore(kv)
        self.mem = MemoryStore(kv)
        self.engine = Engine(bus=bus, job_store=self.job_store,
                             safety=SafetyClient(self.kernel.check), strategy=self.strategy,
                             registry=self.registry, metrics=self.metrics)

    async def start(self):
        await self.kernel.reload()
        await self.capacity.start(self.bus)
        await self.engine.start()
        await self.rebalancer.start()

    async def stop(self):
        await self.rebalancer.stop()
        await self.engine.stop()
        await self.capacity.stop()


async def gateway_submit(stack, job_id, topic, payload, *, requires=(), risk_tags=(),
                         publish=True):
    """Submit a job as the gateway does: the payload into the KV behind a
    context pointer, the ``cordum.op`` label, then the ``JobRequest`` on
    ``sys.job.submit`` (the scheduler writes the PENDING record).  Returns
    the request and its packet (``publish=False`` leaves the publish to the
    caller)."""
    from cordum_tpu_torch.protocol import subjects as subj
    from cordum_tpu_torch.protocol.types import LABEL_OP, BusPacket, JobMetadata, JobRequest
    from cordum_tpu_torch.utils.ids import new_id

    ptr = await stack.mem.put_context(job_id, payload)
    req = JobRequest(job_id=job_id, topic=topic, context_ptr=ptr, tenant_id="default",
                     labels={LABEL_OP: payload["op"]},
                     metadata=JobMetadata(requires=list(requires), risk_tags=list(risk_tags)))
    pkt = BusPacket.wrap(req, trace_id=new_id(), sender_id="gateway")
    if publish:
        await stack.bus.publish(subj.submit_subject_for(job_id, 1), pkt)
    return req, pkt


async def sched_wait(job_store, job_ids, states=None, timeout_s=SCHED_TIMEOUT_S):
    """Each job's state once every one is in ``states`` (default: a
    terminal state); raises naming the jobs still out after
    ``timeout_s``."""
    from cordum_tpu_torch.protocol.types import TERMINAL_STATES

    states = states or tuple(sorted(st.value for st in TERMINAL_STATES))
    deadline = time.monotonic() + timeout_s
    pending, out = list(job_ids), {}
    while pending:
        for jid in list(pending):
            st = await job_store.get_state(jid)
            if st in states:
                out[jid] = st
                pending.remove(jid)
        if pending:
            if time.monotonic() > deadline:
                seen = {j: {k: v for k, v in (await job_store.get_meta(j)).items()
                            if k in ("state", "dispatch_subject", "worker_id")}
                        for j in pending[:5]}
                raise AssertionError(f"{len(pending)} jobs never reached {states}: {seen}")
            await asyncio.sleep(0.005)
    return out


async def sched_job(stack, job_id, topic, payload, **kw):
    """One job through the scheduler to SUCCEEDED; returns its result and
    its meta.  Raises on any other end, or on a missing result pointer."""
    await gateway_submit(stack, job_id, topic, payload, **kw)
    state = (await sched_wait(stack.job_store, [job_id]))[job_id]
    meta = await stack.job_store.get_meta(job_id)
    if state != "SUCCEEDED" or not meta.get("result_ptr"):
        raise AssertionError(f"{job_id}: {state}, meta {meta}")
    return await stack.mem.get_pointer(meta["result_ptr"]), meta


def ran_on(meta, worker_id, topic):
    """The job went to ``worker_id``: dispatched on its direct subject, or
    on the topic it listens to when its heartbeat read overloaded, and its
    result came from it.  Returns whether it went by the topic."""
    from cordum_tpu_torch.protocol.subjects import direct_subject

    subject = meta.get("dispatch_subject")
    if subject not in (direct_subject(worker_id), topic) or meta.get("worker_id") != worker_id:
        raise AssertionError(f"dispatched on {subject}, result from {meta.get('worker_id')}")
    return subject == topic


def sched_payloads(record):
    """16.1's jobs, from phase 6's: (tag, payload) in submission order."""
    return ([("echo", {"op": "echo", "i": i}) for i in range(4)]
            + [("infer", p) for p, _ in record["infer"]]
            + [("embed", p) for p, _ in record["embed1"]]
            + [("gen", p) for p, _ in record["gen"]])


def sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


async def sched_direct_path(torch, dev, dispatcher, record):
    """16.1's yardstick: phase 6's jobs one at a time straight to the
    worker, before the scheduler listens.  Returns the results and the
    launches."""
    zero_launches()
    direct = []
    for tag, payload in sched_payloads(record):
        direct += await dispatcher.run([payload], f"direct16-{tag}")
    sync(torch, dev)
    return [doc for _, doc in direct], read_launches()


async def sched_main_path(torch, dev, stack, worker_id, record, direct, want):
    """16.1: phase 6's jobs one at a time through the scheduler, held to
    the direct path's results ``direct`` and launches ``want``; returns
    the scheduled run's launches and the tokens of each generate prompt."""
    jobs = sched_payloads(record)
    zero_launches()
    got, by_topic = [], 0
    for i, (tag, payload) in enumerate(jobs):
        topic = f"job.gpu.{payload['op']}"
        doc, meta = await sched_job(stack, f"sched16-{i}-{tag}", topic, payload)
        by_topic += ran_on(meta, worker_id, topic)
        got.append(doc)
    sync(torch, dev)
    launches = read_launches()
    embeds = iter(doc for _, doc in record["embed1"])
    tokens = {}
    for (tag, payload), d, g in zip(jobs, direct, got):
        if tag == "echo" and (g["echo"] != payload or g["worker"] != worker_id):
            raise AssertionError(f"scheduled echo: {g}")
        if tag == "infer" and g["next_tokens"] != d["next_tokens"]:
            raise AssertionError(f"scheduled infer {g['next_tokens']}, direct {d['next_tokens']}")
        if tag == "embed":
            six = next(embeds)
            if not (np.array_equal(np.asarray(g["embeddings"]), np.asarray(d["embeddings"]))
                    and np.array_equal(np.asarray(g["embeddings"]),
                                       np.asarray(six["embeddings"]))):
                raise AssertionError("scheduled embeddings differ from the direct and phase 6's")
        if tag == "gen":
            if g["tokens"] != d["tokens"] or not g["tokens"]:
                raise AssertionError(f"scheduled tokens {g['tokens']}, direct {d['tokens']}")
            tokens[tuple(payload["tokens"])] = g["tokens"]
    for name in ("paged_attention", "embed_attention", "dense_attention_fwd"):
        if launches[name] != want[name] or not launches[name]:
            raise AssertionError(f"{name}: {launches[name]} launches through the scheduler, "
                                 f"{want[name]} direct")
    return launches, tokens, by_topic


async def sched_policy_gate(torch, dev, stack, worker_id, gen_payload, want_tokens):
    """16.2: approval, an edit after the decision, a denial.  Returns the
    launches of the approved job."""
    from cordum_tpu_torch.protocol import subjects as subj
    from cordum_tpu_torch.protocol.jobhash import job_hash
    from cordum_tpu_torch.protocol.types import LABEL_APPROVAL_GRANTED, BusPacket

    bus, js = stack.bus, stack.job_store
    topic = "job.gpu.llm.generate"
    parked = {}
    for jid in ("approve16", "edited16"):
        req, _ = await gateway_submit(stack, jid, topic, gen_payload, requires=["gpu"])
        await sched_wait(js, [jid], ("APPROVAL_REQUIRED",))
        rec = await js.get_safety_decision(jid)
        if (rec is None or rec.decision != "REQUIRE_APPROVAL"
                or rec.rule_id != "approve-gpu-generate" or rec.job_hash != job_hash(req)):
            raise AssertionError(f"{jid}: decision record {rec}")
        parked[jid] = req
    zero_launches()
    req = parked["approve16"]
    await bus.publish(subj.SUBMIT, BusPacket.wrap(dataclasses.replace(
        req, labels={**req.labels, LABEL_APPROVAL_GRANTED: "true"}), sender_id="gateway"))
    state = (await sched_wait(js, ["approve16"]))["approve16"]
    meta = await js.get_meta("approve16")
    doc = await stack.mem.get_pointer(meta.get("result_ptr", "")) if meta.get("result_ptr") else None
    sync(torch, dev)
    launches = read_launches()
    if state != "SUCCEEDED" or doc is None or doc["tokens"] != want_tokens:
        raise AssertionError(f"approved job: {state}, {doc}, want {want_tokens}")
    ran_on(meta, worker_id, topic)
    req = parked["edited16"]
    mark = len(bus.published)
    await bus.publish(subj.SUBMIT, BusPacket.wrap(dataclasses.replace(
        req, labels={**req.labels, "note": "edited after approval",
                     LABEL_APPROVAL_GRANTED: "true"}), sender_id="gateway"))
    await asyncio.sleep(0.5)
    await bus.drain()
    state = await js.get_state("edited16")
    sent = [s for s, p in bus.published[mark:]
            if p.job_request is not None and p.job_request.job_id == "edited16"
            and s != subj.SUBMIT]
    if state != "APPROVAL_REQUIRED" or sent:
        raise AssertionError(f"edited job: {state}, dispatched on {sent}")
    stored = await js.get_request("edited16")
    if stored is None or job_hash(stored) != job_hash(req):
        raise AssertionError("the edited republish replaced the parked request")
    mark = len(bus.published)
    await gateway_submit(stack, "deny16", "job.gpu.echo", {"op": "echo"},
                         risk_tags=["exfiltration"])
    state = (await sched_wait(js, ["deny16"]))["deny16"]
    await bus.drain()
    dlq = [p.job_result for s, p in bus.published[mark:] if s == subj.DLQ
           and p.job_result is not None and p.job_result.job_id == "deny16"]
    rec = await js.get_safety_decision("deny16")
    if (state != "DENIED" or len(dlq) != 1 or dlq[0].error_code != SCHED_DENY_CODE
            or rec is None or rec.rule_id != "deny-exfiltration"):
        raise AssertionError(f"denied job: {state}, DLQ {dlq}, decision {rec}")
    return launches


def sched_fleet(n, seed=SEED + 16):
    """``n`` synthetic workers' heartbeats: 7 in 10 in pool ``gpu``, the
    rest in ``batch``; 1-8 cards; no topology, 2x2 or 2x4; load, queue
    depth, capabilities (``fp8`` on some, ``gpu`` missing on a few) and
    health varied."""
    from cordum_tpu_torch.protocol.types import Heartbeat

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        caps = ["gpu", "echo"] + (["fp8"] if rng.random() < 0.3 else [])
        if rng.random() < 0.05:
            caps = ["echo"]
        maxp = int(rng.choice([8, 16, 32, 64]))
        out.append(Heartbeat(
            worker_id=f"syn-{i:04d}", pool="gpu" if i % 10 < 7 else "batch", type="gpu",
            device_kind="H100", capabilities=caps, chip_count=int(rng.choice([1, 2, 4, 8])),
            slice_topology=str(rng.choice(["", "2x2", "2x4"])), max_parallel_jobs=maxp,
            active_jobs=int(rng.integers(0, maxp)), cpu_load=float(rng.uniform(0, 95)),
            tpu_duty_cycle=float(rng.uniform(0, 95)), hbm_total_gb=80.0,
            hbm_used_gb=float(rng.uniform(0, 80)), devices_healthy=bool(rng.random() > 0.02)))
    return out


def sched_requests(n, seed=SEED + 17):
    """``n`` (topic, requires) drawn from ``SCHED_SHAPES``."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(SCHED_SHAPES), size=n, p=[s[0] for s in SCHED_SHAPES])
    return [SCHED_SHAPES[i][1:] for i in idx]


class FleetResponder:
    """The synthetic workers: one subscription a worker on its direct
    subject; each job's result is put in the KV and a ``JobResult``
    published at once.  Counts each job's deliveries.  ``drop`` names jobs
    it swallows (a rehearsal's planted fault)."""

    def __init__(self, bus, mem, heartbeats, *, drop=()):
        self.bus, self.mem, self.heartbeats = bus, mem, heartbeats
        self.drop = set(drop)
        self.delivered: dict[str, int] = {}
        self._subs = []
        self._beat = None

    async def start(self):
        from cordum_tpu_torch.protocol.subjects import direct_subject

        for hb in self.heartbeats:
            self._subs.append(await self.bus.subscribe(
                direct_subject(hb.worker_id), self._handler(hb.worker_id)))
        await self.beat()
        self._beat = asyncio.ensure_future(self._beat_loop())

    async def beat(self):
        from cordum_tpu_torch.protocol import subjects as subj
        from cordum_tpu_torch.protocol.types import BusPacket

        for hb in self.heartbeats:
            await self.bus.publish(subj.HEARTBEAT, BusPacket.wrap(hb, sender_id=hb.worker_id))

    async def _beat_loop(self):
        while True:
            await asyncio.sleep(SCHED_BEAT_S)
            await self.beat()

    def _handler(self, worker_id):
        from cordum_tpu_torch.protocol import subjects as subj
        from cordum_tpu_torch.protocol.types import BusPacket, JobResult

        async def on_job(subject, pkt):
            req = pkt.job_request
            if req is None:
                return
            self.delivered[req.job_id] = self.delivered.get(req.job_id, 0) + 1
            if req.job_id in self.drop:
                return
            payload = await self.mem.get_context(req.context_ptr)
            ptr = await self.mem.put_result(req.job_id, {"echo": payload, "worker": worker_id})
            await self.bus.publish(subj.RESULT, BusPacket.wrap(JobResult(
                job_id=req.job_id, status="SUCCEEDED", result_ptr=ptr, worker_id=worker_id),
                sender_id=worker_id))
        return on_job

    async def stop(self):
        if self._beat is not None:
            self._beat.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._beat
        for sub in self._subs:
            sub.unsubscribe()


async def sched_backlog(stack, n_jobs, burst, *, timeout_s=SCHED_TIMEOUT_S):
    """16.3's backlog: ``n_jobs`` echo jobs of ``SCHED_SHAPES``, ``burst``
    published in one event-loop tick (their records written before), then
    every job waited for in the job store.  Checks each was dispatched
    once and ended SUCCEEDED once; returns the numbers."""
    from cordum_tpu_torch.infra.jobstore import index_key
    from cordum_tpu_torch.protocol import subjects as subj

    js, bus = stack.job_store, stack.bus
    shapes = sched_requests(n_jobs)
    ids = [f"fleet16-{i:05d}" for i in range(n_jobs)]
    mark = len(bus.published)
    picks0, dispatched0 = stack.packed.native_picks, stack.metrics.jobs_dispatched.total()
    done0 = await js.kv.zcard(index_key("SUCCEEDED"))
    sent_at = {}
    for lo in range(0, n_jobs, burst):
        pkts = []
        for jid, (topic, requires) in zip(ids[lo:lo + burst], shapes[lo:lo + burst]):
            _, pkt = await gateway_submit(stack, jid, topic, {"op": "echo", "job": jid},
                                          requires=requires, publish=False)
            pkts.append((jid, pkt))
        now = time.time()
        for jid, pkt in pkts:  # one tick: publish never yields on the loopback bus
            sent_at[jid] = now
            await bus.publish(subj.submit_subject_for(jid, 1), pkt)
        await asyncio.sleep(0)
    deadline = time.monotonic() + timeout_s
    while await js.kv.zcard(index_key("SUCCEEDED")) - done0 < n_jobs:
        if time.monotonic() > deadline:
            break
        await asyncio.sleep(0.02)
    await bus.drain()
    states = await asyncio.gather(*(js.get_state(j) for j in ids))
    lost = [(j, s) for j, s in zip(ids, states) if s != "SUCCEEDED"]
    if lost:
        raise AssertionError(f"{len(lost)} of {n_jobs} jobs did not end SUCCEEDED: {lost[:5]}")
    sent: dict[str, int] = {}
    for s, p in bus.published[mark:]:
        r = p.job_request
        if r is not None and s != subj.SUBMIT and not s.startswith("sys."):
            sent[r.job_id] = sent.get(r.job_id, 0) + 1
    twice = [j for j in ids if sent.get(j) != 1]
    if twice:
        raise AssertionError(f"{len(twice)} jobs not dispatched exactly once: "
                             f"{[(j, sent.get(j)) for j in twice[:5]]}")
    events = await asyncio.gather(*(js.events(j) for j in ids))
    dispatched_at, lat = [], []
    for jid, evs in zip(ids, events):
        ends = [e for e in evs if e.get("state") == "SUCCEEDED"]
        disp = [e for e in evs if e.get("state") == "DISPATCHED"]
        if len(ends) != 1 or len(disp) != 1:
            raise AssertionError(f"{jid}: events {[e.get('state') for e in evs]}")
        dispatched_at.append(disp[0]["ts_us"] / 1e6)
        lat.append((ends[0]["ts_us"] / 1e6 - sent_at[jid]) * 1e3)
    picks = stack.packed.native_picks - picks0
    dispatched = stack.metrics.jobs_dispatched.total() - dispatched0
    first = min(sent_at.values())
    return {"jobs": n_jobs, "scheduled jobs/s": n_jobs / (max(dispatched_at) - first),
            "submit->result p50 ms": float(np.percentile(lat, 50)),
            "submit->result p99 ms": float(np.percentile(lat, 99)),
            "C scan share of picks": picks / dispatched if dispatched else float("nan"),
            "workers": len(stack.registry.snapshot())}


def check_native_picks(registry, pools, n):
    """``n`` picks of the C scan against the Python scan's on ``registry``
    (two ``LeastLoadedStrategy``, native on and off); every pick must be the
    C scan's (no shape of ``SCHED_SHAPES`` falls back) and equal."""
    from cordum_tpu_torch.controlplane.scheduler.strategy import LeastLoadedStrategy
    from cordum_tpu_torch.protocol.types import JobMetadata, JobRequest

    native = LeastLoadedStrategy(registry, pools)
    plain = LeastLoadedStrategy(registry, pools, native=False)
    if native._packed is None:
        raise AssertionError("the native scan did not load")
    picks0 = native._packed.native_picks
    wrong = []
    for i, (topic, requires) in enumerate(sched_requests(n, seed=SEED + 18)):
        req = JobRequest(job_id=f"pick-{i}", topic=topic,
                         metadata=JobMetadata(requires=list(requires)))
        a, b = native.pick_subject(req), plain.pick_subject(req)
        if a != b:
            wrong.append((topic, requires, a, b))
    served = native._packed.native_picks - picks0
    if wrong or served != n:
        raise AssertionError(f"C scan against Python: {len(wrong)} of {n} picks differ "
                             f"{wrong[:3]}; the C scan served {served}")
    return served


async def sched_cluster(stack, *, n_workers=SCHED_WORKERS, n_jobs=SCHED_JOBS,
                        burst=SCHED_BURST, n_picks=SCHED_PICKS, drop=(),
                        timeout_s=SCHED_TIMEOUT_S):
    """16.3: the fleet beside the card's worker, the backlog, then the C
    scan against the Python scan on the same registry."""
    fleet = FleetResponder(stack.bus, stack.mem, sched_fleet(n_workers), drop=drop)
    await fleet.start()
    try:
        await stack.bus.drain()
        numbers = await sched_backlog(stack, n_jobs, burst, timeout_s=timeout_s)
        numbers["native picks checked"] = check_native_picks(stack.registry, stack.pools,
                                                             n_picks)
    finally:
        await fleet.stop()
    return numbers


async def phase_scheduler(torch, dev, card, w, dispatcher, record, *, out=None, **cluster_kw):
    """16.1-16.3 on phase 6's bf16 worker ``w``; returns the launches of
    16.1's scheduled jobs and 16.2's approved one, and 16.3's numbers
    (``cluster_kw`` sizes 16.3 for a rehearsal).  ``out``, when given,
    receives 16.1's tokens of each generate prompt, scheduled and direct,
    and its launches, scheduled and direct (phase 17 is held to them)."""
    from cordum_tpu_torch.infra.kv import MemoryKV

    kv = dispatcher.store.kv
    if not isinstance(kv, MemoryKV):
        raise AssertionError("phase 16 shares phase 6's in-process KV")
    direct, want = await sched_direct_path(torch, dev, dispatcher, record)
    stack = SchedStack(w.bus, kv, policy_doc=sched_policy())
    await stack.start()
    try:
        t0 = time.monotonic()
        while stack.registry.get(w.worker_id) is None:
            if time.monotonic() - t0 > 30:
                raise AssertionError("the scheduler never heard the card worker's heartbeat")
            await asyncio.sleep(0.05)
        t0 = time.monotonic()
        main, tokens, by_topic = await sched_main_path(torch, dev, stack, w.worker_id, record,
                                                       direct, want)
        main_s = time.monotonic() - t0
        if out is not None:
            gens = [(p, d) for (tag, p), d in zip(sched_payloads(record), direct) if tag == "gen"]
            out.update(tokens=tokens, main=main, want=want,
                       direct_tokens={tuple(p["tokens"]): d["tokens"] for p, d in gens})
        gen = record["gen"][0][0]
        gate = await sched_policy_gate(torch, dev, stack, w.worker_id, gen,
                                       tokens[tuple(gen["tokens"])])
        t0 = time.monotonic()
        zero_launches()
        cluster = await sched_cluster(stack, **cluster_kw)
        sync(torch, dev)
        # echo jobs only: no kernel of the port runs while 16.3 schedules
        cluster["kernel launches"] = sum(read_launches().values())
        cluster_s = time.monotonic() - t0
    finally:
        await stack.stop()
    launches = {k: main[k] + gate[k] for k in main}
    log(f"[sched] 16.1: {len(sched_payloads(record))} jobs of phase 6 through the port's "
        f"scheduler (embedded safety kernel, ThroughputAwareStrategy, native scan) to the card's "
        f"worker in {main_s:.1f} s ({by_topic} by its topic: its heartbeat read overloaded): "
        f"results equal to the direct path's, launches equal "
        f"(paged_attention {main['paged_attention']}, embed_attention "
        f"{main['embed_attention']}, dense_attention_fwd {main['dense_attention_fwd']})  [{card}]")
    log(f"[sched] 16.2: approval parked and released with 16.1's tokens (paged_attention "
        f"{gate['paged_attention']}), an edit after approval refused by the hash check, "
        f"a denial to the DLQ with {SCHED_DENY_CODE}  [{card}]")
    log(f"[sched] 16.3: {cluster['jobs']} echo jobs over {cluster['workers']} live workers "
        f"in bursts of {cluster_kw.get('burst', SCHED_BURST)}, each dispatched once and SUCCEEDED once, in "
        f"{cluster_s:.1f} s; {cluster['native picks checked']} C-scan picks equal to the "
        f"Python scan's  [{card}]")
    log("[sched] 16.3 (information): " + ", ".join(
        f"{k} {v!r}" for k, v in cluster.items()) + f"  [{card}]")
    return launches, cluster


async def wait_log(path, text, proc, timeout_s=120.0):
    """Wait until the process's log at ``path`` holds ``text``."""
    deadline = time.monotonic() + timeout_s
    while True:
        with open(path) as f:
            if text in f.read():
                return
        if proc.poll() is not None or time.monotonic() > deadline:
            raise AssertionError(f"{text!r} never appeared (rc {proc.poll()}); see {path}")
        await asyncio.sleep(0.1)


def sched_process_jobs(record):
    """16.4's jobs, from phase 8's: (tag, topic, payload)."""
    return ([("echo", "job.gpu.echo", {"op": "echo", "i": i}) for i in range(4)]
            + [("infer", "job.gpu.infer", p) for p, _ in record["infer"]]
            + [("embed", "job.gpu.embed", p) for p, _ in record["embed1"]]
            + [("gen", "job.gpu.llm.generate", p) for p, _ in record["gen"]])


async def drive_scheduler_process(torch, dev, card, workdir, record, *, timeout_s=300.0):
    """16.4: the port's statebus, scheduler and worker binaries as
    processes over TCP (pools ``SCHED_POOLS``, policy
    ``config/safety.yaml``, the worker at phase 8's config with
    ``WORKER_POOL=gpu``); this script submits as the gateway does, over the
    port's statebus client.  ``record`` holds phase 8's jobs and results
    (``infer``, ``embed1`` and ``gen`` as (payload, result) pairs, ``ties``
    each generate prompt's near-tie positions).  Returns the scheduler's
    exit code and the worker's exit record; every process is stopped on
    every path."""
    import yaml

    from cordum_tpu_torch.infra import statebus
    from cordum_tpu_torch.infra.jobstore import JobStore
    from cordum_tpu_torch.infra.memstore import MemoryStore
    from cordum_tpu_torch.protocol import subjects as subj

    port = free_port()
    url = f"statebus://127.0.0.1:{port}"
    pools = os.path.join(workdir, "pools.yaml")
    with open(pools, "w") as f:
        yaml.safe_dump(SCHED_POOLS, f)
    env = {**os.environ, "STATEBUS_PORT": str(port), "CORDUM_STATEBUS_URL": url,
           "POOL_CONFIG_PATH": pools,
           "SAFETY_POLICY_PATH": os.path.join(REPO_DIR, "config", "safety.yaml"),
           "TIMEOUT_CONFIG_PATH": os.path.join(REPO_DIR, "config", "timeouts.yaml"),
           "WORKER_ID": "w-sched", "WORKER_POOL": "gpu", "WORKER_LLAMA_DTYPE": "float32",
           "WORKER_MAX_BATCH_SIZE": "256", "WORKER_HEARTBEAT_INTERVAL": "1",
           "CORDUM_LOG_FORMAT": "json", "PYTHONDONTWRITEBYTECODE": "1"}
    for k in ("CORDUM_FORCE_CPU", "SAFETY_KERNEL_ADDR", "WORKER_TOPICS", "WORKER_CAPABILITIES"):
        env.pop(k, None)
    if torch.device(dev).type == "cpu":
        env["CORDUM_FORCE_CPU"] = "1"
    logs = {name: os.path.join(workdir, f"{name}.log")
            for name in ("statebus", "scheduler", "worker")}
    procs = {"statebus": start_process(["cordum_tpu_torch.cmd.statebus"], env, logs["statebus"])}
    conn = None
    try:
        kv, bus, conn = await connect_when_up(statebus, url, procs["statebus"])
        stack = types.SimpleNamespace(bus=bus, job_store=JobStore(kv), mem=MemoryStore(kv))
        beats = []

        async def on_beat(subject, pkt):
            if pkt.heartbeat is not None and pkt.heartbeat.worker_id == "w-sched":
                beats.append(pkt.heartbeat)

        await bus.subscribe(subj.HEARTBEAT, on_beat)
        procs["scheduler"] = start_process(["cordum_tpu_torch.cmd.scheduler"], env,
                                           logs["scheduler"])
        await wait_log(logs["scheduler"], '"scheduler running"', procs["scheduler"])
        procs["worker"] = start_process(["cordum_tpu_torch.cmd.worker"], env, logs["worker"])
        t0 = time.monotonic()
        while not beats:
            if procs["worker"].poll() is not None or time.monotonic() - t0 > timeout_s:
                raise AssertionError(f"the worker process never beat; see {logs['worker']}")
            await asyncio.sleep(0.1)
        await asyncio.sleep(1.5)  # the scheduler hears the same heartbeat
        jobs = sched_process_jobs(record)
        ids = [f"proc16-{i}-{tag}" for i, (tag, _, _) in enumerate(jobs)]
        t0 = time.monotonic()
        for jid, (tag, topic, payload) in zip(ids, jobs):
            if tag == "embed":  # one at a time, as phase 8 ran them
                await sched_job(stack, jid, topic, payload)
            else:
                await gateway_submit(stack, jid, topic, payload)
        states = await sched_wait(stack.job_store, ids, timeout_s=timeout_s)
        wall = time.monotonic() - t0
        metas = [await stack.job_store.get_meta(j) for j in ids]
        docs = [await stack.mem.get_pointer(m["result_ptr"]) if m.get("result_ptr") else None
                for m in metas]
        rc = stop_process(procs["scheduler"])
        wrc = stop_process(procs["worker"])
    finally:
        if conn is not None:
            await conn.close()
        for proc in procs.values():
            stop_process(proc)
    bad = {j: s for j, s in states.items() if s != "SUCCEEDED"}
    if bad or any(d is None for d in docs):
        raise AssertionError(f"jobs through the scheduler process: {bad}; see {logs}")
    by_topic = sum(ran_on(m, "w-sched", topic) for m, (_, topic, _) in zip(metas, jobs))
    if rc != 0:
        raise AssertionError(f"SIGTERM: the scheduler exited {rc}; see {logs['scheduler']}")
    with open(logs["scheduler"]) as f:
        if "native strategy scan loaded" not in f.read():
            raise AssertionError(f"the scheduler process did not load the native scan; "
                                 f"see {logs['scheduler']}")
    exit_doc = worker_exit_line(logs["worker"])
    if wrc != 0 or exit_doc.get("cancelled_sessions") != 0:
        raise AssertionError(f"SIGTERM: the worker exited {wrc}, {exit_doc}")
    ties_n = check_process_docs(jobs, docs, record, "w-sched", "the scheduler process")
    log(f"[sched-proc] 16.4: statebus, scheduler and worker processes over TCP: {len(jobs)} "
        f"jobs ({', '.join(sorted(set(t for t, _, _ in jobs)))}) SUCCEEDED through "
        f"the scheduler in {wall:.1f} s ({by_topic} by the worker's topic) with phase 8's "
        f"results ({ties_n} near-tie positions); "
        f"SIGTERM: scheduler exit {rc}, worker exit {wrc}  [{card}]")
    return rc, exit_doc


def check_process_docs(jobs, docs, record, worker_id, what):
    """16.4's jobs' results ``docs`` against phase 8's ``record``: echoes
    from ``worker_id``, next tokens and one-text embeddings equal, tokens
    under the near-tie rule.  Returns the number of near-tie positions."""
    infer8 = iter(doc for _, doc in record["infer"])
    embed8 = iter(doc for _, doc in record["embed1"])
    gen8 = iter(zip(record["gen"], record["ties"]))
    ties_n = 0
    for (tag, _, payload), doc in zip(jobs, docs):
        if tag == "echo" and (doc["echo"] != payload or doc["worker"] != worker_id):
            raise AssertionError(f"echo through {what}: {doc}")
        if tag == "infer" and doc["next_tokens"] != next(infer8)["next_tokens"]:
            raise AssertionError(f"infer through {what}: {doc}")
        if tag == "embed" and not np.array_equal(np.asarray(doc["embeddings"]),
                                                 np.asarray(next(embed8)["embeddings"])):
            raise AssertionError(f"embeddings through {what} differ from phase 8's")
        if tag == "gen":
            (_, want), ties = next(gen8)
            ties_n += len(ties)
            compare_near_tie(doc["tokens"], want["tokens"], ties, f"generate through {what}")
    return ties_n


def check_sched_process_launches(exit_doc, n_layers, n_layers_embed):
    """16.4's worker process launched B1 once a layer a serving step and
    B5 once a layer a flush."""
    launches, steps = exit_doc["kernel_launches"], exit_doc["serving_steps"]
    if not (launches["paged_attention"] == n_layers * steps > 0
            and launches["embed_attention"] > 0
            and launches["embed_attention"] % n_layers_embed == 0):
        raise AssertionError(f"scheduler-process worker launches {launches} ({steps} steps)")
    return launches


def phase_scheduler_process(torch, dev, card, record8):
    """16.4 on the card; returns the worker process's launches."""
    import tempfile

    from cordum_tpu_torch.models import llama
    from cordum_tpu_torch.models.embedder import EmbedderConfig

    with tempfile.TemporaryDirectory(prefix="cordum-sched-") as workdir:
        _, exit_doc = asyncio.run(drive_scheduler_process(torch, dev, card, workdir, record8))
    return check_sched_process_launches(exit_doc, llama.LlamaConfig.tiny().n_layers,
                                        EmbedderConfig().n_layers)


# ---------------------------------------------------------------------------
# phase 17: the API gateway
# ---------------------------------------------------------------------------

#: the context service's embed topic (``BusEmbedder``'s default, the
#: reference's); phase 17's pools route it to pool ``gpu`` with phase 16's
GATEWAY_EMBED_TOPIC = "job.tpu.embed"
GATEWAY_POOLS = {"topics": {**SCHED_POOLS["topics"], "job.tpu.>": "gpu"},
                 "pools": SCHED_POOLS["pools"]}
GATEWAY_KEY, GATEWAY_ADMIN_KEY = "phase17-key", "phase17-admin"
#: 17.2: chunks of one embed job (``BusEmbedder`` sends 16 texts a job),
#: then the chunks behind the embeds/s reading
GATEWAY_CHUNKS, GATEWAY_EMBED_TEXTS = 16, 256
#: 17.3: the backlog (a quarter of 16.3's, cut for the time limit) and the
#: bulk route's batch (the gateway's ``MAX_BULK_JOBS``)
GATEWAY_JOBS, GATEWAY_BULK = 5000, 256
GATEWAY_TIMEOUT_S = 300.0
GATEWAY_QUERY = "which agent recalls the workflow context"


class GatewayStack:
    """The port's gateway as ``cmd/gateway.py`` builds it, in this process
    over ``bus`` and ``kv``: the embedded ``SafetyKernel`` on
    ``policy_doc``, the embedded workflow engine and the ``ContextService``
    whose embedder is a ``BusEmbedder``; beside it the workflow engine's
    result service as ``cmd/workflow_engine.py`` builds it."""

    def __init__(self, bus, kv, *, policy_doc):
        from cordum_tpu_torch.context.service import BusEmbedder, ContextService
        from cordum_tpu_torch.controlplane.gateway.app import Gateway
        from cordum_tpu_torch.controlplane.gateway.auth import BasicAuthProvider
        from cordum_tpu_torch.controlplane.safetykernel.kernel import SafetyKernel
        from cordum_tpu_torch.controlplane.workflowengine.service import WorkflowEngineService
        from cordum_tpu_torch.infra.configsvc import ConfigService
        from cordum_tpu_torch.infra.jobstore import JobStore
        from cordum_tpu_torch.infra.memstore import MemoryStore
        from cordum_tpu_torch.infra.metrics import Metrics
        from cordum_tpu_torch.infra.registry import WorkerRegistry
        from cordum_tpu_torch.infra.schemareg import SchemaRegistry
        from cordum_tpu_torch.workflow.engine import Engine as WorkflowEngine
        from cordum_tpu_torch.workflow.store import WorkflowStore

        configsvc = ConfigService(kv)
        self.kernel = SafetyKernel(policy_doc=policy_doc, configsvc=configsvc)
        self.mem, self.kv = MemoryStore(kv), kv
        wf_store, schemas = WorkflowStore(kv), SchemaRegistry(kv)
        self.embedders = [BusEmbedder(bus, self.mem), BusEmbedder(bus, self.mem)]
        self.context = ContextService(kv, embedder=self.embedders[0])
        metrics = Metrics()
        wf_engine = WorkflowEngine(store=wf_store, bus=bus, mem=self.mem, schemas=schemas,
                                   configsvc=configsvc, instance_id="gateway-wf",
                                   metrics=metrics, context_svc=self.context)
        self.gateway = Gateway(
            kv=kv, bus=bus, job_store=JobStore(kv), mem=self.mem, kernel=self.kernel,
            metrics=metrics, wf_store=wf_store, wf_engine=wf_engine, schemas=schemas,
            configsvc=configsvc, registry=WorkerRegistry(), context_svc=self.context,
            auth=BasicAuthProvider([GATEWAY_KEY], admin_keys=[GATEWAY_ADMIN_KEY]))
        self.wf_service = WorkflowEngineService(
            engine=WorkflowEngine(store=wf_store, bus=bus, mem=self.mem, schemas=schemas,
                                  configsvc=configsvc, metrics=Metrics(),
                                  context_svc=ContextService(kv, embedder=self.embedders[1])),
            bus=bus, job_store=JobStore(kv))
        self.port = free_port()
        self.url = f"http://127.0.0.1:{self.port}"

    async def start(self):
        await self.kernel.reload()
        await self.wf_service.start()
        await self.gateway.start("127.0.0.1", self.port)

    async def stop(self):
        await self.gateway.stop()
        await self.wf_service.stop()
        for e in self.embedders:
            await e.stop()


class GatewayClient:
    """An HTTP client of the gateway at ``url`` (aiohttp, one session)."""

    def __init__(self, url, key=GATEWAY_KEY):
        self.url, self.key = url, key
        self.http = None

    async def __aenter__(self):
        import aiohttp

        self.http = aiohttp.ClientSession(headers={"X-Api-Key": self.key},
                                          timeout=aiohttp.ClientTimeout(total=GATEWAY_TIMEOUT_S))
        return self

    async def __aexit__(self, *exc):
        await self.http.close()

    async def call(self, method, path, want=200, **kw):
        async with self.http.request(method, self.url + path, **kw) as r:
            doc = await r.json()
            if r.status != want:
                raise AssertionError(f"{method} {path}: {r.status} {doc}")
            return doc

    async def submit(self, job_id, topic, payload, **body):
        doc = await self.call("POST", "/api/v1/jobs", 202, json={
            "job_id": job_id, "topic": topic, "payload": payload, **body})
        if doc.get("job_id") != job_id or doc.get("state") != "PENDING":
            raise AssertionError(f"submit {job_id}: {doc}")
        return doc

    async def wait_job(self, job_id, timeout_s=GATEWAY_TIMEOUT_S):
        """The job's document once it is terminal (its result and events
        read back through the gateway); raises unless it SUCCEEDED."""
        deadline = time.monotonic() + timeout_s
        while True:
            doc = await self.call("GET", f"/api/v1/jobs/{job_id}?result=true&events=true")
            if doc.get("state") in ("SUCCEEDED", "FAILED", "DENIED", "CANCELLED", "TIMEOUT"):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"{job_id} not terminal after {timeout_s} s: {doc}")
            await asyncio.sleep(0.01)
        if doc["state"] != "SUCCEEDED" or "result" not in doc:
            raise AssertionError(f"{job_id}: {doc}")
        once = [sum(e.get("state") == s for e in doc["events"]) for s in ("DISPATCHED", "SUCCEEDED")]
        if once != [1, 1]:
            raise AssertionError(f"{job_id}: dispatched and SUCCEEDED {once} times")
        return doc

    async def run_workflow(self, wf, run_input, timeout_s=GATEWAY_TIMEOUT_S):
        """Register ``wf``, start a run and wait for its end; returns the
        run's document (raises unless it SUCCEEDED)."""
        await self.call("POST", "/api/v1/workflows", 201, json=wf)
        run_id = (await self.call("POST", f"/api/v1/workflows/{wf['id']}/runs", 202,
                                  json={"input": run_input}))["run_id"]
        deadline = time.monotonic() + timeout_s
        while True:
            run = await self.call("GET", f"/api/v1/runs/{run_id}")
            if run["status"] in ("SUCCEEDED", "FAILED", "CANCELLED"):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"run {run_id} not done after {timeout_s} s: {run}")
            await asyncio.sleep(0.02)
        if run["status"] != "SUCCEEDED":
            raise AssertionError(f"run {run_id}: {run['status']} {run.get('error')} "
                                 f"{ {k: s.get('error') for k, s in run['steps'].items()} }")
        return run


def context_workflow(wf_id, texts, prompt, n_new):
    """17.2's agent loop: index ``texts`` in the run's memory, read a RAG
    window for ``GATEWAY_QUERY``, then generate from ``prompt``."""
    return {"id": wf_id, "name": "phase 17 agent loop", "steps": {
        "remember": {"topic": "job.gpu.context", "input": {
            "op": "context.update", "user_payload": GATEWAY_QUERY,
            "chunks": [{"file_path": f"doc{i}", "content": t} for i, t in enumerate(texts)]}},
        "recall": {"topic": "job.gpu.context", "depends_on": ["remember"], "input": {
            "op": "context.window", "mode": "RAG", "query": GATEWAY_QUERY}},
        "answer": {"topic": "job.gpu.llm.generate", "depends_on": ["recall"], "input": {
            "op": "llm.generate", "tokens": prompt, "max_new_tokens": n_new}}}}


async def stored_vectors(kv, memory_id, texts):
    """The context service's vectors of chunks ``texts`` (``doc<i>``) in
    ``memory_id``, as it stored them in the KV."""
    from cordum_tpu_torch.context.service import _chunk_hash

    out = []
    for i, t in enumerate(texts):
        b = await kv.get(f"mem:{memory_id}:embed:{_chunk_hash({'file_path': f'doc{i}', 'content': t})}")
        if b is None:
            raise AssertionError(f"{memory_id}: chunk doc{i} was never embedded")
        out.append(np.frombuffer(b, np.float32))
    return np.stack(out)


def check_window(window, chunk_vecs, query_vec, texts):
    """The RAG window's chunks are the top ten by cosine to the query, in
    order, with the scores the service prints; the query ends it."""
    q = np.asarray(query_vec, np.float32)
    scores = [float(q @ v) / (float(np.linalg.norm(q) * np.linalg.norm(v)) or 1.0)
              for v in chunk_vecs]
    order = sorted(range(len(texts)), key=lambda i: scores[i], reverse=True)[:10]
    rag = [m for m in window if m["source"].startswith("rag:")]
    want = [(f"[doc{i}] {texts[i]}", f"rag:{scores[i]:.3f}") for i in order]
    if [(m["content"], m["source"]) for m in rag] != want or window[-1]["content"] != GATEWAY_QUERY:
        raise AssertionError(f"RAG window {[(m['content'][:20], m['source']) for m in window]}, "
                             f"want {[(c[:20], s) for c, s in want]}")


async def gateway_generate(client, record, seen):
    """17.1: phase 6's generate jobs over HTTP, one at a time; returns the
    launches.  Tokens equal 16.1's scheduled and direct tokens, B1's
    launches 16.1's."""
    zero_launches()
    for i, (payload, _) in enumerate(record["gen"]):
        jid = f"gw17-gen-{i}"
        await client.submit(jid, "job.gpu.llm.generate", payload)
        doc = await client.wait_job(jid)
        key = tuple(payload["tokens"])
        if not (doc["result"]["tokens"] == seen["tokens"][key] == seen["direct_tokens"][key]):
            raise AssertionError(f"{jid}: tokens {doc['result']['tokens']} over HTTP, 16.1 "
                                 f"scheduled {seen['tokens'][key]}, direct "
                                 f"{seen['direct_tokens'][key]}")
    return read_launches()


async def gateway_context(torch, dev, stack, client, compute, record, direct):
    """17.2: chunks and a window over HTTP, then the agent-loop workflow,
    then 256 chunks for embeds/s.  ``direct`` holds the chunk texts, their
    vectors and the query's from embed jobs sent straight to the worker,
    and those jobs' launches.  Returns the launches and the numbers."""
    texts, vecs, qvec, want = direct
    zero_launches()
    doc = await client.call("PUT", "/api/v1/context/chunks/gw17", json={
        "chunks": [{"file_path": f"doc{i}", "content": t} for i, t in enumerate(texts)]})
    window = (await client.call("POST", "/api/v1/context/window", json={
        "memory_id": "gw17", "mode": "RAG", "payload": GATEWAY_QUERY}))["messages"]
    sync(torch, dev)
    http = read_launches()
    got = await stored_vectors(stack.kv, "gw17", texts)
    if doc != {"embedded": len(texts)} or not np.array_equal(got, vecs):
        raise AssertionError(f"chunk vectors over HTTP differ from the direct embed job's "
                             f"(max {float(np.abs(got - vecs).max()):.3e}); {doc}")
    check_window(window, got, qvec, texts)
    if http["embed_attention"] != want["embed_attention"] or not http["embed_attention"]:
        raise AssertionError(f"embed_attention: {http['embed_attention']} launches over HTTP, "
                             f"{want['embed_attention']} direct")
    gen_payload = record["gen"][0][0]
    zero_launches()
    run = await client.run_workflow(
        context_workflow("agent17", texts, gen_payload["tokens"], gen_payload["max_new_tokens"]),
        {})
    sync(torch, dev)
    flow = read_launches()
    memory = run["context"]["steps"]["remember"]["memory_id"]
    recall = run["context"]["steps"]["recall"]
    tokens = run["context"]["steps"]["answer"].get("tokens") or []
    if not np.array_equal(await stored_vectors(stack.kv, memory, texts), vecs):
        raise AssertionError("the workflow's chunk vectors differ from the direct embed job's")
    check_window(recall["messages"], vecs, qvec, texts)
    if (flow["embed_attention"] != want["embed_attention"] or not flow["paged_attention"]
            or len(tokens) != gen_payload["max_new_tokens"]):
        raise AssertionError(f"agent loop: launches {flow}, {len(tokens)} tokens")
    rng = np.random.default_rng(SEED + 18)
    many = make_texts(rng, GATEWAY_EMBED_TEXTS, 70, 126)
    zero_launches()
    jobs0 = stack.embedders[0].jobs_total
    t0 = time.monotonic()
    await client.call("PUT", "/api/v1/context/chunks/gw17-many", json={
        "chunks": [{"file_path": f"doc{i}", "content": t} for i, t in enumerate(many)]})
    wall = time.monotonic() - t0
    sync(torch, dev)
    bulk = read_launches()
    err = float(np.abs(await stored_vectors(stack.kv, "gw17-many", many)
                       - plain_embeddings(torch, compute.embedder, many)).max())
    if not err <= EMBED_ATOL["bfloat16"] or not bulk["embed_attention"]:
        raise AssertionError(f"256 chunks over HTTP: max abs err {err}, launches {bulk}")
    launches = {k: http[k] + flow[k] + bulk[k] for k in http}
    return launches, {"context embeds/s": len(many) / wall,
                      "context embed jobs": stack.embedders[0].jobs_total - jobs0,
                      "embed max abs err": err, "workflow memory": memory,
                      "window messages": len(window)}


async def gateway_backlog(stack, client, n_jobs, *, timeout_s=SCHED_TIMEOUT_S):
    """17.3's backlog over ``POST /api/v1/jobs:batch``; checks each job was
    accepted, dispatched once and SUCCEEDED once; returns the numbers."""
    from cordum_tpu_torch.infra.jobstore import index_key
    from cordum_tpu_torch.protocol import subjects as subj

    js, bus = stack.job_store, stack.bus
    shapes = sched_requests(n_jobs, seed=SEED + 19)
    ids = [f"fleet17-{i:05d}" for i in range(n_jobs)]
    mark = len(bus.published)
    done0 = await js.kv.zcard(index_key("SUCCEEDED"))
    t0 = time.time()
    for lo in range(0, n_jobs, GATEWAY_BULK):
        batch = [{"job_id": jid, "topic": topic, "payload": {"op": "echo", "job": jid},
                  "metadata": {"requires": list(requires)}}
                 for jid, (topic, requires) in zip(ids[lo:lo + GATEWAY_BULK],
                                                   shapes[lo:lo + GATEWAY_BULK])]
        doc = await client.call("POST", "/api/v1/jobs:batch", 202, json={"jobs": batch})
        if doc["accepted"] != len(batch):
            raise AssertionError(f"bulk submit: {doc['rejected']} of {len(batch)} rejected: "
                                 f"{[j for j in doc['jobs'] if 'error' in j][:3]}")
    accepted_s = time.time() - t0
    deadline = time.monotonic() + timeout_s
    while await js.kv.zcard(index_key("SUCCEEDED")) - done0 < n_jobs:
        if time.monotonic() > deadline:
            break
        await asyncio.sleep(0.02)
    await bus.drain()
    states = await asyncio.gather(*(js.get_state(j) for j in ids))
    lost = [(j, s) for j, s in zip(ids, states) if s != "SUCCEEDED"]
    if lost:
        raise AssertionError(f"{len(lost)} of {n_jobs} jobs did not end SUCCEEDED: {lost[:5]}")
    sent: dict[str, int] = {}
    for s, p in bus.published[mark:]:
        r = p.job_request
        if r is not None and not s.startswith("sys."):
            sent[r.job_id] = sent.get(r.job_id, 0) + 1
    twice = [j for j in ids if sent.get(j) != 1]
    if twice:
        raise AssertionError(f"{len(twice)} jobs not dispatched exactly once: "
                             f"{[(j, sent.get(j)) for j in twice[:5]]}")
    events = await asyncio.gather(*(js.events(j) for j in ids))
    dispatched_at, lat, e2e = [], [], []
    for jid, evs in zip(ids, events):
        ends = [e for e in evs if e.get("state") == "SUCCEEDED"]
        disp = [e for e in evs if e.get("state") == "DISPATCHED"]
        subm = [e for e in evs if e.get("event") == "submit"]
        if len(ends) != 1 or len(disp) != 1 or len(subm) != 1:
            raise AssertionError(f"{jid}: events {[(e.get('state'), e.get('event')) for e in evs]}")
        dispatched_at.append(disp[0]["ts_us"] / 1e6)
        lat.append((ends[0]["ts_us"] - disp[0]["ts_us"]) / 1e3)
        e2e.append((ends[0]["ts_us"] - subm[0]["ts_us"]) / 1e3)
    return {"jobs": n_jobs, "accepted jobs/s": n_jobs / accepted_s,
            "scheduled jobs/s": n_jobs / (max(dispatched_at) - t0),
            "dispatch->result p50 ms": float(np.percentile(lat, 50)),
            "dispatch->result p99 ms": float(np.percentile(lat, 99)),
            "submit->result p50 ms": float(np.percentile(e2e, 50)),
            "submit->result p99 ms": float(np.percentile(e2e, 99)),
            "workers": len(stack.registry.snapshot())}


async def phase_gateway(torch, dev, card, w, dispatcher, compute, record, seen, *,
                        n_workers=SCHED_WORKERS, n_jobs=GATEWAY_JOBS, n_chunks=GATEWAY_CHUNKS,
                        timeout_s=SCHED_TIMEOUT_S):
    """17.1-17.3 on phase 6's bf16 worker ``w`` after phase 16 (``seen``
    holds 16.1's tokens and launches); returns the launches of 17.1 and
    17.2 and the numbers."""
    from cordum_tpu_torch.infra.kv import MemoryKV

    kv = dispatcher.store.kv
    if not isinstance(kv, MemoryKV):
        raise AssertionError("phase 17 shares phase 6's in-process KV")
    rng = np.random.default_rng(SEED + 17)
    texts = make_texts(rng, n_chunks, 8, 60)
    # the yardstick, before any scheduler listens: the chunks' embed job and
    # the query's, straight to the worker, one at a time
    zero_launches()
    (_, chunk_doc), = await dispatcher.run([{"op": "embed", "texts": texts}], "direct17")
    (_, query_doc), = await dispatcher.run([{"op": "embed", "texts": [GATEWAY_QUERY]}], "direct17")
    sync(torch, dev)
    direct = (texts, np.asarray(chunk_doc["embeddings"], np.float32),
              np.asarray(query_doc["embeddings"], np.float32)[0], read_launches())
    stack = SchedStack(w.bus, kv, policy_doc=sched_policy(), pools_doc=GATEWAY_POOLS)
    gw = GatewayStack(w.bus, kv, policy_doc=sched_policy())
    await stack.start()
    fleet = None
    try:
        await gw.start()
        t0 = time.monotonic()
        while stack.registry.get(w.worker_id) is None:
            if time.monotonic() - t0 > 30:
                raise AssertionError("the scheduler never heard the card worker's heartbeat")
            await asyncio.sleep(0.05)
        async with GatewayClient(gw.url) as client:
            t0 = time.monotonic()
            gen = await gateway_generate(client, record, seen)
            gen_s = time.monotonic() - t0
            if gen["paged_attention"] != seen["main"]["paged_attention"] or not gen["paged_attention"]:
                raise AssertionError(f"paged_attention: {gen['paged_attention']} launches over "
                                     f"HTTP, {seen['main']['paged_attention']} in 16.1")
            ctx, ctx_numbers = await gateway_context(torch, dev, gw, client, compute, record,
                                                     direct)
            fleet = FleetResponder(stack.bus, stack.mem, sched_fleet(n_workers))
            await fleet.start()
            await stack.bus.drain()
            zero_launches()
            t0 = time.monotonic()
            backlog = await gateway_backlog(stack, client, n_jobs, timeout_s=timeout_s)
            backlog_s = time.monotonic() - t0
            sync(torch, dev)
            backlog["kernel launches"] = sum(read_launches().values())
    finally:
        if fleet is not None:
            await fleet.stop()
        await gw.stop()
        await stack.stop()
    launches = {k: gen[k] + ctx[k] for k in gen}
    numbers = {**backlog, **{k: v for k, v in ctx_numbers.items() if k != "workflow memory"}}
    log(f"[gateway] 17.1: {len(record['gen'])} llm.generate jobs of phase 6 over HTTP through "
        f"the port's gateway and scheduler in {gen_s:.1f} s: tokens equal to 16.1's scheduled "
        f"and direct tokens, paged_attention {gen['paged_attention']} launches as in 16.1  [{card}]")
    log(f"[gateway] 17.2: {len(texts)} chunks and a RAG window over HTTP: vectors equal to the "
        f"direct embed job's bit for bit, embed_attention {direct[3]['embed_attention']} "
        f"launches as direct; the agent-loop workflow SUCCEEDED (memory "
        f"{ctx_numbers['workflow memory']}, the same vectors); {GATEWAY_EMBED_TEXTS} chunks "
        f"within {ctx_numbers['embed max abs err']:.3e} of the plain version  [{card}]")
    log(f"[gateway] 17.3: {backlog['jobs']} echo jobs over POST /api/v1/jobs:batch to "
        f"{backlog['workers']} live workers, each accepted, dispatched once and SUCCEEDED "
        f"once, in {backlog_s:.1f} s  [{card}]")
    for k in ("accepted jobs/s", "scheduled jobs/s", "dispatch->result p50 ms",
              "dispatch->result p99 ms", "submit->result p50 ms", "submit->result p99 ms",
              "context embeds/s"):
        log(f"[gateway] 17 (information): {k} {numbers[k]!r}  [{card}]")
    return launches, numbers


def gateway_process_env(workdir, port, url, http_port, dev, torch):
    """17.4's environment: 16.4's, with the gateway's address and keys, the
    workflow engine's reconcile interval, phase 17's pools and the embed
    topic on the worker."""
    import yaml

    pools = os.path.join(workdir, "pools17.yaml")
    with open(pools, "w") as f:
        yaml.safe_dump(GATEWAY_POOLS, f)
    env = {**os.environ, "STATEBUS_PORT": str(port), "CORDUM_STATEBUS_URL": url,
           "POOL_CONFIG_PATH": pools,
           "SAFETY_POLICY_PATH": os.path.join(REPO_DIR, "config", "safety.yaml"),
           "TIMEOUT_CONFIG_PATH": os.path.join(REPO_DIR, "config", "timeouts.yaml"),
           "GATEWAY_HTTP_ADDR": f"127.0.0.1:{http_port}", "CORDUM_API_KEYS": GATEWAY_KEY,
           "CORDUM_ADMIN_KEYS": GATEWAY_ADMIN_KEY, "WF_RECONCILE_INTERVAL": "1",
           "WORKER_ID": "w-gw", "WORKER_POOL": "gpu", "WORKER_LLAMA_DTYPE": "float32",
           "WORKER_TOPICS": f"job.gpu.>,{GATEWAY_EMBED_TOPIC}",
           "WORKER_MAX_BATCH_SIZE": "256", "WORKER_HEARTBEAT_INTERVAL": "1",
           "CORDUM_LOG_FORMAT": "json", "PYTHONDONTWRITEBYTECODE": "1"}
    for k in ("CORDUM_FORCE_CPU", "SAFETY_KERNEL_ADDR", "WORKER_CAPABILITIES"):
        env.pop(k, None)
    if torch.device(dev).type == "cpu":
        env["CORDUM_FORCE_CPU"] = "1"
    return env


async def drive_gateway_process(torch, dev, card, workdir, record, *, timeout_s=300.0):
    """17.4: the port's statebus, scheduler, workflow engine, gateway and
    worker binaries as processes over TCP; this script is the gateway's
    HTTP client.  ``record`` is phase 8's (as 16.4 takes it).  Returns each
    binary's exit code and the worker's exit record; every process is
    stopped on every path."""
    from cordum_tpu_torch.infra import statebus
    from cordum_tpu_torch.protocol import subjects as subj

    port, http_port = free_port(), free_port()
    url = f"statebus://127.0.0.1:{port}"
    env = gateway_process_env(workdir, port, url, http_port, dev, torch)
    names = ("statebus", "scheduler", "workflow_engine", "gateway", "worker")
    logs = {name: os.path.join(workdir, f"{name}17.log") for name in names}
    procs = {"statebus": start_process(["cordum_tpu_torch.cmd.statebus"], env, logs["statebus"])}
    conn = None
    rcs = {}
    try:
        kv, bus, conn = await connect_when_up(statebus, url, procs["statebus"])
        beats = []

        async def on_beat(subject, pkt):
            if pkt.heartbeat is not None and pkt.heartbeat.worker_id == "w-gw":
                beats.append(pkt.heartbeat)

        await bus.subscribe(subj.HEARTBEAT, on_beat)
        for name, ready in (("scheduler", '"scheduler running"'),
                            ("workflow_engine", '"connected to statebus"'),
                            ("gateway", '"gateway listening"')):
            procs[name] = start_process([f"cordum_tpu_torch.cmd.{name}"], env, logs[name])
            await wait_log(logs[name], ready, procs[name])
        procs["worker"] = start_process(["cordum_tpu_torch.cmd.worker"], env, logs["worker"])
        t0 = time.monotonic()
        while not beats:
            if procs["worker"].poll() is not None or time.monotonic() - t0 > timeout_s:
                raise AssertionError(f"the worker process never beat; see {logs['worker']}")
            await asyncio.sleep(0.1)
        await asyncio.sleep(1.5)  # the scheduler and the gateway hear the same heartbeat
        jobs = sched_process_jobs(record)
        ids = [f"proc17-{i}-{tag}" for i, (tag, _, _) in enumerate(jobs)]
        async with GatewayClient(f"http://127.0.0.1:{http_port}") as client:
            t0 = time.monotonic()
            for jid, (tag, topic, payload) in zip(ids, jobs):
                await client.submit(jid, topic, payload)
                if tag == "embed":  # one at a time, as phase 8 ran them
                    await client.wait_job(jid, timeout_s)
            docs = [(await client.wait_job(jid, timeout_s))["result"] for jid in ids]
            wall = time.monotonic() - t0
            texts = make_texts(np.random.default_rng(SEED + 20), GATEWAY_CHUNKS, 8, 60)
            await client.submit("proc17-chunks", "job.gpu.embed", {"op": "embed", "texts": texts})
            want = np.asarray((await client.wait_job("proc17-chunks"))["result"]["embeddings"],
                              np.float32)
            doc = await client.call("PUT", "/api/v1/context/chunks/proc17", json={
                "chunks": [{"file_path": f"doc{i}", "content": t} for i, t in enumerate(texts)]})
            window = (await client.call("POST", "/api/v1/context/window", json={
                "memory_id": "proc17", "mode": "RAG", "payload": GATEWAY_QUERY}))["messages"]
            got = await stored_vectors(kv, "proc17", texts)
            if doc != {"embedded": len(texts)} or not np.array_equal(got, want):
                raise AssertionError(f"chunk vectors through the processes differ from the "
                                     f"embed job's; {doc}")
            if not window[0]["source"].startswith("rag:"):
                raise AssertionError(f"RAG window through the processes: {window}")
            (gen_payload, gen_doc), ties = record["gen"][0], record["ties"][0]
            run = await client.run_workflow(context_workflow(
                "agent17p", texts, gen_payload["tokens"], gen_payload["max_new_tokens"]), {})
            if not np.array_equal(await stored_vectors(
                    kv, run["context"]["steps"]["remember"]["memory_id"], texts), want):
                raise AssertionError("the workflow's chunk vectors differ from the embed job's")
            compare_near_tie(run["context"]["steps"]["answer"]["tokens"], gen_doc["tokens"], ties,
                             "generate in the workflow through the processes")
        for name in ("gateway", "workflow_engine", "scheduler", "worker", "statebus"):
            if name == "statebus":
                await conn.close()
                conn = None
            rcs[name] = stop_process(procs[name])
    finally:
        if conn is not None:
            await conn.close()
        for proc in procs.values():
            stop_process(proc)
    ties_n = check_process_docs(jobs, docs, record, "w-gw", "the gateway's processes")
    exit_doc = worker_exit_line(logs["worker"])
    bad = {n: rc for n, rc in rcs.items() if rc != 0}
    if bad or exit_doc.get("cancelled_sessions") != 0:
        raise AssertionError(f"SIGTERM: exit codes {rcs}, worker {exit_doc}; see {logs}")
    log(f"[gateway-proc] 17.4: statebus, scheduler, workflow engine, gateway and worker "
        f"processes over TCP: {len(jobs)} jobs over HTTP SUCCEEDED once each in {wall:.1f} s "
        f"with phase 8's results ({ties_n} near-tie positions); {len(texts)} chunks' vectors "
        f"equal to their embed job's, the agent-loop workflow SUCCEEDED; SIGTERM exit codes "
        f"{rcs}  [{card}]")
    return rcs, exit_doc


def phase_gateway_process(torch, dev, card, record8):
    """17.4 on the card; returns the worker process's launches."""
    import tempfile

    from cordum_tpu_torch.models import llama
    from cordum_tpu_torch.models.embedder import EmbedderConfig

    with tempfile.TemporaryDirectory(prefix="cordum-gateway-") as workdir:
        _, exit_doc = asyncio.run(drive_gateway_process(torch, dev, card, workdir, record8))
    return check_sched_process_launches(exit_doc, llama.LlamaConfig.tiny().n_layers,
                                        EmbedderConfig().n_layers)


def build_kernels():
    """One ``nvcc`` per kernel source, all started together.  Returns each
    kernel row's source and each module's build log (empty where the
    library was already built)."""
    import importlib
    from concurrent.futures import ThreadPoolExecutor

    from cordum_tpu_torch.ops import _build

    mods = {m: importlib.import_module(f"cordum_tpu_torch.ops.{m}")
            for m in dict.fromkeys(m for m, _ in KERNELS.values())}
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(mods)) as ex:
        built = list(ex.map(lambda m: _build.build(m.SOURCE), mods.values()))
    log(f"[device] kernels built in {time.monotonic() - t0:.1f} s")
    for (path, build_log) in built:
        log(f"[device] kernel library {path}")
        if build_log:
            log(build_log.rstrip())
    sources = {m: str(mod.SOURCE.relative_to(mod.SOURCE.parents[2])) for m, mod in mods.items()}
    logs = {m: build_log for m, (_, build_log) in zip(mods, built)}
    return {name: sources[m] for name, (m, _) in KERNELS.items()}, logs


def main() -> int:
    if "--gang-rank" in sys.argv:
        return gang_rank_main(sys.argv[1:])
    if "--cards" in sys.argv:
        return main_cards()
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from cordum_tpu_torch.models import llama

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
    sources, build_logs = build_kernels()

    kernel = {"paged_attention": phase_kernel(torch, dev, smi)}
    torch.cuda.empty_cache()

    cfg8b = llama.LlamaConfig.llama3_8b()
    cfg32 = dataclasses.replace(cfg8b, n_layers=2, dtype=torch.float32)
    fp32_launches, params32, prompts, oracle, served32 = phase_oracle(torch, dev, smi, cfg32)
    torch.cuda.empty_cache()
    bf16_launches, params8b, serve4 = phase_serve(torch, dev, smi, cfg8b)
    torch.cuda.empty_cache()
    kernel["embed_attention"] = phase_embed_kernel(torch, dev, smi)
    worker, numbers6, (sched16, _, (gw17, _)) = phase_worker(
        torch, dev, smi, fp32=(cfg32, params32, prompts, oracle), bf16=(cfg8b, params8b))
    del params32, params8b  # phase 7 needs the room
    gc.collect()  # whatever of the stopped workers sits in reference cycles
    torch.cuda.empty_cache()
    log(f"[train] device memory allocated before phase 7: "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    dense, train, dense_step = phase_train(torch, dev, smi, cfg8b, build_logs["dense_attention"])
    kernel.update(dense)
    gc.collect()
    torch.cuda.empty_cache()
    proc, record8 = phase_worker_process(torch, dev, smi, numbers6)
    sched_proc = phase_scheduler_process(torch, dev, smi, record8)
    gw_proc = phase_gateway_process(torch, dev, smi, record8)
    gc.collect()
    torch.cuda.empty_cache()
    moe_rows, moe, moe_first_loss = phase_moe(torch, dev, smi)
    kernel.update(moe_rows)
    gc.collect()
    torch.cuda.empty_cache()
    kernel["paged_attention_tp2"], gang = phase_gang(torch, dev, smi, cfg32, prompts, oracle,
                                                     served32, serve4)
    gc.collect()
    torch.cuda.empty_cache()
    pipe, pipe_b1 = phase_pipeline(torch, dev, smi, cfg8b, dense_step)
    gc.collect()
    torch.cuda.empty_cache()
    kernel.update(phase_sp_chunk_kernel(torch, dev, smi))
    mesh, gather_bf16 = phase_mesh(torch, dev, smi)
    kernel.update(phase_ring_kernel(torch, dev, smi))
    ring = phase_ring_mesh(torch, dev, smi, gather_bf16)
    gc.collect()
    torch.cuda.empty_cache()
    kernel.update(phase_moe_room_kernel(torch, dev, smi))
    moe_mesh = phase_moe_mesh(torch, dev, smi, moe_first_loss)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cordum-graft-") as ckpt_root:
        graft = phase_graft(torch, dev, smi, ckpt_root)

    # phase 8's worker process serves an fp32 Llama and the bf16 embedder
    launches = {
        "paged_attention": {"float32": fp32_launches + proc["paged_attention"],
                            "bfloat16": bf16_launches},
        "embed_attention": {"float32": worker["float32"]["embed_attention"],
                            "bfloat16": worker["bfloat16"]["embed_attention"]
                            + proc["embed_attention"]},
        # the bf16 forward also ran in phase 6's infer jobs, the fp32 one in
        # phase 8's
        "dense_attention_fwd": {
            "float32": train["dense_attention_fwd"]["float32"] + proc["dense_attention_fwd"],
            "bfloat16": train["dense_attention_fwd"]["bfloat16"]
            + worker["bfloat16"]["dense_attention_fwd"]},
        "dense_attention_bwd": train["dense_attention_bwd"],
        # the sequence chunks' launches: phase 12.7's and 12.8's ranks
        **{name: mesh[name] for name in CHUNK_ROWS},
        **{name: moe[name] for name in MOE_KERNELS},
        "paged_attention_tp2": gang,
        # the ring's entries and merges: phase 13.2's ranks
        **{name: ring[name] for name in RING_ROWS},
        # the route with a room: phase 14.2's dp 2 x ep 2 ranks
        ROOM_ROW: {"float32": moe_mesh[ROOM_ROW]["float32"]},
    }
    # phase 11.4's serving leg runs B1 at full heads (fp32)
    launches["paged_attention"]["float32"] += pipe_b1
    # phase 16: 16.1's and 16.2's jobs through the scheduler on phase 6's
    # bf16 worker; 16.4's worker process serves phase 8's fp32 Llama and the
    # bf16 embedder
    for name in ("paged_attention", "embed_attention", "dense_attention_fwd"):
        launches[name]["bfloat16"] += sched16[name]
    launches["paged_attention"]["float32"] += sched_proc["paged_attention"]
    launches["embed_attention"]["bfloat16"] += sched_proc["embed_attention"]
    launches["dense_attention_fwd"]["float32"] += sched_proc["dense_attention_fwd"]
    # phase 17: 17.1's and 17.2's jobs through the gateway on phase 6's bf16
    # worker; 17.4's worker process as 16.4's
    for name in ("paged_attention", "embed_attention"):
        launches[name]["bfloat16"] += gw17[name]
    launches["paged_attention"]["float32"] += gw_proc["paged_attention"]
    launches["embed_attention"]["bfloat16"] += gw_proc["embed_attention"]
    launches["dense_attention_fwd"]["float32"] += gw_proc["dense_attention_fwd"]
    # phase 12's rank processes, and 13.2's ring chunks' forward launches
    for name in ("dense_attention_fwd", "dense_attention_bwd"):
        for dtype in ("float32", "bfloat16"):
            launches[name][dtype] += mesh[name][dtype]
    for dtype in ("float32", "bfloat16"):
        launches["dense_attention_fwd"][dtype] += ring["dense_attention_fwd"][dtype]
    # phase 9's MoE runs and phase 11's pipeline runs launch B9 too
    for name in ("dense_attention_fwd", "dense_attention_bwd"):
        for dtype in ("float32", "bfloat16"):
            launches[name][dtype] += moe[name][dtype] + pipe[name][dtype]
    # phase 14.2's MoE rank processes launch B7 and B9
    for name in ("dense_attention_fwd", "dense_attention_bwd", *MOE_KERNELS):
        for dtype in ("float32", "bfloat16"):
            launches[name][dtype] += moe_mesh[name][dtype]
    # phase 15: entry()'s forward, the dry run's rank and the train jobs at
    # world 1 (bf16; the route with a room launches only where dp is above 1)
    for name in GRAFT_LAUNCH_ROWS:
        if name != ROOM_ROW:
            launches[name]["bfloat16"] += graft[name]["bfloat16"]
    line = {"kernels": [
        {"name": f"{name}_{dtype}", "route": "cuda", "source": sources[name],
         "replaces": KERNELS[name][1], "launches": launches[name][dtype],
         **kernel[name][dtype]}
        for name in KERNELS for dtype in ("bfloat16", "float32")
        if dtype == "float32" or name != ROOM_ROW  # fp32 probabilities in every dtype
    ]}
    idle = [row["name"] for row in line["kernels"] if not row["launches"]]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
