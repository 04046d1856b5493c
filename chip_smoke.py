#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):
  1. environment: versions, the card, its power limit; TF32 off.
  2. build: ``nvcc`` compiles every ``src/repro_torch/csrc/*.cu`` for sm_90a
     (one process per source, started together): the tree lookup (B1/B2),
     the classical lookup (B3) and the standalone range match (B4), all
     sharing ``csrc/range_match.cuh`` with the per-feature-loop tree lookup
     (B7), the streaming register scatter / readout (B5), the eviction
     fill and timeout sweep (B6) and the int8-KV decode attention (B8).
  3. kernel vs plain, atol=0, N in {1, 300, 2048}, one launch per call:
     the tree lookup at the serving shapes (the anomaly RF switch artifact,
     the mapped 60-tree XGB backend artifact, a synthetic vote artifact past
     the select crossover), both selects, tables staged in shared memory,
     only the edges and feature table staged, and read from global memory;
     both selects (B1, B2) also at N in {1, 127, 128, 129, 2048, 2049,
     16000} with Co in {1, 2, 32} in every staging mode that fits (rows on
     the edges and at NaN / +-inf), at F=12 (more features than a thread
     keeps row offsets for in registers), and on tables whose keys run past Sp
     (T in {7, 70}, Co in {1, 3, 32}; the matmul select adds nothing for
     such a key, the compare select reads leaf 0) at N in {1, 129, 2049}; the
     streaming register update (B5) at N in {600, 8192, 2^20} x W in
     {1, 96, 1024, 4096} and with every lane on one bucket, then N=8209
     (not a multiple of its tile), an empty window, a window with no valid
     lane and -0.0 count registers on the columns the window does not name,
     each without a clamp, at 1000 and at 2^24; the eviction fill (B6's
     mask-taking entry) at N in {600, 8192, 8209, 2^20}, and B6's timeout
     sweep (in place, the count from the same launch) against its plain
     composition at N in {600, 8192, 8209, 2^20} x W in {1, 1024, 4096}:
     as drawn, no valid lane, a NaN timestamp on a valid lane, columns last
     seen exactly at the cutoff, every column evicted, none evicted;
     the classical lookup (B3) on the SVM (M=1), NB and K-Means (M=2)
     switch artifacts that phase 4 serves (the test rows, N in {1, 300,
     1952, 2048}, 1952 the ragged last batch) and on a synthetic 5-class
     SVM table (F=8, 128 bins, M=10) whose staged tables need the >48 KB
     opt-in, each also on rows on the edges with NaN / +-inf at N in {1,
     127, 128, 129, 1952, 2048, 2049} in every staging mode that fits
     ('all', 'edges', 'none'); the range match at the main path's own shape (all 16000
     training rows against the fit's 64-bin quantile edges), on the served
     edges (5, 63), on a synthetic sorted (8, 255) set and on unsorted
     (5, 255) rows with ragged +inf pads (the count, not a search), N in
     {1, 300, 2048, 16000}, inputs on the edges and at +-inf; the
     per-feature-loop lookup (B7) at N in {1, 127, 128,
     129, 2048, 2049} on the RF switch (staged and global tables; test rows
     and rows on the edges), the XGB backend, and hand-built artifacts whose
     keys run past S (vote with Co 3 and 32, sum; N also 16000 on rows on
     the edges with NaN / +-inf);
     the int8-KV decode attention (B8) at rtol 2e-4 / atol 2e-5 (the
     reference's own Pallas-against-oracle tolerance; an online softmax
     sums in another order) at the slice's shape (B=8, S=32768, G=8, M=4,
     hd=128; a synthetic cache made as the reference's kernel test makes
     it) with every slot live, a ring with holes, every slot dead and the
     served path's broadcast mask, then ragged S in {1, 700, 1000}, the
     split's edges (B=8, G=8: S one below, at and one above a chunk
     boundary, a chunk entirely dead beside live ones, a row all dead),
     h2o-danube-1.8b's 4096-slot ring at its head dim of 80 (M=4), and M in
     {1, 4, 8} x hd in {16, 64, 80, 128}; each case prints the split B8
     chose (n_split, chunk, grid); after phase 4f, layers 0 and 35 of the
     served int8 cache with a seeded q. Then this slice's shapes: B1 at the
     chunk classify's 16,384 and 32,768 readout rows (the streaming
     configuration's first 32 windows through the RF 4x3 switch, both
     selects), B4 at the finance fit (16,000 x 130 rows against 130 x 63
     edges), and the payload parse (``file_features_csv`` after
     ``stitch_split_payload``) on the card against the CPU's, on 512
     finance rows split at byte 700, all 130 columns, and on 4096 fields
     whose integer parts lie in [2^24, 1e8) against their nearest f32; B1
     also at 256 and 512 rows, and B5 and B6's sweep at (N=8192, W=512) and
     (N=4096, W=256), the deferral and scenario phases' shapes.
  4. serve, each path with every launch count set to 0 just before it and
     read just after:
     a. ``repro_torch.launch.serve`` at its full default widths (RF 10x5
        switch, XGB 60x6 backend, tau 0.7, capacity 1024, batch 2048),
        once with select=auto (the matmul-select kernel) and once with
        select=compare;
     b. the SVM, naive Bayes, K-Means and isolation-forest switches (64
        bins, 16 action bits; isolation forest 32 trees of depth 6), each
        trained and mapped on the card and served by ``HybridServer`` in
        front of the XGB 60x6 backend over all 4000 test rows in batches
        of 2048 (the last one ragged, 1952 rows); then the served
        isolation-forest tables against the plain lookup at N in
        {1, 300, 1952, 2048}, both selects in every staging mode that fits.
     c. the streaming path: ``StreamingHybridServer.serve_trace`` over the
        repo's streaming configuration (``benchmarks/stream_bench.py``:
        ``synth_trace(n_flows=4000, seed=0)``, N=8192 buckets, windows of
        1024 packets, tau 0.9, capacity 64; RF 4x3 switch and RF 16x6
        backend trained on the trace's batch flow features), window by
        window on the eager route (``fuse=False``), twice: without
        eviction, and with ``evict_age=5.0`` under the timeout policy. Each
        step launches B5 and B1 once (and B6's timeout sweep once in the
        second run, in place, the cutoff and the count included); the
        first run's flow table equals the batch ``flow_features`` on the
        card bit for bit; the second evicts.
     d. ``HybridServer`` at the serve default's width (phase a's artifact
        and backend) over all 4000 test rows: with
        ``tiles=TileConfig(impl='loop')`` (one B7 launch, no B1/B2, per
        classify), with ``autotune=True`` (every candidate's time and the
        winner; every candidate must be timed), and with ``fuse=None`` (the
        probe, a CUDA graph per shape, bit-equal to the eager server, an
        ``update_tables`` swap under the graphs, and a host-syncing backend
        that must fall back to the eager path).
     e. ``repro_torch.launch.serve --backend lm`` at its default width (the
        RF switch in front of a smoke-size qwen3-4b scorer, ``fuse=None``):
        one switch launch per classify, classes equal to the plain path's,
        and the route the server took.
     g. chunked streaming: the streaming configuration (phase c's models)
        through ``serve_trace`` with ``chunk_windows`` in {1, 2, 8, 16,
        "auto"}, without and with ``evict_age=5.0``, on the eager route
        (B5 K times, B1 once and B6's sweep K times a chunk) and through
        the chunk step's CUDA graph (the probe, warm-up and capture counted;
        replays launch what was captured); each equal to the per-window
        server on the card bit for bit (predictions, flow table, counters;
        one flush a chunk; ``conf_sum`` at rtol 1e-5), the graph route to
        the eager one, chunk by chunk too (evictions in every replay); no
        host sync in a step_chunk; a syncing backend served eagerly; the
        per-window step's graph against the eager step; windows and chunks
        mixed on one server; ``reset()`` under the captured graphs.
     h. ``repro_torch.launch.serve --use-case finance`` at its defaults
        (Jane-Street-like data, 20,000 rows; RF 10x5 switch on the five
        switch features, XGB 60x6 backend on all 130 through the index side
        channel, ``fuse=False``): one B1 launch per classify (and one for the
        launcher's recompute of the dispatch order), predictions equal to a
        plain server's over the same models and side channel; then
        ``repro_torch.examples.finance_lowlatency`` at its defaults, its
        parse and classify on the card equal to the CPU's.
     i. cross-window deferral at the reference's deferral configuration
        (``benchmarks/batch_bench.py:39-41``: phase c's trace and models at
        windows of 512, capacity 64) through ``serve_trace`` with
        ``flush_every`` in {1, 2, 4, 8}, without and with ``evict_age=5.0``,
        through the deferred step's and the flush's CUDA graphs (warm-up and
        capture counted; at k=1 the window step's graph and its probe) and
        eagerly (B5, B1 and the sweep once a window): predictions and
        backend rows equal k=1's bit for bit, ceil(windows / k) backend
        calls (2x fewer at k >= 4), the graph route equal to the eager one
        and both to the CPU port on the same models (every counter, the flow
        table); at k=8 the occupancy (0.5) and deadline (2.0 s) flushes: the
        same predictions with more flushes.
     j. the four adversarial scenarios at the reference scenario bench's
        configuration (``benchmarks/scenario_bench.py:75-91``, scale 1.0:
        4096 buckets, windows of 256, capacity 64, tau 0.9, ``evict_age=
        5.0``; an RF 4x3 switch and an RF 16x6 backend trained on the card
        per trace) under its fault policy, with the profiles none, flaky20
        and outage (eager, the guard's route: B5, B1 and the sweep once a
        window): the clean profile equal to the unguarded server (its
        graphs) with no failed flush; under faults the guard retried, a
        failed flush degraded rows (always under the outage), the
        accounting balances; each run equal to the CPU port under the same
        seeded ``FaultyBackend``.
     k. open-ended ingest and observability: ``serve_stream`` through the
        packet ring (``netsim/ingest.py``; on the chunked path the prefetch
        thread packs each cut into pinned buffers and copies it on a side
        stream), each run's B5, B1 and sweep launches counted against its
        steps, predictions and counters bit for bit against the manual loop
        (``iter_chunks`` + ``step_chunk``, ``iter_windows`` + ``step``): the
        reference latency bench's configuration (``benchmarks/
        latency_bench.py:58-67``: the streaming trace, windows of 256, K=16,
        batches of 4096) with prefetch off and on and with
        ``chunk_windows="auto"``, eager and through the graph, and against
        the CPU port; the streaming configuration's ``serve_trace`` through
        the ring (K=16, without and with ``evict_age=5.0``); the reference
        obs bench's configuration (``benchmarks/obs_bench.py:144-160``:
        3000 flows, W=256, K=8 chunked and ``flush_every=4``,
        ``rollup_every=4``, events to a JSON-lines file in a temporary
        directory) with obs on equal to obs off and to the CPU port, the
        log valid, rollups closed, and its drift monitor firing on the
        shifted trace and silent on a stationary one; a paced source
        (batches of 1000) with a real 2 ms deadline and with a fake clock
        that forces deadline cuts (equal but for ``flushes``); a live
        source sleeping 5 ms a batch at ``serve_stream``'s defaults
        (prefetch on, the graph captured while the thread stages);
        ``record_latency`` with and without ``latency_samples`` (p50, p95,
        p99).
     l. the sharded flow-table tier (``ShardedStreamingServer``) at D = 1,
        one NCCL rank (``flow_shard_mesh`` starts a one-rank group), at the
        reference shard bench's configuration (``benchmarks/
        shard_stream_bench.py:55-57``: the streaming trace and models,
        N=8192, W=1024, tau 0.9, capacity 64), without eviction and with
        ``evict_age=2.0``: the sharded oracle table against the batch table;
        the trace per window (through the step's CUDA graph, collectives
        captured inside, and eagerly: rank 0's backend call broadcast),
        chunked at K=16, with ``flush_every=4``, with
        ``partition_classify=False`` and through ``serve_stream`` (K=16,
        batches of 4096), each equal bit for bit to the single-device
        server on the card (predictions, StreamStats, flow table; epoch
        0.0) with the same B5, B6-sweep and B1 launches, and collectives
        sent; then the census of collectives per step kind (3 psums, 1
        reduce-scatter and 2 all-gathers a window or chunk switch half).
     m. the analysis gate: ``python -m repro_torch.analysis --strict
        --json`` in a subprocess on the card (exit 0, no finding, every
        rule registered with its self-test fired) and with ``--device
        cpu``, each timed; then the four hot-path rules in this process at
        the streaming cell's full width (N=8192, W=1024, capacity 64, tau
        0.9, the RF 4x3 switch and RF 16x6 backend, ``evict_age=5.0``,
        K=16, ``flush_every=4``) over ``HybridServer``, the single-device
        server and, on phase 4l's one-rank NCCL group, the sharded server:
        every contracted body eagerly under the op recorder and
        ``set_sync_debug_mode("error")``, then through its CUDA graph (the
        capture and two replays): no finding, and each eager body's B1, B5
        and B6 launches as a step of its kind launches them; then
        ``repro_torch.examples.quickstart`` and ``anomaly_hybrid`` at the
        reference's sizes on the card, with the forests fitted once on the
        CPU and carried across, each equal to the CPU port's run
        (predictions, accuracy, P/R/F1, the fraction handled, the backend
        rows, the flagged count, the flow table).
     f. Qwen3-4B at full width (36 layers, d_model 2560, vocab 151,936, f32
        params from ``init_model`` on the card, 17.65 GB) through
        ``ServeEngine``: prefill of 8 x 256 seeded tokens, the prefill K/V
        quantized by ``_q8`` into an int8 decode cache of 32,768 slots
        (19.9 GB; ``decode_32k`` cut from batch 128 to 8), then 16 greedy
        decode steps eagerly, then 16 from the engine's decode graph on a
        fresh cache from the same prefill (the first step eager as the
        warm-up, the capture, then replays): the same tokens and logits
        bit for bit, every cache tensor where it was. B8 must launch
        36 x 16 times eagerly and 36 x 2 on the graph route (warm-up and
        capture; a replay counts none), and nothing else; the logits must
        be finite and the tokens in the vocabulary; the first step's
        logits against a prefill of prompt + token (relative gap under
        0.05, argmax agreement reported).
     n. the other six LM families at their published widths, one after
        another, each freed before the next (run after phase 5's LM times,
        once phase f's model is freed): recurrentgemma-2b (26 layers),
        xlstm-1.3b (48), whisper-base (6 + 6, 1500 frames), phi-3-vision
        (32, 576 patches), arctic-480b at 1 of its 35 layers (56.3 GB of
        f32 weights; 2 are 110.7 GB) and deepseek-v3-671b at its 3 dense
        layers and 1 MoE layer of 61, without the MTP head (60.4 GB);
        seeded weights, 8 x 256 prompts (+ frames / patches), a decode
        cache of 2048 slots, int8 wherever there are GQA layers (arctic
        M=7 hd=128, phi-3 M=1 hd=96, recurrentgemma M=10 hd=256 at its
        2048 window), 16 steps eagerly and 16 from the decode graph, as
        phase f: bit for bit, B8 once a GQA layer a step and twice for the
        graph route; the first step against a prefill of prompt + token
        (for MoE one that drops no unit: row by row, each expert with room
        for the row); B8 against its plain version on each served int8
        cache.
     Each classify must launch its switch kernel once, the predictions must
     equal those of the same server on the plain path, the switch's answers
     must equal CPU ``table_predict`` on 64 rows (confidence within 2 ulps
     where it is a transcendental's output), and one classify (one step)
     must not sync the host.
  5. times: CUDA events, median over repetitions after warm-up, for each
     kernel, its plain version, the library call where one computes the
     same function (``torch.searchsorted`` for the range match), and one
     full classify batch per switch family. Each kernel at its main-path
     shape: the lookups at a 2048-row batch (B2 at both of its shapes, the
     RF switch's and the isolation forest's, each a row with its own
     launches; B1, B2 and B7 also by rows a block), the range match at the
     16000-row fit (and at 2048 rows, kernel and ``searchsorted`` in
     turn), B1 also at the streaming step's shape (its 1024 rows through
     the RF 4x3 switch), B5 and B6 at N=8192, W=1024 (B6's timeout sweep
     against its plain composition and the parent's 14-launch sweep, its
     mask-taking entry against ``torch.where``, its library call; B5 has
     none), and the floor of one graph-replayed launch (a one-element
     ``fill_``). One streaming step, eager and under
     graph replay, its parts, and packets per second of ``serve_trace``. One
     classify of each phase-d server: eager, fused (per call and its
     graph's replay), loop tiles and autotuned tiles. B8 on the served
     cache: 50 launches in a CUDA graph and one eager call, its plain
     version, ``scaled_dot_product_attention(enable_gqa=True)`` on an
     already-dequantized cache (the library yardstick, dequant left out),
     the bound and the split it chose; B8 at h2o-danube-1.8b's shape
     (B=8, S=4096, G=8, M=4, hd=80) with its bound; the prefill, the decode
     step (eager and from the graph, medians; the graph's replay alone),
     tokens/s and B8's share of a step; then two more decode steps under
     ``torch.profiler`` on each route, kernels summed by name; for each
     family of phase n its prefill, decode step eager and from the graph,
     tokens/s, and B8 on its served cache (kernel, plain, SDPA on the
     dequantized cache, bound). This
     slice's: one chunk step at K=16 with eviction (eager, device time by
     graph replay, the server's own graph per call and its replay alone)
     and its parts; the per-window step under its graph against eager;
     packets per second of ``serve_trace`` per window (eager, graph)
     against chunked (K=16 eager and graph, "auto"); B1 at 16,384 and
     32,768 rows; B4 at the finance fit against ``torch.searchsorted``;
     the finance classify (eager, device) and the example's parse. Then
     deferral: one deferred step and one flush by replaying each server's
     own graph (k = 2, 4, 8, with eviction), a window's device time at each
     k against the window step's graph at k=1 (W=512), the deferred step's
     parts (the switch half, the deferral tail), a call of each route, and
     ``serve_trace``'s ms and packets/s per k and route; each scenario's
     guarded ``serve_trace``. Then ingest: the host's parts timed alone
     (hash, in numpy and in torch on the CPU, rebase, the ring's
     admit/pop/pack, the pinned pack of a chunk, and its H2D copy under
     CUDA events on the side stream) at the latency bench's and the
     streaming configuration's geometry, and the per-window path's
     transfer (one pinned copy a cut against a copy a column, in turns);
     packets/s of ``serve_stream`` with prefetch off and on, eager and
     from the graph, and its obs stage timers a chunk with prefetch off
     and on; ``serve_trace`` through the ring (prefetch off on the card)
     against the manual loop from the graph (W=1024, K=16, in turns); the
     card's idle share over a ``serve_stream`` run (``torch.profiler``);
     the obs on/off throughput ratio on both paths. Then the sharded tier
     against the single-device server in turns: each step's device time by
     replaying its graph (window, chunk at K=16, deferred step and flush
     at k=4) and ``serve_trace``'s ms and packets/s, the cost of the
     collectives at D = 1.
  6. a JSON line of every kernel with its numbers, the card's name and
     power limit, then ``{"ok": true, "device": {...}}`` as the last line.

Needs one CUDA card; without one (or without the repository around it) it
exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
REPS = 30


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _median_ms(torch, fn, reps=REPS, warmup=3, inner=1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls of
    ``fn``, per call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _graph_ms(torch, fn, inner=50) -> float:
    """Device time per call with the host out of the way: ``inner`` calls
    captured in one CUDA graph, replayed under CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return _median_ms(torch, graph.replay) / inner


def _ulp_ok(ref, got, ulps=2) -> bool:
    """The port's confidence rule: within ``ulps`` ulps of the larger of
    conf and 1 - conf (the gap a transcendental may leave)."""
    import numpy as np
    a = np.asarray(ref, np.float32)
    b = np.asarray(got, np.float32)
    unit = np.maximum(np.spacing(np.abs(a)),
                      np.spacing(np.abs(np.float32(1.0) - a)))
    return bool(np.all(np.abs(a.astype(np.float64) - b.astype(np.float64))
                       <= ulps * unit.astype(np.float64)))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)

    import numpy as np
    from repro_torch.core.artifact import (build_dtable_flat, flatten_ftable,
                                           flatten_vtable, pad_dtable)
    from repro_torch.core.inference import table_predict
    from repro_torch.core.mapping import (map_kmeans, map_naive_bayes,
                                          map_svm, map_tree_ensemble)
    from repro_torch.kernels import _build
    from repro_torch.kernels import bucketize as bk
    from repro_torch.kernels import classical_lookup as ck
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ensemble_lookup as ek
    from repro_torch.kernels import evict as ev
    from repro_torch.kernels import stream_update as su
    from repro_torch.kernels.ops import fused_classify
    from repro_torch.launch import serve
    from repro_torch.launch.serve import build_usecase
    from repro_torch.ml.kmeans import fit_kmeans
    from repro_torch.ml.naive_bayes import fit_gaussian_nb
    from repro_torch.ml.svm import fit_linear_svm
    from repro_torch.ml.trees import (fit_random_forest, fit_xgboost,
                                      quantile_bin_edges)
    from repro_torch.serving.hybrid_serving import HybridServer

    # -- 1. environment ------------------------------------------------------
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _smi()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.2f}s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    # -- 3. kernel vs plain --------------------------------------------------
    xtr, ytr, xte, yte = build_usecase("anomaly", n=20000)
    rf = fit_random_forest(xtr, ytr, n_classes=2, n_trees=10, max_depth=5,
                           seed=0, device=dev)
    rf_art = map_tree_ensemble(rf, 5).to(dev)
    xgb = fit_xgboost(xtr, ytr, n_trees=60, max_depth=6, device=dev)
    xgb_art = map_tree_ensemble(xgb, 5).to(dev)
    # a synthetic vote artifact past the select crossover (T*Sp*Co > 8192)
    # whose staged tables need the >48 KB shared-memory opt-in; codes < 3
    # per feature and strides 3^f keep every key below S = 300
    rng = np.random.default_rng(0)
    syn_f, syn_u, syn_t, syn_s, syn_c = 5, 40, 40, 300, 3
    syn_edges = torch.tensor(np.sort(rng.normal(size=(syn_f, syn_u)), axis=1),
                             dtype=torch.float32, device=dev)
    syn_ftable = torch.tensor(rng.integers(0, 3, (syn_f, syn_u + 1, syn_t)),
                              dtype=torch.int32, device=dev)
    syn_strides = torch.tensor(np.array([[1, 3, 9, 27, 81]] * syn_t),
                               dtype=torch.int32, device=dev)
    syn_dtable = torch.tensor(rng.integers(0, syn_c, (syn_t, syn_s)),
                              device=dev)
    syn_tabs = (syn_edges, flatten_ftable(syn_ftable, syn_strides),
                build_dtable_flat(syn_dtable, syn_c, True),
                pad_dtable(syn_dtable))
    x_all = torch.as_tensor(xte, device=dev)
    x_syn = torch.tensor(rng.normal(size=(2048, syn_f)) * 1.2,
                         dtype=torch.float32, device=dev)

    def tables(art):
        return (art.edges, art.ftable_flat, art.dtable_flat, art.dtable_pad)

    def check_launch(kernel_key, name, call, plain, detail):
        """One kernel call against its plain version: exactly one launch,
        equal output."""
        before = _counts()[kernel_key]
        out_k = call()
        torch.cuda.synchronize()
        launched = _counts()[kernel_key] - before
        out_p = plain()
        err = float((out_k.double() - out_p.double()).abs().max()) \
            if out_k.numel() else 0.0
        print(f"case {name} {detail} launches={launched} max_abs_diff={err}")
        if launched != 1 or out_k.dtype != out_p.dtype \
                or not torch.equal(out_k, out_p):
            raise AssertionError(f"kernel != plain for {name} {detail}")

    cases = [("rf_switch", tables(rf_art), x_all, "auto", None),
             ("rf_switch", tables(rf_art), x_all, "compare", None),
             ("rf_switch", tables(rf_art), x_all, "matmul", "none"),
             ("rf_switch", tables(rf_art), x_all, "compare", "none"),
             ("rf_switch", tables(rf_art), x_all, "compare", "keys"),
             ("xgb_backend", tables(xgb_art), x_all, "auto", None),
             ("xgb_backend", tables(xgb_art), x_all, "matmul", None),
             ("xgb_backend", tables(xgb_art), x_all, "matmul", "none"),
             ("xgb_backend", tables(xgb_art), x_all, "compare", None),
             ("xgb_backend", tables(xgb_art), x_all, "compare", "none"),
             ("synthetic_vote", syn_tabs, x_syn, "auto", None),
             ("synthetic_vote", syn_tabs, x_syn, "matmul", None),
             ("synthetic_vote", syn_tabs, x_syn, "compare", "keys"),
             ("synthetic_vote", syn_tabs, x_syn, "compare", "none")]
    for name, tabs, x_src, select, staged in cases:
        cout, t, s_pad = tabs[2].shape
        f, u = tabs[0].shape
        b_pad, t_pad = tabs[1].shape[0] // f, tabs[1].shape[1]
        resolved = ek.resolve_select(select, t, s_pad, cout)
        st = (ek.stage_mode(f, u, b_pad, t_pad, t, s_pad, cout, resolved,
                            128) if staged is None else staged)
        for n in (1, 300, 2048):
            x = x_src[:n].contiguous()
            check_launch(
                resolved, name,
                lambda: ek.ensemble_lookup_fused(x, *tabs, select=select,
                                                 staged=staged),
                lambda: ek.ensemble_lookup_fused_ref(x, *tabs, select=select),
                f"N={n} F={f} U={u} T={t} Sp={s_pad} Co={cout} "
                f"select={select}->{resolved} staged={st}")

    # the classical switch artifacts at the served width (64 bins, 16 bits),
    # built once: phase 3 checks, phase 4 serves and phase 5 times these
    km = fit_kmeans(xtr, k=2, seed=0, device=dev)
    classical_arts = {
        "svm": map_svm(fit_linear_svm(xtr, ytr, n_classes=2, device=dev),
                       xtr).to(dev),
        "nb": map_naive_bayes(fit_gaussian_nb(xtr, ytr, n_classes=2,
                                              device=dev), xtr).to(dev),
        "kmeans": map_kmeans(km, xtr).to(dev)}
    # a synthetic 5-class SVM table (all 10 pairs) at 128 bins over 8
    # features: 8 * 128 * 16 * 4 B = 64 KB staged, past the 48 KB default
    cls_f, cls_u, cls_m = 8, 127, 10
    cls_edges = np.sort(rng.normal(size=(cls_f, cls_u)), axis=1)
    cls_edges[:, -9:] = np.inf
    cls_q = rng.integers(-32767, 32768, (cls_f, cls_u + 1, cls_m))
    cls_tabs = (torch.tensor(cls_edges, dtype=torch.float32, device=dev),
                flatten_vtable(torch.tensor(cls_q, dtype=torch.int32)).to(dev),
                cls_m)

    def edge_rows(edges, n, gen=rng):
        """Rows around the edges, a quarter exactly on one, +-inf in two."""
        e = edges.cpu().numpy()
        f, u = e.shape
        finite = np.isfinite(e).sum(axis=1)
        x = (gen.normal(size=(n, f)) * 1.5).astype(np.float32)
        on = gen.random((n, f)) < 0.25
        col = (gen.random((n, f)) * finite[None, :]).astype(np.int64)
        pick = e[np.arange(f)[None, :], col]
        x[on] = pick[on]
        x[0, 0], x[1, 0] = np.inf, -np.inf
        return torch.tensor(x, device=dev)

    # both selects (B1, B2) at the batch sizes around their block (128
    # rows) and past the largest batch, Co in {1, 2, 32}, in every staging
    # mode that fits (every table, the edges and feature table only, none),
    # rows on the edges and at NaN / +-inf (a generator of its own, so the
    # cases after it see the same inputs)
    m_rng = np.random.default_rng(17)
    for cout in (1, 2, 32):
        m_t, m_s = (60, 600) if cout == 1 else (33, 300)
        m_edges = np.sort(m_rng.normal(size=(5, 39)), axis=1)
        m_edges[:, -9:] = np.inf
        m_ftable = torch.tensor(m_rng.integers(0, 2, (5, 40, m_t)),
                                dtype=torch.int32)
        m_strides = torch.tensor([[16, 8, 4, 2, 1]] * m_t, dtype=torch.int32)
        m_dtable = torch.tensor(
            m_rng.integers(0, cout, (m_t, m_s)) if cout > 1
            else m_rng.integers(-2000, 2000, (m_t, m_s)), device=dev)
        m_tabs = (torch.tensor(m_edges, dtype=torch.float32, device=dev),
                  flatten_ftable(m_ftable, m_strides).to(dev),
                  build_dtable_flat(m_dtable, cout, cout > 1),
                  pad_dtable(m_dtable))
        x_m = edge_rows(m_tabs[0], 16000, m_rng)
        x_m[2, 1] = float("nan")
        for select in ("matmul", "compare"):
            _check_selects(ek, check_launch, m_tabs, x_m, select,
                           (1, 127, 128, 129, 2048, 2049, 16000),
                           f"{select}_select")

    # more features (12) than a thread keeps row offsets for in registers
    w_edges = np.sort(m_rng.normal(size=(12, 10)), axis=1)
    w_dtable = torch.tensor(m_rng.integers(0, 3, (9, 4100)), device=dev)
    w_tabs = (torch.tensor(w_edges, dtype=torch.float32, device=dev),
              flatten_ftable(
                  torch.tensor(m_rng.integers(0, 2, (12, 11, 9)),
                               dtype=torch.int32),
                  torch.tensor([[2 ** (11 - j) for j in range(12)]] * 9,
                               dtype=torch.int32)).to(dev),
              build_dtable_flat(w_dtable, 3, True), pad_dtable(w_dtable))
    x_w = edge_rows(w_tabs[0], 2049, m_rng)
    for select in ("matmul", "compare"):
        _check_selects(ek, check_launch, w_tabs, x_w, select, (1, 129, 2049),
                       f"{select}_select:F=12")

    # keys at and past Sp (codes in [0, 3), strides 3^j: keys up to 242):
    # the matmul select adds nothing for such a tree, the compare select
    # reads leaf 0; vote (Co 3 and 32) and sum, past the select crossover
    # (T=70) and below it (T=7), both selects, every staging mode
    for p_t, p_s, cout in ((7, 60, 3), (7, 60, 1), (70, 40, 3), (70, 40, 32),
                           (70, 200, 1)):
        p_edges = np.sort(m_rng.normal(size=(5, 34)), axis=1)
        p_edges[:, -8:] = np.inf
        p_dtable = torch.tensor(
            m_rng.integers(0, cout, (p_t, p_s)) if cout > 1
            else m_rng.integers(-2000, 2000, (p_t, p_s)), device=dev)
        p_tabs = (torch.tensor(p_edges, dtype=torch.float32, device=dev),
                  flatten_ftable(
                      torch.tensor(m_rng.integers(0, 3, (5, 35, p_t)),
                                   dtype=torch.int32),
                      torch.tensor([[81, 27, 9, 3, 1]] * p_t,
                                   dtype=torch.int32)).to(dev),
                  build_dtable_flat(p_dtable, cout, cout > 1),
                  pad_dtable(p_dtable))
        x_p = edge_rows(p_tabs[0], 2049, m_rng)
        keys = ek.decision_keys(x_p, p_tabs[0], p_tabs[1], p_t)
        past = int((keys >= p_tabs[2].shape[2]).sum())
        if not past:
            raise AssertionError("no key past Sp in the keys-past-Sp case")
        for select in ("matmul", "compare"):
            _check_selects(ek, check_launch, p_tabs, x_p, select,
                           (1, 129, 2049),
                           f"{select}_select:keys_past_Sp({past} of "
                           f"{keys.numel()})")

    # the classical lookup (B3): the served SVM (M=1), NB and K-Means (M=2)
    # tables and the synthetic 5-class SVM (M=10), on the test rows at the
    # served batches (1952: the ragged last one) and on rows on the edges
    # with NaN / +-inf around the 128-row block, in every staging mode that
    # fits ('all', 'edges', 'none')
    # (a generator of its own for the rows on the edges, so the cases after
    # it see the same inputs)
    x_cls = edge_rows(cls_tabs[0], 2048)
    cl_rng = np.random.default_rng(23)
    cl_cases = [(k, (a.edges, a.vtable_flat, a.vtable.q.shape[2]), x_all)
                for k, a in classical_arts.items()]
    cl_cases.append(("synthetic_svm5", cls_tabs, x_cls))
    for name, (edges, vflat, m), x_src in cl_cases:
        f, u = edges.shape
        b_pad, m_pad = vflat.shape[0] // f, vflat.shape[1]
        x_edge = edge_rows(edges, 2049, cl_rng)
        x_edge[2, f - 1] = float("nan")
        runs = [("test_rows" if name in classical_arts else "edge_rows",
                 x_src, None, (1, 300, 1952, 2048))]
        runs += [("edge_rows", x_edge, staged,
                  (1, 127, 128, 129, 1952, 2048, 2049))
                 for staged in ("all", "edges", "none")
                 if ck.smem_bytes(f, u, b_pad, m, staged, 128)
                 <= ck.SMEM_BUDGET_BYTES]
        for rows, x_src, staged, ns in runs:
            st = ck.stage_mode(f, u, b_pad, m, 128) if staged is None \
                else staged
            for n in ns:
                x = x_src[:n].contiguous()
                check_launch(
                    "classical", f"classical:{name}",
                    lambda: ck.classical_lookup_fused(x, edges, vflat, m,
                                                      staged=staged),
                    lambda: ck.classical_lookup_fused_ref(x, edges, vflat, m),
                    f"{rows} N={n} F={f} U={u} Bp={b_pad} M={m} Mp={m_pad} "
                    f"staged={st} plan="
                    f"{ck.launch_plan(n, f, u, b_pad, m, st, 128)}")

    served_edges = classical_arts["svm"].edges
    syn_b4 = np.sort(rng.normal(size=(8, 255)), axis=1)
    syn_b4[:, -31:] = np.inf
    syn_b4 = torch.tensor(syn_b4, dtype=torch.float32, device=dev)
    # rows that are not sorted (the count, not a search, is the contract),
    # with ragged +inf pads: U=255, each row's pads a different length
    uns_b4 = rng.normal(size=(5, 255)).astype(np.float32)
    for f_i in range(5):
        uns_b4[f_i, 255 - 13 * (f_i + 1):] = np.inf
    rng.shuffle(uns_b4, axis=1)
    uns_b4 = torch.tensor(uns_b4, device=dev)
    # the main path's own B4 call: a tree fit bins all 16000 training rows
    # with the 64-bin quantile edges it computes (ml/trees.py bin_data)
    xtr_dev = torch.as_tensor(xtr, dtype=torch.float32, device=dev)
    fit_edges = quantile_bin_edges(xtr_dev, 64)
    b4_cases = [("fit", fit_edges, xtr_dev, (xtr_dev.shape[0],))]
    b4_cases += [(name, edges, edge_rows(edges, 16000),
                  (1, 300, 2048, 16000))
                 for name, edges in (("served", served_edges),
                                     ("synthetic", syn_b4),
                                     ("unsorted_ragged", uns_b4))]
    for name, edges, x_src, ns in b4_cases:
        for n in ns:
            x = x_src[:n].contiguous()
            check_launch("bucketize", f"bucketize:{name}",
                         lambda: bk.bucketize(x, edges),
                         lambda: bk.bucketize_ref(x, edges),
                         f"N={n} F={edges.shape[0]} U={edges.shape[1]}")

    _check_stream_kernels(torch, dev, su, ev)
    stream_models = _stream_models(torch, np, dev)
    shapes = _check_new_shapes(torch, np, dev, ek, bk, check_launch,
                               stream_models,
                               build_usecase("finance", n=20000))
    _check_loop_kernel(torch, np, dev, ek, check_launch, rf_art, xgb_art,
                       x_all, rng)
    b8_errs = [_check_decode_attention(torch, np, dev, da)]

    # small-input agreement with the plain table semantics (CPU)
    def check_vs_cpu(art, name):
        p_dev, c_dev = fused_classify(art, x_all[:64], device="cuda")
        p_cpu, c_cpu = table_predict(art.to("cpu"), xte[:64])
        same_pred = torch.equal(p_dev.cpu().long(), p_cpu.long())
        conf_ok = (torch.equal(c_dev.cpu(), c_cpu) if art.agg == "vote"
                   else _ulp_ok(c_cpu.numpy(), c_dev.cpu().numpy()))
        if not (same_pred and conf_ok):
            bad = ((p_dev.cpu().long() != p_cpu.long())
                   | (c_dev.cpu() != c_cpu)).nonzero()[:8, 0]
            raise AssertionError(
                f"{name}: fused_classify on the card != table_predict on the "
                f"CPU at rows {bad.tolist()}: pred {p_dev.cpu()[bad].tolist()}"
                f" vs {p_cpu[bad].tolist()}, conf {c_dev.cpu()[bad].tolist()}"
                f" vs {c_cpu[bad].tolist()}")

    check_vs_cpu(rf_art, "rf_switch")

    # -- 4a. serve: the RF switch through the launcher -------------------------
    _reset_counts()
    runs = {}
    for select in ("auto", "compare"):
        print(f"serve --select {select}:")
        runs[select] = serve.main(["--device", "cuda", "--select", select])
    torch.cuda.synchronize()
    path_a = _counts()
    print(f"main-path launches (a: launcher): {path_a}")
    for select, kernel in (("auto", "matmul"), ("compare", "compare")):
        res = runs[select]
        want = res["batches"]
        if path_a[kernel] != want:
            raise AssertionError(f"{kernel}: {path_a[kernel]} launches "
                                 f"for {want} classify calls")
        srv = res["server"]
        plain = HybridServer(res["artifact"], srv.backend_fn,
                             threshold=srv.threshold, capacity=srv.capacity,
                             use_kernel=False, fuse=False, device="cuda")
        batch = res["pred"].shape[0] // want
        plain_pred = torch.cat([
            plain.classify(res["x_test"][i * batch:(i + 1) * batch])[0]
            for i in range(want)])
        pred = res["pred"]
        if pred.shape != (want * batch,) or not torch.equal(pred, plain_pred):
            raise AssertionError(f"served preds != plain preds ({select})")
        if not set(pred.unique().tolist()) <= {0, 1}:
            raise AssertionError("predictions outside the two classes")
        for key in ("acc", "precision", "recall", "f1"):
            if not np.isfinite(res[key]):
                raise AssertionError(f"{key} is not finite")
        print(f"serve[{select}] acc={res['acc']:.4f} "
              f"precision={res['precision']:.4f} recall={res['recall']:.4f} "
              f"f1={res['f1']:.4f} "
              f"handled_at_switch={res['stats'].fraction_handled:.4f} "
              f"backend_rows={res['stats'].backend_rows} batches={want} "
              f"preds_equal_plain=True")
    if path_a["bucketize"] < 1:
        raise AssertionError("training on the card did not bin through B4")

    server = runs["auto"]["server"]
    xb = runs["auto"]["x_test"][:2048]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    server.classify(xb)
    torch.cuda.set_sync_debug_mode(0)
    print("classify: no host sync under torch.cuda.set_sync_debug_mode('error')")

    # -- 4b. serve: the classical switches and the isolation forest -----------
    big = runs["auto"]["backend_model"]             # XGB 60x6, trained on the card
    path_b, families = _serve_families(torch, np, dev, xtr, ytr, x_all, yte,
                                       big, classical_arts, km)
    print(f"main-path launches (b: classical + isolation forest): {path_b}")
    n_batches = sum(len(fam["batches"]) for fam in families.values()
                    if fam["server"].artifact.ftable is None)
    if path_b["classical"] != n_batches:
        raise AssertionError(f"classical: {path_b['classical']} launches for "
                             f"{n_batches} classify calls")
    ifo = families["iforest"]
    ifo_art = ifo["server"].artifact
    ifo_select = ek.resolve_select("auto", ifo_art.n_trees,
                                   ifo_art.dtable_flat.shape[2], 1)
    if path_b[ifo_select] != len(ifo["batches"]):
        raise AssertionError(f"{ifo_select}: {path_b[ifo_select]} launches for "
                             f"{len(ifo['batches'])} isolation-forest "
                             f"classify calls")
    if path_b["bucketize"] < 1:
        raise AssertionError("the isolation forest did not bin through B4")
    # the served isolation-forest tables against the plain lookup, at the
    # batch sizes the path gave them (counted outside the path's run)
    ifo_tabs = tables(ifo_art)
    for n in (1, 300, 1952, 2048):
        x = x_all[:n].contiguous()
        check_launch(
            ifo_select, "iforest_switch",
            lambda: ek.ensemble_lookup_fused(x, *ifo_tabs),
            lambda: ek.ensemble_lookup_fused_ref(x, *ifo_tabs),
            f"N={n} T={ifo_art.n_trees} Sp={ifo_art.dtable_flat.shape[2]} "
            f"Co=1 select=auto->{ifo_select}")
    for select in ("compare", "matmul"):
        _check_selects(ek, check_launch, ifo_tabs, x_all, select,
                       (1, 300, 1952, 2048), f"iforest_switch:{select}")
    for name, fam in families.items():
        srv = fam["server"]
        plain = HybridServer(srv.artifact, srv.backend_fn,
                             threshold=srv.threshold, capacity=srv.capacity,
                             use_kernel=False, fuse=False, device="cuda")
        plain_pred = torch.cat([plain.classify(x_all[lo:hi])[0]
                                for lo, hi in fam["batches"]])
        if not torch.equal(fam["raw_pred"], plain_pred):
            raise AssertionError(f"{name}: served preds != plain preds")
        check_vs_cpu(srv.artifact, name)
        if not set(fam["pred"].unique().tolist()) <= {0, 1}:
            raise AssertionError(f"{name}: predictions outside the classes")
        for key in ("acc", "precision", "recall", "f1", "handled"):
            if not np.isfinite(fam[key]):
                raise AssertionError(f"{name}: {key} is not finite")
        print(f"serve[{name}] acc={fam['acc']:.4f} "
              f"precision={fam['precision']:.4f} recall={fam['recall']:.4f} "
              f"f1={fam['f1']:.4f} handled_at_switch={fam['handled']:.4f} "
              f"backend_rows={fam['backend_rows']} rows={fam['pred'].shape[0]} "
              f"batches={[hi - lo for lo, hi in fam['batches']]} "
              f"{fam['note']}preds_equal_plain=True")
    for name in ("svm", "nb", "kmeans"):
        srv = families[name]["server"]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        srv.classify(xb)
        torch.cuda.set_sync_debug_mode(0)
    print("classical classify (svm, nb, kmeans): no host sync under "
          "torch.cuda.set_sync_debug_mode('error')")

    # -- 4c. serve: the streaming path ----------------------------------------
    stream = _serve_stream(torch, np, dev, stream_models)

    # -- 4d. serve: loop tiles, autotune, the fused step ------------------------
    tuned = _serve_tuned(torch, runs["auto"], x_all)

    # -- 4e. serve: the LM backend through the launcher ------------------------
    _serve_lm_launcher(torch, ek, serve, HybridServer)

    # -- 4f. serve: Qwen3-4B at full width, prefill then int8-KV decode --------
    lm = _serve_lm(torch, np, dev)
    b8_errs.append(_check_served_cache(torch, dev, da, lm))

    # -- 4g. serve: chunked streaming and the streaming step graphs ----------
    chunked = _serve_chunked(torch, np, dev, stream_models)

    # -- 4h. serve: the finance use case and its example ----------------------
    finance = _serve_finance(torch, np, dev, serve, check_vs_cpu)

    # -- 4i. serve: cross-window deferral through its graphs -------------------
    deferred = _serve_deferred(torch, np, dev, stream_models)

    # -- 4j. serve: the adversarial scenarios under the fault guard -----------
    scenarios = _serve_scenarios(torch, np, dev)

    # -- 4k. serve: open-ended ingest and observability -------------------------
    ingest = _serve_ingest(torch, np, dev, stream_models)

    # -- 4l. serve: the sharded tier on one NCCL rank ----------------------------
    sharded = _serve_sharded(torch, np, dev, stream_models)

    # -- 4m. the analysis gate and the quickstart / anomaly examples -----------
    gate = _analysis_gate(torch, np, dev, here, stream_models)

    # -- 5. times ------------------------------------------------------------
    served = runs["auto"]["artifact"].to(dev)
    x2048 = xb.contiguous()
    # B1/B2 launches: the launcher's run, both streaming runs, path d, the
    # chunked runs (4g), the finance launcher (4h), the deferral (4i),
    # scenario (4j), ingest (4k), sharded (4l) and gate (4m) runs
    slice_totals = {}
    for totals in (chunked["totals"], deferred["totals"],
                   scenarios["totals"], ingest["totals"],
                   sharded["totals"], gate["totals"]):
        _add(slice_totals, totals)
    path_ac = {k: path_a[k] + sum(r["path"][k]
                                  for r in stream["runs"].values())
               + sum(p[k] for p in tuned["paths"].values())
               + slice_totals.get(k, 0) + finance["path"][k]
               for k in ("matmul", "compare")}
    kernel_rows = []
    # B2 at both of its main-path shapes, each with its own launches: the
    # RF switch's (the launcher's select=compare run and path d's sweep) and
    # the isolation forest's (path b)
    timing_cases = [("ensemble_lookup:matmul", served, "matmul",
                     "src/repro/kernels/ensemble_lookup.py:112",
                     path_ac["matmul"]),
                    ("ensemble_lookup:compare", served, "compare",
                     "src/repro/kernels/ensemble_lookup.py:132",
                     path_ac["compare"]),
                    ("ensemble_lookup:compare[iforest]", ifo_art, "compare",
                     "src/repro/kernels/ensemble_lookup.py:132",
                     path_b["compare"])]
    for name, art, select, replaces, launches in timing_cases:
        kernel_rows.append(_time_kernel(torch, ek, name, tables(art), x2048,
                                        select, replaces, launches))
    # the backend's compare shape, reported beside the main-path rows
    extra = [_time_kernel(torch, ek, "ensemble_lookup:compare[xgb_backend]",
                          tables(xgb_art), x2048, "compare",
                          "src/repro/kernels/ensemble_lookup.py:132", 0)]
    cl_rows = {name: _time_classical(torch, ck, f"classical_lookup[{name}]",
                                     families[name]["server"].artifact, x2048,
                                     path_b["classical"])
               for name in ("nb", "svm", "kmeans")}
    kernel_rows.append(dict(cl_rows["nb"], name="classical_lookup"))
    kernel_rows.append(_time_bucketize(torch, bk, fit_edges, xtr_dev,
                                       path_b["bucketize"]
                                       + finance["path"]["bucketize"]))
    kernel_rows.append(_time_loop(torch, ek, served, x2048,
                                  sum(p["loop"]
                                      for p in tuned["paths"].values())))
    for row in kernel_rows + extra + [cl_rows["svm"], cl_rows["kmeans"]]:
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.5f} ms")
        print(f"time {row['name']}: kernel {row['ms']:.5f} ms (graph), "
              f"{row['ms_eager']:.5f} ms (eager call); plain "
              f"{row['plain_ms']:.5f} ms (graph), "
              f"{row['plain_ms_eager']:.5f} ms (eager); library {lib}; bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}); "
              f"shape {row['shape']}; on {smi}")
    # rows a block (tile_n; the default is 128) of B1, B2 at both of its
    # shapes and B7: the grid each gives at the serve batch against the
    # card's SMs
    loop_tabs, loop_kw = _loop_args(torch, served)
    sweeps = [
        ("ensemble_lookup:matmul", lambda n: ek.ensemble_lookup_fused(
            x2048, *tables(served), select="matmul", tile_n=n)),
        ("ensemble_lookup:compare", lambda n: ek.ensemble_lookup_fused(
            x2048, *tables(served), select="compare", tile_n=n)),
        ("ensemble_lookup:compare[iforest]",
         lambda n: ek.ensemble_lookup_fused(x2048, *tables(ifo_art),
                                            select="compare", tile_n=n)),
        ("ensemble_lookup_loop", lambda n: ek.ensemble_lookup_loop(
            x2048, *loop_tabs, tile_n=n, **loop_kw))]
    for name, call in sweeps:
        for tile_n in (16, 32, 64, 128, 512):
            ms = _graph_ms(torch, lambda: call(tile_n))
            print(f"time {name} tile_n={tile_n} "
                  f"({-(-x2048.shape[0] // tile_n)} blocks): kernel "
                  f"{ms:.5f} ms (graph) on {smi}")

    for name, srv in [("rf", server)] + [(k, families[k]["server"])
                                         for k in ("svm", "nb", "kmeans",
                                                   "iforest")]:
        eager = _median_ms(torch, lambda: srv.classify(xb))
        graph = _graph_ms(torch, lambda: srv.classify(xb), inner=5)
        print(f"time classify[{name}](batch=2048, full hybrid step, XGB 60x6 "
              f"backend) median {eager:.4f} ms per eager call, {graph:.4f} ms "
              f"device time (graph replay) on {smi}")
    _time_parts(torch, fused_classify, server, xb, "rf", smi)
    _time_parts(torch, fused_classify, families["nb"]["server"], xb, "nb", smi)
    _time_tuned(torch, tuned, xb, smi)

    stream_rows, stream_extra = _time_stream(torch, np, stream, smi)
    for row, key in zip(stream_rows, ("stream_update", "evict_fill")):
        row["launches"] += slice_totals.get(key, 0)   # 4g, 4i-4m
    kernel_rows += stream_rows
    for row in stream_rows + stream_extra:
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.5f} ms")
        print(f"time {row['name']}: kernel {row['ms']:.5f} ms (graph), "
              f"{row['ms_eager']:.5f} ms (eager call); plain "
              f"{row['plain_ms']:.5f} ms (graph), "
              f"{row['plain_ms_eager']:.5f} ms (eager); library {lib}; bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}); "
              f"shape {row['shape']}; on {smi}")

    chunk_rows, chunk_times = _time_chunked(torch, np, ek, bk, stream_models,
                                            chunked, shapes, finance, smi)
    kernel_rows += [chunk_rows[0], chunk_rows[2]]   # B1 at K=16, B4 at F=130
    print("times (phase 5, chunked streaming and finance): "
          + json.dumps(chunk_times))
    defer_times = _time_deferred(torch, np, deferred, scenarios, smi)
    print("times (phase 5, deferral and scenarios): "
          + json.dumps(defer_times))
    ingest_times = _time_ingest(torch, np, ingest, smi)
    print("times (phase 5, ingest and observability): "
          + json.dumps(ingest_times))
    sharded_times = _time_sharded(torch, np, sharded, smi)
    print("times (phase 5, the sharded tier at D=1): "
          + json.dumps(sharded_times))

    lm_row = _time_lm(torch, dev, da, lm, max(b8_errs), smi)
    kernel_rows.append(lm_row)
    _profile_decode(torch, lm, smi)
    _profile_decode(torch, lm, smi, route="graph")
    del lm
    torch.cuda.empty_cache()

    # -- 4n. serve: the other six LM families through ServeEngine ---------------
    # (after phase 5's LM times, so that phase 4f's model is freed first)
    lm_families = _serve_lm_families(torch, np, dev, da, smi)
    lm_row["launches"] += lm_families["launches"]
    lm_row["families"] = lm_families["rows"]
    print("times (phase 5, the LM families): "
          + json.dumps(lm_families["rows"]))

    # -- 6. results ----------------------------------------------------------
    print("kernels: " + json.dumps([r["name"] for r in kernel_rows]))
    print(smi)
    print(json.dumps({"kernels": kernel_rows}))
    import torch.distributed as dist
    dist.destroy_process_group()          # phase 4l's one-rank NCCL group
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _reset_counts():
    from repro_torch.analysis.dispatch_utils import reset_kernel_launches
    reset_kernel_launches()


def _counts() -> dict:
    """Every kernel's launch count, by kernel (B1 matmul, B2 compare, B7
    loop, B3 classical, B4 bucketize, B5 stream_update, B6 evict_fill, B8
    decode_attention)."""
    from repro_torch.analysis.dispatch_utils import kernel_launches
    return kernel_launches()


def _max_abs_err(a, b) -> float:
    """Largest |a - b|, equal entries (the +-inf identities too) counting 0."""
    if a.numel() == 0:
        return 0.0
    d = (a.double() - b.double()).abs()
    return float(d.masked_fill(a == b, 0.0).max())


def _stream_inputs(torch, dev, n, w, *, base=0.0, hot=False, gen=None):
    """A register file of N buckets (40% occupied, integer counts from
    ``base``, first/last timestamps below zero, the +-inf identities on the
    rest) and a W-lane window: negative timestamps, a fifth of the lanes
    invalid, and either every lane on bucket 0 (``hot``) or random buckets
    with four ids outside [0, N)."""
    u = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    occ = u(n) < 0.4
    occ[0] = occ[0] | hot          # the hot bucket holds a flow's counts
    cnt = torch.floor(u(n) * 59.0) + 1.0
    regs = torch.empty((8, n), dtype=torch.float32, device=dev)
    for r in (0, 1, 4, 5, 6, 7):
        scale = 700.0 if r in (1, 6, 7) else 1.0
        regs[r] = torch.where(occ, base + cnt * scale, 0.0)
    t_first = -40.0 * u(n)
    regs[2] = torch.where(occ, t_first, float("inf"))
    regs[3] = torch.where(occ, t_first + 5.0 * u(n), float("-inf"))
    if hot:
        bucket = torch.zeros(w, dtype=torch.int32, device=dev)
    else:
        bucket = torch.randint(0, n, (w,), generator=gen, device=dev,
                               dtype=torch.int32)
        if w >= 4:
            bucket[:4] = torch.tensor([-1, -n - 5, n, n + 9],
                                      dtype=torch.int32, device=dev)
    ts = 60.0 * u(w) - 30.0
    length = torch.floor(u(w) * 1460.0) + 40.0
    is_fwd = (u(w) < 0.55).to(torch.float32)
    valid = u(w) < 0.8
    return regs, (bucket, ts, length, is_fwd, valid)


def _check_stream_kernels(torch, dev, su, ev):
    """Phase 3 for B5 and B6: each kernel call against its plain version on
    the same inputs, atol=0, one launch per call."""
    from repro_torch.kernels import _build
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    lim24 = float(1 << 24)
    cases = [(n, w, limit, "random")
             for n in (600, 8192, 1 << 20) for w in (1, 96, 1024, 4096)
             for limit in (None, 1000.0, lim24)]
    cases += [(8192, 4096, limit, "hot") for limit in (None, 1000.0, lim24)]
    # the one-launch redesign's edges: N not a multiple of its tile, an
    # empty window, a window with no valid lane, -0.0 count registers on
    # the columns the window does not name
    cases += [(n, w, limit, kind)
              for n, w, kind in ((8209, 1024, "random"), (8192, 0, "random"),
                                 (8192, 1024, "invalid"),
                                 (8192, 1024, "neg_zero"))
              for limit in (None, 1000.0, lim24)]
    for n, w, limit, kind in cases:
        # at the 2^24 clamp the registers start 60000 below it, so the
        # window's sums cross it; without a clamp everything stays below
        base = lim24 - 60000.0 if limit == lim24 else 0.0
        regs, cols = _stream_inputs(torch, dev, n, w, base=base,
                                    hot=kind == "hot", gen=gen)
        if kind == "invalid":
            cols = cols[:4] + (torch.zeros_like(cols[4]),)
        elif kind == "neg_zero":
            named = torch.zeros(n, dtype=torch.bool, device=dev)
            b = cols[0].long()
            named[b[(b >= 0) & (b < n)]] = True
            counts = [0, 1, 4, 5, 6, 7]
            regs[counts] = torch.where(named, regs[counts], -0.0)
        want_regs, want_rows = su.stream_update_ref(regs, *cols, limit=limit)
        before = su.LAUNCHES["stream_update"]
        got_regs, got_rows = su.stream_update(regs, *cols, limit=limit)
        torch.cuda.synchronize()
        launched = su.LAUNCHES["stream_update"] - before
        err = max(_max_abs_err(got_regs, want_regs),
                  _max_abs_err(got_rows, want_rows))
        crossed = int((got_regs[[1, 6, 7]] == lim24).sum()) if limit == lim24 \
            else 0
        if kind == "hot" and limit == lim24 and crossed == 0:
            raise AssertionError("the hot bucket's sums did not reach 2^24")
        print(f"case stream_update N={n} W={w} limit={limit} {kind} "
              f"tile={su.tile_columns(n, _build.sm_count(dev))} "
              f"launches={launched} max_abs_diff={err} at_2^24={crossed}")
        if launched != 1 or not (torch.equal(got_regs, want_regs)
                                 and torch.equal(got_rows, want_rows)):
            raise AssertionError(f"stream_update kernel != plain at N={n} "
                                 f"W={w} limit={limit} {kind}")
    fills = torch.tensor([0.0, 0.0, float("inf"), float("-inf"), 0.0, 0.0,
                          0.0, 0.0], device=dev)
    for n in (600, 8192, 8209, 1 << 20):
        regs, _ = _stream_inputs(torch, dev, n, 1, gen=gen)
        for kind in ("random", "all", "none"):
            mask = {"random": torch.rand(n, generator=gen, device=dev) < 0.3,
                    "all": torch.ones(n, dtype=torch.bool, device=dev),
                    "none": torch.zeros(n, dtype=torch.bool,
                                        device=dev)}[kind]
            want = ev.evict_fill_ref(regs, mask, fills)
            before = ev.LAUNCHES["evict_fill"]
            got = ev.evict_fill(regs, mask, fills)
            torch.cuda.synchronize()
            launched = ev.LAUNCHES["evict_fill"] - before
            print(f"case evict_fill N={n} mask={kind} launches={launched} "
                  f"max_abs_diff={_max_abs_err(got, want)}")
            if launched != 1 or not torch.equal(got, want):
                raise AssertionError(f"evict_fill kernel != plain at N={n} "
                                     f"mask={kind}")
    # the timeout sweep (B6's second entry, in place) against its plain
    # composition on a copy of the same register file: the state after it
    # and the count
    age = 5.0
    for n in (600, 8192, 8209, 1 << 20):
        for w in (1, 1024, 4096):
            for case in SWEEP_CASES:
                regs, ts, valid = _sweep_inputs(torch, dev, n, w, case, age,
                                                gen)
                want, want_n = ev.timeout_sweep_ref(regs, ts, valid, age,
                                                    fills)
                before = ev.LAUNCHES["evict_fill"]
                got, n_ev = ev.timeout_sweep(regs.clone(), ts, valid, age,
                                             fills)
                torch.cuda.synchronize()
                launched = ev.LAUNCHES["evict_fill"] - before
                print(f"case evict_fill:timeout_sweep N={n} W={w} {case} "
                      f"plan={ev.sweep_plan(n, _build.sm_count(dev))} "
                      f"launches={launched} evicted={int(n_ev)} "
                      f"plain_evicted={int(want_n)} "
                      f"max_abs_diff={_max_abs_err(got, want)}")
                if launched != 1 or not torch.equal(got, want) \
                        or int(n_ev) != int(want_n):
                    raise AssertionError(f"timeout sweep kernel != plain at "
                                         f"N={n} W={w} {case}")
                if case in ("no_valid", "nan_ts", "none") and int(n_ev):
                    raise AssertionError(f"the {case} sweep evicted")
                if case == "all" and int(n_ev) != n:
                    raise AssertionError("the 'all' sweep left columns")


SWEEP_CASES = ("random", "no_valid", "nan_ts", "at_cutoff", "all", "none")


def _sweep_inputs(torch, dev, n, w, case, age, gen):
    """A register file and a window (``_stream_inputs``) for one case of
    the timeout sweep: as drawn ('random'); no valid lane (cutoff -inf); a
    NaN timestamp on a valid lane (cutoff NaN); a third of the occupied
    columns last seen exactly at the cutoff (they survive); every column
    occupied and the window 100 s later (all evicted); the window 100 s
    earlier (none evicted)."""
    from repro_torch.kernels.evict import evict_cutoff
    regs, cols = _stream_inputs(torch, dev, n, w, gen=gen)
    ts, valid = cols[1], cols[4]
    if case == "no_valid":
        valid = torch.zeros_like(valid)
    elif case == "nan_ts":
        valid[0] = True
        ts[0] = float("nan")
    elif case == "at_cutoff":
        valid[0] = True
        cut = evict_cutoff(ts, valid, age)
        regs[3, 1::3] = torch.where(regs[0, 1::3] > 0, cut, regs[3, 1::3])
    elif case == "all":
        regs[0].clamp_(min=1.0)
        valid[0] = True
        ts = ts + 100.0
    elif case == "none":
        ts = ts - 100.0
    return regs, ts, valid


def _serve_tuned(torch, res, x_all):
    """Phase 4d: ``HybridServer``'s tiles, autotune and fuse at the serve
    default's full width (the launcher's RF 10x5 artifact and XGB 60x6
    backend, tau 0.7, capacity 1024) over all 4000 test rows in batches of
    2048 (the last 1952), each held bit for bit (preds, frac, rows) to the
    plain path and the default eager server. Three sub-paths, each with
    every launch count set to 0 just before it and read just after:
    i. ``tiles=TileConfig(impl='loop')``: one B7 launch and no B1/B2 per
       classify; ii. ``autotune=True``: the sweep (each candidate's graph
       capture counts its launches once; replays launch what was captured)
       must time every candidate; iii. ``fuse=None``: the probe, a CUDA
       graph per shape, an ``update_tables`` swap under the captured graphs,
       then a backend that syncs the host, which must fall back."""
    import dataclasses
    from repro_torch.kernels import tuning
    from repro_torch.kernels.tuning import DEFAULT_TILES, TileConfig
    from repro_torch.serving.hybrid_serving import HybridServer

    art, backend = res["artifact"], res["server"].backend_fn
    n = x_all.shape[0]
    batches = [(lo, min(lo + 2048, n)) for lo in range(0, n, 2048)]
    kw = dict(threshold=0.7, capacity=1024)

    def serve(srv):
        out = []
        for lo, hi in batches:
            pred, st = srv.classify(x_all[lo:hi])
            out.append((pred, *st.as_tensors()))
        return out

    def same(a, b):
        return all(torch.equal(u, v) for ra, rb in zip(a, b)
                   for u, v in zip(ra, rb))

    plain = serve(HybridServer(art, backend, use_kernel=False, fuse=False,
                               **kw))
    eager = HybridServer(art, backend, fuse=False, **kw)
    default = serve(eager)
    if not same(default, plain):
        raise AssertionError("default server != plain path")
    sizes = [hi - lo for lo, hi in batches]
    paths = {}

    # i. the per-feature-loop realization
    loop_srv = HybridServer(art, backend, tiles=TileConfig(impl="loop"),
                            fuse=False, **kw)
    _reset_counts()
    got = []
    for lo, hi in batches:
        before = _counts()
        pred, st = loop_srv.classify(x_all[lo:hi])
        delta = {k: v - before[k] for k, v in _counts().items()}
        if delta["loop"] != 1 or delta["matmul"] or delta["compare"]:
            raise AssertionError(f"tiles=loop: one classify launched {delta}")
        got.append((pred, *st.as_tensors()))
    torch.cuda.synchronize()
    paths["loop_tiles"] = _counts()
    print(f"main-path launches (d.i: tiles=loop): {paths['loop_tiles']}")
    if not (same(got, plain) and same(got, default)):
        raise AssertionError("tiles=loop: served != plain / default server")
    print(f"serve[tiles=loop] batches={sizes} one B7 launch per classify, no "
          f"B1/B2; preds, frac, rows equal_plain=True equal_default=True")

    # ii. the tile autotune
    tuning.clear_tile_cache()
    _reset_counts()
    t0 = time.perf_counter()
    tuned = HybridServer(art, backend, autotune=True, fuse=False, **kw)
    sweep_s = time.perf_counter() - t0
    got = serve(tuned)
    torch.cuda.synchronize()
    paths["autotune"] = _counts()
    print(f"main-path launches (d.ii: autotune=True, the sweep's captures "
          f"included): {paths['autotune']}")
    timings = tuning.sweep_timings(tuned.artifact)
    want = tuning.candidate_tiles(2048) + [DEFAULT_TILES]
    for c in want:
        ms = "MISSING" if c not in timings else f"{timings[c] * 1e3:.5f} ms"
        print(f"autotune candidate tile_n={c.tile_n} select={c.select} "
              f"impl={c.impl}: {ms} per fused_classify call (graph replay, "
              f"min of 2)")
    missing = [c for c in want if c not in timings]
    if missing or set(timings) != set(want):
        raise AssertionError(f"the sweep did not time {missing}")
    if paths["autotune"]["loop"] < 1:
        raise AssertionError("the sweep never launched B7")
    if not same(got, plain):
        raise AssertionError("autotune: served != plain path")
    print(f"autotune winner tile_n={tuned.tiles.tile_n} "
          f"select={tuned.tiles.select} impl={tuned.tiles.impl} "
          f"(sweep {sweep_s:.2f} s); preds, frac, rows equal_plain=True")

    # iii. the fused step
    _reset_counts()
    fused = HybridServer(art, backend, **kw)          # fuse=None
    got1 = serve(fused)     # probes on the first call, captures the second
    got2 = serve(fused)     # captures 2048, replays 1952
    torch.cuda.synchronize()
    paths["fuse"] = _counts()
    print(f"main-path launches (d.iii: fuse=None; the probe, warm-ups and "
          f"captures; replays launch what was captured): {paths['fuse']}")
    if fused._fused_ok is not True:
        raise AssertionError("fuse=None did not fuse a torch backend")
    if not (same(got1, default) and same(got2, default)):
        raise AssertionError("fused server != eager server")
    graphs = dict(fused._graphs)
    ptrs = [t.data_ptr() for t in (fused.artifact.ftable_flat,
                                   fused.artifact.dtable_flat,
                                   fused.artifact.dtable_class)]
    flipped = dataclasses.replace(art, dtable_class=1 - art.dtable_class,
                                  ftable_flat=None, dtable_flat=None,
                                  dtable_pad=None)
    fused.update_tables(flipped)
    got3 = serve(fused)
    want3 = serve(HybridServer(flipped, backend, fuse=False, **kw))
    kept = [t.data_ptr() for t in (fused.artifact.ftable_flat,
                                   fused.artifact.dtable_flat,
                                   fused.artifact.dtable_class)] == ptrs
    if fused._graphs != graphs or not kept or not same(got3, want3) \
            or same(got3, default):
        raise AssertionError("update_tables under a captured graph did not "
                             "serve the new tables")
    fused.update_tables(art)
    if not same(serve(fused), default):
        raise AssertionError("update_tables back to the served tables")

    def np_backend(rows):                         # a host round trip
        return backend(rows).cpu().numpy()

    np_srv = HybridServer(art, np_backend, **kw)
    got4 = serve(np_srv)
    if np_srv._fused_ok is not False or np_srv._graphs \
            or not same(got4, default):
        raise AssertionError("a syncing backend did not fall back eagerly")
    print(f"serve[fuse=None] _fused_ok={fused._fused_ok} graphs="
          f"{sorted(fused._graphs)} preds, frac, rows equal_eager=True; "
          f"update_tables swap served the new tables, no re-capture, same "
          f"data_ptr=True; numpy backend _fused_ok={np_srv._fused_ok} "
          f"equal_eager=True")
    return dict(paths=paths, eager=eager, fused=fused, loop=loop_srv,
                tuned=tuned, timings=timings)


def _check_selects(ek, check_launch, tabs, x_src, select, ns, name):
    """Phase 3 for B1/B2: ``select`` on ``tabs`` against its plain version
    in every staging mode whose shared memory fits one block, at each N."""
    edges, ftable_flat, dtable_flat, _ = tabs
    f, u = edges.shape
    b_pad, t_pad = ftable_flat.shape[0] // f, ftable_flat.shape[1]
    cout, t, s_pad = dtable_flat.shape
    for staged in ("all", "keys", "none"):
        if ek.smem_bytes(f, u, b_pad, t_pad, t, s_pad, cout, select, staged,
                         128) > ek.SMEM_BUDGET_BYTES:
            continue
        for n in ns:
            x = x_src[:n].contiguous()
            plan = ek.launch_plan(n, f, u, b_pad, t_pad, t, s_pad, cout,
                                  select, staged, 128)
            check_launch(
                select, name,
                lambda: ek.ensemble_lookup_fused(x, *tabs, select=select,
                                                 staged=staged),
                lambda: ek.ensemble_lookup_fused_ref(x, *tabs, select=select),
                f"N={n} F={f} U={u} T={t} Sp={s_pad} Co={cout} "
                f"staged={staged} plan={plan}")


def _loop_args(torch, art):
    """B7's operands from an artifact: the unflattened tables, the decision
    table as f32 (what ``fused_classify(impl='loop')`` hands the kernel)."""
    vote = art.agg == "vote"
    dtable = (art.dtable_class if vote else art.dtable_value.q)
    return ((art.edges, art.ftable, art.strides, dtable.to(torch.float32)),
            dict(n_classes=art.n_classes, vote=vote))


def _check_loop_kernel(torch, np, dev, ek, check_launch, rf_art, xgb_art,
                       x_all, rng):
    """Phase 3 for B7: the kernel against its plain version, atol=0, one
    launch per call, at N in {1, 127, 128, 129, 2048, 2049} (and 16000 on
    the hand-built tables): the served RF switch (vote; tables staged and
    global), the mapped XGB 60x6 backend (sum; global: its 1.4 MB decision
    table does not fit a block), and hand-built artifacts whose keys run
    past S (codes in [0, 3), strides 3^f: keys up to 242 against S = 200,
    vote and sum; up to 26 against S = 20 with Co = 32), on normal rows and
    on rows on the edges with NaN / +-inf."""
    def hand_built(gen, f, u, t, s):
        edges = np.sort(gen.normal(size=(f, u)), axis=1).astype(np.float32)
        return (torch.tensor(edges, device=dev),
                torch.tensor(gen.integers(0, 3, (f, u + 1, t)),
                             dtype=torch.int32, device=dev),
                torch.tensor([[3 ** j for j in range(f)]] * t,
                             dtype=torch.int32, device=dev))

    def on_edges(gen, edges, n):
        e = edges.cpu().numpy()
        f, u = e.shape
        x = (gen.normal(size=(n, f)) * 1.2).astype(np.float32)
        on = gen.random((n, f)) < 0.3
        pick = e[np.arange(f)[None, :], gen.integers(0, u, (n, f))]
        x[on] = pick[on]
        x[0, 0], x[1, 0], x[2, f - 1] = np.nan, np.inf, -np.inf
        return torch.tensor(x, device=dev)

    f, u, t, s = 5, 39, 10, 200
    hb = hand_built(rng, f, u, t, s)
    hb_vote = torch.tensor(rng.integers(0, 3, (t, s)), dtype=torch.float32,
                           device=dev)
    hb_sum = torch.tensor(rng.integers(-30000, 30000, (t, s)),
                          dtype=torch.float32, device=dev)
    x_hb = torch.tensor(rng.normal(size=(2049, f)) * 1.2, dtype=torch.float32,
                        device=dev)
    gen = np.random.default_rng(23)             # the new cases' own inputs
    x_hb_edges = on_edges(gen, hb[0], 16000)
    hb32 = hand_built(gen, 3, 9, 33, 20)
    hb32_vote = torch.tensor(gen.integers(0, 32, (33, 20)),
                             dtype=torch.float32, device=dev)
    x_rf_edges = on_edges(gen, rf_art.edges, 2049)
    ns = (1, 127, 128, 129, 2048, 2049)
    cases = [("rf_switch", *_loop_args(torch, rf_art), x_all, None, ns),
             ("rf_switch", *_loop_args(torch, rf_art), x_all, False, ns),
             ("rf_switch:edges", *_loop_args(torch, rf_art), x_rf_edges,
              None, ns),
             ("xgb_backend", *_loop_args(torch, xgb_art), x_all, None, ns),
             ("key_past_S:vote", hb + (hb_vote,),
              dict(n_classes=3, vote=True), x_hb, None, ns),
             ("key_past_S:vote", hb + (hb_vote,),
              dict(n_classes=3, vote=True), x_hb, False, ns),
             ("key_past_S:sum", hb + (hb_sum,), dict(n_classes=2, vote=False),
              x_hb, None, ns),
             ("key_past_S:vote:edges", hb + (hb_vote,),
              dict(n_classes=3, vote=True), x_hb_edges, None, ns + (16000,)),
             ("key_past_S:sum:edges", hb + (hb_sum,),
              dict(n_classes=2, vote=False), x_hb_edges, False,
              ns + (16000,)),
             ("key_past_S:vote32", hb32 + (hb32_vote,),
              dict(n_classes=32, vote=True), on_edges(gen, hb32[0], 2049),
              None, ns),
             ("key_past_S:vote32", hb32 + (hb32_vote,),
              dict(n_classes=32, vote=True), on_edges(gen, hb32[0], 2049),
              False, ns)]
    for name, tabs, kw, x_src, staged, n_list in cases:
        f, u = tabs[0].shape
        t, s = tabs[3].shape
        st = (ek.loop_fits_smem(f, u, t, s, 128) if staged is None
              else staged)
        for n in n_list:
            x = x_src[:n].contiguous()
            check_launch(
                "loop", f"ensemble_lookup_loop:{name}",
                lambda: ek.ensemble_lookup_loop(x, *tabs, staged=staged, **kw),
                lambda: ek.ensemble_lookup_loop_ref(x, *tabs, **kw),
                f"N={n} F={f} U={u} T={t} S={s} Co={kw['n_classes']} "
                f"vote={kw['vote']} staged={st} "
                f"plan={ek.loop_launch_plan(n, f, u, t, s, st, 128)}")


STREAM_RUNS = (("no_eviction", {}),
               ("evict_timeout", {"evict_age": 5.0,
                                  "evict_policy": "timeout"}))


def _stream_models(torch, np, dev):
    """The repo's streaming configuration (``benchmarks/stream_bench.py``):
    ``synth_trace(n_flows=4000, seed=0)``, 8192 buckets, windows of 1024;
    an RF 4x3 switch and an RF 16x6 backend trained on the card on the
    trace's batch flow features. -> dict(trace, table, art, backend)."""
    from repro_torch.core.mapping import map_tree_ensemble
    from repro_torch.ml.trees import fit_random_forest, predict_tree_ensemble
    from repro_torch.netsim.features import flow_features
    from repro_torch.netsim.packets import synth_trace

    trace = synth_trace(n_flows=4000, seed=0)
    b, table = flow_features(trace, n_buckets=STREAM_BUCKETS)
    first = np.unique(trace.flow_id, return_index=True)[1]
    rows = table[b[torch.as_tensor(first, device=dev)].long()]
    small = fit_random_forest(rows, trace.flow_label, n_classes=2, n_trees=4,
                              max_depth=3, seed=0, device=dev)
    big = fit_random_forest(rows, trace.flow_label, n_classes=2, n_trees=16,
                            max_depth=6, seed=1, device=dev)

    def backend(r):
        return predict_tree_ensemble(big, r)

    return dict(trace=trace, table=table, backend=backend, big=big,
                art=map_tree_ensemble(small, rows.shape[1]))


STREAM_BUCKETS, STREAM_WINDOW = 8192, 1024
STREAM_KW = dict(n_buckets=STREAM_BUCKETS, window=STREAM_WINDOW,
                 threshold=0.9, capacity=64)


def _serve_stream(torch, np, dev, models):
    """Phase 4c: the repo's streaming configuration (``_stream_models``)
    served on the card by ``StreamingHybridServer.serve_trace`` window by
    window on the eager route (``fuse=False``; the graph routes are phase
    4g's), once per ``STREAM_RUNS`` entry, each with every launch count set
    to 0 just before it and read just after. Checks launches per step,
    equality with the same server on the plain path, the flow table
    against the batch oracle (no eviction), that eviction happened (timeout
    policy), and that a step does not sync."""
    from repro_torch.kernels import ensemble_lookup as ek
    from repro_torch.ml.metrics import accuracy
    from repro_torch.netsim.stream import iter_windows
    from repro_torch.serving.stream_serving import StreamingHybridServer

    n_buckets, window = STREAM_BUCKETS, STREAM_WINDOW
    trace, table = models["trace"], models["table"]
    art, backend = models["art"], models["backend"]
    truth = trace.flow_label[trace.flow_id]
    kw = dict(STREAM_KW, fuse=False)
    out = {"trace": trace, "runs": {}}
    for name, extra in STREAM_RUNS:
        server = StreamingHybridServer(art, backend, **kw, **extra)
        select = ek.resolve_select("auto", server.artifact.n_trees,
                                   server.artifact.dtable_flat.shape[2],
                                   server.artifact.dtable_flat.shape[0])
        _reset_counts()
        preds, stats = server.serve_trace(trace)
        torch.cuda.synchronize()
        path = _counts()
        n_win = stats.n_windows
        want = {"stream_update": n_win, select: n_win,
                "evict_fill": n_win if extra else 0}
        print(f"main-path launches (c: streaming, {name}): {path}")
        for key, count in path.items():
            if count != want.get(key, 0):
                raise AssertionError(f"{name}: {key} launched {count} times "
                                     f"for {n_win} steps")
        # launches step by step, outside the counted run
        server.reset()
        for w in iter_windows(trace, window, n_buckets):
            before = _counts()
            server.step(w)
            delta = {k: v - before[k] for k, v in _counts().items()}
            if delta != {k: (1 if want.get(k) else 0) for k in delta}:
                raise AssertionError(f"{name}: one step launched {delta}")
        plain = StreamingHybridServer(art, backend, use_kernel=False,
                                      device="cuda", **kw, **extra)
        plain_preds, plain_stats = plain.serve_trace(trace)
        if not torch.equal(preds, plain_preds):
            raise AssertionError(f"{name}: served preds != plain preds")
        got, ref = stats.as_dict(), plain_stats.as_dict()
        for key in got:
            if key in ("conf_sum", "mean_conf"):
                ok = abs(got[key] - ref[key]) <= 1e-5 * abs(ref[key])
            else:
                ok = got[key] == ref[key]
            if not ok:
                raise AssertionError(f"{name}: stats[{key}] {got[key]} != "
                                     f"plain {ref[key]}")
        if not torch.equal(server.flow_table(), plain.flow_table()):
            raise AssertionError(f"{name}: flow table != plain flow table")
        if not extra and not torch.equal(server.flow_table(), table):
            raise AssertionError("streamed flow table != batch flow_features")
        if extra and stats.n_evicted < 1:
            raise AssertionError(f"{name}: the aging sweep evicted nothing")
        if preds.shape != (trace.n_packets,) or \
                not set(preds.unique().tolist()) <= {0, 1}:
            raise AssertionError(f"{name}: predictions of the wrong shape or "
                                 f"outside the classes")
        acc = accuracy(truth, preds)
        if not np.isfinite(acc) or not np.isfinite(stats.mean_conf):
            raise AssertionError(f"{name}: accuracy or confidence not finite")
        w = next(iter(iter_windows(trace, window, n_buckets)))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        server.step(w)
        torch.cuda.set_sync_debug_mode(0)
        print(f"serve_trace[{name}] packets={stats.n_packets} "
              f"windows={n_win} acc={acc:.4f} "
              f"fraction_handled={stats.fraction_handled:.4f} "
              f"backend_rows={stats.total_backend_rows} "
              f"deferred={stats.n_deferred} evicted={stats.n_evicted} "
              f"overflow={stats.n_overflow} mean_conf={stats.mean_conf:.4f} "
              f"preds_equal_plain=True per_step_launches_ok=True "
              f"step_no_host_sync=True"
              + ("" if extra else " flow_table_equals_batch=True"))
        server.reset()
        out["runs"][name] = dict(server=server, path=path, select=select)
    return out


def _time_stream(torch, np, stream, smi):
    """Phase 5 for the streaming path: B5 and B6 at the main path's shape
    (N=8192, W=1024; the register file and window that serving the trace
    leaves at step k): B6's timeout sweep against its plain composition and
    the parent's 14-launch sweep, B6's mask-taking entry against
    ``torch.where``, the floor of one graph-replayed launch; one step eager
    and under graph replay, its parts, and packets per second of
    serve_trace. -> (B5's and B6's JSON rows, [B1 at the step's own shape:
    the window's rows through the RF 4x3 switch])."""
    from repro_torch.core.hybrid import combine, dispatch
    from repro_torch.kernels import ensemble_lookup as ek
    from repro_torch.kernels import evict as ev
    from repro_torch.kernels import stream_update as su
    from repro_torch.kernels.ops import fused_classify
    from repro_torch.netsim.stream import (OVERFLOW_LIMIT, evict_cutoff,
                                           evict_fills, iter_windows,
                                           window_update_readout)
    from repro_torch.serving.stream_serving import accumulate_stream_stats

    trace = stream["trace"]
    runs = stream["runs"]
    server = runs["evict_timeout"]["server"]
    windows = list(iter_windows(trace, server.window, server.n_buckets))
    k = len(windows) // 2
    server.reset()
    for w in windows[:k]:
        server.step(w)
    w = windows[k]
    regs = server.state.regs.clone()          # what step k's B5 reads
    cols = (w.bucket, w.ts, w.length, w.is_fwd, w.valid)
    n, wl = regs.shape[1], w.size
    path_su = sum(r["path"]["stream_update"] for r in runs.values())
    path_ev = sum(r["path"]["evict_fill"] for r in runs.values())

    # B5: in place on its own copy (the counts grow, clamped at 2^24)
    regs_k = regs.clone()
    out_k = su.stream_update(regs.clone(), *cols, limit=OVERFLOW_LIMIT)
    out_p = su.stream_update_ref(regs, *cols, limit=OVERFLOW_LIMIT)
    err = max(_max_abs_err(out_k[0], out_p[0]), _max_abs_err(out_k[1], out_p[1]))
    ms, ms_eager, plain_ms, plain_eager, _ = _times(
        torch, lambda: su.stream_update(regs_k, *cols, limit=OVERFLOW_LIMIT),
        lambda: su.stream_update_ref(regs, *cols, limit=OVERFLOW_LIMIT))
    # bound: the function in place, on this window. Reads: every column's
    # six count registers (the clamp must see each), t_min/t_max only at
    # the columns the lanes name, the window columns (bucket, ts, length,
    # is_fwd 4 B, valid 1 B). Writes: only the register words whose bits
    # change, and the rows. Per valid lane 8 register updates and 3
    # products, per column 6 adds and 6 compares.
    n_valid = int(w.valid.sum())
    named = int(torch.unique(w.bucket).numel())
    changed = int((out_p[0].view(torch.int32) != regs.view(torch.int32)).sum())
    n_bytes = 6 * n * 4 + 2 * named * 4 + wl * 17 + changed * 4 + 8 * wl * 4
    ops = n_valid * 11 + 12 * n + 8 * wl
    bound_ms, bound_by = _bound(n_bytes, ops)
    rows = [{"name": "stream_update", "route": "cuda",
             "source": "src/repro_torch/csrc/stream_update.cu",
             "replaces": "src/repro/kernels/stream_update.py:61",
             "launches": path_su, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
             "library_ms": None, "ms_eager": ms_eager,
             "plain_ms_eager": plain_eager, "bytes": n_bytes, "ops": ops,
             "shape": {"N": n, "W": wl, "valid_lanes": n_valid,
                       "columns_named": named, "words_changed": changed,
                       "limit": OVERFLOW_LIMIT}}]

    # B6, the timeout sweep (the main path's entry): the register file, the
    # window and the age step k's sweep sees, against its plain composition
    # and against the parent's sweep (the cutoff, the mask, the fills, the
    # mask-taking B6 and the sum, 14 launches); and the floor of one
    # graph-replayed launch
    regs = out_p[0]
    age = server.evict_age
    fills = evict_fills(regs.device)
    want, want_n = ev.timeout_sweep_ref(regs, w.ts, w.valid, age, fills)
    got, got_n = ev.timeout_sweep(regs.clone(), w.ts, w.valid, age, fills)
    sweep_err = _max_abs_err(got, want)
    n_ev = int(want_n)
    if not torch.equal(got, want) or int(got_n) != n_ev:
        raise AssertionError("timeout sweep != plain on step k's state")
    one = torch.zeros(1, device=regs.device)
    floor_ms = _graph_ms(torch, lambda: one.fill_(1.0))
    regs_s = got.clone()        # swept: every later call reads, evicts none
    src = regs.clone()

    def parent_sweep():
        fl = torch.zeros(8, dtype=torch.float32, device=regs.device)
        fl[2:3].fill_(float("inf"))
        fl[3:4].fill_(float("-inf"))
        mask = (regs[0] > 0) & (regs[3] < evict_cutoff(w.ts, w.valid, age))
        return ev.evict_fill(regs, mask, fl), mask.sum(dtype=torch.int32)

    ms, ms_eager, plain_ms, plain_eager, _ = _times(
        torch, lambda: ev.timeout_sweep(regs_s, w.ts, w.valid, age, fills),
        lambda: ev.timeout_sweep_ref(regs, w.ts, w.valid, age, fills))
    parent_ms = _graph_ms(torch, parent_sweep)
    parent_eager = _median_ms(torch, parent_sweep, inner=20)
    copy_ms = _graph_ms(torch, lambda: regs_s.copy_(src))
    copy_sweep_ms = _graph_ms(torch, lambda: (
        regs_s.copy_(src), ev.timeout_sweep(regs_s, w.ts, w.valid, age,
                                            fills)))
    # bound: rows 0 and 3 read, the window (ts 4 B, valid 1 B a lane), the
    # evicted columns' 8 registers and the count written; a max and a min a
    # valid lane, two compares a column
    n_valid = int(w.valid.sum())
    n_bytes = 2 * n * 4 + wl * 5 + 8 * 4 * n_ev + 4
    ops = 2 * n_valid + 2 * n
    bound_ms, bound_by = _bound(n_bytes, ops)
    print(f"time launch floor (one-element fill_, graph of 50): "
          f"{floor_ms:.5f} ms on {smi}")
    print(f"time evict_fill:timeout_sweep N={n} W={wl} evicted={n_ev}: "
          f"kernel {ms:.5f} ms (graph; on the swept file, no writes), "
          f"{ms_eager:.5f} ms (eager call); with its evictions, copy + "
          f"sweep {copy_sweep_ms:.5f} ms less the copy {copy_ms:.5f} ms; "
          f"plain composition {plain_ms:.5f} ms (graph), {plain_eager:.5f} "
          f"ms (eager); the parent's sweep (14 launches) {parent_ms:.5f} ms "
          f"(graph), {parent_eager:.5f} ms (eager); bound {bound_ms:.6f} ms "
          f"({bound_by}) on {smi}")

    # B6, the mask-taking entry (the TPU kernel's counterpart; approx-LRU
    # and callers with a mask of their own), on the same register file and
    # step k's eviction mask
    mask = ((regs[0] > 0) & (regs[3] < evict_cutoff(w.ts, w.valid, age)))
    out_k = ev.evict_fill(regs, mask, fills)
    out_p = ev.evict_fill_ref(regs, mask, fills)
    lib = torch.where(mask[None], fills[:, None], regs)
    print(f"library torch.where(mask[None], fills[:, None], regs) equals the "
          f"kernel: {torch.equal(lib, out_k)}")
    m_ms, m_eager, m_plain, m_plain_eager, m_lib = _times(
        torch, lambda: ev.evict_fill(regs, mask, fills),
        lambda: ev.evict_fill_ref(regs, mask, fills),
        lambda: torch.where(mask[None], fills[:, None], regs))
    m_bytes = 2 * 8 * n * 4 + n + 8 * 4
    m_bound, m_by = _bound(m_bytes, 8 * n)
    print(f"time evict_fill:mask N={n}: kernel {m_ms:.5f} ms (graph), "
          f"{m_eager:.5f} ms (eager); plain {m_plain:.5f} ms; torch.where "
          f"{m_lib:.5f} ms; bound {m_bound:.6f} ms ({m_by}) on {smi}")
    rows.append({"name": "evict_fill", "route": "cuda",
                 "source": "src/repro_torch/csrc/evict.cu",
                 "replaces": "src/repro/kernels/evict.py:27",
                 "launches": path_ev, "max_abs_err": sweep_err,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": None,
                 "ms_eager": ms_eager, "plain_ms_eager": plain_eager,
                 "bytes": n_bytes, "ops": ops,
                 "entry": "timeout_sweep (in place, one launch a step)",
                 "launch_floor_ms": floor_ms,
                 "copy_sweep_ms": copy_sweep_ms, "copy_ms": copy_ms,
                 "parent_sweep_ms": parent_ms,
                 "parent_sweep_ms_eager": parent_eager,
                 "shape": {"R": 8, "N": n, "W": wl, "valid_lanes": n_valid,
                           "evicted": n_ev, "evict_age": age},
                 "mask_entry": {
                     "ms": m_ms, "ms_eager": m_eager, "plain_ms": m_plain,
                     "plain_ms_eager": m_plain_eager, "library_ms": m_lib,
                     "bound_ms": m_bound, "bound_by": m_by, "bytes": m_bytes,
                     "max_abs_err": _max_abs_err(out_k, out_p),
                     "launches": 0, "evicted": int(mask.sum())}})

    # one step, eager and under graph replay, then its parts
    for name, run in runs.items():
        srv = run["server"]
        eager = _median_ms(torch, lambda: srv.step(w))
        graph = _graph_ms(torch, lambda: srv.step(w), inner=5)
        print(f"time stream_step[{name}](W={wl}, N={n}, RF 4x3 switch, RF "
              f"16x6 backend) median {eager:.4f} ms per eager call, "
              f"{graph:.4f} ms device time (graph replay) on {smi}")
    # what eviction adds to an eager step, and the sweep's own eager time
    # against the parent's 14-launch sweep: ten pairs in turns (the host's
    # clock moves 2x between calls, so a difference of two medians taken
    # apart says little)
    no_ev, with_ev = (runs[k]["server"] for k in ("no_eviction",
                                                   "evict_timeout"))
    turns = {"no_eviction": [], "evict_timeout": [], "sweep": [],
             "parent_sweep": []}
    for _ in range(10):
        for key, fn in (("no_eviction", lambda: no_ev.step(w)),
                        ("evict_timeout", lambda: with_ev.step(w)),
                        ("sweep", lambda: ev.timeout_sweep(
                            regs_s, w.ts, w.valid, age, fills)),
                        ("parent_sweep", parent_sweep)):
            turns[key].append(_median_ms(torch, fn, reps=5, warmup=1,
                                         inner=5))
    med = {k: statistics.median(v) for k, v in turns.items()}
    step_cost = statistics.median(
        b - a for a, b in zip(turns["no_eviction"], turns["evict_timeout"]))
    sweep_cut = statistics.median(
        b - a for a, b in zip(turns["sweep"], turns["parent_sweep"]))
    print(f"time stream_step eager, ten pairs in turns: no eviction "
          f"{med['no_eviction']:.4f} ms, evict_timeout "
          f"{med['evict_timeout']:.4f} ms, eviction adds {step_cost:.4f} ms "
          f"(median of the pairs' differences); the sweep eager "
          f"{med['sweep']:.5f} ms against the parent's sweep "
          f"{med['parent_sweep']:.5f} ms, {sweep_cut:.5f} ms less (median "
          f"of the pairs' differences) on {smi}")
    rows[1].update(eviction_eager_ms=step_cost, sweep_eager_cut_ms=sweep_cut)
    srv = runs["evict_timeout"]["server"]
    kw = dict(evict_age=srv.evict_age, saturate=True)
    state = srv.state.clone()       # B5 updates it in place, call by call
    _, x, n_ev, n_ov = window_update_readout(state.clone(), w, **kw)
    sw_pred, conf = fused_classify(srv.artifact, x, tiles=srv.tiles)
    fwd = (conf < srv.threshold) & w.valid
    buf, idx, valid = dispatch(x, fwd, srv.capacity)
    be_pred = srv.backend_fn(buf)

    b1_stream = _time_kernel(
        torch, ek, "ensemble_lookup:matmul[stream_step]",
        (srv.artifact.edges, srv.artifact.ftable_flat,
         srv.artifact.dtable_flat, srv.artifact.dtable_pad), x.contiguous(),
        "matmul", "src/repro/kernels/ensemble_lookup.py:112",
        sum(r["path"]["matmul"] for r in runs.values()))

    def dispatch_backend_combine():
        b_, i_, v_ = dispatch(x, fwd, srv.capacity)
        return combine(sw_pred, srv.backend_fn(b_), i_, v_)

    parts = {
        "register half (B5 + sweep with B6 + guard + readout)":
            lambda: window_update_readout(state, w, **kw),
        "classify (B1 + epilogue)":
            lambda: fused_classify(srv.artifact, x, tiles=srv.tiles),
        "dispatch + backend (RF 16x6) + combine": dispatch_backend_combine,
        "stats fold": lambda: accumulate_stream_stats(
            srv.stats, w, sw_pred, be_pred, idx, valid, fwd, conf, n_ev,
            n_ov)}
    print("time stream_step[evict_timeout] parts: " + ", ".join(
        f"{k} {_median_ms(torch, fn):.4f} ms (eager), "
        f"{_graph_ms(torch, fn, inner=5):.4f} ms (graph)"
        for k, fn in parts.items()) + f" on {smi}")

    for name, run in runs.items():
        srv = run["server"]
        times = []
        for _ in range(5):
            srv.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.serve_trace(trace)          # ends with stats.check(): a sync
            times.append(time.perf_counter() - t0)
        best, med = min(times), statistics.median(times)
        print(f"time serve_trace[{name}] {trace.n_packets} packets in "
              f"{-(-trace.n_packets // srv.window)} windows: median "
              f"{med * 1e3:.2f} ms ({trace.n_packets / med:.0f} packets/s), "
              f"best {best * 1e3:.2f} ms ({trace.n_packets / best:.0f} "
              f"packets/s) on {smi}")
    return rows, [b1_stream]


CHUNK_KS = (1, 2, 8, 16, "auto")


def _check_new_shapes(torch, np, dev, ek, bk, check_launch, models, fin):
    """Phase 3 for this slice's shapes: B1 at the chunk classify's row
    counts (16 and 32 windows of 1024 readout rows from the served trace,
    through the RF 4x3 stream switch, both selects and the resolved one),
    B4 at the finance fit's shape (all 16,000 training rows x 130 features
    against the fit's 64-bin quantile edges), and the payload parse on the
    card against the CPU's on the finance example's 512 rows split at byte
    700 (all 130 columns). Everything atol=0. -> the inputs phase 5 times
    again."""
    from repro_torch.core.artifact import finalize_artifact
    from repro_torch.examples.finance_lowlatency import SPLIT_AT
    from repro_torch.ml.trees import quantile_bin_edges
    from repro_torch.netsim.features import (encode_csv_payload,
                                             file_features_csv,
                                             stitch_split_payload)
    from repro_torch.netsim.stream import (chunk_update_readout,
                                           init_flow_table, iter_chunks)
    art = finalize_artifact(models["art"]).to(dev)
    tabs = (art.edges, art.ftable_flat, art.dtable_flat, art.dtable_pad)
    chunk = next(iter_chunks(models["trace"], STREAM_WINDOW, 32,
                             STREAM_BUCKETS, device=dev))
    _, xs, _, _ = chunk_update_readout(init_flow_table(STREAM_BUCKETS,
                                                       device=dev),
                                       chunk, evict_age=5.0)
    x_chunk = xs.reshape(-1, xs.shape[2]).contiguous()
    cout, t, s_pad = tabs[2].shape
    # B1 at the chunk classify's rows, and at the deferral phase's (512)
    # and the scenario phase's (256) window rows
    for n in (SCENARIO_WINDOW, DEFER_WINDOW, 16 * STREAM_WINDOW,
              32 * STREAM_WINDOW):
        x = x_chunk[:n].contiguous()
        for select in ("auto", "matmul", "compare"):
            resolved = ek.resolve_select(select, t, s_pad, cout)
            check_launch(
                resolved, "chunk_classify",
                lambda: ek.ensemble_lookup_fused(x, *tabs, select=select),
                lambda: ek.ensemble_lookup_fused_ref(x, *tabs, select=select),
                f"N={n} F={x.shape[1]} T={t} Sp={s_pad} Co={cout} "
                f"select={select}->{resolved}")
    xtr, xte = fin[0], fin[2]
    fin_x = torch.as_tensor(xtr, dtype=torch.float32, device=dev)
    fin_edges = quantile_bin_edges(fin_x, 64)
    for n in (1, 300, 2048, fin_x.shape[0]):
        x = fin_x[:n].contiguous()
        check_launch("bucketize", "bucketize:finance_fit",
                     lambda: bk.bucketize(x, fin_edges),
                     lambda: bk.bucketize_ref(x, fin_edges),
                     f"N={n} F={fin_edges.shape[0]} U={fin_edges.shape[1]}")
    payload = encode_csv_payload(xte[:512], width=8)
    cols = list(range(payload.shape[1] // 8))
    host = file_features_csv(payload, cols, device="cpu")
    whole = stitch_split_payload(payload[:, :SPLIT_AT],
                                 payload[:, SPLIT_AT:], device=dev)
    card = file_features_csv(whole, cols)
    err = _max_abs_err(card.cpu(), host)
    print(f"case csv_parse rows=512 columns={len(cols)} split_at="
          f"{SPLIT_AT} card_vs_cpu max_abs_diff={err}")
    if not torch.equal(card.cpu(), host):
        raise AssertionError("the payload parse on the card != the CPU's")
    # integer parts past 2^24 (the integer step rounds once): each field
    # parses to its own nearest f32, on the card as on the CPU
    ints = np.random.default_rng(0).integers(1 << 24, 10 ** 8, (4096, 3))
    big = encode_csv_payload(ints.astype(np.float64), width=8)
    card = file_features_csv(torch.as_tensor(big, device=dev), [0, 1, 2])
    want = torch.from_numpy(ints.astype(np.float32))
    print(f"case csv_parse integer parts in [2^24, 1e8) rows=4096 width=8 "
          f"card_vs_exact max_abs_diff={_max_abs_err(card.cpu(), want)}")
    if not (torch.equal(card.cpu(), want) and torch.equal(
            file_features_csv(big, [0, 1, 2], device="cpu"), want)):
        raise AssertionError("the parse past 2^24 != the nearest f32")
    _check_slice_stream_shapes(torch, dev)
    return dict(x_chunk=x_chunk, stream_art=art, fin_x=fin_x,
                fin_edges=fin_edges, payload_whole=whole)


def _same_stream_stats(got, ref, name, *, flushes=True):
    g, r = got.as_dict(), ref.as_dict()
    for key in g:
        if key in ("conf_sum", "mean_conf"):
            ok = abs(g[key] - r[key]) <= 1e-5 * abs(r[key])
        elif key == "flushes" and not flushes:
            continue
        else:
            ok = g[key] == r[key]
        if not ok:
            raise AssertionError(f"{name}: stats[{key}] {g[key]} != {r[key]}")


def _serve_chunked(torch, np, dev, models):
    """Phase 4g: the streaming configuration served by
    ``StreamingHybridServer.serve_trace`` with ``chunk_windows`` in CHUNK_KS
    ("auto": the measured sweep, its launches outside the counted run),
    without and with ``evict_age=5.0``, each on the eager route
    (``fuse=False``: every launch counted, B5 K times, B1 once and the
    sweep K times a chunk) and through its CUDA graph (``fuse=None``: the
    probe, the warm-up and the capture are counted, a replay launches what
    was captured), each with every launch count set to 0 just before it
    and read just after. Each run must equal the per-window server on the
    card bit for bit (predictions, flow table, counters; ``flushes`` one a
    chunk, ``conf_sum`` at rtol 1e-5), the graph route the eager one. Then,
    with eviction: the launches of each eager step_chunk; the graph route
    chunk by chunk against the eager one (evictions counted right in every
    replay); no host sync in a step_chunk; a syncing backend served
    eagerly; the per-window step's graph, and windows and chunks mixed on
    one graph server; reset() under the captured graphs."""
    from repro_torch.kernels import ensemble_lookup as ek
    from repro_torch.netsim.stream import iter_chunks, iter_windows
    from repro_torch.serving import stream_serving as ss
    from repro_torch.serving.stream_serving import StreamingHybridServer

    trace, art, backend = models["trace"], models["art"], models["backend"]
    out = {"paths": {}, "servers": {}, "auto": {}}
    totals = {}
    for name, extra in STREAM_RUNS:
        kw = dict(STREAM_KW, **extra)
        ref = StreamingHybridServer(art, backend, fuse=False, **kw)
        p_ref, s_ref = ref.serve_trace(trace)
        n_win = s_ref.n_windows
        select = ek.resolve_select("auto", ref.artifact.n_trees,
                                   ref.artifact.dtable_flat.shape[2],
                                   ref.artifact.dtable_flat.shape[0])
        out["servers"][(name, "per_window", "eager")] = ref
        for k in CHUNK_KS:
            eager_pred = eager_stats = eager_k = None
            for route, fuse in (("eager", False), ("graph", None)):
                if k == "auto":
                    ss.clear_chunk_tune_cache()
                    _reset_counts()
                    t0 = time.perf_counter()
                srv = StreamingHybridServer(art, backend, chunk_windows=k,
                                            fuse=fuse, **kw)
                if k == "auto":
                    torch.cuda.synchronize()
                    sweep_s = time.perf_counter() - t0
                    out["auto"][(name, route)] = srv.chunk_windows
                    print(f"chunk autotune ({name}, {route}): K="
                          f"{srv.chunk_windows} in {sweep_s:.2f} s; per "
                          f"packet " + ", ".join(
                              f"K={c} {t * 1e9:.1f} ns" for c, t in
                              sorted(srv.chunk_sweep.items()))
                          + f"; the sweep's launches {_counts()}")
                kk = srv.chunk_windows
                _reset_counts()
                p, s = srv.serve_trace(trace)
                torch.cuda.synchronize()
                path = _counts()
                n_chunks = -(-n_win // kk)
                # the graph route launches one chunk eagerly (the probe),
                # then once more for the warm-up and once for the capture
                calls = n_chunks if route == "eager" else (
                    3 if n_chunks >= 2 else 1)
                want = {"stream_update": kk * calls, select: calls,
                        "evict_fill": kk * calls if extra else 0}
                print(f"main-path launches (g: chunked, {name}, K={k}->{kk}, "
                      f"{route}, {n_chunks} chunks): {path}")
                for key, count in path.items():
                    if count != want.get(key, 0):
                        raise AssertionError(
                            f"chunked {name} K={kk} {route}: {key} launched "
                            f"{count} times, want {want.get(key, 0)}")
                for key, count in path.items():
                    totals[key] = totals.get(key, 0) + count
                if not torch.equal(p, p_ref):
                    raise AssertionError(f"chunked {name} K={kk} {route}: "
                                         f"preds != per-window preds")
                if not torch.equal(srv.flow_table(), ref.flow_table()):
                    raise AssertionError(f"chunked {name} K={kk} {route}: "
                                         f"flow table != per-window")
                _same_stream_stats(s, s_ref, f"chunked {name} K={kk} {route}",
                                   flushes=False)
                if s.n_flushes != n_chunks:
                    raise AssertionError(f"{s.n_flushes} flushes for "
                                         f"{n_chunks} chunks")
                if route == "graph":
                    if srv._fused_ok is not True or (
                            n_chunks >= 2 and set(srv._step_graphs)
                            != {("chunk", (kk, STREAM_WINDOW))}):
                        raise AssertionError(f"K={kk}: the graph route did "
                                             f"not capture its chunk step")
                    if not torch.equal(p, eager_pred):
                        raise AssertionError(f"K={kk}: graph != eager preds")
                    # "auto" may pick another K for each route
                    _same_stream_stats(s, eager_stats, f"K={kk} graph/eager",
                                       flushes=kk == eager_k)
                eager_pred, eager_stats, eager_k = p, s, kk
                out["paths"][(name, k, route)] = path
                out["servers"][(name, k, route)] = srv
                print(f"serve_trace[chunked {name} K={kk} {route}] packets="
                      f"{s.n_packets} windows={s.n_windows} chunks="
                      f"{n_chunks} flushes={s.n_flushes} fraction_handled="
                      f"{s.fraction_handled:.4f} backend_rows="
                      f"{s.total_backend_rows} evicted={s.n_evicted} "
                      f"overflow={s.n_overflow} preds_equal_per_window=True "
                      f"flow_table_equal=True counters_equal=True")
    out["totals"] = totals

    # with eviction, K=16: per-step launches, graph against eager chunk by
    # chunk, no sync, the syncing backend, the window graph, mixing, reset
    kw = dict(STREAM_KW, **STREAM_RUNS[1][1])
    eager = StreamingHybridServer(art, backend, chunk_windows=16, fuse=False,
                                  **kw)
    graph = StreamingHybridServer(art, backend, chunk_windows=16, **kw)
    select = ek.resolve_select("auto", eager.artifact.n_trees,
                               eager.artifact.dtable_flat.shape[2],
                               eager.artifact.dtable_flat.shape[0])
    chunks = list(iter_chunks(trace, STREAM_WINDOW, 16, STREAM_BUCKETS))
    for c in chunks:
        before = _counts()
        pe, he = eager.step_chunk(c)
        delta = {k: v - before[k] for k, v in _counts().items()}
        want = {"stream_update": 16, select: 1, "evict_fill": 16}
        if delta != {k: want.get(k, 0) for k in delta}:
            raise AssertionError(f"one eager step_chunk launched {delta}")
        pg, hg = graph.step_chunk(c)
        if not (torch.equal(pe, pg)
                and torch.equal(he.as_tensors()[1], hg.as_tensors()[1])):
            raise AssertionError("graph step_chunk != eager step_chunk")
        _same_stream_stats(graph.stats, eager.stats, "graph/eager per chunk")
    print(f"step_chunk (K=16, evict_timeout): each eager call launched B5 "
          f"16x, {select} once, the sweep 16x; the graph route equal to the "
          f"eager one after each of {len(chunks)} chunks (evicted "
          f"{graph.stats.n_evicted}: counted right in every replay)")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    graph.step_chunk(chunks[1])
    eager.step_chunk(chunks[1])
    torch.cuda.set_sync_debug_mode(0)
    print("step_chunk (graph and eager): no host sync under "
          "torch.cuda.set_sync_debug_mode('error')")

    def np_backend(r):                        # a host round trip
        return backend(r).cpu().numpy()

    ref = out["servers"][("evict_timeout", "per_window", "eager")]
    ref.reset()
    p_ref, s_ref = ref.serve_trace(trace)
    np_srv = StreamingHybridServer(art, np_backend, chunk_windows=16, **kw)
    p_np, s_np = np_srv.serve_trace(trace)
    if np_srv._fused_ok is not False or np_srv._step_graphs \
            or not torch.equal(p_np, p_ref):
        raise AssertionError("a syncing backend did not serve chunks eagerly")
    _same_stream_stats(s_np, s_ref, "syncing backend", flushes=False)
    win = StreamingHybridServer(art, backend, **kw)          # fuse=None
    p_w, s_w = win.serve_trace(trace)
    if set(win._step_graphs) != {("window", (STREAM_WINDOW,))} \
            or not torch.equal(p_w, p_ref) \
            or not torch.equal(win.flow_table(), ref.flow_table()):
        raise AssertionError("the per-window graph != the eager step")
    _same_stream_stats(s_w, s_ref, "per-window graph")
    mixed = StreamingHybridServer(art, backend, chunk_windows=2, **kw)
    preds = []
    for i, c in enumerate(iter_chunks(trace, STREAM_WINDOW, 2,
                                      STREAM_BUCKETS)):
        if i % 2:
            preds.append(mixed.step_chunk(c)[0].reshape(-1))
        else:
            preds += [mixed.step(c.window_at(j))[0] for j in range(2)
                      if bool(c.valid[j].any())]
    if not torch.equal(torch.cat(preds)[:trace.n_packets], p_ref):
        raise AssertionError("step and step_chunk mixed != per-window")
    _same_stream_stats(mixed.stats, s_ref, "mixed", flushes=False)
    graphs = dict(graph._step_graphs)
    graph.reset()
    p_again, s_again = graph.serve_trace(trace)
    if graph._step_graphs != graphs or not torch.equal(p_again, p_ref):
        raise AssertionError("reset() under the captured graph")
    _same_stream_stats(s_again, s_ref, "after reset", flushes=False)
    print(f"serve_trace[evict_timeout]: numpy backend _fused_ok="
          f"{np_srv._fused_ok} (eager, equal); per-window graph "
          f"{sorted(win._step_graphs)} equal to the eager step; step and "
          f"step_chunk mixed on one server equal; reset() under the "
          f"captured graph serves the trace again, equal, no re-capture")
    w = next(iter(iter_windows(trace, STREAM_WINDOW, STREAM_BUCKETS)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    win.step(w)
    torch.cuda.set_sync_debug_mode(0)
    out.update(eager16=eager, graph16=graph, window_graph=win,
               window_eager=ref, chunks16=chunks)
    return out


def _serve_finance(torch, np, dev, serve, check_vs_cpu):
    """Phase 4h: ``launch.serve --use-case finance`` at its defaults
    (``make_janestreet_like(20000)``, RF 10x5 switch on the five switch
    features, XGB 60x6 backend on all 130 through the index side channel,
    tau 0.7, capacity 1024, batch 2048), every launch count set to 0 just
    before it and read just after: B1 twice a batch (the launcher's
    recompute of the dispatch order and the classify, one each), B4 in the
    fits. The predictions must equal a plain server's (``use_kernel=False``)
    over the same models and side channel. Then the finance example at its
    defaults: the card's parse and classify against the CPU's."""
    from repro_torch.core.inference import table_predict
    from repro_torch.data.janestreet_like import SWITCH_FEATURES
    from repro_torch.examples import finance_lowlatency
    from repro_torch.kernels import ensemble_lookup as ek
    from repro_torch.kernels.ops import fused_classify
    from repro_torch.core.hybrid import dispatch
    from repro_torch.netsim.features import file_features_csv
    from repro_torch.serving.hybrid_serving import HybridServer

    _reset_counts()
    res = serve.main(["--device", "cuda", "--use-case", "finance"])
    torch.cuda.synchronize()
    path = _counts()
    print(f"main-path launches (h: finance launcher): {path}")
    srv = res["server"]
    art = srv.artifact
    select = ek.resolve_select("auto", art.n_trees, art.dtable_flat.shape[2],
                               art.dtable_flat.shape[0])
    batches = res["batches"]
    if path[select] != 2 * batches or path["bucketize"] < 2:
        raise AssertionError(f"finance: {path} for {batches} batches")
    for key, count in path.items():
        if key not in (select, "bucketize") and count:
            raise AssertionError(f"finance launched {key} {count} times")
    batch = res["pred"].shape[0] // batches
    backend_fn = res["backend_fn"]
    for i in range(batches):                  # one B1 launch per classify
        rows = res["x_test"][i * batch:(i + 1) * batch]
        backend_fn.full_rows = res["x_full"][i * batch:(i + 1) * batch]
        _, conf = fused_classify(art, rows, tiles=srv.tiles)
        backend_fn.idx = dispatch(rows, conf < srv.threshold,
                                  srv.capacity)[1]
        before = _counts()
        pred, _ = srv.classify(rows)
        delta = {k: v - before[k] for k, v in _counts().items()}
        if delta != {k: int(k == select) for k in delta} or not \
                torch.equal(pred, res["pred"][i * batch:(i + 1) * batch]):
            raise AssertionError(f"finance classify launched {delta}")
    plain = HybridServer(res["artifact"],
                         serve.side_channel_backend(res["backend_model"]),
                         threshold=srv.threshold, capacity=srv.capacity,
                         use_kernel=False, fuse=False, device="cuda")
    plain_preds, _ = serve.serve_batches(plain, res["x_test"], batch,
                                         x_full=res["x_full"])
    if not torch.equal(torch.cat(plain_preds), res["pred"]):
        raise AssertionError("finance: served preds != plain preds")
    check_vs_cpu(art, "finance_switch")
    if not set(res["pred"].unique().tolist()) <= {0, 1}:
        raise AssertionError("finance: predictions outside the classes")
    for key in ("acc", "precision", "recall", "f1"):
        if not np.isfinite(res[key]):
            raise AssertionError(f"finance: {key} is not finite")
    st = res["stats"]
    print(f"serve[finance] acc={res['acc']:.4f} precision="
          f"{res['precision']:.4f} recall={res['recall']:.4f} f1="
          f"{res['f1']:.4f} handled_at_switch={st.fraction_handled:.4f} "
          f"backend_rows={st.backend_rows} batches={batches} x {batch} "
          f"(switch F={res['x_test'].shape[1]}, backend F="
          f"{res['x_full'].shape[1]}) one {select} launch per classify, "
          f"preds_equal_plain=True")

    ex = finance_lowlatency.main(["--device", "cuda"])
    host = file_features_csv(ex["payload"], SWITCH_FEATURES, device="cpu")
    p_cpu, c_cpu = table_predict(ex["artifact"].to("cpu"), host)
    if not (torch.equal(ex["feats"].cpu(), host)
            and torch.equal(ex["pred"].cpu().long(), p_cpu.long())
            and _ulp_ok(c_cpu.numpy(), ex["conf"].cpu().numpy())):
        raise AssertionError("the finance example on the card != the CPU's")
    if not (0.0 <= ex["tag_precision"] <= 1.0
            and np.isfinite(ex["switch_acc"])):
        raise AssertionError("the finance example's telemetry")
    print(f"example[finance_lowlatency] rows={ex['pred'].shape[0]} parse + "
          f"classify {ex['parse_classify_s'] * 1e3:.2f} ms (host clock to a "
          f"sync) tagged={int(ex['tagged'].sum())} tag_precision="
          f"{ex['tag_precision']:.3f} switch_acc={ex['switch_acc']:.4f} "
          f"backend_acc={ex['backend_acc']:.4f} parse_and_preds_equal_cpu="
          f"True")
    return dict(res=res, path=path, select=select, example=ex)


def _time_chunked(torch, np, ek, bk, models, chunked, shapes, finance,
                  smi):
    """Phase 5 for this slice: one chunk step at K=16 (eager, its device
    time by graph replay, the server's own graph per call and its replay
    alone) and its parts; the per-window step under its graph against
    eager; packets per second of serve_trace per window against chunked;
    B1 at the chunk classify's rows; B4 at the finance fit; the finance
    classify and the payload parse. -> (JSON rows, extra JSON rows)."""
    from repro_torch.netsim.stream import (FlowTableState,
                                           chunk_update_readout)
    from repro_torch.serving.stream_serving import chunk_classify_tail
    from repro_torch.core.hybrid import backpatch_pending

    trace = models["trace"]
    eager, graph = chunked["eager16"], chunked["graph16"]
    c = chunked["chunks16"][1]
    w = c.window_at(0)
    k = c.n_windows
    e_call = _median_ms(torch, lambda: eager.step_chunk(c))
    e_dev = _graph_ms(torch, lambda: eager.step_chunk(c), inner=2)
    g_call = _median_ms(torch, lambda: graph.step_chunk(c))
    g_graph = graph._step_graphs[("chunk", (k, STREAM_WINDOW))][0]
    g_replay = _median_ms(torch, g_graph.replay)
    print(f"time step_chunk[K={k}, W={STREAM_WINDOW}, evict_timeout] eager "
          f"{e_call:.4f} ms a call ({e_call / k:.4f} a window), device "
          f"{e_dev:.4f} ms (graph replay; {e_dev / k:.4f} a window); the "
          f"server's graph {g_call:.4f} ms a call ({g_call / k:.4f} a "
          f"window), its replay alone {g_replay:.4f} ms on {smi}")
    regs = eager.state.regs.clone()
    stats = eager.stats
    tau = torch.full((), eager.threshold, device=regs.device)
    kw = dict(evict_age=eager.evict_age, saturate=True)
    _, xs, n_ev, n_ov = chunk_update_readout(FlowTableState(regs.clone()), c,
                                             **kw)
    _, dd, pending, _, _ = chunk_classify_tail(
        eager.artifact, stats, c, xs, n_ev, n_ov, tau, eager.capacity,
        tiles=eager.tiles, device=regs.device)
    be = eager.backend_fn(dd.buf)
    parts = {
        f"register half (B5, sweep, guard x{k}; readout)":
            lambda: chunk_update_readout(FlowTableState(regs), c, **kw),
        f"classify tail (B1 over {k * STREAM_WINDOW} rows, dispatch, fold)":
            lambda: chunk_classify_tail(eager.artifact, stats, c, xs, n_ev,
                                        n_ov, tau, eager.capacity,
                                        tiles=eager.tiles,
                                        device=regs.device),
        f"backend (RF 16x6 over {dd.buf.shape[0]} rows)":
            lambda: eager.backend_fn(dd.buf),
        "back-patch": lambda: backpatch_pending(pending, be, dd)}
    print(f"time step_chunk[K={k}] parts: " + ", ".join(
        f"{name} {_median_ms(torch, fn):.4f} ms (eager), "
        f"{_graph_ms(torch, fn, inner=2):.4f} ms (graph)"
        for name, fn in parts.items()) + f" on {smi}")
    we, wg = chunked["window_eager"], chunked["window_graph"]
    w_call = _median_ms(torch, lambda: we.step(w))
    w_dev = _graph_ms(torch, lambda: we.step(w), inner=5)
    wg_call = _median_ms(torch, lambda: wg.step(w))
    wg_replay = _median_ms(
        torch, wg._step_graphs[("window", (STREAM_WINDOW,))][0].replay)
    print(f"time stream_step[evict_timeout, W={STREAM_WINDOW}] eager "
          f"{w_call:.4f} ms a call, device {w_dev:.4f} ms (graph replay); "
          f"the server's graph {wg_call:.4f} ms a call, its replay alone "
          f"{wg_replay:.4f} ms on {smi}")

    servers = chunked["servers"]
    runs = [(f"{name} {label}", servers[key])
            for name in ("no_eviction", "evict_timeout")
            for label, key in (
                ("per-window eager", (name, "per_window", "eager")),
                ("per-window graph", None),
                ("chunked K=16 eager", (name, 16, "eager")),
                ("chunked K=16 graph", (name, 16, "graph")),
                ("chunked auto graph", (name, "auto", "graph")))
            if key is not None]
    runs.append(("evict_timeout per-window graph", wg))
    rates = {}
    for label, srv in runs:
        times = []
        for _ in range(5):
            srv.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.serve_trace(trace)            # ends with stats.check(): a sync
            times.append(time.perf_counter() - t0)
        med, best = statistics.median(times), min(times)
        rates[label] = trace.n_packets / med
        print(f"time serve_trace[{label}, K={srv.chunk_windows}] "
              f"{trace.n_packets} packets: median {med * 1e3:.2f} ms "
              f"({trace.n_packets / med:.0f} packets/s), best "
              f"{best * 1e3:.2f} ms ({trace.n_packets / best:.0f} packets/s) "
              f"on {smi}")

    art = shapes["stream_art"]
    tabs = (art.edges, art.ftable_flat, art.dtable_flat, art.dtable_pad)
    select = ek.resolve_select("auto", art.n_trees, art.dtable_flat.shape[2],
                               art.dtable_flat.shape[0])
    b1_launches = chunked["totals"].get(select, 0)
    extra = []
    for kk in (16, 32):
        row = _time_kernel(torch, ek, f"ensemble_lookup:{select}[chunk K={kk}]",
                           tabs, shapes["x_chunk"][:kk * STREAM_WINDOW]
                           .contiguous(), select,
                           "src/repro/kernels/ensemble_lookup.py:112"
                           if select == "matmul" else
                           "src/repro/kernels/ensemble_lookup.py:132",
                           b1_launches if kk == 16 else 0)
        extra.append(row)
    b4 = _time_bucketize(torch, bk, shapes["fin_edges"], shapes["fin_x"],
                         finance["path"]["bucketize"])
    b4["name"] = "bucketize[finance_fit]"
    extra.append(b4)
    for row in extra:
        lib = ("none" if row["library_ms"] is None
               else f"{row['library_ms']:.5f} ms")
        print(f"time {row['name']}: kernel {row['ms']:.5f} ms (graph), "
              f"{row['ms_eager']:.5f} ms (eager call); plain "
              f"{row['plain_ms']:.5f} ms (graph); library {lib}; bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}); shape "
              f"{row['shape']}; on {smi}")

    res = finance["res"]
    srv, fn = res["server"], res["backend_fn"]
    rows = res["x_test"][:2048]
    fn.full_rows = res["x_full"][:2048]
    from repro_torch.core.hybrid import dispatch
    from repro_torch.kernels.ops import fused_classify
    _, conf = fused_classify(srv.artifact, rows, tiles=srv.tiles)
    fn.idx = dispatch(rows, conf < srv.threshold, srv.capacity)[1]
    f_call = _median_ms(torch, lambda: srv.classify(rows))
    f_dev = _graph_ms(torch, lambda: srv.classify(rows), inner=5)
    ex = finance["example"]
    from repro_torch.data.janestreet_like import SWITCH_FEATURES
    from repro_torch.netsim.features import file_features_csv
    whole = ex["whole"]
    p_call = _median_ms(torch, lambda: file_features_csv(whole,
                                                         SWITCH_FEATURES))
    p_dev = _graph_ms(torch, lambda: file_features_csv(whole,
                                                       SWITCH_FEATURES),
                      inner=2)
    print(f"time classify[finance](batch=2048, RF 10x5 on 5 features, XGB "
          f"60x6 on 130, side channel set) median {f_call:.4f} ms per eager "
          f"call, {f_dev:.4f} ms device time (graph replay); payload parse "
          f"of the 5 switch columns over {whole.shape[0]} rows {p_call:.4f} "
          f"ms eager, {p_dev:.4f} ms device on {smi}")
    return extra, dict(step_chunk_eager_ms=e_call, step_chunk_device_ms=e_dev,
                       step_chunk_graph_ms=g_call,
                       step_chunk_replay_ms=g_replay, window_eager_ms=w_call,
                       window_device_ms=w_dev, window_graph_ms=wg_call,
                       window_replay_ms=wg_replay, packets_per_s=rates,
                       finance_classify_ms=f_call,
                       finance_classify_device_ms=f_dev)


# -- cross-window deferral and the adversarial scenarios (phases 4i, 4j) -------

# the reference's deferral configuration (benchmarks/batch_bench.py:39-41):
# the streaming trace and models at windows of 512
DEFER_WINDOW = 512
DEFER_KS = (1, 2, 4, 8)
DEFER_KW = dict(n_buckets=STREAM_BUCKETS, window=DEFER_WINDOW, threshold=0.9,
                capacity=64)
DEFER_TRIGGERS = (("occupancy", {"flush_occupancy": 0.5}),
                  ("deadline", {"flush_deadline": 2.0}))
# the reference's scenario configuration (benchmarks/scenario_bench.py:
# 75-91) at scale 1.0, its fault profiles and its policy
SCENARIO_WINDOW, SCENARIO_BUCKETS = 256, 4096
SCENARIO_KW = dict(n_buckets=SCENARIO_BUCKETS, window=SCENARIO_WINDOW,
                   capacity=64, threshold=0.9, evict_age=5.0)
SCENARIO_ARGS = {
    "ddos_flood": dict(n_background=400, n_attack=3000),
    "collision_storm": dict(n_background=400, n_attack=2000,
                            n_buckets=SCENARIO_BUCKETS, n_target_buckets=4),
    "slow_loris": dict(n_background=400, n_slow=64, n_probes=6,
                       idle_gap=4 * 5.0),
    "elephant_mice": dict(n_mice=1000, n_elephants=8, elephant_pkts=2000)}
FAULT_PROFILES = {"none": None, "flaky20": dict(error_rate=0.2, seed=42),
                  "outage": dict(outages=range(2, 6), seed=7)}


def _scenario_policy():
    from repro_torch.serving.faults import FaultPolicy
    return FaultPolicy(max_retries=1, backoff_base_s=0.0,
                       breaker_threshold=3, breaker_cooldown=4)


def _check_slice_stream_shapes(torch, dev):
    """Phase 3 at the deferral and scenario phases' register shapes: B5 and
    B6's timeout sweep at (N=8192, W=512) and (N=4096, W=256) against their
    plain versions, atol=0, one launch a call."""
    from repro_torch.kernels import evict as ev
    from repro_torch.kernels import stream_update as su
    from repro_torch.netsim.stream import OVERFLOW_LIMIT, evict_fills
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    fills = evict_fills(dev)
    for n, w in ((STREAM_BUCKETS, DEFER_WINDOW),
                 (SCENARIO_BUCKETS, SCENARIO_WINDOW)):
        for limit in (None, OVERFLOW_LIMIT):
            base = OVERFLOW_LIMIT - 60000.0 if limit else 0.0
            regs, cols = _stream_inputs(torch, dev, n, w, base=base, gen=gen)
            want = su.stream_update_ref(regs, *cols, limit=limit)
            before = su.LAUNCHES["stream_update"]
            got = su.stream_update(regs.clone(), *cols, limit=limit)
            torch.cuda.synchronize()
            launched = su.LAUNCHES["stream_update"] - before
            err = max(_max_abs_err(got[0], want[0]),
                      _max_abs_err(got[1], want[1]))
            print(f"case stream_update N={n} W={w} limit={limit} "
                  f"launches={launched} max_abs_diff={err}")
            if launched != 1 or not (torch.equal(got[0], want[0])
                                     and torch.equal(got[1], want[1])):
                raise AssertionError(f"stream_update != plain at N={n} W={w}")
        for case in SWEEP_CASES:
            regs, ts, valid = _sweep_inputs(torch, dev, n, w, case, 5.0, gen)
            want, want_n = ev.timeout_sweep_ref(regs, ts, valid, 5.0, fills)
            before = ev.LAUNCHES["evict_fill"]
            got, got_n = ev.timeout_sweep(regs.clone(), ts, valid, 5.0, fills)
            torch.cuda.synchronize()
            launched = ev.LAUNCHES["evict_fill"] - before
            print(f"case evict_fill:timeout_sweep N={n} W={w} {case} "
                  f"launches={launched} evicted={int(got_n)} max_abs_diff="
                  f"{_max_abs_err(got, want)}")
            if launched != 1 or not torch.equal(got, want) \
                    or int(got_n) != int(want_n):
                raise AssertionError(f"timeout sweep != plain at N={n} W={w}")


def _want_launches(select, calls, evict):
    return {"stream_update": calls, select: calls,
            "evict_fill": calls if evict else 0}


def _check_launches(path, want, name):
    for key, count in path.items():
        if count != want.get(key, 0):
            raise AssertionError(f"{name}: {key} launched {count} times, "
                                 f"want {want.get(key, 0)}")


def _add(totals, path):
    for key, count in path.items():
        totals[key] = totals.get(key, 0) + count


def _serve_deferred(torch, np, dev, models):
    """Phase 4i: cross-window deferral at the reference's deferral
    configuration (``DEFER_KW``: the streaming trace and models, windows of
    512) through ``StreamingHybridServer.serve_trace`` with ``flush_every``
    in DEFER_KS, without and with ``evict_age=5.0``, each through its CUDA
    graphs (``fuse=None``: the deferred step's graph and the flush graph;
    at k=1 the window step's) and eagerly (``fuse=False``), each with every
    launch count set to 0 just before it and read just after (eager: B5, B1
    and the sweep once a window; graph: the warm-up and the capture, and at
    k=1 the probe). Checks: predictions and ``backend_rows`` equal k=1's
    bit for bit (batch_bench's oracle 1), ceil(windows / k) backend calls
    and at k >= 4 at least 2x fewer than k=1's (oracle 2), the graph route
    equal to the eager one, and both to the CPU port on the same trace and
    models (every counter; ``conf_sum`` at rtol 1e-5); then at k=8 the
    occupancy (0.5) and deadline (2.0 s) flushes: the same predictions with
    more flushes, through the graphs."""
    from repro_torch.kernels import ensemble_lookup as ek
    from repro_torch.ml.trees import predict_tree_ensemble
    from repro_torch.serving.stream_serving import StreamingHybridServer

    trace, art, backend = models["trace"], models["art"], models["backend"]
    big_cpu = models["big"].to("cpu")

    def cpu_backend(r):
        return predict_tree_ensemble(big_cpu, r)

    out = {"totals": {}, "servers": {}, "trace": trace}
    for name, extra in STREAM_RUNS:
        kw = dict(DEFER_KW, **extra)
        cpu = {}
        for k in DEFER_KS:
            host = StreamingHybridServer(art, cpu_backend, flush_every=k,
                                         device="cpu", **kw)
            cpu[k] = (host, *host.serve_trace(trace))
        base = None
        for k in DEFER_KS:
            eager_pred = eager_stats = None
            for route, fuse in (("graph", None), ("eager", False)):
                srv = StreamingHybridServer(art, backend, flush_every=k,
                                            fuse=fuse, **kw)
                select = ek.resolve_select(
                    "auto", srv.artifact.n_trees,
                    srv.artifact.dtable_flat.shape[2],
                    srv.artifact.dtable_flat.shape[0])
                _reset_counts()
                p, s = srv.serve_trace(trace)
                torch.cuda.synchronize()
                path = _counts()
                n_win = s.n_windows
                calls = n_win if route == "eager" else (3 if k == 1 else 2)
                label = f"deferred {name} k={k} {route}"
                print(f"main-path launches (i: {label}, {n_win} windows): "
                      f"{path}")
                _check_launches(path, _want_launches(select, calls, extra),
                                label)
                _add(out["totals"], path)
                if base is None:
                    base = (p, s)
                p1, s1 = base
                if not torch.equal(p, p1) \
                        or s.total_backend_rows != s1.total_backend_rows \
                        or s.n_deferred != s1.n_deferred:
                    raise AssertionError(f"{label}: != flush_every=1")
                if s.n_flushes != -(-n_win // k) or (
                        k >= 4 and 2 * s.n_flushes > s1.n_flushes):
                    raise AssertionError(f"{label}: {s.n_flushes} flushes")
                host, p_cpu, s_cpu = cpu[k]
                if not torch.equal(p.cpu(), p_cpu) or not torch.equal(
                        srv.flow_table().cpu(), host.flow_table()):
                    raise AssertionError(f"{label}: != the CPU port")
                _same_stream_stats(s, s_cpu, f"{label} vs CPU")
                if route == "graph":
                    want_graphs = ({("window", (DEFER_WINDOW,))} if k == 1
                                   else {("defer", (DEFER_WINDOW,)),
                                         ("flush", (k * 64, 8))})
                    if srv._fused_ok is not True \
                            or set(srv._step_graphs) != want_graphs:
                        raise AssertionError(f"{label}: graphs "
                                             f"{sorted(srv._step_graphs)}")
                else:
                    if not torch.equal(p, eager_pred):
                        raise AssertionError(f"{label}: != the graph route")
                    _same_stream_stats(s, eager_stats, f"{label} vs graph")
                eager_pred, eager_stats = p, s
                out["servers"][(name, k, route)] = srv
                print(f"serve_trace[{label}] packets={s.n_packets} windows="
                      f"{n_win} flushes={s.n_flushes} backend_rows="
                      f"{s.total_backend_rows} deferred={s.n_deferred} "
                      f"evicted={s.n_evicted} fraction_handled="
                      f"{s.fraction_handled:.4f} preds_equal_k1=True "
                      f"equal_cpu=True" + (" equal_graph=True"
                                           if route == "eager" else ""))
        fixed = out["servers"][(name, 8, "graph")].stats.n_flushes
        for trig, tkw in DEFER_TRIGGERS:
            srv = StreamingHybridServer(art, backend, flush_every=8, **kw,
                                        **tkw)
            _reset_counts()
            p, s = srv.serve_trace(trace)
            torch.cuda.synchronize()
            path = _counts()
            label = f"deferred {name} k=8 {trig} graph"
            print(f"main-path launches (i: {label}): {path}")
            _check_launches(path, _want_launches(select, 2, extra), label)
            _add(out["totals"], path)
            if not torch.equal(p, base[0]) or s.n_flushes <= fixed \
                    or s.total_backend_rows != base[1].total_backend_rows:
                raise AssertionError(f"{label}: {s.n_flushes} flushes "
                                     f"against {fixed}, or other answers")
            print(f"serve_trace[{label}] flushes={s.n_flushes} (fixed "
                  f"cadence {fixed}) preds_equal_k1=True")
    return out


def _trace_models(torch, np, dev, trace, n_buckets):
    """The reference scenario bench's model recipe (``benchmarks/
    common.py:108``): an RF 4x3 switch and an RF 16x6 backend trained on the
    card on the trace's batch flow features. -> (artifact, backend, the
    backend model)."""
    from repro_torch.core.mapping import map_tree_ensemble
    from repro_torch.ml.trees import fit_random_forest, predict_tree_ensemble
    from repro_torch.netsim.features import flow_features
    b, table = flow_features(trace, n_buckets=n_buckets)
    first = np.unique(trace.flow_id, return_index=True)[1]
    rows = table[b[torch.as_tensor(first, device=dev)].long()]
    small = fit_random_forest(rows, trace.flow_label, n_classes=2, n_trees=4,
                              max_depth=3, seed=0, device=dev)
    big = fit_random_forest(rows, trace.flow_label, n_classes=2, n_trees=16,
                            max_depth=6, seed=1, device=dev)
    return (map_tree_ensemble(small, rows.shape[1]),
            lambda r: predict_tree_ensemble(big, r), big)


def _serve_scenarios(torch, np, dev):
    """Phase 4j: the four adversarial scenarios at the reference scenario
    bench's configuration (``SCENARIO_ARGS`` at scale 1.0, ``SCENARIO_KW``)
    served per window under its fault policy (the guard forces the eager
    route: B5, B1 and the sweep once a window, counted from 0 per run) with
    each fault profile. Checks: the clean profile equals the unguarded
    server (its graphs) bit for bit with no failed flush; under a fault
    profile the guard saw the faults (retries), a failed flush degrades
    rows (``degraded > 0`` exactly when a flush failed, always under the
    outage) and ``stats.check()`` holds; every run equals the CPU port under
    the same seeded ``FaultyBackend`` (predictions, counters, the guard's
    telemetry)."""
    from repro_torch.kernels import ensemble_lookup as ek
    from repro_torch.ml.trees import predict_tree_ensemble
    from repro_torch.netsim.scenarios import make_scenario
    from repro_torch.serving.faults import FaultyBackend
    from repro_torch.serving.stream_serving import StreamingHybridServer

    policy = _scenario_policy()
    out = {"totals": {}, "runs": {}}
    flaky_degraded = 0
    for name, skw in SCENARIO_ARGS.items():
        t0 = time.perf_counter()
        trace = make_scenario(name, seed=0, **skw)
        gen_s = time.perf_counter() - t0
        truth = torch.as_tensor(trace.flow_label[trace.flow_id])
        art, backend, big = _trace_models(torch, np, dev, trace,
                                          SCENARIO_BUCKETS)
        big_cpu = big.to("cpu")
        cpu_backend = lambda r, m=big_cpu: predict_tree_ensemble(m, r)
        ref = StreamingHybridServer(art, backend, **SCENARIO_KW)
        p_ref, s_ref = ref.serve_trace(trace)
        select = ek.resolve_select("auto", ref.artifact.n_trees,
                                   ref.artifact.dtable_flat.shape[2],
                                   ref.artifact.dtable_flat.shape[0])
        print(f"scenario {name}: {trace.n_packets} packets, {trace.n_flows} "
              f"flows, generated in {gen_s:.2f} s; unguarded (graphs) "
              f"{s_ref!r}")
        for profile, fkw in FAULT_PROFILES.items():
            be = backend if fkw is None else FaultyBackend(backend, **fkw)
            srv = StreamingHybridServer(art, be, fault_policy=policy,
                                        **SCENARIO_KW)
            _reset_counts()
            p, s = srv.serve_trace(trace)       # check() inside
            torch.cuda.synchronize()
            path = _counts()
            label = f"scenario {name} {profile}"
            print(f"main-path launches (j: {label}, {s.n_windows} windows): "
                  f"{path}")
            _check_launches(path, _want_launches(select, s.n_windows, True),
                            label)
            _add(out["totals"], path)
            g = srv.fault_stats
            if fkw is None:
                if not torch.equal(p, p_ref) or g.flushes_failed or \
                        s.n_degraded:
                    raise AssertionError(f"{label}: the guard is not "
                                         f"invisible")
                _same_stream_stats(s, s_ref, label)
            else:
                if (s.n_degraded > 0) != (g.flushes_failed > 0) or \
                        not (g.retries or g.flushes_failed):
                    raise AssertionError(f"{label}: {g}, degraded "
                                         f"{s.n_degraded}")
                if profile == "outage" and s.n_degraded == 0:
                    raise AssertionError(f"{label}: nothing degraded")
                if profile == "flaky20":
                    flaky_degraded += s.n_degraded
            cbe = (cpu_backend if fkw is None
                   else FaultyBackend(cpu_backend, **fkw))
            host = StreamingHybridServer(art, cbe, fault_policy=policy,
                                         device="cpu", **SCENARIO_KW)
            p_cpu, s_cpu = host.serve_trace(trace)
            if not torch.equal(p.cpu(), p_cpu) \
                    or g.as_dict() != host.fault_stats.as_dict():
                raise AssertionError(f"{label}: != the CPU port")
            _same_stream_stats(s, s_cpu, f"{label} vs CPU")
            acc = float((p.cpu() == truth).float().mean())
            out["runs"][(name, profile)] = dict(server=srv, trace=trace,
                                                backend=be)
            print(f"serve_trace[{label}] acc={acc:.4f} fraction_handled="
                  f"{s.fraction_handled:.4f} backend_rows="
                  f"{s.total_backend_rows} deferred={s.n_deferred} degraded="
                  f"{s.n_degraded} evicted={s.n_evicted} overflow="
                  f"{s.n_overflow} flushes={s.n_flushes} guard={g.as_dict()} "
                  f"equal_cpu=True" + (" equal_unguarded=True"
                                       if fkw is None else ""))
    if flaky_degraded == 0:
        raise AssertionError("flaky20 degraded nothing in any scenario")
    return out


def _time_deferred(torch, np, deferred, scenarios, smi):
    """Phase 5 for the deferral and scenario phases: the device time of one
    deferred step and of one flush by replaying each server's own graph
    (k = 2, 4, 8, with eviction), the per-window device time at each k
    against the window step's graph at k=1, a call of each route, and
    ``serve_trace``'s ms and packets/s per k and route (median of 5), then
    each scenario's serve_trace under the guard. -> a dict of the times."""
    from repro_torch.netsim.stream import iter_windows
    from repro_torch.serving.stream_serving import defer_tail
    servers = deferred["servers"]
    out = {"device_ms": {}, "serve_trace": {}, "scenarios": {}}
    name = "evict_timeout"
    k1 = servers[(name, 1, "graph")]
    w1 = k1._step_graphs[("window", (DEFER_WINDOW,))][0]
    window_ms = _median_ms(torch, w1.replay)
    out["device_ms"]["window_step_k1"] = window_ms
    for k in DEFER_KS[1:]:
        srv = servers[(name, k, "graph")]
        d_ms = _median_ms(torch, srv._step_graphs[("defer",
                                                   (DEFER_WINDOW,))][0].replay)
        f_ms = _median_ms(torch, srv._step_graphs[("flush",
                                                   (k * 64, 8))][0].replay)
        per = (k * d_ms + f_ms) / k
        out["device_ms"][f"k{k}"] = dict(defer_step=d_ms, flush=f_ms,
                                         per_window=per)
        print(f"time deferred[{name}, W={DEFER_WINDOW}, k={k}] device by "
              f"graph replay: deferred step {d_ms:.4f} ms, flush ({k * 64} "
              f"rows) {f_ms:.4f} ms, a window {per:.4f} ms against the "
              f"window step's {window_ms:.4f} ms at k=1 on {smi}")
    trace = deferred["trace"]
    ws = list(iter_windows(trace, DEFER_WINDOW, STREAM_BUCKETS))
    w = ws[len(ws) // 2]
    # a deferred step's parts (device, graph of 5) on copies of the k=8
    # carries: the switch half it shares with the window step, and the
    # deferral tail that replaces the backend and the combine
    srv = servers[(name, 8, "eager")]
    c = srv._carries().clone()
    tau = torch.full((), srv.threshold, device=srv.device)
    buf, ctx = srv._window_switch(c, w, tau)
    sw_pred, idx, valid, fwd, conf, n_ev, n_ov = ctx
    parts = {
        "switch half (B5, sweep, guard, readout, B1, dispatch)":
            lambda: srv._window_switch(c, w, tau),
        "deferral tail (defer_window, pending write, stats fold)":
            lambda: defer_tail(c.stats, c.dd, c.pending, w, sw_pred, fwd,
                               buf, idx, valid, conf, (n_ev, n_ov), srv._pos)}
    part_ms = {k: _graph_ms(torch, fn, inner=5) for k, fn in parts.items()}
    out["device_ms"]["k8_parts"] = part_ms
    print("time deferred step[k=8] parts: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in part_ms.items()) + f" (device, graph "
        f"of 5) on {smi}")
    for route in ("graph", "eager"):
        srv = servers[(name, 8, route)]
        srv.reset()
        call = _median_ms(torch, lambda: (srv.step(w), srv.consume_flush()))
        out["device_ms"][f"k8_{route}_call"] = call
        print(f"time deferred step[{name}, k=8, {route}] {call:.4f} ms a call "
              f"(median; the flush every 8th call included) on {smi}")
    for (run, k, route), srv in sorted(servers.items(),
                                       key=lambda kv: str(kv[0])):
        times = []
        for _ in range(5):
            srv.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.serve_trace(trace)             # ends with stats.check()
            times.append(time.perf_counter() - t0)
        med, best = statistics.median(times), min(times)
        out["serve_trace"][f"{run} k={k} {route}"] = dict(
            ms=med * 1e3, packets_per_s=trace.n_packets / med)
        print(f"time serve_trace[deferred {run} k={k} {route}] "
              f"{trace.n_packets} packets: median {med * 1e3:.2f} ms "
              f"({trace.n_packets / med:.0f} packets/s), best "
              f"{best * 1e3:.2f} ms on {smi}")
    for (name, profile), run in scenarios["runs"].items():
        srv, tr, be = run["server"], run["trace"], run["backend"]
        times = []
        for _ in range(3):
            srv.reset()
            if hasattr(be, "reset"):
                be.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv.serve_trace(tr)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        out["scenarios"][f"{name} {profile}"] = dict(
            ms=med * 1e3, packets_per_s=tr.n_packets / med)
        print(f"time serve_trace[scenario {name} {profile}, guarded, eager] "
              f"{tr.n_packets} packets: median {med * 1e3:.2f} ms "
              f"({tr.n_packets / med:.0f} packets/s) on {smi}")
    return out


# -- open-ended ingest and observability (phase 4k) ------------------------------

# the reference's serve_stream bench (benchmarks/latency_bench.py:58-67): the
# streaming trace at windows of 256, K=16, batches of 4096 packets
LAT_WINDOW, LAT_K, LAT_BATCH = 256, 16, 4096
LAT_KW = dict(n_buckets=STREAM_BUCKETS, window=LAT_WINDOW, threshold=0.9,
              capacity=64)
# the reference's obs bench (benchmarks/obs_bench.py:144-160)
OBS_FLOWS, OBS_WINDOW, OBS_K, OBS_FLUSH, OBS_ROLLUP = 3000, 256, 8, 4, 4
OBS_KW = dict(n_buckets=STREAM_BUCKETS, window=OBS_WINDOW, threshold=0.9,
              capacity=64)


def _shift_trace(n_flows=1200, seed=0, benign_frac=0.02, shifted_frac=0.9):
    """A copy of ``benchmarks/obs_bench.py:47 shift_trace``: a benign
    opening segment, then an anomaly-heavy segment strictly after it."""
    import dataclasses
    from repro_torch.netsim.packets import synth_trace
    from repro_torch.netsim.scenarios import merge_traces
    a = synth_trace(n_flows=n_flows, anomaly_frac=benign_frac, seed=seed)
    b = synth_trace(n_flows=n_flows, anomaly_frac=shifted_frac,
                    seed=seed + 1)
    b = dataclasses.replace(b, ts=b.ts + float(a.ts.max()) + 1.0)
    return merge_traces(a, b)


def _chunk_launches(select, k, calls, evict):
    """What ``calls`` chunk steps of K windows launch: B5 and the sweep K
    times a chunk, B1 once (``_want_launches``, per window, K times)."""
    want = _want_launches(select, k * calls, evict)
    want[select] = calls
    return want


def _manual_chunks(torch, srv, trace):
    """The loop ``serve_trace`` replaced: ``iter_chunks`` through
    ``step_chunk``. -> (predictions, stats)."""
    from repro_torch.netsim.stream import iter_chunks
    preds = [srv.step_chunk(c)[0].reshape(-1) for c in iter_chunks(
        trace, srv.window, srv.chunk_windows, srv.n_buckets)]
    return torch.cat(preds)[:trace.n_packets], srv.stats.check()


def _manual_windows(torch, srv, trace):
    """The per-window loop ``serve_trace`` replaced: ``iter_windows``
    through ``step``, each flush's patches over its windows."""
    from repro_torch.netsim.stream import iter_windows
    from repro_torch.serving.stream_serving import _patch
    preds = []
    for w in iter_windows(trace, srv.window, srv.n_buckets):
        preds.append(srv.step(w)[0])
        _patch(preds, srv.consume_flush())
    _patch(preds, srv.flush(trigger="end_of_stream"))
    return torch.cat(preds)[:trace.n_packets], srv.stats.check()


def _same_served(torch, got, ref, label, *, flushes=True):
    """Predictions bit for bit and every counter (``conf_sum`` at rtol
    1e-5)."""
    (p, s), (p_ref, s_ref) = got, ref
    if p.shape != p_ref.shape or not torch.equal(p.cpu(), p_ref.cpu()):
        raise AssertionError(f"{label}: predictions differ")
    _same_stream_stats(s, s_ref, label, flushes=flushes)


def _serve_ingest(torch, np, dev, models):
    """Phase 4k: open-ended ingest and observability. ``serve_stream``
    through the packet ring on the card, each run with every launch count
    set to 0 just before it and read just after (eager: B5 and the sweep K
    times and B1 once a chunk, or each once a window; graph: the probe, the
    warm-up and the capture), its predictions and StreamStats bit for bit
    against the manual loop (``iter_chunks`` + ``step_chunk``, or
    ``iter_windows`` + ``step``) and, where noted, the CPU port:
      - latency_bench's configuration (``LAT_KW``, K=16, batches of 4096):
        prefetch on and off, and ``chunk_windows="auto"``, each eager and
        through the chunk step's graph; the CPU port on the same source;
      - the streaming configuration (W=1024, K=16, without and with
        ``evict_age=5.0``): ``serve_trace`` through the ring against the
        manual loop, eager and graph;
      - obs_bench's configuration (3000 flows, W=256, K=8 chunked and
        ``flush_every=4`` per window, ``rollup_every=4``, events to a
        JSON-lines file in a temporary directory): obs on equal to obs off
        and to the CPU port, the log valid, rollups closed; the drift
        monitor at ``DriftConfig(baseline_windows=2, mix_l1=0.1)`` fires on
        ``_shift_trace`` and stays silent on a stationary trace;
      - a paced source (batches of 1000) with a real 2 ms deadline and with
        a fake clock that forces deadline cuts: equal to the manual loop in
        everything but ``flushes``;
      - a live source that sleeps 5 ms before each one-chunk batch, at
        ``serve_stream``'s defaults (prefetch on, the graph): the prefetch
        thread stages while the graph is captured;
      - ``record_latency=True`` with and without ``latency_samples``: the
        p50/p95/p99.
    -> the totals, servers and traces phase 5 times."""
    import tempfile
    from repro_torch.kernels import ensemble_lookup as ek
    from repro_torch.ml.trees import predict_tree_ensemble
    from repro_torch.netsim.ingest import replay_source, slice_trace
    from repro_torch.netsim.packets import synth_trace
    from repro_torch.obs import DriftConfig, Observability, validate_event_log
    from repro_torch.serving import stream_serving as ss
    from repro_torch.serving.stream_serving import StreamingHybridServer

    trace, art, backend = models["trace"], models["art"], models["backend"]
    big_cpu = models["big"].to("cpu")

    def cpu_backend(r):
        return predict_tree_ensemble(big_cpu, r)

    out = {"totals": {}, "servers": {}, "trace": trace,
           "lat_models": (art, backend)}
    select = None

    def counted(label, run, *, k, calls, evict):
        """run() with the launch counts from 0, checked against ``calls``
        chunk steps of K windows (k=1: window steps)."""
        nonlocal select
        _reset_counts()
        res = run()
        torch.cuda.synchronize()
        path = _counts()
        print(f"main-path launches (k: {label}): {path}")
        _check_launches(path, _chunk_launches(select, k, calls, evict), label)
        _add(out["totals"], path)
        return res

    def graph_calls(n_steps):
        return 3 if n_steps >= 2 else 1     # the probe, warm-up, capture

    # -- latency_bench's configuration ------------------------------------------
    manual = StreamingHybridServer(art, backend, chunk_windows=LAT_K,
                                   fuse=False, **LAT_KW)
    select = ek.resolve_select("auto", manual.artifact.n_trees,
                               manual.artifact.dtable_flat.shape[2],
                               manual.artifact.dtable_flat.shape[0])
    ref = _manual_chunks(torch, manual, trace)
    n_chunks = ref[1].n_flushes
    host = StreamingHybridServer(art, cpu_backend, chunk_windows=LAT_K,
                                 device="cpu", **LAT_KW)
    p_cpu, s_cpu = host.serve_stream(replay_source(trace, batch=LAT_BATCH))
    _same_served(torch, (p_cpu, s_cpu), ref, "latency_bench CPU port")
    for route, fuse in (("eager", False), ("graph", None)):
        for prefetch in (False, True):
            srv = StreamingHybridServer(art, backend, chunk_windows=LAT_K,
                                        fuse=fuse, **LAT_KW)
            label = f"latency_bench {route} prefetch={prefetch}"
            calls = n_chunks if route == "eager" else graph_calls(n_chunks)
            got = counted(label, lambda: srv.serve_stream(
                replay_source(trace, batch=LAT_BATCH), prefetch=prefetch),
                k=LAT_K, calls=calls, evict=False)
            _same_served(torch, got, ref, label)
            if route == "graph" and n_chunks >= 2 and set(
                    srv._step_graphs) != {("chunk", (LAT_K, LAT_WINDOW))}:
                raise AssertionError(f"{label}: graphs {srv._step_graphs}")
            out["servers"][("latency_bench", route, prefetch)] = srv
            ing = srv.ingest_stats
            print(f"serve_stream[{label}] packets={got[1].n_packets} "
                  f"chunks={n_chunks} cuts={ing.cuts} (count "
                  f"{ing.count_cuts}, drain {ing.drain_cuts}) dropped="
                  f"{ing.dropped} equal_manual_loop=True equal_cpu=True")
        ss.clear_chunk_tune_cache()
        auto = StreamingHybridServer(art, backend, chunk_windows="auto",
                                     fuse=fuse, **LAT_KW)
        kk = auto.chunk_windows
        auto_ref = _manual_chunks(torch, StreamingHybridServer(
            art, backend, chunk_windows=kk, fuse=False, **LAT_KW), trace)
        kk_chunks = auto_ref[1].n_flushes
        label = f"latency_bench auto->K={kk} {route}"
        got = counted(label, lambda: auto.serve_stream(
            replay_source(trace, batch=LAT_BATCH)), k=kk,
            calls=kk_chunks if route == "eager" else graph_calls(kk_chunks),
            evict=False)
        _same_served(torch, got, auto_ref, label)
        _same_served(torch, got, ref, label + " vs K=16", flushes=False)
        print(f"serve_stream[{label}] the sweep per packet " + ", ".join(
            f"K={c} {t * 1e9:.1f} ns" for c, t in
            sorted(auto.chunk_sweep.items())) + " equal_manual_loop=True")
        out["servers"][("latency_bench_auto", route)] = auto

    # -- the streaming configuration: serve_trace through the ring -------------
    for name, extra in STREAM_RUNS:
        kw = dict(STREAM_KW, **extra)
        m = StreamingHybridServer(art, backend, chunk_windows=16, fuse=False,
                                  **kw)
        sref = _manual_chunks(torch, m, trace)
        nc = sref[1].n_flushes
        for route, fuse in (("eager", False), ("graph", None)):
            srv = StreamingHybridServer(art, backend, chunk_windows=16,
                                        fuse=fuse, **kw)
            label = f"serve_trace ring {name} K=16 {route}"
            got = counted(label, lambda: srv.serve_trace(trace), k=16,
                          calls=nc if route == "eager" else graph_calls(nc),
                          evict=bool(extra))
            _same_served(torch, got, sref, label)
            if not torch.equal(srv.flow_table(), m.flow_table()):
                raise AssertionError(f"{label}: flow table != manual loop")
            out["servers"][("stream", name, route)] = srv
            print(f"{label}: packets={got[1].n_packets} chunks={nc} "
                  f"evicted={got[1].n_evicted} equal_manual_loop=True "
                  f"flow_table_equal=True")

    # -- a paced source with deadline cuts -----------------------------------------
    def fake_clock():
        state = {"t": 0.0}

        def clock():
            state["t"] += 10.0
            return state["t"]
        return clock

    for clock_name, call in (("real 2 ms deadline", dict(deadline=0.002)),
                             ("fake clock", dict(deadline=1.0,
                                                 clock=fake_clock()))):
        srv = StreamingHybridServer(art, backend, chunk_windows=LAT_K,
                                    **LAT_KW)
        label = f"paced batch=1000 {clock_name}"
        _reset_counts()
        got = srv.serve_stream(replay_source(trace, batch=1000), **call)
        torch.cuda.synchronize()
        path = _counts()
        ing = srv.ingest_stats
        print(f"main-path launches (k: {label}): {path}")
        _check_launches(path, _chunk_launches(select, LAT_K,
                                              graph_calls(ing.cuts), False),
                        label)
        _add(out["totals"], path)
        _same_served(torch, got, ref, label, flushes=False)
        if clock_name == "fake clock" and ing.deadline_cuts == 0:
            raise AssertionError(f"{label}: no deadline cut")
        print(f"serve_stream[{label}] cuts={ing.cuts} (count "
              f"{ing.count_cuts}, deadline {ing.deadline_cuts}, drain "
              f"{ing.drain_cuts}) flushes={got[1].n_flushes} (manual loop "
              f"{ref[1].n_flushes}) equal_manual_loop_but_flushes=True")

    # -- a live source at serve_stream's defaults ----------------------------------
    # prefetch on and the chunk step's graph: the source sleeps 5 ms before
    # each batch of one chunk, longer than a step, so the prefetch thread
    # stages cuts (allocating on its side stream) while the serving thread
    # probes, warms up and captures the graph
    def live():
        for lo in range(0, trace.n_packets, LAT_BATCH):
            time.sleep(0.005)
            yield slice_trace(trace, lo, min(lo + LAT_BATCH, trace.n_packets))

    srv = StreamingHybridServer(art, backend, chunk_windows=LAT_K, **LAT_KW)
    label = "live source sleeping 5 ms a batch, defaults"
    got = counted(label, lambda: srv.serve_stream(live()), k=LAT_K,
                  calls=graph_calls(n_chunks), evict=False)
    _same_served(torch, got, ref, label)
    if set(srv._step_graphs) != {("chunk", (LAT_K, LAT_WINDOW))}:
        raise AssertionError(f"{label}: graphs {srv._step_graphs}")
    print(f"serve_stream[{label}] prefetch on, graph captured with the "
          f"thread staging: equal_manual_loop=True")

    # -- record_latency --------------------------------------------------------------
    srv = out["servers"][("latency_bench", "graph", True)]
    out["latency"] = {}
    for samples in (None, 4096):
        srv.reset()
        got = srv.serve_stream(replay_source(trace, batch=LAT_BATCH),
                               record_latency=True, latency_samples=samples)
        _same_served(torch, got, ref, f"record_latency samples={samples}")
        summ = srv.latency.summary()
        if summ["n"] != trace.n_packets or not (
                0.0 < summ["p50_ms"] <= summ["p95_ms"] <= summ["p99_ms"]):
            raise AssertionError(f"latency summary {summ}")
        out["latency"][str(samples)] = summ
        print(f"serve_stream[latency_bench graph prefetch, record_latency, "
              f"latency_samples={samples}] n={summ['n']} p50 "
              f"{summ['p50_ms']:.4f} ms p95 {summ['p95_ms']:.4f} ms p99 "
              f"{summ['p99_ms']:.4f} ms mean {summ['mean_ms']:.4f} ms max "
              f"{summ['max_ms']:.4f} ms (kept {srv.latency.latencies().size})")

    # -- obs_bench's configuration -----------------------------------------------
    otrace = synth_trace(n_flows=OBS_FLOWS, seed=0)
    oart, obackend, obig = _trace_models(torch, np, dev, otrace,
                                         STREAM_BUCKETS)
    obig_cpu = obig.to("cpu")
    out["obs"] = {"trace": otrace, "servers": {},
                  "models": (oart, obackend)}
    with tempfile.TemporaryDirectory() as tmp:
        for path, pkw in (("chunked", dict(chunk_windows=OBS_K)),
                          ("per_window", dict(flush_every=OBS_FLUSH))):
            kw = dict(OBS_KW, **pkw)
            batch = (pkw.get("chunk_windows") or 1) * OBS_WINDOW
            off = StreamingHybridServer(oart, obackend, **kw)
            p_off = off.serve_stream(replay_source(otrace, batch=batch))
            log = os.path.join(tmp, f"events_{path}.jsonl")
            obs = Observability(events_path=log, rollup_every=OBS_ROLLUP)
            on = StreamingHybridServer(oart, obackend, obs=obs, **kw)
            _reset_counts()
            p_on = on.serve_stream(replay_source(otrace, batch=batch))
            torch.cuda.synchronize()
            launched = _counts()
            obs.close()
            oselect = ek.resolve_select("auto", on.artifact.n_trees,
                                        on.artifact.dtable_flat.shape[2],
                                        on.artifact.dtable_flat.shape[0])
            # graphs: the chunk step's probe, warm-up and capture; the
            # deferred step's warm-up and capture (its probe is the flush's)
            want = (_chunk_launches(oselect, OBS_K, 3, False)
                    if path == "chunked"
                    else _chunk_launches(oselect, 1, 2, False))
            print(f"main-path launches (k: obs_bench {path}, obs on): "
                  f"{launched}")
            _check_launches(launched, want, f"obs {path}")
            _add(out["totals"], launched)
            _same_served(torch, p_on, p_off, f"obs {path} on/off")
            manual = (_manual_chunks if path == "chunked"
                      else _manual_windows)(torch, StreamingHybridServer(
                          oart, obackend, **kw), otrace)
            _same_served(torch, p_on, manual, f"obs {path} vs manual loop")
            host = StreamingHybridServer(
                oart, lambda r: predict_tree_ensemble(obig_cpu, r),
                device="cpu", **kw)
            _same_served(torch, p_on, host.serve_stream(
                replay_source(otrace, batch=batch)), f"obs {path} vs CPU")
            n_events = validate_event_log(log)
            if n_events != obs.events.emitted or obs.rollups.n_rows < 1:
                raise AssertionError(f"obs {path}: {n_events} events, "
                                     f"{obs.rollups.n_rows} rollups")
            rolled = sum(r["sums"]["packets"] for r in obs.rollups.rows)
            if rolled != p_on[1].n_packets:
                raise AssertionError(f"obs {path}: rollups hold {rolled} "
                                     f"packets")
            out["obs"]["servers"][path] = (off, kw, batch)
            print(f"serve_stream[obs_bench {path}] obs on == obs off == "
                  f"manual loop == CPU port; {n_events} events validated "
                  f"({dict(sorted(obs.events.counts().items()))}); "
                  f"{obs.rollups.n_rows} rollups; stages "
                  f"{sorted(obs.timer.stages)}")
    half = max(400, OBS_FLOWS // 3)
    for scenario, tr, expect in (
            ("stationary", synth_trace(n_flows=2 * half, anomaly_frac=0.02,
                                       seed=7), False),
            ("class_mix_shift", _shift_trace(n_flows=half, seed=7), True)):
        obs = Observability(rollup_every=1, drift=DriftConfig(
            baseline_windows=2, mix_l1=0.1))
        StreamingHybridServer(oart, obackend, chunk_windows=OBS_K, obs=obs,
                              **OBS_KW).serve_trace(tr)
        fired = obs.drift.fired_detectors
        if expect != ("class_mix_shift" in fired) or (not expect and fired):
            raise AssertionError(f"drift {scenario}: fired {fired}")
        print(f"drift[{scenario}] {tr.n_packets} packets, "
              f"{obs.rollups.n_rows} rollups, fired {list(fired)} "
              f"({len(obs.alarms)} alarms) as the reference's bench asserts")
    return out


def _device_busy_ms(torch, prof):
    """(busy ms as the union of the device events' intervals, summed ms of
    the device events, their count) from a ``torch.profiler`` run: the
    union counts a copy that overlaps a kernel (the side stream) once."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    busy, summed, end = 0.0, 0.0, None
    for s, e in spans:
        summed += e - s
        if end is None or s >= end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3, summed / 1e3, len(spans)


def _wall_ms(torch, fn, reps=5):
    """Median and best host wall ms of ``fn`` (which ends in a sync)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times), 1e3 * min(times)


def _profile_serve_stream(torch, srv, trace, batch, prefetch, label, out,
                          smi):
    """One ``serve_stream`` run under ``torch.profiler``: the card's busy
    time (the union of its device events) over the run's wall, into
    ``out["idle"][label]``."""
    from repro_torch.netsim.ingest import replay_source
    from torch.profiler import ProfilerActivity, profile
    srv.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.serve_stream(replay_source(trace, batch=batch),
                         prefetch=prefetch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, summed, n_ev = _device_busy_ms(torch, prof)
    idle = (1.0 - busy / wall) if n_ev else None
    out["idle"][label] = dict(wall_ms=wall, busy_ms=busy, summed_ms=summed,
                              device_events=n_ev, idle_share=idle)
    print(f"profile serve_stream[{label}]: device busy {busy:.3f} ms (union "
          f"of {n_ev} device events; summed {summed:.3f} ms) of {wall:.3f} "
          f"ms wall: idle share "
          + ("not measured (no device events)" if idle is None
             else f"{100 * idle:.1f}%") + f" (profiler on) on {smi}")


def _time_ingest(torch, np, ingest, smi):
    """Phase 5 for phase 4k: the host's ingest parts timed alone (hash,
    rebase, the ring's admit/pop/pack, the pinned pack and the H2D copy of
    one chunk on the side stream under CUDA events) at latency_bench's and
    the streaming configuration's geometry, and the hash in torch beside
    the numpy one; packets/s of serve_stream with prefetch off and on,
    eager and from the graph, and the obs stage timers a chunk with
    prefetch off and on; serve_trace through the
    ring against the manual loop it replaced, from the graph (W=1024,
    K=16, in turns); the card's idle share over a serve_stream run
    (``torch.profiler``, the union of the device events over the wall);
    the obs on/off throughput ratio on both paths. -> a dict of the
    numbers."""
    import tempfile
    from repro_torch.netsim.features import (fnv1a_hash, fnv1a_hash_np,
                                             rebase_ts_np)
    from repro_torch.netsim.ingest import (PacketRingBuffer, PinnedStaging,
                                           _pack, replay_source)
    from repro_torch.netsim.stream import trace_columns
    from repro_torch.obs import Observability
    from repro_torch.serving.stream_serving import StreamingHybridServer

    trace, servers = ingest["trace"], ingest["servers"]
    n_pkt = trace.n_packets
    out = {"host_parts_ms": {}, "serve_stream": {}, "ring_vs_manual": {},
           "idle": {}, "obs_ratio": {}}

    def host_ms(fn, reps=9):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return 1e3 * statistics.median(times)

    ts64 = np.asarray(trace.ts, np.float64)
    five = (trace.src_ip, trace.dst_ip, trace.sport, trace.dport,
            trace.proto)
    hash_ms = host_ms(lambda: fnv1a_hash_np(*five, n_buckets=STREAM_BUCKETS))
    # the torch hash on the CPU, which the ring's columns used before
    torch_hash_ms = host_ms(lambda: fnv1a_hash(
        *five, n_buckets=STREAM_BUCKETS, device="cpu"))
    print(f"time ingest hash of {n_pkt} packets: numpy {hash_ms:.3f} ms, "
          f"torch on the CPU {torch_hash_ms:.3f} ms on {smi}")
    out["torch_hash_ms"] = torch_hash_ms
    rebase_ms = host_ms(lambda: rebase_ts_np(ts64, float(ts64.min())))
    cols_ms = host_ms(lambda: trace_columns(trace, STREAM_BUCKETS))
    cols, t0 = trace_columns(trace, STREAM_BUCKETS)
    dev = torch.device("cuda")
    side = torch.cuda.Stream()
    for cfg, window, k in (("latency_bench", LAT_WINDOW, LAT_K),
                           ("stream", STREAM_WINDOW, 16)):
        def ring_run():
            ring = PacketRingBuffer(window, k, STREAM_BUCKETS, t0=t0)
            cuts, off = [], 0
            while off < n_pkt:
                off += ring.admit_cols(cols, off, min(off + ring.free, n_pkt),
                                       now=0.0)
                while ring.ready():
                    cuts.append(ring.cut("count"))
            last = ring.drain()
            return cuts + ([last] if last is not None else [])

        ring_ms = host_ms(ring_run)
        cuts = ring_run()
        cut = cuts[0]
        # a cut staged as prefetch stages it: its columns packed into one
        # pinned buffer (the pack timed on the host), then that buffer's
        # one H2D copy on a side stream, timed by CUDA events around it
        staging = PinnedStaging(k, window, device=dev, slots=1)
        buf, views = staging._bufs[0], staging._host[0]
        pack_ms = host_ms(lambda: _pack(views, cut.cols, cut.valid), reps=30)
        times = []
        for _ in range(3 + REPS):
            with torch.cuda.stream(side):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                buf.to(dev, non_blocking=True)
                end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        h2d_ms = statistics.median(times[3:])
        n_bytes = buf.numel()
        n_cuts = len(cuts)
        per_trace = (hash_ms + rebase_ms + ring_ms
                     + n_cuts * (pack_ms + h2d_ms))
        out["host_parts_ms"][cfg] = dict(
            hash=hash_ms, rebase=rebase_ms, trace_columns=cols_ms,
            ring_admit_pop_pack=ring_ms, pinned_pack_a_chunk=pack_ms,
            h2d_a_chunk=h2d_ms, chunk_bytes=n_bytes, chunks=n_cuts,
            ingest_a_trace=per_trace)
        print(f"time ingest[{cfg}, W={window}, K={k}, {n_pkt} packets, "
              f"{n_cuts} chunks] host: hash {hash_ms:.3f} ms, rebase "
              f"{rebase_ms:.3f} ms (trace_columns {cols_ms:.3f} ms), ring "
              f"admit/pop/pack {ring_ms:.3f} ms, pinned pack {pack_ms:.4f} ms "
              f"a chunk; H2D {h2d_ms:.4f} ms a chunk ({n_bytes} B, "
              f"{n_bytes / h2d_ms / 1e6:.2f} GB/s; CUDA events on the side "
              f"stream); all ingest {per_trace:.3f} ms a trace on {smi}")

    # the per-window path's transfer (``HostCut.to_windows``): each
    # one-window cut packed into one pinned block and copied once, against
    # its plain composition, a pinned copy a column, in turns over the
    # trace's cuts at the deferral configuration's window
    ring = PacketRingBuffer(DEFER_WINDOW, 1, STREAM_BUCKETS, t0=t0)
    wcuts, off = [], 0
    while off < n_pkt:
        off += ring.admit_cols(cols, off, min(off + ring.free, n_pkt),
                               now=0.0)
        while ring.ready():
            wcuts.append(ring.cut("count"))
    wcuts += [c for c in [ring.drain()] if c is not None]

    def one_copy():
        for c in wcuts:
            for _ in c.to_windows(device=dev):
                pass

    def a_copy_a_column():
        for c in wcuts:
            live = c.n_windows * c.window
            for v in (*c.cols.values(), c.valid):
                torch.from_numpy(np.ascontiguousarray(v[:live])).pin_memory(
                ).to(dev, non_blocking=True)

    turns = {"one": [], "each": []}
    for i in range(8):
        for name in (("one", "each") if i % 2 else ("each", "one")):
            fn = one_copy if name == "one" else a_copy_a_column
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            turns[name].append(time.perf_counter() - t0_)
    one_ms, each_ms = (1e3 * statistics.median(turns[k]) for k in
                       ("one", "each"))
    out["host_parts_ms"]["per_window_transfer"] = dict(
        one_copy=one_ms, copy_a_column=each_ms, cuts=len(wcuts),
        one_copy_best=1e3 * min(turns["one"]),
        copy_a_column_best=1e3 * min(turns["each"]))
    print(f"time ingest[per window, W={DEFER_WINDOW}, {len(wcuts)} one-window "
          f"cuts] to the card: one pinned copy a cut {one_ms:.3f} ms (best "
          f"{1e3 * min(turns['one']):.3f}), a pinned copy a column "
          f"{each_ms:.3f} ms (best {1e3 * min(turns['each']):.3f}); medians "
          f"of 8 in turns on {smi}")

    def stream_run(srv, prefetch, batch=LAT_BATCH):
        return lambda: srv.serve_stream(replay_source(trace, batch=batch),
                                        prefetch=prefetch)

    runs = [(f"latency_bench {route} prefetch={pf}",
             stream_run(servers[("latency_bench", route, pf)], pf))
            for route in ("eager", "graph") for pf in (False, True)]
    runs += [(f"stream {name} {route} prefetch={pf}",
              stream_run(servers[("stream", name, route)], pf, batch=None))
             for name in ("no_eviction", "evict_timeout")
             for route in ("eager", "graph") for pf in (False, True)]
    for label, fn in runs:
        med, best = _wall_ms(torch, fn)
        out["serve_stream"][label] = dict(ms=med, best_ms=best,
                                          packets_per_s=n_pkt / med * 1e3)
        print(f"time serve_stream[{label}] {n_pkt} packets: median "
              f"{med:.2f} ms ({n_pkt / med * 1e3:.0f} packets/s), best "
              f"{best:.2f} ms on {smi}")

    # where prefetch's time goes: the stage timers of an Observability on
    # latency_bench's graph server, prefetch off and on (ring_cut and h2d
    # run on the prefetch thread when it is on, megastep on the loop's)
    lat_art, lat_backend = ingest["lat_models"]
    out["stages_ms"] = {}
    for pf in (False, True):
        obs = Observability(rollup_every=1 << 30)
        srv = StreamingHybridServer(lat_art, lat_backend, chunk_windows=LAT_K,
                                    obs=obs, **LAT_KW)
        srv.serve_stream(replay_source(trace, batch=LAT_BATCH), prefetch=pf)
        obs.timer.reset()
        med, _ = _wall_ms(torch, stream_run(srv, pf))
        stages = {k: v["mean_ms"] for k, v in obs.timer.summary().items()}
        out["stages_ms"][f"prefetch={pf}"] = dict(stages, wall_ms=med)
        print(f"time serve_stream[latency_bench graph prefetch={pf}, obs "
              f"stage timers] median {med:.2f} ms; a chunk: " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in sorted(stages.items()))
              + f" on {smi}")

    for name in ("no_eviction", "evict_timeout"):
        srv = servers[("stream", name, "graph")]
        ring, manual = [], []
        for order in ("ring", "manual", "manual", "ring") * 3:
            srv.reset()
            torch.cuda.synchronize()
            t0_ = time.perf_counter()
            if order == "ring":
                srv.serve_trace(trace)
            else:
                _manual_chunks(torch, srv, trace)
            (ring if order == "ring" else manual).append(
                time.perf_counter() - t0_)
        r_ms = 1e3 * statistics.median(ring)
        m_ms = 1e3 * statistics.median(manual)
        faster = "the ring" if r_ms < m_ms else "the manual loop"
        out["ring_vs_manual"][name] = dict(ring_ms=r_ms, manual_ms=m_ms,
                                           faster=faster)
        print(f"time serve_trace[{name}, W={STREAM_WINDOW}, K=16, graph]: "
              f"through the ring (prefetch off, serve_trace's setting on "
              f"the card) {r_ms:.2f} ms median of 6, "
              f"the manual iter_chunks loop {m_ms:.2f} ms; {faster} is "
              f"faster by {abs(r_ms - m_ms):.2f} ms on {smi}")

    profiled = [("latency_bench", servers[("latency_bench", "graph", True)],
                 LAT_BATCH),
                ("stream evict_timeout",
                 servers[("stream", "evict_timeout", "graph")], None)]
    for cfg, srv, batch in profiled:
        for pf in (False, True):
            label = f"{cfg} graph prefetch={pf}"
            _profile_serve_stream(torch, srv, trace, batch, pf, label, out,
                                  smi)

    otrace = ingest["obs"]["trace"]
    oart, obackend = ingest["obs"]["models"]
    for path, (off, kw, batch) in ingest["obs"]["servers"].items():
        t_off, t_on = [], []
        with tempfile.TemporaryDirectory() as tmp:
            obs = Observability(events_path=os.path.join(tmp, "e.jsonl"),
                                rollup_every=OBS_ROLLUP)
            on = StreamingHybridServer(oart, obackend, obs=obs, **kw)
            on.serve_stream(replay_source(otrace, batch=batch))   # capture
            for _ in range(5):
                for srv, acc in ((off, t_off), (on, t_on)):
                    srv.reset()
                    torch.cuda.synchronize()
                    t0_ = time.perf_counter()
                    srv.serve_stream(replay_source(otrace, batch=batch))
                    acc.append(time.perf_counter() - t0_)
            obs.close()
        ratio = min(t_off) / min(t_on)
        out["obs_ratio"][path] = dict(off_ms=1e3 * min(t_off),
                                      on_ms=1e3 * min(t_on), ratio=ratio)
        print(f"time serve_stream[obs_bench {path}] obs off "
              f"{1e3 * min(t_off):.2f} ms, on {1e3 * min(t_on):.2f} ms "
              f"(best of 5, interleaved): on/off throughput {ratio:.3f}x "
              f"(the reference's bench gates 0.9x) on {smi}")
    return out


# -- the sharded flow-table tier on one NCCL rank (phase 4l) ---------------------

# the reference's shard bench (benchmarks/shard_stream_bench.py:55-57): the
# streaming trace and models (4000 flows, N=8192, W=1024, tau 0.9, capacity
# 64), without eviction and with evict_age=2.0
SHARD_RUNS = (("no_eviction", {}), ("evict_2s", {"evict_age": 2.0}))
SHARD_ROUTES = (("window graph", {}),
                ("window eager", {"fuse": False}),
                ("chunk K=16 graph", {"chunk_windows": 16}),
                ("flush_every=4 graph", {"flush_every": 4}),
                ("unpartitioned graph", {"partition_classify": False}),
                ("serve_stream K=16 graph", {"chunk_windows": 16,
                                             "stream": True}))
SHARD_CENSUS = {
    "window switch": dict(psum=3, reduce_scatter=1, all_gather=2,
                          broadcast=0),
    "chunk switch": dict(psum=3, reduce_scatter=1, all_gather=2,
                         broadcast=0),
    "chunk backend": dict(psum=0, reduce_scatter=0, all_gather=1,
                          broadcast=0),
    "deferred switch": dict(psum=2, reduce_scatter=1, all_gather=2,
                            broadcast=0),
    "flush backend": dict(psum=0, reduce_scatter=1, all_gather=1,
                          broadcast=0)}


def _serve_sharded(torch, np, dev, models):
    """Phase 4l: the sharded flow-table tier (``ShardedStreamingServer``)
    on the card at D = 1, a one-rank NCCL group (``flow_shard_mesh``
    starts it), at the reference shard bench's configuration: the sharded
    oracle table against the batch table; then, without eviction and with
    ``evict_age=2.0``, the trace served per window (through the step's CUDA
    graph, collectives inside, and eagerly), chunked at K=16, with
    ``flush_every=4``, with ``partition_classify=False`` (graphs) and
    through ``serve_stream`` (K=16, batches of 4096, graph). Each run with
    every launch count set to 0 just before it and read just after, against
    the single-device ``StreamingHybridServer`` with the same knobs on the
    card: the same launches of B5, B6's sweep and B1, and the same
    predictions, StreamStats and flow table bit for bit, epoch 0.0, and
    collectives sent. Then the collective census per step kind (on copies
    of the carries). -> the servers, the totals, the census."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives
    from repro_torch.distributed.sharding import flow_shard_mesh
    from repro_torch.kernels import ensemble_lookup as ek
    from repro_torch.netsim.ingest import replay_source
    from repro_torch.netsim.shard_stream import stream_sharded_flow_features
    from repro_torch.netsim.stream import iter_chunks, iter_windows
    from repro_torch.serving.shard_serving import ShardedStreamingServer
    from repro_torch.serving.stream_serving import StreamingHybridServer

    trace, art, backend = models["trace"], models["art"], models["backend"]
    mesh = flow_shard_mesh(device="cuda")
    if dist.get_world_size() != 1 or "nccl" not in dist.get_backend():
        raise AssertionError(f"the mesh's group: {dist.get_world_size()} "
                             f"ranks of {dist.get_backend()}")
    out = {"totals": {}, "servers": {}, "trace": trace, "census": {}}
    collectives.reset_counts()
    _, table = stream_sharded_flow_features(
        trace, n_buckets=STREAM_BUCKETS, window=STREAM_WINDOW, mesh=mesh)
    if not torch.equal(table, models["table"]):
        raise AssertionError("sharded oracle table != batch flow_features")
    print(f"sharded[mesh (1, 1), NCCL, one rank] oracle table == batch "
          f"flow_features bit for bit ({collectives.counts()})")
    select = None
    for name, extra in SHARD_RUNS:
        for route, rkw in SHARD_ROUTES:
            rkw = dict(rkw)
            stream = rkw.pop("stream", False)
            pc = rkw.pop("partition_classify", True)
            kw = dict(STREAM_KW, **extra, **rkw)
            label = f"sharded {name} {route}"
            single = StreamingHybridServer(art, backend, **kw)
            select = ek.resolve_select("auto", single.artifact.n_trees,
                                       single.artifact.dtable_flat.shape[2],
                                       single.artifact.dtable_flat.shape[0])
            _reset_counts()
            p_ref, s_ref = single.serve_trace(trace)
            torch.cuda.synchronize()
            want = _counts()
            srv = ShardedStreamingServer(art, backend, mesh=mesh,
                                         partition_classify=pc, **kw)
            _reset_counts()
            collectives.reset_counts()
            if stream:
                p, s = srv.serve_stream(replay_source(trace, batch=LAT_BATCH))
            else:
                p, s = srv.serve_trace(trace)
            torch.cuda.synchronize()
            path, sent = _counts(), collectives.counts()
            print(f"main-path launches (l: {label}): {path}; collectives "
                  f"{sent}")
            if path != want:
                raise AssertionError(f"{label}: launches {path}, the "
                                     f"single-device server's {want}")
            if min(path["stream_update"], path[select]) < 1 or (
                    extra and path["evict_fill"] < 1):
                raise AssertionError(f"{label}: a kernel did not launch")
            if sent["psum"] < 1 or sent["all_gather"] + sent["psum"] < 3:
                raise AssertionError(f"{label}: collectives {sent}")
            _add(out["totals"], path)
            if not torch.equal(p, p_ref):
                raise AssertionError(f"{label}: predictions != single")
            if s.as_dict() != s_ref.as_dict():
                raise AssertionError(f"{label}: stats {s.as_dict()} != "
                                     f"{s_ref.as_dict()}")
            if not torch.equal(srv.flow_table(), single.flow_table()):
                raise AssertionError(f"{label}: flow table != single")
            if srv.epoch != 0.0:
                raise AssertionError(f"{label}: epoch {srv.epoch}")
            graphs = sorted(srv._step_graphs)
            if route.endswith("graph") != bool(srv._fused_ok) or graphs \
                    != sorted(single._step_graphs):
                raise AssertionError(f"{label}: route {srv._fused_ok}, "
                                     f"graphs {graphs}")
            if extra and s.n_evicted < 1:
                raise AssertionError(f"{label}: nothing evicted")
            out["servers"][(name, route)] = (srv, single)
            print(f"serve[{label}] packets={s.n_packets} windows="
                  f"{s.n_windows} flushes={s.n_flushes} backend_rows="
                  f"{s.total_backend_rows} evicted={s.n_evicted} "
                  f"fraction_handled={s.fraction_handled:.4f} graphs="
                  f"{graphs} classify_rows_per_device="
                  f"{srv.classify_rows_per_device} equal_single_device="
                  f"True (predictions, StreamStats, flow table) epoch=0.0")

    # the census: the collectives of each step kind, on copies of carries
    def census(fn):
        collectives.reset_counts()
        fn()
        torch.cuda.synchronize()
        return collectives.counts()

    tau = torch.full((), 0.9, device=dev)
    w = next(iter(iter_windows(trace, STREAM_WINDOW, STREAM_BUCKETS)))
    chunk = next(iter(iter_chunks(trace, STREAM_WINDOW, 16, STREAM_BUCKETS)))
    win = out["servers"][("no_eviction", "window graph")][0]
    chk = out["servers"][("no_eviction", "chunk K=16 graph")][0]
    dfr = out["servers"][("no_eviction", "flush_every=4 graph")][0]
    c1, c2, c3 = (srv._carries().clone() for srv in (win, chk, dfr))
    got = {"window switch": census(lambda: win._window_switch(c1, w, tau)),
           "chunk switch": census(lambda: chk._chunk_switch(c2, chunk, tau))}
    buf, _ = chk._chunk_switch(c2, chunk, tau)
    got["chunk backend"] = census(lambda: chk._fused_backend("chunk", c2,
                                                             buf))
    got["deferred switch"] = census(lambda: dfr._defer_switch(c3, w, tau))
    got["flush backend"] = census(lambda: dfr._fused_backend("flush", c3,
                                                             None))
    for kind, counts in got.items():
        print(f"census[{kind}] {counts}")
        if counts != SHARD_CENSUS[kind]:
            raise AssertionError(f"census {kind}: {counts}, want "
                                 f"{SHARD_CENSUS[kind]}")
    out["census"] = got
    return out


GATE_RULES = ("hotpath-donation", "hotpath-zero-sync", "hotpath-dtype",
              "hotpath-collectives", "lint-host-sync-in-graph",
              "lint-broad-except", "lint-env-mutation",
              "lint-carry-out-of-place", "fit-standard-artifacts")
# the streaming cell at full width for the hot-path audit
GATE_GEOMETRY = dict(n_buckets=STREAM_BUCKETS, window=STREAM_WINDOW,
                     capacity=64, threshold=0.9, chunk_windows=16,
                     flush_every=4, evict_age=5.0, seed=0)


def _run_gate(here, device):
    """``python -m repro_torch.analysis --strict --json`` in a subprocess
    (``--device cpu`` when asked). -> (report, wall seconds)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(here, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.analysis", "--strict",
           "--json"] + (["--device", device] if device == "cpu" else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=here, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"analysis gate ({device}) exited "
                             f"{proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout)
    by_name = {r["rule"]: r for r in report["results"]}
    if not report["ok"] or report["n_findings"] or set(GATE_RULES) - \
            set(by_name) or any(by_name[r]["selftest_fired"] is not True
                                or by_name[r]["error"] for r in GATE_RULES):
        raise AssertionError(f"analysis gate ({device}): {report}")
    return report, wall


def _gate_launches(select, label):
    """What one eager body of a contracted row launches at the streaming
    cell's geometry (eviction on): a batch classify B1 once, a window-
    shaped step B5, B6's sweep and B1 once, a chunk step B5 and the sweep
    K times and B1 once, a flush nothing (the backend is plain PyTorch)."""
    attr = label.rsplit(".", 1)[1]
    if attr == "_step":
        return {select: 1}
    if attr == "_chunk_step":
        return _chunk_launches(select, GATE_GEOMETRY["chunk_windows"], 1,
                               True)
    if attr == "_flush_step":
        return {}
    return _want_launches(select, 1, True)


def _analysis_gate(torch, np, dev, here, models):
    """Phase 4m: the analysis gate on the card and on the CPU
    (subprocesses, timed); the four hot-path rules here at the streaming
    cell's full width, every launch count set to 0 just before and read
    just after, each eager body's launches against a step of its kind;
    then the two examples at the reference's sizes on the card against the
    CPU port. -> dict(totals, walls, records, examples)."""
    from repro_torch.analysis import hotpath
    from repro_torch.analysis.dispatch_utils import collective_census
    from repro_torch.distributed.sharding import flow_shard_mesh
    from repro_torch.kernels import ensemble_lookup as ek

    out = {"totals": {}, "walls": {}}
    for device in ("cuda", "cpu"):
        report, wall = _run_gate(here, device)
        out["walls"][f"gate_{device}_s"] = wall
        print(f"analysis gate --strict (--device {device}): exit 0, "
              f"{report['n_rules']} rules, {report['n_findings']} findings, "
              f"every self-test fired; wall {wall:.2f} s; "
              + ", ".join(f"{r['rule']} {r['elapsed_s']:.2f} s"
                          for r in report["results"]))

    mesh = flow_shard_mesh(device="cuda")        # phase 4l's one-rank group
    targets = hotpath.build_targets(GATE_GEOMETRY, device=dev,
                                    artifact=models["art"],
                                    backend=models["backend"], mesh=mesh)
    art = targets[0].server.artifact
    select = ek.resolve_select("auto", art.n_trees, art.dtable_flat.shape[2],
                               art.dtable_flat.shape[0])
    _reset_counts()
    t0 = time.perf_counter()
    records = hotpath.audit(targets, geometry=GATE_GEOMETRY)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    path = _counts()
    print(f"main-path launches (m: the full-width hot-path audit, eager "
          f"bodies, captures and replays): {path}")
    _add(out["totals"], path)
    found = []
    for check in (hotpath.donation_findings, hotpath.zero_sync_findings,
                  hotpath.dtype_findings, hotpath.collective_findings):
        found += [f.format() for f in check(records)]
    if found:
        raise AssertionError("full-width audit:\n" + "\n".join(found))
    for r in records:
        want = _gate_launches(select, r.label)
        if r.launches != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"audit {r.label}: launched {r.launches}, "
                                 f"want {want}")
        if bool(r.row.get("graph")) != r.graph or r.n_ops < 10:
            raise AssertionError(f"audit {r.label}: graph {r.graph}, "
                                 f"{r.n_ops} ops")
        print(f"audit[{r.label}] {r.n_ops} ops, dtypes {sorted(r.dtypes)}, "
              f"launches {r.launches}, census "
              f"{collective_census(r.calls)}, no host sync (also "
              f"under set_sync_debug_mode('error')), carries in place"
              + (" through the capture and two replays" if r.graph else ""))
    out["walls"]["audit_full_width_s"] = wall
    out["records"] = records
    print(f"analysis gate at full width: {len(records)} contracted bodies, "
          f"0 findings, {wall:.2f} s")
    out["examples"] = _serve_examples(torch, np, out)
    return out


def _serve_examples(torch, np, out):
    """Phase 4m's examples: each at the reference's sizes, first on the CPU
    (fitting its forests), then on the card with those forests: every
    number equal."""
    from repro_torch.examples import anomaly_hybrid, quickstart

    def timed(fn, *args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    q_cpu, t_cpu = timed(quickstart.main, ["--device", "cpu"])
    _reset_counts()
    q_gpu, t_gpu = timed(quickstart.main, ["--device", "cuda"],
                         models=q_cpu["models"])
    path = _counts()
    _add(out["totals"], path)
    same = (torch.equal(q_gpu["pred"].cpu(), q_cpu["pred"])
            and torch.equal(q_gpu["hybrid"].pred.cpu(), q_cpu["hybrid"].pred)
            and all(q_gpu[k] == q_cpu[k] for k in (
                "switch_acc", "switch_prf", "hybrid_acc", "hybrid_prf",
                "fraction_handled"))
            and q_gpu["resources"].row() == q_cpu["resources"].row())
    if not same:
        raise AssertionError("quickstart on the card != the CPU port")
    print(f"example[quickstart] switch acc {q_gpu['switch_acc']:.4f} F1 "
          f"{q_gpu['switch_prf'][2]:.4f}; hybrid acc "
          f"{q_gpu['hybrid_acc']:.4f} F1 {q_gpu['hybrid_prf'][2]:.4f}, "
          f"{q_gpu['fraction_handled'] * 100:.1f}% at the switch; wall "
          f"{t_gpu:.3f} s on the card (the CPU port with its fits "
          f"{t_cpu:.3f} s); launches {path}; equal_cpu=True")

    a_cpu, ta_cpu = timed(anomaly_hybrid.main, ["--device", "cpu"])
    _reset_counts()
    a_gpu, ta_gpu = timed(anomaly_hybrid.main, ["--device", "cuda"],
                          models=a_cpu["models"])
    path = _counts()
    _add(out["totals"], path)
    select = next((k for k in ("matmul", "compare") if path.get(k)), None)
    if select is None or path[select] != 2 or path["stream_update"]:
        raise AssertionError(f"anomaly example launched {path} (want B1 in "
                             "the warm-up and the capture)")
    same = (torch.equal(a_gpu["pred"].cpu(), a_cpu["pred"])
            and torch.equal(a_gpu["flow_table"].cpu(), a_cpu["flow_table"])
            and torch.equal(a_gpu["packet_features"].cpu(),
                            a_cpu["packet_features"])
            and all(a_gpu[k] == a_cpu[k] for k in (
                "fraction_handled", "backend_rows", "accuracy", "prf",
                "flagged")))
    if not same or not a_gpu["server"]._graphs:
        raise AssertionError("anomaly_hybrid on the card != the CPU port "
                             "(or not served from its graph)")
    print(f"example[anomaly_hybrid] {a_gpu['trace'].n_packets} packets, "
          f"{len(a_gpu['rows'])} flows; handled at switch "
          f"{a_gpu['fraction_handled'] * 100:.1f}% (backend saw "
          f"{a_gpu['backend_rows']}); accuracy {a_gpu['accuracy']:.4f} "
          f"P/R/F1 {a_gpu['prf']}; flagged {a_gpu['flagged']}; classify "
          f"{a_gpu['classify_s'] * 1e3:.2f} ms (its capture included); wall "
          f"{ta_gpu:.3f} s on the card (the CPU port with its fits "
          f"{ta_cpu:.3f} s); launches {path}; equal_cpu=True")
    out["walls"].update(quickstart_cuda_s=t_gpu, quickstart_cpu_s=t_cpu,
                        anomaly_cuda_s=ta_gpu, anomaly_cpu_s=ta_cpu)
    print("times (phase 4m, the analysis gate and the examples): "
          + json.dumps(out["walls"]))
    return dict(quickstart=q_gpu, anomaly=a_gpu)


def _time_sharded(torch, np, sharded, smi):
    """Phase 5 for phase 4l: the sharded server (one NCCL rank) against the
    single-device server, in turns in this process (single, sharded,
    sharded, single): each step's device time by replaying its own graph
    (the window step, the chunk step at K=16, the deferred step and the
    flush at k=4), and ``serve_trace``'s ms and packets/s from the graphs
    and on the eager two-phase route, without and with eviction: the cost
    of the collectives at D = 1; then one collective of each kind at the
    window step's shapes, 20 in a CUDA graph."""
    from repro_torch.distributed import collectives as coll
    trace = sharded["trace"]
    out = {"device_ms": {}, "serve_trace": {}, "collective_ms": {}}
    keys = {"window graph": [("window", (STREAM_WINDOW,))],
            "chunk K=16 graph": [("chunk", (16, STREAM_WINDOW))],
            "flush_every=4 graph": [("defer", (STREAM_WINDOW,)),
                                    ("flush", (4 * 64, 8))]}
    order = ("single", "sharded", "sharded", "single")
    for (name, route), (srv, single) in sharded["servers"].items():
        if route not in keys and route != "window eager":
            continue
        pair = {"single": single, "sharded": srv}
        dev_ms = {}
        for key in keys.get(route, ()):
            runs = {"single": [], "sharded": []}
            for _ in range(2):
                for who in order:
                    runs[who].append(_median_ms(
                        torch, pair[who]._step_graphs[key][0].replay))
            dev_ms[key[0]] = {who: statistics.median(v)
                              for who, v in runs.items()}
        wall = {"single": [], "sharded": []}
        for _ in range(3):
            for who in order:
                pair[who].reset()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pair[who].serve_trace(trace)       # ends with stats.check()
                wall[who].append(time.perf_counter() - t0)
        label = f"{name} {route}"
        out["device_ms"][label] = dev_ms
        out["serve_trace"][label] = {
            who: dict(ms=1e3 * statistics.median(v),
                      packets_per_s=trace.n_packets / statistics.median(v))
            for who, v in wall.items()}
        for step, d in dev_ms.items():
            print(f"time sharded[{label}] {step} step device by graph "
                  f"replay: single {d['single']:.4f} ms, sharded (D=1, one "
                  f"NCCL rank) {d['sharded']:.4f} ms, "
                  f"{d['sharded'] - d['single']:+.4f} ms on {smi}")
        st = out["serve_trace"][label]
        print(f"time sharded[{label}] serve_trace {trace.n_packets} packets "
              f"(median of 6, in turns): single {st['single']['ms']:.2f} ms "
              f"({st['single']['packets_per_s']:.0f} packets/s), sharded "
              f"{st['sharded']['ms']:.2f} ms "
              f"({st['sharded']['packets_per_s']:.0f} packets/s) on {smi}")

    # each collective kind alone at the window step's shapes: 20 calls in a
    # graph captured as the server captures (NCCL's watchdog queries its
    # events meanwhile), replays timed by CUDA events
    srv = sharded["servers"][("no_eviction", "window graph")][0]
    dev = srv.device
    rows = torch.zeros((STREAM_WINDOW, 8), device=dev)
    buf = torch.zeros((64, 8), device=dev)
    pred = torch.zeros(STREAM_WINDOW, dtype=torch.int64, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    calls = {"psum (64, 8) buffer": lambda: coll.psum(buf, srv._shard_group),
             "psum i32 scalar": lambda: coll.psum(count, srv._shard_group),
             "reduce-scatter (1024, 8) rows":
                 lambda: coll.psum_scatter(rows, srv._shard_group),
             "all-gather 1024 int64 preds":
                 lambda: coll.all_gather(pred, srv._mesh_group)}
    for label, fn in calls.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for _ in range(20):
                fn()
        ms = _median_ms(torch, graph.replay) / 20
        out["collective_ms"][label] = ms
        print(f"time sharded collective[{label}, one NCCL rank] {ms:.5f} ms "
              f"a call (device, graph of 20) on {smi}")
    return out


def _serve_families(torch, np, dev, xtr, ytr, x_all, yte, big,
                    classical_arts, km):
    """Serve the SVM, NB and K-Means switch artifacts (``classical_arts``,
    built once by the caller; ``km`` is the K-Means model) and the
    isolation forest, trained and mapped here, in front of the XGB backend,
    over every test row in batches of 2048. Launch counts are set to 0
    first and read last. K-Means serves cluster ids, so its backend answers
    in cluster ids too and the model zoo's majority flip maps the final
    answers to classes, outside the server."""
    from repro_torch.core.mapping import map_tree_ensemble
    from repro_torch.ml.kmeans import predict_kmeans
    from repro_torch.ml.metrics import accuracy, precision_recall_f1
    from repro_torch.ml.trees import fit_isolation_forest, predict_margin_xgboost
    from repro_torch.serving.hybrid_serving import HybridServer

    def xgb_fn(rows):
        return (predict_margin_xgboost(big, rows) > 0).to(torch.int32)

    n = x_all.shape[0]
    batches = [(lo, min(lo + 2048, n)) for lo in range(0, n, 2048)]
    _reset_counts()
    out = {}
    for name in ("svm", "nb", "kmeans", "iforest"):
        backend, flip, note = xgb_fn, False, ""
        art = classical_arts.get(name)
        if name == "kmeans":
            assign = predict_kmeans(km, xtr).cpu().numpy()
            maj = [int(np.round(np.mean(ytr[assign == c])))
                   if np.any(assign == c) else c for c in range(2)]
            flip = maj[0] == 1
            note = f"flip={flip} "
            if flip:
                def backend(rows):
                    return 1 - xgb_fn(rows)
        elif name == "iforest":
            art = map_tree_ensemble(fit_isolation_forest(xtr, device=dev),
                                    xtr.shape[1])
        # eager two-phase serving, as slices 1-3 served and timed it
        srv = HybridServer(art, backend, threshold=0.7, capacity=1024,
                           fuse=False, device=dev)
        preds, stats = [], []
        for lo, hi in batches:
            p, st = srv.classify(x_all[lo:hi])
            preds.append(p)
            stats.append(st)
        out[name] = dict(server=srv, batches=batches, flip=flip, note=note,
                         raw_pred=torch.cat(preds), stats=stats)
    torch.cuda.synchronize()
    path = _counts()
    for fam in out.values():
        raw = fam["raw_pred"]
        pred = 1 - raw if fam["flip"] else raw
        p, r, f1 = precision_recall_f1(yte, pred)
        rows = [hi - lo for lo, hi in fam["batches"]]
        fam.update(pred=pred, acc=accuracy(yte, pred), precision=p, recall=r,
                   f1=f1, backend_rows=sum(s.backend_rows for s in fam["stats"]),
                   handled=sum(s.fraction_handled * k
                               for s, k in zip(fam["stats"], rows)) / sum(rows))
    return path, out


def _time_parts(torch, fused_classify, server, xb, label, smi):
    """Where one classify's time goes, part by part (eager calls)."""
    from repro_torch.core.hybrid import combine, dispatch
    sw_pred, conf = fused_classify(server.artifact, xb, tiles=server.tiles,
                                   device="cuda")
    fwd = conf < server.threshold
    buf, idx, valid = dispatch(xb, fwd, server.capacity)
    be_pred = server.backend_fn(buf)
    parts = {
        "switch(fused_classify)": lambda: fused_classify(
            server.artifact, xb, tiles=server.tiles, device="cuda"),
        "dispatch": lambda: dispatch(xb, fwd, server.capacity),
        "backend(xgb 60x6)": lambda: server.backend_fn(buf),
        "combine": lambda: combine(sw_pred, be_pred, idx, valid)}
    print(f"time classify[{label}] parts: " + ", ".join(
        f"{k} {_median_ms(torch, fn):.4f} ms" for k, fn in parts.items())
        + f" on {smi}")


def _bound(n_bytes, ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _times(torch, kernel, plain, library=None):
    """(kernel graph ms, kernel eager ms, plain graph ms, plain eager ms,
    library ms or None): device time per call from a CUDA graph of 50
    calls, and one eager Python call, each a median of CUDA-event timings."""
    return (_graph_ms(torch, kernel), _median_ms(torch, kernel, inner=20),
            _graph_ms(torch, plain), _median_ms(torch, plain, inner=20),
            None if library is None else _graph_ms(torch, library))


def _time_classical(torch, ck, name, art, x, launches):
    edges, vflat = art.edges, art.vtable_flat
    m = art.vtable.q.shape[2]
    n, f = x.shape
    u = edges.shape[1]
    out_k = ck.classical_lookup_fused(x, edges, vflat, m)
    out_p = ck.classical_lookup_fused_ref(x, edges, vflat, m)
    err = float((out_k - out_p).abs().max())
    ms, ms_eager, plain_ms, plain_eager, _ = _times(
        torch, lambda: ck.classical_lookup_fused(x, edges, vflat, m),
        lambda: ck.classical_lookup_fused_ref(x, edges, vflat, m))
    # bound: x and edges read once, the M values of each (feature, bin)
    # these rows touch read once, the (N, M) output written once; N*F*U
    # compares and N*F*M adds
    bins = ck.bucketize_ref(x, edges).long()
    b_pad = vflat.shape[0] // f
    touched = torch.unique(bins + torch.arange(f, device=x.device) * b_pad)
    n_bytes = 4 * (x.numel() + edges.numel() + touched.numel() * m + n * m)
    ops = n * f * u + n * f * m
    bound_ms, bound_by = _bound(n_bytes, ops)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/classical_lookup.cu",
            "replaces": "src/repro/kernels/classical_lookup.py:36",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "ms_eager": ms_eager,
            "plain_ms_eager": plain_eager, "bytes": n_bytes, "ops": ops,
            "shape": {"N": n, "F": f, "U": u, "Bp": vflat.shape[0] // f,
                      "M": m, "Mp": vflat.shape[1], "agg": art.agg}}


def _time_bucketize(torch, bk, edges, x, launches):
    n, f = x.shape
    u = edges.shape[1]
    out_k = bk.bucketize(x, edges)
    out_p = bk.bucketize_ref(x, edges)
    err = float((out_k - out_p).abs().max())
    xt = x.t().contiguous()
    lib = torch.searchsorted(edges, xt)           # (F, N): #{u : e < x}
    print(f"library torch.searchsorted(edges, x.T) equals the kernel: "
          f"{torch.equal(lib.t().to(torch.int32), out_k)}")
    ms, ms_eager, plain_ms, plain_eager, library_ms = _times(
        torch, lambda: bk.bucketize(x, edges),
        lambda: bk.bucketize_ref(x, edges),
        lambda: torch.searchsorted(edges, xt))
    n_bytes = 4 * (x.numel() + edges.numel() + n * f)
    ops = n * f * u
    bound_ms, bound_by = _bound(n_bytes, ops)
    # the same edges at a 2048-row batch: kernel and searchsorted in turn
    # (kernel, library, kernel, library), graphs of 50
    x2 = x[:2048].contiguous()
    xt2 = x2.t().contiguous()
    small = [_graph_ms(torch, fn) for fn in (
        lambda: bk.bucketize(x2, edges), lambda: torch.searchsorted(edges, xt2),
        lambda: bk.bucketize(x2, edges), lambda: torch.searchsorted(edges, xt2))]
    b2, o2 = _bound(4 * (x2.numel() + edges.numel() + x2.numel()),
                    x2.numel() * u)
    print(f"time bucketize at N=2048 F={f} U={u}: kernel {small[0]:.5f} / "
          f"{small[2]:.5f} ms, torch.searchsorted(edges, x.T) {small[1]:.5f} "
          f"/ {small[3]:.5f} ms (graphs of 50, in turn); bound {b2:.6f} ms "
          f"({o2})")
    return {"name": "bucketize", "route": "cuda",
            "source": "src/repro_torch/csrc/bucketize.cu",
            "replaces": "src/repro/kernels/bucketize.py:32",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "ms_eager": ms_eager,
            "plain_ms_eager": plain_eager, "bytes": n_bytes, "ops": ops,
            "shape": {"N": n, "F": f, "U": u, "block": bk.BLOCK},
            "n2048": {"ms": min(small[0], small[2]),
                      "library_ms": min(small[1], small[3]),
                      "bound_ms": b2}}


def _time_tuned(torch, tuned, xb, smi):
    """One 2048-row classify per server of phase 4d: the eager default, the
    fused step (per call, and its graph's replay alone), the loop tiles and
    the autotuned tiles (eager calls, and their device time in a graph)."""
    graph = tuned["fused"]._graphs[tuple(xb.shape)][0]
    replay = _median_ms(torch, graph.replay)
    for name in ("eager", "fused", "loop", "tuned"):
        srv = tuned[name]
        call = _median_ms(torch, lambda: srv.classify(xb))
        dev_ms = (replay if name == "fused" else
                  _graph_ms(torch, lambda: srv.classify(xb), inner=5))
        print(f"time classify[rf, {name}: tiles={srv.tiles.tile_n}/"
              f"{srv.tiles.select}/{srv.tiles.impl} fused_ok={srv._fused_ok}]"
              f"(batch=2048, XGB 60x6 backend) median {call:.4f} ms per call,"
              f" {dev_ms:.4f} ms device time (graph replay) on {smi}")


def _time_loop(torch, ek, art, x, launches):
    """B7 at the serve shape: the RF switch's unflattened tables, 2048 rows."""
    tabs, kw = _loop_args(torch, art)
    edges, ftable, strides, dtable = tabs
    n, f = x.shape
    u = edges.shape[1]
    t, s = dtable.shape
    cout = kw["n_classes"] if kw["vote"] else 1
    out_k = ek.ensemble_lookup_loop(x, *tabs, **kw)
    out_p = ek.ensemble_lookup_loop_ref(x, *tabs, **kw)
    err = _max_abs_err(out_k, out_p)
    ms, ms_eager, plain_ms, plain_eager, _ = _times(
        torch, lambda: ek.ensemble_lookup_loop(x, *tabs, **kw),
        lambda: ek.ensemble_lookup_loop_ref(x, *tabs, **kw))
    # bound: x, edges, codes and strides read once, the decision entries
    # these rows touch (keys in [0, S)) read once, the output written once;
    # N*F*U compares, N*T*F products and sums, N*T*Co compares
    bins = ek.bucketize_ref(x, edges).long()
    codes = ftable[torch.arange(f, device=x.device)[None, :], bins].long()
    keys = (codes * strides.t().long()[None]).sum(dim=1)         # (N, T)
    inside = (keys >= 0) & (keys < s)
    pairs = torch.unique((keys + torch.arange(t, device=x.device) * s)[inside])
    n_bytes = 4 * (x.numel() + edges.numel() + ftable.numel()
                   + strides.numel() + pairs.numel() + n * cout)
    ops = n * f * u + 2 * n * t * f + n * t * cout
    bound_ms, bound_by = _bound(n_bytes, ops)
    return {"name": "ensemble_lookup_loop", "route": "cuda",
            "source": "src/repro_torch/csrc/ensemble_loop.cu",
            "replaces": "src/repro/kernels/ensemble_lookup.py:249",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "ms_eager": ms_eager,
            "plain_ms_eager": plain_eager, "bytes": n_bytes, "ops": ops,
            "shape": {"N": n, "F": f, "U": u, "T": t, "S": s, "Co": cout,
                      "staged": ek.loop_fits_smem(f, u, t, s, 128)}}


def _time_kernel(torch, ek, name, tabs, x, select, replaces, launches):
    edges, ftable_flat, dtable_flat, dtable_pad = tabs
    n, f = x.shape
    u = edges.shape[1]
    cout, t, s_pad = dtable_flat.shape
    out_k = ek.ensemble_lookup_fused(x, *tabs, select=select)
    out_p = ek.ensemble_lookup_fused_ref(x, *tabs, select=select)
    err = float((out_k - out_p).abs().max())
    ms, ms_eager, plain_ms, plain_ms_eager, _ = _times(
        torch, lambda: ek.ensemble_lookup_fused(x, *tabs, select=select),
        lambda: ek.ensemble_lookup_fused_ref(x, *tabs, select=select))

    # bound: bytes this call must move (x, edges and the feature table's
    # U+1 bins x T trees read once, as B7's unpadded table, not the Bp x Tp
    # padding; the decision-table entries these rows touch; the output
    # written once) and the compares and adds it must do, at the card's
    # peak rates
    keys = ek.decision_keys(x, edges, ftable_flat, t)
    inside = (keys >= 0) & (keys < s_pad)
    pairs = torch.unique((keys + torch.arange(t, device=x.device)
                          * s_pad)[inside])
    d_bytes = 4 * pairs.numel() * (cout if select == "matmul" else 1)
    n_bytes = 4 * (x.numel() + edges.numel() + f * (u + 1) * t
                   + n * cout) + d_bytes
    ops = n * f * u + n * t * f + n * t * cout
    bound_ms, bound_by = _bound(n_bytes, ops)
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/ensemble_lookup.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "ms_eager": ms_eager,
            "plain_ms_eager": plain_ms_eager, "bytes": n_bytes, "ops": ops,
            "shape": {"N": n, "F": f, "U": u, "T": t, "Sp": s_pad,
                      "Co": cout, "tile_n": 128,
                      "staged": ek.stage_mode(f, u, ftable_flat.shape[0] // f,
                                              ftable_flat.shape[1], t, s_pad,
                                              cout, select, 128)}}


# -- the LM side: B8 and Qwen3-4B serving ------------------------------------

LM_ARCH = "qwen3-4b"
LM_BATCH, LM_PROMPT, LM_MAX_LEN, LM_STEPS = 8, 256, 32768, 16
B8_SOURCE = "src/repro_torch/csrc/decode_attention.cu"
B8_REPLACES = "src/repro/kernels/decode_attention.py:32"


def _check_b8(torch, da, name, args, detail) -> float:
    """One B8 call against its plain version on the same inputs: exactly one
    launch, finite, and |kernel - plain| <= ATOL + RTOL * |plain| everywhere
    (rtol 2e-4, atol 2e-5: the reference's own Pallas-against-oracle
    tolerance). -> max |kernel - plain|."""
    from repro_torch.models.attention import _inv_sqrt
    scale = _inv_sqrt(args[0].shape[-1])        # gqa_decode's scale
    before = da.LAUNCHES["decode_attention"]
    out = da.decode_attention_int8(*args, scale=scale)
    torch.cuda.synchronize()
    launched = da.LAUNCHES["decode_attention"] - before
    ref = da.decode_attention_int8_ref(*args, scale=scale)
    gap = (out - ref).abs()
    err = float(gap.max())
    ok = (launched == 1 and bool(torch.isfinite(out).all())
          and bool((gap <= da.ATOL + da.RTOL * ref.abs()).all()))
    plan = da.plan_for(args[0], args[1], args[3])
    print(f"case decode_attention:{name} {detail} launches={launched} "
          f"n_split={plan['n_split']} chunk={plan['chunk']} "
          f"grid={plan['grid']} kd={plan['kd']} "
          f"max_abs_diff={err} within rtol={da.RTOL} atol={da.ATOL}: {ok}")
    if not ok:
        raise AssertionError(f"decode_attention kernel != plain: {name} "
                             f"{detail}")
    return err


def _b8_inputs(torch, np, dev, b, s, g, m, hd, seed):
    """A synthetic int8 cache made as the reference's kernel test makes it
    (tests/test_decode_attention_kernel.py:14-31: K/V normal with std 2,
    per-slot scales absmax/127 + 1e-8, codes rounded), drawn in float32 from
    a seeded numpy generator; every slot live."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, g, m, hd),
                                             dtype=np.float32)).to(dev)

    def quantized():
        f = rng.standard_normal((b, s, g, hd), dtype=np.float32)
        f *= np.float32(2.0)
        sc = (np.max(np.abs(f), axis=-1, keepdims=True) / np.float32(127.0)
              + np.float32(1e-8)).astype(np.float32)
        np.divide(f, sc, out=f)
        np.rint(f, out=f)
        return (torch.from_numpy(f.astype(np.int8)).to(dev),
                torch.from_numpy(sc).to(dev))

    kq, ks = quantized()
    vq, vs = quantized()
    valid = torch.ones((b, s), dtype=torch.float32, device=dev)
    return [q, kq, ks, vq, vs, valid]


def _check_decode_attention(torch, np, dev, da) -> float:
    """Phase 3 for B8: the kernel against its plain version, one launch per
    call. At the slice's shape (B=8, S=32768, G=8, M=4, hd=128): every slot
    live, a ring with holes (each row live up to its own length, a fifth of
    those slots dead), every slot dead (the uniform mean of V), and the
    served path's (S,) mask broadcast over B (stride 0). Then ragged S (1,
    700, 1000), h2o-danube-1.8b's shape (its 4096-slot ring, G=8, M=4,
    hd=80) with ring holes, and M in {1, 4, 8} x hd in {16, 64, 80, 128} at
    B=2, G=2. -> the largest |kernel - plain|."""
    errs = []
    b, s, g, m, hd = 8, 32768, 8, 4, 128
    args = _b8_inputs(torch, np, dev, b, s, g, m, hd, seed=0)
    b, s, g, hd = args[1].shape
    gen = torch.Generator(device=dev).manual_seed(1)
    lengths = torch.randint(1, s + 1, (b, 1), generator=gen, device=dev)
    ring = ((torch.arange(s, device=dev)[None] < lengths)
            & (torch.rand((b, s), generator=gen, device=dev) >= 0.2))
    shared = torch.arange(s, device=dev) < s // 100
    masks = {"all_live": args[5],
             "ring_holes": ring.to(torch.float32),
             "all_dead": torch.zeros((b, s), device=dev),
             "broadcast_mask": shared.to(torch.float32)[None].expand(b, s)}
    for name, valid in masks.items():
        errs.append(_check_b8(torch, da, name, args[:5] + [valid],
                              f"B={b} S={s} G={g} M={m} hd={hd} live="
                              f"{int((valid > 0.5).sum())}"))
    del args, masks
    for s_r in (1, 700, 1000):
        args = _b8_inputs(torch, np, dev, 2, s_r, 2, 4, 128, seed=s_r)
        args[5][:, s_r // 3:s_r // 2] = 0.0
        errs.append(_check_b8(torch, da, "ragged_s", args,
                              f"B=2 S={s_r} G=2 M=4 hd=128"))
    # the split's edges at G=8, hd=128: S one below, at and one above a
    # chunk boundary (the last chunk one slot short, whole, one slot long);
    # then a chunk entirely dead beside live ones, and one row all dead
    for name, s_r in _split_edges(da, dev, 8, 8, 4, 128):
        args = _b8_inputs(torch, np, dev, 8, s_r, 8, 4, 128, seed=s_r)
        chunk = da.plan_for(args[0], args[1], args[3])["chunk"]
        errs.append(_check_b8(torch, da, f"split_edge[{name}]", args,
                              f"B=8 S={s_r} G=8 M=4 hd=128"))
        if name == "at":
            args[5][:, chunk:2 * chunk] = 0.0
            errs.append(_check_b8(torch, da, "split_dead_chunk", args,
                                  f"B=8 S={s_r} slots [{chunk}, "
                                  f"{2 * chunk}) dead"))
            args[5][0] = 0.0
            errs.append(_check_b8(torch, da, "split_dead_row", args,
                                  f"B=8 S={s_r} row 0 all dead"))
    args = _b8_inputs(torch, np, dev, 8, 4096, 8, 4, 80, seed=80)
    args[5][:, ::5] = 0.0
    args[5][:, 3000:] = 0.0
    errs.append(_check_b8(torch, da, "danube_ring", args,
                          "B=8 S=4096 G=8 M=4 hd=80 live="
                          f"{int((args[5] > 0.5).sum())}"))
    for m_r in (1, 4, 8):
        for hd_r in (16, 64, 80, 128):
            args = _b8_inputs(torch, np, dev, 2, 1000, 2, m_r, hd_r,
                              seed=10 * m_r + hd_r)
            args[5][1, 500:] = 0.0
            errs.append(_check_b8(torch, da, "m_hd_grid", args,
                                  f"B=2 S=1000 G=2 M={m_r} hd={hd_r}"))
    # M past 8, in query groups over the grid (ceil(M / 8) of them, the last
    # short where 8 does not divide M), then the served shapes of phase 4n's
    # int8 caches: recurrentgemma's local attention (M=10, hd=256, its
    # 2048-slot window), arctic (M=7) and phi-3 (M=1, hd=96)
    for b_r, s_r, g_r, m_r, hd_r in B8_GROUP_SHAPES:
        args = _b8_inputs(torch, np, dev, b_r, s_r, g_r, m_r, hd_r,
                          seed=m_r + hd_r + s_r)
        args[5][:, s_r // 2 + 1:] = 0.0
        args[5][0, ::3] = 0.0
        errs.append(_check_b8(torch, da, "m_groups", args,
                              f"B={b_r} S={s_r} G={g_r} M={m_r} hd={hd_r}"))
    return max(errs)


B8_GROUP_SHAPES = ((2, 1000, 2, 9, 128), (2, 1000, 2, 16, 64),
                   (2, 1000, 1, 10, 256), (8, 2048, 1, 10, 256),
                   (8, 2048, 8, 7, 128), (8, 2048, 32, 1, 96))


def _split_edges(da, dev, b, g, m, hd):
    """S one below, at and one above a chunk boundary of the split B8's
    wrapper picks for (B, G, M, hd) on this card: the first S from 3000 up
    whose chunk leaves a last chunk of chunk - 1, chunk and 1 slots."""
    from repro_torch.kernels import _build
    sms = _build.sm_count(dev)
    found = {}
    for s_r in range(3000, 20000):
        plan = da.launch_plan(b, s_r, g, m, hd, wide=True, sms=sms)
        if plan["n_split"] < 2:
            continue
        rest = s_r - (plan["n_split"] - 1) * plan["chunk"]
        for name, want in (("below", plan["chunk"] - 1),
                           ("at", plan["chunk"]), ("above", 1)):
            if rest == want and name not in found:
                found[name] = s_r
        if len(found) == 3:
            break
    return sorted(found.items(), key=lambda kv: kv[1])


def _serve_lm_launcher(torch, ek, serve, HybridServer):
    """Phase 4e: ``repro_torch.launch.serve --backend lm`` at its default
    width (the RF 10x5 switch in front of the smoke-size qwen3-4b scorer,
    tau 0.7, capacity 1024, batch 2048; ``fuse=None``, as the reference's
    launcher passes it), with the launch counts set to 0 just before it and
    read just after: one switch-kernel launch per classify and no B8 (the
    backend only prefills). The served classes must equal those of the same
    server on the plain path; a second classify of the batch replays the
    fused step when the probe took it, and must give the same classes."""
    _reset_counts()
    res = serve.main(["--device", "cuda", "--backend", "lm"])
    torch.cuda.synchronize()
    path = _counts()
    srv = res["server"]
    art = srv.artifact
    select = ek.resolve_select("auto", art.n_trees, art.dtable_flat.shape[2],
                               art.dtable_flat.shape[0])
    print(f"main-path launches (e: launcher --backend lm): {path}")
    want = {select: res["batches"]}
    for key, count in path.items():
        if key == "bucketize":          # the switch's fit bins on the card
            if count < 1:
                raise AssertionError("--backend lm: the fit did not bin "
                                     "through B4")
        elif count != want.get(key, 0):
            raise AssertionError(f"--backend lm: {key} launched {count} "
                                 f"times for {res['batches']} classify calls")
    batch = res["pred"].shape[0] // res["batches"]
    plain = HybridServer(res["artifact"], srv.backend_fn,
                         threshold=srv.threshold, capacity=srv.capacity,
                         use_kernel=False, fuse=False, device="cuda")
    plain_pred = torch.cat([
        plain.classify(res["x_test"][i * batch:(i + 1) * batch])[0]
        for i in range(res["batches"])])
    if not torch.equal(res["pred"], plain_pred):
        raise AssertionError("--backend lm: served preds != plain preds")
    again = srv.classify(res["x_test"][:batch])[0]
    if not torch.equal(again, res["pred"][:batch]):
        raise AssertionError("--backend lm: a second classify differs")
    route = "fused (CUDA graph)" if srv._fused_ok else "two-phase (eager)"
    print(f"serve[backend=lm] acc={res['acc']:.4f} f1={res['f1']:.4f} "
          f"handled_at_switch={res['stats'].fraction_handled:.4f} "
          f"backend_rows={res['stats'].backend_rows} "
          f"batches={res['batches']} route={route} "
          f"_fused_ok={srv._fused_ok} graphs={sorted(srv._graphs)} "
          f"preds_equal_plain=True")


def _fill_quantized(q8, dst, src):
    """Quantize the prefill K/V through the port's ``_q8`` into the leading
    slots of an int8 decode cache, in place (the reference's
    ``tests/test_int8_kv.py:20-35`` helper); every other leaf (an MLA
    latent, a recurrent state, Whisper's caches) takes the prefill's values
    in its leading slots, as ``serving.engine`` places them."""
    from repro_torch.serving.engine import _place_prefill_into_decode
    if isinstance(dst, dict) and "k_scale" in dst:
        for key in ("k", "v"):
            q, sc = q8(src[key])
            dst[key][tuple(slice(0, x) for x in q.shape)] = q
            dst[key + "_scale"][tuple(slice(0, x) for x in sc.shape)] = sc
        dst["pos"][..., :src["pos"].shape[-1]] = src["pos"]
        return dst
    if isinstance(dst, dict):
        return {k: _fill_quantized(q8, dst[k], src[k]) for k in dst}
    if isinstance(dst, (list, tuple)):
        return type(dst)(_fill_quantized(q8, d, s) for d, s in zip(dst, src))
    return _place_prefill_into_decode(dst, src)


def _decode_route(torch, step, logits, pos0, caches, steps):
    """``steps`` greedy steps of ``step(token, pos, caches)`` (the eager
    ``decode_step`` or the engine's graph) from ``logits`` (the
    prefill's): -> (tokens, each step's logits, host ms of each step to
    its sync, seconds of the whole loop)."""
    toks, logs, ms = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        t1 = time.perf_counter()
        nxt = logits.argmax(-1).to(torch.int32)
        logits, caches = step(nxt, pos0 + i, caches)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
        toks.append(nxt)
        logs.append(logits)
    return toks, logs, ms, time.perf_counter() - t0


def _same_routes(torch, eager, graph, name):
    """The graph route's tokens and logits against the eager route's, bit
    for bit, step by step."""
    for i, (te, tg, le, lg) in enumerate(zip(eager[0], graph[0], eager[1],
                                             graph[1])):
        if not (torch.equal(te, tg) and torch.equal(le, lg)):
            gap = float((le - lg).abs().max())
            raise AssertionError(f"{name}: the decode graph differs from "
                                 f"eager decode at step {i} (max |logit "
                                 f"diff| {gap})")


def _serve_lm(torch, np, dev):
    """Phase 4f: Qwen3-4B at full width (``get_config('qwen3-4b')``: 36
    layers, d_model 2560, vocab 151,936; f32 params from ``init_model`` on
    the card, seeded), served by ``ServeEngine``: prefill of 8 x 256 seeded
    tokens, the prefill K/V quantized into an int8 decode cache of 32,768
    slots (the cut from ``decode_32k``: batch 128 -> 8), then 16 greedy
    decode steps eagerly; then a fresh cache filled from the same prefill
    and 16 steps from the engine's decode graph (the first step eager as
    its warm-up, then the capture, then 15 replays), whose tokens and
    logits must equal the eager route's bit for bit. The counts are set to
    0 just before the prefill and read after the last step: B8 must launch
    36 x 16 times on the eager route and 36 x 2 on the graph route (the
    warm-up and the capture; a replay runs the captured launches and
    counts none), and nothing else."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.attention import _q8
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    n_params = M.count_params(params)
    print(f"lm: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} params={n_params} "
          f"({4 * n_params / 1e9:.2f} GB f32), init "
          f"{time.perf_counter() - t0:.2f} s")
    eng = ServeEngine(cfg, params, batch=LM_BATCH, max_len=LM_MAX_LEN)

    def eager_step(token, pos, caches):
        return M.decode_step(params, cfg, token, pos, caches)

    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(dev)
    caches = M.init_decode_cache(cfg, LM_BATCH, LM_MAX_LEN, quantize_kv=True,
                                 device=dev)
    cache_bytes = sum(v.numel() * v.element_size()
                      for seg in caches for layer in seg
                      for v in layer.values())
    print(f"lm: int8 decode cache batch={LM_BATCH} slots={LM_MAX_LEN}: "
          f"{cache_bytes / 1e9:.2f} GB; memory allocated "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits0, pcache = eng.prefill({"tokens": toks})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    _fill_quantized(_q8, caches, pcache)
    eager = _decode_route(torch, eager_step, logits0, LM_PROMPT, caches,
                          LM_STEPS)
    # the graph route from the same prefill, on a fresh cache
    del caches
    torch.cuda.empty_cache()
    caches = _fill_quantized(_q8, M.init_decode_cache(
        cfg, LM_BATCH, LM_MAX_LEN, quantize_kv=True, device=dev), pcache)
    del pcache
    ptrs = [t.data_ptr() for seg in caches for layer in seg
            for t in layer.values()]
    graph = _decode_route(torch, eng.decode, logits0, LM_PROMPT, caches,
                          LM_STEPS)
    path = _counts()
    print(f"main-path launches (f: LM serve, prefill + {LM_STEPS} decode "
          f"steps eager + {LM_STEPS} from the decode graph): {path}")
    want = {"decode_attention": cfg.n_layers * (LM_STEPS + 2)}
    for key, count in path.items():
        if count != want.get(key, 0):
            raise AssertionError(f"LM serve: {key} launched {count} times, "
                                 f"want {want.get(key, 0)}")
    if [t.data_ptr() for seg in caches for layer in seg
            for t in layer.values()] != ptrs:
        raise AssertionError("LM serve: the decode graph moved a cache")
    _same_routes(torch, eager, graph, "LM serve")
    gen_toks = torch.stack(eager[0], dim=1)
    first, logits = eager[1][0], eager[1][-1]
    if not (bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(first).all())):
        raise AssertionError("LM serve: logits are not finite")
    if logits.shape != (LM_BATCH, cfg.vocab_size):
        raise AssertionError(f"LM serve: logits shape {tuple(logits.shape)}")
    if int(gen_toks.min()) < 0 or int(gen_toks.max()) >= cfg.vocab_size:
        raise AssertionError("LM serve: a token outside the vocabulary")
    # the first step against a prefill of prompt + its token, as the
    # reference's test_int8_kv.py:44-46 measures it
    ref, _ = eng.prefill({"tokens": torch.cat([toks, gen_toks[:, :1]], 1)})
    rel = float((ref - first).abs().max() / ref.abs().max())
    agree = int((ref.argmax(-1) == first.argmax(-1)).sum())
    print(f"lm: first decode step (int8 cache) vs prefill of prompt+token: "
          f"max|diff|/max|ref| = {rel:.6f}, argmax equal in {agree}/"
          f"{LM_BATCH} rows; graph route equals eager bit for bit over "
          f"{LM_STEPS} steps (tokens and logits), caches in place")
    if rel >= 0.05:
        raise AssertionError(f"int8 decode strays from the prefill: {rel}")
    print(f"lm: generated tokens (first row) {gen_toks[0].tolist()}")
    return dict(cfg=cfg, eng=eng, eager_step=eager_step, caches=caches,
                prefill_ms=prefill_ms, steps_ms=eager[2], decode_s=eager[3],
                graph_steps_ms=graph[2], graph_decode_s=graph[3], path=path,
                rel=rel, agree=agree, n_params=n_params,
                cache_bytes=cache_bytes, last_pos=LM_PROMPT + LM_STEPS - 1,
                token=gen_toks[:, -1])


def _served_args(torch, dev, lm, layer, seed):
    """B8's operands as the served path gives them, for one layer: views of
    the stacked int8 cache, its (S,) live mask broadcast over B, and a
    seeded q."""
    c = lm["caches"][0][0]
    kq, ks, vq, vs = (c[key][layer] for key in ("k", "k_scale", "v",
                                                 "v_scale"))
    b, s, g, hd = kq.shape
    m = lm["cfg"].n_heads // g
    cpos = c["pos"][layer]
    live = ((cpos >= 0) & (cpos <= lm["last_pos"])).to(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, g, m, hd), generator=gen, device=dev)
    return [q, kq, ks, vq, vs, live[None].expand(b, s)]


def _check_served_cache(torch, dev, da, lm) -> float:
    """Phase 3 for B8 on the served int8 cache: layers 0 and 35, seeded q."""
    errs = []
    for layer in (0, lm["cfg"].n_layers - 1):
        args = _served_args(torch, dev, lm, layer, seed=layer)
        b, s, g, hd = args[1].shape
        errs.append(_check_b8(torch, da, f"served_cache[layer {layer}]", args,
                              f"B={b} S={s} G={g} M={args[0].shape[2]} "
                              f"hd={hd} live={int(args[5][0].sum())}"))
    return max(errs)


def _time_lm(torch, dev, da, lm, b8_err, smi):
    """Phase 5 for the LM side: B8 on the served cache's layer 0 (device
    time of 50 launches in a CUDA graph, and one eager call), its plain
    version, the library call (``scaled_dot_product_attention`` with
    ``enable_gqa=True`` on an already-dequantized cache: it leaves the
    dequant out), the bound; then prefill, decode step, tokens/s and B8's
    share of a step. -> B8's kernel row."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.models.attention import _inv_sqrt
    args = _served_args(torch, dev, lm, 0, seed=7)
    q, kq, ks, vq, vs, valid = args
    b, s, g, hd = kq.shape
    m = q.shape[2]
    scale = _inv_sqrt(hd)

    def kernel():
        return da.decode_attention_int8(*args, scale=scale)

    def plain():
        return da.decode_attention_int8_ref(*args, scale=scale)

    out_k = kernel()
    err = max(b8_err, float((out_k - plain()).abs().max()))
    # device times from CUDA graphs, as _times takes them for B1-B7 (10
    # calls a graph for the plain version and the library call, which take
    # milliseconds each), and one eager call of the kernel and the plain
    ms = _graph_ms(torch, kernel)
    ms_eager = _median_ms(torch, kernel)
    plain_ms = _graph_ms(torch, plain, inner=10)
    plain_eager = _median_ms(torch, plain, reps=10, warmup=2)
    kd = (kq.to(torch.float32) * ks).permute(0, 2, 1, 3).contiguous()
    vd = (vq.to(torch.float32) * vs).permute(0, 2, 1, 3).contiguous()
    qh = q.reshape(b, g * m, 1, hd)
    mask = (valid > 0.5)[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qh, kd, vd, attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    lib_gap = float((library().reshape(out_k.shape) - out_k).abs().max())
    library_ms = _graph_ms(torch, library, inner=10)
    del kd, vd
    bound_ms, bound_by, n_bytes, ops = _b8_bound(valid, b, s, g, m, hd)
    plan = da.plan_for(q, kq, vq)
    danube = _time_b8_danube(torch, np, dev, da, smi)
    n_layers = lm["cfg"].n_layers
    step_ms = statistics.median(lm["steps_ms"])
    tok_s = LM_BATCH * LM_STEPS / lm["decode_s"]
    graph_step_ms = statistics.median(lm["graph_steps_ms"][1:])
    graph_tok_s = LM_BATCH * LM_STEPS / lm["graph_decode_s"]
    replay_ms = _median_ms(torch, lm["eng"]._decode_graph[1].replay,
                           reps=10)
    print(f"time decode_attention (B8, served cache layer 0, B={b} S={s} "
          f"G={g} M={m} hd={hd}): kernel {ms:.5f} ms (graph of 50), "
          f"{ms_eager:.5f} ms (eager call); plain {plain_ms:.5f} ms (graph "
          f"of 10), {plain_eager:.5f} ms (eager call); library "
          f"scaled_dot_product_attention(enable_gqa=True) on the dequantized "
          f"cache (dequant left out) {library_ms:.5f} ms (graph of 10), "
          f"max|sdpa - kernel| = {lib_gap}; bound {bound_ms:.6f} ms "
          f"({bound_by}: {n_bytes} B, {ops} flops); split n_split="
          f"{plan['n_split']} chunk={plan['chunk']} grid={plan['grid']} "
          f"threads={plan['threads']} kd={plan['kd']} on {smi}")
    print(f"time lm[{LM_ARCH}, f32, batch {LM_BATCH}]: prefill of "
          f"{LM_PROMPT} tokens {lm['prefill_ms']:.2f} ms; decode step "
          f"(eager, host clock to sync) median {step_ms:.3f} ms, min "
          f"{min(lm['steps_ms']):.3f}, first {lm['steps_ms'][0]:.3f}; "
          f"{tok_s:.1f} tokens/s over {LM_STEPS} steps; from the decode "
          f"graph (host clock to sync, replays) median {graph_step_ms:.3f} "
          f"ms, first (warm-up + capture) {lm['graph_steps_ms'][0]:.3f} ms, "
          f"{graph_tok_s:.1f} tokens/s over {LM_STEPS} steps, replay alone "
          f"{replay_ms:.3f} ms (CUDA events); B8 "
          f"{n_layers} x {ms:.5f} ms = {n_layers * ms:.3f} ms, "
          f"{100 * n_layers * ms / step_ms:.1f}% of a step; weights "
          f"{4 * lm['n_params'] / 1e9:.2f} GB at 3.35 TB/s = "
          f"{1e3 * 4 * lm['n_params'] / HBM_BYTES_PER_S:.3f} ms a step; "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"on {smi}")
    return {"name": "decode_attention", "route": "cuda", "source": B8_SOURCE,
            "replaces": B8_REPLACES, "launches": lm["path"]["decode_attention"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "ms_eager": ms_eager,
            "plain_ms_eager": plain_eager, "bytes": n_bytes, "ops": ops,
            "shape": {"B": b, "S": s, "G": g, "M": m, "hd": hd,
                      "live": int(valid[0].sum())},
            "split": {"n_split": plan["n_split"], "chunk": plan["chunk"],
                      "grid": list(plan["grid"]), "kd": plan["kd"]},
            "danube": danube,
            "decode_step_ms": {"eager": step_ms, "graph": graph_step_ms,
                               "graph_replay": replay_ms},
            "tokens_per_s": {"eager": tok_s, "graph": graph_tok_s}}


# -- phase 4n: the other six LM families through ServeEngine -------------------

# (arch, layers served or None for all); one 80 GB card holds each with f32
# weights: arctic at 1 of its 35 layers (56.3 GB; 2 layers are 110.7 GB),
# deepseek at its 3 dense-prefix layers and 1 MoE layer of 61, without the
# MTP head (60.4 GB; the MTP layer, itself MoE, is read by training only)
LM_FAMILIES = (("recurrentgemma-2b", None), ("xlstm-1.3b", None),
               ("whisper-base", None), ("phi-3-vision-4.2b", None),
               ("arctic-480b", 1), ("deepseek-v3-671b", 4))
FAMILY_MAX_LEN = 2048       # recurrentgemma's local window: its ring is full


def _family_cfg(name, depth):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth, mtp=False)
    return cfg


def _int8_layer(caches):
    """The first int8 GQA cache of a decode cache tree, its first layer
    where the layers are stacked."""
    todo = [caches]
    while todo:
        node = todo.pop(0)
        if isinstance(node, dict) and "k_scale" in node:
            return {k: (v[0] if node["k"].dim() == 5 else v)
                    for k, v in node.items()}
        if isinstance(node, dict):
            todo += list(node.values())
        elif isinstance(node, (list, tuple)):
            todo += list(node)
    return None


def _time_b8_served(torch, da, args, label, smi):
    """B8 on a served cache's layer: kernel (graph of 50), plain (graph of
    10), ``scaled_dot_product_attention(enable_gqa=True)`` on the cache
    dequantized beforehand (graph of 10), and the bound."""
    import torch.nn.functional as F
    from repro_torch.models.attention import _inv_sqrt
    q, kq, ks, vq, vs, valid = args
    b, s, g, hd = kq.shape
    m = q.shape[2]
    scale = _inv_sqrt(hd)
    ms = _graph_ms(torch, lambda: da.decode_attention_int8(*args,
                                                            scale=scale))
    plain_ms = _graph_ms(torch, lambda: da.decode_attention_int8_ref(
        *args, scale=scale), inner=10)
    kd = (kq.to(torch.float32) * ks).permute(0, 2, 1, 3).contiguous()
    vd = (vq.to(torch.float32) * vs).permute(0, 2, 1, 3).contiguous()
    qh = q.reshape(b, g * m, 1, hd)
    mask = (valid > 0.5)[:, None, None, :]
    library_ms = _graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=mask, scale=scale, enable_gqa=True), inner=10)
    bound_ms, bound_by, n_bytes, ops = _b8_bound(valid, b, s, g, m, hd)
    plan = da.plan_for(q, kq, vq)
    print(f"time decode_attention (B8, {label} served cache layer 0, B={b} "
          f"S={s} G={g} M={m} hd={hd}, live={int(valid[0].sum())}): kernel "
          f"{ms:.5f} ms (graph of 50); plain {plain_ms:.5f} ms (graph of "
          f"10); library sdpa(enable_gqa) on the dequantized cache "
          f"{library_ms:.5f} ms (graph of 10); bound {bound_ms:.6f} ms "
          f"({bound_by}: {n_bytes} B, {ops} flops); split n_split="
          f"{plan['n_split']} grid={plan['grid']} m_group={plan['m_group']} "
          f"kd={plan['kd']} on {smi}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "shape": {"B": b, "S": s, "G": g, "M": m, "hd": hd},
            "split": {"n_split": plan["n_split"], "grid": list(plan["grid"]),
                      "m_group": plan["m_group"], "kd": plan["kd"]}}


def _serve_lm_families(torch, np, dev, da, smi):
    """Phase 4n: each family of ``LM_FAMILIES`` in turn, freed before the
    next (``_serve_lm_family``). -> the rows phase 5 prints, and B8's
    launches on their paths."""
    import gc
    rows, launches = [], 0
    for name, depth in LM_FAMILIES:
        row = _serve_lm_family(torch, np, dev, da, smi, name, depth)
        launches += row["launches"]
        rows.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    return {"rows": rows, "launches": launches}


def _serve_lm_family(torch, np, dev, da, smi, name, depth):
    """One family at its published widths (``_family_cfg``; f32 params from
    ``init_model`` on the card, seeded), served by ``ServeEngine`` as phase
    4f serves Qwen3-4B: a prefill of 8 x 256 seeded tokens (whisper's
    encoder over 8 x 1500 seeded frames, phi-3's frontend over 8 x 576
    seeded patch embeddings first), its cache placed into a decode cache of
    ``FAMILY_MAX_LEN`` slots (int8 K/V wherever there are GQA layers;
    f32 latents and recurrent states), 16 greedy steps eagerly, then 16
    from the decode graph on a fresh cache from the same prefill: the same
    tokens and logits bit for bit, the caches in place. The counts are set
    to 0 just before the prefill and read after the last step: B8 launches
    once a GQA layer per eager step and at the graph's warm-up and capture,
    nothing else launches. Then the first step against a prefill of prompt
    + token (max|diff| / max|ref| < 0.05, as phase 4f; for MoE a prefill
    that drops no unit: row by row, every expert with room for the whole
    row), B8 against its plain version on the served int8 cache, and the
    times. -> a row."""
    import dataclasses
    from repro_torch.models import model as M
    from repro_torch.models.attention import _q8
    from repro_torch.models.transformer import _layer_spec, tree_leaves
    from repro_torch.serving.engine import ServeEngine

    cfg = _family_cfg(name, depth)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                          device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = M.count_params(params)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)).astype(np.int32)).to(dev)}
    front = (LM_BATCH, cfg.n_frontend_tokens, cfg.frontend_dim)
    n_front = 0
    if cfg.encdec:
        batch["frames"] = torch.from_numpy(0.1 * rng.standard_normal(
            front, dtype=np.float32)).to(dev)
    if cfg.frontend == "image_patches":
        batch["patch_embeds"] = torch.from_numpy(0.1 * rng.standard_normal(
            front, dtype=np.float32)).to(dev)
        n_front = cfg.n_frontend_tokens
    n_gqa = 0 if cfg.encdec else sum(
        _layer_spec(cfg, i)[0] in ("attn", "local_attn")
        for i in range(cfg.n_layers))
    quant = n_gqa > 0

    def fresh():
        return M.init_decode_cache(cfg, LM_BATCH, FAMILY_MAX_LEN,
                                   dtype=torch.float32, quantize_kv=quant,
                                   device=dev)

    eng = ServeEngine(cfg, params, batch=LM_BATCH, max_len=FAMILY_MAX_LEN)

    def eager_step(token, pos, caches):
        return M.decode_step(params, cfg, token, pos, caches)

    caches = fresh()
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    print(f"lm[{name}]: layers={cfg.n_layers}"
          f"{'' if depth is None else ' (cut)'} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} blocks={cfg.block_pattern} "
          f"vocab={cfg.vocab_size} params={n_params} "
          f"({4 * n_params / 1e9:.2f} GB f32), init {init_s:.2f} s; decode "
          f"cache {'int8' if quant else 'f32'} batch={LM_BATCH} slots="
          f"{FAMILY_MAX_LEN}: {cache_bytes / 1e9:.3f} GB; front={n_front}")

    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits0, pcache = eng.prefill(batch)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    _fill_quantized(_q8, caches, pcache)
    pos0 = LM_PROMPT + n_front
    eager = _decode_route(torch, eager_step, logits0, pos0, caches,
                          LM_STEPS)
    del caches
    torch.cuda.empty_cache()
    caches = _fill_quantized(_q8, fresh(), pcache)
    del pcache
    ptrs = [t.data_ptr() for t in tree_leaves(caches)]
    graph = _decode_route(torch, eng.decode, logits0, pos0, caches,
                          LM_STEPS)
    path = _counts()
    print(f"main-path launches (n: {name}, prefill + {LM_STEPS} decode steps "
          f"eager + {LM_STEPS} from the decode graph): {path}")
    want = {"decode_attention": n_gqa * (LM_STEPS + 2)}
    for key, count in path.items():
        if count != want.get(key, 0):
            raise AssertionError(f"{name}: {key} launched {count} times, "
                                 f"want {want.get(key, 0)}")
    if [t.data_ptr() for t in tree_leaves(caches)] != ptrs:
        raise AssertionError(f"{name}: the decode graph moved a cache")
    _same_routes(torch, eager, graph, name)
    gen_toks = torch.stack(eager[0], dim=1)
    first = eager[1][0]
    for lg in (first, eager[1][-1]):
        if lg.shape != (LM_BATCH, cfg.vocab_size) \
                or not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{name}: logits {tuple(lg.shape)} not "
                                 f"finite or not (B, V)")
    if int(gen_toks.min()) < 0 or int(gen_toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{name}: a token outside the vocabulary")
    full = dict(batch, tokens=torch.cat([batch["tokens"], gen_toks[:, :1]],
                                        1))
    if cfg.moe is None:
        ref, _ = M.prefill(params, cfg, full)
    else:
        # a decode step at B=8 drops no MoE unit (an expert takes at most
        # one unit a token, and its capacity is 8 at least); a prefill of
        # 8 x 257 tokens at the configured factor drops the units past an
        # expert's capacity (the reference's semantics: its own
        # prefill-to-decode test allows 0.05 for MoE). So the decode is
        # held to a prefill that drops nothing: row by row, at a factor
        # that gives every expert room for all 257 tokens of the row
        m = cfg.moe
        ref_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=1.01 * m.n_experts / m.top_k))
        ref = torch.cat([M.prefill(params, ref_cfg, {
            k: v[r:r + 1] for k, v in full.items()})[0]
            for r in range(LM_BATCH)])
    rel = float((ref - first).abs().max() / ref.abs().max())
    agree = int((ref.argmax(-1) == first.argmax(-1)).sum())
    del ref
    print(f"lm[{name}]: first decode step vs prefill of prompt+token: "
          f"max|diff|/max|ref| = {rel:.6f}, argmax equal in {agree}/"
          f"{LM_BATCH} rows; graph route equals eager bit for bit over "
          f"{LM_STEPS} steps (tokens and logits), caches in place; tokens "
          f"(first row) {gen_toks[0].tolist()}")
    if rel >= 0.05:
        raise AssertionError(f"{name}: decode strays from the prefill: {rel}")

    b8 = None
    layer = _int8_layer(caches)
    if layer is not None:
        b, s_, g, hd = layer["k"].shape
        last = pos0 + LM_STEPS - 1
        live = ((layer["pos"] >= 0) & (layer["pos"] <= last)).to(
            torch.float32)[None].expand(b, s_)
        q = torch.randn((b, g, cfg.n_heads // g, hd),
                        generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev)
        args = [q, layer["k"], layer["k_scale"], layer["v"],
                layer["v_scale"], live]
        err = _check_b8(torch, da, f"served_cache[{name}]", args,
                        f"B={b} S={s_} G={g} M={q.shape[2]} hd={hd}")
        b8 = dict(_time_b8_served(torch, da, args, name, smi),
                  max_abs_err=err)
    step_ms = statistics.median(eager[2])
    graph_step_ms = statistics.median(graph[2][1:])
    replay_ms = _median_ms(torch, eng._decode_graph[1].replay, reps=10)
    row = {"arch": name, "layers": cfg.n_layers, "params": n_params,
           "cache": "int8" if quant else "f32", "cache_bytes": cache_bytes,
           "prefill_ms": prefill_ms, "decode_step_ms": {
               "eager": step_ms, "graph": graph_step_ms,
               "graph_first": graph[2][0], "graph_replay": replay_ms},
           "tokens_per_s": {"eager": LM_BATCH * LM_STEPS / eager[3],
                            "graph": LM_BATCH * LM_STEPS / graph[3]},
           "rel_vs_prefill": rel, "argmax_agree": agree,
           "launches": path["decode_attention"],
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "b8": b8}
    print(f"time lm[{name}, f32, batch {LM_BATCH}]: prefill of "
          f"{LM_PROMPT} tokens (+{cfg.n_frontend_tokens} frontend) "
          f"{prefill_ms:.2f} ms; decode step eager (host clock to sync) "
          f"median {step_ms:.3f} ms, from the graph {graph_step_ms:.3f} ms "
          f"(first, warm-up + capture, {graph[2][0]:.3f} ms; replay alone "
          f"{replay_ms:.3f} ms by CUDA events); "
          f"{row['tokens_per_s']['eager']:.1f} tokens/s eager, "
          f"{row['tokens_per_s']['graph']:.1f} from the graph; weights "
          f"{4 * n_params / 1e9:.2f} GB at 3.35 TB/s = "
          f"{1e3 * 4 * n_params / HBM_BYTES_PER_S:.3f} ms a step; peak "
          f"memory {row['peak_gb']:.2f} GB on {smi}")
    del eng, eager_step, params, caches, eager, graph, logits0
    return row


def _b8_bound(valid, b, s, g, m, hd):
    """B8's bound: the int8 K/V, their scales, the mask's distinct bytes (an
    (S,) mask broadcast over B with stride 0 counts once) and q read once,
    the output written once; QK and PV products (2 flops each), the dequant
    products and one exp per score. -> (ms, by, bytes, flops)"""
    mask_bytes = 4 * s * (1 if valid.stride(0) == 0 else b)
    n_bytes = 2 * b * s * g * hd + 2 * 4 * b * s * g + mask_bytes \
        + 2 * 4 * b * g * m * hd
    ops = 4 * b * g * m * s * hd + 2 * b * s * g * hd + b * g * m * s
    return (*_bound(n_bytes, ops), n_bytes, ops)


def _time_b8_danube(torch, np, dev, da, smi):
    """B8 at h2o-danube-1.8b's shape (B=8, its 4096-slot ring, G=8, M=4,
    hd=80) on a synthetic cache with holes: kernel (graph of 50), plain
    (graph of 10), bound."""
    from repro_torch.models.attention import _inv_sqrt
    args = _b8_inputs(torch, np, dev, 8, 4096, 8, 4, 80, seed=80)
    args[5][:, ::5] = 0.0
    args[5][:, 3000:] = 0.0
    scale = _inv_sqrt(80)
    ms = _graph_ms(torch, lambda: da.decode_attention_int8(*args,
                                                            scale=scale))
    plain_ms = _graph_ms(torch, lambda: da.decode_attention_int8_ref(
        *args, scale=scale), inner=10)
    bound_ms, bound_by, n_bytes, _ = _b8_bound(args[5], 8, 4096, 8, 4, 80)
    plan = da.plan_for(args[0], args[1], args[3])
    print(f"time decode_attention (B8, h2o-danube shape B=8 S=4096 G=8 M=4 "
          f"hd=80, holes): kernel {ms:.5f} ms (graph of 50); plain "
          f"{plain_ms:.5f} ms (graph of 10); bound {bound_ms:.6f} ms "
          f"({bound_by}: {n_bytes} B); split n_split={plan['n_split']} "
          f"grid={plan['grid']} kd={plan['kd']} on {smi}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "n_split": plan["n_split"]}


def _profile_decode(torch, lm, smi, route="eager"):
    """Where one decode step's device time goes: two more steps under
    ``torch.profiler`` (after the counted run), kernels summed by name,
    eager ``decode_step`` or from the engine's decode graph (``route``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step = lm["eager_step"] if route == "eager" else lm["eng"].decode
    caches = lm["caches"]
    token = lm["token"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(2):
            logits, caches = step(token, lm["last_pos"] + 1 + i, caches)
            token = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only: an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"profile lm decode ({route}, 2 steps): kernels {busy:.3f} ms of "
          f"device time in {wall_ms:.3f} ms wall (idle share "
          f"{100 * (1 - busy / wall_ms):.1f}%, profiler on) on {smi}")
    for key, dev_ms, count in rows[:10]:
        print(f"  {dev_ms / 2:9.3f} ms a step ({100 * dev_ms / busy:5.1f}%) "
              f"x{count // 2} {key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
