#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line is printed):
  1. environment: versions, the card, its power limit; TF32 off.
  2. build: ``nvcc`` compiles every ``src/repro_torch/csrc/*.cu`` for sm_90a
     (one process per source, started together).
  3. kernel vs plain: the tree-ensemble lookup kernel against its plain
     PyTorch version on the card, atol=0, at the serving shapes (the
     anomaly RF switch artifact, the mapped 60-tree XGB backend artifact,
     a synthetic vote artifact past the select crossover), both selects,
     tables staged in shared memory and read from global memory.
  4. serve: the main path, ``repro_torch.launch.serve`` at its full default
     widths on the card (RF 10x5 switch, XGB 60x6 backend, tau 0.7,
     capacity 1024, batch 2048), once with select=auto (the matmul-select
     kernel) and once with select=compare; the kernel's launch counts must
     show one launch per classify, the predictions must equal those of the
     same server on the plain path, and one classify must not sync the host.
  5. times: CUDA events, median over repetitions after warm-up, for each
     kernel, its plain version and one full classify batch.
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
                                           pad_dtable)
    from repro_torch.core.hybrid import combine, dispatch
    from repro_torch.core.inference import table_predict
    from repro_torch.core.mapping import map_tree_ensemble
    from repro_torch.kernels import _build
    from repro_torch.kernels import ensemble_lookup as ek
    from repro_torch.kernels.ops import fused_classify
    from repro_torch.launch import serve
    from repro_torch.launch.serve import build_usecase
    from repro_torch.ml.trees import fit_random_forest, fit_xgboost
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
    xtr, ytr, xte, _ = build_usecase("anomaly", n=20000)
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

    cases = [("rf_switch", tables(rf_art), x_all, "auto", None),
             ("rf_switch", tables(rf_art), x_all, "compare", None),
             ("rf_switch", tables(rf_art), x_all, "matmul", False),
             ("rf_switch", tables(rf_art), x_all, "compare", False),
             ("xgb_backend", tables(xgb_art), x_all, "auto", None),
             ("xgb_backend", tables(xgb_art), x_all, "matmul", None),
             ("synthetic_vote", syn_tabs, x_syn, "auto", None)]
    for name, tabs, x_src, select, staged in cases:
        cout, t, s_pad = tabs[2].shape
        f, u = tabs[0].shape
        b_pad, t_pad = tabs[1].shape[0] // f, tabs[1].shape[1]
        resolved = ek.resolve_select(select, t, s_pad, cout)
        st = (ek.fits_smem(f, u, b_pad, t_pad, t, s_pad, cout, resolved,
                           128) if staged is None else staged)
        for n in (1, 300, 2048):
            x = x_src[:n].contiguous()
            before = dict(ek.LAUNCHES)
            out_k = ek.ensemble_lookup_fused(x, *tabs, select=select,
                                             staged=staged)
            torch.cuda.synchronize()
            launched = ek.LAUNCHES[resolved] - before[resolved]
            out_p = ek.ensemble_lookup_fused_ref(x, *tabs, select=select)
            err = float((out_k - out_p).abs().max())
            print(f"case {name} N={n} F={f} U={u} T={t} Sp={s_pad} Co={cout} "
                  f"select={select}->{resolved} staged={st} "
                  f"launches={launched} max_abs_diff={err}")
            if launched != 1 or not torch.equal(out_k, out_p):
                raise AssertionError(f"kernel != plain for {name} N={n} "
                                     f"select={select} staged={staged}")

    # small-input agreement with the plain table semantics (CPU)
    p_dev, c_dev = fused_classify(rf_art, x_all[:64], device="cuda")
    p_cpu, c_cpu = table_predict(rf_art.to("cpu"), xte[:64])
    if not (torch.equal(p_dev.cpu(), p_cpu) and torch.equal(c_dev.cpu(), c_cpu)):
        bad = ((p_dev.cpu() != p_cpu) | (c_dev.cpu() != c_cpu)).nonzero()
        raise AssertionError(
            f"fused_classify on the card != table_predict on the CPU at rows "
            f"{bad[:8, 0].tolist()}: pred {p_dev[bad[:8, 0]].tolist()} vs "
            f"{p_cpu[bad[:8, 0].cpu()].tolist()}, conf "
            f"{c_dev[bad[:8, 0]].tolist()} vs {c_cpu[bad[:8, 0].cpu()].tolist()}")

    # -- 4. serve: the main path ---------------------------------------------
    ek.reset_launches()
    runs = {}
    for select in ("auto", "compare"):
        print(f"serve --select {select}:")
        runs[select] = serve.main(["--device", "cuda", "--select", select])
    torch.cuda.synchronize()
    main_launches = dict(ek.LAUNCHES)
    print(f"main-path launches: {main_launches}")
    for select, kernel in (("auto", "matmul"), ("compare", "compare")):
        res = runs[select]
        want = res["batches"]
        if main_launches[kernel] != want:
            raise AssertionError(f"{kernel}: {main_launches[kernel]} launches "
                                 f"for {want} classify calls")
        srv = res["server"]
        plain = HybridServer(res["artifact"], srv.backend_fn,
                             threshold=srv.threshold, capacity=srv.capacity,
                             use_kernel=False, device="cuda")
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

    server = runs["auto"]["server"]
    xb = runs["auto"]["x_test"][:2048]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    server.classify(xb)
    torch.cuda.set_sync_debug_mode(0)
    print("classify: no host sync under torch.cuda.set_sync_debug_mode('error')")

    # -- 5. times ------------------------------------------------------------
    served = runs["auto"]["artifact"].to(dev)
    x2048 = xb.contiguous()
    kernel_rows = []
    timing_cases = [("ensemble_lookup:matmul", served, x2048, "matmul",
                     "src/repro/kernels/ensemble_lookup.py:112"),
                    ("ensemble_lookup:compare", served, x2048, "compare",
                     "src/repro/kernels/ensemble_lookup.py:132")]
    for name, art, x, select, replaces in timing_cases:
        tabs = tables(art)
        kernel_rows.append(_time_kernel(torch, ek, name, tabs, x, select,
                                        replaces, main_launches[select]))
    # the backend's compare shape, reported beside the main-path rows
    extra = _time_kernel(torch, ek, "ensemble_lookup:compare[xgb_backend]",
                         tables(xgb_art), x2048, "compare",
                         "src/repro/kernels/ensemble_lookup.py:132", 0)
    classify_ms = _median_ms(torch, lambda: server.classify(xb))
    classify_graph_ms = _graph_ms(torch, lambda: server.classify(xb), inner=5)
    print(f"time classify(batch=2048, full hybrid step) median "
          f"{classify_ms:.4f} ms per eager call, {classify_graph_ms:.4f} ms "
          f"device time (graph replay) on {smi}")
    # where one classify's time goes, part by part (eager calls)
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
    print("time classify parts: " + ", ".join(
        f"{k} {_median_ms(torch, fn):.4f} ms" for k, fn in parts.items())
        + f" on {smi}")
    for row in kernel_rows + [extra]:
        print(f"time {row['name']}: kernel {row['ms']:.5f} ms (graph), "
              f"{row['ms_eager']:.5f} ms (eager call); plain "
              f"{row['plain_ms']:.5f} ms (graph), "
              f"{row['plain_ms_eager']:.5f} ms (eager); bound "
              f"{row['bound_ms']:.6f} ms ({row['bound_by']}); on {smi}")

    # -- 6. results ----------------------------------------------------------
    print("kernels: " + json.dumps([r["name"] for r in kernel_rows]))
    print(smi)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _time_kernel(torch, ek, name, tabs, x, select, replaces, launches):
    edges, ftable_flat, dtable_flat, dtable_pad = tabs
    n, f = x.shape
    u = edges.shape[1]
    cout, t, s_pad = dtable_flat.shape
    out_k = ek.ensemble_lookup_fused(x, *tabs, select=select)
    out_p = ek.ensemble_lookup_fused_ref(x, *tabs, select=select)
    err = float((out_k - out_p).abs().max())

    ms = _graph_ms(torch, lambda: ek.ensemble_lookup_fused(x, *tabs,
                                                           select=select))
    ms_eager = _median_ms(torch, lambda: ek.ensemble_lookup_fused(
        x, *tabs, select=select), inner=20)
    plain_ms = _graph_ms(torch, lambda: ek.ensemble_lookup_fused_ref(
        x, *tabs, select=select))
    plain_ms_eager = _median_ms(torch, lambda: ek.ensemble_lookup_fused_ref(
        x, *tabs, select=select), inner=20)

    # bound: bytes this call must move (x, edges, feature table read once;
    # the decision-table entries these rows touch; the output written once)
    # and the compares and adds it must do, at the card's peak rates
    keys = ek.decision_keys(x, edges, ftable_flat, t)
    pairs = torch.unique(keys + torch.arange(t, device=x.device) * s_pad)
    d_bytes = 4 * pairs.numel() * (cout if select == "matmul" else 1)
    n_bytes = 4 * (x.numel() + edges.numel() + ftable_flat.numel()
                   + n * cout) + d_bytes
    ops = n * f * u + n * t * f + n * t * cout
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/ensemble_lookup.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "ms_eager": ms_eager,
            "plain_ms_eager": plain_ms_eager, "bytes": n_bytes, "ops": ops,
            "shape": {"N": n, "F": f, "U": u, "T": t, "Sp": s_pad,
                      "Co": cout}}


if __name__ == "__main__":
    sys.exit(main())
