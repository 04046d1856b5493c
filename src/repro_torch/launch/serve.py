"""Serving launcher: hybrid IIsy switch tier + ensemble or LM backend.

``python -m repro_torch.launch.serve --use-case anomaly --threshold 0.7``
trains the small switch model (random forest) and the large backend
(XGBoost) on the synthetic UNSW-like data, maps the switch model to tables,
stands up the HybridServer, runs batched requests through it and prints the
paper's telemetry (fraction handled, accuracy, P/R/F1). Port of
``repro/launch/serve.py`` for ``--use-case anomaly`` with both backends.

For the anomaly use case the switch sees the full 5-feature vector, so the
backend scores the dispatched rows directly. ``--backend lm`` scores them
with a smoke-size qwen3-4b instead (``lm_backend``): each forwarded row is
re-encoded as 8 tokens and the class read from the last position's logits,
as the reference does; the server probes whether that backend can be
captured into its fused step (``fuse=None``, as the reference passes it)
and the launcher prints the route taken. The ``finance`` use case (whose
backend needs 130 features through a side channel) waits for a later
slice.

Runs on CUDA unless ``--device cpu`` is given. ``main`` returns what it
served (predictions, stats, server, models) for callers that check it.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.mapping import map_tree_ensemble
from repro_torch.data.unsw_like import make_unsw_like, train_test_split
from repro_torch.device import resolve_device
from repro_torch.kernels.tuning import TileConfig
from repro_torch.ml.metrics import accuracy, precision_recall_f1
from repro_torch.ml.trees import (fit_random_forest, fit_xgboost,
                                  predict_margin_xgboost)
from repro_torch.models import model as M
from repro_torch.serving.hybrid_serving import HybridServer


def build_usecase(name: str = "anomaly", n=20000, seed=0):
    if name != "anomaly":
        raise NotImplementedError(f"use case {name!r} is not ported yet")
    x, y = make_unsw_like(n, seed=seed, n_features=5)
    return train_test_split(x, y)


def lm_backend(cfg, params):
    """The reference's LM scorer: each forwarded row becomes 8 tokens,
    ``int(|x[:, :8]| * 7) % vocab`` padded with zeros, and its class is
    ``logits[:, 0] > logits[:, 1]`` of the prompt's last position."""
    def backend_fn(rows):
        toks = (rows[:, :8].abs() * 7).to(torch.int32) % cfg.vocab_size
        toks = torch.nn.functional.pad(toks, (0, max(0, 8 - toks.shape[1])))
        logits, _ = M.prefill(params, cfg, {"tokens": toks})
        return (logits[:, 0] > logits[:, 1]).to(torch.int32)

    return backend_fn


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--use-case", default="anomaly", choices=["anomaly"])
    ap.add_argument("--threshold", type=float, default=0.7)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--switch-trees", type=int, default=10)
    ap.add_argument("--switch-depth", type=int, default=5)
    ap.add_argument("--backend", default="ensemble", choices=["ensemble", "lm"])
    ap.add_argument("--backend-trees", type=int, default=60)
    ap.add_argument("--backend-depth", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--n-samples", type=int, default=20000,
                    help="dataset size before the 80/20 split")
    ap.add_argument("--select", default="auto",
                    choices=["auto", "matmul", "compare"],
                    help="decision-select strategy of the switch kernel")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    xtr, ytr, xte, yte = build_usecase(args.use_case, n=args.n_samples)
    if args.batch > len(xte):
        raise ValueError(f"--batch {args.batch} exceeds the {len(xte)} test rows")

    # small switch model (paper Table 3 "Medium") + big backend
    small = fit_random_forest(xtr, ytr, n_classes=2,
                              n_trees=args.switch_trees,
                              max_depth=args.switch_depth, seed=0, device=dev)
    art = map_tree_ensemble(small, xtr.shape[1])
    if args.backend == "ensemble":
        big = fit_xgboost(xtr, ytr, n_trees=args.backend_trees,
                          max_depth=args.backend_depth, device=dev)

        def backend_fn(rows):
            return (predict_margin_xgboost(big, rows) > 0).to(torch.int32)
    else:
        cfg = get_smoke_config("qwen3-4b")
        big = M.init_model(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
        backend_fn = lm_backend(cfg, big)

    # the ensemble backend is served eagerly (fuse=False) and the LM backend
    # probed for the fused step (fuse=None), as the reference's launcher does
    server = HybridServer(art, backend_fn, threshold=args.threshold,
                          capacity=args.capacity,
                          tiles=TileConfig(select=args.select),
                          fuse=False if args.backend == "ensemble" else None,
                          device=dev)

    x_test = torch.as_tensor(xte, device=dev)
    n = x_test.shape[0]
    preds = []
    t0 = time.perf_counter()
    for lo in range(0, n - args.batch + 1, args.batch):
        pred, stats = server.classify(x_test[lo:lo + args.batch])
        preds.append(pred)
    pred = torch.cat(preds)
    m = pred.shape[0]
    acc = accuracy(yte[:m], pred)          # reads the preds: syncs
    wall = time.perf_counter() - t0
    p, r, f1 = precision_recall_f1(yte[:m], pred)
    print(f"use_case={args.use_case} backend={args.backend} "
          f"tau={args.threshold} device={dev}")
    print(f"acc={acc:.4f} precision={p:.4f} recall={r:.4f} f1={f1:.4f}")
    print(f"handled_at_switch={stats.fraction_handled:.3f} "
          f"backend_rows/batch={stats.backend_rows}/{args.batch} "
          f"wall={wall:.1f}s")
    print(f"route={'fused' if server._fused_ok else 'two-phase'} "
          f"fused_ok={server._fused_ok}")
    return dict(pred=pred, stats=stats, server=server, switch_model=small,
                backend_model=big, backend_fn=backend_fn, artifact=art,
                x_test=x_test, y_test=yte,
                batches=len(preds), acc=acc, precision=p, recall=r, f1=f1)


if __name__ == "__main__":
    main()
