"""Serving launcher: hybrid IIsy switch tier + ensemble or LM backend.

``python -m repro_torch.launch.serve --use-case anomaly --threshold 0.7``
trains the small switch model (random forest) and the large backend
(XGBoost) on the synthetic use-case data, maps the switch model to tables,
stands up the HybridServer, runs batched requests through it and prints the
paper's telemetry (fraction handled, accuracy, P/R/F1). Port of
``repro/launch/serve.py``.

For the anomaly use case (UNSW-like) the switch sees the full 5-feature
vector, so the backend scores the dispatched rows directly. For the
finance use case (Jane-Street-like, §7.1.2) the switch sees the five
``SWITCH_FEATURES`` and the XGB backend all 130 features: a forwarded
request carries its full payload, which the launcher emulates by a side
channel set per batch (``backend_fn.full_rows`` and ``backend_fn.idx``, the
dispatch order recomputed with the server's own switch realization and
tiles). ``--backend lm`` scores the forwarded rows with a language model
instead (``lm_backend``): the smoke-size qwen3-4b, or with ``--arch`` any
registry id at its published widths (``--lm-layers`` cuts its depth;
DeepSeek-V3 is served as its fp8 checkpoint holds it). Each row is
re-encoded as 8 tokens and the class read from the last position's
logits, as the reference does; the
server probes whether that backend can be captured into its fused step
(``fuse=None``, as the reference passes it) and the launcher prints the
route taken.

Runs on CUDA unless ``--device cpu`` is given. ``main`` returns what it
served (predictions, stats, server, models) for callers that check it.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.mapping import map_tree_ensemble
from repro_torch.core.hybrid import dispatch
from repro_torch.data import janestreet_like, unsw_like
from repro_torch.device import resolve_device
from repro_torch.kernels.grouped_gemm import column_blocks
from repro_torch.kernels.ops import fused_classify
from repro_torch.kernels.tuning import TileConfig
from repro_torch.ml.metrics import accuracy, precision_recall_f1
from repro_torch.ml.trees import (fit_random_forest, fit_xgboost,
                                  predict_margin_xgboost)
from repro_torch.models import model as M
from repro_torch.models.moe import attach_route_log
from repro_torch.serving.hybrid_serving import HybridServer


USE_CASES = ("anomaly", "finance")


def build_usecase(name: str = "anomaly", n=20000, seed=0):
    """(x_train, y_train, x_test, y_test) numpy arrays of a use case: the
    UNSW-like anomaly data (5 features) or the Jane-Street-like finance
    data (130 features; the switch sees ``SWITCH_FEATURES``)."""
    if name == "anomaly":
        x, y = unsw_like.make_unsw_like(n, seed=seed, n_features=5)
        return unsw_like.train_test_split(x, y)
    if name == "finance":
        x, y = janestreet_like.make_janestreet_like(n, seed=seed)
        return janestreet_like.train_test_split(x, y)
    raise ValueError(f"use case must be one of {USE_CASES}, got {name!r}")


def side_channel_backend(model):
    """The finance backend: it scores the full 130-feature rows of the
    forwarded requests, ``backend_fn.full_rows[backend_fn.idx]``, whatever
    switch-feature rows the server hands it. The caller sets both
    attributes per batch before ``classify``."""
    def backend_fn(rows_sw):
        rows = backend_fn.full_rows[backend_fn.idx]
        return (predict_margin_xgboost(model, rows) > 0).to(torch.int32)

    return backend_fn


class LMBackend:
    """The reference's LM scorer: each forwarded row becomes 8 tokens,
    ``int(|x[:, :8]| * 7) % vocab`` padded with zeros, and its class is
    ``logits[:, 0] > logits[:, 1]`` of the prompt's last position.

    Besides the classes it keeps, in tensors of its own that a captured
    step writes in place (allocated at the first call, sized by its rows):
    ``logits``, each call's two class logits of every row (rows, 2) f32;
    and for a model whose MoE layers route as DeepSeek-V3's (served
    params), each layer's route buffers (``models.moe.attach_route_log``):
    its experts' tokens and the rows its grouped GEMM stored, summed over
    calls, and the last call's chosen experts."""

    def __init__(self, cfg, params):
        self.cfg, self.params = cfg, params
        self.logits = None
        self.routes = []

    def __call__(self, rows):
        cfg = self.cfg
        toks = (rows[:, :8].abs() * 7).to(torch.int32) % cfg.vocab_size
        toks = torch.nn.functional.pad(toks, (0, max(0, 8 - toks.shape[1])))
        if self.logits is None:
            self.logits = torch.zeros((rows.shape[0], 2),
                                      dtype=torch.float32,
                                      device=rows.device)
            if cfg.moe is not None and cfg.moe.scoring == "sigmoid" \
                    and cfg.precision is not None:
                self.routes = attach_route_log(self.params, cfg,
                                               toks.numel())
        logits, _ = M.prefill(self.params, cfg, {"tokens": toks})
        self.logits.copy_(logits[:, :2])
        return (logits[:, 0] > logits[:, 1]).to(torch.int32)

    def expert_tokens(self) -> torch.Tensor:
        """(MoE layers, E) int64: each expert's routed tokens, summed over
        the calls since the last ``reset_counters``."""
        return torch.cat([r["tokens"].reshape(-1, r["tokens"].shape[-1])
                          for r in self.routes])

    def routed_pairs(self) -> torch.Tensor:
        """(MoE layers,) float64: the routed pairs whose rows B9 stored,
        summed likewise (the stored count over ``column_blocks(D)``; a row
        stored in only some column blocks reads as a fraction)."""
        stored = torch.cat([r["stored"].reshape(-1) for r in self.routes])
        return stored.double() / column_blocks(self.cfg.d_model)

    def tile_shapes(self) -> torch.Tensor:
        """(MoE layers, 4) int64: B9's row tiles at each of
        ``grouped_gemm.TILE_WIDTHS`` pairs, summed likewise."""
        return torch.cat([r["shapes"].reshape(-1, r["shapes"].shape[-1])
                          for r in self.routes])

    def chosen(self) -> torch.Tensor:
        """(MoE layers, tokens, K) int32: the last call's experts."""
        return torch.cat([r["ids"].reshape(-1, *r["ids"].shape[-2:])
                          for r in self.routes])

    def reset_counters(self) -> None:
        for r in self.routes:
            r["tokens"].zero_()
            r["stored"].zero_()
            r["shapes"].zero_()


def lm_backend(cfg, params) -> LMBackend:
    """The LM backend of ``cfg`` with ``params`` (``LMBackend``)."""
    return LMBackend(cfg, params)


def lm_config(arch: str, layers: int = None):
    """Registry id ``arch`` at its published widths; ``layers`` cuts its
    depth: the leading dense layers count once (a MoE model keeps one),
    the rest follow, and the MTP module is left out."""
    cfg = get_config(arch)
    if layers is None or layers >= cfg.n_layers:
        return cfg
    moe = cfg.moe
    if moe is not None and moe.n_dense_layers:
        moe = dataclasses.replace(moe, n_dense_layers=1)
    return dataclasses.replace(cfg, n_layers=layers, moe=moe, mtp=False)


def lm_params(cfg, seed: int, device):
    """A served precision's params (``models.model.init_serving_model``)
    where ``cfg`` states one, else float32 ones, from ``seed``."""
    if cfg.precision is not None:
        return M.init_serving_model(cfg, seed, device=device)
    return M.init_model(cfg, torch.Generator(device=device).manual_seed(seed),
                        device=device)


def serve_batches(server: HybridServer, x_test: torch.Tensor, batch: int, *,
                  x_full: torch.Tensor = None) -> tuple:
    """The launcher's serving loop: every whole batch of ``x_test`` through
    ``server.classify``. -> (list of per-batch preds, last HybridStats).

    With ``x_full`` (the finance use case) the server's backend is a
    ``side_channel_backend``: before each classify the loop sets its
    ``full_rows`` to the batch's full-feature rows and its ``idx`` to the
    dispatch order, recomputed here with the SAME switch realization and
    tiles the server uses so that it matches bit for bit (another
    realization could order the dispatch differently and score the wrong
    full-feature rows)."""
    backend_fn = server.backend_fn
    preds, stats = [], None
    for lo in range(0, x_test.shape[0] - batch + 1, batch):
        rows = x_test[lo:lo + batch]
        if x_full is not None:
            backend_fn.full_rows = x_full[lo:lo + batch]
            _, conf = fused_classify(server.artifact, rows,
                                     tiles=server.tiles,
                                     device=server.device)
            backend_fn.idx = dispatch(rows, conf < server.threshold,
                                      server.capacity)[1]
        pred, stats = server.classify(rows)
        preds.append(pred)
    return preds, stats


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--use-case", default="anomaly", choices=USE_CASES)
    ap.add_argument("--threshold", type=float, default=0.7)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--switch-trees", type=int, default=10)
    ap.add_argument("--switch-depth", type=int, default=5)
    ap.add_argument("--backend", default="ensemble", choices=["ensemble", "lm"])
    ap.add_argument("--backend-trees", type=int, default=60)
    ap.add_argument("--backend-depth", type=int, default=6)
    ap.add_argument("--arch", default=None,
                    help="--backend lm: a registry id at its published "
                         "widths (default: the smoke qwen3-4b)")
    ap.add_argument("--lm-layers", type=int, default=None,
                    help="--backend lm with --arch: the layers served "
                         "(leading dense layers count once)")
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
    finance = args.use_case == "finance"
    sw = janestreet_like.SWITCH_FEATURES if finance else slice(None)
    xsw_tr, xsw_te = xtr[:, sw], xte[:, sw]

    # small switch model (paper Table 3 "Medium") + big backend
    small = fit_random_forest(xsw_tr, ytr, n_classes=2,
                              n_trees=args.switch_trees,
                              max_depth=args.switch_depth, seed=0, device=dev)
    art = map_tree_ensemble(small, xsw_tr.shape[1])
    if args.backend == "ensemble":
        big = fit_xgboost(xtr, ytr, n_trees=args.backend_trees,
                          max_depth=args.backend_depth, device=dev)
        if finance:
            backend_fn = side_channel_backend(big)
        else:
            def backend_fn(rows):
                return (predict_margin_xgboost(big, rows) > 0).to(torch.int32)
    else:
        cfg = (get_smoke_config("qwen3-4b") if args.arch is None
               else lm_config(args.arch, args.lm_layers))
        big = lm_params(cfg, 0, dev)
        backend_fn = lm_backend(cfg, big)

    # the ensemble backend is served eagerly (fuse=False) and the LM backend
    # probed for the fused step (fuse=None), as the reference's launcher
    # does. The finance backend reads per-batch side channels (idx and
    # full_rows on the function object): it must never be captured into
    # the fused step, which would replay the first batch's rows.
    server = HybridServer(art, backend_fn, threshold=args.threshold,
                          capacity=args.capacity,
                          tiles=TileConfig(select=args.select),
                          fuse=False if args.backend == "ensemble" else None,
                          device=dev)

    x_test = torch.as_tensor(xsw_te, device=dev)
    x_full = (torch.as_tensor(xte, device=dev)
              if finance and args.backend == "ensemble" else None)
    t0 = time.perf_counter()
    preds, stats = serve_batches(server, x_test, args.batch, x_full=x_full)
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
                x_test=x_test, x_full=x_full, y_test=yte,
                batches=len(preds), acc=acc, precision=p, recall=r, f1=f1)


if __name__ == "__main__":
    main()
