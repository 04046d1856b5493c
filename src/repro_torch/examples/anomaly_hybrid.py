"""Anomaly-detection use case (§7.1.1), end to end through the SERVING
stack: packet trace -> data-plane feature extraction -> fused switch
classifier -> capacity-bounded dispatch of low-confidence flows to the
backend. Prints the paper's telemetry.

Port of ``examples/anomaly_hybrid.py``. On the card the features come from
the register scatter and ``HybridServer.classify`` serves the flows as one
CUDA graph (the backend is a pure tensor function, so the step is captured
at the first call, as the reference's first call runs its fused jit),
with the switch lookup (B1) inside; ``--device cpu`` runs the plain path.

    PYTHONPATH=src python -m repro_torch.examples.anomaly_hybrid [--device cpu]

``main`` returns what it computed for callers that check it; ``models``
takes an already-fitted (switch, backend) pair in place of the fits.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.mapping import map_tree_ensemble
from repro_torch.data.unsw_like import make_unsw_like, train_test_split
from repro_torch.device import resolve_device
from repro_torch.examples.quickstart import N_FEATURES, TAU, fit_models
from repro_torch.ml.metrics import accuracy, precision_recall_f1
from repro_torch.ml.trees import predict_tree_ensemble
from repro_torch.netsim.features import flow_features, packet_features
from repro_torch.netsim.packets import synth_trace
from repro_torch.serving.hybrid_serving import HybridServer

TRACE_SEED = 42     # the served trace's seed, as the reference's


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-samples", type=int, default=16000,
                    help="historical flow records before the 80/20 split")
    ap.add_argument("--n-flows", type=int, default=3000,
                    help="flows in the served packet trace")
    ap.add_argument("--n-buckets", type=int, default=1 << 14)
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--switch-trees", type=int, default=10)
    ap.add_argument("--switch-depth", type=int, default=5)
    ap.add_argument("--backend-trees", type=int, default=40)
    ap.add_argument("--backend-depth", type=int, default=8)
    return ap.parse_args(argv)


def flow_rows(trace) -> np.ndarray:
    """Per-flow feature rows in the §7.2 layout (sport, dsport, proto,
    ~svc, eq), from each flow's first packet."""
    first = np.unique(np.asarray(trace.flow_id), return_index=True)[1]
    sport = np.asarray(trace.sport, np.float32)[first]
    dport = np.asarray(trace.dport, np.float32)[first]
    return np.stack([
        sport, dport, np.asarray(trace.proto, np.float32)[first],
        np.minimum(dport % 13, 12),
        (np.asarray(trace.sport)[first]
         == np.asarray(trace.dport)[first]).astype(np.float32),
    ], axis=1)


def main(argv=None, *, models=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)

    # --- offline: train switch + backend on historical flow records --------
    x, y = make_unsw_like(args.n_samples, n_features=N_FEATURES, seed=0)
    xtr, ytr, _, _ = train_test_split(x, y)
    switch_model, backend_model = (fit_models(xtr, ytr, args, dev)
                                   if models is None
                                   else (m.to(dev) for m in models))
    artifact = map_tree_ensemble(switch_model, N_FEATURES)

    server = HybridServer(
        artifact,
        backend_fn=lambda rows: predict_tree_ensemble(backend_model, rows),
        threshold=TAU, capacity=args.capacity, fuse=True, device=dev)

    # --- online: packets hit the data plane ---------------------------------
    trace = synth_trace(n_flows=args.n_flows, seed=TRACE_SEED)
    print(f"trace: {trace.n_packets} packets, {trace.n_flows} flows")

    # stateless parser features + stateful flow registers (hash + segment
    # sums)
    pkt = packet_features(trace, device=dev)
    bucket, flow_tab = flow_features(trace, n_buckets=args.n_buckets,
                                     device=dev)

    rows = flow_rows(trace)
    x_rows = torch.as_tensor(rows, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    pred, stats = server.classify(x_rows)
    sync()
    classify_s = time.perf_counter() - t0
    labels = trace.flow_label
    frac, backend_rows = stats.fraction_handled, stats.backend_rows
    acc = accuracy(labels, pred)
    prf = precision_recall_f1(labels, pred)
    flagged = int((pred == 1).sum())
    print(f"handled at switch: {frac * 100:.1f}%  "
          f"(backend saw {backend_rows}/{len(rows)} flows)")
    print(f"accuracy {acc:.4f}  P/R/F1 {prf}")
    print("anomalous flows dropped at line rate; "
          f"{flagged} flows flagged")
    return dict(server=server, trace=trace, packet_features=pkt,
                bucket=bucket, flow_table=flow_tab, rows=rows, pred=pred,
                fraction_handled=frac, backend_rows=backend_rows,
                accuracy=acc, prf=prf, flagged=flagged,
                classify_s=classify_s, models=(switch_model, backend_model))


if __name__ == "__main__":
    main()
