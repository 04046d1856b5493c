"""Quickstart: train a model, map it to switch tables, classify at the
"switch", and see the hybrid deployment improve the result.

Port of ``examples/quickstart.py``. The fits, the table lookup and the
hybrid run on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``main`` returns what it computed for callers that check it; ``models``
takes an already-fitted (switch, backend) pair, e.g. one carried across
from the reference package with ``ml.trees.ensemble_from_arrays``, in
place of the fits.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.hybrid import hybrid_predict
from repro_torch.core.inference import table_predict
from repro_torch.core.mapping import map_tree_ensemble
from repro_torch.core.resources import artifact_resources
from repro_torch.data.unsw_like import make_unsw_like, train_test_split
from repro_torch.device import resolve_device
from repro_torch.ml.metrics import accuracy, precision_recall_f1
from repro_torch.ml.trees import fit_random_forest, predict_tree_ensemble

N_FEATURES = 5
TAU = 0.7           # the switch's confidence threshold, as the reference's


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-samples", type=int, default=12000,
                    help="flow records before the 80/20 split")
    ap.add_argument("--switch-trees", type=int, default=10)
    ap.add_argument("--switch-depth", type=int, default=5)
    ap.add_argument("--backend-trees", type=int, default=40)
    ap.add_argument("--backend-depth", type=int, default=8)
    return ap.parse_args(argv)


def fit_models(xtr, ytr, args, device):
    """The small "switch" RF and the large "backend" RF, as the reference
    seeds them (the port's draws differ: ROADMAP C3)."""
    switch_model = fit_random_forest(xtr, ytr, n_classes=2,
                                     n_trees=args.switch_trees,
                                     max_depth=args.switch_depth, seed=0,
                                     device=device)
    backend_model = fit_random_forest(xtr, ytr, n_classes=2,
                                      n_trees=args.backend_trees,
                                      max_depth=args.backend_depth, seed=1,
                                      max_features=N_FEATURES, device=device)
    return switch_model, backend_model


def main(argv=None, *, models=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)

    # 1. data: flow records, ~13% anomalies (UNSW-NB15-like)
    x, y = make_unsw_like(args.n_samples, n_features=N_FEATURES, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y)

    # 2. train the small "switch" model and the large "backend" model
    switch_model, backend_model = (fit_models(xtr, ytr, args, dev)
                                   if models is None
                                   else (m.to(dev) for m in models))

    # 3. IIsy mapping: model -> lookup tables (what the control plane loads)
    artifact = map_tree_ensemble(switch_model, N_FEATURES).to(dev)
    resources = artifact_resources(artifact)
    print("switch artifact:", resources.row())

    # 4. classify entirely "on the switch"
    x_test = torch.as_tensor(xte, device=dev)
    pred, confidence = table_predict(artifact, x_test)
    switch_acc = accuracy(yte, pred)
    switch_prf = precision_recall_f1(yte, pred)
    print(f"switch-only accuracy: {switch_acc:.4f} F1 {switch_prf[2]:.4f}")

    # 5. hybrid: low-confidence traffic goes to the backend (tau)
    res = hybrid_predict(artifact,
                         lambda rows: predict_tree_ensemble(backend_model,
                                                            rows),
                         x_test, threshold=TAU)
    hybrid_acc = accuracy(yte, res.pred)
    hybrid_prf = precision_recall_f1(yte, res.pred)
    frac = float(res.fraction_handled)
    print(f"hybrid accuracy:      {hybrid_acc:.4f} "
          f"F1 {hybrid_prf[2]:.4f} "
          f"({frac * 100:.1f}% handled at the switch)")
    return dict(artifact=artifact, resources=resources, pred=pred,
                confidence=confidence, switch_acc=switch_acc,
                switch_prf=switch_prf, hybrid=res, hybrid_acc=hybrid_acc,
                hybrid_prf=hybrid_prf, fraction_handled=frac,
                models=(switch_model, backend_model), y_test=yte)


if __name__ == "__main__":
    main()
