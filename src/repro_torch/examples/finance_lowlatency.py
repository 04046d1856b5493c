"""Financial-transactions use case (§7.1.2): tag high-priority trades at
the switch; everything else takes the normal path to the backend XGBoost.

Port of ``examples/finance_lowlatency.py``. Demonstrates file-level feature
extraction (§5.3): each transaction arrives as a fixed-width CSV payload;
the "switch" parses columns 42/43/45/124/126 from the raw bytes (every row
split across two packets at byte 700, so a field straddles the cut),
classifies, and fast-paths confident strong-buy/sell trades. The parse and
the classify run on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.finance_lowlatency [--device cpu]

``main`` returns what it computed for callers that check it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.inference import table_predict
from repro_torch.core.mapping import map_tree_ensemble
from repro_torch.data.janestreet_like import (SWITCH_FEATURES,
                                              make_janestreet_like,
                                              train_test_split)
from repro_torch.device import resolve_device
from repro_torch.ml.metrics import accuracy
from repro_torch.ml.trees import fit_xgboost, predict_margin_xgboost
from repro_torch.netsim.features import (encode_csv_payload,
                                         file_features_csv,
                                         stitch_split_payload)


N_DEMO = 512            # test trades sent as CSV payloads
SPLIT_AT = 700          # byte at which every payload row is split
TAU = 0.7


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-samples", type=int, default=16000,
                    help="dataset size before the 80/20 split")
    ap.add_argument("--backend-trees", type=int, default=60)
    ap.add_argument("--backend-depth", type=int, default=8)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)

    # train: small switch XGB on 5 features; big backend on all 130
    x, y = make_janestreet_like(args.n_samples, seed=0)
    xtr, ytr, xte, yte = train_test_split(x, y)
    sw = fit_xgboost(xtr[:, SWITCH_FEATURES], ytr, n_trees=10, max_depth=5,
                     device=dev)
    backend = fit_xgboost(xtr, ytr, n_trees=args.backend_trees,
                          max_depth=args.backend_depth, device=dev)
    art = map_tree_ensemble(sw, len(SWITCH_FEATURES)).to(dev)

    # wire format: each trade is a 130-column fixed-width CSV row, split
    # across two packets (a feature straddles the cut)
    payload = encode_csv_payload(np.asarray(xte[:N_DEMO]), width=8)
    first_pkt = torch.as_tensor(payload[:, :SPLIT_AT], device=dev)
    second_pkt = torch.as_tensor(payload[:, SPLIT_AT:], device=dev)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    whole = stitch_split_payload(first_pkt, second_pkt)
    feats = file_features_csv(whole, SWITCH_FEATURES, width=8)  # parse bytes
    pred, conf = table_predict(art, feats)
    sync()
    t_parse_classify = time.perf_counter() - t0

    tagged = (pred == 1) & (conf >= TAU)
    n_tagged = int(tagged.sum())
    print(f"device={dev} {N_DEMO} trades parsed from raw csv bytes + "
          f"classified in {t_parse_classify * 1e3:.1f} ms "
          f"({t_parse_classify / N_DEMO * 1e6:.1f} us/trade)")
    print(f"fast-pathed (tagged strong buy/sell): {n_tagged} "
          f"({n_tagged / N_DEMO * 100:.1f}%)")

    # quality of the tags against the big backend on the same trades
    be = predict_margin_xgboost(backend, xte[:N_DEMO]) > 0
    gt = torch.as_tensor(yte[:N_DEMO] == 1, device=dev)
    tag_precision = int((tagged & gt).sum()) / max(n_tagged, 1)
    switch_acc = accuracy(yte[:N_DEMO], pred)
    backend_acc = accuracy(yte[:N_DEMO], be.to(torch.int32))
    print(f"tag precision {tag_precision:.3f} "
          f"(backend would tag {int(be.sum())})")
    print(f"switch acc {switch_acc:.4f} vs backend {backend_acc:.4f}")
    return dict(payload=payload, whole=whole, feats=feats, pred=pred,
                conf=conf, tagged=tagged, tag_precision=tag_precision,
                switch_acc=switch_acc, backend_acc=backend_acc,
                backend_pred=be, artifact=art, x_test=xte[:N_DEMO],
                parse_classify_s=t_parse_classify)


if __name__ == "__main__":
    main()
