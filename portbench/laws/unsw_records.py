"""Flow records with the UNSW-NB15 statistical shape (``anomaly_frac`` of
them anomalous, about 13%): a copy of the program's
``data/unsw_like.make_unsw_like``.

Feature order: sport, dsport, proto, service, is_sm_ips_ports, dur,
sbytes, dbytes, spkts, dpkts (the first five are the paper's Table 1 set).
"""

from __future__ import annotations

import numpy as np


def rows(rng, mix: dict, n: int):
    """-> (x (n, 10) f32, y (n,) i32)."""
    y = (rng.random(n) < mix["anomaly_frac"]).astype(np.int32)
    n_anom = int(y.sum())
    x = np.zeros((n, 10), np.float32)
    normal, anom = y == 0, y == 1
    n_norm = int(normal.sum())
    x[normal, 0] = rng.integers(32768, 61000, n_norm)
    x[anom, 0] = np.where(rng.random(n_anom) < 0.6,
                          rng.integers(1024, 5000, n_anom),
                          rng.integers(32768, 61000, n_anom))
    common = np.array([80, 443, 53, 22, 25])
    x[normal, 1] = common[rng.integers(0, len(common), n_norm)]
    x[anom, 1] = np.where(rng.random(n_anom) < 0.7,
                          rng.integers(1, 10000, n_anom),
                          common[rng.integers(0, len(common), n_anom)])
    x[normal, 2] = rng.choice([6, 17, 1], n_norm, p=[0.8, 0.18, 0.02])
    x[anom, 2] = rng.choice([6, 17, 1], n_anom, p=[0.45, 0.35, 0.2])
    x[normal, 3] = rng.choice(
        13, n_norm,
        p=np.array([30, 25, 15, 10, 5, 4, 3, 3, 2, 1, 1, 0.5, 0.5]) / 100)
    x[anom, 3] = rng.choice(
        13, n_anom,
        p=np.array([5, 5, 5, 5, 10, 10, 10, 10, 10, 10, 10, 5, 5]) / 100)
    x[normal, 4] = (rng.random(n_norm) < 0.01).astype(np.float32)
    x[anom, 4] = (rng.random(n_anom) < 0.25).astype(np.float32)
    x[normal, 5] = rng.lognormal(-1.0, 1.0, n_norm)
    x[anom, 5] = np.where(rng.random(n_anom) < 0.7,
                          rng.lognormal(-3.5, 0.8, n_anom),
                          rng.lognormal(2.0, 1.0, n_anom))
    x[normal, 6] = rng.lognormal(6.0, 1.2, n_norm)
    x[anom, 6] = rng.lognormal(7.5, 1.5, n_anom)
    x[normal, 7] = rng.lognormal(7.0, 1.4, n_norm)
    x[anom, 7] = rng.lognormal(4.0, 1.5, n_anom)
    x[:, 8] = np.maximum(x[:, 6] / rng.lognormal(6.0, 0.3, n), 1.0)
    x[:, 9] = np.maximum(x[:, 7] / rng.lognormal(6.0, 0.3, n), 1.0)
    flip = rng.random(n) < 0.004          # label noise: no model is perfect
    y = np.where(flip, 1 - y, y)
    return x, y.astype(np.int32)
