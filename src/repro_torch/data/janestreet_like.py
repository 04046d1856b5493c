"""Synthetic stand-in for the Jane Street Market Prediction dataset.

The real dataset: 130 anonymized numeric features per trade and two return
values ('weight', 'resp'); the paper labels trades 'strong sell/buy' (~13.1 %)
vs 'sell/hold/buy' and reports error rates around 0.23-0.26 — i.e. a *hard*,
low-signal task. This generator reproduces that regime: 130 correlated
Gaussian-ish features with a weak nonlinear signal in a small subset
(including indices 42, 43, 45, 124, 126 — the features the paper extracts on
the switch), plus heavy noise so that even large models plateau well below
perfect accuracy.

A copy of ``repro/data/janestreet_like.py`` (numpy only): the same seed
gives the same arrays in both packages.
"""

from __future__ import annotations

import numpy as np

N_FEATURES = 130
N_CLASSES = 2  # 1 = strong sell/buy (the time-sensitive minority class)
SWITCH_FEATURES = [42, 43, 45, 124, 126]  # §7.2 of the paper


def make_janestreet_like(n=20000, positive_frac=0.131, seed=0):
    rng = np.random.default_rng(seed)
    # correlated feature panel: low-rank structure + idiosyncratic noise
    k = 12
    loadings = rng.normal(0, 1, (k, N_FEATURES))
    factors = rng.normal(0, 1, (n, k))
    x = factors @ loadings + rng.normal(0, 1.5, (n, N_FEATURES))

    # weak nonlinear signal on a sparse subset (incl. the switch features)
    sig_idx = np.array(SWITCH_FEATURES + [7, 13, 64, 99])
    s = x[:, sig_idx]
    score = (0.9 * s[:, 0] - 0.7 * s[:, 1] + 0.5 * np.tanh(s[:, 2])
             + 0.6 * s[:, 3] * (s[:, 4] > 0) + 0.3 * s[:, 5]
             - 0.4 * np.abs(s[:, 6]) + 0.25 * s[:, 7] * s[:, 8])
    score = score + rng.normal(0, 2.6, n)        # SNR tuned for ~0.23+ error
    thr = np.quantile(score, 1.0 - positive_frac)
    y = (score > thr).astype(np.int32)
    return x.astype(np.float32), y


def train_test_split(x, y, test_frac=0.2, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    n_test = int(len(x) * test_frac)
    te, tr = idx[:n_test], idx[n_test:]
    return x[tr], y[tr], x[te], y[te]
