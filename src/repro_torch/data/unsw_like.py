"""Synthetic stand-in for the UNSW-NB15 anomaly-detection dataset.

UNSW-NB15 is not redistributable offline; this generator reproduces the
*statistical shape* the paper relies on: flow records with packet-level
features (ports, protocol, service, port-equality flag) plus flow-level
features (duration, bytes/packets in both directions), heavily biased toward
normal traffic (~87 % normal / 13 % attack), where attacks shift the feature
distributions enough that a small tree ensemble reaches high accuracy but a
large one is measurably better — matching Table 3's regime.

Feature order (matches the paper's resource study; first five are the
Table 1 feature set):
  0 sport  1 dsport  2 proto  3 service  4 is_sm_ips_ports
  5 dur    6 sbytes  7 dbytes  8 spkts   9 dpkts

A copy of ``repro/data/unsw_like.py`` (numpy only): the same seed gives the
same arrays in both packages.
"""

from __future__ import annotations

import numpy as np

FEATURE_NAMES = [
    "sport", "dsport", "proto", "service", "is_sm_ips_ports",
    "dur", "sbytes", "dbytes", "spkts", "dpkts",
]

N_CLASSES = 2  # 0 = normal, 1 = anomaly


def make_unsw_like(n=20000, anomaly_frac=0.13, seed=0, n_features=10):
    """Returns (x, y) float32/int32 numpy arrays, x: (n, n_features)."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < anomaly_frac).astype(np.int32)
    n_anom = int(y.sum())
    x = np.zeros((n, 10), np.float32)

    normal = y == 0
    anom = y == 1

    # sport: ephemeral for normal clients; attacks reuse low/fixed ports
    x[normal, 0] = rng.integers(32768, 61000, normal.sum())
    x[anom, 0] = np.where(rng.random(n_anom) < 0.6,
                          rng.integers(1024, 5000, n_anom),
                          rng.integers(32768, 61000, n_anom))
    # dsport: normal -> web/dns-ish {80,443,53,22}; attacks scan wide
    common = np.array([80, 443, 53, 22, 25])
    x[normal, 1] = common[rng.integers(0, len(common), normal.sum())]
    x[anom, 1] = np.where(rng.random(n_anom) < 0.7,
                          rng.integers(1, 10000, n_anom),
                          common[rng.integers(0, len(common), n_anom)])
    # proto: 6=tcp 17=udp 1=icmp; attacks over-use udp/icmp
    x[normal, 2] = rng.choice([6, 17, 1], normal.sum(), p=[0.8, 0.18, 0.02])
    x[anom, 2] = rng.choice([6, 17, 1], n_anom, p=[0.45, 0.35, 0.2])
    # service code 0..12
    x[normal, 3] = rng.choice(13, normal.sum(),
                              p=np.array([30, 25, 15, 10, 5, 4, 3, 3, 2, 1, 1, 0.5, 0.5]) / 100)
    x[anom, 3] = rng.choice(13, n_anom,
                            p=np.array([5, 5, 5, 5, 10, 10, 10, 10, 10, 10, 10, 5, 5]) / 100)
    # is_sm_ips_ports: rarely 1 for normal, more for spoofed attack flows
    x[normal, 4] = (rng.random(normal.sum()) < 0.01).astype(np.float32)
    x[anom, 4] = (rng.random(n_anom) < 0.25).astype(np.float32)
    # dur (s): lognormal; attacks shorter (scans) or much longer (dos)
    x[normal, 5] = rng.lognormal(-1.0, 1.0, normal.sum())
    x[anom, 5] = np.where(rng.random(n_anom) < 0.7,
                          rng.lognormal(-3.5, 0.8, n_anom),
                          rng.lognormal(2.0, 1.0, n_anom))
    # sbytes / dbytes: attacks send more, receive less
    x[normal, 6] = rng.lognormal(6.0, 1.2, normal.sum())
    x[anom, 6] = rng.lognormal(7.5, 1.5, n_anom)
    x[normal, 7] = rng.lognormal(7.0, 1.4, normal.sum())
    x[anom, 7] = rng.lognormal(4.0, 1.5, n_anom)
    # spkts / dpkts correlated with bytes
    x[:, 8] = np.maximum(x[:, 6] / rng.lognormal(6.0, 0.3, n), 1.0)
    x[:, 9] = np.maximum(x[:, 7] / rng.lognormal(6.0, 0.3, n), 1.0)

    # label noise so even the big backend cannot be perfect (paper: 99.5 %)
    flip = rng.random(n) < 0.004
    y = np.where(flip, 1 - y, y)
    return x[:, :n_features].astype(np.float32), y.astype(np.int32)


def train_test_split(x, y, test_frac=0.2, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    n_test = int(len(x) * test_frac)
    te, tr = idx[:n_test], idx[n_test:]
    return x[tr], y[tr], x[te], y[te]
