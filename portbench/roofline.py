"""Operations and bytes of the served work, from problem shapes and the
counts the inputs fix, and the least time they take on the card.

Each input byte is counted read once and each output byte written once,
whatever an implementation reads again; where the work depends on the data
(the decision-table entries a batch touches, the register words a window
changes, the buckets a sweep evicts) the count is what these inputs need.
The kernel formulas are the "bound ms" column of PERF.md's kernel table,
frozen here so that the yardstick does not move with the program. The
peaks are the card's published ones (``peaks.json``), at its full power
limit.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
HBM = PEAKS["hbm_bytes_per_s"]
FP32 = PEAKS["fp32_flops_per_s"]


def least_s(n_bytes: float, ops: float) -> float:
    """The larger of bytes over the memory rate and operations over the
    float32 rate, in seconds."""
    return max(n_bytes / HBM, ops / FP32)


def b1_work(n: int, f: int, u: int, t: int, co: int, pairs: int) -> tuple:
    """The switch's table walk (B1) over n rows of f features: the rows,
    the union edges (f x u), the feature tables (f x (u + 1) x t codes),
    ``pairs`` decision-table entries touched (co values each) and the
    (n, co) votes written. -> (bytes, ops): the range match, the key sums
    and the vote."""
    n_bytes = 4 * (n * f + f * u + f * (u + 1) * t + n * co) + 4 * pairs * co
    ops = n * f * u + n * t * f + n * t * co
    return n_bytes, ops


def b5_work(n_buckets: int, w: int, n_valid: int, named: int,
            changed: int) -> tuple:
    """One window's register fold (B5): the six count registers of every
    bucket (the clamp must see each), the first and last timestamps of the
    ``named`` buckets the lanes name, the window's columns (17 bytes a
    lane), the ``changed`` register words written and the (8, w) rows read
    out. -> (bytes, ops): 11 a valid lane, 12 a bucket, 8 a lane's row."""
    n_bytes = (6 * n_buckets * 4 + 2 * named * 4 + w * 17 + changed * 4
               + 8 * w * 4)
    ops = n_valid * 11 + 12 * n_buckets + 8 * w
    return n_bytes, ops


def b6_work(n_buckets: int, w: int, n_valid: int, evicted: int) -> tuple:
    """One window's timeout sweep (B6): the count and last-seen rows, the
    window's timestamps and valid flags, the evicted buckets' 8 registers
    and the count written. -> (bytes, ops)."""
    n_bytes = 2 * n_buckets * 4 + w * 5 + 8 * 4 * evicted + 4
    ops = 2 * n_valid + 2 * n_buckets
    return n_bytes, ops


def walk_work(rows: int, f: int, t: int, depth: int, c: int) -> tuple:
    """A backend's tree walk over ``rows`` rows: the rows, every tree's
    nodes (feature and threshold) and leaves (c values), one answer a row.
    -> (bytes, ops): a compare a level a tree, c adds a tree."""
    nodes, leaves = 2 ** depth - 1, 2 ** depth
    n_bytes = 4 * (rows * f + t * nodes * 2 + t * leaves * c + rows)
    ops = rows * t * (depth + c)
    return n_bytes, ops


def total(*works) -> tuple:
    return (sum(w[0] for w in works), sum(w[1] for w in works))


def decision_pairs(ens, x: np.ndarray) -> int:
    """Distinct (tree, cell) pairs the rows reach, a cell being the box
    the tree's thresholds cut around a row: the decision-table entries a
    table walk must read."""
    n = 0
    for t in range(ens.n_trees):
        key = np.zeros(len(x), np.int64)
        for f in range(x.shape[1]):
            th = np.unique(ens.thresh[t][(ens.feat[t] == f)
                                         & np.isfinite(ens.thresh[t])])
            key = key * (len(th) + 1) + np.searchsorted(th, x[:, f],
                                                        side="left")
        n += len(np.unique(key))
    return n


def union_edges(ens, n_features: int) -> int:
    """The most distinct finite thresholds on one feature over all trees:
    the width of the switch's range match."""
    return max(1, max(len(np.unique(ens.thresh[(ens.feat == f)
                                                & np.isfinite(ens.thresh)]))
                      for f in range(n_features)))
