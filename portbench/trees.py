"""Tree ensembles for the cells, fitted in plain numpy from the seed.

The ensembles are inputs, as weights are to a model: the benchmark fits
them itself, on rows it generated, and hands the same arrays to the port
(``ensemble_from_arrays``, then ``map_tree_ensemble`` for the switch) and
to the reference. A histogram learner grows complete trees level by level
in the program's heap layout:

  feat   (T, 2**D - 1) int32   feature per internal node
  thresh (T, 2**D - 1) float32 ``x <= thresh`` goes left; +inf: no split
  leaf   (T, 2**D, C)  float32 class counts (forest) or weights (boosting)

A node that should not split keeps the +inf threshold, so every row goes
left and its right subtree is unreachable.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Ensemble:
    feat: np.ndarray
    thresh: np.ndarray
    leaf: np.ndarray
    kind: str                       # "rf" | "xgb"
    base_score: float = 0.0
    learning_rate: float = 1.0
    n_classes: int = 2

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]

    @property
    def depth(self) -> int:
        return int(np.log2(self.feat.shape[1] + 1))


def quantile_edges(x: np.ndarray, n_bins: int) -> list:
    """Per feature, the distinct inner quantiles of its column (f32)."""
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    return [np.unique(np.quantile(x[:, f], qs).astype(np.float32))
            for f in range(x.shape[1])]


def bin_rows(x: np.ndarray, edges: list) -> np.ndarray:
    """(n, F) bin ids: the number of a feature's edges below the value, so
    ``bin <= b`` is exactly ``x <= edges[b]``."""
    return np.stack([np.searchsorted(e, x[:, f], side="left")
                     for f, e in enumerate(edges)], axis=1)


def _grow(bins, edges, stats, depth, n_bins, best_split):
    """One complete tree: per level, histograms of the rows' statistics by
    (node, feature, bin) and the best split of every node. -> (feat,
    thresh, node of each row at the leaf level)."""
    n, n_feat = bins.shape
    feat = np.zeros(2 ** depth - 1, np.int32)
    thresh = np.full(2 ** depth - 1, np.inf, np.float32)
    node = np.zeros(n, np.int64)
    cols = np.arange(n_feat)
    for level in range(depth):
        n_nodes = 2 ** level
        idx = ((node[:, None] * n_feat + cols) * n_bins + bins).ravel()
        size = n_nodes * n_feat * n_bins
        hist = np.stack([np.bincount(idx, np.repeat(s, n_feat), size)
                         for s in stats.T], axis=-1)
        f, b, ok = best_split(hist.reshape(n_nodes, n_feat, n_bins, -1))
        heap = 2 ** level - 1 + np.arange(n_nodes)
        feat[heap] = np.where(ok, f, 0)
        thresh[heap] = [edges[fi][bi] if o else np.inf
                        for fi, bi, o in zip(f, b, ok)]
        right = ok[node] & (bins[np.arange(n), f[node]] > b[node])
        node = 2 * node + right
    return feat, thresh, node


def _valid_splits(edges, n_bins):
    """(F, B) mask: split after bin b exists for feature f."""
    sizes = np.array([len(e) for e in edges])
    return np.arange(n_bins)[None, :] < sizes[:, None]


def _pick(gain, n_bins):
    """Per node the (feature, bin) of the largest gain, and whether it
    beats no split."""
    flat = gain.reshape(gain.shape[0], -1)
    arg = flat.argmax(axis=1)
    ok = flat[np.arange(len(arg)), arg] > 1e-9
    return arg // n_bins, arg % n_bins, ok


def fit_forest(x, y, rng, *, n_trees, depth, n_classes=2, n_bins=64,
               min_leaf=2) -> Ensemble:
    """Random forest: each tree on a bootstrap of the rows and a random
    ceil(sqrt(F)) of the features, Gini splits, class counts at the
    leaves."""
    n, n_feat = x.shape
    edges = quantile_edges(x, n_bins)
    bins = bin_rows(x, edges)
    valid = _valid_splits(edges, n_bins)
    onehot = np.eye(n_classes)[y]
    m = int(np.ceil(np.sqrt(n_feat)))
    feats, threshs, leaves = [], [], []
    for _ in range(n_trees):
        w = np.bincount(rng.integers(0, n, n), minlength=n).astype(np.float64)
        allowed = np.zeros(n_feat, bool)
        allowed[rng.choice(n_feat, m, replace=False)] = True
        stats = onehot * w[:, None]

        def best(hist):
            left = np.cumsum(hist, axis=2)               # (nodes, F, B, C)
            total = left[:, :1, -1:, :]
            right = total - left
            nl, nr = left.sum(-1), right.sum(-1)
            nt = total.sum(-1)
            score = ((left ** 2).sum(-1) / np.maximum(nl, 1e-12)
                     + (right ** 2).sum(-1) / np.maximum(nr, 1e-12)
                     - (total ** 2).sum(-1) / np.maximum(nt, 1e-12))
            ok = (valid[None] & allowed[None, :, None]
                  & (nl >= min_leaf) & (nr >= min_leaf))
            return _pick(np.where(ok, score, -np.inf), n_bins)

        f, t, node = _grow(bins, edges, stats, depth, n_bins, best)
        leaf = np.stack([np.bincount(node, stats[:, c], 2 ** depth)
                         for c in range(n_classes)], axis=1)
        feats.append(f)
        threshs.append(t)
        leaves.append(leaf.astype(np.float32))
    return Ensemble(np.stack(feats), np.stack(threshs), np.stack(leaves),
                    "rf", n_classes=n_classes)


def fit_boosting(x, y, *, n_trees, depth, learning_rate=0.3, reg_lambda=1.0,
                 min_child_weight=1.0, n_bins=64) -> Ensemble:
    """Gradient-boosted trees for two classes (logistic loss, second-order
    splits, margin 0 at the start), XGBoost's rule: a leaf's weight is
    -G / (H + lambda)."""
    n, n_feat = x.shape
    edges = quantile_edges(x, n_bins)
    bins = bin_rows(x, edges)
    valid = _valid_splits(edges, n_bins)
    margin = np.zeros(n)
    feats, threshs, leaves = [], [], []
    for _ in range(n_trees):
        p = 1.0 / (1.0 + np.exp(-margin))
        stats = np.stack([p - y, p * (1.0 - p)], axis=1)

        def best(hist):
            left = np.cumsum(hist, axis=2)
            total = left[:, :1, -1:, :]
            right = total - left
            score = lambda s: s[..., 0] ** 2 / (s[..., 1] + reg_lambda)
            gain = score(left) + score(right) - score(total)
            ok = (valid[None] & (left[..., 1] >= min_child_weight)
                  & (right[..., 1] >= min_child_weight))
            return _pick(np.where(ok, gain, -np.inf), n_bins)

        f, t, node = _grow(bins, edges, stats, depth, n_bins, best)
        g = np.bincount(node, stats[:, 0], 2 ** depth)
        h = np.bincount(node, stats[:, 1], 2 ** depth)
        w = (-g / (h + reg_lambda)).astype(np.float32)
        margin = margin + learning_rate * w[node].astype(np.float64)
        feats.append(f)
        threshs.append(t)
        leaves.append(w[:, None])
    return Ensemble(np.stack(feats), np.stack(threshs), np.stack(leaves),
                    "xgb", learning_rate=learning_rate)
