"""Histogram-based tree learners with fixed-shape, level-wise training.

Port of ``repro/ml/trees.py`` (decision tree, random forest, XGBoost and
the isolation forest). All trees are *complete* binary trees of a fixed
``max_depth`` stored as flat heap arrays (level-wise growth, the
XGBoost/LightGBM histogram method). A node that should not split gets the
sentinel threshold ``+inf`` so every sample routes left and the right
subtree becomes unreachable.

Layout (per tree):
  feat   : (2**D - 1,) int32   feature index per internal heap node
  thresh : (2**D - 1,) float32 ``x <= thresh`` routes left; +inf = no split
  leaf   : (2**D, C)   float32 leaf payload (class counts or boosting weight)

Training runs where its inputs are: ``device=None`` means CUDA (raising
without a card), as every entry point of the port; on the card the data is
binned by the range-match kernel (``kernels/bucketize.py``). The random
draws of the random forest (bootstrap rows, feature subsets) and of the
isolation forest (row subsamples, split features, split positions) come
from a ``torch.Generator`` seeded with ``seed``; they differ from the
reference's ``jax.random`` draws, so a forest matches the reference only
when the draws are handed across (``draws=...``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.inference import _c_factor
from repro_torch.device import resolve_device
from repro_torch.kernels.bucketize import bucketize

NEG_INF = float("-inf")


@dataclasses.dataclass
class TreeEnsemble:
    """A bag of complete trees plus ensemble metadata."""

    feat: torch.Tensor        # (T, 2**D - 1) int32
    thresh: torch.Tensor      # (T, 2**D - 1) float32
    leaf: torch.Tensor        # (T, 2**D, C) float32
    kind: str = "rf"          # 'dt' | 'rf' | 'xgb' | 'iforest'
    base_score: float = 0.0
    learning_rate: float = 1.0
    n_classes: int = 2

    @property
    def n_trees(self) -> int:
        return self.feat.shape[0]

    @property
    def depth(self) -> int:
        return int(np.log2(self.feat.shape[1] + 1))

    def to(self, device) -> "TreeEnsemble":
        return dataclasses.replace(self, feat=self.feat.to(device),
                                   thresh=self.thresh.to(device),
                                   leaf=self.leaf.to(device))


def ensemble_from_arrays(feat, thresh, leaf, kind: str, *,
                         base_score: float = 0.0, learning_rate: float = 1.0,
                         n_classes: int = 2, device=None) -> TreeEnsemble:
    """Build an ensemble from plain arrays — how a trained ensemble crosses
    over from the reference package (or from disk). device=None means
    CUDA; pass device="cpu" for the CPU."""
    dev = resolve_device(device)
    return TreeEnsemble(
        feat=torch.as_tensor(np.asarray(feat), dtype=torch.int32, device=dev),
        thresh=torch.as_tensor(np.asarray(thresh), dtype=torch.float32,
                               device=dev),
        leaf=torch.as_tensor(np.asarray(leaf), dtype=torch.float32,
                             device=dev),
        kind=kind, base_score=base_score, learning_rate=learning_rate,
        n_classes=n_classes)


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

def quantile_bin_edges(x: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-feature quantile bin edges. Returns (F, n_bins - 1).

    ``bin(v) = sum(v > edges)`` so the split rule ``bin <= b`` is exactly
    ``v <= edges[b]``. Duplicated edges produce empty bins, which the split
    search masks out.
    """
    qs = torch.linspace(0.0, 1.0, n_bins + 1, dtype=torch.float32,
                        device=x.device)[1:-1]
    return torch.quantile(x, qs, dim=0).t().contiguous()   # (F, n_bins-1)


def bin_data(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Map raw features (N, F) onto bin ids (N, F) in [0, n_bins): the
    range-match kernel on the card, its plain version on the CPU."""
    return bucketize(x.contiguous(), edges.contiguous())


# ---------------------------------------------------------------------------
# shared level-wise growth
# ---------------------------------------------------------------------------

def _grow_level_hist(bins, node_id, stats, n_nodes, n_feat, n_bins):
    """Scatter-add per-(node, feature, bin) statistic histograms.

    bins (N, F) int32, node_id (N,) int32 node-within-level in
    [0, n_nodes), stats (N, S) per-sample statistics (class one-hot or
    (g, h)) -> (n_nodes, F, n_bins, S).
    """
    n, f = bins.shape
    feat_iota = torch.arange(n_feat, device=bins.device)[None, :]
    flat = ((node_id.long()[:, None] * n_feat + feat_iota) * n_bins
            + bins.long())                                   # (N, F)
    hist = torch.zeros((n_nodes * n_feat * n_bins, stats.shape[1]),
                       dtype=stats.dtype, device=stats.device)
    hist.index_add_(0, flat.reshape(-1),
                    stats[:, None, :].expand(n, f, stats.shape[1])
                    .reshape(n * f, stats.shape[1]))
    return hist.reshape(n_nodes, n_feat, n_bins, stats.shape[1])


def _route(bins, node_id, level_feat, level_split_bin):
    """Advance samples one level down. Returns node index within next level."""
    f = level_feat[node_id.long()].long()                    # (N,)
    b = torch.gather(bins, 1, f[:, None])[:, 0]
    go_right = b > level_split_bin[node_id.long()]
    return node_id * 2 + go_right.to(torch.int32)


def _argmax_split(gain, n_bins, min_gain):
    flat = gain.reshape(gain.shape[0], -1)
    best = torch.argmax(flat, dim=1)
    return best // n_bins, best % n_bins, flat.max(dim=1).values > min_gain


def _gini_best_split(hist, min_leaf):
    """Best (feature, bin) per node from class-count histograms.

    hist: (nodes, F, B, C) counts. Returns (feat, split_bin, has_split).
    """
    left = torch.cumsum(hist, dim=2)                         # counts left of split
    total = left[:, :, -1:, :]
    right = total - left
    n_l = left.sum(-1)                                       # (nodes, F, B)
    n_r = right.sum(-1)
    n_t = n_l + n_r

    def gini(counts, n):
        p = counts / torch.clamp(n[..., None], min=1.0)
        return 1.0 - (p * p).sum(dim=-1)

    g_parent = gini(total, n_t[..., -1:])                    # (nodes, F, 1)
    gain = (g_parent
            - (n_l / torch.clamp(n_t, min=1.0)) * gini(left, n_l)
            - (n_r / torch.clamp(n_t, min=1.0)) * gini(right, n_r))
    valid = (n_l >= min_leaf) & (n_r >= min_leaf)
    valid[:, :, -1] = False                                  # right side empty
    gain = torch.where(valid, gain, torch.full_like(gain, NEG_INF))
    return _argmax_split(gain, hist.shape[2], 0.0)


def _xgb_best_split(hist, reg_lambda, min_child_weight, gamma=0.0):
    """Best split from (g, h) histograms. hist: (nodes, F, B, 2).

    ``gamma`` is XGBoost's min-split-gain: weak splits are pruned, which is
    the paper's §4.2 "prune trees to create action codes of feasible
    length" knob (fewer thresholds -> smaller decision tables)."""
    left = torch.cumsum(hist, dim=2)
    total = left[:, :, -1:, :]
    right = total - left
    gl, hl = left[..., 0], left[..., 1]
    gr, hr = right[..., 0], right[..., 1]
    gt, ht = total[..., 0], total[..., 1]

    def score(g, h):
        return (g * g) / (h + reg_lambda)

    gain = 0.5 * (score(gl, hl) + score(gr, hr) - score(gt, ht))
    valid = (hl >= min_child_weight) & (hr >= min_child_weight)
    valid[:, :, -1] = False
    gain = torch.where(valid, gain, torch.full_like(gain, NEG_INF))
    return _argmax_split(gain, hist.shape[2], gamma)


def _fill_level(feat_heap, thresh_heap, level, level_feat, level_thresh):
    start = (1 << level) - 1
    feat_heap[start:start + level_feat.shape[0]] = level_feat
    thresh_heap[start:start + level_thresh.shape[0]] = level_thresh


def _level_split(bins, node_id, edges, n_bins, bf, bb, ok):
    """Record a level's splits and route the samples one level down."""
    thr = edges[bf, torch.clamp(bb, max=edges.shape[1] - 1)]
    level_feat = torch.where(ok, bf, torch.zeros_like(bf)).to(torch.int32)
    level_thresh = torch.where(ok, thr, torch.full_like(thr, float("inf")))
    # route with the *bin* rule (bin <= bb left); unsplit nodes go left
    eff_bin = torch.where(ok, bb, torch.full_like(bb, n_bins))
    return level_feat, level_thresh, _route(bins, node_id, level_feat, eff_bin)


# ---------------------------------------------------------------------------
# decision tree / random forest
# ---------------------------------------------------------------------------

def _fit_one_gini_tree(bins, y1h, edges, depth, n_bins, min_leaf, feat_mask):
    """Grow one gini tree on pre-binned data.

    bins (N, F) int32, y1h (N, C), edges (F, n_bins-1), feat_mask (F,) bool.
    -> (feat (H,), thresh (H,), leaf (2**depth, C)).
    """
    n, n_feat = bins.shape
    dev = bins.device
    n_heap = (1 << depth) - 1
    feat_heap = torch.zeros((n_heap,), dtype=torch.int32, device=dev)
    thresh_heap = torch.full((n_heap,), float("inf"), dtype=torch.float32,
                             device=dev)
    node_id = torch.zeros((n,), dtype=torch.int32, device=dev)

    for level in range(depth):
        n_nodes = 1 << level
        hist = _grow_level_hist(bins, node_id, y1h, n_nodes, n_feat, n_bins)
        masked = torch.where(feat_mask[None, :, None, None], hist,
                             torch.zeros_like(hist))
        bf, bb, ok = _gini_best_split(masked, min_leaf)
        level_feat, level_thresh, node_id = _level_split(
            bins, node_id, edges, n_bins, bf, bb, ok)
        _fill_level(feat_heap, thresh_heap, level, level_feat, level_thresh)

    # leaves: class counts
    leaf = torch.zeros((1 << depth, y1h.shape[1]), dtype=torch.float32,
                       device=dev)
    leaf.index_add_(0, node_id.long(), y1h)
    return feat_heap, thresh_heap, leaf


def _one_hot(y: torch.Tensor, n_classes: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(y.long(), n_classes).to(torch.float32)


def fit_decision_tree(x, y, *, n_classes, max_depth=5, n_bins=64,
                      min_leaf=1.0, edges=None, device=None):
    """CART-style gini decision tree. Returns a single-tree TreeEnsemble."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y1h = _one_hot(torch.as_tensor(y, device=dev), n_classes)
    edges = (quantile_bin_edges(x, n_bins) if edges is None
             else torch.as_tensor(edges, dtype=torch.float32, device=dev))
    bins = bin_data(x, edges)
    feat_mask = torch.ones((x.shape[1],), dtype=torch.bool, device=dev)
    f, t, leaf = _fit_one_gini_tree(bins, y1h, edges, max_depth, n_bins,
                                    min_leaf, feat_mask)
    return TreeEnsemble(feat=f[None], thresh=t[None], leaf=leaf[None],
                        kind="dt", n_classes=n_classes)


def random_forest_draws(n: int, n_feat: int, n_trees: int, max_features: int,
                        generator: torch.Generator):
    """Bootstrap rows (T, N) int64 and feature masks (T, F) bool, drawn on
    the generator's device."""
    dev = generator.device
    idx = torch.randint(0, n, (n_trees, n), generator=generator, device=dev)
    masks = torch.zeros((n_trees, n_feat), dtype=torch.bool, device=dev)
    for t in range(n_trees):
        perm = torch.randperm(n_feat, generator=generator, device=dev)
        masks[t, perm[:max_features]] = True
    return idx, masks


def fit_random_forest(x, y, *, n_classes, n_trees=10, max_depth=5, n_bins=64,
                      min_leaf=1.0, max_features=None, seed=0, edges=None,
                      draws=None, device=None):
    """Bagged gini trees (bootstrap rows + per-tree feature subsampling).

    ``draws=(idx (T, N), masks (T, F))`` replaces the seeded draws, e.g.
    with the reference's, so both packages grow the same forest.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, device=dev)
    n, n_feat = x.shape
    if max_features is None:
        max_features = max(1, int(np.sqrt(n_feat)))
    edges = (quantile_bin_edges(x, n_bins) if edges is None
             else torch.as_tensor(edges, dtype=torch.float32, device=dev))
    bins = bin_data(x, edges)
    y1h = _one_hot(y, n_classes)
    if draws is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        draws = random_forest_draws(n, n_feat, n_trees, max_features, gen)
    idx = torch.as_tensor(draws[0], device=dev).long()
    masks = torch.as_tensor(draws[1], device=dev).bool()
    outs = [_fit_one_gini_tree(bins[idx[t]], y1h[idx[t]], edges, max_depth,
                               n_bins, min_leaf, masks[t])
            for t in range(idx.shape[0])]
    f, t, leaf = (torch.stack([o[j] for o in outs]) for j in range(3))
    return TreeEnsemble(feat=f, thresh=t, leaf=leaf, kind="rf",
                        n_classes=n_classes)


# ---------------------------------------------------------------------------
# XGBoost-style boosting (binary logistic)
# ---------------------------------------------------------------------------

def _fit_one_xgb_tree(bins, g, h, edges, depth, n_bins, reg_lambda,
                      min_child_weight, gamma=0.0):
    n, n_feat = bins.shape
    dev = bins.device
    n_heap = (1 << depth) - 1
    feat_heap = torch.zeros((n_heap,), dtype=torch.int32, device=dev)
    thresh_heap = torch.full((n_heap,), float("inf"), dtype=torch.float32,
                             device=dev)
    node_id = torch.zeros((n,), dtype=torch.int32, device=dev)
    stats = torch.stack([g, h], dim=1)

    for level in range(depth):
        n_nodes = 1 << level
        hist = _grow_level_hist(bins, node_id, stats, n_nodes, n_feat, n_bins)
        bf, bb, ok = _xgb_best_split(hist, reg_lambda, min_child_weight,
                                     gamma)
        level_feat, level_thresh, node_id = _level_split(
            bins, node_id, edges, n_bins, bf, bb, ok)
        _fill_level(feat_heap, thresh_heap, level, level_feat, level_thresh)

    n_leaf = 1 << depth
    g_leaf = torch.zeros((n_leaf,), dtype=torch.float32, device=dev)
    h_leaf = torch.zeros((n_leaf,), dtype=torch.float32, device=dev)
    g_leaf.index_add_(0, node_id.long(), g)
    h_leaf.index_add_(0, node_id.long(), h)
    w = -g_leaf / (h_leaf + reg_lambda)
    return feat_heap, thresh_heap, w[:, None], node_id


def fit_xgboost(x, y, *, n_trees=10, max_depth=4, n_bins=64,
                learning_rate=0.3, reg_lambda=1.0, min_child_weight=1.0,
                gamma=0.0, base_score=0.0, edges=None, device=None):
    """Second-order boosted trees, binary logistic objective."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    yf = torch.as_tensor(y, device=dev).to(torch.float32)
    edges = (quantile_bin_edges(x, n_bins) if edges is None
             else torch.as_tensor(edges, dtype=torch.float32, device=dev))
    bins = bin_data(x, edges)

    margin = torch.full((x.shape[0],), base_score, dtype=torch.float32,
                        device=dev)
    feats, threshs, leaves = [], [], []
    for _ in range(n_trees):
        p = torch.sigmoid(margin)
        g = p - yf
        h = torch.clamp(p * (1.0 - p), min=1e-6)
        f, t, w, node_id = _fit_one_xgb_tree(bins, g, h, edges, max_depth,
                                             n_bins, reg_lambda,
                                             min_child_weight, gamma)
        margin = margin + learning_rate * w[node_id.long(), 0]
        feats.append(f)
        threshs.append(t)
        leaves.append(w)
    return TreeEnsemble(feat=torch.stack(feats), thresh=torch.stack(threshs),
                        leaf=torch.stack(leaves), kind="xgb",
                        base_score=base_score, learning_rate=learning_rate,
                        n_classes=2)


# ---------------------------------------------------------------------------
# Isolation forest
# ---------------------------------------------------------------------------

def isolation_forest_draws(n: int, n_feat: int, n_trees: int, depth: int,
                           subsample: int, generator: torch.Generator):
    """Per tree: ``subsample`` rows drawn without replacement (T, sub)
    int64, and per heap node a split feature (T, H) int64 and a split
    position (T, H) float32 in [0, 1), drawn on the generator's device."""
    dev = generator.device
    n_heap = (1 << depth) - 1
    idx = torch.stack([torch.randperm(n, generator=generator,
                                      device=dev)[:subsample]
                       for _ in range(n_trees)])
    feat = torch.randint(0, n_feat, (n_trees, n_heap), generator=generator,
                         device=dev)
    pos = torch.rand((n_trees, n_heap), generator=generator, device=dev)
    return idx, feat, pos


def _fit_one_iso_tree(bins, edges, depth, n_bins, feat_draw, pos_draw):
    """Grow one isolation tree: each node splits on its drawn feature at a
    drawn bin between the lowest and highest bin its samples occupy.
    feat_draw/pos_draw (H,) are heap-ordered. -> (feat, thresh, leaf counts)."""
    n, n_feat = bins.shape
    dev = bins.device
    n_heap = (1 << depth) - 1
    feat_heap = torch.zeros((n_heap,), dtype=torch.int32, device=dev)
    thresh_heap = torch.full((n_heap,), float("inf"), dtype=torch.float32,
                             device=dev)
    node_id = torch.zeros((n,), dtype=torch.int32, device=dev)
    ones = torch.ones((n, 1), dtype=torch.float32, device=dev)

    for level in range(depth):
        n_nodes = 1 << level
        start = n_nodes - 1
        hist = _grow_level_hist(bins, node_id, ones, n_nodes, n_feat,
                                n_bins)[..., 0]               # (nodes, F, B)
        level_feat = feat_draw[start:start + n_nodes].long()
        h_f = hist[torch.arange(n_nodes, device=dev), level_feat]  # (nodes, B)
        present = (h_f > 0).to(torch.int32)
        lo = torch.argmax(present, dim=1)                      # first occupied
        hi = n_bins - 1 - torch.argmax(present.flip(1), dim=1)  # last occupied
        span = torch.clamp(hi - lo, min=0).to(torch.float32)
        bb = lo + (pos_draw[start:start + n_nodes] * span).to(torch.int64)
        bb = torch.clamp(bb, 0, n_bins - 2)
        splittable = hi > lo
        thr = edges[level_feat, torch.clamp(bb, max=edges.shape[1] - 1)]
        level_thresh = torch.where(splittable, thr,
                                   torch.full_like(thr, float("inf")))
        eff_bin = torch.where(splittable, bb, torch.full_like(bb, n_bins))
        split_feat = torch.where(splittable, level_feat,
                                 torch.zeros_like(level_feat)).to(torch.int32)
        node_id = _route(bins, node_id, split_feat, eff_bin)
        _fill_level(feat_heap, thresh_heap, level, split_feat, level_thresh)

    count = torch.zeros((1 << depth, 1), dtype=torch.float32, device=dev)
    count.index_add_(0, node_id.long(), ones)
    return feat_heap, thresh_heap, count


def fit_isolation_forest(x, *, n_trees=32, max_depth=6, n_bins=64,
                         subsample=256, seed=0, edges=None, draws=None,
                         device=None):
    """Isolation forest on binned data; leaves hold sample counts.

    ``draws=(idx (T, sub), feat (T, H), pos (T, H))`` replaces the seeded
    draws (``isolation_forest_draws``), e.g. with the reference's, so both
    packages grow the same forest.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    n, n_feat = x.shape
    edges = (quantile_bin_edges(x, n_bins) if edges is None
             else torch.as_tensor(edges, dtype=torch.float32, device=dev))
    bins_full = bin_data(x, edges)
    if draws is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        draws = isolation_forest_draws(n, n_feat, n_trees, max_depth,
                                       min(subsample, n), gen)
    idx = torch.as_tensor(draws[0], device=dev).long()
    feat = torch.as_tensor(draws[1], device=dev).long()
    pos = torch.as_tensor(draws[2], dtype=torch.float32, device=dev)
    outs = [_fit_one_iso_tree(bins_full[idx[t]], edges, max_depth, n_bins,
                              feat[t], pos[t])
            for t in range(idx.shape[0])]
    f, t, leaf = (torch.stack([o[j] for o in outs]) for j in range(3))
    return TreeEnsemble(feat=f, thresh=t, leaf=leaf, kind="iforest",
                        n_classes=2)


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------

def tree_leaf_indices(ens: TreeEnsemble, x) -> torch.Tensor:
    """(T, N) leaf index per tree: a fixed-depth heap walk, all trees at once."""
    x = torch.as_tensor(x, dtype=torch.float32, device=ens.feat.device)
    xt = x.t()                                               # (F, N)
    node = torch.zeros((ens.n_trees, x.shape[0]), dtype=torch.long,
                       device=x.device)
    feat, thresh = ens.feat.long(), ens.thresh
    for _ in range(ens.depth):
        f = torch.gather(feat, 1, node)                      # (T, N)
        t = torch.gather(thresh, 1, node)
        xv = torch.gather(xt, 0, f)                          # x[n, f[t, n]]
        node = 2 * node + 1 + (xv > t).long()
    return node - ((1 << ens.depth) - 1)


def _sum_over_trees(v: torch.Tensor) -> torch.Tensor:
    """Sum over the leading tree axis, adding trees in order — the order the
    reference's reduction takes, so float sums come out bit for bit the same
    (``torch.sum`` associates differently)."""
    total = v[0].clone()
    for t in range(1, v.shape[0]):
        total += v[t]
    return total


def predict_proba_tree_ensemble(ens: TreeEnsemble, x) -> torch.Tensor:
    """Mean per-tree class distribution (DT/RF). -> (N, C)."""
    leaf_idx = tree_leaf_indices(ens, x)                     # (T, N)
    c = ens.leaf.shape[2]
    counts = torch.gather(ens.leaf, 1,
                          leaf_idx[:, :, None].expand(-1, -1, c))   # (T, N, C)
    probs = counts / torch.clamp(counts.sum(-1, keepdim=True), min=1e-9)
    return _sum_over_trees(probs) * float(np.float32(1.0) / np.float32(ens.n_trees))


def predict_margin_xgboost(ens: TreeEnsemble, x) -> torch.Tensor:
    leaf_idx = tree_leaf_indices(ens, x)
    w = torch.gather(ens.leaf[..., 0], 1, leaf_idx)          # (T, N)
    return ens.base_score + ens.learning_rate * _sum_over_trees(w)


def predict_iforest_score(ens: TreeEnsemble, x, subsample=256) -> torch.Tensor:
    """Anomaly score in (0, 1); higher = more anomalous."""
    leaf_idx = tree_leaf_indices(ens, x)                     # (T, N)
    size = torch.gather(ens.leaf[..., 0], 1, leaf_idx)
    path = ens.depth + torch.where(size > 1, _c_factor(size),
                                   torch.zeros_like(size))
    e_path = (_sum_over_trees(path)
              * float(np.float32(1.0) / np.float32(ens.n_trees)))
    n = torch.full((), subsample, dtype=torch.float32, device=path.device)
    return torch.pow(2.0, -e_path / _c_factor(n))


def predict_tree_ensemble(ens: TreeEnsemble, x) -> torch.Tensor:
    """Hard class prediction for any tree kind."""
    if ens.kind in ("dt", "rf"):
        return torch.argmax(predict_proba_tree_ensemble(ens, x), dim=1)
    if ens.kind == "xgb":
        return (predict_margin_xgboost(ens, x) > 0.0).to(torch.int32)
    if ens.kind == "iforest":
        return (predict_iforest_score(ens, x) > 0.5).to(torch.int32)
    raise ValueError(ens.kind)
