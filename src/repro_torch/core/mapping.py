"""IIsy's mapping tool: trained model -> TableArtifact (§4 of the paper).

Port of ``repro/core/mapping.py``. Key ideas, as in the paper:
  * one feature table per feature, **shared across all trees** of an ensemble
    (§4.2 "Ilsy significantly reduces resources by sharing feature tables");
  * per-tree decision tables keyed on the concatenated per-feature codes, so
    the number of lookup stages is independent of tree depth (§4.1);
  * classical models (SVM / NB / K-Means) as per-feature value tables whose
    quantized partial terms are summed at the end of the pipeline (§4.3);
  * payload quantization controlled by ``action_bits`` (§7.7 / Fig 9).

Mapping runs host-side in numpy (the paper's control-plane "python
script"), the same arithmetic as the reference; the artifact's tensors land
on the CPU and a server moves them to its device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.artifact import TableArtifact, finalize_artifact
from repro_torch.core.quantize import quantize_fixed
from repro_torch.device import to_numpy
from repro_torch.ml.kmeans import KMeansModel
from repro_torch.ml.naive_bayes import GaussianNB
from repro_torch.ml.svm import LinearSVM
from repro_torch.ml.trees import TreeEnsemble


# ---------------------------------------------------------------------------
# tree family
# ---------------------------------------------------------------------------


def _tree_thresholds(feat, thresh, n_features):
    """Per-feature sorted unique finite thresholds of one tree."""
    out = []
    for f in range(n_features):
        t = thresh[(feat == f) & np.isfinite(thresh)]
        out.append(np.unique(t))
    return out


def _leaf_walk(feat, thresh, x, depth):
    """Evaluate one tree on rows of x (numpy). Returns leaf indices."""
    node = np.zeros(x.shape[0], np.int64)
    for _ in range(depth):
        f = feat[node]
        t = thresh[node]
        node = 2 * node + 1 + (x[np.arange(x.shape[0]), f] > t)
    return node - (2 ** depth - 1)


def map_tree_ensemble(ens: TreeEnsemble, n_features: int, *,
                      action_bits: int = 16,
                      max_decision_entries: int = 2_000_000) -> TableArtifact:
    feat = to_numpy(ens.feat)           # (T, H)
    thresh = to_numpy(ens.thresh)       # (T, H)
    leaf = to_numpy(ens.leaf)           # (T, L, C)
    n_trees, depth = ens.n_trees, ens.depth

    per_tree = [_tree_thresholds(feat[t], thresh[t], n_features)
                for t in range(n_trees)]

    # union edges per feature
    unions = [np.unique(np.concatenate([per_tree[t][f] for t in range(n_trees)]
                                       + [np.zeros(0, np.float32)]))
              for f in range(n_features)]
    u_max = max(1, max(len(u) for u in unions))
    edges = np.full((n_features, u_max), np.inf, np.float32)
    for f, u in enumerate(unions):
        edges[f, :len(u)] = u

    # feature tables: code of union-bin b under tree t on feature f
    # code = #(tree thresholds with position-in-union < b)
    ftable = np.zeros((n_features, u_max + 1, n_trees), np.int32)
    for f, u in enumerate(unions):
        for t in range(n_trees):
            pos = np.searchsorted(u, per_tree[t][f])   # positions within union
            bins = np.arange(u_max + 1)
            ftable[f, :, t] = np.searchsorted(pos, bins, side="left")

    # mixed-radix strides and decision tables
    radix = np.array([[len(per_tree[t][f]) + 1 for f in range(n_features)]
                      for t in range(n_trees)], np.int64)      # (T, F)
    sizes = radix.prod(axis=1)
    s_max = int(sizes.max())
    if int(sizes.sum()) > max_decision_entries:
        raise ValueError(
            f"decision tables need {int(sizes.sum())} entries > "
            f"{max_decision_entries}; prune the trees (paper §4.2) or raise "
            f"the cap")
    strides = np.zeros((n_trees, n_features), np.int64)
    for t in range(n_trees):
        s = 1
        for f in range(n_features - 1, -1, -1):
            strides[t, f] = s
            s *= radix[t, f]

    dtable_class = np.zeros((n_trees, s_max), np.int32)
    dtable_value = np.zeros((n_trees, s_max), np.float32)
    c_euler = 0.5772156649

    def c_factor(n):
        n = np.maximum(n, 2.0)
        return 2.0 * (np.log(n - 1.0) + c_euler) - 2.0 * (n - 1.0) / n

    for t in range(n_trees):
        # representative value per (feature, code)
        reps = []
        for f in range(n_features):
            th = per_tree[t][f]
            if len(th) == 0:
                reps.append(np.zeros(1, np.float32))
                continue
            mid = (th[:-1] + th[1:]) / 2.0
            reps.append(np.concatenate([[th[0] - 1.0], mid, [th[-1] + 1.0]]))
        # enumerate every code combination (mixed-radix grid)
        size = int(sizes[t])
        keys = np.arange(size)
        grid = np.zeros((size, n_features), np.float32)
        rem = keys.copy()
        for f in range(n_features):
            idx = rem // strides[t, f]
            rem = rem % strides[t, f]
            grid[:, f] = reps[f][idx]
        leaves = _leaf_walk(feat[t], thresh[t], grid, depth)
        payload = leaf[t][leaves]                       # (size, C)
        if ens.kind in ("dt", "rf"):
            dtable_class[t, :size] = payload.argmax(axis=1)
        elif ens.kind == "xgb":
            dtable_value[t, :size] = payload[:, 0]
        elif ens.kind == "iforest":
            n_leaf = payload[:, 0]
            dtable_value[t, :size] = depth + np.where(
                n_leaf > 1, c_factor(n_leaf), 0.0)
        else:
            raise ValueError(ens.kind)

    agg = {"dt": "vote", "rf": "vote", "xgb": "wsum_sigmoid",
           "iforest": "iforest"}[ens.kind]
    return finalize_artifact(TableArtifact(
        edges=torch.from_numpy(edges), agg=agg, n_classes=ens.n_classes,
        ftable=torch.from_numpy(ftable),
        strides=torch.from_numpy(strides.astype(np.int32)),
        dtable_class=torch.from_numpy(dtable_class),
        dtable_value=quantize_fixed(dtable_value, action_bits),
        base_score=ens.base_score, learning_rate=ens.learning_rate))


# ---------------------------------------------------------------------------
# classical family — quantile-binned value tables
# ---------------------------------------------------------------------------

def _quantile_edges(x_train, n_bins):
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    return np.quantile(to_numpy(x_train, np.float32), qs, axis=0).T  # (F, B-1)


def _bin_centers(edges_f):
    """Representative value per bin given one feature's edges (len B-1)."""
    e = edges_f
    if len(e) == 0:
        return np.zeros(1, np.float32)
    mid = (e[:-1] + e[1:]) / 2.0
    span = max(e[-1] - e[0], 1e-6)
    return np.concatenate([[e[0] - 0.05 * span], mid, [e[-1] + 0.05 * span]])


def _data_reps(x_f, edges_f, n_bins):
    """Per-bin representative = mean of training values landing in the bin.

    Midpoint reps are badly wrong for discrete features (duplicate quantile
    edges make the midpoint of a {0,1} feature 0.5); the control plane has the
    training data anyway, so it loads the empirical bin mean and falls back to
    the geometric midpoint only for bins no training point hits.
    """
    mids = _bin_centers(edges_f)
    reps = np.zeros(n_bins, np.float32)
    reps[:len(mids)] = mids
    bins = np.sum(x_f[:, None] > edges_f[None, :], axis=1)  # match feature_bins
    sums = np.bincount(bins, weights=x_f, minlength=n_bins)[:n_bins]
    cnts = np.bincount(bins, minlength=n_bins)[:n_bins]
    hit = cnts > 0
    reps[hit] = (sums[hit] / cnts[hit]).astype(np.float32)
    return reps


def _padded_edges(edges, n_bins):
    """(F, B-1) quantile edges padded with +inf to the artifact's edge table."""
    pad = np.full((edges.shape[0], n_bins - 1), np.inf, np.float32)
    pad[:, :edges.shape[1]] = edges
    return torch.from_numpy(pad)


def map_svm(model: LinearSVM, x_train, *, n_bins=64,
            action_bits: int = 16) -> TableArtifact:
    """Table-per-feature SVM mapping (paper §4.3 / Appendix A.1, option 1).

    vtable[f, b, j] = a_{j,f} * rep(bin b of feature f)  (quantized); the
    hyperplane value is the sum over features plus the intercept.
    """
    edges = _quantile_edges(x_train, n_bins)            # (F, B-1)
    f_dim, m = edges.shape[0], model.weights.shape[0]
    w = to_numpy(model.weights)                         # (m, F) on standardized x
    mean, scale = to_numpy(model.mean), to_numpy(model.scale)
    x_np = to_numpy(x_train, np.float32)
    vtable = np.zeros((f_dim, n_bins, m), np.float32)
    for f in range(f_dim):
        reps = _data_reps(x_np[:, f], edges[f], n_bins)  # raw domain
        reps_std = (reps - mean[f]) / scale[f]
        vtable[f, :, :] = reps_std[:, None] * w[:, f][None, :]
    return finalize_artifact(TableArtifact(
        edges=_padded_edges(edges, n_bins), agg="svm_ovo",
        n_classes=model.n_classes,
        vtable=quantize_fixed(vtable, action_bits),
        consts=torch.from_numpy(to_numpy(model.bias)),
        pairs=torch.from_numpy(to_numpy(model.pairs, np.int32))))


def map_naive_bayes(model: GaussianNB, x_train, *, n_bins=64,
                    action_bits: int = 16) -> TableArtifact:
    """Log-domain NB mapping: vtable[f, b, c] = log P(bin_rep | c).

    The paper multiplies probabilities through paired tables; storing logs and
    summing is the resource-optimal variant it alludes to ("coding the
    results ... rather than normalizing values") and removes the underflow
    error mode of Fig 9.
    """
    edges = _quantile_edges(x_train, n_bins)
    f_dim, c_dim = model.mu.shape[1], model.mu.shape[0]
    mu, var = to_numpy(model.mu), to_numpy(model.var)
    x_np = to_numpy(x_train, np.float32)
    vtable = np.zeros((f_dim, n_bins, c_dim), np.float32)
    for f in range(f_dim):
        reps = _data_reps(x_np[:, f], edges[f], n_bins)
        d = reps[:, None] - mu[None, :, f]
        vtable[f, :, :] = -0.5 * (
            np.log(2 * np.pi * var[None, :, f]) + d * d / var[None, :, f])
    return finalize_artifact(TableArtifact(
        edges=_padded_edges(edges, n_bins), agg="nb_log", n_classes=c_dim,
        vtable=quantize_fixed(vtable, action_bits),
        consts=torch.from_numpy(to_numpy(model.log_prior))))


def map_kmeans(model: KMeansModel, x_train, *, n_bins=64,
               action_bits: int = 16, n_classes=None) -> TableArtifact:
    """vtable[f, b, k] = (rep_std(bin) - center[k, f])^2 (quantized).

    The served prediction is the cluster id; mapping clusters to classes
    (the model zoo's majority flip) is the caller's business."""
    edges = _quantile_edges(x_train, n_bins)
    centers = to_numpy(model.centers)                   # (K, F) standardized
    mean, scale = to_numpy(model.mean), to_numpy(model.scale)
    f_dim, k_dim = edges.shape[0], centers.shape[0]
    x_np = to_numpy(x_train, np.float32)
    vtable = np.zeros((f_dim, n_bins, k_dim), np.float32)
    for f in range(f_dim):
        reps = (_data_reps(x_np[:, f], edges[f], n_bins) - mean[f]) / scale[f]
        d = reps[:, None] - centers[None, :, f]
        vtable[f, :, :] = d * d
    return finalize_artifact(TableArtifact(
        edges=_padded_edges(edges, n_bins), agg="kmeans",
        n_classes=(n_classes or k_dim),
        vtable=quantize_fixed(vtable, action_bits),
        consts=torch.zeros(k_dim, dtype=torch.float32)))
