"""IIsy's mapping tool: trained tree ensemble -> TableArtifact (§4 of the paper).

Port of ``repro/core/mapping.py`` (``map_tree_ensemble``; the classical
mappings wait for the SVM/NB/K-Means slice). Key ideas, as in the paper:
  * one feature table per feature, **shared across all trees** of an ensemble
    (§4.2 "Ilsy significantly reduces resources by sharing feature tables");
  * per-tree decision tables keyed on the concatenated per-feature codes, so
    the number of lookup stages is independent of tree depth (§4.1);
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
from repro_torch.ml.trees import TreeEnsemble


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
    feat = ens.feat.cpu().numpy()        # (T, H)
    thresh = ens.thresh.cpu().numpy()    # (T, H)
    leaf = ens.leaf.cpu().numpy()        # (T, L, C)
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
