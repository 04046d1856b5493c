"""Analytic resource models of prior-work mappings (Figs 6-7 baselines).

Port of ``repro/core/naive_mappings.py`` (numpy). These reproduce the
*mapping strategies* of SwitchTree / pForest / Clustreams so the paper's
comparisons can be regenerated:

- SwitchTree [29]: each tree encoded independently; evaluation walks the
  tree, so stages scale with depth and tables scale with trees x features.
- pForest [12]: one table per tree *level*; stages again scale with depth.
- Clustreams [17]: K-means cells encoded as per-cluster range entries over
  the full feature cross-product.

They are resource estimators (entries/tables/stages), not execution
engines: IIsy's own artifact is the only execution path, which mirrors the
paper (baselines are compared on resources, Figs 6-7).
"""

from __future__ import annotations

from repro_torch.core.mapping import _tree_thresholds
from repro_torch.core.resources import ResourceReport
from repro_torch.device import to_numpy
from repro_torch.ml.trees import TreeEnsemble


def switchtree_resources(ens: TreeEnsemble, n_features: int,
                         class_bits: int = 8) -> ResourceReport:
    """Per-tree, per-feature tables; depth-many dependent stages per tree."""
    feat, thresh = to_numpy(ens.feat), to_numpy(ens.thresh)
    entries = 0
    tables = 0
    for t in range(ens.n_trees):
        ths = _tree_thresholds(feat[t], thresh[t], n_features)
        for f in range(n_features):
            if len(ths[f]) == 0:
                continue
            tables += 1
            entries += len(ths[f]) + 1
        # per-tree decision logic: one table per tree, one entry per leaf
        tables += 1
        entries += 2 ** ens.depth
    # conditions evaluated level by level -> depth stages (+1 vote)
    stages = ens.depth + 1
    return ResourceReport(tables=tables, entries=entries,
                          bits=entries * class_bits, stages=stages)


def pforest_resources(ens: TreeEnsemble, n_features: int,
                      class_bits: int = 8) -> ResourceReport:
    """Table per level per tree: level d holds 2**d node entries."""
    entries = sum(ens.n_trees * (2 ** d) for d in range(ens.depth))
    entries += ens.n_trees * 2 ** ens.depth              # leaves
    tables = ens.n_trees * (ens.depth + 1)
    stages = ens.depth + 1
    return ResourceReport(tables=tables, entries=entries,
                          bits=entries * class_bits, stages=stages)


def clustreams_resources(n_clusters: int, n_features: int, n_bins: int,
                         value_bits: int = 16) -> ResourceReport:
    """Axis-aligned cell encoding: each cluster covered by range entries on
    every feature, matched in one wide table. Entries scale with
    K * bins^(F/2) style box decomposition; this uses the paper-favourable
    lower bound K * n_bins * F."""
    entries = n_clusters * n_bins * n_features
    return ResourceReport(tables=n_features, entries=entries,
                          bits=entries * value_bits, stages=2)
