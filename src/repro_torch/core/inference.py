"""Plain table inference — the reference "switch data plane".

Port of ``repro/core/inference.py``. The fused CUDA kernel reimplements the
same pipeline; both return ``(pred, confidence)``.

Stages (mirrors the match-action pipeline):
  1. per-feature range match           -> union bin        (parser + feature tables)
  2. per-tree code gather + mixed radix -> decision key
  3. per-tree decision-table gather     -> leaf payload
  4. aggregation                        -> class + confidence
"""

from __future__ import annotations

import torch

from repro_torch.core.artifact import TableArtifact
from repro_torch.device import true_div
from repro_torch.kernels.ref import bucketize_ref, tree_keys


def feature_bins(edges: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N, F) union-bin ids; edges padded with +inf never match."""
    return bucketize_ref(x, edges)


def _c_factor(n: torch.Tensor) -> torch.Tensor:
    n = torch.clamp(n, min=2.0)
    return 2.0 * (torch.log(n - 1.0) + 0.5772156649) - 2.0 * (n - 1.0) / n


def table_predict(art: TableArtifact, x: torch.Tensor):
    """Classify a batch. Returns (pred (N,), confidence (N,))."""
    x = torch.as_tensor(x, dtype=torch.float32, device=art.device)
    if art.ftable is not None:                               # tree family
        keys = tree_keys(x, art.edges, art.ftable, art.strides)   # (N, T)
        t_idx = torch.arange(art.n_trees, device=x.device)[None, :]
        if art.agg == "vote":
            cls = art.dtable_class[t_idx, keys]              # (N, T)
            votes = torch.nn.functional.one_hot(
                cls.long(), art.n_classes).to(torch.float32).sum(dim=1)
            pred = torch.argmax(votes, dim=1)
            conf = true_div(votes.max(dim=1).values, art.n_trees)
            return pred, conf
        vals_q = art.dtable_value.q[t_idx, keys]             # (N, T) int32
        # integer-domain sum (what the switch ALU does), one dequant at the end
        total = (vals_q.sum(dim=1, dtype=torch.int32).to(torch.float32)
                 / art.dtable_value.scale)
        if art.agg == "wsum_sigmoid":
            p1 = torch.sigmoid(art.base_score + art.learning_rate * total)
            pred = (p1 > 0.5).to(torch.int32)
            return pred, torch.maximum(p1, 1.0 - p1)
        if art.agg == "iforest":
            e_path = true_div(total, art.n_trees)
            n = torch.full((), art.iforest_subsample, dtype=torch.float32,
                           device=x.device)
            score = torch.pow(2.0, -e_path / _c_factor(n))
            pred = (score > 0.5).to(torch.int32)
            return pred, torch.maximum(score, 1.0 - score)
        raise ValueError(art.agg)

    # classical family
    bins = feature_bins(art.edges, x).long()
    f_idx = torch.arange(art.n_features, device=x.device)[None, :]
    vals_q = art.vtable.q[f_idx, bins]                       # (N, F, M)
    total = (vals_q.sum(dim=1, dtype=torch.int32).to(torch.float32)
             / art.vtable.scale)
    return classical_aggregate(art, total)


def classical_aggregate(art: TableArtifact, total: torch.Tensor):
    """(N, M) dequantized per-model totals -> (pred, conf) for svm_ovo,
    nb_log and kmeans — shared by ``table_predict`` and the classify
    epilogue, as the reference's two copies compute the same thing."""
    if art.agg == "svm_ovo":
        planes = total + art.consts[None, :]                 # (N, m)
        win_i = planes > 0              # plane j votes pairs[j, 0], else [j, 1]
        votes = torch.zeros((planes.shape[0], art.n_classes),
                            dtype=torch.float32, device=planes.device)
        votes.index_add_(1, art.pairs[:, 0].long(), win_i.to(torch.float32))
        votes.index_add_(1, art.pairs[:, 1].long(),
                         (~win_i).to(torch.float32))
        pred = torch.argmax(votes, dim=1)
        if planes.shape[1] == 1:                             # binary: margin conf
            conf = torch.sigmoid(2.0 * torch.abs(planes[:, 0]))
        else:
            conf = true_div(votes.max(dim=1).values, planes.shape[1])
        return pred, conf
    if art.agg == "nb_log":
        joint = total + art.consts[None, :]                  # (N, C) log joint
        pred = torch.argmax(joint, dim=1)
        conf = torch.softmax(joint, dim=1).max(dim=1).values
        return pred, conf
    if art.agg == "kmeans":
        pred = torch.argmin(total, dim=1)
        # margin confidence: how decisively the nearest beats the runner-up
        top2 = torch.topk(-total, 2, dim=1).values
        return pred, 1.0 - torch.exp(top2[:, 1] - top2[:, 0])
    raise ValueError(art.agg)


def table_predict_per_tree(art: TableArtifact, x: torch.Tensor) -> torch.Tensor:
    """Per-tree classes (N, T) — used by equivalence tests."""
    x = torch.as_tensor(x, dtype=torch.float32, device=art.device)
    keys = tree_keys(x, art.edges, art.ftable, art.strides)
    t_idx = torch.arange(art.n_trees, device=x.device)[None, :]
    return art.dtable_class[t_idx, keys]


def tree_vote_predict(ens, x):
    """Direct (non-table) per-tree majority vote: the baseline the table
    pipeline is held to (the paper's per-tree "classification results of
    all trees"). -> (pred (N,), confidence (N,))."""
    from repro_torch.ml.trees import tree_leaf_indices
    leaf_idx = tree_leaf_indices(ens, x)                     # (T, N)
    counts = torch.take_along_dim(ens.leaf, leaf_idx[:, :, None], dim=1)
    cls = torch.argmax(counts, dim=2)                        # (T, N)
    votes = torch.nn.functional.one_hot(cls.t(), ens.n_classes).to(
        torch.float32).sum(dim=1)
    return (torch.argmax(votes, dim=1),
            true_div(votes.max(dim=1).values, ens.n_trees))
