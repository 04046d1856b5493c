"""Classification metrics used by the paper's tables (acc/P/R/F1).

Port of ``repro/ml/metrics.py``, in float32 like the reference. Inputs may
be numpy arrays or tensors on any device; the results are Python floats.
"""

from __future__ import annotations

import torch

from repro_torch.device import mean


def _as_tensors(y_true, y_pred):
    y_pred = torch.as_tensor(y_pred)
    return torch.as_tensor(y_true, device=y_pred.device), y_pred


def confusion_matrix(y_true, y_pred, n_classes):
    """(n_classes, n_classes) int32 counts, rows the true class: a count
    at the flat index ``y_true * n_classes + y_pred``, as the reference's
    scatter-add takes it, so an out-of-range label lands where it lands
    there: JAX's ``.at[].add`` counts a negative index from the end and
    drops one still out of bounds, and so does this."""
    y_true, y_pred = _as_tensors(y_true, y_pred)
    n2 = n_classes * n_classes
    idx = (y_true.to(torch.int32) * n_classes
           + y_pred.to(torch.int32)).reshape(-1)
    idx = torch.where(idx < 0, idx + n2, idx)
    # dropped updates go to one spare slot past the end: no host sync
    slot = torch.where((idx >= 0) & (idx < n2), idx, n2).to(torch.int64)
    counts = torch.zeros(n2 + 1, dtype=torch.int32, device=idx.device)
    counts.index_add_(0, slot, torch.ones_like(idx))
    return counts[:n2].reshape(n_classes, n_classes)


def accuracy(y_true, y_pred) -> float:
    y_true, y_pred = _as_tensors(y_true, y_pred)
    return float(mean((y_true == y_pred).to(torch.float32)))


def precision_recall_f1(y_true, y_pred, positive=1):
    """Binary P/R/F1 treating ``positive`` as the positive class."""
    y_true, y_pred = _as_tensors(y_true, y_pred)
    tp = ((y_pred == positive) & (y_true == positive)).sum()
    fp = ((y_pred == positive) & (y_true != positive)).sum()
    fn = ((y_pred != positive) & (y_true == positive)).sum()
    p = tp.to(torch.float32) / torch.clamp(tp + fp, min=1)
    r = tp.to(torch.float32) / torch.clamp(tp + fn, min=1)
    f1 = 2 * p * r / torch.clamp(p + r, min=1e-9)
    return float(p), float(r), float(f1)


def macro_f1(y_true, y_pred, n_classes) -> float:
    """The mean over classes of each class's binary F1, summed in class
    order as the reference sums its floats."""
    f1s = [precision_recall_f1(y_true, y_pred, positive=c)[2]
           for c in range(n_classes)]
    return sum(f1s) / n_classes
