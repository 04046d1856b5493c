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
