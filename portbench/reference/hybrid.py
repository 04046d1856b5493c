"""The hybrid step on rows: the switch answers, the rows it is unsure of go
to the backend in arrival order up to its capacity, and the backend's
answers replace the switch's on those rows."""

from __future__ import annotations

import numpy as np
import torch


def first_forwarded(fwd: torch.Tensor, capacity: int) -> torch.Tensor:
    """(..., W) bool: the first ``capacity`` forwarded lanes of each row
    (the last axis), in lane order: the rows the backend serves."""
    rank = torch.cumsum(fwd.to(torch.int64), dim=-1)
    return fwd & (rank <= capacity)


def hybrid_rows(x: torch.Tensor, switch, backend, tau: float,
                capacity: int):
    """One batch: -> (pred (n,), forwarded (n,), served (n,)), ``served``
    the rows the backend answered."""
    sw_pred, conf = switch.vote(x)
    fwd = conf < tau
    served = first_forwarded(fwd, capacity)
    pred = sw_pred.clone()
    if bool(served.any()):
        pred[served] = backend.predict(x[served]).to(pred.dtype)
    return pred, fwd, served


def handled_share(fwd: torch.Tensor) -> torch.Tensor:
    """1 - the forwarded share, as a float32 product with the reciprocal
    of the row count (the batch server's telemetry)."""
    n = fwd.shape[-1]
    return 1.0 - fwd.to(torch.float32).sum(-1) * float(
        np.float32(1.0) / np.float32(n))
