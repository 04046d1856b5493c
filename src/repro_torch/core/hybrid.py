"""Hybrid deployment (§2.2.1, §7.7): small switch model + large backend.

Port of ``repro/core/hybrid.py`` (the batch forms). ``hybrid_predict`` is
the dense form used by the paper's sweeps (Figs 10-11).
``dispatch``/``combine`` are the serving form: the low-confidence subset is
*compacted* (MoE-dispatch style) so the expensive backend only sees the
forwarded queries. The cross-window deferral and chunk functions wait for
the streaming slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.artifact import TableArtifact
from repro_torch.core.inference import table_predict
from repro_torch.device import mean


@dataclasses.dataclass
class HybridResult:
    pred: torch.Tensor          # (N,) final classes
    switch_pred: torch.Tensor   # (N,) switch-tier classes
    confidence: torch.Tensor    # (N,)
    handled: torch.Tensor       # (N,) bool: True = answered at the switch
    fraction_handled: torch.Tensor


def hybrid_predict(art: TableArtifact, backend_fn: Callable, x,
                   threshold: float) -> HybridResult:
    """Dense hybrid: backend evaluated everywhere, selected where needed."""
    x = torch.as_tensor(x, dtype=torch.float32, device=art.device)
    sw_pred, conf = table_predict(art, x)
    handled = conf >= threshold
    be_pred = torch.as_tensor(backend_fn(x), device=x.device)
    pred = torch.where(handled, sw_pred, be_pred.to(sw_pred.dtype))
    return HybridResult(pred=pred, switch_pred=sw_pred, confidence=conf,
                        handled=handled,
                        fraction_handled=mean(handled.to(torch.float32)))


def dispatch(x: torch.Tensor, forward_mask: torch.Tensor, capacity: int):
    """Compact the forwarded rows into a fixed-capacity buffer.

    Returns (buf (capacity, F), idx (capacity,), valid (capacity,)) — fewer
    than ``capacity`` rows only when the batch itself is smaller. Forwarded
    rows come first in batch order (a stable sort, as the reference's
    ``jnp.argsort(~mask, stable=True)``); rows beyond capacity are dropped
    from forwarding and keep their switch prediction.
    """
    order = torch.argsort((~forward_mask).to(torch.int32), stable=True)
    idx = order[:capacity]
    return x[idx], idx, forward_mask[idx]


def combine(switch_pred: torch.Tensor, backend_pred_subset: torch.Tensor,
            idx: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Scatter backend answers for forwarded rows back over switch answers.
    ``idx`` holds distinct rows, so the scatter is deterministic. Returns a
    new tensor; ``switch_pred`` is left as it was."""
    upd = torch.where(valid, backend_pred_subset.to(switch_pred.dtype),
                      switch_pred[idx])
    out = switch_pred.clone()
    out[idx] = upd
    return out


def hybrid_serve(art: TableArtifact, backend_fn: Callable, x,
                 threshold: float, capacity: int):
    """Serving-form hybrid with bounded backend batch: backend_fn receives
    exactly ``capacity`` rows (padded with rows that were not forwarded)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=art.device)
    sw_pred, conf = table_predict(art, x)
    fwd = conf < threshold
    buf, idx, valid = dispatch(x, fwd, capacity)
    be_pred = torch.as_tensor(backend_fn(buf), device=x.device)
    pred = combine(sw_pred, be_pred, idx, valid)
    return pred, mean(fwd.to(torch.float32))
