"""Hybrid deployment (§2.2.1, §7.7): small switch model + large backend.

Port of ``repro/core/hybrid.py`` (the batch forms). ``hybrid_predict`` is
the dense form used by the paper's sweeps (Figs 10-11).
``dispatch``/``combine`` are the serving form: the low-confidence subset is
*compacted* (MoE-dispatch style) so the expensive backend only sees the
forwarded queries. ``DeferredDispatch``, ``chunk_dispatch`` and
``backpatch_pending`` are the chunked streaming path's: a chunk of K windows
dispatches every window at once and the backend's answers are patched back
into the chunk's pending predictions at their (window, lane) return
addresses. ``defer_window`` is cross-window deferral's (``flush_every >
1``): it writes one window's dispatched rows into a cycle's buffer in
place, at a slot given as a device scalar, so a captured step never
freezes the slot.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.artifact import TableArtifact
from repro_torch.core.inference import table_predict
from repro_torch.device import mean, resolve_device


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


# ---------------------------------------------------------------------------
# chunk dispatch and back-patch
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeferredDispatch:
    """A buffer of dispatched rows, each with its *return address*:
    ``window``, the pending row the row came from, and ``lane``, its lane in
    that window, so a flush can patch the backend's answers into the
    pending predictions (``backpatch_pending``)."""
    buf: torch.Tensor       # (slots, F) rows
    lane: torch.Tensor      # (slots,) i32 lane within the source window
    window: torch.Tensor    # (slots,) i32 pending row of the source window
    valid: torch.Tensor     # (slots,) bool: the slot holds a live row

    @property
    def slots(self) -> int:
        return self.lane.shape[0]


def init_deferred(flush_every: int, capacity: int, n_features: int, *,
                  device=None) -> DeferredDispatch:
    """An empty buffer for ``flush_every`` windows of ``capacity`` rows, on
    ``device`` (None: CUDA); every slot dead."""
    dev = resolve_device(device)
    n = flush_every * capacity
    zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=dev)
    return DeferredDispatch(buf=zeros((n, n_features), torch.float32),
                            lane=zeros((n,), torch.int32),
                            window=zeros((n,), torch.int32),
                            valid=zeros((n,), torch.bool))


def defer_window(dd: DeferredDispatch, buf: torch.Tensor, idx: torch.Tensor,
                 valid: torch.Tensor, pos) -> DeferredDispatch:
    """Write one window's dispatched rows at pending-cycle slot ``pos``.

    ``buf``/``idx``/``valid`` are ``dispatch``'s outputs for the window;
    slot ``pos`` occupies rows ``[pos*cap, (pos+1)*cap)``, cap the rows
    ``dispatch`` gave. ``pos`` is a 0-dim integer tensor on ``dd``'s
    device (the reference traces it, so stepping through the cycle never
    recompiles; here a CUDA graph reads it from its buffer on every
    replay), or a Python int from a CPU caller. The row index is computed
    on the device and every field of ``dd`` is written in place with
    ``index_copy_``. Returns ``dd``.
    """
    cap = idx.shape[0]
    dev = dd.buf.device
    pos = torch.as_tensor(pos, device=dev).reshape(())
    rows = pos.long() * cap + torch.arange(cap, device=dev)
    dd.buf.index_copy_(0, rows, buf)
    dd.lane.index_copy_(0, rows, idx.to(torch.int32))
    dd.window.index_copy_(0, rows, pos.to(torch.int32).expand(cap))
    dd.valid.index_copy_(0, rows, valid)
    return dd


def zero_deferred_(dd: DeferredDispatch) -> DeferredDispatch:
    """Empty ``dd`` in place (every slot dead, as ``init_deferred`` makes
    it), so a captured flush keeps reading the same buffers. Returns
    ``dd``."""
    for t in (dd.buf, dd.lane, dd.window, dd.valid):
        t.zero_()
    return dd


def chunk_dispatch(xs: torch.Tensor, fwd: torch.Tensor,
                   capacity: int) -> DeferredDispatch:
    """``dispatch`` over every window of a chunk at once.

    xs (K, W, F) feature rows, fwd (K, W) forward masks -> one
    ``DeferredDispatch`` covering the chunk: each window capacity-bounded
    exactly as the per-window path bounds it (a stable argsort along the
    lane axis, forwarded lanes first in lane order), the return addresses
    laid out row-major, so slot ``k*capacity + i`` is window k's i-th
    dispatched row.
    """
    k, w, f = xs.shape
    order = torch.argsort((~fwd).to(torch.int32), dim=1, stable=True)
    idx = order[:, :capacity]                               # (K, cap)
    cap = idx.shape[1]
    buf = torch.gather(xs, 1, idx[:, :, None].expand(k, cap, f))
    return DeferredDispatch(
        buf=buf.reshape(k * cap, f),
        lane=idx.reshape(-1).to(torch.int32),
        window=torch.arange(k, dtype=torch.int32,
                            device=xs.device).repeat_interleave(cap),
        valid=torch.gather(fwd, 1, idx).reshape(-1))


def backpatch_pending(pending: torch.Tensor, backend_pred: torch.Tensor,
                      dd: DeferredDispatch) -> torch.Tensor:
    """Scatter the backend's answers into the pending predictions.

    ``pending`` (P, W) holds each pending window's switch answers; every
    live slot overwrites its (window, lane) address with the backend's
    answer. Dead slots write into a scratch row past the P pending rows,
    which is dropped (the reference's ``mode="drop"``), so a partly filled
    buffer patches exactly its live rows. Live addresses are unique, so the
    scatter is deterministic. Returns a new tensor.
    """
    p, w = pending.shape
    out = torch.cat([pending, pending.new_empty((1, w))])
    row = torch.where(dd.valid, dd.window, p).long()
    out[row, dd.lane.long()] = backend_pred.to(pending.dtype)
    return out[:p]


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
