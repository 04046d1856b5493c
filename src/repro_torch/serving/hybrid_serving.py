"""Hybrid serving tier: the paper's §2.2.1 deployment, end to end.

Port of ``repro/serving/hybrid_serving.py``. Request path:
  1. feature extraction produced a feature vector per request;
  2. the SWITCH TIER — the fused IIsy table pipeline (the CUDA kernel on the
     card) — classifies the whole batch and yields (class, confidence);
  3. confidence >= tau  -> answered at the switch;
  4. confidence <  tau  -> the low-confidence subset is compacted into a
     fixed-capacity buffer and only that buffer hits the BACKEND, so the
     expensive model runs on capacity-many rows, not on the full batch.

``classify`` enqueues its work on the current CUDA stream and never waits
on the device: telemetry comes back in a lazy ``HybridStats`` holding
device tensors, and only reading a statistic (or the predictions)
synchronizes.

The reference's ``fuse``, ``donate`` and ``autotune`` arguments steer
``jax.jit`` (single-dispatch tracing, buffer donation, a tile sweep over
jitted candidates) and have no meaning in eager PyTorch, so they are left
out; the backend is simply called between the switch half and the combine.
The reference defaults to ``use_pallas=False`` (its XLA gather path); this
server defaults to the kernel for CUDA tensors — bit-identical by contract.
"""

from __future__ import annotations

from typing import Callable, Optional

import dataclasses

import torch

from repro_torch.core.artifact import TableArtifact, finalize_artifact
from repro_torch.core.hybrid import combine, dispatch
from repro_torch.device import mean, resolve_device
from repro_torch.kernels.ops import fused_classify
from repro_torch.kernels.tuning import DEFAULT_TILES, TileConfig


class HybridStats:
    """Per-batch telemetry holding device tensors; converts lazily.

    Reading .fraction_handled / .backend_rows is the only point that
    blocks on the device — constructing or returning HybridStats never does.
    """

    __slots__ = ("_fraction_handled", "_backend_rows", "capacity")

    def __init__(self, fraction_handled, backend_rows, capacity: int):
        self._fraction_handled = fraction_handled
        self._backend_rows = backend_rows
        self.capacity = capacity

    @property
    def fraction_handled(self) -> float:
        return float(self._fraction_handled)

    @property
    def backend_rows(self) -> int:
        return int(self._backend_rows)

    def as_tensors(self):
        """(fraction_handled, backend_rows) as device tensors — no sync."""
        return self._fraction_handled, self._backend_rows

    def __repr__(self):
        return (f"HybridStats(fraction_handled={self.fraction_handled:.3f}, "
                f"backend_rows={self.backend_rows}, "
                f"capacity={self.capacity})")


class HybridServer:
    def __init__(self, artifact: TableArtifact, backend_fn: Callable, *,
                 threshold: float = 0.7, capacity: int = 256,
                 use_kernel: Optional[bool] = None,
                 tiles: Optional[TileConfig] = None, device=None):
        """backend_fn: (rows (capacity, F) tensor) -> class predictions
        (capacity,), on the server's device.

        device=None serves on CUDA and raises without a card; pass
        device="cpu" for the plain path. use_kernel=None means "the kernel
        for CUDA tensors"; False runs the plain gather version on the
        server's device (``TileConfig(impl='ref')``); True on the CPU is an
        error, since the kernel exists only on the card.
        """
        self.device = resolve_device(device)
        if use_kernel and self.device.type != "cuda":
            raise ValueError("use_kernel=True needs a CUDA device")
        self.artifact = finalize_artifact(artifact).to(self.device)
        self._backend_fn = backend_fn
        self._capacity = capacity
        self.threshold = threshold
        self.use_kernel = use_kernel
        tiles = tiles or DEFAULT_TILES
        if use_kernel is False:
            tiles = dataclasses.replace(tiles, impl="ref")
        self.tiles = tiles

    @property
    def capacity(self) -> int:
        """Backend buffer size: the backend always sees this many rows."""
        return self._capacity

    @property
    def backend_fn(self):
        return self._backend_fn

    def classify(self, x):
        """x (N, F) -> (pred (N,), HybridStats). Nothing here waits on the
        device when x is already a tensor on it; read the stats (or the
        preds) to sync."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        sw_pred, conf = fused_classify(self.artifact, x, tiles=self.tiles,
                                       device=self.device)
        fwd = conf < self.threshold
        buf, idx, valid = dispatch(x, fwd, self._capacity)
        be_pred = torch.as_tensor(self._backend_fn(buf), device=self.device)
        pred = combine(sw_pred, be_pred, idx, valid)
        frac = 1.0 - mean(fwd.to(torch.float32))
        rows = valid.to(torch.int32).sum()
        return pred, HybridStats(frac, rows, self._capacity)

    def update_tables(self, artifact: TableArtifact):
        """§4.4: retraining swaps table *contents*; the shapes (the model
        constraints) must stay as they are."""
        artifact = finalize_artifact(artifact)
        if artifact.shape_signature() != self.artifact.shape_signature():
            raise ValueError("table shapes changed: constraints violated "
                             "(paper §4.4 requires fixed model constraints)")
        self.artifact = artifact.to(self.device)
