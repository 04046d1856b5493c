"""Gradient compression for the DP all-reduce, with error feedback.

Port of ``repro/training/grad_compress.py``. Two schemes, composable with
any optimizer because they sit *between* per-shard gradient computation
and the cross-replica reduction:

  * top-k sparsification: keep the largest-|g| fraction per tensor (every
    element tied with the k-th largest too); the residual is carried to the
    next step (error feedback, a la Deep Gradient Compression) so nothing
    is lost, only delayed.
  * int8 block quantization: per-block absmax scales; the quantization
    error likewise enters the feedback buffer.

The reference runs both inside its jitted train step, where XLA turns the
int8 scale's division by 127 into a product with the f32 reciprocal (ROADMAP
C3) and fuses the residual ``acc - q * scale`` into one multiply-add; the
port does both (``addcmul``), so on the CPU it equals the jitted
reference bit for bit (CUDA's ``addcmul`` rounds the product first, one
rounding of ``q * scale`` in the residual). Leaves go in
``jax.tree.flatten``'s order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.transformer import tree_map
from repro_torch.training.optim import tree_leaves, tree_unflatten

F32 = torch.float32
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def init_error_state(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)


def _topk_mask(x, frac):
    k = max(1, int(x.numel() * frac))
    flat = torch.abs(x.reshape(-1))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh).to(F32)


def _per_leaf(one, grads, err):
    outs = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def topk_compress(grads, err, *, frac=0.05):
    """-> (sparse grads to reduce, new error state)."""
    def one(g, e):
        acc = g.to(F32) + e
        sent = acc * _topk_mask(acc, frac)
        return sent, acc - sent

    return _per_leaf(one, grads, err)


def int8_compress(grads, err, *, block=256):
    """Quantize (g + err) to int8 blocks; returns (dequantized-to-send,
    new error). The dequantized value is what the all-reduce sees; the
    wire format would be the int8 payload + per-block scales."""
    def one(g, e):
        acc = g.to(F32) + e
        flat = acc.reshape(-1)
        pad = (-flat.numel()) % block
        fp = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
        scale = torch.amax(torch.abs(fp), dim=1, keepdim=True) * _INV_127
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(fp / scale), -127, 127)
        n = flat.numel()
        deq = (q * scale).reshape(-1)[:n].reshape(acc.shape)
        err = torch.addcmul(fp, q, scale, value=-1)     # acc - q * scale
        return deq, err.reshape(-1)[:n].reshape(acc.shape)

    return _per_leaf(one, grads, err)


def compressed_bytes(params, scheme: str, *, frac=0.05, block=256) -> int:
    """Wire bytes per DP all-reduce under each scheme."""
    n = sum(math.prod(getattr(l, "shape", l)) for l in tree_leaves(params))
    if scheme == "none":
        return 4 * n
    if scheme == "int8":
        return n + 4 * (n // block)        # payload + scales
    if scheme == "topk":
        k = int(n * frac)
        return k * (4 + 4)                 # value + index
    raise ValueError(scheme)
