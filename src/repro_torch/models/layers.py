"""Shared neural building blocks (norms, rope, MLPs, init).

Port of ``repro/models/layers.py``. Weights are drawn from an explicit
``torch.Generator`` on an explicit device; the draws differ from
``jax.random`` for the same seed, so parity with the reference goes through
``models.model.params_from_arrays``. The whisper-only ``gelu_mlp`` and
``sinusoidal_positions`` wait for the whisper slice.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import mean

F32 = torch.float32


def dense_init(gen, shape, scale=None, *, device, lead=()):
    """Truncated-normal fan-in init in [-2, 2] x std, fp32 master weights.

    ``lead`` prepends stacked dims (the period axis of a scanned segment);
    fan-in is read from ``shape`` alone, as the reference's vmapped init
    reads it per layer. On the ``meta`` device nothing is drawn."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    std = scale if scale is not None else float(1.0 / np.sqrt(fan_in))
    out = torch.empty(tuple(lead) + tuple(shape), dtype=F32, device=device)
    if out.device.type == "meta":
        return out
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return out.mul_(std)


def rmsnorm(x, w, eps=1e-6):
    """``jnp.mean`` is jitted: the mean is the sum times float32(1/count)
    (``device.mean``), as the reference computes it."""
    xf = x.to(F32)
    var = mean(xf * xf, dim=-1).unsqueeze(-1)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x, w, b, eps=1e-5):
    xf = x.to(F32)
    mu = mean(xf, dim=-1).unsqueeze(-1)
    d = xf - mu
    var = mean(d * d, dim=-1).unsqueeze(-1)
    return ((d * torch.rsqrt(var + eps)).to(x.dtype) * w + b)


def apply_norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["w"])
    return layernorm(x, p["w"], p["b"])


def norm_params(cfg, d, *, device, lead=()):
    shape = tuple(lead) + (d,)
    if cfg.norm == "rmsnorm":
        return {"w": torch.ones(shape, dtype=F32, device=device)}
    return {"w": torch.ones(shape, dtype=F32, device=device),
            "b": torch.zeros(shape, dtype=F32, device=device)}


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(dim, theta, device=None):
    exps = torch.arange(0, dim, 2, dtype=F32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta=10000.0):
    """x (..., S, H, hd), positions (..., S) -> same shape, rotated."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., :, None].to(F32) * freqs        # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# feed-forward
# ---------------------------------------------------------------------------

def swiglu_params(gen, d_model, d_ff, *, device, lead=()):
    return {"gate": dense_init(gen, (d_model, d_ff), device=device, lead=lead),
            "up": dense_init(gen, (d_model, d_ff), device=device, lead=lead),
            "down": dense_init(gen, (d_ff, d_model), device=device, lead=lead)}


def swiglu(p, x):
    h = F.silu(x @ p["gate"]) * (x @ p["up"])
    return h @ p["down"]
