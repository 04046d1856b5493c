"""Shared neural building blocks (norms, rope, MLPs, init).

Port of ``repro/models/layers.py``. Weights are drawn from an explicit
``torch.Generator`` on an explicit device; the draws differ from
``jax.random`` for the same seed, so parity with the reference goes through
``models.model.params_from_arrays``. ``gelu`` is ``jax.nn.gelu``'s default,
the tanh approximation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import mean
from repro_torch.distributed.sharding import dense

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


def as_position(pos, device) -> torch.Tensor:
    """A decode position as a 0-dim int64 tensor on ``device``: a tensor is
    taken as it is (on its own device, no copy), an int is written there by
    a fill, never copied from the host. The decode step computes its slot,
    its cache writes and its mask from it on the device, so a CUDA graph
    can replay the step at any position."""
    if isinstance(pos, torch.Tensor):
        return pos.to(dtype=torch.int64)
    return torch.full((), pos, dtype=torch.int64, device=device)


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
    h = F.silu(dense(x, p["gate"])) * dense(x, p["up"])
    return dense(h, p["down"])


def gelu(x):
    """``jax.nn.gelu`` (approximate=True by default): the tanh form."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp_params(gen, d_model, d_ff, *, device, lead=()):
    lead = tuple(lead)
    return {"up": dense_init(gen, (d_model, d_ff), device=device, lead=lead),
            "up_b": torch.zeros(lead + (d_ff,), dtype=F32, device=device),
            "down": dense_init(gen, (d_ff, d_model), device=device,
                               lead=lead),
            "down_b": torch.zeros(lead + (d_model,), dtype=F32,
                                  device=device)}


def gelu_mlp(p, x):
    return dense(gelu(dense(x, p["up"]) + p["up_b"]), p["down"]) + p["down_b"]


def sinusoidal_positions(n_pos, dim, device=None):
    """(n_pos, dim) f32: sines then cosines of pos / 10000^(2i/dim), made in
    float64 numpy and rounded once, as the reference makes them."""
    pos = np.arange(n_pos)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=1)
    return torch.from_numpy(out.astype(np.float32)).to(device)
