"""Shared neural building blocks (norms, rope, MLPs, init).

Port of ``repro/models/layers.py``. Weights are drawn from an explicit
``torch.Generator`` on an explicit device; the draws differ from
``jax.random`` for the same seed, so parity with the reference goes through
``models.model.params_from_arrays``. ``gelu`` is ``jax.nn.gelu``'s default,
the tanh approximation.
"""

from __future__ import annotations

import hashlib
import math

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


def derive_seed(seed: int, *parts) -> int:
    """A 63-bit seed for the tensor named by ``parts`` (layer, name,
    expert...) of a model drawn from ``seed``: the first 8 bytes of the
    SHA-256 of ``"seed/part/part..."``, little-endian."""
    key = "/".join(str(x) for x in (int(seed),) + tuple(parts)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8],
                          "little") & ((1 << 63) - 1)


def seeded_normal(seed: int, parts, shape, std: float, device):
    """(shape) float32 N(0, std^2) on ``device`` from its own generator,
    seeded ``derive_seed(seed, *parts)``: any one tensor of a model can be
    drawn again alone, on the same device, bit for bit."""
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, *parts))
    out = torch.randn(tuple(shape), generator=gen, device=device,
                      dtype=F32)
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

def yarn_mscale(factor: float, m: float) -> float:
    """YaRN's attention factor ``0.1 m ln(factor) + 1`` (1 at factor <= 1)."""
    return 0.1 * m * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_softmax_scale(scaling) -> float:
    """What YaRN multiplies an attention's softmax scale by: the square of
    ``yarn_mscale(factor, mscale_all_dim)``; 1 without scaling."""
    if scaling is None:
        return 1.0
    return yarn_mscale(scaling.factor, scaling.mscale_all_dim) ** 2


def _yarn_dim(rotations, dim, theta, max_pos):
    """The rotary dimension whose frequency turns ``rotations`` times over
    ``max_pos`` positions."""
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))
            / (2 * math.log(theta)))


def rope_freqs(dim, theta, device=None, scaling=None):
    """(dim/2,) f32 inverse frequencies; with ``scaling`` (a ``YarnConfig``)
    YaRN's: divided by the factor below the ramp, kept above it."""
    exps = torch.arange(0, dim, 2, dtype=F32, device=device) / dim
    freqs = 1.0 / (theta ** exps)
    if scaling is None:
        return freqs
    n = scaling.original_max_position
    low = max(math.floor(_yarn_dim(scaling.beta_fast, dim, theta, n)), 0)
    high = min(math.ceil(_yarn_dim(scaling.beta_slow, dim, theta, n)),
               dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=F32, device=device) - low)
            / max(high - low, 1e-3)).clamp(0.0, 1.0)
    keep = 1.0 - ramp
    return freqs / scaling.factor * (1.0 - keep) + freqs * keep


def apply_rope(x, positions, theta=10000.0, scaling=None):
    """x (..., S, H, hd), positions (..., S) -> same shape, rotated (the
    two halves of the head dim as the pairs; YaRN with ``scaling``)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device, scaling)        # (hd/2,)
    angles = positions[..., :, None].to(F32) * freqs        # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    if scaling is not None:
        m = (yarn_mscale(scaling.factor, scaling.mscale)
             / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
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
