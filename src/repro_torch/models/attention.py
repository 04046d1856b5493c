"""GQA attention (+qk-norm, +bias, +sliding window), blockwise "flash"
attention for long prefill, and the decode step over a float or int8 KV
cache.

Port of the GQA part of ``repro/models/attention.py``. Shapes: hidden
(B, S, D); per-head tensors (B, S, H, hd). The decode step updates the
cache dict IN PLACE (the reference's caches are functional and its engine
donates them; copying a 20 GB cache per step is not an option) and returns
it. Over an int8 cache the attention core runs through the B8 kernel
(``kernels.ops.decode_attention_int8``) on the card. MLA and
cross-attention wait for their slices; ``hint_batch_heads`` (a sharding
hint, a no-op without a mesh) is dropped.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import true_div
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, rmsnorm

F32 = torch.float32
MASKED = -1e30          # the reference's masked score


def _inv_sqrt(n) -> float:
    """float32(1 / sqrt(float32(n))), the reference's ``1.0 / jnp.sqrt(n)``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


# ---------------------------------------------------------------------------
# parameter builders
# ---------------------------------------------------------------------------

def gqa_params(gen, cfg, *, device, lead=()):
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(device=device, lead=lead)
    p = {"wq": dense_init(gen, (d, h * hd), **kw),
         "wk": dense_init(gen, (d, g * hd), **kw),
         "wv": dense_init(gen, (d, g * hd), **kw),
         "wo": dense_init(gen, (h * hd, d), **kw)}
    lead = tuple(lead)
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (h * hd,), dtype=F32, device=device)
        p["bk"] = torch.zeros(lead + (g * hd,), dtype=F32, device=device)
        p["bv"] = torch.zeros(lead + (g * hd,), dtype=F32, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(lead + (hd,), dtype=F32, device=device)
        p["k_norm"] = torch.ones(lead + (hd,), dtype=F32, device=device)
    return p


# ---------------------------------------------------------------------------
# QKV projection (GQA)
# ---------------------------------------------------------------------------

def _project_qkv(p, cfg, x, positions):
    b, s, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, g, hd)
    v = v.reshape(b, s, g, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, scale):
    """q (B,Sq,H,hd), k/v (B,Sk,G,hd) grouped attention with bool mask."""
    b, sq, h, hd = q.shape
    g = k.shape[2]
    q = q.reshape(b, sq, g, h // g, hd)
    scores = torch.einsum("bqgmd,bkgd->bgmqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, MASKED)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bgmqk,bkgd->bqgmd", w, v)
    return out.reshape(b, sq, h, hd)


def causal_mask(sq, sk, window=None, offset=0, device=None):
    """(1, Sq, Sk) bool. offset = number of kv positions before q[0]."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(sk, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m = m & (qi - ki < window)
    return m[None]


def gqa_forward(p, cfg, x, positions, *, window=None, bidirectional=False):
    """Full-sequence attention (training / short prefill)."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    s = x.shape[1]
    mask = None if bidirectional else causal_mask(s, s, window,
                                                  device=x.device)
    out = _sdpa(q, k, v, mask, _inv_sqrt(cfg.head_dim))
    return out.reshape(x.shape[0], s, -1) @ p["wo"], (k, v)


# ---------------------------------------------------------------------------
# blockwise online-softmax attention (long prefill; O(S * block) memory)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, window=None, q_block=1024, k_block=1024,
                    scale=None):
    """Causal grouped attention via online softmax. q (B,S,H,hd).

    Plain torch loops over query and key blocks, in the reference's order
    (its ``lax.map`` over query blocks of a ``lax.scan`` over every key
    block, causally masked ones included). Sequences are padded internally
    to block multiples: padded KV columns sit at positions > any real query
    (causally masked out); padded query rows are sliced off. v's head dim
    may differ from q/k's.
    """
    b, s_orig, h, hd = q.shape
    g = k.shape[2]
    hd_v = v.shape[-1]
    scale = scale if scale is not None else _inv_sqrt(hd)
    q_block = min(q_block, s_orig)
    k_block = min(k_block, s_orig)
    pad = (-s_orig) % q_block
    if q_block != k_block:
        lcm = (q_block * k_block) // math.gcd(q_block, k_block)
        pad = (-s_orig) % lcm
    if pad:
        def padder(a):
            return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        q, k, v = padder(q), padder(k), padder(v)
    s = s_orig + pad
    nq = s // q_block
    nk = s // k_block
    dev = q.device
    outs = []
    for qi in range(nq):
        q_i = q[:, qi * q_block:(qi + 1) * q_block].reshape(
            b, q_block, g, h // g, hd)
        m_run = torch.full((b, g, h // g, q_block), MASKED, dtype=F32,
                           device=dev)
        l_run = torch.zeros((b, g, h // g, q_block), dtype=F32, device=dev)
        acc = torch.zeros((b, g, h // g, q_block, hd_v), dtype=F32,
                          device=dev)
        qpos = qi * q_block + torch.arange(q_block, device=dev)[:, None]
        for ki in range(nk):
            k_i = k[:, ki * k_block:(ki + 1) * k_block]
            v_i = v[:, ki * k_block:(ki + 1) * k_block]
            sc = torch.einsum("bqgmd,bkgd->bgmqk", q_i, k_i) * scale
            kpos = ki * k_block + torch.arange(k_block, device=dev)[None, :]
            msk = kpos <= qpos
            if window is not None:
                msk = msk & (qpos - kpos < window)
            sc = torch.where(msk[None, None, None], sc, MASKED)
            m_new = torch.maximum(m_run, sc.amax(-1))
            alpha = torch.exp(m_run - m_new)
            pexp = torch.exp(sc - m_new[..., None])
            l_run = l_run * alpha + pexp.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgmqk,bkgd->bgmqd", pexp, v_i.to(F32))
            m_run = m_new
        out = acc / torch.clamp(l_run[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(b, q_block, h, hd_v))
    out = torch.cat(outs, dim=1).to(q.dtype)
    return out[:, :s_orig]


def gqa_prefill(p, cfg, x, positions, *, window=None, flash=True):
    """Long prefill: blockwise attention, returns output and (k, v) cache."""
    q, k, v = _project_qkv(p, cfg, x, positions)
    if flash:
        out = flash_attention(q, k, v, window=window)
    else:
        s = x.shape[1]
        out = _sdpa(q, k, v, causal_mask(s, s, window, device=x.device),
                    _inv_sqrt(cfg.head_dim))
    return out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"], (k, v)


# ---------------------------------------------------------------------------
# decode (single token) with KV caches
# ---------------------------------------------------------------------------

def init_gqa_cache(cfg, batch, max_len, dtype=torch.bfloat16, window=None,
                   quantized=False, *, device):
    """quantized=True stores K/V as int8 with a per-(slot, head) fp32
    absmax scale — the paper's "action data bits" knob applied to the
    serving backend's KV memory (halves cache HBM reads vs bf16)."""
    size = min(max_len, window) if window else max_len
    g, hd = cfg.n_kv_heads, cfg.head_dim
    kv_dtype = torch.int8 if quantized else dtype
    c = {"k": torch.zeros((batch, size, g, hd), dtype=kv_dtype, device=device),
         "v": torch.zeros((batch, size, g, hd), dtype=kv_dtype, device=device),
         "pos": torch.full((size,), -1, dtype=torch.int32, device=device)}
    if quantized:
        c["k_scale"] = torch.zeros((batch, size, g, 1), dtype=F32,
                                   device=device)
        c["v_scale"] = torch.zeros((batch, size, g, 1), dtype=F32,
                                   device=device)
    return c


def _q8(v):
    """Symmetric int8 quantize along the last dim. -> (q, scale).

    The scale is a true division by 127, as eager JAX computes it; under
    ``jit`` or ``scan`` XLA may multiply by float32(1/127) instead, one ulp
    apart (``device.true_div``)."""
    vf = v.to(F32)
    s = vf.abs().amax(dim=-1, keepdim=True)
    s = true_div(s, 127.0)
    s = torch.clamp(s, min=1e-8)
    return torch.round(vf / s).to(torch.int8), s


def gqa_decode(p, cfg, x, pos: int, cache, *, window=None):
    """x (B, 1, D), pos an int. Writes the new K/V into ``cache`` in place
    and returns (out (B,1,D), cache)."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, cfg, x, positions)
    size = cache["k"].shape[1]
    slot = pos % size if window else pos
    quantized = "k_scale" in cache
    if quantized:
        k_q, k_s = _q8(k)
        v_q, v_s = _q8(v)
        cache["k"][:, slot] = k_q[:, 0]
        cache["v"][:, slot] = v_q[:, 0]
        cache["k_scale"][:, slot] = k_s[:, 0]
        cache["v_scale"][:, slot] = v_s[:, 0]
    else:
        cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cpos = cache["pos"]
    cpos[slot] = pos
    valid = (cpos >= 0) & (cpos <= pos)
    if window is not None:
        valid = valid & (pos - cpos < window)
    g, hd = cfg.n_kv_heads, cfg.head_dim
    h = cfg.n_heads
    qh = q.reshape(b, g, h // g, hd)
    scale = _inv_sqrt(hd)
    if quantized:
        live = valid.to(F32)[None, :].expand(b, size)
        out = ops.decode_attention_int8(
            qh.to(F32).contiguous(), cache["k"], cache["k_scale"],
            cache["v"], cache["v_scale"], live, scale=scale)
    else:
        k_eff, v_eff = cache["k"].to(F32), cache["v"].to(F32)
        scores = torch.einsum("bgmd,bkgd->bgmk", qh, k_eff) * scale
        scores = torch.where(valid[None, None, None, :], scores, MASKED)
        w = torch.softmax(scores, dim=-1)
        out = torch.einsum("bgmk,bkgd->bgmd", w, v_eff)
    out = out.reshape(b, 1, h * hd).to(x.dtype) @ p["wo"]
    return out, cache
