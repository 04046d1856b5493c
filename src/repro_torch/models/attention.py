"""Attention variants: GQA (+qk-norm, +bias, +sliding window), blockwise
"flash" attention for long prefill, MLA (DeepSeek latent attention) with a
naive and an *absorbed* decode path, and cross-attention for enc-dec.

Port of ``repro/models/attention.py``. Shapes: hidden (B, S, D); per-head
tensors (B, S, H, hd). A decode step updates its cache dict IN PLACE (the
reference's caches are functional and its engine donates them; copying a
20 GB cache per step is not an option) and returns it. Its position is a
0-dim device tensor (``layers.as_position``): the slot, the cache writes
(``index_copy_`` at a device index), the cache's positions and the live
mask are computed on the device, so the step has no host sync and a CUDA
graph can replay it. Over an int8 cache the attention core runs through
the B8 kernel (``kernels.ops.decode_attention_int8``) on the card.
``hint_batch_heads`` (a sharding hint, a no-op without a mesh) is dropped.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import true_div
from repro_torch.kernels import ops
from repro_torch.models.layers import (apply_rope, as_position, dense_init,
                                       rmsnorm)

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


def mla_params(gen, cfg, *, device, lead=()):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    kw = dict(device=device, lead=lead)
    lead = tuple(lead)
    return {
        "wq_a": dense_init(gen, (d, m.q_lora_rank), **kw),
        "q_norm": torch.ones(lead + (m.q_lora_rank,), dtype=F32,
                             device=device),
        "wq_b": dense_init(gen, (m.q_lora_rank,
                                 h * (m.qk_nope_dim + m.qk_rope_dim)), **kw),
        "wkv_a": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_dim), **kw),
        "kv_norm": torch.ones(lead + (m.kv_lora_rank,), dtype=F32,
                              device=device),
        "wkv_b": dense_init(gen, (m.kv_lora_rank,
                                  h * (m.qk_nope_dim + m.v_head_dim)), **kw),
        "wo": dense_init(gen, (h * m.v_head_dim, d), **kw),
    }


def cross_attn_params(gen, cfg, *, device, lead=()):
    return gqa_params(gen, cfg, device=device, lead=lead)


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


def gqa_decode(p, cfg, x, pos, cache, *, window=None):
    """x (B, 1, D), pos a 0-dim device tensor (or an int). Writes the new
    K/V into ``cache`` in place and returns (out (B,1,D), cache)."""
    b = x.shape[0]
    pos = as_position(pos, x.device)
    positions = pos.expand(b, 1)
    q, k, v = _project_qkv(p, cfg, x, positions)
    size = cache["k"].shape[1]
    slot = (pos % size if window else pos).reshape(1)
    quantized = "k_scale" in cache
    if quantized:
        k_q, k_s = _q8(k)
        v_q, v_s = _q8(v)
        cache["k"].index_copy_(1, slot, k_q)
        cache["v"].index_copy_(1, slot, v_q)
        cache["k_scale"].index_copy_(1, slot, k_s)
        cache["v_scale"].index_copy_(1, slot, v_s)
    else:
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    cpos = cache["pos"]
    cpos.index_copy_(0, slot, pos.reshape(1).to(cpos.dtype))
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2/V3 latent attention)
# ---------------------------------------------------------------------------

def _mla_q(p, cfg, x, positions):
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q = rmsnorm(x @ p["wq_a"], p["q_norm"]) @ p["wq_b"]
    q = q.reshape(b, s, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _mla_ckv(p, cfg, x, positions):
    m = cfg.mla
    kv = x @ p["wkv_a"]
    c_kv, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
    c_kv = rmsnorm(c_kv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]         # shared head
    return c_kv, k_rope


def mla_forward(p, cfg, x, positions):
    """Full-sequence MLA (prefill). Cache = (c_kv, k_rope).

    Long sequences (S >= 2048) run blockwise, as the reference's do: q/k
    are assembled as concat(nope, rope) per head (the shared rope key
    broadcast across heads) and fed through ``flash_attention``, never
    materializing the (B, H, S, S) score tensor."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _mla_q(p, cfg, x, positions)
    c_kv, k_rope = _mla_ckv(p, cfg, x, positions)
    kv = (c_kv @ p["wkv_b"]).reshape(b, s, h, m.qk_nope_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
    scale = _inv_sqrt(m.qk_nope_dim + m.qk_rope_dim)
    if s >= 2048:
        qf = torch.cat([q_nope, q_rope], dim=-1)
        kf = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, h, m.qk_rope_dim)], dim=-1)
        out = flash_attention(qf, kf, v, scale=scale)
    else:
        sc = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
              + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)) * scale
        sc = torch.where(causal_mask(s, s, device=x.device)[:, None], sc,
                         MASKED)
        w = torch.softmax(sc, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    out = out.reshape(b, s, h * m.v_head_dim) @ p["wo"]
    return out, (c_kv, k_rope)


def init_mla_cache(cfg, batch, max_len, dtype=torch.bfloat16, *, device):
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_dim),
                                  dtype=dtype, device=device)}


def mla_decode(p, cfg, x, pos, cache, *, absorb=True):
    """Single-token MLA decode over the compressed cache, written in place.

    absorb=False (naive): expand every cached latent back to per-head K/V
    each step. absorb=True: fold W_uk into the query and W_uv into the
    output, so the attention runs in the latent space and the cache is
    read once."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    pos = as_position(pos, x.device)
    positions = pos.expand(b, 1)
    q_nope, q_rope = _mla_q(p, cfg, x, positions)       # (B,1,H,*)
    c_new, r_new = _mla_ckv(p, cfg, x, positions)       # (B,1,lora),(B,1,rope)
    ckv, krp = cache["c_kv"], cache["k_rope"]
    slot = pos.reshape(1)
    ckv.index_copy_(1, slot, c_new.to(ckv.dtype))
    krp.index_copy_(1, slot, r_new.to(krp.dtype))
    s_max = ckv.shape[1]
    valid = torch.arange(s_max, device=x.device) <= pos
    scale = _inv_sqrt(m.qk_nope_dim + m.qk_rope_dim)
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, h,
                               m.qk_nope_dim + m.v_head_dim)
    w_uk = wkv_b[..., :m.qk_nope_dim]                   # (lora, H, nope)
    w_uv = wkv_b[..., m.qk_nope_dim:]                   # (lora, H, v)
    ckv_f, krp_f = ckv.to(F32), krp.to(F32)
    if absorb:
        q_abs = torch.einsum("bqhn,lhn->bqhl", q_nope, w_uk)
        sc = (torch.einsum("bqhl,bkl->bhqk", q_abs, ckv_f)
              + torch.einsum("bqhr,bkr->bhqk", q_rope, krp_f)) * scale
        sc = torch.where(valid[None, None, None, :], sc, MASKED)
        w = torch.softmax(sc, dim=-1)
        ctx = torch.einsum("bhqk,bkl->bqhl", w, ckv_f)  # latent ctx
        out = torch.einsum("bqhl,lhv->bqhv", ctx, w_uv)
    else:
        kv = torch.einsum("bkl,lhe->bkhe", ckv_f, wkv_b)
        k_nope, v = kv[..., :m.qk_nope_dim], kv[..., m.qk_nope_dim:]
        sc = (torch.einsum("bqhn,bkhn->bhqk", q_nope, k_nope)
              + torch.einsum("bqhr,bkr->bhqk", q_rope, krp_f)) * scale
        sc = torch.where(valid[None, None, None, :], sc, MASKED)
        w = torch.softmax(sc, dim=-1)
        out = torch.einsum("bhqk,bkhv->bqhv", w, v)
    out = out.reshape(b, 1, h * m.v_head_dim).to(x.dtype) @ p["wo"]
    return out, cache


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder -> encoder states)
# ---------------------------------------------------------------------------

def cross_attention(p, cfg, x, enc_kv):
    """x (B,S,D) queries; enc_kv = (k, v) precomputed from encoder output."""
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k, v = (a.to(q.dtype) for a in enc_kv)     # a bf16 cache's, promoted
    out = _sdpa(q, k, v, None, _inv_sqrt(hd))
    return out.reshape(b, s, -1) @ p["wo"]


def encode_cross_kv(p, cfg, enc_out):
    b, t, _ = enc_out.shape
    g, hd = cfg.n_kv_heads, cfg.head_dim
    k = (enc_out @ p["wk"]).reshape(b, t, g, hd)
    v = (enc_out @ p["wv"]).reshape(b, t, g, hd)
    return k, v
