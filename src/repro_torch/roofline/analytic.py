"""Exact analytic FLOPs / HBM-bytes per (arch x shape) cell.

Port of ``repro/roofline/analytic.py``, the same arithmetic over the
port's ``layer_plan`` / ``_layer_spec`` and ``launch.shapes.SHAPES``; the
decode cache's bytes come from the port's cache tree on ``meta``. The
dry run also counts each device's FLOPs as its step runs
(``launch.dryrun``); this closed form is the model the roofline reads,
as in the reference.

Counting conventions:
  * matmul flops = 2*M*N*K; backward = 2x forward; full remat adds +1x
    forward recompute (policy 'full') -> train multiplier 3 (+1 embed-
    free forward under remat) vs no-remat 3.
  * attention: blockwise/causal scores+AV counted exactly:
    full causal ~ S^2 (masked half still computed in dense blocks ->
    count full S*S per the kernel's actual work), windowed ~ S*W.
  * HBM bytes: params touched (fwd + bwd re-gather + optimizer state
    read/write for train), activations streamed once per op in/out at
    dtype width, KV/state caches read+write per decode step.
    This is a lower-bound streaming model — fusion-dependent temporaries
    are excluded, so the memory term is optimistic-but-consistent.
"""

from __future__ import annotations

import math

from repro_torch.launch.shapes import SHAPES
from repro_torch.models.transformer import _layer_spec

BF16 = 2
F32 = 4


def _attn_flops(cfg, s_q, s_kv, batch, window=None):
    """Scores + AV for one layer."""
    h = cfg.n_heads
    hd = cfg.head_dim
    if cfg.attn_kind == "mla":
        m = cfg.mla
        qk = m.qk_nope_dim + m.qk_rope_dim
        vd = m.v_head_dim
    else:
        qk = vd = hd
    kv_eff = min(s_kv, window) if window else s_kv
    return 2.0 * batch * h * s_q * kv_eff * (qk + vd)


def _proj_flops(cfg, spec, tokens):
    """QKV/out + FFN projections for one layer, per token batch."""
    d = cfg.d_model
    block, ffn = spec
    fl = 0.0
    if block in ("attn", "local_attn"):
        h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        fl += 2.0 * tokens * d * (h * hd + 2 * g * hd + h * hd)
    elif block == "mla":
        m = cfg.mla
        h = cfg.n_heads
        fl += 2.0 * tokens * (
            d * m.q_lora_rank
            + m.q_lora_rank * h * (m.qk_nope_dim + m.qk_rope_dim)
            + d * (m.kv_lora_rank + m.qk_rope_dim)
            + m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
            + h * m.v_head_dim * d)
    elif block == "rglru":
        w = cfg.rglru_width or d
        fl += 2.0 * tokens * (2 * d * w + 2 * w * w + w * d)
    elif block == "mlstm":
        w = 2 * d
        hd = w // cfg.n_heads
        fl += 2.0 * tokens * (2 * d * w + 3 * w * hd + w * d)
        fl += 2.0 * tokens * cfg.n_heads * hd * hd * 2   # C update + read
    elif block == "slstm":
        fl += 2.0 * tokens * (d * 4 * d + d * 4 * (d // cfg.n_heads))
        fl += 2.0 * tokens * (2 * d * int(d * 4 / 3) + int(d * 4 / 3) * d)

    if ffn == "dense":
        fl += 2.0 * tokens * 3 * d * cfg.d_ff
    elif ffn == "moe":
        m = cfg.moe
        fl += 2.0 * tokens * d * m.n_experts              # router
        fl += 2.0 * tokens * m.top_k * m.capacity_factor * 3 * d * m.d_expert
        if m.n_shared:
            fl += 2.0 * tokens * 3 * d * m.d_expert * m.n_shared
        if m.dense_residual:
            fl += 2.0 * tokens * 3 * d * m.dense_d_ff
    return fl


def _param_bytes(cfg, n_params, dtype=F32):
    return n_params * dtype


def forward_flops(cfg, seq_len, batch, *, kv_len=None, decode=False):
    """One forward pass (all layers + head)."""
    tokens = batch * (1 if decode else seq_len)
    s_q = 1 if decode else seq_len
    s_kv = kv_len if kv_len is not None else seq_len
    total = 0.0
    for i in range(cfg.n_layers):
        spec = _layer_spec(cfg, i)
        total += _proj_flops(cfg, spec, tokens)
        block = spec[0]
        if block in ("attn", "local_attn", "mla"):
            window = (cfg.local_window if block == "local_attn"
                      else cfg.sliding_window)
            total += _attn_flops(cfg, s_q, s_kv, batch, window)
    if cfg.encdec:
        if not decode:
            # encoder + per-decoder-layer cross-KV projection (prefill only;
            # decode reuses the cached encoder states and cross-KV)
            enc_t = batch * cfg.n_frontend_tokens
            for _ in range(cfg.n_encoder_layers):
                total += 2.0 * enc_t * 4 * cfg.d_model * cfg.d_model
                total += 2.0 * enc_t * 2 * cfg.d_model * cfg.d_ff
                total += _attn_flops(cfg, cfg.n_frontend_tokens,
                                     cfg.n_frontend_tokens, batch)
            total += cfg.n_layers * (
                2.0 * batch * cfg.n_frontend_tokens * 2 * cfg.d_model ** 2)
        # cross-attention scores/AV every step
        total += cfg.n_layers * _attn_flops(cfg, s_q,
                                            cfg.n_frontend_tokens, batch)
    total += 2.0 * tokens * cfg.d_model * cfg.vocab_size     # head
    return total


def cell_flops_per_device(cfg, shape_name, n_chips, *, remat=True):
    spec = SHAPES[shape_name]
    b, s = spec["global_batch"], spec["seq_len"]
    if spec["kind"] == "train":
        f = forward_flops(cfg, s, b)
        mult = 3.0 + (1.0 if remat else 0.0)     # fwd + 2x bwd (+ remat)
        if cfg.mtp:
            f *= 1.0 + 1.0 / max(cfg.n_layers, 1)
        return f * mult / n_chips
    if spec["kind"] == "prefill":
        return forward_flops(cfg, s, b) / n_chips
    return forward_flops(cfg, s, b, kv_len=s, decode=True) / n_chips


def cell_hbm_bytes_per_device(cfg, shape_name, n_chips, n_params,
                              cache_bytes_total=0, *, remat=True,
                              model_shards=16):
    """Streaming lower bound: weights + activations + caches + opt state.

    Weight *compute* reads divide by the TP (model) axis only: after the
    FSDP all-gather each device holds and reads 1/model_shards of every
    layer. Optimizer-state traffic stays fully sharded (1/n_chips).
    Activations/caches are batch(+seq)-sharded: 1/n_chips.
    """
    spec = SHAPES[shape_name]
    return step_hbm_bytes(cfg, spec["kind"], spec["seq_len"],
                          spec["global_batch"], n_chips, n_params,
                          cache_bytes_total, remat=remat,
                          model_shards=model_shards)


def step_hbm_bytes(cfg, kind, seq_len, batch, n_chips, n_params,
                   cache_bytes_total=0, *, remat=True, model_shards=16):
    """``cell_hbm_bytes_per_device`` at any batch and length (a step the
    card runs whole: n_chips = model_shards = 1)."""
    b, s = batch, seq_len
    d = cfg.d_model
    if kind == "train":
        tokens = b * s
        # fwd + bwd weight reads (+ remat re-read) happen post-gather
        reads = 2 + (1 if remat else 0)
        w_compute = n_params * F32 * reads / model_shards
        # grads write + adam m/v read+write + param read/write: sharded
        w_opt = n_params * (F32 + 4 * F32 + 2 * F32) / n_chips
        # activations: ~14 streams/layer of (tokens, d) at bf16 + logits f32
        act = tokens * d * BF16 * 14 * cfg.n_layers / n_chips
        logits = tokens * cfg.vocab_size * F32 * 2 / n_chips
        return w_compute + w_opt + act + logits
    if kind == "prefill":
        tokens = b * s
        w = n_params * BF16 / model_shards
        act = tokens * d * BF16 * 10 * cfg.n_layers / n_chips
        return w + act
    # decode: weights + full cache read + one slot write
    w = n_params * BF16 / model_shards
    return w + cache_bytes_total / n_chips


def decode_cache_bytes(cfg, shape_name, *, int8_kv=False):
    """Total decode-cache bytes for the cell, from the real shapes (the
    cache tree on ``meta``, nothing allocated)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.transformer import tree_leaves
    spec = SHAPES[shape_name]
    shapes = M.init_decode_cache(
        cfg, spec["global_batch"], spec["seq_len"], dtype=torch.bfloat16,
        quantize_kv=int8_kv, device="meta")
    return sum(math.prod(l.shape) * l.dtype.itemsize
               for l in tree_leaves(shapes))
