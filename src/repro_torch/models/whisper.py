"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).

Port of ``repro/models/whisper.py``. The conv frontend is not modeled: the
caller gives precomputed frame embeddings (B, n_frames, d_model), the
post-conv representation. The encoder adds sinusoidal positions and runs
bidirectional attention; the decoder is causal self-attention +
cross-attention + GELU MLP (LayerNorm pre-norm, as in Whisper). As in the
reference, decoder positions use RoPE and the encoder passes position 0
(no rotation). Every layer's params are stacked on a leading layer dim;
the port loops over it where the reference scans.

The decode cache is the reference's: ``{"self": {k, v, pos} stacked over
layers, "cross": (K, V)}`` with the cross K/V a tuple of
(L, B, n_frames, G, hd) tensors. A decode step writes the self-attention
cache in place (position on the device, as ``attention.gqa_decode``) and
reads the cross K/V. ``forward_train`` is the teacher-forced decoder;
with ``remat`` each encoder and decoder layer is checkpointed, as the
reference wraps its scan bodies in ``jax.checkpoint``.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import gather_data, hint_batch
from repro_torch.models import attention as att
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import (checkpointed, embed_lookup,
                                            period_trees)
from repro_torch.models.layers import (as_position, dense_init, gelu_mlp,
                                       gelu_mlp_params, layernorm,
                                       sinusoidal_positions)

F32 = torch.float32


def _ln_params(d, *, device, lead=()):
    lead = tuple(lead)
    return {"w": torch.ones(lead + (d,), dtype=F32, device=device),
            "b": torch.zeros(lead + (d,), dtype=F32, device=device)}


def _enc_layer_params(gen, cfg, *, device, lead):
    kw = dict(device=device, lead=lead)
    return {"norm1": _ln_params(cfg.d_model, **kw),
            "attn": att.gqa_params(gen, cfg, **kw),
            "norm2": _ln_params(cfg.d_model, **kw),
            "mlp": gelu_mlp_params(gen, cfg.d_model, cfg.d_ff, **kw)}


def _dec_layer_params(gen, cfg, *, device, lead):
    kw = dict(device=device, lead=lead)
    return {"norm1": _ln_params(cfg.d_model, **kw),
            "self": att.gqa_params(gen, cfg, **kw),
            "norm2": _ln_params(cfg.d_model, **kw),
            "cross": att.cross_attn_params(gen, cfg, **kw),
            "norm3": _ln_params(cfg.d_model, **kw),
            "mlp": gelu_mlp_params(gen, cfg.d_model, cfg.d_ff, **kw)}


def init_params(cfg: ArchConfig, gen=None, *, device=None) -> dict:
    """As ``transformer.init_params``: ``meta`` allocates nothing."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if gen is None and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(0)
    return {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02,
                            device=dev),
        "enc_layers": _enc_layer_params(gen, cfg, device=dev,
                                        lead=(cfg.n_encoder_layers,)),
        "enc_norm": _ln_params(cfg.d_model, device=dev),
        "dec_layers": _dec_layer_params(gen, cfg, device=dev,
                                        lead=(cfg.n_layers,)),
        "final_norm": _ln_params(cfg.d_model, device=dev),
    }   # head tied to embed (Whisper ties)


def _ln(p, x):
    return layernorm(x, p["w"], p["b"])


def encode(params, cfg: ArchConfig, frames, *, remat=True):
    """frames (B, T, D) -> encoder states (B, T, D)."""
    b, t, d = frames.shape
    x = hint_batch(frames + sinusoidal_positions(t, d, frames.device)[None])
    zero_pos = torch.zeros((b, t), dtype=torch.int32, device=frames.device)

    def body(x, lp):
        lp = gather_data(lp)
        h, _ = att.gqa_forward(lp["attn"], cfg, _ln(lp["norm1"], x),
                               zero_pos, bidirectional=True)
        x = x + h
        return x + gelu_mlp(lp["mlp"], _ln(lp["norm2"], x))

    body = checkpointed(body, remat)
    for lp in period_trees(params["enc_layers"], cfg.n_encoder_layers):
        x = body(x, lp)
    return _ln(params["enc_norm"], x)


def _dec_layer(lp, cfg, x, positions, enc_kv, mode, cache, pos):
    if mode == "decode":
        h, new_self = att.gqa_decode(lp["self"], cfg, _ln(lp["norm1"], x),
                                     pos, cache["self"])
    else:
        h, kv = att.gqa_prefill(lp["self"], cfg, _ln(lp["norm1"], x),
                                positions, flash=x.shape[1] >= 2048)
        new_self = _prefill_cache(kv, positions) if mode == "prefill" else None
    x = x + h
    x = x + att.cross_attention(lp["cross"], cfg, _ln(lp["norm2"], x), enc_kv)
    x = x + gelu_mlp(lp["mlp"], _ln(lp["norm3"], x))
    new_cache = (None if mode == "train"
                 else {"self": new_self, "cross": enc_kv})
    return x, new_cache


def _prefill_cache(kv, positions):
    k, v = kv
    return {"k": k, "v": v, "pos": positions[0]}


def _logits(params, x):
    return (hint_batch(_ln(gather_data(params["final_norm"]), x))
            @ gather_data(params["embed"].T))


def forward_train(params, cfg: ArchConfig, tokens, frames, *, remat=True):
    """Teacher-forced decoder over stub-encoded audio. tokens (B, S),
    frames (B, T, D) -> (logits (B, S, V), aux)."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    enc = encode(params, cfg, torch.as_tensor(frames, device=dev))
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)

    def body(x, lp):
        lp = gather_data(lp)
        enc_kv = att.encode_cross_kv(lp["cross"], cfg, enc)
        x, _ = _dec_layer(lp, cfg, x, positions, enc_kv, "train", None, None)
        return x

    body = checkpointed(body, remat)
    for lp in period_trees(params["dec_layers"], cfg.n_layers):
        x = body(x, lp)
    logits = _logits(params, x)
    return logits, {"moe_aux": torch.zeros((), dtype=F32, device=dev)}


def forward_prefill(params, cfg: ArchConfig, tokens, frames):
    """tokens (B, S), frames (B, T, D) -> (last-position logits (B, V),
    caches: the layers' self K/V and cross K/V, stacked)."""
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev).long()
    enc = encode(params, cfg, torch.as_tensor(frames, device=dev))
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens)
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    per_layer = []
    for lp in period_trees(params["dec_layers"], cfg.n_layers):
        lp = gather_data(lp)
        enc_kv = att.encode_cross_kv(lp["cross"], cfg, enc)
        x, cache = _dec_layer(lp, cfg, x, positions, enc_kv, "prefill",
                              None, None)
        per_layer.append(cache)
    caches = {"self": {k: torch.stack([c["self"][k] for c in per_layer])
                       for k in per_layer[0]["self"]},
              "cross": tuple(torch.stack([c["cross"][j] for c in per_layer])
                             for j in range(2))}
    return _logits(params, x[:, -1]), caches


def forward_decode(params, cfg: ArchConfig, token, pos, caches):
    """token (B,), pos a 0-dim device tensor (or an int) -> (logits (B, V),
    caches: the self-attention caches written in place)."""
    dev = params["embed"].device
    token = torch.as_tensor(token, device=dev).long()
    x = embed_lookup(params["embed"], token)[:, None, :]
    pos = as_position(pos, dev)
    n = cfg.n_layers
    for lp, self_c, cross in zip(period_trees(params["dec_layers"], n),
                                 period_trees(caches["self"], n),
                                 period_trees(caches["cross"], n)):
        x, _ = _dec_layer(gather_data(lp), cfg, x, None, cross, "decode",
                          {"self": self_c, "cross": cross}, pos)
    return _logits(params, x[:, 0]), caches


def init_decode_cache(cfg: ArchConfig, batch, max_len, n_frames,
                      dtype=torch.bfloat16, *, device=None):
    """Self-attn caches + cross-KV slots, stacked over decoder layers.
    device=None means CUDA; ``meta`` allocates nothing."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    g, hd = cfg.n_kv_heads, cfg.head_dim
    n = cfg.n_layers
    self_c = att.init_gqa_cache(cfg, batch, max_len, dtype, device=dev)
    return {
        "self": {k: v.expand((n,) + tuple(v.shape)).clone()
                 for k, v in self_c.items()},
        "cross": (torch.zeros((n, batch, n_frames, g, hd), dtype=dtype,
                              device=dev),
                  torch.zeros((n, batch, n_frames, g, hd), dtype=dtype,
                              device=dev)),
    }
