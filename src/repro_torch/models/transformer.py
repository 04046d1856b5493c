"""Composable decoder stack driven by ArchConfig.

Port of ``repro/models/transformer.py`` for every decoder family of the
registry: GQA attention (``attn``, or ``local_attn`` with a window), MLA,
RG-LRU, mLSTM and sLSTM blocks, with a dense SwiGLU, MoE or no FFN, the
image-patch frontend and the MTP head's params. (Whisper, the enc-dec
family, is ``models.whisper``.) The MTP forward, ``forward_train`` and
``decode_cache_shapes`` wait for the training slice.

Layer plan
----------
Layers are grouped into *segments*, as in the reference: maximal runs
where the per-layer spec sequence is periodic with the block pattern. Each
segment's params and caches keep the reference's layout — a list over the
period's layers whose leaves are stacked on a leading period dim — so
``models.model.params_from_arrays`` is a tree map. Where the reference
scans over periods, the port loops over the period index.

Per-layer wiring (pre-norm residual):
  x = x + Block(norm1(x))          Block in {gqa, local gqa, MLA, RG-LRU,
                                             mLSTM, sLSTM}
  x = x + FFN(norm2(x))            FFN in {swiglu, moe, none}

Two entry modes share the layer code:
  prefill  full sequence, returns (last logits, caches)
  decode   one token + caches, returns (logits, caches); the caches are
           updated IN PLACE (a layer's cache is a view of the stacked
           tensors), standing for the reference's donated caches: copying
           a 20 GB int8 cache every step is not an option. The position is
           a 0-dim device tensor, so the step never reads the device from
           the host and a CUDA graph can replay it (``serving.engine``).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_norm, as_position, dense_init,
                                       norm_params, swiglu, swiglu_params)

F32 = torch.float32


# ---------------------------------------------------------------------------
# layer plan
# ---------------------------------------------------------------------------

def _layer_spec(cfg: ArchConfig, i: int):
    block = cfg.block_kind(i)
    if block == "attn" and cfg.attn_kind == "mla":
        block = "mla"
    if cfg.d_ff == 0:
        ffn = "none"
    elif cfg.moe is not None and i >= cfg.moe.n_dense_layers:
        ffn = "moe"
    else:
        ffn = "dense"
    return (block, ffn)


def layer_plan(cfg: ArchConfig):
    """-> list of segments: {"specs": tuple[LayerSpec], "n_periods": int}.

    A segment with n_periods > 1 has stacked leaves; n_periods == 1 does
    not."""
    specs = [_layer_spec(cfg, i) for i in range(cfg.n_layers)]
    period = len(cfg.block_pattern)
    segments = []
    i = 0
    while i < cfg.n_layers:
        # longest periodic run starting at i
        pat = tuple(specs[i:i + period])
        n = 0
        while (i + (n + 1) * period <= cfg.n_layers
               and tuple(specs[i + n * period:i + (n + 1) * period]) == pat):
            n += 1
        if n >= 1 and len(pat) == period:
            segments.append({"specs": pat, "n_periods": n})
            i += n * period
        else:   # ragged tail: single layers
            segments.append({"specs": (specs[i],), "n_periods": 1})
            i += 1
    return segments


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _init_block(cfg, gen, kind, *, device, lead=()):
    kw = dict(device=device, lead=lead)
    if kind in ("attn", "local_attn"):
        return att.gqa_params(gen, cfg, **kw)
    if kind == "mla":
        return att.mla_params(gen, cfg, **kw)
    if kind == "rglru":
        return rec.rglru_params(gen, cfg, **kw)
    if kind == "mlstm":
        return rec.mlstm_params(gen, cfg, **kw)
    if kind == "slstm":
        return rec.slstm_params(gen, cfg, **kw)
    raise ValueError(kind)


def _init_layer(cfg, gen, spec, *, device, lead=()):
    block, ffn = spec
    kw = dict(device=device, lead=lead)
    p = {"norm1": norm_params(cfg, cfg.d_model, **kw),
         "block": _init_block(cfg, gen, block, **kw)}
    if ffn != "none":
        p["norm2"] = norm_params(cfg, cfg.d_model, **kw)
        p["ffn"] = (moe_mod.moe_params(gen, cfg, **kw) if ffn == "moe"
                    else swiglu_params(gen, cfg.d_model, cfg.d_ff, **kw))
    return p


def init_params(cfg: ArchConfig, gen=None, *, device=None) -> dict:
    """Params drawn from ``gen`` (a ``torch.Generator`` on ``device``; None
    seeds one with 0). device=None means CUDA; ``meta`` allocates nothing
    (``param_shapes``)."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if gen is None and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(0)
    segs = []
    for seg in layer_plan(cfg):
        lead = () if seg["n_periods"] == 1 else (seg["n_periods"],)
        segs.append([_init_layer(cfg, gen, spec, device=dev, lead=lead)
                     for spec in seg["specs"]])
    p = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), scale=0.02,
                            device=dev),
        "segments": segs,
        "final_norm": norm_params(cfg, cfg.d_model, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  device=dev)
    if cfg.frontend == "image_patches":
        p["patch_proj"] = dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                                     device=dev)
    if cfg.mtp:
        # read by the training loss only, never by prefill or decode
        p["mtp"] = {"proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                       device=dev),
                    "layer": _init_layer(cfg, gen,
                                         _layer_spec(cfg, cfg.n_layers - 1),
                                         device=dev),
                    "norm": norm_params(cfg, cfg.d_model, device=dev)}
    return p


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts, lists and tuples
    (whisper's cross K/V is a tuple); a ``torch.Size`` is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple) and not isinstance(tree, torch.Size):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    """The leaves of a tree, in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def param_shapes(cfg: ArchConfig):
    """Shape tree (``torch.Size`` leaves) without allocating."""
    return tree_map(lambda a: a.shape, init_params(cfg, device="meta"))


# ---------------------------------------------------------------------------
# per-layer forward (mode in {"prefill", "decode"})
# ---------------------------------------------------------------------------

_RECURRENT = {"rglru": (rec.rglru_block, rec.rglru_block_decode),
              "mlstm": (rec.mlstm_block, rec.mlstm_block_decode),
              "slstm": (rec.slstm_block, rec.slstm_block_decode)}


def _window(cfg, kind):
    if kind == "local_attn":
        return cfg.local_window
    return cfg.sliding_window   # None for full attention


def _block_apply(p, cfg, kind, x, positions, mode, cache, pos):
    """-> (y, new_cache); in decode mode the cache is written in place."""
    if kind in ("attn", "local_attn"):
        w = _window(cfg, kind)
        if mode == "decode":
            return att.gqa_decode(p, cfg, x, pos, cache, window=w)
        y, kv = att.gqa_prefill(p, cfg, x, positions, window=w,
                                flash=x.shape[1] >= 2048)
        return y, _kv_to_cache(cfg, kv, positions, w)
    if kind == "mla":
        if mode == "decode":
            return att.mla_decode(p, cfg, x, pos, cache)
        y, (c_kv, k_rope) = att.mla_forward(p, cfg, x, positions)
        return y, {"c_kv": c_kv, "k_rope": k_rope}
    block, block_decode = _RECURRENT[kind]
    if mode == "decode":
        return block_decode(p, cfg, x, cache)
    return block(p, cfg, x)


def _kv_to_cache(cfg, kv, positions, window):
    """Turn prefill (k, v) into the decode ring cache layout."""
    k, v = kv
    s = k.shape[1]
    size = min(s, window) if window else s
    pos_ids = positions[0]                           # (S,) assume aligned
    if window and s > size:
        k, v, pos_ids = k[:, -size:], v[:, -size:], pos_ids[-size:]
    # ring layout: slot = pos % size
    slots = pos_ids % size
    order = torch.argsort(slots, stable=True)
    return {"k": k[:, order], "v": v[:, order],
            "pos": pos_ids[order].to(torch.int32)}


def _layer_apply(p, cfg, spec, x, positions, mode, cache, pos):
    """-> (x, new_cache, aux)."""
    block, ffn = spec
    h = apply_norm(cfg, p["norm1"], x)
    y, new_cache = _block_apply(p["block"], cfg, block, h, positions,
                                mode, cache, pos)
    x = x + y
    aux = torch.zeros((), dtype=F32, device=x.device)
    if ffn == "dense":
        x = x + swiglu(p["ffn"], apply_norm(cfg, p["norm2"], x))
    elif ffn == "moe":
        y, aux = moe_mod.moe_forward(p["ffn"], cfg,
                                     apply_norm(cfg, p["norm2"], x))
        x = x + y
    return x, new_cache, aux


def _period_apply(period_params, cfg, specs, x, positions, mode,
                  period_cache, pos):
    new_caches = []
    aux = torch.zeros((), dtype=F32, device=x.device)
    for li, (p, spec) in enumerate(zip(period_params, specs)):
        c = None if period_cache is None else period_cache[li]
        x, nc, a = _layer_apply(p, cfg, spec, x, positions, mode, c, pos)
        new_caches.append(nc)
        aux = aux + a
    return x, new_caches, aux


# ---------------------------------------------------------------------------
# stack forward
# ---------------------------------------------------------------------------

def _run_segments(params, cfg, x, positions, mode, caches, pos):
    """caches: list aligned with segments (None in prefill mode). In decode
    mode each layer sees views of the stacked cache tensors and writes into
    them; the returned caches are the same objects. -> (x, caches, aux)."""
    new_caches = []
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    for si, seg in enumerate(layer_plan(cfg)):
        seg_p = params["segments"][si]
        specs = seg["specs"]
        seg_cache = None if caches is None else caches[si]
        if seg["n_periods"] == 1:
            x, nc, aux = _period_apply(seg_p, cfg, specs, x, positions, mode,
                                       seg_cache, pos)
            new_caches.append(nc)
            aux_total = aux_total + aux
            continue
        per_period = []
        for i in range(seg["n_periods"]):
            pp = tree_map(lambda a, i=i: a[i], seg_p)
            pc = (None if seg_cache is None
                  else tree_map(lambda a, i=i: a[i], seg_cache))
            x, nc, aux = _period_apply(pp, cfg, specs, x, positions, mode,
                                       pc, pos)
            aux_total = aux_total + aux
            per_period.append(nc)
        if mode == "decode":
            new_caches.append(seg_cache)
        else:       # stack the periods' prefill caches, as scan's ys
            new_caches.append([
                {key: torch.stack([c[li][key] for c in per_period])
                 for key in per_period[0][li]}
                for li in range(len(specs))])
    return x, new_caches, aux_total


def _embed(params, cfg, tokens, patch_embeds=None):
    x = params["embed"][tokens]                      # (B, S, D)
    if cfg.frontend == "image_patches" and patch_embeds is not None:
        pe = patch_embeds.to(device=x.device, dtype=x.dtype) \
            @ params["patch_proj"]
        x = torch.cat([pe, x], dim=1)
    return x


def _logits(params, cfg, x):
    x = apply_norm(cfg, params["final_norm"], x)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return x @ head


def _tokens(params, tokens):
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def forward_prefill(params, cfg: ArchConfig, tokens, *, patch_embeds=None):
    """tokens (B, S) (+ patch_embeds (B, n_front, frontend_dim) for the
    image frontend, which go first) -> (last-position logits (B, V),
    caches)."""
    tokens = _tokens(params, tokens)
    if patch_embeds is not None:
        patch_embeds = torch.as_tensor(patch_embeds)
    x = _embed(params, cfg, tokens, patch_embeds)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    x, caches, _ = _run_segments(params, cfg, x, positions, "prefill",
                                 None, None)
    return _logits(params, cfg, x[:, -1]), caches


def forward_decode(params, cfg: ArchConfig, token, pos, caches):
    """token (B,) int, pos a 0-dim device tensor (or an int) -> (logits
    (B, V), caches updated in place)."""
    token = _tokens(params, token)
    x = params["embed"][token][:, None, :]           # (B, 1, D)
    pos = as_position(pos, x.device)
    x, _, _ = _run_segments(params, cfg, x, None, "decode", caches, pos)
    return _logits(params, cfg, x[:, 0]), caches


# ---------------------------------------------------------------------------
# decode cache init (shape-faithful for every block kind)
# ---------------------------------------------------------------------------

def _layer_cache(cfg, spec, batch, max_len, dtype, quantize_kv=False, *,
                 device):
    block, _ = spec
    if block in ("attn", "local_attn"):
        return att.init_gqa_cache(cfg, batch, max_len, dtype,
                                  window=_window(cfg, block),
                                  quantized=quantize_kv, device=device)
    if block == "mla":
        return att.init_mla_cache(cfg, batch, max_len, dtype, device=device)
    if block == "rglru":
        return rec.rglru_init_state(cfg, batch, dtype, device=device)
    if block == "mlstm":
        return rec.mlstm_init_state(cfg, batch, dtype, device=device)
    if block == "slstm":
        return rec.slstm_init_state(cfg, batch, dtype, device=device)
    raise ValueError(block)


def init_decode_cache(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16,
                      quantize_kv=False, *, device=None):
    """Segment-aligned decode caches: stacked leaves (n_periods, ...) for a
    segment of several periods. device=None means CUDA."""
    dev = resolve_device(device)
    caches = []
    for seg in layer_plan(cfg):
        per = [_layer_cache(cfg, s, batch, max_len, dtype, quantize_kv,
                            device=dev)
               for s in seg["specs"]]
        if seg["n_periods"] == 1:
            caches.append(per)
        else:
            n = seg["n_periods"]
            caches.append(tree_map(
                lambda a, n=n: a.expand((n,) + tuple(a.shape)).clone(), per))
    return caches
