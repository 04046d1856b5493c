"""Composable decoder stack driven by ArchConfig: the dense GQA part.

Port of ``repro/models/transformer.py`` for decoders whose every block is
GQA attention (``attn``, or ``local_attn`` with a window) with a dense
SwiGLU FFN: qwen3-4b, yi-6b, qwen2.5-32b, h2o-danube-1.8b. Other block or
FFN kinds (mla, moe, rglru, mlstm, slstm), enc-dec, the image-patch
frontend and the MTP head raise ``NotImplementedError``; they are queued in
ROADMAP.md (A13). ``forward_train`` waits for the training slice.

Layer plan
----------
Layers are grouped into *segments*, as in the reference: maximal runs
where the per-layer spec sequence is periodic with the block pattern. Each
segment's params and caches keep the reference's layout — a list over the
period's layers whose leaves are stacked on a leading period dim — so
``models.model.params_from_arrays`` is a tree map. Where the reference
scans over periods, the port loops over the period index.

Per-layer wiring (pre-norm residual):
  x = x + Attn(norm1(x))
  x = x + SwiGLU(norm2(x))

Two entry modes share the layer code:
  prefill  full sequence, returns (last logits, caches)
  decode   one token + caches, returns (logits, caches); the caches are
           updated IN PLACE (a layer's cache is a view of the stacked
           tensors), standing for the reference's donated caches: copying
           a 20 GB int8 cache every step is not an option.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as att
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_norm, dense_init, norm_params,
                                       swiglu, swiglu_params)

F32 = torch.float32

QUEUED = ("is not ported yet: the PyTorch port serves dense GQA decoders "
          "(qwen3-4b, yi-6b, qwen2.5-32b, h2o-danube-1.8b); the rest of the "
          "LM side is queued in ROADMAP.md (A13)")


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError for anything outside the dense GQA slice."""
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: encdec {QUEUED}")
    if cfg.frontend == "image_patches":
        raise NotImplementedError(f"{cfg.name}: image_patches {QUEUED}")
    if cfg.mtp:
        raise NotImplementedError(f"{cfg.name}: mtp {QUEUED}")
    for i in range(cfg.n_layers):
        block, ffn = _layer_spec(cfg, i)
        if block not in ("attn", "local_attn"):
            raise NotImplementedError(f"{cfg.name}: block {block!r} {QUEUED}")
        if ffn == "moe":
            raise NotImplementedError(f"{cfg.name}: ffn 'moe' {QUEUED}")


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

def _init_layer(cfg, gen, spec, *, device, lead=()):
    _, ffn = spec
    p = {"norm1": norm_params(cfg, cfg.d_model, device=device, lead=lead),
         "block": att.gqa_params(gen, cfg, device=device, lead=lead)}
    if ffn != "none":
        p["norm2"] = norm_params(cfg, cfg.d_model, device=device, lead=lead)
        p["ffn"] = swiglu_params(gen, cfg.d_model, cfg.d_ff, device=device,
                                 lead=lead)
    return p


def init_params(cfg: ArchConfig, gen=None, *, device=None) -> dict:
    """Params drawn from ``gen`` (a ``torch.Generator`` on ``device``; None
    seeds one with 0). device=None means CUDA; ``meta`` allocates nothing
    (``param_shapes``)."""
    check_supported(cfg)
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
    return p


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts and lists (a tuple,
    ``torch.Size`` included, is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def param_shapes(cfg: ArchConfig):
    """Shape tree (``torch.Size`` leaves) without allocating."""
    return tree_map(lambda a: a.shape, init_params(cfg, device="meta"))


# ---------------------------------------------------------------------------
# per-layer forward (mode in {"prefill", "decode"})
# ---------------------------------------------------------------------------

def _window(cfg, kind):
    if kind == "local_attn":
        return cfg.local_window
    return cfg.sliding_window   # None for full attention


def _block_apply(p, cfg, kind, x, positions, mode, cache, pos):
    """-> (y, new_cache)."""
    w = _window(cfg, kind)
    if mode == "decode":
        return att.gqa_decode(p, cfg, x, pos, cache, window=w)
    y, kv = att.gqa_prefill(p, cfg, x, positions, window=w,
                            flash=x.shape[1] >= 2048)
    return y, _kv_to_cache(cfg, kv, positions, w)


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
    """-> (x, new_cache)."""
    block, ffn = spec
    h = apply_norm(cfg, p["norm1"], x)
    y, new_cache = _block_apply(p["block"], cfg, block, h, positions,
                                mode, cache, pos)
    x = x + y
    if ffn == "dense":
        x = x + swiglu(p["ffn"], apply_norm(cfg, p["norm2"], x))
    return x, new_cache


def _period_apply(period_params, cfg, specs, x, positions, mode,
                  period_cache, pos):
    new_caches = []
    for li, (p, spec) in enumerate(zip(period_params, specs)):
        c = None if period_cache is None else period_cache[li]
        x, nc = _layer_apply(p, cfg, spec, x, positions, mode, c, pos)
        new_caches.append(nc)
    return x, new_caches


# ---------------------------------------------------------------------------
# stack forward
# ---------------------------------------------------------------------------

def _run_segments(params, cfg, x, positions, mode, caches, pos):
    """caches: list aligned with segments (None in prefill mode). In decode
    mode each layer sees views of the stacked cache tensors and writes into
    them; the returned caches are the same objects."""
    new_caches = []
    for si, seg in enumerate(layer_plan(cfg)):
        seg_p = params["segments"][si]
        specs = seg["specs"]
        seg_cache = None if caches is None else caches[si]
        if seg["n_periods"] == 1:
            x, nc = _period_apply(seg_p, cfg, specs, x, positions, mode,
                                  seg_cache, pos)
            new_caches.append(nc)
            continue
        per_period = []
        for i in range(seg["n_periods"]):
            pp = tree_map(lambda a, i=i: a[i], seg_p)
            pc = (None if seg_cache is None
                  else tree_map(lambda a, i=i: a[i], seg_cache))
            x, nc = _period_apply(pp, cfg, specs, x, positions, mode, pc,
                                  pos)
            per_period.append(nc)
        if mode == "decode":
            new_caches.append(seg_cache)
        else:       # stack the periods' prefill caches, as scan's ys
            new_caches.append([
                {key: torch.stack([c[li][key] for c in per_period])
                 for key in per_period[0][li]}
                for li in range(len(specs))])
    return x, new_caches


def _embed(params, cfg, tokens):
    return params["embed"][tokens]                   # (B, S, D)


def _logits(params, cfg, x):
    x = apply_norm(cfg, params["final_norm"], x)
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return x @ head


def _tokens(params, tokens):
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def forward_prefill(params, cfg: ArchConfig, tokens):
    """tokens (B, S) -> (last-position logits (B, V), caches)."""
    check_supported(cfg)
    tokens = _tokens(params, tokens)
    b, s = tokens.shape
    x = _embed(params, cfg, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    x, caches = _run_segments(params, cfg, x, positions, "prefill",
                              None, None)
    return _logits(params, cfg, x[:, -1]), caches


def forward_decode(params, cfg: ArchConfig, token, pos: int, caches):
    """token (B,) int, pos an int -> (logits (B, V), caches updated in
    place)."""
    check_supported(cfg)
    token = _tokens(params, token)
    x = params["embed"][token][:, None, :]           # (B, 1, D)
    positions = torch.full((x.shape[0], 1), int(pos), dtype=torch.int32,
                           device=x.device)
    x, new_caches = _run_segments(params, cfg, x, positions, "decode",
                                  caches, pos)
    return _logits(params, cfg, x[:, 0]), new_caches


# ---------------------------------------------------------------------------
# decode cache init
# ---------------------------------------------------------------------------

def _layer_cache(cfg, spec, batch, max_len, dtype, quantize_kv=False, *,
                 device):
    block, _ = spec
    return att.init_gqa_cache(cfg, batch, max_len, dtype,
                              window=_window(cfg, block),
                              quantized=quantize_kv, device=device)


def init_decode_cache(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16,
                      quantize_kv=False, *, device=None):
    """Segment-aligned decode caches: stacked leaves (n_periods, ...) for a
    segment of several periods. device=None means CUDA."""
    check_supported(cfg)
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
