"""Composable decoder stack driven by ArchConfig.

Port of ``repro/models/transformer.py`` for every decoder family of the
registry: GQA attention (``attn``, or ``local_attn`` with a window), MLA,
RG-LRU, mLSTM and sLSTM blocks, with a dense SwiGLU, MoE or no FFN, the
image-patch frontend and DeepSeek's MTP head. (Whisper, the enc-dec
family, is ``models.whisper``.)

Layer plan
----------
Layers are grouped into *segments*, as in the reference: maximal runs
where the per-layer spec sequence is periodic with the block pattern. Each
segment's params and caches keep the reference's layout — a list over the
period's layers whose leaves are stacked on a leading period dim — so
``models.model.params_from_arrays`` is a tree map. Where the reference
scans over periods, the port loops over the period index; with ``remat``
each period of such a segment runs under ``torch.utils.checkpoint``, as the
reference wraps its scan body in ``jax.checkpoint``.

Per-layer wiring (pre-norm residual):
  x = x + Block(norm1(x))          Block in {gqa, local gqa, MLA, RG-LRU,
                                             mLSTM, sLSTM}
  x = x + FFN(norm2(x))            FFN in {swiglu, moe, none}

Three entry modes share the layer code:
  train    full sequence, no caches, returns (logits, aux)
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
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core.quantize import dequantize_blocks, quantize_blocks
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (dense, gather_data,
                                              hint_batch, is_sharded,
                                              replicate_dim)
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (apply_norm, as_position, dense_init,
                                       norm_params, seeded_normal, swiglu,
                                       swiglu_params)
from repro_torch.obs.profiling import phase

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


def period_trees(tree, n: int):
    """A tree whose leaves are stacked on a leading dim of ``n`` as ``n``
    trees of views, one ``unbind`` a leaf: a decode step's in-place cache
    writes reach the stack. Under autograd that matters too: the backward
    of ``unbind`` stacks the ``n`` grads once, where slicing ``a[i]`` a
    period would zero-fill a grad of the whole stack for every period."""
    unbound = [replicate_dim(a, 0).unbind(0) for a in tree_leaves(tree)]
    out = []
    for i in range(n):
        it = iter([u[i] for u in unbound])
        out.append(tree_map(lambda _: next(it), tree))
    return out


def param_shapes(cfg: ArchConfig):
    """Shape tree (``torch.Size`` leaves) without allocating."""
    return tree_map(lambda a: a.shape, init_params(cfg, device="meta"))


# ---------------------------------------------------------------------------
# served params: DeepSeek-V3 as its fp8 checkpoint holds it
# ---------------------------------------------------------------------------

ROUTER_BIAS_STD = 0.01      # the correction bias's draw (not published)
EXPERT_CHUNK = 16           # experts quantized a call by the served init


def _activations(cfg) -> torch.dtype:
    return getattr(torch, cfg.precision.activations)


def _served_linear(cfg, seed, key, n_out, n_in, device):
    """A linear weight drawn (n_out, n_in) from ``key``, N(0, 1 / n_in),
    quantized to fp8 in blocks and held as the copy of its dequantized
    values in the activations' type, transposed to the port's (n_in,
    n_out)."""
    block = cfg.precision.block
    q, sc = quantize_blocks(
        seeded_normal(seed, key, (n_out, n_in), n_in ** -0.5, device), block)
    return dequantize_blocks(q, sc, block, _activations(cfg)).T.contiguous()


def _served_ones(cfg, n, device):
    return {"w": torch.ones(n, dtype=_activations(cfg), device=device)}


def _served_layer(cfg, seed, li, spec, device, experts):
    """Layer ``li``'s served params; ``experts`` (MoE): the views its fp8
    expert codes and scales are written into."""
    block, ffn = spec
    if block != "mla" or ffn == "none":
        raise ValueError("the served init holds DeepSeek-V3's layers (MLA, "
                         f"then a dense or MoE FFN), not {spec}")
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    lin = lambda name, n_out, n_in: _served_linear(
        cfg, seed, (li, name), n_out, n_in, device)
    p = {"norm1": _served_ones(cfg, d, device),
         "block": {
             "wq_a": lin("wq_a", m.q_lora_rank, d),
             "q_norm": _served_ones(cfg, m.q_lora_rank, device)["w"],
             "wq_b": lin("wq_b", h * (m.qk_nope_dim + m.qk_rope_dim),
                         m.q_lora_rank),
             "wkv_a": lin("wkv_a", m.kv_lora_rank + m.qk_rope_dim, d),
             "kv_norm": _served_ones(cfg, m.kv_lora_rank, device)["w"],
             "wkv_b": lin("wkv_b", h * (m.qk_nope_dim + m.v_head_dim),
                          m.kv_lora_rank),
             "wo": lin("wo", d, h * m.v_head_dim)},
         "norm2": _served_ones(cfg, d, device)}
    if ffn == "dense":
        p["ffn"] = {"gate": lin("ffn.gate", cfg.d_ff, d),
                    "up": lin("ffn.up", cfg.d_ff, d),
                    "down": lin("ffn.down", d, cfg.d_ff)}
        return p
    e, f = cfg.moe.n_experts, cfg.moe.d_expert
    bsz = cfg.precision.block
    for name, (n_out, n_in) in (("gate", (f, d)), ("up", (f, d)),
                                ("down", (d, f))):
        # a chunk of experts drawn one matrix at a time, quantized at once
        buf = torch.empty((EXPERT_CHUNK, n_out, n_in), dtype=F32,
                          device=device)
        for lo in range(0, e, EXPERT_CHUNK):
            n = min(EXPERT_CHUNK, e - lo)
            for j in range(n):
                buf[j].copy_(seeded_normal(
                    seed, (li, "experts." + name, lo + j), (n_out, n_in),
                    n_in ** -0.5, device))
            q, sc = quantize_blocks(buf[:n], bsz)
            experts[name][lo:lo + n].copy_(q)
            experts[name + "_scale"][lo:lo + n].copy_(sc)
        del buf
    fs = f * cfg.moe.n_shared
    # the router's gate is held in bf16 by the checkpoint and read in f32
    router = seeded_normal(seed, (li, "router"), (e, d), d ** -0.5, device)
    p["ffn"] = {
        "router": router.to(torch.bfloat16).to(F32).T.contiguous(),
        "router_bias": seeded_normal(seed, (li, "router_bias"), (e,),
                                     ROUTER_BIAS_STD, device),
        "experts": experts,
        "shared": {"gate": lin("shared.gate", fs, d),
                   "up": lin("shared.up", fs, d),
                   "down": lin("shared.down", d, fs)}}
    return p


def _served_experts(cfg, lead, device):
    """Uninitialized fp8 expert codes (E, F, D) / (E, D, F) and their
    float32 block scales, with ``lead`` stacked dims."""
    e, f, d = cfg.moe.n_experts, cfg.moe.d_expert, cfg.d_model
    b = cfg.precision.block
    fb, db = -(-f // b), -(-d // b)
    shapes = {"gate": (e, f, d), "up": (e, f, d), "down": (e, d, f),
              "gate_scale": (e, fb, db), "up_scale": (e, fb, db),
              "down_scale": (e, db, fb)}
    return {k: torch.empty(tuple(lead) + v, device=device,
                           dtype=F32 if k.endswith("scale")
                           else torch.float8_e4m3fn)
            for k, v in shapes.items()}


def init_serving_params(cfg: ArchConfig, seed: int, *, device=None) -> dict:
    """The params of ``cfg`` as its precision serves them
    (``cfg.precision``: DeepSeek-V3's fp8 checkpoint), drawn on ``device``
    (None: CUDA) from ``seed``, each tensor (each expert's each matrix) from
    its own generator, seeded by ``layers.derive_seed(seed, layer, name[,
    expert])``, so any one of them can be drawn again alone:

    * a linear weight (out, in): N(0, 1 / in), quantized to e4m3 in
      ``block`` x ``block`` blocks with float32 scales (``core.quantize``);
      the routed experts kept as codes and scales (the grouped GEMM B9 reads
      them), every other one held as the copy of its dequantized values in
      the activations' type (bf16 as served);
    * the router (E, D): N(0, 1 / D) rounded to bf16, read in float32; its
      correction bias N(0, ``ROUTER_BIAS_STD``^2);
    * the embedding ("embed") N(0, 1) and the head ("lm_head") N(0, 1 / D)
      rounded to bf16; the norms' gains ones.

    The MTP module is left out: serving reads the last position's logits.
    The 45 GB of experts at DeepSeek-V3's width never pass through float32
    weights whole: ``EXPERT_CHUNK`` experts' matrices at a time are drawn,
    quantized and copied in (0.9 GB of float32 at that width).
    """
    if cfg.precision is None or cfg.precision.weights != "float8_e4m3fn":
        raise ValueError(f"{cfg.name}: the served init holds fp8 e4m3 "
                         f"weights, not {cfg.precision}")
    dev = resolve_device(device)
    segs, li = [], 0
    for seg in layer_plan(cfg):
        n, specs = seg["n_periods"], seg["specs"]
        layers = []
        for j, spec in enumerate(specs):
            lead = () if n == 1 else (n,)
            stacked = (_served_experts(cfg, lead, dev) if spec[1] == "moe"
                       else None)
            per = []
            for k in range(n):
                views = None if stacked is None else (
                    stacked if n == 1 else {a: t[k]
                                            for a, t in stacked.items()})
                per.append(_served_layer(cfg, seed, li + j + k * len(specs),
                                         spec, dev, views))
            if n == 1:
                layers.append(per[0])
                continue

            def stack(*leaves):
                return torch.stack(leaves)
            merged = _tree_zip(stack, per, skip=("experts",))
            if stacked is not None:
                merged["ffn"]["experts"] = stacked
            layers.append(merged)
        segs.append(layers)
        li += n * len(specs)
    # the checkpoint holds both in bf16; held in the activations' type
    embed = seeded_normal(seed, ("embed",), (cfg.vocab_size, cfg.d_model),
                          1.0, dev).to(torch.bfloat16).to(_activations(cfg))
    head = seeded_normal(seed, ("lm_head",), (cfg.vocab_size, cfg.d_model),
                         cfg.d_model ** -0.5, dev).to(torch.bfloat16).to(
                             _activations(cfg))
    return {"embed": embed, "segments": segs,
            "final_norm": _served_ones(cfg, cfg.d_model, dev),
            "lm_head": head.T.contiguous()}


def _tree_zip(fn, trees, skip=()):
    """``fn`` over the leaves of equal trees (dicts of dicts), leaf by
    leaf; a key in ``skip`` is left out."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_zip(fn, [t[k] for t in trees], skip)
                for k in first if k not in skip}
    return fn(*trees)


# ---------------------------------------------------------------------------
# per-layer forward (mode in {"train", "prefill", "decode"})
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
        if mode == "train":
            return y, None
        return y, _kv_to_cache(cfg, kv, positions, w)
    if kind == "mla":
        if mode == "decode":
            return att.mla_decode(p, cfg, x, pos, cache)
        y, (c_kv, k_rope) = att.mla_forward(p, cfg, x, positions)
        if mode == "train":
            return y, None
        return y, {"c_kv": c_kv, "k_rope": k_rope}
    block, block_decode = _RECURRENT[kind]
    if mode == "decode":
        return block_decode(p, cfg, x, cache)
    y, state = block(p, cfg, x)
    return y, (state if mode == "prefill" else None)


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
    p = gather_data(p)
    phase("lm.attention")
    # on a mesh, each norm's output enters its block with the batch sharded
    # and d_model whole (Megatron's layout); identity on a plain tensor
    h = hint_batch(apply_norm(cfg, p["norm1"], x))
    y, new_cache = _block_apply(p["block"], cfg, block, h, positions,
                                mode, cache, pos)
    x = x + y
    aux = torch.zeros((), dtype=F32, device=x.device)
    if ffn == "dense":
        phase("lm.shared_ffn")
        x = x + swiglu(p["ffn"], hint_batch(apply_norm(cfg, p["norm2"], x)))
    elif ffn == "moe":
        phase("lm.route")
        y, aux = moe_mod.moe_forward(p["ffn"], cfg,
                                     hint_batch(apply_norm(cfg, p["norm2"],
                                                           x)))
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

def checkpointed(fn, remat: bool):
    """``fn`` recomputed in the backward pass instead of keeping its
    activations (``jax.checkpoint``): only its inputs are saved. Without
    ``remat``, or with grad off (prefill), ``fn`` itself."""
    if not remat:
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return run


def _run_segments(params, cfg, x, positions, mode, caches, pos,
                  remat=False):
    """caches: list aligned with segments (None in train and prefill mode).
    In decode mode each layer sees views of the stacked cache tensors and
    writes into them; the returned caches are the same objects. With
    ``remat`` each period of a segment of several periods is checkpointed,
    where the reference checkpoints its scan body. -> (x, caches, aux)."""
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
        n = seg["n_periods"]
        if mode == "train":
            def body(xc, pp, specs=specs):
                xc, _, aux = _period_apply(pp, cfg, specs, xc, positions,
                                           mode, None, None)
                return xc, aux
            body = checkpointed(body, remat)
            for pp in period_trees(seg_p, n):
                x, aux = body(x, pp)
                aux_total = aux_total + aux
            new_caches.append(None)
            continue
        per_period = []
        period_caches = ([None] * n if seg_cache is None
                         else period_trees(seg_cache, n))
        for pp, pc in zip(period_trees(seg_p, n), period_caches):
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


def embed_lookup(table, ids):
    """``table[ids]``. On a mesh the row width is gathered first (the FSDP
    gather of the embedding's 'data' dim), so the rows come out sharded as
    the ids are, where DTensor would rather gather the ids and run the rest
    of the model on the whole batch on every device; and the lookup is
    ``F.embedding``, whose backward DTensor shards (an index's backward,
    ``index_put``, it does not in every PyTorch release)."""
    if is_sharded(table):
        return hint_batch(F.embedding(ids, replicate_dim(table, -1)))
    return table[ids]


def _embed(params, cfg, tokens, patch_embeds=None):
    x = embed_lookup(params["embed"], tokens)         # (B, S, D)
    if cfg.frontend == "image_patches" and patch_embeds is not None:
        pe = patch_embeds.to(device=x.device, dtype=x.dtype) \
            @ gather_data(params["patch_proj"])
        x = torch.cat([hint_batch(pe), x], dim=1)
    return x


def _logits(params, cfg, x):
    x = hint_batch(apply_norm(cfg, gather_data(params["final_norm"]), x))
    head = (params["embed"].T if cfg.tie_embeddings else params["lm_head"])
    return x @ gather_data(head)


def _tokens(params, tokens):
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def _positions(b, s, device):
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def forward_train(params, cfg: ArchConfig, tokens, *, patch_embeds=None,
                  remat=True):
    """tokens (B, S) -> (logits (B, S_text_out, V), aux losses dict).

    With an image frontend, logits cover only the text positions. With
    ``cfg.mtp`` the dict also holds ``mtp_logits`` (B, S - 1, V)."""
    tokens = _tokens(params, tokens)
    if patch_embeds is not None:
        patch_embeds = torch.as_tensor(patch_embeds)
    b, s = tokens.shape
    x = _embed(params, cfg, tokens, patch_embeds)
    positions = _positions(b, x.shape[1], x.device)
    x, _, aux = _run_segments(params, cfg, x, positions, "train", None, None,
                              remat)
    n_front = x.shape[1] - s
    xt = x[:, n_front:]
    logits = _logits(params, cfg, xt)
    out_aux = {"moe_aux": aux}
    if cfg.mtp:
        # DeepSeek-V3 MTP: one extra layer predicts token t+2 from
        # concat(h_t, embed(token_{t+1})), sharing the embedding/head.
        emb_next = embed_lookup(params["embed"], tokens)
        h_in = torch.cat([xt[:, :-1], emb_next[:, 1:]], dim=-1)
        h = dense(h_in, gather_data(params["mtp"]["proj"]))
        h, _, _ = _period_apply([params["mtp"]["layer"]], cfg,
                                (_layer_spec(cfg, cfg.n_layers - 1),),
                                h, positions[:, 1:], "train", None, None)
        out_aux["mtp_logits"] = _logits(
            {**params, "final_norm": params["mtp"]["norm"]}, cfg, h)
    return logits, out_aux


def forward_prefill(params, cfg: ArchConfig, tokens, *, patch_embeds=None):
    """tokens (B, S) (+ patch_embeds (B, n_front, frontend_dim) for the
    image frontend, which go first) -> (last-position logits (B, V),
    caches)."""
    tokens = _tokens(params, tokens)
    if patch_embeds is not None:
        patch_embeds = torch.as_tensor(patch_embeds)
    x = _embed(params, cfg, tokens, patch_embeds)
    b, s = x.shape[:2]
    positions = _positions(b, s, x.device)
    x, caches, _ = _run_segments(params, cfg, x, positions, "prefill",
                                 None, None)
    phase("lm.head")
    return _logits(params, cfg, x[:, -1]), caches


def forward_decode(params, cfg: ArchConfig, token, pos, caches):
    """token (B,) int, pos a 0-dim device tensor (or an int) -> (logits
    (B, V), caches updated in place)."""
    token = _tokens(params, token)
    x = embed_lookup(params["embed"], token)[:, None, :]   # (B, 1, D)
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
    segment of several periods. device=None means CUDA; ``meta`` allocates
    nothing (``decode_cache_shapes``)."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
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


def decode_cache_shapes(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16):
    """The decode cache tree as ``meta`` tensors (shape and dtype, nothing
    allocated), the counterpart of the reference's ``eval_shape``."""
    return init_decode_cache(cfg, batch, max_len, dtype, device="meta")
