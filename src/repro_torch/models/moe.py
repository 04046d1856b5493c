"""Mixture-of-experts FFN with capacity-bounded index dispatch.

Port of ``repro/models/moe.py``. Dispatch is index-based, as in the
reference: each (token, slot) unit takes a position in its expert's
buffer by an exclusive cumsum over the units, units past an expert's
capacity are dropped (their combine weight never lands), and the expert
FFN is one batched matmul over the stacked (E, D, F) weights. The router
is a softmax over expert logits, top-k, weights renormalised over the k;
always-on shared experts (DeepSeek) and a dense residual branch (Arctic)
are never dropped. The load-balance aux loss (Switch: E * sum_e f_e p_e)
is returned for the training loss.

Departures from the reference, each kept on purpose:
- The sharding hints are the reference's (``shard_hint``: the experts'
  buffers over 'model', the combined tokens over the batch axes), read
  from the tensors' own mesh where the reference reads its ambient one;
  each is identity without a mesh.
- The combine. The reference scatter-adds each unit's bf16 row into a bf16
  accumulator, ``acc.at[buf_tok].add(yflat)``, one unit after another in
  buffer order (ascending slot: ascending expert id for a token), rounding
  to bf16 after each add. On the card a bf16 ``index_add_`` takes atomics
  in no fixed order, so its rounding would change from run to run. Here a
  token gathers its k buffer rows, sorted by slot (a dropped unit's slot
  is the zero row past the buffer and sorts last), and adds them one after
  another in bf16: the reference's order and rounding, deterministic, and
  without a data-dependent shape, so the MoE runs inside the decode graph.
- Nothing here takes ``nonzero``, a boolean-mask index or ``one_hot``
  (whose CPU checks read the data on the host).

DeepSeek-V3's published layer (``scoring="sigmoid"``; the JAX package has
no such route) goes through ``moe_sigmoid``: the sigmoid router with its
correction bias and group limit (``route_sigmoid``), and dropless experts
held as fp8 block-scaled codes under ``p["experts"]`` (the served params
of ``models.model.init_serving_model``): the pairs are sorted by expert on
the device and the experts run as the grouped GEMM B9
(``kernels.grouped_gemm``); a token's K rows are then summed in float32 in
a fixed order, so nothing is dropped, nothing is read on the host and no
shape depends on the routing. The layer adds its shared expert once.
Params without served experts raise: the JAX package's softmax route of
the same id is ``configs.deepseek_v3_671b.reference_settings``. Where
``p["route"]`` holds buffers (``attach_route_log``), the layer adds each
expert's tokens and the rows B9 stored into them in place and copies the
chosen experts out: the counters a benchmark reads once after its
window.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import mean
from repro_torch.distributed.sharding import (hint_batch, is_sharded, reshape,
                                              shard_hint)
from repro_torch.kernels.grouped_gemm import (TILE_WIDTHS, expert_plan,
                                              grouped_ffn)
from repro_torch.models.layers import dense_init, swiglu, swiglu_params
from repro_torch.obs.profiling import phase

F32 = torch.float32
BF16 = torch.bfloat16


def moe_params(gen, cfg, *, device, lead=()):
    m = cfg.moe
    d = cfg.d_model
    kw = dict(device=device, lead=lead)
    p = {
        "router": dense_init(gen, (d, m.n_experts), scale=0.02, **kw),
        # stacked expert SwiGLU weights (dense_init reads the fan-in from
        # the shape's first dim, E, as the reference's does)
        "w_gate": dense_init(gen, (m.n_experts, d, m.d_expert), **kw),
        "w_up": dense_init(gen, (m.n_experts, d, m.d_expert), **kw),
        "w_down": dense_init(gen, (m.n_experts, m.d_expert, d), **kw),
    }
    if m.n_shared:
        p["shared"] = swiglu_params(gen, d, m.d_expert * m.n_shared, **kw)
    if m.dense_residual:
        p["dense"] = swiglu_params(gen, d, m.dense_d_ff, **kw)
    return p


def _capacity(n_tokens: int, top_k: int, n_experts: int, factor: float) -> int:
    cap = int(n_tokens * top_k * factor / n_experts)
    return max(8, ((cap + 7) // 8) * 8)   # pad to 8 for lane alignment


def _rows(table, ids):
    """``table[ids]``; on a mesh ``F.embedding``, whose backward DTensor
    shards (an index's backward, ``index_put``, it does not in every
    PyTorch release)."""
    return F.embedding(ids, table) if is_sharded(table) else table[ids]


def moe_forward(p, cfg, x):
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    m = cfg.moe
    if m.scoring == "sigmoid":
        return moe_sigmoid(p, cfg, x)
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    dev = x.device
    xf = reshape(x, t, d)
    cap = _capacity(t, k, e, m.capacity_factor)

    # --- router ------------------------------------------------------------
    # on a mesh each token's routing reads all its experts' logits
    logits = hint_batch(xf.to(F32) @ p["router"].to(F32))       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.topk(probs, k, dim=-1)                # (T, K)
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch): E * sum_e mean(frac_e) * mean(prob_e)
    experts = torch.arange(e, device=dev)
    onehot_top1 = (gate_i[:, :1] == experts).to(F32)
    frac = mean(onehot_top1, dim=0)
    aux = e * torch.sum(frac * mean(probs, dim=0))

    # --- dispatch: position-in-expert via cumsum over (T, K) units ----------
    eid = gate_i.reshape(-1)
    uw = gate_w.reshape(-1)
    unit_tok = torch.arange(t, device=dev)[:, None].expand(t, k).reshape(-1)
    oh = (eid[:, None] == experts).to(torch.int32)               # (T*K, E)
    pos = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh        # exclusive
    pos_in_e = pos.gather(1, eid[:, None])[:, 0]
    keep = pos_in_e < cap
    slot = torch.where(keep, eid * cap + pos_in_e, e * cap)

    # token index / weight into the (E*C,) buffer (+1 overflow row, whose
    # several writers leave an entry that is dropped)
    buf_tok = torch.full((e * cap + 1,), t, dtype=torch.int64, device=dev)
    buf_tok = buf_tok.scatter(0, slot, unit_tok)[:-1]
    buf_w = torch.zeros((e * cap + 1,), dtype=F32, device=dev)
    buf_w = buf_w.scatter(0, slot, uw)[:-1]

    # gather tokens -> (E, C, D) in bf16; the sentinel t hits the zero row
    xd = xf.to(BF16)
    xpad = torch.cat([xd, xd.new_zeros((1, d))], dim=0)
    xe = shard_hint(reshape(_rows(xpad, buf_tok), e, cap, d),
                    "model", None, None)                 # EP: experts over 'model'
    xe = xe.to(F32)

    # --- expert FFN (stacked SwiGLU; bf16 x f32 promotes to f32) ------------
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).to(BF16)                      # (E, C, D)
    ye = shard_hint(ye, "model", None, None)

    # --- combine: each token's kept rows in slot order, added in bf16 -------
    yflat = (reshape(ye, e * cap, d).to(F32) * buf_w[:, None]).to(BF16)
    ypad = torch.cat([yflat, yflat.new_zeros((1, d))], dim=0)
    order = torch.sort(slot.reshape(t, k), dim=1).values         # (T, K)
    rows = _rows(ypad, order)                                    # (T, K, D)
    acc = rows[:, 0]
    for j in range(1, k):
        acc = acc + rows[:, j]
    out = hint_batch(acc.to(F32))         # the tokens over the batch axes

    if m.n_shared:
        out = out + swiglu(p["shared"], xf).to(F32)
    if m.dense_residual:
        out = out + swiglu(p["dense"], xf).to(F32)
    return reshape(out, b, s, d).to(x.dtype), aux


# ---------------------------------------------------------------------------
# DeepSeek-V3's layer: sigmoid router, group limit, dropless experts
# ---------------------------------------------------------------------------

def route_sigmoid(p, m, xf):
    """xf (T, D) -> (ids (T, K) int64, weights (T, K) f32, s + b (T, E)
    f32). s = sigmoid(xf W_r) in float32; the experts are chosen by s + b
    (b, ``router_bias``, zero where the params hold none) among the
    ``topk_group`` groups of ``n_group`` whose top-2 sums of s + b are
    largest; each chosen expert's weight is its s over the chosen s's sum,
    times ``routed_scale``."""
    s = torch.sigmoid(xf.to(F32) @ p["router"].to(F32))
    bias = p.get("router_bias")
    sb = s if bias is None else s + bias.to(F32)
    t, e = sb.shape
    grouped = sb.reshape(t, m.n_group, e // m.n_group)
    top2 = grouped.topk(min(2, e // m.n_group), dim=-1).values.sum(-1)
    chosen = top2.topk(m.topk_group, dim=-1).indices            # (T, G')
    keep = torch.zeros_like(top2, dtype=torch.bool).scatter_(1, chosen, True)
    masked = grouped.masked_fill(~keep[..., None], float("-inf"))
    ids = masked.reshape(t, e).topk(m.top_k, dim=-1).indices    # (T, K)
    w = s.gather(1, ids)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * m.routed_scale
    return ids, w, sb


def attach_route_log(params, cfg, tokens: int):
    """Give every MoE layer of the served ``params`` (a tree of
    ``models.transformer``) its route buffers, zeroed: ``tokens`` (E,)
    int64, each expert's routed tokens, ``stored`` () int64, the rows B9
    stored (``grouped_gemm.grouped_ffn``'s count: the routed pairs
    written, times ``column_blocks(D)``), and ``shapes`` (4,) int64, B9's
    row tiles at each width (``grouped_gemm.TILE_WIDTHS``), all summed in
    place over calls; ``ids`` (``tokens``, K) int32, the last call's
    chosen experts. -> the list of the layers' buffers, stacked layers as
    one dict of (n, ...) tensors."""
    m = cfg.moe
    out = []
    for seg in params["segments"]:
        for layer in seg:
            ffn = layer.get("ffn", {})
            if "router" not in ffn:
                continue
            lead = tuple(ffn["router"].shape[:-2])
            dev = ffn["router"].device
            ffn["route"] = {
                "tokens": torch.zeros(lead + (m.n_experts,),
                                      dtype=torch.int64, device=dev),
                "stored": torch.zeros(lead, dtype=torch.int64, device=dev),
                "shapes": torch.zeros(lead + (len(TILE_WIDTHS),),
                                      dtype=torch.int64, device=dev),
                "ids": torch.zeros(lead + (tokens, m.top_k),
                                   dtype=torch.int32, device=dev)}
            out.append(ffn["route"])
    return out


def moe_sigmoid(p, cfg, x):
    """DeepSeek-V3's MoE layer, dropless. x (B, S, D) -> (out, aux 0)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    if "experts" not in p:
        raise ValueError("DeepSeek-V3's sigmoid route runs fp8 experts: "
                         "draw the params with models.model."
                         "init_serving_model, or take the JAX package's "
                         "softmax route through configs.deepseek_v3_671b."
                         "reference_settings")
    ids, w, _ = route_sigmoid(p, m, xf)
    phase("lm.experts")
    plan = expert_plan(ids, m.n_experts)
    route = p.get("route")
    if route is not None:
        plan.shapes = route.get("shapes")
    y = grouped_ffn(xf.contiguous(), plan, p["experts"], w,
                    None if route is None else route["stored"])
    out = y.reshape(t, m.top_k, d).sum(1, dtype=F32)
    if route is not None:
        route["tokens"] += plan.counts
        route["ids"].copy_(ids)
    if m.n_shared:
        phase("lm.shared_ffn")
        out = out + swiglu(p["shared"], xf).to(F32)
    aux = torch.zeros((), dtype=F32, device=x.device)
    return out.reshape(b, s, d).to(x.dtype), aux
