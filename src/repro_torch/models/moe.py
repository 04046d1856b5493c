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
- The sharding hints (``shard_hint``, ``_ambient_mesh``) are no-ops
  without a mesh and are dropped.
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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import mean
from repro_torch.models.layers import dense_init, swiglu, swiglu_params

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


def moe_forward(p, cfg, x):
    """x (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.n_experts, m.top_k
    dev = x.device
    xf = x.reshape(t, d)
    cap = _capacity(t, k, e, m.capacity_factor)

    # --- router ------------------------------------------------------------
    logits = xf.to(F32) @ p["router"].to(F32)                    # (T, E)
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
    xe = xpad[buf_tok].reshape(e, cap, d).to(F32)

    # --- expert FFN (stacked SwiGLU; bf16 x f32 promotes to f32) ------------
    h = F.silu(torch.bmm(xe, p["w_gate"])) * torch.bmm(xe, p["w_up"])
    ye = torch.bmm(h, p["w_down"]).to(BF16)                      # (E, C, D)

    # --- combine: each token's kept rows in slot order, added in bf16 -------
    yflat = (ye.reshape(e * cap, d).to(F32) * buf_w[:, None]).to(BF16)
    ypad = torch.cat([yflat, yflat.new_zeros((1, d))], dim=0)
    order = torch.sort(slot.reshape(t, k), dim=1).values         # (T, K)
    rows = ypad[order]                                           # (T, K, D)
    acc = rows[:, 0]
    for j in range(1, k):
        acc = acc + rows[:, j]
    out = acc.to(F32)

    if m.n_shared:
        out = out + swiglu(p["shared"], xf).to(F32)
    if m.dense_residual:
        out = out + swiglu(p["dense"], xf).to(F32)
    return out.reshape(b, s, d).to(x.dtype), aux
