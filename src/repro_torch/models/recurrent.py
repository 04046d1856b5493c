"""Recurrent sequence blocks: RG-LRU (Griffin/RecurrentGemma) and xLSTM's
mLSTM / sLSTM.

Port of ``repro/models/recurrent.py``. Every block has the reference's
triple of entry points:
  <kind>_params(gen, cfg, *, device, lead)  -> param tree
  <kind>_block(p, cfg, x)                   -> (y, final_state)  full sequence
  <kind>_block_decode(p, cfg, x, state)     -> (y, state)        single token

A decode step writes its new state into ``state`` IN PLACE (a layer's state
is a view of the stacked decode cache) and returns the same dict: the
state tensors are the decode graph's carries, standing for the
reference's donated caches.

Full-sequence forms:
  * RG-LRU is the linear recurrence h_t = a_t h_{t-1} + u_t. The reference
    evaluates it with ``jax.lax.associative_scan``; the port scans by
    doubling (Hillis-Steele: log2(S) rounds, each combining every position
    with the one ``offset`` before it). Both are exact reassociations of the
    same recurrence, combined in different trees, so they agree to a few
    ulps per level, not bit for bit.
  * mLSTM runs chunkwise, as the reference does: the intra-chunk quadratic
    form plus the matrix state carried across chunks (``MLSTM_CHUNK``
    positions a chunk; a length that is not a multiple of it runs as one
    chunk). The chunk loop stands for the reference's ``lax.scan``.
  * sLSTM has genuine hidden-to-hidden recurrence, so it steps over time.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import mean, true_div
from repro_torch.models.layers import dense_init, gelu

F32 = torch.float32


def _zeros(lead, shape, device, dtype=F32):
    return torch.zeros(tuple(lead) + tuple(shape), dtype=dtype, device=device)


def _full(lead, shape, value, device):
    return torch.full(tuple(lead) + tuple(shape), value, dtype=F32,
                      device=device)


# ---------------------------------------------------------------------------
# causal depthwise conv1d (width w), used by RG-LRU and mLSTM branches
# ---------------------------------------------------------------------------

def conv1d_params(gen, width, channels, *, device, lead=()):
    return {"w": dense_init(gen, (width, channels), scale=0.3, device=device,
                            lead=lead),
            "b": _zeros(lead, (channels,), device)}


def causal_conv1d(p, x):
    """x (B, S, C) -> (B, S, C); y_t = b + sum_w W[w] * x_{t-w}."""
    width = p["w"].shape[0]
    s = x.shape[1]
    y = torch.zeros_like(x) + p["b"]
    for w in range(width):
        shifted = F.pad(x, (0, 0, w, 0))[:, :s]
        y = y + shifted * p["w"][w]
    return y


def causal_conv1d_decode(p, x1, conv_state):
    """x1 (B, 1, C), conv_state (B, width-1, C) = previous inputs (oldest
    first). Returns (y1, new_state): the new state is a fresh tensor, so
    the caller may write it over ``conv_state``."""
    window = torch.cat([conv_state.to(x1.dtype), x1], dim=1)  # (B, width, C)
    # window[:, -1] is x_t and must pair with W[0] (shift 0): flip taps
    y = p["b"] + torch.einsum("bwc,wc->bc", window,
                              p["w"].flip(0))[:, None, :]
    return y, window[:, 1:]


def conv_tail(x, width):
    """Last width-1 positions of x (left-padded if S < width-1)."""
    pad = max(0, (width - 1) - x.shape[1])
    xp = F.pad(x, (0, 0, pad, 0))
    return xp[:, -(width - 1):]


# ---------------------------------------------------------------------------
# RG-LRU block (Griffin recurrent block)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0


def rglru_params(gen, cfg, *, device, lead=()):
    d = cfg.d_model
    w = cfg.rglru_width or d
    kw = dict(device=device, lead=lead)
    # Lambda init so a = exp(-c*softplus(L)) lands in [0.9, 0.999]
    u = torch.empty(tuple(lead) + (w,), dtype=F32, device=device)
    if u.device.type != "meta":
        u.uniform_(0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / _RGLRU_C))
    return {
        "in_x": dense_init(gen, (d, w), **kw),       # recurrent branch
        "in_g": dense_init(gen, (d, w), **kw),       # gate branch (GeLU)
        "conv": conv1d_params(gen, cfg.conv1d_width, w, **kw),
        "w_rg": dense_init(gen, (w, w), scale=0.02, **kw),  # recurrence gate
        "b_rg": _zeros(lead, (w,), device),
        "w_ig": dense_init(gen, (w, w), scale=0.02, **kw),  # input gate
        "b_ig": _zeros(lead, (w,), device),
        "lam": lam,
        "out": dense_init(gen, (w, d), **kw),
    }


def _rglru_scan_coeffs(p, u):
    """u (B,S,W) conv output -> (a, gated_input) for the linear scan."""
    r = torch.sigmoid(u @ p["w_rg"] + p["b_rg"])
    i = torch.sigmoid(u @ p["w_ig"] + p["b_ig"])
    log_a = -_RGLRU_C * F.softplus(p["lam"]) * r            # (B,S,W) <= 0
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably from log a
    beta = torch.sqrt(torch.clamp(-torch.expm1(2.0 * log_a), min=1e-12))
    return a, beta * (i * u)


def linear_scan(a, v):
    """h_t = a_t h_{t-1} + v_t along dim 1 from h_{-1} = 0, by doubling:
    each round combines position t with t - offset, (A, H) <- (A_prev A,
    A H_prev + H), the reference's ``combine``."""
    s = a.shape[1]
    off = 1
    while off < s:
        v = torch.cat([v[:, :off], a[:, off:] * v[:, :-off] + v[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return v


def rglru_block(p, cfg, x):
    """x (B,S,D) -> (y (B,S,D), state)."""
    xin = x @ p["in_x"]
    u = causal_conv1d(p["conv"], xin)
    g = gelu(x @ p["in_g"])
    a, v = _rglru_scan_coeffs(p, u.to(F32))
    h = linear_scan(a, v)
    y = (h * g.to(F32)).to(x.dtype) @ p["out"]
    state = {"h": h[:, -1], "conv": conv_tail(xin, cfg.conv1d_width)}
    return y, state


def rglru_init_state(cfg, batch, dtype=F32, *, device):
    w = cfg.rglru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                dtype=dtype, device=device)}


def rglru_block_decode(p, cfg, x, state):
    """x (B,1,D) -> (y (B,1,D), state written in place)."""
    u_in = x @ p["in_x"]
    u, conv_state = causal_conv1d_decode(p["conv"], u_in, state["conv"])
    g = gelu(x @ p["in_g"])
    a, v = _rglru_scan_coeffs(p, u.to(F32))
    h = a[:, 0] * state["h"] + v[:, 0]
    y = (h[:, None] * g.to(F32)).to(x.dtype) @ p["out"]
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return y, state


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM): matrix memory, exponential gating
# ---------------------------------------------------------------------------

def mlstm_params(gen, cfg, *, device, lead=()):
    d = cfg.d_model
    w = 2 * d                                   # up-projection factor 2
    nh = cfg.n_heads
    hd = w // nh
    kw = dict(device=device, lead=lead)
    return {
        "up_u": dense_init(gen, (d, w), **kw),
        "up_z": dense_init(gen, (d, w), **kw),
        "conv": conv1d_params(gen, cfg.conv1d_width, w, **kw),
        # per-head block-diagonal q/k/v (the xLSTM BlockDiagonal linear)
        "wq": dense_init(gen, (nh, hd, hd), **kw),
        "wk": dense_init(gen, (nh, hd, hd), **kw),
        "wv": dense_init(gen, (nh, hd, hd), **kw),
        "w_if": dense_init(gen, (w, 2 * nh), scale=0.02, **kw),
        "b_if": torch.cat([_zeros(lead, (nh,), device),
                           _full(lead, (nh,), 3.0, device)], dim=-1),
        "gn": _full(lead, (w,), 1.0, device),   # per-channel group norm gain
        "down": dense_init(gen, (w, d), **kw),
        "skip": _full(lead, (w,), 1.0, device),  # learnable per-channel skip
    }


def _blockdiag(x_heads, w):
    """x (B,S,H,hd) @ per-head (H, hd, hd) -> (B,S,H,hd)."""
    return torch.einsum("bshd,hde->bshe", x_heads, w)


def _inv_scale_k(k, hd):
    """k / sqrt(float32(hd)), a true division as eager JAX takes it."""
    return true_div(k, float(np.sqrt(np.float32(hd))))


def _mlstm_qkv_gates(p, cfg, x):
    u = x @ p["up_u"]
    z = x @ p["up_z"]
    c = F.silu(causal_conv1d(p["conv"], u))
    b, s, w = u.shape
    nh = cfg.n_heads
    hd = w // nh
    ch = c.reshape(b, s, nh, hd)
    q = _blockdiag(ch, p["wq"])
    k = _inv_scale_k(_blockdiag(ch, p["wk"]), hd)
    v = _blockdiag(u.reshape(b, s, nh, hd), p["wv"])
    g = c @ p["w_if"] + p["b_if"]                                # (B,S,2H)
    log_i = g[..., :nh].to(F32)                                  # pre-act ~ log i
    log_f = F.logsigmoid(g[..., nh:].to(F32))                    # f = sigmoid
    return q, k, v, z, c, log_i, log_f


def _headnorm(h, gain):
    """Per-head RMS norm then flatten; h (B,S,H,hd), gain (H*hd,)."""
    var = mean(h * h, dim=-1).unsqueeze(-1)
    hn = h * torch.rsqrt(var + 1e-6)
    b, s = h.shape[:2]
    return hn.reshape(b, s, -1) * gain


MLSTM_CHUNK = 256


def mlstm_block(p, cfg, x):
    """Chunkwise-parallel mLSTM: intra-chunk quadratic + carried matrix
    state across chunks. O(S*L) memory instead of O(S^2)."""
    b, s, _ = x.shape
    q, k, v, z, c, log_i, log_f = _mlstm_qkv_gates(p, cfg, x)
    nh = cfg.n_heads
    hd = q.shape[-1]
    L = MLSTM_CHUNK if s % MLSTM_CHUNK == 0 else s
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    C = torch.zeros((b, nh, hd, hd), dtype=F32, device=x.device)
    n = torch.zeros((b, nh, hd), dtype=F32, device=x.device)
    m_st = torch.full((b, nh), -1e30, dtype=F32, device=x.device)
    hs = []
    for c0 in range(0, s, L):
        sl = slice(c0, c0 + L)
        qi, ki, vi = q[:, sl].to(F32), k[:, sl].to(F32), v[:, sl].to(F32)
        li, lf = log_i[:, sl], log_f[:, sl]              # (B,L,H)
        lf_cum = torch.cumsum(lf, dim=1)                 # (B,L,H)
        lf_tot = lf_cum[:, -1]                           # (B,H)
        # inter-chunk: query i sees state with decay lf_cum[i] (+ m_st)
        b_i = lf_cum + m_st[:, None, :]                  # (B,L,H)
        # intra-chunk decay matrix
        dmat = (lf_cum[:, :, None, :] - lf_cum[:, None, :, :]
                + li[:, None, :, :])                     # (B,Lq,Lk,H)
        dmat = torch.where(causal[None, :, :, None], dmat, -torch.inf)
        m_i = torch.clamp(torch.maximum(dmat.amax(dim=2), b_i), min=0.0)
        dexp = torch.exp(dmat - m_i[:, :, None, :])      # (B,Lq,Lk,H)
        inter_sc = torch.exp(b_i - m_i)                  # (B,L,H)

        scores = torch.einsum("blhd,bmhd->blmh", qi, ki) * dexp
        num = (torch.einsum("blmh,bmhe->blhe", scores, vi)
               + inter_sc[..., None]
               * torch.einsum("blhd,bhde->blhe", qi, C))
        den = (scores.sum(dim=2)
               + inter_sc * torch.einsum("blhd,bhd->blh", qi, n))
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])

        # state update to end of chunk
        dlast = lf_tot[:, None, :] - lf_cum + li         # (B,L,H)
        m_new = torch.maximum(lf_tot + m_st, dlast.amax(dim=1))
        carry_sc = torch.exp(lf_tot + m_st - m_new)      # (B,H)
        wgt = torch.exp(dlast - m_new[:, None, :])       # (B,L,H)
        C = (carry_sc[..., None, None] * C
             + torch.einsum("blh,blhd,blhe->bhde", wgt, ki, vi))
        n = (carry_sc[..., None] * n
             + torch.einsum("blh,blhd->bhd", wgt, ki))
        m_st = m_new
    h = torch.cat(hs, dim=1)                             # (B,S,H,hd)

    hn = _headnorm(h, p["gn"]) + c.to(F32) * p["skip"]
    y = (hn * F.silu(z.to(F32))).to(x.dtype) @ p["down"]
    state = {"C": C, "n": n, "m": m_st,
             "conv": conv_tail(x @ p["up_u"], cfg.conv1d_width)}
    return y, state


def mlstm_init_state(cfg, batch, dtype=F32, *, device):
    w = 2 * cfg.d_model
    nh = cfg.n_heads
    hd = w // nh
    return {"C": torch.zeros((batch, nh, hd, hd), dtype=F32, device=device),
            "n": torch.zeros((batch, nh, hd), dtype=F32, device=device),
            "m": torch.full((batch, nh), -1e30, dtype=F32, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, w),
                                dtype=dtype, device=device)}


def mlstm_block_decode(p, cfg, x, state):
    """Single-token recurrent mLSTM step. x (B,1,D); state written in
    place."""
    b = x.shape[0]
    nh = cfg.n_heads
    u = x @ p["up_u"]
    z = x @ p["up_z"]
    cval, conv_state = causal_conv1d_decode(p["conv"], u, state["conv"])
    cact = F.silu(cval)
    w = u.shape[-1]
    hd = w // nh
    ch = cact.reshape(b, 1, nh, hd)
    q = _blockdiag(ch, p["wq"])[:, 0].to(F32)
    k = _inv_scale_k(_blockdiag(ch, p["wk"])[:, 0], hd).to(F32)
    v = _blockdiag(u.reshape(b, 1, nh, hd), p["wv"])[:, 0].to(F32)
    g = (cact @ p["w_if"] + p["b_if"])[:, 0]                     # (B,2H)
    log_i = g[:, :nh].to(F32)
    log_f = F.logsigmoid(g[:, nh:].to(F32))

    m_old = state["m"]
    m_new = torch.maximum(log_f + m_old, log_i)                  # (B,H)
    f_sc = torch.exp(log_f + m_old - m_new)
    i_sc = torch.exp(log_i - m_new)
    C = (f_sc[..., None, None] * state["C"]
         + i_sc[..., None, None] * torch.einsum("bhd,bhe->bhde", k, v))
    n = f_sc[..., None] * state["n"] + i_sc[..., None] * k
    num = torch.einsum("bhde,bhd->bhe", C, q)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n, q).abs(),
                        torch.exp(-m_new))
    h = (num / den[..., None])[:, None]                          # (B,1,H,hd)
    hn = _headnorm(h, p["gn"]) + cact.to(F32) * p["skip"]
    y = (hn * F.silu(z.to(F32))).to(x.dtype) @ p["down"]
    state["C"].copy_(C)
    state["n"].copy_(n)
    state["m"].copy_(m_new)
    state["conv"].copy_(conv_state)
    return y, state


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM): scalar memory, true hidden-to-hidden recurrence
# ---------------------------------------------------------------------------

def slstm_params(gen, cfg, *, device, lead=()):
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    d_up = int(d * 4 / 3)
    kw = dict(device=device, lead=lead)
    return {
        # input projections for z, i, f, o (4 gates)
        "w_in": dense_init(gen, (d, 4 * d), **kw),
        "b_in": torch.cat([_zeros(lead, (d,), device),           # z
                           _zeros(lead, (d,), device),           # i
                           _full(lead, (d,), 3.0, device),       # f (open)
                           _zeros(lead, (d,), device)], dim=-1),  # o
        # block-diagonal (per-head) hidden-to-hidden recurrence
        "w_rec": dense_init(gen, (nh, hd, 4 * hd), scale=0.02, **kw),
        "gn": _full(lead, (d,), 1.0, device),
        # post-block GeGLU FFN, factor 4/3
        "ffn_gate": dense_init(gen, (d, d_up), **kw),
        "ffn_up": dense_init(gen, (d, d_up), **kw),
        "ffn_down": dense_init(gen, (d_up, d), **kw),
    }


def _slstm_step(p, cfg, xg, carry):
    """One time step. xg (B, 4D) pre-computed input gates; carry dict.
    -> a new carry dict."""
    c, n, h, m = carry["c"], carry["n"], carry["h"], carry["m"]
    b = xg.shape[0]
    nh = cfg.n_heads
    d = c.shape[1]
    hd = d // nh
    hh = h.reshape(b, nh, hd)
    rec = torch.einsum("bhd,hde->bhe", hh, p["w_rec"]).reshape(b, 4 * d)
    g = xg + rec
    zt = torch.tanh(g[:, :d])
    log_i = g[:, d:2 * d].to(F32)
    log_f = F.logsigmoid(g[:, 2 * d:3 * d].to(F32))
    o = torch.sigmoid(g[:, 3 * d:])
    m_new = torch.maximum(log_f + m, log_i)
    i_sc = torch.exp(log_i - m_new)
    f_sc = torch.exp(log_f + m - m_new)
    c_new = f_sc * c + i_sc * zt
    n_new = f_sc * n + i_sc
    h_new = o * (c_new / torch.clamp(n_new, min=1e-6))
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_init_state(cfg, batch, dtype=F32, *, device):
    d = cfg.d_model
    return {"c": torch.zeros((batch, d), dtype=F32, device=device),
            "n": torch.zeros((batch, d), dtype=F32, device=device),
            "h": torch.zeros((batch, d), dtype=F32, device=device),
            "m": torch.full((batch, d), -1e30, dtype=F32, device=device)}


def _slstm_ffn(p, h):
    return (gelu(h @ p["ffn_gate"]) * (h @ p["ffn_up"])) @ p["ffn_down"]


def _slstm_out(p, cfg, h, dtype):
    """Head-wise RMS norm of h (B,S,D), the gain, then the GeGLU FFN."""
    b, s, d = h.shape
    hh = h.reshape(b, s, cfg.n_heads, -1)
    var = mean(hh * hh, dim=-1).unsqueeze(-1)
    hn = (hh * torch.rsqrt(var + 1e-6)).reshape(b, s, d) * p["gn"]
    return _slstm_ffn(p, hn.to(dtype))


def slstm_block(p, cfg, x):
    """Sequential scan over time. x (B,S,D) -> (y, state)."""
    b, s, _ = x.shape
    xg = x @ p["w_in"] + p["b_in"]                               # (B,S,4D)
    carry = slstm_init_state(cfg, b, device=x.device)
    hs = []
    for t in range(s):
        carry = _slstm_step(p, cfg, xg[:, t], carry)
        hs.append(carry["h"])
    y = _slstm_out(p, cfg, torch.stack(hs, dim=1), x.dtype)
    return y, carry


def slstm_block_decode(p, cfg, x, state):
    """Single-token sLSTM step. x (B,1,D); state written in place."""
    xg = (x @ p["w_in"] + p["b_in"])[:, 0]
    new = _slstm_step(p, cfg, xg, state)
    y = _slstm_out(p, cfg, new["h"][:, None], x.dtype)
    for key, val in new.items():
        state[key].copy_(val)
    return y, state
