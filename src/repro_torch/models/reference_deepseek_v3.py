"""DeepSeek-V3's forward pass, written plainly: the reference the served
model is held to.

Plain ``torch`` in float32 with TF32 off, no kernel, no cache, no batching
beyond what the tensors hold; it imports nothing else of the port and no
JAX. It computes the published equations (arXiv:2412.19437 §2.1; the
config.json of deepseek-ai/DeepSeek-V3) from the weights as they are read
dequantized, in the checkpoint's (out, in) layout:

* MLA: q = W_qb rmsnorm(W_qa x); c = rmsnorm(W_kva x)[:kv_lora]; the
  decoupled rotary key from the rest of W_kva x, one head shared by all;
  k_nope, v from W_kvb c; softmax((q_nope . k_nope + q_rope . k_rope) *
  scale) causal, scale = mscale^2 / sqrt(nope + rope) with YaRN's mscale
  = 0.1 ln(factor) + 1; out W_o.
* YaRN rotary frequencies: theta^(-2i/d), divided by ``factor`` below the
  ramp between the dimensions that turn ``beta_slow`` and ``beta_fast``
  times over the original 4096 positions, kept above it.
* The router: s = sigmoid(x W_r^T); the 8 groups of 32 experts ranked by
  the sum of their top-2 s + b; within the top 4 groups the top 8 experts
  by s + b; g = s / sum(s) * 2.5 over the chosen.
* A MoE layer: y = x + shared(x) + sum_i g_i E_i(x), each E(x) =
  W_2 (silu(W_1 x) * W_3 x); a dense layer: y = x + FFN(x); pre-norm
  residual blocks (RMSNorm, eps 1e-6), a final norm and the head.

Departures, each deliberate:
- The rotary pairs are the two halves of the rope dims (the port's
  layout); the published code pairs neighbouring dims. The two differ by a
  fixed permutation of the rope rows of W_qb and W_kva, which random
  weights do not see.
- The multi-token-prediction module is left out: the classifier reads the
  last position's logits.
- ``follow``: the program's expert sets, taken in place of the reference's
  own choice, so that the layers after see the same tokens on both sides
  and a routing that rounding tips either way does not part the two
  models for the rest of the pass. Each token whose set differs is
  counted: as a near tie (``taken``) where the reference's own choice is
  one (its 8th and 9th scores s + b, or its 4th and 5th group scores,
  within ``gap``), else as ``apart``.

``Precision`` rounds the inputs of every linear map (the control's
lower precision: fp8 e4m3 in 1 x 128 groups, as the published inference
quantizes activations); ``EXACT`` leaves them as they are.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = torch.float32
EPS = 1e-6


class Precision:
    """Rounds a linear map's input: ``None`` keeps float32; "fp8" rounds to e4m3 with one scale (largest magnitude over
    448) a group of 128 of the last dim."""

    def __init__(self, act=None):
        self.act = act

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.act is None:
            return x
        d = x.shape[-1]
        pad = -d % 128
        v = F.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, 128)
        s = v.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
        v = (v / s).to(torch.float8_e4m3fn).to(F32) * s
        return v.reshape(*x.shape[:-1], d + pad)[..., :d]


EXACT = Precision()


def rmsnorm(x, w):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * w


def rope_freqs(cfg: dict) -> torch.Tensor:
    """(rope/2,) YaRN inverse frequencies of the config."""
    dim, theta = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    freqs = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=F32) / dim)
    ys = cfg.get("rope_scaling")
    if not ys:
        return freqs
    n = ys["original_max_position_embeddings"]

    def at(rot):
        return dim * math.log(n / (rot * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(at(ys["beta_fast"])), 0)
    high = min(math.ceil(at(ys["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=F32) - low)
            / max(high - low, 1e-3)).clamp(0, 1)
    return freqs / ys["factor"] * ramp + freqs * (1 - ramp)


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    ys = cfg.get("rope_scaling")
    if ys and ys["factor"] > 1:
        m = 0.1 * ys["mscale_all_dim"] * math.log(ys["factor"]) + 1.0
        scale *= m * m
    return scale


def rope(x, freqs):
    """x (B, S, ..., r): rotated by position (the halves as pairs)."""
    s = x.shape[1]
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] \
        * freqs.to(x.device)
    shape = (1, s) + (1,) * (x.dim() - 3) + (ang.shape[-1],)
    cos, sin = torch.cos(ang).reshape(shape), torch.sin(ang).reshape(shape)
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def linear(x, w, prec: Precision):
    return prec(x) @ w.T


def mla(w: dict, cfg: dict, x, prec: Precision):
    """x (B, S, D) normed -> (B, S, D)."""
    b, s, _ = x.shape
    h = cfg["num_attention_heads"]
    nope, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, kvr = cfg["v_head_dim"], cfg["kv_lora_rank"]
    freqs = rope_freqs(cfg)
    q = linear(rmsnorm(linear(x, w["wq_a"], prec), w["q_norm"]), w["wq_b"],
               prec).reshape(b, s, h, nope + r)
    q_nope, q_rope = q[..., :nope], rope(q[..., nope:], freqs)
    kv = linear(x, w["wkv_a"], prec)
    c = rmsnorm(kv[..., :kvr], w["kv_norm"])
    k_rope = rope(kv[..., kvr:], freqs)                        # (B, S, r)
    kvb = linear(c, w["wkv_b"], prec).reshape(b, s, h, nope + dv)
    k_nope, v = kvb[..., :nope], kvb[..., nope:]
    sc = (torch.einsum("bqhd,bkhd->bhqk", q_nope, k_nope)
          + torch.einsum("bqhd,bkd->bhqk", q_rope, k_rope)) \
        * softmax_scale(cfg)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    sc = sc.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1), v)
    return linear(o.reshape(b, s, h * dv), w["wo"], prec)


def ffn(w1, w3, w2, x, prec: Precision):
    return linear(F.silu(linear(x, w1, prec)) * linear(x, w3, prec), w2,
                  prec)


def route(w: dict, cfg: dict, x):
    """x (T, D) normed -> (ids (T, K), s (T, E), gap of the 8th and 9th
    chosen s + b (T,), gap of the 4th and 5th group scores (T,))."""
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    ng, kg = cfg["n_group"], cfg["topk_group"]
    s = torch.sigmoid(x @ w["router"].T)
    sb = s + w["router_bias"]
    t = sb.shape[0]
    grouped = sb.reshape(t, ng, e // ng)
    gscore = grouped.topk(min(2, e // ng), -1).values.sum(-1)   # (T, G)
    gsort = gscore.sort(-1, descending=True).values
    ggap = (gsort[:, kg - 1] - gsort[:, kg]) if kg < ng else \
        torch.full((t,), float("inf"), device=x.device)
    keep = torch.zeros_like(gscore, dtype=torch.bool).scatter_(
        1, gscore.topk(kg, -1).indices, True)
    masked = grouped.masked_fill(~keep[..., None], float("-inf")).reshape(
        t, e)
    top = masked.topk(k + 1, -1)
    return top.indices[:, :k], s, top.values[:, k - 1] - top.values[:, k], \
        ggap


def weights_of(s, ids, cfg):
    g = s.gather(1, ids)
    return g / g.sum(-1, keepdim=True) * cfg["routed_scaling_factor"]


def moe(w: dict, experts, cfg: dict, x, prec: Precision, follow=None,
        gap: float = 0.0):
    """x (T, D) normed -> (y (T, D) without the residual, the routing:
    {"ids" the sets used, "own" the reference's choice, "near" its
    smaller gap, "taken" / "apart" the tokens whose program set differs at
    / away from a near tie}). ``experts(e)`` -> (W1, W3, W2) of expert e;
    ``follow`` (T, K): the program's choices, used where given (a row of
    -1 takes the reference's own)."""
    own, s, gap8, ggap = route(w, cfg, x)
    near = torch.minimum(gap8, ggap)
    tie = near <= gap
    ids, differ = own, torch.zeros_like(tie)
    if follow is not None:              # a row of -1: no program choice
        given = (follow >= 0).all(-1)
        ids = torch.where(given[:, None], follow.to(own), own)
        differ = given & (own.sort(-1).values != ids.sort(-1).values).any(-1)
    g = weights_of(s, ids, cfg)
    y = ffn(w["shared_w1"], w["shared_w3"], w["shared_w2"], x, prec)
    for e in range(cfg["n_routed_experts"]):
        hit = ids == e
        tok = hit.any(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        w1, w3, w2 = experts(e)
        ge = (g * hit).sum(-1)[tok, None]
        y.index_add_(0, tok, ge * ffn(w1, w3, w2, x[tok], prec))
    return y, {"ids": ids, "own": own, "near": near, "taken": differ & tie,
               "apart": differ & ~tie}


def forward(weights: dict, cfg: dict, tokens, prec: Precision = EXACT,
            follow=None, gap: float = 0.0, head_rows=None):
    """tokens (B, S) -> (last position's logits (B, V), or of
    ``head_rows`` only; one routing dict a MoE layer). ``weights``: the
    dequantized float32 tensors, (out, in): "embed" (V, D), "head" (V, D),
    "final_norm", "layers" [each: "attn_norm", "wq_a", "q_norm", "wq_b",
    "wkv_a", "kv_norm", "wkv_b", "wo", "ffn_norm"; a dense layer "w1",
    "w3", "w2"; a MoE layer "router" (E, D), "router_bias" (E,),
    "shared_w1" / "_w3" / "_w2" and "experts" (W1 (E, F, D), W3, W2 (E, D,
    F))]. ``follow``: per MoE layer the program's (B * S, K) choices."""
    b, s = tokens.shape
    x = weights["embed"][tokens.long()].to(F32)
    routes, mi = [], 0
    for li, w in enumerate(weights["layers"]):
        x = x + mla(w, cfg, rmsnorm(x, w["attn_norm"]), prec)
        h = rmsnorm(x, w["ffn_norm"])
        if li < cfg["first_k_dense_replace"]:
            x = x + ffn(w["w1"], w["w3"], w["w2"], h, prec)
            continue
        ex = w["experts"]
        y, r = moe(w, lambda e: (ex[0][e], ex[1][e], ex[2][e]), cfg,
                   h.reshape(b * s, -1), prec,
                   None if follow is None else follow[mi], gap)
        x = x + y.reshape(b, s, -1)
        routes.append(r)
        mi += 1
    head = weights["head"] if head_rows is None else \
        weights["head"][head_rows]
    last = rmsnorm(x[:, -1], weights["final_norm"])
    return linear(last, head, prec), routes
