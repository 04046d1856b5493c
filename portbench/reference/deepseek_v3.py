"""DeepSeek-V3's forward pass in plain float32, for the check of the
``lm_records`` cells: a copy of the program's
``repro_torch/models/reference_deepseek_v3.py`` (the equations and their
departures are written there), with the weights drawn again from the seed.

``Weights`` draws each tensor as the program's served init draws it
(``repro_torch.models.transformer.init_serving_params``): its own
``torch.Generator`` on the device, seeded by the first 8 bytes of the
SHA-256 of ``"seed/layer/name[/expert]"``, N(0, std^2) in float32, a
linear weight quantized to e4m3 in 128 x 128 blocks with float32 scales
(largest magnitude over 448). The reference reads the dequantized values
in float32; the program holds its non-expert weights as their bf16
copies. One layer's weights and one expert's at a time, so the check fits
the card once the program is freed, and ``forward`` runs each layer over
every pool batch before the next, so each weight is drawn once.

It imports nothing of the program and no JAX, and sets TF32 off.
"""

from __future__ import annotations

import hashlib
import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32 = torch.float32
EPS = 1e-6
FP8 = torch.float8_e4m3fn
ROUTER_BIAS_STD = 0.01


# -- the weights, drawn again from the seed --------------------------------

def derive_seed(seed: int, *parts) -> int:
    key = "/".join(str(x) for x in (int(seed),) + tuple(parts)).encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8],
                          "little") & ((1 << 63) - 1)


def seeded_normal(seed: int, parts, shape, std: float, device):
    gen = torch.Generator(device=device).manual_seed(
        derive_seed(seed, *parts))
    out = torch.randn(tuple(shape), generator=gen, device=device,
                      dtype=F32)
    return out.mul_(std)


def quantize_blocks(w: torch.Tensor, block: int):
    """(codes e4m3, scales): one scale a block, its amax over 448."""
    n, k = w.shape[-2:]
    pn, pk = -n % block, -k % block
    v = F.pad(w, (0, pk, 0, pn)) if pn or pk else w
    v = v.reshape(*v.shape[:-2], (n + pn) // block, block,
                  (k + pk) // block, block)
    amax = v.abs().amax(dim=(-3, -1))
    scale = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    q = (v / scale[..., :, None, :, None]).to(FP8)
    q = q.reshape(*q.shape[:-4], q.shape[-4] * block, q.shape[-2] * block)
    return q[..., :n, :k].contiguous(), scale


def dequantize(q, scale, block: int) -> torch.Tensor:
    n, k = q.shape[-2:]
    s = scale.repeat_interleave(block, dim=-2)[..., :n, :]
    s = s.repeat_interleave(block, dim=-1)[..., :k]
    return q.to(F32) * s


class Weights:
    """The dequantized float32 weights of the config's model drawn from
    ``seed`` on ``device``, in the checkpoint's (out, in) layout."""

    def __init__(self, cfg: dict, seed: int, device, block: int = 128):
        self.cfg, self.seed, self.device, self.block = cfg, seed, device, \
            block

    def linear(self, key, n_out, n_in) -> torch.Tensor:
        w = seeded_normal(self.seed, key, (n_out, n_in), n_in ** -0.5,
                          self.device)
        return dequantize(*quantize_blocks(w, self.block), self.block)

    def layer(self, li: int) -> dict:
        """Layer ``li``'s weights, its routed experts left out."""
        c = self.cfg
        d, h = c["hidden_size"], c["num_attention_heads"]
        nope, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
        ql, kvl, dv = c["q_lora_rank"], c["kv_lora_rank"], c["v_head_dim"]
        lin = lambda name, o, i: self.linear((li, name), o, i)
        ones = lambda n: torch.ones(n, dtype=F32, device=self.device)
        w = {"attn_norm": ones(d), "ffn_norm": ones(d),
             "wq_a": lin("wq_a", ql, d), "q_norm": ones(ql),
             "wq_b": lin("wq_b", h * (nope + r), ql),
             "wkv_a": lin("wkv_a", kvl + r, d), "kv_norm": ones(kvl),
             "wkv_b": lin("wkv_b", h * (nope + dv), kvl),
             "wo": lin("wo", d, h * dv)}
        if li < c["first_k_dense_replace"]:
            f = c["intermediate_size"]
            w.update(w1=lin("ffn.gate", f, d), w3=lin("ffn.up", f, d),
                     w2=lin("ffn.down", d, f))
            return w
        e = c["n_routed_experts"]
        fs = c["moe_intermediate_size"] * c["n_shared_experts"]
        router = seeded_normal(self.seed, (li, "router"), (e, d), d ** -0.5,
                               self.device)
        w.update(router=router.to(torch.bfloat16).to(F32),
                 router_bias=seeded_normal(self.seed, (li, "router_bias"),
                                           (e,), ROUTER_BIAS_STD,
                                           self.device),
                 shared_w1=lin("shared.gate", fs, d),
                 shared_w3=lin("shared.up", fs, d),
                 shared_w2=lin("shared.down", d, fs))
        return w

    def expert(self, li: int, e: int) -> tuple:
        c = self.cfg
        d, f = c["hidden_size"], c["moe_intermediate_size"]
        return (self.linear((li, "experts.gate", e), f, d),
                self.linear((li, "experts.up", e), f, d),
                self.linear((li, "experts.down", e), d, f))

    def embed(self, batches: list) -> list:
        """The embedding rows of each batch's tokens (bf16 values, as
        held), the table drawn once."""
        c = self.cfg
        table = seeded_normal(self.seed, ("embed",), (c["vocab_size"],
                                                      c["hidden_size"]),
                              1.0, self.device).to(torch.bfloat16)
        return [table[t.long()].to(F32) for t in batches]

    def head(self, rows) -> torch.Tensor:
        """The head's rows ``rows`` (bf16 values, as held)."""
        c = self.cfg
        d = c["hidden_size"]
        table = seeded_normal(self.seed, ("lm_head",), (c["vocab_size"], d),
                              d ** -0.5, self.device)
        return table[rows].to(torch.bfloat16).to(F32)


# -- the equations (as in the program's reference_deepseek_v3.py) -----------

class Precision:
    """Rounds a linear map's input: ``None`` keeps float32; "fp8" rounds to e4m3 with one scale (largest magnitude over
    448) a group of 128 of the last dim (the control)."""

    def __init__(self, act=None):
        self.act = act

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.act is None:
            return x
        d = x.shape[-1]
        pad = -d % 128
        v = F.pad(x, (0, pad)).reshape(*x.shape[:-1], -1, 128)
        s = v.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
        v = (v / s).to(FP8).to(F32) * s
        return v.reshape(*x.shape[:-1], d + pad)[..., :d]


EXACT = Precision()


def rmsnorm(x, w):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * w


def rope_freqs(cfg: dict) -> torch.Tensor:
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
    k_rope = rope(kv[..., kvr:], freqs)
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
    """x (T, D) normed -> (ids (T, K), s, gap of the 8th and 9th chosen
    s + b, gap of the 4th and 5th group scores)."""
    e, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    ng, kg = cfg["n_group"], cfg["topk_group"]
    s = torch.sigmoid(x @ w["router"].T)
    sb = s + w["router_bias"]
    t = sb.shape[0]
    grouped = sb.reshape(t, ng, e // ng)
    gscore = grouped.topk(min(2, e // ng), -1).values.sum(-1)
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
    """x (T, D) normed -> (y (T, D), {"ids" the sets used, "own" the
    reference's choice, "near" its smaller gap, "taken" / "apart" the
    tokens whose program set differs at / away from a near tie}).
    ``experts(e)`` -> (W1, W3, W2); ``follow`` (T, K): the program's
    choices, used where given (a row of -1 takes the reference's own)."""
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


def forward(weights: Weights, cfg: dict, batches: list,
            prec: Precision = EXACT, follow=None, gap: float = 0.0,
            head_rows=(0, 1)):
    """``batches``: token tensors (B, S) -> (per batch the last position's
    logits of ``head_rows`` (B, len), per batch one routing dict a MoE
    layer). Each layer runs over every batch before the next; ``follow``
    [batch][MoE layer]: the program's (B * S, K) choices (None for a batch
    the program did not serve)."""
    xs = weights.embed(batches)
    routes = [[] for _ in batches]
    mi = 0
    for li in range(cfg["num_hidden_layers"]):
        w = weights.layer(li)
        hs = []
        for i, x in enumerate(xs):
            x = x + mla(w, cfg, rmsnorm(x, w["attn_norm"]), prec)
            xs[i] = x
            hs.append(rmsnorm(x, w["ffn_norm"]))
        if li < cfg["first_k_dense_replace"]:
            for i, h in enumerate(hs):
                xs[i] = xs[i] + ffn(w["w1"], w["w3"], w["w2"], h, prec)
            continue
        shape = [h.shape for h in hs]
        flat = torch.cat([h.reshape(-1, h.shape[-1]) for h in hs])
        fol = None if follow is None else torch.cat(
            [torch.full((h.shape[0] * h.shape[1],
                         cfg["num_experts_per_tok"]), -1,
                        dtype=torch.long, device=h.device)
             if f is None else f[mi] for f, h in zip(follow, hs)])
        y, r = moe(w, lambda e, li=li: weights.expert(li, e), cfg, flat,
                   prec, fol, gap)
        lo = 0
        for i, sh in enumerate(shape):
            n = sh[0] * sh[1]
            xs[i] = xs[i] + y[lo:lo + n].reshape(sh)
            routes[i].append({k: v[lo:lo + n] for k, v in r.items()})
            lo += n
        mi += 1
        del w, flat, y
    head = weights.head(torch.as_tensor(head_rows, device=weights.device))
    norm = torch.ones(cfg["hidden_size"], dtype=F32, device=weights.device)
    return [linear(rmsnorm(x[:, -1], norm), head, prec) for x in xs], routes
