"""DeepSeek-V3 as published, in the port, against the plain reference
``repro_torch/models/reference_deepseek_v3.py`` on the CPU at a small size:
MLA with YaRN, the sigmoid router with its group limit, the dropless MoE
(the grouped GEMM B9's plain version), fp8 block scaling, a whole 1 dense
+ 2 MoE model and the hybrid server with the model as its backend. The
port's parity with the JAX package (whose model of this id keeps a
softmax router, capacity drops and plain RoPE) is in
``tests/test_torch_archs.py`` on ``smoke()``.

Tolerances, each with its reason:
- ``F32_REL`` = 1e-4 of the largest magnitude: float32 against float32,
  the products associated differently;
- ``B9_REL`` = 2e-2: the served experts round their dequantized weights,
  their intermediate H and their weighted output Y to bf16, as the kernel
  does (2^-9 of an element each), where the reference keeps float32;
- ``LOGIT_REL`` = 2e-2 for whole models: those bf16 roundings carried
  through the layers after them.
Routing is compared exactly, away from near ties (the reference's 8th and
9th scores, or its 4th and 5th group scores, within ``GAP``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.deepseek_v3_671b import reference_settings
from repro_torch.core.quantize import (FP8, FP8_MAX, dequantize_blocks,
                                       quantize_blocks)
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.launch import serve
from repro_torch.models import attention as att
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import reference_deepseek_v3 as R
from repro_torch.models.config import MLAConfig, PrecisionConfig
from repro_torch.models.transformer import tree_map

F32_REL, B9_REL, LOGIT_REL, GAP = 1e-4, 2e-2, 2e-2, 1e-4
FULL = get_config("deepseek-v3-671b")


def small_cfg(n_layers=3, experts=32, block=16, activations="float32"):
    """The published mechanisms at a small width: 32 experts in 8 groups,
    top-4 groups, top-8, x2.5, YaRN, fp8 blocks of ``block``."""
    return dataclasses.replace(
        FULL, n_layers=n_layers, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=256, mtp=False,
        mla=MLAConfig(32, 16, 16, 8, 16),
        moe=dataclasses.replace(FULL.moe, n_experts=experts, d_expert=32,
                                n_dense_layers=1),
        precision=PrecisionConfig(block=block, activations=activations))


def hf(cfg) -> dict:
    """The reference's config keys (those of DeepSeek-V3's config.json)."""
    m, a, ys = cfg.moe, cfg.mla, cfg.rope_scaling
    return dict(
        hidden_size=cfg.d_model, num_attention_heads=cfg.n_heads,
        qk_nope_head_dim=a.qk_nope_dim, qk_rope_head_dim=a.qk_rope_dim,
        v_head_dim=a.v_head_dim, q_lora_rank=a.q_lora_rank,
        kv_lora_rank=a.kv_lora_rank, rope_theta=cfg.rope_theta,
        rope_scaling=None if ys is None else dict(
            factor=ys.factor, beta_fast=ys.beta_fast,
            original_max_position_embeddings=ys.original_max_position,
            beta_slow=ys.beta_slow, mscale=ys.mscale,
            mscale_all_dim=ys.mscale_all_dim),
        n_routed_experts=m.n_experts, num_experts_per_tok=m.top_k,
        n_group=m.n_group, topk_group=m.topk_group,
        routed_scaling_factor=m.routed_scale,
        first_k_dense_replace=m.n_dense_layers,
        num_hidden_layers=cfg.n_layers, vocab_size=cfg.vocab_size,
        intermediate_size=cfg.d_ff, moe_intermediate_size=m.d_expert,
        n_shared_experts=m.n_shared)


def _block_weights(lay, cfg):
    """One layer of the port's served params as the reference's dict
    (float32, (out, in))."""
    f = lambda t: t.float().T
    b, ff = lay["block"], lay["ffn"]
    w = dict(attn_norm=lay["norm1"]["w"].float(),
             ffn_norm=lay["norm2"]["w"].float(), wq_a=f(b["wq_a"]),
             q_norm=b["q_norm"].float(), wq_b=f(b["wq_b"]),
             wkv_a=f(b["wkv_a"]), kv_norm=b["kv_norm"].float(),
             wkv_b=f(b["wkv_b"]), wo=f(b["wo"]))
    if "router" not in ff:
        w.update(w1=f(ff["gate"]), w3=f(ff["up"]), w2=f(ff["down"]))
        return w
    ex, blk = ff["experts"], cfg.precision.block
    w.update(router=f(ff["router"]), router_bias=ff["router_bias"].float(),
             shared_w1=f(ff["shared"]["gate"]),
             shared_w3=f(ff["shared"]["up"]),
             shared_w2=f(ff["shared"]["down"]),
             experts=tuple(dequantize_blocks(ex[n], ex[n + "_scale"], blk)
                           for n in ("gate", "up", "down")))
    return w


def reference_weights(params, cfg) -> dict:
    layers_ = []
    for seg in params["segments"]:
        for lay in seg:
            lead = lay["norm1"]["w"].dim() == 2
            for k in range(lay["norm1"]["w"].shape[0] if lead else 1):
                one = tree_map(lambda t: t[k], lay) if lead else lay
                layers_.append(_block_weights(one, cfg))
    return dict(embed=params["embed"].float(),
                head=params["lm_head"].float().T,
                final_norm=params["final_norm"]["w"].float(), layers=layers_)


def close(ref, got, rel):
    ref, got = ref.double(), got.double()
    assert ref.shape == got.shape
    err = float((ref - got).abs().max())
    assert err <= rel * float(ref.abs().max()), (err, float(ref.abs().max()))


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _tokens(b, s, seed, vocab=256):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (b, s)))


# -- configuration --------------------------------------------------------

def test_registry_holds_the_published_settings():
    m = FULL.moe
    assert (m.scoring, m.n_group, m.topk_group, m.top_k, m.routed_scale,
            m.n_experts, m.n_shared) == ("sigmoid", 8, 4, 8, 2.5, 256, 1)
    ys = FULL.rope_scaling
    assert (ys.factor, ys.original_max_position, ys.beta_fast, ys.beta_slow,
            ys.mscale, ys.mscale_all_dim) == (40.0, 4096, 32.0, 1.0, 1.0,
                                              1.0)
    assert FULL.mla.v_head_dim == 128 and FULL.rope_theta == 10000.0
    p = FULL.precision
    assert (p.weights, p.block, p.activations) == ("float8_e4m3fn", 128,
                                                   "bfloat16")
    ref = reference_settings(FULL)
    assert ref.rope_scaling is None and ref.precision is None
    assert ref.moe.scoring == "softmax" and ref.d_model == FULL.d_model


def test_lm_config_cuts_depth_and_keeps_widths():
    cfg = serve.lm_config("deepseek-v3-671b", 5)
    assert cfg.n_layers == 5 and cfg.moe.n_dense_layers == 1
    assert not cfg.mtp and cfg.d_model == 7168 and cfg.moe.n_experts == 256
    assert serve.lm_config("deepseek-v3-671b") is FULL
    args = serve.parse_args(["--backend", "lm", "--arch", "deepseek-v3-671b",
                             "--lm-layers", "5"])
    assert (args.arch, args.lm_layers) == ("deepseek-v3-671b", 5)
    assert serve.parse_args([]).arch is None


# -- fp8 block scaling ------------------------------------------------------

@pytest.mark.parametrize("shape, block", [((256, 384), 128),
                                          ((3, 200, 300), 128),
                                          ((40, 24), 16)])
def test_fp8_block_dequantization(shape, block):
    """Each block's scale is its largest magnitude over 448, its codes the
    weights over the scale rounded to e4m3 (the block's largest at +-448),
    and dequantizing is code x scale, block by block."""
    w = _x(shape, 3)
    q, s = quantize_blocks(w, block)
    assert q.dtype == FP8 and q.shape == w.shape
    n, k = shape[-2:]
    assert s.shape == shape[:-2] + (-(-n // block), -(-k // block))
    d = dequantize_blocks(q, s, block)
    for i in range(s.shape[-2]):
        for j in range(s.shape[-1]):
            rows, cols = slice(i * block, (i + 1) * block), \
                slice(j * block, (j + 1) * block)
            wb, qb = w[..., rows, cols], q[..., rows, cols].float()
            amax = wb.abs().amax((-2, -1))
            assert torch.equal(s[..., i, j], amax / FP8_MAX)
            assert torch.equal(qb.abs().amax((-2, -1)),
                               torch.full_like(amax, FP8_MAX))
            assert torch.equal(d[..., rows, cols],
                               qb * s[..., i, j][..., None, None])
            assert torch.equal(qb, (wb / s[..., i, j][..., None, None]).to(
                FP8).float())
    # e4m3 keeps 4 significant bits: within 2^-4 of each element's size
    assert float(((d - w).abs() - w.abs() / 16).max()) <= 2 ** -9 * float(
        s.max())
    assert torch.equal(dequantize_blocks(q, s, block, torch.bfloat16),
                       d.to(torch.bfloat16))


def test_a_block_of_zeros_keeps_scale_one():
    q, s = quantize_blocks(torch.zeros(32, 32), 16)
    assert torch.equal(s, torch.ones(2, 2)) and not q.float().any()


# -- MLA with YaRN ----------------------------------------------------------

def test_yarn_frequencies_and_scale():
    ys = FULL.rope_scaling
    got = layers.rope_freqs(64, 10000.0, scaling=ys)
    base = layers.rope_freqs(64, 10000.0)
    # beta_fast 32 -> dim 10.47 -> low 10; beta_slow 1 -> 22.5 -> high 23
    assert torch.equal(got[:11], base[:11])
    assert torch.allclose(got[23:], base[23:] / 40.0, rtol=1e-6)
    mid = got[11:23] / base[11:23]
    assert bool((mid < 1).all() and (mid > 1 / 40).all())
    assert torch.allclose(got, R.rope_freqs(hf(FULL)), rtol=1e-6)
    assert layers.yarn_softmax_scale(ys) == pytest.approx(
        (0.1 * np.log(40) + 1) ** 2)
    assert att._mla_scale(FULL) == pytest.approx(
        (0.1 * np.log(40) + 1) ** 2 / np.sqrt(192))
    assert R.softmax_scale(hf(FULL)) == pytest.approx(att._mla_scale(FULL))


@pytest.mark.parametrize("yarn", [True, False])
def test_mla_matches_reference(yarn):
    cfg = small_cfg()
    if not yarn:
        cfg = dataclasses.replace(cfg, rope_scaling=None)
    p = M.init_serving_model(cfg, 5, device="cpu")
    lay = p["segments"][0][0]
    x = _x((2, 9, cfg.d_model), 6)
    y, _ = att.mla_forward(lay["block"], cfg, x,
                           torch.arange(9).expand(2, 9))
    w = _block_weights(lay, cfg)
    close(R.mla(w, hf(cfg), x, R.EXACT), y, F32_REL)


# -- the router ---------------------------------------------------------------

def _router(cfg, seed):
    e, d = cfg.moe.n_experts, cfg.d_model
    return {"router": _x((d, e), seed) * d ** -0.5,
            "router_bias": 0.05 * _x((e,), seed + 1)}


def test_router_matches_reference_with_its_group_limit():
    cfg = small_cfg()
    m = cfg.moe
    p = _router(cfg, 11)
    x = _x((64, cfg.d_model), 12)
    ids, w, _ = moe.route_sigmoid(p, m, x)
    wr = {"router": p["router"].T, "router_bias": p["router_bias"]}
    rid, s, gap8, ggap = R.route(wr, hf(cfg), x)
    sure = (gap8 > GAP) & (ggap > GAP)
    assert int(sure.sum()) > 48
    assert torch.equal(ids.sort(-1).values[sure], rid.sort(-1).values[sure])
    close(R.weights_of(s, ids, hf(cfg)), w, F32_REL)
    assert torch.allclose(w.sum(-1), torch.full((64,), 2.5))
    # every choice lies in the topk_group groups, and leaving the limit
    # out chooses otherwise for some tokens
    groups = ids // (m.n_experts // m.n_group)
    assert int(max(len(set(g.tolist())) for g in groups)) <= m.topk_group
    free = dataclasses.replace(m, topk_group=m.n_group)
    ids_free, _, _ = moe.route_sigmoid(p, free, x)
    assert not torch.equal(ids_free.sort(-1).values, ids.sort(-1).values)


# -- the dropless MoE ----------------------------------------------------------

def _moe_layer(cfg, seed):
    p = M.init_serving_model(cfg, seed, device="cpu")
    lay = p["segments"][1][0]
    return tree_map(lambda t: t[0], lay) if lay["norm1"]["w"].dim() == 2 \
        else lay


@pytest.mark.parametrize("skew", [False, True])
def test_dropless_moe_matches_reference(skew):
    """Every token's 8 experts, each expert's tokens however many (with
    ``skew`` the bias sends every token to the same 8 experts of one
    group: 8 x T pairs on 8 experts, nothing dropped)."""
    cfg = small_cfg()
    lay = _moe_layer(cfg, 21)
    ffn = lay["ffn"]
    if skew:
        ffn["router_bias"] = torch.full_like(ffn["router_bias"], -10.0)
        ffn["router_bias"][:8] = 10.0
    t = 48
    x = _x((t, cfg.d_model), 22)
    log = {"tokens": torch.zeros(cfg.moe.n_experts, dtype=torch.int64),
           "stored": torch.zeros((), dtype=torch.int64),
           "ids": torch.zeros((t, 8), dtype=torch.int32)}
    ffn["route"] = log
    y, aux = moe.moe_forward(ffn, cfg, x[None])
    assert float(aux) == 0.0
    assert int(log["stored"]) == 8 * t * gg.column_blocks(cfg.d_model)
    assert int(log["tokens"].sum()) == 8 * t
    if skew:
        assert log["tokens"][:8].tolist() == [t] * 8
    w = _block_weights(lay, cfg)
    ex = w["experts"]
    yr, r = R.moe(w, lambda e: (ex[0][e], ex[1][e], ex[2][e]), hf(cfg), x,
                  R.EXACT, follow=log["ids"].long(), gap=GAP)
    assert not bool(r["apart"].any())
    close(yr, y[0], B9_REL)


def test_the_published_route_without_served_experts_raises():
    """Float32 master weights (``init_model``) hold no fp8 experts: the
    published route refuses them and names the two ways that have them."""
    cfg = small_cfg()
    p = M.init_model(cfg, 71, device="cpu")
    ffn = tree_map(lambda t: t[0], p["segments"][1][0]["ffn"])
    assert "experts" not in ffn
    with pytest.raises(ValueError, match="init_serving_model"):
        moe.moe_forward(ffn, cfg, _x((2, 10, cfg.d_model), 72))


def test_the_route_log_counts_the_rows_b9_stored():
    """``stored`` counts what the grouped GEMM wrote, not the plan: an
    expert whose last pair is cut from the plan leaves its row unwritten
    and the count one row short a column block."""
    cfg = small_cfg()
    ex = _moe_layer(cfg, 33)["ffn"]["experts"]
    t, k = 10, 8
    x = _x((t, cfg.d_model), 34).to(torch.bfloat16)
    ids = torch.rand((t, cfg.moe.n_experts),
                     generator=torch.Generator().manual_seed(5)).topk(
        k).indices
    w = torch.rand((t, k), generator=torch.Generator().manual_seed(6))
    plan = gg.expert_plan(ids, cfg.moe.n_experts)
    blocks = gg.column_blocks(cfg.d_model)
    stored = torch.zeros((), dtype=torch.int64)
    gg.grouped_ffn(x, plan, ex, w, stored)
    assert int(stored) == t * k * blocks
    busiest = int(plan.counts.argmax())
    plan.counts[busiest] -= 1
    stored.zero_()
    y = gg.grouped_ffn(x, plan, ex, w, stored)
    assert int(stored) == (t * k - 1) * blocks
    lost = int(plan.dst[plan.offsets[busiest] + plan.counts[busiest]])
    assert not bool(y[lost].any())


def test_expert_plan_sorts_pairs_by_expert():
    ids = torch.tensor([[3, 0], [3, 1], [0, 3], [2, 3]])
    plan = gg.expert_plan(ids, 5)
    assert plan.counts.tolist() == [2, 1, 1, 4, 0]
    assert plan.offsets.tolist() == [0, 2, 3, 4, 8]
    assert plan.tile_start.tolist() == [0, 1, 2, 3, 4, 4]
    assert plan.max_tiles == 1 + 5
    eid = ids.reshape(-1)[plan.order]
    assert eid.tolist() == sorted(eid.tolist())
    assert plan.order.tolist() == [1, 4, 3, 6, 0, 2, 5, 7]   # stable
    assert plan.src.tolist() == (plan.order // 2).tolist()
    big = gg.expert_plan(torch.zeros((2 * gg.BM + 1, 1), dtype=torch.int64),
                         3)
    assert big.tile_start.tolist() == [0, 3, 3, 3]


def test_expert_plan_walks_the_largest_experts_first():
    """The tile list both launches walk: the experts by pairs, most first
    (ties in expert order), ``tile_start`` the prefix of their row tiles of
    ``BM`` along that walk; ``tile_widths`` counts each tile at its pairs
    rounded up to 64."""
    counts = [3, 0, 600, 257, 256, 1, 64, 65]
    ids = torch.repeat_interleave(torch.arange(8), torch.tensor(counts))
    plan = gg.expert_plan(ids[torch.randperm(len(ids))][:, None], 8)
    assert plan.counts.tolist() == counts
    assert plan.walk.tolist() == [2, 3, 4, 7, 6, 0, 5, 1]
    assert plan.tile_start.tolist() == [0, 3, 5, 6, 7, 8, 9, 10, 10]
    assert gg.BM == 256 and gg.TILE_WIDTHS == (64, 128, 192, 256)
    # 600 = 2 x 256 + 88 (128), 257 = 256 + 1 (64), 256, 65 (128), 64, 3, 1
    assert gg.tile_widths(plan.counts).tolist() == [4, 2, 0, 4]
    # 192 (192); 193 (256); 511 = 256 + 255 (256)
    assert gg.tile_widths(torch.tensor([0, 192, 193, 511])).tolist() == [
        0, 0, 1, 3]


def test_grouped_ffn_counts_row_tiles_by_width():
    """The plan's ``shapes``, when set, gains the row tiles at each width
    (the plain version adds the plan's ``tile_widths``; the kernel counts
    the tiles its down launch ran), call after call; None counts none."""
    cfg = small_cfg()
    ex = _moe_layer(cfg, 35)["ffn"]["experts"]
    t, k = 40, 8
    x = _x((t, cfg.d_model), 36).to(torch.bfloat16)
    ids = torch.rand((t, cfg.moe.n_experts),
                     generator=torch.Generator().manual_seed(7)).topk(
        k).indices
    w = torch.rand((t, k), generator=torch.Generator().manual_seed(8))
    plan = gg.expert_plan(ids, cfg.moe.n_experts)
    y0 = gg.grouped_ffn(x, plan, ex, w)
    plan.shapes = torch.zeros(len(gg.TILE_WIDTHS), dtype=torch.int64)
    y1 = gg.grouped_ffn(x, plan, ex, w)
    gg.grouped_ffn(x, plan, ex, w)
    assert torch.equal(y0, y1)
    want = gg.tile_widths(plan.counts)
    assert int(want.sum()) == int((plan.counts > 0).sum())
    assert plan.shapes.tolist() == (2 * want).tolist()


def test_grouped_ffn_plain_equals_a_loop_over_pairs():
    cfg = small_cfg()
    ex = _moe_layer(cfg, 31)["ffn"]["experts"]
    t, k = 12, 8
    x = _x((t, cfg.d_model), 32).to(torch.bfloat16)
    ids = torch.rand((t, cfg.moe.n_experts),
                     generator=torch.Generator().manual_seed(3)).topk(
        k).indices
    w = torch.rand((t, k), generator=torch.Generator().manual_seed(4))
    y = gg.grouped_ffn(x, gg.expert_plan(ids, cfg.moe.n_experts), ex, w)
    blk = cfg.precision.block
    for ti in range(t):
        for ki in range(k):
            e = int(ids[ti, ki])
            wg, wu, wd = (dequantize_blocks(ex[n][e], ex[n + "_scale"][e],
                                            blk, torch.bfloat16).float()
                          for n in ("gate", "up", "down"))
            xf = x[ti].float()
            h = (torch.nn.functional.silu(wg @ xf) * (wu @ xf)).to(
                torch.bfloat16).float()
            want = ((wd @ h) * w[ti, ki]).to(torch.bfloat16)
            got = y[ti * k + ki]
            assert float((got.float() - want.float()).abs().max()) <= \
                2 ** -7 * float(want.float().abs().max()) + 1e-6


# -- whole models ----------------------------------------------------------------

def test_whole_model_logits_match_reference():
    """1 dense + 2 MoE layers, the served params in float32 activations
    (the experts as fp8 codes): the last position's logits over the whole
    vocabulary, the reference taking the program's routing only at ties."""
    cfg = small_cfg(n_layers=3)
    p = M.init_serving_model(cfg, 41, device="cpu")
    toks = _tokens(6, 8, 42)
    routes = moe.attach_route_log(p, cfg, toks.numel())
    got, _ = M.prefill(p, cfg, {"tokens": toks})
    follow = [r for r in routes[0]["ids"].long()]
    ref, rr = R.forward(reference_weights(p, cfg), hf(cfg), toks,
                        follow=follow, gap=GAP)
    assert len(rr) == 2 and not any(bool(r["apart"].any()) for r in rr)
    close(ref, got, LOGIT_REL)
    assert routes[0]["stored"].tolist() == [
        8 * toks.numel() * gg.column_blocks(cfg.d_model)] * 2
    assert routes[0]["shapes"].tolist() == [
        gg.tile_widths(c).tolist() for c in routes[0]["tokens"]]


def test_served_bf16_model_runs_and_stays_near_float32():
    """The same params held in bf16 as served: the logits of the bf16 run
    against the float32 run of the same draw."""
    cfg16 = small_cfg(activations="bfloat16")
    p16 = M.init_serving_model(cfg16, 43, device="cpu")
    p32 = M.init_serving_model(small_cfg(), 43, device="cpu")
    assert p16["embed"].dtype == torch.bfloat16
    assert torch.equal(p16["segments"][1][0]["ffn"]["experts"]["gate"].view(
        torch.uint8), p32["segments"][1][0]["ffn"]["experts"]["gate"].view(
        torch.uint8))
    toks = _tokens(4, 8, 44)
    l16, _ = M.prefill(p16, cfg16, {"tokens": toks})
    l32, _ = M.prefill(p32, small_cfg(), {"tokens": toks})
    assert l16.dtype == torch.bfloat16
    rel = float((l16.float() - l32).norm() / l32.norm())
    assert rel < 0.5


def test_hybrid_server_with_the_deepseek_backend():
    """``HybridServer`` over ``lm_backend`` of the served model: backend
    rows exact against the forwarded rows, the backend's kept logits of
    every capacity row against the reference on the same rows."""
    from repro_torch.core.mapping import map_tree_ensemble
    from repro_torch.data.unsw_like import make_unsw_like
    from repro_torch.ml.trees import fit_random_forest
    from repro_torch.serving.hybrid_serving import HybridServer
    cfg = small_cfg(n_layers=3)
    x, y = make_unsw_like(3000, seed=3, n_features=5)
    forest = fit_random_forest(x[:2000], y[:2000], n_classes=2, n_trees=4,
                               max_depth=3, seed=0, device="cpu")
    art = map_tree_ensemble(forest, 5)
    params = M.init_serving_model(cfg, 51, device="cpu")
    backend = serve.lm_backend(cfg, params)
    cap, tau = 32, 0.9
    server = HybridServer(art, backend, threshold=tau, capacity=cap,
                          fuse=None, device="cpu")
    rows = torch.as_tensor(x[2000:2512])
    pred, stats = server.classify(rows)
    from repro_torch.kernels.ops import fused_classify
    _, conf = fused_classify(server.artifact, rows, device="cpu")
    fwd = conf < tau
    assert stats.backend_rows == min(cap, int(fwd.sum()))
    n = torch.arange(len(rows))
    idx = torch.cat([n[fwd], n[~fwd]])[:cap]
    toks = (rows[idx, :8].abs() * 7).to(torch.int32) % cfg.vocab_size
    toks = torch.nn.functional.pad(toks, (0, 3))
    follow = [r for r in backend.chosen().long()]
    ref, rr = R.forward(reference_weights(params, cfg), hf(cfg), toks,
                        follow=follow, gap=GAP, head_rows=[0, 1])
    assert not any(bool(r["apart"].any()) for r in rr)
    close(ref, backend.logits, LOGIT_REL)
    assert backend.routed_pairs().tolist() == [8 * cap * 8] * 2
    served = idx[fwd[idx]]
    lm = (backend.logits[:, 0] > backend.logits[:, 1]).to(pred.dtype)
    assert torch.equal(pred[served], lm[fwd[idx]])
