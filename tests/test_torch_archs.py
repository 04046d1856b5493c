"""Every LM family of the PyTorch port against the JAX package: the six
families past the dense GQA decoders (MoE with a dense residual, MLA + MoE,
RG-LRU + local attention, mLSTM + sLSTM, Whisper's encoder-decoder, the
image-patch frontend) on their smoke configs, their blocks alone, and all
ten configs' shapes, layer plans and prefill-to-decode consistency. Params
are carried from JAX by ``params_from_arrays``, inputs made from numpy
seeds, the same calls on both sides.

Tolerances, each with its reason (entrywise, against the reference's
largest magnitude):
- ``REL`` = 1e-4: f32 matmuls and reductions that XLA and PyTorch associate
  differently, a few ulps after a few layers (as ``test_torch_lm.py``);
- ``SCAN_REL`` = 5e-4 for the RG-LRU family: the reference evaluates the
  linear recurrence with ``associative_scan``, the port by doubling; each
  h_t sums the same products in another tree, a few ulps per level of
  log2(S), and the recurrence carries them to every later position;
- ``MOE_REL`` = 1e-2 for the MoE families: the dispatch and the combine
  ride bf16, so an expert output that the two packages compute a few f32
  ulps apart can round to neighbouring bf16 values, one bf16 ulp (2^-8 of
  the element) apart; the port adds a token's units in the reference's
  order (ascending slot), so no other difference remains;
- int8 caches: ``INT8_REL`` = 1e-3 (the MoE families ``MOE_REL``) with
  argmax equal: a k or v one ulp apart can round to an int8 code one apart;
  the codes equal or +-1; the scales (absmax / 127 of a k or v that a
  deeper layer computes a few ulps apart) as every other float leaf;
- the aux loss within rtol 1e-5 (a sum over experts of f32 means);
- generated tokens equal, cache positions equal;
- prefill-to-decode consistency on the port's own params: the reference's
  own bounds (``tests/test_archs.py``), 0.05 for MoE (capacity drops
  differ between a prompt of S and one token) and 1e-3 otherwise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jatt
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import recurrent as jrec
from repro.models import transformer as jtfm
from repro.models import whisper as jwhi
from repro.serving.engine import _place_prefill_into_decode as jax_place
from repro.serving.engine import greedy_generate as jax_generate
from repro_torch.analysis.dispatch_utils import OpRecorder
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import attention as att
from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.models import recurrent as rec
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whi
from repro_torch.serving.engine import (ServeEngine,
                                        _place_prefill_into_decode,
                                        greedy_generate)
from test_torch_cuda import fill_quantized

NEW = ["deepseek-v3-671b", "arctic-480b", "xlstm-1.3b", "whisper-base",
       "phi-3-vision-4.2b", "recurrentgemma-2b"]
GQA_NEW = ["arctic-480b", "phi-3-vision-4.2b", "recurrentgemma-2b"]
GQA_ALL = ["qwen3-4b", "yi-6b", "qwen2.5-32b", "h2o-danube-1.8b"] + GQA_NEW
REL, SCAN_REL, MOE_REL, INT8_REL = 1e-4, 5e-4, 1e-2, 1e-3
B, S = 2, 12


def _rel(cfg, base=REL):
    if cfg.moe is not None:
        return MOE_REL
    if "rglru" in cfg.block_pattern:
        return max(base, SCAN_REL)
    return base


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _t(tree):
    """A JAX tree as the port's (CPU tensors, tuples kept)."""
    return tfm.tree_map(lambda a: torch.from_numpy(np.array(a)),
                        jax.tree.map(np.asarray, tree))


def _close(ref, got, rel):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    bound = rel * float(np.abs(ref).max())
    err = float(np.abs(ref.astype(np.float64) - got).max())
    assert err <= bound, (err, bound)


def _flat(tree, path=()):
    """Leaves of a dict / list / tuple tree, keyed by path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (i,)))
        return out
    return {path: _np(tree)}


def _compare_caches(ref, got, rel):
    ref, got = _flat(ref), _flat(got)
    assert ref.keys() == got.keys()
    for key in ref:
        if key[-1] == "pos":
            np.testing.assert_array_equal(got[key], ref[key])
        else:
            _close(ref[key], got[key], rel)


def _batch(cfg, b=B, s=S, seed=1):
    """numpy tokens (+ frames / patch embeddings) from a seed."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    front = (cfg.n_frontend_tokens, cfg.frontend_dim)
    if cfg.encdec:
        batch["frames"] = (0.1 * rng.standard_normal((b,) + front)).astype(
            np.float32)
    if cfg.frontend == "image_patches":
        batch["patch_embeds"] = (0.1 * rng.standard_normal((b,) + front)
                                 ).astype(np.float32)
    return batch


def _n_front(cfg):
    return cfg.n_frontend_tokens if cfg.frontend == "image_patches" else 0


def _cut(batch, s):
    return dict(batch, tokens=batch["tokens"][:, :s])


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _arch(a):
    """(JAX cfg, JAX params, port cfg, port params, batch)."""
    jcfg = jax_smoke(a)
    jparams = JM.init_model(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(a)
    params = M.params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return jcfg, jparams, cfg, params, _batch(cfg)


@pytest.fixture(params=NEW)
def arch(request):
    return _arch(request.param)


# ---------------------------------------------------------------------------
# int8 cache fill (the reference's tests/test_int8_kv.py helper, extended to
# every cache kind: an int8 GQA cache takes the quantized K/V, every other
# leaf the prefill's values in its leading slots); the port's side is
# test_torch_cuda.fill_quantized
# ---------------------------------------------------------------------------

def _jax_fill(dst, src):
    if isinstance(dst, dict) and "k_scale" in dst:
        out = dict(dst)
        for key in ("k", "v"):
            q, sc = jatt._q8(src[key])
            out[key] = dst[key].at[tuple(slice(0, x) for x in q.shape)].set(q)
            out[key + "_scale"] = dst[key + "_scale"].at[
                tuple(slice(0, x) for x in sc.shape)].set(sc)
        n = src["pos"].shape[-1]
        out["pos"] = dst["pos"].at[..., :n].set(src["pos"])
        return out
    if isinstance(dst, dict):
        return {k: _jax_fill(dst[k], src[k]) for k in dst}
    if isinstance(dst, (list, tuple)):
        return type(dst)(_jax_fill(d, s) for d, s in zip(dst, src))
    return jax_place(dst, src)


# ---------------------------------------------------------------------------
# the six families against the JAX package
# ---------------------------------------------------------------------------

def test_prefill_matches_jax(arch):
    jcfg, jparams, cfg, params, batch = arch
    lj, cj = JM.prefill(jparams, jcfg, _jb(batch))
    lt, ct = M.prefill(params, cfg, batch)
    _close(lj, lt, _rel(cfg))
    _compare_caches(cj, ct, _rel(cfg))


def _decode_pair(arch, quantize):
    """Prefill S-1 tokens, place them into a decode cache (float, or int8
    where there are GQA layers), decode token S-1 on both sides."""
    jcfg, jparams, cfg, params, batch = arch
    pos = S - 1 + _n_front(cfg)
    max_len = S + _n_front(cfg) + 4
    _, pj = JM.prefill(jparams, jcfg, _jb(_cut(batch, S - 1)))
    dj = _jax_fill(JM.init_decode_cache(jcfg, B, max_len, dtype=jnp.float32,
                                        quantize_kv=quantize), pj)
    tok = batch["tokens"][:, S - 1]
    lj, nj = JM.decode_step(jparams, jcfg, jnp.asarray(tok), pos, dj)
    _, pt = M.prefill(params, cfg, _cut(batch, S - 1))
    dt = fill_quantized(
        M.init_decode_cache(cfg, B, max_len, dtype=torch.float32,
                            quantize_kv=quantize, device="cpu"), pt)
    ptrs = [a.data_ptr() for a in tfm.tree_leaves(dt)]
    lt, nt = M.decode_step(params, cfg, tok, pos, dt)
    assert [a.data_ptr() for a in tfm.tree_leaves(nt)] == ptrs
    return dj, (lj, nj), (lt, nt)


def test_float_decode_matches_jax(arch):
    _, (lj, nj), (lt, nt) = _decode_pair(arch, False)
    cfg = arch[2]
    _close(lj, lt, _rel(cfg))
    _compare_caches(nj, nt, _rel(cfg))


@pytest.mark.parametrize("a", GQA_NEW)
def test_int8_decode_matches_jax(a):
    dj, (lj, nj), (lt, nt) = _decode_pair(_arch(a), True)
    jcfg, jparams, cfg, params, batch = _arch(a)
    _close(lj, lt, _rel(cfg, INT8_REL))
    np.testing.assert_array_equal(_np(lt).argmax(-1),
                                  np.asarray(lj).argmax(-1))
    # the reference's own int8 cache, carried across: the same codes in
    # both decode steps leave the matmul and softmax order
    carried = M.cache_from_arrays(jax.tree.map(np.asarray, dj), device="cpu")
    lc, _ = M.decode_step(params, cfg, batch["tokens"][:, S - 1],
                          S - 1 + _n_front(cfg), carried)
    _close(lj, lc, _rel(cfg))
    ref, got = _flat(nj), _flat(nt)
    assert any(key[-1] == "k_scale" for key in ref)
    for key in ref:
        if key[-1] in ("k", "v") and got[key].dtype == np.int8:
            gap = np.abs(got[key].astype(np.int32) - ref[key].astype(np.int32))
            assert gap.max() <= 1, key
        elif key[-1] == "pos":
            np.testing.assert_array_equal(got[key], ref[key])
        else:
            _close(ref[key], got[key], _rel(cfg))


def test_greedy_generate_matches_jax(arch):
    jcfg, jparams, cfg, params, batch = arch
    ref = jax_generate(jcfg, jparams, _jb(_cut(batch, 8)), n_new=6)
    got = greedy_generate(cfg, params, _cut(batch, 8), n_new=6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_recurrentgemma_ring_wraps():
    """A prompt longer than the smoke local window (16): the prefill keeps
    the last 16 positions in ring order, and decode and generation wrap the
    ring, as the reference's do."""
    a = "recurrentgemma-2b"
    jcfg, cfg = jax_smoke(a), get_smoke_config(a)
    jparams = JM.init_model(jcfg, jax.random.PRNGKey(2))
    params = M.params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    batch = _batch(cfg, s=24, seed=3)
    assert batch["tokens"].shape[1] > cfg.local_window
    lj, cj = JM.prefill(jparams, jcfg, _jb(batch))
    lt, ct = M.prefill(params, cfg, batch)
    _close(lj, lt, SCAN_REL)
    _compare_caches(cj, ct, SCAN_REL)
    ref = jax_generate(jcfg, jparams, _jb(batch), n_new=6)
    got = greedy_generate(cfg, params, batch, n_new=6)
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


# ---------------------------------------------------------------------------
# blocks alone
# ---------------------------------------------------------------------------

def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("case", ["arctic", "deepseek", "drops"])
def test_moe_forward_matches_jax(case):
    """Arctic's dense residual, DeepSeek's shared expert, and a capacity so
    small that units are dropped (cap 8 for 128 units over 4 experts)."""
    a = "deepseek-v3-671b" if case == "deepseek" else "arctic-480b"
    jcfg, cfg = jax_smoke(a), get_smoke_config(a)
    b, s = (4, 16) if case == "drops" else (2, 7)
    if case == "drops":
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=0.25))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.25))
        cap = moe._capacity(b * s, cfg.moe.top_k, cfg.moe.n_experts, 0.25)
        assert cap * cfg.moe.n_experts < b * s * cfg.moe.top_k
    jp = jmoe.moe_params(jax.random.PRNGKey(7), jcfg)
    x = _x((b, s, cfg.d_model), 7)
    yj, auxj = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    yt, auxt = moe.moe_forward(_t(jp), cfg, torch.from_numpy(x))
    _close(yj, yt, MOE_REL)
    np.testing.assert_allclose(float(auxt), float(auxj), rtol=1e-5)


@pytest.mark.parametrize("s", [9, 2048])
def test_mla_forward_matches_jax(s):
    """Short prefill (dense scores) and S = 2048, which takes
    flash_attention in both packages."""
    jcfg, cfg = jax_smoke("deepseek-v3-671b"), get_smoke_config(
        "deepseek-v3-671b")
    jp = jatt.mla_params(jax.random.PRNGKey(5), jcfg)
    b = 2 if s < 2048 else 1
    x = _x((b, s, cfg.d_model), s)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    yj, (cj, rj) = jatt.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    yt, (ct, rt) = att.mla_forward(_t(jp), cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos))
    _close(yj, yt, REL)
    _close(cj, ct, REL)
    _close(rj, rt, REL)


@pytest.mark.parametrize("absorb", [True, False])
def test_mla_decode_matches_jax(absorb):
    jcfg, cfg = jax_smoke("deepseek-v3-671b"), get_smoke_config(
        "deepseek-v3-671b")
    jp = jatt.mla_params(jax.random.PRNGKey(6), jcfg)
    p = _t(jp)
    b, s = 2, 9
    x = _x((b, s, cfg.d_model), 11)
    pos = np.broadcast_to(np.arange(s - 1, dtype=np.int32), (b, s - 1)).copy()
    _, (c, r) = jatt.mla_forward(jp, jcfg, jnp.asarray(x[:, :-1]),
                                 jnp.asarray(pos))
    jc = jatt.init_mla_cache(jcfg, b, s + 3, jnp.float32)
    jc = {"c_kv": jc["c_kv"].at[:, :s - 1].set(c),
          "k_rope": jc["k_rope"].at[:, :s - 1].set(r)}
    tc = _t(jc)
    yj, nj = jatt.mla_decode(jp, jcfg, jnp.asarray(x[:, -1:]), s - 1, jc,
                             absorb=absorb)
    yt, nt = att.mla_decode(p, cfg, torch.from_numpy(x[:, -1:]),
                            torch.tensor(s - 1), tc, absorb=absorb)
    assert nt is tc
    _close(yj, yt, REL)
    _compare_caches(nj, nt, REL)


REC_CASES = [("rglru", "recurrentgemma-2b"), ("mlstm", "xlstm-1.3b"),
             ("slstm", "xlstm-1.3b")]


@pytest.mark.parametrize("kind,a", REC_CASES)
def test_recurrent_block_matches_jax(kind, a):
    jcfg, cfg = jax_smoke(a), get_smoke_config(a)
    jp = getattr(jrec, f"{kind}_params")(jax.random.PRNGKey(8), jcfg)
    x = _x((2, 11, cfg.d_model), 8, 0.5)
    yj, sj = getattr(jrec, f"{kind}_block")(jp, jcfg, jnp.asarray(x))
    yt, st = getattr(rec, f"{kind}_block")(_t(jp), cfg, torch.from_numpy(x))
    rel = SCAN_REL if kind == "rglru" else REL
    _close(yj, yt, rel)
    _compare_caches(sj, st, rel)


@pytest.mark.parametrize("kind,a", REC_CASES)
def test_recurrent_decode_matches_jax(kind, a):
    """One decode step from the block's state after 10 positions: the
    output and the state, written in place."""
    jcfg, cfg = jax_smoke(a), get_smoke_config(a)
    jp = getattr(jrec, f"{kind}_params")(jax.random.PRNGKey(9), jcfg)
    x = _x((2, 11, cfg.d_model), 9, 0.5)
    _, sj = getattr(jrec, f"{kind}_block")(jp, jcfg, jnp.asarray(x[:, :-1]))
    st = _t(sj)
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    yj, nj = getattr(jrec, f"{kind}_block_decode")(jp, jcfg,
                                                   jnp.asarray(x[:, -1:]), sj)
    yt, nt = getattr(rec, f"{kind}_block_decode")(_t(jp), cfg,
                                                  torch.from_numpy(x[:, -1:]),
                                                  st)
    assert nt is st and {k: v.data_ptr() for k, v in nt.items()} == ptrs
    _close(yj, yt, REL)
    _compare_caches(nj, nt, REL)


def test_whisper_encode_and_cross_attention_match_jax():
    jcfg, cfg = jax_smoke("whisper-base"), get_smoke_config("whisper-base")
    jparams = jwhi.init_params(jcfg, jax.random.PRNGKey(4))
    params = M.params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    frames = _x((2, cfg.n_frontend_tokens, cfg.d_model), 4, 0.1)
    ej = jwhi.encode(jparams, jcfg, jnp.asarray(frames))
    et = whi.encode(params, cfg, torch.from_numpy(frames))
    _close(ej, et, REL)
    lp = jax.tree.map(lambda a: a[0], jparams["dec_layers"])["cross"]
    kvj = jatt.encode_cross_kv(lp, jcfg, ej)
    kvt = att.encode_cross_kv(_t(lp), cfg, et)
    for a, b in zip(kvj, kvt):
        _close(a, b, REL)
    x = _x((2, 5, cfg.d_model), 5)
    _close(jatt.cross_attention(lp, jcfg, jnp.asarray(x), kvj),
           att.cross_attention(_t(lp), cfg, torch.from_numpy(x), kvt), REL)


def test_gelu_mlp_and_sinusoidal_positions_match_jax():
    jp = jlayers.gelu_mlp_params(jax.random.PRNGKey(3), 16, 40)
    x = _x((3, 5, 16), 3)
    _close(jlayers.gelu_mlp(jp, jnp.asarray(x)),
           layers.gelu_mlp(_t(jp), torch.from_numpy(x)), 1e-6)
    np.testing.assert_array_equal(
        layers.sinusoidal_positions(37, 24).numpy(),
        np.asarray(jlayers.sinusoidal_positions(37, 24)))


def test_mlstm_chunked_equals_single_chunk(monkeypatch):
    """Chunkwise mLSTM (two chunks of 4) == one-chunk (quadratic)
    evaluation, on the port's own params (reference:
    tests/test_archs.py::test_mlstm_chunked_equals_single_chunk)."""
    cfg = get_smoke_config("xlstm-1.3b")
    p = rec.mlstm_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(_x((2, 8, cfg.d_model), 5, 0.5))
    y_single, st1 = rec.mlstm_block(p, cfg, x)       # S=8 -> single chunk
    monkeypatch.setattr(rec, "MLSTM_CHUNK", 4)
    y_multi, st2 = rec.mlstm_block(p, cfg, x)
    torch.testing.assert_close(y_single, y_multi, rtol=2e-4, atol=2e-5)
    torch.testing.assert_close(st1["C"], st2["C"], rtol=2e-4, atol=2e-5)


# ---------------------------------------------------------------------------
# all ten configs
# ---------------------------------------------------------------------------

def _shape_tree(tree):
    if isinstance(tree, torch.Size):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shape_tree(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("a", ARCH_IDS)
def test_full_param_shapes_match_reference(a):
    """The full config's param shape tree (on ``meta``, nothing allocated)
    equals the reference's ``model_param_shapes``, and so do the total and
    active parameter counts."""
    cfg, jcfg = get_config(a), jax_config(a)
    shapes = M.model_param_shapes(cfg)
    jshapes = JM.model_param_shapes(jcfg)
    assert _shape_tree(shapes) == _shape_tree(jshapes)
    n = M.count_params(shapes)
    assert n == JM.count_params(jshapes) and n > 50e6
    assert M.active_params(cfg, n) == JM.active_params(jcfg, n)


@pytest.mark.parametrize("a", ARCH_IDS)
def test_layer_plan_matches_reference(a):
    assert tfm.layer_plan(get_config(a)) == jtfm.layer_plan(jax_config(a))
    assert tfm.layer_plan(get_smoke_config(a)) == jtfm.layer_plan(
        jax_smoke(a))


@pytest.mark.parametrize("a", ARCH_IDS)
def test_prefill_decode_consistency(a):
    """Decoding token S-1 after a prefill of S-1 tokens gives the logits
    of a prefill of all S (the port's counterpart of the reference's
    tests/test_archs.py::test_prefill_decode_consistency, on the port's
    own params)."""
    cfg = get_smoke_config(a)
    params = M.init_model(cfg, 0, device="cpu")
    batch = _batch(cfg)
    ref, _ = M.prefill(params, cfg, batch)
    _, caches = M.prefill(params, cfg, _cut(batch, S - 1))
    n_front = _n_front(cfg)
    dc = _place_prefill_into_decode(
        M.init_decode_cache(cfg, B, S + n_front + 4, dtype=torch.float32,
                            device="cpu"), caches)
    got, _ = M.decode_step(params, cfg, batch["tokens"][:, S - 1],
                           S - 1 + n_front, dc)
    err = float((ref - got).abs().max())
    tol = 0.05 if cfg.moe is not None else 1e-3
    assert err < tol, (a, err)


@pytest.mark.parametrize("a,int8", [(a, False) for a in ARCH_IDS]
                         + [(a, True) for a in GQA_ALL])
def test_decode_step_reads_nothing_on_the_host(a, int8):
    """One decode step of every family, its position a 0-dim tensor on the
    device, under the op recorder: no ``aten._local_scalar_dense`` (an
    ``int()``, ``.item()`` or ``bool()`` of a tensor) and no copy across
    devices, so a CUDA graph can capture it."""
    cfg = get_smoke_config(a)
    params = M.init_model(cfg, 0, device="cpu")
    batch = _batch(cfg)
    _, pc = M.prefill(params, cfg, _cut(batch, S - 1))
    n_front = _n_front(cfg)
    caches = fill_quantized(
        M.init_decode_cache(cfg, B, S + n_front + 4, dtype=torch.float32,
                            quantize_kv=int8, device="cpu"), pc)
    tok = torch.from_numpy(batch["tokens"][:, S - 1])
    pos = torch.tensor(S - 1 + n_front)
    with OpRecorder() as recorder:
        logits, _ = M.decode_step(params, cfg, tok, pos, caches)
    assert recorder.ops and not recorder.syncs, recorder.syncs
    assert not any("_local_scalar_dense" in op for op in recorder.ops)
    assert bool(torch.isfinite(logits).all())


def test_engine_on_the_cpu_steps_eagerly():
    """A CPU engine decodes eagerly: the same logits as ``decode_step``,
    the same cache objects."""
    cfg = get_smoke_config("xlstm-1.3b")
    params = M.init_model(cfg, 0, device="cpu")
    eng = ServeEngine(cfg, params, batch=B, max_len=S)
    assert eng.graph is False
    batch = _batch(cfg)
    _, pc = eng.prefill(_cut(batch, S - 1))
    caches = [M.init_decode_cache(cfg, B, S, dtype=torch.float32,
                                  device="cpu") for _ in range(2)]
    caches = [_place_prefill_into_decode(c, pc) for c in caches]
    tok = batch["tokens"][:, S - 1]
    want, _ = M.decode_step(params, cfg, tok, S - 1, caches[0])
    got, out = eng.decode(torch.from_numpy(tok), S - 1, caches[1])
    assert out is caches[1]
    assert torch.equal(got, want)
