"""The LM side of the PyTorch port against the JAX package, on the smoke
configs of the four dense GQA decoders: params carried from JAX by
``params_from_arrays``, inputs from numpy seeds, the same calls on both.

Tolerances, each with its reason:
- prefill logits within 1e-4 * max|logits|, and the prefill caches within
  1e-4 * max|cache| (entrywise): f32 matmuls and reductions that XLA and
  PyTorch associate differently, a few ulps after two layers;
- float-cache decode logits within 1e-4 * max|logits|, for the same reason;
- int8-cache decode logits within 1e-3 * max|logits| with argmax equal: a k
  or v one ulp apart can round to an int8 code one apart, a 1/127 step of
  its row's scale; the int8 codes equal or +-1 and the scales within
  rtol 1e-6 (eager JAX divides by 127, XLA's scanned decode step multiplies
  by float32(1/127): one ulp);
- generated tokens and the launcher's backend classes equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as jatt
from repro.models import model as JM
from repro.serving.engine import greedy_generate as jax_generate
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as att
from repro_torch.models import model as M
from repro_torch.serving.engine import (ServeEngine,
                                        _place_prefill_into_decode,
                                        greedy_generate)
from test_torch_cuda import fill_quantized

ARCHS = ["qwen3-4b", "yi-6b", "qwen2.5-32b", "h2o-danube-1.8b"]
B, S = 2, 12


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(arch id, JAX cfg, JAX params, port cfg, port params, tokens)."""
    a = request.param
    jcfg = jax_smoke(a)
    jparams = JM.init_model(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config(a)
    params = M.params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return a, jcfg, jparams, cfg, params, toks


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(ref, got, rel):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape
    bound = rel * float(np.abs(ref).max())
    err = float(np.abs(ref.astype(np.float64) - got).max())
    assert err <= bound, (err, bound)


def _flat(cache):
    """Leaves of a segment-aligned cache, keyed by path."""
    out = {}
    for si, seg in enumerate(cache):
        for li, layer in enumerate(seg):
            for k, v in layer.items():
                out[(si, li, k)] = _np(v)
    return out


def _compare_caches(ref, got, rel):
    ref, got = _flat(ref), _flat(got)
    assert ref.keys() == got.keys()
    for key in ref:
        if key[2] == "pos":
            np.testing.assert_array_equal(got[key], ref[key])
        else:
            _close(ref[key], got[key], rel)


# ---------------------------------------------------------------------------
# int8 cache fill (the reference's tests/test_int8_kv.py helper, both sides)
# ---------------------------------------------------------------------------

def _jax_fill_quantized(dst, src):
    if isinstance(dst, dict) and "k_scale" in dst:
        out = dict(dst)
        for key in ("k", "v"):
            q, sc = jatt._q8(src[key])
            out[key] = dst[key].at[tuple(slice(0, x) for x in q.shape)].set(q)
            out[key + "_scale"] = dst[key + "_scale"].at[
                tuple(slice(0, x) for x in sc.shape)].set(sc)
        out["pos"] = dst["pos"].at[:src["pos"].shape[-1]].set(src["pos"]) \
            if dst["pos"].ndim == 1 else \
            dst["pos"].at[:, :src["pos"].shape[-1]].set(src["pos"])
        return out
    return [_jax_fill_quantized(d, s) for d, s in zip(dst, src)]


# ---------------------------------------------------------------------------
# prefill, flash attention, decode
# ---------------------------------------------------------------------------

def test_prefill_matches_jax(arch):
    _, jcfg, jparams, cfg, params, toks = arch
    lj, cj = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    lt, ct = M.prefill(params, cfg, {"tokens": toks})
    _close(lj, lt, 1e-4)
    _compare_caches(cj, ct, 1e-4)


@pytest.mark.parametrize("window,q_block,k_block,s", [
    (None, 8, 8, 30), (None, 8, 4, 30), (6, 4, 8, 29)])
def test_flash_attention_matches_jax(window, q_block, k_block, s):
    """Small blocks, a ragged length (padding) and a sliding window."""
    rng = np.random.default_rng(s)
    q = rng.normal(size=(2, s, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, s, 2, 16)).astype(np.float32)
    ref = jatt.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               window=window, q_block=q_block,
                               k_block=k_block)
    got = att.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), window=window,
                              q_block=q_block, k_block=k_block)
    _close(ref, got, 1e-5)
    # and the dense masked attention it stands for
    dense = att._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                      torch.from_numpy(v),
                      att.causal_mask(s, s, window), att._inv_sqrt(16))
    _close(dense, got, 1e-5)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_gqa_forward_matches_jax(bidirectional):
    """Full-sequence GQA attention (qk-norm, rope, sliding window)."""
    jcfg = jax_smoke("qwen3-4b").scaled(sliding_window=5)
    cfg = get_smoke_config("qwen3-4b").scaled(sliding_window=5)
    jp = jatt.gqa_params(jax.random.PRNGKey(4), jcfg)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).normal(size=(2, 9, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    yj, (kj, vj) = jatt.gqa_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                    window=5, bidirectional=bidirectional)
    yt, (kt, vt) = att.gqa_forward(p, cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos.copy()), window=5,
                                   bidirectional=bidirectional)
    _close(yj, yt, 1e-4)
    _close(kj, kt, 1e-4)
    _close(vj, vt, 1e-4)


def test_long_prefill_takes_flash_and_matches_jax():
    """A 2048-token prompt goes through flash_attention in both packages."""
    jcfg, cfg = jax_smoke("h2o-danube-1.8b"), get_smoke_config("h2o-danube-1.8b")
    jparams = JM.init_model(jcfg, jax.random.PRNGKey(3))
    params = M.params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    toks = np.random.default_rng(2).integers(0, 256, (1, 2048)).astype(np.int32)
    lj, cj = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    lt, ct = M.prefill(params, cfg, {"tokens": toks})
    _close(lj, lt, 1e-4)
    _compare_caches(cj, ct, 1e-4)


def test_float_decode_matches_jax(arch):
    _, jcfg, jparams, cfg, params, toks = arch
    _, pj = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S - 1])})
    dj = JM.init_decode_cache(jcfg, B, S + 4, dtype=jnp.float32)
    from repro.serving.engine import _place_prefill_into_decode as jplace
    dj = jplace(dj, pj)
    lj, nj = JM.decode_step(jparams, jcfg, jnp.asarray(toks[:, S - 1]),
                            S - 1, dj)

    _, pt = M.prefill(params, cfg, {"tokens": toks[:, :S - 1]})
    dt = M.init_decode_cache(cfg, B, S + 4, dtype=torch.float32, device="cpu")
    dt = _place_prefill_into_decode(dt, pt)
    lt, nt = M.decode_step(params, cfg, toks[:, S - 1], S - 1, dt)
    _close(lj, lt, 1e-4)
    _compare_caches(nj, nt, 1e-4)
    assert nt is dt or all(a is b for a, b in zip(nt, dt))


def test_int8_decode_matches_jax(arch):
    _, jcfg, jparams, cfg, params, toks = arch
    _, pj = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks[:, :S - 1])})
    dj = _jax_fill_quantized(
        JM.init_decode_cache(jcfg, B, S + 4, dtype=jnp.float32,
                             quantize_kv=True), pj)
    lj, nj = JM.decode_step(jparams, jcfg, jnp.asarray(toks[:, S - 1]),
                            S - 1, dj)

    _, pt = M.prefill(params, cfg, {"tokens": toks[:, :S - 1]})
    dt = fill_quantized(
        M.init_decode_cache(cfg, B, S + 4, dtype=torch.float32,
                            quantize_kv=True, device="cpu"), pt)
    lt, nt = M.decode_step(params, cfg, toks[:, S - 1], S - 1, dt)
    _close(lj, lt, 1e-3)
    np.testing.assert_array_equal(_np(lt).argmax(-1), np.asarray(lj).argmax(-1))
    # the reference's own int8 cache, carried across: the same codes in
    # both decode steps leave the matmul and softmax order (1e-4)
    carried = M.cache_from_arrays(jax.tree.map(np.asarray, dj), device="cpu")
    lc, _ = M.decode_step(params, cfg, toks[:, S - 1], S - 1, carried)
    _close(lj, lc, 1e-4)
    ref, got = _flat(nj), _flat(nt)
    for key in ref:
        if key[2] in ("k", "v"):
            assert got[key].dtype == np.int8
            gap = np.abs(got[key].astype(np.int32) - ref[key].astype(np.int32))
            assert gap.max() <= 1, key
        elif key[2] == "pos":
            np.testing.assert_array_equal(got[key], ref[key])
        else:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=0)


def test_greedy_generate_matches_jax(arch):
    _, jcfg, jparams, cfg, params, toks = arch
    ref = jax_generate(jcfg, jparams, {"tokens": jnp.asarray(toks[:, :8])},
                       n_new=6)
    got = greedy_generate(cfg, params, {"tokens": toks[:, :8]}, n_new=6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_engine_decodes_in_place(arch):
    """ServeEngine: prefill, place into an int8 cache, decode two steps; the
    cache tensors are written where they lie (no copy per step)."""
    _, _, _, cfg, params, toks = arch
    eng = ServeEngine(cfg, params, batch=B, max_len=S + 4)
    logits, pcache = eng.prefill({"tokens": toks})
    caches = fill_quantized(
        M.init_decode_cache(cfg, B, S + 4, dtype=torch.float32,
                            quantize_kv=True, device="cpu"), pcache)
    ptrs = {k: v.data_ptr() for k, v in caches[0][0].items()}
    for i in range(2):
        nxt = logits.argmax(-1).to(torch.int32)
        logits, caches = eng.decode(nxt, S + i, caches)
        assert bool(torch.isfinite(logits).all())
    assert {k: v.data_ptr() for k, v in caches[0][0].items()} == ptrs
    pos = caches[0][0]["pos"]
    size = pos.shape[-1]
    assert (pos[..., (S + 1) % size] == S + 1).all()


# ---------------------------------------------------------------------------
# the reference's own properties, on the port's own params
# ---------------------------------------------------------------------------

def test_greedy_generate_deterministic():
    cfg = get_smoke_config("yi-6b")
    params = M.init_model(cfg, 0, device="cpu")
    batch = {"tokens": torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8]],
                                    dtype=torch.int32)}
    o1 = greedy_generate(cfg, params, batch, n_new=6)
    o2 = greedy_generate(cfg, params, batch, n_new=6)
    assert torch.equal(o1, o2)


def test_generate_matches_rerun_prefill():
    """Token t generated with caches == argmax of prefill(prompt+prefix)."""
    cfg = get_smoke_config("h2o-danube-1.8b")
    params = M.init_model(cfg, 0, device="cpu")
    prompt = torch.tensor([[3, 1, 4, 1, 5, 9, 2, 6]], dtype=torch.int32)
    out = greedy_generate(cfg, params, {"tokens": prompt}, n_new=3,
                          cache_dtype=torch.float32)
    full = torch.cat([prompt, out[:, :2]], dim=1)
    logits, _ = M.prefill(params, cfg, {"tokens": full})
    assert torch.equal(out[:, 2], logits.argmax(-1).to(torch.int32))


def test_int8_kv_decode_close_and_halves_bytes():
    cfg = get_smoke_config("qwen2.5-32b")
    params = M.init_model(cfg, 0, device="cpu")
    b, s = 2, 12
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         dtype=torch.int32)
    ref, _ = M.prefill(params, cfg, {"tokens": toks})
    _, caches = M.prefill(params, cfg, {"tokens": toks[:, :s - 1]})
    dcq = fill_quantized(M.init_decode_cache(
        cfg, b, s + 4, dtype=torch.float32, quantize_kv=True, device="cpu"),
        caches)
    lq, _ = M.decode_step(params, cfg, toks[:, s - 1], s - 1, dcq)
    rel = float((ref - lq).abs().max() / ref.abs().max())
    assert rel < 0.05, rel
    assert torch.equal(ref.argmax(-1), lq.argmax(-1))

    def nbytes(tree):
        return sum(v.numel() * v.element_size()
                   for seg in tree for layer in seg for v in layer.values())

    bf16 = nbytes(M.init_decode_cache(cfg, 4, 64, device="cpu"))
    i8 = nbytes(M.init_decode_cache(cfg, 4, 64, quantize_kv=True,
                                    device="cpu"))
    assert i8 < 0.65 * bf16, (i8, bf16)


# ---------------------------------------------------------------------------
# registry, converters, launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ["deepseek-v3-671b", "arctic-480b",
                                     "xlstm-1.3b", "whisper-base",
                                     "phi-3-vision-4.2b",
                                     "recurrentgemma-2b"])
def test_outside_the_slice_raises(arch_id):
    cfg = get_smoke_config(arch_id)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_model(cfg, 0, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        M.init_decode_cache(cfg, 1, 8, device="cpu")


def test_param_count_and_converter_checks():
    from repro_torch.configs import get_config
    assert M.count_params(M.model_param_shapes(get_config("qwen3-4b"))) \
        == 4_411_424_256
    cfg = get_smoke_config("qwen3-4b")
    jparams = jax.tree.map(np.asarray,
                           JM.init_model(jax_smoke("qwen3-4b"),
                                         jax.random.PRNGKey(0)))
    assert M.count_params(M.params_from_arrays(cfg, jparams, device="cpu")) \
        == M.count_params(M.model_param_shapes(cfg))
    bad = dict(jparams, embed=jparams["embed"][:, :8])
    with pytest.raises(ValueError, match="embed"):
        M.params_from_arrays(cfg, bad, device="cpu")


def test_serve_lm_backend_on_cpu():
    """``launch.serve --backend lm --device cpu`` at a reduced size runs end
    to end, and its backend classes equal the reference's LM backend's on
    the same rows with the same (carried) weights."""
    from repro_torch.launch import serve
    res = serve.main(["--backend", "lm", "--device", "cpu",
                      "--n-samples", "4000", "--batch", "256",
                      "--capacity", "128"])
    assert res["pred"].shape == (res["batches"] * 256,)
    assert set(res["pred"].unique().tolist()) <= {0, 1}
    assert np.isfinite(res["acc"])
    assert res["server"]._fused_ok is False        # a CPU server is eager

    jcfg = jax_smoke("qwen3-4b")
    jparams = JM.init_model(jcfg, jax.random.PRNGKey(0))
    cfg = get_smoke_config("qwen3-4b")
    params = M.params_from_arrays(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    rows = res["x_test"][:128]

    # the reference's backend_fn (repro/launch/serve.py:88-94)
    jrows = jnp.asarray(rows.numpy())
    jt = (jnp.abs(jrows[:, :8]) * 7).astype(jnp.int32) % jcfg.vocab_size
    jt = jnp.pad(jt, ((0, 0), (0, max(0, 8 - jt.shape[1]))))
    jl, _ = JM.prefill(jparams, jcfg, {"tokens": jt})
    ref = np.asarray((jl[:, 0] > jl[:, 1]).astype(jnp.int32))

    got = serve.lm_backend(cfg, params)(rows)
    np.testing.assert_array_equal(_np(got), ref)
