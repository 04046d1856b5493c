"""LM training in the PyTorch port against the JAX package: the loss and
its grads for every smoke config (remat on and off), the MTP branch, the
optimizer, gradient compression, the token pipeline, checkpoints in both
directions, the train step and loop, and the entry points; plus the
reference's own ``tests/test_training.py`` cases and its
``test_train_step_smoke`` / ``test_remat_matches_no_remat`` carried over.
Params are carried from JAX by ``params_from_arrays``, inputs made from
numpy seeds, the same calls on both sides.

Tolerances, each with its reason:
- the loss within rtol 1e-5, 1e-3 for the MoE families: f32 sums that XLA
  and PyTorch associate differently; the MoE's dispatch and combine ride
  bf16, where one f32 ulp can round to a neighbouring bf16 value;
- grads per leaf against that leaf's largest reference magnitude: 1e-3 for
  the f32 families, 5e-3 for RG-LRU (its scan's other tree), 5e-2 for MoE:
  the forward tolerances of ``tests/test_torch_archs.py``, times 10 for
  the backward pass;
- the schedule and one AdamW update within 2 f32 ulps of the jitted
  reference, element by element;
- compression, the pipeline and checkpoints bit for bit.
"""

import functools
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.data.lm_pipeline import TokenPipeline as JaxPipeline
from repro.models import model as JM
from repro.training import checkpoint as jckpt
from repro.training import grad_compress as jgc
from repro.training import loop as jloop
from repro.training import optim as jopt
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.data.lm_pipeline import TokenPipeline
from repro_torch.models import model as M
from repro_torch.models import transformer as tfm
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import grad_compress as gc
from repro_torch.training.loop import (TrainConfig, make_train_step, train,
                                       value_and_grad)
from repro_torch.training.optim import (AdamWConfig, adamw_update,
                                        global_norm, init_opt_state, lr_at,
                                        tree_flatten, tree_leaves)
from repro_torch.training.watchdog import StepWatchdog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, MOE_LOSS_RTOL = 1e-5, 1e-3
GRAD_REL, SCAN_GRAD_REL, MOE_GRAD_REL = 1e-3, 5e-3, 5e-2
B, S = 2, 12


def _loss_rtol(cfg):
    return MOE_LOSS_RTOL if cfg.moe is not None else LOSS_RTOL


def _grad_rel(cfg):
    if cfg.moe is not None:
        return MOE_GRAD_REL
    if "rglru" in cfg.block_pattern:
        return SCAN_GRAD_REL
    return GRAD_REL


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _batch(cfg, seed=1, b=B, s=S):
    """numpy inputs: tokens, labels (+ frames / patch_embeds)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    stub = (b, cfg.n_frontend_tokens, cfg.frontend_dim)
    if cfg.encdec:
        out["frames"] = (0.1 * rng.standard_normal(stub)).astype(np.float32)
    if cfg.frontend == "image_patches":
        out["patch_embeds"] = (0.1 * rng.standard_normal(stub)).astype(
            np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(cfg, seed=0):
    """The reference's params (jitted init: its op-by-op form takes tens of
    seconds for a MoE config on the CPU)."""
    return jax.jit(lambda k: JM.init_model(cfg, k))(jax.random.PRNGKey(seed))


def _carried(arch, jparams):
    return M.params_from_arrays(get_smoke_config(arch),
                                jax.tree.map(np.asarray, jparams),
                                device="cpu")


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _names(pairs):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in pairs]


def _leaf_close(ref, got, rel, name=""):
    ref, got = _np(ref), _np(got)
    assert ref.shape == got.shape, (name, ref.shape, got.shape)
    bound = rel * float(np.abs(ref).max())
    err = float(np.abs(ref.astype(np.float64) - got).max()) if ref.size else 0
    assert err <= bound, (name, err, bound)


def _ulps(ref, got):
    """Largest distance in f32 ulps (the ordered integer representation)."""
    def key(a):
        i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(ref) - key(got)).max())


# ---------------------------------------------------------------------------
# the loss and its grads, every smoke config, remat on and off
# ---------------------------------------------------------------------------

def _jax_loss_and_grads(cfg, jparams, batch, remat):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, cfg, jb, remat=remat), has_aux=True))(jparams)


@pytest.mark.parametrize("remat", [False, True], ids=["noremat", "remat"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_equal_the_reference(arch, remat):
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    jparams = _jax_params(jcfg)
    batch = _batch(cfg)
    (jloss, jmet), jgrads = _jax_loss_and_grads(jcfg, jparams, batch, remat)
    params = _carried(arch, jparams)
    (loss, met), grads = value_and_grad(
        lambda p, b: M.loss_fn(p, cfg, b, remat=remat), params,
        _port_batch(batch))
    rtol = _loss_rtol(cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=rtol)
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=rtol,
                                   atol=1e-7, err_msg=k)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    flat = tree_flatten(grads)
    assert _names(jflat) == ["/".join(map(str, p)) for p, _ in flat]
    rel = _grad_rel(cfg)
    for name, (_, jg), (_, g) in zip(_names(jflat), jflat, flat):
        _leaf_close(jg, g, rel, name)


def test_mtp_branch_equals_the_reference():
    """deepseek's smoke config: the MTP layer's logits over positions 1..S-1
    and its cross-entropy against labels 1..S-1."""
    arch = "deepseek-v3-671b"
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    assert cfg.mtp
    jparams = _jax_params(jcfg)
    batch = _batch(cfg, seed=4)
    jlogits, jaux = jax.jit(lambda p, t: JM.tfm.forward_train(
        p, jcfg, t, remat=False))(jparams, jnp.asarray(batch["tokens"]))
    params = _carried(arch, jparams)
    with torch.no_grad():
        logits, aux = tfm.forward_train(params, cfg,
                                        torch.from_numpy(batch["tokens"]),
                                        remat=False)
        _, met = M.loss_fn(params, cfg, _port_batch(batch), remat=False)
    assert tuple(aux["mtp_logits"].shape) == (B, S - 1, cfg.vocab_size)
    _leaf_close(jaux["mtp_logits"], aux["mtp_logits"], 1e-2, "mtp_logits")
    _leaf_close(jlogits, logits, 1e-2, "logits")
    _, jmet = jax.jit(lambda p, b: JM.loss_fn(p, jcfg, b, remat=False))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(met["mtp_xent"]),
                               float(jmet["mtp_xent"]), rtol=MOE_LOSS_RTOL)


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

LR_CFGS = [AdamWConfig(lr_peak=1e-3, lr_min=1e-4, warmup_steps=10,
                       total_steps=100),
           AdamWConfig(),
           AdamWConfig(lr_peak=6e-4, warmup_steps=7, total_steps=33)]


@pytest.mark.parametrize("i", range(len(LR_CFGS)))
def test_lr_at_equals_the_jitted_reference(i):
    cfg = LR_CFGS[i]
    jcfg = jopt.AdamWConfig(**cfg.__dict__)
    jlr = jax.jit(lambda s: jopt.lr_at(jcfg, s))
    for s in (0, 1, 3, 5, 7, 10, 11, 33, 50, 99, 100, 101, 5000, 10_000):
        want = np.float32(jlr(jnp.int32(s)))
        got = lr_at(cfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert _ulps(want, _np(got)) <= 2, (s, want, float(got))


def _opt_tree(rng, scale=1.0):
    """An unsorted nested tree: leaf order is jax.tree.flatten's only if
    the keys are walked sorted."""
    return {"w": (scale * rng.standard_normal((33, 7))).astype(np.float32),
            "b": {"z": (scale * rng.standard_normal(70)).astype(np.float32),
                  "a": [(scale * rng.standard_normal((5, 3))).astype(
                      np.float32),
                        (scale * rng.standard_normal(4)).astype(np.float32)]},
            "a": (scale * rng.standard_normal((2, 3, 4))).astype(np.float32)}


def _tt(tree):
    return tfm.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("step, clip", [(0, 1.0), (6, 1.0), (41, 100.0)])
def test_adamw_update_equals_the_jitted_reference(step, clip):
    """One update from identical params, grads and state (Adam moments from
    a seed, ``step`` updates already taken; ``clip`` 1.0 clips these grads,
    100.0 does not)."""
    rng = np.random.default_rng(step)
    params, grads = _opt_tree(rng), _opt_tree(rng, 0.5)
    m = _opt_tree(rng, 0.1) if step else tfm.tree_map(np.zeros_like, params)
    v = tfm.tree_map(lambda a: np.abs(a) * 0.01,
                     _opt_tree(rng)) if step else \
        tfm.tree_map(np.zeros_like, params)
    cfg = AdamWConfig(lr_peak=1e-2, warmup_steps=5, total_steps=50,
                      clip_norm=clip)
    jcfg = jopt.AdamWConfig(**cfg.__dict__)
    jstate = {"m": m, "v": v, "step": jnp.int32(step)}
    jp, js, jm = jax.jit(lambda p, g, s: jopt.adamw_update(jcfg, p, g, s))(
        params, grads, jstate)
    state = {"m": _tt(m), "v": _tt(v),
             "step": torch.tensor(step, dtype=torch.int32)}
    p = _tt(params)
    p_out, s_out, met = adamw_update(cfg, p, _tt(grads), state)
    assert p_out is p and s_out is state            # updated in place
    assert int(state["step"]) == step + 1
    assert _ulps(jm["lr"], _np(met["lr"])) <= 2
    np.testing.assert_allclose(float(met["grad_norm"]), float(jm["grad_norm"]),
                               rtol=2e-7)
    for ref, got in ((jp, p), (js["m"], state["m"]), (js["v"], state["v"])):
        for a, b_ in zip(jax.tree.leaves(ref), tree_leaves(got)):
            assert _ulps(np.asarray(a), _np(b_)) <= 2


def test_global_norm_walks_the_references_leaf_order():
    rng = np.random.default_rng(3)
    tree = _opt_tree(rng)
    want = np.float32(jax.jit(jopt.global_norm)(tree))
    assert _ulps(want, _np(global_norm(_tt(tree)))) <= 2
    assert [l.shape for l in jax.tree.leaves(tree)] == \
        [tuple(l.shape) for l in tree_leaves(_tt(tree))]


MOE_ARCHS = [a for a in ARCH_IDS if get_smoke_config(a).moe is not None]
STEP_OPT = dict(lr_peak=2e-3, warmup_steps=2, total_steps=10)


@pytest.mark.parametrize("arch, micro, compress", [
    ("qwen3-4b", 1, "topk"), ("h2o-danube-1.8b", 2, "int8"),
    ("whisper-base", 1, "none")])
def test_three_train_steps_equal_the_reference(arch, micro, compress):
    """The loss of three steps from carried params. The MoE families are
    held step by step below: their straight runs part past the loss
    tolerance after one update (``test_moe_step_gap_is_the_references_own``)."""
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    tcfg = TrainConfig(steps=3, seq_len=S, global_batch=4, microbatches=micro,
                       grad_compress=compress, opt=AdamWConfig(**STEP_OPT))
    jtcfg = jloop.TrainConfig(steps=3, seq_len=S, global_batch=4,
                              microbatches=micro, grad_compress=compress,
                              opt=jopt.AdamWConfig(**STEP_OPT))
    jparams = jax.tree.map(jnp.copy, _jax_params(jcfg))   # the step donates
    params = _carried(arch, jparams)
    jstep = jloop.make_train_step(jcfg, jtcfg)
    step = make_train_step(cfg, tcfg)
    jstate, state = jopt.init_opt_state(jparams), init_opt_state(params)
    jerr = jgc.init_error_state(jparams) if compress != "none" else None
    err = gc.init_error_state(params) if compress != "none" else None
    pipe = TokenPipeline(cfg.vocab_size, S, 4, seed=0)
    extra = {k: v for k, v in _batch(cfg, b=4).items()
             if k in ("frames", "patch_embeds")}
    for i in range(3):
        data = dict(pipe.batch(i), **extra)
        jparams, jstate, jerr, jmet = jstep(
            jparams, jstate, jerr,
            {k: jnp.asarray(v) for k, v in data.items()})
        params, state, err, met = step(params, state, err, _port_batch(data))
        np.testing.assert_allclose(float(met["loss_total"]),
                                   float(jmet["loss_total"]),
                                   rtol=_loss_rtol(cfg), err_msg=f"step {i}")
    assert int(state["step"]) == 3


def _spy(monkeypatch, module, name, arg):
    """Record, at each call of ``module.name``, a numpy copy of the leaves
    of its positional argument ``arg``."""
    seen, real = [], getattr(module, name)

    def spy(*args, **kw):
        seen.append([_np(x).copy() for x in tree_leaves(args[arg])])
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return seen


@functools.lru_cache(maxsize=None)
def _moe_fns(arch):
    """The reference's jitted loss-and-grads and AdamW update at STEP_OPT,
    compiled once for both MoE tests."""
    jcfg = jax_smoke(arch)
    jvg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b, remat=True), has_aux=True))
    jup = jax.jit(functools.partial(jopt.adamw_update,
                                    jopt.AdamWConfig(**STEP_OPT)))
    return jvg, jup


def _moe_setup(arch):
    jparams = jax.tree.map(jnp.copy, _jax_params(jax_smoke(arch)))
    return (get_smoke_config(arch), jparams) + _moe_fns(arch)


def _jax_tree(like, leaves):
    return jax.tree.unflatten(jax.tree.structure(like),
                              [jnp.asarray(x) for x in leaves])


@pytest.mark.parametrize("arch, micro, compress", [
    ("deepseek-v3-671b", 1, "none"), ("arctic-480b", 2, "topk")])
def test_moe_train_steps_equal_the_reference_fed_the_ports_grads(
        arch, micro, compress, monkeypatch):
    """Three ``make_train_step`` steps of each MoE family at lr 2e-3. At
    each step the reference computes its loss and grads at its own params
    (the microbatches' mean where micro > 1, as its scan does); the
    port's loss is within the MoE loss tolerance and the grads its step
    accumulates within the MoE grad tolerance of them. Top-k compression
    of the port's grads under the reference's error feedback is bit-equal
    to what the port's step sends, and the reference's AdamW then applies
    what the port sent: the params after each step agree within 2^-20 of
    each leaf's largest magnitude. So the update, which the straight run
    cannot hold (the next test), is checked on every leaf at every step."""
    cfg, jparams, jvg, jup = _moe_setup(arch)
    assert arch in MOE_ARCHS
    params = _carried(arch, jparams)
    names = _names(jax.tree_util.tree_flatten_with_path(jparams)[0])
    from repro_torch.training import loop as ploop
    sent = _spy(monkeypatch, ploop, "adamw_update", 2)
    raw = (_spy(monkeypatch, gc, "topk_compress", 0)
           if compress == "topk" else sent)
    tcfg = TrainConfig(steps=3, seq_len=S, global_batch=4, microbatches=micro,
                       grad_compress=compress, opt=AdamWConfig(**STEP_OPT))
    step = make_train_step(cfg, tcfg)
    jstate, state = jopt.init_opt_state(jparams), init_opt_state(params)
    jerr = jgc.init_error_state(jparams) if compress == "topk" else None
    err = gc.init_error_state(params) if compress == "topk" else None
    pipe = TokenPipeline(cfg.vocab_size, S, 4, seed=0)
    for i in range(3):
        data = pipe.batch(i)
        mbs = [{k: jnp.asarray(v.reshape((micro, -1) + v.shape[1:])[j])
                for k, v in data.items()} for j in range(micro)]
        outs = [jvg(jparams, mb) for mb in mbs]
        jloss = np.mean([float(l) for (l, _), _ in outs])
        jgrads = [np.sum([np.asarray(g) for g in gs], axis=0) / micro
                  for gs in zip(*[jax.tree.leaves(g) for _, g in outs])]
        params, state, err, met = step(params, state, err, _port_batch(data))
        np.testing.assert_allclose(float(met["loss_total"]), jloss,
                                   rtol=MOE_LOSS_RTOL, err_msg=f"step {i}")
        for name, jg, g in zip(names, jgrads, raw[i]):
            _leaf_close(jg, g, MOE_GRAD_REL, f"step {i} {name}")
        if compress == "topk":
            jsent, jerr = jax.jit(functools.partial(
                jgc.topk_compress, frac=tcfg.topk_frac))(
                    _jax_tree(jparams, raw[i]), jerr)
            for name, a, b in zip(names, jax.tree.leaves(jsent), sent[i]):
                np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
        jparams, jstate, _ = jup(jparams, _jax_tree(jparams, sent[i]), jstate)
        for name, jp, p in zip(names, jax.tree.leaves(jparams),
                               tree_leaves(params)):
            _leaf_close(jp, p, 2.0 ** -20, f"step {i} {name}")
    assert int(state["step"]) == 3 and len(sent) == 3


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_step_gap_is_the_references_own(arch):
    """Why the MoE families' straight runs part (ROADMAP C3): after one
    AdamW step at lr 2e-3 from step 1's grads, the reference's loss moves
    past the MoE loss tolerance when those grads carry the port's
    difference from them, and as far when they carry that same
    difference shuffled within each leaf (the same sizes, none of the
    port's pattern) in the reference alone. Adam's first update is
    lr * sign(g): a small grad that a rounding puts on the other side of
    zero moves its weight 2 lr, and the router's top-k turns that into a
    step in the loss."""
    cfg, jparams, jvg, jup = _moe_setup(arch)
    params = _carried(arch, jparams)
    pipe = TokenPipeline(cfg.vocab_size, S, 4, seed=0)
    b0, b1 = pipe.batch(0), pipe.batch(1)
    (_, _), jg = jvg(jparams, {k: jnp.asarray(v) for k, v in b0.items()})
    _, pg = value_and_grad(lambda p, b: M.loss_fn(p, cfg, b, remat=True),
                           params, _port_batch(b0))
    jg = [np.asarray(g) for g in jax.tree.leaves(jg)]
    diff = [_np(p) - g for p, g in zip(tree_leaves(pg), jg)]

    def next_loss(grads):
        p, _, _ = jup(jparams, _jax_tree(jparams, grads),
                      jopt.init_opt_state(jparams))
        (l, _), _ = jvg(p, {k: jnp.asarray(v) for k, v in b1.items()})
        return float(l)

    own = next_loss(jg)
    port_gap = abs(next_loss([g + d for g, d in zip(jg, diff)]) - own) / own
    shuffled = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        moved = [g + rng.permutation(d.ravel()).reshape(d.shape)
                 for g, d in zip(jg, diff)]
        shuffled.append(abs(next_loss(moved) - own) / own)
    print(f"{arch}: the next loss moves {port_gap:.3e} (the port's "
          f"difference), {shuffled} (shuffled, seeds 0-2)")
    assert max(shuffled) > MOE_LOSS_RTOL, shuffled
    assert max(shuffled) >= 0.5 * port_gap, (shuffled, port_gap)


def test_train_step_over_a_mesh_waits_for_the_lm_sharding():
    """The mesh path exists now (tests/test_torch_sharding_roofline.py and
    tests/test_torch_dryrun.py run it); what is not a ``DeviceMesh`` is
    refused when the step is built."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_train_step(get_smoke_config("qwen3-4b"), TrainConfig(),
                        mesh=object())


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def _grad_tree(rng):
    g = _opt_tree(rng)
    g["t"] = np.round(rng.standard_normal(300) * 2).astype(np.float32)  # ties
    return g


@pytest.mark.parametrize("frac", [0.05, 0.1, 0.5])
def test_topk_compress_bit_equals_the_reference(frac):
    rng = np.random.default_rng(7)
    g, e = _grad_tree(rng), tfm.tree_map(lambda a: 0.1 * a, _grad_tree(rng))
    jsent, jerr = jax.jit(lambda g, e: jgc.topk_compress(g, e, frac=frac))(
        g, e)
    sent, err = gc.topk_compress(_tt(g), _tt(e), frac=frac)
    for ref, got in ((jsent, sent), (jerr, err)):
        for a, b_ in zip(jax.tree.leaves(ref), tree_leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), _np(b_))


@pytest.mark.parametrize("block", [256, 64])
def test_int8_compress_bit_equals_the_jitted_reference(block):
    rng = np.random.default_rng(8)
    g, e = _grad_tree(rng), tfm.tree_map(lambda a: 0.01 * a, _grad_tree(rng))
    jsent, jerr = jax.jit(lambda g, e: jgc.int8_compress(g, e, block=block))(
        g, e)
    sent, err = gc.int8_compress(_tt(g), _tt(e), block=block)
    for ref, got in ((jsent, sent), (jerr, err)):
        for a, b_ in zip(jax.tree.leaves(ref), tree_leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), _np(b_))


def test_compressed_bytes_equal_the_reference():
    shapes = M.model_param_shapes(get_smoke_config("qwen3-4b"))
    jshapes = JM.model_param_shapes(jax_smoke("qwen3-4b"))
    for scheme in ("none", "int8", "topk"):
        assert gc.compressed_bytes(shapes, scheme, frac=0.03) == \
            jgc.compressed_bytes(jshapes, scheme, frac=0.03)
    with pytest.raises(ValueError):
        gc.compressed_bytes(shapes, "fp8")


# ---------------------------------------------------------------------------
# data and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards, shard", [(1, 0), (4, 3)])
def test_token_pipeline_bit_equals_the_reference(shards, shard):
    kw = dict(seq_len=64, global_batch=8, n_shards=shards, shard=shard,
              seed=5)
    ours, ref = TokenPipeline(32000, **kw), JaxPipeline(32000, **kw)
    for step in (0, 1, 17, 1000):
        a, b_ = ours.batch(step), ref.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b_[k].dtype
            np.testing.assert_array_equal(a[k], b_[k])


def _train_tree(arch="qwen3-4b"):
    """A (params, opt_state) tree of a smoke model, state moved off zero."""
    jparams = _jax_params(jax_smoke(arch))
    jstate = jopt.init_opt_state(jparams)
    jstate = {"m": jax.tree.map(lambda a: a + 1, jstate["m"]),
              "v": jstate["v"], "step": jnp.int32(9)}
    return jparams, jstate


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    jparams, jstate = _train_tree()
    jckpt.save_checkpoint(str(tmp_path), 9, (jparams, jstate))
    like = M.init_model(get_smoke_config("qwen3-4b"), device="meta")
    (params, state), step = ckpt.restore_checkpoint(
        str(tmp_path), (like, init_opt_state(like)), device="cpu")
    assert step == 9
    for a, b_ in zip(jax.tree.leaves((jparams, jstate)),
                     tree_leaves((params, state))):
        got = _np(b_)
        assert got.dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(np.asarray(a), got)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    jparams, jstate = _train_tree()
    params = _carried("qwen3-4b", jparams)
    state = {"m": _tt(jstate["m"]), "v": _tt(jstate["v"]),
             "step": torch.tensor(9, dtype=torch.int32)}
    ckpt.save_checkpoint(str(tmp_path / "port"), 9, (params, state))
    jckpt.save_checkpoint(str(tmp_path / "ref"), 9, (jparams, jstate))
    manifests = [json.load(open(tmp_path / d / "step_9" / "manifest.json"))
                 for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    zeros = jax.tree.map(jnp.zeros_like, (jparams, jstate))
    (rp, rs), step = jckpt.restore_checkpoint(str(tmp_path / "port"), zeros)
    assert step == 9
    for a, b_ in zip(jax.tree.leaves((rp, rs)), jax.tree.leaves(
            (jparams, jstate))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b_))


def test_restore_rejects_a_shape_mismatch(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), {"w": torch.zeros(4)})
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path / "none"), {"w": torch.zeros(3)})


# ---------------------------------------------------------------------------
# the reference's tests/test_training.py, carried over
# ---------------------------------------------------------------------------

def test_lr_schedule_shape():
    cfg = AdamWConfig(lr_peak=1e-3, lr_min=1e-4, warmup_steps=10,
                      total_steps=100)
    lrs = [float(lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[2] - 1e-3) < 1e-9          # peak at warmup end
    assert lrs[3] < lrs[2]                     # decaying
    assert abs(lrs[4] - 1e-4) < 1e-6           # floor


def test_adamw_decreases_quadratic():
    w = {"w": torch.tensor([5.0, -3.0])}
    st = init_opt_state(w)
    cfg = AdamWConfig(lr_peak=0.2, warmup_steps=0, total_steps=100,
                      weight_decay=0.0)
    for _ in range(60):
        g = {"w": 2 * w["w"]}
        w, st, _ = adamw_update(cfg, w, g, st)
    assert float(w["w"].abs().max()) < 0.5


def test_train_loss_decreases():
    cfg = get_smoke_config("h2o-danube-1.8b")
    tcfg = TrainConfig(steps=15, seq_len=32, global_batch=4,
                       opt=AdamWConfig(lr_peak=2e-3, warmup_steps=3,
                                       total_steps=15))
    _, hist = train(cfg, tcfg, verbose=False, device="cpu")
    assert hist[-1]["loss_total"] < hist[0]["loss_total"]


def test_checkpoint_restart_resumes(tmp_path):
    cfg = get_smoke_config("qwen3-4b")
    d = str(tmp_path)
    tcfg = TrainConfig(steps=6, seq_len=16, global_batch=2,
                       ckpt_dir=d, ckpt_every=3, log_every=100)
    train(cfg, tcfg, verbose=False, device="cpu")
    assert ckpt.latest_step(d) == 6
    tcfg2 = TrainConfig(steps=8, seq_len=16, global_batch=2,
                        ckpt_dir=d, ckpt_every=3, log_every=100)
    _, hist = train(cfg, tcfg2, verbose=False, device="cpu")
    assert hist[0]["step"] == 6             # resumed, not restarted
    assert hist[-1]["step"] == 7


def test_restart_repeats_the_straight_run(tmp_path):
    """Steps 3-5 rerun from the step-3 checkpoint equal the straight run's
    (the CPU is deterministic: bit for bit)."""
    cfg = get_smoke_config("yi-6b")
    d = str(tmp_path)
    kw = dict(seq_len=16, global_batch=2, ckpt_every=3, log_every=100,
              opt=AdamWConfig(lr_peak=2e-3, warmup_steps=2, total_steps=6))
    straight, hist = train(cfg, TrainConfig(steps=6, ckpt_dir=d, **kw),
                           verbose=False, device="cpu")
    shutil.rmtree(os.path.join(d, "step_6"))
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("3")
    again, hist2 = train(cfg, TrainConfig(steps=6, ckpt_dir=d, **kw),
                         verbose=False, device="cpu")
    assert [h["step"] for h in hist2] == [3, 4, 5]
    assert [h["loss_total"] for h in hist2] == \
        [h["loss_total"] for h in hist[3:]]
    for a, b_ in zip(tree_leaves(straight), tree_leaves(again)):
        assert torch.equal(a, b_)


def test_checkpoint_atomic_and_gc(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(10), "b": {"c": torch.ones((3, 3))}}
    for step in (1, 2, 3, 4):
        ckpt.save_checkpoint(d, step, tree, keep=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert steps == ["step_3", "step_4"]
    restored, step = ckpt.restore_checkpoint(d, tree)
    assert step == 4
    np.testing.assert_array_equal(_np(restored["a"]), np.arange(10))


def test_async_checkpointer(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    w.save(5, {"x": torch.ones(4)})
    w.wait()
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_async_checkpointer_snapshots_before_in_place_updates(tmp_path,
                                                              monkeypatch):
    """The tree saved as step N holds step N's values although the caller
    updates it in place, as ``adamw_update`` does, before the write ends."""
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": [torch.ones(3)]}
    state = init_opt_state(params)
    want = [_np(x).copy() for x in tree_leaves((params, state))]
    gate = threading.Event()
    real = ckpt.save_checkpoint

    def held(*a, **kw):
        gate.wait(timeout=30)
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "save_checkpoint", held)
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    w.save(1, (params, state))
    try:
        adamw_update(AdamWConfig(lr_peak=0.5, warmup_steps=0), params,
                     tfm.tree_map(torch.ones_like, params), state)
        params["b"][0].fill_(7.0)
    finally:
        gate.set()
        w.wait()
    assert int(state["step"]) == 1
    like = (params, init_opt_state(params))
    restored, step = ckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 1
    for a, b_ in zip(want, tree_leaves(restored)):
        np.testing.assert_array_equal(a, _np(b_))


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compression_error_feedback_conserves(scheme):
    """sent + residual == grad + old_residual (nothing is lost)."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(0, 1, (64,)).astype(np.float32))}
    err = gc.init_error_state(g)
    fn = gc.topk_compress if scheme == "topk" else gc.int8_compress
    sent, new_err = fn(g, err)
    np.testing.assert_allclose(_np(sent["w"] + new_err["w"]),
                               _np(g["w"] + err["w"]), rtol=1e-5, atol=1e-6)


def test_topk_sparsity():
    g = {"w": torch.arange(100.0)}
    err = gc.init_error_state(g)
    sent, _ = gc.topk_compress(g, err, frac=0.1)
    assert int((sent["w"] != 0).sum()) == 10
    # kept the largest
    assert float(sent["w"][99]) == 99.0


def test_train_with_compression_converges():
    cfg = get_smoke_config("yi-6b")
    tcfg = TrainConfig(steps=12, seq_len=16, global_batch=2,
                       grad_compress="int8",
                       opt=AdamWConfig(lr_peak=2e-3, warmup_steps=2,
                                       total_steps=12))
    _, hist = train(cfg, tcfg, verbose=False, device="cpu")
    assert hist[-1]["loss_total"] < hist[0]["loss_total"]


def test_compressed_bytes_accounting():
    params = {"w": torch.zeros((1000,))}
    full = gc.compressed_bytes(params, "none")
    int8 = gc.compressed_bytes(params, "int8")
    topk = gc.compressed_bytes(params, "topk", frac=0.05)
    assert full == 4000
    assert int8 < full / 3
    assert topk < full / 2


def test_watchdog_straggler_detection():
    wd = StepWatchdog(window=16, slow_factor=2.0, hang_timeout_s=999)
    for s in range(10):
        wd.step_start(s)
        time.sleep(0.002)
        wd.step_end(s)
    wd.step_start(10)
    time.sleep(0.05)
    stat = wd.step_end(10)
    assert stat["straggler"]
    assert wd.events and wd.events[-1]["kind"] == "straggler"


# ---------------------------------------------------------------------------
# the reference's tests/test_archs.py training cases, carried over
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_smoke(arch):
    cfg = get_smoke_config(arch)
    params = M.init_model(cfg, 0, device="cpu")
    batch = _port_batch(_batch(cfg))
    (loss, metrics), grads = value_and_grad(
        lambda p, b: M.loss_fn(p, cfg, b, remat=False), params, batch)
    assert loss.shape == ()
    assert np.isfinite(float(loss))
    gnorm = sum(float(torch.sum(torch.square(g))) for g in tree_leaves(grads))
    assert np.isfinite(gnorm) and gnorm > 0


def test_remat_matches_no_remat():
    cfg = get_smoke_config("qwen3-4b")
    params = M.init_model(cfg, 0, device="cpu")
    batch = _port_batch(_batch(cfg))
    with torch.no_grad():
        l1, _ = M.loss_fn(params, cfg, batch, remat=False)
        l2, _ = M.loss_fn(params, cfg, batch, remat=True)
    assert abs(float(l1) - float(l2)) < 1e-5


def test_decode_cache_shapes_equal_the_reference():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if cfg.encdec:
            continue
        want = jax.tree.leaves(JM.tfm.decode_cache_shapes(
            jax_config(arch), 2, 64))
        got = tree_leaves(tfm.decode_cache_shapes(cfg, 2, 64))
        assert [(tuple(a.shape), str(a.dtype)) for a in want] == \
            [(tuple(b.shape), str(b.dtype).replace("torch.", ""))
             for b in got], arch
        assert all(b.device.type == "meta" for b in got)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_train_launcher_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-4b", "--smoke", "--steps", "3", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "final loss:" in out.stdout and "(3 steps) device=cpu" in \
        out.stdout


@pytest.mark.parametrize("arch", ["whisper-base", "phi-3-vision-4.2b"])
def test_train_launcher_stubs_the_frontends(arch):
    from repro_torch.launch.train import main
    _, hist = main(["--arch", arch, "--smoke", "--steps", "2", "--seq-len",
                    "8", "--global-batch", "2", "--device", "cpu"])
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss_total"])


def test_train_lm_example_runs_two_steps(tmp_path):
    from repro_torch.examples.train_lm import main
    hist = main(["--steps", "2", "--seq-len", "16", "--global-batch", "2",
                 "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss_total"]) for h in hist)
