"""Temperature sampling in ``greedy_generate`` and the classification
metrics ``confusion_matrix`` / ``macro_f1`` of the PyTorch port against the
JAX package.

The sampling parity rests on one identity of jax's sampler: under jax
0.9.0, ``jax.random.categorical(k, lg)`` (``replace=True``) is
``argmax(jax.random.gumbel(k, lg.shape, lg.dtype) + lg)``. So the port's
``sample_tokens`` fed the reference's Gumbel noise must give the
reference's tokens bit for bit; the port's own draws
(``gumbel_noise`` from a ``torch.Generator``) are held by a chi-square
test instead, since they are not ``jax.random``'s bits.

Tolerances: tokens, confusion counts and macro F1 compare exactly (==);
each log of the port's Gumbel transform of the reference's uniforms agrees
within 2 ulps (a transcendental, ROADMAP C3), the whole within 2 ulps of
the larger of |g| and 1; the chi-square statistic lies below its 1 - 1e-4
quantile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.ml import metrics as jmetrics
from repro.serving.engine import greedy_generate as jax_generate
from repro_torch import ml as tml
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.serving import engine as teng
from test_torch_archs import _arch, _cut, _jb, _np

TINY = float(np.finfo(np.float32).tiny)
KEYS = (0, 7, 12345)
SHAPES = ((5, 7), (3, 151))


def _ulps(ref, got):
    """Largest gap in units of the reference's ulp."""
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    gap = np.abs(ref.astype(np.float64) - got.astype(np.float64))
    return float((gap / np.spacing(np.abs(ref)).astype(np.float64)).max())


# ---------------------------------------------------------------------------
# the identity the parity rests on, and the transform
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", KEYS)
def test_categorical_is_argmax_of_gumbel_plus_logits(seed, shape):
    k = jax.random.PRNGKey(seed)
    lg = jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                     .astype(np.float32) * 3.0)
    want = jnp.argmax(jax.random.gumbel(k, lg.shape, lg.dtype) + lg, axis=-1)
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(k, lg, axis=-1)), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES + ((1 << 16,),))
@pytest.mark.parametrize("seed", KEYS)
def test_gumbel_is_the_low_transform_of_uniforms(seed, shape):
    """``jax.random.gumbel`` is ``-log(-log(u))`` of its uniforms in
    ``[tiny, 1)``. The port's ``_gumbel_from_uniform`` of the same uniforms
    takes each log within 2 ulps of XLA's on the same input, so the whole
    lies within 2 ulps of the larger of ``|g|`` and 1: where g is near 0,
    one ulp of the inner log (~1) is many ulps of g itself."""
    k = jax.random.PRNGKey(seed)
    u = jax.random.uniform(k, shape, jnp.float32, minval=TINY, maxval=1.0)
    ref = np.asarray(jax.random.gumbel(k, shape, jnp.float32))
    inner = -jnp.log(u)
    np.testing.assert_array_equal(ref, np.asarray(-jnp.log(inner)))
    u, inner = np.array(u), np.array(inner)
    assert _ulps(inner, _np(-torch.log(torch.from_numpy(u)))) <= 2
    assert _ulps(ref, _np(-torch.log(torch.from_numpy(inner)))) <= 2
    got = _np(teng._gumbel_from_uniform(torch.from_numpy(u)))
    assert got.dtype == np.float32
    unit = np.spacing(np.maximum(np.abs(ref), np.float32(1.0)))
    assert np.all(np.abs(ref.astype(np.float64) - got) <= 2 * unit)


# ---------------------------------------------------------------------------
# sample_tokens against jax.random.categorical, fed the reference's noise
# ---------------------------------------------------------------------------

def _reference_draw(seed, logits, temperature):
    """(the reference's tokens, its noise) for one step: a split as
    ``greedy_generate`` splits, ``categorical(sub, logits / T)``."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    lg = jnp.asarray(logits)
    toks = jax.random.categorical(sub, lg / temperature, axis=-1)
    noise = jax.random.gumbel(sub, lg.shape, jnp.float32)
    return np.asarray(toks), np.asarray(noise)


@pytest.mark.parametrize("vocab", (7, 151))
@pytest.mark.parametrize("temperature", (1e-3, 0.3, 0.7, 1.7))
def test_sample_tokens_equals_categorical(temperature, vocab):
    logits = (np.random.default_rng(vocab).standard_normal((64, vocab))
              .astype(np.float32) * 2.0)
    want, noise = _reference_draw(3, logits, temperature)
    got = teng.sample_tokens(torch.from_numpy(logits), temperature,
                             torch.from_numpy(noise))
    assert got.dtype == torch.int32 and got.shape == (64,)
    np.testing.assert_array_equal(_np(got), want)


def test_sample_tokens_on_tied_logits():
    """Tied logits (and -inf ones) under the reference's noise give its
    tokens; with no noise the first maximum wins on both sides."""
    logits = np.zeros((32, 9), np.float32)
    logits[:, ::3] = 1.5
    logits[:, 4] = -np.inf
    for temperature in (0.3, 1.0):
        want, noise = _reference_draw(11, logits, temperature)
        got = teng.sample_tokens(torch.from_numpy(logits), temperature,
                                 torch.from_numpy(noise))
        np.testing.assert_array_equal(_np(got), want)
        assert not np.any(want == 4)
    zero = np.zeros_like(logits)
    got = teng.sample_tokens(torch.from_numpy(logits), 0.7,
                             torch.from_numpy(zero))
    want = np.asarray(jnp.argmax(jnp.asarray(zero) + jnp.asarray(logits)
                                 / 0.7, axis=-1))
    np.testing.assert_array_equal(_np(got), want)
    assert np.all(want == 0)


# ---------------------------------------------------------------------------
# the whole greedy_generate(temperature=0.7) against the reference's
# ---------------------------------------------------------------------------

GEN_ARCHS = ("qwen3-4b", "recurrentgemma-2b", "phi-3-vision-4.2b",
             "whisper-base")
TEMPERATURE, N_NEW = 0.7, 6


def _margin(scores):
    """The gap between the best and second-best score of each row."""
    top = np.sort(np.asarray(scores, np.float64), axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("arch", GEN_ARCHS)
def test_sampled_generate_equals_the_reference(arch, seed, monkeypatch):
    """The port's ``gumbel_noise`` hands out the reference's chain (``key,
    sub = split(key)``, then ``gumbel(sub, (B, V), f32)``): the tokens
    equal ``repro``'s ``greedy_generate(temperature=0.7, key=PRNGKey(s))``
    bit for bit. On a flip, the two packages' margins at that step are
    printed."""
    jcfg, jparams, cfg, params, batch = _arch(arch)
    state = {"key": jax.random.PRNGKey(seed)}
    port_steps, ref_steps = [], []

    def ref_noise(shape, generator, device):
        state["key"], sub = jax.random.split(state["key"])
        noise = torch.from_numpy(np.asarray(
            jax.random.gumbel(sub, tuple(shape), jnp.float32))).to(device)
        port_steps.append(noise)
        return noise

    real_categorical = jax.random.categorical
    real_sample = teng.sample_tokens

    def recording_categorical(key, logits, axis=-1, **kw):
        ref_steps.append((key, np.asarray(logits)))
        return real_categorical(key, logits, axis=axis, **kw)

    def recording_sample(logits, temperature, noise):
        scores = noise + teng.true_div(logits, temperature)
        port_scores.append(_np(scores))
        return real_sample(logits, temperature, noise)

    port_scores = []
    monkeypatch.setattr(teng, "gumbel_noise", ref_noise)
    monkeypatch.setattr(teng, "sample_tokens", recording_sample)
    monkeypatch.setattr(jax.random, "categorical", recording_categorical)
    ref = jax_generate(jcfg, jparams, _jb(_cut(batch, 8)), n_new=N_NEW,
                       temperature=TEMPERATURE, key=jax.random.PRNGKey(seed))
    got = teng.greedy_generate(cfg, params, _cut(batch, 8), n_new=N_NEW,
                               temperature=TEMPERATURE,
                               generator=torch.Generator().manual_seed(99))
    assert len(port_steps) == len(ref_steps) == len(port_scores) == N_NEW
    assert port_steps[0].shape == (batch["tokens"].shape[0], cfg.vocab_size)
    assert got.dtype == torch.int32
    ref, got = np.asarray(ref), _np(got)
    if not np.array_equal(ref, got):
        step = int(np.argwhere((ref != got).any(axis=0))[0, 0])
        key, scaled = ref_steps[step]
        ref_scores = np.asarray(jax.random.gumbel(key, scaled.shape,
                                                  jnp.float32)) + scaled
        print(f"{arch} seed {seed}: first flip at step {step}; margins "
              f"reference {_margin(ref_scores)}, port "
              f"{_margin(port_scores[step])}")
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# the fallbacks, the generator, the port's own draws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    cfg = get_smoke_config("qwen3-4b")
    params = M.init_model(cfg, 0, device="cpu")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, 8)).astype(np.int32)
    return cfg, params, {"tokens": toks}


def test_sampling_off_is_the_greedy_path(qwen):
    """Temperature 0 with a generator, and a temperature with no
    generator, both take the argmax: the greedy tokens unchanged."""
    cfg, params, batch = qwen
    greedy = teng.greedy_generate(cfg, params, batch, n_new=5)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    zero = teng.greedy_generate(cfg, params, batch, n_new=5,
                                temperature=0.0, generator=gen)
    assert torch.equal(gen.get_state(), state)       # nothing drawn
    hot = teng.greedy_generate(cfg, params, batch, n_new=5, temperature=0.7)
    assert torch.equal(zero, greedy) and torch.equal(hot, greedy)


def test_sampling_is_determined_by_the_generator(qwen):
    cfg, params, batch = qwen

    def run(seed):
        return teng.greedy_generate(
            cfg, params, batch, n_new=8, temperature=1.7,
            generator=torch.Generator().manual_seed(seed))

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_gumbel_noise_draws_the_softmax():
    """``gumbel_noise`` + ``sample_tokens`` on the CPU (seeded): 2^16 draws
    over V=16 at T=0.7 against ``softmax(logits / 0.7)``, chi-square below
    its 1 - 1e-4 quantile (15 degrees of freedom)."""
    v, n, temperature = 16, 1 << 16, 0.7
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal(v)
                              .astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    noise = teng.gumbel_noise((n, v), gen, "cpu")
    assert noise.dtype == torch.float32 and bool(torch.isfinite(noise).all())
    toks = teng.sample_tokens(logits.expand(n, v), temperature, noise)
    counts = np.bincount(_np(toks), minlength=v)
    p = _np(torch.softmax(logits.double() / temperature, dim=-1))
    chi2 = float((((counts - n * p) ** 2) / (n * p)).sum())
    assert chi2 < stats.chi2.ppf(1 - 1e-4, v - 1), chi2
    # the standard Gumbel's mean (Euler's constant) and variance (pi^2 / 6)
    assert abs(float(noise.double().mean()) - np.euler_gamma) < 0.01
    assert abs(float(noise.double().var()) - np.pi ** 2 / 6) < 0.02


# ---------------------------------------------------------------------------
# confusion_matrix and macro_f1
# ---------------------------------------------------------------------------

def _labels(n_classes, kind, seed=0, n=500, absent=None):
    rng = np.random.default_rng(seed)
    y_true = rng.integers(0, n_classes, n)
    y_pred = np.where(rng.random(n) < 0.7, y_true,
                      rng.integers(0, n_classes, n))
    if absent is not None:
        y_true = np.where(y_true == absent, (absent + 1) % n_classes, y_true)
        y_pred = np.where(y_pred == absent, (absent + 1) % n_classes, y_pred)
    if kind == "tensor":
        return (torch.from_numpy(y_true.astype(np.int64)),
                torch.from_numpy(y_pred.astype(np.int64)))
    return y_true.astype(kind), y_pred.astype(kind)


def _np_inputs(y_true, y_pred):
    return _np(y_true), _np(y_pred)


@pytest.mark.parametrize("kind", (np.int32, np.int64, "tensor"))
@pytest.mark.parametrize("n_classes", (2, 3, 10))
def test_metrics_equal_the_reference(n_classes, kind):
    y_true, y_pred = _labels(n_classes, kind, seed=n_classes)
    jt, jp = _np_inputs(y_true, y_pred)
    cm = tml.confusion_matrix(y_true, y_pred, n_classes)
    want = np.asarray(jmetrics.confusion_matrix(jt, jp, n_classes))
    assert cm.dtype == torch.int32 and cm.shape == (n_classes, n_classes)
    np.testing.assert_array_equal(_np(cm), want)
    assert int(cm.sum()) == len(jt)
    assert (tml.macro_f1(y_true, y_pred, n_classes)
            == jmetrics.macro_f1(jt, jp, n_classes))


@pytest.mark.parametrize("n_classes", (3, 10))
def test_metrics_with_a_class_that_never_occurs(n_classes):
    y_true, y_pred = _labels(n_classes, np.int32, seed=4, absent=1)
    cm = tml.confusion_matrix(y_true, y_pred, n_classes)
    np.testing.assert_array_equal(
        _np(cm), np.asarray(jmetrics.confusion_matrix(y_true, y_pred,
                                                      n_classes)))
    assert int(cm[1].sum()) == 0 and int(cm[:, 1].sum()) == 0
    assert (tml.macro_f1(y_true, y_pred, n_classes)
            == jmetrics.macro_f1(y_true, y_pred, n_classes))


def test_confusion_matrix_out_of_range_labels_as_the_reference():
    """Labels past the classes alias through the flat index; a negative
    index counts from the end as JAX's ``.at[].add`` counts it, and one
    still out of bounds is dropped, never raised."""
    y_true = np.array([0, 1, -1, 5, 0, 2, -3, 1, 0, 4], np.int32)
    y_pred = np.array([0, 1, 0, 0, -1, 0, 0, 3, 7, 0], np.int32)
    for n_classes in (2, 3):
        cm = tml.confusion_matrix(y_true, y_pred, n_classes)
        np.testing.assert_array_equal(
            _np(cm), np.asarray(jmetrics.confusion_matrix(y_true, y_pred,
                                                          n_classes)))
        assert (tml.macro_f1(y_true, y_pred, n_classes)
                == jmetrics.macro_f1(y_true, y_pred, n_classes))
    assert int(tml.confusion_matrix(y_true, y_pred, 2).sum()) < len(y_true)


def test_metrics_exported_as_the_reference_exports_them():
    import repro.ml as jml
    for name in ("accuracy", "precision_recall_f1", "confusion_matrix",
                 "macro_f1"):
        assert hasattr(jml, name)
        assert getattr(tml, name).__module__ == "repro_torch.ml.metrics"
