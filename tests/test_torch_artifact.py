"""Port parity: quantization, the fused-kernel table layout, artifacts
carried across, and table inference for all six aggregations."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import artifact as jart  # noqa: E402
from repro.core.inference import table_predict as jax_table_predict  # noqa: E402
from repro.core.quantize import quantize_fixed as jax_quantize  # noqa: E402
from repro_torch.core import artifact as tart  # noqa: E402
from repro_torch.core.inference import (table_predict,  # noqa: E402
                                        table_predict_per_tree)
from repro_torch.core.quantize import dequantize, quantize_fixed  # noqa: E402
from test_torch_parity import (assert_bit_equal, assert_conf_parity,  # noqa: E402
                               port_artifact)

ALL_MODELS = ("DT", "RF", "XGB", "IForest", "SVM", "Bayes", "KMeans")


def _jax_artifact(model, xtr, ytr):
    from repro.core.mapping import map_tree_ensemble
    if model == "IForest":
        from repro.ml.trees import fit_isolation_forest
        ens = fit_isolation_forest(np.asarray(xtr), n_trees=6, max_depth=4,
                                   seed=0)
        return map_tree_ensemble(ens, xtr.shape[1])
    from benchmarks.common import fit_and_map
    _, art, _ = fit_and_map(model, xtr, ytr, n_trees=4, max_depth=4)
    return art


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_quantize_fixed_matches_reference(bits):
    v = np.random.default_rng(bits).normal(0, 3, (7, 11)).astype(np.float32)
    fj, ft = jax_quantize(v, bits), quantize_fixed(v, bits)
    assert_bit_equal(fj.q, ft.q)
    assert_bit_equal(fj.scale, ft.scale)
    assert ft.bits == bits and ft.q.dtype == torch.int32
    assert np.abs(dequantize(ft).numpy() - v).max() <= 0.5 / float(ft.scale) + 1e-6


@pytest.mark.parametrize("vote", [True, False])
@pytest.mark.parametrize("f,b,t,s", [(1, 2, 1, 3), (5, 35, 10, 81), (3, 9, 17, 130)])
def test_flat_layout_matches_reference_lane8(f, b, t, s, vote):
    rng = np.random.default_rng(f * 100 + t)
    ftable = rng.integers(0, 4, (f, b, t)).astype(np.int32)
    strides = rng.integers(1, 50, (t, f)).astype(np.int32)
    dtable = (rng.integers(0, 3, (t, s)) if vote
              else rng.integers(-500, 500, (t, s))).astype(np.int32)
    q = rng.integers(-900, 900, (f, b, 6)).astype(np.int32)
    assert_bit_equal(jart.flatten_ftable(jnp.asarray(ftable), jnp.asarray(strides), 8),
                     tart.flatten_ftable(torch.from_numpy(ftable),
                                         torch.from_numpy(strides)))
    assert_bit_equal(jart.build_dtable_flat(jnp.asarray(dtable), 3, vote, 8),
                     tart.build_dtable_flat(torch.from_numpy(dtable), 3, vote))
    assert_bit_equal(jart.pad_dtable(jnp.asarray(dtable), 8),
                     tart.pad_dtable(torch.from_numpy(dtable)))
    assert_bit_equal(jart.flatten_vtable(jnp.asarray(q), 8),
                     tart.flatten_vtable(torch.from_numpy(q)))


def test_artifact_from_arrays_roundtrip(anomaly_data):
    xtr, ytr, _, _ = anomaly_data
    ja = _jax_artifact("RF", xtr, ytr)
    ta = port_artifact(ja)
    assert ta.pad_meta == ja.pad_meta
    assert (ta.n_features, ta.n_trees, ta.n_bins) == (ja.n_features, ja.n_trees, ja.n_bins)
    # the carried-across flat layout is what the port itself builds (lane 8)
    stripped = tart.TableArtifact(edges=ta.edges, agg=ta.agg,
                                  n_classes=ta.n_classes, ftable=ta.ftable,
                                  strides=ta.strides,
                                  dtable_class=ta.dtable_class,
                                  dtable_value=ta.dtable_value)
    rebuilt = tart.finalize_artifact(stripped)
    for name in ("ftable_flat", "dtable_flat", "dtable_pad"):
        assert_bit_equal(getattr(ja, name), getattr(rebuilt, name))
    assert tart.finalize_artifact(rebuilt) is rebuilt              # idempotent
    assert rebuilt.shape_signature() == ta.shape_signature()
    assert ta.to("cpu").device == torch.device("cpu")


@pytest.mark.parametrize("model", ALL_MODELS)
def test_table_predict_parity_all_aggs(model, anomaly_data):
    """The same reference artifact gives the same (pred, conf) in the port:
    pred exact, conf bitwise for votes and within 1 ulp otherwise."""
    xtr, ytr, xte, _ = anomaly_data
    ja = _jax_artifact(model, xtr, ytr)
    pj, cj = jax_table_predict(ja, xte[:400])
    pt, ct = table_predict(port_artifact(ja), xte[:400])
    assert_bit_equal(pj, pt)
    assert_conf_parity(ja.agg, cj, ct)
    if ja.ftable is not None and ja.agg == "vote":
        from repro.core.inference import table_predict_per_tree as jax_per_tree
        assert_bit_equal(jax_per_tree(ja, xte[:50]),
                         table_predict_per_tree(port_artifact(ja), xte[:50]))


def test_relative_error_matches_reference_and_falls_with_bits():
    """The mean relative calc error of a quantized table (Fig 9) against the
    reference (an f32 mean summed in another order: rtol 1e-6), falling as
    the action bits grow (the reference's ``test_action_bits_monotone``),
    and zero-safe (a zero value divides by 1e-9)."""
    from repro.core.quantize import relative_error as jax_rel
    from repro_torch.core.quantize import relative_error
    v = np.random.default_rng(1).normal(0, 3, (64, 64)).astype(np.float32)
    v[0, :4] = 0.0
    errs = []
    for bits in (8, 12, 16, 24):
        got = relative_error(quantize_fixed(v, bits), v)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, jax_rel(jax_quantize(v, bits), v),
                                   rtol=1e-6)
        errs.append(got)
    assert all(errs[i] >= errs[i + 1] for i in range(len(errs) - 1))

