"""Parity harness between the JAX reference (``repro``) and the PyTorch port
(``repro_torch``): converters that carry the reference's artifacts,
ensembles, flow-table states and packet windows across as numpy arrays,
and the bit-equality and ulp checks the other ``test_torch_*`` files use.
Its own tests check the helpers."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.artifact import artifact_from_arrays  # noqa: E402
from repro_torch.ml.kmeans import kmeans_from_arrays  # noqa: E402
from repro_torch.ml.naive_bayes import nb_from_arrays  # noqa: E402
from repro_torch.ml.svm import svm_from_arrays  # noqa: E402
from repro_torch.ml.trees import ensemble_from_arrays  # noqa: E402
from repro_torch.netsim.stream import (REGISTER_FIELDS,  # noqa: E402
                                       flow_table_from_arrays,
                                       packet_window_from_arrays)


def artifact_arrays(art) -> dict:
    """Every field of a reference ``TableArtifact`` as numpy / Python values."""
    out = {}
    for f in dataclasses.fields(art):
        v = getattr(art, f.name)
        if v is None:
            continue
        if hasattr(v, "q"):                              # FixedPoint
            out[f.name] = {"q": np.array(v.q), "scale": np.array(v.scale),
                           "bits": v.bits}
        elif isinstance(v, (str, int, float)):
            out[f.name] = v
        else:
            out[f.name] = np.array(v)
    return out


def port_artifact(jax_art):
    """The reference's artifact carried across into the port (CPU)."""
    return artifact_from_arrays(artifact_arrays(jax_art))


def hand_built(vote: bool, seed: int = 0, t: int = 7, s: int = 60):
    """A reference tree artifact whose strides let keys run past S: codes
    in [0, 3) with strides 3^f over F = 4 features reach 3^4 - 1 = 80, so
    with S = 60 (Sp = 64) some keys fall outside [0, S) and some outside
    [0, Sp). There the compare selects and the loop kernel read leaf 0 (a
    vote for class 0) and the matmul select adds nothing."""
    import jax.numpy as jnp
    from repro.core.artifact import TableArtifact
    from repro.core.quantize import quantize_fixed
    rng = np.random.default_rng(seed)
    f, u, c = 4, 10, 3
    dvals = rng.integers(-900, 900, (t, s)).astype(np.float32)
    return TableArtifact(
        edges=jnp.asarray(np.sort(rng.normal(size=(f, u)), axis=1)
                          .astype(np.float32)),
        agg="vote" if vote else "wsum_sigmoid", n_classes=c if vote else 2,
        ftable=jnp.asarray(rng.integers(0, 3, (f, u + 1, t)).astype(np.int32)),
        strides=jnp.asarray(np.array([[1, 3, 9, 27]] * t, np.int32)),
        dtable_class=jnp.asarray(rng.integers(0, c, (t, s)).astype(np.int32)),
        dtable_value=quantize_fixed(dvals, 16))


def port_ensemble(jax_ens, device="cpu"):
    return ensemble_from_arrays(
        np.array(jax_ens.feat), np.array(jax_ens.thresh),
        np.array(jax_ens.leaf), jax_ens.kind, base_score=jax_ens.base_score,
        learning_rate=jax_ens.learning_rate, n_classes=jax_ens.n_classes,
        device=device)


def port_svm(jax_svm, device="cpu"):
    return svm_from_arrays(jax_svm.weights, jax_svm.bias, jax_svm.pairs,
                           jax_svm.mean, jax_svm.scale,
                           n_classes=jax_svm.n_classes, device=device)


def port_nb(jax_nb, device="cpu"):
    return nb_from_arrays(jax_nb.mu, jax_nb.var, jax_nb.log_prior,
                          n_classes=jax_nb.n_classes, device=device)


def port_kmeans(jax_km, device="cpu"):
    return kmeans_from_arrays(jax_km.centers, jax_km.mean, jax_km.scale,
                              device=device)


def port_flow_table(jax_state, device="cpu"):
    """The reference's ``FlowTableState`` (one array per register) as the
    port's stacked (8, N) register file."""
    return flow_table_from_arrays(
        {f: np.array(getattr(jax_state, f)) for f in REGISTER_FIELDS},
        device=device)


def port_window(jax_w, device="cpu"):
    """The reference's ``PacketWindow`` carried across."""
    return packet_window_from_arrays(
        np.array(jax_w.bucket), np.array(jax_w.ts), np.array(jax_w.length),
        np.array(jax_w.is_fwd), np.array(jax_w.valid), device=device)


def to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def assert_bit_equal(ref, port):
    """Same shape and the same values bit for bit (NaNs compared as equal)."""
    a, b = to_np(ref), to_np(port)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def ulp_distance(ref, port) -> np.ndarray:
    """Elementwise distance in float32 ulps (same-sign finite values)."""
    a = to_np(ref).astype(np.float32).view(np.int32).astype(np.int64)
    b = to_np(port).astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


CONF_ULPS = 2


def assert_conf_parity(agg: str, ref, port):
    """The confidence rule: bitwise for votes (integer counts over an integer
    tree count). Every other aggregation's confidence is a transcendental's
    output t (sigmoid, softmax, exp) or 1 - t, and XLA's and PyTorch's
    transcendentals differ by up to CONF_ULPS ulps of t (measured: 2, in
    the sigmoid of svm_ovo and the exp of kmeans), so the gap is bounded by
    CONF_ULPS ulps of the larger of conf and 1 - conf."""
    if agg == "vote":
        assert_bit_equal(ref, port)
        return
    a = to_np(ref).astype(np.float32)
    b = to_np(port).astype(np.float32)
    assert a.shape == b.shape
    unit = np.maximum(np.spacing(np.abs(a)),
                      np.spacing(np.abs(np.float32(1.0) - a)))
    gap = np.abs(a.astype(np.float64) - b.astype(np.float64))
    assert np.all(gap <= CONF_ULPS * unit.astype(np.float64)), gap.max()


def test_ulp_distance_counts_neighbours():
    x = np.float32(0.9)
    nxt = np.nextafter(x, np.float32(2.0))
    assert ulp_distance(np.array([x]), np.array([nxt]))[0] == 1
    assert ulp_distance(np.array([x]), np.array([x]))[0] == 0


def test_assert_conf_parity_rule():
    a = np.array([0.5, 0.9], np.float32)
    b = np.nextafter(a, np.float32(2.0))
    assert_conf_parity("wsum_sigmoid", a, b)
    with pytest.raises(AssertionError):
        assert_conf_parity("vote", a, b)
    far = np.nextafter(np.nextafter(b, np.float32(2.0)), np.float32(2.0))
    with pytest.raises(AssertionError):
        assert_conf_parity("kmeans", a, far)


def test_artifact_arrays_carry_every_field(anomaly_data):
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_random_forest
    xtr, ytr, _, _ = anomaly_data
    ens = fit_random_forest(xtr, ytr, n_classes=2, n_trees=3, max_depth=3)
    jart = map_tree_ensemble(ens, 5)
    tart = port_artifact(jart)
    for f in dataclasses.fields(jart):
        v = getattr(jart, f.name)
        w = getattr(tart, f.name)
        if v is None:
            assert w is None, f.name
        elif hasattr(v, "q"):
            assert_bit_equal(v.q, w.q)
            assert_bit_equal(v.scale, w.scale)
            assert v.bits == w.bits
        elif isinstance(v, (str, int, float)):
            assert v == w, f.name
        else:
            assert_bit_equal(v, w)
    tens = port_ensemble(ens)
    assert_bit_equal(ens.feat, tens.feat)
    assert_bit_equal(ens.thresh, tens.thresh)
    assert_bit_equal(ens.leaf, tens.leaf)
    assert tens.kind == "rf" and tens.depth == 3 and tens.n_trees == 3


def test_flow_table_and_window_converters():
    from repro.netsim.packets import synth_trace
    from repro.netsim.stream import (init_flow_table, iter_windows,
                                     update_flow_table)
    tr = synth_trace(n_flows=40, seed=2)
    w = next(iter(iter_windows(tr, 64, 256)))
    state = update_flow_table(init_flow_table(256), w)
    ts = port_flow_table(state)
    assert ts.regs.shape == (8, 256) and ts.regs.dtype == torch.float32
    for f in REGISTER_FIELDS:
        assert_bit_equal(getattr(state, f), getattr(ts, f))
    tw = port_window(w)
    for f in ("bucket", "ts", "length", "is_fwd", "valid"):
        assert_bit_equal(getattr(w, f), getattr(tw, f))
    assert tw.bucket.dtype == torch.int32 and tw.valid.dtype == torch.bool
