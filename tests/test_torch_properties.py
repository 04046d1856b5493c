"""Hypothesis property tests on the port's invariants: the cases of the
reference's ``tests/test_properties.py`` whose modules the port has
(bucketize is the rank, the quantize contracts, the hybrid dispatch round
trip, the ingest ring's replay), each also held bit for bit against the
reference on the drawn inputs. Everything runs on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip(
    "hypothesis", reason="hypothesis not installed; property tests skipped")

import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import hybrid as jhybrid  # noqa: E402
from repro.core.quantize import quantize_fixed as jax_quantize  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import hybrid as thybrid  # noqa: E402
from repro_torch.core.quantize import dequantize, quantize_fixed  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the reference's profile: 25 examples, no deadline
PROFILE = settings(max_examples=25, deadline=None)

_FLOATS = st.floats(-1e4, 1e4, allow_nan=False, width=32,
                    allow_subnormal=False)   # XLA flushes subnormals (FTZ)


@PROFILE
@given(
    st.integers(1, 40).flatmap(lambda n: st.tuples(
        st.just(n), st.lists(_FLOATS, min_size=n, max_size=n))),
    st.lists(_FLOATS, min_size=1, max_size=12),
)
def test_bucketize_is_rank(pair, edges_raw):
    """bucketize(x) is the rank of x among the edges: bounded by the edge
    count, monotone in x, exact on ties, and the reference's bins."""
    _, xs = pair
    edges = np.sort(np.asarray(edges_raw, np.float32))
    x = np.asarray(xs, np.float32)[:, None]                 # (N, 1)
    out = tref.bucketize_ref(torch.from_numpy(x),
                             torch.from_numpy(edges[None, :]))
    assert out.dtype == torch.int32
    out = out.numpy()[:, 0]
    assert out.min() >= 0 and out.max() <= len(edges)
    order = np.argsort(x[:, 0], kind="stable")
    assert (np.diff(out[order]) >= 0).all()
    np.testing.assert_array_equal(out, (x > edges[None, :]).sum(axis=1))
    np.testing.assert_array_equal(
        out, np.asarray(jref.bucketize_ref(jnp.asarray(x),
                                           jnp.asarray(edges[None, :])))[:, 0])


@PROFILE
@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False, width=32),
                min_size=1, max_size=200),
       st.sampled_from([8, 12, 16, 24]))
def test_quantize_bounded_error(vals, bits):
    """|dequant(quant(v)) - v| <= max|v| / (2^(bits-1) - 1) elementwise,
    with the reference's codes and scale."""
    v = np.asarray(vals, np.float32)
    fp = quantize_fixed(v, bits)
    deq = dequantize(fp).numpy()
    bound = (np.abs(v).max() + 1e-12) / (2 ** (bits - 1) - 1)
    assert np.all(np.abs(deq - v) <= bound * 1.0001)
    jfp = jax_quantize(v, bits)
    np.testing.assert_array_equal(np.asarray(jfp.q), fp.q.numpy())
    np.testing.assert_array_equal(np.asarray(jfp.scale), fp.scale.numpy())


@PROFILE
@given(st.lists(st.floats(-1e4, 1e4, allow_nan=False, width=32,
                          allow_subnormal=False), min_size=1, max_size=200),
       st.sampled_from([4, 8, 12, 16]))
def test_quantize_symmetric_range(vals, bits):
    """Symmetric fixed point never dequantizes past max|v|: codes stay in
    [-qmax, qmax]."""
    v = np.asarray(vals, np.float32)
    fp = quantize_fixed(v, bits)
    qmax = 2 ** (bits - 1) - 1
    assert int(fp.q.min()) >= -qmax and int(fp.q.max()) <= qmax
    max_abs = max(float(np.abs(v).max()), 1e-12)
    assert float(dequantize(fp).abs().max()) <= max_abs * (1 + 1e-6)


@PROFILE
@given(st.integers(2, 64), st.integers(1, 8), st.integers(0, 3))
def test_quantize_integer_sum_exact(n, m, seed):
    """Summing in the integer domain then dequantizing equals summing the
    dequantized values up to f32 rounding (the switch-ALU property)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 10, (n, m)).astype(np.float32)
    fp = quantize_fixed(v, 16)
    left = (fp.q.sum(dim=0).to(torch.float32) / fp.scale).numpy()
    right = dequantize(fp).sum(dim=0).numpy()
    np.testing.assert_allclose(left, right, rtol=1e-4, atol=1e-4)


@PROFILE
@given(st.integers(1, 30), st.integers(2, 8), st.integers(0, 5))
def test_hybrid_dispatch_roundtrip(n_fwd, cap, seed):
    """dispatch/combine: forwarded rows up to capacity get the backend's
    answer, everything else keeps the switch's, and the reference picks
    the same rows."""
    rng = np.random.default_rng(seed)
    n = 32
    mask = np.zeros(n, bool)
    mask[rng.choice(n, size=min(n_fwd, n), replace=False)] = True
    x = rng.normal(0, 1, (n, 3)).astype(np.float32)
    buf, idx, valid = thybrid.dispatch(torch.from_numpy(x),
                                       torch.from_numpy(mask), cap)
    out = thybrid.combine(torch.zeros(n, dtype=torch.int32),
                          torch.ones(cap, dtype=torch.int32), idx, valid)
    assert int(out.sum()) == min(int(mask.sum()), cap)
    assert np.all(mask[idx.numpy()[valid.numpy()]])
    jbuf, jidx, jvalid = jhybrid.dispatch(jnp.asarray(x), jnp.asarray(mask),
                                          cap)
    np.testing.assert_array_equal(np.asarray(jidx), idx.numpy())
    np.testing.assert_array_equal(np.asarray(jbuf), buf.numpy())
    np.testing.assert_array_equal(np.asarray(jvalid), valid.numpy())


_INGEST_TRACE = None


def _ingest_trace():
    """Small shared trace for the ring-replay property (built lazily, so
    collection stays cheap)."""
    global _INGEST_TRACE
    if _INGEST_TRACE is None:
        from repro.netsim.packets import synth_trace
        _INGEST_TRACE = synth_trace(n_flows=30, seed=17)
    return _INGEST_TRACE


@PROFILE
@given(st.integers(1, 400), st.sampled_from([3, 5, 8]),
       st.sampled_from([1, 2, 3]), st.booleans())
def test_ring_replay_bit_identical_to_iter_chunks(batch, window, k,
                                                  use_deadline):
    """Window-granular cuts: replaying a trace through the port's ingest
    ring in ANY batch size, with count cuts, deadline cuts (an aggressive
    fake clock) and the ragged-tail drain all firing, yields exactly the
    window sequence of ``iter_chunks`` (the port's and the reference's),
    and the same cuts as the reference's ring under the same clock."""
    from repro.netsim import ingest as jingest
    from repro.netsim.stream import iter_chunks as j_iter_chunks
    from repro_torch.netsim import ingest as tingest
    from repro_torch.netsim.stream import iter_chunks
    trace = _ingest_trace()
    n_buckets = 64
    runs = []
    for mod in (tingest, jingest):
        state = {"t": 0.0}

        def clock():
            state["t"] += 1.0          # every look at the clock ages the ring
            return state["t"]

        ring = mod.PacketRingBuffer(window, k, n_buckets,
                                    deadline=0.5 if use_deadline else None,
                                    clock=clock)
        runs.append((list(mod.cut_stream(
            ring, mod.replay_source(trace, batch=batch))), ring.stats))
    (cuts, stats), (jcuts, jstats) = runs
    assert sum(c.n for c in cuts) == trace.n_packets
    assert stats.admitted == trace.n_packets and stats.dropped == 0
    assert all(c.kind in ("count", "deadline", "drain") for c in cuts)
    if not use_deadline:
        assert stats.deadline_cuts == 0
    assert stats.as_dict() == jstats.as_dict()
    assert [(c.kind, c.n) for c in cuts] == [(c.kind, c.n) for c in jcuts]
    for c, jc in zip(cuts, jcuts):
        np.testing.assert_array_equal(c.admit_time, jc.admit_time)
    n_live = -(-trace.n_packets // window) * window   # live windows, padded
    ref = list(iter_chunks(trace, window, k, n_buckets, device="cpu"))
    jref = list(j_iter_chunks(trace, window, k, n_buckets))
    for field in ("bucket", "ts", "length", "is_fwd", "valid"):
        got = np.concatenate([
            (c.valid if field == "valid" else c.cols[field])
            [:c.n_windows * c.window] for c in cuts])
        want = np.concatenate([getattr(rc, field).numpy().reshape(-1)
                               for rc in ref])[:n_live]
        jwant = np.concatenate([np.asarray(getattr(rc, field)).reshape(-1)
                                for rc in jref])[:n_live]
        np.testing.assert_array_equal(got, want, err_msg=field)
        np.testing.assert_array_equal(got, jwant, err_msg=field)
