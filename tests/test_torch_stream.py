"""Port parity for the per-window streaming path: packet traces and the
flow hash, batch and streamed flow features, the register half
(``window_update_readout``) under both eviction policies, and
``StreamingHybridServer.step`` / ``serve_trace`` against the reference's
jitted server, with the switch artifact and the backend forest carried
across. Everything runs on the CPU (the plain versions of B5 and B6).

Tolerances: predictions, ``HybridStats``, every integer ``StreamStats``
counter, the flow table and the register file compare bit for bit.
``conf_sum`` is an f32 sum over each window's lanes that the two packages
associate differently (XLA's reduction against PyTorch's), so it compares
at rtol=1e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.netsim import features as jfeat  # noqa: E402
from repro.netsim import packets as jpackets  # noqa: E402
from repro.netsim import stream as jstream  # noqa: E402
from repro.serving.stream_serving import \
    StreamingHybridServer as JaxStreamServer  # noqa: E402
from repro_torch.netsim import features as tfeat  # noqa: E402
from repro_torch.netsim import packets as tpackets  # noqa: E402
from repro_torch.netsim import stream as tstream  # noqa: E402
from repro_torch.serving.stream_serving import (  # noqa: E402
    StreamingHybridServer, StreamStats)
from test_torch_parity import (assert_bit_equal, port_artifact,  # noqa: E402
                               port_ensemble, port_flow_table, port_window)

N_BUCKETS = 1 << 12


def _permute_packets(tr, perm):
    return dataclasses.replace(tr, **{
        f.name: getattr(tr, f.name)[perm]
        for f in dataclasses.fields(tr) if f.name != "flow_label"})


@pytest.fixture(scope="module")
def stream_setup():
    """The reference's streaming fixture (tests/test_stream.py): 400 flows,
    a 4x3 RF switch and a 12x5 RF backend trained on the batch flow
    features, both carried across to the port."""
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_random_forest, predict_tree_ensemble
    from repro_torch.ml.trees import predict_tree_ensemble as t_predict
    trace = jpackets.synth_trace(n_flows=400, seed=3)
    b, table = jfeat.flow_features(trace, n_buckets=N_BUCKETS)
    first_idx = np.unique(np.asarray(trace.flow_id), return_index=True)[1]
    rows = np.asarray(table)[np.asarray(b)[first_idx]].astype(np.float32)
    small = fit_random_forest(rows, trace.flow_label, n_classes=2,
                              n_trees=4, max_depth=3, seed=0)
    big = fit_random_forest(rows, trace.flow_label, n_classes=2,
                            n_trees=12, max_depth=5, seed=1)
    art = map_tree_ensemble(small, rows.shape[1])
    tbig = port_ensemble(big)
    return (trace, art, lambda r: predict_tree_ensemble(big, r),
            port_artifact(art), lambda r: t_predict(tbig, r))


# -- traces, hash, batch features ----------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_synth_trace_matches_reference(seed):
    a = jpackets.synth_trace(n_flows=300, seed=seed)
    b = tpackets.synth_trace(n_flows=300, seed=seed)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype, f.name
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n_buckets", [N_BUCKETS, 1000, 7])
def test_fnv1a_hash_matches_reference(n_buckets):
    """uint32 wraparound in int64: the trace's 5-tuples, and int32 columns
    with negative values and extremes (cast to uint32 by both)."""
    tr = jpackets.synth_trace(n_flows=200, seed=1)
    cols = (tr.src_ip, tr.dst_ip, tr.sport, tr.dport, tr.proto)
    assert_bit_equal(jfeat.fnv1a_hash(*cols, n_buckets=n_buckets),
                     tfeat.fnv1a_hash(*cols, n_buckets=n_buckets,
                                      device="cpu"))
    rng = np.random.default_rng(n_buckets)
    ints = rng.integers(-2**31, 2**31, 500).astype(np.int32)
    ints[:3] = [-1, -2**31, 2**31 - 1]
    ref = jfeat.fnv1a_hash(ints, ints[::-1].copy(), n_buckets=n_buckets)
    assert_bit_equal(ref, tfeat.fnv1a_hash(ints, ints[::-1].copy(),
                                           n_buckets=n_buckets, device="cpu"))
    assert_bit_equal(ref, tfeat.fnv1a_hash(torch.from_numpy(ints),
                                           torch.from_numpy(ints[::-1].copy()),
                                           n_buckets=n_buckets))


def test_flow_and_packet_features_match_reference():
    tr = jpackets.synth_trace(n_flows=300, seed=5)
    tr.ts = tr.ts + 1.7e9                         # epoch-scale timestamps
    jb, jt = jfeat.flow_features(tr, n_buckets=2048)
    tb, tt = tfeat.flow_features(tr, n_buckets=2048, device="cpu")
    assert_bit_equal(jb, tb)
    assert_bit_equal(jt, tt)
    assert (tt[:, 2] > 0).any()                   # durations survived
    assert_bit_equal(jfeat.packet_features(tr),
                     tfeat.packet_features(tr, device="cpu"))
    assert_bit_equal(jfeat.rebase_ts(tr.ts, 1.7e9),
                     tfeat.rebase_ts(tr.ts, 1.7e9, device="cpu"))


# -- streamed flow table --------------------------------------------------------

def test_stream_flow_features_bit_equal_batch_at_every_window():
    """Streamed over windows of 64, 257, 1000 and P+5 packets, the port's
    flow table equals the reference's batch table bit for bit."""
    tr = jpackets.synth_trace(n_flows=300, seed=5)
    jb, jt = jfeat.flow_features(tr, n_buckets=2048)
    for w in (64, 257, 1000, tr.n_packets + 5):
        tb, tt = tstream.stream_flow_features(tr, n_buckets=2048, window=w,
                                              device="cpu")
        assert_bit_equal(jt, tt)
        assert_bit_equal(jb, tb)


def test_stream_flow_features_epoch_and_reordered_timestamps():
    tr = jpackets.synth_trace(n_flows=200, seed=13)
    tr.ts = tr.ts + 1.7e9
    perm = np.arange(tr.n_packets)
    perm[:250] = np.random.default_rng(1).permutation(250)
    tr = _permute_packets(tr, perm)
    assert float(tr.ts[0]) > float(tr.ts.min())   # epoch arrives late
    _, jt = jfeat.flow_features(tr, n_buckets=2048)
    for t0 in (None, float(tr.ts.min())):
        _, tt = tstream.stream_flow_features(tr, n_buckets=2048, window=128,
                                             t0=t0, device="cpu")
        assert_bit_equal(jt, tt)


@pytest.mark.parametrize("pad", [True, False])
def test_iter_windows_match_reference(pad):
    tr = jpackets.synth_trace(n_flows=60, seed=4)
    jws = list(jstream.iter_windows(tr, 100, 512, pad=pad))
    tws = list(tstream.iter_windows(tr, 100, 512, pad=pad, device="cpu"))
    assert len(jws) == len(tws) == -(-tr.n_packets // 100)
    for jw, tw in zip(jws, tws):
        for f in ("bucket", "ts", "length", "is_fwd", "valid"):
            assert_bit_equal(getattr(jw, f), getattr(tw, f))
    cols, t0 = tstream.trace_columns(tr, 512)
    jcols, jt0 = jstream.trace_columns(tr, 512)
    assert t0 == jt0
    for k in jcols:
        assert_bit_equal(jcols[k], cols[k])


# -- the register half -----------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("policy", ["timeout", "approx_lru"])
def test_window_update_readout_matches_reference(policy, use_kernel):
    """Window by window against the reference's jitted register half at
    evict_age=2.0: register file, readout rows, evicted and saturated
    counts. N=128 for 300 flows keeps the approx-LRU table above its
    occupancy mark, so that sweep evicts too."""
    tr = jpackets.synth_trace(n_flows=300, seed=9)
    n = 128
    kw = dict(evict_age=2.0, evict_policy=policy, lru_occupancy=0.75)
    jfn = jax.jit(functools.partial(jstream.window_update_readout, **kw))
    jstate = jstream.init_flow_table(n)
    tstate = tstream.init_flow_table(n, device="cpu")
    evicted = 0
    for jw in jstream.iter_windows(tr, 128, n):
        tw = port_window(jw)
        jstate, jx, jev, jov = jfn(jstate, jw)
        tstate, tx, tev, tov = tstream.window_update_readout(
            tstate, tw, use_kernel=use_kernel, **kw)
        assert_bit_equal(port_flow_table(jstate).regs, tstate.regs)
        assert_bit_equal(jx, tx)
        assert int(jev) == int(tev) and int(jov) == int(tov)
        evicted += int(tev)
    assert evicted > 0


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("evict_age", [None, 2.0])
def test_window_update_readout_counts_saturations_like_reference(
        evict_age, use_kernel):
    """The overflow guard near 2^24, window by window against the
    reference's jitted register half: columns a few packets or a few
    thousand bytes below the limit, several lanes per column, pad lanes,
    and columns that stay saturated over later windows, so each
    saturation is counted once and only in its window."""
    rng = np.random.default_rng(11)
    n, w, lim = 64, 48, tstream.OVERFLOW_LIMIT
    regs = np.zeros((8, n), np.float32)
    regs[2], regs[3] = np.inf, -np.inf
    occ = np.arange(40)
    regs[0, occ] = rng.integers(1, 50, occ.size)
    regs[0, :12] = lim - rng.integers(1, 7, 12)
    regs[1, occ] = regs[0, occ] * 64.0
    regs[1, 12:24] = lim - rng.integers(500, 4000, 12)
    regs[4, occ] = regs[0, occ]
    regs[6, 24:32] = lim - 1500.0
    regs[2, occ] = rng.uniform(0.0, 1.0, occ.size).astype(np.float32)
    regs[3, occ] = regs[2, occ] + 0.5
    jstate = jstream.FlowTableState(*[jnp.asarray(r) for r in regs])
    tstate = tstream.FlowTableState(torch.from_numpy(regs.copy()))
    jfn = jax.jit(functools.partial(jstream.window_update_readout,
                                    evict_age=evict_age))
    saturated = []
    for k in range(4):
        # pad lanes as iter_windows makes them: the last packet replicated
        n_valid = w - 5 * k
        bucket = rng.integers(0, 44, w)
        bucket[n_valid:] = bucket[n_valid - 1]
        jw = jstream.PacketWindow(
            bucket=jnp.asarray(bucket, jnp.int32),
            ts=jnp.asarray(rng.uniform(1.0 + k, 2.0 + k, w), jnp.float32),
            length=jnp.asarray(rng.integers(40, 1500, w), jnp.float32),
            is_fwd=jnp.asarray(rng.random(w) < 0.6, jnp.float32),
            valid=jnp.asarray(np.arange(w) < n_valid))
        jstate, jx, jev, jov = jfn(jstate, jw)
        tstate, tx, tev, tov = tstream.window_update_readout(
            tstate, port_window(jw), evict_age=evict_age,
            use_kernel=use_kernel)
        assert_bit_equal(port_flow_table(jstate).regs, tstate.regs)
        assert_bit_equal(jx, tx)
        assert int(jev) == int(tev) and int(jov) == int(tov)
        saturated.append(int(tov))
    assert saturated[0] > 0 and sum(saturated) < 2 * 12 + 8


def test_saturate_counts_counts_new_saturations_once():
    rng = np.random.default_rng(0)
    regs = np.zeros((8, 64), np.float32)
    regs[2], regs[3] = np.inf, -np.inf
    regs[0] = rng.integers(0, 3, 64) + tstream.OVERFLOW_LIMIT - 2
    prev = regs.copy()
    regs[0, :10] += 4.0
    jnew, jn = jstream.saturate_counts(
        jstream.FlowTableState(*[jnp.asarray(r) for r in regs]),
        prev=jstream.FlowTableState(*[jnp.asarray(r) for r in prev]))
    tnew, tn = tstream.saturate_counts(
        tstream.FlowTableState(torch.from_numpy(regs)),
        prev=tstream.FlowTableState(torch.from_numpy(prev)))
    assert int(jn) == int(tn) > 0
    assert_bit_equal(port_flow_table(jnew).regs, tnew.regs)
    _, jn2 = jstream.saturate_counts(jnew)
    _, tn2 = tstream.saturate_counts(tnew)
    assert int(jn2) == int(tn2) == 0


@pytest.mark.parametrize("evict_age", [5.0, 2.0, 0.7])
def test_age_classes_use_the_jitted_reciprocal(evict_age):
    """The reference computes ``floor(idle / period)`` under ``jax.jit``,
    where XLA turns the division by the constant period into a product
    with its f32 reciprocal. The port computes that product: equal on all
    200,000 draws, where a true division rounds differently on tens of
    thousands of quotients."""
    rng = np.random.default_rng(0)
    idle = rng.uniform(0, 20, 200_000).astype(np.float32)
    jitted = jax.jit(lambda i: jnp.floor(
        i / (jnp.float32(evict_age) / jnp.float32(3.0))))(jnp.asarray(idle))
    assert_bit_equal(jitted, tstream._age_classes(torch.from_numpy(idle),
                                                  evict_age, 3))
    period = np.float32(evict_age) / np.float32(3.0)
    assert (idle / period != idle * (np.float32(1.0) / period)).sum() > 1000


def test_log2_activity_classes_hidden_by_the_clip():
    """XLA's jitted log2 gives 12.999999 at 8192 and 14.999999 at 32768,
    where torch gives 13 and 15. The approx-LRU activity class clips
    floor(log2(pkt_count + 1)) at 2^LRU_ACT_BITS - 1, so every count where
    the two floors differ lies above the clip and the classes agree. A
    larger ``act_bits`` would expose the difference: this test fails then."""
    counts = np.concatenate([2.0 ** np.arange(1, 25) - 1,
                             np.arange(0, 40000)]).astype(np.float32)
    jfloor = np.asarray(jax.jit(lambda c: jnp.floor(jnp.log2(c + 1.0)))(
        jnp.asarray(counts)))
    tfloor = torch.floor(torch.log2(torch.from_numpy(counts) + 1.0)).numpy()
    top = float((1 << tstream.LRU_ACT_BITS) - 1)
    differ = jfloor != tfloor
    assert np.all(np.minimum(jfloor[differ], tfloor[differ]) >= top)
    np.testing.assert_array_equal(np.clip(jfloor, 0, top),
                                  np.clip(tfloor, 0, top))


# -- the streaming server -----------------------------------------------------

def _servers(setup, **kw):
    trace, art, jbackend, tart, tbackend = setup
    base = dict(n_buckets=N_BUCKETS, window=256, threshold=0.9, capacity=32)
    base.update(kw)
    return (trace, JaxStreamServer(art, jbackend, **base),
            StreamingHybridServer(tart, tbackend, device="cpu", **base),
            StreamingHybridServer(tart, tbackend, device="cpu",
                                  use_kernel=False, **base))


def _assert_stats_equal(jstats, tstats):
    jd, td = jstats.as_dict(), tstats.as_dict()
    for k in ("windows", "packets", "handled", "backend_rows", "deferred",
              "degraded", "flushes", "evicted", "overflow",
              "fraction_handled"):
        assert jd[k] == td[k], k
    np.testing.assert_allclose(td["conf_sum"], jd["conf_sum"], rtol=1e-5)


@pytest.mark.parametrize("evict", [
    {}, {"evict_policy": "timeout", "evict_age": 2.0},
    # the streaming configuration's age (the timeout sweep in one call)
    {"evict_policy": "timeout", "evict_age": 5.0},
    # 400 flows in 256 buckets: the approx-LRU sweep runs under pressure
    {"evict_policy": "approx_lru", "evict_age": 2.0, "n_buckets": 256}])
def test_step_matches_reference_window_by_window(stream_setup, evict):
    trace, jsrv, tsrv, plain = _servers(stream_setup, **evict)
    for jw in jstream.iter_windows(trace, 256, tsrv.n_buckets):
        tw = port_window(jw)
        jp, js = jsrv.step(jw)
        tp, ts = tsrv.step(tw)
        pp, _ = plain.step(tw)
        assert_bit_equal(jp, tp)
        assert_bit_equal(tp, pp)
        assert js.fraction_handled == ts.fraction_handled
        assert js.backend_rows == ts.backend_rows
        assert ts.capacity == 32
    _assert_stats_equal(jsrv.stats, tsrv.stats)
    _assert_stats_equal(jsrv.stats, plain.stats)
    assert_bit_equal(jsrv.flow_table(), tsrv.flow_table())
    assert_bit_equal(tsrv.flow_table(), plain.flow_table())
    if evict:
        assert tsrv.stats.n_evicted > 0


def test_serve_trace_matches_reference(stream_setup):
    trace, jsrv, tsrv, _ = _servers(stream_setup, window=512)
    jp, js = jsrv.serve_trace(trace)
    tp, ts = tsrv.serve_trace(trace)
    assert tp.shape == (trace.n_packets,)
    assert_bit_equal(jp, tp)
    _assert_stats_equal(js, ts)
    assert ts.n_windows == -(-trace.n_packets // 512)
    assert ts.n_packets == trace.n_packets
    # the streamed register file is the batch oracle's
    assert_bit_equal(jfeat.flow_features(trace, n_buckets=N_BUCKETS)[1],
                     tsrv.flow_table())
    tsrv.reset()
    assert tsrv.stats.n_windows == 0
    assert float(tsrv.flow_table().abs().sum()) == 0.0


def test_stream_stats_are_lazy_tensors(stream_setup):
    trace, _, tsrv, _ = _servers(stream_setup)
    w = next(iter(tstream.iter_windows(trace, 256, N_BUCKETS, device="cpu")))
    pred, hs = tsrv.step(w)
    st = tsrv.stats
    assert isinstance(st.windows, torch.Tensor) and st.windows.dim() == 0
    assert st.windows.dtype == torch.int32
    assert st.conf_sum.dtype == torch.float32
    d = st.as_dict()
    assert d["windows"] == 1 and d["packets"] == 256
    assert d["handled"] + d["backend_rows"] + d["deferred"] == 256
    assert st.check() is st
    assert 0.0 < d["mean_conf"] <= 1.0
    bad = dataclasses.replace(st, handled=st.handled + 1)
    with pytest.raises(AssertionError):
        bad.check()
    assert "StreamStats(windows=1" in repr(st)
    zero = StreamStats.zero("cpu")
    assert zero.fraction_handled == 0.0 and zero.mean_conf == 0.0


def test_streaming_server_rejects_bad_settings(stream_setup):
    _, _, _, tart, tbackend = stream_setup
    with pytest.raises(ValueError):
        StreamingHybridServer(tart, tbackend, evict_policy="lfu",
                              device="cpu")
    with pytest.raises(ValueError):
        StreamingHybridServer(tart, tbackend, evict_policy="approx_lru",
                              device="cpu")
    with pytest.raises(ValueError):
        StreamingHybridServer(tart, tbackend, evict_policy="approx_lru",
                              evict_age=1.0, lru_occupancy=1.0, device="cpu")
    with pytest.raises(ValueError):
        StreamingHybridServer(tart, tbackend, use_kernel=True, device="cpu")
