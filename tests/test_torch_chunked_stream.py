"""Port parity for device-resident chunked streaming: ``PacketChunk``,
``pack_chunk_columns``, ``iter_chunks``, ``chunk_update_readout``, the chunk
dispatch and back-patch (``core.hybrid``), the chunk stats fold, the
chunk-size autotune and ``StreamingHybridServer.step_chunk`` /
``serve_trace(chunk_windows=K)``, against the reference's chunked path
(``tests/test_chunked_stream.py``) and against the port's own per-window
path. Everything runs on the CPU (the plain versions of B5 and B6); the
card's graph routes are in ``tests/test_torch_cuda.py``.

Tolerances: predictions, readout rows, register files, the flow table and
every integer counter compare bit for bit. ``conf_sum`` is an f32 sum that
the packages, and a chunk against K windows, associate differently: it
compares at rtol=1e-5. ``flushes`` counts backend calls, one a chunk.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hybrid as jhybrid  # noqa: E402
from repro.netsim import features as jfeat  # noqa: E402
from repro.netsim import packets as jpackets  # noqa: E402
from repro.netsim import stream as jstream  # noqa: E402
from repro.serving import stream_serving as jserving  # noqa: E402
from repro_torch.core import hybrid as thybrid  # noqa: E402
from repro_torch.netsim import stream as tstream  # noqa: E402
from repro_torch.serving import stream_serving as tserving  # noqa: E402
from repro_torch.serving.stream_serving import \
    StreamingHybridServer  # noqa: E402
from test_torch_parity import (assert_bit_equal, port_artifact,  # noqa: E402
                               port_ensemble, port_flow_table)

N_BUCKETS = 1 << 11
W_FIELDS = ("bucket", "ts", "length", "is_fwd", "valid")


@pytest.fixture(scope="module")
def chunk_setup():
    """The reference's chunked-streaming fixture (300 flows, 2048 buckets):
    a 4x3 RF switch and a 12x5 RF backend trained on the batch flow
    features, both carried across to the port."""
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_random_forest, predict_tree_ensemble
    from repro_torch.ml.trees import predict_tree_ensemble as t_predict
    trace = jpackets.synth_trace(n_flows=300, seed=3)
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


def _port_chunk(jc) -> tstream.PacketChunk:
    return tstream.packet_chunk_from_arrays(
        *(np.array(getattr(jc, f)) for f in W_FIELDS), device="cpu")


def _stats_equal(ref, got, *, flushes=True):
    rd, gd = ref.as_dict(), got.as_dict()
    keys = ["windows", "packets", "handled", "backend_rows", "deferred",
            "degraded", "evicted", "overflow", "fraction_handled"]
    for k in keys + (["flushes"] if flushes else []):
        assert rd[k] == gd[k], k
    np.testing.assert_allclose(gd["conf_sum"], rd["conf_sum"], rtol=1e-5)


# -- chunk packing and the iterator ----------------------------------------------

def test_iter_chunks_rows_equal_iter_windows():
    """Row k of the chunk stream equals the k-th window of ``iter_windows``
    bit for bit, and the reference's chunk; the ragged final chunk is
    padded with dead windows."""
    tr = jpackets.synth_trace(n_flows=150, seed=9)
    ws = list(tstream.iter_windows(tr, 128, N_BUCKETS, device="cpu"))
    for k in (1, 3, 8):
        rows = 0
        jcs = list(jstream.iter_chunks(tr, 128, k, N_BUCKETS))
        tcs = list(tstream.iter_chunks(tr, 128, k, N_BUCKETS, device="cpu"))
        assert len(jcs) == len(tcs) == -(-len(ws) // k)
        for jc, c in zip(jcs, tcs):
            assert c.n_windows == k and c.window == 128
            for f in W_FIELDS:
                assert_bit_equal(getattr(jc, f), getattr(c, f))
                assert getattr(c, f).dtype == getattr(ws[0], f).dtype
            for i in range(k):
                w = c.window_at(i)
                if rows < len(ws):
                    for f in W_FIELDS:
                        assert_bit_equal(getattr(ws[rows], f), getattr(w, f))
                else:   # a dead pad window: every lane invalid
                    assert not bool(w.valid.any())
                    assert not bool(w.bucket.any())
                rows += 1
        assert rows == -(-len(ws) // k) * k


@pytest.mark.parametrize("n,window,rows", [(0, 8, 2), (5, 8, 1), (17, 8, 4),
                                           (24, 8, 3)])
def test_pack_chunk_columns_matches_reference(n, window, rows):
    rng = np.random.default_rng(n)
    cols = dict(bucket=rng.integers(0, 99, n).astype(np.int32),
                ts=rng.random(n).astype(np.float32),
                length=rng.integers(40, 1500, n).astype(np.float32),
                is_fwd=(rng.random(n) < 0.5).astype(np.float32))
    jfull, jvalid = jstream.pack_chunk_columns(cols, n, window, rows)
    tfull, tvalid = tstream.pack_chunk_columns(cols, n, window, rows)
    np.testing.assert_array_equal(jvalid, tvalid)
    for k in jfull:
        assert jfull[k].dtype == tfull[k].dtype
        np.testing.assert_array_equal(jfull[k], tfull[k])
    with pytest.raises(ValueError):
        tstream.pack_chunk_columns(cols, n, window, -(-n // window) - 1)


# -- the chunk register half ------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("evict_age,saturate",
                         [(None, True), (None, False), (1.5, True),
                          (1.5, False)])
def test_chunk_update_readout_bit_equals_stepwise(evict_age, saturate,
                                                  use_kernel):
    """The port's chunk register half equals the reference's
    ``chunk_update_readout`` on its packed route and K port window steps:
    registers, readout rows and the eviction and overflow counts, at
    K in {1, 2, 8}, a ragged final chunk included."""
    tr = jpackets.synth_trace(n_flows=200, seed=5)
    kw = dict(evict_age=evict_age, saturate=saturate)
    ws = list(tstream.iter_windows(tr, 128, N_BUCKETS, device="cpu"))
    s_ref = tstream.init_flow_table(N_BUCKETS, device="cpu")
    xs_ref, ev_ref, ov_ref = [], 0, 0
    for w in ws:
        s_ref, x, ev, ov = tstream.window_update_readout(
            s_ref, w, use_kernel=use_kernel, **kw)
        xs_ref.append(x)
        ev_ref, ov_ref = ev_ref + int(ev), ov_ref + int(ov)
    for k in (1, 2, 8):
        js = jstream.init_flow_table(N_BUCKETS)
        ts = tstream.init_flow_table(N_BUCKETS, device="cpu")
        xs, ev_sum, ov_sum = [], 0, 0
        for jc in jstream.iter_chunks(tr, 128, k, N_BUCKETS):
            js, jx, jev, jov = jstream.chunk_update_readout(
                js, jc, use_pallas=False, **kw)
            ts, tx, tev, tov = tstream.chunk_update_readout(
                ts, _port_chunk(jc), use_kernel=use_kernel, **kw)
            assert tx.shape == (k, 128, 8)
            assert_bit_equal(jx, tx)
            assert_bit_equal(port_flow_table(js).regs, ts.regs)
            assert int(jev) == int(tev) and int(jov) == int(tov)
            assert tev.dtype == tov.dtype == torch.int32
            xs.append(tx)
            ev_sum, ov_sum = ev_sum + int(tev), ov_sum + int(tov)
        xs = torch.cat(list(xs))[:len(ws)]
        for i, x_ref in enumerate(xs_ref):
            assert_bit_equal(x_ref, xs[i])
        assert_bit_equal(s_ref.regs, ts.regs)
        assert (ev_sum, ov_sum) == (ev_ref, ov_ref)
    if evict_age is not None:
        assert ev_ref > 0


@pytest.mark.parametrize("use_kernel", [None, False])
def test_chunk_update_readout_approx_lru_matches_reference(use_kernel):
    """The approx-LRU sweep inside a chunk (the reference's generic scan
    body): 300 flows in 128 buckets keep the table under pressure."""
    tr = jpackets.synth_trace(n_flows=300, seed=9)
    kw = dict(evict_age=2.0, evict_policy="approx_lru", lru_occupancy=0.75)
    js = jstream.init_flow_table(128)
    ts = tstream.init_flow_table(128, device="cpu")
    evicted = 0
    for jc in jstream.iter_chunks(tr, 128, 4, 128):
        js, jx, jev, jov = jstream.chunk_update_readout(js, jc,
                                                        use_pallas=False, **kw)
        ts, tx, tev, tov = tstream.chunk_update_readout(
            ts, _port_chunk(jc), use_kernel=use_kernel, **kw)
        assert_bit_equal(jx, tx)
        assert_bit_equal(port_flow_table(js).regs, ts.regs)
        assert int(jev) == int(tev) and int(jov) == int(tov)
        evicted += int(tev)
    assert evicted > 0


def _one_lane_chunk(bucket, ts, length, k_pad=2):
    """The reference's fixture: a chunk whose first window holds one
    packet, padded with dead windows."""
    shp = (k_pad, 1)
    arrays = {}
    for name, v, dt in (("bucket", bucket, np.int32), ("ts", ts, np.float32),
                        ("length", length, np.float32),
                        ("is_fwd", 1.0, np.float32), ("valid", True, bool)):
        a = np.zeros(shp, dt)
        a[0, 0] = v
        arrays[name] = a
    return (jstream.PacketChunk(**{k: jnp.asarray(v)
                                   for k, v in arrays.items()}),
            tstream.packet_chunk_from_arrays(**arrays, device="cpu"))


@pytest.mark.parametrize("use_kernel", [None, False])
def test_chunk_overflow_counted_once(use_kernel):
    """Saturation inside a chunk: the clamp lands and the slot counts
    exactly once across chunks, as the reference's."""
    lim = tstream.OVERFLOW_LIMIT
    js = jstream.init_flow_table(16)
    ts = tstream.init_flow_table(16, device="cpu")
    for (b, t, ln), want in (((3, 0.0, lim + 1024.0), 2),
                             ((3, 1.0, 2048.0), 0)):
        jc, tc = _one_lane_chunk(b, t, ln)
        js, _, _, jov = jstream.chunk_update_readout(js, jc, saturate=True,
                                                     use_pallas=False)
        ts, _, _, tov = tstream.chunk_update_readout(ts, tc, saturate=True,
                                                     use_kernel=use_kernel)
        assert int(tov) == int(jov) == want   # byte_count AND fwd_bytes
        assert float(ts.byte_count[3]) == lim
        assert_bit_equal(port_flow_table(js).regs, ts.regs)


def _lane_chunk(entries, k):
    """(k, 1) chunk with one packet per listed window: entries maps window
    index -> (bucket, ts, length); unlisted windows are dead. -> (the
    reference's chunk, the port's)."""
    arrays = dict(bucket=np.zeros((k, 1), np.int32),
                  ts=np.zeros((k, 1), np.float32),
                  length=np.zeros((k, 1), np.float32),
                  is_fwd=np.ones((k, 1), np.float32),
                  valid=np.zeros((k, 1), bool))
    for i, (b, t, ln) in entries.items():
        arrays["bucket"][i, 0], arrays["ts"][i, 0] = b, t
        arrays["length"][i, 0], arrays["valid"][i, 0] = ln, True
    return (jstream.PacketChunk(**{f: jnp.asarray(v)
                                   for f, v in arrays.items()}),
            tstream.packet_chunk_from_arrays(**arrays, device="cpu"))


@pytest.mark.parametrize("use_kernel", [None, False])
def test_evict_readmit_within_one_chunk_bit_matches_stepwise(use_kernel):
    """A flow evicted mid-chunk and re-admitted by a later window of the
    same chunk reads out as a fresh one-packet flow, as K window steps and
    the reference's chunk give it."""
    entries = {0: (3, 0.0, 100.0), 1: (5, 10.0, 50.0),
               2: (3, 10.5, 70.0), 3: (3, 10.6, 30.0)}
    jc, tc = _lane_chunk(entries, k=4)
    s_ref = tstream.init_flow_table(16, device="cpu")
    xs_ref, ev_ref = [], 0
    for i in range(4):
        s_ref, x, ev, _ = tstream.window_update_readout(
            s_ref, tc.window_at(i), evict_age=2.0, use_kernel=use_kernel)
        xs_ref.append(x)
        ev_ref += int(ev)
    assert ev_ref == 1
    js, jxs, jev, _ = jstream.chunk_update_readout(
        jstream.init_flow_table(16), jc, evict_age=2.0, use_pallas=False)
    ts, xs, ev, _ = tstream.chunk_update_readout(
        tstream.init_flow_table(16, device="cpu"), tc, evict_age=2.0,
        use_kernel=use_kernel)
    assert int(ev) == int(jev) == 1
    assert_bit_equal(jxs, xs)
    for i, x_ref in enumerate(xs_ref):
        assert_bit_equal(x_ref, xs[i])
    assert float(xs[2, 0, 0]) == 1.0 and float(xs[2, 0, 1]) == 70.0
    assert_bit_equal(s_ref.regs, ts.regs)
    assert_bit_equal(port_flow_table(js).regs, ts.regs)


@pytest.mark.parametrize("use_kernel", [None, False])
def test_saturate_across_chunk_boundary_counts_once(use_kernel):
    """A register crossing 2^24 exactly at a chunk boundary counts once,
    as the stepwise path and the reference's chunks count it."""
    lim = tstream.OVERFLOW_LIMIT
    chunks = [_lane_chunk({0: (3, 0.0, lim - 512.0), 1: (3, 0.1, 256.0)}, 2),
              _lane_chunk({0: (3, 0.2, 1024.0), 1: (3, 0.3, 64.0)}, 2)]
    ts = tstream.init_flow_table(16, device="cpu")
    js = jstream.init_flow_table(16)
    s_ref = tstream.init_flow_table(16, device="cpu")
    ov = jov_sum = ov_ref = 0
    for jc, tc in chunks:
        ts, _, _, o = tstream.chunk_update_readout(ts, tc, saturate=True,
                                                   use_kernel=use_kernel)
        js, _, _, jo = jstream.chunk_update_readout(js, jc, saturate=True,
                                                    use_pallas=False)
        ov, jov_sum = ov + int(o), jov_sum + int(jo)
        for i in range(tc.n_windows):
            s_ref, _, _, o = tstream.window_update_readout(
                s_ref, tc.window_at(i), saturate=True, use_kernel=use_kernel)
            ov_ref += int(o)
    assert ov == ov_ref == jov_sum == 2
    assert float(ts.byte_count[3]) == lim
    assert_bit_equal(s_ref.regs, ts.regs)
    assert_bit_equal(port_flow_table(js).regs, ts.regs)


# -- chunk dispatch and back-patch ------------------------------------------------

@pytest.mark.parametrize("k,w,cap", [(1, 16, 4), (3, 16, 16), (8, 32, 5)])
def test_chunk_dispatch_and_backpatch_match_reference(k, w, cap):
    rng = np.random.default_rng(k * w + cap)
    xs = rng.normal(size=(k, w, 8)).astype(np.float32)
    fwd = rng.random((k, w)) < 0.4
    fwd[0] = True                   # a window past capacity
    if k > 1:
        fwd[1] = False              # a window that forwards nothing
    jdd = jhybrid.chunk_dispatch(jnp.asarray(xs), jnp.asarray(fwd), cap)
    tdd = thybrid.chunk_dispatch(torch.from_numpy(xs), torch.from_numpy(fwd),
                                 cap)
    for f in ("buf", "lane", "window", "valid"):
        assert_bit_equal(getattr(jdd, f), getattr(tdd, f))
    assert tdd.lane.dtype == tdd.window.dtype == torch.int32
    assert tdd.slots == k * cap
    pending = rng.integers(0, 3, (k, w)).astype(np.int32)
    pending[:, -2:] = -1
    be = rng.integers(5, 9, k * cap).astype(np.int32)
    assert_bit_equal(
        jhybrid.backpatch_pending(jnp.asarray(pending), jnp.asarray(be), jdd),
        thybrid.backpatch_pending(torch.from_numpy(pending),
                                  torch.from_numpy(be), tdd))


def test_backpatch_drops_dead_slots_like_reference():
    """A partly filled buffer (``init_deferred``'s dead slots all address
    window 0, lane 0) patches exactly its live rows."""
    jdd = jhybrid.init_deferred(3, 4, 8)
    tdd = thybrid.init_deferred(3, 4, 8, device="cpu")
    for f in ("buf", "lane", "window", "valid"):
        assert_bit_equal(getattr(jdd, f), getattr(tdd, f))
    lane = np.array([2, 0, 5, 1] + [0] * 8, np.int32)
    window = np.array([1, 1, 2, 0] + [0] * 8, np.int32)
    valid = np.array([1, 1, 1, 0] + [0] * 8, bool)
    jdd = dataclasses.replace(jdd, lane=jnp.asarray(lane),
                              window=jnp.asarray(window),
                              valid=jnp.asarray(valid))
    tdd = dataclasses.replace(tdd, lane=torch.from_numpy(lane),
                              window=torch.from_numpy(window),
                              valid=torch.from_numpy(valid))
    pending = np.full((3, 6), -1, np.int32)
    be = np.arange(12, dtype=np.int32) + 10
    got = thybrid.backpatch_pending(torch.from_numpy(pending),
                                    torch.from_numpy(be), tdd)
    assert_bit_equal(jhybrid.backpatch_pending(jnp.asarray(pending),
                                               jnp.asarray(be), jdd), got)
    assert int((got != -1).sum()) == 3 and int(got[0, 0]) == -1


# -- chunked serving -------------------------------------------------------------

def _servers(setup, **kw):
    trace, art, jbackend, tart, tbackend = setup
    base = dict(n_buckets=N_BUCKETS, window=256, threshold=0.9, capacity=32)
    base.update(kw)
    return trace, art, jbackend, tart, tbackend, base


@pytest.mark.parametrize("evict", [{}, {"evict_age": 1.0}])
@pytest.mark.parametrize("k", (1, 2, 8))
def test_chunked_serving_bit_matches_per_window(chunk_setup, k, evict):
    """serve_trace through step_chunk equals the reference's chunked
    serve_trace and the port's per-window server: predictions, flow table
    and accounting, with ceil(windows / K) backend calls."""
    trace, art, jbackend, tart, tbackend, kw = _servers(chunk_setup,
                                                        **evict)
    jsrv = jserving.StreamingHybridServer(art, jbackend, chunk_windows=k,
                                          **kw)
    jp, js = jsrv.serve_trace(trace)
    per_window = StreamingHybridServer(tart, tbackend, device="cpu", **kw)
    p_ref, s_ref = per_window.serve_trace(trace)
    for use_kernel in (None, False):
        srv = StreamingHybridServer(tart, tbackend, chunk_windows=k,
                                    use_kernel=use_kernel, device="cpu", **kw)
        p, s = srv.serve_trace(trace)
        assert p.shape == (trace.n_packets,) and p.dtype == p_ref.dtype
        assert_bit_equal(jp, p)
        assert_bit_equal(p_ref, p)
        assert_bit_equal(jsrv.flow_table(), srv.flow_table())
        assert_bit_equal(per_window.flow_table(), srv.flow_table())
        _stats_equal(js, s)
        _stats_equal(s_ref, s, flushes=False)
        assert s.n_flushes == -(-s.n_windows // k)
        assert s.n_windows == -(-trace.n_packets // 256)
        if evict:
            assert s.n_evicted > 0


def test_chunked_serving_evict_readmit_and_approx_lru(chunk_setup):
    """Aggressive eviction (re-admissions inside most chunks) and the
    approx-LRU sweep under pressure: the chunked server equals the
    per-window server end to end."""
    for extra in ({"evict_age": 0.25, "window": 128},
                  {"evict_age": 2.0, "evict_policy": "approx_lru",
                   "n_buckets": 128}):
        trace, _, _, tart, tbackend, kw = _servers(chunk_setup, **extra)
        ref = StreamingHybridServer(tart, tbackend, device="cpu", **kw)
        p_ref, s_ref = ref.serve_trace(trace)
        assert s_ref.n_evicted > 0
        srv = StreamingHybridServer(tart, tbackend, chunk_windows=4,
                                    device="cpu", **kw)
        p, s = srv.serve_trace(trace)
        assert_bit_equal(p_ref, p)
        assert_bit_equal(ref.flow_table(), srv.flow_table())
        _stats_equal(s_ref, s, flushes=False)


def test_step_and_step_chunk_mix_on_one_server(chunk_setup):
    """Windows served one at a time and chunks served on the same carries
    give the per-window server's predictions, flow table and counters;
    ``reset`` refills the carries in place."""
    trace, _, _, tart, tbackend, kw = _servers(chunk_setup)
    ref = StreamingHybridServer(tart, tbackend, device="cpu", **kw)
    p_ref, s_ref = ref.serve_trace(trace)
    srv = StreamingHybridServer(tart, tbackend, chunk_windows=2,
                                device="cpu", **kw)
    ptr = (srv.state.regs.data_ptr(), srv._stats.windows.data_ptr())
    ws = list(tstream.iter_windows(trace, 256, N_BUCKETS, device="cpu"))
    preds = [srv.step(ws[0])[0], srv.step(ws[1])[0]]
    rest = tstream.iter_chunks(trace, 256, 2, N_BUCKETS, device="cpu")
    for i, c in enumerate(rest):
        if i == 0:
            continue                   # windows 0 and 1 went through step
        if i % 2:
            preds.append(srv.step_chunk(c)[0].reshape(-1))
        else:
            preds += [srv.step(c.window_at(j))[0] for j in range(2)
                      if bool(c.valid[j].any())]
    assert_bit_equal(p_ref, torch.cat(preds)[:trace.n_packets])
    assert_bit_equal(ref.flow_table(), srv.flow_table())
    _stats_equal(s_ref, srv.stats.check(), flushes=False)
    srv.reset()
    assert (srv.state.regs.data_ptr(), srv._stats.windows.data_ptr()) == ptr
    assert srv.stats.n_windows == 0
    assert_bit_equal(tstream.init_flow_table(N_BUCKETS, device="cpu").regs,
                     srv.state.regs)
    p2, _ = srv.serve_trace(trace)
    assert_bit_equal(p_ref, p2)


def test_chunk_stats_dead_windows_and_snapshot(chunk_setup):
    """A chunk of one live window and three dead ones: the dead lanes read
    -1, only the live window counts, one flush; ``stats`` is a snapshot."""
    trace, _, _, tart, tbackend, kw = _servers(chunk_setup)
    srv = StreamingHybridServer(tart, tbackend, chunk_windows=4,
                                device="cpu", **kw)
    c = next(tstream.iter_chunks(trace, 256, 1, N_BUCKETS, device="cpu"))
    dead = lambda t: torch.cat([t, torch.zeros((3, 256), dtype=t.dtype)])
    chunk = tstream.PacketChunk(*(dead(getattr(c, f)) for f in W_FIELDS))
    before = srv.stats
    pred, hs = srv.step_chunk(chunk)
    assert pred.shape == (4, 256)
    assert bool((pred[1:] == -1).all()) and bool((pred[0] >= 0).all())
    st = srv.stats
    assert before.n_windows == 0                  # the snapshot kept its values
    assert (st.n_windows, st.n_flushes, st.n_packets) == (1, 1, 256)
    assert hs.backend_rows == st.total_backend_rows <= 32
    st.check()


def test_step_chunk_interface_validation(chunk_setup):
    trace, _, _, tart, tbackend, _ = _servers(chunk_setup)
    with pytest.raises(ValueError):
        StreamingHybridServer(tart, tbackend, chunk_windows=0, device="cpu")
    srv = StreamingHybridServer(tart, tbackend, n_buckets=N_BUCKETS,
                                window=256, chunk_windows=4, device="cpu")
    c = next(tstream.iter_chunks(trace, 256, 2, N_BUCKETS, device="cpu"))
    with pytest.raises(ValueError):           # built for K=4, got K=2
        srv.step_chunk(c)
    narrow = next(tstream.iter_chunks(trace, 128, 4, N_BUCKETS, device="cpu"))
    with pytest.raises(ValueError):           # built for W=256, got 128
        srv.step_chunk(narrow)
    plain = StreamingHybridServer(tart, tbackend, n_buckets=N_BUCKETS,
                                  window=256, device="cpu")
    with pytest.raises(ValueError):           # built without chunking
        plain.step_chunk(c)


# -- the chunk-size autotune -------------------------------------------------------

def test_probe_chunk_matches_reference():
    jc = jserving.probe_chunk(64, 3, 500, seed=2)
    tc = tserving.probe_chunk(64, 3, 500, seed=2, device="cpu")
    for f in W_FIELDS:
        assert_bit_equal(getattr(jc, f), getattr(tc, f))
    jw = jserving.probe_window(64, 500, seed=2)
    tw = tserving.probe_window(64, 500, seed=2, device="cpu")
    for f in W_FIELDS:
        assert_bit_equal(getattr(jw, f), getattr(tw, f))


def test_chunk_autotune_deterministic():
    """With a deterministic ``time_fn`` the sweep picks the reference's
    winner: the per-packet argmin over a set that always holds the
    default (the first candidate on a tie); the cache returns the first
    winner."""
    tserving.clear_chunk_tune_cache()
    cases = [{4: 4.0, 8: 6.0, 16: 9.0, 32: 20.0},
             {4: 4.0, 8: 8.0, 16: 16.0, 32: 32.0},       # flat per packet
             {4: 10.0, 8: 10.0, 16: 10.0, 32: 40.0},
             {4: 4.0, 8: 8.5, 16: 12.0, 32: 30.0}]
    for table in cases:
        kw = dict(window=64, n_buckets=128, time_fn=table.__getitem__)
        want = jserving.autotune_chunk_windows(None, **kw)
        assert tserving.autotune_chunk_windows(None, **kw) == want
    assert tserving.autotune_chunk_windows(
        None, window=64, n_buckets=128, candidates=(4, 8),
        time_fn={4: 9.0, 8: 30.0, 16: 10.0}.__getitem__) == 16
    first = tserving.autotune_chunk_windows(
        None, window=64, n_buckets=128, cache_key=("t",),
        time_fn={4: 1.0, 8: 9.0, 16: 99.0, 32: 999.0}.__getitem__)
    again = tserving.autotune_chunk_windows(
        None, window=64, n_buckets=128, cache_key=("t",),
        time_fn={4: 999.0, 8: 9.0, 16: 1.0, 32: 1.0}.__getitem__)
    assert first == again == 4
    assert tserving.chunk_sweep_timings(("t",)) == {
        4: 1.0 / 256, 8: 9.0 / 512, 16: 99.0 / 1024, 32: 999.0 / 2048}
    assert tserving.chunk_sweep_timings(("never",)) is None
    tserving.clear_chunk_tune_cache()


def test_chunk_autotune_verbose_prints_the_sweep(capsys):
    """``verbose=True`` prints each candidate's per-packet time as the
    reference's sweep prints it, and picks the same K as ``verbose=False``
    and as the reference."""
    table = {4: 4.0, 8: 6.0, 16: 9.0, 32: 20.0}
    kw = dict(window=64, n_buckets=128, time_fn=table.__getitem__)
    quiet = tserving.autotune_chunk_windows(None, **kw)
    assert capsys.readouterr().out == ""
    loud = tserving.autotune_chunk_windows(None, verbose=True, **kw)
    out = capsys.readouterr().out
    ref = jserving.autotune_chunk_windows(None, verbose=True, **kw)
    assert capsys.readouterr().out == out
    assert loud == quiet == ref
    lines = out.splitlines()
    assert len(lines) == len(table)
    for line, (k, dt) in zip(lines, table.items()):
        assert line == f"chunk-autotune {k} -> {dt / (k * 64) * 1e3:.3f} ms"


def test_chunk_windows_auto_serves_like_per_window(chunk_setup):
    """``chunk_windows="auto"`` times every candidate on throwaway servers
    and serves with the winner, equal to the per-window server."""
    tserving.clear_chunk_tune_cache()
    trace, _, _, tart, tbackend, kw = _servers(chunk_setup, window=64)
    srv = StreamingHybridServer(tart, tbackend, chunk_windows="auto",
                                device="cpu", **kw)
    assert srv.chunk_windows in tserving.CHUNK_WINDOW_CANDIDATES
    assert set(srv.chunk_sweep) == set(tserving.CHUNK_WINDOW_CANDIDATES)
    assert srv.chunk_windows == min(srv.chunk_sweep, key=srv.chunk_sweep.get)
    again = StreamingHybridServer(tart, tbackend, chunk_windows="auto",
                                  device="cpu", **kw)
    assert again.chunk_windows == srv.chunk_windows          # cached
    ref = StreamingHybridServer(tart, tbackend, device="cpu", **kw)
    p_ref, s_ref = ref.serve_trace(trace)
    p, s = srv.serve_trace(trace)
    assert_bit_equal(p_ref, p)
    _stats_equal(s_ref, s, flushes=False)
    tserving.clear_chunk_tune_cache()


def _guard_chunk(lanes, k, w=8):
    """(k, w) chunk from {window: [(bucket, valid), ...]}: every packet one
    byte, forward, at ts = window / 10; the other lanes pad lanes (bucket 0,
    invalid), a window with no entry dead."""
    arrays = dict(bucket=np.zeros((k, w), np.int32),
                  ts=np.zeros((k, w), np.float32),
                  length=np.zeros((k, w), np.float32),
                  is_fwd=np.zeros((k, w), np.float32),
                  valid=np.zeros((k, w), bool))
    for i, entries in lanes.items():
        for j, (b, ok) in enumerate(entries):
            arrays["bucket"][i, j], arrays["valid"][i, j] = b, ok
            arrays["ts"][i, j] = np.float32(i / 10)
            arrays["length"][i, j] = arrays["is_fwd"][i, j] = 1.0
    return tstream.packet_chunk_from_arrays(**arrays, device="cpu")


GUARD_CASES = {
    # column 5 crosses 2^24 by three valid lanes of window 1
    "valid_crossing": ({5: -2.0}, [{1: [(5, True)] * 3}]),
    # column 7 sits at the limit, named only by invalid lanes; 5 crosses
    "invalid_lanes_at_limit": ({5: -1.0, 7: 0.0},
                               [{0: [(7, False)] * 4 + [(5, True)] * 2}]),
    # column 9 sits above the limit and no lane names it; 5 crosses
    "unnamed_above_limit": ({5: -1.0, 9: 2.0}, [{2: [(5, True)] * 2}]),
    # column 5 nears the limit in a chunk's last window, crosses in the
    # next chunk's first
    "chunk_boundary": ({5: -3.0}, [{2: [(5, True)]}, {0: [(5, True)] * 2}]),
    # window 1 is dead (its lanes name column 0, one below the limit);
    # column 5 crosses in window 2
    "dead_window": ({0: -1.0, 5: -1.0}, [{0: [(3, True)],
                                          2: [(5, True)] * 2}]),
}


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_plain_route_overflow_count_equals_saturate_counts(case):
    """The chunk register half's plain route (a CPU tensor, B5's plain
    version and the count's plain form) counts the newly saturated slots
    that ``saturate_counts(prev=)`` counts over the whole file, window by
    window, and leaves the same registers and readout as the stepwise
    plain composition."""
    lim = tstream.OVERFLOW_LIMIT
    columns, chunk_lanes = GUARD_CASES[case]
    k, n = 3, 64
    regs = tstream.init_flow_table(n, device="cpu").regs
    for col, offset in columns.items():
        regs[[0, 1, 4, 5, 6, 7], col] = lim + offset
        regs[2, col], regs[3, col] = -1.0, -0.5
    state = tstream.FlowTableState(regs)
    s_ref = state.clone()
    total = 0
    for lanes in chunk_lanes:
        chunk = _guard_chunk(lanes, k)
        state, xs, n_ev, n_ov = tstream.chunk_update_readout(
            state, chunk, saturate=True)
        want = 0
        for i in range(k):
            w = chunk.window_at(i)
            after = tstream.update_flow_table(s_ref, w)
            s_ref, n_new = tstream.saturate_counts(after, prev=s_ref)
            want += int(n_new)
            assert_bit_equal(tstream.flow_table_readout(s_ref, w.bucket),
                             xs[i])
        assert int(n_ov) == want
        assert int(n_ev) == 0
        assert_bit_equal(s_ref.regs, state.regs)
        total += want
    assert total > 0
    assert float(state.pkt_count[5]) == lim
    for col, offset in columns.items():
        if offset >= 0:                  # at or above the limit: clamped
            assert (state.regs[[0, 1, 4, 5, 6, 7], col] == lim).all()


@pytest.mark.parametrize("route", ["window", "chunk"])
@pytest.mark.parametrize("use_kernel", [None, False])
def test_register_half_rejects_an_unknown_evict_policy(route, use_kernel):
    """The register half names a mistyped eviction policy whether or not
    an aging sweep runs (``evict_age`` None here)."""
    chunk = _guard_chunk({0: [(5, True)]}, 2)
    state = tstream.init_flow_table(64, device="cpu")
    with pytest.raises(ValueError, match="evict_policy"):
        if route == "window":
            tstream.window_update_readout(state, chunk.window_at(0),
                                          evict_policy="lru",
                                          use_kernel=use_kernel)
        else:
            tstream.chunk_update_readout(state, chunk, evict_policy="lru",
                                         use_kernel=use_kernel)
