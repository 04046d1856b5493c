"""Port parity for cross-window deferral (``flush_every > 1``): ``defer_window``,
the deferred stats folds, ``StreamingHybridServer.step`` / ``flush`` /
``consume_flush`` / ``serve_trace`` with ``flush_every=k``, and the
occupancy- and deadline-triggered flushes, against the reference's deferred
path (the deferred cases of ``tests/test_stream.py`` and the occupancy cases
of ``tests/test_chunked_stream.py``) and against the port's own
``flush_every=1`` path. Everything runs on the CPU; the deferred step's and
the flush's CUDA graphs are in ``tests/test_torch_cuda.py``.

Tolerances: predictions, the deferral buffer, the flow table and every
integer counter compare bit for bit; ``conf_sum`` is an f32 sum that the
packages associate differently and compares at rtol=1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hybrid as jhybrid  # noqa: E402
from repro.netsim import stream as jstream  # noqa: E402
from repro.serving import stream_serving as jserving  # noqa: E402
from repro_torch.core import hybrid as thybrid  # noqa: E402
from repro_torch.netsim import stream as tstream  # noqa: E402
from repro_torch.serving import stream_serving as tserving  # noqa: E402
from repro_torch.serving.stream_serving import \
    StreamingHybridServer  # noqa: E402
from test_torch_parity import (assert_bit_equal, port_artifact,  # noqa: E402
                               port_ensemble, port_window)

N_BUCKETS = 1 << 12
DD_FIELDS = ("buf", "lane", "window", "valid")


@pytest.fixture(scope="module")
def stream_setup():
    """The reference's streaming fixture (400 flows, 4096 buckets): a 4x3
    RF switch and a 12x5 RF backend on the batch flow features, carried
    across to the port."""
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_random_forest, predict_tree_ensemble
    from repro.netsim.features import flow_features
    from repro.netsim.packets import synth_trace
    from repro_torch.ml.trees import predict_tree_ensemble as t_predict
    trace = synth_trace(n_flows=400, seed=3)
    b, table = flow_features(trace, n_buckets=N_BUCKETS)
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


KW = dict(n_buckets=N_BUCKETS, window=256, threshold=0.9, capacity=32)


def _stats_equal(ref, got, *, flushes=True):
    rd, gd = ref.as_dict(), got.as_dict()
    keys = ["windows", "packets", "handled", "backend_rows", "deferred",
            "degraded", "evicted", "overflow", "fraction_handled"]
    for k in keys + (["flushes"] if flushes else []):
        assert rd[k] == gd[k], k
    np.testing.assert_allclose(gd["conf_sum"], rd["conf_sum"], rtol=1e-5)


def _windows(trace, n=None, **kw):
    ws = list(jstream.iter_windows(trace, 256, N_BUCKETS, **kw))[:n]
    return ws, [port_window(w) for w in ws]


# -- defer_window and the back-patch ----------------------------------------------

@pytest.mark.parametrize("pos_kind", ["int", "tensor"])
def test_defer_window_and_backpatch_roundtrip(pos_kind):
    """Rows deferred over two cycle slots land where the reference's
    ``defer_window`` puts them, bit for bit, and come back to their
    (window, lane) return addresses; dead slots never touch the pending set.
    The port writes ``dd`` in place and returns it; ``pos`` may be a Python
    int or a 0-dim tensor."""
    k, cap, w_lanes = 3, 4, 8
    jdd = jhybrid.init_deferred(k, cap, 2)
    tdd = thybrid.init_deferred(k, cap, 2, device="cpu")
    x0 = np.arange(16, dtype=np.float32).reshape(8, 2)
    for pos, lanes in ((0, [1, 5]), (1, [0, 2, 7])):
        m = np.zeros(8, bool)
        m[lanes] = True
        jb = jhybrid.dispatch(jnp.asarray(x0), jnp.asarray(m), cap)
        tb = thybrid.dispatch(torch.from_numpy(x0), torch.from_numpy(m), cap)
        jdd = jhybrid.defer_window(jdd, *jb, jnp.int32(pos))
        tpos = pos if pos_kind == "int" else torch.tensor(pos,
                                                          dtype=torch.int32)
        ptrs = [getattr(tdd, f).data_ptr() for f in DD_FIELDS]
        assert thybrid.defer_window(tdd, *tb, tpos) is tdd
        assert [getattr(tdd, f).data_ptr() for f in DD_FIELDS] == ptrs
        for f in DD_FIELDS:
            assert_bit_equal(getattr(jdd, f), getattr(tdd, f))
    assert int(tdd.valid.sum()) == 5
    pending = np.zeros((k, w_lanes), np.int32)
    be = np.arange(k * cap, dtype=np.int32) + 100
    out = thybrid.backpatch_pending(torch.from_numpy(pending),
                                    torch.from_numpy(be), tdd)
    assert_bit_equal(jhybrid.backpatch_pending(jnp.asarray(pending),
                                               jnp.asarray(be), jdd), out)
    got = {(w, ln) for w, ln in zip(*np.nonzero(out.numpy() >= 100))}
    assert got == {(0, 1), (0, 5), (1, 0), (1, 2), (1, 7)}
    assert (out.numpy()[2] == 0).all()           # untouched cycle slot
    thybrid.zero_deferred_(tdd)
    for f in DD_FIELDS:
        assert_bit_equal(getattr(jhybrid.init_deferred(k, cap, 2), f),
                         getattr(tdd, f))


def test_defer_window_short_dispatch_and_empty():
    """A window narrower than the capacity dispatches fewer rows, and the
    slot is then ``pos * rows`` as in the reference; capacity 0 writes
    nothing."""
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    m = np.array([0, 1, 1, 0, 1, 0], bool)
    for cap in (0, 10):
        jdd = jhybrid.init_deferred(3, 10, 2)
        tdd = thybrid.init_deferred(3, 10, 2, device="cpu")
        jb = jhybrid.dispatch(jnp.asarray(x), jnp.asarray(m), cap)
        tb = thybrid.dispatch(torch.from_numpy(x), torch.from_numpy(m), cap)
        jdd = jhybrid.defer_window(jdd, *jb, jnp.int32(2))
        thybrid.defer_window(tdd, *tb, 2)
        for f in DD_FIELDS:
            assert_bit_equal(getattr(jdd, f), getattr(tdd, f))


# -- the stats folds ------------------------------------------------------------

def _random_window(rng, w=64):
    valid = rng.random(w) < 0.8
    return (jstream.PacketWindow(
        bucket=jnp.zeros(w, jnp.int32), ts=jnp.zeros(w, jnp.float32),
        length=jnp.zeros(w, jnp.float32), is_fwd=jnp.zeros(w, jnp.float32),
        valid=jnp.asarray(valid)),
        tstream.packet_window_from_arrays(
            np.zeros(w, np.int32), np.zeros(w, np.float32),
            np.zeros(w, np.float32), np.zeros(w, np.float32), valid,
            device="cpu"))


def _start_stats(rng):
    vals = {k: int(rng.integers(0, 500)) for k in tserving._COUNTERS}
    conf = np.float32(rng.random() * 100)
    j = jserving.StreamStats(**{k: jnp.int32(v) for k, v in vals.items()},
                             conf_sum=jnp.float32(conf))
    t = tserving.StreamStats(**{k: torch.tensor(v, dtype=torch.int32)
                                for k, v in vals.items()},
                             conf_sum=torch.tensor(conf))
    return j, t


def _stats_bits(ref, got):
    """Every counter bit for bit, conf_sum (summed in another order) at
    rtol=1e-5."""
    for f in dataclasses.fields(got):
        if f.name == "conf_sum":
            np.testing.assert_allclose(float(got.conf_sum),
                                       float(ref.conf_sum), rtol=1e-5)
        else:
            assert_bit_equal(getattr(ref, f.name), getattr(got, f.name))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stats_folds_match_reference(seed):
    """accumulate_deferred_stats, degrade_window_stats, fold_flush_stats,
    fold_degraded_flush, degrade_chunk_stats and defer_tail against the
    reference on the same inputs, from a non-zero running state."""
    rng = np.random.default_rng(seed)
    jw, tw = _random_window(rng)
    w, cap = 64, 16
    fwd = (rng.random(w) < 0.5) & np.asarray(jw.valid)
    conf = rng.random(w).astype(np.float32)
    sw = rng.integers(0, 2, w).astype(np.int32)
    x = rng.normal(size=(w, 8)).astype(np.float32)
    jb = jhybrid.dispatch(jnp.asarray(x), jnp.asarray(fwd), cap)
    tb = thybrid.dispatch(torch.from_numpy(x), torch.from_numpy(fwd), cap)
    counts = (3, 1)
    js, ts = _start_stats(rng)
    jargs = (jnp.asarray(fwd), jb[2], jnp.asarray(conf))
    targs = (torch.from_numpy(fwd), tb[2], torch.from_numpy(conf))
    jr = jserving.accumulate_deferred_stats(js, jw, *jargs, *counts)
    tr = tserving.accumulate_deferred_stats(ts, tw, *targs, *counts)
    _stats_bits(jr[0], tr[0])
    assert_bit_equal(jr[1], tr[1]) and assert_bit_equal(jr[2], tr[2])
    jr = jserving.degrade_window_stats(js, jw, jnp.asarray(sw), *jargs,
                                       *counts)
    tr = tserving.degrade_window_stats(ts, tw, torch.from_numpy(sw), *targs,
                                       *counts)
    _stats_bits(jr[0], tr[0])
    for a, b in zip(jr[1:], tr[1:]):
        assert_bit_equal(a, b)
    jdd = jhybrid.init_deferred(3, cap, 8)
    tdd = thybrid.init_deferred(3, cap, 8, device="cpu")
    jpend = jnp.full((3, w), -1, jnp.int32)
    tpend = torch.full((3, w), -1, dtype=torch.int32)
    for pos in (0, 2):
        jr = jserving.defer_tail(js, jdd, jpend, jw, jnp.asarray(sw),
                                 jnp.asarray(fwd), *jb, jnp.asarray(conf),
                                 counts, jnp.int32(pos))
        tr = tserving.defer_tail(ts, tdd, tpend, tw, torch.from_numpy(sw),
                                 torch.from_numpy(fwd), *tb,
                                 torch.from_numpy(conf), counts,
                                 torch.tensor(pos))
        js, jdd, jpend = jr[:3]
        ts = tr[0]
        assert tr[1] is tdd and tr[2] is tpend
        _stats_bits(js, ts)
        assert_bit_equal(jpend, tpend)
        for f in DD_FIELDS:
            assert_bit_equal(getattr(jdd, f), getattr(tdd, f))
        for a, b in zip(jr[3:], tr[3:]):
            assert_bit_equal(a, b)
    for name in ("fold_flush_stats", "fold_degraded_flush",
                 "degrade_chunk_stats"):
        _stats_bits(getattr(jserving, name)(js, jdd),
                    getattr(tserving, name)(ts, tdd))


# -- deferred serving ------------------------------------------------------------

@pytest.mark.parametrize("evict", [{}, {"evict_age": 1.0}])
@pytest.mark.parametrize("k", (2, 4, 8))
def test_deferred_serving_bit_matches_flush_every_1(stream_setup, k, evict):
    """The equivalence oracle: flush_every=k returns the reference's final
    predictions, flow table and counters, and the port's flush_every=1
    predictions and counters, with ceil(windows / k) backend calls; the
    guaranteed partial flush at the end leaves nothing pending."""
    trace, art, jbackend, tart, tbackend = stream_setup
    kw = dict(KW, **evict)
    ref = StreamingHybridServer(tart, tbackend, device="cpu", **kw)
    p_ref, s_ref = ref.serve_trace(trace)
    assert s_ref.n_flushes == s_ref.n_windows
    jsrv = jserving.StreamingHybridServer(art, jbackend, flush_every=k, **kw)
    jp, js = jsrv.serve_trace(trace)
    for use_kernel in (None, False):
        srv = StreamingHybridServer(tart, tbackend, flush_every=k,
                                    use_kernel=use_kernel, device="cpu", **kw)
        p, s = srv.serve_trace(trace)
        assert p.dtype == p_ref.dtype == torch.int64
        assert_bit_equal(jp, p)
        assert_bit_equal(p_ref, p)
        assert_bit_equal(jsrv.flow_table(), srv.flow_table())
        assert_bit_equal(ref.flow_table(), srv.flow_table())
        _stats_equal(js, s)
        _stats_equal(s_ref, s, flushes=False)
        assert s.n_flushes == -(-s.n_windows // k)
        assert srv.pending_windows == 0
        if evict:
            assert s.n_evicted > 0


def test_deferred_numpy_backend_matches_tensor_backend(stream_setup):
    """A backend that answers in numpy (the reference's two-phase case)
    serves the deferred flush as one that answers in tensors, and as the
    reference's two-phase flush."""
    trace, art, jbackend, tart, tbackend = stream_setup
    kw = dict(KW, flush_every=4)
    p_t, s_t = StreamingHybridServer(tart, tbackend, device="cpu",
                                     **kw).serve_trace(trace)
    p_n, s_n = StreamingHybridServer(
        tart, lambda r: tbackend(r).numpy(), device="cpu",
        **kw).serve_trace(trace)
    jsrv = jserving.StreamingHybridServer(
        art, lambda r: np.asarray(jbackend(np.asarray(r))), **kw)
    jp, js = jsrv.serve_trace(trace)
    assert jsrv._fused_ok is False
    assert_bit_equal(p_t, p_n)
    assert_bit_equal(jp, p_n)
    _stats_equal(s_t, s_n)
    _stats_equal(js, s_n)


def test_deferred_step_returns_provisional_then_flush_patches(stream_setup):
    """Manual stepping: step() returns the reference's provisional
    (switch-tier) predictions; flush() back-patches the backend's answers
    and equals flush_every=1's and the reference's patch."""
    trace, art, jbackend, tart, tbackend = stream_setup
    ref = StreamingHybridServer(tart, tbackend, device="cpu", **KW)
    srv = StreamingHybridServer(tart, tbackend, flush_every=8, device="cpu",
                                **KW)
    jsrv = jserving.StreamingHybridServer(art, jbackend, flush_every=8, **KW)
    jws, tws = _windows(trace, 3)                        # a partial cycle
    ref_preds = [ref.step(w)[0] for w in tws]
    for jw, tw in zip(jws, tws):
        jprov, jhs = jsrv.step(jw)
        prov, hs = srv.step(tw)
        assert_bit_equal(jprov, prov)
        assert hs.backend_rows == jhs.backend_rows
        assert hs.fraction_handled == jhs.fraction_handled
    assert srv.pending_windows == 3
    assert srv.consume_flush() is None            # cycle not full: no auto
    n, patched = srv.flush()
    jn, jpatched = jsrv.flush()
    assert n == jn == 3 and srv.pending_windows == 0
    assert patched.shape == (8, 256)
    assert_bit_equal(jpatched, patched)
    for i in range(n):
        assert_bit_equal(ref_preds[i], patched[i])
    assert bool((patched[n:] == -1).all())
    assert srv.flush() is None                    # nothing pending now
    assert srv.stats.n_flushes == 1
    _stats_equal(jsrv.stats, srv.stats)


def test_flush_queue_keeps_every_unconsumed_cycle(stream_setup):
    """Auto-flush results queue FIFO: stepping through three cycles without
    consuming loses none, each equal to the reference's."""
    trace, art, jbackend, tart, tbackend = stream_setup
    ref = StreamingHybridServer(tart, tbackend, device="cpu", **KW)
    srv = StreamingHybridServer(tart, tbackend, flush_every=2, device="cpu",
                                **KW)
    jsrv = jserving.StreamingHybridServer(art, jbackend, flush_every=2, **KW)
    jws, tws = _windows(trace, 6)                        # 3 full cycles
    ref_preds = [ref.step(w)[0] for w in tws]
    for jw, tw in zip(jws, tws):
        jsrv.step(jw)
        srv.step(tw)
    for c in range(3):                                   # oldest first
        n, patched = srv.consume_flush()
        jn, jpatched = jsrv.consume_flush()
        assert n == jn == 2
        assert_bit_equal(jpatched, patched)
        for i in range(n):
            assert_bit_equal(ref_preds[2 * c + i], patched[i])
    assert srv.consume_flush() is None
    assert srv.pending_windows == 0


def test_serve_trace_flushes_stale_pending_on_entry(stream_setup):
    """Windows pending from manual step() calls are flushed on entry and
    their patches dropped: the rest of the stream gets exactly a full
    serve's predictions, the stale windows count in the stats."""
    trace, art, jbackend, tart, tbackend = stream_setup
    t0 = float(np.asarray(trace.ts, np.float64).min())
    kw = dict(KW, flush_every=4)
    ref = StreamingHybridServer(tart, tbackend, device="cpu", **kw)
    p_ref, s_ref = ref.serve_trace(trace, t0=t0)
    srv = StreamingHybridServer(tart, tbackend, device="cpu", **kw)
    jsrv = jserving.StreamingHybridServer(art, jbackend, **kw)
    jws, tws = _windows(trace, 2, t0=t0)
    for jw, tw in zip(jws, tws):
        jsrv.step(jw)
        srv.step(tw)
    assert srv.pending_windows == 2
    rest = dataclasses.replace(trace, **{
        f.name: getattr(trace, f.name)[2 * 256:]
        for f in dataclasses.fields(trace) if f.name != "flow_label"})
    p, s = srv.serve_trace(rest, t0=t0)
    jp, js = jsrv.serve_trace(rest, t0=t0)
    assert srv.pending_windows == 0
    assert_bit_equal(p_ref[2 * 256:], p)
    assert_bit_equal(jp, p)
    _stats_equal(js, s)
    assert s.n_windows == s_ref.n_windows
    assert s.total_backend_rows == s_ref.total_backend_rows


def test_reset_drops_pending_cycle_in_place(stream_setup):
    """reset() mid-cycle empties the buffer and the pending set in place
    (the graphs read them) and serves the trace again to the same
    answers."""
    trace, _, _, tart, tbackend = stream_setup
    srv = StreamingHybridServer(tart, tbackend, flush_every=4, device="cpu",
                                **KW)
    p1, s1 = srv.serve_trace(trace)
    _, tws = _windows(trace, 3)
    for w in tws:
        srv.step(w)
    ptrs = [getattr(srv._dd, f).data_ptr() for f in DD_FIELDS] + [
        srv._pending.data_ptr()]
    srv.reset()
    assert srv.pending_windows == 0 and srv.consume_flush() is None
    assert [getattr(srv._dd, f).data_ptr() for f in DD_FIELDS] + [
        srv._pending.data_ptr()] == ptrs
    assert not bool(srv._dd.valid.any()) and bool((srv._pending == -1).all())
    assert srv.flush() is None
    p2, s2 = srv.serve_trace(trace)
    assert_bit_equal(p1, p2)
    _stats_equal(s1, s2)


def test_pending_set_keeps_the_switch_dtype(stream_setup):
    """The pending set holds the switch's prediction dtype (int64 for
    votes, int32 for a sum ensemble), as ``fused_classify`` returns it."""
    from repro_torch.kernels.ops import fused_classify, pred_dtype
    from test_torch_parity import hand_built
    _, _, _, tart, tbackend = stream_setup
    srv = StreamingHybridServer(tart, tbackend, flush_every=2, device="cpu",
                                **KW)
    assert srv._pending.dtype == torch.int64
    x = torch.randn(5, 4)
    for vote in (True, False):
        art = port_artifact(hand_built(vote))
        assert fused_classify(art, x, device="cpu")[0].dtype \
            == pred_dtype(art)


# -- flush triggers ---------------------------------------------------------------

def test_flush_deadline_bit_identical_with_earlier_flushes(stream_setup):
    """A deadline splits cycles without changing a final prediction and
    flushes more often, as the reference's."""
    trace, art, jbackend, tart, tbackend = stream_setup
    kw = dict(KW, flush_every=6)
    p_ref, s_ref = StreamingHybridServer(tart, tbackend, device="cpu",
                                         **kw).serve_trace(trace)
    p, s = StreamingHybridServer(tart, tbackend, flush_deadline=0.05,
                                 device="cpu", **kw).serve_trace(trace)
    jp, js = jserving.StreamingHybridServer(
        art, jbackend, flush_deadline=0.05, **kw).serve_trace(trace)
    assert_bit_equal(p_ref, p)
    assert_bit_equal(jp, p)
    _stats_equal(js, s)
    assert s.n_flushes > s_ref.n_flushes
    assert s.total_backend_rows == s_ref.total_backend_rows


def test_flush_deadline_bounds_pending_staleness(stream_setup):
    """Once a window's newest timestamp ages past the deadline relative to
    the cycle's first window, the cycle flushes on its own."""
    trace, art, jbackend, tart, tbackend = stream_setup
    jws, tws = _windows(trace, 2)
    t0 = np.asarray(jws[0].ts)[np.asarray(jws[0].valid)]
    t1 = np.asarray(jws[1].ts)[np.asarray(jws[1].valid)]
    span0, span1 = t0.max() - t0.min(), t1.max() - t0.min()
    assert span0 < span1
    kw = dict(KW, flush_every=8, flush_deadline=float((span0 + span1) / 2))
    srv = StreamingHybridServer(tart, tbackend, device="cpu", **kw)
    jsrv = jserving.StreamingHybridServer(art, jbackend, **kw)
    srv.step(tws[0])
    assert srv.pending_windows == 1
    srv.step(tws[1])             # window 1 ages past the deadline vs birth
    assert srv.pending_windows == 0
    n, patched = srv.consume_flush()
    for jw in jws:
        jsrv.step(jw)
    jn, jpatched = jsrv.consume_flush()
    assert n == jn == 2
    assert_bit_equal(jpatched, patched)


def test_occupancy_flush_bit_identical_with_more_flushes(stream_setup):
    """A low occupancy threshold flushes early (more backend calls than the
    fixed cadence) without changing a final prediction, as the
    reference's."""
    trace, art, jbackend, tart, tbackend = stream_setup
    p_ref, _ = StreamingHybridServer(tart, tbackend, device="cpu",
                                     **KW).serve_trace(trace)
    _, s_fixed = StreamingHybridServer(tart, tbackend, flush_every=8,
                                       device="cpu", **KW).serve_trace(trace)
    kw = dict(KW, flush_every=8, flush_occupancy=0.25)
    p, s = StreamingHybridServer(tart, tbackend, device="cpu",
                                 **kw).serve_trace(trace)
    jp, js = jserving.StreamingHybridServer(art, jbackend,
                                            **kw).serve_trace(trace)
    assert_bit_equal(p_ref, p)
    assert_bit_equal(jp, p)
    _stats_equal(js, s)
    assert s.n_flushes > s_fixed.n_flushes
    assert s.total_backend_rows == s_fixed.total_backend_rows


@pytest.mark.parametrize("kw", [
    dict(flush_every=0),
    dict(flush_every=0, chunk_windows=0),
    dict(chunk_windows=0),
    dict(chunk_windows=2, flush_every=2),
    dict(flush_occupancy=0.5),
    dict(flush_every=4, flush_occupancy=1.5),
    dict(flush_every=4, flush_occupancy=0.0),
    dict(flush_deadline=0.5),
    dict(flush_every=4, flush_deadline=0.0),
    dict(flush_every=4, flush_deadline=-1.0, flush_occupancy=2.0),
    dict(flush_every=4, evict_policy="mru"),
    dict(flush_every=0, evict_policy="mru"),
    dict(evict_policy="approx_lru"),
    dict(fault_policy="policy", fuse=True),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_constructor_validation_matches_reference(stream_setup, kw):
    """Every invalid combination raises the reference's ValueError, with
    its message, checked in the reference's order."""
    from repro.serving.faults import FaultPolicy as JPolicy
    from repro_torch.serving.faults import FaultPolicy as TPolicy
    _, art, jbackend, tart, tbackend = stream_setup
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("fault_policy"):
        jkw["fault_policy"], tkw["fault_policy"] = JPolicy(), TPolicy()
    with pytest.raises(ValueError) as jerr:
        jserving.StreamingHybridServer(art, jbackend, **jkw)
    with pytest.raises(ValueError) as terr:
        StreamingHybridServer(tart, tbackend, device="cpu", **tkw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [dict(), dict(flush_every=4),
                                dict(flush_every=4, flush_occupancy=0.5),
                                dict(flush_every=3, flush_deadline=0.2,
                                     evict_age=1.0)],
                         ids=["per_window", "deferred", "occupancy",
                              "deadline_evict"])
def test_stream_stats_invariant_holds(stream_setup, kw):
    """check() (handled + backend_rows + deferred + degraded == packets)
    passes on each deferred path and is what serve_trace returns."""
    trace, _, _, tart, tbackend = stream_setup
    _, stats = StreamingHybridServer(tart, tbackend, device="cpu",
                                     **dict(KW, **kw)).serve_trace(trace)
    assert (stats.n_handled + stats.total_backend_rows + stats.n_deferred
            + stats.n_degraded == stats.n_packets)
