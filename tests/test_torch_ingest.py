"""Port parity for open-ended ingest (``repro_torch.netsim.ingest``) and
``StreamingHybridServer.serve_stream`` / ``serve_trace``: the cases of the
reference's ``tests/test_ingest.py`` (less its sharded ones and
``test_autotune_candidate_filter``, which are in ``tests/test_torch_shard.py``),
each held against the reference on the same inputs, and the
port's own prefetch staging and thread lifetime. Everything runs on the
CPU; the card's side-stream prefetch and the graph routes are in
``tests/test_torch_cuda.py``.

Tolerances: predictions, the flow table, every integer ``StreamStats``
counter, ring cuts (columns, valid lanes, admit times under an injected
clock), ``IngestStats`` and ``LatencyRecorder`` summaries from injected
spans compare bit for bit; ``conf_sum`` at rtol=1e-5 (summed in another
order).
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.netsim import ingest as jingest  # noqa: E402
from repro.netsim import stream as jstream  # noqa: E402
from repro.netsim.packets import synth_trace  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import stream_serving as jserving  # noqa: E402
from repro_torch.netsim import ingest as tingest  # noqa: E402
from repro_torch.netsim import stream as tstream  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import stream_serving as tserving  # noqa: E402
from repro_torch.serving.stream_serving import \
    StreamingHybridServer  # noqa: E402
from test_torch_parity import (assert_bit_equal, port_artifact,  # noqa: E402
                               port_ensemble, to_np)

N_BUCKETS = 1 << 11
WINDOW = 64
K = 4
COUNTERS = ("windows", "packets", "handled", "backend_rows", "deferred",
            "degraded", "evicted", "overflow")
FAST = dict(max_retries=1, backoff_base_s=0.0, breaker_threshold=3,
            breaker_cooldown=2)


@pytest.fixture(scope="module")
def setup():
    """The reference's ingest fixture (300 flows, 2048 buckets): a 4x3 RF
    switch and a 12x5 RF backend trained on the batch flow features, both
    carried across to the port."""
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_random_forest, predict_tree_ensemble
    from repro.netsim.features import flow_features
    from repro_torch.ml.trees import predict_tree_ensemble as t_predict
    trace = synth_trace(n_flows=300, seed=3)
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


def _fake_clock(step=0.0, start=100.0):
    """Deterministic wall clock advancing ``step`` seconds per call."""
    state = {"t": start}

    def clock():
        state["t"] += step
        return state["t"]
    return clock


def _served(srv, trace, ingest, **kw):
    """(preds, stats dict, flow table) as numpy — serve_trace, or
    serve_stream over ``ingest.replay_source`` when ``replay={...}`` is
    given."""
    if "replay" in kw:
        source = ingest.replay_source(trace, **kw.pop("replay"))
        pred, stats = srv.serve_stream(source, **kw)
    else:
        pred, stats = srv.serve_trace(trace, **kw)
    return to_np(pred), stats.as_dict(), to_np(srv.flow_table())


def _port(setup, trace=None, *, backend=None, **kw):
    """serve on a fresh CPU port server: kw splits into the server's and
    the serving call's (``replay``, ``prefetch``, ...)."""
    tr, _, _, tart, tbackend = setup
    call = {k: kw.pop(k) for k in list(kw) if k in _CALL_KW}
    srv = StreamingHybridServer(tart, backend or tbackend, device="cpu",
                                **kw)
    return srv, _served(srv, trace or tr, tingest, **call)


def _ref(setup, trace=None, *, backend=None, **kw):
    tr, art, jbackend, _, _ = setup
    call = {k: kw.pop(k) for k in list(kw) if k in _CALL_KW}
    srv = jserving.StreamingHybridServer(art, backend or jbackend, **kw)
    return srv, _served(srv, trace or tr, jingest, **call)


_CALL_KW = ("replay", "prefetch", "deadline", "clock", "record_latency",
            "latency_samples", "t0", "ring_capacity")


def _same(got, ref, *, flushes=True):
    (gp, gs, gt), (rp, rs, rt) = got, ref
    assert_bit_equal(rp, gp)
    assert_bit_equal(rt, gt)
    for k in COUNTERS + (("flushes",) if flushes else ()):
        assert gs[k] == rs[k], k
    np.testing.assert_allclose(gs["conf_sum"], rs["conf_sum"], rtol=1e-5)


def _same_cut(t, j):
    """A port HostCut equal to the reference's, columns, lanes and admit
    times included."""
    assert (t.n, t.window, t.rows, t.kind, t.n_windows) == \
        (j.n, j.window, j.rows, j.kind, j.n_windows)
    for k in ("bucket", "ts", "length", "is_fwd"):
        assert_bit_equal(j.cols[k], t.cols[k])
    assert_bit_equal(j.valid, t.valid)
    assert_bit_equal(j.admit_time, t.admit_time)


def _rings(*args, **kw):
    return (tingest.PacketRingBuffer(*args, **kw),
            jingest.PacketRingBuffer(*args, **kw))


# -- ring mechanics (host only) --------------------------------------------------

def test_ring_capacity_floor_validation():
    floor = (K + 1) * WINDOW - 1
    for mod in (tingest, jingest):
        with pytest.raises(ValueError):
            mod.PacketRingBuffer(WINDOW, K, N_BUCKETS, capacity=floor - 1)
        assert mod.PacketRingBuffer(WINDOW, K, N_BUCKETS,
                                    capacity=floor).free == floor
    with pytest.raises(ValueError):
        tingest.PacketRingBuffer(0, K, N_BUCKETS)
    with pytest.raises(ValueError):
        tingest.PacketRingBuffer(WINDOW, K, N_BUCKETS, deadline=0.0)


def test_full_ring_always_has_a_ready_chunk():
    tr = synth_trace(n_flows=120, seed=1)
    rings = _rings(WINDOW, K, N_BUCKETS, capacity=(K + 1) * WINDOW - 1,
                   clock=lambda: 100.0)
    cuts = []
    for ring in rings:
        n = ring.admit(tingest.slice_trace(tr, 0, ring.free))
        assert n == ring.buffered and ring.free == 0
        assert ring.ready()                  # the progress guarantee
        cut = ring.cut("count")
        assert cut.kind == "count" and cut.n == K * WINDOW
        assert cut.rows == K and cut.n_windows == K
        cuts.append(cut)
    _same_cut(*cuts)


def test_push_admit_tail_drop_and_overflow():
    tr = synth_trace(n_flows=120, seed=1)
    cap = (K + 1) * WINDOW - 1
    strict, _ = _rings(WINDOW, K, N_BUCKETS, capacity=cap)
    with pytest.raises(ValueError):
        strict.admit(tingest.slice_trace(tr, 0, cap + 1))
    for lossy in _rings(WINDOW, K, N_BUCKETS, capacity=cap, drop=True):
        n = lossy.admit(tingest.slice_trace(tr, 0, cap + 10))
        assert n == cap and lossy.buffered == cap
        assert lossy.stats.admitted == cap and lossy.stats.dropped == 10


def test_drain_pops_ragged_tail():
    tr = synth_trace(n_flows=120, seed=1)
    m = K * WINDOW + WINDOW + 7                    # K full + 1 + ragged
    got = []
    for ring in _rings(WINDOW, K, N_BUCKETS, clock=lambda: 5.0):
        ring.admit(tingest.slice_trace(tr, 0, m))
        full = ring.cut("count")
        assert full.n == K * WINDOW
        tail = ring.drain()
        assert tail.kind == "drain" and tail.n == WINDOW + 7
        assert tail.n_windows == 2 and ring.buffered == 0
        assert ring.drain() is None
        with pytest.raises(ValueError):
            ring.cut("count")                  # nothing left to cut
        s = ring.stats
        assert (s.count_cuts, s.drain_cuts, s.cuts) == (1, 1, 2)
        got.append((full, tail, s.as_dict()))
    (tf, tt, ts), (jf, jt, js) = got
    _same_cut(tf, jf)
    _same_cut(tt, jt)
    assert ts == js


def test_deadline_due_tracks_oldest_admit():
    tr = synth_trace(n_flows=120, seed=1)
    answers = []
    for ring in _rings(WINDOW, K, N_BUCKETS, deadline=5.0,
                       clock=lambda: 100.0):
        seen = [ring.deadline_due(now=200.0)]  # empty: nothing can be due
        ring.admit(tingest.slice_trace(tr, 0, WINDOW), now=100.0)
        seen += [ring.deadline_due(now=104.0), ring.deadline_due(now=105.0),
                 ring.deadline_due()]          # the ring's own clock
        assert ring.cut("deadline").kind == "deadline"
        ring.admit(tingest.slice_trace(tr, 0, WINDOW // 2), now=100.0)
        seen.append(ring.deadline_due(now=200.0))   # incomplete window
        answers.append(seen)
    assert answers[0] == answers[1] == [False, False, True, False, False]


def test_count_cut_wins_over_deadline():
    # the clock jumps far past the deadline on every call: both triggers
    # are due the moment a chunk completes, and the count cut must win
    tr = synth_trace(n_flows=200, seed=2)
    runs = []
    for mod in (tingest, jingest):
        ring = mod.PacketRingBuffer(WINDOW, K, N_BUCKETS, deadline=0.5,
                                    clock=_fake_clock(step=10.0))
        cuts = list(mod.cut_stream(ring, mod.replay_source(tr, batch=None)))
        assert cuts[0].kind == "count" and ring.stats.count_cuts >= 1
        runs.append((cuts, ring.stats.as_dict()))
    (tc, ts), (jc, js) = runs
    assert ts == js and len(tc) == len(jc)
    for t, j in zip(tc, jc):
        _same_cut(t, j)


@pytest.mark.parametrize("batch,deadline", [(53, None), (130, 0.5),
                                            (WINDOW * K, 0.5), (7, None)])
def test_ring_cuts_equal_reference_under_injected_clock(batch, deadline):
    """A dribbled replay through both rings under the same fake clock: the
    same cut sequence (kinds, columns, valid lanes, admit times) and the
    same IngestStats, with count, deadline and drain cuts firing."""
    tr = synth_trace(n_flows=150, seed=6)
    runs = []
    for mod in (tingest, jingest):
        ring = mod.PacketRingBuffer(WINDOW, K, N_BUCKETS, deadline=deadline,
                                    clock=_fake_clock(step=0.3))
        runs.append((list(mod.cut_stream(
            ring, mod.replay_source(tr, batch=batch))), ring.stats))
    (tc, ts), (jc, js) = runs
    assert ts.as_dict() == js.as_dict()
    assert ts.admitted == tr.n_packets and ts.dropped == 0
    if deadline is not None and batch < WINDOW * K:
        assert ts.deadline_cuts > 0
    assert len(tc) == len(jc)
    for t, j in zip(tc, jc):
        _same_cut(t, j)


@pytest.mark.parametrize("n_buckets", [1, 7, 4096, 1 << 20])
def test_host_hash_equals_reference(n_buckets):
    """The ring's hash (``fnv1a_hash_np``, numpy on the host) gives the
    reference's bucket ids and the torch hash's, on a trace and on columns
    at the uint32 extremes."""
    from repro.netsim.features import fnv1a_hash as j_hash
    from repro_torch.netsim.features import fnv1a_hash, fnv1a_hash_np
    tr = synth_trace(n_flows=200, seed=9)
    edge = np.array([0, 1, 255, 256, 2 ** 31, 2 ** 32 - 1], np.uint32)
    for cols in ((tr.src_ip, tr.dst_ip, tr.sport, tr.dport, tr.proto),
                 (edge, edge[::-1], edge.astype(np.uint16))):
        got = fnv1a_hash_np(*cols, n_buckets=n_buckets)
        assert got.dtype == np.int32
        assert_bit_equal(j_hash(*cols, n_buckets=n_buckets), got)
        assert_bit_equal(fnv1a_hash(*cols, n_buckets=n_buckets,
                                    device="cpu"), got)


def test_single_batch_replay_bit_identical_to_iter_chunks(setup):
    trace = setup[0]
    ring = tingest.PacketRingBuffer(WINDOW, K, N_BUCKETS)
    cuts = list(tingest.cut_stream(ring, tingest.replay_source(trace)))
    ref = list(tstream.iter_chunks(trace, WINDOW, K, N_BUCKETS,
                                   device="cpu"))
    jref = list(jstream.iter_chunks(trace, WINDOW, K, N_BUCKETS))
    assert len(cuts) == len(ref) == len(jref)
    for cut, rc, jc in zip(cuts, ref, jref):
        got = cut.to_chunk(device="cpu")
        for f in ("bucket", "ts", "length", "is_fwd", "valid"):
            assert_bit_equal(getattr(rc, f), getattr(got, f))
            assert_bit_equal(getattr(jc, f), getattr(got, f))
    assert sum(c.n for c in cuts) == trace.n_packets
    assert ring.stats.admitted == trace.n_packets


def test_to_windows_moves_live_rows_once(setup):
    """``HostCut.to_windows`` yields the live windows as row slices of one
    copy of the columns, equal to the reference's and to the windows of
    ``iter_windows``; dead padding windows are skipped."""
    trace = setup[0]
    sub = tingest.slice_trace(trace, 0, 3 * WINDOW + 11)
    ring = tingest.PacketRingBuffer(WINDOW, K, N_BUCKETS)
    jring = jingest.PacketRingBuffer(WINDOW, K, N_BUCKETS)
    ring.admit(sub)
    jring.admit(sub)
    cut, jcut = ring.drain(), jring.drain()
    wins = list(cut.to_windows(device="cpu"))
    jwins = list(jcut.to_windows())
    ref = list(tstream.iter_windows(sub, WINDOW, N_BUCKETS, device="cpu"))
    assert len(wins) == len(jwins) == len(ref) == cut.n_windows == 4
    base = wins[0].bucket.untyped_storage().data_ptr()
    for w, jw, rw in zip(wins, jwins, ref):
        assert w.bucket.untyped_storage().data_ptr() == base
        for f in ("bucket", "ts", "length", "is_fwd", "valid"):
            assert_bit_equal(getattr(jw, f), getattr(w, f))
            assert_bit_equal(getattr(rw, f), getattr(w, f))
    empty = tingest.HostCut(cols=cut.cols, valid=cut.valid,
                            admit_time=cut.admit_time[:0], n=0,
                            window=WINDOW, rows=K, kind="drain")
    assert list(empty.to_windows(device="cpu")) == []


def test_pack_chunk_columns_layout():
    cols, _ = tstream.trace_columns(synth_trace(n_flows=40, seed=5),
                                    N_BUCKETS)
    n = len(cols["bucket"])
    rows = -(-n // WINDOW) + 1                       # one dead pad window
    full, valid = tstream.pack_chunk_columns(cols, n, WINDOW, rows)
    jfull, jvalid = jstream.pack_chunk_columns(cols, n, WINDOW, rows)
    assert valid.shape == (rows * WINDOW,)
    assert valid[:n].all() and not valid[n:].any()   # live lanes lead
    assert_bit_equal(cols["bucket"], full["bucket"][:n])
    live_w = -(-n // WINDOW)
    if n % WINDOW:      # replicate-last pad inside the ragged window
        assert_bit_equal(np.repeat(cols["bucket"][-1], live_w * WINDOW - n),
                         full["bucket"][n:live_w * WINDOW])
    assert (full["bucket"][live_w * WINDOW:] == 0).all()
    assert_bit_equal(jvalid, valid)
    for k in full:
        assert_bit_equal(jfull[k], full[k])


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "ingest-prefetch"]


def test_prefetch_iter_preserves_order_and_propagates_errors():
    assert list(tingest.prefetch_iter(iter(range(100)), depth=2)) == \
        list(range(100))

    def boom():
        yield 1
        raise RuntimeError("source died")
    it = tingest.prefetch_iter(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="source died"):
        next(it)
    with pytest.raises(ValueError):
        next(tingest.prefetch_iter(iter(()), depth=0))
    assert not _prefetch_threads()


def test_prefetch_iter_close_stops_the_thread():
    """A consumer that abandons the iterator mid-stream (close) stops the
    producer, which was blocked on the full queue, and joins it."""
    pulled = []

    def source():
        for i in range(1000):
            pulled.append(i)
            yield i
    it = tingest.prefetch_iter(source(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert not _prefetch_threads()
    assert len(pulled) < 10                  # the bounded queue held it back


def test_latency_recorder_summary():
    recs = (tingest.LatencyRecorder(), jingest.LatencyRecorder())
    for rec in recs:
        assert rec.summary()["n"] == 0
        rec.record(np.array([0.0, 0.1, 0.2]), 1.0)
        rec.record(np.array([0.5]), 1.0)
        rec.record(np.array([]), 3.0)        # an empty cut records nothing
        s = rec.summary()
        assert s["n"] == rec.n == 4
        assert s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"] <= s["max_ms"]
        assert s["max_ms"] == pytest.approx(1000.0)
    assert recs[0].summary() == recs[1].summary()
    assert_bit_equal(recs[1].latencies(), recs[0].latencies())


# -- serve_stream against serve_trace and the reference ---------------------------

CHUNKED = dict(n_buckets=N_BUCKETS, window=WINDOW, chunk_windows=K,
               capacity=32)


@pytest.mark.parametrize("batch", [None, 97, WINDOW * K])
def test_serve_stream_dribbled_equals_serve_trace_chunked(setup, batch):
    """One-shot, ragged and chunk-sized batches: the same predictions, flow
    table and counters as serve_trace, and as the reference's serve_stream
    on the same batches."""
    trace = setup[0]
    _, ref = _port(setup, **CHUNKED)
    srv, got = _port(setup, replay={"batch": batch}, **CHUNKED)
    _same(got, ref)
    assert srv.ingest_stats.admitted == trace.n_packets
    assert srv.ingest_stats.dropped == 0
    jsrv, jgot = _ref(setup, replay={"batch": batch}, **CHUNKED)
    _same(got, jgot)
    assert srv.ingest_stats.as_dict() == jsrv.ingest_stats.as_dict()


def test_serve_trace_is_serve_stream_replay(setup):
    """serve_trace goes through the ring, equals serve_stream's one-batch
    replay, the manual iter_chunks + step_chunk loop it replaces and the
    reference's serve_trace."""
    trace, _, _, tart, tbackend = setup
    srv = StreamingHybridServer(tart, tbackend, device="cpu", **CHUNKED)
    pred, stats = srv.serve_trace(trace)
    assert srv.ingest_stats is not None      # it really went through the ring
    assert srv.ingest_stats.count_cuts + srv.ingest_stats.drain_cuts == \
        srv.ingest_stats.cuts == stats.n_flushes
    again = StreamingHybridServer(tart, tbackend, device="cpu", **CHUNKED)
    rp, rs = again.serve_stream(tingest.replay_source(trace))
    assert torch.equal(pred, rp) and stats.as_dict() == rs.as_dict()
    manual = StreamingHybridServer(tart, tbackend, device="cpu", **CHUNKED)
    mp = torch.cat([manual.step_chunk(c)[0].reshape(-1)
                    for c in tstream.iter_chunks(trace, WINDOW, K, N_BUCKETS,
                                                 device="cpu")])
    assert torch.equal(pred, mp[:trace.n_packets])
    assert manual.stats.as_dict() == stats.as_dict()
    _, jgot = _ref(setup, **CHUNKED)
    _same((to_np(pred), stats.as_dict(), to_np(srv.flow_table())), jgot)


def test_serve_trace_per_window_equals_manual_loop(setup):
    """The per-window serve_trace (deferred, through the ring) against the
    iter_windows + step + consume_flush loop it replaces."""
    trace, _, _, tart, tbackend = setup
    kw = dict(n_buckets=N_BUCKETS, window=WINDOW, flush_every=3, capacity=32)
    srv = StreamingHybridServer(tart, tbackend, device="cpu", **kw)
    pred, stats = srv.serve_trace(trace)
    manual = StreamingHybridServer(tart, tbackend, device="cpu", **kw)
    preds = []
    for w in tstream.iter_windows(trace, WINDOW, N_BUCKETS, device="cpu"):
        preds.append(manual.step(w)[0])
        tserving._patch(preds, manual.consume_flush())
    tserving._patch(preds, manual.flush(trigger="end_of_stream"))
    assert torch.equal(pred, torch.cat(preds)[:trace.n_packets])
    assert manual.stats.as_dict() == stats.as_dict()
    assert torch.equal(manual.flow_table(), srv.flow_table())


def test_prefetch_bit_identical_and_per_window_rejected(setup):
    trace, _, _, tart, tbackend = setup
    srv = StreamingHybridServer(tart, tbackend, device="cpu", **CHUNKED)
    on = _served(srv, trace, tingest, replay={"batch": 113}, prefetch=True)
    srv.reset()
    off = _served(srv, trace, tingest, replay={"batch": 113}, prefetch=False)
    _same(on, off)
    _, jgot = _ref(setup, replay={"batch": 113}, prefetch=True, **CHUNKED)
    _same(on, jgot)
    kw = dict(n_buckets=N_BUCKETS, window=WINDOW, capacity=32)
    pw = StreamingHybridServer(tart, tbackend, device="cpu", **kw)
    with pytest.raises(ValueError, match="prefetch"):
        pw.serve_stream(tingest.replay_source(trace), prefetch=True)
    pred, _ = pw.serve_stream(tingest.replay_source(trace))  # None: off
    assert pred.shape == (trace.n_packets,)
    assert not _prefetch_threads()


def test_serve_stream_per_window_deferred_dribbled(setup):
    trace = setup[0]
    kw = dict(n_buckets=N_BUCKETS, window=WINDOW, flush_every=3, capacity=32)
    _, ref = _port(setup, **kw)
    srv, got = _port(setup, replay={"batch": 151}, record_latency=True, **kw)
    _same(got, ref)
    # every packet's final (back-patched) prediction was timed once
    assert srv.latency.n == trace.n_packets
    _, jgot = _ref(setup, replay={"batch": 151}, **kw)
    _same(got, jgot)


def test_deadline_cuts_change_flushes_only(setup):
    # every batch ages the ring 10 fake seconds past the 1 s deadline, so
    # sub-chunk groups of complete windows are cut early
    _, ref = _port(setup, **CHUNKED)
    call = dict(replay={"batch": WINDOW + 11}, deadline=1.0)
    srv, got = _port(setup, clock=_fake_clock(step=10.0), **call, **CHUNKED)
    assert srv.ingest_stats.deadline_cuts > 0
    _same(got, ref, flushes=False)
    jsrv, jgot = _ref(setup, clock=_fake_clock(step=10.0), **call, **CHUNKED)
    _same(got, jgot)                         # the same grouping: flushes too
    assert srv.ingest_stats.as_dict() == jsrv.ingest_stats.as_dict()


def test_serve_stream_with_eviction_bit_identical(setup):
    kw = dict(CHUNKED, evict_age=0.5)
    _, ref = _port(setup, **kw)
    _, got = _port(setup, replay={"batch": 89}, **kw)
    _same(got, ref)
    assert ref[1]["evicted"] > 0             # the knob actually fired
    _, jgot = _ref(setup, replay={"batch": 89}, **kw)
    _same(got, jgot)


@pytest.mark.parametrize("path_kw", [dict(flush_every=2),
                                     dict(chunk_windows=K)],
                         ids=["deferred", "chunked"])
def test_serve_stream_fault_injection_replay(setup, path_kw):
    # an injected-fault schedule is a pure function of (seed, call index);
    # count cuts keep the flush grouping, so the dribbled stream replays
    # the exact degradation sequence of serve_trace, and of the reference
    _, _, jbackend, _, tbackend = setup
    kw = dict(n_buckets=N_BUCKETS, window=WINDOW, capacity=32, **path_kw)
    _, ref = _port(setup, backend=tfaults.FaultyBackend(
        tbackend, error_rate=0.4, seed=9),
        fault_policy=tfaults.FaultPolicy(**FAST), **kw)
    srv, got = _port(setup, backend=tfaults.FaultyBackend(
        tbackend, error_rate=0.4, seed=9),
        fault_policy=tfaults.FaultPolicy(**FAST), replay={"batch": 201}, **kw)
    _same(got, ref)
    assert ref[1]["degraded"] > 0            # faults actually landed
    jsrv, jgot = _ref(setup, backend=jfaults.FaultyBackend(
        jbackend, error_rate=0.4, seed=9),
        fault_policy=jfaults.FaultPolicy(**FAST), replay={"batch": 201},
        **kw)
    _same(got, jgot)
    assert srv.fault_stats.as_dict() == jsrv.fault_stats.as_dict()


def test_latency_recorder_covers_chunked_path(setup):
    trace, _, _, tart, tbackend = setup
    srv = StreamingHybridServer(tart, tbackend, device="cpu", **CHUNKED)
    for prefetch in (True, False):
        srv.reset()
        srv.serve_stream(tingest.replay_source(trace, batch=177),
                         record_latency=True, prefetch=prefetch)
        s = srv.latency.summary()
        assert s["n"] == trace.n_packets
        assert 0.0 <= s["p50_ms"] <= s["p95_ms"] <= s["p99_ms"]
    srv.serve_stream(tingest.replay_source(trace))   # off again
    assert srv.latency is None


def test_latency_spans_use_the_loop_clock(setup):
    """With an injected clock the recorded spans are exact: every cut is
    admitted at one tick and completes at the next reading, on both paths,
    so every span is one step of the clock."""
    trace = setup[0]
    for kw in (CHUNKED, dict(n_buckets=N_BUCKETS, window=WINDOW,
                             capacity=32)):
        srv, _ = _port(setup, replay={"batch": WINDOW * K},
                       record_latency=True, prefetch=False,
                       clock=_fake_clock(step=0.25), **kw)
        lat = srv.latency.latencies()
        assert lat.size == trace.n_packets
        assert np.all(lat > 0) and np.all(lat == np.round(lat / 0.25) * 0.25)


# -- flush-knob composition (wall-clock cuts x data-time flushes) -----------------

def test_flush_knobs_need_deferral_and_exclude_chunked(setup):
    _, _, _, tart, tbackend = setup
    kw = dict(n_buckets=N_BUCKETS, window=WINDOW, device="cpu")
    with pytest.raises(ValueError, match="flush_every"):
        StreamingHybridServer(tart, tbackend, flush_occupancy=0.5, **kw)
    with pytest.raises(ValueError, match="flush_every"):
        StreamingHybridServer(tart, tbackend, flush_deadline=1.0, **kw)
    with pytest.raises(ValueError):
        StreamingHybridServer(tart, tbackend, chunk_windows=K,
                              flush_every=4, flush_occupancy=0.5, **kw)


@pytest.mark.parametrize("knob", [{"flush_occupancy": 0.5},
                                  {"flush_deadline": 0.25}])
def test_flush_knobs_compose_with_ingest_deadline(setup, knob):
    # the ingest deadline (wall clock) regroups cuts and the flush knobs
    # (data time / occupancy) regroup flushes; on the per-window path cuts
    # are one window, so count-cut precedence consumes every complete
    # window the moment it exists and the wall-clock deadline is inert
    kw = dict(n_buckets=N_BUCKETS, window=WINDOW, flush_every=4,
              capacity=32, **knob)
    _, ref = _port(setup, **kw)
    call = dict(replay={"batch": WINDOW * 2 + 5}, deadline=1.0)
    srv, got = _port(setup, clock=_fake_clock(step=10.0), **call, **kw)
    assert srv.ingest_stats.deadline_cuts == 0
    assert srv.ingest_stats.count_cuts > 0
    _same(got, ref)
    _, jgot = _ref(setup, clock=_fake_clock(step=10.0), **call, **kw)
    _same(got, jgot)


# -- chunk-size autotune --------------------------------------------------------

def _mk(setup, **extra):
    _, _, _, tart, tbackend = setup
    return lambda k: StreamingHybridServer(
        tart, tbackend, n_buckets=N_BUCKETS, window=WINDOW, chunk_windows=k,
        capacity=32, device="cpu", **extra)


@pytest.mark.parametrize("times,default,want", [
    (lambda k: 1.0, 4, 16),                  # equal walls: the largest K
    ({4: 1.0, 8: 3.0, 16: 9.0}.__getitem__, 4, 4)])   # sublinear: smallest
def test_autotune_picks_per_packet_argmin(setup, times, default, want):
    kw = dict(window=WINDOW, n_buckets=N_BUCKETS, candidates=(4, 8, 16),
              default=default, time_fn=times)
    assert tserving.autotune_chunk_windows(_mk(setup), **kw) == want
    assert jserving.autotune_chunk_windows(None, **kw) == want


def test_autotune_never_drops_the_default(setup):
    times = {4: 5.0, 8: 5.0, 16: 0.1}
    kw = dict(window=WINDOW, n_buckets=N_BUCKETS, candidates=(4, 8),
              default=16, time_fn=times.__getitem__)
    assert tserving.autotune_chunk_windows(_mk(setup), **kw) == 16
    assert jserving.autotune_chunk_windows(None, **kw) == 16


def test_autotune_cache_short_circuits(setup):
    tserving.clear_chunk_tune_cache()
    calls = []

    def timer(k):
        calls.append(k)
        return float(k)
    kw = dict(window=WINDOW, n_buckets=N_BUCKETS, candidates=(4, 8),
              default=4, time_fn=timer, cache_key=("test", "cache"))
    k1 = tserving.autotune_chunk_windows(_mk(setup), **kw)
    n_timed = len(calls)
    k2 = tserving.autotune_chunk_windows(_mk(setup), **kw)
    assert k1 == k2 and len(calls) == n_timed
    tserving.clear_chunk_tune_cache()


def test_chunk_windows_auto_resolves_and_serves(setup):
    tserving.clear_chunk_tune_cache()
    kw = dict(n_buckets=N_BUCKETS, window=WINDOW, capacity=32)
    srv, got = _port(setup, chunk_windows="auto", **kw)
    assert srv.chunk_windows in tserving.CHUNK_WINDOW_CANDIDATES + \
        (tserving.DEFAULT_CHUNK_WINDOWS,)
    _, ref = _port(setup, chunk_windows=srv.chunk_windows, **kw)
    _same(got, ref)
    _, jgot = _ref(setup, chunk_windows=srv.chunk_windows, **kw)
    _same(got, jgot)
    tserving.clear_chunk_tune_cache()


# -- the loop's exit paths ----------------------------------------------------------

def test_serve_stream_joins_prefetch_thread_on_error(setup):
    """A step that raises mid-stream (here the backend) ends serve_stream
    with that error and the prefetch thread stopped and joined."""
    trace, _, _, tart, tbackend = setup
    calls = {"n": 0}

    def flaky(rows):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("backend died")
        return tbackend(rows)
    srv = StreamingHybridServer(tart, flaky, device="cpu", **CHUNKED)
    with pytest.raises(RuntimeError, match="backend died"):
        srv.serve_stream(tingest.replay_source(trace, batch=50),
                         prefetch=True, prefetch_depth=1)
    assert not _prefetch_threads()


def test_serve_stream_raises_source_errors(setup):
    """An exception in the source (on the prefetch thread) is re-raised
    to the serve_stream caller, and the thread is gone."""
    trace, _, _, tart, tbackend = setup

    def source():
        yield tingest.slice_trace(trace, 0, 700)
        raise OSError("capture lost")
    srv = StreamingHybridServer(tart, tbackend, device="cpu", **CHUNKED)
    with pytest.raises(OSError, match="capture lost"):
        srv.serve_stream(source())
    assert not _prefetch_threads()


def test_staging_layout_round_trips_a_cut(setup):
    """The staging buffer's layout: every column a typed view of one uint8
    buffer (the 4-byte columns 4-byte aligned), so one copy carries a cut
    and the views give back its columns bit for bit."""
    trace = setup[0]
    ring = tingest.PacketRingBuffer(WINDOW, K, N_BUCKETS)
    ring.admit(tingest.slice_trace(trace, 0, 2 * WINDOW + 5))
    cut = ring.drain()
    n = K * WINDOW
    buf = torch.zeros(tingest._LANE_BYTES * n, dtype=torch.uint8)
    views = tingest._column_views(buf, n)
    for k, v in views.items():
        assert v.shape == (n,) and v.storage_offset() % v.element_size() == 0
        v.numpy()[:] = cut.valid if k == "valid" else cut.cols[k]
    again = tingest._column_views(buf.clone(), n)
    want = cut.to_chunk(device="cpu")
    for k, v in again.items():
        assert_bit_equal(getattr(want, k), v.reshape(K, WINDOW))


def test_pinned_staging_needs_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        tingest.PinnedStaging(K, WINDOW, device="cpu")
    chunk = tstream.packet_chunk_from_arrays(
        *(np.zeros((K, WINDOW), dt) for dt in
          (np.int32, np.float32, np.float32, np.float32, bool)),
        device="cpu")
    assert tingest.await_chunk(chunk, None) is chunk
