"""Port parity for backend fault tolerance (``repro_torch.serving.faults``)
and the streaming server's degraded routes, against the reference's
``tests/test_faults.py`` (less its two sharded cases, which are in
``tests/test_torch_shard.py``) and against the reference's guard and server on the same
seeded fault sequences. Everything runs on the CPU; the worker thread's
CUDA stream is checked in ``tests/test_torch_cuda.py``.

Tolerances: predictions, fault telemetry and every integer counter compare
bit for bit; ``conf_sum`` at rtol=1e-5 (summed in another order).
"""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import stream_serving as jserving  # noqa: E402
from repro_torch.serving.faults import (CLOSED, HALF_OPEN, OPEN,  # noqa: E402
                                        BackendFault, FaultPolicy,
                                        FaultyBackend, GuardedBackend)
from repro_torch.serving.stream_serving import \
    StreamingHybridServer  # noqa: E402
from test_torch_parity import (assert_bit_equal, port_artifact,  # noqa: E402
                               port_ensemble)

N_BUCKETS = 1 << 12

# a policy with no real waiting anywhere: tests run instantly
FAST = dict(max_retries=1, backoff_base_s=0.0, breaker_threshold=3,
            breaker_cooldown=2)
TFAST = FaultPolicy(**FAST)
JFAST = jfaults.FaultPolicy(**FAST)


@pytest.fixture(scope="module")
def fault_setup():
    """The reference's fault fixture (400 flows, 4096 buckets, a 4x3 RF
    switch and a 12x5 RF backend), carried across to the port."""
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


def _stats_equal(ref, got):
    rd, gd = ref.as_dict(), got.as_dict()
    for k in ("windows", "packets", "handled", "backend_rows", "deferred",
              "degraded", "flushes", "evicted", "overflow"):
        assert rd[k] == gd[k], k
    np.testing.assert_allclose(gd["conf_sum"], rd["conf_sum"], rtol=1e-5)


# -- FaultPolicy ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(timeout_s=0.0), dict(max_retries=-1),
                                dict(breaker_threshold=-1),
                                dict(breaker_threshold=2,
                                     breaker_cooldown=0)])
def test_policy_validation(kw):
    with pytest.raises(ValueError) as terr:
        FaultPolicy(**kw)
    with pytest.raises(ValueError) as jerr:
        jfaults.FaultPolicy(**kw)
    assert str(terr.value) == str(jerr.value)
    FaultPolicy(breaker_threshold=0, breaker_cooldown=0)   # breaker off: ok


# -- GuardedBackend unit behavior (scripted backends, injected sleep) ----------

def _scripted(outcomes, fault=BackendFault):
    """Backend failing/succeeding per a script of bools (True = ok)."""
    it = iter(outcomes)

    def fn(rows):
        if not next(it):
            raise fault("scripted")
        return rows[:, 0]
    return fn


def test_guard_success_passthrough_keeps_the_backend_answer():
    """The port's guard returns the backend's answer as it came (a tensor
    stays a tensor on its device; the reference converts to numpy)."""
    g = GuardedBackend(_scripted([True, True]), TFAST, sleep=lambda s: None)
    rows = torch.ones((3, 2))
    out = g(rows)
    assert isinstance(out, torch.Tensor)
    assert_bit_equal(np.ones(3, np.float32), out)
    assert g.stats.flushes_ok == 1 and g.stats.attempts == 1
    assert g.stats.retries == 0 and g.state == CLOSED
    out = g(np.ones((2, 2)))                 # numpy in, numpy out
    assert isinstance(out, np.ndarray) and out.tolist() == [1.0, 1.0]


def test_guard_retries_then_succeeds_with_backoff_schedule():
    slept = []
    p = FaultPolicy(max_retries=3, backoff_base_s=0.01, backoff_factor=2.0,
                    breaker_threshold=0)
    g = GuardedBackend(_scripted([False, False, True]), p,
                       sleep=slept.append)
    assert g(torch.ones((2, 2))) is not None
    assert g.stats.attempts == 3 and g.stats.retries == 2
    assert slept == [0.01, 0.02]            # base * factor**i, exponential
    assert g.stats.flushes_ok == 1 and g.stats.flushes_failed == 0


def test_guard_exhausted_retries_returns_none():
    g = GuardedBackend(_scripted([False] * 2), TFAST, sleep=lambda s: None)
    assert g(torch.ones((2, 2))) is None
    assert g.stats.flushes_failed == 1 and g.stats.attempts == 2
    assert g.consecutive_failures == 1 and g.state == CLOSED


def test_guard_treats_any_backend_exception_as_a_fault():
    """The fault boundary catches every Exception the backend raises (the
    lint waiver's reason), not only BackendFault."""
    g = GuardedBackend(_scripted([False, False], fault=ValueError), TFAST,
                       sleep=lambda s: None)
    assert g(torch.ones((2, 2))) is None
    assert g.stats.flushes_failed == 1


def test_guard_timeout_abandons_attempt():
    release = threading.Event()

    def slow(rows):
        release.wait(5.0)
        return torch.zeros(len(rows))

    p = FaultPolicy(timeout_s=0.05, max_retries=0, breaker_threshold=0)
    g = GuardedBackend(slow, p)
    try:
        assert g(torch.ones((2, 2))) is None
        assert g.stats.timeouts == 1 and g.stats.flushes_failed == 1
    finally:
        release.set()                       # unstick the abandoned worker


def test_guard_timeout_returns_the_worker_answer():
    """Under a timeout the backend runs on the worker thread and its answer
    comes back unchanged (a CPU tensor: no stream to join)."""
    p = FaultPolicy(timeout_s=5.0, max_retries=0, breaker_threshold=0)
    seen = []

    def fn(rows):
        seen.append(threading.current_thread().name)
        return rows.sum(dim=1)

    g = GuardedBackend(fn, p)
    out = g(torch.ones((4, 3)))
    assert_bit_equal(np.full(4, 3.0, np.float32), out)
    assert seen[0].startswith("guarded-backend")
    g._executor.shutdown(wait=True)


def test_breaker_opens_rejects_probes_and_closes():
    script = [False] * 6 + [True, True]
    g = GuardedBackend(_scripted(script), TFAST, sleep=lambda s: None)
    for _ in range(3):                      # 2 attempts each -> 6 failures
        assert g(torch.ones((1, 1))) is None
    assert g.state == OPEN and g.stats.breaker_opens == 1
    for _ in range(2):                      # cooldown: no backend call
        assert g(torch.ones((1, 1))) is None
    assert g.stats.rejected == 2 and g.stats.attempts == 6
    assert g(torch.ones((1, 1))) is not None   # the probe: 1 attempt, closes
    assert g.state == CLOSED and g.stats.breaker_closes == 1
    assert g.stats.attempts == 7
    assert g(torch.ones((1, 1))) is not None


def test_breaker_failed_probe_reopens():
    script = [False] * 6 + [False] + [True]
    states = []
    inner = _scripted(script)

    def fn(rows):
        states.append(g.state)
        return inner(rows)

    g = GuardedBackend(fn, TFAST, sleep=lambda s: None)
    for _ in range(3 + 2):                  # open + drain cooldown
        g(torch.ones((1, 1)))
    assert g.state == OPEN and g._cooldown_left == 0
    assert g(torch.ones((1, 1))) is None    # the HALF_OPEN probe fails
    assert states[-1] == HALF_OPEN and states[:-1] == [CLOSED] * 6
    assert g.state == OPEN and g.stats.breaker_opens == 2
    assert g.stats.attempts == 7


def test_guard_reset_restores_closed_breaker():
    g = GuardedBackend(_scripted([False] * 6), TFAST, sleep=lambda s: None)
    for _ in range(3):
        g(torch.ones((1, 1)))
    assert g.state == OPEN
    g.reset()
    assert g.state == CLOSED and g.stats.attempts == 0
    assert g.consecutive_failures == 0


@pytest.mark.parametrize("script", [
    [True], [False, True], [False] * 6 + [True, True],
    [False] * 6 + [False] + [True, True], [False, False, True, False, False]])
def test_guard_matches_reference_flush_by_flush(script):
    """The port's and the reference's guards over the same scripted
    backend: the same answers (None or not), breaker states and telemetry
    after every flush."""
    tg = GuardedBackend(_scripted(script), TFAST, sleep=lambda s: None)
    jg = jfaults.GuardedBackend(
        lambda r, f=_scripted(script): np.asarray(f(torch.as_tensor(r))),
        JFAST, sleep=lambda s: None)
    n_calls = len(script) + 2
    for _ in range(n_calls):
        try:
            t_out = tg(torch.ones((2, 2)))
            j_out = jg(np.ones((2, 2), np.float32))
        except StopIteration:
            break
        assert (t_out is None) == (j_out is None)
        assert tg.state == jg.state
        assert tg.stats.as_dict() == jg.stats.as_dict()


# -- FaultyBackend injection ----------------------------------------------------

def test_faulty_backend_validation():
    ok = lambda r: r
    for kw in (dict(error_rate=1.5), dict(spike_rate=-0.1)):
        with pytest.raises(ValueError) as terr:
            FaultyBackend(ok, **kw)
        with pytest.raises(ValueError) as jerr:
            jfaults.FaultyBackend(ok, **kw)
        assert str(terr.value) == str(jerr.value)


def _fault_pattern(fb, n, fault):
    pat = []
    for _ in range(n):
        try:
            fb(np.ones((1, 1)))
            pat.append(False)
        except fault:
            pat.append(True)
    return pat


def test_faulty_backend_seeded_determinism_and_reset():
    mk = lambda: FaultyBackend(lambda r: r, error_rate=0.5, seed=11)
    a, b = mk(), mk()
    pa = _fault_pattern(a, 40, BackendFault)
    assert pa == _fault_pattern(b, 40, BackendFault)
    assert any(pa) and not all(pa)
    a.reset()
    assert _fault_pattern(a, 40, BackendFault) == pa
    c = FaultyBackend(lambda r: r, error_rate=0.5, seed=12)
    assert _fault_pattern(c, 40, BackendFault) != pa
    ref = jfaults.FaultyBackend(lambda r: r, error_rate=0.5, seed=11)
    assert _fault_pattern(ref, 40, jfaults.BackendFault) == pa


def test_faulty_backend_outages_dont_shift_error_pattern():
    base = _fault_pattern(
        FaultyBackend(lambda r: r, error_rate=0.3, seed=5), 30, BackendFault)
    out = _fault_pattern(
        FaultyBackend(lambda r: r, error_rate=0.3, seed=5,
                      outages=range(10, 14)), 30, BackendFault)
    assert all(out[i] for i in range(10, 14))
    assert out[:10] == base[:10] and out[14:] == base[14:]
    ref = _fault_pattern(
        jfaults.FaultyBackend(lambda r: r, error_rate=0.3, seed=5,
                              outages=range(10, 14)), 30,
        jfaults.BackendFault)
    assert out == ref


def test_faulty_backend_spikes_sleep_before_the_call():
    slept = []
    fb = FaultyBackend(lambda r: r, spike_rate=1.0, spike_s=0.25, seed=0,
                       sleep=slept.append)
    fb(np.ones((1, 1)))
    assert slept == [0.25] and fb.spikes == 1 and fb.errors == 0


# -- serving: zero-fault bit identity and graceful degradation ------------------

PATHS = [dict(), dict(flush_every=4), dict(chunk_windows=4)]
PATH_IDS = ["per_window", "deferred", "chunked"]


@pytest.mark.parametrize("path_kw", PATHS, ids=PATH_IDS)
def test_zero_fault_bit_identity(fault_setup, path_kw):
    """A guarded server with a clean backend is invisible: its predictions
    equal the unguarded server's and the reference's guarded server's bit
    for bit on every path."""
    trace, art, jbackend, tart, tbackend = fault_setup
    kw = dict(KW, **path_kw)
    ref, s_ref = StreamingHybridServer(tart, tbackend, device="cpu",
                                       **kw).serve_trace(trace)
    srv = StreamingHybridServer(tart, tbackend, fault_policy=TFAST,
                                device="cpu", **kw)
    got, stats = srv.serve_trace(trace)
    assert srv._fused_ok is False
    jp, js = jserving.StreamingHybridServer(
        art, jbackend, fault_policy=JFAST, **kw).serve_trace(trace)
    assert_bit_equal(ref, got)
    assert_bit_equal(jp, got)
    _stats_equal(s_ref, stats)
    _stats_equal(js, stats)
    assert stats.n_degraded == 0
    assert srv.fault_stats.flushes_failed == 0
    assert srv.fault_stats.flushes_ok == stats.n_flushes


@pytest.mark.parametrize("path_kw", PATHS, ids=PATH_IDS)
def test_degraded_rows_keep_switch_predictions(fault_setup, path_kw):
    """With injected flush failures serve_trace completes (check() inside),
    degraded rows keep the switch answer, and the predictions, counters and
    guard telemetry equal the reference's under the same fault sequence."""
    trace, art, jbackend, tart, tbackend = fault_setup
    kw = dict(KW, **path_kw)
    fkw = dict(error_rate=0.4, seed=9, outages=range(0, 4))
    srv = StreamingHybridServer(tart, FaultyBackend(tbackend, **fkw),
                                fault_policy=TFAST, device="cpu", **kw)
    preds, stats = srv.serve_trace(trace)
    jsrv = jserving.StreamingHybridServer(
        art, jfaults.FaultyBackend(jbackend, **fkw), fault_policy=JFAST,
        **kw)
    jp, js = jsrv.serve_trace(trace)
    assert stats.n_degraded > 0
    assert preds.shape == (trace.n_packets,)
    assert (stats.n_handled + stats.total_backend_rows + stats.n_deferred
            + stats.n_degraded == stats.n_packets)
    g = srv.fault_stats
    assert g.flushes_failed > 0
    assert stats.n_flushes == g.flushes_ok
    assert set(np.unique(preds.numpy())) <= {0, 1}
    assert_bit_equal(jp, preds)
    _stats_equal(js, stats)
    assert g.as_dict() == jsrv.fault_stats.as_dict()


def test_degraded_predictions_match_switch_tier(fault_setup):
    """Under a total outage every window degrades: the stream's answers
    equal a server whose backend never sees a row (capacity=0, the
    backend called on an empty buffer), as in the reference."""
    trace, art, jbackend, tart, tbackend = fault_setup
    dead = FaultyBackend(tbackend, error_rate=1.0, seed=0)
    srv = StreamingHybridServer(tart, dead, fault_policy=TFAST,
                                device="cpu", **KW)
    preds, stats = srv.serve_trace(trace)
    assert stats.total_backend_rows == 0 and stats.n_flushes == 0
    assert stats.n_degraded > 0
    assert (stats.n_handled + stats.n_deferred + stats.n_degraded
            == stats.n_packets)
    seen = []

    def empty_ok(rows):
        seen.append(tuple(rows.shape))
        return tbackend(rows)

    kw0 = dict(KW, capacity=0)
    ref, s0 = StreamingHybridServer(tart, empty_ok, device="cpu",
                                    **kw0).serve_trace(trace)
    assert seen and set(seen) == {(0, 8)}
    assert s0.total_backend_rows == 0 and s0.n_flushes == s0.n_windows
    assert_bit_equal(ref, preds)
    jref, _ = jserving.StreamingHybridServer(art, jbackend,
                                             **kw0).serve_trace(trace)
    assert_bit_equal(jref, preds)


def test_breaker_opens_under_sustained_faults(fault_setup):
    trace, art, jbackend, tart, tbackend = fault_setup
    srv = StreamingHybridServer(
        tart, FaultyBackend(tbackend, error_rate=0.9, seed=2),
        fault_policy=TFAST, device="cpu", **KW)
    preds, stats = srv.serve_trace(trace)
    g = srv.fault_stats
    assert g.breaker_opens >= 1
    assert g.rejected >= 1
    assert stats.n_degraded > 0
    jsrv = jserving.StreamingHybridServer(
        art, jfaults.FaultyBackend(jbackend, error_rate=0.9, seed=2),
        fault_policy=JFAST, **KW)
    jp, _ = jsrv.serve_trace(trace)
    assert_bit_equal(jp, preds)
    assert g.as_dict() == jsrv.fault_stats.as_dict()


def test_fault_policy_rejects_fused_and_forces_eager(fault_setup):
    _, _, _, tart, tbackend = fault_setup
    with pytest.raises(ValueError):
        StreamingHybridServer(tart, tbackend, fault_policy=TFAST, fuse=True,
                              device="cpu", **KW)
    srv = StreamingHybridServer(tart, tbackend, fault_policy=TFAST,
                                flush_every=2, device="cpu", **KW)
    assert srv._fused_ok is False and srv._defer_graphs is False
    assert StreamingHybridServer(tart, tbackend, device="cpu",
                                 **KW).fault_stats is None


def test_server_reset_resets_guard(fault_setup):
    """reset() starts a fresh guard epoch: identical reruns see identical
    breaker behavior and per-run telemetry."""
    trace, _, _, tart, tbackend = fault_setup
    faulty = FaultyBackend(tbackend, error_rate=0.4, seed=9)
    srv = StreamingHybridServer(tart, faulty, fault_policy=TFAST,
                                device="cpu", **KW)
    p1, s1 = srv.serve_trace(trace)
    g1 = dataclasses.asdict(srv.fault_stats)
    srv.reset()
    faulty.reset()
    p2, s2 = srv.serve_trace(trace)
    assert_bit_equal(p1, p2)
    assert s1.n_degraded == s2.n_degraded
    assert dataclasses.asdict(srv.fault_stats) == g1


def test_deferred_manual_flush_degrades_then_recovers(fault_setup):
    """A failed deferred flush returns the provisional answers unpatched
    and folds the cycle into ``degraded``; the next cycle's flush patches
    again. Equal to the reference step by step."""
    from repro.netsim.stream import iter_windows
    from test_torch_parity import port_window
    trace, art, jbackend, tart, tbackend = fault_setup
    kw = dict(KW, flush_every=3)
    srv = StreamingHybridServer(
        tart, FaultyBackend(tbackend, outages=range(0, 2)),
        fault_policy=TFAST, device="cpu", **kw)
    jsrv = jserving.StreamingHybridServer(
        art, jfaults.FaultyBackend(jbackend, outages=range(0, 2)),
        fault_policy=JFAST, **kw)
    ws = list(iter_windows(trace, 256, N_BUCKETS))[:4]
    prov = [srv.step(port_window(w))[0] for w in ws[:2]]
    for w in ws[:2]:
        jsrv.step(w)
    n, patched = srv.flush()                     # both attempts fail
    jn, jpatched = jsrv.flush()
    assert n == jn == 2
    assert_bit_equal(jpatched, patched)
    for i in range(2):
        assert_bit_equal(prov[i], patched[i])
    deg = srv.stats.n_degraded
    assert deg == jsrv.stats.n_degraded > 0 and srv.stats.n_flushes == 0
    for w in ws[2:]:
        srv.step(port_window(w))
        jsrv.step(w)
    _, patched = srv.flush()                     # the backend is back
    _, jpatched = jsrv.flush()
    assert_bit_equal(jpatched, patched)
    assert srv.stats.n_flushes == 1 and srv.stats.n_degraded == deg
    _stats_equal(jsrv.stats, srv.stats)
