"""Port parity for the observability package (``repro_torch.obs``) and its
wiring into the streaming server: the cases of the reference's
``tests/test_obs.py`` (less ``test_obs_bit_identity_sharded``, which is in
``tests/test_torch_shard.py``), each held against the reference on the same inputs.
Everything runs on the CPU.

Tolerances: predictions, the flow table, every integer counter, rollup
rows, drift alarms' detectors and windows, guard telemetry and
``LatencyRecorder`` summaries from injected spans compare bit for bit;
``conf_sum`` and the statistics derived from it (mean confidence, drift
values) at rtol=1e-5 (summed in another order). Event streams compare by
``kind``, ``seq`` and fields, with ``ts`` left out.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.netsim import ingest as jingest  # noqa: E402
from repro.netsim.packets import synth_trace  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro.serving import stream_serving as jserving  # noqa: E402
from repro_torch.netsim import ingest as tingest  # noqa: E402
from repro_torch.serving import faults as tfaults  # noqa: E402
from repro_torch.serving import stream_serving as tserving  # noqa: E402
from repro_torch.serving.stream_serving import \
    StreamingHybridServer  # noqa: E402
from test_torch_parity import (assert_bit_equal, port_artifact,  # noqa: E402
                               port_ensemble)

N_BUCKETS = 1 << 12


@pytest.fixture(scope="module")
def obs_setup():
    """The reference's obs fixture (300 flows, 4096 buckets): a 4x3 RF
    switch and a 12x5 RF backend, both carried across to the port."""
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


def _close(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        return a == pytest.approx(b, rel=1e-5)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def assert_same_events(got, ref):
    """Two event sequences (Event lists or buses) equal by seq, kind and
    fields, ts left out; float fields at rtol 1e-5."""
    got = got.events if hasattr(got, "events") else got
    ref = ref.events if hasattr(ref, "events") else ref
    assert [(e.seq, e.kind) for e in got] == [(e.seq, e.kind) for e in ref]
    for g, r in zip(got, ref):
        assert set(g.fields) == set(r.fields), (g.kind, g.fields, r.fields)
        for k in r.fields:
            assert _close(g.fields[k], r.fields[k]), (g.kind, k, g.fields,
                                                     r.fields)


def _rows_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g["key"], g["window"], g["samples"]) == \
            (r["key"], r["window"], r["samples"])
        assert set(g["sums"]) == set(r["sums"])
        for k, v in r["sums"].items():
            assert _close(g["sums"][k], v), k


def _alarms_equal(got, ref):
    assert [(a.detector, a.key, a.window) for a in got] == \
        [(a.detector, a.key, a.window) for a in ref]
    for g, r in zip(got, ref):
        for f in ("value", "baseline", "threshold"):
            assert getattr(g, f) == pytest.approx(getattr(r, f), rel=1e-5)


# -- EventBus ------------------------------------------------------------------

def test_event_bus_seq_and_ring():
    buses = (tobs.EventBus(max_events=4), jobs.EventBus(max_events=4))
    for bus in buses:
        for i in range(6):
            bus.emit("chunk", windows=i)
        assert bus.emitted == 6 and len(bus) == 4     # the ring evicted 2
        seqs = [e.seq for e in bus.events]
        assert seqs == sorted(seqs) and seqs[-1] - seqs[0] == 3
        assert bus.counts() == {"chunk": 4}   # only buffered events count
        assert bus.kinds() == ["chunk"] * 4 and len(bus.of("chunk")) == 4
    assert_same_events(*buses)
    assert tobs.EVENT_KINDS == jobs.EVENT_KINDS
    assert tobs.EVENT_SCHEMA_VERSION == jobs.EVENT_SCHEMA_VERSION
    buses[0].clear()
    assert len(buses[0]) == 0 and buses[0].emitted == 6
    with pytest.raises(ValueError):
        tobs.EventBus(max_events=0)


def test_event_bus_rejects_unknown_kind_and_reserved_fields():
    for mod in (tobs, jobs):
        bus = mod.EventBus()
        with pytest.raises(mod.EventSchemaError):
            bus.emit("not_a_kind")
        with pytest.raises(mod.EventSchemaError):
            bus.emit("chunk", seq=7)         # shadows an envelope key
        assert bus.emitted == 0              # failed emits record nothing


def test_event_log_roundtrip_and_validation(tmp_path):
    """The port's log passes both packages' validators (one schema), and a
    reordered seq fails both."""
    path = str(tmp_path / "events.jsonl")
    obs = tobs.Observability(events_path=path)
    obs.emit("serve_begin", mode="chunked")
    obs.emit("chunk", windows=8)
    obs.emit("serve_end", packets=100)
    obs.close()
    assert tobs.validate_event_log(path) == jobs.validate_event_log(path) == 3
    lines = [json.loads(ln) for ln in open(path)]
    assert [ln["kind"] for ln in lines] == ["serve_begin", "chunk",
                                            "serve_end"]
    assert all(ln["v"] == 1 for ln in lines)
    lines[2]["seq"] = lines[0]["seq"]
    with open(path, "w") as f:
        for ln in lines:
            f.write(json.dumps(ln) + "\n")
    for mod in (tobs, jobs):
        with pytest.raises(mod.EventSchemaError):
            mod.validate_event_log(path)


@pytest.mark.parametrize("line", [
    [1], {"v": 1, "seq": 0, "ts": 0.0}, {"v": 2, "seq": 0, "ts": 0.0,
                                         "kind": "chunk"},
    {"v": 1, "seq": True, "ts": 0.0, "kind": "chunk"},
    {"v": 1, "seq": 0, "ts": 0.0, "kind": "nope"},
    {"v": 1, "seq": 0, "ts": 0.0, "kind": "chunk", "x": {"a": 1}},
    {"v": 1, "seq": 0, "ts": 0.0, "kind": "chunk", "x": [[1]]},
    {"v": 1, "seq": 0, "ts": 0.0, "kind": "chunk", "x": [1, "a", None]}])
def test_validate_event_line_matches_reference(line):
    """Each malformed line is refused by both validators, the good one
    accepted by both."""
    def verdict(mod):
        try:
            mod.validate_event_line(line)
            return "ok"
        except mod.EventSchemaError:
            return "refused"
    assert verdict(tobs) == verdict(jobs)
    lines = [e for e in tobs.iter_event_lines(
        [tobs.Event(seq=0, ts=1.5, kind="chunk", fields={"k": 1})])]
    assert lines == [{"v": 1, "seq": 0, "ts": 1.5, "kind": "chunk", "k": 1}]


# -- MetricsRegistry + RollupWindows ---------------------------------------------

def test_registry_metrics_and_type_conflict():
    snaps = []
    for mod in (tobs, jobs):
        reg = mod.MetricsRegistry()
        reg.counter("flushes").inc()
        reg.counter("flushes").inc(2)
        reg.gauge("occupancy").set(0.5)
        for v in (1.0, 2.0, 3.0):
            reg.histogram("lat").observe(v)
        snap = reg.snapshot()
        assert snap["counters"]["flushes"] == 3
        assert snap["gauges"]["occupancy"] == 0.5
        assert snap["histograms"]["lat"]["n"] == 3
        assert snap["histograms"]["lat"]["mean"] == 2.0
        with pytest.raises(ValueError):
            reg.gauge("flushes")             # registered as a counter
        snaps.append(snap)
    assert snaps[0] == snaps[1]


def test_registry_sources_unify_stats_objects():
    """StreamStats / FaultStats / IngestStats all expose as_dict() and route
    through one snapshot(); a source that raises reports an error."""
    snaps = []
    for reg, fs, ing in (
            (tobs.MetricsRegistry(), tfaults.FaultStats(flushes_ok=2),
             tingest.IngestStats(admitted=10, count_cuts=1)),
            (jobs.MetricsRegistry(), jfaults.FaultStats(flushes_ok=2),
             jingest.IngestStats(admitted=10, count_cuts=1))):
        reg.register_source("faults", fs.as_dict)
        reg.register_source("ingest", ing.as_dict)
        reg.register_source("broken", lambda: 1 / 0)
        snap = reg.snapshot()
        assert snap["sources"]["faults"]["flushes_ok"] == 2
        assert snap["sources"]["ingest"]["admitted"] == 10
        assert snap["sources"]["ingest"]["cuts"] == 1      # derived key
        assert "error" in snap["sources"]["broken"]        # never raises
        assert reg.source_names == ("faults", "ingest", "broken")
        reg.unregister_source("broken")
        snaps.append(snap)
    assert snaps[0] == snaps[1]


def test_rollup_windows_close_flush_and_vector_fold():
    rows = []
    for mod in (tobs, jobs):
        rw = mod.RollupWindows(every=2)
        assert rw.observe({"packets": 10, "class_counts": [8, 2]}) is None
        row = rw.observe({"packets": 5, "class_counts": [5, 0],
                          "flag": True, "note": "dropped"})
        assert row["samples"] == 2 and row["sums"]["packets"] == 15
        assert row["sums"]["class_counts"] == [13.0, 2.0]
        rw.observe({"packets": 7}, key="tenant_b")       # keyed windows
        assert rw.flush("tenant_b")["sums"]["packets"] == 7
        assert rw.flush("tenant_b") is None              # nothing open
        rw.observe({"packets": 1})
        assert len(rw.flush_all()) == 1
        assert [r["key"] for r in rw.rows] == ["default", "tenant_b",
                                               "default"]
        assert rw.n_rows == 3 and len(rw.rows_for("default")) == 2
        rows.append(list(rw.rows))
    _rows_equal(*rows)
    with pytest.raises(ValueError):
        tobs.RollupWindows(every=0)


# -- StageTimer / SampledSync / annotation ----------------------------------------

def test_stage_timer_accumulates():
    summaries = []
    for mod in (tobs, jobs):
        t = iter(np.arange(0.0, 10.0, 0.5))
        timer = mod.StageTimer(clock=lambda: next(t))
        with timer.stage("megastep"):
            pass
        with timer.stage("megastep"):
            pass
        timer.record("h2d", 0.25)
        summ = timer.summary()
        assert summ["megastep"]["n"] == timer.count("megastep") == 2
        assert summ["megastep"]["total_s"] == pytest.approx(1.0)
        assert summ["h2d"]["max_ms"] == pytest.approx(250.0)
        summaries.append(summ)
    assert summaries[0] == summaries[1]
    assert tobs.STAGES == jobs.STAGES


def test_sampled_sync_cadence():
    for mod in (tobs, jobs):
        assert [mod.SampledSync(0).due() for _ in range(5)] == [False] * 5
        s = mod.SampledSync(3)
        assert [s.due() for _ in range(7)] == [False, False, True,
                                               False, False, True, False]
        with pytest.raises(ValueError):
            mod.SampledSync(-1)


def test_annotation_is_a_profiler_range():
    """Enabled, the annotation is a ``record_function`` range that shows in
    a profiler trace; disabled, a null context."""
    with tobs.annotation("off", enabled=False):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tobs.Observability(annotate=True).annotate("megastep"):
            torch.ones(4).sum()
    assert "megastep" in {e.key for e in prof.key_averages()}


# -- DriftMonitor ----------------------------------------------------------------

def _row(window, *, packets=1000, conf=0.95, frac=0.9, mix=(0.9, 0.1),
         key="default"):
    return {"key": key, "window": window, "samples": 1,
            "sums": {"packets": packets, "conf_sum": conf * packets,
                     "handled": int(frac * packets),
                     "class_counts": [m * packets for m in mix]}}


def _both_drift(config_kw, rows):
    mons = (tobs.DriftMonitor(tobs.DriftConfig(**config_kw)),
            jobs.DriftMonitor(jobs.DriftConfig(**config_kw)))
    fired = [[m.observe(r) for r in rows] for m in mons]
    for t, j in zip(*fired):
        _alarms_equal(t, j)
    return mons, fired[0]


def test_drift_baseline_freezes_then_detects():
    rows = [_row(0), _row(1), _row(2),
            _row(3, conf=0.6, frac=0.5, mix=(0.2, 0.8))]
    (mon, jmon), fired = _both_drift(dict(baseline_windows=2), rows)
    assert fired[:3] == [[], [], []]      # baseline, then stationary
    assert {a.detector for a in fired[3]} == {
        "conf_collapse", "frac_handled_drop", "class_mix_shift"}
    a = next(a for a in fired[3] if a.detector == "conf_collapse")
    assert a.baseline == pytest.approx(0.95) and a.value == pytest.approx(0.6)
    assert mon.fired_detectors == jmon.fired_detectors
    mon.reset()
    assert not mon.fired and not mon.baseline_ready()
    for bad in (dict(conf_drop=0.0), dict(baseline_windows=0),
                dict(min_packets=-1)):
        with pytest.raises(ValueError):
            tobs.DriftConfig(**bad)


def test_drift_min_packets_guard_and_disabled_detectors():
    rows = [_row(0, packets=10), _row(1),
            _row(2, conf=0.1, frac=0.1, mix=(0.1, 0.9))]
    (mon, _), fired = _both_drift(dict(baseline_windows=1, min_packets=64,
                                       conf_drop=None, frac_drop=None), rows)
    assert fired[0] == [] and [a.detector for a in fired[2]] == [
        "class_mix_shift"]


def test_drift_per_key_baselines():
    rows = [_row(0, key="a"), _row(0, key="b", mix=(0.1, 0.9)),
            _row(1, key="a", mix=(0.9, 0.1)),
            _row(1, key="b", mix=(0.9, 0.1))]
    _, fired = _both_drift(dict(baseline_windows=1), rows)
    assert fired[2] == []
    assert [a.detector for a in fired[3]] == ["class_mix_shift"]
    assert fired[3][0].key == "b"


def test_drift_class_space_growth_pads():
    rows = [_row(0, mix=(0.9, 0.1)), _row(1, mix=(0.1, 0.1, 0.8))]
    _, fired = _both_drift(dict(baseline_windows=1), rows)
    assert [a.detector for a in fired[1]] == ["class_mix_shift"]


# -- LatencyRecorder bounded reservoir --------------------------------------------

def test_latency_recorder_unbounded_unchanged():
    for mod in (tingest, jingest):
        rec = mod.LatencyRecorder()
        rec.record(np.array([1.0, 2.0]), 3.0)
        rec.record(np.array([2.5]), 3.0)
        np.testing.assert_allclose(rec.latencies(), [2.0, 1.0, 0.5])
        s = rec.summary()
        assert s["n"] == 3
        assert s["mean_ms"] == pytest.approx(3500.0 / 3)
        assert s["max_ms"] == pytest.approx(2000.0)


def test_latency_recorder_reservoir_bounds_memory_exact_until_full():
    """The port's reservoir draws what the reference's draws: the same
    samples, the same summary, exact until the reservoir fills."""
    recs = []
    rng = np.random.default_rng(0)
    admits = rng.uniform(0.0, 1.0, 10_000)
    for mod in (tingest, jingest):
        rec = mod.LatencyRecorder(max_samples=8)
        rec.record(np.arange(5, dtype=np.float64), 5.0)   # spans 5..1
        assert rec.n == 5 and rec.latencies().size == 5
        exact = mod.LatencyRecorder()
        exact.record(np.arange(5, dtype=np.float64), 5.0)
        assert rec.summary() == exact.summary()           # exact until full
        rec.record(admits, 2.0)
        assert rec.latencies().size == 8                  # O(k), not O(n)
        s = rec.summary()
        assert s["n"] == 10_005
        true_spans = np.concatenate([5.0 - np.arange(5), 2.0 - admits])
        assert s["mean_ms"] == pytest.approx(true_spans.mean() * 1e3)
        assert s["max_ms"] == pytest.approx(5000.0)
        assert abs(s["p50_ms"] - np.percentile(true_spans * 1e3, 50)) < 700.0
        recs.append(rec)
    assert_bit_equal(recs[1].latencies(), recs[0].latencies())
    assert recs[0].summary() == recs[1].summary()


def test_latency_recorder_seeded_determinism_and_validation():
    a, b = (tingest.LatencyRecorder(max_samples=4, seed=7),
            tingest.LatencyRecorder(max_samples=4, seed=7))
    j = jingest.LatencyRecorder(max_samples=4, seed=7)
    for rec in (a, b, j):
        rec.record(np.linspace(0, 1, 100), 2.0)
    assert_bit_equal(a.latencies(), b.latencies())
    assert_bit_equal(j.latencies(), a.latencies())
    with pytest.raises(ValueError):
        tingest.LatencyRecorder(max_samples=0)


def test_serve_stream_latency_samples_bounds_recorder(obs_setup):
    trace, _, _, tart, tbackend = obs_setup
    srv = StreamingHybridServer(tart, tbackend, n_buckets=N_BUCKETS,
                                window=128, chunk_windows=4, device="cpu")
    srv.serve_stream(tingest.replay_source(trace), record_latency=True,
                     latency_samples=32)
    assert srv.latency.max_samples == 32
    assert srv.latency.n == trace.n_packets            # n stays exact
    assert srv.latency.latencies().size == 32


# -- GuardedBackend lifecycle events ------------------------------------------------

def _breaker_episode(faults, bus):
    """One full breaker episode: the first flush times out then errors, the
    second fails twice more -> OPEN, the third is rejected, the fourth is
    the HALF_OPEN probe -> CLOSED. -> the guard."""
    release = threading.Event()
    calls = {"i": 0}

    def backend(rows):
        i = calls["i"]
        calls["i"] += 1
        if i == 0:
            release.wait(5.0)           # abandoned by the 30 ms timeout
        if i in (1, 2, 3):
            raise faults.BackendFault(f"scripted failure {i}")
        return np.zeros(4, np.int32)

    guard = faults.GuardedBackend(
        backend, faults.FaultPolicy(timeout_s=0.03, max_retries=1,
                                    backoff_base_s=0.0, breaker_threshold=2,
                                    breaker_cooldown=1),
        sleep=lambda s: None, events=bus)
    try:
        assert guard(np.zeros((4, 8))) is None         # flush 1: failed
    finally:
        release.set()                   # unstick the abandoned worker
    assert guard(np.zeros((4, 8))) is None             # flush 2: -> OPEN
    assert guard(np.zeros((4, 8))) is None             # flush 3: rejected
    out = guard(np.zeros((4, 8)))                      # flush 4: probe ok
    np.testing.assert_array_equal(out, np.zeros(4, np.int32))
    return guard


def test_breaker_event_sequence_exact():
    bus, jbus = tobs.EventBus(), jobs.EventBus()
    guard = _breaker_episode(tfaults, bus)
    jguard = _breaker_episode(jfaults, jbus)
    assert [e.kind for e in bus.events] == [
        "backend_attempt", "backend_timeout",          # flush 1
        "backend_retry", "backend_attempt", "backend_error",
        "flush_failed",
        "backend_attempt", "backend_error",            # flush 2
        "backend_retry", "backend_attempt", "backend_error",
        "flush_failed", "breaker_open",
        "flush_rejected",                              # flush 3
        "breaker_half_open", "backend_attempt",        # flush 4 (probe)
        "flush_ok", "breaker_close",
    ]
    assert_same_events(bus, jbus)
    assert guard.stats.breaker_opens == guard.stats.breaker_closes == 1
    assert guard.stats.as_dict() == jguard.stats.as_dict()


def test_breaker_events_under_faulty_backend_injection():
    buses = []
    for faults, mod in ((tfaults, tobs), (jfaults, jobs)):
        be = faults.FaultyBackend(lambda rows: np.zeros(len(rows), np.int32),
                                  outages=range(0, 4), seed=0)
        bus = mod.EventBus()
        guard = faults.GuardedBackend(
            be, faults.FaultPolicy(max_retries=1, backoff_base_s=0.0,
                                   breaker_threshold=2, breaker_cooldown=1),
            sleep=lambda s: None, events=bus)
        assert guard(np.zeros((2, 8))) is None         # outages 0,1
        assert guard(np.zeros((2, 8))) is None         # outages 2,3 -> OPEN
        assert guard(np.zeros((2, 8))) is None         # rejected (cooldown)
        assert guard(np.zeros((2, 8))) is not None     # probe succeeds
        kinds = [e.kind for e in bus.events]
        assert kinds.count("breaker_open") == 1
        assert kinds.count("flush_rejected") == 1
        assert kinds.index("breaker_half_open") < kinds.index("breaker_close")
        assert kinds[-1] == "breaker_close"
        buses.append(bus)
    assert_same_events(*buses)


def test_guard_reset_clears_monitor_state_and_emits():
    buses = []
    for faults, mod in ((tfaults, tobs), (jfaults, jobs)):
        bus = mod.EventBus()
        guard = faults.GuardedBackend(
            lambda rows: (_ for _ in ()).throw(faults.BackendFault("down")),
            faults.FaultPolicy(max_retries=0, backoff_base_s=0.0,
                               breaker_threshold=1, breaker_cooldown=2),
            sleep=lambda s: None, events=bus)
        assert guard(np.zeros((2, 8))) is None
        assert guard.stats.breaker_opens == 1
        guard.reset()
        assert guard.state == faults.CLOSED
        assert guard.stats == faults.FaultStats()       # telemetry cleared
        assert guard.consecutive_failures == 0
        assert bus.events[-1].kind == "guard_reset"
        # construction-time reset() emitted nothing (events bound after)
        assert [e.kind for e in bus.events].count("guard_reset") == 1
        buses.append(bus)
    assert_same_events(*buses)


# -- serving-tier wiring: bit identity, rollups, unified snapshot -------------------

PATHS = [{"chunk_windows": 4}, {"flush_every": 1}, {"flush_every": 3}]
PATH_IDS = ["chunked", "per_window", "deferred"]


def _stats_equal(got, ref):
    g, r = got.as_dict(), ref.as_dict()
    for k in ("windows", "packets", "handled", "backend_rows", "deferred",
              "degraded", "flushes", "evicted", "overflow"):
        assert g[k] == r[k], k
    np.testing.assert_allclose(g["conf_sum"], r["conf_sum"], rtol=1e-5)


@pytest.mark.parametrize("path_kw", PATHS, ids=PATH_IDS)
def test_obs_bit_identity_single_device(obs_setup, path_kw):
    """obs on equals obs off bit for bit, and the reference with obs: the
    same predictions, counters, rollup rows and event stream."""
    trace, art, jbackend, tart, tbackend = obs_setup
    kw = dict(n_buckets=N_BUCKETS, window=128, **path_kw)
    ref_preds, ref_stats = StreamingHybridServer(
        tart, tbackend, device="cpu", **kw).serve_trace(trace)
    obs = tobs.Observability(rollup_every=2)
    srv = StreamingHybridServer(tart, tbackend, obs=obs, device="cpu", **kw)
    preds, stats = srv.serve_trace(trace)
    assert torch.equal(preds, ref_preds)
    assert stats.as_dict() == ref_stats.as_dict()
    assert obs.events.counts()["serve_begin"] == 1
    assert obs.rollups.n_rows > 0
    total = sum(r["sums"]["packets"] for r in obs.rollups.rows)
    assert total == stats.n_packets           # deltas reconcile
    jobs_ = jobs.Observability(rollup_every=2)
    jp, js = jserving.StreamingHybridServer(art, jbackend, obs=jobs_,
                                            **kw).serve_trace(trace)
    assert_bit_equal(jp, preds)
    _stats_equal(stats, js)
    assert_same_events(obs.events, jobs_.events)
    _rows_equal(list(obs.rollups.rows), list(jobs_.rollups.rows))


def test_obs_events_with_eviction_and_dribbled_cuts(obs_setup):
    """A paced replay with deadline cuts under a fake clock and the aging
    sweep on: cut, chunk, rollup and eviction events equal the
    reference's, field for field."""
    trace, art, jbackend, tart, tbackend = obs_setup
    kw = dict(n_buckets=N_BUCKETS, window=128, chunk_windows=4,
              evict_age=0.5)
    buses = []
    for mod, ingest, make, be in (
            (tobs, tingest, lambda **k: StreamingHybridServer(
                tart, tbackend, device="cpu", **k), tbackend),
            (jobs, jingest, lambda **k: jserving.StreamingHybridServer(
                art, jbackend, **k), jbackend)):
        state = {"t": 0.0}

        def clock():
            state["t"] += 10.0
            return state["t"]
        obs = mod.Observability(rollup_every=3)
        srv = make(obs=obs, **kw)
        srv.serve_stream(ingest.replay_source(trace, batch=300),
                         deadline=1.0, clock=clock)
        assert srv.ingest_stats.deadline_cuts > 0
        buses.append((obs, srv))
    (obs, srv), (jobs_, jsrv) = buses
    assert obs.events.counts().get("eviction", 0) > 0
    assert_same_events(obs.events, jobs_.events)
    _rows_equal(list(obs.rollups.rows), list(jobs_.rollups.rows))
    assert srv.ingest_stats.as_dict() == jsrv.ingest_stats.as_dict()


def test_obs_snapshot_unifies_server_telemetry(obs_setup):
    trace, art, jbackend, tart, tbackend = obs_setup
    kw = dict(n_buckets=N_BUCKETS, window=128, chunk_windows=4)
    obs = tobs.Observability(rollup_every=2)
    srv = StreamingHybridServer(tart, tbackend, device="cpu", obs=obs,
                                fault_policy=tfaults.FaultPolicy(
                                    max_retries=0), **kw)
    srv.serve_stream(tingest.replay_source(trace), record_latency=True)
    snap = obs.snapshot()
    src = snap["sources"]
    assert src["server.stream"]["packets"] == trace.n_packets
    assert src["server.stream"]["conf_sum"] > 0
    assert 0.0 <= src["server.stream"]["mean_conf"] <= 1.0
    assert src["server.faults"]["flushes_ok"] == srv.fault_stats.flushes_ok
    assert src["server.ingest"]["admitted"] == trace.n_packets
    assert src["server.latency"]["n"] == trace.n_packets
    assert "megastep" in snap["stages"]
    assert "backend_flush" in snap["stages"] and "backpatch" in snap["stages"]
    assert snap["events"]["emitted"] == obs.events.emitted
    assert snap["drift"]["enabled"] and snap["drift"]["alarms"] == []
    # the reference under the same policy: its two-phase route narrates
    # each chunk's back-patch, and so does the port's
    jobs_ = jobs.Observability(rollup_every=2)
    jserving.StreamingHybridServer(
        art, jbackend, obs=jobs_, fault_policy=jfaults.FaultPolicy(
            max_retries=0), **kw).serve_stream(jingest.replay_source(trace))
    assert obs.events.counts()["backpatch"] == srv.stats.n_flushes
    assert_same_events(obs.events, jobs_.events)


def test_obs_degraded_events_under_faults(obs_setup):
    """Seeded flush failures under the guard, chunked and deferred: the
    guard's, the flush's and the degradation's events equal the
    reference's one for one."""
    trace, art, jbackend, tart, tbackend = obs_setup
    policy = dict(max_retries=1, backoff_base_s=0.0, breaker_threshold=3,
                  breaker_cooldown=2)
    for path_kw in ({"chunk_windows": 4}, {"flush_every": 2}):
        kw = dict(n_buckets=N_BUCKETS, window=128, **path_kw)
        obs = tobs.Observability(rollup_every=2)
        srv = StreamingHybridServer(
            tart, tfaults.FaultyBackend(tbackend, error_rate=0.5, seed=3),
            obs=obs, fault_policy=tfaults.FaultPolicy(**policy),
            device="cpu", **kw)
        p, s = srv.serve_trace(trace)
        jobs_ = jobs.Observability(rollup_every=2)
        jp, js = jserving.StreamingHybridServer(
            art, jfaults.FaultyBackend(jbackend, error_rate=0.5, seed=3),
            obs=jobs_, fault_policy=jfaults.FaultPolicy(**policy),
            **kw).serve_trace(trace)
        assert s.n_degraded > 0 and obs.events.counts()["degraded"] > 0
        assert_bit_equal(jp, p)
        _stats_equal(s, js)
        assert_same_events(obs.events, jobs_.events)


def test_obs_stats_as_dict_contract(obs_setup):
    trace, _, _, tart, tbackend = obs_setup
    srv = StreamingHybridServer(tart, tbackend, n_buckets=N_BUCKETS,
                                window=128, chunk_windows=4, device="cpu")
    _, stats = srv.serve_trace(trace)
    d = stats.as_dict()
    assert d["handled"] + d["backend_rows"] + d["deferred"] \
        + d["degraded"] == d["packets"]
    assert d["fraction_handled"] == pytest.approx(stats.fraction_handled)
    assert d["mean_conf"] == pytest.approx(d["conf_sum"] / d["packets"])
    for cls in (tingest.IngestStats, tfaults.FaultStats):
        assert isinstance(cls().as_dict(), dict)
    assert tingest.IngestStats().as_dict().keys() == \
        jingest.IngestStats().as_dict().keys()


def test_obs_sampled_sync_and_stage_timing_bit_identical(obs_setup):
    trace, _, _, tart, tbackend = obs_setup
    kw = dict(n_buckets=N_BUCKETS, window=128, chunk_windows=4,
              device="cpu")
    ref, _ = StreamingHybridServer(tart, tbackend, **kw).serve_trace(trace)
    obs = tobs.Observability(rollup_every=2, sync_every=2)
    srv = StreamingHybridServer(tart, tbackend, obs=obs, **kw)
    preds, _ = srv.serve_trace(trace)
    assert torch.equal(preds, ref)
    assert obs.timer.count("megastep") > 0
    assert obs.timer.count("megastep_synced") > 0
    assert obs.timer.count("ring_cut") > 0 and obs.timer.count("h2d") > 0


def test_obs_drift_fires_on_class_mix_shift_trace(obs_setup):
    """A benign segment then an anomaly-heavy one trips class_mix_shift;
    the stationary replay stays silent; the alarms equal the reference's."""
    from repro.netsim.scenarios import merge_traces
    trace, art, jbackend, tart, tbackend = obs_setup
    kw = dict(n_buckets=N_BUCKETS, window=128, chunk_windows=2)
    drift = dict(baseline_windows=2, mix_l1=0.1)

    obs_flat = tobs.Observability(rollup_every=1,
                                  drift=tobs.DriftConfig(**drift))
    StreamingHybridServer(tart, tbackend, obs=obs_flat, device="cpu",
                          **kw).serve_trace(trace)
    assert not obs_flat.drift.fired, obs_flat.alarms

    shifted = synth_trace(n_flows=300, anomaly_frac=0.95, seed=4)
    shifted = dataclasses.replace(
        shifted, ts=shifted.ts + float(trace.ts.max()) + 1.0)
    both = merge_traces(trace, shifted)
    obs = tobs.Observability(rollup_every=1, drift=tobs.DriftConfig(**drift))
    StreamingHybridServer(tart, tbackend, obs=obs, device="cpu",
                          **kw).serve_trace(both)
    assert "class_mix_shift" in obs.drift.fired_detectors
    assert obs.events.counts().get("drift_alarm", 0) == len(obs.alarms)
    assert obs.snapshot()["counters"]["drift.class_mix_shift"] >= 1
    jobs_ = jobs.Observability(rollup_every=1,
                               drift=jobs.DriftConfig(**drift))
    jserving.StreamingHybridServer(art, jbackend, obs=jobs_,
                                   **kw).serve_trace(both)
    _alarms_equal(obs.alarms, jobs_.alarms)
    assert_same_events(obs.events.of("drift_alarm", "rollup"),
                       jobs_.events.of("drift_alarm", "rollup"))


def test_obs_flush_and_autotune_events(obs_setup):
    """The per-window deferred path narrates its flush lifecycle as the
    reference does, and chunk_windows='auto' records the autotune decision
    (then a cache hit)."""
    trace, art, jbackend, tart, tbackend = obs_setup
    obs = tobs.Observability(rollup_every=4)
    StreamingHybridServer(tart, tbackend, n_buckets=N_BUCKETS, window=128,
                          flush_every=3, obs=obs,
                          device="cpu").serve_trace(trace)
    counts = obs.events.counts()
    assert counts["flush"] >= 1 and counts["backpatch"] >= 1
    triggers = {e.fields["trigger"] for e in obs.events.of("flush")}
    assert triggers and triggers <= {"end_of_stream", "cycle_full"}
    jobs_ = jobs.Observability(rollup_every=4)
    jserving.StreamingHybridServer(art, jbackend, n_buckets=N_BUCKETS,
                                   window=128, flush_every=3,
                                   obs=jobs_).serve_trace(trace)
    assert_same_events(obs.events.of("flush", "backpatch"),
                       jobs_.events.of("flush", "backpatch"))

    tserving.clear_chunk_tune_cache()
    for cached in (False, True):
        obs2 = tobs.Observability()
        srv = StreamingHybridServer(tart, tbackend, n_buckets=N_BUCKETS,
                                    window=128, chunk_windows="auto",
                                    obs=obs2, device="cpu")
        auto = obs2.events.of("autotune")
        assert len(auto) == 1 and auto[0].fields["knob"] == "chunk_windows"
        assert auto[0].fields["chosen"] == srv.chunk_windows
        assert auto[0].fields["cached"] is cached
        if not cached:
            assert auto[0].fields["default"] == \
                tserving.DEFAULT_CHUNK_WINDOWS
            assert auto[0].fields["candidates"] == list(
                tserving.CHUNK_WINDOW_CANDIDATES)
    tserving.clear_chunk_tune_cache()
    obs3 = jobs.Observability()
    jserving.StreamingHybridServer(art, jbackend, n_buckets=N_BUCKETS,
                                   window=128, chunk_windows="auto",
                                   autotune=False, obs=obs3)
    assert set(obs3.events.of("autotune")[0].fields) == \
        set(obs2.events.of("autotune")[0].fields) | {"default",
                                                      "candidates"}


def test_observability_config_and_close(tmp_path):
    with pytest.raises(ValueError):
        tobs.ObsConfig(rollup_every=0)
    with pytest.raises(ValueError):
        tobs.Observability(tobs.ObsConfig(), rollup_every=2)
    path = str(tmp_path / "e.jsonl")
    obs = tobs.Observability(events_path=path, drift_enabled=False)
    assert obs.drift is None and obs.alarms == []
    assert [obs.tick() for _ in range(8)] == [False] * 7 + [True]
    obs.tick()
    assert obs.pending_ticks == 1
    obs.reset_ticks()
    assert obs.pending_ticks == 0
    obs.emit("chunk", windows=1)
    obs.close()
    assert tobs.validate_event_log(path) == 1
    assert not obs.snapshot()["drift"]["enabled"]
