"""The servers' spans and their graphs' phase marks (``obs/profiling.py``).

On the CPU a server serves eagerly, so the graph route runs here through a
stand-in graph: ``_capture`` runs the body once under ``capture_phases``
with aten ops counted in place of device nodes (``OpRecorder``), and its
``replay`` runs the body again into the outputs. The spans, their nesting
and their gate, the order of every body's marks, the capture's threshold
and mode, and the test helper that reads the marks in a trace
(``tests/phase_reader.py``, on a synthetic Kineto trace) are checked here; the marks against real device
nodes are checked on the card (``tests/test_torch_cuda.py``).
"""

import contextlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import harness  # noqa: E402
from repro_torch.analysis import hotpath  # noqa: E402
from repro_torch.analysis.dispatch_utils import OpRecorder  # noqa: E402
from repro_torch.obs import profiling as prof  # noqa: E402
from repro_torch.serving import hybrid_serving, stream_serving  # noqa: E402
from repro_torch.serving.stream_serving import (probe_chunk,  # noqa: E402
                                                probe_window)

from phase_reader import phase_breakdown  # noqa: E402

G = hotpath.PROBE


class _Graph:
    """A captured body's stand-in: ``replay`` runs it again on the same
    carries and input and copies its results into the outputs."""

    def __init__(self, body, carries, static, outs):
        self.body, self.carries, self.static, self.outs = (body, carries,
                                                           static, outs)

    def replay(self):
        for o, n in zip(self.outs, self.body(self.carries, self.static)):
            o.copy_(n)


def _eager_graphs(srv):
    """Serve ``srv`` by the graph route with stand-in graphs; its marks
    count aten ops."""
    def capture(body, carries, static, mode="global"):
        # a capture records the body's work without doing it: run it on
        # copies of the carries
        copies = None if carries is None else carries.clone()
        with OpRecorder() as rec, \
                prof.capture_phases(lambda: len(rec.ops)) as marks:
            outs = body(copies, static)
        return _Graph(body, carries, static, outs), static, outs, \
            marks.result
    srv._capture = capture
    srv._fused_ok = True
    srv._defer_graphs = True
    return srv


def _servers():
    targets = hotpath.build_targets(
        device="cpu", tiers=("HybridServer", "StreamingHybridServer"))
    return {t.label: t.server for t in targets}


def _stream(**kw):
    return stream_serving.StreamingHybridServer(
        hotpath.probe_artifact("cpu"), hotpath.traceable_backend,
        n_buckets=G["n_buckets"], window=G["window"],
        capacity=G["capacity"], threshold=G["threshold"],
        evict_age=G["evict_age"], device="cpu", **kw)


def _batch():
    return hybrid_serving.HybridServer(
        hotpath.probe_artifact("cpu"), hotpath.traceable_backend,
        threshold=G["threshold"], capacity=G["capacity"], device="cpu")


def _x(seed=0):
    rng = np.random.RandomState(seed)
    return torch.as_tensor(rng.rand(G["window"], 8).astype(np.float32)
                           * 1500.0)


def _chunk(seed=0):
    return probe_chunk(G["window"], G["chunk_windows"], G["n_buckets"], seed,
                       device="cpu")


def _window(seed=0):
    return probe_window(G["window"], G["n_buckets"], seed, device="cpu")


def _spans(p):
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in p.events() if e.name.startswith("repro_torch.")]


# -- spans ----------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["batch", "chunk", "window", "deferred"])
def test_entry_spans_nest_under_a_profiler(tier):
    """Under a CPU profiler a graph call opens ``entry`` around ``input``,
    ``replay`` and ``output`` in that order, and its first call
    ``capture`` too; the stand-in graph serves what the eager route
    serves."""
    make = {"batch": _batch, "chunk": lambda: _stream(chunk_windows=4),
            "window": _stream, "deferred": lambda: _stream(flush_every=2)}
    srv, ref = _eager_graphs(make[tier]()), make[tier]()
    call = {"batch": lambda s, i: s.classify(_x(i)),
            "chunk": lambda s, i: s.step_chunk(_chunk(i)),
            "window": lambda s, i: s.step(_window(i)),
            "deferred": lambda s, i: s.step(_window(i))}[tier]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        got = [call(srv, i)[0] for i in range(3)]
    want = [call(ref, i)[0] for i in range(3)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    spans = _spans(p)
    entries = [s for s in spans if s[0] == prof.ENTRY]
    # the deferred route's second window fills its cycle: a flush inside
    assert len(entries) == 3
    for k, (_, t0, t1) in enumerate(entries):
        inner = [s for s in spans if t0 <= s[1] and s[2] <= t1
                 and s[0] != prof.ENTRY]
        names = [n for n, _, _ in sorted(inner, key=lambda s: s[1])]
        steps = [prof.ENTRY_INPUT, prof.ENTRY_REPLAY, prof.ENTRY_OUTPUT]
        want_names = ([prof.ENTRY_CAPTURE] if k == 0 else []) + steps
        if tier == "deferred" and k == 1:
            want_names += [prof.ENTRY_CAPTURE] + steps        # the flush
        assert names == want_names


def test_no_span_opens_without_a_profiler(monkeypatch):
    """With no profiler recording, a served call constructs no
    ``record_function``: the entry's one check, and nothing more."""
    made = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name) or real(name))
    srv = _eager_graphs(_stream(chunk_windows=4))
    batch = _eager_graphs(_batch())
    for i in range(3):
        srv.step_chunk(_chunk(i))
        batch.classify(_x(i))
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        srv.step_chunk(_chunk(3))
    assert made == [prof.ENTRY, prof.ENTRY_INPUT, prof.ENTRY_REPLAY,
                    prof.ENTRY_OUTPUT]


def test_probe_and_eager_routes_have_their_spans():
    """The first call's probe and the two-phase route open ``.probe`` and
    ``.eager`` inside ``entry``."""
    srv = _stream(chunk_windows=4)
    srv._fused_ok = None            # the card's first call
    srv._probe_backend = srv._host_backend
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        srv.step_chunk(_chunk(0))
        srv._fused_ok = False
        srv.step_chunk(_chunk(1))
    names = [n for n, _, _ in sorted(_spans(p), key=lambda s: s[1])]
    assert names == [prof.ENTRY, prof.ENTRY_PROBE, prof.ENTRY,
                     prof.ENTRY_EAGER]


def test_annotation_gate():
    """``annotation`` opens a range only when enabled and a profiler
    records; ``entry_call`` opens the entry's and passes ``traced``."""
    assert not prof.tracing()
    assert isinstance(prof.annotation("x"), type(prof.annotation("y",
                                                                 False)))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        assert prof.tracing()
        assert prof.entry_call(lambda a, traced: (a, traced), 2) == (2, True)
        with prof.annotation("on"):
            pass
        with prof.annotation("off", enabled=False):
            pass
    keys = {e.key for e in p.key_averages()}
    assert {prof.ENTRY, "on"} <= keys and "off" not in keys


@pytest.mark.parametrize("tier", ["StreamingHybridServer",
                                  "ShardedStreamingServer"])
@pytest.mark.parametrize("route", ["eager", "graph"])
def test_classify_is_the_batch_servers_on_every_tier(tier, route):
    """``classify``, inherited from ``HybridServer``, serves the batch step
    on the streaming tiers too (the sharded one at D = 1): the same
    predictions and stats, by the two-phase route and by the graph's."""
    from repro_torch.serving.shard_serving import ShardedStreamingServer
    art = hotpath.probe_artifact("cpu")

    def backend(rows):
        return (rows[:, 0] > 700.0).to(torch.int32)
    kw = dict(threshold=0.9, capacity=G["capacity"], device="cpu")
    with hotpath.own_group():
        if tier == "ShardedStreamingServer":
            mesh, _ = hotpath._default_mesh(torch.device("cpu"))
            srv = ShardedStreamingServer(art, backend, mesh=mesh,
                                         n_buckets=G["n_buckets"],
                                         window=G["window"], **kw)
        else:
            srv = stream_serving.StreamingHybridServer(
                art, backend, n_buckets=G["n_buckets"], window=G["window"],
                **kw)
        ref = hybrid_serving.HybridServer(art, backend, **kw)
        if route == "graph":
            srv, ref = _eager_graphs(srv), _eager_graphs(ref)
        for i in range(3):
            pred, stats = srv.classify(_x(i))
            want, want_stats = ref.classify(_x(i))
            assert isinstance(stats, hybrid_serving.HybridStats)
            assert torch.equal(pred, want)
            assert stats.fraction_handled == want_stats.fraction_handled
            assert stats.backend_rows == want_stats.backend_rows
            assert stats.capacity == want_stats.capacity
        assert 0 < stats.backend_rows < G["window"]


class _FakeStream:
    def __init__(self, *a, **k):
        pass

    def wait_stream(self, other):
        pass


class _FakeGraph:
    def replay(self):
        pass


@pytest.mark.parametrize("tier,mode", [("batch", "global"),
                                       ("chunk", "thread_local"),
                                       ("window", "thread_local")])
def test_capture_runs_at_the_threshold_in_its_mode(tier, mode, monkeypatch):
    """``_capture`` fills the threshold before the warm-up, so the warm-up
    and the capture both run at it (a stale ``_tau`` would dispatch other
    rows); the batch graph is captured in ``global`` mode, the step
    graphs, beside ``serve_stream``'s prefetch thread, in
    ``thread_local``. CUDA's streams and graph are stand-ins here."""
    modes = []

    @contextlib.contextmanager
    def graph(g, capture_error_mode="global"):
        modes.append(capture_error_mode)
        yield
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(hybrid_serving, "capture_phases",
                        lambda: prof.capture_phases(lambda: 0))
    srv = {"batch": _batch, "chunk": lambda: _stream(chunk_windows=4),
           "window": _stream}[tier]()
    srv._fused_ok = True
    srv._tau.fill_(0.0)                         # stale
    seen = []
    attr = {"batch": "_step", "chunk": "_chunk_step",
            "window": "_window_step"}[tier]
    body = getattr(srv, attr)

    def spy(*args):
        seen.append(float(srv._tau))
        return body(*args)
    monkeypatch.setattr(srv, attr, spy)
    {"batch": lambda: srv.classify(_x()),
     "chunk": lambda: srv.step_chunk(_chunk()),
     "window": lambda: srv.step(_window())}[tier]()
    assert seen == [pytest.approx(G["threshold"])] * 2  # warm-up, capture
    assert modes == [mode]


# -- phase marks ----------------------------------------------------------------

def test_phase_returns_at_once_outside_a_capture():
    prof.phase("switch")                   # no recorder open: nothing kept
    counts = iter(range(10))
    with prof.capture_phases(lambda: next(counts)) as marks:
        prof.phase("a")                    # 0
        prof.phase("b")                    # 1
    assert marks.result == (("a", 1), ("b", 1))      # closed at 2
    counts = iter([3, 5, 9])
    with prof.capture_phases(lambda: next(counts)) as marks:
        prof.phase("a")
        prof.phase("b")
    assert marks.result == (("unmarked", 3), ("a", 2), ("b", 4))
    with pytest.raises(RuntimeError):
        with prof.capture_phases(lambda: 0) as marks:
            raise RuntimeError("a failed capture keeps no marks")
    assert marks.result is None


BODIES = {
    "_step": ("switch", "dispatch", "backend", "combine"),
    "_chunk_step": ("register", "switch", "dispatch", "backend", "combine"),
    "_window_step": ("register", "switch", "dispatch", "backend", "combine"),
    "_deferred_step": ("register", "switch", "dispatch"),
    "_flush_step": ("backend", "combine"),
}


def _record(srv, row, monkeypatch):
    """Run a contracted body under ``capture_phases`` with aten ops for
    device nodes. -> (marks, ops, where B1 and the register half ran as
    aten-op ranges)."""
    calls = {}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **k):
            start = len(rec.ops)
            out = real(*a, **k)
            calls.setdefault(key, []).append((start, len(rec.ops)))
            return out
        monkeypatch.setattr(mod, name, wrapped)

    spy(hybrid_serving, "fused_classify", "b1")
    spy(stream_serving, "fused_classify", "b1")
    spy(stream_serving, "chunk_update_readout", "register")
    spy(stream_serving, "window_update_readout", "register")
    inp = {"batch": lambda: _x(), "chunk": _chunk, "window": _window,
           "defer": _window, "flush": lambda: None}[row["probe"]]()
    with OpRecorder() as rec, \
            prof.capture_phases(lambda: len(rec.ops)) as marks:
        if row["probe"] == "batch":
            getattr(srv, row["attr"])(inp, srv._tau)
        else:
            getattr(srv, row["attr"])(srv._carries(), inp)
    return marks.result, rec.ops, calls


def _phase_of(marks, span):
    """The phase whose nodes hold the op range ``span``."""
    i = 0
    for name, n in marks:
        if i <= span[0] and span[1] <= i + n:
            return name
        i += n
    return None


@pytest.mark.parametrize("label", [
    "HybridServer._step", "StreamingHybridServer._window_step",
    "StreamingHybridServer[chunked]._chunk_step",
    "StreamingHybridServer[deferred]._deferred_step",
    "StreamingHybridServer[deferred]._flush_step"])
def test_each_body_marks_its_phases_in_order(label, monkeypatch):
    """Every captured body marks its phases in the order of its work and
    leaves no node unmarked; the switch kernel's call falls in ``switch``
    and the register half's in ``register``."""
    srv = _servers()[label]
    row = next(r for r in type(srv).AUDIT_CONTRACTS
               if r["attr"] == label.rsplit(".", 1)[1])
    marks, ops, calls = _record(srv, row, monkeypatch)
    assert tuple(n for n, _ in marks) == BODIES[row["attr"]]
    assert sum(n for _, n in marks) == len(ops)
    assert all(n > 0 for name, n in marks if name != "backend")
    for span in calls.get("b1", []):
        assert _phase_of(marks, span) == "switch"
    for span in calls.get("register", []):
        assert _phase_of(marks, span) == "register"
    assert ("b1" in calls) == ("switch" in BODIES[row["attr"]])
    assert ("register" in calls) == ("register" in BODIES[row["attr"]])


def test_sharded_bodies_mark_their_phases(monkeypatch):
    """The sharded tier's switch halves (D = 1, a one-rank gloo group) mark
    the same phases as the single-device server's."""
    with hotpath.own_group():
        targets = hotpath.build_targets(
            device="cpu", tiers=("ShardedStreamingServer",))
        for t in targets:
            if not t.row.get("graph"):
                continue
            marks, ops, _ = _record(t.server, t.row, monkeypatch)
            assert tuple(n for n, _ in marks) == BODIES[t.row["attr"]], \
                t.label
            assert sum(n for _, n in marks) == len(ops)


def test_graph_phases_keyed_as_the_graphs():
    srv = _eager_graphs(_stream(flush_every=2))
    for i in range(2):
        srv.step(_window(i))
    srv.classify(_x())
    phases = srv.graph_phases()
    assert set(phases) == set(srv._step_graphs) | set(srv._graphs)
    assert [n for n, _ in phases[("defer", (G["window"],))]] == \
        list(BODIES["_deferred_step"])
    assert [n for n, _ in phases[("flush", tuple(srv._dd.buf.shape))]] == \
        list(BODIES["_flush_step"])
    assert [n for n, _ in phases[(G["window"], 8)]] == list(BODIES["_step"])
    srv.release_graphs()
    assert srv.graph_phases() == {}


# -- reading a trace --------------------------------------------------------------

def _x_event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


MARKS = {("chunk", (4, 32)): (("switch", 1), ("dispatch", 2),
                              ("backend", 1), ("combine", 1))}


def _trace(graph_ops=5):
    """Two requests in the harness's spans: the entry's fill and copy in
    ``input``, one graph launch, a clone in ``output``; the harness's
    own copy after each, launched outside every program span."""
    ev = []
    for r, base in enumerate((0.0, 1000.0)):
        c = 10 * r
        ev += [
            _x_event("user_annotation", harness.SPAN_CALL, base + 100, 100),
            _x_event("user_annotation", prof.ENTRY, base + 101, 98),
            _x_event("user_annotation", prof.ENTRY_INPUT, base + 102, 8),
            _x_event("user_annotation", prof.ENTRY_REPLAY, base + 111, 9),
            _x_event("user_annotation", prof.ENTRY_OUTPUT, base + 121, 9),
            _x_event("cuda_runtime", "cudaLaunchKernel", base + 103, 1,
                     correlation=c + 1),
            _x_event("cuda_runtime", "cudaMemcpyAsync", base + 105, 1,
                     correlation=c + 2),
            _x_event("cuda_runtime", "cudaGraphLaunch", base + 112, 2,
                     correlation=c + 3),
            _x_event("cuda_runtime", "cudaMemcpyAsync", base + 122, 1,
                     correlation=c + 4),
            _x_event("cuda_runtime", "cudaMemcpyAsync", base + 205, 1,
                     correlation=c + 5),
            _x_event("kernel", "fill", base + 110, 2, correlation=c + 1),
            _x_event("gpu_memcpy", "Memcpy DtoD", base + 112, 2,
                     correlation=c + 2),
            _x_event("gpu_memcpy", "Memcpy DtoD", base + 161, 2,
                     correlation=c + 4),
            _x_event("gpu_memcpy", "Memcpy DtoH", base + 210, 2,
                     correlation=c + 5),
        ]
        spans = [(120, 5, "b1"), (126, 4, "cmp"), (131, 9, "sort"),
                 (141, 1, "walk"), (150, 10, "patch"), (160.5, 0.25, "x")]
        for ts, dur, name in spans[:graph_ops]:
            ev.append(_x_event("kernel", name, base + ts, dur,
                               correlation=c + 3))
    return ev


def test_phase_breakdown_splits_replays_by_their_marks():
    out = phase_breakdown(_trace(), MARKS)
    assert out["replays"] == 2
    assert out["phases"] == pytest.approx(
        {"switch": 10e-6, "dispatch": 26e-6, "backend": 2e-6,
         "combine": 20e-6})
    want = {"switch": {"b1": (2, 10e-6)},
            "dispatch": {"cmp": (2, 8e-6), "sort": (2, 18e-6)},
            "backend": {"walk": (2, 2e-6)}, "combine": {"patch": (2, 20e-6)}}
    assert out["phase_ops"].keys() == want.keys()
    for ph, ops in want.items():
        assert out["phase_ops"][ph] == {k: pytest.approx(v)
                                        for k, v in ops.items()}
    assert out["entry_copy_ops"] == 6
    assert out["entry_copies_s"] == pytest.approx(12e-6)
    assert out["outside_ops"] == 2
    assert out["outside_s"] == pytest.approx(4e-6)
    busy = (sum(out["phases"].values()) + out["entry_copies_s"]
            + out["entry_other_s"] + out["outside_s"])
    assert busy == pytest.approx(out["busy_s"])


def test_phase_breakdown_keeps_the_harness_busy_time_and_gap_sum():
    """The reader's busy time and idle-gap sum are the harness's; the gaps
    inside the harness's call take the program's innermost span."""
    events = _trace()
    old = harness.read_trace(events, 1e-3)
    new = phase_breakdown(events, MARKS)
    assert new["busy_s"] == old["busy_s"]
    assert sum(new["idle_gaps"].values()) == pytest.approx(
        sum(v for _, v in old["idle_gaps"]), rel=1e-12)
    # a request's gaps: 114 -> 120 while the host replays, 125 -> 126 in
    # the output span, the rest in the entry; 212 -> 1110 in no span
    assert new["idle_gaps"] == pytest.approx(
        {prof.ENTRY_REPLAY: 12e-6, prof.ENTRY_OUTPUT: 2e-6,
         prof.ENTRY: 116e-6, "other": 898e-6})
    assert harness.SPAN_CALL not in new["idle_gaps"]
    assert json.dumps(new)                  # plain numbers and names


def test_phase_breakdown_raises_on_a_count_mismatch():
    with pytest.raises(ValueError, match=r"ran 6 device ops.*\[5\]"):
        phase_breakdown(_trace(graph_ops=6), MARKS)
    two = dict(MARKS, other=(("switch", 5),))
    with pytest.raises(ValueError, match="more than one layout"):
        phase_breakdown(_trace(), two)
