"""Streaming hybrid serving: the always-on switch, one window or one
chunk of windows at a time.

Port of ``repro/serving/stream_serving.py``. ``StreamingHybridServer``
extends ``HybridServer`` with the register-file carry of ``netsim.stream``:
each ``step(window)`` runs

  register update        the window folded into the (8, N) register file
                         (the B5 kernel on the card, in place)
  aging sweep            idle buckets reset through the B6 kernel, when
                         ``evict_age`` is set
  feature read-out       the updated rows of the window's touched flows
                         (per packet, as a switch classifies each arriving
                         packet with its flow's registers)
  fused switch classify  the table pipeline (the B1 kernel)
  capacity-bounded dispatch -> backend -> combine
  telemetry fold         ``StreamStats`` carried as 0-dim device tensors

Device-resident chunked streaming (``chunk_windows=K``): ``serve_trace``
stacks K windows into one (K, W) ``PacketChunk`` and ``step_chunk`` serves
it as one step: the register half K times in order (``chunk_update_
readout``: B5, and B6's sweep, once a window), then ONE classify over the
K*W rows, one dispatch of every window (``chunk_dispatch``), ONE backend
call over the chunk's K*capacity rows and the back-patch of its answers
into the chunk's predictions. The predictions, the flow table and every
counter equal the per-window path's bit for bit (``flushes`` counts one
backend call a chunk; ``conf_sum`` sums in another order). ``"auto"``
picks K by a measured sweep that never picks a K slower than
``DEFAULT_CHUNK_WINDOWS``.

Cross-window deferral (``flush_every=k``, DESIGN.md §7): ``step`` runs the
switch half and writes the window's dispatched rows into a
``DeferredDispatch`` buffer of k*capacity rows (``defer_window``) and its
provisional predictions into a (k, W) pending set; the backend runs once
per flush over the whole buffer and its answers are back-patched into the
pending windows. A flush comes when the cycle is full, or earlier on
``flush_occupancy`` or ``flush_deadline`` (each costs one host sync a
step, as in the reference), or on ``flush()``; its result waits in a FIFO
for ``consume_flush()``. ``flush_every=1`` is the per-window path, the
equivalence oracle: final predictions equal it bit for bit.

Faults (``fault_policy``): the backend call goes through a
``serving.faults.GuardedBackend`` (timeout, retries with backoff, circuit
breaker), which forces the eager two-phase route. When a flush ultimately
fails the tier degrades: the dispatched rows keep their switch answers
and are counted in ``StreamStats.degraded`` (per window, per deferral
cycle, or per chunk, whose optimistic backend fold is retracted).

Carries and graphs. The register file, the ``StreamStats`` tensors, the
deferral buffer and the pending set are the server's carries: every step
writes them in place (B5 and B6's sweep already do; the stats fold copies
into them; ``defer_window`` and the pending write use ``index_copy_`` at a
row index computed on the device; a flush zeroes the buffer and refills
the pending set with -1), so ``state`` reads the live register file (read
it, don't keep it) and ``stats`` a snapshot. On the card (``fuse=None``,
as in ``HybridServer``) the first call of the backend probes whether it
syncs the host; if it does not, each step shape is captured once as a
CUDA graph that owns static input buffers and updates the carries in
place, and every later call copies its window or chunk in and replays it:
the counterpart of the reference's jitted, donating ``_stream_step``,
``_chunk_step`` and ``_flush_fused``. The deferred step calls no backend,
so with ``fuse`` not False it is always a graph (one a window shape); the
cycle slot it writes is a device scalar filled before each replay, as the
threshold is. The flush is a second graph, keyed by the buffer's shape;
the first flush is usually the backend's first call, so the probe runs
there. The warm-up before each capture runs on copies of the carries, so
it advances nothing. A backend that syncs is served eagerly in two phases
(switch half, backend, then the fold or the back-patch), as the
reference's ``_stream_switch`` / ``_chunk_switch`` / ``_flush_patch``
routes do. ``step``, ``step_chunk`` and ``flush`` may be mixed: the graphs
read and write the same carries, and ``reset()`` refills them in place.
Nothing in a step waits on the device unless a flush trigger asks for it.

Open-ended ingest (DESIGN.md §13): ``serve_stream(source)`` is the primary
serving loop, a pull-based pipeline over ``netsim.ingest``'s ring buffer
(count / deadline window-granular cuts; on the chunked path a prefetch
thread whose copies run on a side CUDA stream from pinned buffers; the
per-packet admit->prediction latency recorder). ``serve_trace`` is its
finite-replay wrapper, equal bit for bit to driving ``iter_chunks`` through
``step_chunk`` (or ``iter_windows`` through ``step``) by hand.
Predictions come back as one tensor on the server's device.

Observability (``obs``, DESIGN.md §14): lifecycle events (cuts, chunks,
windows, flushes, back-patches, degradations, the guard's attempts and
breaker, the chunk autotune's decision), stage timers, a rollup window
every ``rollup_every`` dispatches (the loop's one stats read) and the drift
monitors over it. As in ``HybridServer``, ``use_kernel`` picks the kernels
or their plain versions (the reference's ``use_pallas``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core.artifact import TableArtifact
from repro_torch.device import resolve_device
from repro_torch.core.hybrid import (DeferredDispatch, backpatch_pending,
                                     chunk_dispatch, combine, defer_window,
                                     dispatch, init_deferred, zero_deferred_)
from repro_torch.kernels.ops import fused_classify, pred_dtype
from repro_torch.kernels.tuning import (TileConfig, _artifact_key,
                                        measure_min, sweep_best)
from repro_torch.netsim.ingest import (LatencyRecorder, PacketRingBuffer,
                                       PinnedStaging, await_chunk,
                                       cut_stream, prefetch_iter,
                                       replay_source)
from repro_torch.netsim.stream import (EVICT_POLICIES, FLOW_FEATURES,
                                       FlowTableState, PacketChunk,
                                       PacketWindow, chunk_update_readout,
                                       flow_table_readout, init_flow_table,
                                       packet_chunk_from_arrays,
                                       window_update_readout)
from repro_torch.obs import Observability
from repro_torch.obs.profiling import (ENTRY_CAPTURE, ENTRY_EAGER,
                                       ENTRY_PROBE, annotation, entry_call,
                                       phase, tracing)
from repro_torch.serving.faults import FaultPolicy, FaultStats, GuardedBackend
from repro_torch.serving.hybrid_serving import HybridServer, HybridStats

_NULL = contextlib.nullcontext()

_COUNTERS = ("windows", "packets", "handled", "backend_rows", "deferred",
             "degraded", "flushes", "evicted", "overflow")


@dataclasses.dataclass
class StreamStats:
    """Running telemetry over all windows served — 0-dim device tensors.

    Built and updated on the device; reading any Python-typed property
    below is the only point that syncs, as with ``HybridStats``.
    """
    windows: torch.Tensor        # i32: windows served
    packets: torch.Tensor        # i32: valid packets seen
    handled: torch.Tensor        # i32: answered at the switch tier
    backend_rows: torch.Tensor   # i32: rows the backend actually served
    deferred: torch.Tensor       # i32: low-confidence rows past capacity that
                                 #      never reached the backend (switch
                                 #      answer kept)
    degraded: torch.Tensor       # i32: dispatched rows whose backend flush
                                 #      ultimately failed under a fault
                                 #      policy (switch answer kept)
    flushes: torch.Tensor        # i32: successful backend invocations (one
                                 #      a window at flush_every=1, one a
                                 #      flush or a chunk otherwise)
    evicted: torch.Tensor        # i32: buckets recycled by the aging sweep
    overflow: torch.Tensor       # i32: register slots newly saturated at 2^24
    conf_sum: torch.Tensor       # f32: switch confidence summed over valid
                                 #      lanes (mean_conf = conf_sum / packets)

    @classmethod
    def zero(cls, device) -> "StreamStats":
        z = lambda: torch.zeros((), dtype=torch.int32, device=device)
        return cls(**{k: z() for k in _COUNTERS},
                   conf_sum=torch.zeros((), dtype=torch.float32,
                                        device=device))

    def _tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def clone(self) -> "StreamStats":
        """A snapshot on the device (no sync)."""
        return StreamStats(*(t.clone() for t in self._tensors()))

    def copy_(self, other: "StreamStats") -> "StreamStats":
        """Write ``other``'s values into these tensors in place (what a
        captured step does to its carries). Returns self."""
        for dst, src in zip(self._tensors(), other._tensors()):
            dst.copy_(src)
        return self

    def zero_(self) -> "StreamStats":
        for t in self._tensors():
            t.zero_()
        return self

    @property
    def n_windows(self) -> int:
        return int(self.windows)

    @property
    def n_packets(self) -> int:
        return int(self.packets)

    @property
    def n_handled(self) -> int:
        """Packets answered confidently at the switch tier."""
        return int(self.handled)

    @property
    def fraction_handled(self) -> float:
        n = int(self.packets)
        return float(self.handled) / n if n else 0.0

    @property
    def total_backend_rows(self) -> int:
        return int(self.backend_rows)

    @property
    def n_deferred(self) -> int:
        """Low-confidence rows that overflowed the dispatch capacity and
        kept the switch answer; nonzero means the stream wants a larger
        ``capacity``."""
        return int(self.deferred)

    @property
    def n_degraded(self) -> int:
        return int(self.degraded)

    @property
    def n_flushes(self) -> int:
        return int(self.flushes)

    @property
    def n_evicted(self) -> int:
        """Buckets recycled by the aging sweep (0 when eviction is off)."""
        return int(self.evicted)

    @property
    def n_overflow(self) -> int:
        """Register slots that hit the 2^24 exactness envelope."""
        return int(self.overflow)

    @property
    def total_conf(self) -> float:
        """Switch confidence summed over all valid packets."""
        return float(self.conf_sum)

    @property
    def mean_conf(self) -> float:
        """Mean switch confidence per valid packet."""
        n = int(self.packets)
        return float(self.conf_sum) / n if n else 0.0

    def as_dict(self) -> dict:
        """Host-side snapshot (syncs every counter): the additive counters,
        then the two derived ratios."""
        return {"windows": self.n_windows, "packets": self.n_packets,
                "handled": self.n_handled,
                "backend_rows": self.total_backend_rows,
                "deferred": self.n_deferred, "degraded": self.n_degraded,
                "flushes": self.n_flushes, "evicted": self.n_evicted,
                "overflow": self.n_overflow, "conf_sum": self.total_conf,
                "fraction_handled": self.fraction_handled,
                "mean_conf": self.mean_conf}

    def check(self) -> "StreamStats":
        """Raise unless every valid packet was answered exactly once:

            handled + backend_rows + deferred + degraded == packets

        Reading the counters syncs. Returns self."""
        n = (self.n_handled + self.total_backend_rows + self.n_deferred
             + self.n_degraded)
        if n != self.n_packets:
            raise AssertionError(
                f"StreamStats accounting invariant violated: "
                f"handled={self.n_handled}"
                f" + backend_rows={self.total_backend_rows}"
                f" + deferred={self.n_deferred}"
                f" + degraded={self.n_degraded} = {n}"
                f" != packets={self.n_packets}")
        return self

    def __repr__(self):
        return (f"StreamStats(windows={self.n_windows}, "
                f"packets={self.n_packets}, "
                f"fraction_handled={self.fraction_handled:.3f}, "
                f"backend_rows={self.total_backend_rows}, "
                f"deferred={self.n_deferred}, degraded={self.n_degraded}, "
                f"flushes={self.n_flushes}, "
                f"evicted={self.n_evicted}, overflow={self.n_overflow})")


def _count(mask: torch.Tensor) -> torch.Tensor:
    return mask.sum(dtype=torch.int32)


def _fold_conf(conf, valid) -> torch.Tensor:
    """Valid-lane confidence sum (f32 scalar) for the conf_sum fold."""
    return torch.where(valid, conf, 0.0).to(torch.float32).sum()


def accumulate_deferred_stats(stats: StreamStats, w: PacketWindow, fwd,
                              valid, conf, n_evicted, n_overflow):
    """The window fold without the backend accounting: everything but
    ``backend_rows``/``degraded`` and ``flushes``, which fold when the
    backend runs (or fails). Forwarded rows past capacity land in
    ``deferred``. Returns (stats, frac_handled, rows), rows the window's
    dispatched rows."""
    n_valid = _count(w.valid)
    n_handled = _count(w.valid & ~fwd)
    rows = _count(valid)
    frac = (n_handled.to(torch.float32)
            / torch.clamp(n_valid, min=1).to(torch.float32))
    stats = dataclasses.replace(
        stats, windows=stats.windows + 1,
        packets=stats.packets + n_valid,
        handled=stats.handled + n_handled,
        deferred=stats.deferred + (_count(fwd) - rows),
        evicted=stats.evicted + n_evicted,
        overflow=stats.overflow + n_overflow,
        conf_sum=stats.conf_sum + _fold_conf(conf, w.valid))
    return stats, frac, rows


def _served(stats: StreamStats, rows) -> StreamStats:
    """One successful backend call served ``rows`` rows."""
    return dataclasses.replace(stats, backend_rows=stats.backend_rows + rows,
                               flushes=stats.flushes + 1)


def _degraded(stats: StreamStats, rows) -> StreamStats:
    """A failed backend call: its ``rows`` rows keep the switch's answers;
    ``flushes`` counts successful calls only."""
    return dataclasses.replace(stats, degraded=stats.degraded + rows)


def accumulate_stream_stats(stats: StreamStats, w: PacketWindow, sw_pred,
                            be_pred, idx, valid, fwd, conf, n_evicted,
                            n_overflow):
    """The step's epilogue: combine the backend's answers, mark pad lanes
    -1, fold this window into the running StreamStats. The backend ran for
    this window, so ``flushes`` advances by one; forwarded rows past
    capacity land in ``deferred``. Returns (stats, pred, frac_handled,
    backend_rows), all device tensors."""
    pred = combine(sw_pred, be_pred, idx, valid)
    pred = torch.where(w.valid, pred, -1)                # pad lanes
    stats, frac, rows = accumulate_deferred_stats(stats, w, fwd, valid, conf,
                                                  n_evicted, n_overflow)
    return _served(stats, rows), pred, frac, rows


def degrade_window_stats(stats: StreamStats, w: PacketWindow, sw_pred, fwd,
                         valid, conf, n_evicted, n_overflow):
    """The per-window epilogue when the window's guarded backend call
    ultimately failed: every dispatched row keeps its switch prediction
    and is counted in ``degraded``, not ``backend_rows``; ``flushes`` does
    not advance. Returns (stats, pred, frac_handled, rows_degraded)."""
    pred = torch.where(w.valid, sw_pred, -1)             # pad lanes
    stats, frac, rows = accumulate_deferred_stats(stats, w, fwd, valid, conf,
                                                  n_evicted, n_overflow)
    return _degraded(stats, rows), pred, frac, rows


def fold_flush_stats(stats: StreamStats, dd: DeferredDispatch) -> StreamStats:
    """One backend flush served every live slot of the deferral buffer."""
    return _served(stats, _count(dd.valid))


def fold_degraded_flush(stats: StreamStats,
                        dd: DeferredDispatch) -> StreamStats:
    """The flush fold when the backend ultimately failed: the cycle's rows
    keep their provisional switch predictions (no back-patch) and land in
    ``degraded``."""
    return _degraded(stats, _count(dd.valid))


def degrade_chunk_stats(stats: StreamStats,
                        dd: DeferredDispatch) -> StreamStats:
    """The corrective fold of a failed chunk flush: ``accumulate_chunk_
    stats`` folds the chunk's backend accounting in the switch half,
    before the backend runs; when the guarded call then fails, move its
    rows to ``degraded`` and retract the optimistic flush."""
    rows = _count(dd.valid)
    return dataclasses.replace(
        stats, backend_rows=stats.backend_rows - rows,
        degraded=stats.degraded + rows, flushes=stats.flushes - 1)


def defer_tail(stats, dd, pending, w: PacketWindow, sw_pred, fwd, buf, idx,
               valid, conf, counts, pos):
    """The deferred step's tail: mark pad lanes -1, write the window's
    dispatched rows into the deferral buffer at cycle slot ``pos``
    (``defer_window``) and its provisional predictions into row ``pos`` of
    the pending set, and fold the stats without the backend accounting.
    ``dd`` and ``pending`` are written in place; ``pos`` is a 0-dim device
    tensor (or a Python int from a CPU caller).
    Returns (stats, dd, pending, pred, frac, rows)."""
    pred = torch.where(w.valid, sw_pred, -1)             # pad lanes
    defer_window(dd, buf, idx, valid, pos)
    slot = torch.as_tensor(pos, device=pending.device).reshape(1).long()
    pending.index_copy_(0, slot, pred[None].to(pending.dtype))
    stats, frac, rows = accumulate_deferred_stats(stats, w, fwd, valid, conf,
                                                  *counts)
    return stats, dd, pending, pred, frac, rows


def accumulate_chunk_stats(stats: StreamStats, chunk: PacketChunk, fwd,
                           dd: DeferredDispatch, conf, n_evicted,
                           n_overflow):
    """Whole-chunk stats fold: the per-window telemetry summed over the
    (K, W) chunk in one pass (dead windows contribute no valid lanes and
    are not counted as windows), plus the backend accounting of the
    chunk's single backend call (one flush a chunk).
    Returns (stats, frac_handled, backend_rows)."""
    n_valid = _count(chunk.valid)
    n_handled = _count(chunk.valid & ~fwd)
    n_fwd = _count(fwd)
    rows = _count(dd.valid)
    live = _count(chunk.valid.any(dim=1))
    frac = (n_handled.to(torch.float32)
            / torch.clamp(n_valid, min=1).to(torch.float32))
    stats = dataclasses.replace(
        stats, windows=stats.windows + live,
        packets=stats.packets + n_valid,
        handled=stats.handled + n_handled,
        backend_rows=stats.backend_rows + rows,
        deferred=stats.deferred + (n_fwd - rows),
        flushes=stats.flushes + 1,
        evicted=stats.evicted + n_evicted,
        overflow=stats.overflow + n_overflow,
        conf_sum=stats.conf_sum + _fold_conf(conf, chunk.valid))
    return stats, frac, rows


def chunk_classify_tail(art, stats, chunk: PacketChunk, xs, n_ev, n_ov,
                        threshold, capacity: int, *, tiles, device,
                        classify=None):
    """The batched half of the chunk step, after the register half produced
    the (K, W, 8) readout rows: ONE fused classify over the K*W rows, the
    dispatch of every window, the whole-chunk stats fold, and the pending
    predictions (pad and dead lanes at -1). Equal to K per-window passes
    because every op is row-independent. ``classify(rows) -> (pred, conf)``
    replaces the fused classify (the sharded tier's partitioned one).
    Returns (stats, dd, pending, frac, rows)."""
    k, w_lanes, nf = xs.shape
    rows_in = xs.reshape(k * w_lanes, nf)
    phase("switch")
    sw_pred, conf = (fused_classify(art, rows_in, tiles=tiles, device=device)
                     if classify is None else classify(rows_in))
    phase("dispatch")
    sw_pred = sw_pred.reshape(k, w_lanes)
    conf = conf.reshape(k, w_lanes)
    fwd = (conf < threshold) & chunk.valid
    dd = chunk_dispatch(xs, fwd, capacity)
    stats, frac, rows = accumulate_chunk_stats(stats, chunk, fwd, dd, conf,
                                               n_ev, n_ov)
    pending = torch.where(chunk.valid, sw_pred, -1)        # pad/dead lanes
    return stats, dd, pending, frac, rows


# -- chunk-size autotune ---------------------------------------------------

DEFAULT_CHUNK_WINDOWS = 16
CHUNK_WINDOW_CANDIDATES = (4, 8, 16, 32)

_CHUNK_TUNE_CACHE: dict = {}


def clear_chunk_tune_cache() -> None:
    _CHUNK_TUNE_CACHE.clear()


def probe_chunk(window: int, k: int, n_buckets: int, seed: int = 0, *,
                device=None) -> PacketChunk:
    """Synthetic all-valid (k, window) chunk for timing sweeps, the
    reference's draws: uniform bucket ids (realistic scatter conflicts),
    monotone timestamps, in-distribution lengths. device=None: CUDA."""
    rng = np.random.RandomState(seed)
    n = k * window
    shp = (k, window)
    return packet_chunk_from_arrays(
        rng.randint(0, n_buckets, n).astype(np.int32).reshape(shp),
        np.linspace(0.0, 1.0, n, dtype=np.float32).reshape(shp),
        rng.uniform(60.0, 1500.0, n).astype(np.float32).reshape(shp),
        (rng.rand(n) < 0.5).astype(np.float32).reshape(shp),
        np.ones(shp, bool), device=device)


def probe_window(window: int, n_buckets: int, seed: int = 0, *,
                 device=None) -> PacketWindow:
    """Synthetic all-valid window, the 1D sibling of ``probe_chunk``."""
    return probe_chunk(window, 1, n_buckets, seed, device=device).window_at(0)


def autotune_chunk_windows(make_server, *, window: int, n_buckets: int,
                           candidates=CHUNK_WINDOW_CANDIDATES,
                           default: int = DEFAULT_CHUNK_WINDOWS,
                           candidate_filter=None, reps: int = 3,
                           seed: int = 0, cache_key=None, time_fn=None,
                           verbose: bool = False, events=None) -> int:
    """Measured K sweep at server init: pick ``chunk_windows``.

    ``make_server(k)`` builds a throwaway server for chunk size k; each
    candidate is timed (``kernels.tuning.measure_min``: the warm-up call
    absorbs the probe and the graph capture) on one synthetic
    ``probe_chunk`` and scored per *packet*, so different Ks compete
    fairly. The ``default`` is always timed and the winner is the measured
    argmin over a set containing it (``kernels.tuning.sweep_best``), so the
    sweep never picks a K slower than the default on the tuned shape.
    ``candidate_filter`` drops the Ks a configuration cannot use (the
    sharded tier's per-device backend slices); when it rejects the default,
    the first surviving candidate takes the default's role.
    ``time_fn(k) -> seconds`` replaces the measurement (deterministic
    tests); ``verbose`` prints each candidate's time as it is taken;
    ``cache_key`` memoizes the winner and the timings. Each
    throwaway server's graphs are freed once it is timed. ``events`` (an
    ``obs`` ``EventBus``) gets one ``autotune`` event, on a cache hit as on
    a decision.

    The probes call the real ``backend_fn``: a *stateful* backend sees
    those extra calls, so pair "auto" with a stateless backend.
    """
    if cache_key is not None:
        hit = _CHUNK_TUNE_CACHE.get(cache_key)
        if hit is not None:
            if events is not None:
                events.emit("autotune", knob="chunk_windows", chosen=hit[0],
                            cached=True)
            return hit[0]
    cands = [k for k in candidates
             if candidate_filter is None or candidate_filter(k)]
    if candidate_filter is not None and not candidate_filter(default):
        if not cands:
            raise ValueError(
                "no chunk_windows candidate satisfies this configuration "
                f"(candidates={tuple(candidates)})")
        default = cands[0]

    def time_k(k: int) -> float:
        if time_fn is not None:
            return float(time_fn(k)) / (k * window)
        srv = make_server(k)
        try:
            chunk = probe_chunk(window, k, n_buckets, seed,
                                device=srv.device)
            sync = (torch.cuda.synchronize if srv.device.type == "cuda"
                    else (lambda: None))

            def one():
                srv.step_chunk(chunk)
                sync()
            return measure_min(one, reps) / (k * window)   # per packet
        finally:
            srv.release_graphs()

    best, timings = sweep_best(cands, time_k, default=default,
                               verbose=verbose, label="chunk-autotune")
    if time_fn is None and torch.cuda.is_available():
        torch.cuda.empty_cache()        # the throwaway servers' graph pools
    if cache_key is not None:
        _CHUNK_TUNE_CACHE[cache_key] = (best, timings)
    if events is not None:
        events.emit("autotune", knob="chunk_windows", chosen=best,
                    default=default, candidates=list(cands),
                    cached=False)
    return best


def chunk_sweep_timings(cache_key):
    """{K: seconds per packet} that the cached sweep under ``cache_key``
    measured, or None when it has not run."""
    hit = _CHUNK_TUNE_CACHE.get(cache_key)
    return None if hit is None else dict(hit[1])


def _clone_input(inp):
    """A window, chunk or deferral buffer with its own copies of the
    tensors."""
    return type(inp)(**{f.name: getattr(inp, f.name).clone()
                        for f in dataclasses.fields(inp)})


def _copy_input(dst, src) -> None:
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


class _Carries(NamedTuple):
    """What a step reads and writes in place: the register file (a
    ``FlowTableState``, or the sharded tier's ``ShardedFlowTable``), the
    stats tensors, and on the deferred path the deferral buffer and the
    pending set (None at flush_every=1)."""
    table: FlowTableState
    stats: StreamStats
    dd: Optional[DeferredDispatch]
    pending: Optional[torch.Tensor]

    def clone(self) -> "_Carries":
        return _Carries(self.table.clone(), self.stats.clone(),
                        None if self.dd is None else _clone_input(self.dd),
                        None if self.pending is None
                        else self.pending.clone())


class StreamingHybridServer(HybridServer):
    """HybridServer over a packet stream with per-flow register state.

    ``window`` is the packet chunk size ``serve_trace`` cuts the trace into;
    ``n_buckets`` sizes the flow register file. The batch ``classify`` of
    the parent stays available.
    """

    # What the analysis gate (``repro_torch.analysis.hotpath``) audits: each
    # body ``_replay_step`` captures ("graph"), called as ``attr(carries,
    # probe)``, and the two-phase route's switch half, called as
    # ``attr(carries, probe, tau)`` ("tau"). ``carries`` names the
    # ``_Carries`` fields the body must write in place, the counterpart of
    # the reference's ``donate``. ``reference`` maps each row to the
    # reference's (``repro/serving/stream_serving.py`` AUDIT_CONTRACTS):
    # ``_window_step`` is its ``_stream_step``, ``_window_switch`` its
    # ``_stream_switch``; the deferred step and the flush, graphs of their
    # own here, have no row there.
    AUDIT_CONTRACTS = (
        {"attr": "_window_step", "reference": "_stream_step",
         "probe": "window", "carries": ("table", "stats"), "graph": True,
         "collectives": {}},
        {"attr": "_window_switch", "reference": "_stream_switch",
         "probe": "window", "carries": ("table",), "tau": True,
         "collectives": {}},
        {"attr": "_chunk_step", "reference": "_chunk_step",
         "probe": "chunk", "carries": ("table", "stats"), "graph": True,
         "collectives": {}},
        {"attr": "_deferred_step", "reference": None, "probe": "defer",
         "carries": ("table", "stats", "dd", "pending"), "graph": True,
         "collectives": {}},
        {"attr": "_flush_step", "reference": None, "probe": "flush",
         "carries": ("stats", "dd", "pending"), "graph": True,
         "collectives": {}},
    )

    def __init__(self, artifact: TableArtifact, backend_fn: Callable, *,
                 n_buckets: int = 4096, window: int = 512,
                 threshold: float = 0.7, capacity: int = 64,
                 flush_every: int = 1,
                 chunk_windows: Optional[Union[int, str]] = None,
                 flush_occupancy: Optional[float] = None,
                 flush_deadline: Optional[float] = None,
                 evict_age: Optional[float] = None, saturate: bool = True,
                 evict_policy: str = "timeout", lru_occupancy: float = 0.75,
                 fault_policy: Optional[FaultPolicy] = None,
                 use_kernel: Optional[bool] = None, autotune: bool = False,
                 tiles: Optional[TileConfig] = None,
                 fuse: Optional[bool] = None,
                 obs: Optional[Observability] = None, device=None):
        """evict_age: recycle a flow bucket once it has been idle this many
        (rebased) seconds; the sweep's cutoff is clamped to the window's
        oldest timestamp, so a flow seen in a window survives it. None
        disables eviction (the bit-exact contract with the batch path).
        saturate keeps the 2^24 overflow guard on (a bitwise no-op below
        the envelope; saturations are counted in ``StreamStats.overflow``).
        evict_policy: "timeout" recycles any bucket idle for evict_age;
        "approx_lru" runs the pressure-triggered sweep (see
        ``netsim.stream.approx_lru_sweep``), evicting only while occupancy
        exceeds ``lru_occupancy``; both need evict_age.

        flush_every: defer the backend across this many windows (the module
        docstring). 1 keeps one backend call a window. k > 1 makes ``step``
        return *provisional* (switch-tier) predictions; the backend's
        answers come back per flush from ``consume_flush()`` (``serve_trace``
        consumes them and ends with a guaranteed flush, so its predictions
        are final and equal flush_every=1's for a row-wise backend).

        chunk_windows: serve ``serve_trace`` K windows at a time through
        ``step_chunk`` (see the module docstring); every chunk must then
        have exactly K rows. ``"auto"`` picks K by a measured sweep at init
        (``autotune_chunk_windows``, cached per artifact shape, backend and
        geometry; never slower than ``DEFAULT_CHUNK_WINDOWS`` on the tuned
        shape). None serves window by window. The chunk is its own flush
        cycle, so it needs flush_every=1.

        flush_occupancy: with flush_every > 1, flush the cycle as soon as
        the buffer holds at least this fraction of its flush_every *
        capacity slots. flush_deadline: with flush_every > 1, flush as soon
        as a window's newest timestamp is this many (rebased) seconds past
        the earliest timestamp of the cycle's first window. Each splits a
        cycle early without changing a final prediction, and each costs one
        host sync a step (reading a count, or the window's timestamps), so
        both are opt-in.

        fault_policy: guard the backend with a ``serving.faults.
        GuardedBackend`` (per-flush timeout, bounded retries with
        exponential backoff, circuit breaker). It forces fuse=False (the
        guard runs on the host); with no fault injected the predictions
        equal an unguarded server's bit for bit. A flush that ultimately
        fails degrades its rows to the switch's answers
        (``StreamStats.degraded``).

        autotune, tiles: the switch kernel's launch configuration, passed
        to ``HybridServer`` as they are. fuse (CUDA only; a CPU server
        ignores it): None probes at the backend's first call whether
        backend_fn syncs the host and serves each step shape (and the
        flush) as a CUDA graph if it does not; True captures without
        probing; False serves eagerly. The deferred step, which calls no
        backend, is a graph whenever fuse is not False. A backend that
        reads mutable side channels must pass fuse=False.

        obs: attach a ``repro_torch.obs.Observability``: lifecycle events,
        per-stage timings, metric rollups and drift monitors over the
        serving loop. None (the default) takes no observability branch
        anywhere; with an instance attached every hook stays on the host
        and the predictions are the same bit for bit. Only ``sync_every >
        0`` adds sampled syncs, and only the rollup boundary (every
        ``rollup_every`` dispatches) reads the stats. The patch events of a
        chunk step (``backpatch``, ``degraded``) narrate the reference's
        two-phase route, so they come where it takes that route: with a
        fault policy or fuse=False, and on the card where the probe found a
        backend that syncs.

        device=None serves on CUDA and raises without a card; pass
        device="cpu" for the plain path. use_kernel=None means "the kernels
        for CUDA tensors"; False runs every kernel's plain version on the
        server's device.
        """
        self._obs = obs
        if obs is not None:
            obs.bind(self)
        if flush_every < 1:
            raise ValueError(f"flush_every must be >= 1, got {flush_every}")
        sweep = None
        if chunk_windows == "auto":
            # resolved before the checks below, so they see an int
            chunk_windows, sweep = self._resolve_auto_chunk_windows(
                artifact, backend_fn, n_buckets=n_buckets, window=window,
                threshold=threshold, capacity=capacity, evict_age=evict_age,
                saturate=saturate, evict_policy=evict_policy,
                lru_occupancy=lru_occupancy, use_kernel=use_kernel,
                autotune=autotune, tiles=tiles, fuse=fuse, device=device)
        if chunk_windows is not None:
            if chunk_windows < 1:
                raise ValueError(
                    f"chunk_windows must be >= 1, got {chunk_windows}")
            if flush_every != 1:
                raise ValueError(
                    "chunked streaming aligns backend flushes to chunk "
                    "boundaries (one flush per chunk_windows windows); "
                    "combine it with flush_every=1, not "
                    f"flush_every={flush_every}")
        if flush_occupancy is not None:
            if not 0.0 < flush_occupancy <= 1.0:
                raise ValueError(f"flush_occupancy must be in (0, 1], "
                                 f"got {flush_occupancy}")
            if flush_every == 1:
                raise ValueError("flush_occupancy needs flush_every > 1 "
                                 "(there is no deferral cycle to flush "
                                 "early at flush_every=1)")
        if flush_deadline is not None:
            if flush_deadline <= 0:
                raise ValueError(f"flush_deadline must be > 0, "
                                 f"got {flush_deadline}")
            if flush_every == 1:
                raise ValueError("flush_deadline needs flush_every > 1 "
                                 "(there is no deferral cycle to flush "
                                 "early at flush_every=1)")
        if evict_policy not in EVICT_POLICIES:
            raise ValueError(f"evict_policy must be one of "
                             f"{EVICT_POLICIES}, got {evict_policy!r}")
        if evict_policy == "approx_lru":
            if evict_age is None:
                raise ValueError("evict_policy='approx_lru' needs "
                                 "evict_age (the idle-age quantization "
                                 "horizon of the age classes)")
            if not 0.0 < lru_occupancy < 1.0:
                raise ValueError(f"lru_occupancy must be in (0, 1), "
                                 f"got {lru_occupancy}")
        if fault_policy is not None:
            if fuse:
                raise ValueError("fault_policy guards the host backend "
                                 "call and therefore needs the two-phase "
                                 "serving path; it cannot be combined "
                                 "with fuse=True")
            fuse = False
        super().__init__(artifact, backend_fn, threshold=threshold,
                         capacity=capacity, use_kernel=use_kernel,
                         autotune=autotune, tiles=tiles, fuse=fuse,
                         device=device)
        self.n_buckets = n_buckets
        self.window = window
        self.flush_every = flush_every
        self.chunk_windows = chunk_windows
        self.chunk_sweep = sweep   # {K: s per packet} of "auto"'s sweep
        self.flush_occupancy = flush_occupancy
        self.flush_deadline = flush_deadline
        self.evict_age = evict_age
        self.saturate = saturate
        self.evict_policy = evict_policy
        self.lru_occupancy = lru_occupancy
        self.fault_policy = fault_policy
        self._fuse = fuse
        self._guard = (GuardedBackend(backend_fn, fault_policy,
                                      events=(obs.events if obs is not None
                                              else None))
                       if fault_policy is not None else None)
        self._ingest = None      # ring telemetry of the last serve_stream
        self._latency = None     # LatencyRecorder of the last serve_stream
        self._staging = None     # serve_stream's pinned buffers, kept
        # the carries: written in place by every step, read by the graphs
        self._table = self._make_state()
        self._stats = StreamStats.zero(self.device)
        self._dd = self._pending = None
        if flush_every > 1:
            # the sharded tier's ranks keep their partial rows in this same
            # layout
            self._dd = init_deferred(flush_every, capacity, FLOW_FEATURES,
                                     device=self.device)
            self._pending = torch.full((flush_every, window), -1,
                                       dtype=pred_dtype(self.artifact),
                                       device=self.device)
        self._pos = torch.zeros((), dtype=torch.int32, device=self.device)
        self._reset_deferred()
        # the deferred step calls no backend: a graph whenever fuse allows
        self._defer_graphs = self.device.type == "cuda" and fuse is not False
        self._step_graphs = {}     # (kind, shape) -> (graph, input, outs, marks)

    # -- the chunk-size autotune -------------------------------------------

    def _resolve_auto_chunk_windows(self, artifact, backend_fn, *, n_buckets,
                                    window, capacity, device, **kw):
        """-> (K, {K: seconds per packet} the sweep measured). The
        throwaway servers get no fault policy: the sweep times the serving
        path, not retries."""
        dev = resolve_device(device)
        card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        # the route (graphs or eager), the sweep and the mesh change what K
        # costs
        key = (type(self).__name__, getattr(self, "n_shards", 1),
               getattr(self, "n_data", 1), _artifact_key(artifact),
               id(backend_fn), card, window, n_buckets, capacity, kw["fuse"],
               kw["evict_age"], kw["evict_policy"])
        k = autotune_chunk_windows(
            lambda k: self._auto_chunk_server(
                k, artifact, backend_fn, n_buckets=n_buckets, window=window,
                capacity=capacity, device=device, **kw),
            window=window, n_buckets=n_buckets,
            candidate_filter=self._auto_chunk_filter(capacity), cache_key=key,
            events=None if self._obs is None else self._obs.events)
        return k, chunk_sweep_timings(key)

    def _auto_chunk_server(self, k: int, artifact, backend_fn, **kw):
        """A throwaway server of this tier for chunk size k, the sweep's
        timing target (the sharded tier pins its mesh)."""
        return StreamingHybridServer(artifact, backend_fn, chunk_windows=k,
                                     **kw)

    def _auto_chunk_filter(self, capacity: int):
        """The sweep's candidate predicate (None: every K); the sharded
        tier keeps the Ks whose chunk buffer divides over its mesh."""
        return None

    # -- the carries ---------------------------------------------------------

    def _make_state(self) -> FlowTableState:
        """A fresh register file, the carry's layout (the sharded tier
        allocates this rank's block of its partitioned file instead)."""
        return init_flow_table(self.n_buckets, device=self.device)

    def _carries(self) -> _Carries:
        return _Carries(self._table, self._stats, self._dd, self._pending)

    def _reset_deferred(self):
        """Empty pending cycle: the deferral buffer zeroed and the pending
        set refilled with -1 in place (the graphs read them), the host-side
        cycle position, occupancy count and deadline latch cleared, and the
        flush queue emptied."""
        self._pending_n = 0
        self._occ_rows = 0
        self._cycle_born = None
        self._flush_queue = []
        if self._dd is not None:
            zero_deferred_(self._dd)
            self._pending.fill_(-1)

    @property
    def state(self) -> FlowTableState:
        """The live register file, written in place by every step: read it,
        don't keep it."""
        return self._table

    @property
    def stats(self) -> StreamStats:
        """A snapshot of the running telemetry (device tensors, no sync)."""
        return self._stats.clone()

    @property
    def pending_windows(self) -> int:
        """Windows deferred in the current (unflushed) cycle."""
        return self._pending_n

    @property
    def fault_stats(self) -> Optional[FaultStats]:
        """The fault-policy guard's host-side telemetry (attempts, retries,
        timeouts, breaker transitions; ``serving.faults.FaultStats``), or
        None without a ``fault_policy``."""
        return self._guard.stats if self._guard is not None else None

    @property
    def ingest_stats(self):
        """``netsim.ingest.IngestStats`` of the most recent (or running)
        ``serve_stream``: admitted/dropped packets, count vs deadline vs
        drain cuts. None before the first serve_stream."""
        return self._ingest

    @property
    def latency(self) -> Optional[LatencyRecorder]:
        """Admit->prediction LatencyRecorder of the most recent
        ``serve_stream(record_latency=True)`` (``.summary()`` gives the
        p50/p95/p99 row); None otherwise."""
        return self._latency

    def flow_table(self) -> torch.Tensor:
        """(n_buckets, 8) feature table from the current registers."""
        return flow_table_readout(self.state)

    def reset(self):
        """Fresh register file + telemetry (a new stream epoch), refilled in
        place, so captured graphs stay valid. Pending deferred windows are
        dropped unflushed (flush() first if their answers matter), and the
        fault guard starts a fresh epoch."""
        self._table.copy_(self._make_state())
        self._stats.zero_()
        self._reset_deferred()
        if self._guard is not None:
            self._guard.reset()

    def release_graphs(self):
        """Drop every captured step graph (and ``classify``'s); the next
        step captures anew."""
        self._step_graphs.clear()
        self._graphs.clear()

    def _store_regs(self, regs: torch.Tensor, state: FlowTableState):
        # B5 and B6's sweep wrote ``regs`` in place; a plain or approx-LRU
        # route returned a new tensor, copied back into the carry
        if state.regs is not regs:
            regs.copy_(state.regs)

    # -- the step kinds: switch half, then what follows the backend ----------

    def _register_kw(self) -> dict:
        """The register half's knobs, as this server was built."""
        return dict(evict_age=self.evict_age, saturate=self.saturate,
                    evict_policy=self.evict_policy,
                    lru_occupancy=self.lru_occupancy,
                    use_kernel=False if self.use_kernel is False else None)

    def _window_switch(self, c: _Carries, w: PacketWindow, tau):
        phase("register")
        state, x, n_ev, n_ov = window_update_readout(
            FlowTableState(c.table.regs), w, **self._register_kw())
        self._store_regs(c.table.regs, state)
        phase("switch")
        sw_pred, conf = fused_classify(self.artifact, x, tiles=self.tiles,
                                       device=self.device)
        phase("dispatch")
        fwd = (conf < tau) & w.valid
        buf, idx, valid = dispatch(x, fwd, self.capacity)
        return buf, (sw_pred, idx, valid, fwd, conf, n_ev, n_ov)

    def _window_finish(self, c: _Carries, w: PacketWindow, ctx, be_pred):
        sw_pred, idx, valid, fwd, conf, n_ev, n_ov = ctx
        if be_pred is None:        # the guarded call failed: switch answers
            new, pred, frac, rows = degrade_window_stats(
                c.stats, w, sw_pred, fwd, valid, conf, n_ev, n_ov)
        else:
            new, pred, frac, rows = accumulate_stream_stats(
                c.stats, w, sw_pred, be_pred, idx, valid, fwd, conf, n_ev,
                n_ov)
        c.stats.copy_(new)
        return pred, frac, rows

    def _chunk_switch(self, c: _Carries, chunk: PacketChunk, tau):
        phase("register")
        state, xs, n_ev, n_ov = chunk_update_readout(
            FlowTableState(c.table.regs), chunk, **self._register_kw())
        self._store_regs(c.table.regs, state)
        new, dd, pending, frac, rows = chunk_classify_tail(
            self.artifact, c.stats, chunk, xs, n_ev, n_ov, tau,
            self.capacity, tiles=self.tiles, device=self.device)
        c.stats.copy_(new)        # the backend accounting folds here too
        return dd.buf, (dd, pending, frac, rows)

    def _chunk_finish(self, c: _Carries, chunk, ctx, be_pred):
        dd, pending, frac, rows = ctx
        if be_pred is None:        # failed: retract the fold, no patch
            c.stats.copy_(degrade_chunk_stats(c.stats, dd))
            return pending, frac, rows
        return backpatch_pending(pending, be_pred, dd), frac, rows

    def _halves(self, kind: str):
        if kind == "window":
            return self._window_switch, self._window_finish
        return self._chunk_switch, self._chunk_finish

    # -- the captured step bodies -----------------------------------------------

    def _fused_step(self, kind: str, c: _Carries, inp):
        """A fused step's body: the switch half, the backend on its rows,
        then the fold (a window) or the back-patch (a chunk), every carry
        written in place. -> (pred, frac, rows)."""
        switch, finish = self._halves(kind)
        buf, ctx = switch(c, inp, self._tau)
        phase("backend")
        be_pred = self._fused_backend(kind, c, buf)
        phase("combine")
        return finish(c, inp, ctx, be_pred)

    def _window_step(self, c: _Carries, w: PacketWindow):
        """The window step a graph captures (threshold from ``_tau``)."""
        return self._fused_step("window", c, w)

    def _chunk_step(self, c: _Carries, chunk: PacketChunk):
        """The chunk step a graph captures (threshold from ``_tau``)."""
        return self._fused_step("chunk", c, chunk)

    def _deferred_step(self, c: _Carries, w: PacketWindow):
        """The deferred step a graph captures: ``_defer_body`` at the
        threshold in ``_tau`` and the cycle slot in ``_pos``."""
        return self._defer_body(c, w, self._tau, self._pos)

    def _flush_step(self, c: _Carries, _inp=None):
        """The flush a graph captures: the backend over the deferral
        buffer, the back-patch, the fold and the emptying.
        -> (patched predictions,)."""
        phase("backend")
        be_pred = self._fused_backend("flush", c, None)
        phase("combine")
        return (self._flush_finish(c, be_pred),)

    def _defer_body(self, c: _Carries, w: PacketWindow, tau, pos):
        """One deferred window: the switch half, then the rows into the
        buffer and the provisional predictions into the pending set at
        slot ``pos``; no backend. -> (pred, frac, rows)."""
        buf, ctx = self._defer_switch(c, w, tau)
        sw_pred, idx, valid, fwd, conf, n_ev, n_ov = ctx
        new, _, _, pred, frac, rows = defer_tail(
            c.stats, c.dd, c.pending, w, sw_pred, fwd, buf, idx, valid, conf,
            (n_ev, n_ov), pos)
        c.stats.copy_(new)
        return pred, frac, rows

    def _defer_switch(self, c: _Carries, w: PacketWindow, tau):
        """The deferred window's switch half (the sharded tier keeps each
        shard's partial rows, with no merge a window)."""
        return self._window_switch(c, w, tau)

    def _flush_finish(self, c: _Carries, be_pred) -> torch.Tensor:
        """Patch the backend's answers into the pending set (or, when the
        guarded call failed, keep its provisional answers), fold the
        flush, then empty the cycle in place. -> the (flush_every, W)
        predictions, a new tensor."""
        if be_pred is None:
            c.stats.copy_(fold_degraded_flush(c.stats, c.dd))
            patched = c.pending.clone()
        else:
            patched = backpatch_pending(c.pending, be_pred, c.dd)
            c.stats.copy_(fold_flush_stats(c.stats, c.dd))
        zero_deferred_(c.dd)
        c.pending.fill_(-1)
        return patched

    def _backend_answer(self, rows) -> Optional[torch.Tensor]:
        """The backend's answers for ``rows`` on the server's device; with
        a fault policy through the guard, and None when the guarded call
        ultimately failed (the caller degrades). The captured steps call
        this."""
        out = self._backend_fn(rows) if self._guard is None \
            else self._guard(rows)
        return None if out is None else torch.as_tensor(out,
                                                        device=self.device)

    def _fused_backend(self, kind: str, c: _Carries, rows):
        """The backend's answers inside a fused step (a graph's body): for
        "window" and "chunk" on the step's dispatched ``rows``, for "flush"
        on the deferral buffer. The sharded tier serves them across its
        mesh."""
        return self._backend_answer(c.dd.buf if kind == "flush" else rows)

    def _eager_backend(self, kind: str, c: _Carries, rows):
        """The backend's answers on the eager route: the probe at the first
        call on the card, else the two-phase host call, over the step's
        ``rows`` or, for a "flush", ``_flush_rows_host()``; None when the
        guarded call failed."""
        if kind == "flush":
            rows = self._flush_rows_host()
        return (self._probe_backend(rows) if self._fused_ok is None
                else self._host_backend(rows))

    def _stage(self, name: str):
        """The attached Observability's timer for stage ``name``, or a null
        context without one."""
        return _NULL if self._obs is None else self._obs.stage(name)

    def _host_call(self, rows) -> Optional[torch.Tensor]:
        """``_backend_answer`` called from the host, timed as the
        ``backend_flush`` stage when an Observability is attached."""
        with self._stage("backend_flush"):
            return self._backend_answer(rows)

    def _host_backend(self, rows) -> Optional[torch.Tensor]:
        """The two-phase route's backend answers: the host call (the
        sharded tier makes it on one rank and shares the answers)."""
        return self._host_call(rows)

    def _narrates_patch(self) -> bool:
        """Whether the reference's counterpart of the last step took its
        two-phase route (a host backend call, then the patch), where it
        emits the chunk step's patch events: on the card, whenever the port
        serves eagerly (fuse=False, a fault policy, or a backend the probe
        found syncing); a CPU server always serves eagerly, so there it is
        fuse=False or a fault policy."""
        if self.device.type == "cuda":
            return self._fused_ok is False
        return self._fuse is False

    def _probe_backend(self, buf) -> torch.Tensor:
        """The backend's first call, with host syncs turned into errors: a
        backend that syncs cannot be captured, so it is called again
        normally and served eagerly from now on. The switch half (or the
        deferred steps) already ran and the carries have advanced, so only
        the backend is retried, never the step."""
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            be = self._host_call(buf)
            self._fused_ok = True
        except RuntimeError:
            self._fused_ok = False
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        return be if self._fused_ok else self._host_call(buf)

    def _replay_step(self, key, body, inp, traced: bool = False):
        """``body(carries, inp)`` as a CUDA graph under ``key`` (captured at
        its first call), replayed on ``inp`` (None: the body reads only the
        carries); its output tensors cloned out of the graph's buffers. The
        warm-up before the capture runs on copies of the carries, so it
        advances nothing. The capture forbids unsafe CUDA calls on this
        thread only (``thread_local``): ``serve_stream``'s prefetch thread
        may allocate, copy and wait on events meanwhile, on its own stream,
        which the capture does not record."""
        entry = self._step_graphs.get(key)
        if entry is None:
            with annotation(ENTRY_CAPTURE, traced):
                entry = self._step_graphs[key] = self._capture(
                    body, self._carries(),
                    None if inp is None else _clone_input(inp),
                    "thread_local")
        return self._run_graph(entry, self._load_step, inp, traced)

    def _load_step(self, static, inp) -> None:
        """The threshold and the step's input into the graph's buffers; a
        flush (no input) reads only the carries."""
        if inp is not None:
            self._tau.fill_(self.threshold)
            _copy_input(static, inp)

    def graph_phases(self) -> dict:
        return {**super().graph_phases(),
                **{key: entry[3] for key, entry in self._step_graphs.items()}}

    def _serve(self, kind: str, inp, traced: bool):
        switch, finish = self._halves(kind)
        if self._fused_ok:
            pred, frac, rows = self._replay_step(
                (kind, tuple(inp.bucket.shape)),
                self._window_step if kind == "window" else self._chunk_step,
                inp, traced)
        else:
            with annotation(ENTRY_PROBE if self._fused_ok is None
                            else ENTRY_EAGER, traced):
                c = self._carries()
                buf, ctx = switch(c, inp, self.threshold)
                be = self._eager_backend(kind, c, buf)
                narrate = (self._obs is not None and kind == "chunk"
                           and self._narrates_patch())
                # a failed call (be None) leaves the switch's answers: no
                # patch
                with (self._stage("backpatch") if narrate and be is not None
                      else _NULL):
                    pred, frac, rows = finish(c, inp, ctx, be)
            if narrate:
                self._obs.emit("degraded" if be is None else "backpatch",
                               windows=inp.n_windows)
        return pred, HybridStats(frac, rows, self.capacity)

    # -- serving ---------------------------------------------------------------

    def step(self, w: PacketWindow):
        """Serve one window. -> (pred (W,), HybridStats for this window).

        Pad lanes report -1. Nothing here waits on the device (the first
        call may, to probe the backend; the second captures its graph).

        With flush_every > 1 the predictions are *provisional*: deferred
        rows carry the switch's answer until their cycle flushes (when it
        fills, on an occupancy or deadline trigger, or on ``flush()``), and
        the back-patched predictions of the cycle then wait in
        ``consume_flush()``. ``HybridStats.backend_rows`` reports the rows
        deferred this window.

        NOT retry-safe: the register file advances before the backend runs,
        so a backend exception leaves the window folded in — calling
        step(w) again double-counts it. Recover by reset() or by skipping
        the failed window, never by replaying it.
        """
        if tracing():
            return entry_call(self._step_window, w)
        return self._step_window(w, False)

    def _step_window(self, w: PacketWindow, traced: bool):
        if self.flush_every == 1:
            return self._serve("window", w, traced)
        self._pos.fill_(self._pending_n)
        if self._defer_graphs:
            pred, frac, rows = self._replay_step(
                ("defer", tuple(w.bucket.shape)), self._deferred_step, w,
                traced)
        else:
            with annotation(ENTRY_EAGER, traced):
                pred, frac, rows = self._defer_body(self._carries(), w,
                                                    self.threshold, self._pos)
        self._pending_n += 1
        full = self._pending_n >= self.flush_every
        trigger = "cycle_full"
        if self.flush_occupancy is not None and not full:
            # reading the deferred-row count is one host sync (opt-in)
            self._occ_rows += int(rows)
            if self._occ_rows >= self.flush_occupancy * self._dd.slots:
                full, trigger = True, "occupancy"
        if self.flush_deadline is not None:
            # age the cycle's first window (its earliest timestamp latched
            # at cycle start) against this window's newest: one host sync
            ts = w.ts.cpu()[w.valid.cpu()]
            if ts.numel():
                if self._cycle_born is None:
                    self._cycle_born = float(ts.min())
                if (not full and float(ts.max()) - self._cycle_born
                        >= self.flush_deadline):
                    full, trigger = True, "deadline"
        if full:
            # queued, not overwritten: a caller who steps through several
            # cycles without consuming loses nothing
            self._flush_queue.append(self._flush(trigger, traced))
        return pred, HybridStats(frac, rows, self.capacity)

    # -- deferred-dispatch flushing ------------------------------------------

    def _flush_rows_host(self) -> torch.Tensor:
        """The deferred rows a two-phase backend call serves: the whole
        buffer (the sharded tier sums its shards' partial rows here)."""
        return self._dd.buf

    def flush(self, *, trigger: str = "manual"):
        """Run the backend on the pending deferral cycle and back-patch.

        -> (n_windows_flushed, patched (flush_every, W) predictions) with
        the flushed windows at rows [0, n); None when nothing is pending
        (or flush_every == 1, where every step already ran the backend).
        ``serve_trace`` calls this at its end, the guaranteed flush; drive
        it yourself when stepping manually. The buffer is zeroed and the
        pending set refilled in place. Fused, the backend, the patch, the
        fold and the emptying are one CUDA graph; two-phase, the backend
        runs on the host's call, then the patch; degraded (the guard gave
        up), the provisional answers come back unpatched and the cycle's
        rows fold into ``degraded``. ``trigger`` names what asked for the
        flush ("cycle_full", "occupancy", "deadline", "end_of_stream",
        "manual") in the ``flush`` event when an Observability is attached;
        it changes nothing else.
        """
        if tracing():
            return entry_call(self._flush, trigger)
        return self._flush(trigger, False)

    def _flush(self, trigger: str, traced: bool):
        if self.flush_every == 1 or self._pending_n == 0:
            return None
        n = self._pending_n
        obs = self._obs
        if obs is not None:
            obs.emit("flush", windows=n, trigger=trigger)
        served = True
        if self._fused_ok:
            (patched,) = self._replay_step(
                ("flush", tuple(self._dd.buf.shape)), self._flush_step, None,
                traced)
        else:
            with annotation(ENTRY_PROBE if self._fused_ok is None
                            else ENTRY_EAGER, traced):
                c = self._carries()
                be = self._eager_backend("flush", c, None)
                served = be is not None
                with self._stage("backpatch") if served else _NULL:
                    patched = self._flush_finish(c, be)
        if obs is not None:
            obs.emit("backpatch" if served else "degraded", windows=n)
        self._pending_n = 0
        self._occ_rows = 0
        self._cycle_born = None
        return n, patched

    def consume_flush(self):
        """Pop the oldest unconsumed flush result (or None): the
        (n_windows, patched predictions) pair ``step`` queued when a cycle
        flushed. FIFO, so stepping through several cycles before consuming
        loses nothing."""
        return self._flush_queue.pop(0) if self._flush_queue else None

    # -- chunked serving -----------------------------------------------------

    def step_chunk(self, chunk: PacketChunk):
        """Serve K stacked windows as one step.
        -> (pred (K, W), HybridStats for the chunk).

        The register half folds the chunk's windows in order, then one
        classify, one dispatch of every window, ONE backend call over the
        chunk's K*capacity rows and the back-patch: the predictions are
        final, pad and dead lanes at -1 (under a fault policy, a failed
        call leaves the switch's answers). Needs ``chunk_windows`` set, and
        a chunk of exactly that many windows of ``window`` lanes
        (``iter_chunks`` pads the ragged final chunk with dead windows).
        Same retry discipline as ``step``.
        """
        if self.chunk_windows is None:
            raise ValueError("server built without chunk_windows")
        if chunk.n_windows != self.chunk_windows:
            raise ValueError(f"chunk has {chunk.n_windows} windows, server "
                             f"built for {self.chunk_windows}")
        if chunk.window != self.window:
            raise ValueError(f"chunk windows are {chunk.window} lanes wide, "
                             f"server built for {self.window}")
        if tracing():
            return entry_call(self._serve, "chunk", chunk)
        return self._serve("chunk", chunk, False)

    # -- open-ended serving --------------------------------------------------

    def _sync_current(self) -> None:
        """Wait until everything enqueued so far on the current CUDA stream
        is done, through an event (not a stream sync): the latency
        recorder's and the sampled sync's one wait. Nothing on the CPU."""
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()

    def serve_stream(self, source, *, t0: Optional[float] = None,
                     deadline: Optional[float] = None,
                     ring_capacity: Optional[int] = None,
                     prefetch: Optional[bool] = None,
                     prefetch_depth: int = 2,
                     record_latency: bool = False,
                     latency_samples: Optional[int] = None,
                     clock: Callable[[], float] = time.monotonic):
        """The primary serving loop: pull packets from an open-ended
        ``source`` through the ingest ring. -> (pred (P,) on the server's
        device, stats).

        ``source`` is any iterable of PacketTrace batches (a live capture
        adapter, ``netsim.ingest.replay_source`` for finite traces, a
        generator pacing a scenario). Batches are admitted into a
        ``PacketRingBuffer`` and cut into window-granular chunks by count
        or ``deadline`` (wall seconds an admitted packet may wait),
        whichever fires first (see ``netsim.ingest``). Cuts never move
        window boundaries, so predictions, the flow table and every
        StreamStats field except ``flushes`` are the same under ANY cut
        grouping; replaying a finite trace in one batch reproduces the
        offline grouping exactly (``serve_trace``).

        Ingest is pull-based, so backpressure is "the source waits":
        nothing is dropped, and ``ring_capacity`` (default 4 chunks) bounds
        host memory.

        On the chunked path (``chunk_windows`` set) ``prefetch`` (default
        on) runs the ring and the cut -> device map on a background thread
        with a bounded ``prefetch_depth`` queue. On the card each cut is
        packed into a pinned buffer and copied on a side stream
        (``netsim.ingest.PinnedStaging``, ``prefetch_depth + 2`` buffers,
        kept by the server), so chunk k+1's transfer is in flight while
        chunk k runs; the loop makes its stream wait on the copy's event
        before the step reads the chunk. The per-window path has no chunk
        transfer to overlap: prefetch=True there raises ValueError, and
        the default (None) turns it off. The generator is closed (and the
        thread joined) however the loop ends.

        record_latency=True records every packet's admit->prediction wall
        latency into ``self.latency`` (p50/p95/p99 via ``.summary()``), with
        *final*-prediction semantics: a chunk's packets complete when its
        back-patched predictions can be read on the host; under deferred
        dispatch (flush_every > 1) a window's packets complete at the flush
        that back-patches its cycle. Each completion is one wait on an
        event recorded after the step on the current stream (the only
        waits the knob adds); off, the loop waits on nothing.
        ``latency_samples`` bounds the recorder's memory with a seeded
        reservoir (exact mean/max, sampled percentiles); None keeps exact
        percentiles at unbounded memory (see ``LatencyRecorder``).

        With an ``obs=Observability`` attached at construction, this loop
        emits lifecycle events (serve_begin / cut / chunk / window / flush
        / rollup / serve_end), times pipeline stages, closes a metric
        rollup window every ``rollup_every`` dispatches (the loop's only
        stats read), feeds the drift monitors, and, only when
        ``sync_every > 0``, waits for the device as the ``megastep_synced``
        stage. The predictions, flow table and StreamStats are the same
        with obs on or off.

        The ingest ``deadline`` acts in the *wall-clock* domain on admitted
        packets and only changes cut grouping; ``flush_deadline`` /
        ``flush_occupancy`` act in the *data-time / occupancy* domain on
        the deferral cycle inside ``step`` and only change flush grouping.
        When a count cut and a deadline cut are both due, the count cut
        wins. ``self.ingest_stats`` reports admitted/dropped/cut telemetry.
        """
        chunked = bool(self.chunk_windows)
        if prefetch is None:
            prefetch = chunked
        if prefetch and not chunked:
            raise ValueError(
                "prefetch double-buffers (K, W) chunk transfers and "
                "needs the chunked path — build the server with "
                "chunk_windows (prefetch=None auto-disables on the "
                "per-window path)")
        ring = PacketRingBuffer(self.window,
                                self.chunk_windows if chunked else 1,
                                self.n_buckets, t0=t0,
                                capacity=ring_capacity, deadline=deadline,
                                clock=clock)
        self._ingest = ring.stats
        rec = (LatencyRecorder(max_samples=latency_samples)
               if record_latency else None)
        self._latency = rec
        # windows pending from manual step() calls belong to a different
        # prediction stream: flush them, drop their patches
        self.flush()
        self._flush_queue = []
        preds = []
        cuts = cut_stream(ring, source)
        obs = self._obs
        if obs is not None:
            obs.emit("serve_begin", tier=type(self).__name__,
                     window=self.window,
                     chunk_windows=self.chunk_windows or 0,
                     flush_every=self.flush_every, prefetch=bool(prefetch))
            obs.reset_ticks()
            # the rollup baseline: ONE stats read before the loop, so
            # boundary deltas are exact even on a warm server
            obs_prev = self._read_stats()[0]
            obs_b0 = 0                # preds index of the last boundary

        def done_at() -> float:
            self._sync_current()
            return clock()

        if chunked:
            staging = None
            if prefetch and self.device.type == "cuda":
                staging = self._staging
                if staging is None or staging.slots != prefetch_depth + 2:
                    staging = self._staging = PinnedStaging(
                        self.chunk_windows, self.window, device=self.device,
                        slots=prefetch_depth + 2)

            def to_device(c):
                if staging is None:
                    return c.to_chunk(device=self.device), None
                return staging.stage(c)

            def make_pairs():
                # a generator, so the obs stage timers can bracket the cut
                # pull and the device map separately; with prefetch on, both
                # run on the prefetch thread and time its work
                it = iter(cuts)
                while True:
                    try:
                        with self._stage("ring_cut"):
                            c = next(it)
                    except StopIteration:
                        return
                    with self._stage("h2d"):
                        ch, ready = to_device(c)
                    yield c, ch, ready

            pairs = make_pairs()
            if prefetch:
                pairs = prefetch_iter(pairs, depth=prefetch_depth)
            try:
                for cut, chunk, ready in pairs:
                    chunk = await_chunk(chunk, ready)
                    if obs is not None:
                        obs.emit("cut", cut_kind=cut.kind, packets=cut.n,
                                 windows=cut.n_windows)
                    with self._stage("megastep"):
                        pred, _ = self.step_chunk(chunk)
                    # live rows lead; pad/-1 lanes only trail them
                    flat = pred.reshape(-1)[:cut.n]
                    if rec is not None:
                        rec.record(cut.admit_time, done_at())
                    preds.append(flat)
                    if obs is not None:
                        obs.emit("chunk", windows=cut.n_windows,
                                 packets=cut.n)
                        if obs.sync_due():
                            with obs.stage("megastep_synced"):
                                self._sync_current()
                        if obs.tick():
                            obs_prev, obs_b0 = self._obs_rollup(
                                obs, preds, obs_b0, obs_prev,
                                n_dispatches=obs.config.rollup_every,
                                collapse=True)
            finally:
                pairs.close()
            if obs is not None and obs.pending_ticks:
                obs_prev, obs_b0 = self._obs_rollup(
                    obs, preds, obs_b0, obs_prev,
                    n_dispatches=obs.pending_ticks, collapse=True)
            flat = self._concat(preds)
            if obs is not None:
                obs.emit("serve_end", packets=int(flat.numel()),
                         cuts=ring.stats.cuts,
                         windows=self._stats.n_windows)
            return flat, self.stats.check()

        # per-window path (incl. deferred dispatch); one window per cut
        times = []                    # admit times aligned with preds
        n_live = 0

        def patch(fl):
            k = fl[0]
            _patch(preds, fl)
            if rec is not None:
                done = done_at()
                for at in times[len(times) - k:]:
                    rec.record(at, done)

        for cut in cuts:
            if obs is not None:
                obs.emit("cut", cut_kind=cut.kind, packets=cut.n,
                         windows=cut.n_windows)
            for w in cut.to_windows(device=self.device):
                with self._stage("megastep"):
                    pred, _ = self.step(w)
                preds.append(pred)
                times.append(cut.admit_time)
                n_live += cut.n
                if rec is not None and self.flush_every == 1:
                    rec.record(cut.admit_time, done_at())
                fl = self.consume_flush()
                if fl is not None:
                    patch(fl)
                if obs is not None:
                    obs.emit("window", packets=cut.n)
                    if obs.sync_due():
                        with obs.stage("megastep_synced"):
                            self._sync_current()
                    if obs.tick():
                        # never collapse: a patch rewrites preds per window
                        obs_prev, obs_b0 = self._obs_rollup(
                            obs, preds, obs_b0, obs_prev,
                            n_dispatches=obs.config.rollup_every,
                            collapse=False)
        fl = self.flush(trigger="end_of_stream")   # guaranteed final flush
        if fl is not None:
            patch(fl)
        if obs is not None and obs.pending_ticks:
            obs_prev, obs_b0 = self._obs_rollup(
                obs, preds, obs_b0, obs_prev,
                n_dispatches=obs.pending_ticks, collapse=False)
        flat = self._concat(preds)[:n_live]
        if obs is not None:
            obs.emit("serve_end", packets=n_live, cuts=ring.stats.cuts,
                     windows=self._stats.n_windows)
        return flat, self.stats.check()

    def _concat(self, preds: list) -> torch.Tensor:
        if preds:
            return torch.cat([p.reshape(-1) for p in preds])
        return torch.zeros((0,), dtype=pred_dtype(self.artifact),
                           device=self.device)

    def _read_stats(self, seg: Optional[torch.Tensor] = None) -> tuple:
        """The additive StreamStats counters as a dict of Python numbers,
        and with ``seg`` the class counts of its predictions (pad/-1 lanes
        and labels outside [0, n_classes) not counted), in ONE read from
        the device: every value rides one float64 tensor (exact for the
        int32 counters, the f32 ``conf_sum`` and the counts)."""
        vals = [t.to(torch.float64) for t in self._stats._tensors()]
        n_classes = self.artifact.n_classes
        if seg is not None:
            ok = (seg >= 0) & (seg < n_classes)
            counts = torch.zeros(n_classes + 1, dtype=torch.float64,
                                 device=seg.device).index_add_(
                0, torch.where(ok, seg, n_classes).long(),
                torch.ones(seg.shape, dtype=torch.float64,
                           device=seg.device))
            vals.append(counts[:n_classes])
        host = torch.cat([v.reshape(-1) for v in vals]).tolist()
        names = [f.name for f in dataclasses.fields(self._stats)]
        cur = {k: (v if k == "conf_sum" else int(v))
               for k, v in zip(names, host)}
        return cur, [int(v) for v in host[len(names):]]

    def _obs_rollup(self, obs, preds, b0, prev, *, n_dispatches, collapse):
        """Close one observability rollup window at a dispatch boundary.

        The loop's ONE device read per ``rollup_every`` dispatches: the
        StreamStats counters, whose delta against the previous boundary is
        the rollup sample (all additive), with the predicted class counts
        of the predictions emitted since the last boundary, counted on the
        device (on the deferred per-window path these may still be
        provisional; the class-mix signal tolerates that).
        ``collapse=True`` (chunked path only) replaces the consumed preds
        entries with their concatenation; the per-window path keeps one
        entry per window for the flush back-patch. An eviction delta
        surfaces as an ``eviction`` event. Returns (snapshot, new_b0) for
        the next boundary."""
        if len(preds) > b0:
            seg = torch.cat([p.reshape(-1) for p in preds[b0:]])
            if collapse:
                preds[b0:] = [seg]
        else:
            seg = torch.zeros(0, dtype=torch.int64, device=self.device)
        cur, counts = self._read_stats(seg)
        delta = {k: cur[k] - prev[k] for k in cur}
        if delta["evicted"] > 0:
            obs.emit("eviction", buckets=int(delta["evicted"]))
        sample = dict(delta, dispatches=int(n_dispatches),
                      class_counts=counts)
        obs.observe_rollup(sample)
        return cur, len(preds)

    def serve_trace(self, trace, *, t0: Optional[float] = None):
        """Stream a whole PacketTrace. -> (pred (P,) on the server's device,
        stats).

        The finite-replay wrapper over ``serve_stream``: the trace enters
        the ingest ring as one batch, so t0 latches to the trace minimum
        (the offline iterators' epoch), every cut is a count cut and the
        grouping, hence predictions, flow table and StreamStats including
        ``flushes``, equals driving ``iter_chunks`` / ``iter_windows``
        through ``step_chunk`` / ``step`` by hand. Per-packet predictions
        come back in arrival order with pad lanes stripped; under deferred
        dispatch they are final (every cycle back-patched, the trailing
        cycle flushed). Ends with ``stats.check()``.

        On the card the replay runs without prefetch: the trace is already
        in host memory, and there the thread and the pinned staging cost
        more than the overlap hides (PERF.md). On the CPU prefetch keeps
        serve_stream's default, as the reference's replay does.
        """
        return self.serve_stream(replay_source(trace), t0=t0,
                                 prefetch=(False if self.device.type == "cuda"
                                           else None))


def _patch(preds: list, flushed) -> None:
    """Write a flush's (n, patched) predictions over the last n windows'
    provisional ones."""
    if flushed is not None:
        k, patched = flushed
        preds[-k:] = list(patched[:k])
