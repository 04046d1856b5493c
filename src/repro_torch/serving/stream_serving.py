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

Carries and graphs. The register file and the ``StreamStats`` tensors are
the server's carries: every step writes them in place (B5 and B6's sweep
already do; the stats fold copies into them), so ``state`` reads the live
register file (read it, don't keep it) and ``stats`` a snapshot. On the
card (``fuse=None``, as in ``HybridServer``) the first step probes whether
the backend syncs the host; if it does not, each step shape is captured
once as a CUDA graph that owns static input buffers and updates the
carries in place, and every later call copies its window or chunk in and
replays it: the counterpart of the reference's jitted, donating
``_stream_step`` and ``_chunk_step``. A backend that syncs is served
eagerly in two phases (switch half, backend, then the fold or the
back-patch), as the reference's ``_stream_switch`` / ``_chunk_switch``
routes do. ``step`` and ``step_chunk`` may be mixed on one stream: both
graphs read and write the same carries, and ``reset()`` refills them in
place. Nothing in a step waits on the device.

Left out until their slices: ``flush_every`` and the cross-window deferral,
``flush_occupancy``, ``flush_deadline`` and ``fault_policy`` (A-iv),
``serve_stream`` with the ingest ring (A-v), and ``obs`` (A-vi).
``serve_trace`` drives ``iter_chunks`` through ``step_chunk`` when
``chunk_windows`` is set and ``iter_windows`` through ``step`` otherwise,
the two loops the reference documents as equal to its ring route. As in
``HybridServer``, ``use_kernel`` picks the kernels or their plain versions
(the reference's ``use_pallas``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core.artifact import TableArtifact
from repro_torch.device import resolve_device
from repro_torch.core.hybrid import (DeferredDispatch, backpatch_pending,
                                     chunk_dispatch, combine, dispatch)
from repro_torch.kernels.ops import fused_classify
from repro_torch.kernels.tuning import (TileConfig, _artifact_key,
                                        measure_min, sweep_best)
from repro_torch.netsim.stream import (EVICT_POLICIES, FlowTableState,
                                       PacketChunk, PacketWindow,
                                       chunk_update_readout,
                                       flow_table_readout, init_flow_table,
                                       iter_chunks, iter_windows,
                                       packet_chunk_from_arrays,
                                       window_update_readout)
from repro_torch.serving.hybrid_serving import HybridServer, HybridStats

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
                                 #      failed (always 0 until the fault
                                 #      policy is ported)
    flushes: torch.Tensor        # i32: backend invocations (== windows here)
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
    n_valid = _count(w.valid)
    n_handled = _count(w.valid & ~fwd)
    n_fwd = _count(fwd)
    rows = _count(valid)
    frac = (n_handled.to(torch.float32)
            / torch.clamp(n_valid, min=1).to(torch.float32))
    stats = dataclasses.replace(
        stats, windows=stats.windows + 1,
        packets=stats.packets + n_valid,
        handled=stats.handled + n_handled,
        backend_rows=stats.backend_rows + rows,
        deferred=stats.deferred + (n_fwd - rows),
        flushes=stats.flushes + 1,
        evicted=stats.evicted + n_evicted,
        overflow=stats.overflow + n_overflow,
        conf_sum=stats.conf_sum + _fold_conf(conf, w.valid))
    return stats, pred, frac, rows


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
                        threshold, capacity: int, *, tiles, device):
    """The batched half of the chunk step, after the register half produced
    the (K, W, 8) readout rows: ONE fused classify over the K*W rows, the
    dispatch of every window, the whole-chunk stats fold, and the pending
    predictions (pad and dead lanes at -1). Equal to K per-window passes
    because every op is row-independent.
    Returns (stats, dd, pending, frac, rows)."""
    k, w_lanes, nf = xs.shape
    sw_pred, conf = fused_classify(art, xs.reshape(k * w_lanes, nf),
                                   tiles=tiles, device=device)
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
                           reps: int = 3, seed: int = 0, cache_key=None,
                           time_fn=None) -> int:
    """Measured K sweep at server init: pick ``chunk_windows``.

    ``make_server(k)`` builds a throwaway server for chunk size k; each
    candidate is timed (``kernels.tuning.measure_min``: the warm-up call
    absorbs the probe and the graph capture) on one synthetic
    ``probe_chunk`` and scored per *packet*, so different Ks compete
    fairly. The ``default`` is always timed and the winner is the measured
    argmin over a set containing it (``kernels.tuning.sweep_best``), so the
    sweep never picks a K slower than the default on the tuned shape.
    ``time_fn(k) -> seconds`` replaces the measurement (deterministic
    tests); ``cache_key`` memoizes the winner and the timings. Each
    throwaway server's graphs are freed once it is timed.

    The probes call the real ``backend_fn``: a *stateful* backend sees
    those extra calls, so pair "auto" with a stateless backend. (The
    reference's ``candidate_filter`` serves its sharded tier, which the
    port does not have yet.)
    """
    if cache_key is not None:
        hit = _CHUNK_TUNE_CACHE.get(cache_key)
        if hit is not None:
            return hit[0]

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

    best, timings = sweep_best(candidates, time_k, default=default)
    if time_fn is None and torch.cuda.is_available():
        torch.cuda.empty_cache()        # the throwaway servers' graph pools
    if cache_key is not None:
        _CHUNK_TUNE_CACHE[cache_key] = (best, timings)
    return best


def chunk_sweep_timings(cache_key):
    """{K: seconds per packet} that the cached sweep under ``cache_key``
    measured, or None when it has not run."""
    hit = _CHUNK_TUNE_CACHE.get(cache_key)
    return None if hit is None else dict(hit[1])


def _clone_input(inp):
    """A window or chunk with its own copies of the columns."""
    return type(inp)(**{f.name: getattr(inp, f.name).clone()
                        for f in dataclasses.fields(inp)})


def _copy_input(dst, src) -> None:
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


class StreamingHybridServer(HybridServer):
    """HybridServer over a packet stream with per-flow register state.

    ``window`` is the packet chunk size ``serve_trace`` cuts the trace into;
    ``n_buckets`` sizes the flow register file. The batch ``classify`` of
    the parent stays available.
    """

    def __init__(self, artifact: TableArtifact, backend_fn: Callable, *,
                 n_buckets: int = 4096, window: int = 512,
                 threshold: float = 0.7, capacity: int = 64,
                 chunk_windows: Optional[Union[int, str]] = None,
                 evict_age: Optional[float] = None, saturate: bool = True,
                 evict_policy: str = "timeout", lru_occupancy: float = 0.75,
                 use_kernel: Optional[bool] = None, autotune: bool = False,
                 tiles: Optional[TileConfig] = None,
                 fuse: Optional[bool] = None, device=None):
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

        chunk_windows: serve ``serve_trace`` K windows at a time through
        ``step_chunk`` (see the module docstring); every chunk must then
        have exactly K rows. ``"auto"`` picks K by a measured sweep at init
        (``autotune_chunk_windows``, cached per artifact shape, backend and
        geometry; never slower than ``DEFAULT_CHUNK_WINDOWS`` on the tuned
        shape). None serves window by window.

        autotune, tiles: the switch kernel's launch configuration, passed
        to ``HybridServer`` as they are. fuse (CUDA only; a CPU server
        ignores it): None probes on the first step whether backend_fn syncs
        the host and serves each step shape as a CUDA graph if it does not;
        True captures without probing; False serves eagerly. A backend that
        reads mutable side channels must pass fuse=False.

        device=None serves on CUDA and raises without a card; pass
        device="cpu" for the plain path. use_kernel=None means "the kernels
        for CUDA tensors"; False runs every kernel's plain version on the
        server's device.
        """
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
        sweep = None
        if chunk_windows == "auto":
            # resolved before the check below, so it sees an int
            chunk_windows, sweep = self._resolve_auto_chunk_windows(
                artifact, backend_fn, n_buckets=n_buckets, window=window,
                threshold=threshold, capacity=capacity, evict_age=evict_age,
                saturate=saturate, evict_policy=evict_policy,
                lru_occupancy=lru_occupancy, use_kernel=use_kernel,
                autotune=autotune, tiles=tiles, fuse=fuse, device=device)
        if chunk_windows is not None and chunk_windows < 1:
            raise ValueError(f"chunk_windows must be >= 1, got {chunk_windows}")
        super().__init__(artifact, backend_fn, threshold=threshold,
                         capacity=capacity, use_kernel=use_kernel,
                         autotune=autotune, tiles=tiles, fuse=fuse,
                         device=device)
        self.n_buckets = n_buckets
        self.window = window
        self.chunk_windows = chunk_windows
        self.chunk_sweep = sweep   # {K: s per packet} of "auto"'s sweep
        self.evict_age = evict_age
        self.saturate = saturate
        self.evict_policy = evict_policy
        self.lru_occupancy = lru_occupancy
        # the carries: written in place by every step, read by the graphs
        self._regs = init_flow_table(n_buckets, device=self.device).regs
        self._stats = StreamStats.zero(self.device)
        self._step_graphs = {}     # (kind, shape) -> (graph, input, outputs)

    # -- the chunk-size autotune -------------------------------------------

    def _resolve_auto_chunk_windows(self, artifact, backend_fn, *, n_buckets,
                                    window, capacity, device, **kw):
        """-> (K, {K: seconds per packet} the sweep measured)."""
        dev = resolve_device(device)
        card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        # the route (graphs or eager) and the sweep change what K costs
        key = (type(self).__name__, _artifact_key(artifact), id(backend_fn),
               card, window, n_buckets, capacity, kw["fuse"],
               kw["evict_age"], kw["evict_policy"])
        k = autotune_chunk_windows(
            lambda k: StreamingHybridServer(
                artifact, backend_fn, chunk_windows=k, n_buckets=n_buckets,
                window=window, capacity=capacity, device=device, **kw),
            window=window, n_buckets=n_buckets, cache_key=key)
        return k, chunk_sweep_timings(key)

    # -- the carries ---------------------------------------------------------

    @property
    def state(self) -> FlowTableState:
        """The live register file, written in place by every step: read it,
        don't keep it."""
        return FlowTableState(self._regs)

    @property
    def stats(self) -> StreamStats:
        """A snapshot of the running telemetry (device tensors, no sync)."""
        return self._stats.clone()

    def flow_table(self) -> torch.Tensor:
        """(n_buckets, 8) feature table from the current registers."""
        return flow_table_readout(self.state)

    def reset(self):
        """Fresh register file + telemetry (a new stream epoch), refilled in
        place, so captured graphs stay valid."""
        self._regs.copy_(init_flow_table(self.n_buckets,
                                         device=self.device).regs)
        self._stats.zero_()

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

    # -- the two step kinds: switch half, then what follows the backend ------

    def _window_switch(self, regs, stats, w: PacketWindow, tau):
        state, x, n_ev, n_ov = window_update_readout(
            FlowTableState(regs), w, evict_age=self.evict_age,
            saturate=self.saturate, evict_policy=self.evict_policy,
            lru_occupancy=self.lru_occupancy,
            use_kernel=False if self.use_kernel is False else None)
        self._store_regs(regs, state)
        sw_pred, conf = fused_classify(self.artifact, x, tiles=self.tiles,
                                       device=self.device)
        fwd = (conf < tau) & w.valid
        buf, idx, valid = dispatch(x, fwd, self.capacity)
        return buf, (sw_pred, idx, valid, fwd, conf, n_ev, n_ov)

    def _window_finish(self, regs, stats, w: PacketWindow, ctx, be_pred):
        new, pred, frac, rows = accumulate_stream_stats(stats, w, ctx[0],
                                                        be_pred, *ctx[1:])
        stats.copy_(new)
        return pred, frac, rows

    def _chunk_switch(self, regs, stats, chunk: PacketChunk, tau):
        state, xs, n_ev, n_ov = chunk_update_readout(
            FlowTableState(regs), chunk, evict_age=self.evict_age,
            saturate=self.saturate, evict_policy=self.evict_policy,
            lru_occupancy=self.lru_occupancy,
            use_kernel=False if self.use_kernel is False else None)
        self._store_regs(regs, state)
        new, dd, pending, frac, rows = chunk_classify_tail(
            self.artifact, stats, chunk, xs, n_ev, n_ov, tau, self.capacity,
            tiles=self.tiles, device=self.device)
        stats.copy_(new)          # the backend accounting folds here too
        return dd.buf, (dd, pending, frac, rows)

    def _chunk_finish(self, regs, stats, chunk, ctx, be_pred):
        dd, pending, frac, rows = ctx
        return backpatch_pending(pending, be_pred, dd), frac, rows

    def _halves(self, kind: str):
        if kind == "window":
            return self._window_switch, self._window_finish
        return self._chunk_switch, self._chunk_finish

    def _backend(self, buf) -> torch.Tensor:
        return torch.as_tensor(self._backend_fn(buf), device=self.device)

    def _body(self, kind, regs, stats, inp, tau):
        """One whole step on the given carries -> (pred, frac, rows)."""
        switch, finish = self._halves(kind)
        buf, ctx = switch(regs, stats, inp, tau)
        return finish(regs, stats, inp, ctx, self._backend(buf))

    def _probe_backend(self, buf) -> torch.Tensor:
        """The backend's first call, with host syncs turned into errors: a
        backend that syncs cannot be captured, so it is called again
        normally and served eagerly from now on. The switch half has
        already run (the carries have advanced), so only the backend is
        retried, never the step."""
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            be = self._backend(buf)
            self._fused_ok = True
        except RuntimeError:
            self._fused_ok = False
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        return be if self._fused_ok else self._backend(buf)

    def _replay_step(self, kind: str, inp):
        """The step for ``inp``'s shape as a CUDA graph (captured at its
        first call), replayed on ``inp``; outputs cloned out of the graph's
        buffers. The warm-up before the capture runs on copies of the
        carries, so it advances nothing."""
        key = (kind, tuple(inp.bucket.shape))
        entry = self._step_graphs.get(key)
        self._tau.fill_(self.threshold)
        if entry is None:
            static = _clone_input(inp)
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._body(kind, self._regs.clone(), self._stats.clone(),
                           static, self._tau)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = self._body(kind, self._regs, self._stats, static,
                                  self._tau)
            entry = self._step_graphs[key] = (graph, static, outs)
        graph, static, outs = entry
        _copy_input(static, inp)
        graph.replay()
        return tuple(o.clone() for o in outs)

    def _serve(self, kind: str, inp):
        if self._fused_ok:
            pred, frac, rows = self._replay_step(kind, inp)
        else:
            switch, finish = self._halves(kind)
            buf, ctx = switch(self._regs, self._stats, inp, self.threshold)
            be = (self._probe_backend(buf) if self._fused_ok is None
                  else self._backend(buf))
            pred, frac, rows = finish(self._regs, self._stats, inp, ctx, be)
        return pred, HybridStats(frac, rows, self.capacity)

    # -- serving ---------------------------------------------------------------

    def step(self, w: PacketWindow):
        """Serve one window. -> (pred (W,), HybridStats for this window).

        Pad lanes report -1. Nothing here waits on the device (the first
        call may, to probe the backend; the second captures its graph).

        NOT retry-safe: the register file advances before the backend runs,
        so a backend exception leaves the window folded in — calling
        step(w) again double-counts it. Recover by reset() or by skipping
        the failed window, never by replaying it.
        """
        return self._serve("window", w)

    def step_chunk(self, chunk: PacketChunk):
        """Serve K stacked windows as one step.
        -> (pred (K, W), HybridStats for the chunk).

        The register half folds the chunk's windows in order, then one
        classify, one dispatch of every window, ONE backend call over the
        chunk's K*capacity rows and the back-patch: the predictions are
        final, pad and dead lanes at -1. Needs ``chunk_windows`` set, and a
        chunk of exactly that many windows of ``window`` lanes
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
        return self._serve("chunk", chunk)

    def serve_trace(self, trace, *, t0: Optional[float] = None):
        """Stream a whole PacketTrace. -> (pred (P,) on the server's device,
        stats).

        With ``chunk_windows`` the trace is cut by ``iter_chunks`` and every
        chunk goes through ``step_chunk``; otherwise ``iter_windows`` and
        ``step``. t0 defaults to the trace minimum. Per-packet predictions
        come back in arrival order with pad lanes stripped, equal on both
        routes. Ends with ``stats.check()``, the only sync.
        """
        if self.chunk_windows is not None:
            preds = [self.step_chunk(c)[0].reshape(-1) for c in iter_chunks(
                trace, self.window, self.chunk_windows, self.n_buckets,
                t0=t0, device=self.device)]
        else:
            preds = [self.step(w)[0] for w in iter_windows(
                trace, self.window, self.n_buckets, t0=t0,
                device=self.device)]
        n = len(trace.ts)
        flat = (torch.cat(preds)[:n] if preds
                else torch.zeros((0,), dtype=torch.int64, device=self.device))
        return flat, self.stats.check()
