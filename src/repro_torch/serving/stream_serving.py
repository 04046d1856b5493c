"""Streaming hybrid serving: the always-on switch, one window at a time.

Port of ``repro/serving/stream_serving.py`` (the per-window path,
``flush_every=1``). ``StreamingHybridServer`` extends ``HybridServer`` with
the register-file carry of ``netsim.stream``: each ``step(window)`` runs

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

in that order, eagerly, with the backend called between the switch half
and the fold. Nothing in ``step`` waits on the device: state and running
statistics stay device tensors, per-window telemetry returns as a lazy
``HybridStats``, and predictions stay on the device until the caller reads
them. The register file is consumed by every step and replaced by the
returned one, so callers read ``state`` and never keep it.

Left out until their slices: ``flush_every`` and the cross-window deferral
(A7), ``chunk_windows`` and the chunked megastep (A6), ``flush_occupancy``,
``flush_deadline`` and ``fault_policy`` (A7), ``obs`` (A9), and
``serve_stream`` with the ingest ring (A8). ``serve_trace`` drives
``iter_windows`` through ``step``, which the reference documents as
bit-identical to its ring route. As in ``HybridServer``, the reference's
``use_pallas``, ``autotune`` and ``fuse`` steer ``jax.jit`` and have no
meaning here; ``use_kernel`` picks the kernels or their plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.artifact import TableArtifact
from repro_torch.core.hybrid import combine, dispatch
from repro_torch.kernels.ops import fused_classify
from repro_torch.kernels.tuning import TileConfig
from repro_torch.netsim.stream import (EVICT_POLICIES, FlowTableState,
                                       PacketWindow, flow_table_readout,
                                       init_flow_table, iter_windows,
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


class StreamingHybridServer(HybridServer):
    """HybridServer over a packet stream with per-flow register state.

    ``window`` is the packet chunk size ``serve_trace`` cuts the trace into;
    ``n_buckets`` sizes the flow register file. The batch ``classify`` of
    the parent stays available.
    """

    def __init__(self, artifact: TableArtifact, backend_fn: Callable, *,
                 n_buckets: int = 4096, window: int = 512,
                 threshold: float = 0.7, capacity: int = 64,
                 evict_age: Optional[float] = None, saturate: bool = True,
                 evict_policy: str = "timeout", lru_occupancy: float = 0.75,
                 use_kernel: Optional[bool] = None,
                 tiles: Optional[TileConfig] = None, device=None):
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
        super().__init__(artifact, backend_fn, threshold=threshold,
                         capacity=capacity, use_kernel=use_kernel,
                         tiles=tiles, device=device)
        self.n_buckets = n_buckets
        self.window = window
        self.evict_age = evict_age
        self.saturate = saturate
        self.evict_policy = evict_policy
        self.lru_occupancy = lru_occupancy
        self._state = init_flow_table(n_buckets, device=self.device)
        self._stats = StreamStats.zero(self.device)

    @property
    def state(self) -> FlowTableState:
        """Current register file. Consumed by every step: read, don't keep."""
        return self._state

    @property
    def stats(self) -> StreamStats:
        return self._stats

    def flow_table(self) -> torch.Tensor:
        """(n_buckets, 8) feature table from the current registers."""
        return flow_table_readout(self._state)

    def reset(self):
        """Fresh register file + telemetry (a new stream epoch)."""
        self._state = init_flow_table(self.n_buckets, device=self.device)
        self._stats = StreamStats.zero(self.device)

    def step(self, w: PacketWindow):
        """Serve one window. -> (pred (W,), HybridStats for this window).

        Pad lanes report -1. Nothing here waits on the device.

        NOT retry-safe: the register file advances before the backend runs,
        so a backend exception leaves the window folded in — calling
        step(w) again double-counts it. Recover by reset() or by skipping
        the failed window, never by replaying it.
        """
        self._state, x, n_ev, n_ov = window_update_readout(
            self._state, w, evict_age=self.evict_age, saturate=self.saturate,
            evict_policy=self.evict_policy, lru_occupancy=self.lru_occupancy,
            use_kernel=False if self.use_kernel is False else None)
        sw_pred, conf = fused_classify(self.artifact, x, tiles=self.tiles,
                                       device=self.device)
        fwd = (conf < self.threshold) & w.valid
        buf, idx, valid = dispatch(x, fwd, self.capacity)
        be_pred = torch.as_tensor(self._backend_fn(buf), device=self.device)
        self._stats, pred, frac, rows = accumulate_stream_stats(
            self._stats, w, sw_pred, be_pred, idx, valid, fwd, conf, n_ev,
            n_ov)
        return pred, HybridStats(frac, rows, self.capacity)

    def serve_trace(self, trace, *, t0: Optional[float] = None):
        """Stream a whole PacketTrace window by window. -> (pred (P,) on the
        server's device, stats).

        The trace is cut by ``iter_windows`` (t0 defaults to the trace
        minimum) and every window goes through ``step``; per-packet
        predictions come back in arrival order with pad lanes stripped.
        Ends with ``stats.check()``, the only sync.
        """
        preds = [self.step(w)[0] for w in iter_windows(
            trace, self.window, self.n_buckets, t0=t0, device=self.device)]
        n = len(trace.ts)
        flat = (torch.cat(preds)[:n] if preds
                else torch.zeros((0,), dtype=torch.int64, device=self.device))
        return flat, self._stats.check()
