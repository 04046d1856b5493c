"""Unified observability for the serving loop (DESIGN.md §14).

Port of ``repro/obs``. One ``Observability`` object bundles the obs
primitives behind the hooks the serving tiers call:

  events    ``obs.events``  — structured JSON-lines lifecycle events
                              (obs/events.py), bounded ring + optional
                              file sink;
  metrics   ``obs.metrics`` — counters/gauges/histograms plus snapshot
                              *sources* unifying StreamStats /
                              FaultStats / IngestStats / LatencyRecorder
                              behind one ``snapshot()`` (obs/metrics.py);
  rollups   ``obs.rollups`` — keyed per-N-dispatches windowed aggregation
                              (obs/metrics.RollupWindows);
  timing    ``obs.timer``   — per-stage wall timers with sampled device
                              synchronization (obs/profiling.py);
  drift     ``obs.drift``   — confidence-collapse / fraction_handled /
                              class-mix monitors over the rollup rows
                              (obs/drift.py), emitting ``drift_alarm``
                              events.

The contract with the serving tiers: a server built with ``obs=None``
(the default) takes NO observability branches (every hook site is guarded
by ``if obs is not None``). A server built with an ``Observability``
emits host-side events and, once per ``rollup_every`` dispatches (a
dispatch = one chunk step or one window step), reads its device stats
ONCE to close a rollup window; at the default ``sync_every=0`` it adds no
other sync, so predictions stay bit-identical with obs on and off.

Usage::

    obs = Observability(events_path="events.jsonl", rollup_every=8)
    srv = StreamingHybridServer(art, backend, chunk_windows=8, obs=obs)
    preds, stats = srv.serve_trace(trace)
    obs.snapshot()          # unified metrics + stage timings + drift
    obs.drift.alarms        # what fired (also "drift_alarm" events)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.obs.drift import (DETECTORS, DriftAlarm, DriftConfig,
                             DriftMonitor)
from repro_torch.obs.events import (EVENT_KINDS, EVENT_SCHEMA_VERSION, Event,
                              EventBus, EventSchemaError, JsonlSink,
                              iter_event_lines, validate_event_line,
                              validate_event_log)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               RollupWindows)
from repro_torch.obs.profiling import (STAGES, SampledSync, StageTimer,
                                 annotation)

__all__ = [
    "DETECTORS", "DriftAlarm", "DriftConfig", "DriftMonitor",
    "EVENT_KINDS", "EVENT_SCHEMA_VERSION", "Event", "EventBus",
    "EventSchemaError", "JsonlSink", "iter_event_lines",
    "validate_event_line", "validate_event_log",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RollupWindows",
    "STAGES", "SampledSync", "StageTimer", "annotation",
    "ObsConfig", "Observability",
]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Knobs of one Observability instance.

    events_path    JSON-lines sink file (None: in-memory ring only);
    max_events     in-memory event ring capacity;
    rollup_every   dispatches (chunk steps / window steps) per rollup
                   window — also the cadence of the ONE device-stats read
                   the serving loop takes per window;
    sync_every     sampled-synchronization cadence: every N-th dispatch
                   blocks until device-complete inside the
                   ``megastep_synced`` stage (0 = never, the default —
                   the zero-sync loop is preserved exactly);
    annotate       let ``Observability.annotate`` open its
                   ``record_function`` ranges (while a profiler records);
                   the servers' entries open theirs whenever one records
                   (obs/profiling.py);
    drift          DriftConfig of the monitors (None: defaults);
    drift_enabled  False disables drift detection entirely.
    """
    events_path: Optional[str] = None
    max_events: int = 65536
    rollup_every: int = 8
    sync_every: int = 0
    annotate: bool = False
    drift: Optional[DriftConfig] = None
    drift_enabled: bool = True

    def __post_init__(self):
        if self.rollup_every < 1:
            raise ValueError(f"rollup_every must be >= 1, "
                             f"got {self.rollup_every}")


class Observability:
    """The facade the serving tiers hold (see module doc).

    Construct from an ``ObsConfig`` or keyword knobs::

        Observability(rollup_every=4, events_path="events.jsonl")
    """

    def __init__(self, config: Optional[ObsConfig] = None, **knobs):
        if config is not None and knobs:
            raise ValueError("pass an ObsConfig or keyword knobs, not both")
        self.config = config or ObsConfig(**knobs)
        c = self.config
        sink = JsonlSink(c.events_path) if c.events_path else None
        self.events = EventBus(sink=sink, max_events=c.max_events)
        self.metrics = MetricsRegistry()
        # serving rollup samples are boundary deltas covering rollup_every
        # dispatches each, so every observed sample closes one row
        self.rollups = RollupWindows(every=1)
        self.timer = StageTimer()
        self.sync = SampledSync(c.sync_every)
        self.drift = DriftMonitor(c.drift) if c.drift_enabled else None
        self._ticks = 0           # dispatches since the last rollup row

    # -- serving hooks -------------------------------------------------------

    def bind(self, server, name: str = "server") -> None:
        """Register the server's stats objects as snapshot sources.

        Late-bound lambdas: the server replaces ``_stats`` every step and
        ``ingest_stats``/``latency`` every serve_stream, so sources read
        the *current* object at snapshot() time. Reading the stream
        source syncs its device scalars — snapshot() is a telemetry
        call, not a hot-path one.
        """
        self.metrics.register_source(
            f"{name}.stream", lambda: server.stats.as_dict())
        self.metrics.register_source(
            f"{name}.faults",
            lambda: (server.fault_stats.as_dict()
                     if server.fault_stats is not None else {}))
        self.metrics.register_source(
            f"{name}.ingest",
            lambda: (server.ingest_stats.as_dict()
                     if server.ingest_stats is not None else {}))
        self.metrics.register_source(
            f"{name}.latency",
            lambda: (server.latency.summary()
                     if server.latency is not None else {}))

    def emit(self, kind: str, **fields) -> Event:
        return self.events.emit(kind, **fields)

    def stage(self, name: str):
        """Time a pipeline stage (context manager)."""
        return self.timer.stage(name)

    def annotate(self, name: str):
        """A profiler range around a block of the caller's (null context
        unless ``annotate`` is configured and a profiler records)."""
        return annotation(name, self.config.annotate)

    def sync_due(self) -> bool:
        """Sampled synchronization: should this dispatch block until
        device-complete (inside the ``megastep_synced`` stage)?"""
        return self.sync.due()

    def tick(self) -> bool:
        """Count one dispatch; True at each rollup boundary."""
        self._ticks += 1
        if self._ticks >= self.config.rollup_every:
            self._ticks = 0
            return True
        return False

    @property
    def pending_ticks(self) -> int:
        """Dispatches since the last rollup row (the end-of-stream
        partial window the serving loop flushes)."""
        return self._ticks

    def reset_ticks(self) -> None:
        self._ticks = 0

    def observe_rollup(self, sample: dict, key: str = "default") -> dict:
        """Close one rollup window from a boundary-delta sample: emit the
        ``rollup`` event, feed the drift monitors, emit a ``drift_alarm``
        event (and count a metric) per alarm. Returns the closed row."""
        row = self.rollups.observe(sample, key=key)   # every=1: closes now
        self.emit("rollup", key=key, window=row["window"],
                  packets=int(sample.get("packets", 0)),
                  dispatches=int(sample.get("dispatches", 0)))
        if self.drift is not None:
            for alarm in self.drift.observe(row):
                self.emit("drift_alarm", **alarm.as_fields())
                self.metrics.counter(
                    f"drift.{alarm.detector}").inc()
        return row

    # -- reading -------------------------------------------------------------

    @property
    def alarms(self) -> list:
        return self.drift.alarms if self.drift is not None else []

    def snapshot(self) -> dict:
        """Everything at once: the metrics registry snapshot (counters /
        gauges / histograms / sources), per-stage timings, event counts,
        and the drift state."""
        out = self.metrics.snapshot()
        out["stages"] = self.timer.summary()
        out["events"] = {"emitted": self.events.emitted,
                         "buffered": len(self.events),
                         "by_kind": self.events.counts()}
        out["drift"] = {
            "enabled": self.drift is not None,
            "alarms": [dataclasses.asdict(a) for a in self.alarms],
            "fired_detectors": list(
                self.drift.fired_detectors) if self.drift else [],
        }
        return out

    def close(self) -> None:
        self.events.close()
