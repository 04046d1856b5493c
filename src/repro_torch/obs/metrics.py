"""Metrics registry: counters/gauges/histograms + keyed windowed rollups.

Port of ``repro/obs/metrics.py`` (plain Python and numpy).

Two halves:

* ``MetricsRegistry`` — a flat named-metric store (counter / gauge /
  histogram) plus *sources*: callables returning the snapshot dict of an
  existing stats object. The four pre-observability telemetry objects
  (``StreamStats``, ``FaultStats``, ``IngestStats``, ``LatencyRecorder``)
  register as sources through their shared ``as_dict()``/``summary()``
  contract, so one ``snapshot()`` reports every tier's telemetry
  uniformly.

* ``RollupWindows`` — per-N-chunks windowed aggregation in the
  cowrieprocessor daily/weekly-rollup style: samples accumulate per
  *key* (today always ``"default"``; per-tenant rollups for ROADMAP
  item 2 drop in by keying on tenant id) and every ``every`` samples the
  window closes into one row carrying sums, the sample count, and the
  window index. Rows are bounded (``max_rows`` ring) so an open-ended
  stream cannot leak through its own rollups. The drift monitors
  (obs/drift.py) consume closed rollup rows.

Everything here is plain-python and host-side: reading a device-tensor
stat inside a registered source is the *source's* sync, taken only when
``snapshot()`` is called (the serving loop calls it at rollup
boundaries, never per window).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Optional

import numpy as np


class Counter:
    """Monotone event counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = None

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Streaming scalar distribution: count/sum/min/max plus a bounded
    sample ring for approximate percentiles."""

    __slots__ = ("n", "total", "min", "max", "_samples")

    def __init__(self, max_samples: int = 4096):
        self.n = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._samples: collections.deque = collections.deque(
            maxlen=max_samples)

    def observe(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        self._samples.append(v)

    def summary(self) -> dict:
        if not self.n:
            return {"n": 0, "mean": None, "min": None, "max": None,
                    "p50": None, "p95": None, "p99": None}
        s = np.fromiter(self._samples, np.float64)
        p50, p95, p99 = np.percentile(s, (50, 95, 99))
        return {"n": self.n, "mean": self.total / self.n,
                "min": self.min, "max": self.max, "p50": float(p50),
                "p95": float(p95), "p99": float(p99)}


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Named metrics + pluggable snapshot sources behind one snapshot().

    ``register_source(name, fn)`` takes any zero-arg callable returning a
    dict — the ``as_dict()`` of a stats object, a ``summary()``, a
    lambda reading live server state. ``snapshot()`` evaluates every
    source at call time, so a source bound to a server attribute that is
    replaced each step (e.g. ``lambda: srv.stats.as_dict()``) always
    reports the current value.
    """

    def __init__(self):
        self._metrics: dict = {}      # name -> (type_name, metric)
        self._sources: dict = {}      # name -> fn() -> dict

    def _get(self, name: str, type_name: str):
        hit = self._metrics.get(name)
        if hit is not None:
            if hit[0] != type_name:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{hit[0]}, requested {type_name}")
            return hit[1]
        m = _METRIC_TYPES[type_name]()
        self._metrics[name] = (type_name, m)
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge")

    def histogram(self, name: str) -> Histogram:
        return self._get(name, "histogram")

    def register_source(self, name: str, fn: Callable[[], dict]) -> None:
        """Attach (or replace) a named snapshot source."""
        self._sources[name] = fn

    def unregister_source(self, name: str) -> None:
        self._sources.pop(name, None)

    @property
    def source_names(self) -> tuple:
        return tuple(self._sources)

    def snapshot(self) -> dict:
        """One uniform telemetry dict: every metric and every source.

        Shape: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: summary...},
        "sources": {name: source_dict...}}``. A source that raises
        reports ``{"error": ...}`` instead of poisoning the snapshot
        (telemetry must never take the serving loop down).
        """
        out = {"counters": {}, "gauges": {}, "histograms": {},
               "sources": {}}
        for name, (tname, m) in sorted(self._metrics.items()):
            if tname == "counter":
                out["counters"][name] = m.value
            elif tname == "gauge":
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.summary()
        for name, fn in sorted(self._sources.items()):
            try:
                out["sources"][name] = dict(fn())
            except Exception as e:   # noqa: BLE001 — telemetry never raises
                out["sources"][name] = {"error": f"{type(e).__name__}: {e}"}
        return out


@dataclasses.dataclass
class _WindowAcc:
    """Open rollup window of one key: running sums + sample count."""
    n: int = 0
    sums: dict = dataclasses.field(default_factory=dict)
    first_seq: Optional[int] = None


class RollupWindows:
    """Keyed per-N-samples rollup aggregation (cowrieprocessor style).

    ``observe(sample, key=...)`` folds one numeric sample dict into the
    key's open window; after ``every`` samples the window *closes* into
    a row ``{"key", "window", "samples", "sums": {...}}`` appended to
    the bounded ``rows`` ring — and returned, so the caller can feed it
    straight to a drift monitor. Non-numeric sample values are dropped
    (rollups are arithmetic); list values of equal length are summed
    element-wise (class-count vectors).

    ``flush(key)`` / ``flush_all()`` close partial windows (end of
    stream); empty windows never produce rows.
    """

    def __init__(self, every: int = 8, max_rows: int = 4096):
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        self.every = every
        self._acc: dict = {}              # key -> _WindowAcc
        self._windows: dict = {}          # key -> closed-window count
        self.rows: collections.deque = collections.deque(maxlen=max_rows)

    @staticmethod
    def _fold(sums: dict, sample: dict) -> None:
        for k, v in sample.items():
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, (int, float)):
                sums[k] = sums.get(k, 0) + v
            elif isinstance(v, (list, tuple, np.ndarray)):
                arr = np.asarray(v, np.float64)
                prev = sums.get(k)
                sums[k] = arr if prev is None else np.asarray(prev) + arr
            # non-numeric: dropped (rollups are arithmetic)

    def observe(self, sample: dict, key: str = "default"):
        """Fold one sample; returns the closed row when the window
        completes, else None."""
        acc = self._acc.get(key)
        if acc is None:
            acc = self._acc[key] = _WindowAcc()
        self._fold(acc.sums, sample)
        acc.n += 1
        if acc.n >= self.every:
            return self.flush(key)
        return None

    def flush(self, key: str = "default"):
        """Close the key's open window (even if partial). -> row or None."""
        acc = self._acc.pop(key, None)
        if acc is None or acc.n == 0:
            return None
        idx = self._windows.get(key, 0)
        self._windows[key] = idx + 1
        sums = {k: (np.asarray(v).tolist()
                    if isinstance(v, np.ndarray) else v)
                for k, v in acc.sums.items()}
        row = {"key": key, "window": idx, "samples": acc.n, "sums": sums}
        self.rows.append(row)
        return row

    def flush_all(self) -> list:
        return [r for r in (self.flush(k) for k in list(self._acc))
                if r is not None]

    def rows_for(self, key: str = "default") -> list:
        return [r for r in self.rows if r["key"] == key]

    @property
    def n_rows(self) -> int:
        return len(self.rows)
