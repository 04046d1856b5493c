"""Per-stage timing for the serving pipeline, with sampled device sync.

Port of ``repro/obs/profiling.py``. PyTorch on the card is asynchronous:
``step_chunk`` *enqueues* its kernels (or replays its CUDA graph) and
returns, so host timers around it measure the enqueue, not device work.
The decomposition this module provides:

* ``StageTimer.stage(name)`` — wall-time a pipeline stage (ring cut, host
  pack, H2D transfer, step dispatch, backend flush, back-patch).
  Durations accumulate per stage with a bounded sample ring for
  percentiles; appends are atomic under the GIL, so the prefetch thread
  may time its stages too.

* **sampled synchronization** — every ``sync_every``-th dispatch (0 =
  never, the default) the serving loop waits until that dispatch's
  predictions are complete on the device inside a ``*_synced`` stage, so
  the sampled duration covers enqueue + device execution. A sync drains
  the queue of work, which is why it is off by default; it changes *when*
  the host waits, never a value.

* ``annotation(name)`` — a ``torch.profiler.record_function`` range around
  a step while a profiler trace is captured (the step's phases show in the
  trace's timeline); a null context when disabled.

Stage vocabulary used by the serving tiers: ``ring_cut`` (pull source +
admit + window-granular pack), ``h2d`` (HostCut -> device PacketChunk; with
prefetch on the card, the pinned staging and the enqueue of the side
stream's copies, timed on the prefetch thread), ``megastep`` (step
dispatch), ``megastep_synced`` (sampled: dispatch + device completion),
``backend_flush`` (host backend call on the two-phase path), ``backpatch``
(the back-patch on the two-phase path). The reference also separates the
register scan and the fused classify inside its jitted step with
``jax.named_scope`` metadata. A replayed CUDA graph has no counterpart:
its kernels run without the host, so no range can be opened inside a
replay; the profiler's kernel names are what tells them apart.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable

import numpy as np
import torch

STAGES = ("ring_cut", "h2d", "megastep", "megastep_synced",
          "backend_flush", "backpatch")


class StageTimer:
    """Accumulate wall durations per named stage (bounded memory)."""

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 max_samples: int = 4096):
        self._clock = clock
        self._max = max_samples
        self._acc: dict = {}     # name -> [n, total_s, max_s, deque]

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.record(name, self._clock() - t0)

    def record(self, name: str, seconds: float) -> None:
        acc = self._acc.get(name)
        if acc is None:
            acc = self._acc[name] = [0, 0.0, 0.0,
                                     collections.deque(maxlen=self._max)]
        acc[0] += 1
        acc[1] += seconds
        acc[2] = max(acc[2], seconds)
        acc[3].append(seconds)

    @property
    def stages(self) -> tuple:
        return tuple(self._acc)

    def count(self, name: str) -> int:
        acc = self._acc.get(name)
        return acc[0] if acc else 0

    def total(self, name: str) -> float:
        acc = self._acc.get(name)
        return acc[1] if acc else 0.0

    def summary(self) -> dict:
        """stage -> {n, total_s, mean_ms, p50_ms, p95_ms, max_ms}."""
        out = {}
        for name, (n, total, mx, samples) in sorted(self._acc.items()):
            s = np.fromiter(samples, np.float64) * 1e3
            p50, p95 = (np.percentile(s, (50, 95)) if s.size
                        else (float("nan"), float("nan")))
            out[name] = {"n": n, "total_s": total,
                         "mean_ms": total / n * 1e3 if n else None,
                         "p50_ms": float(p50) if s.size else None,
                         "p95_ms": float(p95) if s.size else None,
                         "max_ms": mx * 1e3}
        return out

    def reset(self) -> None:
        self._acc.clear()


class SampledSync:
    """Every-N counter deciding which dispatches get a blocking device sync.

    ``due()`` advances the counter and returns True on the N-th, 2N-th, ...
    call; ``every=0`` (default) never syncs.
    """

    def __init__(self, every: int = 0):
        if every < 0:
            raise ValueError(f"sync_every must be >= 0, got {every}")
        self.every = every
        self._i = 0

    def due(self) -> bool:
        if not self.every:
            return False
        self._i += 1
        if self._i >= self.every:
            self._i = 0
            return True
        return False


def annotation(name: str, enabled: bool = True):
    """A ``torch.profiler.record_function(name)`` range when enabled, else
    a null context. The range shows only inside a captured profiler trace;
    outside one it costs a no-op."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
