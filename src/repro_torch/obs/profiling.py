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

* **spans** — ``torch.profiler.record_function`` ranges that open only
  while a torch profiler records (``tracing()``), so a served call pays
  one check when none does. The servers' entries (``classify``,
  ``step``, ``step_chunk``, ``flush``), traced, run inside
  ``entry_call``, which opens ``repro_torch.entry`` around the call and,
  inside it,
  ``.input`` (the threshold fill and the copies into a graph's static
  buffers), ``.replay`` (``graph.replay()``), ``.output`` (the clones out
  of its buffers), ``.capture`` (the warm-up and the capture, once a
  shape), ``.probe`` (the first call's probe of the backend) and
  ``.eager`` (the two-phase route). Kineto records these ranges and the
  device's work on one clock, so a device idle gap falls inside the span
  the host was in. ``annotation(name, enabled)`` opens any such range
  under the same gate.

* **phase marks** — the reference separates the register scan and the
  fused classify inside its jitted step with ``jax.named_scope``
  metadata. The port's counterpart: a step body calls ``phase(name)`` at
  each of its phase boundaries. While ``capture_phases()`` records a
  CUDA graph's capture, each mark counts the device nodes (kernel,
  memcpy, memset) the graph under capture holds so far
  (``capture_nodes``), so each phase owns the nodes captured after its
  mark. A replay runs no Python, so the marks cost nothing there;
  outside a capture ``phase`` returns at once. A graph captured from one
  stream is a chain that runs its nodes in capture order, so a replay's
  device events in a profiler's trace, in order of start, split by the
  marks' counts (``graph_phases()`` on each server hands them out).

Stage vocabulary used by the serving tiers: ``ring_cut`` (pull source +
admit + window-granular pack), ``h2d`` (HostCut -> device PacketChunk; with
prefetch on the card, the pinned staging and the enqueue of the side
stream's copies, timed on the prefetch thread), ``megastep`` (step
dispatch), ``megastep_synced`` (sampled: dispatch + device completion),
``backend_flush`` (host backend call on the two-phase path), ``backpatch``
(the back-patch on the two-phase path).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import threading
import time
from typing import Callable, Optional

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


# -- spans ----------------------------------------------------------------------

ENTRY = "repro_torch.entry"
ENTRY_INPUT = ENTRY + ".input"
ENTRY_REPLAY = ENTRY + ".replay"
ENTRY_OUTPUT = ENTRY + ".output"
ENTRY_CAPTURE = ENTRY + ".capture"
ENTRY_PROBE = ENTRY + ".probe"
ENTRY_EAGER = ENTRY + ".eager"

_OFF = contextlib.nullcontext()


# tracing() -> whether a torch profiler records on this process: the one
# check a served call pays for its spans (PyTorch's own C function, so the
# check adds no Python frame)
tracing = torch.autograd._profiler_enabled


def annotation(name: str, enabled: bool = True):
    """A ``torch.profiler.record_function(name)`` range when enabled and a
    profiler records, else a null context: with no profiler running it
    costs the check and opens nothing."""
    if enabled and tracing():
        return torch.profiler.record_function(name)
    return _OFF


def entry_call(fn: Callable, *args):
    """``fn(*args, True)`` inside the ``repro_torch.entry`` range: an
    entry's traced call, once ``tracing()`` has said a profiler records
    (the untraced call is ``fn(*args, False)``, with no range). The flag
    tells ``fn`` to open its inner spans."""
    with torch.profiler.record_function(ENTRY):
        return fn(*args, True)


# -- phase marks --------------------------------------------------------------

DEVICE_NODE_TYPES = (0, 1, 2)   # CUgraphNodeType: kernel, memcpy, memset
_CAPTURE_ACTIVE = 1             # CUstreamCaptureStatus
_marks = threading.local()      # .open: the recorders of this thread's captures


class PhaseMarks:
    """The marks of one capture: each ``mark(name)`` takes ``count()``,
    the device nodes captured so far. ``close()`` takes the count at the
    capture's end; ``result`` is then ``((phase, nodes), ...)`` in capture
    order, summing to the graph's device nodes (a first entry
    ``("unmarked", n)`` holds nodes captured before the first mark)."""

    def __init__(self, count: Callable[[], int]):
        self.count = count
        self.at = []                # (phase, nodes before its first node)
        self.result = None

    def mark(self, name: str) -> None:
        self.at.append((name, self.count()))

    def close(self) -> None:
        ends = [n for _, n in self.at[1:]] + [self.count()]
        marks = [(name, end - start)
                 for (name, start), end in zip(self.at, ends)]
        first = self.at[0][1] if self.at else ends[-1]
        if first:
            marks.insert(0, ("unmarked", first))
        self.result = tuple(marks)


def phase(name: str) -> None:
    """Mark the start of phase ``name`` in the CUDA graph this thread is
    capturing under ``capture_phases``; outside one, return at once."""
    open_ = getattr(_marks, "open", None)
    if open_:
        open_[-1].mark(name)


@contextlib.contextmanager
def capture_phases(count: Optional[Callable[[], int]] = None):
    """Record the ``phase`` marks of the body run inside the block: open it
    inside ``torch.cuda.graph(...)``, around the body, so its end still
    counts the graph under capture. ``count`` (default ``capture_nodes``)
    counts the device nodes captured so far. -> the ``PhaseMarks``, whose
    ``result`` is set once the block ends without an error."""
    rec = PhaseMarks(count or capture_nodes)
    open_ = getattr(_marks, "open", None)
    if open_ is None:
        open_ = _marks.open = []
    open_.append(rec)
    try:
        yield rec
        rec.close()
    finally:
        open_.pop()


@functools.lru_cache(maxsize=1)
def _driver():
    """libcuda's graph queries, through ctypes (torch has loaded the
    library). ``cuStreamGetCaptureInfo_v2`` is CUDA 12's entry point."""
    lib = ctypes.CDLL("libcuda.so.1")
    info = lib.cuStreamGetCaptureInfo_v2
    info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_uint64),
                     ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_size_t)]
    nodes = lib.cuGraphGetNodes
    nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.POINTER(ctypes.c_size_t)]
    kind = lib.cuGraphNodeGetType
    kind.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    for fn in (info, nodes, kind):
        fn.restype = ctypes.c_int
    return info, nodes, kind


def _check(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"{what} failed with CUresult {rc}")


def capture_nodes() -> int:
    """Device nodes (kernel, memcpy, memset) of the CUDA graph the current
    stream is capturing."""
    info, get_nodes, get_kind = _driver()
    stream = torch.cuda.current_stream()
    status, gid = ctypes.c_int(), ctypes.c_uint64()
    graph, deps, n_deps = ctypes.c_void_p(), ctypes.c_void_p(), \
        ctypes.c_size_t()
    _check(info(stream.cuda_stream, ctypes.byref(status), ctypes.byref(gid),
                ctypes.byref(graph), ctypes.byref(deps),
                ctypes.byref(n_deps)), "cuStreamGetCaptureInfo")
    if status.value != _CAPTURE_ACTIVE:
        raise RuntimeError("capture_nodes: the stream is not capturing")
    n = ctypes.c_size_t(0)
    _check(get_nodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    if not n.value:
        return 0
    nodes = (ctypes.c_void_p * n.value)()
    _check(get_nodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, count = ctypes.c_int(), 0
    for node in nodes[:n.value]:
        _check(get_kind(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        count += kind.value in DEVICE_NODE_TYPES
    return count
