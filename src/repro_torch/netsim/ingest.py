"""Open-ended packet ingest: host ring buffer -> window-granular cuts.

Port of ``repro/netsim/ingest.py``. ``serve_trace`` takes a complete,
finite trace; the deployment shape is a stream that never ends: packets
are *admitted* into a host-side ring buffer as they arrive and *cut* into
``PacketChunk``s by whichever fires first —

  count cut     ``chunk_windows`` complete windows are buffered (the
                steady-state path: a full (K, W) chunk, no padding)
  deadline cut  the oldest buffered packet has waited ``deadline`` wall
                seconds and at least one complete window is buffered
  drain cut     the source is exhausted; whatever remains (including a
                ragged partial window) is flushed

Every cut is **window-granular**: it emits only *complete* windows (the
drain cut's ragged tail is the one exception, exactly like the final
``iter_windows`` window). Window boundaries, and therefore per-packet
register readouts, classifications and dispatch groupings, are a pure
function of packet arrival order, never of cut timing; a deadline cut only
changes how many chunks the same windows are grouped into.

The packing discipline is shared with ``iter_chunks`` through
``stream.pack_chunk_columns`` (the ragged live window replicate-pads the
last packet with valid=False; missing windows are dead, all-zero and all
invalid), so replaying a finite trace through the ring produces bit for
bit the chunks of ``iter_chunks``.

Backpressure: driven by ``cut_stream`` the ring is *pull-based*:
admission pauses (the source iterator is simply not advanced) while the
buffer is full, so nothing is ever dropped and ``capacity`` bounds host
memory, not correctness. Push-style callers that cannot pause admission
construct the ring with ``drop=True``, and ``admit`` tail-drops instead
(counted in ``IngestStats.dropped``) rather than raising.

The ring, the cuts and ``LatencyRecorder`` are host numpy, copied from the
reference (the same seeded reservoir). The device side is the port's own:
``HostCut.to_chunk`` / ``to_windows`` move a cut's columns to the device
in one copy of one pinned buffer (a window is a row slice of them), and
``PinnedStaging`` is the transfer half of the prefetch pipeline on the
card, where the reference's ``jnp.asarray`` on the prefetch thread starts
an asynchronous transfer: the cut is packed into a pinned host buffer (a
small pool reused round robin, a buffer only after its last copy has
completed) and copied in one ``non_blocking=True`` copy on a side CUDA
stream, and the chunk travels with the event recorded after its copy.
The consumer makes its stream wait on that event before the step reads
the chunk (``await_chunk``).
``prefetch_iter`` runs the cut -> device map on a background thread with
a small bounded queue, so chunk k+1's columns are in flight while chunk k
runs.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.netsim.stream import (PacketChunk, PacketWindow,
                                       pack_chunk_columns, trace_columns)

# host column layout of one admitted packet (dtypes match trace_columns)
COLUMN_DTYPES = (("bucket", np.int32), ("ts", np.float32),
                 ("length", np.float32), ("is_fwd", np.float32))

CUT_KINDS = ("count", "deadline", "drain")


@dataclasses.dataclass
class IngestStats:
    """Host-side ring telemetry (wall-clock domain, unlike StreamStats)."""
    admitted: int = 0          # packets accepted into the ring
    dropped: int = 0           # packets tail-dropped (drop=True rings only)
    count_cuts: int = 0        # full (K, W) chunks cut by occupancy
    deadline_cuts: int = 0     # partial chunks cut by admit-age deadline
    drain_cuts: int = 0        # end-of-source flush cuts

    @property
    def cuts(self) -> int:
        return self.count_cuts + self.deadline_cuts + self.drain_cuts

    def as_dict(self) -> dict:
        """The snapshot contract shared with StreamStats and FaultStats,
        derived ``cuts`` included."""
        return dict(dataclasses.asdict(self), cuts=self.cuts)


# the staged columns with their torch dtypes (those of COLUMN_DTYPES) and
# bytes a lane, in their order in a staging buffer: the 4-byte columns
# first, so each starts 4-byte aligned
_STAGED = (("bucket", torch.int32, 4), ("ts", torch.float32, 4),
           ("length", torch.float32, 4), ("is_fwd", torch.float32, 4),
           ("valid", torch.bool, 1))
_LANE_BYTES = sum(b for _, _, b in _STAGED)


def _column_views(buf: torch.Tensor, n: int) -> dict:
    """The staged columns as typed (n,) views of one uint8 buffer."""
    out, off = {}, 0
    for k, dt, b in _STAGED:
        out[k] = buf[off:off + b * n].view(dt)
        off += b * n
    return out


def _pack(host: dict, cols: dict, valid: np.ndarray) -> None:
    """Write a cut's columns and ``valid`` into a staging buffer's numpy
    views (``host``, from ``_column_views``)."""
    for k, view in host.items():
        view[:] = valid if k == "valid" else cols[k]


def _columns_on(cols: dict, valid: np.ndarray, device) -> dict:
    """Every column (and ``valid``) on ``device``. To a CUDA device they
    are packed side by side into one pinned block of PyTorch's host cache
    (the ``PinnedStaging`` layout) and cross in ONE ``non_blocking`` copy on
    the current stream, which waits on nothing on the host and is ordered
    before the step that reads it; the columns are typed views of the
    copy. The host cache reuses the block only after the copy is done."""
    if device.type != "cuda":
        return {k: torch.as_tensor(v, device=device)
                for k, v in dict(cols, valid=valid).items()}
    n = len(valid)
    buf = torch.empty(_LANE_BYTES * n, dtype=torch.uint8, pin_memory=True)
    _pack({k: v.numpy() for k, v in _column_views(buf, n).items()}, cols,
          valid)
    return _column_views(buf.to(device, non_blocking=True), n)


@dataclasses.dataclass
class HostCut:
    """One window-granular cut: host columns for up to ``rows`` windows.

    ``cols``/``valid`` are flat (rows*window,) arrays in the
    ``pack_chunk_columns`` layout: live packets first, the replicate-padded
    ragged window, then dead windows. ``admit_time`` holds the wall clock
    each of the ``n`` live packets entered the ring (latency accounting);
    ``kind`` records which trigger fired.
    """
    cols: dict
    valid: np.ndarray
    admit_time: np.ndarray   # (n,) float64 wall seconds
    n: int                   # live packets
    window: int
    rows: int                # total windows incl. dead padding
    kind: str

    @property
    def n_windows(self) -> int:
        """Live (non-dead) windows in this cut."""
        return -(-self.n // self.window) if self.n else 0

    def to_chunk(self, *, device=None) -> PacketChunk:
        """The (rows, window) chunk on ``device`` (None: CUDA), the
        ``step_chunk`` input; one copy, on the current stream."""
        on = _columns_on(self.cols, self.valid, resolve_device(device))
        return PacketChunk(**{k: v.reshape(self.rows, self.window)
                              for k, v in on.items()})

    def to_windows(self, *, device=None) -> Iterator[PacketWindow]:
        """The cut's *live* windows one by one on ``device`` (None: CUDA),
        the per-window path's input (dead padding windows are skipped).
        The columns cross to the device once; a window is a row slice."""
        if not self.n:
            return
        live = self.n_windows * self.window
        on = _columns_on({k: v[:live] for k, v in self.cols.items()},
                         self.valid[:live], resolve_device(device))
        for r in range(self.n_windows):
            sl = slice(r * self.window, (r + 1) * self.window)
            yield PacketWindow(**{k: v[sl] for k, v in on.items()})


class PacketRingBuffer:
    """Fixed-capacity circular buffer of admitted packets, cut window-wise.

    window/chunk_windows fix the cut geometry (a cut is at most
    ``chunk_windows`` complete windows, packed to exactly that many rows
    with dead padding); ``n_buckets`` sizes the flow hash the admit path
    computes. ``t0`` is the stream epoch: None latches the first admitted
    batch's minimum timestamp (the offline iterators' default on a
    single-batch replay, the bit-identity contract); open-ended
    multi-batch sources that may open out of order pass an explicit t0.

    ``capacity`` (default ``4 * chunk_windows * window``) must be at least
    ``(chunk_windows + 1) * window - 1`` lanes: a full ring then always
    holds a complete chunk, so a pull-driven loop (``cut_stream``) always
    makes progress without dropping. ``deadline`` (wall seconds, via
    ``clock``) bounds how long an admitted packet can sit uncut; None
    disables deadline cuts.
    """

    def __init__(self, window: int, chunk_windows: int = 1,
                 n_buckets: int = 4096, *, t0: Optional[float] = None,
                 capacity: Optional[int] = None,
                 deadline: Optional[float] = None, drop: bool = False,
                 clock: Callable[[], float] = time.monotonic):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if chunk_windows < 1:
            raise ValueError(
                f"chunk_windows must be >= 1, got {chunk_windows}")
        if deadline is not None and deadline <= 0:
            raise ValueError(f"deadline must be > 0, got {deadline}")
        if capacity is None:
            capacity = 4 * chunk_windows * window
        floor = (chunk_windows + 1) * window - 1
        if capacity < floor:
            raise ValueError(
                f"capacity={capacity} cannot guarantee cut progress: a "
                f"full ring must always contain {chunk_windows} complete "
                f"windows, which needs >= {floor} lanes "
                f"((chunk_windows+1)*window - 1)")
        self.window = window
        self.chunk_windows = chunk_windows
        self.n_buckets = n_buckets
        self.capacity = capacity
        self.deadline = deadline
        self.drop = drop
        self.t0 = t0
        self._clock = clock
        self._store = {k: np.zeros(capacity, dt) for k, dt in COLUMN_DTYPES}
        self._atime = np.zeros(capacity, np.float64)
        self._head = 0          # read position of the oldest packet
        self._count = 0
        self.stats = IngestStats()

    # -- occupancy ----------------------------------------------------------

    @property
    def buffered(self) -> int:
        return self._count

    @property
    def free(self) -> int:
        return self.capacity - self._count

    @property
    def complete_windows(self) -> int:
        return self._count // self.window

    def ready(self) -> bool:
        """A full count cut is available."""
        return self.complete_windows >= self.chunk_windows

    def deadline_due(self, now: Optional[float] = None) -> bool:
        """The oldest admitted packet has aged past ``deadline`` and at
        least one *complete* window is buffered (a lone partial window
        waits for more packets or the drain)."""
        if self.deadline is None or self.complete_windows < 1:
            return False
        if now is None:
            now = self._clock()
        return now - float(self._atime[self._head]) >= self.deadline

    # -- admission ----------------------------------------------------------

    def _latch_t0(self, t0: float) -> None:
        if self.t0 is None:
            self.t0 = t0

    def admit_cols(self, cols: dict, lo: int, hi: int,
                   now: Optional[float] = None) -> int:
        """Admit packets [lo, hi) of precomputed host columns (the
        ``trace_columns`` layout, already rebased against this ring's t0).
        Returns the number admitted; the remainder is tail-dropped when
        ``drop=True`` (counted), otherwise asking for more than ``free``
        raises ValueError."""
        m = hi - lo
        take = min(m, self.free)
        if take < m and not self.drop:
            raise ValueError(
                f"ring full: {m} packets offered, {self.free} lanes free "
                f"(pull-driven ingest should cut first; push-style "
                f"callers construct the ring with drop=True)")
        if now is None:
            now = self._clock()
        w = (self._head + self._count) % self.capacity
        first = min(take, self.capacity - w)
        for k, _ in COLUMN_DTYPES:
            src = cols[k]
            self._store[k][w:w + first] = src[lo:lo + first]
            if take > first:
                self._store[k][:take - first] = src[lo + first:lo + take]
        self._atime[w:w + first] = now
        if take > first:
            self._atime[:take - first] = now
        self._count += take
        self.stats.admitted += take
        self.stats.dropped += m - take
        return take

    def admit(self, trace, now: Optional[float] = None) -> int:
        """Admit a PacketTrace batch: hash and rebase (latching t0 from the
        first batch when unset), then ``admit_cols`` the lot."""
        cols, t0 = trace_columns(trace, self.n_buckets, t0=self.t0)
        self._latch_t0(t0)
        return self.admit_cols(cols, 0, len(cols["ts"]), now=now)

    # -- cutting ------------------------------------------------------------

    def _pop(self, n: int) -> tuple:
        """Remove the oldest ``n`` packets -> (contiguous cols, times)."""
        h, c = self._head, self.capacity
        idx = (h + np.arange(n)) % c if h + n > c else slice(h, h + n)
        cols = {k: np.ascontiguousarray(self._store[k][idx])
                for k, _ in COLUMN_DTYPES}
        times = np.ascontiguousarray(self._atime[idx])
        self._head = (h + n) % c
        self._count -= n
        return cols, times

    def cut(self, kind: str = "count") -> HostCut:
        """Cut up to ``chunk_windows`` complete windows (all buffered
        packets for ``kind='drain'``, including a ragged tail window) into
        one HostCut packed to the full (chunk_windows, window) shape."""
        if kind not in CUT_KINDS:
            raise ValueError(f"kind must be one of {CUT_KINDS}, got {kind!r}")
        if kind == "drain":
            n = self._count
        else:
            n = min(self.complete_windows, self.chunk_windows) * self.window
        if n == 0:
            raise ValueError(f"nothing to cut ({kind}): "
                             f"{self._count} packets buffered")
        cols, times = self._pop(n)
        full, valid = pack_chunk_columns(cols, n, self.window,
                                         self.chunk_windows)
        setattr(self.stats, f"{kind}_cuts",
                getattr(self.stats, f"{kind}_cuts") + 1)
        return HostCut(cols=full, valid=valid, admit_time=times, n=n,
                       window=self.window, rows=self.chunk_windows,
                       kind=kind)

    def drain(self) -> Optional[HostCut]:
        """End-of-source flush: everything buffered (the ragged tail padded
        like the final ``iter_chunks`` chunk), or None when empty."""
        return self.cut("drain") if self._count else None


def slice_trace(trace, lo: int, hi: int):
    """Per-packet slice [lo, hi) of a PacketTrace (flow arrays shared)."""
    return dataclasses.replace(
        trace, ts=trace.ts[lo:hi], src_ip=trace.src_ip[lo:hi],
        dst_ip=trace.dst_ip[lo:hi], sport=trace.sport[lo:hi],
        dport=trace.dport[lo:hi], proto=trace.proto[lo:hi],
        length=trace.length[lo:hi], direction=trace.direction[lo:hi],
        flow_id=trace.flow_id[lo:hi])


def replay_source(trace, batch: Optional[int] = None) -> Iterator:
    """A finite trace as an ingest source: the whole trace in one batch
    (batch=None, the ``serve_trace`` replay shape, which latches the offline
    iterators' t0 and equals them bit for bit, cut grouping included), or
    consecutive ``batch``-packet slices (arrival-paced sources: the same
    predictions, the cut grouping may differ)."""
    if batch is None:
        yield trace
        return
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    for lo in range(0, trace.n_packets, batch):
        yield slice_trace(trace, lo, min(lo + batch, trace.n_packets))


def cut_stream(ring: PacketRingBuffer, source: Iterable
               ) -> Iterator[HostCut]:
    """Pull-driven ingest loop: admit ``source`` batches into ``ring``,
    yielding cuts as they become ready; drain at exhaustion.

    Oversized batches are admitted in slices as cuts free lanes (the ring
    bounds memory, the source just waits), so nothing is dropped whatever
    the batch size. When both triggers are due, count cuts come first (a
    ready ring always cuts full chunks), then one deadline cut of whatever
    complete windows remain. Deadlines are evaluated at admission
    boundaries, the only point a pull loop can act, so a sparse source
    that blocks for long stretches should slice its batches
    (``replay_source(trace, batch=...)``) to give the deadline a chance.
    """
    for tr in source:
        m = tr.n_packets
        if not m:
            continue
        cols, t0 = trace_columns(tr, ring.n_buckets, t0=ring.t0)
        ring._latch_t0(t0)
        now = ring._clock()
        off = 0
        while off < m:
            off += ring.admit_cols(cols, off, min(off + ring.free, m),
                                   now=now)
            while ring.ready():
                yield ring.cut("count")
        if ring.deadline_due():
            yield ring.cut("deadline")
    final = ring.drain()
    if final is not None:
        yield final


def prefetch_iter(it: Iterable, depth: int = 2) -> Iterator:
    """Run ``it`` on a background thread, holding up to ``depth`` items
    ready ahead of the consumer.

    The double-buffer half of the ingest pipeline: the producer maps cuts
    to device chunks (on the card through ``PinnedStaging``, whose copies
    run on a side stream), so chunk k+1 is in flight while the consumer's
    step runs chunk k. depth=2 is classic double buffering. The producer
    blocks (bounded queue) rather than running ahead, and a consumer that
    abandons the iterator (``close()``, or GeneratorExit) stops the thread
    and joins it. An exception in the producer is re-raised on the
    consumer's side once the items before it are consumed.
    """
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()
    err: list = []

    def worker():
        try:
            for item in it:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — producer-thread trap:
            #                         captured and re-raised on the consumer
            #                         side, so nothing is swallowed
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(done, timeout=0.05)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True,
                         name="ingest-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            yield item
    finally:
        stop.set()
        t.join()
    if err:
        raise err[0]


class PinnedStaging:
    """HostCut -> PacketChunk on a CUDA device with the copy in flight.

    ``slots`` pinned host buffers of (rows * window) lanes, every column
    and ``valid`` side by side in one buffer (17 bytes a lane), reused
    round robin. ``stage(cut)`` waits until the slot's previous copy has
    completed (its event), packs the cut into the slot's buffer, starts ONE
    ``non_blocking`` copy of it on the side stream and records an event
    after it. -> (chunk, event): the chunk's tensors are views of the
    copy's destination, allocated on the side stream; hand both to
    ``await_chunk`` before any other stream reads the chunk. One producer
    at a time; a server keeps its staging across ``serve_stream`` calls.
    """

    def __init__(self, rows: int, window: int, *, device=None,
                 slots: int = 3):
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError("pinned staging needs a CUDA device")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.rows, self.window, self.device = rows, window, dev
        self.slots = slots
        self.stream = torch.cuda.Stream(dev)
        n = rows * window
        self._bufs = [torch.empty(_LANE_BYTES * n, dtype=torch.uint8,
                                  pin_memory=True) for _ in range(slots)]
        self._host = [{k: v.numpy() for k, v in _column_views(b, n).items()}
                      for b in self._bufs]
        self._events: list = [None] * slots
        self._next = 0

    def stage(self, cut: HostCut) -> tuple:
        if (cut.rows, cut.window) != (self.rows, self.window):
            raise ValueError(f"cut of ({cut.rows}, {cut.window}) for "
                             f"staging of ({self.rows}, {self.window})")
        i = self._next
        self._next = (i + 1) % self.slots
        if self._events[i] is not None:
            self._events[i].synchronize()   # its last copy has completed
        _pack(self._host[i], cut.cols, cut.valid)
        with torch.cuda.stream(self.stream):
            on = self._bufs[i].to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self._events[i] = done
        cols = _column_views(on, self.rows * self.window)
        return PacketChunk(**{k: v.reshape(self.rows, self.window)
                              for k, v in cols.items()}), done


def await_chunk(chunk: PacketChunk, ready) -> PacketChunk:
    """Order the current CUDA stream after a staged chunk's copy (``ready``,
    the event ``PinnedStaging.stage`` returned) and tell the allocator that
    this stream uses the chunk's memory. ready=None (a chunk made on the
    consumer's stream or on the CPU): nothing to do. Returns the chunk."""
    if ready is None:
        return chunk
    cur = torch.cuda.current_stream(chunk.bucket.device)
    cur.wait_event(ready)
    for f in dataclasses.fields(chunk):     # one storage when staged
        getattr(chunk, f.name).record_stream(cur)
    return chunk


class LatencyRecorder:
    """Per-packet admit->prediction latency accumulator.

    ``record`` takes the admit wall-times of a cut's live packets and the
    wall time their *final* predictions became readable on the host (after
    the sync); ``summary`` reduces to the percentile row (milliseconds).

    ``max_samples=None`` (the default) keeps every span: exact percentiles,
    memory linear in stream length, right for bounded traces. On an
    *open-ended* stream that is an unbounded leak, so ``max_samples=k``
    switches to a seeded uniform reservoir (Algorithm R): memory is O(k),
    percentiles come from the reservoir (exact until the k+1-th packet, an
    unbiased sample after), while ``n`` / ``mean`` / ``max`` stay exact over
    *all* packets seen. ``latencies()`` returns the reservoir in bounded
    mode: a uniform sample, not the admit-order sequence."""

    def __init__(self, max_samples: Optional[int] = None, seed: int = 0):
        if max_samples is not None and max_samples < 1:
            raise ValueError(f"max_samples must be >= 1 or None, "
                             f"got {max_samples}")
        self.max_samples = max_samples
        self._spans: list = []              # unbounded mode
        self._reservoir: Optional[np.ndarray] = (
            None if max_samples is None
            else np.zeros(max_samples, np.float64))
        self._rng = np.random.default_rng(seed)
        self._n_seen = 0
        self._sum = 0.0
        self._max: Optional[float] = None

    def record(self, admit_time: np.ndarray, finish: float) -> None:
        if not len(admit_time):
            return
        spans = finish - np.asarray(admit_time, np.float64)
        self._sum += float(spans.sum())
        mx = float(spans.max())
        self._max = mx if self._max is None else max(self._max, mx)
        if self.max_samples is None:
            self._n_seen += len(spans)
            self._spans.append(spans)
            return
        k = self.max_samples
        for v in spans:                     # Algorithm R, element-wise
            i = self._n_seen
            self._n_seen += 1
            if i < k:
                self._reservoir[i] = v
            else:
                j = int(self._rng.integers(0, i + 1))
                if j < k:
                    self._reservoir[j] = v

    @property
    def n(self) -> int:
        """Total packets seen (NOT the reservoir size in bounded mode)."""
        return self._n_seen

    def latencies(self) -> np.ndarray:
        """(m,) float64 seconds. Unbounded mode: every span, admit order.
        Bounded mode: the reservoir sample (m = min(n, k))."""
        if self.max_samples is None:
            return (np.concatenate(self._spans) if self._spans
                    else np.zeros(0, np.float64))
        return self._reservoir[:min(self._n_seen, self.max_samples)].copy()

    def summary(self) -> dict:
        """Milliseconds row. ``n``/``mean_ms``/``max_ms`` are exact over all
        packets seen; percentiles are reservoir-approximate once bounded
        mode has evicted (n > max_samples)."""
        if not self._n_seen:
            return {"n": 0, "p50_ms": None, "p95_ms": None, "p99_ms": None,
                    "mean_ms": None, "max_ms": None}
        lat = self.latencies() * 1e3
        p50, p95, p99 = np.percentile(lat, (50, 95, 99))
        return {"n": self._n_seen, "p50_ms": float(p50),
                "p95_ms": float(p95), "p99_ms": float(p99),
                "mean_ms": self._sum / self._n_seen * 1e3,
                "max_ms": self._max * 1e3}
