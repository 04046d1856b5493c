"""Structured event bus: JSON-lines lifecycle events for the serving loop.

Port of ``repro/obs/events.py`` (pure Python, the same schema and
vocabulary, so a log either package writes validates under both).

The serving tiers narrate their host-side lifecycle — cuts admitted,
chunks dispatched, flushes issued and back-patched, circuit-breaker
transitions, eviction sweeps, autotune decisions, degradations — as
``Event`` records on an ``EventBus``. Everything here is HOST-side by
construction: an event is emitted around a device dispatch, never inside
one (never inside a captured CUDA graph), so the step stays free of host
syncs and observability-off is bit-identical to observability-on.

Design points:

* **monotonic timestamps** — ``ts`` is ``time.monotonic()`` (injectable
  for tests), never wall-clock, so event ordering survives NTP steps and
  intervals are meaningful;
* **bounded memory** — the in-memory buffer is a ring
  (``max_events``); an open-ended stream cannot turn its own telemetry
  into a leak (the same discipline as the ingest ring and the latency
  reservoir). ``seq`` is a monotone counter, so dropped-from-the-ring
  events remain detectable;
* **JSON-lines sink** — ``JsonlSink`` appends one self-describing JSON
  object per event; ``validate_event_log`` checks a written log against
  the schema below (the CI quick run does), so downstream consumers can
  key on the contract.

Event line schema (DESIGN.md §14):

    {"v": 1, "seq": <int>, "ts": <float monotonic s>, "kind": <str>,
     ...flat JSON-safe fields...}

``kind`` must be one of ``EVENT_KINDS``; field values must be JSON
scalars (str/int/float/bool/None) or flat lists of scalars.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Callable, Iterable, Optional

EVENT_SCHEMA_VERSION = 1

# the lifecycle vocabulary: every emitter uses one of these (validated)
EVENT_KINDS = (
    # ingest / serving lifecycle
    "serve_begin",       # serve_stream entered (tier, window, chunking)
    "serve_end",         # serve_stream finished (packets, cuts, walltime)
    "cut",               # ring cut admitted (kind, packets, windows)
    "chunk",             # chunk dispatched into the chunk step
    "window",            # window dispatched on the per-window path
    # backend flush lifecycle
    "flush",             # deferred-cycle flush issued (windows, trigger)
    "backpatch",         # flush answers back-patched into pending windows
    "degraded",          # a flush ultimately failed; switch answers kept
    # fault-policy guard / circuit breaker (serving.faults.GuardedBackend)
    "backend_attempt",   # one guarded backend invocation attempt
    "backend_timeout",   # an attempt was abandoned on timeout
    "backend_error",     # an attempt raised (non-timeout)
    "backend_retry",     # a retry is about to run (after backoff)
    "flush_ok",          # the flush was ultimately served
    "flush_failed",      # the flush ultimately failed (caller degrades)
    "flush_rejected",    # short-circuited by an OPEN breaker
    "breaker_open",      # CLOSED/HALF_OPEN -> OPEN
    "breaker_half_open", # OPEN -> HALF_OPEN (single probe follows)
    "breaker_close",     # HALF_OPEN -> CLOSED
    "guard_reset",       # GuardedBackend.reset() (new stream epoch)
    # lifecycle / control-plane
    "eviction",          # an aging/LRU sweep recycled buckets (rollup-rate)
    "autotune",          # a measured-sweep decision (chunk K, tiles)
    "rollup",            # a metrics rollup window closed
    "drift_alarm",       # a drift monitor fired (obs/drift.py)
)

_KIND_SET = frozenset(EVENT_KINDS)

# reserved top-level keys an emitter's fields may not shadow
_RESERVED = frozenset(("v", "seq", "ts", "kind"))


@dataclasses.dataclass(frozen=True)
class Event:
    """One structured lifecycle event (host-side, monotonic-timestamped)."""
    seq: int
    ts: float
    kind: str
    fields: dict

    def as_line(self) -> dict:
        """The flat JSON-lines form (schema above)."""
        return {"v": EVENT_SCHEMA_VERSION, "seq": self.seq, "ts": self.ts,
                "kind": self.kind, **self.fields}


class EventSchemaError(ValueError):
    """An event (or a serialized event line) violates the schema."""


def _check_field_value(key, value, where):
    ok_scalar = isinstance(value, (str, int, float, bool)) or value is None
    if ok_scalar:
        return
    if isinstance(value, (list, tuple)):
        for v in value:
            if not (isinstance(v, (str, int, float, bool)) or v is None):
                raise EventSchemaError(
                    f"{where}: field {key!r} list holds non-scalar "
                    f"{type(v).__name__}")
        return
    raise EventSchemaError(f"{where}: field {key!r} must be a JSON scalar "
                           f"or flat list, got {type(value).__name__}")


def validate_event_line(obj, where: str = "<event>") -> None:
    """Raise EventSchemaError unless ``obj`` is a valid event line."""
    if not isinstance(obj, dict):
        raise EventSchemaError(
            f"{where}: event line must be an object, "
            f"got {type(obj).__name__}")
    for key, types in (("v", int), ("seq", int), ("ts", (int, float)),
                       ("kind", str)):
        if key not in obj:
            raise EventSchemaError(f"{where}: missing key {key!r}")
        if not isinstance(obj[key], types) or isinstance(obj[key], bool):
            raise EventSchemaError(
                f"{where}: {key!r} must be {types}, "
                f"got {type(obj[key]).__name__}")
    if obj["v"] != EVENT_SCHEMA_VERSION:
        raise EventSchemaError(f"{where}: schema version must be "
                               f"{EVENT_SCHEMA_VERSION}, got {obj['v']}")
    if obj["kind"] not in _KIND_SET:
        raise EventSchemaError(f"{where}: unknown kind {obj['kind']!r}")
    for key, value in obj.items():
        if key in _RESERVED:
            continue
        _check_field_value(key, value, where)


def validate_event_log(path: str) -> int:
    """Validate a JSON-lines event log; returns the number of events.

    Checks every line against the schema AND that ``seq`` is strictly
    increasing (the bus contract — gaps are fine, they mark events the
    in-memory ring dropped, but reordering is a writer bug).
    """
    n = 0
    prev_seq = -1
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            where = f"{path}:{i + 1}"
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                raise EventSchemaError(f"{where}: not valid JSON ({e})") \
                    from e
            validate_event_line(obj, where)
            if obj["seq"] <= prev_seq:
                raise EventSchemaError(
                    f"{where}: seq {obj['seq']} not increasing "
                    f"(previous {prev_seq})")
            prev_seq = obj["seq"]
            n += 1
    return n


class JsonlSink:
    """Append events to a JSON-lines file (one object per line)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")

    def write(self, event: Event) -> None:
        json.dump(event.as_line(), self._f, separators=(",", ":"))
        self._f.write("\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class EventBus:
    """Bounded in-memory event ring with an optional JSON-lines sink.

    ``emit(kind, **fields)`` validates the kind eagerly (an unknown kind
    is a programming error at the call site, not a log-consumer
    surprise), stamps a monotonic timestamp and a monotone ``seq``, keeps
    the event in a bounded ring, and forwards it to the sink when one is
    attached. Emission is cheap (a dataclass + deque append) but not
    free — callers on the zero-sync hot path guard with
    ``if obs is not None`` so observability-off costs nothing at all.
    """

    def __init__(self, *, sink: Optional[JsonlSink] = None,
                 max_events: int = 65536,
                 clock: Callable[[], float] = time.monotonic):
        if max_events < 1:
            raise ValueError(f"max_events must be >= 1, got {max_events}")
        self._ring: collections.deque = collections.deque(maxlen=max_events)
        self._seq = 0
        self.sink = sink
        self._clock = clock

    def emit(self, kind: str, **fields) -> Event:
        if kind not in _KIND_SET:
            raise EventSchemaError(f"unknown event kind {kind!r} "
                                   f"(EVENT_KINDS is the vocabulary)")
        bad = _RESERVED.intersection(fields)
        if bad:
            raise EventSchemaError(
                f"fields shadow reserved keys {sorted(bad)}")
        ev = Event(seq=self._seq, ts=self._clock(), kind=kind,
                   fields=fields)
        self._seq += 1
        self._ring.append(ev)
        if self.sink is not None:
            self.sink.write(ev)
        return ev

    # -- reading ------------------------------------------------------------

    @property
    def events(self) -> list:
        """Buffered events, oldest first (the ring may have dropped
        earlier ones — compare seq gaps)."""
        return list(self._ring)

    @property
    def emitted(self) -> int:
        """Total events emitted (including any dropped from the ring)."""
        return self._seq

    def __len__(self) -> int:
        return len(self._ring)

    def kinds(self) -> list:
        """The buffered kind sequence, oldest first (test helper)."""
        return [e.kind for e in self._ring]

    def of(self, *kinds: str) -> list:
        """Buffered events of the given kinds, oldest first."""
        want = set(kinds)
        return [e for e in self._ring if e.kind in want]

    def counts(self) -> dict:
        """kind -> buffered occurrence count."""
        c: dict = {}
        for e in self._ring:
            c[e.kind] = c.get(e.kind, 0) + 1
        return c

    def clear(self) -> None:
        """Drop buffered events (seq keeps counting — gaps stay visible)."""
        self._ring.clear()

    def close(self) -> None:
        if self.sink is not None:
            self.sink.close()


def iter_event_lines(events: Iterable[Event]):
    """Serialize events to their JSON-lines dict form (test helper)."""
    for e in events:
        yield e.as_line()
