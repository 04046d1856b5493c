"""Backend fault tolerance: policy, circuit breaker, and fault injection.

Port of ``repro/serving/faults.py``. The hybrid split's value is that the
switch keeps answering when the backend is the bottleneck, which includes
the backend being *down*. This module wraps the host-side backend call
(the streaming server's two-phase flush path) in an operational policy:

  ``FaultPolicy``    per-flush timeout, bounded retries with exponential
                     backoff, and a circuit breaker that opens after
                     consecutive flush failures;
  ``GuardedBackend`` applies a policy to a backend function: returns the
                     backend's answers, or ``None`` when the flush
                     ultimately failed (the server then *degrades*:
                     deferred rows keep their provisional switch-tier
                     predictions and are counted in
                     ``StreamStats.degraded``);
  ``FaultyBackend``  a seeded injection wrapper for tests and the
                     scenarios: an error rate, latency spikes, and hard
                     outages by call index.

Everything here runs on the host, outside any CUDA graph: a server built
with a ``FaultPolicy`` serves eagerly in two phases (switch half, guarded
backend, then the fold or the back-patch), which equals the graph route
bit for bit. With no faults injected, a guarded server returns exactly
the predictions of an unguarded one.

Circuit breaker state machine (per GuardedBackend):

  CLOSED     every flush calls the backend (with timeout and retries);
             ``breaker_threshold`` *consecutive* ultimate failures open it.
  OPEN       flushes short-circuit to degraded (no backend call, no
             timeout wait) for ``breaker_cooldown`` flushes.
  HALF_OPEN  after the cooldown, exactly one probe flush reaches the
             backend (one attempt, no retries); success closes the
             breaker, failure re-opens it for another cooldown.

Timeouts run the backend on a worker thread and abandon it on expiry
(Python cannot interrupt an arbitrary call); an abandoned call may still
finish in the background and its answer is dropped. The worker runs on
the caller's CUDA stream when the rows are a CUDA tensor, so its kernels
are ordered after the work that produced the rows and before the patch
that reads its answer, with no host sync. Unlike the reference, the guard
returns what the backend returned (a CUDA tensor stays on the card).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch


class BackendFault(RuntimeError):
    """A backend invocation failed (injected or real)."""


class BackendTimeout(BackendFault):
    """A backend invocation exceeded the policy's per-attempt timeout."""


# breaker states
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Operational policy for one backend flush (host-side, see module doc).

    timeout_s          per-*attempt* timeout; None disables (no worker
                       thread is spawned).
    max_retries        retries after the first attempt (total attempts =
                       1 + max_retries; a HALF_OPEN probe gets exactly 1).
    backoff_base_s     sleep before retry i is backoff_base_s *
                       backoff_factor**i — exponential backoff.
    backoff_factor     growth factor of the backoff schedule.
    breaker_threshold  consecutive ultimately-failed flushes that open
                       the breaker; 0 disables the breaker entirely.
    breaker_cooldown   flushes short-circuited while OPEN before the
                       HALF_OPEN probe.
    """
    timeout_s: Optional[float] = None
    max_retries: int = 2
    backoff_base_s: float = 0.01
    backoff_factor: float = 2.0
    breaker_threshold: int = 3
    breaker_cooldown: int = 4

    def __post_init__(self):
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {self.timeout_s}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.breaker_threshold < 0:
            raise ValueError(f"breaker_threshold must be >= 0, "
                             f"got {self.breaker_threshold}")
        if self.breaker_threshold and self.breaker_cooldown < 1:
            raise ValueError(f"breaker_cooldown must be >= 1, "
                             f"got {self.breaker_cooldown}")


@dataclasses.dataclass
class FaultStats:
    """Host-side telemetry of one GuardedBackend (plain ints, no sync)."""
    flushes_ok: int = 0        # flushes the backend ultimately served
    flushes_failed: int = 0    # flushes that degraded (incl. rejected)
    attempts: int = 0          # backend invocations attempted
    retries: int = 0           # attempts beyond the first, per flush
    timeouts: int = 0          # attempts abandoned on timeout
    rejected: int = 0          # flushes short-circuited by an OPEN breaker
    breaker_opens: int = 0     # CLOSED/HALF_OPEN -> OPEN transitions
    breaker_closes: int = 0    # HALF_OPEN -> CLOSED transitions

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _call_on(stream, fn, rows):
    """``fn(rows)`` with ``stream`` as the thread's current CUDA stream
    (the worker thread's own default is another stream)."""
    if stream is None:
        return fn(rows)
    with torch.cuda.stream(stream):
        return fn(rows)


class GuardedBackend:
    """Apply a FaultPolicy to a host backend function.

    Calling the guard with a row buffer returns the backend's answer as
    the backend returned it, or ``None`` when the flush ultimately failed:
    the caller degrades (keeps provisional switch predictions). Never
    raises for backend failures; genuine bugs (e.g. shape errors in the
    caller) surface as usual because only ``Exception``s raised *by the
    backend attempt* are treated as faults.

    ``sleep`` is injectable so tests can assert the backoff schedule
    without real waiting. ``events`` takes an ``EventBus``
    (``repro_torch.obs.events``): when set, the guard narrates its
    lifecycle — ``backend_attempt`` / ``backend_timeout`` /
    ``backend_error`` / ``backend_retry`` per attempt, ``flush_ok`` /
    ``flush_failed`` / ``flush_rejected`` per flush, ``breaker_open`` /
    ``breaker_half_open`` / ``breaker_close`` on state transitions, and
    ``guard_reset`` — the reference's sequence, event for event.
    """

    def __init__(self, backend_fn: Callable, policy: FaultPolicy, *,
                 sleep: Callable[[float], None] = time.sleep,
                 events=None):
        self.backend_fn = backend_fn
        self.policy = policy
        self._sleep = sleep
        self._executor = None
        self._events = None        # init-time reset() emits nothing
        self.reset()
        self._events = events

    def _emit(self, kind: str, **fields) -> None:
        if self._events is not None:
            self._events.emit(kind, **fields)

    def reset(self):
        """Fresh telemetry and a CLOSED breaker (a new stream epoch:
        ``StreamingHybridServer.reset`` calls this so repeated runs see
        identical guard behavior)."""
        self.stats = FaultStats()
        self.state = CLOSED
        self.consecutive_failures = 0
        self._cooldown_left = 0
        self._emit("guard_reset")

    # -- timeout plumbing ---------------------------------------------------

    def _attempt(self, rows):
        """One backend attempt under the per-attempt timeout."""
        self.stats.attempts += 1
        self._emit("backend_attempt", attempt=self.stats.attempts,
                   state=self.state)
        if self.policy.timeout_s is None:
            return self.backend_fn(rows)
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="guarded-backend")
        stream = (torch.cuda.current_stream(rows.device)
                  if isinstance(rows, torch.Tensor) and rows.is_cuda
                  else None)
        fut = self._executor.submit(_call_on, stream, self.backend_fn, rows)
        try:
            return fut.result(timeout=self.policy.timeout_s)
        except concurrent.futures.TimeoutError:
            self.stats.timeouts += 1
            # abandon the in-flight call: its thread keeps running, so a
            # fresh executor serves the next attempt (the stuck worker is
            # never awaited again)
            self._executor.shutdown(wait=False)
            self._executor = None
            raise BackendTimeout(
                f"backend exceeded {self.policy.timeout_s}s") from None

    # -- breaker transitions ------------------------------------------------

    def _record_failure(self):
        self.stats.flushes_failed += 1
        self.consecutive_failures += 1
        self._emit("flush_failed",
                   consecutive_failures=self.consecutive_failures)
        p = self.policy
        if not p.breaker_threshold:
            return
        if (self.state == HALF_OPEN
                or self.consecutive_failures >= p.breaker_threshold):
            # open (or re-open after a failed HALF_OPEN probe)
            self.state = OPEN
            self._cooldown_left = p.breaker_cooldown
            self.stats.breaker_opens += 1
            self._emit("breaker_open", cooldown=p.breaker_cooldown)

    def _record_success(self):
        self.stats.flushes_ok += 1
        self.consecutive_failures = 0
        self._emit("flush_ok")
        if self.state != CLOSED:
            self.state = CLOSED
            self.stats.breaker_closes += 1
            self._emit("breaker_close")

    # -- the guarded flush --------------------------------------------------

    def __call__(self, rows):
        p = self.policy
        if self.state == OPEN:
            if self._cooldown_left > 0:
                self._cooldown_left -= 1
                self.stats.rejected += 1
                self.stats.flushes_failed += 1
                self._emit("flush_rejected",
                           cooldown_left=self._cooldown_left)
                return None
            self.state = HALF_OPEN          # cooldown over: one probe
            self._emit("breaker_half_open")
        attempts = 1 if self.state == HALF_OPEN else 1 + p.max_retries
        for i in range(attempts):
            if i:
                self.stats.retries += 1
                self._emit("backend_retry", retry=i)
                self._sleep(p.backoff_base_s * p.backoff_factor ** (i - 1))
            try:
                out = self._attempt(rows)
            except Exception as e:  # noqa: BLE001 — fault boundary: ANY
                #                     backend failure must degrade, not crash
                #                     the serving loop
                kind = ("backend_timeout" if isinstance(e, BackendTimeout)
                        else "backend_error")
                self._emit(kind, error=f"{type(e).__name__}: {e}")
                continue
            self._record_success()
            return out
        self._record_failure()
        return None


class FaultyBackend:
    """Seeded fault-injection wrapper around a backend function.

    error_rate          probability an invocation raises BackendFault;
    spike_rate/spike_s  probability (and duration) of a latency spike
                        before the call — with ``sleep=time.sleep`` a
                        spike longer than the policy timeout turns into
                        a timeout fault;
    outages             iterable of invocation indices (0-based, counted
                        over *calls to this wrapper*) that hard-fail
                        regardless of error_rate — deterministic outage
                        windows like ``range(10, 14)``;
    seed                the rng seed: identical seeds replay identical
                        fault sequences (the reproducibility contract of
                        the scenario bench).

    The wrapper is host-only by construction (rng + counters are python
    state); serving tiers built with a FaultPolicy never trace the
    backend, so the injected faults fire on the two-phase path where the
    guard can catch them.
    """

    def __init__(self, backend_fn: Callable, *, error_rate: float = 0.0,
                 spike_rate: float = 0.0, spike_s: float = 0.0,
                 outages: Iterable[int] = (), seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        if not 0.0 <= error_rate <= 1.0:
            raise ValueError(f"error_rate must be in [0, 1], "
                             f"got {error_rate}")
        if not 0.0 <= spike_rate <= 1.0:
            raise ValueError(f"spike_rate must be in [0, 1], "
                             f"got {spike_rate}")
        self.backend_fn = backend_fn
        self.error_rate = error_rate
        self.spike_rate = spike_rate
        self.spike_s = spike_s
        self.outages = frozenset(int(i) for i in outages)
        self.seed = seed
        self._sleep = sleep
        self.reset()

    def reset(self):
        """Rewind the rng and counters: the next call sequence replays
        the identical fault sequence (pure function of seed + index)."""
        self._rng = np.random.default_rng(self.seed)
        self.calls = 0
        self.errors = 0
        self.spikes = 0

    def __call__(self, rows):
        i = self.calls
        self.calls += 1
        # draw both variates unconditionally so the fault sequence is a
        # pure function of (seed, call index) — an outage never shifts
        # the downstream error pattern
        err = self._rng.random() < self.error_rate
        spike = self._rng.random() < self.spike_rate
        if spike:
            self.spikes += 1
            self._sleep(self.spike_s)
        if i in self.outages or err:
            self.errors += 1
            raise BackendFault(f"injected fault at invocation {i}")
        return self.backend_fn(rows)
