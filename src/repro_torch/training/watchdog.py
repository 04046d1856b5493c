"""Step-time watchdog: straggler / hang detection.

A copy of ``repro/training/watchdog.py`` (host-only, no JAX in it).

At 1000+ nodes the common failure modes are (a) a host silently slowing
down (thermal, ECC retries, network flaps) and (b) a hard hang in a
collective. Both surface as step-time anomalies. The watchdog keeps a
robust running estimate (median + MAD over a window) and:

  * flags a STRAGGLER when a step exceeds ``slow_factor`` x median;
  * arms a hang timer that a monitoring thread can use to abort the
    process (so the job scheduler restarts it from the last checkpoint —
    the restart path is exercised by tests/test_torch_training.py).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional


class StepWatchdog:
    def __init__(self, *, window: int = 32, slow_factor: float = 2.5,
                 hang_timeout_s: float = 600.0,
                 on_hang: Optional[Callable[[], None]] = None):
        self.times = collections.deque(maxlen=window)
        self.slow_factor = slow_factor
        self.hang_timeout_s = hang_timeout_s
        self.on_hang = on_hang
        self.events: list[dict] = []
        self._timer: Optional[threading.Timer] = None
        self._t0: Optional[float] = None

    # -- step lifecycle ------------------------------------------------------
    def step_start(self, step: int):
        self._t0 = time.monotonic()
        self._arm(step)

    def step_end(self, step: int) -> dict:
        dt = time.monotonic() - self._t0
        self._disarm()
        med = self.median()
        is_straggler = (med is not None and len(self.times) >= 8
                        and dt > self.slow_factor * med)
        if is_straggler:
            self.events.append({"step": step, "kind": "straggler",
                                "dt": dt, "median": med})
        self.times.append(dt)
        return {"dt": dt, "median": self.median(), "straggler": is_straggler}

    def median(self) -> Optional[float]:
        if not self.times:
            return None
        s = sorted(self.times)
        return s[len(s) // 2]

    # -- hang timer ----------------------------------------------------------
    def _arm(self, step):
        self._disarm()
        if self.on_hang is None:
            return
        self._timer = threading.Timer(self.hang_timeout_s, self._fire, (step,))
        self._timer.daemon = True
        self._timer.start()

    def _fire(self, step):
        self.events.append({"step": step, "kind": "hang"})
        self.on_hang()

    def _disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
