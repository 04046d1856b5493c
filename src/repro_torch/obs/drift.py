"""Drift monitors over rollup windows: the hot-swap control plane's senses.

Port of ``repro/obs/drift.py`` (numpy, host-side).

IIsy's switch tier serves a *frozen* small model; the hybrid design only
stays trustworthy while the traffic still looks like the training
distribution. ROADMAP item 1 (pForest-style phase-aware models, the
Planter train→map→deploy loop) needs exactly three signals to decide a
retrain/hot-swap, and this module computes them from the metric rollups
(``obs.metrics.RollupWindows`` rows):

  confidence collapse   mean switch confidence of a rollup window drops
                        ``conf_drop`` below the baseline — the small
                        model still answers, but no longer decisively;
  fraction_handled drop the share of packets answered at the switch
                        falls ``frac_drop`` below baseline — backend
                        load is growing, the paper's headline economy
                        is eroding;
  class-mix shift       the L1 distance between the window's predicted
                        class distribution and the baseline's exceeds
                        ``mix_l1`` — the traffic itself changed (attack
                        onset, new application mix), the strongest
                        retrain trigger.

Baseline: the mean over the first ``baseline_windows`` closed rollups
(per key), frozen once complete — drift is measured against how the
stream *started*, so a slow degradation cannot re-anchor its own
baseline window by window. Windows with fewer than ``min_packets``
packets are ignored both for the baseline and for detection (tiny drain
windows are noise). Detectors return ``DriftAlarm`` records; the
``Observability`` facade emits each as a ``drift_alarm`` event.

All host-side, all O(1) per rollup window: nothing here syncs a device
value (the serving loop's rollup boundary already produced plain
numbers).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

DETECTORS = ("conf_collapse", "frac_handled_drop", "class_mix_shift")


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Thresholds of the three detectors (None disables a detector).

    conf_drop          absolute mean-confidence drop vs baseline that
                       fires ``conf_collapse``;
    frac_drop          absolute fraction_handled drop vs baseline that
                       fires ``frac_handled_drop``;
    mix_l1             L1 distance between predicted-class distributions
                       (in [0, 2]) that fires ``class_mix_shift``;
    baseline_windows   rollup windows averaged into the frozen baseline;
    min_packets        windows below this packet count are ignored.
    """
    conf_drop: Optional[float] = 0.15
    frac_drop: Optional[float] = 0.2
    mix_l1: Optional[float] = 0.5
    baseline_windows: int = 2
    min_packets: int = 64

    def __post_init__(self):
        for name in ("conf_drop", "frac_drop", "mix_l1"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0 or None, got {v}")
        if self.baseline_windows < 1:
            raise ValueError(f"baseline_windows must be >= 1, "
                             f"got {self.baseline_windows}")
        if self.min_packets < 0:
            raise ValueError(f"min_packets must be >= 0, "
                             f"got {self.min_packets}")


@dataclasses.dataclass(frozen=True)
class DriftAlarm:
    """One detector firing on one rollup window."""
    detector: str      # one of DETECTORS
    key: str           # rollup key (tenant-ready)
    window: int        # rollup window index that fired
    value: float       # the window's observed statistic
    baseline: float    # the frozen baseline statistic
    threshold: float   # the configured trip threshold

    def as_fields(self) -> dict:
        """Flat event-field form (drift_alarm events)."""
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _Baseline:
    """Per-key frozen baseline, averaged over the first N valid windows."""
    n: int = 0
    conf_sum: float = 0.0
    frac_sum: float = 0.0
    mix_sum: Optional[np.ndarray] = None
    frozen: bool = False

    def fold(self, conf: float, frac: float, mix: np.ndarray) -> None:
        self.n += 1
        self.conf_sum += conf
        self.frac_sum += frac
        self.mix_sum = (mix.copy() if self.mix_sum is None
                        else self.mix_sum + mix)

    @property
    def conf(self) -> float:
        return self.conf_sum / self.n

    @property
    def frac(self) -> float:
        return self.frac_sum / self.n

    @property
    def mix(self) -> np.ndarray:
        return self.mix_sum / self.n


def _window_stats(row: dict):
    """(packets, mean_conf, frac_handled, class_dist) of one rollup row —
    None when the row is unusable (no packets)."""
    sums = row.get("sums", {})
    pkts = float(sums.get("packets", 0))
    if pkts <= 0:
        return None
    conf = float(sums.get("conf_sum", 0.0)) / pkts
    frac = float(sums.get("handled", 0)) / pkts
    counts = np.asarray(sums.get("class_counts", [pkts]), np.float64)
    total = counts.sum()
    dist = counts / total if total > 0 else counts
    return pkts, conf, frac, dist


class DriftMonitor:
    """Feed closed rollup rows in; get DriftAlarms out.

    ``observe(row)`` returns the (possibly empty) list of alarms the
    window tripped. Alarms accumulate in ``.alarms``; ``fired`` /
    ``fired_detectors`` summarize. ``reset()`` forgets baselines and
    alarms (a new stream epoch).
    """

    def __init__(self, config: Optional[DriftConfig] = None):
        self.config = config or DriftConfig()
        self.reset()

    def reset(self) -> None:
        self._baselines: dict = {}      # key -> _Baseline
        self.alarms: list = []
        self.windows_seen = 0

    @property
    def fired(self) -> bool:
        return bool(self.alarms)

    @property
    def fired_detectors(self) -> tuple:
        seen: list = []
        for a in self.alarms:
            if a.detector not in seen:
                seen.append(a.detector)
        return tuple(seen)

    def baseline_ready(self, key: str = "default") -> bool:
        b = self._baselines.get(key)
        return b is not None and b.frozen

    def observe(self, row: dict) -> list:
        """Fold one closed rollup row; -> list of DriftAlarm fired."""
        cfg = self.config
        stats = _window_stats(row)
        if stats is None:
            return []
        pkts, conf, frac, dist = stats
        if pkts < cfg.min_packets:
            return []
        self.windows_seen += 1
        key = row.get("key", "default")
        b = self._baselines.get(key)
        if b is None:
            b = self._baselines[key] = _Baseline()
        if not b.frozen:
            b.fold(conf, frac, dist)
            if b.n >= cfg.baseline_windows:
                b.frozen = True
            return []                     # baseline windows never alarm
        fired = []
        window = int(row.get("window", self.windows_seen))

        def alarm(detector, value, baseline, threshold):
            a = DriftAlarm(detector=detector, key=key, window=window,
                           value=float(value), baseline=float(baseline),
                           threshold=float(threshold))
            fired.append(a)
            self.alarms.append(a)

        if cfg.conf_drop is not None and b.conf - conf >= cfg.conf_drop:
            alarm("conf_collapse", conf, b.conf, cfg.conf_drop)
        if cfg.frac_drop is not None and b.frac - frac >= cfg.frac_drop:
            alarm("frac_handled_drop", frac, b.frac, cfg.frac_drop)
        if cfg.mix_l1 is not None:
            bm, dm = b.mix, dist
            if len(bm) != len(dm):        # class space grew: pad shorter
                n = max(len(bm), len(dm))
                bm = np.pad(bm, (0, n - len(bm)))
                dm = np.pad(dm, (0, n - len(dm)))
            l1 = float(np.abs(bm - dm).sum())
            if l1 >= cfg.mix_l1:
                alarm("class_mix_shift", l1, 0.0, cfg.mix_l1)
        return fired
