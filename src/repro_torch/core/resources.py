"""Switch-resource accounting for a TableArtifact (Tables 1-2 analog).

Port of ``repro/core/resources.py`` (host numpy, the paper's challenge
(iii): does the mapped model fit the switch?). The artifact's tables may
live on any device; they are read back to the host to be counted.

We report the quantities the paper reports, computed from the artifact:
  tables   — number of lookup tables (feature tables + decision tables + agg)
  entries  — total table entries
  bits     — total payload storage
  stages   — pipeline-stage analog: dependent lookup rounds. IIsy's mapping
             is constant-stage: features (parallel) -> decisions (parallel)
             -> aggregation, i.e. 3, independent of tree count/depth (§4.1).

Beyond *reporting*, :func:`check_fit` maps a report against a declarative
:class:`DeviceProfile` budget (Tofino-like / NIC-ish) and rejects
artifacts that would not deploy — the Planter-style fit gate IIsy's §4
mapping discussion assumes. Feature (range-match) tables bill against TCAM, decision/value
(exact-match) tables against SRAM, mirroring the paper's table-type
split.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

from repro_torch.core.artifact import TableArtifact
from repro_torch.device import to_numpy


@dataclasses.dataclass
class ResourceReport:
    tables: int
    entries: int
    bits: int
    stages: int
    # match-kind split used by check_fit: range/ternary feature tables
    # (TCAM) vs exact-match decision/value tables (SRAM). 0/0 (the
    # naive-mapping constructors) means "unsplit" — check_fit then bills
    # everything against SRAM, the conservative default for exact-match
    # flat layouts.
    tcam_bits: int = 0
    sram_bits: int = 0

    @property
    def kib(self) -> float:
        return self.bits / 8 / 1024

    def row(self) -> str:
        return (f"tables={self.tables} entries={self.entries} "
                f"mem={self.kib:.1f}KiB stages={self.stages}")


def _code_bits(radix: np.ndarray) -> np.ndarray:
    return np.ceil(np.log2(np.maximum(radix, 2))).astype(np.int64)


def artifact_resources(art: TableArtifact) -> ResourceReport:
    edges = to_numpy(art.edges)
    f_dim = edges.shape[0]
    valid_edges = np.isfinite(edges).sum(axis=1)            # (F,)

    if art.ftable is not None:
        n_trees = to_numpy(art.strides).shape[0]
        # per-tree radices recoverable from the feature-table code maxima
        ftab = to_numpy(art.ftable)                         # (F, U+1, T)
        radix = ftab.max(axis=1) + 1                        # (F, T)
        sizes = radix.astype(np.int64).prod(axis=0)         # (T,)
        feat_entries = int((valid_edges + 1).sum())
        feat_bits = int(((valid_edges + 1)[:, None]
                         * _code_bits(radix)[...]).sum())
        dec_entries = int(sizes.sum())
        payload_bits = (art.dtable_value.bits
                        if art.agg != "vote"
                        else max(1, math.ceil(math.log2(max(art.n_classes, 2)))))
        dec_bits = int(sizes.sum()) * payload_bits
        return ResourceReport(
            tables=f_dim + n_trees + 1,
            entries=feat_entries + dec_entries,
            bits=feat_bits + dec_bits,
            stages=3,
            tcam_bits=feat_bits, sram_bits=dec_bits)

    # classical: feature value tables + one aggregation/compare stage
    m = art.vtable.q.shape[2]
    feat_entries = int((valid_edges + 1).sum())
    bits = feat_entries * m * art.vtable.bits
    extra_tables = 1 if art.agg != "nb_log" else 2   # paper: NB uses 2 tables
    # classical value tables are range-keyed on the feature axis but
    # store per-class payload vectors: key side TCAM, payload side SRAM.
    # The key codes are log2(radix)-ish and dwarfed by the payloads, so
    # bill the whole bits figure as SRAM and the entry *keys* as TCAM at
    # the code width of the edge count.
    key_bits = (int(((valid_edges + 1) * _code_bits(valid_edges + 1)).sum())
                if f_dim else 0)
    return ResourceReport(tables=f_dim + extra_tables,
                          entries=feat_entries, bits=bits,
                          stages=3 if art.agg != "nb_log" else 4,
                          tcam_bits=int(key_bits), sram_bits=bits)


# -- device fit (Planter-style deploy gate) ---------------------------------


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Declarative per-device resource budget.

    Budgets are deliberately coarse — the public numbers for a
    Tofino-class switch ASIC (order: 12 stages, O(10) MiB SRAM, O(1) MiB
    TCAM) and a SmartNIC match-action pipeline. The point is not cycle
    accuracy but a *monotone gate*: any artifact the profile rejects
    has genuinely outgrown that class of device, and growth in any
    utilization column is visible in the bench trajectory.
    """

    name: str
    stages: int
    sram_kib: int
    tcam_kib: int
    max_entries: int
    max_tables: int

    def budgets(self) -> Dict[str, float]:
        return {"stages": self.stages,
                "sram_kib": float(self.sram_kib),
                "tcam_kib": float(self.tcam_kib),
                "entries": float(self.max_entries),
                "tables": float(self.max_tables)}


# Default profiles. tofino_like mirrors the device class IIsy's Table 2
# targets; nic_like is a deliberately leaner SmartNIC-ish budget so the
# utilization rows show meaningful headroom differences.
TOFINO_LIKE = DeviceProfile(name="tofino_like", stages=12,
                            sram_kib=10 * 1024, tcam_kib=1024,
                            max_entries=400_000, max_tables=32)
NIC_LIKE = DeviceProfile(name="nic_like", stages=6,
                         sram_kib=2 * 1024, tcam_kib=128,
                         max_entries=100_000, max_tables=16)
PROFILES: Dict[str, DeviceProfile] = {p.name: p
                                      for p in (TOFINO_LIKE, NIC_LIKE)}
DEFAULT_PROFILE = TOFINO_LIKE


class FitError(ValueError):
    """Raised by check_fit(..., strict=True) when an artifact cannot
    deploy on the profile. Carries the full report for diagnostics."""

    def __init__(self, report: "FitReport"):
        self.report = report
        super().__init__(
            f"artifact does not fit {report.profile}: "
            + "; ".join(report.violations))


@dataclasses.dataclass
class FitReport:
    profile: str
    fits: bool
    utilization: Dict[str, float]   # budget key -> used/budget fraction
    used: Dict[str, float]
    violations: List[str]

    def row(self) -> Dict[str, object]:
        """Flat row: the profile, whether it fits, one utilization per budget."""
        out: Dict[str, object] = {"profile": self.profile,
                                  "fits": bool(self.fits)}
        for k, v in self.utilization.items():
            out[f"util_{k}"] = round(float(v), 6)
        return out


def check_fit(art_or_report, profile: DeviceProfile = DEFAULT_PROFILE, *,
              strict: bool = False) -> FitReport:
    """Map an artifact (or a precomputed ResourceReport) against a
    device budget *before* deploy.

    Every budget dimension yields a utilization fraction; any fraction
    above 1.0 is a violation. ``strict=True`` raises :class:`FitError`
    instead of returning an unfit report — that is the mode
    ``finalize_artifact(..., profile=...)`` uses as a deploy guard.
    """
    if isinstance(art_or_report, ResourceReport):
        res = art_or_report
    else:
        res = artifact_resources(art_or_report)
    sram_bits = res.sram_bits if (res.sram_bits or res.tcam_bits) else res.bits
    used = {"stages": float(res.stages),
            "sram_kib": sram_bits / 8 / 1024,
            "tcam_kib": res.tcam_bits / 8 / 1024,
            "entries": float(res.entries),
            "tables": float(res.tables)}
    budgets = profile.budgets()
    util = {k: (used[k] / budgets[k] if budgets[k] else float("inf"))
            for k in budgets}
    violations = [f"{k}: {used[k]:g} > budget {budgets[k]:g} "
                  f"({util[k]:.2f}x)"
                  for k in budgets if util[k] > 1.0]
    report = FitReport(profile=profile.name, fits=not violations,
                       utilization=util, used=used, violations=violations)
    if strict and violations:
        raise FitError(report)
    return report
