"""Resource-fit rules (rule section ``fit``).

Port of ``repro/analysis/fit.py``, on the port's ``core/resources.py``
(host numpy). The check half proves every artifact family the serving
stack deploys (DT, RF and XGB over the streaming readout layout, fitted by
the port's ``ml/trees.py``) fits the default Tofino-like profile; the
self-test half proves :func:`check_fit` genuinely *rejects*: a paper-scale
oversized ensemble (wide per-feature radices, the regime IIsy §4 / Table 1
calls out as the naive-mapping blowup) must fail.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np

from repro_torch.analysis.registry import Finding, Rule, RULES, register
from repro_torch.core.resources import DEFAULT_PROFILE, PROFILES, check_fit

_SETTINGS = {"device": None}


def set_device(device) -> None:
    """The device the registered rule fits its artifacts on (None: CUDA)."""
    _SETTINGS["device"] = device


@functools.lru_cache(maxsize=None)
def _standard_artifacts(device: Optional[str]):
    from repro_torch.core.artifact import finalize_artifact
    from repro_torch.core.mapping import map_tree_ensemble
    from repro_torch.ml.trees import (fit_decision_tree, fit_random_forest,
                                      fit_xgboost)
    from repro_torch.netsim.stream import FLOW_FEATURES
    rng = np.random.RandomState(0)
    x = rng.rand(512, FLOW_FEATURES).astype(np.float32) * 1500.0
    y = ((x[:, 0] > x[:, 1]) ^ (x[:, 2] > 700.0)).astype(np.int32)
    dt = fit_decision_tree(x, y, n_classes=2, max_depth=5, device=device)
    rf = fit_random_forest(x, y, n_classes=2, n_trees=10, max_depth=5,
                           device=device)
    xgb = fit_xgboost(x, y, n_trees=10, max_depth=5, device=device)
    return tuple(
        (name, finalize_artifact(map_tree_ensemble(m, FLOW_FEATURES)))
        for name, m in (("dt", dt), ("rf", rf), ("xgb", xgb)))


def standard_artifacts(device=None):
    """(name, finalized artifact) for the model families the serving stack
    deploys, small trained instances of each mapping, fitted on ``device``
    (None: the gate's device, CUDA unless set)."""
    dev = _SETTINGS["device"] if device is None else device
    return _standard_artifacts(None if dev is None else str(dev))


def oversized_report():
    """A deliberately paper-scale ResourceReport no single device holds:
    8 features x 256-entry range tables feeding trees whose per-feature
    code radix is 16 — prod(radix) decision entries per tree, the §4
    blowup the mapping's table split exists to avoid."""
    from repro_torch.core.resources import ResourceReport
    f_dim, radix, n_trees, feat_entries = 8, 16, 4, 256 * 8
    dec_entries = n_trees * radix ** f_dim          # 4 * 16^8 ~ 1.7e10
    feat_bits = feat_entries * 4 * f_dim
    dec_bits = dec_entries * 2
    return ResourceReport(tables=f_dim + n_trees + 1,
                          entries=feat_entries + dec_entries,
                          bits=feat_bits + dec_bits, stages=3,
                          tcam_bits=feat_bits, sram_bits=dec_bits)


def fit_rows(artifacts=None) -> List[Dict[str, object]]:
    """Per-(artifact, profile) utilization rows over ``artifacts``
    ((name, artifact) pairs; default ``standard_artifacts()``)."""
    rows = []
    for name, art in (standard_artifacts() if artifacts is None
                      else artifacts):
        for profile in PROFILES.values():
            rows.append({"artifact": name, **check_fit(art, profile).row()})
    return rows


def check_standard_artifacts_fit() -> List[Finding]:
    out = []
    for name, art in standard_artifacts():
        rep = check_fit(art, DEFAULT_PROFILE)
        if not rep.fits:
            out.append(Finding(
                rule="fit-standard-artifacts",
                message=(f"{name} artifact no longer fits "
                         f"{DEFAULT_PROFILE.name}: "
                         + "; ".join(rep.violations))))
    return out


def _selftest_rejects_oversized() -> List[Finding]:
    rep = check_fit(oversized_report(), DEFAULT_PROFILE)
    if not rep.fits:
        return [Finding(rule="fit-standard-artifacts",
                        message="selftest: oversized ensemble rejected: "
                                + "; ".join(rep.violations))]
    return []


def register_rules() -> None:
    if "fit-standard-artifacts" in RULES:
        return
    register(Rule(
        name="fit-standard-artifacts", section="fit",
        doc="every served artifact family (dt/rf/xgb) deploys under the "
            "default device profile; check_fit rejects paper-scale "
            "oversized ensembles",
        check=check_standard_artifacts_fit,
        selftest=_selftest_rejects_oversized))
