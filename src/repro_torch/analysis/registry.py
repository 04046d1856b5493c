"""Rule registry for the port's analysis gate.

Port of ``repro/analysis/registry.py`` (a copy: the port imports nothing
of the reference package).

A :class:`Rule` is a named check in one of three sections (``lint``,
``hotpath``, ``fit``). Rules self-register at import time via
:func:`register`; the CLI runs them through :func:`run_rules` and folds
the findings into an :class:`AnalysisReport`. Every rule must carry a
``selftest`` callable that seeds a violation and proves the rule fires —
``--strict`` refuses to pass if any rule's self-test is silent.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence

SECTIONS = ("lint", "hotpath", "fit")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One concrete violation reported by a rule."""

    rule: str
    message: str
    path: str = ""
    line: int = 0
    severity: str = "error"  # "error" | "warning"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}: " if self.path else ""
        return f"{loc}[{self.rule}] {self.message}"

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Rule:
    """A named static check.

    ``check`` returns the findings on the real tree (empty = clean).
    ``selftest`` seeds a violation out-of-tree and returns the findings
    the rule produced on it; an empty self-test result means the rule
    has rotted into a no-op and fails ``--strict``.
    """

    name: str
    section: str
    doc: str
    check: Callable[[], List[Finding]]
    selftest: Callable[[], List[Finding]]

    def __post_init__(self) -> None:
        if self.section not in SECTIONS:
            raise ValueError(f"unknown section {self.section!r} for rule {self.name!r}")


RULES: Dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if rule.name in RULES:
        raise ValueError(f"duplicate rule name {rule.name!r}")
    RULES[rule.name] = rule
    return rule


def iter_rules(sections: Optional[Sequence[str]] = None) -> List[Rule]:
    """Rules in registration order, optionally filtered by section."""
    rules = list(RULES.values())
    if sections:
        wanted = set(sections)
        unknown = wanted - set(SECTIONS)
        if unknown:
            raise ValueError(f"unknown sections: {sorted(unknown)}")
        rules = [r for r in rules if r.section in wanted]
    return rules


@dataclasses.dataclass
class RuleResult:
    rule: str
    section: str
    findings: List[Finding]
    selftest_fired: Optional[bool]  # None = self-test not run
    elapsed_s: float
    error: str = ""  # non-empty if the rule itself crashed

    @property
    def ok(self) -> bool:
        return not self.findings and not self.error and self.selftest_fired is not False

    def to_json(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "section": self.section,
            "findings": [f.to_json() for f in self.findings],
            "selftest_fired": self.selftest_fired,
            "elapsed_s": round(self.elapsed_s, 3),
            "error": self.error,
        }


@dataclasses.dataclass
class AnalysisReport:
    results: List[RuleResult]

    @property
    def findings(self) -> List[Finding]:
        return [f for r in self.results for f in r.findings]

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def to_json(self) -> Dict[str, object]:
        return {
            "ok": self.ok,
            "n_rules": len(self.results),
            "n_findings": len(self.findings),
            "results": [r.to_json() for r in self.results],
        }


def run_rules(sections: Optional[Sequence[str]] = None,
              selftests: bool = True) -> AnalysisReport:
    """Run every registered rule (and optionally its self-test; one not
    run reports ``selftest_fired`` None).

    A rule that raises is reported as a failed result rather than
    aborting the whole run, so one broken auditor cannot mask the rest.
    """
    results: List[RuleResult] = []
    for rule in iter_rules(sections):
        t0 = time.perf_counter()
        findings: List[Finding] = []
        fired: Optional[bool] = None
        error = ""
        try:
            findings = list(rule.check())
            if selftests:
                fired = bool(rule.selftest())
        except Exception as exc:  # noqa: BLE001 — isolate rule crashes into the report
            error = f"{type(exc).__name__}: {exc}"
        results.append(RuleResult(rule=rule.name, section=rule.section,
                                  findings=findings, selftest_fired=fired,
                                  elapsed_s=time.perf_counter() - t0, error=error))
    return AnalysisReport(results=results)
