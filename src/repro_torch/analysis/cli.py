"""``python -m repro_torch.analysis`` — run the port's analysis gate.

Port of ``repro/analysis/cli.py``: the same JSON report (``ok``,
``n_findings``, ``results[].rule``, ``results[].selftest_fired``). Exit
status 0 iff every rule is clean (no findings, no rule crashes, and no
rule's seeded violation silent; ``--no-selftests`` skips them outside
``--strict``). The hot-path audit
and the fits run on the card unless ``--device cpu`` is given; without a
card the default fails loudly.

    python -m repro_torch.analysis                   # human output
    python -m repro_torch.analysis --json            # machine output
    python -m repro_torch.analysis --strict          # the gate
    python -m repro_torch.analysis --section lint    # one section only
    python -m repro_torch.analysis --no-selftests    # rules only
    python -m repro_torch.analysis --device cpu      # plain paths, gloo
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.analysis.registry import SECTIONS, AnalysisReport, run_rules


def _register_all(device) -> None:
    from repro_torch.analysis import fit, hotpath, lint
    hotpath.set_device(device)
    fit.set_device(device)
    for mod in (lint, fit, hotpath):
        mod.register_rules()


def _human(report: AnalysisReport) -> str:
    lines: List[str] = []
    for res in report.results:
        status = "OK"
        if res.error:
            status = f"CRASH ({res.error})"
        elif res.findings:
            status = f"{len(res.findings)} finding(s)"
        elif res.selftest_fired is False:
            status = "SELFTEST SILENT (rule is a no-op)"
        lines.append(f"[{res.section:7s}] {res.rule:28s} {status:30s} "
                     f"{res.elapsed_s:6.2f}s")
        for f in res.findings:
            lines.append(f"    {f.format()}")
    lines.append(f"{'PASS' if report.ok else 'FAIL'}: "
                 f"{len(report.results)} rules, "
                 f"{len(report.findings)} findings")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's analysis gate: AST lint, hot-path auditor "
                    "over the serving steps, device resource-fit checker")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--strict", action="store_true",
                    help="CI mode: self-tests forced on; nonzero exit on "
                         "any finding, rule crash, or silent self-test")
    ap.add_argument("--section", choices=SECTIONS, action="append",
                    help="run only this section (repeatable)")
    ap.add_argument("--no-selftests", action="store_true",
                    help="skip the seeded-violation self-tests "
                         "(ignored under --strict)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the hot-path audit and the fits run")
    args = ap.parse_args(argv)

    selftests = args.strict or not args.no_selftests
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)       # no card: fails here, loudly
    _register_all(dev)
    from repro_torch.analysis.hotpath import own_group
    with own_group():
        report = run_rules(sections=args.section, selftests=selftests)
    if args.json:
        print(json.dumps(report.to_json(), indent=2, sort_keys=True))
    else:
        print(_human(report))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
