"""repro_torch.analysis — the port's analysis gate.

Port of ``repro/analysis`` (DESIGN.md §15): three subsystems behind one
rule registry and one CLI (``python -m repro_torch.analysis``):

* **hotpath** — runs every serving tier's contracted step bodies
  (``AUDIT_CONTRACTS``) once under an aten-op recorder
  (``dispatch_utils``) and, on the card, through their CUDA graphs: the
  carries are written in place (donation), no host sync inside a step
  (zero-sync), the f32/i32/bool register layout with the documented
  int64/uint8 additions (no f64), and the sharded steps' exact collective
  census.
* **lint** — an AST pass over ``src/repro_torch/``: host-sync idioms in
  captured functions, broad ``except`` without justification,
  module-level ``os.environ`` mutation, carries rebound out of place.
* **fit** — the switch resource-fit checker (``core.resources.
  check_fit``) on the served artifact families.

Every rule carries a seeded-violation self-test (``--strict`` runs them)
so the analyzer can never rot into a silent no-op.
"""

from repro_torch.analysis.registry import (AnalysisReport, Finding,  # noqa: F401
                                           Rule, RULES, iter_rules, register,
                                           run_rules)
from repro_torch.analysis.lint import lint_paths, lint_source  # noqa: F401
