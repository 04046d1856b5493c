"""AST lint pass over ``src/repro_torch/`` (rule section ``lint``).

Port of ``repro/analysis/lint.py``, whose walk of all of ``src/`` stays as
it is. One rule for each of the reference's:

* ``lint-host-sync-in-graph`` (the reference's ``lint-host-sync-in-jit``)
  — host-sync idioms (``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``float``/``int``/``bool`` of a value, ``np.asarray``/
  ``np.array``, ``torch.cuda.synchronize``) inside a function the module
  hands to a CUDA-graph capture: the ``body`` passed to ``_replay_step``,
  the callables under a ``torch.cuda.graph(...)`` block, and every
  attribute named in an ``AUDIT_CONTRACTS`` row; with every method such a
  function names on ``self`` (or calls) in the same module, and a
  subclass's override of a captured method. Each idiom blocks the host
  per call (or, in a capture, fails it).
* ``lint-broad-except`` — ``except Exception`` / bare ``except`` without a
  justification comment on the same or previous line (waivers
  ``noqa: BLE001`` or ``lint: allow-broad-except``, each with a reason),
  as the reference has it.
* ``lint-env-mutation`` — module-level ``os.environ`` mutation outside
  ``launch/`` (waiver ``lint: allow-env-mutation``), as the reference has
  it.
* ``lint-carry-out-of-place`` (the reference's ``lint-missing-donate``) —
  a carry is "donated" here when it is written in place, so inside a
  captured function the rule flags a rebinding of a carry attribute
  (``regs``, a ``StreamStats`` field, the deferral buffer or pending set,
  the server's ``_table``/``_stats``/``_dd``/``_pending``) by anything but
  an in-place method (``copy_``, ``index_copy_``, ``fill_``, ``zero_``, an
  op ending in ``_``) or an augmented assignment. Its run-time twin is
  ``hotpath-donation``.
"""

from __future__ import annotations

import ast
import functools
import os
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.analysis.registry import Finding, Rule, RULES, register

PORT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_ROOT = os.path.dirname(PORT_ROOT)                     # .../repo/src

WAIVER_TAGS = ("noqa: BLE001", "lint: allow-broad-except")
ENV_WAIVER_TAG = "lint: allow-env-mutation"

HOST_SYNC_CALLS = {"float", "int", "bool"}
HOST_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
NUMPY_SYNC_ATTRS = {"asarray", "array"}
# float()/int()/bool() of these is host arithmetic on a shape, not a sync
_SHAPE_CALLS = {"len", "numel", "size", "dim", "nelement"}

# the carries a step writes in place: the register file, the StreamStats
# fields, the deferral buffer and pending set, and the server's handles
CARRY_ATTRS = frozenset({
    "regs", "epoch",
    "windows", "packets", "handled", "backend_rows", "deferred", "degraded",
    "flushes", "evicted", "overflow", "conf_sum",
    "dd", "pending", "table", "stats",
    "_table", "_stats", "_dd", "_pending"})


def iter_source_files(root: str = PORT_ROOT) -> Iterable[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _is_launch_module(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return "launch" in parts


def _numpy_aliases(tree: ast.Module) -> Set[str]:
    """Aliases of the numpy module (``import numpy as np``)."""
    aliases = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "numpy":
                    aliases.add(alias.asname or "numpy")
    return aliases


def _dotted(expr: ast.expr) -> str:
    """``torch.cuda.graph`` for that attribute chain, '' otherwise."""
    parts = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return ""


# -- what a module captures ---------------------------------------------------


def _callable_name(expr: ast.expr) -> Optional[str]:
    """The function a callable expression names: ``f``, ``self.f`` or
    ``obj.f`` -> "f"."""
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def _contract_attrs(tree: ast.Module) -> Set[str]:
    """Every "attr" of every ``AUDIT_CONTRACTS`` row in the module."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign) or not any(
                isinstance(t, ast.Name) and t.id == "AUDIT_CONTRACTS"
                for t in node.targets):
            continue
        for sub in ast.walk(node.value):
            if isinstance(sub, ast.Dict):
                for k, v in zip(sub.keys, sub.values):
                    if (isinstance(k, ast.Constant) and k.value == "attr"
                            and isinstance(v, ast.Constant)):
                        out.add(v.value)
    return out


def _is_graph_block(item: ast.withitem) -> bool:
    call = item.context_expr
    return (isinstance(call, ast.Call)
            and _dotted(call.func).endswith("cuda.graph"))


def _capture_roots(tree: ast.Module) -> Tuple[Set[str], List[ast.AST]]:
    """(function names the module captures, lambda / block bodies captured
    inline)."""
    names = set(_contract_attrs(tree))
    inline: List[ast.AST] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _callable_name(node.func) \
                == "_replay_step":
            body = node.args[1] if len(node.args) > 1 else next(
                (k.value for k in node.keywords if k.arg == "body"), None)
            if isinstance(body, ast.Lambda):
                inline.append(body)
            elif body is not None and _callable_name(body):
                names.add(_callable_name(body))
        elif isinstance(node, ast.With) and any(
                _is_graph_block(i) for i in node.items):
            for stmt in node.body:
                inline.append(stmt)
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and _callable_name(sub.func):
                        names.add(_callable_name(sub.func))
    return names, inline


def _functions(tree: ast.Module) -> Dict[str, List[ast.AST]]:
    """name -> every function definition of that name in the module."""
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out


def _referenced(node: ast.AST, defined: Set[str]) -> Set[str]:
    """Module functions a body calls, and methods it names on ``self``."""
    out = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id in defined:
            out.add(sub.func.id)
        elif (isinstance(sub, ast.Attribute)
              and isinstance(sub.value, ast.Name) and sub.value.id == "self"
              and sub.attr in defined):
            out.add(sub.attr)
    return out


def captured_functions(tree: ast.Module,
                       inherited: Set[str] = frozenset()) -> Set[str]:
    """Names of the module's functions that run inside a capture: the
    roots (``_capture_roots``, and ``inherited`` names a base class
    captures), closed over what they call or name on ``self``."""
    fns = _functions(tree)
    defined = set(fns)
    roots, inline = _capture_roots(tree)
    todo = [n for n in (roots | set(inherited)) if n in defined]
    for node in inline:
        todo += list(_referenced(node, defined))
    seen: Set[str] = set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for fn in fns[name]:
            todo += list(_referenced(fn, defined) - seen)
    return seen


# -- rule: host-sync idioms inside captured functions -------------------------


def _shape_read(expr: ast.expr) -> bool:
    """``x.shape`` or a call in ``_SHAPE_CALLS`` (``len(x)``, ``x.size()``,
    ``x.numel()``): a size the host holds, whatever ``x`` is."""
    if isinstance(expr, ast.Attribute):
        return expr.attr == "shape"
    return (isinstance(expr, ast.Call)
            and _callable_name(expr.func) in _SHAPE_CALLS)


def _host_value(arg: ast.expr, np_aliases: Set[str]) -> bool:
    """A value computed on the host: a constant, a shape or a count (or an
    entry of one, at a host index), a numpy scalar (``np.float32(...)``),
    or arithmetic on those. An index into a tensor is not one, even at a
    host index: ``int(w[w.shape[0] - 1])`` reads the device."""
    if isinstance(arg, ast.Constant):
        return True
    if isinstance(arg, ast.BinOp):
        return (_host_value(arg.left, np_aliases)
                and _host_value(arg.right, np_aliases))
    if isinstance(arg, ast.UnaryOp):
        return _host_value(arg.operand, np_aliases)
    if isinstance(arg, ast.Subscript):
        return (_shape_read(arg.value)
                and _host_value(arg.slice, np_aliases))
    if _shape_read(arg):
        return True
    return (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Attribute)
            and isinstance(arg.func.value, ast.Name)
            and arg.func.value.id in np_aliases)


def _host_sync_idiom(node: ast.Call, np_aliases: Set[str]) -> Optional[str]:
    f = node.func
    if isinstance(f, ast.Name) and f.id in HOST_SYNC_CALLS and node.args \
            and not isinstance(node.args[0], ast.Constant) \
            and not _host_value(node.args[0], np_aliases):
        return f"{f.id}(...) of a value"
    if isinstance(f, ast.Attribute):
        if f.attr in HOST_SYNC_METHODS:
            return f".{f.attr}()"
        if (f.attr in NUMPY_SYNC_ATTRS and isinstance(f.value, ast.Name)
                and f.value.id in np_aliases):
            return f"{f.value.id}.{f.attr}(...)"
        if _dotted(f).endswith("cuda.synchronize"):
            return "torch.cuda.synchronize()"
    return None


def _walk_captured(tree: ast.Module, captured: Set[str]):
    """(enclosing function path, node) for every node inside a captured
    function, and inside every inline captured body."""

    class Visitor(ast.NodeVisitor):
        def __init__(self):
            self.stack: List[str] = []
            self.hits: List[Tuple[str, ast.AST]] = []

        def visit_FunctionDef(self, node):
            self.stack.append(node.name)
            self.generic_visit(node)
            self.stack.pop()

        visit_AsyncFunctionDef = visit_FunctionDef

        def generic_visit(self, node):
            if any(n in captured for n in self.stack):
                self.hits.append(("/".join(self.stack), node))
            super().generic_visit(node)

    v = Visitor()
    v.visit(tree)
    seen = {id(n) for _, n in v.hits}
    _, inline = _capture_roots(tree)
    for body in inline:
        for sub in ast.walk(body):
            if id(sub) not in seen:
                seen.add(id(sub))
                v.hits.append(("<captured block>", sub))
    return v.hits


def _check_host_sync(path: str, tree: ast.Module,
                     captured: Set[str]) -> List[Finding]:
    np_aliases = _numpy_aliases(tree)
    out: List[Finding] = []
    for where, node in _walk_captured(tree, captured):
        if not isinstance(node, ast.Call):
            continue
        bad = _host_sync_idiom(node, np_aliases)
        if bad:
            out.append(Finding(
                rule="lint-host-sync-in-graph",
                message=(f"host-sync idiom {bad} inside captured function "
                         f"{where!r}"),
                path=path, line=node.lineno))
    return out


# -- rule: carry rebound out of place -------------------------------------------


def _check_carry_out_of_place(path: str, tree: ast.Module,
                              captured: Set[str]) -> List[Finding]:
    out: List[Finding] = []
    for where, node in _walk_captured(tree, captured):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "setattr" and len(node.args) >= 2 \
                and isinstance(node.args[1], ast.Constant) \
                and node.args[1].value in CARRY_ATTRS:
            out.append(Finding(
                rule="lint-carry-out-of-place",
                message=(f"setattr rebinds carry {node.args[1].value!r} "
                         f"inside captured function {where!r}: write it in "
                         "place"),
                path=path, line=node.lineno))
            continue
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Attribute) and sub.attr in CARRY_ATTRS \
                        and isinstance(sub.ctx, ast.Store):
                    out.append(Finding(
                        rule="lint-carry-out-of-place",
                        message=(f"carry {_dotted(sub) or sub.attr!r} "
                                 f"rebound inside captured function "
                                 f"{where!r}: write it in place (copy_, "
                                 "index_copy_, fill_, zero_)"),
                        path=path, line=node.lineno))
    return out


# -- rule: broad except without justification -------------------------------


def _has_waiver(lines: List[str], lineno: int, tags: Tuple[str, ...]) -> bool:
    """Waiver tag on the flagged line or the line above it."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines) and any(t in lines[ln - 1] for t in tags):
            return True
    return False


def _check_broad_except(path: str, tree: ast.Module,
                        lines: List[str]) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        broad = node.type is None or (
            isinstance(node.type, ast.Name)
            and node.type.id in ("Exception", "BaseException"))
        if broad and not _has_waiver(lines, node.lineno, WAIVER_TAGS):
            what = ("bare except" if node.type is None
                    else f"except {node.type.id}")
            out.append(Finding(
                rule="lint-broad-except",
                message=(f"{what} without justification — narrow it or "
                         "add '# noqa: BLE001 — <reason>'"),
                path=path, line=node.lineno))
    return out


# -- rule: module-level os.environ mutation ---------------------------------


def _env_mutations(tree: ast.Module) -> List[ast.stmt]:
    """Top-level statements that write os.environ."""

    def is_environ(expr: ast.expr) -> bool:
        return (isinstance(expr, ast.Attribute) and expr.attr == "environ"
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "os")

    hits = []
    for node in tree.body:                       # module top level only
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break                            # defs run later, not at import
            if isinstance(sub, ast.Assign) and any(
                    isinstance(t, ast.Subscript) and is_environ(t.value)
                    for t in sub.targets):
                hits.append(sub)
            elif isinstance(sub, ast.Call):
                f = sub.func
                if (isinstance(f, ast.Attribute)
                        and f.attr in ("setdefault", "update", "pop")
                        and is_environ(f.value)):
                    hits.append(sub)
    return hits


def _check_env_mutation(path: str, tree: ast.Module,
                        lines: List[str]) -> List[Finding]:
    if _is_launch_module(path):
        return []
    out = []
    for node in _env_mutations(tree):
        if _has_waiver(lines, node.lineno, (ENV_WAIVER_TAG,)):
            continue
        out.append(Finding(
            rule="lint-env-mutation",
            message=("module-level os.environ mutation outside launch/ — "
                     "imports must be side-effect free (waive with "
                     f"'# {ENV_WAIVER_TAG} — <reason>')"),
            path=path, line=node.lineno))
    return out


# -- the package's classes: overrides of captured methods --------------------


def _class_captures(trees: Dict[str, ast.Module]) -> Dict[str, Set[str]]:
    """class name -> the method names captured in it or in a base class
    (by name, package-wide), so an override is captured too."""
    bases: Dict[str, List[str]] = {}
    own: Dict[str, Set[str]] = {}
    for tree in trees.values():
        captured = captured_functions(tree)
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                bases[node.name] = [_callable_name(b) for b in node.bases
                                    if _callable_name(b)]
                methods = {n.name for n in node.body
                           if isinstance(n, (ast.FunctionDef,
                                             ast.AsyncFunctionDef))}
                own[node.name] = methods & captured

    def total(cls: str, depth: int = 0) -> Set[str]:
        if depth > 16 or cls not in own:
            return set()
        out = set(own[cls])
        for b in bases.get(cls, ()):
            out |= total(b, depth + 1)
        return out

    return {cls: total(cls) for cls in own}


def _inherited(tree: ast.Module, by_class: Dict[str, Set[str]]) -> Set[str]:
    """Captured names this module's classes inherit from their bases."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            for b in node.bases:
                out |= by_class.get(_callable_name(b) or "", set())
    return out


# -- the pass over the tree --------------------------------------------------


def _lint_tree(path: str, tree: ast.Module, lines: List[str],
               inherited: Set[str] = frozenset()) -> List[Finding]:
    captured = captured_functions(tree, inherited)
    findings: List[Finding] = []
    findings += _check_host_sync(path, tree, captured)
    findings += _check_broad_except(path, tree, lines)
    findings += _check_env_mutation(path, tree, lines)
    findings += _check_carry_out_of_place(path, tree, captured)
    return findings


def _parse(path: str, source: str):
    try:
        return ast.parse(source, filename=path), None
    except SyntaxError as exc:
        return None, Finding(rule="lint-parse", path=path,
                             line=exc.lineno or 0,
                             message=f"syntax error: {exc.msg}")


def lint_source(path: str, source: str) -> List[Finding]:
    """All lint findings for one module's source text (its classes'
    bases resolved within the module only)."""
    tree, err = _parse(path, source)
    if err is not None:
        return [err]
    inherited = _inherited(tree, _class_captures({path: tree}))
    return _lint_tree(path, tree, source.splitlines(), inherited)


def lint_paths(paths: Optional[Iterable[str]] = None) -> List[Finding]:
    """All lint findings over ``paths`` (default: every module of
    ``src/repro_torch/``); a class's captured methods are resolved through
    its bases across every module linted."""
    sources, trees, findings = {}, {}, []
    for path in (paths if paths is not None else iter_source_files()):
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        rel = os.path.relpath(path, os.path.dirname(SRC_ROOT))
        tree, err = _parse(rel, source)
        if err is not None:
            findings.append(err)
            continue
        sources[rel], trees[rel] = source, tree
    by_class = _class_captures(trees)
    for rel, tree in trees.items():
        findings += _lint_tree(rel, tree, sources[rel].splitlines(),
                               _inherited(tree, by_class))
    return findings


@functools.lru_cache(maxsize=1)
def _tree_lint() -> Tuple[Finding, ...]:
    """The real tree's findings, linted once for the four rules."""
    return tuple(lint_paths())


def _only(rule: str, findings: List[Finding]) -> List[Finding]:
    return [f for f in findings if f.rule == rule]


def _tree_findings(rule: str) -> List[Finding]:
    return _only(rule, list(_tree_lint()))


# Seeded-violation fixtures: each must make its rule fire.
_FIXTURE_HOST_SYNC = """
import numpy as np
import torch

class Server:
    def _replay_step(self, key, body, inp):
        return body(inp)

    def serve(self, w):
        return self._replay_step("window", self._body, w)

    def _body(self, w):
        n = float(w.sum())
        rows = np.asarray(w)
        k = w[0].item()
        last = int(w[w.shape[0] - 1])
        host = w.cpu()
        ids = w.tolist()
        torch.cuda.synchronize()
        return n + rows.sum() + k + last + host.sum() + len(ids)
"""

_FIXTURE_BROAD_EXCEPT = """
def risky():
    try:
        return 1
    except Exception:
        return 0
    except:
        return -1
"""

_FIXTURE_ENV = """
import os
os.environ["CUDA_VISIBLE_DEVICES"] = "0"
"""

_FIXTURE_CARRY = """
import dataclasses

class Server:
    AUDIT_CONTRACTS = ({"attr": "_window_step", "probe": "window",
                        "carries": ("table", "stats")},)

    def _window_step(self, c, w):
        c.table.regs = c.table.regs + w.sum()
        self._stats = dataclasses.replace(self._stats, windows=1)
        return ()
"""


def register_rules() -> None:
    rules = (
        Rule(name="lint-host-sync-in-graph", section="lint",
             doc="no .item()/.cpu()/.tolist()/.numpy()/float()/"
                 "np.asarray/torch.cuda.synchronize inside a function a "
                 "CUDA graph captures (or an AUDIT_CONTRACTS row names)",
             check=lambda: _tree_findings("lint-host-sync-in-graph"),
             selftest=lambda: _only("lint-host-sync-in-graph",
                                    lint_source("fixture.py",
                                                _FIXTURE_HOST_SYNC))),
        Rule(name="lint-broad-except", section="lint",
             doc="except Exception / bare except requires a justification "
                 "comment (noqa: BLE001 or lint: allow-broad-except)",
             check=lambda: _tree_findings("lint-broad-except"),
             selftest=lambda: _only("lint-broad-except",
                                    lint_source("fixture.py",
                                                _FIXTURE_BROAD_EXCEPT))),
        Rule(name="lint-env-mutation", section="lint",
             doc="no module-level os.environ mutation outside launch/",
             check=lambda: _tree_findings("lint-env-mutation"),
             selftest=lambda: _only("lint-env-mutation",
                                    lint_source("fixture.py",
                                                _FIXTURE_ENV))),
        Rule(name="lint-carry-out-of-place", section="lint",
             doc="a captured step writes its carries in place (copy_, "
                 "index_copy_, fill_, zero_), never rebinds them",
             check=lambda: _tree_findings("lint-carry-out-of-place"),
             selftest=lambda: _only("lint-carry-out-of-place",
                                    lint_source("fixture.py",
                                                _FIXTURE_CARRY))))
    for rule in rules:
        if rule.name not in RULES:
            register(rule)
