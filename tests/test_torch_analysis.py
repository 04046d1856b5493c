"""The port's analysis gate (``repro_torch.analysis``): the counterparts of
``tests/test_analysis.py``'s seventeen tests (registry, AST lint, resource
fit, the CLI gate, the op recorder), each rule's seeded violations, the
hot-path audit of every server's ``AUDIT_CONTRACTS`` on the CPU, parity with
the reference's analysis (fit rows, contracted censuses, dtypes), and the
(2, 2) census in four gloo processes.

The ranks import this module, so it imports no jax at its top: the
reference's modules are imported inside the tests. Everything compared
with the reference is exact (the fit rows are host arithmetic on the same
tables).
"""

import datetime
import json
import multiprocessing
import os
import queue
import subprocess
import sys
import time
import traceback

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.analysis import dispatch_utils as DU  # noqa: E402
from repro_torch.analysis import fit, hotpath, lint  # noqa: E402
from repro_torch.analysis.registry import (RULES, Finding, Rule,  # noqa: E402
                                           register, run_rules)
from repro_torch.core.resources import (DEFAULT_PROFILE,  # noqa: E402
                                        NIC_LIKE, PROFILES, DeviceProfile,
                                        FitError, check_fit)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_RULES = ("hotpath-donation", "hotpath-zero-sync", "hotpath-dtype",
              "hotpath-collectives", "lint-host-sync-in-graph",
              "lint-broad-except", "lint-env-mutation",
              "lint-carry-out-of-place", "fit-standard-artifacts")
RANK_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _gate_on_cpu():
    hotpath.set_device("cpu")
    fit.set_device("cpu")


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_rejects_duplicates_and_bad_sections():
    r = Rule(name="t-dup", section="lint", doc="",
             check=lambda: [], selftest=lambda: [Finding("t-dup", "x")])
    register(r)
    try:
        with pytest.raises(ValueError, match="duplicate"):
            register(r)
    finally:
        RULES.pop("t-dup")
    with pytest.raises(ValueError, match="unknown section"):
        Rule(name="t-bad", section="nope", doc="",
             check=lambda: [], selftest=lambda: [])


def test_run_rules_isolates_rule_crashes():
    """A crashing rule is reported as a crash, never as a pass."""

    def boom():
        raise RuntimeError("auditor exploded")

    register(Rule(name="t-crash", section="lint", doc="",
                  check=boom, selftest=lambda: []))
    register(Rule(name="t-fine", section="lint", doc="",
                  check=lambda: [], selftest=lambda: [Finding("t-fine", "f")]))
    try:
        report = run_rules(sections=("lint",))
        by_name = {r.rule: r for r in report.results}
        assert "auditor exploded" in by_name["t-crash"].error
        assert not by_name["t-crash"].ok
        assert by_name["t-fine"].ok
        assert not report.ok
    finally:
        RULES.pop("t-crash")
        RULES.pop("t-fine")


def test_silent_selftest_fails_the_report():
    register(Rule(name="t-noop", section="lint", doc="",
                  check=lambda: [], selftest=lambda: []))
    try:
        report = run_rules(sections=("lint",))
        res = {r.rule: r for r in report.results}["t-noop"]
        assert res.selftest_fired is False
        assert not res.ok and not report.ok
    finally:
        RULES.pop("t-noop")


# ---------------------------------------------------------------------------
# AST lint rules — seeded violations must fire, idiomatic code must not
# ---------------------------------------------------------------------------

def _fired(source, path="fixture.py"):
    return {f.rule for f in lint.lint_source(path, source)}


def test_lint_host_sync_fires_on_seeded_violations():
    msgs = [f.message for f in lint.lint_source("fixture.py",
                                                lint._FIXTURE_HOST_SYNC)
            if f.rule == "lint-host-sync-in-graph"]
    assert len(msgs) == 7
    for idiom in ("float(", "int(", "np.asarray", ".item()", ".cpu()",
                  ".tolist()", "torch.cuda.synchronize()"):
        assert any(idiom in m for m in msgs), idiom


def test_lint_host_sync_spares_uncaptured_and_reads_every_capture_form():
    # the same idioms in a function no capture reaches: clean
    assert not _fired("""
import numpy as np
def host_side(x):
    return float(np.asarray(x).sum()) + x.numpy().sum() + x.item()
""")
    # a callable under a torch.cuda.graph block, and .numpy() there
    assert "lint-host-sync-in-graph" in _fired("""
import torch
def step(x):
    return x.numpy()
def capture(g, x):
    with torch.cuda.graph(g):
        out = step(x)
    return out
""")
    # a lambda handed to _replay_step, and what it calls on self
    assert "lint-host-sync-in-graph" in _fired("""
class S:
    def serve(self, w):
        return self._replay_step("k", lambda c, i: self._half(c, i), w)
    def _half(self, c, i):
        return int(i.sum())
""")
    # an AUDIT_CONTRACTS attr, and a subclass's override of it
    assert "lint-host-sync-in-graph" in _fired("""
class Base:
    AUDIT_CONTRACTS = ({"attr": "_switch", "probe": "window"},)
    def _switch(self, c, w):
        return w
class Child(Base):
    def _switch(self, c, w):
        return w.cpu()
""")
    # shapes, counts and numpy scalars are host values, not syncs
    assert not _fired("""
import numpy as np
class S:
    AUDIT_CONTRACTS = ({"attr": "_step", "probe": "window"},)
    def _step(self, c, w):
        k = int(w.shape[0]) + int(len(c)) + int(w.numel())
        j = int(w.shape[-1] - 1) + int(w.size()[0]) + int(w.size(1))
        return w * float(np.float32(1.0) / np.float32(k + j))
""")
    # an index into a tensor reads the device, whatever its index is
    for read in ("int(w[w.shape[0] - 1])", "float(w[len(c)])",
                 "int(w.sum() + w.shape[0])"):
        assert "lint-host-sync-in-graph" in _fired(f"""
class S:
    AUDIT_CONTRACTS = ({{"attr": "_step", "probe": "window"}},)
    def _step(self, c, w):
        return {read}
"""), read


def test_lint_broad_except_fires_and_respects_waivers():
    assert "lint-broad-except" in _fired(lint._FIXTURE_BROAD_EXCEPT)
    for waiver in ("noqa: BLE001", "lint: allow-broad-except"):
        assert not _fired(f"""
def risky():
    try:
        return 1
    except Exception:  # {waiver} — telemetry never raises
        return 0
""")
    assert not _fired("""
def risky():
    try:
        return 1
    # noqa: BLE001 — fault boundary, everything must degrade
    except Exception:
        return 0
""")
    assert not _fired("""
def risky():
    try:
        return 1
    except (ValueError, KeyError):
        return 0
""")


def test_lint_env_mutation_fires_outside_launch_only():
    assert "lint-env-mutation" in _fired(lint._FIXTURE_ENV)
    assert not lint.lint_source("src/repro_torch/launch/fixture.py",
                                lint._FIXTURE_ENV)
    assert not _fired("""
import os
# lint: allow-env-mutation — test shim
os.environ["X"] = "1"
""")
    assert not _fired("""
import os
def configure():
    os.environ["X"] = "1"
""")


def test_lint_carry_out_of_place_fires_and_spares_in_place_writes():
    fired = [f for f in lint.lint_source("fixture.py", lint._FIXTURE_CARRY)
             if f.rule == "lint-carry-out-of-place"]
    assert len(fired) == 2
    assert any("c.table.regs" in f.message for f in fired)
    assert any("self._stats" in f.message for f in fired)
    # in-place writes, augmented assignments and slices: clean
    assert not _fired("""
class S:
    AUDIT_CONTRACTS = ({"attr": "_step", "probe": "window"},)
    def _step(self, c, w):
        c.table.regs.copy_(c.table.regs + 1.0)
        c.stats.windows += 1
        c.dd.buf.index_copy_(0, w, w)
        c.pending.fill_(-1)
        c.stats.packets[...] = 0
        regs = c.table.regs + 1.0          # a local, not the carry
        return regs
""")
    # setattr on a carry inside a capture fires; outside one nothing does
    assert "lint-carry-out-of-place" in _fired("""
class S:
    AUDIT_CONTRACTS = ({"attr": "_step", "probe": "window"},)
    def _step(self, c, w):
        setattr(c.table, "regs", w)
""")
    assert not _fired("""
class S:
    def reset(self, fresh):
        self._table = fresh
        self._stats = fresh
""")


def test_lint_clean_on_the_real_tree():
    findings = lint.lint_paths()
    assert not findings, "\n".join(f.format() for f in findings)


def test_lint_captures_the_servers_step_bodies():
    """The lint reaches every contracted body and what it calls, and the
    sharded server's overrides through its base class."""
    import ast
    trees = {p: ast.parse(open(p).read()) for p in lint.iter_source_files()}
    by_class = lint._class_captures(trees)
    root = os.path.join(REPO, "src", "repro_torch", "serving")
    cap = {}
    for name in ("stream_serving", "shard_serving", "hybrid_serving"):
        tree = trees[os.path.join(root, f"{name}.py")]
        cap[name] = lint.captured_functions(tree,
                                            lint._inherited(tree, by_class))
    assert {"_window_step", "_window_switch", "_chunk_step",
            "_deferred_step", "_flush_step", "_flush_finish",
            "_fused_backend", "_chunk_finish", "defer_tail",
            "accumulate_stream_stats"} <= cap["stream_serving"]
    assert {"_shard_switch", "_slab_classify", "_fused_backend",
            "_chunk_switch", "_defer_switch"} <= cap["shard_serving"]
    assert "_share" not in cap["shard_serving"]       # the two-phase route
    assert "_probe_backend" not in cap["stream_serving"]
    assert cap["hybrid_serving"] == {"_step"}


# ---------------------------------------------------------------------------
# resource fit
# ---------------------------------------------------------------------------

def test_standard_artifacts_fit_default_profile():
    for name, art in fit.standard_artifacts():
        rep = check_fit(art, DEFAULT_PROFILE)
        assert rep.fits, f"{name}: {rep.violations}"
        assert all(0.0 <= u for u in rep.utilization.values())
    assert [n for n, _ in fit.standard_artifacts()] == ["dt", "rf", "xgb"]


def test_check_fit_rejects_oversized_artifact():
    for profile in PROFILES.values():
        rep = check_fit(fit.oversized_report(), profile)
        assert not rep.fits
        assert any("entries" in v for v in rep.violations)
    with pytest.raises(FitError, match="does not fit"):
        check_fit(fit.oversized_report(), DEFAULT_PROFILE, strict=True)


def test_finalize_artifact_profile_guard():
    import dataclasses

    from repro_torch.core.artifact import finalize_artifact
    from repro_torch.core.resources import artifact_resources
    art = dict(fit.standard_artifacts())["xgb"]
    raw = dataclasses.replace(art, ftable_flat=None, dtable_flat=None,
                              dtable_pad=None)
    entries = artifact_resources(art).entries
    tight = DeviceProfile(name="tight", stages=12, sram_kib=1 << 20,
                          tcam_kib=1 << 20, max_entries=entries // 2,
                          max_tables=1 << 10)
    with pytest.raises(FitError, match="entries"):
        finalize_artifact(raw, profile=tight)
    out = finalize_artifact(raw, profile=DEFAULT_PROFILE)
    assert out.ftable_flat is not None


def test_fit_rows_cover_every_artifact_profile_pair():
    rows = fit.fit_rows()
    assert len(rows) == len(fit.standard_artifacts()) * len(PROFILES)
    for row in rows:
        assert set(row) >= {"artifact", "profile", "fits", "util_entries",
                            "util_sram_kib", "util_tcam_kib", "util_tables",
                            "util_stages"}
    assert NIC_LIKE.name in {r["profile"] for r in rows}


def test_resource_report_split_is_consistent():
    from repro_torch.core.resources import artifact_resources
    for name, art in fit.standard_artifacts():
        res = artifact_resources(art)
        assert res.tcam_bits + res.sram_bits == res.bits, name


def test_fit_rows_equal_the_reference_on_its_artifacts():
    """The reference's DT/RF/XGB standard artifacts carried across: the
    port's fit rows equal the reference's ``fit_rows()`` exactly."""
    from repro.analysis import fit as jfit
    from test_torch_parity import port_artifact
    ref_arts = jfit.standard_artifacts()
    ported = [(name, port_artifact(art)) for name, art in ref_arts]
    assert fit.fit_rows(ported) == jfit.fit_rows()


# ---------------------------------------------------------------------------
# the CLI gate itself
# ---------------------------------------------------------------------------

def test_strict_gate_passes_clean_tree():
    """``python -m repro_torch.analysis --strict --json --device cpu``
    exits 0 with every port rule registered and its self-test fired."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict", "--json",
         "--device", "cpu"], capture_output=True, text=True, timeout=600,
        cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["ok"] and report["n_findings"] == 0
    by_name = {r["rule"]: r for r in report["results"]}
    assert set(by_name) == set(PORT_RULES)
    for rule in PORT_RULES:
        assert by_name[rule]["selftest_fired"] is True, rule
        assert by_name[rule]["error"] == "", rule


def test_cli_section_filter_and_nonstrict_lint():
    from repro_torch.analysis.cli import main
    assert main(["--section", "lint", "--json", "--device", "cpu"]) == 0


def test_run_rules_can_skip_the_selftests():
    """``selftests=False`` runs the checks only: a self-test not run
    reports None, which does not fail the rule, as the reference's
    ``run_rules`` reports it."""
    from repro.analysis import registry as jreg
    calls = []

    def selftest():
        calls.append(1)
        return []

    rule = dict(name="t-skip", section="lint", doc="", check=lambda: [],
                selftest=selftest)
    register(Rule(**rule))
    jreg.register(jreg.Rule(**rule))
    try:
        report = run_rules(sections=("lint",), selftests=False)
        ref = jreg.run_rules(sections=("lint",), selftests=False)
        got = {r.rule: r for r in report.results}["t-skip"]
        want = {r.rule: r for r in ref.results}["t-skip"]
        assert got.selftest_fired is None and got.ok
        assert not calls
        assert ({k: v for k, v in got.to_json().items() if k != "elapsed_s"}
                == {k: v for k, v in want.to_json().items()
                    if k != "elapsed_s"})
        assert report.ok
        assert not run_rules(sections=("lint",)).ok    # the silent self-test
        assert calls == [1]
    finally:
        RULES.pop("t-skip")
        jreg.RULES.pop("t-skip")


def test_cli_no_selftests_and_strict(capsys):
    """``--no-selftests`` leaves every ``selftest_fired`` null; under
    ``--strict`` the self-tests run all the same."""
    from repro_torch.analysis.cli import main
    assert main(["--no-selftests", "--section", "lint", "--json",
                 "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["results"]
    assert all(r["selftest_fired"] is None for r in report["results"])
    assert main(["--strict", "--no-selftests", "--section", "lint",
                 "--json", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] and report["results"]
    assert all(r["selftest_fired"] is True for r in report["results"])


def test_cli_defaults_to_the_card_and_fails_loudly_without_one():
    from repro_torch.analysis.cli import main
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--section", "lint"])


def test_dispatch_utils_recorder_and_census():
    """The recorder's machinery on toy programs (the self-tests cover the
    negative direction): ops inside helpers and loops are recorded, a
    clean step has no sync, cross-device copies and mask indexing are
    syncs, the census counts kinds and rank >= 2 readouts."""

    def helper(s, w):
        return s * 2.0 + w

    def good_step(state, w):
        for _ in range(2):
            state = helper(state, w)
        return state, w.sum()

    rec = DU.OpRecorder()
    with rec:
        good_step(torch.zeros(8, 8), torch.ones(8, 8))
    assert rec.syncs == [] and rec.dtypes <= {"float32"}
    assert sum("aten.mul" in op for op in rec.ops) == 2
    assert sum("aten.add" in op for op in rec.ops) == 2
    cpu, meta = torch.zeros(2), torch.empty(2, device="meta")
    assert "cpu -> meta" in DU.host_sync_reason(
        torch.ops.aten._to_copy.default, (cpu,), {}, meta)
    assert DU.host_sync_reason(torch.ops.aten._to_copy.default, (cpu,), {},
                               cpu.clone()) == ""
    assert "meta" in DU.host_sync_reason(torch.ops.aten.copy_.default,
                                         (meta, cpu), {}, meta)
    mask = torch.tensor([True, False])
    assert "mask" in DU.host_sync_reason(torch.ops.aten.index.Tensor,
                                         (cpu, [mask]), {}, cpu[:1])
    assert DU.host_sync_reason(torch.ops.aten.index.Tensor,
                               (cpu, [torch.tensor([1])]), {}, cpu[:1]) == ""
    calls = [("psum", 2), ("psum", 0), ("reduce_scatter", 2),
             ("reduce_scatter", 1), ("all_gather", 1)]
    assert DU.collective_census(calls) == {"psum": 2, "reduce_scatter": 2,
                                           "all_gather": 1}
    assert DU.readout_count(calls, "psum") == 1
    assert DU.readout_count(calls, "reduce_scatter") == 1
    assert DU.launch_delta({"matmul": 1, "loop": 0},
                           {"matmul": 3, "loop": 0}) == {"matmul": 2}


# ---------------------------------------------------------------------------
# each rule's seeded violations, one by one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("selftest, want", [
    (hotpath._selftest_donation, ("selftest[fresh]: carry table.regs was "
                                  "not written in place",
                                  "selftest[swapped]: carry table.regs "
                                  "moved")),
    (hotpath._selftest_zero_sync, ("selftest[item]: "
                                   "aten._local_scalar_dense",
                                   "selftest[mask]: aten.index.Tensor")),
    (hotpath._selftest_dtypes, ("selftest: ['float64']",)),
    (hotpath._selftest_collectives, (
        "selftest[doubled psum]: collective census {'psum': 2}",
        "selftest[doubled reduce_scatter]: collective census "
        "{'reduce_scatter': 2}",
        "selftest[rank-1 scatter]: 0 rank>=2 readout reduce_scatters")),
    (fit._selftest_rejects_oversized, ("selftest: oversized ensemble "
                                       "rejected",)),
], ids=["fresh-carry", "item", "float64", "census", "oversized"])
def test_each_seeded_violation_fires(selftest, want):
    msgs = [f.message for f in selftest()]
    assert len(msgs) == len(want), msgs
    for w in want:
        assert any(m.startswith(w) for m in msgs), (w, msgs)


# ---------------------------------------------------------------------------
# the hot-path audit of the real servers on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def probe_records():
    return hotpath.audit(device="cpu")


def test_every_contracted_row_is_audited_and_clean(probe_records):
    from repro_torch.serving.hybrid_serving import HybridServer
    from repro_torch.serving.shard_serving import ShardedStreamingServer
    from repro_torch.serving.stream_serving import StreamingHybridServer
    labels = {r.label for r in probe_records}
    for cls in (HybridServer, StreamingHybridServer, ShardedStreamingServer):
        for row in cls.AUDIT_CONTRACTS:
            assert any(lab.startswith(cls.__name__)
                       and lab.endswith("." + row["attr"])
                       for lab in labels), (cls.__name__, row["attr"])
    assert len(probe_records) == 11
    for check in (hotpath.donation_findings, hotpath.zero_sync_findings,
                  hotpath.dtype_findings, hotpath.collective_findings):
        found = check(probe_records)
        assert not found, "\n".join(f.format() for f in found)
    for r in probe_records:
        assert r.n_ops > 10 and not r.graph        # eager on the CPU
        assert r.launches == {}                    # plain versions here
        assert "float64" not in r.dtypes


def test_sharded_census_per_step(probe_records):
    by = {r.label: DU.collective_census(r.calls) for r in probe_records}
    assert by["ShardedStreamingServer._window_step"] == {
        "psum": 3, "reduce_scatter": 1, "all_gather": 2}
    assert by["ShardedStreamingServer[chunked]._chunk_step"] == {
        "psum": 3, "reduce_scatter": 1, "all_gather": 3}
    assert by["ShardedStreamingServer[deferred]._deferred_step"] == {
        "psum": 2, "reduce_scatter": 1, "all_gather": 2}
    assert by["ShardedStreamingServer[deferred]._flush_step"] == {
        "reduce_scatter": 1, "all_gather": 1}
    assert by["StreamingHybridServer._window_step"] == {}


def test_donation_catches_a_carry_left_unwritten(monkeypatch):
    """The register file's copy-back dropped: the plain route's new
    registers never reach the carry, which the audit reports."""
    from repro_torch.serving.stream_serving import StreamingHybridServer
    monkeypatch.setattr(StreamingHybridServer, "_store_regs",
                        lambda self, regs, state: None)
    recs = hotpath.audit(device="cpu", tiers=("StreamingHybridServer",))
    bad = {f.message.split(":")[0] for f in hotpath.donation_findings(recs)}
    assert "StreamingHybridServer._window_step" in bad
    assert "StreamingHybridServer[chunked]._chunk_step" in bad


def test_zero_sync_and_dtype_catch_a_step_that_reads_the_host(monkeypatch):
    """A fold that reads a counter on the host and sums in float64."""
    from repro_torch.serving import stream_serving as ss
    real = ss._fold_conf

    def syncing(conf, valid):
        int(valid.sum())
        return real(conf, valid).to(torch.float64).to(torch.float32)

    monkeypatch.setattr(ss, "_fold_conf", syncing)
    recs = hotpath.audit(device="cpu", tiers=("StreamingHybridServer",))
    syncs = hotpath.zero_sync_findings(recs)
    assert any("_window_step" in f.message and "_local_scalar_dense"
               in f.message for f in syncs)
    assert any("float64" in f.message for f in hotpath.dtype_findings(recs))


def test_collectives_catch_a_doubled_merge(monkeypatch):
    """One psum more in the sharded switch half breaks the census of every
    sharded row that runs it."""
    from repro_torch.serving import shard_serving as sh
    real = sh.psum
    monkeypatch.setattr(sh, "psum", lambda x, g: real(real(x, g), g)
                        if x.dim() >= 2 else real(x, g))
    recs = hotpath.audit(device="cpu", tiers=("ShardedStreamingServer",))
    msgs = [f.message for f in hotpath.collective_findings(recs)]
    assert any(m.startswith("ShardedStreamingServer._window_step: "
                            "collective census") for m in msgs)
    assert any("2 rank>=2 readout psums" in m for m in msgs)


# ---------------------------------------------------------------------------
# the audit's one-rank group: started for the sharded rows, then destroyed
# ---------------------------------------------------------------------------

def _no_group_yet():
    if dist.is_initialized():
        pytest.fail("a default process group is already running")


def test_audit_destroys_the_group_it_started():
    _no_group_yet()
    recs = hotpath.audit(device="cpu", tiers=("ShardedStreamingServer",))
    assert recs and not dist.is_initialized()
    assert hotpath._selftest_collectives()
    assert not dist.is_initialized()


def test_audit_then_a_one_rank_sharded_server_in_one_process():
    """What a worker that runs this file before ``test_torch_shard.py``
    does: the audit, then a D = 1 server on a one-rank group of its own."""
    from repro_torch.distributed.sharding import flow_shard_mesh
    from repro_torch.serving.shard_serving import ShardedStreamingServer
    from repro_torch.serving.stream_serving import probe_window
    _no_group_yet()
    hotpath.audit(device="cpu")
    mesh = flow_shard_mesh(device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        g = hotpath.PROBE
        srv = ShardedStreamingServer(
            hotpath.probe_artifact("cpu"), hotpath.traceable_backend,
            mesh=mesh, n_buckets=g["n_buckets"], window=g["window"],
            capacity=g["capacity"], threshold=g["threshold"], device="cpu")
        pred, _ = srv.step(probe_window(g["window"], g["n_buckets"],
                                        g["seed"], device="cpu"))
        assert tuple(pred.shape) == (g["window"],)
    finally:
        dist.destroy_process_group()


def test_audit_leaves_a_group_it_did_not_start():
    from repro_torch.distributed.sharding import flow_shard_mesh
    _no_group_yet()
    flow_shard_mesh(device="cpu")
    try:
        hotpath.audit(device="cpu", tiers=("ShardedStreamingServer",))
        hotpath._selftest_collectives()
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# parity with the reference's contracts
# ---------------------------------------------------------------------------

def test_contracted_census_matches_the_reference_rows():
    """Every reference AUDIT_CONTRACTS row has a port row with its census
    and readout counts; the chunk step's one more all-gather (its backend's
    answers, ROADMAP C3) is the only difference."""
    from repro.serving import hybrid_serving as jh
    from repro.serving import shard_serving as jsh
    from repro.serving import stream_serving as jss
    from repro_torch.serving.hybrid_serving import HybridServer
    from repro_torch.serving.shard_serving import ShardedStreamingServer
    from repro_torch.serving.stream_serving import StreamingHybridServer
    pairs = ((jh.HybridServer, HybridServer),
             (jss.StreamingHybridServer, StreamingHybridServer),
             (jsh.ShardedStreamingServer, ShardedStreamingServer))
    for ref_cls, port_cls in pairs:
        port = {r["reference"]: r for r in port_cls.AUDIT_CONTRACTS
                if r["reference"]}
        for ref_row in ref_cls.AUDIT_CONTRACTS:
            row = port[ref_row["attr"]]
            assert row["probe"] == ref_row["probe"]
            want = dict(ref_row["collectives"])
            if ref_row["attr"] == "_chunk_step" and want:
                want["all_gather"] += 1
            assert row["collectives"] == want, (port_cls, ref_row["attr"])
            for key in ("readout_psums", "readout_scatters"):
                assert row.get(key) == ref_row.get(key)
            # a donated argument is a carry written in place here
            assert bool(row["carries"]) == bool(ref_row["donate"])


def test_allowed_dtypes_are_the_references_plus_c3(probe_records):
    from repro.analysis import hotpath as jhot
    assert hotpath.ALLOWED_DTYPES - jhot.ALLOWED_DTYPES == {"int64",
                                                           "uint8"}
    assert jhot.ALLOWED_DTYPES <= hotpath.ALLOWED_DTYPES
    seen = set().union(*(r.dtypes for r in probe_records))
    assert seen - jhot.ALLOWED_DTYPES <= {"int64", "uint8"}
    assert {k: hotpath.PROBE[k] for k in jhot.PROBE} == jhot.PROBE


# ---------------------------------------------------------------------------
# the (2, 2) mesh: four gloo processes
# ---------------------------------------------------------------------------

def _rank_audit(rank, world, store, results):
    """One spawned rank of the (2, 2) mesh: the sharded rows' audit ->
    (rank, {label: (census, readouts, findings)}, traceback or None)."""
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        recs = hotpath.audit(device="cpu", tiers=("ShardedStreamingServer",))
        found = []
        for check in (hotpath.donation_findings, hotpath.zero_sync_findings,
                      hotpath.dtype_findings, hotpath.collective_findings):
            found += [f.format() for f in check(recs)]
        out = {r.label: (DU.collective_census(r.calls),
                         DU.readout_count(r.calls, "psum"),
                         DU.readout_count(r.calls, "reduce_scatter"))
               for r in recs}
        results.put((rank, (out, found), None))
    except BaseException:            # reported to the parent, which fails
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_sharded_census_on_a_2x2_mesh_in_four_gloo_processes(tmp_path):
    from repro_torch.serving.shard_serving import ShardedStreamingServer
    world = 4
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = str(tmp_path / "store_2x2")
    procs = [ctx.Process(target=_rank_audit,
                         args=(r, world, store, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, why = {}, None
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        while len(got) < world and why is None:
            try:
                rank, out, err = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    why = f"ranks {dead} died"
                elif time.monotonic() > deadline:
                    why = f"ranks still running after {RANK_TIMEOUT_S} s"
                continue
            if err is not None:
                why = f"rank {rank} raised:\n{err}"
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30 if why is None else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert why is None, why
    rows = {r["attr"]: r for r in ShardedStreamingServer.AUDIT_CONTRACTS}
    for rank in range(world):
        census, found = got[rank]
        assert not found, f"rank {rank}: {found}"
        assert len(census) == len(rows)
        for label, (c, n_psum, n_scatter) in census.items():
            assert "[2x2" in label, label
            row = rows[label.rsplit(".", 1)[1]]
            assert c == row["collectives"], (rank, label)
            assert (n_psum, n_scatter) == (row["readout_psums"],
                                           row["readout_scatters"])
