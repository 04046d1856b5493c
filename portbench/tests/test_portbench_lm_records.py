"""The ``lm_records`` kind on the CPU at a small size: the check passes the
program and fails faults planted in it (activations rounded to fp8, the
router's group limit left out, one expert's contribution dropped, a pair
the grouped GEMM never stored), and the control (the reference with fp8
activations in the program's place) fails the comparison too.

The small size is the kind's card-less one (``lm_records.CARDLESS``: 32
experts in the 8 groups, top-4 groups, top-8, a capacity of 32 rows,
float32 activations); ``conftest.py`` runs these tests on one intra-op
thread."""

import json
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.kinds import lm_records

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "portbench" / "configs"
                  / "dsv3-anomaly.json").read_text())
MIX = {"law": "unsw_records", "anomaly_frac": 0.13, "train_rows": 2000,
       "batch": 256, "pool_batches": 3, "in_flight": 1, "trace_requests": 2}
CAPACITY = lm_records.CARDLESS["capacity"]


def serve(n=7, seed=61):
    cell = lm_records.Cell(CFG, MIX, seed, "cpu")
    harness.run_count(cell, 0, n, cell.depth)
    counters = cell.counters()
    cell.release()
    checks, failed = cell.check((n - 2, 2))
    return cell, counters, checks, failed


def bad(checks) -> set:
    return {k for k, (v, lim) in checks.items() if v > lim}


def test_the_program_passes_its_check():
    cell, counters, checks, failed = serve()
    assert bad(checks) == set() and failed == 0
    tokens = CAPACITY * 8
    assert counters["routed_pairs"].tolist() == [8 * tokens * 7] * 4
    assert counters["expert_tokens"].sum(-1).tolist() == [8 * tokens * 7] * 4
    assert set(cell.bounds) == {"b1", "b9"} and cell.least_s > 0
    assert cell.bounds["b9"][1] == 2 * 2 * 4
    assert cell.logits.shape == (7, CAPACITY, 2)


def _fp8_rows(x):
    """x rounded to e4m3 with one scale a row (its largest over 448)."""
    s = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / 448.0
    return ((x / s).to(torch.float8_e4m3fn).to(x.dtype) * s)


def test_activations_rounded_to_fp8_fail(monkeypatch):
    from repro_torch.models import transformer
    real = transformer.apply_norm
    monkeypatch.setattr(transformer, "apply_norm",
                        lambda cfg, p, x: _fp8_rows(real(cfg, p, x)))
    checks = serve()[2]
    assert "logit_error" in bad(checks)


def test_the_group_limit_left_out_fails(monkeypatch):
    import dataclasses

    from repro_torch.models import moe
    real = moe.route_sigmoid
    monkeypatch.setattr(moe, "route_sigmoid", lambda p, m, x: real(
        p, dataclasses.replace(m, topk_group=m.n_group), x))
    checks = serve()[2]
    assert "route_apart" in bad(checks)


def test_one_expert_dropped_fails(monkeypatch):
    from repro_torch.models import moe
    real = moe.grouped_ffn

    def drop(x, plan, experts, w, stored=None):
        y = real(x, plan, experts, w, stored)
        gone = (plan.order.new_zeros(y.shape[0], dtype=torch.bool)
                .index_fill_(0, plan.order[:int(plan.counts[0])], True))
        return torch.where(gone[:, None], torch.zeros_like(y), y)
    monkeypatch.setattr(moe, "grouped_ffn", drop)
    checks = serve()[2]
    assert "logit_error" in bad(checks)


def test_a_pair_never_stored_fails(monkeypatch):
    """The plan of every MoE layer loses its busiest expert's last pair,
    as a tile B9 skipped would: the stored count falls short."""
    from repro_torch.models import moe
    real = moe.expert_plan

    def short(ids, n_experts):
        plan = real(ids, n_experts)
        plan.counts[int(plan.counts.argmax())] -= 1
        return plan
    monkeypatch.setattr(moe, "expert_plan", short)
    checks = serve()[2]
    assert "routed_pairs_mismatch" in bad(checks)


def test_the_control_fails_the_comparison():
    cell = lm_records.Cell.offline(CFG, MIX, 62, "cpu")
    numbers = cell.control(4)
    assert any(v > lim for v, lim in numbers.values())


@pytest.mark.parametrize("key", ["hidden_size", "n_routed_experts",
                                 "num_experts_per_tok", "n_group"])
def test_the_config_file_holds_the_published_numbers(key):
    """What the program serves is read from the registry and held to the
    config file: the widths here, the routing in ``program_config``."""
    pub = {"hidden_size": 7168, "n_routed_experts": 256,
           "num_experts_per_tok": 8, "n_group": 8}
    assert CFG[key] == pub[key]
    cfg = lm_records.program_config(CFG)
    assert (cfg.d_model, cfg.moe.n_experts, cfg.moe.top_k,
            cfg.moe.n_group)[list(pub).index(key)] == pub[key]
