"""The plain reference against the port's CPU paths at small sizes: the
served predictions, each request's telemetry, and for the stream the whole
register file and counters, bit for bit; and the reference's pieces
against the program's own models."""

import numpy as np
import pytest
import torch

from portbench import harness, laws, trees
from portbench.laws import unsw_records
from portbench.kinds import records, stream
from portbench.reference.stream import features
from portbench.reference.trees import Trees

RECORDS_CFG = {"kind": "records", "n_features": 5,
               "switch": {"trees": 4, "depth": 3},
               "backend": {"trees": 8, "depth": 3, "learning_rate": 0.3},
               "tau": 0.8, "capacity": 64}
RECORDS_MIX = {"law": "unsw_records", "anomaly_frac": 0.13,
               "train_rows": 2000, "batch": 256, "pool_batches": 4,
               "in_flight": 1, "trace_requests": 4}
STREAM_CFG = {"kind": "stream", "n_buckets": 512, "window": 64,
              "chunk_windows": 4, "evict_age": 5.0,
              "switch": {"trees": 4, "depth": 3},
              "backend": {"trees": 4, "depth": 4}, "tau": 0.9,
              "capacity": 8}
PACKETS_MIX = {"law": "packets", "flows_per_60s": 400, "anomaly_frac": 0.13,
               "mean_pkts": 12, "duration_s": 60,
               "pool_chunks": 4, "in_flight": 2, "trace_requests": 4}
ELEPHANTS_MIX = dict(PACKETS_MIX, law="elephants", flows_per_60s=100,
                     pool_chunks=8,
                     elephants={"count": 2, "pkts_per_60s": 1200})


def _rows(rng, n):
    x, y = unsw_records.rows(rng, {"anomaly_frac": 0.13}, n)
    return x[:, :5], y


def serve(kind, cfg, mix, seed, n):
    cell = kind.Cell(cfg, mix, seed, "cpu")
    harness.run_count(cell, 0, n, cell.depth)
    counters = cell.counters()
    cell.release()
    checks, failed = cell.check((n - 2, 2))
    return cell, counters, checks, failed


def test_records_cell_matches_the_port():
    cell, counters, checks, failed = serve(records, RECORDS_CFG, RECORDS_MIX,
                                           21, 10)
    assert {k: v for k, (v, _) in checks.items()} == dict.fromkeys(checks, 0)
    assert failed == 0 and counters["rows"] == 10 * 256
    assert counters["backend_rows"] > 0
    assert set(cell.bounds) == {"b1"} and cell.least_s > 0


@pytest.mark.parametrize("epoch", [None, 2048], ids=["one-epoch", "epochs"])
@pytest.mark.parametrize("mix", [PACKETS_MIX, ELEPHANTS_MIX],
                         ids=["packets", "elephants"])
def test_stream_cell_matches_the_port(mix, epoch, monkeypatch):
    if epoch:                  # passes of 1024 packets, two an epoch
        monkeypatch.setattr(stream, "EPOCH_PACKETS", epoch)
    n = 40 if mix is PACKETS_MIX else 160
    cell, _, checks, failed = serve(stream, STREAM_CFG, mix, 22, n)
    assert cell.epoch == (8 if epoch else 4 * 256)
    assert {k: v for k, (v, _) in checks.items()} == dict.fromkeys(checks, 0)
    assert failed == 0
    c = cell.program_counters
    assert c["flushes"] == n and c["packets"] == n * 256
    assert c["evicted"] > 0
    if mix is ELEPHANTS_MIX:
        assert c["overflow"] > 0          # the hot buckets reached 2^24
    assert set(cell.bounds) == {"b1", "b5", "b6"}
    assert cell.bounds["b5"][1] == 2 * 4


def test_reference_trees_against_the_programs_models():
    from repro_torch.core.mapping import map_tree_ensemble
    from repro_torch.kernels.ops import fused_classify
    from repro_torch.ml.trees import ensemble_from_arrays, \
        predict_tree_ensemble
    r_x, r_f = laws.streams(31, 2)
    x, y = _rows(r_x, 3000)
    rf = trees.fit_forest(x, y, r_f, n_trees=6, depth=4)
    xgb = trees.fit_boosting(x, y, n_trees=10, depth=4)
    xt = torch.as_tensor(x)
    art = map_tree_ensemble(ensemble_from_arrays(
        rf.feat, rf.thresh, rf.leaf, "rf", device="cpu"), 5)
    pred, conf = fused_classify(art, xt, device="cpu")
    ref_pred, ref_conf = Trees(rf, "cpu").vote(xt)
    assert torch.equal(pred, ref_pred) and torch.equal(conf, ref_conf)
    for ens in (rf, xgb):
        prog = ensemble_from_arrays(ens.feat, ens.thresh, ens.leaf, ens.kind,
                                    base_score=ens.base_score,
                                    learning_rate=ens.learning_rate,
                                    device="cpu")
        assert torch.equal(predict_tree_ensemble(prog, xt),
                           Trees(ens, "cpu").predict(xt))


def test_features_match_the_programs_readout():
    from repro_torch.netsim.features import table_from_registers
    rng = np.random.default_rng(0)
    rows = torch.as_tensor(rng.integers(0, 50, (8, 100)).astype(np.float32))
    rows[2] = torch.rand(100)
    rows[3] = rows[2] + torch.rand(100)
    assert torch.equal(features(rows), table_from_registers(*rows))


def test_fitted_trees_are_complete_heaps():
    r_x, r_f = laws.streams(32, 2)
    x, y = _rows(r_x, 2000)
    rf = trees.fit_forest(x, y, r_f, n_trees=3, depth=5)
    assert rf.feat.shape == (3, 31) and rf.leaf.shape == (3, 32, 2)
    assert np.isfinite(rf.thresh[:, 0]).all()       # every root splits
    xgb = trees.fit_boosting(x, y, n_trees=4, depth=6)
    assert xgb.thresh.shape == (4, 63) and xgb.leaf.shape == (4, 64, 1)


def test_data_time_stays_within_an_epoch(monkeypatch):
    """Across epochs the served timestamps stay below one epoch's span and
    the register file's times below it too; the rebase moves the
    register file's two time rows and nothing else."""
    monkeypatch.setattr(stream, "EPOCH_PACKETS", 2048)
    cell = stream.Cell(STREAM_CFG, PACKETS_MIX, 23, "cpu")
    span = cell.inputs["span"]
    assert cell.shift == 2 * span
    assert [cell.offset(j) for j in range(10)] == [0.0] * 4 + [span] * 4 \
        + [0.0] * 2
    for j in range(7):
        cell.finish(cell.issue(j))
    before = cell.server.state.regs.clone()
    cell.prepare(8)                    # the second epoch's first request
    after = cell.server.state.regs
    moved = before[2:4] - cell.shift
    assert torch.equal(after[2:4], moved)
    assert torch.equal(after[[0, 1, 4, 5, 6, 7]], before[[0, 1, 4, 5, 6, 7]])
    assert float(cell.ts.max()) < span
    assert float(after[3][torch.isfinite(after[3])].max()) < 0.0
