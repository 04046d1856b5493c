"""The traffic laws: each mix finds its law by name, the same seed gives
the same rows and packets, the copies give what the program's own
generators give, and each mix keeps its documented parameters."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import flows, laws
from portbench.laws import elephants, packets, unsw_records

ROOT = Path(__file__).resolve().parents[2]
MIXES = ROOT / "portbench" / "traffic"


def _mix(name):
    return json.loads((MIXES / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(p.stem for p in MIXES.glob("*.json")))
def test_each_mix_finds_its_law_by_name(name):
    mix = _mix(name)
    law = laws.find(mix)
    assert law.__name__ == f"portbench.laws.{mix['law']}"
    assert callable(getattr(law, "rows", None)) \
        or callable(getattr(law, "packets", None))


def test_a_new_law_needs_only_a_module_and_a_mix(monkeypatch):
    """A packet law added as a module of its own feeds the stream kind with
    no other file changed."""
    import sys
    import types

    from portbench.kinds import stream
    from portbench.tests.test_portbench_reference import STREAM_CFG
    mod = types.ModuleType("portbench.laws.one_flow_a_bucket")
    mod.packets = lambda rngs, mix: packets.synth(
        rngs[0], mix["flows"], mean_pkts=4, duration=10.0)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    mix = {"law": "one_flow_a_bucket", "flows": 600, "pool_chunks": 2,
           "in_flight": 2}
    cell = stream.Cell.offline(STREAM_CFG, mix, 5, "cpu")
    assert cell.inputs["cols"]["ts"].shape == (2, 4, 64)


def test_streams_are_seeded_and_independent():
    a = [r.random(4) for r in laws.streams(2**31 + 7, 3)]
    b = [r.random(4) for r in laws.streams(2**31 + 7, 3)]
    c = [r.random(4) for r in laws.streams(2**31 + 8, 3)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], a[1])
    assert not np.array_equal(a[0], c[0])


def test_records_copy_the_programs_law():
    from repro_torch.data.unsw_like import make_unsw_like
    x, y = unsw_records.rows(np.random.default_rng(5),
                             {"anomaly_frac": 0.13}, 3000)
    xr, yr = make_unsw_like(3000, seed=5, n_features=10)
    assert np.array_equal(x, xr) and np.array_equal(y, yr)


def test_packets_copy_the_programs_law():
    from repro_torch.netsim.packets import synth_trace
    t = packets.synth(np.random.default_rng(9), 500)
    r = synth_trace(n_flows=500, seed=9)
    for k in laws.PACKET_FIELDS + ("flow_label",):
        assert np.array_equal(t[k], getattr(r, k)), k


def test_elephants_copy_the_programs_scenario():
    from repro_torch.netsim.scenarios import elephant_mice
    bg = packets.synth(np.random.default_rng(4), 1000)
    el = elephants.bulk(np.random.default_rng(4 + 0xE1E0), 8, 2000, 60.0)
    t = elephants.merge(bg, el)
    r = elephant_mice(seed=4)
    for k in laws.PACKET_FIELDS + ("flow_label",):
        assert np.array_equal(t[k], getattr(r, k)), k


def test_records_mix_parameters():
    mix = _mix("records.b2048")
    x, y = laws.find(mix).rows(laws.streams(11, 1)[0], mix,
                               mix["pool_batches"] * mix["batch"])
    assert x.shape == (64 * 2048, 10) and mix["pool_batches"] >= 64
    assert abs(y.mean() - 0.13) < 0.01


@pytest.mark.parametrize("name", ["packets.k16", "elephants.k16"])
def test_packet_mixes_are_seeded_and_fill_the_pool(name):
    mix = _mix(name)
    a = laws.find(mix).packets(laws.streams(123, laws.STREAMS), mix)
    b = laws.find(mix).packets(laws.streams(123, laws.STREAMS), mix)
    for k in laws.PACKET_FIELDS:
        assert np.array_equal(a[k], b[k])
    assert np.all(np.diff(a["ts"]) >= 0)
    assert len(a["ts"]) >= mix["pool_chunks"] * 16 * 1024


def test_packet_mix_parameters():
    mix = _mix("packets.k16")
    t = laws.find(mix).packets(laws.streams(77, laws.STREAMS), mix)
    assert len(t["flow_label"]) == 4000 * mix["duration_s"] // 60
    assert abs(t["flow_label"].mean() - 0.13) < 0.02
    per_flow = np.bincount(t["flow_id"])
    assert 9 < per_flow.mean() < 12                 # Poisson 12 and 6, >= 2


def test_elephant_mix_parameters():
    mix = _mix("elephants.k16")
    t = laws.find(mix).packets(laws.streams(78, laws.STREAMS), mix)
    n_mice = 1000 * mix["duration_s"] // 60
    elephant = t["flow_id"] >= n_mice
    assert len(t["flow_label"]) == n_mice + 8
    assert int(elephant.sum()) == 8 * 2000 * mix["duration_s"] // 60
    assert 0.55 < elephant.mean() < 0.63             # about 59% of packets
    assert np.all(t["flow_label"][n_mice:] == 1)


def test_flow_hash_matches_the_programs():
    from repro_torch.netsim.features import fnv1a_hash_np
    t = packets.synth(np.random.default_rng(2), 300)
    b = flows.fnv1a_buckets(t, 8192)
    r = fnv1a_hash_np(t["src_ip"], t["dst_ip"], t["sport"], t["dport"],
                      t["proto"], n_buckets=8192)
    assert np.array_equal(b, r)


def test_flow_rows_match_the_programs_batch_table():
    import torch
    from repro_torch.netsim.features import flow_features
    from repro_torch.netsim.packets import PacketTrace
    t = packets.synth(np.random.default_rng(3), 400)
    n = len(t["ts"])
    cols = flows.columns(t, 1024, n)
    x, y = flows.flow_rows(cols, t["flow_id"], t["flow_label"], 1024)
    b, table = flow_features(PacketTrace(**t), n_buckets=1024, device="cpu")
    first = np.unique(t["flow_id"], return_index=True)[1]
    ref = table[b[torch.as_tensor(first)].long()].numpy()
    assert np.array_equal(x, ref)
    assert np.array_equal(y, t["flow_label"])
