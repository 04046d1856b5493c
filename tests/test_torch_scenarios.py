"""Port parity for the adversarial scenarios (``repro_torch.netsim.
scenarios``) and approx-LRU eviction under attack: every case of the
reference's ``tests/test_scenarios.py``, each generator's trace equal to the
reference's array for array, the approx-LRU sweep against the reference on
the same tables, and the streaming server over the scenarios against the
reference's server. Everything runs on the CPU.

Tolerances: traces, register files, predictions and every integer counter
compare bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.netsim import scenarios as jscen  # noqa: E402
from repro.netsim import stream as jstream  # noqa: E402
from repro.netsim.features import fnv1a_hash as jhash  # noqa: E402
from repro.serving import stream_serving as jserving  # noqa: E402
from repro_torch import netsim  # noqa: E402
from repro_torch.netsim import stream as tstream  # noqa: E402
from repro_torch.netsim.packets import PacketTrace, synth_trace  # noqa: E402
from repro_torch.netsim.scenarios import (SCENARIOS,  # noqa: E402
                                          collision_storm, ddos_flood,
                                          elephant_mice, make_scenario,
                                          merge_traces, slow_loris)
from repro_torch.serving.stream_serving import \
    StreamingHybridServer  # noqa: E402
from test_torch_parity import (assert_bit_equal, port_artifact,  # noqa: E402
                               port_ensemble, port_flow_table, port_window)

N_BUCKETS = 1 << 10


def _bucket_of(tr, n_buckets=N_BUCKETS):
    return netsim.fnv1a_hash(tr.src_ip, tr.dst_ip, tr.sport, tr.dport,
                             tr.proto, n_buckets=n_buckets,
                             device="cpu").numpy()


def _same_trace(ref, got):
    for f in dataclasses.fields(PacketTrace):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        assert isinstance(b, np.ndarray), f.name
        assert np.asarray(a).dtype == b.dtype, f.name
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=f.name)


# -- generators: the reference's traces, well formed and seeded ----------------------

@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_well_formed_and_deterministic(name):
    kw = dict(seed=5)
    if name == "collision_storm":
        kw["n_buckets"] = N_BUCKETS
    a = make_scenario(name, **kw)
    assert isinstance(a, PacketTrace)
    assert (np.diff(a.ts) >= 0).all()                  # time-sorted
    assert a.flow_id.min() >= 0 and a.flow_id.max() < a.n_flows
    assert set(np.unique(a.flow_label)) <= {0, 1}
    assert a.flow_label.sum() > 0                      # attack flows exist
    _same_trace(make_scenario(name, **kw), a)
    _same_trace(jscen.make_scenario(name, **kw), a)
    c = make_scenario(name, **{**kw, "seed": 6})
    assert not np.array_equal(c.ts, a.ts)              # seeds matter


@pytest.mark.parametrize("name,kw", [
    ("ddos_flood", dict(n_background=400, n_attack=3000)),
    ("collision_storm", dict(n_background=400, n_attack=2000,
                             n_buckets=4096, n_target_buckets=4)),
    ("slow_loris", dict(n_background=400, n_slow=64, n_probes=6,
                        idle_gap=20.0)),
    ("elephant_mice", dict(n_mice=1000, n_elephants=8,
                           elephant_pkts=2000)),
])
def test_scenario_bench_traces_equal_reference(name, kw):
    """The reference scenario bench's configurations at scale 1.0 give the
    reference's traces array for array."""
    _same_trace(jscen.make_scenario(name, seed=0, **kw),
                make_scenario(name, seed=0, **kw))


def test_make_scenario_unknown_name():
    with pytest.raises(ValueError, match="unknown scenario"):
        make_scenario("teardrop")


def test_scenarios_exported_from_netsim():
    assert netsim.make_scenario is make_scenario
    assert netsim.SCENARIOS == SCENARIOS == jscen.SCENARIOS


def test_merge_traces_preserves_labels_and_order():
    a = synth_trace(n_flows=50, seed=0)
    b = synth_trace(n_flows=30, seed=1)
    la = a.flow_label[a.flow_id]
    lb = b.flow_label[b.flow_id]
    m = merge_traces(a, b)
    assert m.n_flows == 80 and m.n_packets == a.n_packets + b.n_packets
    assert (np.diff(m.ts) >= 0).all()
    lm = m.flow_label[m.flow_id]
    order = np.argsort(np.concatenate([a.ts, b.ts]), kind="stable")
    np.testing.assert_array_equal(lm, np.concatenate([la, lb])[order])
    _same_trace(jscen.merge_traces(a, b), m)


def test_ddos_flood_single_use_flows():
    t = ddos_flood(n_background=50, n_attack=500, seed=2)
    atk = t.flow_id >= 50
    ids, counts = np.unique(t.flow_id[atk], return_counts=True)
    assert len(ids) == 500 and (counts == 1).all()
    assert len(np.unique(t.dst_ip[atk])) == 1


def test_collision_storm_lands_in_target_buckets():
    """The attack flows land in exactly the targeted buckets of the hash
    the serving tiers use (the port's on the CPU and the reference's)."""
    t = collision_storm(n_background=50, n_attack=400, n_buckets=N_BUCKETS,
                        n_target_buckets=4, seed=3)
    atk = t.flow_id >= 50
    hit = np.unique(_bucket_of(t)[atk])
    assert len(hit) == 4
    ref = np.asarray(jhash(t.src_ip, t.dst_ip, t.sport, t.dport, t.proto,
                           n_buckets=N_BUCKETS))
    np.testing.assert_array_equal(ref, _bucket_of(t))


def test_slow_loris_idle_gaps():
    t = slow_loris(n_background=50, n_slow=8, n_probes=5, idle_gap=30.0,
                   seed=4)
    atk = t.flow_id >= 50
    fid, ts = t.flow_id[atk], t.ts[atk]
    for f in np.unique(fid):
        assert (np.diff(np.sort(ts[fid == f])) > 25.0).all()


def test_elephant_mice_skew():
    t = elephant_mice(n_mice=100, n_elephants=4, elephant_pkts=500, seed=5)
    atk = t.flow_id >= 100
    _, counts = np.unique(t.flow_id[atk], return_counts=True)
    assert (counts == 500).all() and len(counts) == 4


# -- the approx-LRU sweep against the reference ---------------------------------------

def _tables_with(n, occupied_rows, *, t_max, pkt_count=1.0):
    """The reference's and the port's table with the given rows occupied
    (t_min=0, the given t_max and count)."""
    s = jstream.init_flow_table(n)
    idx = np.asarray(occupied_rows)
    upd = lambda a, v: a.at[idx].set(np.broadcast_to(v, idx.shape).astype(
        np.float32))
    js = dataclasses.replace(
        s, pkt_count=upd(s.pkt_count, pkt_count),
        byte_count=upd(s.byte_count, 100.0),
        t_min=upd(s.t_min, 0.0), t_max=upd(s.t_max, t_max))
    return js, port_flow_table(js)


def _windows_at(ts, bucket=0, n=8):
    jw = jstream.PacketWindow(
        bucket=jnp.full(n, bucket, jnp.int32),
        ts=jnp.full(n, ts, jnp.float32),
        length=jnp.full(n, 100.0, jnp.float32),
        is_fwd=jnp.ones(n, jnp.float32), valid=jnp.ones(n, bool))
    return jw, port_window(jw)


def _sweep_both(js, ts, jw, tw, evict_age, occupancy):
    js2, jn = jstream.approx_lru_sweep(js, jw, evict_age,
                                       occupancy=occupancy)
    out = []
    for use_kernel in (None, False):
        ts2, tn = tstream.approx_lru_sweep(ts.clone(), tw, evict_age,
                                           occupancy=occupancy,
                                           use_kernel=use_kernel)
        assert int(tn) == int(jn)
        assert_bit_equal(port_flow_table(js2).regs, ts2.regs)
        out.append((ts2, tn))
    return out[0]


def test_approx_lru_no_pressure_is_noop():
    js, ts = _tables_with(32, [1, 2, 3, 4], t_max=[0.0, 1.0, 2.0, 3.0])
    jw, tw = _windows_at(100.0, bucket=1)
    s2, n_ev = _sweep_both(js, ts, jw, tw, 5.0, 0.75)
    assert int(n_ev) == 0
    assert_bit_equal(ts.pkt_count, s2.pkt_count)


def test_approx_lru_pressure_evicts_idle_low_activity_first():
    n = 8
    js, _ = _tables_with(n, [1, 2, 3], t_max=0.0)
    js = dataclasses.replace(
        js, pkt_count=js.pkt_count.at[np.r_[4:8]].set(
            jnp.asarray([1., 1., 500., 500.])),
        byte_count=js.byte_count.at[np.r_[4:8]].set(100.0),
        t_min=js.t_min.at[np.r_[4:8]].set(0.0),
        t_max=js.t_max.at[np.r_[4:8]].set(
            jnp.asarray([99.9, 99.9, 0., 99.9])))
    jw, tw = _windows_at(100.0, bucket=0)
    s2, n_ev = _sweep_both(js, port_flow_table(js), jw, tw, 10.0, 0.5)
    evicted = s2.pkt_count.numpy() == 0
    assert evicted[[1, 2, 3]].all()
    assert not evicted[7]
    assert int(n_ev) == int(evicted[1:].sum())


def test_approx_lru_never_evicts_current_window():
    n = 8
    js, _ = _tables_with(n, list(range(7)), t_max=0.0)
    jw, tw = _windows_at(100.0, bucket=3)
    js = jstream.update_flow_table(js, jw)
    ts = tstream.update_flow_table(port_flow_table(
        _tables_with(n, list(range(7)), t_max=0.0)[0]), tw)
    assert_bit_equal(port_flow_table(js).regs, ts.regs)
    s2, n_ev = _sweep_both(js, ts, jw, tw, 5.0, 0.5)
    assert int(n_ev) > 0
    assert float(s2.pkt_count[3]) > 0                 # seen now: survives


def test_lifecycle_sweep_rejects_unknown_policy():
    s = tstream.init_flow_table(8, device="cpu")
    _, w = _windows_at(0.0)
    with pytest.raises(ValueError, match="evict_policy"):
        tstream.lifecycle_sweep(s, w, 5.0, True, evict_policy="mru")
    assert "approx_lru" in tstream.EVICT_POLICIES


# -- the streaming server under the scenarios -------------------------------------------

def _models(trace):
    """The reference test's recipe: a 4x3 RF trained on the trace's batch
    flow features serves as the switch and (row-wise) as the backend, in
    both packages."""
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_random_forest, predict_tree_ensemble
    from repro.netsim.features import flow_features
    from repro_torch.ml.trees import predict_tree_ensemble as t_predict
    b, table = flow_features(trace, n_buckets=N_BUCKETS)
    first = np.unique(np.asarray(trace.flow_id), return_index=True)[1]
    rows = np.asarray(table)[np.asarray(b)[first]].astype(np.float32)
    small = fit_random_forest(rows, trace.flow_label, n_classes=2,
                              n_trees=4, max_depth=3, seed=0)
    art = map_tree_ensemble(small, rows.shape[1])
    tsmall = port_ensemble(small)
    return (art, lambda r: predict_tree_ensemble(small, r),
            port_artifact(art), lambda r: t_predict(tsmall, r))


def _serve(trace, *, evict_policy, evict_age=5.0, reference=True, **kw):
    """The port's server over ``trace`` (and the reference's, when asked:
    predictions and counters must agree). -> (preds, stats)."""
    art, jbackend, tart, tbackend = _models(trace)
    kw = dict(n_buckets=N_BUCKETS, window=256, threshold=0.9, capacity=32,
              evict_age=evict_age, evict_policy=evict_policy, **kw)
    preds, stats = StreamingHybridServer(tart, tbackend, device="cpu",
                                         **kw).serve_trace(trace)
    if reference:
        jp, js = jserving.StreamingHybridServer(art, jbackend,
                                                **kw).serve_trace(trace)
        assert_bit_equal(jp, preds)
        for k in ("windows", "packets", "handled", "backend_rows",
                  "deferred", "degraded", "flushes", "evicted", "overflow"):
            assert js.as_dict()[k] == stats.as_dict()[k], k
    return preds.numpy(), stats


def test_slow_loris_timeout_churns_lru_spares():
    """A timeout sweep evicts the idle-but-live slow flows between probes;
    the pressure trigger never fires on this small population, so approx-LRU
    keeps every flow accumulating."""
    t = slow_loris(n_background=60, n_slow=16, n_probes=4, idle_gap=20.0,
                   seed=7)
    _, st_timeout = _serve(t, evict_policy="timeout")
    _, st_lru = _serve(t, evict_policy="approx_lru", lru_occupancy=0.75)
    assert st_timeout.n_evicted > 0
    assert st_lru.n_evicted == 0


def test_ddos_flood_lru_evicts_under_pressure():
    t = ddos_flood(n_background=60, n_attack=2500, seed=8)
    _, st = _serve(t, evict_policy="approx_lru", lru_occupancy=0.5)
    assert st.n_evicted > 0
    st.check()


def test_chunked_approx_lru_bit_matches_per_window():
    t = ddos_flood(n_background=60, n_attack=1500, seed=9)
    p_ref, st_ref = _serve(t, evict_policy="approx_lru", lru_occupancy=0.5,
                           reference=False)
    p_chunk, st_chunk = _serve(t, evict_policy="approx_lru",
                               lru_occupancy=0.5, chunk_windows=4)
    np.testing.assert_array_equal(p_chunk, p_ref)
    assert st_chunk.n_evicted == st_ref.n_evicted


@pytest.mark.parametrize("kw", [dict(evict_policy="approx_lru",
                                     evict_age=None),
                                dict(evict_policy="bogus")])
def test_evict_policy_validation(kw):
    with pytest.raises(ValueError):
        _serve(synth_trace(n_flows=20, seed=0), reference=False, **kw)
