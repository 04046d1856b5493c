"""Port parity for the sharded flow-table tier (``repro_torch.distributed``,
``repro_torch.netsim.shard_stream``, ``repro_torch.serving.shard_serving``),
the counterpart of the reference's ``tests/test_shard_stream.py`` and of
its sharded cases in ``test_ingest.py``, ``test_obs.py`` and
``test_faults.py``. Everything runs on the CPU over gloo.

* D = 1, in this process: a one-rank group (``flow_shard_mesh`` starts it)
  against the reference's ``ShardedStreamingServer(n_shards=1)``, per
  window, chunked and unpartitioned, with and without eviction, through
  ``serve_stream``, with ``obs`` and under a fault policy. Sharded deferral
  is held to the reference's single-device server at the same
  ``flush_every``: the reference's own sharded deferral raises at one shard
  under this jax (ROADMAP C2).
* D = 2, D = 4 and the (2, 2) mesh: one spawn of gloo processes per shape
  (a FileStore under the test's temporary directory, every process joined
  with a timeout; the three shapes run together). Every rank runs all of
  its shape's checks and sends its
  arrays back; each is held to the port's single-device server, which the
  reference holds to its own, and the ranks to each other.
* approx-LRU at D = 2, the one sharded path whose answers differ from one
  device's (each shard sweeps its own block): against the reference's
  sharded server on two host devices, in a subprocess.

The ranks import this module, so it imports no jax at its top: the
reference's modules are imported inside the fixtures and tests.

Tolerances: predictions, flow tables, epochs and every integer counter bit
for bit; ``conf_sum`` at rtol 1e-5 against the reference (the packages sum
in another order) and bit for bit within the port.
"""

import dataclasses
import datetime
import json
import multiprocessing
import os
import queue
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed.sharding import (as_flow_mesh,  # noqa: E402
                                              flow_shard_mesh)
from repro_torch.kernels.tuning import TileConfig, shard_tiles  # noqa: E402
from repro_torch.ml.trees import predict_tree_ensemble  # noqa: E402
from repro_torch.netsim.features import flow_features  # noqa: E402
from repro_torch.netsim.ingest import replay_source  # noqa: E402
from repro_torch.netsim.packets import PacketTrace  # noqa: E402
from repro_torch.netsim.scenarios import collision_storm  # noqa: E402
from repro_torch.netsim.shard_stream import (  # noqa: E402
    init_sharded_table, stream_sharded_flow_features)
from repro_torch.netsim.stream import iter_chunks, iter_windows  # noqa: E402
from repro_torch.serving.faults import FaultPolicy, FaultyBackend  # noqa: E402
from repro_torch.serving.shard_serving import \
    ShardedStreamingServer  # noqa: E402
from repro_torch.serving.stream_serving import \
    StreamingHybridServer  # noqa: E402
from test_torch_parity import (assert_bit_equal, port_artifact,  # noqa: E402
                               port_ensemble, to_np)

N_BUCKETS = 1 << 11
KW = dict(n_buckets=N_BUCKETS, window=256, threshold=0.9, capacity=32)
FAST = dict(max_retries=1, backoff_base_s=0.0, breaker_threshold=3,
            breaker_cooldown=2)
FAULTS = dict(error_rate=0.4, seed=9, outages=range(0, 4))
LRU = dict(evict_age=0.5, evict_policy="approx_lru", lru_occupancy=0.05)
MESH_SHAPES = [(2, 1), (4, 1), (2, 2)]
RANK_TIMEOUT_S = 240


def _fit(n_buckets=N_BUCKETS):
    """The reference's sharded fixture (300 flows, 2048 buckets): a 4x3 RF
    switch and a 12x5 RF backend on the batch flow features."""
    from repro.core.mapping import map_tree_ensemble
    from repro.ml.trees import fit_random_forest
    from repro.netsim.features import flow_features as jflow_features
    from repro.netsim.packets import synth_trace
    trace = synth_trace(n_flows=300, seed=3)
    b, table = jflow_features(trace, n_buckets=n_buckets)
    first_idx = np.unique(np.asarray(trace.flow_id), return_index=True)[1]
    rows = np.asarray(table)[np.asarray(b)[first_idx]].astype(np.float32)
    small = fit_random_forest(rows, trace.flow_label, n_classes=2,
                              n_trees=4, max_depth=3, seed=0)
    big = fit_random_forest(rows, trace.flow_label, n_classes=2,
                            n_trees=12, max_depth=5, seed=1)
    return trace, map_tree_ensemble(small, rows.shape[1]), big


def _port_trace(tr) -> PacketTrace:
    return PacketTrace(**{f.name: np.asarray(getattr(tr, f.name))
                          for f in dataclasses.fields(tr)})


def _reorder_head(trace, n, seed=0):
    """Permute the first n packets (a reordered opening)."""
    perm = np.arange(trace.n_packets)
    perm[:n] = np.random.default_rng(seed).permutation(n)
    return dataclasses.replace(trace, **{
        f.name: getattr(trace, f.name)[perm]
        for f in dataclasses.fields(trace) if f.name != "flow_label"})


def _storm():
    """The reference's uneven-ownership stress: a collision storm on two
    target buckets of the serving table's own hash."""
    return collision_storm(n_background=150, n_attack=800,
                           n_buckets=N_BUCKETS, n_target_buckets=2,
                           pkts_per_attack=2, seed=0)


@pytest.fixture(scope="module")
def setup():
    trace, art, big = _fit()
    from repro.ml.trees import predict_tree_ensemble as jpredict
    tbig = port_ensemble(big)
    return dict(jtrace=trace, trace=_port_trace(trace), art=art, big=big,
                jbackend=lambda r: jpredict(big, r), tart=port_artifact(art),
                tbig=tbig, tbackend=lambda r: predict_tree_ensemble(tbig, r))


@pytest.fixture(scope="module")
def one_rank():
    """D = 1: the mesh with no group yet starts a one-rank gloo group."""
    if dist.is_initialized():
        pytest.fail("a default process group is already running")
    mesh = flow_shard_mesh(device="cpu")
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    yield mesh
    dist.destroy_process_group()


def _served(srv, trace, *, stream_batch=None, **call):
    """(preds, StreamStats dict, flow table, epoch) as numpy / Python."""
    if stream_batch is None:
        pred, stats = srv.serve_trace(trace, **call)
    else:
        pred, stats = srv.serve_stream(replay_source(trace,
                                                     batch=stream_batch))
    epoch = getattr(srv, "epoch", None)
    return to_np(pred), stats.as_dict(), to_np(srv.flow_table()), epoch


def _same(got, ref, *, conf_exact=True, flushes=True, table=True):
    (gp, gs, gt, _), (rp, rs, rt, _) = got, ref
    assert_bit_equal(rp, gp)
    if table:
        assert_bit_equal(rt, gt)
    for k in ("windows", "packets", "handled", "backend_rows", "deferred",
              "degraded", "evicted", "overflow") + (("flushes",) if flushes
                                                    else ()):
        assert gs[k] == rs[k], (k, gs[k], rs[k])
    if conf_exact:
        assert gs["conf_sum"] == rs["conf_sum"]
    else:
        np.testing.assert_allclose(gs["conf_sum"], rs["conf_sum"],
                                   rtol=1e-5)


# -- D = 1 against the reference ---------------------------------------------

_JAX_RUNS: dict = {}


def _jax_run(setup, key, *, sharded=True, backend=None, obs=None,
             trace=None, **kw):
    """The reference server's run, memoized by ``key`` for the module."""
    if key not in _JAX_RUNS:
        from repro.serving.shard_serving import \
            ShardedStreamingServer as JSharded
        from repro.serving.stream_serving import \
            StreamingHybridServer as JSingle
        extra = dict(n_shards=1) if sharded else {}
        srv = (JSharded if sharded else JSingle)(
            setup["art"], backend or setup["jbackend"], obs=obs,
            **dict(KW, **kw), **extra)
        got = _served(srv, setup["jtrace"] if trace is None else trace)
        _JAX_RUNS[key] = (got, srv)
    return _JAX_RUNS[key]


D1_CASES = {"window": {}, "window_evict": dict(evict_age=0.5),
            "chunk": dict(chunk_windows=4),
            "chunk_evict": dict(chunk_windows=4, evict_age=0.5),
            "unpartitioned": dict(partition_classify=False)}


@pytest.mark.parametrize("case", list(D1_CASES))
def test_d1_equals_reference_sharded_server(setup, one_rank, case):
    """The contract at one shard: predictions, StreamStats, flow_table()
    and the epoch of the reference's ``ShardedStreamingServer(n_shards=1)``
    (which took its fused route), bit for bit."""
    kw = D1_CASES[case]
    jkw = {k: v for k, v in kw.items() if k != "partition_classify"}
    ref, jsrv = _jax_run(setup, case, partition_classify=kw.get(
        "partition_classify", True), **jkw)
    assert jsrv._fused_ok is True
    srv = ShardedStreamingServer(setup["tart"], setup["tbackend"],
                                 mesh=one_rank, device="cpu", **KW, **kw)
    got = _served(srv, setup["trace"])
    _same(got, ref, conf_exact=False)
    assert got[3] == ref[3] == 0.0                    # in-order stream
    assert (got[1]["evicted"] > 0) == ("evict" in case)


def test_d1_serve_stream_obs_and_faults(setup, one_rank):
    """serve_stream over a replay of 131-packet batches equals the
    reference's chunked serve_trace; obs on equals the reference with obs
    on (events by kind, rollup rows); a fault policy with no fault equals
    the unguarded reference, and seeded faults degrade the reference's
    windows, with its guard's telemetry."""
    from repro.obs import Observability as JObs
    from repro.serving import faults as jfaults
    from repro_torch.obs import Observability
    art, be = setup["tart"], setup["tbackend"]
    trace = setup["trace"]
    ref_chunk, _ = _jax_run(setup, "chunk", chunk_windows=4)
    srv = ShardedStreamingServer(art, be, mesh=one_rank, device="cpu",
                                 chunk_windows=4, **KW)
    _same(_served(srv, trace, stream_batch=131), ref_chunk,
          conf_exact=False)

    jobs = JObs(rollup_every=2)
    ref_obs, _ = _jax_run(setup, "window_obs", obs=jobs)
    obs = Observability(rollup_every=2)
    srv = ShardedStreamingServer(art, be, mesh=one_rank, device="cpu",
                                 obs=obs, **KW)
    _same(_served(srv, trace), ref_obs, conf_exact=False)
    assert obs.events.counts() == jobs.events.counts()
    assert obs.rollups.n_rows == jobs.rollups.n_rows > 0

    ref, _ = _jax_run(setup, "window")
    srv = ShardedStreamingServer(art, be, mesh=one_rank, device="cpu",
                                 fault_policy=FaultPolicy(**FAST), **KW)
    got = _served(srv, trace)
    _same(got, ref, conf_exact=False)
    assert got[1]["degraded"] == 0
    ref_f, jsrv = _jax_run(
        setup, "faults", backend=jfaults.FaultyBackend(setup["jbackend"],
                                                       **FAULTS),
        fault_policy=jfaults.FaultPolicy(**FAST))
    srv = ShardedStreamingServer(art, FaultyBackend(be, **FAULTS),
                                 mesh=one_rank, device="cpu",
                                 fault_policy=FaultPolicy(**FAST), **KW)
    got = _served(srv, trace)
    _same(got, ref_f, conf_exact=False)
    assert got[1]["degraded"] > 0
    assert (dataclasses.asdict(srv.fault_stats)
            == dataclasses.asdict(jsrv.fault_stats))


@pytest.mark.parametrize("flush_every", [2, 4])
def test_d1_deferral_equals_reference_single_device(setup, one_rank,
                                                    flush_every):
    """Sharded deferral, on the mesh route (a flush reduce-scatters the
    partial rows) and on the two-phase route (one host call over the summed
    rows), against the reference's single-device server at the same
    flush_every: ceil(windows / k) flushes, final predictions equal."""
    ref, _ = _jax_run(setup, f"defer{flush_every}", sharded=False,
                      flush_every=flush_every)
    for fuse in (None, False):
        srv = ShardedStreamingServer(setup["tart"], setup["tbackend"],
                                     mesh=one_rank, device="cpu", fuse=fuse,
                                     flush_every=flush_every, **KW)
        got = _served(srv, setup["trace"])
        _same(got, ref, conf_exact=False)
        assert got[1]["flushes"] == -(-got[1]["windows"] // flush_every)


def test_d1_census_per_step_kind(setup, one_rank):
    """The collectives of each step kind, counted where they are issued:
    a window step, its switch half and a chunk's switch half each send 3
    psums, 1 reduce-scatter and 2 all-gathers (the reference's
    AUDIT_CONTRACTS); the chunk step's mesh-wide backend all-gathers its
    answers once more; a deferred step skips the buffer psum, and its
    flush reduce-scatters and all-gathers once; the two-phase route
    broadcasts rank 0's outcome (a header, then the answers); the
    unpartitioned baseline psums pred and conf instead."""
    art, be = setup["tart"], setup["tbackend"]
    trace = setup["trace"]
    w = next(iter_windows(trace, 256, N_BUCKETS, device="cpu"))
    chunk = next(iter_chunks(trace, 256, 4, N_BUCKETS, device="cpu"))

    def census(fn):
        collectives.reset_counts()
        fn()
        return collectives.counts()

    def c(psum, rs, ag, bc=0):
        return {"psum": psum, "reduce_scatter": rs, "all_gather": ag,
                "broadcast": bc}

    mk = lambda **kw: ShardedStreamingServer(art, be, mesh=one_rank,
                                             device="cpu", **KW, **kw)
    srv = mk()
    assert census(lambda: srv.step(w)) == c(3, 1, 2)
    assert census(lambda: srv._window_switch(srv._carries(), w,
                                             0.9)) == c(3, 1, 2)
    csrv = mk(chunk_windows=4)
    assert census(lambda: csrv._chunk_switch(csrv._carries(), chunk,
                                             0.9)) == c(3, 1, 2)
    assert census(lambda: csrv.step_chunk(chunk)) == c(3, 1, 3)
    dsrv = mk(flush_every=2)
    assert census(lambda: dsrv.step(w)) == c(2, 1, 2)
    assert census(lambda: dsrv.flush()) == c(0, 1, 1)
    assert census(lambda: mk(fuse=False).step(w)) == c(3, 1, 2, 2)
    assert census(lambda: mk(partition_classify=False).step(w)) \
        == c(5, 0, 0)


def test_d1_mesh_table_epoch_and_layout(setup, one_rank):
    """The sharded register carry and the mesh at one device: the oracle
    table equals the reference's and the batch table (ragged windows), a
    reordered opening under the provisional t0 too; the server's epoch
    min-merges to the reference's; a 1D mesh normalizes; per-device
    classify rows; ``shard_tiles``; and no device means the card."""
    from repro.netsim.features import flow_features as jflow_features
    from repro.netsim.packets import synth_trace
    from repro.netsim.shard_stream import \
        stream_sharded_flow_features as jstream
    tr = synth_trace(n_flows=250, seed=5)
    _, jt = jstream(tr, n_buckets=N_BUCKETS, window=257, n_shards=1)
    _, tt = stream_sharded_flow_features(_port_trace(tr),
                                         n_buckets=N_BUCKETS, window=257,
                                         mesh=one_rank)
    assert_bit_equal(jt, tt)
    assert_bit_equal(jflow_features(tr, n_buckets=N_BUCKETS)[1], tt)
    tr = synth_trace(n_flows=200, seed=13)
    tr.ts = np.round(tr.ts * 1024.0) / 1024.0     # f32-exact grid
    tr = _reorder_head(tr, min(300, tr.n_packets), seed=1)
    _, tt = stream_sharded_flow_features(_port_trace(tr), n_buckets=1024,
                                         window=128, mesh=one_rank,
                                         t0=float(tr.ts[0]))
    assert_bit_equal(jflow_features(tr, n_buckets=1024)[1], tt)

    jtr = _reorder_head(setup["jtrace"], 300, seed=2)
    t0 = float(jtr.ts[0])
    ref, jsrv = _jax_run(setup, "reordered", trace=jtr)
    srv = ShardedStreamingServer(setup["tart"], setup["tbackend"],
                                 mesh=one_rank, device="cpu", **KW)
    srv.serve_trace(_port_trace(jtr), t0=t0)
    want = float(np.float32(np.float64(jtr.ts.min()) - t0))
    assert srv.epoch == want < 0.0
    jsrv.reset()
    jsrv.serve_trace(jtr, t0=t0)
    assert jsrv.epoch == srv.epoch

    from torch.distributed.device_mesh import DeviceMesh
    flat = as_flow_mesh(DeviceMesh("cpu", [0], mesh_dim_names=("shard",)))
    assert flat.mesh_dim_names == ("shard", "data")
    assert tuple(flat.mesh.shape) == (1, 1)
    with pytest.raises(ValueError):
        as_flow_mesh(DeviceMesh("cpu", [0], mesh_dim_names=("model",)))
    with pytest.raises(ValueError):                 # the group has one rank
        flow_shard_mesh(2, device="cpu")
    for k in (None, 4):
        srv = ShardedStreamingServer(setup["tart"], setup["tbackend"],
                                     mesh=flat, device="cpu",
                                     chunk_windows=k, **KW)
        assert srv.n_shards == srv.n_data == 1
        assert srv.classify_rows_per_device == (k or 1) * 256
    assert shard_tiles(TileConfig(), 1024) == TileConfig()
    assert shard_tiles(TileConfig(), 40).tile_n == 64
    assert shard_tiles(TileConfig(), 3).tile_n == 16
    assert shard_tiles(TileConfig(impl="loop"), 40) == TileConfig(impl="loop")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ShardedStreamingServer(setup["tart"], setup["tbackend"], **KW)


def test_sharded_example_at_one_rank(one_rank, capsys):
    """``repro_torch.examples.sharded_stream`` on the group already running
    (it leaves it running): equal to the single-device server."""
    from repro_torch.examples.sharded_stream import main
    res = main(["--device", "cpu", "--n-flows", "200", "--n-buckets",
                str(N_BUCKETS), "--window", "256", "--chunk-windows", "4",
                "--evict-age", "1.0"])
    assert res["equal"] and res["stats"].n_evicted > 0
    assert dist.is_initialized() and "equal_single_device=True" in \
        capsys.readouterr().out


def test_autotune_candidate_filter():
    """The chunk sweep's ``candidate_filter`` (which the sharded tier sets
    to the Ks whose chunk buffer divides over its mesh) drops candidates as
    the reference's does, hands the default's role to the first survivor,
    and raises when none is left."""
    from repro.serving.stream_serving import \
        autotune_chunk_windows as jtune
    from repro_torch.serving.stream_serving import \
        autotune_chunk_windows as ttune
    for cands, default, keep in (((4, 6, 8), 4, lambda k: k % 4 == 0),
                                 ((6, 12), 4, lambda k: k % 3 == 0),
                                 ((4, 8, 16, 32), 16, lambda k: k < 16)):
        seen = ([], [])
        got = [tune(lambda k: None, window=256, n_buckets=N_BUCKETS,
                    candidates=cands, default=default, candidate_filter=keep,
                    time_fn=lambda k, s=s: s.append(k) or 1.0 + 0.1 * (k % 5))
               for tune, s in ((ttune, seen[0]), (jtune, seen[1]))]
        assert got[0] == got[1] and keep(got[0])
        assert seen[0] == seen[1] and all(keep(k) for k in seen[0])
    for tune in (ttune, jtune):
        with pytest.raises(ValueError, match="candidate"):
            tune(lambda k: None, window=256, n_buckets=N_BUCKETS,
                 candidates=(6,), default=4, candidate_filter=lambda k: False,
                 time_fn=lambda k: 1.0)


# -- D = 2, D = 4 and (2, 2): gloo processes ---------------------------------

def _mesh_cases(shape):
    """name -> (server kwargs, how to serve). Served on the main trace
    unless named; every case is held to a single-device port run."""
    cases = {
        "window": ({}, {}), "window_evict": (dict(evict_age=0.5), {}),
        "chunk": (dict(chunk_windows=4), {}),
        "chunk_evict": (dict(chunk_windows=4, evict_age=0.5), {}),
        "chunk_two_phase": (dict(chunk_windows=4, fuse=False), {}),
        "defer2": (dict(flush_every=2), {}),
        "defer4": (dict(flush_every=4), {}),
        "defer2_two_phase": (dict(flush_every=2, fuse=False), {}),
        "unpartitioned": (dict(partition_classify=False), {}),
        "serve_stream": (dict(chunk_windows=4), dict(stream_batch=131)),
        "faults": (dict(fault_policy=FAST, faults=True), {}),
        "faults_chunk": (dict(fault_policy=FAST, faults=True,
                              chunk_windows=4), {}),
        "storm": (dict(capacity=4), dict(trace="storm")),
        "reordered": ({}, dict(trace="reordered")),
        "lru": (dict(LRU), {}),
    }
    if shape[1] == 1:
        cases["window_1d_mesh"] = (dict(mesh_1d=True), {})
    return cases


def _single_kw(kw):
    """The single-device server a mesh case is held to."""
    return {k: v for k, v in kw.items()
            if k not in ("partition_classify", "mesh_1d")}


def _server_args(kw, be):
    kw = dict(kw)
    if kw.pop("faults", False):
        be = FaultyBackend(be, **FAULTS)
    if "fault_policy" in kw:
        kw["fault_policy"] = FaultPolicy(**kw["fault_policy"])
    return kw, be


def _traces(payload):
    return {"main": payload["trace"], "storm": payload["storm"],
            "reordered": payload["reordered"]}


def _serve_case(make, payload, call):
    call = dict(call)
    tr = _traces(payload)[call.pop("trace", "main")]
    if tr is payload["reordered"]:
        call["t0"] = payload["t0"]
    return _served(make(), tr, **call)


def _rank_checks(shape, payload) -> dict:
    """Every check of one mesh shape on this rank -> its results."""
    from torch.distributed.device_mesh import DeviceMesh
    be = lambda r: predict_tree_ensemble(payload["big"], r)   # noqa: E731
    art = payload["art"]
    world = shape[0] * shape[1]
    mesh = flow_shard_mesh(*shape, device="cpu")
    out = {"runs": {}}
    for name, (kw, call) in _mesh_cases(shape).items():
        kw, backend = _server_args(kw, be)
        m = mesh
        if kw.pop("mesh_1d", False):
            m = DeviceMesh("cpu", list(range(world)),
                           mesh_dim_names=("shard",))
        srv_kw = dict(KW, **kw)

        def make():
            return ShardedStreamingServer(art, backend, mesh=m,
                                          device="cpu", **srv_kw)
        out["runs"][name] = _serve_case(make, payload, call)

    srv = ShardedStreamingServer(art, be, mesh=mesh, device="cpu", **KW)
    w = next(iter_windows(payload["trace"], 256, N_BUCKETS, device="cpu"))
    collectives.reset_counts()
    srv.step(w)
    out["census_window"] = collectives.counts()
    csrv = ShardedStreamingServer(art, be, mesh=mesh, device="cpu",
                                  chunk_windows=4, **KW)
    chunk = next(iter_chunks(payload["trace"], 256, 4, N_BUCKETS,
                             device="cpu"))
    collectives.reset_counts()
    csrv._chunk_switch(csrv._carries(), chunk, 0.9)
    out["census_chunk_switch"] = collectives.counts()
    out["rows"] = {(k, p): ShardedStreamingServer(
        art, be, mesh=mesh, device="cpu", chunk_windows=k, partition_classify=p,
        **KW).classify_rows_per_device
        for k in (None, 4) for p in (True, False)}
    out["mesh"] = (srv.n_shards, srv.n_data, srv.n_devices)
    # "auto" at capacity 3: every rank sweeps in step and takes rank 0's K
    out["auto_k"] = ShardedStreamingServer(
        art, be, mesh=mesh, device="cpu", chunk_windows="auto",
        **dict(KW, capacity=3)).chunk_windows
    errors = {}
    for label, fn in (
            ("table", lambda: init_sharded_table(N_BUCKETS + 1,
                                                 n_shards=shape[0],
                                                 device="cpu")),
            ("buckets", lambda: ShardedStreamingServer(
                art, be, mesh=mesh, device="cpu",
                **dict(KW, n_buckets=N_BUCKETS + 1))),
            ("defer_slots", lambda: ShardedStreamingServer(
                art, be, mesh=mesh, device="cpu",
                **dict(KW, capacity=3, flush_every=3))),
            ("chunk_slots", lambda: ShardedStreamingServer(
                art, be, mesh=mesh, device="cpu",
                **dict(KW, capacity=3, chunk_windows=3)))):
        try:
            fn()
            errors[label] = None
        except ValueError as e:
            errors[label] = str(e)
    out["errors"] = errors
    try:                # each rank's wall clock would cut its own stream
        srv.serve_stream(replay_source(payload["trace"]), deadline=0.01)
        out["wall_deadline"] = None
    except ValueError as e:
        out["wall_deadline"] = str(e)
    out["capacity3_per_window"] = ShardedStreamingServer(
        art, be, mesh=mesh, device="cpu",
        **dict(KW, capacity=3)).capacity
    _, out["oracle_table"] = (lambda r: (r[0], to_np(r[1])))(
        stream_sharded_flow_features(payload["trace"], n_buckets=N_BUCKETS,
                                     window=257, mesh=mesh))
    return out


def _rank_main(rank, world, store, shape, payload_path, results):
    """One spawned rank: the no-group error first, then the group, then
    every check on the pickled payload; (rank, results or None, traceback
    or None) to the parent."""
    import pickle
    torch.set_num_threads(1)
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        try:
            flow_shard_mesh(world, device="cpu")
            no_group = None
        except RuntimeError as e:
            no_group = str(e)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        out = _rank_checks(shape, payload)
        out["no_group_error"] = no_group
        results.put((rank, out, None))
    except BaseException:            # reported to the parent, which fails
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _start_mesh(shape, payload_path, tmp):
    """Start ``_rank_checks`` on shape[0]*shape[1] gloo processes.
    -> (procs, their result queue). The payload crosses in a file: a
    process's arguments go down a pipe that the child reads only after its
    imports, so a large payload would start the ranks one after another."""
    world = shape[0] * shape[1]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(tmp, f"store_{shape[0]}x{shape[1]}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, shape, payload_path,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, results


def _collect_mesh(shape, procs, results, deadline):
    """-> (the ranks' results in rank order, None), or (None, why) when a
    rank raised, died or outlived ``deadline``. Every process is joined,
    and killed if it will not end."""
    world = len(procs)
    got, why = {}, None
    try:
        while len(got) < world and why is None:
            try:
                rank, out, err = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead:
                    why = (f"ranks {dead} died (exit codes "
                           f"{[procs[i].exitcode for i in dead]})")
                elif time.monotonic() > deadline:
                    why = (f"ranks {sorted(set(range(world)) - set(got))} "
                           f"still running after {RANK_TIMEOUT_S} s")
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
    if why is not None:
        return None, f"mesh {shape}: {why}"
    return [got[r] for r in range(world)], None


@pytest.fixture(scope="module")
def mesh_payload(setup):
    tr = setup["trace"]
    jtr = _reorder_head(setup["jtrace"], 300, seed=2)
    return dict(trace=tr, storm=_storm(), reordered=_port_trace(jtr),
                t0=float(jtr.ts[0]), art=setup["tart"], big=setup["tbig"])


@pytest.fixture(scope="module")
def single_refs(setup, mesh_payload):
    """The port's single-device run of every mesh case (memoized)."""
    memo = {}

    def ref(kw, call):
        skw = _single_kw(kw)
        key = json.dumps([skw, call], sort_keys=True, default=str)
        if key not in memo:
            skw, backend = _server_args(skw, setup["tbackend"])
            memo[key] = _serve_case(
                lambda: StreamingHybridServer(setup["tart"], backend,
                                              device="cpu",
                                              **dict(KW, **skw)),
                mesh_payload, {k: v for k, v in call.items()
                               if k != "stream_batch"})
        return memo[key]
    return ref


_MESH_RUNS: dict = {}


@pytest.fixture(scope="module")
def mesh_run(mesh_payload, tmp_path_factory):
    """shape -> the ranks' results. The first call starts every shape's
    processes together (they overlap on the cores) and collects them all;
    a shape whose ranks failed fails only its own callers."""
    def run(shape):
        if not _MESH_RUNS:
            import pickle
            tmp = str(tmp_path_factory.mktemp("mesh"))
            payload_path = os.path.join(tmp, "payload.pkl")
            with open(payload_path, "wb") as f:   # read back by the ranks
                pickle.dump(mesh_payload, f)
            started = {sh: _start_mesh(sh, payload_path, tmp)
                       for sh in MESH_SHAPES}
            deadline = time.monotonic() + RANK_TIMEOUT_S
            for sh, (procs, results) in started.items():
                _MESH_RUNS[sh] = _collect_mesh(sh, procs, results, deadline)
        ranks, why = _MESH_RUNS[shape]
        if why is not None:
            pytest.fail(why)
        return ranks
    return run


def _jax_lru_main(fixture, path):
    """The reference's sharded server at two host devices under approx-LRU
    (run in a subprocess whose XLA_FLAGS ask for two) on the pickled
    ``fixture`` (trace, artifact, backend forest): its predictions and
    StreamStats into ``path``. Its flow_table() cannot be read there
    (ROADMAP C2)."""
    import pickle

    import jax
    from repro.ml.trees import predict_tree_ensemble as jpredict
    from repro.serving.shard_serving import \
        ShardedStreamingServer as JSharded
    assert jax.device_count() == 2, jax.devices()
    with open(fixture, "rb") as f:
        trace, art, big = pickle.load(f)
    srv = JSharded(art, lambda r: jpredict(big, r), n_shards=2, **KW, **LRU)
    pred, stats = srv.serve_trace(trace)
    np.savez(path, pred=np.asarray(pred),
             stats=np.asarray(json.dumps(stats.as_dict())))


def test_approx_lru_d2_equals_reference(setup, mesh_run, tmp_path):
    """approx-LRU sweeps each shard's own block, so at D = 2 the sharded
    tier answers differently from one device; it must answer as the
    reference's sharded tier at D = 2 does: predictions and StreamStats.
    The reference runs in a subprocess at two host devices (XLA_FLAGS in
    its environment), while this process spawns the port's two ranks."""
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    import pickle
    fixture, out = str(tmp_path / "fixture.pkl"), str(tmp_path / "lru.npz")
    with open(fixture, "wb") as f:       # read back by the subprocess below
        pickle.dump((setup["jtrace"], setup["art"], setup["big"]), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    proc = subprocess.Popen(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {here!r}); "
         f"import test_torch_shard as t; "
         f"t._jax_lru_main({fixture!r}, {out!r})"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        lead = mesh_run((2, 1))[0]["runs"]["lru"]
        _, err = proc.communicate(timeout=RANK_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    ref = np.load(out)
    rs = json.loads(str(ref["stats"]))
    assert_bit_equal(ref["pred"], lead[0])
    _same(lead, (ref["pred"], rs, None, None), conf_exact=False,
          table=False)
    assert rs["evicted"] > 0
    single = StreamingHybridServer(setup["tart"], setup["tbackend"],
                                   device="cpu", **KW, **LRU)
    _, s1 = single.serve_trace(setup["trace"])
    assert s1.as_dict()["evicted"] != rs["evicted"]   # not one device's


@pytest.mark.parametrize("shape", MESH_SHAPES,
                         ids=[f"{s}x{d}" for s, d in MESH_SHAPES])
def test_mesh_equals_single_device(mesh_run, single_refs, mesh_payload,
                                   shape):
    """Every case of the shape on every rank: equal to the port's
    single-device server bit for bit (predictions, StreamStats with
    flushes, flow_table(), the epoch), and the ranks to each other;
    approx-LRU differs from one device (each shard sweeps its own block)
    but the ranks agree and the accounting closes. Then the collision
    storm's uneven ownership, the census, the per-device classify rows,
    the indivisibility errors, the 1D mesh and the no-group error."""
    ranks = mesh_run(shape)
    n_sh, n_dt = shape
    world = n_sh * n_dt
    lead = ranks[0]
    for name, (kw, call) in _mesh_cases(shape).items():
        got = lead["runs"][name]
        for other in ranks[1:]:
            _same(other["runs"][name], got)
            assert other["runs"][name][3] == got[3]
        if name == "lru":
            s = got[1]
            assert s["handled"] + s["backend_rows"] + s["deferred"] \
                + s["degraded"] == s["packets"]
            assert s["evicted"] > 0
            continue
        _same(got, single_refs(kw, call))
        if name != "reordered":
            assert got[3] == 0.0, name
        if name.startswith("defer"):
            k = kw["flush_every"]
            assert got[1]["flushes"] == -(-got[1]["windows"] // k)
        if name.startswith("faults"):
            assert got[1]["degraded"] > 0
    assert lead["runs"]["reordered"][3] < 0.0
    assert lead["runs"]["storm"][1]["deferred"] > 0
    batch = to_np(flow_features(mesh_payload["trace"], n_buckets=N_BUCKETS,
                                device="cpu")[1])
    window = dict(psum=3, reduce_scatter=1, all_gather=2, broadcast=0)
    for r in ranks:
        assert r["census_window"] == window
        assert r["census_chunk_switch"] == window
        assert r["mesh"] == (n_sh, n_dt, world)
        assert r["rows"] == {(None, True): -(-256 // world),
                             (4, True): -(-1024 // world),
                             (None, False): 256, (4, False): 1024}
        assert r["errors"]["table"] and r["errors"]["buckets"]
        assert "divide evenly over" in r["errors"]["defer_slots"]
        assert "divide evenly over" in r["errors"]["chunk_slots"]
        assert r["capacity3_per_window"] == 3
        assert "clock" in r["wall_deadline"]
        assert r["auto_k"] == lead["auto_k"] and (3 * r["auto_k"]) % world == 0
        assert "torchrun --nproc-per-node" in r["no_group_error"]
        assert_bit_equal(batch, r["oracle_table"])
