"""The dry run (``repro_torch.launch.dryrun``) and the mesh train step over
several gloo ranks.

* Dry-run records: in subprocesses (a fake default group cannot share a
  process with a real one), each with a fake group of 16 ranks as a
  (4, 4) ('data', 'model') mesh, ``run_cell``'s train, prefill and decode
  records of the dense smoke config (h2o-danube) and of deepseek's (MoE,
  MLA, MTP): ``params_total`` equals the reference's ``count_params``,
  ``analytic`` equals ``roofline.analytic``'s, a train step sends
  collectives, the scan correction equals the measured total (PyTorch runs
  every layer), and the peak holds at least the arguments that are not
  written in place. A toy step's per-device FLOPs and collective bytes
  equal a hand count.
* The mesh train step at (2, 2) and at (1, 2), one gloo process a rank,
  against ``mesh=None`` in this process: h2o-danube's smoke config over two
  steps, losses within rtol 1e-5 and params within 1e-4 of a leaf's largest
  magnitude (the ranks sum the batch in another order); deepseek's in the
  fed-grads form of ROADMAP C3's MoE entry: at each step the mesh's loss
  within rtol 1e-3 and its grads within 5e-2 of a leaf's largest magnitude
  (the bf16 dispatch, ``tests/test_torch_training.py``'s tolerances), and
  ``mesh=None``'s optimizer fed the mesh's grads reaching the mesh's params
  within 2^-20 of a leaf's largest magnitude. At (1, 2) each rank also
  restores a checkpoint onto the mesh and holds its own half; at (2, 2)
  three int8-cache decode steps (the caches sharded, each rank writing its
  own slots) match ``mesh=None`` within 1e-5 of the logits' magnitude.

The ranks import this module, so it imports no jax at its top. Every
process that starts a group destroys it; the last test fails if a default
group is left in this one.
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

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240

# ---------------------------------------------------------------------------
# dry-run records, in subprocesses
# ---------------------------------------------------------------------------

_CELLS = """
import json, sys
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import gather_data
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_group
from repro_torch.roofline.analysis import collective_bytes_from_ops

arch = sys.argv[1]
out = {}
with fake_group(16):
    mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
    # the smoke config on the (4, 4) mesh, where the cell takes the
    # published config on the production mesh
    dryrun.get_config = get_smoke_config
    dryrun.make_production_mesh = lambda multi_pod: mesh
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        out[shape] = dryrun.run_cell(arch, shape, multi_pod=False,
                                     verbose=False)
    if arch == "h2o-danube-1.8b":
        # the toy step: x (64, 32) over 'data' times w (32, 48), whose
        # input dim is over 'data' and output dim over 'model', gathered
        x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        w = distribute_tensor(torch.empty(32, 48, device="meta"), mesh,
                              [Shard(0), Shard(1)], src_data_rank=None)
        rec = dryrun.StepRecorder()
        with rec:
            y = x @ gather_data(w)
        out["toy"] = {"flops": rec.flops, "calls": rec.calls,
                      "coll": collective_bytes_from_ops(rec.calls),
                      "local": list(y.to_local().shape)}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    """The cells of both archs, the two subprocesses run at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = {a: subprocess.Popen([sys.executable, "-c", _CELLS, a],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, env=env)
             for a in ("h2o-danube-1.8b", "deepseek-v3-671b")}
    out = {}
    for arch, p in procs.items():
        try:
            so, se = p.communicate(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.communicate()
        assert p.returncode == 0, se[-4000:]
        out[arch] = json.loads(so.strip().splitlines()[-1])
    return out


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "deepseek-v3-671b"])
def test_dry_run_records(arch, records):
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro_torch.configs import get_smoke_config
    from repro_torch.roofline.analytic import (cell_flops_per_device,
                                               cell_hbm_bytes_per_device,
                                               decode_cache_bytes)
    cfg = get_smoke_config(arch)
    n = JM.count_params(JM.model_param_shapes(jax_smoke(arch)))
    for shape, r in records[arch].items():
        if shape == "toy":
            continue
        assert r["chips"] == 16 and r["mesh"] == [4, 4]
        assert r["params_total"] == n
        cache = (decode_cache_bytes(cfg, shape) if r["kind"] == "decode"
                 else 0)
        assert r["analytic"] == {
            "flops_per_dev": cell_flops_per_device(cfg, shape, 16),
            "hbm_bytes_per_dev": cell_hbm_bytes_per_device(cfg, shape, 16,
                                                           n, cache),
            "decode_cache_bytes_total": cache}
        assert r["collective_bytes_corrected"] == r["collectives"]["total"]
        mem = r["memory"]
        assert mem["peak_per_device"] >= (mem["argument_bytes"]
                                          - mem["alias_bytes"])
        assert r["cost_measured"]["flops_per_dev"] > 0
        assert set(r["roofline"]) == {"compute_s", "memory_s",
                                      "collective_s", "dominant",
                                      "overlap_roofline_frac"}
    assert records[arch]["train_4k"]["collectives"]["count"] > 0
    assert records[arch]["train_4k"]["memory"]["alias_bytes"] > 0
    assert records[arch]["decode_32k"]["memory"]["alias_bytes"] > 0


def test_toy_step_equals_a_hand_count(records):
    """x (64, 32) Shard(0) over 'data' times w (32, 48), Shard(0) over
    'data' and Shard(1) over 'model', on the (4, 4) mesh: gathering w's
    'data' shards is one all-gather of its (32, 12) local block over the 4
    ranks of a 'data' group, (3/4) x 32 x 12 x 4 B on the wire; the product
    is a (16, 32) x (32, 12) block a device, 2 x 16 x 32 x 12 FLOPs."""
    toy = records["h2o-danube-1.8b"]["toy"]
    assert toy["local"] == [16, 12]
    assert toy["flops"] == 2 * 16 * 32 * 12
    assert toy["calls"] == [["all-gather", 32 * 12 * 4, 4]]
    assert toy["coll"] == {"total": 0.75 * 32 * 12 * 4,
                           "by_op": {"all-gather": 0.75 * 32 * 12 * 4},
                           "count": 1}


# ---------------------------------------------------------------------------
# the mesh train step over gloo ranks
# ---------------------------------------------------------------------------

B, S = 4, 12


def _batch(cfg, step):
    rng = np.random.default_rng(100 + step)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                .astype(np.int32))
            for k in ("tokens", "labels")}


def _tcfg():
    from repro_torch.training.loop import TrainConfig
    from repro_torch.training.optim import AdamWConfig
    return TrainConfig(seq_len=S, global_batch=B, remat=False,
                       opt=AdamWConfig(lr_peak=2e-3, warmup_steps=1))


def _leaves(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.training.optim import tree_leaves
    return [(t.full_tensor() if isinstance(t, DTensor) else t)
            .detach().numpy().copy() for t in tree_leaves(tree)]


def _run(arch, mesh, feed=None):
    """Two steps of ``make_train_step`` from seed 0. -> (losses, the grads
    the optimizer was handed a step, final params). ``feed``: a step's
    grads to hand the optimizer in place of its own."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.training import loop
    from repro_torch.training.optim import (init_opt_state, tree_leaves,
                                            tree_unflatten)
    cfg = get_smoke_config(arch)
    params = M.init_model(cfg, 0, device="cpu")
    state = init_opt_state(params)
    seen, real = [], loop.adamw_update

    def spy(ocfg, p, grads, st):
        seen.append(_leaves(grads))
        if feed is not None:
            grads = tree_unflatten(grads, [torch.from_numpy(g) for g in
                                           feed[len(seen) - 1]])
        return real(ocfg, p, grads, st)

    loop.adamw_update = spy
    try:
        step = loop.make_train_step(cfg, _tcfg(), mesh=mesh)
        losses = []
        for k in range(2):
            params, state, _, met = step(params, state, None,
                                         _batch(cfg, k))
            loss = met["loss_total"]
            losses.append(float(loss.full_tensor() if isinstance(
                loss, DTensor) else loss))
    finally:
        loop.adamw_update = real
    return losses, seen, _leaves(params)


def _decode(mesh, steps=3, arch="qwen3-4b"):
    """``steps`` decode steps of the smoke config over an int8 cache (B8's
    plain version on each shard), placed by ``param_specs`` and
    ``cache_specs`` on ``mesh`` (or not, mesh=None). -> each step's
    logits."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import (P, batch_specs,
                                                  cache_specs,
                                                  distribute_tree,
                                                  named_sharding_tree,
                                                  param_specs)
    from repro_torch.models import model as M
    cfg = get_smoke_config(arch)
    params = M.init_model(cfg, 0, device="cpu")
    caches = M.init_decode_cache(cfg, B, 16, dtype=torch.float32,
                                 quantize_kv=True, device="cpu")
    rng = np.random.default_rng(7)

    def place(t, spec):
        return (t if mesh is None else distribute_tree(
            t, named_sharding_tree(mesh, spec)))
    if mesh is not None:
        params = place(params, param_specs(params, mesh))
        caches = place(caches, cache_specs(mesh, caches, B))
    out = []
    with torch.no_grad(), implicit_replication():
        for i in range(steps):
            tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B,))
                                   .astype(np.int32))
            tok = tok if mesh is None else place(tok, batch_specs(mesh, tok))
            logits, caches = M.decode_step(params, cfg, tok,
                                           place(torch.tensor(i), P()),
                                           caches)
            out.append((logits.full_tensor() if isinstance(
                logits, DTensor) else logits).numpy().copy())
    return out


def _restore_halves(mesh, tmp):
    """A checkpoint restored onto the (1, 2) mesh: each rank's local block
    is its half of the saved array (rank 0 the first columns)."""
    from repro_torch.distributed.sharding import P, named_sharding_tree
    from repro_torch.training import checkpoint as ckpt
    w = torch.arange(32.0).reshape(4, 8)
    if dist.get_rank() == 0:
        ckpt.save_checkpoint(tmp, 1, {"w": w})
    dist.barrier()
    got, _ = ckpt.restore_checkpoint(
        tmp, {"w": w}, shardings=named_sharding_tree(
            mesh, {"w": P("data", "model")}))
    half = got["w"].to_local()
    want = w[:, 4 * dist.get_rank():4 * dist.get_rank() + 4]
    return bool(torch.equal(half, want)), bool(torch.equal(
        got["w"].full_tensor(), w))


def _rank_main(rank, shape, store, tmp, results):
    torch.set_num_threads(1)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        world = shape[0] * shape[1]
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=120))
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        out = {a: _run(a, mesh) for a in ("h2o-danube-1.8b",
                                          "deepseek-v3-671b")}
        if shape == (1, 2):
            out["restore"] = _restore_halves(mesh, tmp)
        else:
            out["decode"] = _decode(mesh)
        results.put((rank, out, None))
    except BaseException:            # reported to the parent, which fails
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Both meshes' ranks at once: {shape: [each rank's results]}."""
    ctx = multiprocessing.get_context("spawn")
    started = {}
    for shape in ((2, 2), (1, 2)):
        tmp = str(tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}"))
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            r, shape, os.path.join(tmp, "store"), tmp, results))
            for r in range(shape[0] * shape[1])]
        for p in procs:
            p.start()
        started[shape] = (procs, results)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    out, why = {}, None
    try:
        for shape, (procs, results) in started.items():
            got = {}
            while len(got) < len(procs) and why is None:
                try:
                    rank, res, err = results.get(timeout=1.0)
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        why = f"a rank of {shape} died"
                    elif time.monotonic() > deadline:
                        why = f"{shape} still running after {RANK_TIMEOUT_S} s"
                    continue
                if err is not None:
                    why = f"rank {rank} of {shape} raised:\n{err}"
                got[rank] = res
            out[shape] = [got.get(r) for r in range(len(procs))]
    finally:
        for procs, _ in started.values():
            for p in procs:
                p.join(timeout=30 if why is None else 1)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    if why is not None:
        pytest.fail(why)
    return out


def _rel(ref, got):
    scale = float(np.abs(ref).max())
    err = float(np.abs(got.astype(np.float64) - ref).max())
    return err / scale if scale else err


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
def test_dense_mesh_train_step_matches_one_device(shape, mesh_runs):
    ranks = mesh_runs[shape]
    losses, _, params = ranks[0]["h2o-danube-1.8b"]
    ref_losses, _, ref_params = _run("h2o-danube-1.8b", None)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert max(_rel(r, g) for r, g in zip(ref_params, params)) <= 1e-4
    for other in ranks[1:]:          # every rank gathers the same params
        assert other["h2o-danube-1.8b"][0] == losses
        assert all(np.array_equal(a, b) for a, b in
                   zip(other["h2o-danube-1.8b"][2], params))


@pytest.mark.parametrize("shape", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
def test_moe_mesh_train_step_matches_one_device_fed_its_grads(shape,
                                                              mesh_runs):
    losses, grads, params = mesh_runs[shape][0]["deepseek-v3-671b"]
    ref_losses, ref_grads, ref_params = _run("deepseek-v3-671b", None,
                                             feed=grads)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)
    for step_g, step_ref in zip(grads, ref_grads):
        assert max(_rel(r, g) for r, g in zip(step_ref, step_g)) <= 5e-2
    assert max(_rel(r, g) for r, g in zip(ref_params, params)) <= 2 ** -20


def test_mesh_decode_matches_one_device(mesh_runs):
    """Three int8-cache decode steps of the qwen3-4b smoke config with the
    caches sharded by ``cache_specs`` on (2, 2) (each rank writes its own
    slots, ``write_row_``): the logits within 1e-5 of their largest
    magnitude of ``mesh=None``'s (the ranks sum in another order)."""
    got = mesh_runs[(2, 2)][0]["decode"]
    for g, r in zip(got, _decode(None)):
        assert _rel(r, g) <= 1e-5


def test_restore_onto_two_ranks_keeps_each_half(mesh_runs):
    for rank in mesh_runs[(1, 2)]:
        assert rank["restore"] == (True, True)


def test_no_default_group_is_left_running():
    """The file's last test: no test here left a default process group in
    this worker."""
    assert not dist.is_initialized()
