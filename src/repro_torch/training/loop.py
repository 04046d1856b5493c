"""Training loop: the train step (grad accumulation, optional gradient
compression), checkpoint/restart, watchdog, deterministic data.

Port of ``repro/training/loop.py``. Departures from the reference, each
kept on purpose:
- The step runs eagerly. Grads come from ``torch.autograd.grad`` over the
  param leaves (``requires_grad`` turned on), and the optimizer writes
  params and moments in place (``optim.adamw_update``): the counterpart of
  the reference's jitted step with donated params and state.
- Microbatches: where the reference scans, the port loops over them in the
  same order, adds each one's f32 grads in place, and divides by
  ``microbatches`` as the jitted reference does, by a product with the f32
  reciprocal (ROADMAP C3).
- Metrics cross to the host in one transfer a step.
- ``mesh=`` (a ``DeviceMesh`` with dims ('data', 'model'), or
  ('pod', 'data', 'model')) runs the same step on ``DTensor`` s, under
  ``implicit_replication`` (the model's plain constants, rope tables and
  masks, count as replicated): params and the error state placed by
  ``param_specs``, the optimizer state by ``opt_state_specs`` and each
  batch by ``batch_specs``, where the reference jits the step with those
  ``in_shardings``. A leaf that is not yet a ``DTensor`` is placed on the
  way in (every rank holds it whole and keeps its slice). On a mesh of
  one device the step is bit-equal to ``mesh=None``.
- ``train`` draws the initial weights from ``torch.Generator(seed)`` on the
  device, which differ from the reference's ``PRNGKey(seed)`` draws (C3's
  RNG entry); a restart restores them from the checkpoint instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.data.lm_pipeline import TokenPipeline
from repro_torch.device import mean, resolve_device
from repro_torch.distributed.sharding import (batch_specs, distribute_tree,
                                              named_sharding_tree,
                                              opt_state_specs, param_specs)
from repro_torch.models import model as M
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import grad_compress as gc
from repro_torch.training.optim import (AdamWConfig, adamw_update,
                                        init_opt_state, tree_leaves,
                                        tree_unflatten)
from repro_torch.training.watchdog import StepWatchdog

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    seq_len: int = 256
    global_batch: int = 8
    microbatches: int = 1            # gradient accumulation
    opt: AdamWConfig = AdamWConfig()
    remat: bool = True
    grad_compress: str = "none"      # none | topk | int8
    topk_frac: float = 0.05
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10


def value_and_grad(loss_of, params, batch):
    """``jax.value_and_grad(loss_of, has_aux=True)(params, batch)``:
    -> ((loss, metrics), grads), grads a tree like ``params``. A leaf the
    loss does not read gets zeros, as under ``jax.grad``."""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_of(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def _micro(a, n, i):
    return a.reshape((n, a.shape[0] // n) + tuple(a.shape[1:]))[i]


def make_train_step(cfg, tcfg: TrainConfig, mesh=None, batch_shapes=None):
    """Build the (params, opt_state, err_state, batch) -> (params,
    opt_state, err_state, metrics) step; params and opt_state are updated
    in place and returned. With ``mesh`` the step runs on ``DTensor`` s
    placed over it (the module docstring); ``batch_shapes`` (a dict of
    leaves with shapes) fixes the batch's specs, which are otherwise read
    from each batch."""
    def loss_of(params, batch):
        return M.loss_fn(params, cfg, batch, remat=tcfg.remat)

    def step(params, opt_state, err_state, batch):
        n = tcfg.microbatches
        if n > 1:
            # split the batch on dim0 and accumulate grads over the
            # microbatches in order: activation memory drops by n
            acc, losses, mets = None, [], []
            for i in range(n):
                mb = {k: _micro(v, n, i) for k, v in batch.items()}
                (l, metrics), g = value_and_grad(loss_of, params, mb)
                g = [x.to(F32) for x in tree_leaves(g)]
                if acc is None:
                    acc = g
                else:
                    for a, x in zip(acc, g):
                        a.add_(x)
                losses.append(l)
                mets.append(metrics)
            inv_n = float(np.float32(1.0) / np.float32(n))
            grads = tree_unflatten(params, [a.mul_(inv_n) for a in acc])
            loss = mean(torch.stack(losses))
            metrics = {k: mean(torch.stack([m[k] for m in mets]))
                       for k in mets[0]}
        else:
            (loss, metrics), grads = value_and_grad(loss_of, params, batch)

        if tcfg.grad_compress == "topk":
            grads, err_state = gc.topk_compress(grads, err_state,
                                                frac=tcfg.topk_frac)
        elif tcfg.grad_compress == "int8":
            grads, err_state = gc.int8_compress(grads, err_state)

        params, opt_state, om = adamw_update(tcfg.opt, params, grads,
                                             opt_state)
        metrics = {**metrics, **om, "loss_total": loss}
        return params, opt_state, err_state, metrics

    if mesh is None:
        return step
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh with dims ('data', "
                        f"'model') or ('pod', 'data', 'model'), got "
                        f"{type(mesh).__name__}")
    shapes = M.model_param_shapes(cfg)
    psh = named_sharding_tree(mesh, param_specs(shapes, mesh))
    osh = named_sharding_tree(mesh, opt_state_specs(shapes, mesh))
    bsh = (named_sharding_tree(mesh, batch_specs(mesh, batch_shapes))
           if batch_shapes is not None else None)

    def mesh_step(params, opt_state, err_state, batch):
        params = distribute_tree(params, psh)
        opt_state = distribute_tree(opt_state, osh)
        if err_state is not None:
            err_state = distribute_tree(err_state, psh)
        batch = distribute_tree(batch, bsh or named_sharding_tree(
            mesh, batch_specs(mesh, batch)))
        with implicit_replication():
            return step(params, opt_state, err_state, batch)

    return mesh_step


def _host_metrics(metrics) -> dict:
    """Every metric as a Python float, in one device-to-host transfer (a
    ``DTensor`` metric gathered whole first)."""
    keys = list(metrics)
    vals = [metrics[k] for k in keys]
    vals = [v.full_tensor() if isinstance(v, DTensor) else v for v in vals]
    vals = torch.stack([v.to(F32) for v in vals]).cpu().tolist()
    return dict(zip(keys, vals))


def train(cfg, tcfg: TrainConfig, *, seed=0, mesh=None, extra_batch=None,
          verbose=True, device=None):
    """Run the loop on ``device`` (None: CUDA, raising without a card).
    Returns (params, history).

    mesh: a ``DeviceMesh`` on ``device``'s type; the initial params (every
    rank draws the same ones from ``seed``), the optimizer and error state
    and each step's batch are placed over it, a restart restores onto it
    (``restore_checkpoint(shardings=)``), and the returned params are
    ``DTensor`` s. A checkpoint holds whole arrays, so it restores on any
    mesh or none.

    extra_batch: dict of static per-batch tensors (frames / patch_embeds
    stubs) merged into every step's batch.
    """
    dev = resolve_device(device)
    step_fn = make_train_step(cfg, tcfg, mesh=mesh)

    start_step = 0
    latest = ckpt.latest_step(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
    if latest is not None:               # restart path
        like = M.init_model(cfg, device="meta")
        like = (like, init_opt_state(like))
        shardings = None
        if mesh is not None:
            shapes = M.model_param_shapes(cfg)
            shardings = named_sharding_tree(mesh, (
                param_specs(shapes, mesh), opt_state_specs(shapes, mesh)))
        (params, opt_state), start_step = ckpt.restore_checkpoint(
            tcfg.ckpt_dir, like, step=latest, device=dev,
            shardings=shardings)
    else:
        params = M.init_model(cfg, seed, device=dev)
        opt_state = init_opt_state(params)
        if mesh is not None:
            shapes = M.model_param_shapes(cfg)
            params = distribute_tree(params, named_sharding_tree(
                mesh, param_specs(shapes, mesh)))
            opt_state = distribute_tree(opt_state, named_sharding_tree(
                mesh, opt_state_specs(shapes, mesh)))
    err_state = (gc.init_error_state(params)
                 if tcfg.grad_compress != "none" else None)

    watchdog = StepWatchdog()
    writer = (ckpt.AsyncCheckpointer(tcfg.ckpt_dir)
              if tcfg.ckpt_dir else None)
    history = []

    # deterministic per-(step, shard) data: any host can regenerate any
    # shard after failover
    pipe = TokenPipeline(cfg.vocab_size, seq_len=tcfg.seq_len,
                         global_batch=tcfg.global_batch, seed=seed)

    for step in range(start_step, tcfg.steps):
        watchdog.step_start(step)
        data = pipe.batch(step)
        batch = {"tokens": torch.from_numpy(data["tokens"]).to(dev),
                 "labels": torch.from_numpy(data["labels"]).to(dev)}
        if extra_batch:
            batch.update(extra_batch)
        params, opt_state, err_state, metrics = step_fn(
            params, opt_state, err_state, batch)
        metrics = _host_metrics(metrics)
        stat = watchdog.step_end(step)
        metrics["step_time"] = stat["dt"]
        history.append({"step": step, **metrics})
        if verbose and (step % tcfg.log_every == 0 or step == tcfg.steps - 1):
            print(f"step {step:5d} loss {metrics['loss_total']:.4f} "
                  f"xent {metrics['xent']:.4f} lr {metrics['lr']:.2e} "
                  f"dt {stat['dt']:.2f}s")
        if writer and (step + 1) % tcfg.ckpt_every == 0:
            writer.save(step + 1, (params, opt_state))
    if writer:
        writer.wait()
    return params, history
