"""AdamW + schedules, plain PyTorch (no ``torch.optim``).

Port of ``repro/training/optim.py``. State layout mirrors the param tree:
{"m": tree, "v": tree, "step": int32 0-dim tensor}.

Departures from the reference, each kept on purpose:
- The update writes params and moments IN PLACE, under ``torch.no_grad``,
  and returns the same objects: the counterpart of the reference's donated
  params and state (``donate_argnums``), and what keeps a full-width model's
  params, grads and both moments within one card.
- ``torch.optim.AdamW`` is not used: it decays the weights before the step
  and rounds in another order. The update here is the reference's
  ``p - lr * (mh / (sqrt(vh) + eps) + wd * p)`` as XLA compiles it: the
  moments' ``b * m + c`` and the last two products-and-sums each one fused
  multiply-add (``torch.add(..., alpha=)`` and ``addcmul``, one rounding),
  and ``(m / b1c) / den`` as ``m / (b1c * den)``, XLA's rewrite of a
  quotient of a quotient. On the CPU it equals the jitted reference within
  2 ulps an element. CUDA's ``addcmul`` rounds its product before the sum,
  so on the card the last step can round once more.
- Division by a constant: the reference's schedule runs under ``jit``,
  where XLA multiplies by the f32 reciprocal of ``warmup_steps`` and of the
  decay length; so does ``lr_at`` (ROADMAP C3).
- Leaves are walked in ``jax.tree.flatten``'s order (dict keys sorted,
  lists in order, ``tree_flatten``), so the global norm sums the leaves'
  squares in the reference's order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models.transformer import tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


# -- trees in jax.tree.flatten's order ----------------------------------------

def tree_flatten(tree, path=()):
    """-> [(path, leaf)] with dict keys sorted and lists / tuples in order,
    as ``jax.tree_util.tree_flatten_with_path`` walks a pytree."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_flatten(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Size):
        out = []
        for i, v in enumerate(tree):
            out += tree_flatten(v, path + (i,))
        return out
    return [(path, tree)]


def tree_leaves(tree):
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure whose leaves, in ``tree_flatten``'s
    order, are ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)) and not isinstance(t, torch.Size):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


# -- schedule and state -------------------------------------------------------

def _f32(x) -> float:
    """A Python float that is exactly the f32 nearest ``x``."""
    return float(np.float32(x))


def lr_at(cfg: AdamWConfig, step, *, device=None):
    """Linear warmup then cosine decay to lr_min. ``step`` an int or a 0-dim
    tensor -> 0-dim f32 tensor (on ``step``'s device, or ``device``)."""
    if isinstance(step, torch.Tensor):
        step = step.to(F32)
    else:
        step = torch.tensor(step, dtype=F32, device=device)
    inv_warm = _f32(1.0 / max(cfg.warmup_steps, 1))
    inv_decay = _f32(1.0 / max(cfg.total_steps - cfg.warmup_steps, 1))
    warm = cfg.lr_peak * step * inv_warm
    t = torch.clamp((step - cfg.warmup_steps) * inv_decay, 0, 1)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(_f32(math.pi) * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params):
    zeros = lambda t: tree_map(lambda p: torch.zeros_like(p, dtype=F32), t)
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device)}


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(l.to(F32))) for l in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(g, max_norm):
    return torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """-> (grads * scale, the norm before clipping), new tensors."""
    g = global_norm(grads)
    scale = _clip_scale(g, max_norm)
    return tree_map(lambda x: x * scale, grads), g


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state):
    """-> (params, state, metrics); params and state are updated in place
    and returned. ``grads`` is read, not written; the clipped copy of each
    leaf lives one leaf at a time."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    step = state["step"].add_(1)
    lr = lr_at(cfg, step)
    stepf = step.to(F32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32,
                                       device=stepf.device), stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32,
                                       device=stepf.device), stepf)
    c1, c2 = 1 - cfg.b1, 1 - cfg.b2

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = (g * scale).to(F32)
        torch.add(c1 * g, m, alpha=cfg.b1, out=m)       # b1 m + (1 - b1) g
        torch.add(c2 * g * g, v, alpha=cfg.b2, out=v)   # b2 v + (1 - b2) g g
        den = torch.sqrt(v / b2c) + cfg.eps
        upd = torch.add(m / (b1c * den), p, alpha=cfg.weight_decay)
        p.addcmul_(upd.to(p.dtype), lr, value=-1)       # p - lr * upd
    return params, state, {"grad_norm": gnorm, "lr": lr}
