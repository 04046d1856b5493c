"""Model registry: one uniform (init / prefill / decode) surface over the
decoder families the port serves.

Port of ``repro/models/model.py`` for the dense GQA decoders
(``models.transformer``); enc-dec and the other families raise
``NotImplementedError`` (ROADMAP.md, A13), and ``loss_fn`` waits for the
training slice. ``params_from_arrays`` and ``cache_from_arrays`` carry the
reference's pytrees (numpy leaves, as ``jax.tree.map(np.asarray, tree)``
gives them) into the port: the two packages draw different weights from
the same seed, so parity goes through them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ArchConfig


def init_model(cfg: ArchConfig, gen=None, *, device=None):
    """Params from ``gen`` (a ``torch.Generator`` on ``device``, or an int
    seed; None seeds 0). device=None means CUDA."""
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: encdec {tfm.QUEUED}")
    if isinstance(gen, int):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(gen)
    return tfm.init_params(cfg, gen, device=device)


def model_param_shapes(cfg: ArchConfig):
    return tfm.param_shapes(cfg)


def prefill(params, cfg: ArchConfig, batch):
    """-> (last-token logits (B, V), caches)."""
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: encdec {tfm.QUEUED}")
    return tfm.forward_prefill(params, cfg, batch["tokens"])


def decode_step(params, cfg: ArchConfig, token, pos, caches):
    """-> (logits (B, V), caches). The caches are updated in place."""
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: encdec {tfm.QUEUED}")
    return tfm.forward_decode(params, cfg, token, pos, caches)


def init_decode_cache(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16,
                      quantize_kv=False, *, device=None):
    if cfg.encdec:
        raise NotImplementedError(f"{cfg.name}: encdec {tfm.QUEUED}")
    return tfm.init_decode_cache(cfg, batch, max_len, dtype,
                                 quantize_kv=quantize_kv, device=device)


def count_params(shapes) -> int:
    """Elements in a tree of shapes or tensors."""
    total = 0

    def add(leaf):
        nonlocal total
        total += math.prod(leaf.shape if hasattr(leaf, "shape") else leaf)
        return leaf

    tfm.tree_map(add, shapes)
    return total


def active_params(cfg: ArchConfig, total: int) -> int:
    """Per-token active parameters (MoE: routed experts count top_k/E)."""
    if cfg.moe is None:
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_expert
    n_moe_layers = sum(
        1 for i in range(cfg.n_layers)
        if cfg.moe is not None and i >= m.n_dense_layers and cfg.d_ff > 0)
    inactive = n_moe_layers * per_expert * (m.n_experts - m.top_k)
    return total - inactive


def _same_structure(want, got, path="params"):
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(want) != set(got):
            raise ValueError(f"{path}: expected a dict with keys "
                             f"{sorted(want)}")
        for k in want:
            _same_structure(want[k], got[k], f"{path}[{k!r}]")
    elif isinstance(want, list):
        if not isinstance(got, (list, tuple)) or len(want) != len(got):
            raise ValueError(f"{path}: expected a list of {len(want)}")
        for i, (w, g) in enumerate(zip(want, got)):
            _same_structure(w, g, f"{path}[{i}]")
    elif tuple(np.shape(got)) != tuple(want):
        raise ValueError(f"{path}: shape {tuple(np.shape(got))} != "
                         f"{tuple(want)}")


def _to_tensor(a, dev):
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


def params_from_arrays(cfg: ArchConfig, tree, *, device=None):
    """The reference's params (a tree of numpy arrays) as the port's tree,
    checked against ``param_shapes(cfg)``. device=None means CUDA."""
    dev = resolve_device(device)
    _same_structure(tfm.param_shapes(cfg), tree)
    return tfm.tree_map(lambda a: _to_tensor(a, dev), tree)


def cache_from_arrays(tree, *, device=None):
    """A decode (or prefill) cache tree of numpy arrays as tensors, dtypes
    kept (f32, int8, int32; numpy has no bfloat16). device=None means
    CUDA."""
    dev = resolve_device(device)
    return tfm.tree_map(lambda a: _to_tensor(a, dev), tree)
