"""Model registry: one uniform (init / training loss / prefill / decode)
surface over the three backbone families (decoder-only, enc-dec, VLM
decoder).

Port of ``repro/models/model.py``: enc-dec configs route to
``models.whisper``, every other to ``models.transformer``; the trainer and
the server never branch on architecture internals. ``params_from_arrays``
and ``cache_from_arrays`` carry the reference's pytrees (numpy leaves, as
``jax.tree.map(np.asarray, tree)`` gives them; whisper's cross K/V is a
tuple) into the port: the two packages draw different weights from the
same seed, so parity goes through them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import mean, resolve_device
from repro_torch.distributed.sharding import is_sharded, lay_as, settle
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper as whi
from repro_torch.models.config import ArchConfig

F32 = torch.float32

MOE_AUX_WEIGHT = 0.01
MTP_WEIGHT = 0.3


def init_model(cfg: ArchConfig, gen=None, *, device=None):
    """Params from ``gen`` (a ``torch.Generator`` on ``device``, or an int
    seed; None seeds 0). device=None means CUDA."""
    if isinstance(gen, int):
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(gen)
    if cfg.encdec:
        return whi.init_params(cfg, gen, device=device)
    return tfm.init_params(cfg, gen, device=device)


def init_serving_model(cfg: ArchConfig, seed: int, *, device=None):
    """Params as ``cfg.precision`` serves them, drawn on ``device`` from
    ``seed`` (``transformer.init_serving_params``: DeepSeek-V3's fp8
    weights). device=None means CUDA."""
    return tfm.init_serving_params(cfg, seed, device=device)


def model_param_shapes(cfg: ArchConfig):
    """Shape tree (``torch.Size`` leaves) without allocating."""
    if cfg.encdec:
        return tfm.tree_map(lambda a: a.shape,
                            whi.init_params(cfg, device="meta"))
    return tfm.param_shapes(cfg)


def _xent(logits, labels):
    """Mean token cross-entropy, f32 logsumexp minus the gold logit (the
    mean as the reference's jitted ``jnp.mean``, ``device.mean``)."""
    logits = logits.to(F32)
    if is_sharded(logits):
        # vocab-parallel (Megatron's): each device reduces its vocab slice
        # and the slices' max and sums are combined; the gold logit is its
        # slice's pick (zeros elsewhere) summed. DTensor would gather the
        # vocab for logsumexp, and a gather's backward builds the whole
        # (B, S, V) grad on every device.
        top = settle(logits.detach().amax(-1, keepdim=True))
        lse = (top + torch.log(settle(torch.exp(logits - top).sum(
            -1, keepdim=True))))[..., 0]
        ids = torch.arange(logits.shape[-1], device=logits.device)
        hit = lay_as(labels.long()[..., None] == ids, logits)
        gold = settle(torch.where(hit, logits, 0.0).sum(-1))
    else:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return mean(lse - gold)


def loss_fn(params, cfg: ArchConfig, batch, *, remat=True):
    """batch: tokens/labels (+frames or patch_embeds). -> (loss, metrics),
    every metric a 0-dim f32 tensor."""
    tokens, labels = batch["tokens"], batch["labels"]
    if cfg.encdec:
        logits, aux = whi.forward_train(params, cfg, tokens, batch["frames"],
                                        remat=remat)
    else:
        logits, aux = tfm.forward_train(
            params, cfg, tokens,
            patch_embeds=batch.get("patch_embeds"), remat=remat)
    labels = torch.as_tensor(labels, device=logits.device)
    loss = _xent(logits, labels)
    total = loss + MOE_AUX_WEIGHT * aux["moe_aux"]
    metrics = {"xent": loss, "moe_aux": aux["moe_aux"]}
    if "mtp_logits" in aux:
        # MTP head predicts token t+2: logits t covers label t+1
        mtp = _xent(aux["mtp_logits"], labels[:, 1:])
        total = total + MTP_WEIGHT * mtp
        metrics["mtp_xent"] = mtp
    metrics["loss"] = total
    return total, metrics


def prefill(params, cfg: ArchConfig, batch):
    """batch: tokens (+ frames for enc-dec, + patch_embeds for the image
    frontend) -> (last-token logits (B, V), caches)."""
    if cfg.encdec:
        return whi.forward_prefill(params, cfg, batch["tokens"],
                                   batch["frames"])
    return tfm.forward_prefill(params, cfg, batch["tokens"],
                               patch_embeds=batch.get("patch_embeds"))


def decode_step(params, cfg: ArchConfig, token, pos, caches):
    """-> (logits (B, V), caches). The caches are updated in place; ``pos``
    is a 0-dim device tensor or an int."""
    if cfg.encdec:
        return whi.forward_decode(params, cfg, token, pos, caches)
    return tfm.forward_decode(params, cfg, token, pos, caches)


def init_decode_cache(cfg: ArchConfig, batch, max_len, dtype=torch.bfloat16,
                      quantize_kv=False, *, device=None):
    """Enc-dec caches take no int8 K/V, as the reference's take none."""
    if cfg.encdec:
        return whi.init_decode_cache(cfg, batch, max_len,
                                     cfg.n_frontend_tokens, dtype,
                                     device=device)
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
    checked against ``model_param_shapes(cfg)``. device=None means CUDA."""
    dev = resolve_device(device)
    _same_structure(model_param_shapes(cfg), tree)
    return tfm.tree_map(lambda a: _to_tensor(a, dev), tree)


def cache_from_arrays(tree, *, device=None):
    """A decode (or prefill) cache tree of numpy arrays as tensors, dtypes
    kept (f32, int8, int32; numpy has no bfloat16). device=None means
    CUDA."""
    dev = resolve_device(device)
    return tfm.tree_map(lambda a: _to_tensor(a, dev), tree)
