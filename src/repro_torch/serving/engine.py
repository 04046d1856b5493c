"""Batched prefill/decode serving engine.

Port of ``repro/serving/engine.py``. One prefill (full prompt -> last
logits + caches) and one decode step (token + caches -> logits + caches),
reused across requests. The reference jits both and donates the caches to
the decode step; here both run eagerly and the decode step writes into the
caches in place (``models.transformer``), so a step allocates no cache.
Over an int8 cache the attention core of every layer is the B8 kernel on
the card.

Sampling: greedy; the engine is deliberately simple — batching discipline
(fixed batch, fixed max_len) mirrors the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import model as M


class ServeEngine:
    def __init__(self, cfg, params, *, batch: int, max_len: int,
                 cache_dtype=torch.bfloat16):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.cache_dtype = cache_dtype

    def prefill(self, batch_dict):
        logits, caches = M.prefill(self.params, self.cfg, batch_dict)
        return logits, caches

    def decode(self, token, pos, caches):
        """-> (logits, caches): the same cache objects, written in place."""
        return M.decode_step(self.params, self.cfg, token, pos, caches)


def _place_prefill_into_decode(decode_cache, prefill_cache):
    """Copy the prefill cache into the leading slots of the decode cache,
    in place; returns the decode cache."""
    def place(d, s):
        d[tuple(slice(0, x) for x in s.shape)].copy_(s)
        return d

    if isinstance(decode_cache, dict):
        return {k: _place_prefill_into_decode(decode_cache[k],
                                              prefill_cache[k])
                for k in decode_cache}
    if isinstance(decode_cache, list):
        return [_place_prefill_into_decode(d, s)
                for d, s in zip(decode_cache, prefill_cache, strict=True)]
    return place(decode_cache, prefill_cache)


def greedy_generate(cfg, params, batch_dict, *, n_new: int,
                    max_len: Optional[int] = None,
                    cache_dtype=torch.float32):
    """Prefill the prompt, then decode n_new tokens greedily. Returns
    (B, n_new) int32. (The reference's temperature sampling waits: nothing
    in the port calls it, and its draws could not match ``jax.random``.)"""
    dev = params["embed"].device
    tokens = torch.as_tensor(batch_dict["tokens"], device=dev)
    b, s = tokens.shape
    max_len = max_len or (s + n_new + 1)

    logits, pcache = M.prefill(params, cfg, {"tokens": tokens})
    dcache = M.init_decode_cache(cfg, b, max_len, dtype=cache_dtype,
                                 device=dev)
    caches = _place_prefill_into_decode(dcache, pcache)

    outs = []
    for i in range(n_new):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        outs.append(nxt)
        logits, caches = M.decode_step(params, cfg, nxt, s + i, caches)
    return torch.stack(outs, dim=1)
