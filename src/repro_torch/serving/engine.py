"""Batched prefill/decode serving engine.

Port of ``repro/serving/engine.py``. One prefill (full prompt -> last
logits + caches) and one decode step (token + caches -> logits + caches),
reused across requests, for every family of the registry. The reference
jits both and donates the caches to the decode step. Here the prefill runs
eagerly, and on the card the decode step is a CUDA graph, one per engine:

- static token and position input buffers (the position a 0-dim int64
  tensor: the step computes its slot, cache writes and masks from it on
  the device, ``models.attention``);
- the caches are the graph's carries, written in place where they lie
  (the reference's donation); the graph is bound to the cache tensors it
  was captured on, and a decode over other tensors captures anew;
- a static logits output, returned as a copy.

The first decode over a cache tree runs the step eagerly on a side stream
(the capture's warm-up, and the step itself: it writes the caches once),
then captures the same step, which runs nothing; every later step
replays it. A failed capture raises. On the CPU every step runs eagerly
(``models.model.decode_step`` is the eager step on either device). Over
an int8 cache the attention core of every GQA layer is the B8 kernel on
the card, inside the graph.

Sampling: greedy or temperature (``greedy_generate``); the engine is
deliberately simple — batching discipline (fixed batch, fixed max_len)
mirrors the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import true_div
from repro_torch.models import model as M
from repro_torch.models.transformer import tree_leaves


class ServeEngine:
    def __init__(self, cfg, params, *, batch: int, max_len: int,
                 cache_dtype=torch.bfloat16):
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.max_len = max_len
        self.cache_dtype = cache_dtype
        self.device = params["embed"].device
        self.graph = self.device.type == "cuda"
        # (cache pointers and token shape, graph, token, pos, logits)
        self._decode_graph = None

    def prefill(self, batch_dict):
        logits, caches = M.prefill(self.params, self.cfg, batch_dict)
        return logits, caches

    def decode(self, token, pos, caches):
        """-> (logits, caches): the same cache objects, written in place.
        ``pos`` is an int or a 0-dim tensor on the engine's device."""
        if not self.graph:
            return M.decode_step(self.params, self.cfg, token, pos, caches)
        key = (tuple(t.data_ptr() for t in tree_leaves(caches)),
               tuple(token.shape))
        entry = self._decode_graph
        if entry is None or entry[0] != key:
            self._decode_graph = None
            return self._capture(key, token, pos, caches), caches
        _, graph, tok, pos_buf, logits = entry
        tok.copy_(token)
        _set_pos(pos_buf, pos)
        graph.replay()
        return logits.clone(), caches

    def _capture(self, key, token, pos, caches):
        """The step at ``pos`` eagerly on a side stream (the warm-up), then
        captured into the engine's graph. -> the eager step's logits."""
        dev = self.device
        tok = torch.empty(tuple(token.shape), dtype=torch.int64, device=dev)
        tok.copy_(token)
        pos_buf = torch.zeros((), dtype=torch.int64, device=dev)
        _set_pos(pos_buf, pos)
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first, _ = M.decode_step(self.params, self.cfg, tok, pos_buf,
                                     caches)
        main.wait_stream(side)
        first.record_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            logits, _ = M.decode_step(self.params, self.cfg, tok, pos_buf,
                                      caches)
        self._decode_graph = (key, graph, tok, pos_buf, logits)
        return first


def _set_pos(buf, pos):
    """The position into its static buffer: a device-side fill for an int,
    a copy for a tensor; never a read on the host."""
    if isinstance(pos, torch.Tensor):
        buf.copy_(pos)
    else:
        buf.fill_(pos)


def _place_prefill_into_decode(decode_cache, prefill_cache):
    """Copy the prefill cache into the leading slots of the decode cache,
    in place; returns the decode cache."""
    if isinstance(decode_cache, dict):
        return {k: _place_prefill_into_decode(decode_cache[k],
                                              prefill_cache[k])
                for k in decode_cache}
    if isinstance(decode_cache, (list, tuple)):
        placed = [_place_prefill_into_decode(d, s)
                  for d, s in zip(decode_cache, prefill_cache, strict=True)]
        return type(decode_cache)(placed)
    decode_cache[tuple(slice(0, x) for x in prefill_cache.shape)].copy_(
        prefill_cache)
    return decode_cache


def _gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel``'s default ('low') transform of uniforms in
    ``[finfo(f32).tiny, 1)``."""
    return -torch.log(-torch.log(u))


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` in f32, drawn on ``device`` from
    ``generator``: uniforms in ``[finfo(f32).tiny, 1)`` through
    ``_gumbel_from_uniform``, as ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    return _gumbel_from_uniform(u.clamp_min_(torch.finfo(torch.float32).tiny))


def sample_tokens(logits: torch.Tensor, temperature: float,
                  noise: torch.Tensor) -> torch.Tensor:
    """One categorical draw a row from ``logits / temperature`` by the
    Gumbel-max trick, as ``jax.random.categorical`` draws it: the first
    maximum of ``noise + logits / temperature``. The division is the
    correctly rounded one (``device.true_div``), as the reference's eager
    division gives it. -> int32 tokens."""
    return torch.argmax(noise + true_div(logits, temperature),
                        dim=-1).to(torch.int32)


def greedy_generate(cfg, params, batch_dict, *, n_new: int,
                    max_len: Optional[int] = None,
                    cache_dtype=torch.float32, temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None):
    """Prefill the prompt (+ its frames or patch embeddings), then decode
    n_new tokens. Returns (B, n_new) int32.

    Greedy (the first argmax) unless ``temperature > 0.0`` and a
    ``generator`` is given (the reference's ``key``): then each step draws
    one (B, V) noise tensor from ``generator`` on the params' device, in
    step order, and samples ``sample_tokens(logits, temperature, noise)``."""
    dev = params["embed"].device
    batch = dict(batch_dict)
    batch["tokens"] = torch.as_tensor(batch_dict["tokens"], device=dev)
    b, s = batch["tokens"].shape
    n_front = (cfg.n_frontend_tokens
               if cfg.frontend == "image_patches" else 0)
    max_len = max_len or (s + n_front + n_new + 1)

    logits, pcache = M.prefill(params, cfg, batch)
    dcache = M.init_decode_cache(cfg, b, max_len, dtype=cache_dtype,
                                 device=dev)
    caches = _place_prefill_into_decode(dcache, pcache)

    outs = []
    pos = s + n_front
    for i in range(n_new):
        if temperature > 0.0 and generator is not None:
            noise = gumbel_noise(tuple(logits.shape), generator, dev)
            nxt = sample_tokens(logits, temperature, noise)
        else:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        outs.append(nxt)
        logits, caches = M.decode_step(params, cfg, nxt, pos + i, caches)
    return torch.stack(outs, dim=1)
