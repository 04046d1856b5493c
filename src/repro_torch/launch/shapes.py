"""Input stand-ins for every (arch x shape) dry-run cell.

Port of ``repro/launch/shapes.py``: each of the reference's
``ShapeDtypeStruct`` is a ``meta`` tensor of the same shape and dtype
(nothing allocated). Shapes (LM family):
  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill
  decode_32k   seq 32,768 (KV), batch 128     -> serve (decode) step
  long_500k    seq 524,288 (KV), batch 1      -> decode; sub-quadratic only

long_500k needs an O(1)-or-windowed per-token state: xlstm-1.3b
(recurrent), h2o-danube-1.8b (SWA ring), recurrentgemma-2b (RG-LRU + a
local window). The pure full-attention archs skip it (recorded).
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M

I32 = torch.int32
F32 = torch.float32
BF16 = torch.bfloat16

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, global_batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, global_batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, global_batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, global_batch=1),
}

LONG_OK = {"xlstm-1.3b", "h2o-danube-1.8b", "recurrentgemma-2b"}


def cell_supported(arch_id: str, shape_name: str, cfg=None) -> bool:
    if shape_name == "long_500k":
        return arch_id in LONG_OK
    return True


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_extras(cfg, batch):
    extras = {}
    if cfg.encdec:
        extras["frames"] = _meta(
            (batch, cfg.n_frontend_tokens, cfg.frontend_dim), F32)
    if cfg.frontend == "image_patches":
        extras["patch_embeds"] = _meta(
            (batch, cfg.n_frontend_tokens, cfg.frontend_dim), F32)
    return extras


def input_specs(cfg, shape_name: str, *, int8_kv: bool = False):
    """-> the cell step's arguments as meta tensors:

    train:   {"batch": {tokens, labels, extras...}}
    prefill: {"batch": {tokens, extras...}}
    decode:  {"token": (B,), "pos": 0-dim, "caches": the cache tree}
    """
    spec = SHAPES[shape_name]
    b, s = spec["global_batch"], spec["seq_len"]
    if spec["kind"] == "train":
        batch = {"tokens": _meta((b, s), I32), "labels": _meta((b, s), I32)}
        batch.update(_frontend_extras(cfg, b))
        return {"batch": batch}
    if spec["kind"] == "prefill":
        batch = {"tokens": _meta((b, s), I32)}
        batch.update(_frontend_extras(cfg, b))
        return {"batch": batch}
    # decode: one new token against a seq_len-deep cache
    caches = M.init_decode_cache(cfg, b, s, dtype=BF16, quantize_kv=int8_kv,
                                 device="meta")
    return {"token": _meta((b,), I32), "pos": _meta((), I32),
            "caches": caches}
