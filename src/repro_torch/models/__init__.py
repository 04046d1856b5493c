"""Backend model substrate: every LM family of the registry in PyTorch
(dense and MoE GQA decoders, MLA, the recurrent blocks, Whisper's
encoder-decoder, the image-patch frontend).

Pure-function style, as the reference: params are trees (dicts, lists and
tuples) of tensors, every forward is a function of (params, batch). The
decode step writes into its caches in place at a position held on the
device; over an int8 cache its attention core is the B8 kernel on the
card.
"""

from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig
from repro_torch.models.transformer import (
    forward_decode,
    forward_prefill,
    init_decode_cache,
    init_params,
    param_shapes,
)

__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "forward_decode",
           "forward_prefill", "init_decode_cache", "init_params",
           "param_shapes"]
