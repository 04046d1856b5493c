"""Architecture configuration schema.

One frozen dataclass describes every supported family; repro_torch/configs/<id>.py
files instantiate it with the exact published numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int               # expert FFN hidden size
    n_shared: int = 0           # always-on shared experts (DeepSeek)
    dense_residual: bool = False  # dense FFN in parallel with MoE (Arctic)
    dense_d_ff: int = 0         # size of the parallel dense FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    n_dense_layers: int = 0     # leading layers that use a dense FFN instead
    # the router. "softmax": softmax over the experts, top-k, the k weights
    # renormalised, units past ``capacity_factor`` dropped (the reference's).
    # "sigmoid": DeepSeek-V3's (arXiv:2412.19437 §2.1.2), s = sigmoid(x W_r);
    # the experts chosen by s + b (b a correction bias) inside the
    # ``topk_group`` of ``n_group`` groups whose top-2 sums of s + b are
    # largest; weights s / sum(s) * ``routed_scale`` over the k chosen;
    # dropless (every token reaches its k experts; capacity_factor unread).
    scoring: str = "softmax"
    n_group: int = 1
    topk_group: int = 1
    routed_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class YarnConfig:
    """YaRN rotary scaling (arXiv:2309.00071), as DeepSeek-V3's config.json
    gives it under ``rope_scaling``: the frequencies of the dimensions that
    turn fewer than ``beta_slow`` times over ``original_max_position``
    positions are divided by ``factor``, those that turn more than
    ``beta_fast`` times are kept, a linear ramp between; the softmax scale
    is multiplied by ``mscale(factor, mscale_all_dim) ** 2`` (MLA's
    attention) and the rotary cos / sin by ``mscale(factor, mscale) /
    mscale(factor, mscale_all_dim)``, ``mscale(f, m) = 0.1 m ln f + 1``."""
    factor: float = 40.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """How a served model is held: its linear weights as ``weights`` in
    ``block`` x ``block`` blocks, each with a float32 scale (DeepSeek-V3's
    checkpoint: fp8 e4m3, 128 x 128, tech report §3.3), its activations in
    ``activations``. None on an ``ArchConfig``: float32 master weights."""
    weights: str = "float8_e4m3fn"
    block: int = 128
    activations: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None          # default d_model // n_heads

    # attention flavor
    attn_kind: str = "gqa"                # gqa | mla
    qk_norm: bool = False
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # SWA width (h2o-danube)
    local_window: Optional[int] = None    # local-attn width (recurrentgemma)
    rope_theta: float = 10000.0
    rope_scaling: Optional[YarnConfig] = None
    precision: Optional[PrecisionConfig] = None   # how it is served

    # mixture / latent configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mtp: bool = False                     # multi-token-prediction head (DSv3)

    # layer pattern, cycled across n_layers:
    #   'attn' | 'local_attn' | 'rglru' | 'mlstm' | 'slstm'
    block_pattern: Tuple[str, ...] = ("attn",)

    # encoder-decoder (whisper)
    encdec: bool = False
    n_encoder_layers: int = 0

    # modality frontend stub: None | 'audio_frames' | 'image_patches'
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0            # frames / patches per example
    frontend_dim: int = 0                 # raw embedding dim from the stub

    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    tie_embeddings: bool = False
    rglru_width: Optional[int] = None     # recurrent branch width
    conv1d_width: int = 4

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    @property
    def sub_quadratic(self) -> bool:
        """True if long-context decode (500k) is feasible: no unbounded
        full-attention KV growth."""
        kinds = set(self.block_pattern)
        if "attn" in kinds and self.sliding_window is None:
            return False
        return not self.encdec

    def scaled(self, *, n_layers=None, d_model=None, n_heads=None,
               n_kv_heads=None, d_ff=None, vocab_size=None, moe=None,
               **kw) -> "ArchConfig":
        """Reduced copy for smoke tests (same family/wiring, tiny sizes)."""
        return dataclasses.replace(
            self,
            n_layers=n_layers or self.n_layers,
            d_model=d_model or self.d_model,
            n_heads=n_heads or self.n_heads,
            n_kv_heads=n_kv_heads or self.n_kv_heads,
            d_ff=d_ff if d_ff is not None else self.d_ff,
            vocab_size=vocab_size or self.vocab_size,
            moe=moe if moe is not None else self.moe,
            d_head=kw.pop("d_head", None) or (
                None if self.d_head is None else max(8, self.d_head // 16)),
            **kw,
        )
