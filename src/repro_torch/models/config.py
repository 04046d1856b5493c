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


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


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
