"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8 experts, MTP.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280  [arXiv:2412.19437; hf
config.json]. First 3 layers use a dense FFN (18432, the published dense
intermediate size); the remaining 58 are MoE with 2048-wide experts.

CONFIG holds the published settings: the sigmoid router with its
correction bias, 8 groups of which the top 4 are searched, top-8,
normalised weights times 2.5, dropless; YaRN (factor 40 over 4096
positions, beta 32 / 1, mscale 1 / 1); and the served precision, fp8 e4m3
linear weights in 128 x 128 blocks with bf16 activations.

The JAX package's model of this id has a softmax router with capacity
drops, plain RoPE and float32 weights. ``smoke()`` keeps those settings,
so the parity tests hold the port to the JAX package; ``reference_settings``
turns any config of this id back to them.
"""

import dataclasses

from repro_torch.models.config import (ArchConfig, MLAConfig, MoEConfig,
                                       PrecisionConfig, YarnConfig)

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                      # dense-prefix FFN width
    vocab_size=129280,
    attn_kind="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  n_dense_layers=3, capacity_factor=1.25,
                  scoring="sigmoid", n_group=8, topk_group=4,
                  routed_scale=2.5),
    mtp=True,
    rope_theta=10000.0,
    rope_scaling=YarnConfig(factor=40.0, original_max_position=4096,
                            beta_fast=32.0, beta_slow=1.0, mscale=1.0,
                            mscale_all_dim=1.0),
    precision=PrecisionConfig(weights="float8_e4m3fn", block=128,
                              activations="bfloat16"),
)


def reference_settings(cfg: ArchConfig) -> ArchConfig:
    """``cfg`` with the JAX package's settings where the published ones
    differ: a softmax router with capacity drops, plain RoPE, float32."""
    return dataclasses.replace(
        cfg, rope_scaling=None, precision=None,
        moe=dataclasses.replace(cfg.moe, scoring="softmax", n_group=1,
                                topk_group=1, routed_scale=1.0))


def smoke():
    return reference_settings(CONFIG.scaled(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=32, n_shared=1,
                      n_dense_layers=1, capacity_factor=1.5),
    ))
