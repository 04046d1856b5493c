"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8 experts, MTP.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280  [arXiv:2412.19437; hf]
First 3 layers use a dense FFN (18432, the published dense intermediate
size); remaining 58 are MoE with 2048-wide experts.
"""

from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig

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
                  n_dense_layers=3, capacity_factor=1.25),
    mtp=True,
    rope_theta=10000.0,
)


def smoke():
    return CONFIG.scaled(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96,
        vocab_size=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=32, n_shared=1,
                      n_dense_layers=1, capacity_factor=1.5),
    )
