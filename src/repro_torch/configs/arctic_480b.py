"""arctic-480b [moe] — 128 experts top-2 + always-on dense residual branch.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000
[hf:Snowflake/snowflake-arctic-base]
"""

from repro_torch.models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, d_expert=4864,
                  dense_residual=True, dense_d_ff=4864,
                  capacity_factor=1.25),
)


def smoke():
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=96,
        vocab_size=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=48,
                      dense_residual=True, dense_d_ff=48,
                      capacity_factor=1.5),
    )
