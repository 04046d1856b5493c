"""qwen3-4b [dense] — GQA with qk-norm, decoupled head_dim=128.

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936  [hf:Qwen/Qwen3-*]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab_size=151936,
    d_head=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
)


def smoke():
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256, d_head=16)
