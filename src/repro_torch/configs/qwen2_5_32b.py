"""qwen2.5-32b [dense] — GQA with QKV bias.

64L d_model=5120 40H (GQA kv=8) d_ff=27648 vocab=152064  [hf:Qwen/Qwen2.5-*]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)


def smoke():
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                         d_ff=128, vocab_size=256)
