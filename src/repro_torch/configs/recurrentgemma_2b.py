"""recurrentgemma-2b [hybrid] — Griffin: RG-LRU + local attention, 2:1.

26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000,
local window 2048  [arXiv:2402.19427]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    d_head=256,
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    rglru_width=2560,
    conv1d_width=4,
    tie_embeddings=True,
)


def smoke():
    return CONFIG.scaled(n_layers=6, d_model=64, n_heads=2, n_kv_heads=1,
                         d_ff=96, vocab_size=256, d_head=32,
                         local_window=16, rglru_width=64)
