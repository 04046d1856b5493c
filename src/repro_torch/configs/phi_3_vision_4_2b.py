"""phi-3-vision-4.2b [vlm] — phi3-mini decoder + CLIP patch frontend STUB
(input_specs provides precomputed patch embeddings, CLIP-L/14 width 1024).

32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    frontend="image_patches",
    n_frontend_tokens=576,       # 336px / 14 patch = 24x24
    frontend_dim=1024,           # CLIP-L/14 hidden
)


def smoke():
    return CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                         d_ff=128, vocab_size=256, n_frontend_tokens=4,
                         frontend_dim=32)
