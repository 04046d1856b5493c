"""whisper-base [audio] — encoder-decoder; conv frontend is a STUB
(input_specs provides precomputed frame embeddings at d_model).

6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865  [arXiv:2212.04356]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                  # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    encdec=True,
    n_encoder_layers=6,
    norm="layernorm",
    tie_embeddings=True,
    frontend="audio_frames",
    n_frontend_tokens=1500,      # 30s of audio at 50 Hz post-conv
    frontend_dim=512,
)


def smoke():
    return CONFIG.scaled(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                         d_ff=64, vocab_size=128, n_encoder_layers=2,
                         n_frontend_tokens=8, frontend_dim=32)
