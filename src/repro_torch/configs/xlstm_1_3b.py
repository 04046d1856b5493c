"""xlstm-1.3b [ssm] — mLSTM + sLSTM blocks, 7:1 ratio (xLSTM[7:1]).

48L d_model=2048 4H d_ff=0 (blocks carry their own projections)
vocab=50304  [arXiv:2405.04517]
"""

from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    tie_embeddings=True,
)


def smoke():
    return CONFIG.scaled(
        n_layers=4, d_model=32, n_heads=2, n_kv_heads=2, d_ff=0,
        vocab_size=128, block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
    )
