# Copy of src/repro/configs/xlstm_1p3b.py (pure data).
"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304,
sLSTM + mLSTM blocks (7:1 ratio) [arXiv:2405.04517; unverified]."""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab=50304, act="swiglu", norm="rms",
    tie_embeddings=True,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, chunk=256,
                  n_heads=4),
    subquadratic=True,
)
