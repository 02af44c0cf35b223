# Copy of src/repro/configs/olmo_1b.py (pure data).
"""olmo-1b [dense]: 16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304,
non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=8192, vocab=50304, act="swiglu", norm="nonparametric",
    rope_theta=10000.0, tie_embeddings=True,
    block_pattern=("attn",), subquadratic=False,
)
