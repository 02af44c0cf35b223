# Copy of src/repro/configs/gemma_2b.py (pure data).
"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256 [arXiv:2403.08295; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, act="geglu", norm="rms",
    rope_theta=10000.0, tie_embeddings=True,
    block_pattern=("attn",), subquadratic=False,
)
