# Copy of src/repro/configs/zamba2_1p2b.py (pure data).
"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64; Mamba2 blocks + ONE shared attention block re-invoked every
6th position (weights shared, per-occurrence KV caches)
[arXiv:2411.15242; hf]."""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000, act="swiglu", norm="rms",
    tie_embeddings=True,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "mamba",
                   "attn_shared"),
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, chunk=256,
                  n_heads=16),
    subquadratic=True,
)
