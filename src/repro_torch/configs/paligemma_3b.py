# Copy of src/repro/configs/paligemma_3b.py (pure data).
"""paligemma-3b [vlm]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216; SigLIP + gemma backbone.  Vision frontend is a STUB: inputs
include precomputed patch embeddings (B,P,D) [arXiv:2407.07726; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=257216, act="geglu", norm="rms",
    tie_embeddings=True, frontend="vision_stub", n_patches=256,
    block_pattern=("attn",), subquadratic=False,
)
