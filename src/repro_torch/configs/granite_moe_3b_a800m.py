# Copy of src/repro/configs/granite_moe_3b_a800m.py (pure data).
"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) expert
d_ff=512 vocab=49155, 40 experts top-8 [hf:ibm-granite; hf]."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155, act="swiglu", norm="rms",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512),
    block_pattern=("attn",), subquadratic=False,
)
