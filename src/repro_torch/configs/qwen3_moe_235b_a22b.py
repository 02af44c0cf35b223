# Copy of src/repro/configs/qwen3_moe_235b_a22b.py (pure data).
"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936, 128 experts top-8 [hf:Qwen/Qwen3-*; hf]."""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936, act="swiglu", norm="rms",
    rope_theta=1000000.0, tie_embeddings=False,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
    block_pattern=("attn",), subquadratic=False,
)
