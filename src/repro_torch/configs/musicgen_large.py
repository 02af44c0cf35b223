# Copy of src/repro/configs/musicgen_large.py (pure data).
"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048; decoder-only over EnCodec tokens.  Frontend (EnCodec) is a
STUB: inputs are precomputed frame embeddings (B,S,D)
[arXiv:2306.05284; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, act="gelu", norm="rms",
    tie_embeddings=False, frontend="audio_stub",
    block_pattern=("attn",), subquadratic=False,
)
