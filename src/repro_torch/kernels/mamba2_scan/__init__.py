"""Mamba2 / SSD chunked gated-linear-attention scan."""
