"""Causal flash attention: online softmax over KV tiles (GQA-aware)."""
