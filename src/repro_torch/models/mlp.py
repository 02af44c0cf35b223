"""Feed-forward layers (twin of ``repro/models/mlp.py``): the dense FFN.

The token-choice MoE of the reference (granite, qwen3-moe) is the next
part of the model substrate to port (ROADMAP A11.2); until then
``models/transformer.py`` raises ``NotImplementedError`` for an MoE
config.
"""
from __future__ import annotations

import torch

from .common import dense_init, gated_act, gelu


def init_dense_ffn(gen: torch.Generator, d_model: int, d_ff: int, act: str,
                   dtype=torch.float32) -> dict:
    if act in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, d_model, d_ff, dtype),
                "w_up": dense_init(gen, d_model, d_ff, dtype),
                "w_down": dense_init(gen, d_ff, d_model, dtype)}
    return {"w_up": dense_init(gen, d_model, d_ff, dtype),
            "w_down": dense_init(gen, d_ff, d_model, dtype)}


def dense_ffn(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if "w_gate" in params:
        h = gated_act(act, x @ params["w_gate"], x @ params["w_up"])
    else:
        h = gelu(x @ params["w_up"])
    return h @ params["w_down"]
