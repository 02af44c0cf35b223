"""Copy of ``src/repro/configs/registry.py`` (the port imports nothing of
``repro``); ``get_config`` imports ``repro_torch.configs.<arch>``.

Architecture registry: --arch <id> resolution + the shape-cell matrix.

Shapes (assigned, LM-family):
  train_4k     seq 4,096   global_batch 256   (training)
  prefill_32k  seq 32,768  global_batch 32    (inference prefill)
  decode_32k   seq 32,768  global_batch 128   (single-token decode step)
  long_500k    seq 524,288 global_batch 1     (long-context decode)

long_500k requires sub-quadratic attention: runs only for the
`subquadratic` archs (xlstm-1.3b, zamba2-1.2b); skipped for the 8 pure
full-attention archs (DESIGN.md §5).
"""
from __future__ import annotations

import dataclasses
import importlib

ARCH_IDS = (
    "gemma_2b",
    "phi4_mini_3p8b",
    "olmo_1b",
    "qwen1p5_110b",
    "xlstm_1p3b",
    "granite_moe_3b_a800m",
    "qwen3_moe_235b_a22b",
    "zamba2_1p2b",
    "musicgen_large",
    "paligemma_3b",
)

# external ids (--arch accepts either form)
ALIASES = {
    "gemma-2b": "gemma_2b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "olmo-1b": "olmo_1b",
    "qwen1.5-110b": "qwen1p5_110b",
    "xlstm-1.3b": "xlstm_1p3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "zamba2-1.2b": "zamba2_1p2b",
    "musicgen-large": "musicgen_large",
    "paligemma-3b": "paligemma_3b",
}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str):
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "p")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def cell_supported(cfg, shape_name: str) -> tuple[bool, str]:
    """Is (arch x shape) a runnable cell?  Returns (ok, reason)."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("long_500k needs sub-quadratic attention; "
                       f"{cfg.name} is pure full-attention (DESIGN.md §5)")
    return True, ""


def all_cells():
    """All 40 (arch, shape) cells with support flags."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES:
            ok, why = cell_supported(cfg, s)
            out.append((a, s, ok, why))
    return out
