"""LM serving: batched prefill, then a greedy decode loop (twin of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_1p2b \\
        --batch 4 --prompt-len 2048 --gen 32          # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_1p2b \\
        --reduced --device cpu                        # a smoke run on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_1p3b \\
        --batch 4 --prompt-len 2048 --gen 32          # xLSTM on the GPU

Weights are random, drawn by torch from ``--seed`` at the config's width,
and cast once to the compute dtype.  The device defaults to ``cuda``;
without a GPU that raises.  Prefill runs the ``flash_attention`` and
``mamba2_scan`` kernels on the card (the latter for Mamba2 and mLSTM
blocks).  Prints prefill seconds, decode ms per step and tokens per
second, each after a device sync.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs.registry import get_config
from ..core.device import resolve_device, sync
from ..models.config import ModelConfig
from ..models.steps import make_decode_step, make_prefill_step
from ..models.transformer import (cast_params, init_decode_state,
                                  init_params)


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor    # (B, gen) greedy tokens, the first from prefill
    logits: list            # (B, vocab) logits that chose each token
    prefill_s: float
    decode_s: float         # the gen - 1 timed decode steps

    @property
    def decode_ms_per_step(self) -> float:
        return self.decode_s / max(len(self.logits) - 1, 1) * 1e3


def load_model(cfg: ModelConfig, seed: int = 0,
               device: str | torch.device = "cuda") -> dict:
    """Random parameters from ``seed`` on ``device``, cast once to the
    compute dtype."""
    return cast_params(init_params(cfg, seed, resolve_device(device)), cfg)


def prompt_tokens(cfg: ModelConfig, batch: int, prompt_len: int, seed: int,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    gen = torch.Generator(resolve_device(device)).manual_seed(seed + 1)
    return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                         device=gen.device)


def generate(params, cfg: ModelConfig, prompt: torch.Tensor, gen: int,
             attn_backend: str | None = None,
             ssm_backend: str | None = None) -> ServeResult:
    """Prefill ``prompt`` (B, S), then ``gen - 1`` greedy decode steps.
    One warm-up decode step runs outside the timed loop; it writes the
    same K and V at the same position as the first timed step, and its
    SSD states are dropped."""
    B, S = prompt.shape
    dev = prompt.device
    state = init_decode_state(cfg, B, S + gen, device=dev)
    prefill = make_prefill_step(cfg, S + gen, attn_backend, ssm_backend)
    decode = make_decode_step(cfg, attn_backend, ssm_backend)
    with torch.inference_mode():
        sync(dev)
        t0 = time.perf_counter()
        logits, state = prefill(params, {"tokens": prompt}, state)
        tok = logits.argmax(-1)[:, None]
        sync(dev)
        prefill_s = time.perf_counter() - t0
        decode(params, {"tokens": tok}, state, S)          # warm-up
        toks, all_logits = [tok], [logits]
        sync(dev)
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, state = decode(params, {"tokens": tok}, state, S + i)
            tok = logits.argmax(-1)[:, None]
            toks.append(tok)
            all_logits.append(logits)
        sync(dev)
        decode_s = time.perf_counter() - t0
    return ServeResult(torch.cat(toks, dim=1), all_logits, prefill_s,
                       decode_s)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = load_model(cfg, args.seed, device)
    prompt = prompt_tokens(cfg, args.batch, args.prompt_len, args.seed,
                           device)
    res = generate(params, cfg, prompt, args.gen)
    steps = args.gen - 1
    print(f"{cfg.name} on {device}: batch {args.batch}, prompt "
          f"{args.prompt_len}, gen {args.gen}")
    print(f"prefill_s={res.prefill_s:.6f} prefill_tokens_per_s="
          f"{args.batch * args.prompt_len / res.prefill_s:.1f}")
    print(f"{steps} decode steps x {args.batch} seqs: decode_ms_per_step="
          f"{res.decode_ms_per_step:.4f} decode_tokens_per_s="
          f"{args.batch * steps / max(res.decode_s, 1e-12):.1f}")
    return res


if __name__ == "__main__":
    main()
