"""LM serving: batched prefill, then a greedy decode loop (twin of
``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_1p2b \\
        --batch 4 --prompt-len 2048 --gen 32          # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_1p2b \\
        --reduced --device cpu                        # a smoke run on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_1p3b \\
        --batch 4 --prompt-len 2048 --gen 32          # xLSTM on the GPU
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite_moe_3b_a800m --batch 4 --prompt-len 2048 --gen 32

Every config of the registry serves: the MoE configs (granite_moe_3b_a800m,
qwen3_moe_235b_a22b: 94 layers do not fit one card, ``--layers`` cuts the
depth), the audio stub (musicgen_large: the prompt and each decode step
are random frame embeddings, fresh each step, as in the reference) and the
vision stub (paligemma_3b: ``n_patches`` random patch embeddings in front
of the prompt's tokens; the KV cache holds n_patches + prompt + gen
positions).

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


def _embeddings(gen: torch.Generator, *shape) -> torch.Tensor:
    """Stub embeddings, as the reference draws them: N(0, 1) x 0.02 in
    bf16."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * 0.02).to(torch.bfloat16)


def prompt_inputs(cfg: ModelConfig, batch: int, prompt_len: int, gen: int,
                  seed: int, device: str | torch.device = "cuda"):
    """A random request for ``cfg``'s frontend -> (prompt, step_inputs).
    ``prompt``: the prefill's batch dict: ``tokens`` (``prompt_tokens``),
    with ``patches`` (B, n_patches, D) for the vision stub, or the audio
    stub's ``frames`` (B, prompt_len, D).  ``step_inputs``: None, where a
    decode step is fed the greedy token, or for the audio stub ``frames``
    (B, gen - 1, D), one column a timed decode step."""
    device = resolve_device(device)
    g = torch.Generator(device).manual_seed(seed + 2)
    D = cfg.d_model
    if cfg.frontend == "audio_stub":
        return ({"frames": _embeddings(g, batch, prompt_len, D)},
                {"frames": _embeddings(g, batch, max(gen - 1, 0), D)})
    prompt = {"tokens": prompt_tokens(cfg, batch, prompt_len, seed, device)}
    if cfg.frontend == "vision_stub":
        prompt["patches"] = _embeddings(g, batch, cfg.n_patches, D)
    return prompt, None


def prompt_positions(prompt: dict) -> int:
    """Positions a prefill of ``prompt`` fills: the frames, or the
    tokens after any patches."""
    if "frames" in prompt:
        return prompt["frames"].shape[1]
    n = prompt["tokens"].shape[1]
    return n + (prompt["patches"].shape[1] if "patches" in prompt else 0)


def generate(params, cfg: ModelConfig, prompt, gen: int,
             attn_backend: str | None = None,
             ssm_backend: str | None = None,
             step_inputs: dict | None = None) -> ServeResult:
    """Prefill ``prompt`` (a batch dict from ``prompt_inputs``, or token
    ids (B, S)), then ``gen - 1`` greedy decode steps, step i fed the
    last greedy token, or column i of each of ``step_inputs`` (the audio
    stub's frames).  The KV caches hold the prompt's positions (patches
    included) + ``gen``, and decode positions follow the prompt's.  One
    warm-up decode step runs outside the timed loop; it writes the same K
    and V at the same position as the first timed step, and its SSD
    states are dropped."""
    if isinstance(prompt, torch.Tensor):
        prompt = {"tokens": prompt}
    if cfg.frontend == "audio_stub" and step_inputs is None:
        raise ValueError("the audio stub's decode steps need step_inputs "
                         "(frames)")
    first = next(iter(prompt.values()))
    B, dev = first.shape[0], first.device
    S = prompt_positions(prompt)
    state = init_decode_state(cfg, B, S + gen, device=dev)
    prefill = make_prefill_step(cfg, S + gen, attn_backend, ssm_backend)
    decode = make_decode_step(cfg, attn_backend, ssm_backend)

    def fed(i, tok):
        if step_inputs is None:
            return {"tokens": tok}
        return {k: v[:, i:i + 1] for k, v in step_inputs.items()}

    with torch.inference_mode():
        sync(dev)
        t0 = time.perf_counter()
        logits, state = prefill(params, prompt, state)
        tok = logits.argmax(-1)[:, None]
        sync(dev)
        prefill_s = time.perf_counter() - t0
        decode(params, fed(0, tok), state, S)             # warm-up
        toks, all_logits = [tok], [logits]
        sync(dev)
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, state = decode(params, fed(i, tok), state, S + i)
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
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    params = load_model(cfg, args.seed, device)
    prompt, step_inputs = prompt_inputs(cfg, args.batch, args.prompt_len,
                                        args.gen, args.seed, device)
    res = generate(params, cfg, prompt, args.gen, step_inputs=step_inputs)
    steps = args.gen - 1
    positions = prompt_positions(prompt)
    print(f"{cfg.name} on {device}: batch {args.batch}, prompt "
          f"{args.prompt_len} ({positions} positions), gen {args.gen}, "
          f"cache {positions + args.gen}")
    print(f"prefill_s={res.prefill_s:.6f} prefill_tokens_per_s="
          f"{args.batch * positions / res.prefill_s:.1f}")
    print(f"{steps} decode steps x {args.batch} seqs: decode_ms_per_step="
          f"{res.decode_ms_per_step:.4f} decode_tokens_per_s="
          f"{args.batch * steps / max(res.decode_s, 1e-12):.1f}")
    return res


if __name__ == "__main__":
    main()
