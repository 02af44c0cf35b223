"""Zero-shot greedy placement (counterpart of ``repro/core/zero_shot.py``).

The reference re-implements the greedy episode in float32 numpy so that a
placement server's cache miss pays no XLA compile for a new graph shape.
The port has no compile step, so its miss path runs the policy where the
server lives, on the card by default: the graph is encoded once (the
``gnn_mp`` pair, one launch a GNN layer) and ``assign.rollout_batch``
takes one greedy episode (SEL argmax, PLC argmax, the ETF dynamics),
drawing nothing.

The reference's ``plc_logits_np`` has its counterpart in
``core/policies.py``'s ``plc_logits``, which the rollout calls; it is not
duplicated here.
"""
from __future__ import annotations

import numpy as np
import torch

from .assign import build_graph_data, encode, rollout_batch
from .device import resolve_device
from .devices import DeviceModel, uniform_box
from .features import COMM_FACTOR_DEFAULT
from .graph import DataflowGraph
from ..models.convert import params_from_numpy, params_to_numpy


def to_numpy_params(params) -> dict:
    """The reference's name for ``convert.params_to_numpy`` as float32:
    torch (any device) or numpy leaves -> float32 numpy leaves."""
    return params_to_numpy(params, np.float32)


def _on(params, device: torch.device) -> dict:
    return params_from_numpy(params, device, torch.float32)


def _backend(device: torch.device) -> str:
    """The encoder's backend on ``device``: the kernel on the card."""
    return "cuda" if device.type == "cuda" else "torch"


def encode_graph(params, g: DataflowGraph,
                 comm_factor: float = COMM_FACTOR_DEFAULT,
                 device: str | torch.device = "cuda"):
    """Once-per-graph encodings ``(H, sel_logits, z_plc)`` on ``device``:
    ``assign.encode`` (the ``gnn_mp`` pair on the card).  They do not
    depend on the fleet, so the graph's data is built for one device."""
    device = resolve_device(device)
    gd = build_graph_data(g, uniform_box(1), comm_factor, device)
    return encode(_on(params, device), gd, _backend(device))


def greedy_place(params, g: DataflowGraph, dev: DeviceModel,
                 comm_factor: float = COMM_FACTOR_DEFAULT,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """One greedy episode of the pretrained dual policy on an unseen
    graph x fleet, the zero-shot serving rollout: ``rollout_batch`` at
    K = 1, ``greedy=True``, on ``device``.  ``params`` may hold torch or
    numpy leaves.  Returns the (n,) assignment."""
    device = resolve_device(device)
    gd = build_graph_data(g, dev, comm_factor, device)
    out = rollout_batch(_on(params, device), gd, 1, greedy=True,
                        encoder_backend=_backend(device))
    return out["assignment"][0].cpu().numpy()
