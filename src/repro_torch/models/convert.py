"""Reference parameters carried across: a JAX parameter pytree as numpy
leaves <-> the port's parameters, for the policies of the placement slice
and for the model substrate alike; and the AdamW state (count and
moments) beside them, so that both packages can resume one run.

The port keeps the reference's layout (nested dicts and lists; ``unit``
leaves stacked on axis 0; ``None`` where an ``attn_shared`` position has
no weights of its own) and each leaf's dtype, so the round trip is
bit-equal.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.nn import tree_map
from ..train.optim import AdamState


def _host(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def params_from_numpy(tree, device: str | torch.device = "cpu",
                      dtype: torch.dtype | None = None):
    """Numpy leaves (e.g. ``jax.tree_util.tree_map(np.asarray, params)``)
    or torch leaves -> torch tensors on ``device``, in the same nesting;
    ``dtype`` casts every leaf.  Numpy leaves are copied; a torch leaf
    already on ``device`` in ``dtype`` is kept as it is."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, dtype)
        return torch.from_numpy(np.array(x, copy=True)).to(device, dtype)
    return tree_map(leaf, tree)


def params_to_numpy(params, dtype=None):
    """The inverse of ``params_from_numpy``: numpy leaves on the host,
    from torch or numpy leaves; ``dtype`` (numpy) casts every leaf."""
    return tree_map(lambda x: _host(x, dtype), params)


def adam_state_from_numpy(state, device: str | torch.device = "cpu"
                          ) -> AdamState:
    """The reference's ``AdamState`` as numpy leaves (its int32 ``step``
    scalar, its ``mu`` and ``nu`` trees; e.g. ``jax.tree_util.tree_map(
    np.asarray, opt_state)``) -> the port's, the moments on ``device``."""
    step, mu, nu = state
    return AdamState(int(np.asarray(step)), params_from_numpy(mu, device),
                     params_from_numpy(nu, device))


def adam_state_to_numpy(state: AdamState) -> tuple:
    """The inverse: (int32 step, mu, nu) as numpy leaves, the reference's
    ``AdamState`` fields in order."""
    return (np.asarray(int(state.step), np.int32),
            params_to_numpy(state.mu), params_to_numpy(state.nu))
