"""Reference parameters carried across: a JAX parameter pytree as numpy
leaves <-> the port's parameters, for the policies of the placement slice
and for the model substrate alike.

The port keeps the reference's layout (nested dicts and lists; ``unit``
leaves stacked on axis 0; ``None`` where an ``attn_shared`` position has
no weights of its own) and each leaf's dtype, so the round trip is
bit-equal.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.nn import tree_map


def params_from_numpy(tree, device: str | torch.device = "cpu"):
    """Numpy leaves (e.g. ``jax.tree_util.tree_map(np.asarray, params)``)
    -> torch tensors on ``device``, in the same nesting."""
    return tree_map(lambda x: torch.from_numpy(np.array(x, copy=True))
                    .to(device), tree)


def params_to_numpy(params):
    """The inverse of ``params_from_numpy``: numpy leaves on the host."""
    return tree_map(lambda x: x.detach().cpu().numpy(), params)
