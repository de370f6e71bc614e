"""Carry parameters from the JAX reference to the port.

The reference draws its weights from ``jax.random``, which torch cannot
reproduce, so parity tests take the reference's own parameters through
numpy. Both packages keep one parameter tree (the same key paths and
shapes), so the conversion is one to one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device


def params_from_jax(tree, device=DEFAULT_DEVICE):
    """Nested dicts of numpy arrays (the reference's parameter tree, e.g.
    ``jax.tree.map(np.asarray, params)``) -> the same tree of tensors on
    ``device``."""
    dev = resolve_device(device)

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return convert(tree)
