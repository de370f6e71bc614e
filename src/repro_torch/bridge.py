"""Carry parameters, train states and app states from the JAX reference to
the port.

The reference draws its weights and the paper apps' initial states from
``jax.random``, which torch cannot reproduce, so parity tests take the
reference's own parameters (or whole TrainState, or app state) through
numpy. Both packages keep one parameter tree (the same
key paths and shapes), so the conversion is one to one.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sharding import place
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.layers import tree_map


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


def state_from_jax(state, device=DEFAULT_DEVICE, shardings=None):
    """The reference's TrainState as numpy (``params``, ``opt`` with ``mu``,
    ``nu`` and ``step``, the ``rng`` key and ``step``; e.g.
    ``jax.tree.map(np.asarray, state)``) -> the port's TrainState on
    ``device``, or, given ``shardings`` (e.g. a trainer's
    ``_state_shardings(mesh)``), placed on their mesh."""
    opt = state["opt"]
    out = {"params": params_from_jax(state["params"], device),
           "opt": params_from_jax({"mu": opt["mu"], "nu": opt["nu"],
                                   "step": opt["step"]}, device),
           "rng": params_from_jax(state["rng"], device),
           "step": params_from_jax(state["step"], device)}
    if shardings is not None:
        out = tree_map(place, out, shardings)
    return out


def app_state_from_jax(app: str, state, device=DEFAULT_DEVICE):
    """A paper app's state from the reference as numpy (e.g.
    ``jax.tree.map(np.asarray, state)``) -> the port's on ``device``:
    ``"cg"`` takes the fields of a ``CGState`` (an object with ``x``,
    ``r``, ``p``, ``rs``, or a dict of them) to the port's ``CGState``;
    ``"jacobi"``, ``"nbody"`` and ``"fs"`` take their dicts."""
    if app in ("jacobi", "nbody", "fs"):
        return params_from_jax(dict(state), device)
    if app != "cg":
        raise ValueError(f"unknown app {app!r}")
    from repro_torch.apps.paper_apps import CGState
    fields = state if isinstance(state, dict) else vars(state)
    return CGState(**params_from_jax(
        {k: fields[k] for k in ("x", "r", "p", "rs")}, device))
