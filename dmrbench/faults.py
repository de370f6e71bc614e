"""Faults planted under the timed path, to show that the check sees them.

Each is a context manager that breaks the program's training step for its
length and mends it after:

- ``unchanged``: the step computes its loss but returns the state it was
  given;
- ``half``: the step sees the first half of the global batch only, the mean
  taken over those rows;
- ``exchange``: the slices' gradients are not summed: the update takes the
  first slice's alone (a cell on one slice has no exchange to leave out).

Training cells produce no tokens or answers besides their loss, which the
check compares itself. ``control.py`` reads the faults on the card at a
cell's own size; ``test_dmrbench_faults.py`` at a test size on the CPU.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


def unchanged():
    from repro_torch.runtime import ElasticTrainer
    step = ElasticTrainer.train_step

    def train_step(self, state, batch):
        _, metrics = step(self, state, batch)
        return state, metrics
    return _patched(ElasticTrainer, "train_step", train_step)


def half():
    from repro_torch.runtime import ElasticTrainer
    step = ElasticTrainer.train_step

    def train_step(self, state, batch):
        rows = batch["tokens"].shape[0] // 2
        return step(self, state, {k: v[:rows] for k, v in batch.items()})
    return _patched(ElasticTrainer, "train_step", train_step)


def exchange():
    import torch

    from repro_torch.models.layers import tree_map
    from repro_torch.runtime import trainer
    grads = trainer.slice_grads
    seen = {"first": None}

    def slice_grads(model, params, coords, *args, **kwargs):
        g = grads(model, params, coords, *args, **kwargs)
        first = seen["first"]
        if first is None or first == coords:
            seen["first"] = coords
            return g
        return tree_map(torch.zeros_like, g)
    return _patched(trainer, "slice_grads", slice_grads)


FAULTS = {"unchanged": unchanged, "half": half, "exchange": exchange}
