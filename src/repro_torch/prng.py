"""The reference's PRNG keys: Threefry-2x32, as ``jax.random`` computes it.

A key is a uint32 tensor of shape (2,). ``prng_key(seed)`` is
``jax.random.PRNGKey(seed)`` and ``fold_in(key, data)`` is
``jax.random.fold_in(key, data)``, bit for bit: the trainer advances its
``rng`` leaf with ``fold_in(rng, 0)`` every step, as the reference does.
``threefry2x32`` works on Python ints and on int64 tensors that hold uint32
values alike; ``fold_in`` takes the tensors, so a key folds on its own
device, a card's or the CPU's, by the same code.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of the count (x0, x1) under the key (k0, k1):
    20 rounds, a key injection after every 4."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device).to(torch.uint32)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``: the hash of
    the count (0, data) under ``key``, in int64 tensor ops on ``key``'s
    device (no host round trip on a card)."""
    k = key.to(torch.int64)
    y0, y1 = threefry2x32(k[0], k[1], 0, data & _MASK)
    return torch.stack([y0, y1]).to(torch.uint32)
