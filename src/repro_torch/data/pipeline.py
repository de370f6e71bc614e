"""Synthetic token pipeline: deterministic, elastic.

Counterpart of ``repro.data.pipeline``: next-token batches from a seeded
stream with a learnable structure, so training losses descend. Each row
starts at a random base and steps by a fixed ``shift`` modulo ``k``
(``(base + t shift) mod k``), and 10% of the tokens are replaced by random
ones. ``k`` and ``shift`` are drawn by numpy exactly as the reference draws
them. Batches are a pure function of (seed, step), so after a resize every
slice can regenerate its shard without coordination. The random draws come
from a ``torch.Generator`` seeded from both and cannot equal
``jax.random``'s; tests that need the reference's batches feed them in.

Text only: modality frontends and encoder-decoder batches are not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    frontend: Optional[str] = None    # "patches" | "frames"
    frontend_tokens: int = 0
    d_model: int = 0
    enc_dec: bool = False


class SyntheticLMData:
    """Deterministic synthetic LM stream."""

    def __init__(self, cfg: DataConfig):
        if cfg.frontend or cfg.enc_dec:
            raise NotImplementedError(
                "frontend and encoder-decoder batches are not ported yet "
                "(ROADMAP.md, Queue 1, other model families: paligemma, "
                "seamless)")
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.k = min(cfg.vocab_size, 4093)
        self.shift = int(rng.integers(1, self.k))

    def generator(self, step: int) -> torch.Generator:
        """A CPU generator seeded from (seed, step) alone."""
        state = np.random.SeedSequence([self.cfg.seed, step]).generate_state(
            2, dtype=np.uint32)
        return torch.Generator().manual_seed(
            int(state[0]) << 32 | int(state[1]))

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """{"tokens", "labels"}: int32 (global_batch, seq_len) on the CPU;
        the labels are the tokens shifted by one."""
        cfg = self.cfg
        gen = self.generator(step)
        shape = (cfg.global_batch, cfg.seq_len + 1)
        base = torch.randint(0, self.k, (cfg.global_batch, 1), generator=gen)
        steps = torch.arange(cfg.seq_len + 1)[None, :]
        toks = (base + steps * self.shift) % self.k
        noise = torch.rand(shape, generator=gen) < 0.1
        rnd = torch.randint(0, self.k, shape, generator=gen)
        toks = torch.where(noise, rnd, toks).to(torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch(cfg: DataConfig, step: int) -> Dict[str, torch.Tensor]:
    return SyntheticLMData(cfg).batch(step)
