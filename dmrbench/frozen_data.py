"""The benchmark's token stream: a frozen copy of
``src/repro_torch/data/pipeline.py::SyntheticLMData`` (commit 8108f17), text
only.

Next-token batches from a seeded stream with a learnable structure: each row
starts at a random base and steps by a fixed ``shift`` modulo ``k``, and 10%
of the tokens are replaced by random ones, so every row of a batch differs.
A batch is a pure function of (seed, step). The harness makes every batch
from ``--seed`` here and hands it to the program's trainer and to the
reference alike.
"""
from __future__ import annotations

import numpy as np
import torch


class SyntheticLMData:
    """Deterministic synthetic LM stream of ``batch`` rows of ``seq_len``
    tokens over ``vocab_size``, from ``seed``."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int, seed: int):
        self.seq_len, self.rows, self.seed = seq_len, batch, int(seed)
        rng = np.random.default_rng(self.seed)
        self.k = min(vocab_size, 4093)
        self.shift = int(rng.integers(1, self.k))

    def generator(self, step: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, step]).generate_state(
            2, dtype=np.uint32)
        return torch.Generator().manual_seed(
            int(state[0]) << 32 | int(state[1]))

    def batch(self, step: int) -> dict:
        """{"tokens", "labels"}: int32 (rows, seq_len) on the CPU, the labels
        the tokens shifted by one."""
        gen = self.generator(step)
        shape = (self.rows, self.seq_len + 1)
        base = torch.randint(0, self.k, (self.rows, 1), generator=gen)
        steps = torch.arange(self.seq_len + 1)[None, :]
        toks = (base + steps * self.shift) % self.k
        noise = torch.rand(shape, generator=gen) < 0.1
        rnd = torch.randint(0, self.k, shape, generator=gen)
        toks = torch.where(noise, rnd, toks).to(torch.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
