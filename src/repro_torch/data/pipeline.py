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

A model with a modality frontend gets its stub embeddings too, as in the
reference: ``batch["frontend"]``, standard normal fp32 (B, frontend_tokens
or seq_len // 2, d_model), and text of ``seq_len - frontend_tokens``
tokens, or ``seq_len // 2`` for an encoder-decoder (``enc_dec``).
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
        """{"tokens", "labels"}: int32 (global_batch, text_len) on the CPU,
        the labels the tokens shifted by one; with a frontend also
        "frontend" (see the module's docstring)."""
        cfg = self.cfg
        gen = self.generator(step)
        text_len = _text_len(cfg)
        shape = (cfg.global_batch, text_len + 1)
        base = torch.randint(0, self.k, (cfg.global_batch, 1), generator=gen)
        steps = torch.arange(text_len + 1)[None, :]
        toks = (base + steps * self.shift) % self.k
        noise = torch.rand(shape, generator=gen) < 0.1
        rnd = torch.randint(0, self.k, shape, generator=gen)
        toks = torch.where(noise, rnd, toks).to(torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.frontend:
            batch["frontend"] = torch.randn(_frontend_shape(cfg),
                                            generator=gen)
        return batch


def _text_len(cfg: DataConfig) -> int:
    return cfg.seq_len // 2 if cfg.enc_dec else \
        cfg.seq_len - cfg.frontend_tokens


def _frontend_shape(cfg: DataConfig) -> tuple:
    return (cfg.global_batch, cfg.frontend_tokens or cfg.seq_len // 2,
            cfg.d_model)


def batch_specs(cfg: DataConfig) -> Dict[str, tuple]:
    """{name: (shape, dtype)} of a batch, without drawing one (the
    reference's ShapeDtypeStruct stand-ins)."""
    text = ((cfg.global_batch, _text_len(cfg)), torch.int32)
    out = {"tokens": text, "labels": text}
    if cfg.frontend:
        out["frontend"] = (_frontend_shape(cfg), torch.float32)
    return out


def make_batch(cfg: DataConfig, step: int) -> Dict[str, torch.Tensor]:
    return SyntheticLMData(cfg).batch(step)
