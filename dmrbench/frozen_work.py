"""The yardstick's arithmetic: each kernel's operations and bytes, the card's
peaks, and the model FLOPs of a training step.

The kernel formulas are a frozen copy of ``src/repro_torch/kernels/work.py``
(``attention_pairs``, ``attention_work``, ``attention_bwd_work``,
``_chunk_lens``, ``ssd_work``, ``ssd_bwd_work``) and the peaks of
``src/repro_torch/roofline/hardware.py``, both as of commit 8108f17. They are
copied, not imported, so that a change to the program cannot move the
benchmark's yardstick; ``test_dmrbench_work.py`` holds the copy against the
program's module at the cells' shapes.

``step_flops`` is the model FLOPs of one training step: 6 x (the matrix
products' parameters, the tied unembedding included) x tokens, plus the
sequence mixer's own operations (causal attention, or the SSD scan), forward
and backward (3 x the forward's), with no recompute counted.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM5 data sheet, dense, at its full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def attention_pairs(sq: int, sk: int, causal: bool = True, window=None) -> int:
    """(query, key) pairs the mask lets through, queries right-aligned to
    the keys, counted row by row."""
    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_work(b, h, kv, sq, sk, d, itemsize, causal=True, window=None):
    """q, k, v read and o written once, against 4 D flops a pair."""
    flops = 4.0 * b * h * d * attention_pairs(sq, sk, causal, window)
    nbytes = itemsize * (2 * b * h * sq * d + 2 * b * kv * sk * d)
    return flops, nbytes


def attention_bwd_work(b, h, kv, sq, sk, d, itemsize, causal=True,
                       window=None):
    """q, k, v, o, do and the fp32 lse read and dq, dk, dv written once,
    against five products of 2 D flops a pair."""
    fwd_flops, _ = attention_work(b, h, kv, sq, sk, d, itemsize, causal,
                                  window)
    nbytes = (itemsize * (4 * b * h * sq * d + 4 * b * kv * sk * d)
              + 4 * b * h * sq)
    return 2.5 * fwd_flops, nbytes


def _chunk_lens(s: int, chunk: int):
    q = min(chunk, s, 128)
    return [min(q, s - s0) for s0 in range(0, s, q)]


def ssd_work(b, s, h, p, n, chunk, itemsize):
    """The chunked SSD algorithm's products at their least; x, B, C, dt and
    a_log read and y and the final state written once."""
    lens = _chunk_lens(s, chunk)
    tri = sum(L * (L + 1) // 2 for L in lens)
    flops = 2.0 * b * n * tri
    flops += 2.0 * b * h * p * tri
    flops += 2.0 * b * h * p * n * sum(lens[1:])
    flops += 2.0 * b * h * p * n * s
    nbytes = (itemsize * (2 * b * s * h * p + 2 * b * s * n)
              + 4 * (b * s * h + h + b * h * p * n))
    return flops, nbytes


def ssd_bwd_work(b, s, h, p, n, chunk, itemsize):
    """The chunked algorithm's backward products at their least."""
    lens = _chunk_lens(s, chunk)
    tri = sum(L * (L + 1) // 2 for L in lens)
    flops = 2.0 * b * n * tri
    flops += 2.0 * 2 * b * h * p * tri
    flops += 2.0 * 2 * b * h * n * tri
    flops += 2.0 * 3 * b * h * p * n * s
    flops += 2.0 * b * h * p * n * sum(lens[1:])
    nbytes = (itemsize * (3 * b * s * h * p + 4 * b * s * n)
              + 4 * (2 * b * s * h + 2 * h))
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the bf16 peak or
    bytes at the memory rate, whichever is longer."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def matmul_params(m: dict) -> int:
    """The parameters that enter a matrix product once a token, by the
    model's config ``m`` (the port's ModelConfig fields): the projections of
    every layer and the tied unembedding (the embedding's gather is not a
    product)."""
    d, layers, vocab = m["d_model"], m["num_layers"], m["vocab_size"]
    if m["family"] == "dense":
        hd = m["head_dim"] or d // m["num_heads"]
        attn = d * hd * (2 * m["num_heads"] + 2 * m["num_kv_heads"])
        per_layer = attn + 3 * d * m["d_ff"]
    elif m["family"] == "ssm":
        di = m["ssm_expand"] * d
        heads = di // m["ssm_head_dim"]
        per_layer = d * (2 * di + 2 * m["ssm_state"] + heads) + di * d
    else:
        raise ValueError(f"no FLOP count for family {m['family']!r}")
    return layers * per_layer + vocab * d


def mixer_flops(m: dict, batch: int, seq: int) -> float:
    """The sequence mixer's forward operations over ``batch`` rows of
    ``seq`` tokens, every layer: causal attention's 4 D a (query, key) pair
    and head, or the SSD scan's (``ssd_work``)."""
    d, layers = m["d_model"], m["num_layers"]
    if m["family"] == "dense":
        hd = m["head_dim"] or d // m["num_heads"]
        flops, _ = attention_work(batch, m["num_heads"], m["num_kv_heads"],
                                  seq, seq, hd, 2)
    else:
        di = m["ssm_expand"] * d
        heads = di // m["ssm_head_dim"]
        flops, _ = ssd_work(batch, seq, heads, m["ssm_head_dim"],
                            m["ssm_state"], m["ssd_chunk"], 2)
    return layers * flops


def step_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on ``batch`` x ``seq`` tokens:
    forward and backward, 3 x the forward's 2 x params x tokens and its
    mixer operations; a recompute is not counted."""
    return 3.0 * (2.0 * matmul_params(m) * batch * seq
                  + mixer_flops(m, batch, seq))
