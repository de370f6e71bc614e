"""The work each kernel's function does: the operations of its algorithm
at their least and the bytes it must move (each input read once, each
output written once). ``kernels/bench.py`` turns them into a kernel's bound
against the H100's rates (``roofline/hardware.py``); the kernels' torch ops
register the operations as their FLOP formulas (``torch.utils.
flop_counter``), and the dry-run's count (``roofline/count.py``) charges a
kernel op the bytes counted here rather than its tensors' sizes.

Each function returns ``(flops, nbytes)``. ``KERNEL_WORK`` maps each
kernel op (an ``OpOverloadPacket`` of the ``repro_torch`` namespace) to a
function of the op's arguments that returns the same pair, and
``KERNEL_IMPL`` to the op's implementation (the wrapper call, which on meta
tensors allocates what the card's call allocates and launches nothing); the
ops' modules fill both in (``register``) when they define the ops.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
from torch.utils.flop_counter import register_flop_formula

KERNEL_WORK: Dict[object, Callable] = {}
KERNEL_IMPL: Dict[object, Callable] = {}


def register(op, count: Callable, impl: Callable) -> None:
    """Record ``count`` (the op's arguments -> (flops, nbytes)) as the
    work of the kernel op ``op`` and its flops as the op's FLOP formula,
    and ``impl`` as its implementation."""
    KERNEL_WORK[op] = count
    KERNEL_IMPL[op] = impl
    register_flop_formula(op, get_raw=True)(
        lambda *args, out_val=None, **kw: count(*args, **kw)[0])


def attention_pairs(sq: int, sk: int, causal: bool = True,
                    window: Optional[int] = None) -> int:
    """(query, key) pairs the mask lets through, queries right-aligned to
    the keys (query i at position i + Sk - Sq), as ``attention_ref``: a
    key at most ``window - 1`` positions back and, when causal, none
    ahead. Counted row by row."""
    qpos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(qpos - window + 1, 0) if window is not None
          else np.zeros(sq, np.int64))
    return int(np.clip(hi - lo + 1, 0, None).sum())


def attention_work(b, h, kv, sq, sk, d, itemsize, causal=True,
                   window=None):
    """q, k, v read and o written once, against 4 D flops for each
    (query, key) pair the mask lets through."""
    flops = 4.0 * b * h * d * attention_pairs(sq, sk, causal, window)
    nbytes = itemsize * (2 * b * h * sq * d + 2 * b * kv * sk * d)
    return flops, nbytes


def softcap_ops(b, h, sq, sk, causal=True, window=None, backward=False):
    """fp32 operations of a softcap ``c tanh(s / c)`` over the scores the
    mask lets through: a divide, a tanh and a multiply for each (query, key)
    pair and head; the backward recomputes them and multiplies dP by the
    cap's derivative ``1 - tanh^2`` (two more). They run on the CUDA
    cores beside the products, so they are kept out of the FLOPs of
    ``attention_work`` (the tensor cores' products, the kernel op's FLOP
    formula) and bound a call on their own (``bench.capped``)."""
    return float((5 if backward else 3) * b * h
                 * attention_pairs(sq, sk, causal, window))


def attention_bwd_work(b, h, kv, sq, sk, d, itemsize, causal=True,
                       window=None):
    """q, k, v, o, do and the fp32 lse read and dq, dk, dv written once,
    against five products of 2 D flops (Q K^T, dO V^T, P^T dO, dS^T Q,
    dS K) for each (query, key) pair the mask lets through."""
    fwd_flops, _ = attention_work(b, h, kv, sq, sk, d, itemsize, causal,
                                  window)
    nbytes = (itemsize * (4 * b * h * sq * d + 4 * b * kv * sk * d)
              + 4 * b * h * sq)
    return 2.5 * fwd_flops, nbytes


def _chunk_lens(s: int, chunk: int):
    q = min(chunk, s, 128)
    return [min(q, s - s0) for s0 in range(0, s, q)]


def ssd_work(b, s, h, p, n, chunk, itemsize):
    """x, B, C, dt and a_log read and y and the final state written once,
    against the products of the chunked algorithm at its least: C B^T once
    per (batch, chunk), as B and C are shared by the heads, on the lower
    triangle only, as are the intra-chunk products; the carried-state term
    from the second chunk on (the first one's state is zero); the state
    update. Chunks of ``min(chunk, S, 128)`` rows, as the kernel's."""
    lens = _chunk_lens(s, chunk)
    tri = sum(L * (L + 1) // 2 for L in lens)
    flops = 2.0 * b * n * tri                        # C B^T
    flops += 2.0 * b * h * p * tri                   # (G) (x dt)
    flops += 2.0 * b * h * p * n * sum(lens[1:])     # C h
    flops += 2.0 * b * h * p * n * s                 # B^T (x dt rem)
    nbytes = (itemsize * (2 * b * s * h * p + 2 * b * s * n)
              + 4 * (b * s * h + h + b * h * p * n))
    return flops, nbytes


def ssd_bwd_work(b, s, h, p, n, chunk, itemsize):
    """x, dy, B, C, dt and a_log read and dx, dB, dC, ddt and da_log
    written once, against the chunked algorithm's backward products at
    their least: C B^T once per (batch, chunk) and, per head, G^T dy,
    dy (x dt)^T, PD B and PD^T C on the lower triangle; each chunk's
    dy^T C, and the carried states' B dh_out^T, (x dt) dh_out and (from
    the second chunk on) dy h_in. Chunks as the forward's."""
    lens = _chunk_lens(s, chunk)
    tri = sum(L * (L + 1) // 2 for L in lens)
    flops = 2.0 * b * n * tri                          # C B^T
    flops += 2.0 * 2 * b * h * p * tri                 # G^T dy, dy (x dt)^T
    flops += 2.0 * 2 * b * h * n * tri                 # PD B, PD^T C
    flops += 2.0 * 3 * b * h * p * n * s               # dy^T C, two states
    flops += 2.0 * b * h * p * n * sum(lens[1:])       # dy h_in
    nbytes = (itemsize * (3 * b * s * h * p + 4 * b * s * n)
              + 4 * (2 * b * s * h + 2 * h))
    return flops, nbytes


def rglru_work(b, s, w):
    """a and b read and h written once (fp32), against one multiply-add
    per element."""
    return 2.0 * b * s * w, 3 * 4 * b * s * w


def rglru_bwd_work(b, s, w):
    """a, h and dh read and da and db written once (fp32), against a
    multiply-add and a multiply per element."""
    return 3.0 * b * s * w, 5 * 4 * b * s * w
