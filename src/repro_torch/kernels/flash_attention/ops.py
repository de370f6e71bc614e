"""Dispatching wrapper for flash attention.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention_op``.
A CUDA tensor launches the hand-written kernel (or raises: a build or launch
failure is never caught); a CPU tensor takes the plain version, as does
``impl="ref"`` on either device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention_op(q, k, v, *, causal: bool = True,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       impl: str = "auto") -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r} (auto | ref)")
    if impl == "ref" or not q.is_cuda:
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)
