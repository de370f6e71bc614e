"""Dispatching wrapper for flash attention, with its gradient.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention_op``.
A CUDA tensor launches the hand-written forward kernel (or raises: a build
or launch failure is never caught); when torch records a graph for any of
q, k and v, it goes through :class:`FlashAttention`, whose forward also
writes the rows' log-sum-exp and whose backward launches the backward
kernel. A CPU tensor takes the plain version under torch autograd, as does
``impl="ref"`` on either device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.kernel import (aligned,
                                                        flash_attention,
                                                        flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import attention_ref


class FlashAttention(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op on CUDA
    tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.options = dict(causal=causal, window=window, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if not aligned(do):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do,
                                         **ctx.options)
        return dq, dk, dv, None, None, None


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, softcap)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap)
