"""Dispatching wrapper for the RG-LRU scan, with its gradient.

Counterpart of ``repro.kernels.rglru.ops.rglru_op``, with the optional
initial state of ``rglru_ref``. A CUDA tensor launches the hand-written
kernel (or raises: a build or launch failure is never caught); when torch
records a graph for a, b or h0, it goes through :class:`RGLRUScan`, whose
backward launches the backward kernel on the forward's saved output. A CPU
tensor takes the plain version under torch autograd, as does ``impl="ref"``
on either device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rglru.kernel import rglru_scan, rglru_scan_bwd
from repro_torch.kernels.rglru.ref import rglru_ref


class RGLRUScan(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op on CUDA
    tensors."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = rglru_scan(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        if dh.stride(-1) != 1:
            dh = dh.contiguous()
        return rglru_scan_bwd(a, h, h0, dh)


def rglru_op(a, b, h0=None, *, impl: str = "auto"):
    """a, b: (B, S, W); h0: (B, W) or None -> h: (B, S, W) in a's dtype."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r} (auto | ref)")
    if impl == "ref" or not a.is_cuda:
        return rglru_ref(a, b, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (a, b, h0)):
        return RGLRUScan.apply(a, b, h0)
    return rglru_scan(a, b, h0)
