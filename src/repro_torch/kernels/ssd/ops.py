"""Dispatching wrapper for the SSD scan, with its gradient.

Counterpart of ``repro.kernels.ssd.ops.ssd_op``, returning the final state
beside y. A CUDA tensor launches the hand-written kernel (or raises: a build
or launch failure is never caught); when torch records a graph for any
input, it goes through :class:`SSDScan`, whose forward keeps the kernel's
workspace and whose backward launches the backward kernel. A CPU tensor
takes the plain version under torch autograd, as does ``impl="ref"`` on
either device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.kernel import ssd_scan, ssd_scan_bwd
from repro_torch.kernels.ssd.ref import ssd_ref


class SSDScan(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op on CUDA
    tensors. Besides the inputs it saves the forward's workspace: the
    chunks' states (P x N fp32 each), which the backward reads."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b, c, chunk):
        y, h_final, workspace = ssd_scan(x, dt, a_log, b, c, chunk=chunk,
                                         keep_workspace=True)
        ctx.save_for_backward(x, dt, a_log, b, c, workspace)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, a_log, b, c, workspace = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        elif dy.stride(-1) != 1:
            dy = dy.contiguous()
        if dh_final is not None:
            dh_final = dh_final.float().contiguous()
        grads = ssd_scan_bwd(x, dt, a_log, b, c, dy, dh_final, workspace,
                             chunk=ctx.chunk)
        return (*grads, None)


def ssd_op(x, dt, a_log, b, c, *, chunk: int = 128, impl: str = "auto"):
    """x: (B,S,H,P); dt: (B,S,H); a_log: (H,); b/c: (B,S,N) -> (y (B,S,H,P),
    h_final (B,H,P,N) float32)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r} (auto | ref)")
    if impl == "ref" or not x.is_cuda:
        return ssd_ref(x, dt, a_log, b, c)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a_log, b, c)):
        return SSDScan.apply(x, dt, a_log, b, c, chunk)
    return ssd_scan(x, dt, a_log, b, c, chunk=chunk)
