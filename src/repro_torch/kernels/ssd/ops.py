"""Dispatching wrapper for the SSD scan, with its gradient.

Counterpart of ``repro.kernels.ssd.ops.ssd_op``, returning the final state
beside y. A CUDA tensor launches the hand-written kernel (or raises: a build
or launch failure is never caught), and so does a meta tensor, which stands
for one in the dry-run's count and launches nothing. Both kernels are torch
ops of the ``repro_torch`` namespace (``torch.library``): ``ssd_scan_fwd``
returns the kernel's workspace (the chunks' states, P x N fp32 each) beside
y and the final state, and its registered gradient hands that workspace to
``ssd_scan_bwd``, the backward kernel. Being ops, they show in a dispatch
mode: ``FlopCounterMode`` counts them by the formulas of
``kernels/work.py`` and the dry-run charges them those bytes. A meta tensor
takes the wrappers' allocations (``fake``: the same function). A CPU
tensor takes the plain version under torch autograd, as does
``impl="ref"`` on either device.
"""
from typing import Optional

import torch
from torch import Tensor

from repro_torch.device import on_card
from repro_torch.kernels import work
from repro_torch.kernels.ssd.kernel import ssd_scan, ssd_scan_bwd
from repro_torch.kernels.ssd.ref import ssd_ref


def _fwd(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor,
         chunk: int) -> tuple[Tensor, Tensor, Tensor]:
    """The forward kernel: (y, h_final, workspace)."""
    return ssd_scan(x, dt, a_log, b, c, chunk=chunk, keep_workspace=True)


def _bwd(x: Tensor, dt: Tensor, a_log: Tensor, b: Tensor, c: Tensor,
         dy: Tensor, dh_final: Optional[Tensor], workspace: Tensor,
         chunk: int) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The backward kernel: (dx, ddt, da_log, db, dc)."""
    return ssd_scan_bwd(x, dt, a_log, b, c, dy, dh_final, workspace,
                        chunk=chunk)


ssd_fwd_op = torch.library.custom_op("repro_torch::ssd_scan_fwd", _fwd,
                                     mutates_args=())
ssd_fwd_op.register_fake(_fwd)
ssd_bwd_op = torch.library.custom_op("repro_torch::ssd_scan_bwd", _bwd,
                                     mutates_args=())
ssd_bwd_op.register_fake(_bwd)


def _save(ctx, inputs, output):
    x, dt, a_log, b, c, chunk = inputs
    ctx.save_for_backward(x, dt, a_log, b, c, output[2])
    ctx.chunk = chunk
    # a loss that reads no h_final gives None for it, which the kernel
    # takes as zeros, and the workspace never has a gradient
    ctx.set_materialize_grads(False)


def _grad(ctx, dy, dh_final, _dworkspace):
    x, dt, a_log, b, c, workspace = ctx.saved_tensors
    if dy is None:
        dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    elif dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dh_final is not None:
        dh_final = dh_final.float().contiguous()
    return (*ssd_bwd_op(x, dt, a_log, b, c, dy, dh_final, workspace,
                        ctx.chunk), None)


ssd_fwd_op.register_autograd(_grad, setup_context=_save)


def fwd_work(x, dt, a_log, b, c, chunk, **_):
    bsz, s, h, p = x.shape
    return work.ssd_work(bsz, s, h, p, b.shape[-1], chunk, x.element_size())


def bwd_work(x, dt, a_log, b, c, dy, dh_final, workspace, chunk, **_):
    bsz, s, h, p = x.shape
    return work.ssd_bwd_work(bsz, s, h, p, b.shape[-1], chunk,
                             x.element_size())


work.register(torch.ops.repro_torch.ssd_scan_fwd, fwd_work, _fwd)
work.register(torch.ops.repro_torch.ssd_scan_bwd, bwd_work, _bwd)


def ssd_op(x, dt, a_log, b, c, *, chunk: int = 128, impl: str = "auto"):
    """x: (B,S,H,P); dt: (B,S,H); a_log: (H,); b/c: (B,S,N) -> (y (B,S,H,P),
    h_final (B,H,P,N) float32)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r} (auto | ref)")
    if impl == "ref" or not on_card(x):
        return ssd_ref(x, dt, a_log, b, c)
    y, h_final, _ = ssd_fwd_op(x, dt, a_log, b, c, chunk)
    return y, h_final
