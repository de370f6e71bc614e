"""Dispatching wrapper for the RG-LRU scan, with its gradient.

Counterpart of ``repro.kernels.rglru.ops.rglru_op``, with the optional
initial state of ``rglru_ref``. A CUDA tensor launches the hand-written
kernel (or raises: a build or launch failure is never caught), and so does
a meta tensor, which stands for one in the dry-run's count and launches
nothing. Both kernels are torch ops of the ``repro_torch`` namespace
(``torch.library``): the registered gradient of ``rglru_scan_fwd`` runs
``rglru_scan_bwd``, the backward kernel, on the forward's saved output.
Being ops, they show in a dispatch mode: ``FlopCounterMode`` counts them
by the formulas of ``kernels/work.py`` and the dry-run charges them those
bytes. A meta tensor takes the wrappers' allocations (``fake``: the same
function). A CPU tensor takes the plain version under torch autograd, as
does ``impl="ref"`` on either device.
"""
from typing import Optional

import torch
from torch import Tensor

from repro_torch.device import on_card
from repro_torch.kernels import work
from repro_torch.kernels.rglru.kernel import rglru_scan, rglru_scan_bwd
from repro_torch.kernels.rglru.ref import rglru_ref


def _fwd(a: Tensor, b: Tensor, h0: Optional[Tensor]) -> Tensor:
    """The forward kernel: h."""
    return rglru_scan(a, b, h0)


def _bwd(a: Tensor, h: Tensor, h0: Optional[Tensor],
         dh: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The backward kernel: (da, db, dh0, or an empty tensor when h0 is
    None)."""
    da, db, dh0 = rglru_scan_bwd(a, h, h0, dh)
    return da, db, dh0 if dh0 is not None else da.new_empty((0,))


rglru_fwd_op = torch.library.custom_op("repro_torch::rglru_scan_fwd", _fwd,
                                       mutates_args=())
rglru_fwd_op.register_fake(_fwd)
rglru_bwd_op = torch.library.custom_op("repro_torch::rglru_scan_bwd", _bwd,
                                       mutates_args=())
rglru_bwd_op.register_fake(_bwd)


def _save(ctx, inputs, output):
    a, _, h0 = inputs
    ctx.save_for_backward(a, output, h0)


def _grad(ctx, dh):
    a, h, h0 = ctx.saved_tensors
    if dh.stride(-1) != 1:
        dh = dh.contiguous()
    da, db, dh0 = rglru_bwd_op(a, h, h0, dh)
    return da, db, dh0 if h0 is not None else None


rglru_fwd_op.register_autograd(_grad, setup_context=_save)


def fwd_work(a, b, h0, **_):
    return work.rglru_work(*a.shape)


def bwd_work(a, h, h0, dh, **_):
    return work.rglru_bwd_work(*a.shape)


work.register(torch.ops.repro_torch.rglru_scan_fwd, fwd_work, _fwd)
work.register(torch.ops.repro_torch.rglru_scan_bwd, bwd_work, _bwd)


def rglru_op(a, b, h0=None, *, impl: str = "auto"):
    """a, b: (B, S, W); h0: (B, W) or None -> h: (B, S, W) in a's dtype."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r} (auto | ref)")
    if impl == "ref" or not on_card(a):
        return rglru_ref(a, b, h0)
    return rglru_fwd_op(a, b, h0)
