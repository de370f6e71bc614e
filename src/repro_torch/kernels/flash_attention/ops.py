"""Dispatching wrapper for flash attention, with its gradient.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention_op``.
A CUDA tensor launches the hand-written forward kernel (or raises: a build
or launch failure is never caught), and so does a meta tensor, which
stands for one in the dry-run's count and launches nothing. Both kernels
are torch ops of the ``repro_torch`` namespace (``torch.library``):
``flash_attention_fwd`` writes the rows' log-sum-exp when torch records a
graph for any of q, k and v, and its registered gradient runs
``flash_attention_bwd``, the backward kernel. Being ops, they show in a
dispatch mode: ``FlopCounterMode`` counts them by the formulas of
``kernels/work.py``, the dry-run charges them those bytes, and remat
"dots" saves the forward's outputs (``models/transformer.py``, ``DOTS``).
A meta tensor takes the wrappers' allocations (``fake``: the same
function). A CPU tensor takes the plain version under torch autograd, as
does ``impl="ref"`` on either device.
"""
from typing import Optional

import torch
from torch import Tensor

from repro_torch.device import on_card
from repro_torch.kernels import work
from repro_torch.kernels.flash_attention.kernel import (aligned,
                                                        flash_attention,
                                                        flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import attention_ref


def _fwd(q: Tensor, k: Tensor, v: Tensor, causal: bool,
         window: Optional[int], softcap: Optional[float],
         return_lse: bool) -> tuple[Tensor, Tensor]:
    """The forward kernel: (out, the rows' log-sum-exp, or an empty tensor
    unless ``return_lse``)."""
    if return_lse:
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, return_lse=True)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=softcap)
    return out, out.new_empty((0,), dtype=torch.float32)


def _bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
         do: Tensor, causal: bool, window: Optional[int],
         softcap: Optional[float]) -> tuple[Tensor, Tensor, Tensor]:
    """The backward kernel: (dq, dk, dv)."""
    return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                               window=window, softcap=softcap)


flash_fwd_op = torch.library.custom_op("repro_torch::flash_attention_fwd",
                                       _fwd, mutates_args=())
flash_fwd_op.register_fake(_fwd)
flash_bwd_op = torch.library.custom_op("repro_torch::flash_attention_bwd",
                                       _bwd, mutates_args=())
flash_bwd_op.register_fake(_bwd)


def _save(ctx, inputs, output):
    q, k, v, causal, window, softcap, _ = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.options = (causal, window, softcap)


def _grad(ctx, do, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    if not aligned(do):
        # not .contiguous(): it keeps the strides of a size-1 dim (one head
        # a model coordinate), which may be 1
        do = do.clone(memory_format=torch.contiguous_format)
    dq, dk, dv = flash_bwd_op(q, k, v, out, lse, do, *ctx.options)
    return dq, dk, dv, None, None, None, None


flash_fwd_op.register_autograd(_grad, setup_context=_save)


def fwd_work(q, k, v, causal, window, softcap, return_lse, **_):
    b, h, sq, d = q.shape
    return work.attention_work(b, h, k.shape[1], sq, k.shape[2], d,
                               q.element_size(), causal, window)


def bwd_work(q, k, v, o, lse, do, causal, window, softcap, **_):
    b, h, sq, d = q.shape
    return work.attention_bwd_work(b, h, k.shape[1], sq, k.shape[2], d,
                                   q.element_size(), causal, window)


work.register(torch.ops.repro_torch.flash_attention_fwd, fwd_work, _fwd)
work.register(torch.ops.repro_torch.flash_attention_bwd, bwd_work, _bwd)


def flash_attention_op(q, k, v, *, causal: bool = True,
                       window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       impl: str = "auto") -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r} (auto | ref)")
    if impl == "ref" or not on_card(q):
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    graph = torch.is_grad_enabled() and any(t.requires_grad
                                            for t in (q, k, v))
    return flash_fwd_op(q, k, v, causal, window, softcap, graph)[0]
