"""Dispatching wrapper for the RG-LRU scan.

Counterpart of ``repro.kernels.rglru.ops.rglru_op``, with the optional
initial state of ``rglru_ref``. A CUDA tensor launches the hand-written
kernel (or raises: a build or launch failure is never caught); a CPU tensor
takes the plain version, as does ``impl="ref"`` on either device. The
kernel has no backward yet: on CUDA tensors that torch would record a graph
through, the op raises.
"""
from __future__ import annotations

from repro_torch.kernels.forward_only import refuse_autograd
from repro_torch.kernels.rglru.kernel import rglru_scan
from repro_torch.kernels.rglru.ref import rglru_ref


def rglru_op(a, b, h0=None, *, impl: str = "auto"):
    """a, b: (B, S, W); h0: (B, W) or None -> h: (B, S, W) in a's dtype."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r} (auto | ref)")
    if impl == "ref" or not a.is_cuda:
        return rglru_ref(a, b, h0)
    refuse_autograd("rglru_scan", "ROADMAP.md, Queue 2: the RG-LRU scan's "
                    "backward, with recurrentgemma's training", a, b, h0)
    return rglru_scan(a, b, h0)
