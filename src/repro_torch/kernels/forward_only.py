"""Guard for kernels that have a forward and no backward yet.

A kernel launched through ``ctypes`` returns a tensor that torch's autograd
knows nothing of: a ``loss.backward()`` through it would drop every
gradient that flows through the kernel, silently. Its op calls
:func:`refuse_autograd` before launching on CUDA tensors, so a graph that
would need its gradient raises instead.
"""
from __future__ import annotations

import torch


def refuse_autograd(name: str, queued: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when torch records a graph (grad mode
    on) through any of ``tensors`` (None is skipped); ``queued`` names the
    ROADMAP.md item that will bring the backward kernel."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no backward kernel yet, and its forward kernel "
            f"would cut the gradient ({queued}); run it under "
            "torch.no_grad() or on the CPU")
