"""Dispatching wrapper for the SSD scan.

Counterpart of ``repro.kernels.ssd.ops.ssd_op``, returning the final state
beside y. A CUDA tensor launches the hand-written kernel (or raises: a build
or launch failure is never caught); a CPU tensor takes the plain version,
as does ``impl="ref"`` on either device. The kernel has no backward yet: on
CUDA tensors that torch would record a graph through, the op raises.
"""
from __future__ import annotations

from repro_torch.kernels.forward_only import refuse_autograd
from repro_torch.kernels.ssd.kernel import ssd_scan
from repro_torch.kernels.ssd.ref import ssd_ref


def ssd_op(x, dt, a_log, b, c, *, chunk: int = 128, impl: str = "auto"):
    """x: (B,S,H,P); dt: (B,S,H); a_log: (H,); b/c: (B,S,N) -> (y (B,S,H,P),
    h_final (B,H,P,N) float32)."""
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r} (auto | ref)")
    if impl == "ref" or not x.is_cuda:
        return ssd_ref(x, dt, a_log, b, c)
    refuse_autograd("ssd_scan", "ROADMAP.md, Queue 2: the SSD scan's "
                    "backward, with mamba2's training", x, dt, a_log, b, c)
    return ssd_scan(x, dt, a_log, b, c, chunk=chunk)
