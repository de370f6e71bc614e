"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. With no
card and no explicit ``device="cpu"`` they raise: they never carry on
silently on the CPU. ``device="meta"`` builds the card's program without
data: a meta tensor takes every kernel route a CUDA tensor takes, and the
kernels' wrappers allocate their outputs and launch nothing (the dry-run,
``repro_torch.launch.dryrun``, counts that program).
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's route: a CUDA tensor, or a meta
    tensor, which stands for one in the dry-run's count."""
    return t.is_cuda or t.is_meta
