"""Model FLOPs of the measured window's steps (``frozen_work.step_flops``:
6 x the products' parameters x tokens plus the sequence mixer, no
recompute) over the window's seconds times the card's bf16 peak, %."""
from dmrbench.frozen_work import PEAK_BF16_FLOPS


def read(rec):
    w = rec["window"]
    if not w["steps"]:
        return None
    return 100.0 * w["flops"] / (w["seconds"] * PEAK_BF16_FLOPS)
