"""The flash attention backward against its bound (``frozen_work.
attention_bwd_work`` at each call's shape) over its device time (its three
CUDA kernels) in the traced window, %."""
from dmrbench import roofline


def read(rec):
    return roofline.share(rec, "flash_bwd")
