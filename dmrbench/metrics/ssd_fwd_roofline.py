"""The SSD scan's forward against its bound (``frozen_work.ssd_work`` at
each call's shape: a slice's rows, the cell's heads, state and chunk, bf16)
over its device time (its three CUDA kernels) in the traced window, %."""
from dmrbench import roofline


def read(rec):
    return roofline.share(rec, "ssd_fwd")
