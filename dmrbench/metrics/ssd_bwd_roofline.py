"""The SSD scan's backward against its bound (``frozen_work.ssd_bwd_work``
at each call's shape) over its device time (its four CUDA kernels) in the
traced window, %."""
from dmrbench import roofline


def read(rec):
    return roofline.share(rec, "ssd_bwd")
