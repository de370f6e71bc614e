"""The flash attention forward against its bound (``frozen_work.
attention_work`` at each call's shape: a slice's rows, the cell's heads and
sequence, bf16, causal) over its device time in the traced window, %."""
from dmrbench import roofline


def read(rec):
    return roofline.share(rec, "flash_fwd")
