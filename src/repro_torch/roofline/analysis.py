"""Roofline terms of a counted cell on the H100.

Counterpart of ``repro.roofline.analysis``, whose constants are a TPU
v5e's: here they are the H100's (``roofline/hardware.py``), and the counts
come from the port's own eager program on the meta device
(``roofline/count.py``) rather than from XLA's ``cost_analysis``. The
terms are the reference's, per device:

    compute    = FLOPs / peak bf16 rate
    memory     = HBM bytes / HBM rate
    collective = bytes sent to other cards / NVLink rate (one direction)

``step_s`` is the largest (a lower bound that assumes full overlap),
``mfu`` the model FLOPs over what the cards could do in ``step_s``, and
``useful_ratio`` the model FLOPs over the counted ones.
"""
from __future__ import annotations

import dataclasses

from repro_torch.roofline.hardware import (HBM_BYTES, NVLINK_BYTES,
                                           PEAK_BF16_FLOPS, PEAK_BYTES)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    hlo_flops_global: float
    hlo_bytes_global: float
    coll_bytes_global: float
    model_flops: float
    useful_ratio: float     # MODEL_FLOPS / counted FLOPs
    step_s: float           # max of the three terms (no-overlap lower bound)
    mfu: float              # MODEL_FLOPS / (chips * peak * step_s)

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(*, per_device_flops: float, per_device_bytes: float,
                   per_device_coll_bytes: float, chips: int,
                   model_flops: float) -> Roofline:
    peak = PEAK_BF16_FLOPS
    compute_s = per_device_flops / peak
    memory_s = per_device_bytes / PEAK_BYTES
    collective_s = per_device_coll_bytes / NVLINK_BYTES
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    gf = per_device_flops * chips
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant,
        hlo_flops_global=gf,
        hlo_bytes_global=per_device_bytes * chips,
        coll_bytes_global=per_device_coll_bytes * chips,
        model_flops=model_flops,
        useful_ratio=(model_flops / gf) if gf else 0.0,
        step_s=step_s,
        mfu=(model_flops / (chips * peak * step_s)) if step_s else 0.0)


def memory_summary(count) -> dict:
    """The counted step's memory per device, in the reference record's
    terms where they apply: the arguments, the most alive at once beyond
    them (``temp``) and in all (``peak``), and whether that fits the
    card's HBM."""
    return {"argument_size_in_bytes": float(count.arg_bytes),
            "temp_size_in_bytes": float(count.peak_bytes - count.arg_bytes),
            "peak_bytes": float(count.peak_bytes),
            "hbm_bytes": HBM_BYTES,
            "fits": count.peak_bytes <= HBM_BYTES}


def cost_summary(count) -> dict:
    """The counted step's FLOPs and bytes per device, with the kernel
    ops' share."""
    return {"flops": count.flops, "bytes": count.bytes, "ops": count.ops,
            "kernel_flops": count.kernel_flops,
            "kernel_calls": count.kernel_calls}
