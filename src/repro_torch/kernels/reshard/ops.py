"""Dispatching wrapper for the reshard's copies.

``box_copy_op`` executes a table of pieces (``ref.TABLE_DTYPE``) whose
blocks lie on one device: CUDA blocks launch the hand-written kernel (or
raise: a build or launch failure is never caught), CPU blocks take the
plain version.
"""
from typing import Sequence

import numpy as np
from torch import Tensor

from repro_torch.kernels.reshard.kernel import box_copy
from repro_torch.kernels.reshard.ref import box_copy_ref


def box_copy_op(srcs: Sequence[Tensor], dsts: Sequence[Tensor],
                table: np.ndarray) -> None:
    """Copy each piece of ``table`` from ``srcs`` into ``dsts``."""
    if srcs[0].is_cuda:
        box_copy(srcs, dsts, table)
    else:
        box_copy_ref(srcs, dsts, table)
