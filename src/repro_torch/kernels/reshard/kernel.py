"""Binding of the hand-written CUDA box-copy kernel, the reshard's transfer
engine.

The kernel (``csrc/box_copy.cu``) replaces no TPU kernel: the reference's
reshard is one ``jax.device_put``, whose runtime copies the blocks. It is
built with ``nvcc`` for sm_90a into a shared library with a plain C
interface (see :mod:`repro_torch.kernels.build`) and called through
``ctypes`` on PyTorch's current stream.

:func:`box_copy` executes a table of pieces (``ref.TABLE_DTYPE``, the
kernel's ``Piece`` records, their tiles placed) whose blocks all lie on one
card, in one launch. It allocates the device buffer for the table and the
blocks' data pointers (``torch.empty``) and makes one call of the C entry,
which checks the table, lays it and the pointers out in a pinned host
buffer of its own, copies that to the device buffer on the current
stream, records an event after the copy (the pinned buffer is reused only
once that event has completed), launches and returns ``cudaGetLastError``.
The host side is one call because each Python step of it costs
microseconds that every resize pays. The wrapper raises on what the kernel
does not take and when the C entry reports an error.
``box_copy.launches`` counts the launches (``CUDA_KERNELS`` their CUDA
kernel).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import CUDA_KERNELS, build
from repro_torch.kernels.reshard.ref import TABLE_DTYPE

SOURCE = Path(__file__).resolve().parent / "csrc" / "box_copy.cu"
MAX_PIECES = 2 ** 31 - 1
CUDA_KERNEL = ("box_copy",)
# the kernel's Piece is TABLE_DTYPE's record: 17 int64
assert TABLE_DTYPE.itemsize == 17 * 8

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_P, _P, _P, _I, _I, _I, _I, _P)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument and result types on a library
    built from this kernel's source."""
    lib.box_copy_launch.argtypes = _ARGTYPES
    lib.box_copy_launch.restype = ctypes.c_int
    lib.box_copy_error_string.argtypes = [ctypes.c_int]
    lib.box_copy_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load() -> build.Built:
    """Build (at first use) and load the kernel library, once per process:
    a launch then touches no file."""
    built = build.load(SOURCE)
    bind(built.lib)
    return built


def _check(srcs, dsts, table) -> int:
    """The index of the card every block lies on; raises on what the kernel
    does not take (the C entry checks the table's pieces themselves)."""
    if not isinstance(table, np.ndarray) or table.dtype != TABLE_DTYPE or \
            table.ndim != 1 or not table.flags.c_contiguous:
        raise TypeError("table must be a contiguous 1-d TABLE_DTYPE array")
    if not 0 < len(table) <= MAX_PIECES or not srcs or not dsts:
        raise ValueError(f"{len(table)} pieces over {len(srcs)} sources and "
                         f"{len(dsts)} destinations: the kernel takes 1 to "
                         f"{MAX_PIECES} pieces")
    cards = {t.get_device() for t in srcs} | {t.get_device() for t in dsts}
    if len(cards) != 1 or not srcs[0].is_cuda:
        raise ValueError(f"blocks on {sorted(cards)}: every block must lie "
                         f"on one card (-1: the CPU)")
    return cards.pop()


def box_copy(srcs: Sequence[torch.Tensor], dsts: Sequence[torch.Tensor],
             table: np.ndarray) -> None:
    """Copy every piece of ``table`` (TABLE_DTYPE, its tiles placed) from
    ``srcs`` into ``dsts``, all on one card, in one launch on the current
    stream."""
    card = _check(srcs, dsts, table)
    ptrs = np.array([t.data_ptr() for t in srcs]
                    + [t.data_ptr() for t in dsts], dtype=np.int64)
    dev_table = torch.empty(table.nbytes + ptrs.nbytes, dtype=torch.uint8,
                            device=srcs[0].device)
    lib = load().lib
    stream = torch.cuda.current_stream(card).cuda_stream
    rc = lib.box_copy_launch(table.ctypes.data, ptrs.ctypes.data,
                             dev_table.data_ptr(), len(table), len(srcs),
                             len(dsts), card, stream)
    if rc != 0:
        msg = lib.box_copy_error_string(rc).decode()
        raise RuntimeError(f"box_copy launch failed: error {rc} ({msg})")
    box_copy.launches += 1
    CUDA_KERNELS.update(CUDA_KERNEL)


box_copy.launches = 0
