"""Binding of the hand-written CUDA RG-LRU scan kernel.

The kernel (``csrc/rglru_scan.cu``) replaces the Pallas TPU kernel
``repro.kernels.rglru.kernel.rglru_scan_pallas`` and also takes an initial
state. It is built with ``nvcc`` for sm_90a into a shared library with a
plain C interface (see :mod:`repro_torch.kernels.build`) and called through
``ctypes`` on PyTorch's current stream. The wrapper allocates the output,
checks what the kernel takes and raises on the rest, and raises when the
launch reports an error. ``rglru_scan.launches`` counts the launches
(``CUDA_KERNELS`` their CUDA kernels).

The backward (``rglru_scan_bwd``, the source's second entry; the Pallas
kernel has none) gives da, db and dh0 from the gradient of h and the
forward's saved h; it splits S into chunks of ``BWD_CHUNK`` steps that pass
their carry right to left through a workspace the wrapper allocates
(``bwd_workspace_numel``). ``rglru_scan_bwd.launches`` counts its
launches. Meta tensors stand for the card's in the dry-run's count: both
wrappers check them and allocate the same outputs and workspace, and
build, load and launch nothing.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.device import on_card
from repro_torch.kernels import CUDA_KERNELS, build

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru_scan.cu"
MAX_BATCH = 65535     # the grid's second axis
BWD_CHUNK = 128       # the backward's steps per block (CHUNK in the source)
# the CUDA kernel each call launches (the backward's workspace is zeroed by
# a memset, which is no kernel)
CUDA_KERNEL, BWD_CUDA_KERNEL = ("rglru_scan_f32",), ("rglru_scan_bwd_f32",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _P)
_BWD_ARGTYPES = (*(_P,) * 8, _I, _I, _I, _L, _L, _L, _L, _P)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument and result types on a library
    built from this kernel's source."""
    lib.rglru_scan_fwd.argtypes = _ARGTYPES
    lib.rglru_scan_fwd.restype = ctypes.c_int
    lib.rglru_scan_bwd.argtypes = _BWD_ARGTYPES
    lib.rglru_scan_bwd.restype = ctypes.c_int
    lib.rglru_scan_error_string.argtypes = [ctypes.c_int]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load() -> build.Built:
    """Build (at first use) and load the kernel library, once per process:
    a launch then touches no file."""
    built = build.load(SOURCE)
    bind(built.lib)
    return built


def _check(a, b, h0):
    named = (("a", a), ("b", b)) + ((("h0", h0),) if h0 is not None else ())
    for name, t in named:
        if not on_card(t):
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("a, b and h0 must be on one device")
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"expected a and b of one shape (B, S, W), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    bsz, s, w = a.shape
    if bsz == 0 or s == 0 or w == 0 or bsz > MAX_BATCH:
        raise ValueError(f"unsupported sizes: a {tuple(a.shape)}")
    for name, t in (("a", a), ("b", b)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride over its last "
                             f"axis, got strides {t.stride()}")
    if h0 is not None and (h0.shape != (bsz, w) or not h0.is_contiguous()):
        raise ValueError(f"h0 must be a contiguous (B, W) = {(bsz, w)}, "
                         f"got {tuple(h0.shape)} strides {h0.stride()}")


def rglru_scan(a, b, h0=None):
    """a, b: (B, S, W) float32; h0: (B, W) float32 or None -> h (B, S, W)
    float32, on the card."""
    _check(a, b, h0)
    h = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if not a.is_meta:
        launch(load().lib, a, b, h0, h)
        rglru_scan.launches += 1
        CUDA_KERNELS.update(CUDA_KERNEL)
    return h


def launch(lib: ctypes.CDLL, a, b, h0, h) -> None:
    """Run the kernel of ``lib`` (bound by :func:`bind`) on checked inputs
    into ``h`` on the current stream; raise if the launch reports an
    error. Counts nothing: :func:`rglru_scan` does."""
    bsz, s, w = a.shape
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_scan_fwd(
            a.data_ptr(), b.data_ptr(),
            h0.data_ptr() if h0 is not None else None, h.data_ptr(),
            bsz, s, w, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
            stream)
    if rc != 0:
        msg = lib.rglru_scan_error_string(rc).decode()
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {rc} "
                           f"({msg})")


def _check_bwd(a, h, h0, dh):
    _check(a, dh, h0)
    if h.device != a.device or h.dtype != torch.float32 or \
            h.shape != a.shape or not h.is_contiguous():
        raise ValueError(f"h must be the forward's contiguous float32 "
                         f"{tuple(a.shape)} output on {a.device}, got "
                         f"{h.dtype} {tuple(h.shape)} strides {h.stride()}")


def bwd_workspace_numel(b: int, s: int, w: int) -> int:
    """fp32 elements of the backward's workspace for a (B, S, W): per
    (batch, chunk of ``BWD_CHUNK`` steps, channel) the chunk's aggregate
    (two values) and its inclusive carry, each beside its flag."""
    return 6 * b * -(-s // BWD_CHUNK) * w


def rglru_scan_bwd(a, h, h0, dh):
    """Gradients (da, db, dh0) of :func:`rglru_scan`'s h = scan(a, b, h0)
    given dh (B, S, W) and the forward's output h, on the card; dh0 is None
    when h0 is. All float32, contiguous."""
    _check_bwd(a, h, h0, dh)
    da = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    db = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    dh0 = torch.empty_like(h0) if h0 is not None else None
    workspace = torch.empty(bwd_workspace_numel(*a.shape),
                            dtype=torch.float32, device=a.device)
    if not a.is_meta:
        launch_bwd(load().lib, a, h, h0, dh, da, db, dh0, workspace)
        rglru_scan_bwd.launches += 1
        CUDA_KERNELS.update(BWD_CUDA_KERNEL)
    return da, db, dh0


def launch_bwd(lib: ctypes.CDLL, a, h, h0, dh, da, db, dh0,
               workspace) -> None:
    """Run the backward of ``lib`` (bound by :func:`bind`) on checked inputs
    on the current stream; raise if the launch reports an error. Counts
    nothing: :func:`rglru_scan_bwd` does."""
    bsz, s, w = a.shape
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.rglru_scan_bwd(
            *(t.data_ptr() if t is not None else None
              for t in (a, h, h0, dh, da, db, dh0, workspace)),
            bsz, s, w, a.stride(0), a.stride(1), dh.stride(0), dh.stride(1),
            stream)
    if rc != 0:
        msg = lib.rglru_scan_error_string(rc).decode()
        raise RuntimeError(f"rglru_scan_bwd launch failed: CUDA error {rc} "
                           f"({msg})")


rglru_scan.launches = 0
rglru_scan_bwd.launches = 0
