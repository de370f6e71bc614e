"""Binding of the hand-written CUDA SSD scan kernel.

The kernel (``csrc/ssd_scan.cu``) replaces the Pallas TPU kernel
``repro.kernels.ssd.kernel.ssd_scan`` and also writes the final state. It
is built with ``nvcc`` for sm_90a into a shared library with a plain C
interface (see :mod:`repro_torch.kernels.build`) and called through
``ctypes`` on PyTorch's current stream. One call runs the chunked
algorithm's three passes as three CUDA kernels (chunk states, state
passing, chunk outputs; ``ref.ssd_passes`` is their plain mirror). The
wrapper allocates the outputs and the passes' workspace, checks what the
kernel takes and raises on the rest, and raises when a launch reports an
error. ``ssd_scan.launches`` counts the calls (``CUDA_KERNELS`` their
CUDA kernels, ``cuda_kernels`` and ``bwd_cuda_kernels``).

The backward (``csrc/ssd_scan_bwd.cu``, a library of its own; the Pallas
kernel has none) gives the gradients of x, dt, a_log, B and C from dy, an
optional final-state gradient and the forward's workspace, which
``ssd_scan(..., keep_workspace=True)`` hands back. For bf16 inputs one call
runs four CUDA kernels, the products on the tensor cores (each chunk's
state-gradient share, the state passing in reverse, one pass per (batch,
chunk) over the heads for every gradient, da_log over the chunks); for fp32
seven, on the CUDA cores. ``ref.ssd_bwd_passes`` mirrors them;
``ssd_scan_bwd.launches`` counts the calls. Meta tensors stand for the
card's in the dry-run's count: both wrappers check them and allocate the
same outputs and workspaces, and build, load and launch nothing.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.device import on_card
from repro_torch.kernels import CUDA_KERNELS, build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
BWD_SOURCE = SOURCE.with_name("ssd_scan_bwd.cu")
HEAD_DIMS = (16, 32, 64)        # P
STATE_DIMS = (16, 32, 64, 128)  # N
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 128                 # rows per chunk (QMAX in the source)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
              *(_L,) * 10, _P)
_BWD_ARGTYPES = (*(_P,) * 14, *(_I,) * 7, *(_L,) * 13, _P)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument and result types on a library
    built from this kernel's source."""
    lib.ssd_scan_fwd.argtypes = _ARGTYPES
    lib.ssd_scan_fwd.restype = ctypes.c_int
    lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_error_string.restype = ctypes.c_char_p
    return lib


def chunk_rows(s: int, chunk: int) -> int:
    """Rows per chunk the kernel works in: ``min(chunk, S, 128)``."""
    return min(chunk, s, MAX_CHUNK)


def workspace_numel(bsz: int, s: int, h: int, p: int, n: int,
                    chunk: int, dtype: torch.dtype) -> int:
    """Floats of the passes' workspace: each (batch, chunk, head)'s P x N
    fp32 state (the chunk's own contribution, then for fp32 inputs its
    incoming state), for bf16 inputs the incoming states rounded to bf16,
    and each one's seg total."""
    q = chunk_rows(s, chunk)
    slots = bsz * (-(-s // q)) * h
    half = p * n // 2 if dtype == torch.bfloat16 else 0
    return slots * (p * n + half + 1)


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The same for a library built from the backward's source."""
    lib.ssd_scan_bwd.argtypes = _BWD_ARGTYPES
    lib.ssd_scan_bwd.restype = ctypes.c_int
    lib.ssd_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_scan_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load() -> build.Built:
    """Build (at first use) and load the kernel library, once per process:
    a launch then touches no file."""
    built = build.load(SOURCE)
    bind(built.lib)
    return built


@functools.cache
def load_bwd() -> build.Built:
    """The same for the backward's library."""
    built = build.load(BWD_SOURCE)
    bind_bwd(built.lib)
    return built


def bwd_workspace_numel(bsz: int, s: int, h: int, p: int, n: int,
                        chunk: int, dtype: torch.dtype) -> int:
    """Floats of the backward's workspace: each (batch, chunk, head)'s P x
    N fp32 state-gradient share and its fp64 share of da_log; for bf16
    inputs each one's dh_out in bf16 besides, and nothing per row (dB and dC
    are summed over the heads on chip); for fp32 per (batch, row, head) the
    fp64 row less column sums of M, the carried term and the per-head dB and
    dC rows (N each)."""
    q = chunk_rows(s, chunk)
    slots = bsz * (-(-s // q)) * h
    if dtype == torch.bfloat16:
        return slots * p * n * 3 // 2 + 2 * slots
    rows = bsz * s * h
    return slots * p * n + 2 * rows + 2 * slots + rows + 2 * rows * n


def _check(x, dt, a_log, b, c, chunk: int):
    named = (("x", x), ("dt", dt), ("a_log", a_log), ("b", b), ("c", c))
    for name, t in named:
        if not on_card(t):
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if len({t.device for _, t in named}) != 1:
        raise ValueError("x, dt, a_log, b and c must be on one device")
    if x.dim() != 4 or dt.dim() != 3 or a_log.dim() != 1 or \
            b.dim() != 3 or c.dim() != 3:
        raise ValueError(
            f"expected x (B,S,H,P), dt (B,S,H), a_log (H,), b/c (B,S,N); got "
            f"{[tuple(t.shape) for _, t in named]}")
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if dt.shape != (bsz, s, h) or a_log.shape != (h,) or \
            b.shape != (bsz, s, n) or c.shape != (bsz, s, n):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)} dt {tuple(dt.shape)} a_log "
            f"{tuple(a_log.shape)} b {tuple(b.shape)} c {tuple(c.shape)}")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b and c must share one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a_log.dtype != torch.float32:
        raise TypeError(f"dt and a_log must be float32, got {dt.dtype}, "
                        f"{a_log.dtype}")
    for name, t in (("x", x), ("b", b), ("c", c)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride over its last "
                             f"axis, got strides {t.stride()}")
    if a_log.stride(0) != 1:
        raise ValueError("a_log must be contiguous")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"head_dim {p} or state {n} not supported "
                         f"(P in {HEAD_DIMS}, N in {STATE_DIMS})")
    if bsz == 0 or s == 0 or h == 0:
        raise ValueError(f"empty input: x {tuple(x.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def ssd_scan(x, dt, a_log, b, c, *, chunk: int = 128,
             keep_workspace: bool = False):
    """x: (B,S,H,P); dt: (B,S,H); a_log: (H,); b/c: (B,S,N) -> (y (B,S,H,P)
    in x's dtype, h_final (B,H,P,N) float32), on the card. The kernel works
    in chunks of ``min(chunk, S, 128)`` rows and masks a ragged tail.
    ``keep_workspace``: also return the passes' workspace, which
    :func:`ssd_scan_bwd` reads."""
    _check(x, dt, a_log, b, c, chunk)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    h_final = torch.empty((bsz, h, p, n), dtype=torch.float32,
                          device=x.device)
    workspace = torch.empty(workspace_numel(bsz, s, h, p, n, chunk, x.dtype),
                            dtype=torch.float32, device=x.device)
    if not x.is_meta:
        launch(load().lib, x, dt, a_log, b, c, y, h_final, workspace,
               chunk=chunk_rows(s, chunk))
        ssd_scan.launches += 1
        CUDA_KERNELS.update(cuda_kernels(x.dtype))
    if keep_workspace:
        return y, h_final, workspace
    return y, h_final


def cuda_kernels(dtype) -> tuple:
    """The CUDA kernels one forward call launches: its three passes."""
    t = "bf16" if dtype == torch.bfloat16 else "f32"
    return (f"chunk_state_{t}", "state_pass", f"chunk_output_{t}")


def bwd_cuda_kernels(dtype) -> tuple:
    """The CUDA kernels one backward call launches: four for bf16 inputs,
    seven for fp32 (its ``state_pass`` shares the forward's name)."""
    if dtype == torch.bfloat16:
        return ("chunk_dstate_bf16", "state_pass", "chunk_bwd_bf16",
                "reduce_alog")
    return ("chunk_dstate", "state_pass", "chunk_dx", "chunk_dc", "chunk_db",
            "reduce_heads", "reduce_alog")


def launch(lib: ctypes.CDLL, x, dt, a_log, b, c, y, h_final, workspace, *,
           chunk: int) -> None:
    """Run the kernel of ``lib`` (bound by :func:`bind`) on checked inputs
    into ``y`` and ``h_final`` on the current stream, ``chunk`` rows at a
    time (1..128), with ``workspace`` (:func:`workspace_numel` floats);
    raise if a launch reports an error. Counts nothing: :func:`ssd_scan`
    does."""
    bsz, s, h, p = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            workspace.data_ptr(),
            DTYPES[x.dtype], bsz, s, h, p, b.shape[-1], chunk,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1), stream)
    if rc != 0:
        msg = lib.ssd_scan_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc} "
                           f"({msg})")


def _check_bwd(x, dt, a_log, b, c, dy, dh_final, workspace, chunk: int):
    _check(x, dt, a_log, b, c, chunk)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if dy.device != x.device:
        raise ValueError(f"dy must be on x's device {x.device}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.stride(-1) != 1:
        raise ValueError(f"dy must match x {tuple(x.shape)} {x.dtype} with "
                         f"unit stride over P; got {tuple(dy.shape)} "
                         f"{dy.dtype} strides {dy.stride()}")
    if dh_final is not None and (
            dh_final.device != x.device or dh_final.dtype != torch.float32
            or dh_final.shape != (bsz, h, p, n)
            or not dh_final.is_contiguous() or dh_final.data_ptr() % 16):
        raise ValueError(f"dh_final must be a contiguous, 16-byte aligned "
                         f"float32 {(bsz, h, p, n)} on {x.device}")
    want = workspace_numel(bsz, s, h, p, n, chunk, x.dtype)
    if workspace.device != x.device or workspace.dtype != torch.float32 or \
            workspace.numel() != want or workspace.data_ptr() % 16:
        raise ValueError(f"workspace must be the forward's: {want} float32 "
                         f"on {x.device}")


def ssd_scan_bwd(x, dt, a_log, b, c, dy, dh_final, workspace, *,
                 chunk: int = 128):
    """Gradients (dx, ddt, da_log, db, dc) of :func:`ssd_scan`'s (y,
    h_final) on these inputs, given dy (B,S,H,P) in x's dtype, dh_final
    (B,H,P,N) float32 or None (zeros) and the forward's ``workspace``
    (``keep_workspace=True``, the same ``chunk``), on the card. Each
    gradient has its input's shape and dtype and is contiguous."""
    _check_bwd(x, dt, a_log, b, c, dy, dh_final, workspace, chunk)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    dev = x.device
    dx = torch.empty((bsz, s, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((bsz, s, h), dtype=torch.float32, device=dev)
    da_log = torch.empty((h,), dtype=torch.float32, device=dev)
    db = torch.empty((bsz, s, n), dtype=b.dtype, device=dev)
    dc = torch.empty((bsz, s, n), dtype=c.dtype, device=dev)
    scratch = torch.empty(bwd_workspace_numel(bsz, s, h, p, n, chunk,
                                              x.dtype),
                          dtype=torch.float32, device=dev)
    if not x.is_meta:
        launch_bwd(load_bwd().lib, x, dt, a_log, b, c, dy, dh_final,
                   workspace, dx, ddt, da_log, db, dc, scratch,
                   chunk=chunk_rows(s, chunk))
        ssd_scan_bwd.launches += 1
        CUDA_KERNELS.update(bwd_cuda_kernels(x.dtype))
    return dx, ddt, da_log, db, dc


def launch_bwd(lib: ctypes.CDLL, x, dt, a_log, b, c, dy, dh_final,
               fwd_workspace, dx, ddt, da_log, db, dc, workspace, *,
               chunk: int) -> None:
    """Run the backward of ``lib`` (bound by :func:`bind_bwd`) on checked
    inputs on the current stream, ``chunk`` rows at a time (the forward's);
    raise if a launch reports an error. Counts nothing:
    :func:`ssd_scan_bwd` does."""
    bsz, s, h, p = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan_bwd(
            *(t.data_ptr() if t is not None else None
              for t in (x, dt, a_log, b, c, dy, dh_final, fwd_workspace, dx,
                        ddt, da_log, db, dc, workspace)),
            DTYPES[x.dtype], bsz, s, h, p, b.shape[-1], chunk,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            b.stride(0), b.stride(1), c.stride(0), c.stride(1),
            dy.stride(0), dy.stride(1), dy.stride(2), stream)
    if rc != 0:
        msg = lib.ssd_scan_bwd_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan_bwd launch failed: CUDA error {rc} "
                           f"({msg})")


ssd_scan.launches = 0
ssd_scan_bwd.launches = 0
