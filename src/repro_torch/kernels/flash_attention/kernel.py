"""Binding of the hand-written CUDA flash-attention kernels.

The forward (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention``; for training it
also writes the rows' log-sum-exp. The backward
(``csrc/flash_attention_bwd.cu``, a source of its own, so serving builds
only the forward) has no Pallas counterpart: the reference trains through
XLA's autodiff. Each is built with ``nvcc`` for sm_90a into a shared
library with a plain C interface (see :mod:`repro_torch.kernels.build`) and
called through ``ctypes`` on PyTorch's current stream. The wrappers
allocate the outputs and workspace, check what the kernels take and raise
on the rest, and raise when a launch reports an error.
``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
the launches, and ``CUDA_KERNELS`` the CUDA kernels each put on the
stream (``cuda_kernels``, ``bwd_cuda_kernels``). Meta tensors stand for the card's in the dry-run's count:
the wrappers check them and allocate the same outputs and workspace, and
build, load and launch nothing.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.device import on_card
from repro_torch.kernels import CUDA_KERNELS, build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = SOURCE.with_name("flash_attention_bwd.cu")
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Q_TILE = 64          # query rows per fp32 block (BQ in the source)
MAX_Q_TILES = 65535  # the grid's second axis
BWD_QTILE = 64       # query rows of a tile of the backward's workspace
BWD_KEYS = 64        # keys per block of the backward's D 256 route
BWD_BLOCKS = 3 * 132  # the D 256 route's target grid: three blocks an SM

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, *(_L,) * 12,
              _I, _I, ctypes.c_float, ctypes.c_float, _P)
_BWD_ARGTYPES = (*(_P,) * 10, *(_I,) * 7, *(_L,) * 24, _I, _I,
                 ctypes.c_float, ctypes.c_float, _I, _P)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument and result types on a library
    built from this kernel's source."""
    lib.flash_attention_fwd.argtypes = _ARGTYPES
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The same for a library built from the backward's source."""
    lib.flash_attention_bwd.argtypes = _BWD_ARGTYPES
    lib.flash_attention_bwd.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load() -> build.Built:
    """Build (at first use) and load the forward's library, once per
    process: a launch then touches no file."""
    built = build.load(SOURCE)
    bind(built.lib)
    return built


@functools.cache
def load_bwd() -> build.Built:
    """The same for the backward's library."""
    built = build.load(BWD_SOURCE)
    bind_bwd(built.lib)
    return built


def _check(q, k, v, causal: bool, window: Optional[int],
           softcap: Optional[float]):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not on_card(t):
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got shape {tuple(t.shape)}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not supported "
                            f"(float32 or bfloat16)")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride over head_dim")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share one dtype")
    b, h, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    kvh, sk = k.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"query heads {h} not a multiple of KV heads {kvh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported {HEAD_DIMS}")
    if sq == 0 or sk == 0 or -(-sq // Q_TILE) > MAX_Q_TILES:
        raise ValueError(f"unsupported sizes: Sq {sq}, Sk {sk}")
    if q.dtype == torch.bfloat16:
        # TMA: 16-byte aligned base and strides
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
                raise ValueError(f"{name}: bfloat16 rows must be 16-byte "
                                 f"aligned (strides {t.stride()})")
    if causal and sq > sk:
        raise ValueError(f"causal attention needs Sq <= Sk, got {sq} > {sk}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, return_lse: bool = False):
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D), on the card;
    with ``return_lse`` also the rows' log-sum-exp, fp32 (B, H, Sq), which
    :func:`flash_attention_bwd` takes. Meta tensors: the outputs only."""
    _check(q, k, v, causal, window, softcap)
    out = output_buffer(q)
    lse = None
    if return_lse:
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    if not q.is_meta:
        launch(load().lib, q, k, v, out, causal=causal, window=window,
               softcap=softcap, lse=lse)
        flash_attention.launches += 1
        CUDA_KERNELS.update(cuda_kernels(q.dtype))
    return (out, lse) if return_lse else out


def cuda_kernels(dtype) -> tuple:
    """The CUDA kernel one forward call launches, by dtype."""
    return ("flash_fwd_bf16" if dtype == torch.bfloat16 else "flash_fwd_f32",)


def bwd_cuda_kernels(dtype, d: int, splits: int) -> tuple:
    """The CUDA kernels one backward call launches: the rows' delta, the
    main pass (the ``wgmma`` kernel at bf16 D 64 and 128, its D 256 route
    with the partials' sum where ``splits`` > 1, else the CUDA-core one),
    then dq."""
    main = ("flash_bwd_dkdv",)
    if dtype == torch.bfloat16 and d in (64, 128):
        main = ("flash_bwd_wgmma",)
    elif dtype == torch.bfloat16 and d == 256:
        main = ("flash_bwd_wgmma256",) + (("flash_bwd_dkdv_sum",)
                                          if splits > 1 else ())
    return ("flash_bwd_delta", *main, "flash_bwd_dq")


def output_buffer(q) -> torch.Tensor:
    """The output for q (B, H, Sq, D): a (B, Sq, H, D) tensor viewed as
    (B, H, Sq, D), the layout the model's o-projection reads, so the
    model's transpose back is free and its reshape copies nothing."""
    b, h, sq, d = q.shape
    return torch.empty((b, sq, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def launch(lib: ctypes.CDLL, q, k, v, out, *, causal: bool,
           window: Optional[int], softcap: Optional[float],
           lse: Optional[torch.Tensor] = None) -> None:
    """Run the kernel of ``lib`` (bound by :func:`bind`) on checked inputs
    into ``out`` (and the rows' log-sum-exp into ``lse``, a contiguous fp32
    (B, H, Sq) tensor, unless it is None) on the current stream; raise if
    the launch reports an error. Counts nothing: :func:`flash_attention`
    does."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            DTYPES[q.dtype], b, h, kvh, sq, sk, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            int(causal), window or 0, float(softcap or 0.0),
            1.0 / math.sqrt(d), stream)
    if rc != 0:
        msg = lib.flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{rc} ({msg})")


def aligned(t: torch.Tensor) -> bool:
    """Whether the backward can read ``t`` (B, heads, S, D) 16 bytes at a
    time: unit stride over D, 16-byte aligned base and strides."""
    per = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % per == 0 for s in t.stride()[:3]))


def _check_bwd(q, k, v, o, lse, do, causal, window, softcap):
    _check(q, k, v, causal, window, softcap)
    b, h, sq, d = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} must match q: {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if not aligned(t):
            raise ValueError(f"{name}: rows must be 16-byte aligned, with "
                             f"unit stride over head_dim (strides "
                             f"{t.stride()})")
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (b, h, sq) or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(b, h, sq)} "
                         f"tensor on {q.device}, got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    if b * h > 65535:
        raise ValueError(f"unsupported sizes: B {b} x H {h}")


def bwd_workspace_numel(b: int, h: int, sq: int, d: int) -> int:
    """fp32 elements of the backward's workspace for q (B, H, Sq, D): per
    64-row query tile (``BWD_QTILE``), dQ's fp32 sums (64 x D) and a record
    of the rows' lse and delta (2 x 64)."""
    return b * h * -(-sq // BWD_QTILE) * BWD_QTILE * (d + 2)


def bwd_splits(b: int, h: int, kv: int, sk: int, d: int,
               dtype: torch.dtype) -> int:
    """How many blocks of the backward's bf16 D 256 route share a key
    tile's (query head, query tile) items: enough for about ``BWD_BLOCKS``
    blocks (one fits an SM at a time, so a few waves of them balance key
    tiles of unequal work), at most the group's heads; 1 on every other
    route."""
    if dtype != torch.bfloat16 or d != 256:
        return 1
    tiles = b * kv * -(-sk // BWD_KEYS)
    return max(1, min(h // kv, -(-BWD_BLOCKS // tiles)))


def bwd_partials_numel(splits: int, b: int, kv: int, sk: int,
                       d: int) -> int:
    """fp32 elements the D 256 route's dK and dV partials add to the
    workspace: none for one split, else (splits, B, KV, Sk, D) of each."""
    return 0 if splits == 1 else 2 * splits * b * kv * sk * d


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """Gradients (dq, dk, dv) of :func:`flash_attention`'s output ``o`` with
    respect to q, k and v, given the output's gradient ``do`` and the
    forward's ``lse``, on the card; dq, dk and dv have the strides of q, k
    and v. Meta tensors: the gradients and the workspace only."""
    _check_bwd(q, k, v, o, lse, do, causal, window, softcap)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    splits = bwd_splits(b, h, kvh, sk, d, q.dtype)
    workspace = torch.empty(
        bwd_workspace_numel(b, h, sq, d)
        + bwd_partials_numel(splits, b, kvh, sk, d),
        dtype=torch.float32, device=q.device)
    if not q.is_meta:
        launch_bwd(load_bwd().lib, q, k, v, o, lse, do, dq, dk, dv,
                   workspace, causal=causal, window=window, softcap=softcap,
                   splits=splits)
        flash_attention_bwd.launches += 1
        CUDA_KERNELS.update(bwd_cuda_kernels(q.dtype, d, splits))
    return dq, dk, dv


def launch_bwd(lib: ctypes.CDLL, q, k, v, o, lse, do, dq, dk, dv, workspace,
               *, causal: bool, window: Optional[int],
               softcap: Optional[float], splits: int = 1) -> None:
    """Run the backward of ``lib`` (bound by :func:`bind_bwd`) on checked
    inputs on the current stream, ``splits`` blocks a key tile (with a
    workspace that holds their partials; see :func:`bwd_splits`); raise if
    the launch reports an error. Counts nothing: :func:`flash_attention_bwd`
    does."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv,
                                     workspace)),
            DTYPES[q.dtype], b, h, kvh, sq, sk, d, *strides,
            int(causal), window or 0, float(softcap or 0.0),
            1.0 / math.sqrt(d), splits, stream)
    if rc != 0:
        msg = lib.flash_attention_bwd_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{rc} ({msg})")


flash_attention.launches = 0
flash_attention_bwd.launches = 0
