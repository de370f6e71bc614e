"""Binding of the hand-written CUDA flash-attention kernel.

The kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention``. It is built with
``nvcc`` for sm_90a into a shared library with a plain C interface (see
:mod:`repro_torch.kernels.build`) and called through ``ctypes`` on
PyTorch's current stream. The wrapper allocates the output, checks what the
kernel takes and raises on the rest, and raises when the launch reports an
error. ``flash_attention.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import build

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Q_TILE = 64          # query rows per fp32 block (BQ in the source)
MAX_Q_TILES = 65535  # the grid's second axis

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, *(_L,) * 12,
              _I, _I, ctypes.c_float, ctypes.c_float, _P)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface's argument and result types on a library
    built from this kernel's source."""
    lib.flash_attention_fwd.argtypes = _ARGTYPES
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load() -> build.Built:
    """Build (at first use) and load the kernel library, once per process:
    a launch then touches no file."""
    built = build.load(SOURCE)
    bind(built.lib)
    return built


def _check(q, k, v, causal: bool, window: Optional[int],
           softcap: Optional[float]):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
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
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D), on the card."""
    _check(q, k, v, causal, window, softcap)
    out = output_buffer(q)
    launch(load().lib, q, k, v, out, causal=causal, window=window,
           softcap=softcap)
    flash_attention.launches += 1
    return out


def output_buffer(q) -> torch.Tensor:
    """The output for q (B, H, Sq, D): a (B, Sq, H, D) tensor viewed as
    (B, H, Sq, D), the layout the model's o-projection reads, so the
    model's transpose back is free and its reshape copies nothing."""
    b, h, sq, d = q.shape
    return torch.empty((b, sq, h, d), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def launch(lib: ctypes.CDLL, q, k, v, out, *, causal: bool,
           window: Optional[int], softcap: Optional[float]) -> None:
    """Run the kernel of ``lib`` (bound by :func:`bind`) on checked inputs
    into ``out`` on the current stream; raise if the launch reports an
    error. Counts nothing: :func:`flash_attention` does."""
    b, h, sq, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
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


flash_attention.launches = 0
