"""Time the port's kernels on the card against their plain versions, their
bound and one PyTorch library call computing the same function.

    PYTHONPATH=src python -m repro_torch.kernels.bench
    PYTHONPATH=src python -m repro_torch.kernels.bench --against OLD.cu
    PYTHONPATH=src python -m repro_torch.kernels.bench --profile

``--against`` builds another version of one kernel's source (for example
``git show REV:src/repro_torch/kernels/ssd/csrc/ssd_scan.cu > OLD.cu``) and
times both on the same card in turns (old, new, new, old), which is the only
fair way to compare two versions. The C function the library exports says
which kernel it is: ``flash_attention_fwd``, ``flash_attention_bwd``,
``ssd_scan_fwd`` or ``rglru_scan_fwd``. ``<name>_abi`` says which C
interface it has (none: version 1); sources with an older one than the
wrappers' (before the output strides and the SSD workspace, version 1; the
flash forward before its log-sum-exp output, version 2; the flash backward
before its tiled workspace, version 1) are called with their own
(``launch_old``). All write the same logical layout, which
``max|new - old|`` compares. A shape the old source does not take is
reported and skipped.

The flash-attention backward is timed at smollm-135m's training shape
beside its plain version (torch autograd of ``attention_ref``) and the
backward of ``scaled_dot_product_attention`` (``torch.autograd.grad`` of its
output, captured in a CUDA graph like the kernel, so both are device times;
the eager call is printed beside it, named so, with the backend PyTorch
picks). ``--profile`` also lists the library backward's kernels by device
time, last, as a profile of autograd's backward left later profiles in the
same process without device events.

Times are device times: the calls are captured in a CUDA graph and
replayed, so host overhead between launches is not counted. The bound is
the least time the card could take: bytes moved once at the memory rate
against the operations at the peak rate for their type (H100 SXM data
sheet, dense, at 700 W), whichever is larger. A card set below 700 W runs
slower, so every number is printed with the card's power limit. No PyTorch
call computes the SSD scan or the RG-LRU scan, so they have no library
yardstick.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# (B, H, KV, S, D, layout, window) of smollm-135m's attention: at its full
# context, and the (B, S, H, D) views a B 4, S 512 prefill passes; of
# recurrentgemma-9b's local layers in the same prefill (window 2048); and
# of qwen3-4b's and phi3.5-moe's (32 query / 8 KV heads of 128)
SHAPES = {"smollm-2048": (8, 9, 3, 2048, 64, "bhsd", None),
          "prefill-512": (4, 9, 3, 512, 64, "bshd", None),
          "recurrentgemma-512": (4, 16, 1, 512, 256, "bshd", 2048),
          "d128-512": (4, 32, 8, 512, 128, "bshd", None)}
# (B, S, H, P, N, chunk, layout) of mamba2-130m's SSD scan: the views of the
# conv output a B 4, S 512 prefill passes, and a longer contiguous batch
SSD_SHAPES = {"prefill-512": (4, 512, 24, 64, 128, 128, "view"),
              "long-2048": (8, 2048, 24, 64, 128, 128, "contiguous")}
# (B, S, W) of recurrentgemma-9b's RG-LRU scan in a B 4, S 512 prefill
RGLRU_SHAPES = {"prefill-512": (4, 512, 4096)}
# (B, H, KV, S, D, layout) of smollm-135m's attention in a B 8, S 2048
# train step, for the backward
BWD_SHAPES = {"train-2048": (8, 9, 3, 2048, 64, "bshd")}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, iters: int = 20, warmup: int = 3, stream=None) -> float:
    """Device time of one call of ``fn`` (CUDA graph of ``iters`` calls),
    warmed up and captured on ``stream`` (default: a new one)."""
    side = stream if stream is not None else torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Time of one eager call of ``fn``, host overhead included."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, top: int = 6) -> dict:
    """One call of ``fn`` under torch.profiler: the card's busy time (the
    sum of its kernels and copies), the profiled wall time, the number of
    kernels and copies (``launches``) and of kernels alone (``kernels``),
    and the kernels that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    by_name: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            us, n = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (us + ev.self_device_time_total, n + 1)
    busy_ms = sum(us for us, _ in by_name.values()) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(busy_ms=busy_ms, wall_ms=wall * 1e3,
                launches=sum(n for _, n in by_name.values()),
                kernels=sum(n for name, (_, n) in by_name.items()
                            if not name.startswith(("Memcpy", "Memset"))),
                top=[(name[:60], us / 1e3, n) for name, (us, n) in ranked])


def attention_bound(b, h, kv, sq, sk, d, dtype, causal=True, window=None):
    """(bound ms, "operations" | "bytes", flops) for attention on these
    inputs: q, k, v read and o written once, against 4 D flops for each
    (query, key) pair the mask lets through."""
    qpos = np.arange(sq)[:, None] + (sk - sq)
    kpos = np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    flops = 4.0 * b * h * d * int(mask.sum())
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * (2 * b * h * sq * d + 2 * b * kv * sk * d)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


def attention_bwd_bound(b, h, kv, sq, sk, d, dtype, causal=True,
                        window=None):
    """(bound ms, "operations" | "bytes", flops) for the attention backward
    on these inputs: q, k, v, o, do and the fp32 lse read and dq, dk, dv
    written once, against five products of 2 D flops (Q K^T, dO V^T,
    P^T dO, dS^T Q, dS K) for each (query, key) pair the mask lets
    through."""
    _, _, fwd_flops = attention_bound(b, h, kv, sq, sk, d, dtype, causal,
                                      window)
    flops = 2.5 * fwd_flops
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (size * (4 * b * h * sq * d + 4 * b * kv * sk * d)
              + 4 * b * h * sq)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


def make_qkv(gen, b, h, kv, sq, sk, d, dtype, layout):
    """Random q (B, H, Sq, D), k / v (B, KV, Sk, D) on the card; layout
    "bshd" stores them as (B, S, H, D) and returns the transposed views,
    as the model passes them."""
    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if layout == "bshd":
        return (randn((b, sq, h, d)).transpose(1, 2),
                randn((b, sk, kv, d)).transpose(1, 2),
                randn((b, sk, kv, d)).transpose(1, 2))
    return (randn((b, h, sq, d)), randn((b, kv, sk, d)),
            randn((b, kv, sk, d)))


def sdpa(q, k, v):
    """The library yardstick; the port never calls it. Causal only: it
    computes the kernel's function where a window does not bite."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)


def time_flash_attention(label: str, seed: int = 1) -> dict:
    """Kernel, plain version and library call at one of SHAPES (bf16,
    causal, within the shape's window), with the bound."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    b, h, kv, s, d, layout, window = SHAPES[label]
    if window is not None and window < s:
        raise ValueError(f"{label}: scaled_dot_product_attention's causal "
                         f"mask is not a window of {window} at S {s}")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16, layout)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    bound_ms, bound_by, flops = attention_bound(b, h, kv, s, s, d,
                                                torch.bfloat16,
                                                window=window)
    ms = graph_ms(lambda: kernel.flash_attention(q, k, v, window=window))
    return dict(
        label=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
        tflops=flops / ms / 1e9,
        plain_ms=graph_ms(lambda: attention_ref(q, k, v, window=window),
                          iters=3),
        library_ms=graph_ms(lambda: sdpa(qc, kc, vc)),
        eager_ms=eager_ms(lambda: kernel.flash_attention(q, k, v,
                                                         window=window)))


def sdpa_backend(q, k, v) -> str:
    """The backend PyTorch picks for :func:`sdpa` on these inputs (flash,
    efficient, cuDNN or math)."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, is_causal=True, enable_gqa=True)).name


def library_backward(q, k, v, do):
    """(fn, stream): ``fn`` computes the gradients of :func:`sdpa` on q, k,
    v (contiguous copies) for the output gradient ``do``, replaying the
    backward of one forward kept on ``stream``. Autograd runs each
    backward op on its forward's stream, so the forward runs there and a
    CUDA graph of ``fn`` is captured on it."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        leaves = [x.detach().contiguous().requires_grad_(True)
                  for x in (q, k, v)]
        res = sdpa(*leaves)
    return (lambda: torch.autograd.grad(res, leaves, do,
                                        retain_graph=True)), stream


def time_flash_attention_bwd(label: str, seed: int = 1) -> dict:
    """The backward kernel at one of BWD_SHAPES (bf16, causal) from the
    forward kernel's output and log-sum-exp, its plain version (torch
    autograd of ``attention_ref``, its graph kept and the backward
    replayed, eager) and the backward of ``scaled_dot_product_attention``
    (device time from a CUDA graph, and one eager call), with the bound."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    b, h, kv, s, d, layout = BWD_SHAPES[label]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16, layout)
    do = make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16, layout)[0]
    out, lse = kernel.flash_attention(q, k, v, return_lse=True)
    bound_ms, bound_by, flops = attention_bwd_bound(b, h, kv, s, s, d,
                                                    torch.bfloat16)

    def run():
        return kernel.flash_attention_bwd(q, k, v, out, lse, do)

    def backward_of(fn, inputs):
        leaves = [x.detach().requires_grad_(True) for x in inputs]
        res = fn(*leaves)
        return lambda: torch.autograd.grad(res, leaves, do,
                                           retain_graph=True)

    ms = graph_ms(run)
    plain = backward_of(attention_ref, (q, k, v))
    plain_ms = eager_ms(plain, iters=2, warmup=1)
    del plain
    library, stream = library_backward(q, k, v, do)
    return dict(
        label=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
        tflops=flops / ms / 1e9, plain_ms=plain_ms,
        library_ms=graph_ms(library, stream=stream),
        library_eager_ms=eager_ms(library),
        library_backend=sdpa_backend(q.contiguous(), k.contiguous(),
                                     v.contiguous()),
        eager_ms=eager_ms(run))


def describe_bwd(row: dict) -> str:
    b, h, kv, s, d, layout = BWD_SHAPES[row["label"]]
    return (f"flash_attention_bwd B{b} H{h} KV{kv} S{s} D{d} bf16 causal "
            f"{layout}: kernel {row['ms']:.4f} ms ({row['tflops']:.1f} "
            f"TFLOP/s), plain (autograd of attention_ref, eager) "
            f"{row['plain_ms']:.4f} ms, scaled_dot_product_attention's "
            f"backward ({row['library_backend']}) {row['library_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            f"kernel/bound {row['ms'] / row['bound_ms']:.2f}x, "
            f"kernel/library {row['ms'] / row['library_ms']:.2f}x (device "
            f"times); one eager call: kernel {row['eager_ms']:.4f} ms, "
            f"library {row['library_eager_ms']:.4f} ms")


def describe(row: dict) -> str:
    b, h, kv, s, d, layout, window = SHAPES[row["label"]]
    win = f" window {window}" if window is not None else ""
    return (f"flash_attention B{b} H{h} KV{kv} S{s} D{d} bf16 causal{win} "
            f"{layout}: kernel {row['ms']:.4f} ms ({row['tflops']:.1f} "
            f"TFLOP/s), plain {row['plain_ms']:.4f} ms, "
            f"scaled_dot_product_attention {row['library_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            f"kernel/bound {row['ms'] / row['bound_ms']:.2f}x, "
            f"kernel/library {row['ms'] / row['library_ms']:.2f}x (device "
            f"times); one eager call {row['eager_ms']:.4f} ms")


def ssd_bound(b, s, h, p, n, chunk, dtype):
    """(bound ms, "operations" | "bytes", flops) for the SSD scan on these
    inputs: x, B, C, dt and a_log read and y and the final state written
    once, against the products of the chunked algorithm at its least: C B^T
    once per (batch, chunk), as B and C are shared by the heads, on the
    lower triangle only, as are the intra-chunk products; the carried-state
    term from the second chunk on (the first one's state is zero); the
    state update. Chunks of ``min(chunk, S, 128)`` rows, as the kernel's."""
    q = min(chunk, s, 128)
    lens = [min(q, s - s0) for s0 in range(0, s, q)]
    tri = sum(L * (L + 1) // 2 for L in lens)
    flops = 2.0 * b * n * tri                        # C B^T
    flops += 2.0 * b * h * p * tri                   # (G) (x dt)
    flops += 2.0 * b * h * p * n * sum(lens[1:])     # C h
    flops += 2.0 * b * h * p * n * s                 # B^T (x dt rem)
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (size * (2 * b * s * h * p + 2 * b * s * n)
              + 4 * (b * s * h + h + b * h * p * n))
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


def make_ssd_inputs(gen, b, s, h, p, n, dtype, layout):
    """Random x (B,S,H,P), dt (B,S,H) (softplus'ed), a_log (H,), b / c
    (B,S,N) on the card, as tests/test_kernels.py draws them; layout "view"
    cuts x, b and c out of one (B, S, H P + 2 N) tensor, as the model's
    conv output, and "unaligned" out of one with a column more, whose rows
    are not 16-byte aligned."""
    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(randn((b, s, h)))
    a_log = randn((h,)) * 0.5
    if layout in ("view", "unaligned"):
        extra = int(layout == "unaligned")
        conv = randn((b, s, h * p + 2 * n + extra)).to(dtype)
        x = conv[..., :h * p].reshape(b, s, h, p)
        return x, dt, a_log, conv[..., h * p:h * p + n], \
            conv[..., h * p + n:h * p + 2 * n]
    return (randn((b, s, h, p)).to(dtype), dt, a_log,
            randn((b, s, n)).to(dtype), randn((b, s, n)).to(dtype))


def time_ssd_scan(label: str, seed: int = 1) -> dict:
    """Kernel and plain version at one of SSD_SHAPES (bf16), with the
    bound and the CUDA kernels one call launches (torch.profiler); no
    library call computes this function."""
    from repro_torch.kernels.ssd import kernel
    from repro_torch.kernels.ssd.ref import ssd_ref
    b, s, h, p, n, chunk, layout = SSD_SHAPES[label]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = make_ssd_inputs(gen, b, s, h, p, n, torch.bfloat16, layout)
    bound_ms, bound_by, flops = ssd_bound(b, s, h, p, n, chunk,
                                          torch.bfloat16)
    ms = graph_ms(lambda: kernel.ssd_scan(*args, chunk=chunk))
    return dict(
        label=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
        tflops=flops / ms / 1e9,
        cuda_kernels=device_profile(
            lambda: kernel.ssd_scan(*args, chunk=chunk))["kernels"],
        plain_ms=graph_ms(lambda: ssd_ref(*args), iters=2, warmup=1),
        library_ms=None,
        eager_ms=eager_ms(lambda: kernel.ssd_scan(*args, chunk=chunk)))


def describe_ssd(row: dict) -> str:
    b, s, h, p, n, chunk, layout = SSD_SHAPES[row["label"]]
    return (f"ssd_scan B{b} S{s} H{h} P{p} N{n} chunk {chunk} bf16 "
            f"{layout}: kernel {row['ms']:.4f} ms ({row['tflops']:.2f} "
            f"TFLOP/s, {row['cuda_kernels']} CUDA kernels a call), plain "
            f"{row['plain_ms']:.4f} ms, library call none, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
            f"kernel/bound {row['ms'] / row['bound_ms']:.2f}x (device "
            f"times); one eager call {row['eager_ms']:.4f} ms")


def rglru_bound(b, s, w):
    """(bound ms, "operations" | "bytes", flops) for the RG-LRU scan on
    these inputs: a and b read and h written once (fp32), against one
    multiply-add per element at the fp32 rate."""
    flops = 2.0 * b * s * w
    nbytes = 3 * 4 * b * s * w
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops)


def make_rglru_inputs(gen, b, s, w):
    """Random decays a in (0, 0.99) and inputs b, (B, S, W) fp32 on the
    card, as tests/test_kernels.py draws them."""
    a = torch.sigmoid(torch.randn((b, s, w), generator=gen,
                                  device="cuda")) * 0.99
    return a, torch.randn((b, s, w), generator=gen, device="cuda")


def time_rglru_scan(label: str, seed: int = 1) -> dict:
    """Kernel and plain version at one of RGLRU_SHAPES (fp32), with the
    bound; no library call computes this function."""
    from repro_torch.kernels.rglru import kernel
    from repro_torch.kernels.rglru.ref import rglru_ref
    b, s, w = RGLRU_SHAPES[label]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a, bb = make_rglru_inputs(gen, b, s, w)
    bound_ms, bound_by, flops = rglru_bound(b, s, w)
    ms = graph_ms(lambda: kernel.rglru_scan(a, bb))
    return dict(
        label=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
        gbps=3 * 4 * b * s * w / ms / 1e6,
        plain_ms=graph_ms(lambda: rglru_ref(a, bb), iters=2, warmup=1),
        library_ms=None,
        eager_ms=eager_ms(lambda: kernel.rglru_scan(a, bb)))


def describe_rglru(row: dict) -> str:
    b, s, w = RGLRU_SHAPES[row["label"]]
    return (f"rglru_scan B{b} S{s} W{w} fp32: kernel {row['ms']:.4f} ms "
            f"({row['gbps']:.0f} GB/s), plain {row['plain_ms']:.4f} ms, "
            f"library call none, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); kernel/bound "
            f"{row['ms'] / row['bound_ms']:.2f}x (device times); one eager "
            f"call {row['eager_ms']:.4f} ms")


def ptxas_report(log: str) -> list:
    """["entry: N registers, S bytes spill stores", ...] from nvcc's
    ``-Xptxas -v`` output, then its notes on wgmma (products serialised)."""
    out, entry, spill = [], None, "0"
    notes = [line.strip() for line in log.splitlines()
             if "wgmma.mma_async" in line]
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append(f"{entry}: {m.group(1)} registers, {spill} bytes "
                       "spill stores")
            entry, spill = None, "0"
    return out + notes


def profile_kernels(seed: int = 1) -> None:
    """One call of each kernel at each of its shapes under torch.profiler:
    the device time of every CUDA kernel it launched (the SSD scan and the
    flash backward launch three); last, the library backward's kernels."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru import kernel as rglru
    from repro_torch.kernels.ssd import kernel as ssd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    calls = {}
    for label, (b, h, kv, s, d, layout, window) in SHAPES.items():
        q, k, v = make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16, layout)
        calls[f"flash_attention {label}"] = (
            lambda q=q, k=k, v=v, w=window: flash.flash_attention(
                q, k, v, window=w))
    for label, (b, s, h, p, n, chunk, layout) in SSD_SHAPES.items():
        args = make_ssd_inputs(gen, b, s, h, p, n, torch.bfloat16, layout)
        calls[f"ssd_scan {label}"] = (
            lambda a=args, c=chunk: ssd.ssd_scan(*a, chunk=c))
    for label, shape in RGLRU_SHAPES.items():
        a, bb = make_rglru_inputs(gen, *shape)
        calls[f"rglru_scan {label}"] = (
            lambda a=a, bb=bb: rglru.rglru_scan(a, bb))
    for label, (b, h, kv, s, d, layout) in BWD_SHAPES.items():
        q, k, v = make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16, layout)
        do = torch.randn_like(q)
        out, lse = flash.flash_attention(q, k, v, return_lse=True)
        calls[f"flash_attention_bwd {label}"] = (
            lambda a=(q, k, v, out, lse, do): flash.flash_attention_bwd(*a))
        calls[f"scaled_dot_product_attention backward {label}"] = \
            library_backward(q, k, v, do)[0]
    for name, fn in calls.items():
        prof = device_profile(fn, top=8)
        print(f"profile {name}: busy {prof['busy_ms'] * 1e3:.1f} us; "
              + "; ".join(f"{k} {ms * 1e3:.1f} us x{n}"
                          for k, ms, n in prof["top"]), flush=True)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# The C interfaces older than the wrappers': flash_attention.cu and
# ssd_scan.cu before the output strides and the SSD workspace (version 1:
# flash attention wrote a contiguous (B, H, Sq, D) output, the SSD scan
# took no workspace), flash_attention.cu before the log-sum-exp output
# (version 2), and flash_attention_bwd.cu before its tiled workspace
# (version 1: the same arguments, a workspace of delta (B, H, Sq), then
# dQ's sums (B, H, Sq, D))
OLD_ARGTYPES = {("flash_attention", 1): (_P, _P, _P, _P, *(_I,) * 7,
                                         *(_L,) * 9, _I, _I, ctypes.c_float,
                                         ctypes.c_float, _P),
                ("flash_attention", 2): (_P, _P, _P, _P, *(_I,) * 7,
                                         *(_L,) * 12, _I, _I, ctypes.c_float,
                                         ctypes.c_float, _P),
                ("ssd_scan", 1): (*(_P,) * 7, *(_I,) * 7, *(_L,) * 10, _P),
                ("flash_attention_bwd", 1): (*(_P,) * 10, *(_I,) * 7,
                                             *(_L,) * 24, _I, _I,
                                             ctypes.c_float, ctypes.c_float,
                                             _P)}
# the C interface versions the wrappers call
CURRENT = {"flash_attention": 3, "ssd_scan": 2, "flash_attention_bwd": 2}
# each kernel's C entry point
ENTRY = {"flash_attention": "flash_attention_fwd", "ssd_scan": "ssd_scan_fwd",
         "rglru_scan": "rglru_scan_fwd",
         "flash_attention_bwd": "flash_attention_bwd"}


def old_bwd_workspace_numel(b: int, h: int, sq: int, d: int) -> int:
    """fp32 elements of a version-1 backward's workspace."""
    return b * h * sq * (d + 1)


def interface_version(lib: ctypes.CDLL, name: str) -> int:
    """The C interface version of a library built from some version of
    ``name``'s source: what its ``<name>_abi`` returns, or 1 where it
    exports none."""
    if not hasattr(lib, f"{name}_abi"):
        return 1
    fn = getattr(lib, f"{name}_abi")
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def launch_old(name: str, version: int, lib: ctypes.CDLL, *args) -> None:
    """Call a library of ``name`` with an older C interface on the current
    stream: flash_attention (q, k, v, out, window), causal (version 1:
    ``out`` contiguous; version 2: through its strides, no log-sum-exp);
    ssd_scan version 1 (x, dt, a_log, b, c, y, h_final, chunk);
    flash_attention_bwd version 1 (q, k, v, o, lse, do, dq, dk, dv,
    workspace of ``old_bwd_workspace_numel``), causal."""
    fwd = getattr(lib, ENTRY[name])
    fwd.argtypes, fwd.restype = OLD_ARGTYPES[name, version], ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    stream = torch.cuda.current_stream().cuda_stream
    if name == "flash_attention_bwd":
        q, k, v, o, lse, do, dq, dk, dv, ws = args
        b, h, sq, d = q.shape
        if ws.numel() < old_bwd_workspace_numel(b, h, sq, d):
            raise ValueError("a version-1 backward needs a larger workspace")
        rc = fwd(*(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv,
                                           ws)),
                 1 if q.dtype == torch.bfloat16 else 0, b, h, k.shape[1], sq,
                 k.shape[2], d, *(st for t in (q, k, v, o, do, dq, dk, dv)
                                  for st in t.stride()[:3]),
                 1, 0, 0.0, 1.0 / math.sqrt(d), stream)
    elif name == "flash_attention":
        q, k, v, out, window = args
        if version == 1 and not out.is_contiguous():
            raise ValueError("a version-1 library writes a contiguous out")
        b, h, sq, d = q.shape
        out_strides = () if version == 1 else out.stride()[:3]
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 1 if q.dtype == torch.bfloat16 else 0, b, h, k.shape[1],
                 sq, k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *out_strides, 1, window or 0, 0.0,
                 1.0 / math.sqrt(d), stream)
    else:
        x, dt, a_log, b, c, y, h_final, chunk = args
        bsz, s, h, p = x.shape
        rc = fwd(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(),
                 b.data_ptr(), c.data_ptr(), y.data_ptr(),
                 h_final.data_ptr(), 1 if x.dtype == torch.bfloat16 else 0,
                 bsz, s, h, p, b.shape[-1], chunk, *x.stride()[:3],
                 *dt.stride(), *b.stride()[:2], *c.stride()[:2], stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def compare(old_source: Path, seed: int = 1):
    """Time another build of one kernel's source against the current one,
    in turns (old, new, new, old), at each of that kernel's shapes."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru import kernel as rglru
    from repro_torch.kernels.ssd import kernel as ssd
    built = build.load(old_source)
    print(f"{old_source}: " + "; ".join(ptxas_report(built.log)), flush=True)
    lib = built.lib
    if hasattr(lib, "ssd_scan_fwd"):
        name, module, shapes = "ssd_scan", ssd, SSD_SHAPES
    elif hasattr(lib, "rglru_scan_fwd"):
        name, module, shapes = "rglru_scan", rglru, RGLRU_SHAPES
    elif hasattr(lib, "flash_attention_bwd"):
        name, module, shapes = "flash_attention_bwd", flash, BWD_SHAPES
    else:
        name, module, shapes = "flash_attention", flash, SHAPES
    # rglru_scan's has not changed: it exports no version
    version = interface_version(lib, name)
    current = version == CURRENT.get(name, 1)
    if not current and (name, version) not in OLD_ARGTYPES:
        raise ValueError(f"{old_source}: unknown C interface version "
                         f"{version}")
    if current:
        (flash.bind_bwd if name == "flash_attention_bwd"
         else module.bind)(lib)
    print(f"{old_source}: {name}, C interface version {version}",
          flush=True)
    for label in shapes:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if name == "flash_attention_bwd":
            b, h, kv, s, d, layout = BWD_SHAPES[label]
            q, k, v = make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16,
                               layout)
            do = torch.randn_like(q)
            o, lse = flash.flash_attention(q, k, v, return_lse=True)
            grads = [torch.empty_like(t) for t in (q, k, v)]
            ws = torch.empty(
                (flash.bwd_workspace_numel if current
                 else old_bwd_workspace_numel)(b, h, s, d), device="cuda")

            def run_old():
                if not current:
                    launch_old(name, version, lib, q, k, v, o, lse, do,
                               *grads, ws)
                else:
                    flash.launch_bwd(lib, q, k, v, o, lse, do, *grads, ws,
                                     causal=True, window=None, softcap=None)

            def run_new():
                return flash.flash_attention_bwd(q, k, v, o, lse, do)
            out = grads
        elif name == "rglru_scan":
            a, bb = make_rglru_inputs(gen, *shapes[label])
            out = torch.empty_like(a)

            def run_old():
                rglru.launch(lib, a, bb, None, out)

            def run_new():
                return rglru.rglru_scan(a, bb)
        elif name == "ssd_scan":
            b, s, h, p, n, chunk, layout = SSD_SHAPES[label]
            args = make_ssd_inputs(gen, b, s, h, p, n, torch.bfloat16,
                                   layout)
            y = torch.empty((b, s, h, p), dtype=torch.bfloat16,
                            device="cuda")
            hf = torch.empty((b, h, p, n), device="cuda")
            rows = ssd.chunk_rows(s, chunk)
            ws = torch.empty(ssd.workspace_numel(b, s, h, p, n, chunk,
                                                 torch.bfloat16),
                             device="cuda")

            def run_old():
                if not current:
                    launch_old(name, version, lib, *args, y, hf, rows)
                else:
                    ssd.launch(lib, *args, y, hf, ws, chunk=rows)

            def run_new():
                return ssd.ssd_scan(*args, chunk=chunk)[0]
            out = y
        else:
            b, h, kv, s, d, layout, window = SHAPES[label]
            q, k, v = make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16,
                               layout)
            out = torch.empty(q.shape, dtype=q.dtype, device="cuda")

            def run_old():
                if not current:
                    launch_old(name, version, lib, q, k, v, out, window)
                else:
                    flash.launch(lib, q, k, v, out, causal=True,
                                 window=window, softcap=None)

            def run_new():
                return flash.flash_attention(q, k, v, window=window)
        new = run_new()
        try:
            run_old()
        except RuntimeError as err:   # e.g. a head_dim the old one lacks
            print(f"{name} {label}: the old source does not run this "
                  f"shape ({err}); skipped", flush=True)
            continue
        torch.cuda.synchronize()
        diff = max((n.float() - o.float()).abs().max().item() for n, o in
                   zip(*((t,) if torch.is_tensor(t) else t
                         for t in (new, out))))
        old1, new1, new2, old2 = (graph_ms(fn) for fn in
                                  (run_old, run_new, run_new, run_old))
        print(f"{name} {label}: old "
              f"{old1:.4f} / {old2:.4f} ms, new {new1:.4f} / {new2:.4f} ms "
              f"(old, new, new, old); max|new - old| {diff:.3e}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, nargs="+", default=[],
                    help="other versions of flash_attention.cu, "
                         "flash_attention_bwd.cu, ssd_scan.cu or "
                         "rglru_scan.cu to compare, each in turns with the "
                         "current one")
    ap.add_argument("--profile", action="store_true",
                    help="also the device time of each CUDA kernel one "
                         "call launches (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device available", file=sys.stderr)
        return 2
    print(card(), flush=True)
    for label in SHAPES:
        print(describe(time_flash_attention(label)), flush=True)
    for label in SSD_SHAPES:
        print(describe_ssd(time_ssd_scan(label)), flush=True)
    for label in RGLRU_SHAPES:
        print(describe_rglru(time_rglru_scan(label)), flush=True)
    if args.profile:
        profile_kernels()
    # after every profile: autograd's backward (the library yardstick) has
    # left later profiles in the same process without device events
    for label in BWD_SHAPES:
        print(describe_bwd(time_flash_attention_bwd(label)), flush=True)
    for old_source in args.against:
        compare(old_source)
    return 0


if __name__ == "__main__":
    sys.exit(main())
