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
``ssd_scan_fwd``, ``ssd_scan_bwd`` or ``rglru_scan_fwd`` (an RG-LRU source
is timed forward and backward). ``<name>_abi`` says which C interface it
has (none: version 1); sources with an older one than the wrappers'
(before the output strides and the SSD workspace, version 1; the flash
forward before its log-sum-exp output, version 2; the flash backward before
its tiled workspace, version 1, and before its D 256 route's splits,
version 2; the SSD backward before its bf16 workspace without per-head rows,
version 1; the RG-LRU backward before its chained workspace, version 1)
are called with their own (``launch_old``). All write the same logical
layout, which ``max|new - old|`` compares. A shape the old source does not
take is reported and skipped: a version-1 flash backward takes no window.

The flash-attention backward is timed at the training calls of
``BWD_SHAPES`` beside its plain version (torch
autograd of ``attention_ref``) and the backward of
``scaled_dot_product_attention`` (``torch.autograd.grad`` of its output,
captured in a CUDA graph like the kernel, so both are device times; the
eager call is printed beside it, named so, with the backend PyTorch picks;
with a window, through an explicit boolean mask; with a softcap, as at
gemma2-27b's calls, where ``scaled_dot_product_attention`` cannot cap the
scores, the backward of ``flex_attention`` compiled by ``torch.compile``,
the cap its ``score_mod`` and the mask a block mask). The SSD and RG-LRU
backward kernels are timed at mamba2-130m's and recurrentgemma-9b's
training shapes beside their plain versions (torch autograd of
``ssd_ref`` and ``rglru_ref``, the backward replayed eagerly).
``--profile`` also lists the library backward's kernels by device time.
Every profile is held to the kernels the wrappers launched
(``check_profile``): in a process in torch.profiler's lossy state each
session loses its first kernel records (``profiler_repro.py``), which
``session``'s sentinel kernels absorb.

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
from collections import Counter
from pathlib import Path

import torch

from repro_torch.kernels import CUDA_KERNELS, work
from repro_torch.roofline.hardware import (PEAK_BF16_FLOPS, PEAK_BYTES,
                                           PEAK_FP32_FLOPS)

# (B, H, KV, S, D, layout, window, softcap) of smollm-135m's attention: at
# its full context, and the (B, S, H, D) views a B 4, S 512 prefill passes;
# of recurrentgemma-9b's local layers in the same prefill (window 2048); of
# qwen3-4b's and phi3.5-moe's (32 query / 8 KV heads of 128); of
# paligemma-3b's (8 query heads on 1 KV head of 256, 256 patches and 256
# tokens); and the forward's calls in the train steps: qwen3-4b's at B 2,
# S 4096 (whole, and on one model coordinate's heads at model_ways 2:
# 16 query / 4 KV), recurrentgemma-9b's at B 1, S 4096, where the window
# bites (whole, and on one model coordinate's 8 of 16 heads at model_ways
# 2, its one KV head whole), gemma2-27b's local layer at B 1, S 4352 (32
# query / 16 KV heads of 128, window 4096, scores capped at 50),
# paligemma-3b's at B 8 (256 patches and 256 tokens), granite-3-2b's at
# B 2, S 4096 (32 query / 8 KV heads of 64) and seamless-m4t-medium's
# decoder at B 8 (2048 of the 4096 positions; 16 heads of 64). All causal.
SHAPES = {"smollm-2048": (8, 9, 3, 2048, 64, "bhsd", None, None),
          "prefill-512": (4, 9, 3, 512, 64, "bshd", None, None),
          "recurrentgemma-512": (4, 16, 1, 512, 256, "bshd", 2048, None),
          "d128-512": (4, 32, 8, 512, 128, "bshd", None, None),
          "paligemma-512": (4, 8, 1, 512, 256, "bshd", None, None),
          "qwen3-4096": (2, 32, 8, 4096, 128, "bshd", None, None),
          "qwen3-tp2-4096": (2, 16, 4, 4096, 128, "bshd", None, None),
          "recurrentgemma-4096": (1, 16, 1, 4096, 256, "bshd", 2048, None),
          "recurrentgemma-tp2-4096": (1, 8, 1, 4096, 256, "bshd", 2048,
                                      None),
          "gemma2-4352": (1, 32, 16, 4352, 128, "bshd", 4096, 50.0),
          "paligemma-train-512": (8, 8, 1, 512, 256, "bshd", None, None),
          "granite-4096": (2, 32, 8, 4096, 64, "bshd", None, None),
          "seamless-dec-2048": (8, 16, 16, 2048, 64, "bshd", None, None)}
# (B, H, KV, Sq, Sk, D, layout) of seamless-m4t-medium's attention without a
# causal mask (16 heads of 64): its encoder's in a B 4 prefill of 512
# frames, which is also the cross attention's call of 512 tokens over them,
# the cross attention of 264 tokens over 256 frames, and in its B 8 train
# step of 2048 frames and 2048 tokens the encoder's call, which is also the
# cross attention's (the same shape, mask and layout: every frame attended)
NONCAUSAL_SHAPES = {"seamless-512": (4, 16, 16, 512, 512, 64, "bshd"),
                    "seamless-cross-264": (4, 16, 16, 264, 256, 64, "bshd"),
                    "seamless-2048": (8, 16, 16, 2048, 2048, 64, "bshd")}
# (B, S, H, P, N, chunk, layout) of mamba2-130m's SSD scan: the views of the
# conv output a B 4, S 512 prefill passes, a longer contiguous batch, and
# one model coordinate's 12 of 24 heads in a B 8, S 2048 train step at
# model_ways 2
SSD_SHAPES = {"prefill-512": (4, 512, 24, 64, 128, 128, "view"),
              "long-2048": (8, 2048, 24, 64, 128, 128, "contiguous"),
              "train-tp2-2048": (8, 2048, 12, 64, 128, 128, "view")}
# (B, S, W) of recurrentgemma-9b's RG-LRU scan in a B 4, S 512 prefill and
# in its B 1, S 4096 train step (whole, and one model coordinate's 2048
# channels at model_ways 2)
RGLRU_SHAPES = {"prefill-512": (4, 512, 4096), "train-4096": (1, 4096, 4096),
                "train-tp2-4096": (1, 4096, 2048)}
# (B, H, KV, S, D, layout, window, softcap) of smollm-135m's attention in a
# B 8, S 2048 train step, of recurrentgemma-9b's local layers in a B 1,
# S 4096 one (window 2048), of qwen3-4b's in a B 2, S 4096 one (32 query /
# 8 KV heads of 128; 16 / 4 on each model coordinate at model_ways 2), and
# of the train steps of gemma2-27b's local layer, paligemma-3b,
# granite-3-2b and seamless-m4t-medium's decoder (SHAPES' calls of the same
# names), for the backward; without a causal mask, seamless's encoder and
# cross attention in its train step (NONCAUSAL_SHAPES' call)
BWD_SHAPES = {"train-2048": (8, 9, 3, 2048, 64, "bshd", None, None),
              "recurrentgemma-4096": (1, 16, 1, 4096, 256, "bshd", 2048,
                                      None),
              "qwen3-4096": (2, 32, 8, 4096, 128, "bshd", None, None),
              "qwen3-tp2-4096": (2, 16, 4, 4096, 128, "bshd", None, None),
              "recurrentgemma-tp2-4096": (1, 8, 1, 4096, 256, "bshd", 2048,
                                          None),
              "gemma2-4352": (1, 32, 16, 4352, 128, "bshd", 4096, 50.0),
              "paligemma-train-512": (8, 8, 1, 512, 256, "bshd", None,
                                      None),
              "granite-4096": (2, 32, 8, 4096, 64, "bshd", None, None),
              "seamless-dec-2048": (8, 16, 16, 2048, 64, "bshd", None,
                                    None)}
NONCAUSAL_BWD_SHAPES = {"seamless-2048": NONCAUSAL_SHAPES["seamless-2048"]}
# the CUDA kernels one call launches at the timed (bf16) shapes: the SSD
# scan's three passes, its backward's four (bf16 route); the flash
# backward's three (delta, the main pass, dq), four on the bf16 D 256 route
# where its blocks split a key tile (flash_bwd_dkdv_sum adds their parts)
SSD_KERNELS, SSD_BWD_KERNELS = 3, 4
# the scans' backward at their training shapes: mamba2-130m's B 8, S 2048
# (the views of the conv output), recurrentgemma-9b's B 1, S 4096; and at
# one model coordinate's share of each at model_ways 2
SSD_BWD_SHAPES = {"train-2048": (8, 2048, 24, 64, 128, 128, "view"),
                  "train-tp2-2048": (8, 2048, 12, 64, 128, 128, "view")}
RGLRU_BWD_SHAPES = {"train-4096": (1, 4096, 4096),
                    "train-tp2-4096": (1, 4096, 2048)}


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


def base_name(name: str) -> str:
    """A CUDA kernel's own name from the profiler's: no return type,
    namespace, template arguments or parameters."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void\s+)?([\w:]+)", name)
    return m.group(1).rsplit("::", 1)[-1] if m else name


def port_kernels() -> frozenset:
    """Every CUDA kernel of the port's routes, by base_name."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.reshard import kernel as box
    from repro_torch.kernels.rglru import kernel as rglru
    from repro_torch.kernels.ssd import kernel as ssd
    names = set(rglru.CUDA_KERNEL + rglru.BWD_CUDA_KERNEL + box.CUDA_KERNEL)
    for dtype in (torch.float32, torch.bfloat16):
        names.update(flash.cuda_kernels(dtype), ssd.cuda_kernels(dtype),
                     ssd.bwd_cuda_kernels(dtype))
        for d in flash.HEAD_DIMS:
            names.update(flash.bwd_cuda_kernels(dtype, d, 2))
    return frozenset(names)


def check_profile(events, launched, what: str) -> None:
    """Raise unless one profiled interval's device events, ``events`` [(name,
    device ms)], hold at least one event and list each CUDA kernel that the
    port's wrappers launched in the interval, ``launched`` ({kernel name:
    launches}, from CUDA_KERNELS), as often, by name, each with device time
    above 0. Every busy reading passes through here: torch.profiler loses
    kernel records in some processes (profiler_repro.py), and a reading
    missing a kernel would pass for a faster call. A reading that fails is
    not retried."""
    if not events:
        raise RuntimeError(f"the profile of {what} holds no device event")
    ours = port_kernels()
    seen, timeless = Counter(), Counter()
    for name, ms in events:
        base = base_name(name)
        if base in ours:
            seen[base] += 1
            timeless[base] += ms <= 0
    timeless = +timeless
    if seen != launched or timeless:
        raise RuntimeError(
            f"the profile of {what} lists the port's CUDA kernels "
            f"{dict(seen)}, {sum(timeless.values())} of them without device "
            f"time {dict(timeless)}; the wrappers launched {dict(launched)}")


# the marks between the intervals of one profiler session (session): a
# spin kernel (``torch.cuda._sleep``), finished before and after, so that
# the intervals are cut on the card's own clock (the host's
# record_function marks can lie a millisecond off the kernels' CUPTI
# times); and the small kernels a session launches before its first mark
# and after its last: in a process where torch.profiler loses records, a
# session loses its first kernels, mostly one to three, rarely dozens
# (profiler_repro.py; PERF.md, section 7), and these are they
MARK, MARK_CYCLES, SENTINELS = "spin_kernel", 20000, 256


def sentinel() -> None:
    """SENTINELS small CUDA kernels, finished: a session's first launches,
    and its last, outside every interval."""
    if torch.cuda.is_available():
        for _ in range(SENTINELS):
            torch.zeros(1, device="cuda")
        torch.cuda.synchronize()


def session(fns) -> list:
    """One torch.profiler session over ``fns`` (callables), each called once
    between marks (MARK's kernel, the card synchronised on each side),
    between the sentinel's kernels: for each, (the device events of its
    interval [(name, device ms)], the CUDA kernels the port's wrappers
    launched in it, a Counter). A device event belongs to the interval
    between the marks it starts between, on the card's clock. The events
    are Kineto's own (``kineto_results.events()``, each kernel's duration
    as CUPTI recorded it), not the parse ``prof.events()`` makes of them.
    Raises where the session does not list every mark, or none of the
    sentinel's kernels before the first or after the last: it may then
    have lost more, inside an interval. Without a card every interval is
    empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    card = torch.cuda.is_available()

    def mark():
        torch.cuda.synchronize()
        if card:
            torch.cuda._sleep(MARK_CYCLES)
            torch.cuda.synchronize()
    launched = []
    if card:
        # the allocator's cached blocks handed back first: in the zoo's
        # child, whose models hold most of the card, sessions lost their
        # marks without it (PERF.md, section 7)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sentinel()
        for fn in fns:
            mark()
            before = Counter(CUDA_KERNELS)
            fn()
            launched.append(CUDA_KERNELS - before)
        mark()
        sentinel()
    events = sorted((ev for ev in prof.profiler.kineto_results.events()
                     if ev.device_type() == DeviceType.CUDA),
                    key=lambda ev: ev.start_ns())
    marks = [i for i, ev in enumerate(events)
             if base_name(ev.name()) == MARK]
    out = [[] for _ in fns]
    if not card:
        return list(zip(out, launched))
    if len(marks) != len(fns) + 1:
        raise RuntimeError(
            f"the profile lists {len(marks)} of its {len(fns) + 1} marks, "
            f"at {marks} of {len(events)} device events; first "
            f"{[base_name(ev.name()) for ev in events[:3]]}, last "
            f"{[base_name(ev.name()) for ev in events[-3:]]}")
    if marks[0] == 0 or marks[-1] == len(events) - 1:
        raise RuntimeError(f"the profile lost all {SENTINELS} kernels the "
                           f"session began or ended with")
    for i, (lo, hi) in enumerate(zip(marks, marks[1:])):
        out[i] = [(ev.name(), ev.duration_ns() / 1e6)
                  for ev in events[lo + 1:hi]]
    return list(zip(out, launched))


def profiled(fns, whats) -> list:
    """session(fns), each interval held by check_profile (``whats`` names
    them): [each interval's device events]."""
    out = session(fns)
    for (events, launched), what in zip(out, whats):
        check_profile(events, launched, what)
    return [events for events, _ in out]


def device_profile(fn, top: int = 6, what: str = "a call") -> dict:
    """One call of ``fn`` (after one untimed) under torch.profiler, held by
    check_profile: the card's busy time (the sum of its kernels and
    copies), the number of kernels and copies (``launches``) and of kernels
    alone (``kernels``), and the kernels that took the most device time."""
    fn()
    torch.cuda.synchronize()
    events, = profiled([fn], [what])
    by_name: dict = {}
    for name, ms in events:
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + ms, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return dict(busy_ms=sum(t for t, _ in by_name.values()),
                launches=sum(n for _, n in by_name.values()),
                kernels=sum(n for name, (_, n) in by_name.items()
                            if not name.startswith(("Memcpy", "Memset"))),
                top=[(name[:60], t, n) for name, (t, n) in ranked])


def split_kernels(fn, want: int, what: str) -> list:
    """Each CUDA kernel one call of ``fn`` launches, (name, device ms,
    count), from device_profile (held by check_profile); raises unless the
    profile saw ``want`` kernel launches, the route's count, each with
    device time."""
    prof = device_profile(fn, top=64, what=what)
    kernels = [(name, ms, n) for name, ms, n in prof["top"]
               if not name.startswith(("Memcpy", "Memset"))]
    launched = sum(n for *_, n in kernels)
    if launched != want or any(ms <= 0 for _, ms, _ in kernels):
        raise RuntimeError(
            f"the profile of one {what} call saw {launched} CUDA kernel "
            f"launches, {sum(ms <= 0 for _, ms, _ in kernels)} of them "
            f"without device time; the route launches {want}: {kernels}")
    return kernels


def flash_bwd_kernels(label: str, seed: int = 1) -> list:
    """split_kernels of the flash backward at a label of bwd_call (bf16),
    from the forward kernel's output and log-sum-exp: three CUDA kernels,
    or four on the D 256 route with more than one split."""
    from repro_torch.kernels.flash_attention import kernel
    b, h, kv, sq, sk, d, layout, causal, window, softcap = bwd_call(label)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = make_qkv(gen, b, h, kv, sq, sk, d, torch.bfloat16, layout)
    do = torch.randn_like(q)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = kernel.flash_attention(q, k, v, return_lse=True, **kw)
    splits = kernel.bwd_splits(b, h, kv, sk, d, torch.bfloat16)
    return split_kernels(
        lambda: kernel.flash_attention_bwd(q, k, v, out, lse, do, **kw),
        3 + (splits > 1), f"flash_attention_bwd {label}")


def bound(flops: float, nbytes: float, peak: float):
    """(bound ms, "operations" | "bytes") of work that takes ``flops`` at
    ``peak`` FLOP/s and moves ``nbytes`` at the HBM rate, whichever takes
    longer."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _peak(dtype) -> float:
    return PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS


def _itemsize(dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def capped(ms: float, by: str, cap_ops: float):
    """(ms, by) of a bound, or the time of a softcap's ``cap_ops`` fp32
    operations at the card's fp32 rate where that takes longer: they run
    on the CUDA cores, beside the products on the tensor cores."""
    cap_ms = 1e3 * cap_ops / PEAK_FP32_FLOPS
    return (cap_ms, "operations") if cap_ms > ms else (ms, by)


def attention_bound(b, h, kv, sq, sk, d, dtype, causal=True, window=None,
                    softcap=None):
    """(bound ms, "operations" | "bytes", flops) for attention on these
    inputs (``work.attention_work``; with a ``softcap``, its operations
    too, ``work.softcap_ops``)."""
    flops, nbytes = work.attention_work(b, h, kv, sq, sk, d, _itemsize(dtype),
                                        causal, window)
    ms, by = bound(flops, nbytes, _peak(dtype))
    if softcap is not None:
        ms, by = capped(ms, by, work.softcap_ops(b, h, sq, sk, causal,
                                                 window))
    return ms, by, flops


def attention_bwd_bound(b, h, kv, sq, sk, d, dtype, causal=True,
                        window=None, softcap=None):
    """(bound ms, "operations" | "bytes", flops) for the attention backward
    on these inputs (``work.attention_bwd_work``; with a ``softcap``, its
    operations too, ``work.softcap_ops``)."""
    flops, nbytes = work.attention_bwd_work(b, h, kv, sq, sk, d,
                                            _itemsize(dtype), causal, window)
    ms, by = bound(flops, nbytes, _peak(dtype))
    if softcap is not None:
        ms, by = capped(ms, by, work.softcap_ops(b, h, sq, sk, causal, window,
                                                 backward=True))
    return ms, by, flops


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


def sdpa(q, k, v, causal: bool = True, mask=None):
    """The library yardstick; the port never calls it. It computes the
    kernel's function where a window does not bite (causal calls here are
    square, where its top-left mask is the kernel's), and under an explicit
    ``mask`` (window_mask) where one does."""
    if mask is not None:
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)


def flash_call(label: str) -> tuple:
    """(B, H, KV, Sq, Sk, D, layout, causal, window, softcap) of a label of
    SHAPES or NONCAUSAL_SHAPES."""
    if label in SHAPES:
        b, h, kv, s, d, layout, window, softcap = SHAPES[label]
        return b, h, kv, s, s, d, layout, True, window, softcap
    b, h, kv, sq, sk, d, layout = NONCAUSAL_SHAPES[label]
    return b, h, kv, sq, sk, d, layout, False, None, None


def bwd_call(label: str) -> tuple:
    """(B, H, KV, Sq, Sk, D, layout, causal, window, softcap) of a label of
    BWD_SHAPES or NONCAUSAL_BWD_SHAPES."""
    if label in BWD_SHAPES:
        b, h, kv, s, d, layout, window, softcap = BWD_SHAPES[label]
        return b, h, kv, s, s, d, layout, True, window, softcap
    b, h, kv, sq, sk, d, layout = NONCAUSAL_BWD_SHAPES[label]
    return b, h, kv, sq, sk, d, layout, False, None, None


def max_norm_err(got, want) -> float:
    """max |got - want| over max |want|, in fp32."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def flex_library(q, k, v, causal: bool = True, window=None,
                 softcap=None):
    """The library yardstick where a softcap is on, which
    ``scaled_dot_product_attention`` cannot apply (it adds a mask or a bias
    to the scores): a function (q, k, v) -> output of
    ``torch.nn.attention.flex_attention`` with the cap ``c * tanh(s / c)``
    as its ``score_mod``, the causal and window mask as a block mask (query
    rows right-aligned to the keys, as the kernel's) and GQA; compiled by
    ``torch.compile`` on the card (its fused Triton kernels), eager on the
    CPU (the scores materialised). The port never calls it."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    sq, sk = q.shape[2], k.shape[2]

    def score_mod(score, b, h, q_idx, kv_idx):
        return softcap * torch.tanh(score / softcap)

    def mask_mod(b, h, q_idx, kv_idx):
        lag = q_idx + (sk - sq) - kv_idx
        keep = lag >= 0 if causal else lag > -sk
        return keep & (lag < window) if window is not None else keep

    block_mask = None
    if causal or window is not None:
        block_mask = create_block_mask(mask_mod, None, None, sq, sk,
                                       device=q.device)
    fn = (torch.compile(flex_attention, dynamic=False) if q.is_cuda
          else flex_attention)
    return lambda q, k, v: fn(
        q, k, v, score_mod=None if softcap is None else score_mod,
        block_mask=block_mask, enable_gqa=True)


def flex_compiled(fn):
    """``fn()``'s first call, where torch.compile builds its kernels, in
    this process (no pool of compile workers left behind)."""
    from torch._inductor import config
    with config.patch(compile_threads=1):
        out = fn()
    torch.cuda.synchronize()
    return out


def warm_flex(label: str) -> None:
    """The first calls of flex_library's forward and backward at a label
    of SHAPES with a softcap (and BWD_SHAPES', the same call), as
    time_flash_attention and time_flash_attention_bwd make them, untimed:
    run in another process first, they leave torch.compile's caches on
    disk warm for those calls."""
    b, h, kv, sq, sk, d, layout, causal, window, softcap = flash_call(label)
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = make_qkv(gen, b, h, kv, sq, sk, d, torch.bfloat16, layout)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    flex = flex_library(qc, kc, vc, causal=causal, window=window,
                        softcap=softcap)
    flex_compiled(lambda: flex(qc, kc, vc))
    library, stream = library_backward(q, k, v, torch.randn_like(q), window,
                                       softcap)
    with torch.cuda.stream(stream):
        flex_compiled(library)


def time_flash_attention(label: str, seed: int = 1) -> dict:
    """Kernel, plain version and library call at one of SHAPES (bf16,
    causal, within the shape's window: where it bites, the library call
    takes it as an explicit mask; with a softcap the library call is
    flex_library's, its max-normalised distance from the plain version in
    the row, ``library_err``) or
    NONCAUSAL_SHAPES, with the bound."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    b, h, kv, sq, sk, d, layout, causal, window, softcap = flash_call(label)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = make_qkv(gen, b, h, kv, sq, sk, d, torch.bfloat16, layout)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    mask = (window_mask(sk, window, q.device)
            if window is not None and window < sk else None)
    kw = dict(causal=causal, window=window, softcap=softcap)
    bound_ms, bound_by, flops = attention_bound(b, h, kv, sq, sk, d,
                                                torch.bfloat16, **kw)
    ms = graph_ms(lambda: kernel.flash_attention(q, k, v, **kw))
    if softcap is None:
        library = {"library_ms": graph_ms(lambda: sdpa(qc, kc, vc, causal,
                                                       mask)),
                   "library_backend": sdpa_backend(qc, kc, vc, mask,
                                                   causal)}
    else:
        flex = flex_library(qc, kc, vc, **kw)
        got = flex_compiled(lambda: flex(qc, kc, vc))
        library = {"library_ms": graph_ms(lambda: flex(qc, kc, vc)),
                   "library_backend": "flex_attention",
                   "library_err": max_norm_err(got, attention_ref(q, k, v,
                                                                  **kw))}
        del got
    return dict(
        label=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
        tflops=flops / ms / 1e9,
        plain_ms=graph_ms(lambda: attention_ref(q, k, v, **kw), iters=3),
        **library,
        eager_ms=eager_ms(lambda: kernel.flash_attention(q, k, v, **kw)))


def sdpa_backend(q, k, v, mask=None, causal: bool = True) -> str:
    """The backend PyTorch picks for :func:`sdpa` on these inputs (flash,
    efficient, cuDNN or math), or for the call with an explicit ``mask``
    in place of the causal one."""
    from torch.nn.attention import SDPBackend
    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True)).name


def window_mask(s: int, window: int, device) -> torch.Tensor:
    """(S, S) bool: key j is attended from query i where i - window < j <=
    i, the kernel's causal sliding window."""
    pos = torch.arange(s, device=device)
    diff = pos[:, None] - pos[None, :]
    return (diff >= 0) & (diff < window)


def library_backward(q, k, v, do, window=None, softcap=None,
                     causal: bool = True):
    """(fn, stream): ``fn`` computes the gradients of :func:`sdpa` on q, k,
    v (contiguous copies; ``causal`` or not) for the output gradient
    ``do``, replaying the
    backward of one forward kept on ``stream``; with a ``window``, of
    ``scaled_dot_product_attention`` under that window's explicit mask;
    with a ``softcap``, of :func:`flex_library` (causal, ``window``).
    Autograd runs each backward op on its forward's stream, so the forward
    runs there and a CUDA graph of ``fn`` is captured on it."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        leaves = [x.detach().contiguous().requires_grad_(True)
                  for x in (q, k, v)]
        if softcap is not None:
            flex = flex_library(*leaves, window=window, softcap=softcap)
            res = flex_compiled(lambda: flex(*leaves))
        elif window is None:
            res = sdpa(*leaves, causal)
        else:
            res = torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=window_mask(q.shape[2], window, q.device),
                enable_gqa=True)
    return (lambda: torch.autograd.grad(res, leaves, do,
                                        retain_graph=True)), stream


def time_flash_attention_bwd(label: str, seed: int = 1) -> dict:
    """The backward kernel at a label of bwd_call (bf16) from the
    forward kernel's output and log-sum-exp, its plain version (torch
    autograd of ``attention_ref``, its graph kept and the backward
    replayed, eager) and the backward of ``scaled_dot_product_attention``
    (device time from a CUDA graph, and one eager call; with a softcap,
    of flex_library's, its largest max-normalised distance from the plain
    gradients over dq, dk and dv in the row, ``library_err``), with the
    bound."""
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    b, h, kv, sq, sk, d, layout, causal, window, softcap = bwd_call(label)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = make_qkv(gen, b, h, kv, sq, sk, d, torch.bfloat16, layout)
    do = make_qkv(gen, b, h, kv, sq, sk, d, torch.bfloat16, layout)[0]
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = kernel.flash_attention(q, k, v, return_lse=True, **kw)
    bound_ms, bound_by, flops = attention_bwd_bound(
        b, h, kv, sq, sk, d, torch.bfloat16, **kw)

    def run():
        return kernel.flash_attention_bwd(q, k, v, out, lse, do, **kw)

    ms = graph_ms(run)
    plain = backward_of(lambda *t: attention_ref(*t, **kw), (q, k, v), do)
    plain_ms = eager_ms(plain, iters=2, warmup=1)
    if softcap is None:
        del plain
        library, stream = library_backward(q, k, v, do, window,
                                           causal=causal)
        lib = {"library_ms": graph_ms(library, stream=stream),
               "library_eager_ms": eager_ms(library),
               "library_backend": sdpa_backend(
                   q.contiguous(), k.contiguous(), v.contiguous(),
                   None if window is None
                   else window_mask(sq, window, q.device), causal)}
    else:
        want = plain()
        del plain
        library, stream = library_backward(q, k, v, do, window, softcap)
        with torch.cuda.stream(stream):
            got = flex_compiled(library)
        err = max(max_norm_err(g, w) for g, w in zip(got, want))
        del got, want
        lib = {"library_ms": graph_ms(library, stream=stream),
               "library_eager_ms": eager_ms(library),
               "library_backend": "flex_attention",
               "library_err": err}
    return dict(
        label=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
        tflops=flops / ms / 1e9, plain_ms=plain_ms, **lib,
        eager_ms=eager_ms(run))


def backward_of(fn, inputs, grad):
    """A function replaying the backward of ``fn`` on detached copies of
    ``inputs`` (their graph kept) for the output gradient ``grad`` (a
    tuple for several outputs): the plain version's backward time."""
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    res = fn(*leaves)
    return lambda: torch.autograd.grad(res, leaves, grad, retain_graph=True)


def options(window, softcap) -> str:
    """" window W", " softcap C", both or nothing."""
    return ((f" window {window}" if window is not None else "")
            + (f" softcap {softcap:g}" if softcap is not None else ""))


def library_name(row: dict, explicit: bool = False) -> str:
    """The library call of a flash row, with its backend: cuDNN's or
    another backend of ``scaled_dot_product_attention`` (``explicit``:
    under an explicit mask), or ``flex_attention`` with its distance from
    the plain version."""
    if row["library_backend"] == "flex_attention":
        return (f"flex_attention (torch.compile, the softcap its score_mod; "
                f"{row['library_err']:.3e} from plain, max-normalised)")
    return (f"scaled_dot_product_attention ({row['library_backend']}"
            f"{', explicit mask' if explicit else ''})")


def describe_bwd(row: dict) -> str:
    b, h, kv, sq, sk, d, layout, causal, window, softcap = bwd_call(
        row["label"])
    length = f"S{sq}" if sq == sk else f"Sq{sq} Sk{sk}"
    mask = "causal" if causal else "non-causal"
    return (f"flash_attention_bwd B{b} H{h} KV{kv} {length} D{d} bf16 {mask}"
            f"{options(window, softcap)} {layout}: kernel {row['ms']:.4f} "
            f"ms ({row['tflops']:.1f} TFLOP/s), plain (autograd of "
            f"attention_ref, eager) {row['plain_ms']:.4f} ms, the backward "
            f"of {library_name(row)} {row['library_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); kernel/bound "
            f"{row['ms'] / row['bound_ms']:.2f}x, kernel/library "
            f"{row['ms'] / row['library_ms']:.2f}x (device times); one eager "
            f"call: kernel {row['eager_ms']:.4f} ms, library "
            f"{row['library_eager_ms']:.4f} ms")


def describe(row: dict) -> str:
    b, h, kv, sq, sk, d, layout, causal, window, softcap = flash_call(
        row["label"])
    length = f"S{sq}" if sq == sk else f"Sq{sq} Sk{sk}"
    mask = ("causal" if causal else "non-causal") + options(window, softcap)
    library = library_name(row, window is not None and window < sk)
    return (f"flash_attention B{b} H{h} KV{kv} {length} D{d} bf16 {mask} "
            f"{layout}: kernel {row['ms']:.4f} ms ({row['tflops']:.1f} "
            f"TFLOP/s), plain {row['plain_ms']:.4f} ms, {library} "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); kernel/bound "
            f"{row['ms'] / row['bound_ms']:.2f}x, kernel/library "
            f"{row['ms'] / row['library_ms']:.2f}x (device times); one eager "
            f"call {row['eager_ms']:.4f} ms")


def ssd_bound(b, s, h, p, n, chunk, dtype):
    """(bound ms, "operations" | "bytes", flops) for the SSD scan on these
    inputs (``work.ssd_work``)."""
    flops, nbytes = work.ssd_work(b, s, h, p, n, chunk, _itemsize(dtype))
    return (*bound(flops, nbytes, _peak(dtype)), flops)


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
    passes = split_kernels(lambda: kernel.ssd_scan(*args, chunk=chunk),
                           SSD_KERNELS, f"ssd_scan {label}")
    return dict(
        label=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
        tflops=flops / ms / 1e9, passes=passes,
        cuda_kernels=sum(n for *_, n in passes),
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


def ssd_bwd_bound(b, s, h, p, n, chunk, dtype):
    """(bound ms, "operations" | "bytes", flops) for the SSD scan's backward
    on these inputs (``work.ssd_bwd_work``)."""
    flops, nbytes = work.ssd_bwd_work(b, s, h, p, n, chunk, _itemsize(dtype))
    return (*bound(flops, nbytes, _peak(dtype)), flops)


def _ssd_bwd_call(label: str, seed: int):
    """(a call of the backward kernel at one of SSD_BWD_SHAPES (bf16), from
    the forward kernel's workspace, its inputs, dy)."""
    from repro_torch.kernels.ssd import kernel
    b, s, h, p, n, chunk, layout = SSD_BWD_SHAPES[label]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    args = make_ssd_inputs(gen, b, s, h, p, n, torch.bfloat16, layout)
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(
        torch.bfloat16)
    _, _, ws = kernel.ssd_scan(*args, chunk=chunk, keep_workspace=True)
    return (lambda: kernel.ssd_scan_bwd(*args, dy, None, ws, chunk=chunk),
            args, dy)


def ssd_bwd_kernels(label: str, seed: int = 1) -> list:
    """split_kernels of the SSD backward at one of SSD_BWD_SHAPES; profile
    it before any autograd backward of the process, as flash_bwd_kernels."""
    return split_kernels(_ssd_bwd_call(label, seed)[0], SSD_BWD_KERNELS,
                         f"ssd_scan_bwd {label}")


def time_ssd_scan_bwd(label: str, seed: int = 1, passes=None) -> dict:
    """The backward kernel at one of SSD_BWD_SHAPES (bf16), from the
    forward kernel's workspace, with the bound, the CUDA kernels one call
    launches (``passes``, ssd_bwd_kernels' split, else split here before
    the plain version's autograd backward) and its plain version (torch
    autograd of ``ssd_ref``, its graph kept and the backward replayed,
    eager); no library call computes this function."""
    from repro_torch.kernels.ssd.ref import ssd_ref
    b, s, h, p, n, chunk, layout = SSD_BWD_SHAPES[label]
    run, args, dy = _ssd_bwd_call(label, seed)
    bound_ms, bound_by, flops = ssd_bwd_bound(b, s, h, p, n, chunk,
                                              torch.bfloat16)
    ms = graph_ms(run)
    if passes is None:
        passes = split_kernels(run, SSD_BWD_KERNELS, f"ssd_scan_bwd {label}")
    plain = backward_of(lambda *t: ssd_ref(*t)[0], args, dy)
    plain_ms = eager_ms(plain, iters=1, warmup=1)
    del plain
    return dict(label=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                tflops=flops / ms / 1e9,
                cuda_kernels=sum(n for *_, n in passes), passes=passes,
                plain_ms=plain_ms, library_ms=None, eager_ms=eager_ms(run))


def describe_ssd_bwd(row: dict) -> str:
    b, s, h, p, n, chunk, layout = SSD_BWD_SHAPES[row["label"]]
    return (f"ssd_scan_bwd B{b} S{s} H{h} P{p} N{n} chunk {chunk} bf16 "
            f"{layout}: kernel {row['ms']:.4f} ms ({row['tflops']:.2f} "
            f"TFLOP/s, {row['cuda_kernels']} CUDA kernels a call), plain "
            f"(autograd of ssd_ref, eager) {row['plain_ms']:.4f} ms, "
            f"library call none, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}); kernel/bound "
            f"{row['ms'] / row['bound_ms']:.2f}x (device times); one eager "
            f"call {row['eager_ms']:.4f} ms; by CUDA kernel under the "
            f"profiler: " + "; ".join(f"{name} {ms:.4f} ms x{n}"
                                      for name, ms, n in row["passes"]))


def rglru_bound(b, s, w):
    """(bound ms, "operations" | "bytes", flops) for the RG-LRU scan on
    these inputs (``work.rglru_work``, fp32)."""
    flops, nbytes = work.rglru_work(b, s, w)
    return (*bound(flops, nbytes, PEAK_FP32_FLOPS), flops)


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


def rglru_bwd_bound(b, s, w):
    """(bound ms, "operations" | "bytes", flops) for the RG-LRU scan's
    backward (``work.rglru_bwd_work``, fp32)."""
    flops, nbytes = work.rglru_bwd_work(b, s, w)
    return (*bound(flops, nbytes, PEAK_FP32_FLOPS), flops)


def time_rglru_scan_bwd(label: str, seed: int = 1) -> dict:
    """The backward kernel at one of RGLRU_BWD_SHAPES (fp32, no initial
    state, as the model calls it) from the forward kernel's output, with
    the bound and its plain version (torch autograd of ``rglru_ref``, the
    backward replayed, eager); no library call computes this function."""
    from repro_torch.kernels.rglru import kernel
    from repro_torch.kernels.rglru.ref import rglru_ref
    b, s, w = RGLRU_BWD_SHAPES[label]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a, bb = make_rglru_inputs(gen, b, s, w)
    dh = torch.randn((b, s, w), generator=gen, device="cuda")
    h = kernel.rglru_scan(a, bb)
    bound_ms, bound_by, _ = rglru_bwd_bound(b, s, w)

    def run():
        return kernel.rglru_scan_bwd(a, h, None, dh)
    ms = graph_ms(run)
    plain = backward_of(rglru_ref, (a, bb), dh)
    plain_ms = eager_ms(plain, iters=1, warmup=1)
    del plain
    return dict(label=label, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                gbps=5 * 4 * b * s * w / ms / 1e6, plain_ms=plain_ms,
                library_ms=None, eager_ms=eager_ms(run))


def describe_rglru_bwd(row: dict) -> str:
    b, s, w = RGLRU_BWD_SHAPES[row["label"]]
    return (f"rglru_scan_bwd B{b} S{s} W{w} fp32: kernel {row['ms']:.4f} "
            f"ms ({row['gbps']:.0f} GB/s), plain (autograd of rglru_ref, "
            f"eager) {row['plain_ms']:.4f} ms, library call none, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); kernel/bound "
            f"{row['ms'] / row['bound_ms']:.2f}x (device times); one eager "
            f"call {row['eager_ms']:.4f} ms")


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
    flash backward launch three, the SSD backward four in bf16); last, the
    library backwards' kernels."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru import kernel as rglru
    from repro_torch.kernels.ssd import kernel as ssd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    calls = {}
    for label, (b, h, kv, s, d, layout, window, cap) in SHAPES.items():
        q, k, v = make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16, layout)
        calls[f"flash_attention {label}"] = (
            lambda q=q, k=k, v=v, w=window, c=cap: flash.flash_attention(
                q, k, v, window=w, softcap=c))
    for label, (b, s, h, p, n, chunk, layout) in SSD_SHAPES.items():
        args = make_ssd_inputs(gen, b, s, h, p, n, torch.bfloat16, layout)
        calls[f"ssd_scan {label}"] = (
            lambda a=args, c=chunk: ssd.ssd_scan(*a, chunk=c))
    for label, shape in RGLRU_SHAPES.items():
        a, bb = make_rglru_inputs(gen, *shape)
        calls[f"rglru_scan {label}"] = (
            lambda a=a, bb=bb: rglru.rglru_scan(a, bb))
    for label, (b, s, h, p, n, chunk, layout) in SSD_BWD_SHAPES.items():
        args = make_ssd_inputs(gen, b, s, h, p, n, torch.bfloat16, layout)
        dy = torch.randn_like(args[0])
        ws = ssd.ssd_scan(*args, chunk=chunk, keep_workspace=True)[2]
        calls[f"ssd_scan_bwd {label}"] = (
            lambda a=args, dy=dy, ws=ws, c=chunk: ssd.ssd_scan_bwd(
                *a, dy, None, ws, chunk=c))
    for label, shape in RGLRU_BWD_SHAPES.items():
        a, bb = make_rglru_inputs(gen, *shape)
        h, dh = rglru.rglru_scan(a, bb), torch.randn_like(a)
        calls[f"rglru_scan_bwd {label}"] = (
            lambda a=a, h=h, dh=dh: rglru.rglru_scan_bwd(a, h, None, dh))
    for label in (*BWD_SHAPES, *NONCAUSAL_BWD_SHAPES):
        b, h, kv, sq, sk, d, layout, causal, window, cap = bwd_call(label)
        q, k, v = make_qkv(gen, b, h, kv, sq, sk, d, torch.bfloat16, layout)
        do = torch.randn_like(q)
        kw = dict(causal=causal, window=window, softcap=cap)
        out, lse = flash.flash_attention(q, k, v, return_lse=True, **kw)
        calls[f"flash_attention_bwd {label}"] = (
            lambda a=(q, k, v, out, lse, do), kw=kw:
            flash.flash_attention_bwd(*a, **kw))
        if cap is None:
            calls[f"scaled_dot_product_attention backward {label}"] = \
                library_backward(q, k, v, do, window, causal=causal)[0]
    for name, fn in calls.items():
        prof = device_profile(fn, top=8, what=name)
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
# dQ's sums (B, H, Sq, D)), and ssd_scan_bwd.cu before its bf16 route ran
# on the tensor cores (version 1: the same arguments, a workspace of
# old_ssd_bwd_workspace_numel floats)
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
                                             _P),
                ("flash_attention_bwd", 2): (*(_P,) * 10, *(_I,) * 7,
                                             *(_L,) * 24, _I, _I,
                                             ctypes.c_float, ctypes.c_float,
                                             _P),
                ("ssd_scan_bwd", 1): (*(_P,) * 14, *(_I,) * 7, *(_L,) * 13,
                                      _P),
                ("rglru_scan_bwd", 1): (*(_P,) * 7, _I, _I, _I, *(_L,) * 4,
                                        _P)}
# the C interface versions the wrappers call
CURRENT = {"flash_attention": 3, "ssd_scan": 2, "flash_attention_bwd": 3,
           "ssd_scan_bwd": 2, "rglru_scan_bwd": 2}
# each kernel's C entry point
ENTRY = {"flash_attention": "flash_attention_fwd", "ssd_scan": "ssd_scan_fwd",
         "rglru_scan": "rglru_scan_fwd",
         "flash_attention_bwd": "flash_attention_bwd",
         "ssd_scan_bwd": "ssd_scan_bwd", "rglru_scan_bwd": "rglru_scan_bwd"}
# each source's error-string function, where it is not <name>_error_string
ERROR_STRING = {"rglru_scan_bwd": "rglru_scan_error_string"}


def old_bwd_workspace_numel(b: int, h: int, sq: int, d: int) -> int:
    """fp32 elements of a version-1 backward's workspace."""
    return b * h * sq * (d + 1)


def old_ssd_bwd_workspace_numel(b: int, s: int, h: int, p: int, n: int,
                                chunk: int, dtype: torch.dtype) -> int:
    """fp32 elements of a version-1 SSD backward's workspace: per (batch,
    chunk, head) a P x N fp32 state gradient (for bf16 an fp32 incoming
    state besides) and an fp64 da_log share; per (batch, row, head) an fp64
    row less column sum, the carried term and the per-head dB and dC
    rows."""
    q = min(chunk, s, 128)
    slots = b * (-(-s // q)) * h
    rows = b * s * h
    states = slots * p * n * (2 if dtype == torch.bfloat16 else 1)
    return states + 2 * rows + 2 * slots + rows + 2 * rows * n


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
    stream: flash_attention (q, k, v, out, window, softcap), causal
    (version 1: ``out`` contiguous; version 2: through its strides, no
    log-sum-exp);
    ssd_scan version 1 (x, dt, a_log, b, c, y, h_final, chunk);
    flash_attention_bwd (q, k, v, o, lse, do, dq, dk, dv, workspace,
    window, softcap), causal: version 1 with a workspace of
    ``old_bwd_workspace_numel`` and no window, version 2 with one of
    ``bwd_workspace_numel``; ssd_scan_bwd version 1 (x, dt, a_log, b, c,
    dy, dh_final, the forward's workspace, dx, ddt, da_log, db, dc,
    workspace of ``old_ssd_bwd_workspace_numel``, chunk); rglru_scan_bwd
    version 1 (a, h, h0, dh, da, db, dh0)."""
    fwd = getattr(lib, ENTRY[name])
    fwd.argtypes, fwd.restype = OLD_ARGTYPES[name, version], ctypes.c_int
    err = getattr(lib, ERROR_STRING.get(name, f"{name}_error_string"))
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    stream = torch.cuda.current_stream().cuda_stream
    if name == "ssd_scan_bwd":
        from repro_torch.kernels.ssd import kernel as ssd
        *tensors, ws, chunk = args
        x, b = tensors[0], tensors[3]
        if ws.numel() < old_ssd_bwd_workspace_numel(
                *x.shape, b.shape[-1], chunk, x.dtype):
            raise ValueError("a version-1 SSD backward needs a larger "
                             "workspace")
        ssd.launch_bwd(lib, *tensors, ws, chunk=chunk)
        return
    if name == "rglru_scan_bwd":
        a, h, h0, dh, da, db, dh0 = args
        bsz, s, w = a.shape
        rc = fwd(*(t.data_ptr() if t is not None else None
                   for t in (a, h, h0, dh, da, db, dh0)),
                 bsz, s, w, a.stride(0), a.stride(1), dh.stride(0),
                 dh.stride(1), stream)
    elif name == "flash_attention_bwd":
        from repro_torch.kernels.flash_attention import kernel as flash
        q, k, v, o, lse, do, dq, dk, dv, ws, window, softcap = args
        b, h, sq, d = q.shape
        if version == 1 and window is not None:
            raise ValueError("a version-1 backward takes no window")
        need = (old_bwd_workspace_numel if version == 1
                else flash.bwd_workspace_numel)(b, h, sq, d)
        if ws.numel() < need:
            raise ValueError(f"a version-{version} backward needs a larger "
                             "workspace")
        rc = fwd(*(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv,
                                           ws)),
                 1 if q.dtype == torch.bfloat16 else 0, b, h, k.shape[1], sq,
                 k.shape[2], d, *(st for t in (q, k, v, o, do, dq, dk, dv)
                                  for st in t.stride()[:3]),
                 1, window or 0, float(softcap or 0.0), 1.0 / math.sqrt(d),
                 stream)
    elif name == "flash_attention":
        q, k, v, out, window, softcap = args
        if version == 1 and not out.is_contiguous():
            raise ValueError("a version-1 library writes a contiguous out")
        b, h, sq, d = q.shape
        out_strides = () if version == 1 else out.stride()[:3]
        rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 1 if q.dtype == torch.bfloat16 else 0, b, h, k.shape[1],
                 sq, k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
                 *v.stride()[:3], *out_strides, 1, window or 0,
                 float(softcap or 0.0), 1.0 / math.sqrt(d), stream)
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


def kernel_of(lib) -> str:
    """Which kernel a library built from some version of one of the port's
    sources computes, by the C entry point it exports."""
    for name in ("ssd_scan", "ssd_scan_bwd", "rglru_scan",
                 "flash_attention_bwd"):
        if hasattr(lib, ENTRY[name]):
            return name
    return "flash_attention"


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
    name = kernel_of(lib)
    module, shapes = {"ssd_scan": (ssd, SSD_SHAPES),
                      "ssd_scan_bwd": (ssd, SSD_BWD_SHAPES),
                      "rglru_scan": (rglru, RGLRU_SHAPES),
                      "flash_attention_bwd": (flash, BWD_SHAPES),
                      "flash_attention": (flash, SHAPES)}[name]
    # rglru_scan's has not changed: it exports no version
    version = interface_version(lib, name)
    current = version == CURRENT.get(name, 1)
    if not current and (name, version) not in OLD_ARGTYPES:
        raise ValueError(f"{old_source}: unknown C interface version "
                         f"{version}")
    if current:
        {"flash_attention_bwd": flash.bind_bwd,
         "ssd_scan_bwd": ssd.bind_bwd}.get(name, module.bind)(lib)
    print(f"{old_source}: {name}, C interface version {version}",
          flush=True)
    # an RG-LRU source holds the backward too: timed at its train shape
    jobs = [(name, label) for label in shapes]
    if name == "rglru_scan":
        jobs += [("rglru_scan_bwd", label) for label in RGLRU_BWD_SHAPES]
    for kind, label in jobs:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if kind == "flash_attention_bwd":
            b, h, kv, s, d, layout, window, softcap = BWD_SHAPES[label]
            if window is not None and version == 1:
                print(f"{name} {label}: a window, which a version-1 source "
                      "does not take; skipped", flush=True)
                continue
            q, k, v = make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16,
                               layout)
            do = torch.randn_like(q)
            o, lse = flash.flash_attention(q, k, v, window=window,
                                           softcap=softcap, return_lse=True)
            grads = [torch.empty_like(t) for t in (q, k, v)]
            splits = flash.bwd_splits(b, h, kv, s, d, torch.bfloat16)
            ws = torch.empty(
                old_bwd_workspace_numel(b, h, s, d) if version == 1
                else flash.bwd_workspace_numel(b, h, s, d)
                + (flash.bwd_partials_numel(splits, b, kv, s, d)
                   if current else 0), device="cuda")

            def run_old():
                if not current:
                    launch_old(name, version, lib, q, k, v, o, lse, do,
                               *grads, ws, window, softcap)
                else:
                    flash.launch_bwd(lib, q, k, v, o, lse, do, *grads, ws,
                                     causal=True, window=window,
                                     softcap=softcap, splits=splits)

            def run_new():
                return flash.flash_attention_bwd(q, k, v, o, lse, do,
                                                 window=window,
                                                 softcap=softcap)
            out = grads
        elif kind == "rglru_scan_bwd":
            b, s, w = RGLRU_BWD_SHAPES[label]
            a, bb = make_rglru_inputs(gen, b, s, w)
            dh = torch.randn((b, s, w), generator=gen, device="cuda")
            h = rglru.rglru_scan(a, bb)
            out = [torch.empty_like(a), torch.empty_like(a)]
            bwd_version = interface_version(lib, kind)
            ws = torch.empty(rglru.bwd_workspace_numel(b, s, w),
                             device="cuda")

            def run_old():
                if bwd_version != CURRENT[kind]:
                    launch_old(kind, bwd_version, lib, a, h, None, dh, *out,
                               None)
                else:
                    rglru.launch_bwd(lib, a, h, None, dh, *out, None, ws)

            def run_new():
                return rglru.rglru_scan_bwd(a, h, None, dh)[:2]
        elif kind == "ssd_scan_bwd":
            b, s, h, p, n, chunk, layout = SSD_BWD_SHAPES[label]
            args = make_ssd_inputs(gen, b, s, h, p, n, torch.bfloat16,
                                   layout)
            dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(
                torch.bfloat16)
            fws = ssd.ssd_scan(*args, chunk=chunk, keep_workspace=True)[2]
            out = [torch.empty((b, s, h, p), dtype=torch.bfloat16,
                               device="cuda"),
                   torch.empty((b, s, h), device="cuda"),
                   torch.empty((h,), device="cuda"),
                   *(torch.empty((b, s, n), dtype=torch.bfloat16,
                                 device="cuda") for _ in range(2))]
            ws = torch.empty(
                (ssd.bwd_workspace_numel if current
                 else old_ssd_bwd_workspace_numel)(b, s, h, p, n, chunk,
                                                   torch.bfloat16),
                device="cuda")
            rows = ssd.chunk_rows(s, chunk)

            def run_old():
                if not current:
                    launch_old(name, version, lib, *args, dy, None, fws,
                               *out, ws, rows)
                else:
                    ssd.launch_bwd(lib, *args, dy, None, fws, *out, ws,
                                   chunk=rows)

            def run_new():
                return ssd.ssd_scan_bwd(*args, dy, None, fws, chunk=chunk)
        elif kind == "rglru_scan":
            a, bb = make_rglru_inputs(gen, *shapes[label])
            out = torch.empty_like(a)

            def run_old():
                rglru.launch(lib, a, bb, None, out)

            def run_new():
                return rglru.rglru_scan(a, bb)
        elif kind == "ssd_scan":
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
            b, h, kv, s, d, layout, window, softcap = SHAPES[label]
            q, k, v = make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16,
                               layout)
            out = torch.empty(q.shape, dtype=q.dtype, device="cuda")

            def run_old():
                if not current:
                    launch_old(name, version, lib, q, k, v, out, window,
                               softcap)
                else:
                    flash.launch(lib, q, k, v, out, causal=True,
                                 window=window, softcap=softcap)

            def run_new():
                return flash.flash_attention(q, k, v, window=window,
                                             softcap=softcap)
        new = run_new()
        try:
            run_old()
        except RuntimeError as err:   # e.g. a head_dim the old one lacks
            print(f"{kind} {label}: the old source does not run this "
                  f"shape ({err}); skipped", flush=True)
            continue
        torch.cuda.synchronize()
        diff = max((n.float() - o.float()).abs().max().item() for n, o in
                   zip(*((t,) if torch.is_tensor(t) else t
                         for t in (new, out))))
        old1, new1, new2, old2 = (graph_ms(fn) for fn in
                                  (run_old, run_new, run_new, run_old))
        print(f"{kind} {label}: old "
              f"{old1:.4f} / {old2:.4f} ms, new {new1:.4f} / {new2:.4f} ms "
              f"(old, new, new, old); max|new - old| {diff:.3e}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, nargs="+", default=[],
                    help="other versions of flash_attention.cu, "
                         "flash_attention_bwd.cu, ssd_scan.cu, "
                         "ssd_scan_bwd.cu or rglru_scan.cu to compare, each "
                         "in turns with the current one")
    ap.add_argument("--profile", action="store_true",
                    help="also the device time of each CUDA kernel one "
                         "call launches (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench: no CUDA device available", file=sys.stderr)
        return 2
    print(card(), flush=True)
    for label in (*SHAPES, *NONCAUSAL_SHAPES):
        print(describe(time_flash_attention(label)), flush=True)
    for label in SSD_SHAPES:
        print(describe_ssd(time_ssd_scan(label)), flush=True)
    for label in RGLRU_SHAPES:
        print(describe_rglru(time_rglru_scan(label)), flush=True)
    for label in SSD_BWD_SHAPES:
        print(describe_ssd_bwd(time_ssd_scan_bwd(label)), flush=True)
    for label in RGLRU_BWD_SHAPES:
        print(describe_rglru_bwd(time_rglru_scan_bwd(label)), flush=True)
    if args.profile:
        profile_kernels()
    for label in (*BWD_SHAPES, *NONCAUSAL_BWD_SHAPES):
        print(describe_bwd(time_flash_attention_bwd(label)), flush=True)
    for old_source in args.against:
        compare(old_source)
    return 0


if __name__ == "__main__":
    sys.exit(main())
