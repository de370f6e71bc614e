#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's serving and training paths, the paper's apps and the reconfiguration-cost calibration on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught but the
fit's FitError in (t)):

  (a) device   -- the card's name and power limit (nvidia-smi)
  (b) build    -- nvcc builds the flash-attention forward and backward,
                  SSD-scan and RG-LRU scan kernels from src/, all at once
  (c) flash    -- the flash-attention kernel against its plain version, at
                  head_dim 32-256 (recurrentgemma's local layers: D 256,
                  window 2048; slice 9's D 128 prefills: 32 / 8, 16 / 16
                  and 32 / 16 heads with softcap 50, and gemma2's local
                  layer at S 4352, window 4096)
  (p) backward -- the flash-attention backward kernel (dq, dk, dv from the
                  forward's log-sum-exp) against torch autograd of the
                  plain version, on (c)'s cases and smollm's training call;
                  the forward's log-sum-exp against the plain scores
  (d) ssd      -- the SSD-scan kernel (three CUDA kernels a call) against
                  its plain version and the chunked path (y and the final
                  state), up to B 8, S 2048 (16 chunks of state passing)
  (l) rglru    -- the RG-LRU scan kernel against its plain version (ragged
                  S, S 1, an initial state)
  smollm-135m at full width (seeded random weights):
  (e) prefill  -- B 4, S 512: logits through the kernel against
                  attn_impl="chunked"; exactly 30 launches per prefill
  (f) decode   -- prefill, then decode steps, against forward's logits
  (g) server   -- Server.run: 8 requests, batch 4, max_len 256, 16 tokens
  (q) train    -- B 8, S 2048: one fp32 train step (loss and every
                  gradient) through the kernels against attn_impl="chunked";
                  20 bf16 steps of ElasticTrainer.train, the loss falling;
                  exactly 60 forward and 30 backward flash launches a step
                  (remat recomputes each layer's forward); mamba2's
                  loss.backward() on the card raises (its SSD kernel has no
                  backward yet)
  mamba2-130m at full width (seeded random weights):
  (h) prefill  -- B 4, S 512: fp32 logits and cache through the kernel
                  against the same weights' plain path on the CPU; bf16 by
                  its distance from fp32; exactly 24 launches per prefill
  (i) decode   -- prefill, then decode steps, against forward's logits
  (j) server   -- Server.run as (g)
  recurrentgemma-9b at full width, cut to 8 layers (two (rglru, rglru,
  local) units and the 2-layer rglru tail of the 38-layer model), seeded
  random weights at the 38-layer model's scale:
  (m) prefill  -- B 4, S 512 bf16: exactly 2 flash-attention and 6 RG-LRU
                  launches per prefill; then one unit, fp32, B 1, S 2304
                  (the window bites, the ring wraps) on the card against
                  the same weights' plain path on the CPU: the logits, and
                  each block from the same input, its output and every
                  cache leaf; the unit end to end at a per-layer fan-in
  (n) decode   -- prefill of 2100 tokens (a wrapped ring), then decode
                  steps, against forward's logits: the first unit alone
                  (fp32 at the tolerance, bf16 by its distance), then all 8
                  layers (bf16 by its distance; fp32 printed: the recurrent
                  state carries each step's rounding through gates that
                  saturate at this init, PERF.md), and all 8 with the same
                  weights at a per-layer fan-in (fp32 at the tolerance:
                  there the gates do not saturate)
  (o) server   -- Server.run as (g)
  slice 9, last, in a child process of its own (chip_smoke.py --zoo), each
  path twice from draws on the card: first every layer at its own fan-in,
  every check held; then at the reference's init at the published depth's
  scale (fp32 comparisons printed, not held: its attention scores reach
  the hundreds, PERF.md), with Server and the step times; each model freed
  after its path:
  (u) gemma2   -- gemma2-27b at full width cut to 4 layers (two (local,
                  global) units of 46): prefill B4 S512 kernel vs chunked
                  (fp32, and bf16 by its distance from fp32); one unit in
                  fp32 at B1 S4352 (the window of 4096 bites, the ring
                  wraps) block by block against the CPU's plain path;
                  prefill of 4160 tokens + 8 decode steps against forward;
                  Server
  (v) moe      -- phi3.5-moe-42b-a6.6b and deepseek-moe-16b at full width
                  cut to 4 layers (deepseek: head0 dense + 3 MoE): the
                  same, the blocks at B2 S256 with each MoE block's chosen
                  experts against the CPU's for every token (a flip at a
                  near tie reported with its gap), the choices dropped at
                  capacity and the router loss on each side; decode
                  against forward at capacity factor E / k, where no token
                  drops; bf16 held by a median over tokens
  (w) dense    -- qwen3-4b and granite-3-2b at their published depth and
                  widths: the same, the blocks at B1 S128
  (x) compress -- the int8 compressed all-reduce on 2 and 4 virtual slices
                  over smollm-135m's gradient tree: bit-equal to the CPU's,
                  error feedback over 12 steps, ms a call and payload bytes
  the paper's applications and the calibration, run after (r) (no kernel of
  the port; plain fp32 torch, as the reference leaves them to XLA):
  (s) apps     -- CG, Jacobi and N-body at n (N) 2048: five steps on the
                  card against the CPU's plain path from one state; then
                  each at its Table 1 state size (CG n 9216, 0.95 GiB;
                  Jacobi n 16384, 2 GiB; N-body N 16384; Flexible Sleep 1
                  GiB) held to the reference's properties (CG's residual
                  falls, Jacobi contracts, N-body keeps its momentum and
                  stays finite); each app's calibrate() time per
                  iteration; each state through 1 -> 2 -> 4 -> 2 virtual
                  slices by timed_reshard, bit-equal each time
  (t) calib    -- measure_grid(MeasureConfig(backend="torch")) on the CI
                  grid (1 <-> 2 ... 32 <-> 64 virtual slices; 64 MiB, 256
                  MiB, 1 GiB; 3 repeats; migrate and sched samples), the
                  port's reshard onto resized_mesh, each resize bit-equal
                  with the plan's non-local bytes; then the fit. Its
                  verdict (the fitted model, the residuals, the Fig. 3b
                  checks and fit_report_rows, or FitError's message with
                  the samples) is printed, not asserted: the paper's model
                  divides busiest-link bytes by a per-node bandwidth,
                  virtual slices share one HBM, and the reshard on one
                  card is host-bound, so a refusal is a finding about one
                  card, not a fault of the port
  (k) times    -- each kernel, its plain version, its bound and (flash
                  only) scaled_dot_product_attention (forward and backward,
                  both in device time) as a yardstick the port never calls;
                  each model's prefill and decode step and smollm's train
                  step, with the card's busy share; the Servers' tokens/s;
                  the backward last

Phases (e)-(g), (q), (h)-(j), (m)-(o) and (u)-(w) are the main paths: every
kernel launch count is set to 0 just before each path and read just after
it. The last
lines are the kernels' JSON record, the card's name and power limit, and
{"ok": true, "device": {...}}. Exits non-zero without printing a result when
no card is present or when run outside a checkout of the repository.
"""
import concurrent.futures
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# kernel vs plain. fp32: atol = rtol = 1e-5, elementwise. bf16: per query
# row, max |kernel - plain| over head_dim divided by the row's max |plain|,
# at most 2^-6. The plain version rounds its fp32 result to bf16 once; the
# kernel also rounds P to bf16 for P.V. A correct kernel is off by one ulp
# of the row's largest value (2^-7 of it at most); one 64-key tile dropped
# or counted twice moves a row by 5% or more, even at S 2048.
FP32_TOL = 1e-5
BF16_ROW_TOL = 2.0 ** -6
# SSD kernel vs plain and chunked: max |error| over the reference's max |y|
# (or |h_final|), the reference's own tolerances (tests/test_kernels.py)
SSD_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
# model-level checks in fp32, max-normalised, as the reference's own
# decode-consistency test; bf16 see phase_prefill
MODEL_TOL = 1e-4
BF16_RATIO = 1.5
PREFILL_B, PREFILL_S = 4, 512
# RG-LRU kernel vs plain, elementwise, the reference's own tolerance for its
# kernel (tests/test_kernels.py)
RGLRU_ATOL, RGLRU_RTOL = 1e-5, 1e-4
# recurrentgemma-9b: its depth, and the 8 layers (two units and the tail)
# that chip_smoke draws and drives
RG_DEPTH, RG_LAYERS = 38, 8
# smollm-135m training: batch, sequence length and bf16 steps of phase (q)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2048, 20


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


# -- (c) flash kernel against plain --------------------------------------------------

# (b, h, kv, sq, sk, d, causal, window, softcap, dtype, layout)
# layout "bhsd": contiguous (B, H, S, D); "bshd": (B, S, H, D) storage viewed
# as (B, H, S, D), as the model passes it.
def kernel_cases():
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        # tests/test_kernels.py FLASH_CASES
        (2, 4, 2, 256, 256, 64, True, None, None, f32, "bhsd"),
        (1, 4, 1, 512, 512, 128, True, 128, None, f32, "bhsd"),
        (2, 2, 2, 256, 256, 64, True, None, 50.0, f32, "bhsd"),
        (1, 8, 4, 256, 256, 32, False, None, None, f32, "bhsd"),
        (1, 2, 1, 256, 256, 64, True, None, None, bf16, "bhsd"),
        (2, 3, 3, 384, 384, 64, True, 256, 30.0, f32, "bhsd"),
    ]
    # tests/test_kernels.py grid-skip windows, fp32 and bf16
    cases += [(1, 2, 2, 512, 512, 64, True, w, None, dt, "bhsd")
              for dt in (f32, bf16) for w in (64, 128, 256)]
    cases += [
        # the bf16 (tensor-core) path at every head_dim and option
        (1, 4, 1, 512, 512, 128, True, 128, None, bf16, "bhsd"),
        (1, 8, 4, 256, 256, 32, False, None, None, bf16, "bhsd"),
        (2, 3, 3, 384, 384, 64, True, 256, 30.0, bf16, "bhsd"),
        # ragged lengths
        (1, 3, 1, 1000, 1000, 64, True, None, None, f32, "bhsd"),
        (1, 3, 1, 1000, 1000, 64, True, None, None, bf16, "bhsd"),
        # Sq < Sk: right-aligned queries
        (2, 6, 2, 300, 1000, 64, True, None, None, f32, "bhsd"),
        (2, 6, 2, 300, 1000, 64, True, None, None, bf16, "bhsd"),
        (1, 4, 2, 100, 260, 64, False, 70, None, bf16, "bhsd"),
        # the main path's prefill call: smollm heads, (B, S, H, D) views
        (PREFILL_B, 9, 3, PREFILL_S, PREFILL_S, 64, True, None, None, bf16,
         "bshd"),
        # smollm at its full context, as phase (k) times it
        (8, 9, 3, 2048, 2048, 64, True, None, None, bf16, "bhsd"),
        # recurrentgemma's local layers: 16 query heads on 1 KV head, D 256,
        # window 2048. The main path's prefill call ((B, S, H, D) views),
        # S 4096 where the window bites, a ragged S, and phase (m)'s fp32
        # unit (S 2304)
        (PREFILL_B, 16, 1, PREFILL_S, PREFILL_S, 256, True, 2048, None,
         bf16, "bshd"),
        (PREFILL_B, 16, 1, PREFILL_S, PREFILL_S, 256, True, 2048, None,
         f32, "bshd"),
        (1, 16, 1, 4096, 4096, 256, True, 2048, None, bf16, "bshd"),
        (1, 16, 1, 4096, 4096, 256, True, 2048, None, f32, "bshd"),
        (2, 16, 1, 1000, 1000, 256, True, 300, None, bf16, "bhsd"),
        (2, 16, 1, 1000, 1000, 256, True, 300, None, f32, "bhsd"),
        (1, 16, 1, 2304, 2304, 256, True, 2048, None, f32, "bshd"),
    ]
    return cases


def zoo_kernel_cases():
    """Head_dim 128 on the main paths of slice 9, fp32 and bf16, as the
    models pass them ((B, S, H, D) views): the prefill of qwen3-4b and
    phi3.5-moe (32 / 8 heads), of deepseek-moe (16 / 16), gemma2-27b's
    global layers (32 / 16, softcap 50) and its local layers where the
    window of 4096 bites (S 4352)."""
    return [(b, h, kv, s, s, 128, True, window, softcap, dt, "bshd")
            for b, h, kv, s, window, softcap in (
                (PREFILL_B, 32, 8, PREFILL_S, None, None),
                (PREFILL_B, 16, 16, PREFILL_S, None, None),
                (PREFILL_B, 32, 16, PREFILL_S, None, 50.0),
                (1, 32, 16, 4352, 4096, 50.0))
            for dt in (torch.bfloat16, torch.float32)]


# -- (p) flash backward against plain ----------------------------------------------

# backward kernel vs the plain fp32 gradients (torch autograd of
# attention_ref on the inputs in fp32), max |kernel - plain| over the
# largest |plain| of each of dq, dk, dv. fp32: the kernel sums the same
# terms in fp32 in another order (dq by atomics, in an order that changes
# from run to run); over up to 4096 keys (or a group of query rows) the
# rounding stays near sqrt(4096) 2^-24 = 4e-6 of the largest gradient, so
# 1e-4 leaves 25x; a key tile dropped or counted twice moves a gradient by
# a whole tile's share (over 1% even at S 4096). bf16: the inputs are the
# same bf16 values on both sides, the kernel rounds P and dS to bf16 for
# its products (2^-9 relative each) and its outputs (2^-9 of the largest
# value); dS = P (dP - delta) cancels, so its rounding adds up in dq and dk
# to a few times 2^-9 = 2e-3: 2e-2 leaves several times that, and a wrong
# tile still moves a gradient by more. The forward's log-sum-exp against
# torch.logsumexp of the plain scores: 1e-4 (absolute, on values of 1-10;
# the kernel's exp2 and log2 are accurate to 2^-22).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4


def phase_flash_bwd_vs_plain():
    """Returns {(head_dim, S): max |kernel - plain| over dq, dk and dv} at
    smollm's training call (bf16, B 8, S 2048, (B, S, H, D) views) and the
    case table's other bf16 calls on such views."""
    from repro_torch.kernels.bench import make_qkv
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import (attention_lse,
                                                         attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(2)
    main_err = {}
    cases = kernel_cases() + [
        # smollm-135m's train step: B 8, S 2048, (B, S, H, D) views
        (8, 9, 3, 2048, 2048, 64, True, None, None, torch.bfloat16, "bshd")]
    for case in cases:
        b, h, kv, sq, sk, d, causal, window, softcap, dtype, layout = case
        q, k, v = make_qkv(gen, b, h, kv, sq, sk, d, dtype, layout)
        do = make_qkv(gen, b, h, kv, sq, sk, d, dtype, layout)[0]
        kw = dict(causal=causal, window=window, softcap=softcap)
        out, lse = kernel.flash_attention(q, k, v, return_lse=True, **kw)
        grads = kernel.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves,
                                   do.float())
        lse_err = (lse - attention_lse(q, k, **kw)).abs().max().item()
        errs = [max_norm_err(g, w) for g, w in zip(grads, want)]
        name = (f"B{b} H{h} KV{kv} Sq{sq} Sk{sk} D{d} causal={causal} "
                f"window={window} softcap={softcap} {str(dtype)[6:]} "
                f"{layout}")
        log("p", f"{name}: dq {errs[0]:.3e} dk {errs[1]:.3e} dv "
                 f"{errs[2]:.3e} (max-normalised, tol {BWD_TOL[dtype]}); "
                 f"lse {lse_err:.3e} (tol {LSE_TOL})")
        finite = all(torch.isfinite(g).all() for g in grads)
        if (not finite or max(errs) > BWD_TOL[dtype] or lse_err > LSE_TOL
                or any(g.shape != t.shape or g.stride() != t.stride()
                       for g, t in zip(grads, (q, k, v)))):
            raise AssertionError(f"backward kernel disagrees with plain: "
                                 f"{name}")
        if dtype == torch.bfloat16 and layout == "bshd":
            main_err[(d, sq)] = max((g.float() - w).abs().max().item()
                                    for g, w in zip(grads, want))
    return main_err


def phase_kernel_vs_plain():
    """Returns {head_dim: max |kernel - plain|} at the main paths' prefill
    calls (bf16, B 4, S 512, (B, S, H, D) views; the largest over the
    head_dim 128 calls of slice 9)."""
    from repro_torch.kernels.bench import make_qkv
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = {}
    for case in kernel_cases() + zoo_kernel_cases():
        b, h, kv, sq, sk, d, causal, window, softcap, dtype, layout = case
        q, k, v = make_qkv(gen, b, h, kv, sq, sk, d, dtype, layout)
        kw = dict(causal=causal, window=window, softcap=softcap)
        out = kernel.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = attention_ref(q, k, v, **kw).float()
        err = (out.float() - ref).abs()
        name = (f"B{b} H{h} KV{kv} Sq{sq} Sk{sk} D{d} causal={causal} "
                f"window={window} softcap={softcap} {str(dtype)[6:]} "
                f"{layout}")
        if dtype == torch.float32:
            bad = err > FP32_TOL + FP32_TOL * ref.abs()
            held = f"tol atol=rtol={FP32_TOL}"
        else:
            row = (err.amax(-1) / ref.abs().amax(-1).clamp_min(1e-30)).max()
            bad = row > BF16_ROW_TOL
            held = (f"row-normalised {row.item():.3e}, tol "
                    f"{BF16_ROW_TOL:.3e}")
        log("c", f"{name}: max|kernel - plain| {err.max().item():.3e} "
                 f"({held})")
        if not torch.isfinite(out).all() or bad.any():
            raise AssertionError(f"kernel disagrees with plain: {name}")
        if layout == "bshd" and dtype == torch.bfloat16 and sq == PREFILL_S:
            main_err[d] = max(main_err.get(d, 0.0), err.max().item())
    return main_err


# -- (d) SSD kernel against plain and chunked ----------------------------------

# (b, s, h, p, n, chunk, dtype, layout); layout "view": x, b and c cut out of
# one (B, S, H P + 2 N) tensor, as the model passes its conv output;
# "unaligned": rows the kernel cannot read 16 bytes at a time
def ssd_cases():
    f32, bf16 = torch.float32, torch.bfloat16
    m = (24, 64, 128, 128)          # mamba2-130m: H, P, N, chunk
    return [
        # tests/test_kernels.py SSD_CASES
        (2, 64, 3, 16, 32, 16, f32, "contiguous"),
        (1, 128, 2, 32, 64, 32, f32, "contiguous"),
        (1, 64, 2, 16, 32, 64, f32, "contiguous"),
        (2, 64, 2, 16, 32, 16, bf16, "contiguous"),
        # mamba2's prefill shape, contiguous and as the model's views
        (PREFILL_B, PREFILL_S, *m, f32, "contiguous"),
        (PREFILL_B, PREFILL_S, *m, bf16, "contiguous"),
        (PREFILL_B, PREFILL_S, *m, f32, "view"),
        (PREFILL_B, PREFILL_S, *m, bf16, "view"),
        # ragged S, S < chunk, S = 1
        (2, 500, *m, f32, "view"),
        (2, 500, *m, bf16, "view"),
        (2, 100, *m, f32, "view"),
        (2, 1, *m, f32, "view"),
        (2, 1, *m, bf16, "view"),
        # 16 chunks: the state passing carries far
        (8, 2048, *m, f32, "contiguous"),
        (8, 2048, *m, bf16, "contiguous"),
        # rows not 16-byte aligned, a ragged S
        (2, 300, 3, 16, 32, 64, f32, "unaligned"),
        (2, 300, 3, 16, 32, 64, bf16, "unaligned"),
    ]


def phase_ssd_vs_plain():
    """The kernel's y and final state against ref.py's sequential
    recurrence and against the model's chunked path (which halves its
    chunk until it divides S); returns the largest |y error| against the
    plain version at the shape and layout the model launches, in bf16."""
    from repro_torch.kernels.bench import make_ssd_inputs
    from repro_torch.kernels.ssd import kernel
    from repro_torch.kernels.ssd.ref import ssd_ref
    from repro_torch.models.ssm import ssd_chunked
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for b, s, h, p, n, chunk, dtype, layout in ssd_cases():
        args = make_ssd_inputs(gen, b, s, h, p, n, dtype, layout)
        y, hf = kernel.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        tol = SSD_TOL[dtype]
        name = (f"B{b} S{s} H{h} P{p} N{n} chunk {chunk} "
                f"{str(dtype)[6:]} {layout}")
        errs = {}
        for against, (y_ref, h_ref) in (
                ("plain", ssd_ref(*args)),
                ("chunked", ssd_chunked(*args, chunk))):
            errs[against] = (max_norm_err(y, y_ref), max_norm_err(hf, h_ref))
            if against == "plain" and layout == "view" and \
                    dtype == torch.bfloat16 and s == PREFILL_S:
                main_err = (y.float() - y_ref.float()).abs().max().item()
        log("d", f"{name}: max-normalised " + "; ".join(
            f"{k}: y {e_y:.2e}, h_final {e_h:.2e}"
            for k, (e_y, e_h) in errs.items()) + f" (tol {tol})")
        if not (torch.isfinite(y).all() and torch.isfinite(hf).all()) or \
                max(max(e) for e in errs.values()) > tol:
            raise AssertionError(f"ssd_scan disagrees: {name}")
    return main_err


# -- (l) RG-LRU kernel against plain -------------------------------------------

# (b, s, w, with h0): tests/test_kernels.py's shapes, the main path's B 4,
# S 512, W 4096, a ragged S, S 1, a long S, and an initial state (also with
# a W that no block width divides)
def rglru_cases():
    main = (PREFILL_B, PREFILL_S, 4096)
    return [(1, 32, 64, False), (2, 64, 128, False), (3, 128, 256, False),
            (*main, False), (2, 500, 4096, False), (2, 1, 4096, False),
            (1, 4096, 4096, False), (*main, True), (2, 37, 1000, True)]


def phase_rglru_vs_plain():
    """The kernel against ref.py's sequential recurrence at RGLRU_ATOL /
    RGLRU_RTOL; returns the largest |error| at the main path's shape."""
    from repro_torch.kernels.bench import make_rglru_inputs
    from repro_torch.kernels.rglru import kernel
    from repro_torch.kernels.rglru.ref import rglru_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for b, s, w, with_h0 in rglru_cases():
        a, bb = make_rglru_inputs(gen, b, s, w)
        h0 = torch.randn((b, w), generator=gen, device="cuda") \
            if with_h0 else None
        h = kernel.rglru_scan(a, bb, h0)
        torch.cuda.synchronize()
        ref = rglru_ref(a, bb, h0)
        err = (h - ref).abs().max().item()
        name = f"B{b} S{s} W{w} fp32" + (" with h0" if with_h0 else "")
        log("l", f"{name}: max|kernel - plain| {err:.3e} (atol "
                 f"{RGLRU_ATOL}, rtol {RGLRU_RTOL})")
        if not torch.isfinite(h).all() or not torch.allclose(
                h, ref, atol=RGLRU_ATOL, rtol=RGLRU_RTOL):
            raise AssertionError(f"rglru_scan disagrees with plain: {name}")
        if (b, s, w, with_h0) == (PREFILL_B, PREFILL_S, 4096, False):
            main_err = err
    return main_err


# -- (e)-(j), (m)-(o) the main paths ---------------------------------------------


def max_norm_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / (want.float().abs().max() + 1e-6)).item()


def mean_norm_err(got, want):
    return ((got.float() - want.float()).abs().mean()
            / (want.float().abs().max() + 1e-6)).item()


def bf16_distance(cfg, got, truth):
    """How far bf16 logits (B, S, V) lie from fp32 ones: the mean distance,
    max-normalised; for a MoE model the median over tokens of each token's
    mean distance. bf16 routes about one token in a hundred a layer to
    another expert than fp32 does (a near tie at bf16's rounding), which
    moves that token's logits by tens of per cent: a few such tokens swing
    a mean, not a median."""
    if not cfg.num_experts:
        return mean_norm_err(got, truth)
    per_token = (got.float() - truth.float()).abs().mean(-1)
    return (per_token.median() / (truth.float().abs().max() + 1e-6)).item()


def counters():
    """Every kernel wrapper, by name; each counts its own launches."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru import kernel as rglru
    from repro_torch.kernels.ssd import kernel as ssd
    return {"flash_attention": flash.flash_attention,
            "flash_attention_bwd": flash.flash_attention_bwd,
            "ssd_scan": ssd.ssd_scan,
            "rglru_scan": rglru.rglru_scan}


def counted_launches(fn, want):
    """Call fn and check it launched each wrapper of ``want`` ({name:
    count}) exactly that often; returns what fn returned."""
    wrappers = counters()
    before = {name: wrappers[name].launches for name in want}
    result = fn()
    torch.cuda.synchronize()
    got = {name: wrappers[name].launches - before[name] for name in want}
    if got != want:
        raise AssertionError(f"launches {got}, expected {want}")
    return result


def run_counted(fn, wrapper, expected, also=None):
    """Call fn, which returns (logits, ...), and check it launched
    ``wrapper``'s kernel ``expected`` times (and each wrapper of ``also``,
    {wrapper: count}, its count); returns what fn returned."""
    expect = {wrapper: expected, **(also or {})}
    result = counted_launches(fn, {w.__name__: n for w, n in expect.items()})
    if not torch.isfinite(result[0]).all():
        raise AssertionError("non-finite logits")
    return result


def drive(label, phases):
    """One main path: every launch count set to 0 just before it and read
    just after it."""
    for wrapper in counters().values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    result = [phase() for phase in phases]
    counts = {name: w.launches for name, w in counters().items()}
    log(label, f"main path in {time.perf_counter() - t0:.1f} s, kernel "
               f"launches {counts}")
    return counts, result


def phase_prefill(cfg, params, toks, label="e", hold=True):
    """(e) Prefill at full width through the kernel (attn_impl="auto") and
    through the chunked path, in fp32 (held unless ``hold`` is False) and
    in the model's bf16.

    fp32 holds the kernel path to the chunked one at MODEL_TOL. In bf16 the
    two differ far more, and not by the kernel: the reference's init draws
    block weights with the stacked layers axis as fan-in (std 1/sqrt(30)),
    which makes the logits chaotic under bf16 rounding (the JAX model's own
    bf16 and fp32 logits differ by 0.47 max-normalised at 2 layers). So
    bf16 is held by what it costs: the mean distance of the kernel path's
    logits from the fp32 logits, over every position of a forward pass, may
    be at most BF16_RATIO times the chunked path's."""
    from repro_torch.models import build_model
    s = toks.shape[1]
    n_layers = cfg.num_layers
    models = {(dt, impl): build_model(dataclasses.replace(
        cfg, dtype=dt, attn_impl=impl))
        for dt in ("float32", "bfloat16") for impl in ("auto", "chunked")}
    flash = counters()["flash_attention"]
    pre = {key: run_counted(
        lambda m=m: m.prefill(params, toks, max_len=s + 8), flash,
        n_layers if key[1] == "auto" else 0)[0]
        for key, m in models.items()}
    err32 = max_norm_err(pre["float32", "auto"], pre["float32", "chunked"])
    err16 = max_norm_err(pre["bfloat16", "auto"], pre["bfloat16", "chunked"])
    log(label, f"{cfg.name} prefill B{toks.shape[0]} S{s}: {n_layers} kernel "
             f"launches per prefill; logits {tuple(pre['bfloat16', 'auto'].shape)}"
             f" kernel vs chunked max-normalised: float32 {err32:.3e} "
             + (f"(tol {MODEL_TOL})" if hold else "(not held)")
             + f", bfloat16 {err16:.3e}")
    if hold and err32 > MODEL_TOL:
        raise AssertionError("fp32 prefill through the kernel disagrees")
    fwd = {key: run_counted(lambda m=models[key]: m.forward(params, toks),
                            flash, n_layers if key[1] == "auto" else 0)[0]
           for key in (("float32", "chunked"), ("bfloat16", "auto"),
                       ("bfloat16", "chunked"))}
    truth = fwd["float32", "chunked"]
    e_kernel = bf16_distance(cfg, fwd["bfloat16", "auto"], truth)
    e_chunked = bf16_distance(cfg, fwd["bfloat16", "chunked"], truth)
    log(label, f"bfloat16 forward, "
               f"{'median over tokens of the ' if cfg.num_experts else ''}"
               f"mean distance from fp32 logits "
             f"(max-normalised): kernel path {e_kernel:.3e}, chunked path "
             f"{e_chunked:.3e} (kernel may be at most {BF16_RATIO}x)")
    if e_kernel > BF16_RATIO * e_chunked:
        raise AssertionError("bf16 logits through the kernel are less "
                             "accurate than the chunked path's")


def phase_ssm_prefill(cfg, params, toks):
    """(h) Prefill at full width on the card, through the SSD kernel, in
    fp32 against the same weights' prefill on the CPU, which takes the
    chunked path that tier-1 holds against the JAX package: logits and
    cache at MODEL_TOL. bf16 is held by its distance from fp32, as in
    phase_prefill: over every position of a shorter forward, the mean
    distance of the card's bf16 logits (kernel) from its fp32 logits may
    be at most BF16_RATIO times the CPU's bf16 logits' (chunked path)."""
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_map
    s = toks.shape[1]
    n_layers = cfg.num_layers
    ssd = counters()["ssd_scan"]
    fp32 = dataclasses.replace(cfg, dtype="float32")
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    card32, card16 = build_model(fp32), build_model(bf16)
    cpu32, cpu16 = (build_model(c, device="cpu") for c in (fp32, bf16))
    params_cpu = tree_map(lambda t: t.cpu(), params)

    logits, cache = run_counted(
        lambda: card32.prefill(params, toks, max_len=s + 8), ssd, n_layers)
    want, want_cache = cpu32.prefill(params_cpu, toks.cpu(), max_len=s + 8)
    errs = {"logits": max_norm_err(logits.cpu(), want)}
    for name in ("conv", "state"):
        errs[name] = max_norm_err(cache["blocks"]["p0"][name].cpu(),
                                  want_cache["blocks"]["p0"][name])
    pre16, _ = run_counted(
        lambda: card16.prefill(params, toks, max_len=s), ssd, n_layers)
    log("h", f"{cfg.name} prefill B{toks.shape[0]} S{s}: {n_layers} kernel "
             f"launches per prefill; logits {tuple(pre16.shape)}; fp32 on "
             f"the card vs the CPU's plain path, max-normalised: "
             + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
             + f" (tol {MODEL_TOL})")
    if max(errs.values()) > MODEL_TOL:
        raise AssertionError("fp32 prefill through the kernel disagrees "
                             "with the CPU's plain path")
    short = toks[:2, :s // 2]
    truth, _ = run_counted(lambda: card32.forward(params, short), ssd,
                           n_layers)
    got, _ = run_counted(lambda: card16.forward(params, short), ssd,
                         n_layers)
    plain, _ = cpu16.forward(params_cpu, short.cpu())
    e_kernel = mean_norm_err(got, truth)
    e_plain = mean_norm_err(plain, truth.cpu())
    log("h", f"bfloat16 forward B{short.shape[0]} S{short.shape[1]}, mean "
             f"distance from the card's fp32 logits (max-normalised): card "
             f"(kernel) {e_kernel:.3e}, CPU (chunked path) {e_plain:.3e} "
             f"(kernel may be at most {BF16_RATIO}x)")
    if e_kernel > BF16_RATIO * e_plain:
        raise AssertionError("bf16 logits through the kernel are less "
                             "accurate than the chunked path's")


def layer_kinds(cfg):
    """The block kind of every layer, in order (no first dense layers)."""
    reps, tail = cfg.pattern_repeats
    return list(cfg.pattern) * reps + list(cfg.pattern[:tail])


def tree_paths(tree, prefix=()):
    """{key path: leaf} of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in tree_paths(sub, prefix + (k,)).items()}
    return {prefix: tree}


def check_ring(pos, s):
    """A local layer's ring after a prefill of ``s`` tokens holds the last
    len(ring) positions, each in its slot p % len(ring)."""
    ring = pos.reshape(-1, pos.shape[-1])[0]
    n = ring.shape[0]
    held = torch.arange(max(0, s - n), s, dtype=ring.dtype)
    if not torch.equal(ring[held % n], held):
        raise AssertionError(f"the ring does not hold positions "
                             f"{held[0].item()}..{s - 1}")
    return held[0].item()


def first_unit(cfg, params):
    """(config, parameters) of the model's first pattern unit alone: the
    first repeat of each stacked block (views of ``params``)."""
    from repro_torch.models.layers import tree_map
    unit = dataclasses.replace(cfg, num_layers=len(cfg.pattern))
    return unit, {"embed": params["embed"],
                  "final_norm": params["final_norm"],
                  "blocks": tree_map(lambda t: t[:1], params["blocks"])}


def at_per_layer_fan_in(model, params, drawn_layers):
    """``params`` of ``model``, drawn by the reference's rule (a stacked
    weight's fan-in is its layers axis, here ``drawn_layers`` long), with
    each stacked normal weight rescaled to one layer's fan-in: the axes a
    product sums over (all but the last of a projection back to the
    embedding, such as wo's heads x head_dim; else the first, such as wq's
    embed or the conv's taps; an expert's own, past the experts axis).
    These are the same random numbers that a draw with ParamSpec.scale
    sqrt(drawn_layers / fan_in) gives."""
    def rescale(spec, t):
        if isinstance(spec, dict):
            return {k: rescale(spec[k], t[k]) for k in spec}
        if spec.init != "normal":
            return t
        return t * (drawn_layers / layer_fan_in(spec)) ** 0.5
    return dict(params, blocks=rescale(model.specs()["blocks"],
                                       params["blocks"]))


def layer_fan_in(spec):
    """One layer's fan-in of a stacked weight (see at_per_layer_fan_in)."""
    one, axes = spec.shape[1:], spec.logical[1:]
    if axes[0] == "experts":
        one, axes = one[1:], axes[1:]
    return (int(np.prod(one[:-1])) if len(one) > 1 and axes[-1] == "embed"
            else one[0])


def phase_hybrid_prefill(cfg, params, toks, unit_toks):
    """(m) recurrentgemma's prefill at full width. In bf16 at the main
    path's B 4, S 512, through both kernels: exactly one flash-attention
    launch per "local" layer and one RG-LRU launch per "rglru" layer.

    Then its first unit (rglru, rglru, local) in fp32 at B 1 and
    ``unit_toks``' length (beyond the window, so it bites and the local
    ring wraps), on the card against the same weights' plain path on the
    CPU, which tier-1 holds against the JAX package: the unit's logits at
    MODEL_TOL, and each block run from the same input on both, its output
    and every cache leaf at MODEL_TOL, the ring's positions exactly. The
    whole unit's cache leaves are printed too: from the second RG-LRU
    layer on they carry the first layer's rounding through gates that
    saturate at this init, where the sigmoid's log turns the
    pre-activation's absolute error into a relative one (PERF.md)."""
    from repro_torch.models import build_model, transformer
    from repro_torch.models.layers import embed_apply, tree_map
    flash, rglru = counters()["flash_attention"], counters()["rglru_scan"]
    kinds = layer_kinds(cfg)
    n_local, n_rglru = kinds.count("local"), kinds.count("rglru")
    s = toks.shape[1]
    model = build_model(cfg)
    logits, _ = run_counted(
        lambda: model.prefill(params, toks, max_len=s + 8), flash, n_local,
        also={rglru: n_rglru})
    log("m", f"{cfg.name} {cfg.dtype} prefill B{toks.shape[0]} S{s}: "
             f"{n_local} flash_attention and {n_rglru} rglru_scan launches "
             f"per prefill; logits {tuple(logits.shape)}")

    unit, card_params = first_unit(cfg, params)
    unit = dataclasses.replace(unit, dtype="float32")
    cpu_params = tree_map(lambda t: t.cpu(), card_params)
    s = unit_toks.shape[1]
    max_len = s + 8
    got, got_cache = run_counted(
        lambda: build_model(unit).prefill(card_params, unit_toks,
                                          max_len=max_len),
        flash, unit.pattern.count("local"),
        also={rglru: unit.pattern.count("rglru")})
    want, want_cache = build_model(unit, device="cpu").prefill(
        cpu_params, unit_toks.cpu(), max_len=max_len)
    errs = {"logits": max_norm_err(got.cpu(), want)}
    got_leaves = tree_paths(got_cache)
    whole = {"/".join(path): max_norm_err(got_leaves[path].cpu(), w)
             for path, w in tree_paths(want_cache).items()
             if path[-1] != "pos"}

    x = embed_apply(cpu_params["embed"], unit_toks.cpu(), unit)
    dev = unit_toks.device
    for j, kind in enumerate(unit.pattern):
        def block(tree, j=j):
            return transformer.layer(tree["blocks"][f"p{j}"], 0)
        y_card, c_card = run_counted(
            lambda: transformer.block_prefill(block(card_params), x.to(dev),
                                              unit, kind, max_len),
            flash, int(kind == "local"), also={rglru: int(kind == "rglru")})
        y, c = transformer.block_prefill(block(cpu_params), x, unit, kind,
                                         max_len)
        errs[f"p{j} {kind} out"] = max_norm_err(y_card.cpu(), y)
        for name, w in c.items():
            if name == "pos":
                if not torch.equal(c_card[name].cpu(), w):
                    raise AssertionError(f"p{j}: the ring's positions differ")
                first = check_ring(w, s)
            else:
                errs[f"p{j}/{name}"] = max_norm_err(c_card[name].cpu(), w)
        x = y
    log("m", f"one unit fp32 prefill B1 S{s} (window {cfg.sliding_window}; "
             f"the ring holds positions {first}..{s - 1}, equal on both), "
             f"card vs the CPU's plain path, max-normalised: "
             + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
             + f" (tol {MODEL_TOL}); the whole unit's cache, not held: "
             + ", ".join(f"{k} {e:.3e}" for k, e in whole.items()))
    if max(errs.values()) > MODEL_TOL:
        raise AssertionError("fp32 prefill through the kernels disagrees "
                             "with the CPU's plain path")

    # the same unit end to end at a per-layer fan-in (ROADMAP.md, Queue 3):
    # do the gates still saturate, and the card and the CPU still part?
    pl = at_per_layer_fan_in(build_model(unit), card_params,
                             RG_DEPTH // len(cfg.pattern))
    got, got_cache = build_model(unit).prefill(pl, unit_toks,
                                               max_len=max_len)
    want, want_cache = build_model(unit, device="cpu").prefill(
        tree_map(lambda t: t.cpu(), pl), unit_toks.cpu(), max_len=max_len)
    got_leaves = tree_paths(got_cache)
    pl_errs = {"logits": max_norm_err(got.cpu(), want)}
    pl_errs.update({"/".join(path): max_norm_err(got_leaves[path].cpu(), w)
                    for path, w in tree_paths(want_cache).items()
                    if path[-1] != "pos"})
    log("m", f"the same unit drawn at a per-layer fan-in, card vs the "
             f"CPU's plain path end to end, max-normalised: "
             + ", ".join(f"{k} {e:.3e}" for k, e in pl_errs.items())
             + f"; largest {max(pl_errs.values()):.3e}, against "
             f"{max(whole.values()):.3e} at the reference's init")


def phase_decode(label, cfg, params, toks, steps, hold_fp32=True):
    """Prefill, then ``steps`` decode steps, against forward's logits at
    the same positions: fp32 at MODEL_TOL, as the reference's own
    decode-consistency test (printed, not held, when ``hold_fp32`` is
    False). bf16 is held as in phase_prefill: the mean distance of its
    prefill + decode logits from the fp32 forward's may be at most
    BF16_RATIO times the bf16 forward's own (bf16_distance)."""
    from repro_torch.models import build_model
    s = toks.shape[1] - steps
    full = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model(dataclasses.replace(cfg, dtype=dtype))
        full[dtype], _ = model.forward(params, toks)
        pre, cache = model.prefill(params, toks[:, :s], max_len=s + steps)
        outs = [pre[:, 0]]
        for t in range(steps):
            dec, cache = model.decode_step(params, cache,
                                           toks[:, s + t:s + t + 1], s + t)
            if not torch.isfinite(dec).all():
                raise AssertionError("non-finite decode logits")
            outs.append(dec[:, 0])
        want = full[dtype][:, s - 1:]
        errs = [max_norm_err(o, want[:, t]) for t, o in enumerate(outs)]
        log(label, f"{cfg.name} ({cfg.num_layers} layers) {dtype} prefill "
                   f"B{toks.shape[0]} S{s} + {steps} decode steps "
                   f"vs forward, max-normalised: "
                   f"{', '.join(f'{e:.2e}' for e in errs)}"
                   + ("" if dtype != "float32" else f" (tol {MODEL_TOL})"
                      if hold_fp32 else " (not held)"))
        if dtype == "float32" and hold_fp32 and max(errs) > MODEL_TOL:
            raise AssertionError("prefill/decode disagree with forward")
    truth = full["float32"][:, s - 1:]
    e_decode = bf16_distance(cfg, torch.stack(outs, dim=1), truth)
    e_forward = bf16_distance(cfg, full["bfloat16"][:, s - 1:], truth)
    log(label, f"bfloat16 prefill + decode, "
               f"{'median over tokens of the ' if cfg.num_experts else ''}"
               f"mean distance from fp32 forward logits (max-normalised): "
               f"{e_decode:.3e}, bf16 forward {e_forward:.3e} (decode may be "
               f"at most {BF16_RATIO}x)")
    if e_decode > BF16_RATIO * e_forward:
        raise AssertionError("bf16 prefill + decode logits are less "
                             "accurate than the bf16 forward's")


def phase_server(label, model, params):
    from repro_torch.runtime import Request, Server
    rng = np.random.default_rng(0)
    vocab = model.cfg.vocab_size
    reqs = [Request(rid=i, prompt=rng.integers(0, vocab, rng.integers(8, 65)),
                    max_new_tokens=16) for i in range(8)]
    server = Server(model, params, batch=4, max_len=256)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.run(reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tokens = sum(len(v) for v in done.values())
    prompt = sum(len(r.prompt) for r in reqs)
    log(label, f"{model.cfg.name} Server batch 4 max_len 256: {len(done)} "
               f"requests, prompts {min(len(r.prompt) for r in reqs)}-"
               f"{max(len(r.prompt) for r in reqs)} tokens ({prompt} in "
               f"all), {tokens} new tokens in {dt:.3f} s = "
               f"{tokens / dt:.1f} tok/s")
    if sorted(done) != list(range(8)) or \
            any(len(v) != 16 for v in done.values()) or \
            any(not 0 <= t < vocab for v in done.values() for t in v):
        raise AssertionError(f"Server did not complete every request: {done}")
    return tokens / dt


# -- (q) smollm-135m training -----------------------------------------------------


def with_grad(params):
    """Leaves of ``params`` that require a gradient (sharing storage)."""
    from repro_torch.models.layers import tree_map
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def flash_per_step(cfg):
    """Flash forward and backward launches one train step of ``cfg`` makes:
    a backward per layer, a forward per layer, twice under remat (the
    checkpointed units run again in the backward pass)."""
    n = cfg.num_layers
    return {"flash_attention": n * (2 if cfg.remat == "nothing_saveable"
                                    else 1),
            "flash_attention_bwd": n}


def train_grads(cfg, params, batch, want, **changes):
    """(loss, {leaf path: gradient}) of one fp32 train step of ``cfg`` with
    ``changes``, checking its flash launches against ``want``."""
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(cfg, dtype="float32",
                                            **changes))
    leaves = with_grad(params)

    def step():
        loss, _ = model.loss(leaves, batch)
        loss.backward()
        return loss.detach()
    loss = counted_launches(step, want)
    return loss, {path: t.grad for path, t in tree_paths(leaves).items()}


def grad_errs(got, want):
    """Max-normalised distance of the loss and of each gradient leaf."""
    errs = {"loss": max_norm_err(got[0], want[0])}
    errs.update({"/".join(path): max_norm_err(g, want[1][path])
                 for path, g in got[1].items()})
    return errs


def phase_train_fp32(cfg, model, params, batch):
    """(q) One fp32 train step at full width, the loss and every gradient
    leaf, through the kernels (attn_impl="auto": the flash forward with the
    log-sum-exp, the backward kernel) against attn_impl="chunked" on the
    card, from the same parameters and batch, max-normalised at MODEL_TOL,
    with the weights drawn at a per-layer fan-in. At the reference's init
    (stacked weights take the layers axis as fan-in, std 1/sqrt(30)) the
    model is chaotic and gradients carry rounding far up: there the two
    paths are printed beside the chunked path against itself at another
    chunk size (the same function summed in another order), the floor of
    any comparison at that init."""
    n_off = {"flash_attention": 0, "flash_attention_bwd": 0}
    shape = f"B{batch['tokens'].shape[0]} S{batch['tokens'].shape[1]}"
    sane = at_per_layer_fan_in(model, params, cfg.pattern_repeats[0])
    held = grad_errs(train_grads(cfg, sane, batch, flash_per_step(cfg)),
                     train_grads(cfg, sane, batch, n_off,
                                 attn_impl="chunked"))
    kernel = train_grads(cfg, params, batch, flash_per_step(cfg))
    chunked = train_grads(cfg, params, batch, n_off, attn_impl="chunked")
    floor = grad_errs(train_grads(cfg, params, batch, n_off,
                                  attn_impl="chunked", attn_chunk=256),
                      chunked)
    seen = grad_errs(kernel, chunked)
    log("q", f"{cfg.name} fp32 train step {shape} (remat {cfg.remat}, "
             f"{flash_per_step(cfg)} launches), weights at a per-layer "
             f"fan-in: through the kernels vs chunked, max-normalised "
             + ", ".join(f"{k} {e:.3e}" for k, e in held.items())
             + f" (tol {MODEL_TOL})")
    log("q", f"at the reference's init (not held): loss "
             f"{kernel[0].item():.6f} through the kernels, "
             f"{chunked[0].item():.6f} chunked; kernels vs chunked, largest "
             f"leaf {max(seen.values()):.3e}; chunked at attn_chunk 256 vs "
             f"512 (the rounding floor) {max(floor.values()):.3e}")
    if not all(torch.isfinite(g).all() for g in kernel[1].values()) or \
            max(held.values()) > MODEL_TOL:
        raise AssertionError("the fp32 train step through the kernels "
                             "disagrees with the chunked path")


def phase_train_bf16(cfg, params, data_cfg, steps):
    """(q) ``steps`` bf16 steps of ElasticTrainer.train at lr 3e-3 from
    ``params``: every loss finite, the last below the first, and exactly
    the flash launches the layer count and remat imply per step. Returns
    (trainer, state, the next batch), for phase_train_step_time."""
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import ElasticTrainer, TrainerConfig
    model = build_model(cfg)
    trainer = ElasticTrainer(
        model, AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=steps),
        data_cfg, TrainerConfig(steps=steps, log_period=1))
    per_step = flash_per_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = counted_launches(
        lambda: trainer.train(state=trainer.init_state(params=params)),
        {name: steps * n for name, n in per_step.items()})
    seconds = time.perf_counter() - t0
    losses = [m["loss"] for m in trainer.metrics]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log("q", f"{cfg.name} {cfg.dtype} ElasticTrainer.train, {steps} steps "
             f"B{data_cfg.global_batch} S{data_cfg.seq_len} in "
             f"{seconds:.1f} s ({per_step} launches a step); losses "
             + ", ".join(f"{x:.4f}" for x in losses)
             + f"; peak device memory {peak:.2f} GiB")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            int(state["step"]) != steps:
        raise AssertionError("bf16 training did not bring the loss down")
    return trainer, state, trainer.data.batch(steps)


def profile_split(fns):
    """One torch.profiler session over ``fns`` ({name: fn}), each called
    once between synchronises and marks: {name: (card busy ms, kernels and
    copies)}, each device event counted in the interval between the marks
    its start falls in. One session serves them all: a profile of a train
    step, whose backward runs on autograd's own thread, has left later
    profiles in the process without device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    names = list(fns)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, name in enumerate(names):
            torch.cuda.synchronize()
            with record_function(f"chip_smoke_mark_{i}"):
                pass
            fns[name]()
        torch.cuda.synchronize()
        with record_function(f"chip_smoke_mark_{len(names)}"):
            pass
    events = prof.events()
    marks = sorted(ev.time_range.start for ev in events
                   if ev.name.startswith("chip_smoke_mark_"))
    out = {name: [0.0, 0] for name in names}
    for ev in events:
        if ev.device_type != DeviceType.CUDA:
            continue
        t = ev.time_range.start
        for i, name in enumerate(names):
            if marks[i] <= t < marks[i + 1]:
                out[name][0] += ev.self_device_time_total / 1e3
                out[name][1] += 1
    return {name: tuple(v) for name, v in out.items()}


def phase_train_step_time(cfg, trainer, state, batch, data_cfg):
    """(k) One bf16 train step at 1, 2 and 4 slices of the card (the
    trained state resharded from 1): the wall time (host clock around 3
    steps ending in a synchronise), the card's busy time in one step under
    torch.profiler, and tokens/s. It runs after every other profile (see
    profile_split)."""
    from repro_torch.core import make_mesh, reshard, slice_devices
    from repro_torch.runtime import ElasticTrainer
    steps = {}
    for n in (1, 2, 4):
        if n == 1:
            tr, st = trainer, state
        else:
            tr = ElasticTrainer(trainer.model, trainer.opt_cfg, trainer.data,
                                dataclasses.replace(trainer.cfg,
                                                    max_slices=n),
                                devices=slice_devices(n))
            st = reshard(state, tr._state_shardings(make_mesh(
                n, 1, devices=tr.devices)))
        steps[n] = (lambda tr=tr, st=st: tr.train_step(st, batch))
    walls = {}
    for n, step in steps.items():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        walls[n] = (time.perf_counter() - t0) / 3 * 1e3
    busy = profile_split({n: fn for n, fn in steps.items()})
    tokens = data_cfg.global_batch * data_cfg.seq_len
    for n in steps:
        ms, launches = busy[n]
        log("k", f"{cfg.name} bf16 train step B{data_cfg.global_batch} "
                 f"S{data_cfg.seq_len} at {n} slice(s) of the card: "
                 f"{walls[n]:.3f} ms wall, card busy {ms:.3f} ms in "
                 f"{launches} kernels and copies "
                 f"({100 * (1 - ms / walls[n]):.1f}% idle), "
                 f"{tokens / walls[n] * 1e3:.0f} tokens/s")
        if launches == 0:
            raise AssertionError(f"the profile saw no device work of the "
                                 f"step at {n} slices")


def phase_ssd_grad_raises(cfg, params):
    """(q) mamba2's SSD kernel has no backward yet: a loss.backward() on the
    card raises NotImplementedError instead of dropping the gradients."""
    from repro_torch.models import build_model
    model = build_model(cfg)
    toks = torch.zeros((1, 64), dtype=torch.int64, device="cuda")
    try:
        loss, _ = model.loss(with_grad(params), {"tokens": toks,
                                                 "labels": toks})
        loss.backward()
    except NotImplementedError as err:
        log("q", f"{cfg.name} loss.backward() on the card raises "
                 f"NotImplementedError: {err}")
        return
    raise AssertionError(f"{cfg.name}: a backward through the SSD kernel "
                         "did not raise")


# -- (r) smollm-135m elastic: virtual slices of the card -----------------------------

# the elastic path: up to 4 virtual slices of the card; the fp32 comparison's
# steps; the bf16 loop's steps, reconfiguration and checkpoint periods, the
# step the rival job is queued and finished at, and the state step whose
# first try fails
ELASTIC_SLICES = 4
ELASTIC_FP32_STEPS = 4
LOOP_STEPS, LOOP_CHECK, LOOP_CKPT = 12, 3, 4
RIVAL_QUEUED, RIVAL_DONE, FAULT_AT = 2, 5, 9
# elastic against fixed, the reference's bound (tests/test_multidevice.py:
# 140); one batch at 1, 2 and 4 slices, test_grad_accum_equivalence's
ELASTIC_TOL, SLICES_TOL = 0.05, 5e-3


class ScriptedRMS:
    """Answers the n-th reconfiguration request from ``script``."""

    def __init__(self, script):
        self.script, self.calls = dict(script), 0

    def request_reconfig(self, job_id, *, current, minimum, maximum,
                         factor, preferred):
        from repro_torch.core import Action, Decision
        self.calls += 1
        return self.script.get(self.calls,
                               Decision(Action.NO_ACTION, current))

    def confirm_resize(self, job_id, decision, timeout_s):
        return True, 0.0


def elastic_trainer(cfg, data, steps, slices, rms=None, **changes):
    """An ElasticTrainer of ``cfg`` on ELASTIC_SLICES virtual slices of the
    card, starting at ``slices``, lr 3e-3 with one warmup step."""
    from repro_torch.core import slice_devices
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import ElasticTrainer, TrainerConfig
    return ElasticTrainer(
        build_model(cfg), AdamWConfig(lr=3e-3, warmup_steps=1,
                                      total_steps=steps),
        data, TrainerConfig(steps=steps, max_slices=ELASTIC_SLICES,
                            log_period=1, **changes),
        rms=rms, devices=slice_devices(ELASTIC_SLICES), slices=slices)


def storage_of(t):
    s = t.untyped_storage()
    return s.data_ptr(), s.data_ptr() + s.nbytes()


def same_bits(a, b):
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def checked_reshard(state, shardings):
    """reshard, leaf by leaf, checking that every leaf keeps its bits and
    that a new block shares an old buffer only as a view kept in place by
    the one local transfer to its slice: every other block is a new
    buffer on the card, including each non-local transfer's. Returns (the
    new state, {"moved": bytes of non-local transfers, "local": bytes
    copied on the slice itself, "kept": blocks left in place, "kept_at":
    the slices that kept one, "copies": non-local transfers})."""
    from repro_torch.core import gather, reshard
    from repro_torch.models.layers import tree_map
    stats = dict(moved=0, local=0, kept=0, copies=0, kept_at=set())

    def leaf(x, sh):
        log_ = []
        y = reshard(x, sh, transfers=log_)
        if not same_bits(gather(y), gather(x)):
            raise AssertionError(f"reshard changed a leaf {x}")
        olds = [storage_of(t) for t in x.shards.values()]
        for c, t in y.shards.items():
            if t.device.type != "cuda":
                raise AssertionError(f"block {c} is not on the card")
            r = storage_of(t)
            k = c[0]
            into = [tr for tr in log_ if tr.dst == k]
            if any(r[0] < o[1] and o[0] < r[1] for o in olds):
                if r not in olds or len(into) != 1 or not into[0].local:
                    raise AssertionError(f"block {c} of {x} shares an old "
                                         f"buffer without a local transfer")
                stats["kept"] += 1
                stats["kept_at"].add(k)
        for tr in log_:
            if not tr.local:
                stats["moved"] += tr.nbytes
                stats["copies"] += 1
        stats["local"] += sum(tr.nbytes for tr in log_ if tr.local) - sum(
            t.numel() * t.element_size() for c, t in y.shards.items()
            if storage_of(t) in olds)
        return y

    return tree_map(leaf, state, shardings), stats


def phase_reshard(cfg, params, data_cfg):
    """(r) The whole TrainState of smollm-135m at full width (params,
    random moments, rng, step) expanded from 2 to 4 virtual slices of the
    card and shrunk back, every leaf bit-equal, a copy on the card for
    every non-local transfer; ownership per Listing 3; migrate_slice.
    Returns the trainer and both states, for phase (k)."""
    from repro_torch.core import (NamedSharding, PartitionSpec, gather,
                                  migrate_slice, ownership_map, place,
                                  reshard, resized_mesh, slice_devices)
    from repro_torch.core.sharding import distinct_blocks
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.prng import fold_in
    tr = elastic_trainer(cfg, data_cfg, 1, 2)
    state = tr.init_state(params=params)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name in ("mu", "nu"):
        state["opt"][name] = tree_map(lambda x: x.map(lambda t: torch.randn(
            t.shape, generator=gen, device=t.device).abs()),
            state["opt"][name])
    state["rng"] = state["rng"].map(lambda k: fold_in(k, 7))
    state["step"] = state["step"].map(lambda t: t + 5)
    devices = slice_devices(ELASTIC_SLICES)
    m4 = resized_mesh(tr.mesh, 4, devices=devices)
    sh4 = tr._state_shardings(m4)
    s4, grow = checked_reshard(state, sh4)
    s2, shrink = checked_reshard(s4, tr._state_shardings(tr.mesh))
    for a, b in zip(tree_leaves(state), tree_leaves(s2)):
        if not same_bits(gather(a), gather(b)):
            raise AssertionError("expand then shrink changed a leaf")
    # Listing 3: each sharded moment's new blocks start at the quarters of
    # its sharded dimension
    for mu in tree_leaves(s4["opt"]["mu"]):
        blocks = distinct_blocks(mu)
        if len(blocks) != 4:
            raise AssertionError(f"{mu} not cut in four")
        dim = next(i for i, s in enumerate(blocks[0][0])
                   if s.stop - s.start != mu.shape[i])
        starts = sorted(idx[dim].start for idx in ownership_map(mu).values())
        if starts != [q * mu.shape[dim] // 4 for q in range(4)]:
            raise AssertionError(f"{mu}: starts {starts}")
    x = torch.arange(64.0, device="cuda").reshape(8, 8)
    x4 = reshard(place(x, NamedSharding(tr.mesh, PartitionSpec("data"))),
                 NamedSharding(m4, PartitionSpec("data")))
    starts = sorted(idx[0].start for idx in ownership_map(x4).values())
    rows = torch.arange(4.0, device="cuda")[:, None].repeat(1, 3)
    swapped = gather(migrate_slice(place(rows, NamedSharding(
        m4, PartitionSpec("data"))), m4, 0, 2))[:, 0].tolist()
    n = len(tree_leaves(state))
    log("r", f"{cfg.name} TrainState ({n} leaves, "
             f"{sum(x.nbytes for x in tree_leaves(state['params'])) / 1e9:.3f}"
             f" GB of parameters on each slice, ZeRO-1 moments) expand 2 -> 4"
             f" virtual slices: {grow['copies']} copies on the card, "
             f"{grow['moved'] / 1e9:.3f} GB moved, {grow['kept']} blocks "
             f"kept in place; shrink 4 -> 2: {shrink['copies']} copies, "
             f"{shrink['moved'] / 1e9:.3f} GB moved, "
             f"{shrink['local'] / 1e9:.3f} GB copied on the receivers, "
             f"{shrink['kept']} blocks kept; every leaf bit-equal; 8x8 "
             f"expand starts {starts}; migrate_slice(0, 2) rows {swapped}")
    if grow["copies"] != 2 * n or grow["kept"] != 2 * n or \
            grow["kept_at"] != {0, 2} or \
            starts != [0, 2, 4, 6] or swapped != [2.0, 1.0, 0.0, 3.0] or \
            not torch.equal(gather(x4), x):
        raise AssertionError("resharding does not follow Listing 3")
    return tr, state, s4


def phase_elastic_fp32(cfg, model, params, data_cfg):
    """(r) fp32 at full width, weights at a per-layer fan-in: a run that
    expands 2 -> 4 slices at its first reconfiguration point against the
    same steps at 4 slices from the same state, the losses within
    ELASTIC_TOL; the first steps at 1, 2 and 4 slices within SLICES_TOL."""
    f32 = dataclasses.replace(cfg, dtype="float32")
    from repro_torch.core import Action, Decision
    sane = at_per_layer_fan_in(model, params, cfg.pattern_repeats[0])

    def run(slices, steps, rms=None):
        tr = elastic_trainer(f32, data_cfg, steps, slices, rms=rms,
                             check_period=2)
        tr.train(state=tr.init_state(params=sane))
        return [m["loss"] for m in tr.metrics], tr

    fixed, _ = run(4, ELASTIC_FP32_STEPS)
    elastic, tr = run(2, ELASTIC_FP32_STEPS,
                      ScriptedRMS({1: Decision(Action.EXPAND, 4)}))
    one, _ = run(1, 2)
    diff = max(abs(a - b) for a, b in zip(fixed, elastic))
    spread = max(abs(a - b) for run_ in (one, elastic[:2])
                 for a, b in zip(run_, fixed[:2]))
    log("r", f"{cfg.name} fp32 B{data_cfg.global_batch} S{data_cfg.seq_len} "
             f"(per-layer fan-in): losses at 4 slices "
             + ", ".join(f"{x:.6f}" for x in fixed) + "; 2 -> 4 "
             + ", ".join(f"{x:.6f}" for x in elastic)
             + f" (resize {tr.resize_log}); largest difference {diff:.3e} "
             f"(tol {ELASTIC_TOL}); first two steps at 1, 2 and 4 slices "
             f"within {spread:.3e} (tol {SLICES_TOL})")
    if [(r["action"], r["from"], r["to"]) for r in tr.resize_log] != \
            [("EXPAND", 2, 4)] or diff > ELASTIC_TOL or spread > SLICES_TOL:
        raise AssertionError("elastic training does not match fixed")


class ScriptedCluster:
    """The synthetic stream beside a scripted cluster (examples/
    elastic_train.py): a rival job of 2 nodes is queued before step
    RIVAL_QUEUED's batch, started by the RMS as soon as it fits, and
    finished before step RIVAL_DONE's."""

    def __init__(self, data, rms):
        from repro_torch.rms import Job
        self.data, self.rms = data, rms
        self.rival = Job(job_id=1, app="lm:rival", submit_time=0.0, work=1e9,
                         min_nodes=2, max_nodes=2, preferred=None,
                         requested_nodes=2)
        self.events = []

    def batch(self, step):
        from repro_torch.rms import JobState
        rival, rms = self.rival, self.rms
        if step == RIVAL_QUEUED and rival not in rms.jobs:
            rms.submit(rival)
            self.events.append((step, "rival queued"))
        if rival.state is JobState.PENDING and rival in rms.jobs and \
                rival.requested_nodes <= rms.cluster.free_nodes:
            rms.cluster.allocate(rival.job_id, rival.requested_nodes)
            rival.state, rival.nodes = JobState.RUNNING, 2
            self.events.append((step, "rival started"))
        if step == RIVAL_DONE and rival.state is JobState.RUNNING:
            rms.finish(rival.job_id)
            self.events.append((step, "rival finished"))
        return self.data.batch(step)


def phase_elastic_loop(cfg, params, data_cfg):
    """(r) The paper's loop in bf16: LocalRMS with the reference's policy
    over 4 nodes, the job on all 4. The queued rival makes the policy
    SHRINK it; when the rival finishes, it EXPANDs back. Checkpoints every
    LOOP_CKPT steps into a temporary directory; the first try of state
    step FAULT_AT raises, and the trainer restores the latest checkpoint
    and goes on: exactly one recovery. Every step launches 60 forward and
    30 backward flash kernels per slice; the loss falls."""
    import tempfile
    from repro_torch.data import SyntheticLMData
    from repro_torch.rms import Job
    from repro_torch.runtime import LocalRMS
    rms = LocalRMS(num_nodes=ELASTIC_SLICES)
    rms.submit(Job(job_id=0, app=f"lm:{cfg.name}", submit_time=0.0,
                   work=LOOP_STEPS, min_nodes=1, max_nodes=ELASTIC_SLICES,
                   preferred=None, requested_nodes=ELASTIC_SLICES),
               start=True)
    cluster = ScriptedCluster(SyntheticLMData(data_cfg), rms)
    (ROOT / "build").mkdir(exist_ok=True)
    per_step = flash_per_step(cfg)
    wrappers = counters()
    calls, faults = [], []
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as ckpt:
        tr = elastic_trainer(cfg, cluster, LOOP_STEPS, ELASTIC_SLICES,
                             rms=rms, check_period=LOOP_CHECK,
                             ckpt_period=LOOP_CKPT, ckpt_dir=ckpt)
        step_fn = tr.train_step

        def step(state, batch):
            at = int(state["step"])
            if at == FAULT_AT and not faults:
                faults.append(at)
                raise RuntimeError(f"fault injected at step {at}")
            before = {n: wrappers[n].launches for n in per_step}
            out = step_fn(state, batch)
            calls.append((at, tr.slices, {n: wrappers[n].launches
                                          - before[n] for n in per_step}))
            return out

        tr.train_step = step
        t0 = time.perf_counter()
        state = tr.train(state=tr.init_state(params=params))
        seconds = time.perf_counter() - t0
        saved = sorted(p.name for p in Path(ckpt).glob("ckpt_*"))
    losses = [m["loss"] for m in tr.metrics]
    log("r", f"{cfg.name} bf16 B{data_cfg.global_batch} S{data_cfg.seq_len}"
             f", LocalRMS of {ELASTIC_SLICES} nodes: {LOOP_STEPS} steps in "
             f"{seconds:.1f} s; cluster {cluster.events}; resizes "
             + "; ".join(f"{r['action']} {r['from']} -> {r['to']} at step "
                         f"{r['step']} in {r['resize_s'] * 1e3:.3f} ms"
                         for r in tr.resize_log)
             + f"; recoveries {tr.recoveries}; checkpoints kept {saved}; "
             f"slices by step {[m['slices'] for m in tr.metrics]}; losses "
             + ", ".join(f"{x:.4f}" for x in losses))
    actions = [r["action"] for r in tr.resize_log]
    bad = [c for c in calls
           if c[2] != {n: c[1] * k for n, k in per_step.items()}]
    if "SHRINK" not in actions or "EXPAND" not in actions:
        raise AssertionError(f"the loop did not shrink and expand: "
                             f"{tr.resize_log}")
    if len(faults) != 1 or len(tr.recoveries) != 1 or \
            tr.recoveries[0]["failed"] != FAULT_AT:
        raise AssertionError(f"recoveries {tr.recoveries} for faults "
                             f"{faults}")
    if bad or not calls:
        raise AssertionError(f"flash launches per step {bad}, expected "
                             f"{per_step} per slice")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            int(state["step"]) != LOOP_STEPS:
        raise AssertionError("the elastic loop did not bring the loss down")


def phase_reshard_times(cfg, trainer, s2, s4):
    """(k) timed_reshard against timed_reshard(impl=checkpoint_reshard) for
    the TrainState's expand 2 -> 4 and shrink 4 -> 2, three of each, with
    the plan's bytes (non-local transfers) and the rate they imply; then
    migrate_slice(0, 2) of every leaf of the 4-slice state."""
    from repro_torch.core import (checkpoint_reshard, migrate_slice,
                                  reshard, resized_mesh, slice_devices,
                                  timed_reshard)
    from repro_torch.core.reshard import synchronize
    from repro_torch.models.layers import tree_leaves, tree_map
    m4 = resized_mesh(trainer.mesh, 4,
                      devices=slice_devices(ELASTIC_SLICES))
    cases = {"expand 2 -> 4": (s2, trainer._state_shardings(m4)),
             "shrink 4 -> 2": (s4, trainer._state_shardings(trainer.mesh))}
    for name, (src, sh) in cases.items():
        plan = []
        reshard(src, sh, transfers=plan)
        moved = sum(t.nbytes for t in plan if not t.local)
        times = {}
        for impl in (reshard, checkpoint_reshard):
            times[impl.__name__] = [timed_reshard(src, sh, impl=impl)[1]
                                    * 1e3 for _ in range(3)]
        best = min(times["reshard"])
        slow = min(times["checkpoint_reshard"])
        log("k", f"{cfg.name} TrainState {name} virtual slices: reshard "
                 + ", ".join(f"{t:.3f}" for t in times["reshard"])
                 + f" ms ({moved / 1e9:.3f} GB of non-local transfers, "
                 f"{moved / best / 1e6:.1f} GB/s at the best); "
                 f"checkpoint_reshard "
                 + ", ".join(f"{t:.3f}" for t in times["checkpoint_reshard"])
                 + f" ms (to the host and back, pageable memory), "
                 f"{slow / best:.1f}x the reshard; on-card copies, not the "
                 f"paper's links between nodes")
    synchronize(s4)
    t0 = time.perf_counter()
    out = tree_map(lambda x: migrate_slice(x, x.sharding.mesh, 0, 2), s4)
    synchronize(out)
    ms = (time.perf_counter() - t0) * 1e3
    moved = sum(2 * x.shards[(0, 0)].numel() * x.dtype.itemsize
                for x in tree_leaves(s4))
    log("k", f"{cfg.name} migrate_slice(0, 2) of every leaf at 4 slices: "
             f"{ms:.3f} ms, {moved / 1e9:.3f} GB swapped, "
             f"{moved / ms / 1e6:.1f} GB/s")


# -- (s) the paper's apps ---------------------------------------------------------

# card against the CPU's plain path: n of CG and Jacobi, N of N-body, and the
# steps, at MODEL_TOL max-normalised (fp32 against fp64 on the CPU: 3e-6 at
# most, CG's x)
APP_PARITY_N, APP_PARITY_STEPS = 2048, 5
# the Table 1 state sizes (src/repro/rms/costmodel.py:73-82): CG's x, r, p
# 0.95 GiB (1 GiB), Jacobi's grid and rhs 2 GiB, N-body's (N, N, 3)
# difference tensor 3.2 GB, Flexible Sleep 1 GiB
APP_SIZES = {"cg": 9216, "jacobi": 16384, "nbody": 16384}
FS_BYTES = 1 << 30
# N-body at N 16384: the reference's bound (1e-2, absolute, at N 64) does
# not scale with N; the momentum's drift over the momentum the forces moved,
# sum m |v - v0|, does: fp32 rounding leaves 2e-9 at N 64-2048 on the CPU,
# forces that are not equal and opposite leave O(1)
MOMENTUM_TOL = 1e-6
# the slices an app's state goes through, by timed_reshard
APP_SLICES = (1, 2, 4, 2)


def state_gib(state):
    from repro_torch.models.layers import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(state)) \
        / 2 ** 30


def phase_apps_parity():
    """(s) Each app's steps on the card against the CPU's plain path from
    one initial state: every leaf within MODEL_TOL, max-normalised."""
    from repro_torch.apps import APPS
    from repro_torch.models.layers import tree_leaves, tree_map
    for name, (init, step) in APPS.items():
        card = init(APP_PARITY_N, device="cuda")
        cpu = tree_map(lambda t: t.cpu(), card)
        for _ in range(APP_PARITY_STEPS):
            card, cpu = step(card), step(cpu)
        errs = [max_norm_err(a.cpu(), b) for a, b in zip(tree_leaves(card),
                                                         tree_leaves(cpu))]
        log("s", f"{name} n {APP_PARITY_N}, {APP_PARITY_STEPS} steps: card "
                 f"against the CPU's plain path, max-normalised "
                 f"{max(errs):.3e} (bound {MODEL_TOL})")
        if not max(errs) <= MODEL_TOL:
            raise AssertionError(f"{name}: card and CPU part by {errs}")


def phase_apps_table1():
    """(s) Each app at its Table 1 state size on the card, held to the
    reference's own properties (tests/test_apps.py): CG's residual falls,
    Jacobi contracts, N-body's momentum is conserved and its positions stay
    finite. Returns each app's state."""
    from repro_torch.apps import (FlexibleSleep, cg_init, cg_step,
                                  jacobi_init, jacobi_step, nbody_init,
                                  nbody_step)
    states = {}
    t0 = time.perf_counter()
    s = cg_init(APP_SIZES["cg"])
    states["cg"] = s
    r0 = float(s.rs.sqrt())
    for _ in range(30):
        s = cg_step(s)
    r30 = float(s.rs.sqrt())
    log("s", f"cg n {APP_SIZES['cg']} ({state_gib(states['cg']):.3f} GiB): "
             f"residual {r0:.4g} -> {r30:.4g} in 30 steps "
             f"({r30 / r0:.4f}, bound 0.2)")
    if not r30 < 0.2 * r0 or not torch.isfinite(s.x).all():
        raise AssertionError("CG's residual did not fall")

    s = jacobi_init(APP_SIZES["jacobi"])
    states["jacobi"] = s
    d_early = float((jacobi_step(s)["grid"] - s["grid"]).abs().max())
    for _ in range(200):
        s = jacobi_step(s)
    d_late = float((jacobi_step(s)["grid"] - s["grid"]).abs().max())
    log("s", f"jacobi n {APP_SIZES['jacobi']} "
             f"({state_gib(states['jacobi']):.3f} GiB): max change "
             f"{d_early:.4g} at step 1, {d_late:.4g} at step 201 "
             f"({d_late / d_early:.4f}, bound 0.2)")
    if not d_late < 0.2 * d_early:
        raise AssertionError("Jacobi does not contract")

    s = nbody_init(APP_SIZES["nbody"])
    states["nbody"] = s
    v0 = s["vel"]
    p0 = (s["vel"] * s["mass"][:, None]).sum(0)
    for _ in range(10):
        s = nbody_step(s)
    p1 = (s["vel"] * s["mass"][:, None]).sum(0)
    moved = float(((s["vel"] - v0).abs() * s["mass"][:, None]).sum())
    drift = float((p1 - p0).abs().max())
    log("s", f"nbody N {APP_SIZES['nbody']} ((N, N, 3) differences "
             f"{APP_SIZES['nbody'] ** 2 * 12 / 1e9:.2f} GB): momentum drift "
             f"{drift:.4g} over 10 steps against {moved:.4g} moved by the "
             f"forces ({drift / moved:.3e}, bound {MOMENTUM_TOL})")
    if not torch.isfinite(s["pos"]).all() or not drift <= MOMENTUM_TOL * moved:
        raise AssertionError("N-body lost momentum or went non-finite")

    fs = FlexibleSleep(nbytes=FS_BYTES, step_s=0.0)
    states["fs"] = fs.step(fs.init())
    if states["fs"]["data"].nbytes != FS_BYTES:
        raise AssertionError("Flexible Sleep holds the wrong size")
    torch.cuda.synchronize()
    log("s", f"Table 1 sizes held in {time.perf_counter() - t0:.1f} s")
    return states


def phase_apps_times(states):
    """(s) Each app's per-iteration time (apps.calibrate), then each app's
    state through 1 -> 2 -> 4 -> 2 virtual slices of the card by
    timed_reshard, bit-equal after every step."""
    from repro_torch.apps import APPS, calibrate, data_shardings
    from repro_torch.core import (gather, make_mesh, place, resized_mesh,
                                  slice_devices, timed_reshard)
    from repro_torch.models.layers import tree_leaves, tree_map
    for name in APPS:
        mean, std = calibrate(name, APP_SIZES[name], iters=10)
        log("s", f"{name} n {APP_SIZES[name]}: {mean * 1e3:.3f} ms per "
                 f"iteration (std {std * 1e3:.3f} ms, 10 iterations)")
    devices = slice_devices(max(APP_SLICES))
    for name, state in states.items():
        mesh = make_mesh(APP_SLICES[0], 1, devices=devices)
        cur = tree_map(place, state, data_shardings(state, mesh))
        path = f"{APP_SLICES[0]}"
        for q in APP_SLICES[1:]:
            mesh = resized_mesh(mesh, q, devices=devices)
            cur, secs = timed_reshard(cur, data_shardings(state, mesh))
            path += f" -> {q} ({secs * 1e3:.3f} ms)"
            for a, b in zip(tree_leaves(cur), tree_leaves(state)):
                if not same_bits(gather(a), b):
                    raise AssertionError(f"{name}: reshard to {q} slices "
                                         f"changed its state")
        log("s", f"{name} state ({state_gib(state):.3f} GiB) through "
                 f"{path} virtual slices by timed_reshard, bit-equal each "
                 f"time; on-card copies, not links between nodes")


# -- (t) calibration: the port's reshards on virtual slices, fitted ---------------


def phase_calibration():
    """(t) measure_grid(MeasureConfig(backend="torch")) on the CI grid: the
    port's reshard of 64 MiB - 1 GiB between 1 and 64 virtual slices of the
    card, each resize checked by measure_grid itself (bit-equal, the
    reshard's transfers carrying the plan's non-local bytes) and here (each
    sample's plan features, positive seconds); then the fit. The fit's
    verdict is printed, not asserted: the paper's model divides the
    busiest link's bytes by a per-node bandwidth, and virtual slices share
    one HBM, so a refusal (FitError) is a finding about one card."""
    from repro_torch.calib import (FitError, MeasureConfig, fit_report_rows,
                                   fit_samples, make_artifact, measure_grid,
                                   validate_calibration)
    from repro_torch.calib.measure import resize_features
    from repro_torch.rms.costmodel import ReconfigCostModel
    config = MeasureConfig(backend="torch")
    t0 = time.perf_counter()
    samples, env = measure_grid(config)
    kinds = [s["kind"] for s in samples]
    n_resize = 2 * len(config.geometries) * len(config.data_bytes)
    if kinds.count("expand") + kinds.count("shrink") != n_resize or \
            kinds.count("sched") != len(config.sched_nodes):
        raise AssertionError(f"samples {kinds}")
    for s in samples:
        if not s["seconds"] > 0:
            raise AssertionError(f"sample {s} took no time")
        if s["kind"] in ("expand", "shrink") and \
                (s["participants"], s["busiest_bytes"]) != resize_features(
                    s["kind"], s["old"], s["new"], s["bytes"]):
            raise AssertionError(f"sample {s} is not its plan's")
    log("t", f"{len(samples)} samples ({n_resize} resizes, each bit-equal "
             f"with the plan's non-local bytes) in "
             f"{time.perf_counter() - t0:.1f} s; environment {env}")
    for s in samples:
        if s["kind"] in ("migrate", "sched"):
            log("t", f"{s['kind']} {s['old']} slices: "
                     f"{s['seconds'] * 1e3:.4f} ms")
    # each geometry alone: seconds against busiest-link bytes over the data
    # sizes, the copy rate its slope gives and the time at zero bytes (the
    # host's share), which the model's one spawn_s cannot follow
    by_geometry = {}
    for s in samples:
        if s["kind"] in ("expand", "shrink"):
            by_geometry.setdefault((s["kind"], s["old"], s["new"]), []).append(
                (s["busiest_bytes"], s["seconds"]))
    for (kind, old, new), pts in by_geometry.items():
        slope, at_zero = np.polyfit(*zip(*pts), 1)
        rate = f"{1 / slope / 1e12:.3f} TB/s" if slope > 0 else "no rate"
        log("t", f"{kind} {old} -> {new} alone: {rate} of busiest-link "
                 f"bytes, {at_zero * 1e3:.4f} ms at zero bytes")
    try:
        fitted, residuals, checks = fit_samples(samples)
    except FitError as err:
        log("t", f"fit: FitError: {err}")
        for s in samples:
            if s["kind"] in ("expand", "shrink"):
                log("t", f"{s['kind']} {s['old']} -> {s['new']}, "
                         f"{s['bytes'] / 2 ** 20:.0f} MiB: "
                         f"{s['seconds'] * 1e3:.4f} ms, busiest link "
                         f"{s['busiest_bytes'] / 2 ** 20:g} MiB, "
                         f"{s['participants']} participants")
        return
    doc = validate_calibration(make_artifact(
        samples=samples, fitted=fitted, residuals=residuals, checks=checks,
        grid=config.grid_doc(), backend=config.backend, environment=env))
    model = ReconfigCostModel.from_artifact(doc)
    log("t", f"fit: calibration {doc['calibration_id']}: {fitted}; "
             f"residuals {residuals}; Fig. 3b checks {checks}; model "
             f"link_bw {model.link_bw:.4g} B/s")
    for row in fit_report_rows(doc):
        log("t", f"{row['action']} {row['from']} -> {row['to']}, "
                 f"{row['bytes'] / 2 ** 20:.0f} MiB: measured "
                 f"{row['measured_s'] * 1e3:.4f} ms, fitted "
                 f"{row['fitted_s'] * 1e3:.4f} ms, paper-fit "
                 f"{row['paper_s'] * 1e3:.4f} ms")


# -- (u)-(x) slice 9: gemma2, the MoE families, qwen3 and granite, and the --------
# compressed all-reduce

# the decoders whose fp32 weights at their published depth do not fit the
# card: (published depth, layers drawn at its scale and driven)
ZOO_CUT = {"gemma2-27b": (46, 4), "phi3.5-moe-42b-a6.6b": (32, 4),
           "deepseek-moe-16b": (28, 4)}
# MoE routing, card against CPU from the same fp32 input: their router
# logits differ by about 1e-5 (the attention's and the projections'
# rounding); a token whose chosen experts differ at a logit gap under
# NEAR_TIE is a near tie, reported with its probability gap, its tokens
# left out of that block's output comparison. A flip at a larger gap fails.
NEAR_TIE = 1e-3
# the compressed all-reduce: virtual slices of the card, and the steps of
# the error-feedback check (tests/test_multidevice.py:144)
COMPRESS_SLICES, COMPRESS_STEPS = (2, 4), 12
# what the child process of (u)-(x) hands back (run_zoo)
ZOO_RESULT = ROOT / "build" / "chip_smoke_zoo.json"


def cpu_tree(tree):
    from repro_torch.models.layers import tree_map
    return tree_map(lambda t: t.cpu(), tree)


def router_input(p, x, cfg, kind, max_len):
    """What a "moe" block's feed-forward sees: the block's input after its
    attention and the second norm (block_prefill's first half)."""
    from repro_torch.models import attention
    from repro_torch.models.layers import rms_norm
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, _ = attention.attention_prefill(p["attn"], h, cfg, kind=kind,
                                       cache_len=max_len)
    return rms_norm(x + y, p["ln2"], cfg.norm_eps)


def compare_routing(label, name, cfg, p_card, p_cpu, x, kind, max_len,
                    hold=True):
    """The experts a "moe" block chose for every token on the card and on
    the CPU, from the same input ``x`` (CPU, fp32). Prints the choices
    dropped at capacity and the router loss on each side, and each flipped
    token with its logit and probability gap. Returns the (B, S) mask of
    tokens whose slots agree; raises on a flip that is not a near tie."""
    from repro_torch.models import moe
    s = x.shape[1]
    ne = cfg.num_experts
    cap = moe.capacity(cfg, s, cfg.capacity_factor)
    h_card = router_input(p_card, x.cuda(), cfg, kind, max_len)
    h_cpu = router_input(p_cpu, x, cfg, kind, max_len)
    probs_g, e_g, _, aux_g = moe.route(p_card["ffn"], h_card, cfg)
    probs_c, e_c, _, aux_c = moe.route(p_cpu["ffn"], h_cpu, cfg)
    e_g = e_g.cpu()
    slots_g = moe.dispatch_slots(e_g, ne, cap)
    slots_c = moe.dispatch_slots(e_c, ne, cap)
    drops = [int((sl == ne * cap).sum()) for sl in (slots_g, slots_c)]
    flips = []
    for b, t in (e_g != e_c).any(-1).nonzero().tolist():
        j = int((e_g[b, t] != e_c[b, t]).nonzero()[0])
        mine, theirs = int(e_g[b, t, j]), int(e_c[b, t, j])
        pc = probs_c[b, t]
        gap_logit = abs(float(torch.log(pc[mine]) - torch.log(pc[theirs])))
        flips.append((b, t, mine, theirs, gap_logit,
                      abs(float(pc[mine] - pc[theirs]))))
    log(label, f"{name}: routing of {e_c.numel()} choices (B{x.shape[0]} "
               f"S{s}, top-{cfg.top_k} of {ne}, capacity {cap}): "
               f"{len(flips)} tokens choose otherwise on the card; dropped "
               f"at capacity card {drops[0]}, CPU {drops[1]}; router loss "
               f"card {float(aux_g):.6e}, CPU {float(aux_c):.6e}")
    for b, t, mine, theirs, gap, pgap in flips:
        log(label, f"{name}: token (row {b}, position {t}) chose expert "
                   f"{mine} on the card and {theirs} on the CPU: logit gap "
                   f"{gap:.3e}, probability gap {pgap:.3e}"
                   + (" (a near tie)" if gap < NEAR_TIE else ""))
        if hold and gap >= NEAR_TIE:
            raise AssertionError(f"{name}: the card routes token ({b}, {t}) "
                                 "otherwise, at more than a near tie")
    return (slots_g == slots_c).reshape(e_c.shape).all(-1)


def phase_blocks_vs_cpu(label, cfg, params, toks, max_len, hold=True):
    """fp32 prefill on the card (the flash kernel) against the same
    weights' plain path on the CPU, block by block from the same input
    (the CPU's output of the block before): each block's output and cache
    leaves at MODEL_TOL, a local ring's positions exactly; for a "moe"
    block the routing too (compare_routing). Then the card's prefill
    logits against the CPU's. With ``hold`` False the errors are printed
    and a flip at any gap is reported, not raised."""
    from repro_torch.models import CausalLM, build_model, transformer
    from repro_torch.models.layers import (embed_apply, rms_norm,
                                           unembed_apply)
    cfg = dataclasses.replace(cfg, dtype="float32")
    card = build_model(cfg)
    s = toks.shape[1]
    x = embed_apply(cpu_tree(params["embed"]), toks.cpu(), cfg)
    errs, rings = {}, []
    for i, (key, slot, kind) in enumerate(card._layers()):
        p_card = CausalLM._select(params, key, slot)
        p_cpu = cpu_tree(p_card)
        name = f"layer {i} ({kind})"
        y_card, c_card = transformer.block_prefill(p_card, x.cuda(), cfg,
                                                   kind, max_len)
        y, c = transformer.block_prefill(p_cpu, x, cfg, kind, max_len)
        keep = torch.ones(y.shape[:2], dtype=torch.bool)
        if "router" in p_cpu.get("ffn", {}):
            keep = compare_routing(label, name, cfg, p_card, p_cpu, x, kind,
                                   max_len, hold)
            if not keep.all():
                log(label, f"{name}: output held on the {int(keep.sum())} "
                           f"of {keep.numel()} tokens whose slots agree")
        errs[f"{i} out"] = ((y_card.cpu() - y).abs()[keep].max()
                            / (y.abs().max() + 1e-6)).item()
        for leaf, w in c.items():
            if leaf == "pos":
                if not torch.equal(c_card[leaf].cpu(), w):
                    raise AssertionError(f"{name}: cache positions differ")
                if kind == "local":
                    rings.append(check_ring(w, s))
            else:
                errs[f"{i}/{leaf}"] = max_norm_err(c_card[leaf].cpu(), w)
        x = y
        del p_cpu, y_card, c_card
    x = rms_norm(x, cpu_tree(params["final_norm"]), cfg.norm_eps)
    want = unembed_apply(cpu_tree(params["embed"]), x[:, -1:], cfg)
    got, _ = card.prefill(params, toks, max_len=max_len)
    errs["logits"] = max_norm_err(got.cpu(), want)
    log(label, f"{cfg.name} ({cfg.num_layers} layers) fp32 prefill "
               f"B{toks.shape[0]} S{s} on the card vs the CPU's plain path, "
               f"block by block, max-normalised: "
               + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
               + (f" (tol {MODEL_TOL})" if hold else " (not held)")
               + (f"; local rings hold positions {rings[0]}..{s - 1}, equal "
                  f"on both" if rings else ""))
    if hold and max(errs.values()) > MODEL_TOL:
        raise AssertionError(f"{cfg.name}: fp32 prefill on the card "
                             "disagrees with the CPU's plain path")


def drive_zoo(label, cfg, depth, toks, blocks_of, long_toks=None):
    """One model's main path, twice, each from its own draw on the card.

    First with each layer's weights at its own fan-in, where every check
    is held: prefill (kernel against chunked), the fp32 blocks against the
    CPU (``blocks_of(cfg, params)``: (cfg, params, tokens, max_len)),
    prefill + decode against forward (on ``long_toks`` where given; for a
    MoE model at a capacity where no token drops: there prefill and forward
    route alike, as in the reference's own decode-consistency test). Then
    at the reference's init at ``depth``'s scale, as every other path runs:
    the same fp32 comparisons printed, not held (its attention scores reach
    the hundreds, and fp32 rounding moves a softmax so near an argmax by
    more than 1e-4: PERF.md, Findings), the bf16 ones held, the MoE
    blocks against the CPU, Server and the step times. Returns (launch
    counts, Server tok/s, peak GiB)."""
    decode_cfg = cfg
    if cfg.num_experts:
        decode_cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    seq = toks if long_toks is None else long_toks
    torch.cuda.reset_peak_memory_stats()
    _, params = model_and_params(cfg, label, depth, on_card=True,
                                 per_layer=True)
    held, _ = drive(label, (
        lambda: phase_prefill(cfg, params, toks[:, :PREFILL_S], label),
        lambda: phase_blocks_vs_cpu(label, *blocks_of(cfg, params)),
        lambda: phase_decode(label, decode_cfg, params, seq, steps=8)))
    del params
    torch.cuda.empty_cache()
    model, params = model_and_params(cfg, label, depth, on_card=True)
    phases = [
        lambda: phase_prefill(cfg, params, toks[:, :PREFILL_S], label,
                              hold=False),
        lambda: phase_decode(label, decode_cfg, params, seq, steps=8,
                             hold_fp32=False),
        lambda: phase_server(label, model, params)]
    if cfg.num_experts:
        phases.insert(1, lambda: phase_blocks_vs_cpu(
            label, *blocks_of(cfg, params), hold=False))
    counts, (*_, tok_s) = drive(label, phases)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(label, f"{cfg.name}: peak device memory {peak:.2f} GiB")
    counts = {k: held[k] + counts[k] for k in counts}
    if counts["flash_attention"] == 0:
        raise AssertionError(f"{cfg.name}'s path never launched "
                             "flash_attention")
    phase_step_times(cfg, params, toks[:, :PREFILL_S])
    return counts, tok_s, peak


def phase_compression():
    """(x) compressed_psum_grads on 2 and 4 virtual slices of the card over
    smollm-135m's full-width gradient tree (random gradients and
    residuals from a seed): means and residuals bit-equal to the CPU's on
    the same inputs (elementwise IEEE fp32 and an exact int32 sum); the
    error-feedback property over 12 steps; the wall ms of a call, beside
    the plain fp32 sum in slice order, and the payload bytes against
    fp32's."""
    from repro_torch.configs import get_config
    from repro_torch.core import make_mesh, slice_devices
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import compressed_psum_grads
    from repro_torch.optim.compression import BLOCK
    specs = build_model(get_config("smollm-135m")).specs()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def draw(scale):
        return tree_map(lambda sp: torch.randn(
            sp.shape, generator=gen, device=gen.device) * scale, specs)
    sizes = [int(np.prod(sp.shape)) for sp in tree_leaves(specs)]
    numel, blocks = sum(sizes), sum(-(-k // BLOCK) for k in sizes)
    for n in COMPRESS_SLICES:
        mesh = make_mesh(n, 1, devices=slice_devices(n, "cuda"))
        cpu_mesh = make_mesh(n, 1, devices=slice_devices(n, "cpu"))
        grads = [draw(1e-3) for _ in range(n)]
        errors = [draw(1e-6) for _ in range(n)]
        means, errs = compressed_psum_grads(grads, mesh, errors=errors)
        want_m, want_e = compressed_psum_grads(
            [cpu_tree(g) for g in grads], cpu_mesh,
            errors=[cpu_tree(e) for e in errors])
        differ = 0
        for got, want in ((means, want_m), (errs, want_e)):
            for g, w in zip(got, want):
                for a, b in zip(tree_leaves(g), tree_leaves(w)):
                    differ += int((a.cpu().view(torch.int32)
                                   != b.view(torch.int32)).sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            compressed_psum_grads(grads, mesh, errors=errors)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3

        def plain_sum():
            total = tree_map(torch.clone, grads[0])
            for g in grads[1:]:
                tree_map(lambda r, x: r.add_(x), total, g)
            return total
        plain_sum()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            plain_sum()
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) / 3 * 1e3
        log("x", f"compressed all-reduce, {n} virtual slices, smollm-135m's "
                 f"gradient tree ({numel} fp32 elements a slice): "
                 f"{differ} bits of the means and residuals differ from the "
                 f"CPU's; {ms:.3f} ms a call (the plain fp32 sum in slice "
                 f"order {plain:.3f} ms); payload a slice {numel + 4 * blocks}"
                 f" bytes (int8 and an fp32 scale per {BLOCK}) against "
                 f"{4 * numel} in fp32, "
                 f"{(numel + 4 * blocks) / (4 * numel):.4f}x")
        if differ:
            raise AssertionError(f"the compressed all-reduce on the card "
                                 f"differs from the CPU's at {n} slices")
        del grads, errors, means, errs, want_m, want_e
    # error feedback over one fixed set of gradients
    n = COMPRESS_SLICES[-1]
    mesh = make_mesh(n, 1, devices=slice_devices(n, "cuda"))
    grads = [draw(1e-3) for _ in range(n)]
    truth = tree_map(lambda *g: torch.stack(g).mean(0), *grads)
    errors, acc, first = None, None, None
    for _ in range(COMPRESS_STEPS):
        means, errors = compressed_psum_grads(grads, mesh, errors=errors)
        m = means[0]
        first = first or m
        acc = m if acc is None else tree_map(torch.add, acc, m)

    def rel(tree):
        return max(((a - t).abs().max() / (t.abs().max() + 1e-9)).item()
                   for a, t in zip(tree_leaves(tree), tree_leaves(truth)))
    rel1 = rel(first)
    rel_n = rel(tree_map(lambda a: a / COMPRESS_STEPS, acc))
    log("x", f"error feedback, {n} slices, {COMPRESS_STEPS} steps: a single "
             f"shot within {rel1:.4f} of the true mean (max-normalised, the "
             f"largest over the leaves; bound 0.25), the running average "
             f"within {rel_n:.4f} (closer, and under 0.05)")
    if not (rel1 < 0.25 and rel_n < rel1 and rel_n < 0.05):
        raise AssertionError("error feedback does not converge")


# -- (k) times --------------------------------------------------------------------


def phase_step_times(cfg, params, toks):
    """End to end: one full-width bf16 prefill (for attention models through
    the kernel and through the chunked path) and one batch-4 decode step;
    for each, the card's busy time under the profiler against the
    unprofiled wall time."""
    from repro_torch.kernels.bench import device_profile, eager_ms
    from repro_torch.models import build_model
    s = toks.shape[1]
    steps = {}
    impls = ("auto", "chunked") if "global" in cfg.pattern else ("auto",)
    for impl in impls:
        model = build_model(dataclasses.replace(cfg, attn_impl=impl))
        name = f"prefill B{toks.shape[0]} S{s}" + (
            f" attn_impl={impl}" if len(impls) > 1 else "")
        steps[name] = lambda m=model: m.prefill(params, toks, max_len=s + 1)
    _, cache = model.prefill(params, toks, max_len=s + 1)
    steps[f"decode_step B{toks.shape[0]} at pos {s}"] = (
        lambda: model.decode_step(params, cache, toks[:, -1:], s))
    for name, fn in steps.items():
        wall = eager_ms(fn, iters=5)
        prof = device_profile(fn)
        log("k", f"{cfg.name} bf16 {name}: {wall:.3f} ms wall; card busy "
                 f"{prof['busy_ms']:.3f} ms in {prof['launches']} kernels "
                 f"and copies ({100 * (1 - prof['busy_ms'] / wall):.1f}% "
                 f"idle); top: " + "; ".join(
                     f"{k} {ms:.3f} ms x{n}" for k, ms, n in prof["top"]))


def build_kernels():
    """(b) nvcc on every kernel source at once; print ptxas's registers and
    spills."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru import kernel as rglru
    from repro_torch.kernels.ssd import kernel as ssd
    kernels = (("flash_attention", flash.load),
               ("flash_attention_bwd", flash.load_bwd),
               ("ssd_scan", ssd.load), ("rglru_scan", rglru.load))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        builds = {name: pool.submit(load) for name, load in kernels}
        builds = {name: f.result() for name, f in builds.items()}
    log("b", f"all {len(builds)} built in {time.perf_counter() - t0:.1f} s")
    for name, built in builds.items():
        log("b", f"{name}: {built.path.name}, nvcc {built.seconds:.1f} s")
        for line in built.log.splitlines():
            if "Compiling entry" in line or "registers" in line or \
                    "spill" in line or "wgmma.mma_async" in line:
                log("b", line.strip())


def init_at_depth(model, generator, depth, per_layer=False):
    """Parameters of ``model`` drawn as a ``depth``-layer model of its
    config would draw its layers. The reference's init takes a stacked
    weight's fan-in from the layers axis, so a model cut from 38 layers to
    8 would draw its block weights sqrt(12 / 2) times larger than the 38-layer
    model's; each stacked normal weight's scale undoes that. Nothing else
    changes. ``per_layer``: the same random numbers at each layer's own
    fan-in (at_per_layer_fan_in of that draw)."""
    from repro_torch.models import CausalLM
    from repro_torch.models.layers import (init_from_specs, torch_dtype,
                                           tree_map)
    cfg = model.cfg
    reps = model._pattern_layout()[0]
    full = CausalLM(dataclasses.replace(cfg, num_layers=depth),
                    model.device)._pattern_layout()[0]
    specs = model.specs()

    def scale(sp):
        if sp.init != "normal":
            return sp
        at = (full / layer_fan_in(sp)) ** 0.5 if per_layer else 1.0
        return dataclasses.replace(sp, scale=sp.scale * (reps / full) ** 0.5
                                   * at)
    specs["blocks"] = tree_map(scale, specs["blocks"])
    return init_from_specs(generator, specs, torch_dtype(cfg.param_dtype),
                           model.device)


def model_and_params(cfg, label, init_depth=None, on_card=False,
                     per_layer=False):
    """The model on the card and its parameters from seed 0, drawn on the
    host (the same weights as a CPU draw) or, ``on_card``, on the card (in
    a moment, where the host would take tens of seconds); ``per_layer``:
    at each layer's own fan-in (init_at_depth)."""
    from repro_torch.models import build_model
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda")
    gen = torch.Generator(device="cuda" if on_card else "cpu").manual_seed(0)
    params = (model.init(gen) if init_depth is None and not per_layer
              else init_at_depth(model, gen, init_depth or cfg.num_layers,
                                 per_layer))
    n = sum(t.numel() for t in _leaves(params))
    depth = "" if init_depth is None else \
        f" (drawn at the {init_depth}-layer model's scale)"
    if per_layer:
        depth += ", each layer at its own fan-in"
    torch.cuda.synchronize()
    log(label, f"{cfg.name}: {cfg.num_layers} layers{depth}, pattern "
               f"{cfg.pattern}, d_model {cfg.d_model}, vocab "
               f"{cfg.vocab_size}, {n} parameters, {cfg.dtype} over "
               f"{cfg.param_dtype}; init {time.perf_counter() - t0:.1f} s "
               f"on the {'card' if on_card else 'host'}")
    return model, params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def record_row(name, source, replaces, launches, err, row, shape):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": shape}


def main_zoo():
    """(u)-(x), run by ``chip_smoke.py --zoo`` in a process of its own (see
    run_zoo): each decoder of slice 9 at its published widths, its depth
    cut where its fp32 weights would not fit, drawn on the card and freed
    after its path; then the compressed all-reduce. Writes each path's
    launch counts, Server tok/s and peak GiB to ZOO_RESULT."""
    from repro_torch.configs import get_config
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(9)
    zoo = {}
    for arch, label in (("gemma2-27b", "u"), ("phi3.5-moe-42b-a6.6b", "v"),
                        ("deepseek-moe-16b", "v"), ("qwen3-4b", "w"),
                        ("granite-3-2b", "w")):
        cfg = get_config(arch)
        depth = None
        if arch in ZOO_CUT:
            depth, layers = ZOO_CUT[arch]
            cfg = dataclasses.replace(cfg, num_layers=layers)
        z_toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (PREFILL_B, PREFILL_S + 8))).cuda()
        long_toks = None
        if "local" in cfg.pattern:
            # one (local, global) unit where the window bites and the ring
            # wraps; prefill + decode of all layers past the window
            window = cfg.sliding_window
            unit_toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (1, window + 256))).cuda()
            long_toks = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (1, window + 64 + 8))).cuda()

            def blocks_of(cfg, params, unit_toks=unit_toks):
                return (*first_unit(cfg, params), unit_toks,
                        unit_toks.shape[1] + 8)
        elif cfg.num_experts:
            def blocks_of(cfg, params, z_toks=z_toks):
                return cfg, params, z_toks[:2, :256], 256 + 8
        else:
            # the whole published depth, one shorter row (the CPU's share)
            def blocks_of(cfg, params, z_toks=z_toks):
                return cfg, params, z_toks[:1, :128], 128 + 8
        counts, tok_s, peak = drive_zoo(label, cfg, depth, z_toks,
                                        blocks_of, long_toks)
        zoo[arch] = {"counts": counts, "tok_s": tok_s, "peak": peak}
        torch.cuda.empty_cache()
    phase_compression()
    ZOO_RESULT.parent.mkdir(parents=True, exist_ok=True)
    ZOO_RESULT.write_text(json.dumps(zoo))
    return 0



def run_zoo():
    """Run main_zoo in a child process and return {arch: (launch counts,
    Server tok/s, peak GiB)}. Its own process: run in the process of the
    earlier phases, these paths left torch.profiler without device events
    in the kernel timings after them, though each part alone, and twenty
    profiles after training, left it working (PERF.md, Findings). The
    child loads the kernels this process built."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ZOO_RESULT.unlink(missing_ok=True)
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--zoo"], check=False)
    if proc.returncode != 0:
        raise AssertionError(f"the slice-9 paths failed (exit "
                             f"{proc.returncode})")
    return {arch: (v["counts"], v["tok_s"], v["peak"])
            for arch, v in json.loads(ZOO_RESULT.read_text()).items()}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.kernels import bench
    start = time.perf_counter()

    # fp32 products in full fp32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = bench.card()
    log("a", f"{smi}; torch {torch.__version__} CUDA {torch.version.cuda}; "
             f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    build_kernels()
    flash_err = phase_kernel_vs_plain()
    bwd_err = phase_flash_bwd_vs_plain()
    ssd_err = phase_ssd_vs_plain()
    rglru_err = phase_rglru_vs_plain()
    log("l", f"kernels held against their plain versions; "
             f"{time.perf_counter() - start:.1f} s so far")

    rng = np.random.default_rng(0)
    smollm = get_config("smollm-135m")
    model, params = model_and_params(smollm, "e")
    toks = torch.from_numpy(rng.integers(
        0, smollm.vocab_size, (PREFILL_B, PREFILL_S + 8))).cuda()
    smollm_counts, (_, _, smollm_tok_s) = drive("g", (
        lambda: phase_prefill(smollm, params, toks[:, :PREFILL_S]),
        lambda: phase_decode("f", smollm, params, toks, steps=8),
        lambda: phase_server("g", model, params)))
    if smollm_counts["flash_attention"] == 0:
        raise AssertionError("smollm's path never launched flash_attention")

    data_cfg = DataConfig(vocab_size=smollm.vocab_size, seq_len=TRAIN_S,
                          global_batch=TRAIN_B)
    train_batch = {k: t.cuda()
                   for k, t in SyntheticLMData(data_cfg).batch(0).items()}
    train_counts, (_, trained) = drive("q", (
        lambda: phase_train_fp32(smollm, model, params, train_batch),
        lambda: phase_train_bf16(smollm, params, data_cfg, TRAIN_STEPS)))
    for name in ("flash_attention", "flash_attention_bwd"):
        if train_counts[name] == 0:
            raise AssertionError(f"smollm's training path never launched "
                                 f"{name}")
    elastic_counts, (resharded, *_) = drive("r", (
        lambda: phase_reshard(smollm, params, data_cfg),
        lambda: phase_elastic_fp32(smollm, model, params, data_cfg),
        lambda: phase_elastic_loop(smollm, params, data_cfg)))
    for name in ("flash_attention", "flash_attention_bwd"):
        if elastic_counts[name] == 0:
            raise AssertionError(f"smollm's elastic path never launched "
                                 f"{name}")
    t0 = time.perf_counter()
    phase_apps_parity()
    phase_apps_times(phase_apps_table1())
    phase_calibration()
    torch.cuda.empty_cache()
    log("t", f"apps and calibration in {time.perf_counter() - t0:.1f} s")

    mamba = get_config("mamba2-130m")
    m_model, m_params = model_and_params(mamba, "h")
    m_toks = torch.from_numpy(rng.integers(
        0, mamba.vocab_size, (PREFILL_B, PREFILL_S + 8))).cuda()
    mamba_counts, (_, _, mamba_tok_s) = drive("j", (
        lambda: phase_ssm_prefill(mamba, m_params, m_toks[:, :PREFILL_S]),
        lambda: phase_decode("i", mamba, m_params, m_toks, steps=8),
        lambda: phase_server("j", m_model, m_params)))
    if mamba_counts["ssd_scan"] == 0:
        raise AssertionError("mamba2's path never launched ssd_scan")
    phase_ssd_grad_raises(mamba, m_params)

    rg = dataclasses.replace(get_config("recurrentgemma-9b"),
                             num_layers=RG_LAYERS)
    rg_model, rg_params = model_and_params(rg, "m", init_depth=RG_DEPTH)
    window = rg.sliding_window
    rg_toks = torch.from_numpy(rng.integers(
        0, rg.vocab_size, (PREFILL_B, PREFILL_S))).cuda()
    unit_toks = torch.from_numpy(rng.integers(
        0, rg.vocab_size, (1, window + 256))).cuda()
    long_toks = torch.from_numpy(rng.integers(
        0, rg.vocab_size, (2, window + 52 + 8))).cuda()
    rg_counts, (*_, rg_tok_s) = drive("o", (
        lambda: phase_hybrid_prefill(rg, rg_params, rg_toks, unit_toks),
        lambda: phase_decode("n", *first_unit(rg, rg_params), long_toks,
                             steps=8),
        lambda: phase_decode("n", rg, rg_params, long_toks, steps=8,
                             hold_fp32=False),
        lambda: phase_decode("n", rg, at_per_layer_fan_in(
            rg_model, rg_params, RG_DEPTH // len(rg.pattern)), long_toks,
            steps=8),
        lambda: phase_server("o", rg_model, rg_params)))
    for name in ("flash_attention", "rglru_scan"):
        if rg_counts[name] == 0:
            raise AssertionError(f"recurrentgemma's path never launched "
                                 f"{name}")

    flash_rows = {label: bench.time_flash_attention(label)
                  for label in bench.SHAPES}
    for row in flash_rows.values():
        log("k", bench.describe(row))
    ssd_rows = {label: bench.time_ssd_scan(label)
                for label in bench.SSD_SHAPES}
    for row in ssd_rows.values():
        log("k", bench.describe_ssd(row))
        if row["cuda_kernels"] < 1:
            raise AssertionError(f"the profiler saw no CUDA kernel of "
                                 f"ssd_scan at {row['label']}")
    rglru_rows = {label: bench.time_rglru_scan(label)
                  for label in bench.RGLRU_SHAPES}
    for row in rglru_rows.values():
        log("k", bench.describe_rglru(row))
    phase_step_times(smollm, params, toks[:, :PREFILL_S])
    phase_step_times(mamba, m_params, m_toks[:, :PREFILL_S])
    phase_step_times(rg, rg_params, rg_toks)
    phase_reshard_times(smollm, *resharded)
    del resharded
    phase_train_step_time(smollm, *trained, data_cfg)
    # the backward last: its library yardstick is autograd's backward in a
    # CUDA graph, after which no profile runs
    bwd_rows = {label: bench.time_flash_attention_bwd(label)
                for label in bench.BWD_SHAPES}
    for row in bwd_rows.values():
        log("k", bench.describe_bwd(row))
    # slice 9 in a process of its own, with the card's memory this one no
    # longer needs
    del params, m_params, rg_params, model, m_model, rg_model, trained
    zoo = run_zoo()
    log("k", f"Server {smollm_tok_s:.1f} tok/s (smollm-135m bf16, batch 4), "
             f"{mamba_tok_s:.1f} tok/s (mamba2-130m bf16, batch 4), "
             f"{rg_tok_s:.1f} tok/s (recurrentgemma-9b at {RG_LAYERS} "
             f"layers, bf16, batch 4), " + ", ".join(
                 f"{tok_s:.1f} tok/s ({arch}, peak {peak:.2f} GiB)"
                 for arch, (_, tok_s, peak) in zoo.items()))
    log("k", f"chip_smoke ran {time.perf_counter() - start:.1f} s")
    # each kernel's row at the shape its first main path launches; flash
    # attention runs on two paths: its launches are both paths', and its
    # row at recurrentgemma's shape (D 256, window 2048) rides along
    flash_row = record_row(
        "flash_attention", "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:93",
        smollm_counts["flash_attention"] + train_counts["flash_attention"]
        + elastic_counts["flash_attention"] + rg_counts["flash_attention"]
        + sum(counts["flash_attention"] for counts, _, _ in zoo.values()),
        flash_err[64], flash_rows["prefill-512"],
        f"B{PREFILL_B} H9 KV3 S{PREFILL_S} D64 bf16 causal, (B, S, H, D) "
        "views")
    flash_row["launches_by_path"] = {
        "smollm-135m": smollm_counts["flash_attention"],
        "smollm-135m training": train_counts["flash_attention"],
        "smollm-135m elastic training": elastic_counts["flash_attention"],
        "recurrentgemma-9b": rg_counts["flash_attention"],
        **{arch: counts["flash_attention"]
           for arch, (counts, _, _) in zoo.items()}}
    flash_row["recurrentgemma"] = record_row(
        "flash_attention", flash_row["source"], flash_row["replaces"],
        rg_counts["flash_attention"], flash_err[256],
        flash_rows["recurrentgemma-512"],
        f"B{PREFILL_B} H16 KV1 S{PREFILL_S} D256 bf16 causal, window "
        f"{rg.sliding_window}, (B, S, H, D) views")
    # and at head_dim 128: qwen3-4b's and phi3.5-moe's prefill (slice 9)
    flash_row["head_dim_128"] = record_row(
        "flash_attention", flash_row["source"], flash_row["replaces"],
        sum(zoo[arch][0]["flash_attention"] for arch in
            ("gemma2-27b", "phi3.5-moe-42b-a6.6b", "deepseek-moe-16b",
             "qwen3-4b")), flash_err[128], flash_rows["d128-512"],
        f"B{PREFILL_B} H32 KV8 S{PREFILL_S} D128 bf16 causal, (B, S, H, D) "
        "views")
    ssd_row = record_row(
        "ssd_scan", "src/repro_torch/kernels/ssd/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd/kernel.py:67", mamba_counts["ssd_scan"],
        ssd_err, ssd_rows["prefill-512"],
        f"B{PREFILL_B} S{PREFILL_S} H24 P64 N128 chunk 128 bf16, views of "
        "the conv output")
    ssd_row["launches_by_path"] = {"mamba2-130m": mamba_counts["ssd_scan"]}
    # CUDA kernels one wrapper call launched at this shape, under the
    # profiler in this run (the passes: chunk states, state passing, chunk
    # outputs)
    ssd_row["cuda_kernels_per_launch"] = ssd_rows["prefill-512"][
        "cuda_kernels"]
    rglru_row = record_row(
        "rglru_scan", "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru/kernel.py:39", rg_counts["rglru_scan"],
        rglru_err, rglru_rows["prefill-512"],
        f"B{PREFILL_B} S{PREFILL_S} W4096 fp32, the gates of every rglru "
        "layer")
    rglru_row["launches_by_path"] = {
        "recurrentgemma-9b": rg_counts["rglru_scan"]}
    b, h, kv, s, d, _ = bench.BWD_SHAPES["train-2048"]
    bwd_row = record_row(
        "flash_attention_bwd", "src/repro_torch/kernels/flash_attention/"
        "csrc/flash_attention_bwd.cu", "none: the Pallas kernel has no "
        "backward; the reference trains through XLA's autodiff of "
        "chunked_attention (src/repro/models/attention.py:94)",
        train_counts["flash_attention_bwd"]
        + elastic_counts["flash_attention_bwd"], bwd_err[(d, s)],
        bwd_rows["train-2048"], f"B{b} H{h} KV{kv} S{s} D{d} bf16 causal, "
        "(B, S, H, D) views, dq / dk / dv from the forward's lse")
    bwd_row["launches_by_path"] = {
        "smollm-135m training": train_counts["flash_attention_bwd"],
        "smollm-135m elastic training":
            elastic_counts["flash_attention_bwd"]}
    # the library's backward in device time (a CUDA graph, like the
    # kernel's), its eager call, and the backend PyTorch picked
    bwd_row["library_eager_ms"] = bwd_rows["train-2048"]["library_eager_ms"]
    bwd_row["library_backend"] = bwd_rows["train-2048"]["library_backend"]
    record = {"kernels": [flash_row, bwd_row, ssd_row, rglru_row]}
    print(json.dumps(record))
    print(bench.card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main_zoo() if sys.argv[1:] == ["--zoo"] else main())
