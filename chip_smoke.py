#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's serving and training paths, the paper's apps and the reconfiguration-cost calibration on one NVIDIA card and check them.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught but the
fit's FitError in (t)):

  (a) device   -- the card's name and power limit (nvidia-smi)
  (b) build    -- nvcc builds the flash-attention forward and backward,
                  the SSD scan's forward and backward, the RG-LRU scan's
                  (forward and backward, one source) and the reshard's
                  box-copy kernel from src/, all at once
  (c) flash    -- the flash-attention kernel against its plain version, at
                  head_dim 32-256 (recurrentgemma's local layers: D 256,
                  window 2048; slice 9's D 128 prefills: 32 / 8, 16 / 16
                  and 32 / 16 heads with softcap 50, and gemma2's local
                  layer at S 4352, window 4096; slice 10's: paligemma's
                  prefill, D 256 causal without a window, 8 / 1 heads;
                  seamless's encoder and cross attention without a causal
                  mask, 16 / 16 heads of 64, Sq 512 = Sk and Sq 264 over
                  Sk 256; the zt training calls, among them seamless's at
                  B 8, S 2048: the encoder's and the cross attention's
                  without a causal mask, the decoder's causal, each
                  case with its own mask)
  (p) backward -- the flash-attention backward kernel (dq, dk, dv from the
                  forward's log-sum-exp) against torch autograd of the
                  plain version, on (c)'s cases (slice 10's too),
                  smollm's training call and the bf16 D 256 route at
                  every option (softcap, no causal mask, Sq < Sk, GQA
                  groups 1-8, B > 1 views); the forward's log-sum-exp
                  against the plain scores
  (d) ssd      -- the SSD-scan kernel (three CUDA kernels a call) against
                  its plain version and the chunked path (y and the final
                  state), up to B 8, S 2048 (16 chunks of state passing),
                  and on one model coordinate's 12 or 6 heads
  (l) rglru    -- the RG-LRU scan kernel against its plain version (ragged
                  S, S 1, an initial state, one model coordinate's 2048 or
                  1024 channels)
  (sb) scan bwd-- the SSD and RG-LRU backward kernels against torch
                  autograd of their plain versions, every gradient: the SSD
                  at mamba2's train call (B 8, S 2048, views) in fp32 and
                  bf16 (two bf16 calls bit-equal), a ragged S, a final
                  state's gradient, in bf16 also 5 heads of P 32, N 64,
                  unaligned rows and S 1; the RG-LRU at recurrentgemma's
                  (B 1, S 4096, W 4096) with and without an initial state
                  (two calls bit-equal), S off and below its 128-step
                  chunks, W 1000 with h0; both at one model coordinate's
                  share of their train calls at model_ways 2 and 4 (as (p)
                  holds recurrentgemma's D 256 flash backward on 8 and 4
                  of its 16 heads)
  smollm-135m at full width (seeded random weights):
  (bc) copies  -- the reshard's box-copy kernel against its plain version,
                  bit for bit, on the tables reshard builds (plan_copies):
                  every resize of (t)'s grid (CI geometries both ways, 64
                  MiB - 1 GiB) and smollm's TrainState (random moments)
                  expanded 2 -> 4 and shrunk back under TP_DP_RULES and
                  FSDP_RULES (the shrink reading the views the expand kept
                  in place as strided sources)
  (e) prefill  -- B 4, S 512: logits through the kernel against
                  attn_impl="chunked"; exactly 30 launches per prefill
  (f) decode   -- prefill, then decode steps, against forward's logits
  (g) server   -- Server.run: 8 requests, batch 4, max_len 256, 16 tokens
  (q) train    -- B 8, S 2048: one fp32 train step (loss and every
                  gradient) through the kernels against attn_impl="chunked";
                  20 bf16 steps of ElasticTrainer.train, the loss falling;
                  exactly 60 forward and 30 backward flash launches a step
                  (remat recomputes each layer's forward)
  (r) elastic  -- smollm's train cell on 4 virtual slices of the card: the
                  TrainState expanded 2 -> 4 and shrunk back bit-equal;
                  elastic against fixed in fp32; the LocalRMS loop (a
                  rival job, SHRINK, EXPAND, checkpoints, one fault); then
                  with the parameters in blocks over the slices
                  (FSDP_RULES): one fp32 step at 2 and 4 slices against
                  the replicated layout's (the loss, every parameter and
                  moment after the update), and the bf16 loop's EXPAND
                  2 -> 4 and SHRINK 4 -> 2, each reshard bit-equal, with
                  the resize ms and non-local bytes of both layouts
  (tps) tp     -- smollm-135m with tensor parallelism inside a slice
                  (model_ways 2; its 9 / 3 heads do not divide, so each
                  model coordinate computes the whole attention while the
                  MLP and the vocab are split): one fp32 step at 1 and 2
                  slices (2 and 4 virtual devices of the card) against
                  model_ways 1, the loss and every parameter and moment
                  after the update; the bf16 loop's EXPAND 1 -> 2 and
                  SHRINK 2 -> 1 under TP_DP_RULES and FSDP_RULES, each
                  reshard bit-equal, twice (q)'s flash launches per slice
                  and step; the resize ms and non-local bytes beside the
                  model_ways 1 layout's
  mamba2-130m at full width (seeded random weights):
  (h) prefill  -- B 4, S 512: fp32 logits and cache through the kernel
                  against the same weights' plain path on the CPU; bf16 by
                  its distance from fp32; exactly 24 launches per prefill
  (i) decode   -- prefill, then decode steps, against forward's logits
  (j) server   -- Server.run as (g)
  (hq) train   -- B 8, S 2048, full depth: one fp32 train step (loss and
                  every gradient) through the SSD kernels against the
                  chunked path on the card, weights at a per-layer fan-in
                  (held) and at the reference's init (printed); 20 bf16
                  steps of ElasticTrainer.train, the loss falling; exactly
                  48 forward (remat) and 24 backward SSD launches a step
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
                  cut to 2 layers (deepseek: head0 dense + 1 MoE; 4
                  layers until slice 19, whose training paths (zt) took
                  the time): the
                  same, the blocks at B2 S256 with each MoE block's chosen
                  experts against the CPU's for every token (a flip at a
                  near tie reported with its gap), the choices dropped at
                  capacity and the router loss on each side; decode
                  against forward at capacity factor E / k, where no token
                  drops; bf16 held by a median over tokens
  (w) dense    -- qwen3-4b and granite-3-2b at their published widths
                  cut to 4 of their 36 and 40 layers (their full-depth
                  Servers took a minute of the run's limit, 12 layers half
                  a minute, which (zt) needs; granite trains at its 40
                  layers there): the same, the blocks at B1 S128
  (x) compress -- the int8 compressed all-reduce on 2 and 4 virtual slices
                  over smollm-135m's gradient tree: bit-equal to the CPU's,
                  error feedback over 12 steps, ms a call and payload bytes
  (mq) train   -- after the zoo, in a child process of its own
                  (chip_smoke.py --rg-train, with the card to itself):
                  recurrentgemma-9b at full width cut
                  to its first unit and 2-layer tail (5 layers: 8 layers'
                  fp32 training state does not fit the card), each layer at
                  its own fan-in, B 1, S 4096 (the window of 2048 bites),
                  the loss by ce_chunk: one fp32 train step through the
                  RG-LRU and flash (D 256) kernels against the plain paths;
                  6 bf16 steps, the loss falling, the peak memory; exactly
                  6 forward and 4 backward RG-LRU, 2 forward and 1 backward
                  flash launches a step; the step's times
  (wq) train   -- after (mq), in a child process of its own
                  (chip_smoke.py --qwen-train): qwen3-4b at its published
                  widths cut to 12 of its 36 layers (36 layers' fp32
                  training state does not fit the card), each layer at its
                  own fan-in, the loss by ce_chunk: one fp32 train step at
                  B 1, S 2048 through the flash kernels at D 128 under
                  remat "dots" and "nothing_saveable" against the chunked
                  path and each other; 6 bf16 steps at B 2, S 4096 under
                  "dots", the loss falling (the flash backward's bf16 D 128
                  route on a main path); exactly 24 forward and 12 backward
                  flash launches a step; the step's wall, busy, tokens/s
                  and peak memory under both remats
  (tp) tp      -- after (wq), in a child process of its own
                  (chip_smoke.py --tp): qwen3-4b cut to 6 layers with tensor
                  parallelism inside a slice on virtual devices of the
                  card: one fp32 step at B 1, S 2048 at model_ways 2 and 4
                  against 1 (the loss and every gradient, put together from
                  the coordinates' blocks), exactly 6 x M forward and
                  6 x M backward flash launches on H / M heads; 4 bf16
                  ElasticTrainer steps at B 2, S 4096 at model_ways 2, the
                  loss falling; the bf16 step's wall, busy, tokens/s, peak
                  and on-card copies at model_ways 1, 2 and 4, the peak
                  and busy time at 2 and 4 held against M times the
                  dry-run's count of one coordinate's share (a (1, M)
                  mesh), counted before any step
  (tk) tp kinds-- after (tp), in a child process of its own
                  (chip_smoke.py --tp-kinds): tensor parallelism inside a
                  slice for the SSD, RG-LRU, mixture-of-experts and
                  encoder-decoder blocks on virtual devices of the card,
                  each model at its published widths and each layer at its
                  own fan-in: mamba2-130m at full depth (an fp32 step at
                  B 8, S 2048 at model_ways 2 and 4 against 1, 4 bf16
                  ElasticTrainer steps at 2, the loss falling, fp32
                  prefill and 8 decode steps at 2 against 1, the bf16
                  step's wall, busy, idle, peak and on-card copies at 1, 2
                  and 4); recurrentgemma-9b cut to one unit (rglru, rglru,
                  local: the fp32 step at B 1, S 4096 at 2 and 4 against 1,
                  4 bf16 steps at 2); deepseek-moe-16b cut to its dense
                  first layer and two MoE layers (the routing and drops at
                  2 equal to 1's but for near ties, the fp32 step at 2 and
                  4 against 1, 4 bf16 steps at 2, the step's times, and
                  one fp32 step on 2 virtual data slices against 1, the
                  router's loss over the whole batch by the trainer's
                  routing pre-pass); seamless-m4t-medium (the fp32 step of (z) at 2 and 4
                  against 1, 4 bf16 ElasticTrainer steps at 2 at B 2 of
                  2048 frames and 2048 tokens under remat "dots", the loss
                  falling, the bf16 step's times at 1, 2 and 4); every
                  kernel call on one coordinate's share
                  (H / M SSD and query heads, W / M RG-LRU channels),
                  exactly M times one way's launches
  (zt) zoo train-- after (tk), in a child process of its own
                  (chip_smoke.py --zoo-train): the families whose training
                  no other path runs, each at its published widths and
                  each layer at its own fan-in, freed after its path:
                  gemma2-27b cut to one (local, global) unit (fp32 and bf16
                  at B 1, S 4352: the flash backward with softcap 50, the
                  window of 4096 biting in the local layer; the final
                  softcap 30 in the chunked loss), paligemma-3b at its 18
                  layers (fp32 at B 2, bf16 at B 8, 256 patches + 256
                  tokens: the bf16 D 256 backward without a window),
                  phi3.5-moe at 2 layers where they fit, else 1 (fp32 at
                  B 2, S 1024, bf16 at B 2, S 4096; first each MoE block's
                  experts through the kernels against chunked, a near-tie
                  flip printed with its gap) and granite-3-2b at its 40
                  layers (fp32 at B 1, S 2048, bf16 at B 2, S 4096: the
                  D 64 backward) and seamless-m4t-medium at all 12 + 12
                  layers (fp32 at B 2 of 512 frames and 512 tokens, bf16 at
                  B 8 of 2048 frames and 2048 tokens: the bf16 flash
                  forward and backward at S 2048, the encoder's and the
                  cross attention without a causal mask, the decoder's
                  causal; the tied embedding's gradient through both its
                  uses), each cut no deeper than the dry-run's count
                  allows (a one-step peak within 74 GiB, every one counted
                  on the meta device before any draw): an fp32 step
                  under remat "dots" against the chunked path (the loss and
                  every gradient), 4 bf16 ElasticTrainer steps, the loss
                  falling, exactly one flash forward and one backward a
                  layer and step, the step's wall, busy, idle, tokens/s and
                  one-step peak, held within 2% of the count
  slice 10, in the same child process after (x), each model at its
  published widths and depth, twice as (u)-(w) (per-layer fan-in, every
  check held; then the reference's init, fp32 printed):
  (y) vlm      -- paligemma-3b (18 layers, 2.51 B parameters): prefill at
                  B 4 of 256 patch embeddings + 256 tokens, kernel vs
                  chunked (fp32, and bf16 by its distance from fp32),
                  exactly 18 launches a prefill; prefill + 8 decode steps
                  after the patches against forward; at the reference's
                  init cut to 4 layers drawn at the 18 layers' scale (all
                  18 train in zt): the same, Server (text, as the
                  reference's Server) and step times
  (z) encdec   -- seamless-m4t-medium (12 + 12 layers, 0.72 B
                  parameters): prefill at B 4 of 512 frames and 512 tokens,
                  kernel vs chunked, exactly 36 launches a prefill (12
                  encoder and 12 cross calls without a causal mask, 12
                  causal self calls); prefill + 8 decode steps over 256
                  frames and 256 tokens against forward; one fp32 train
                  step at B 2 (256 frames, 256 tokens from the data
                  stream) through both kernels against chunked, the loss
                  and every gradient; step times; no Server (the
                  reference's cannot serve it)
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
                  port's reshard onto resized_mesh (its copies in one
                  box-copy launch a resize), each resize bit-equal with
                  the plan's non-local bytes; the grid again through the
                  plain version's copies, each resize and each geometry's
                  time at zero bytes printed beside the kernel's; then the
                  fit. Its verdict (the fitted model, the residuals, the
                  Fig. 3b checks and fit_report_rows, or FitError's
                  message with the samples) is printed, not asserted: the
                  paper's model divides busiest-link bytes by a per-node
                  bandwidth and virtual slices share one HBM, so a refusal
                  is a finding about one card, not a fault of the port;
                  (s) and (t) are one main path, its box-copy launches
                  counted
  (ws) worksim -- the paper's section 7 testbed on the port's event engine
                  and simulator (host code), fed (t)'s artifact: the
                  reference's golden engine scenario (12 jobs, 32 nodes,
                  a failure, a straggler), sanitised, byte-equal to
                  tests/data/golden_engine_trace.json; Table 4 (50, 100,
                  200, 400 jobs of make_workload on 64 nodes, EASY, sync,
                  fixed and flexible, every job completed) under the
                  paper-fit cost model with the reference's four claims
                  held at 50 jobs, then under (t)'s fitted model with its
                  calibration_id, or one line saying the card gave none;
                  each flexible row's expand and shrink times; simulated
                  seconds, and the phase's own host seconds
  (sw) sweep    -- the rest of the JAX package's modules in the port, host
                  code fed (t)'s artifact: the three golden sweep grids
                  (smoke, churn, serving) through repro_torch.rms.sweep on
                  2 spawn workers, each byte-equal to its tests/data
                  artifact after the v4 -> v5 upgrade; the policy zoo (8
                  policies x 5 mixes x fixed and flexible on sample.swf,
                  64 nodes, seed 7: 80 points) under (t)'s fit written to
                  build/chip_smoke_calibration.json, or, when the fit raised
                  FitError, under tests/data/golden_calibration.json (one
                  line says so), serially and as two journaled shards
                  merged by --resume, byte-equal; the winners by makespan
                  and node-hours; the golden churn scenario under the
                  port's TraceRecorder, its artifact and report byte-equal
                  to tests/data/golden_obs_trace.json and
                  golden_obs_report.txt; one zoo point traced, its row
                  equal to the untraced one and its ledger holding every
                  action; python -m repro_torch.lint src/repro_torch
                  --check clean; the phase's host seconds
  (k) times    -- each kernel, its plain version, its bound and (flash
                  only) scaled_dot_product_attention (forward and backward,
                  both in device time) as a yardstick the port never calls
                  (the box-copy kernel: torch._foreach_copy_ over the
                  pieces' views; the TrainState's resizes through the
                  kernel, its plain version and checkpoint_reshard, one
                  under the profiler),
                  every busy reading held by bench.check_profile (each
                  profiled interval lists every CUDA kernel the wrappers
                  launched in it, by name, each with device time, else
                  the phase fails),
                  at slice 10's call shapes too, the scans' backward at
                  their train calls (the SSD scan's, its backward's and
                  the flash backward's CUDA kernels each under the
                  profiler, the phase failing where one of the route's is
                  missing or has no device time); each model's prefill and
                  decode step,
                  smollm's train step at 1, 2 and 4 slices (at 2 and 4
                  also under FSDP_RULES) and mamba2's, with the card's
                  busy share; the Servers' tokens/s; the backwards last
                  (the flash backward also at qwen3's train call), and
                  the flash forward and backward at gemma2's, paligemma's
                  and granite's train calls (zt; with gemma2's softcap
                  the library call is flex_attention under torch.compile,
                  held to the plain version)

  (nc) node    -- from the start, in two processes of their own on the
                  host's CPU (chip_smoke.py --node-count NAME, the card
                  hidden): the dry-run's count of qwen3-4b's train_4k cell
                  at its published size on one HGX node laid out 1 x 8
                  and 2 x 4 (data x model): one card's compute, memory and
                  collective terms and the collectives by kind, printed
                  at the end

Phases (e)-(g), (q), (r), (tps), (s)-(t), (h)-(j), (hq), (m)-(o), (u)-(w),
(y), (z), (mq), (wq), (tp), (tk) and (zt) are the main paths: every kernel launch count is set to 0 just
before each path and read just after it. The last
lines are the kernels' JSON record, the card's name and power limit, and
{"ok": true, "device": {...}}. Exits non-zero without printing a result when
no card is present or when run outside a checkout of the repository.
"""
import atexit
import concurrent.futures
import contextlib
import dataclasses
import json
import os
import shutil
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
# smollm-135m training: batch, sequence length and bf16 steps of phase (q);
# mamba2-130m's (hq) are the same
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 2048, 20
# recurrentgemma-9b training (mq): B 1, S 4096 (twice the window, so that it
# bites in the flash backward), the layers trained (the first unit and the
# 2-layer tail: 8 layers' fp32 weights, gradients and two AdamW moments,
# the old and the new, would not fit the card), the bf16 steps and their
# learning rate
RG_TRAIN_S, RG_TRAIN_LAYERS, RG_TRAIN_STEPS, RG_TRAIN_LR = 4096, 5, 6, 1e-3
# qwen3-4b training (wq): its depth, cut to 12 layers (36 layers' fp32
# parameters, gradients, moments and the functional update's new
# parameters and moments come to about 112 GB; 12 layers', 1.60 B
# parameters, to about 45 GB); the fp32 step's S at B 1; the bf16 steps'
# batch, S, number and learning rate; ce_chunk
QWEN_DEPTH, QWEN_TRAIN_LAYERS, QWEN_FP32_S = 36, 12, 2048
QWEN_TRAIN_B, QWEN_TRAIN_S, QWEN_TRAIN_STEPS, QWEN_TRAIN_LR = 2, 4096, 6, 1e-3
QWEN_CE_CHUNK = 1024
# qwen3-4b's layers in (tp): 12 (wq's cut, whose step (tp) timed again at
# model_ways 1) until slice 20, whose new phases took their seconds
TP_LAYERS = 6
# the dry-run's predicted one-step peak memory of the wq and mq cells may be
# off the measured one by at most this share (PERF.md, section 2): room for
# the allocator's rounding and cuBLAS's workspace, less than one layer's
# parameters and moments of either model
PEAK_MARGIN = 0.02


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


# slice 10's flash calls on its main paths, by their label in
# bench.SHAPES / bench.NONCAUSAL_SHAPES, (B, H, KV, Sq, Sk, D, causal), as
# the models pass them ((B, S, H, D) views) without a window: paligemma-3b's
# prefill (8 query heads on 1 KV head of 256, 256 patches and 256 tokens);
# seamless-m4t-medium's encoder over 512 frames, the same call as its cross
# attention's of 512 tokens over them at prefill; and its cross attention
# of 264 tokens over 256 frames, in the decode check's forward
SLICE10_CALLS = {"paligemma-512": (PREFILL_B, 8, 1, 512, 512, 256, True),
                 "seamless-512": (PREFILL_B, 16, 16, 512, 512, 64, False),
                 "seamless-cross-264": (PREFILL_B, 16, 16, 264, 256, 64,
                                        False)}


def slice10_kernel_cases():
    """SLICE10_CALLS in bf16 and fp32."""
    return [(b, h, kv, sq, sk, d, causal, None, None, dt, "bshd")
            for b, h, kv, sq, sk, d, causal in SLICE10_CALLS.values()
            for dt in (torch.bfloat16, torch.float32)]


def slice10_label(case):
    """The SLICE10_CALLS label of a bf16 case of the table, or None."""
    b, h, kv, sq, sk, d, causal, window, softcap, dtype, layout = case
    if window is not None or softcap is not None or layout != "bshd" or \
            dtype != torch.bfloat16:
        return None
    return next((label for label, call in SLICE10_CALLS.items()
                 if call == (b, h, kv, sq, sk, d, causal)), None)


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


# the bf16 flash calls on the training paths of slices 19 and 20 (zt), as
# the models pass them ((B, S, H, D) views): {label in bench's tables
# (bench.flash_call, bench.bwd_call): the path's model}. gemma2-27b's local
# layer (window 4096, scores capped at 50), paligemma-3b's at B 8 (8 query
# heads on 1 KV head of 256, 256 patches + 256 tokens, no window),
# granite-3-2b's at B 2, S 4096 (32 / 8 heads of 64), causal;
# seamless-m4t-medium's at B 8 over 2048 frames and 2048 tokens (16 heads of
# 64): its encoder's self attention without a causal mask, which is also
# its cross attention's call (Sq 2048 over Sk 2048 frames, every frame
# attended), and its decoder's causal self attention
ZT_ROWS = {"gemma2-4352": "gemma2-27b", "paligemma-train-512": "paligemma-3b",
           "granite-4096": "granite-3-2b",
           "seamless-2048": "seamless-m4t-medium",
           "seamless-dec-2048": "seamless-m4t-medium"}
# the rows slice 20 added, whose checks' seconds (c) and (p) print, and
# the model's calls each stands for
SLICE20_ROWS = ("seamless-2048", "seamless-dec-2048")
ZT_CALLS = {"seamless-2048": "the encoder's self attention and the cross "
                             "attention, one call (Sq = Sk = 2048)",
            "seamless-dec-2048": "the decoder's causal self attention"}


def zt_call(label):
    """(B, H, KV, Sq, Sk, D, causal, window, softcap) of one of ZT_ROWS."""
    from repro_torch.kernels import bench
    b, h, kv, sq, sk, d, _, causal, window, softcap = bench.flash_call(label)
    return b, h, kv, sq, sk, d, causal, window, softcap


def zt_kernel_cases():
    """ZT_ROWS' calls in bf16, each with its own causal mask, then
    gemma2's global layer in the same step (softcap 50 without a window,
    S 4352)."""
    calls = [zt_call(label) for label in ZT_ROWS]
    return [(*call, torch.bfloat16, "bshd") for call in
            (*calls, (1, 32, 16, 4352, 4352, 128, True, None, 50.0))]


def zt_label(case):
    """The ZT_ROWS label of a case of the table, or None."""
    *call, dtype, layout = case
    if layout != "bshd" or dtype != torch.bfloat16:
        return None
    return next((label for label in ZT_ROWS if zt_call(label) == tuple(call)),
                None)


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


def bwd_d256_cases():
    """The backward's bf16 D 256 route (wgmma, the head dims split between
    two warpgroups, a key tile's items split between blocks) at every option
    beyond kernel_cases()' D 256 calls: a softcap, no causal mask, Sq < Sk
    (right-aligned, with a window too), GQA groups of 1, 2, 3, 4 and 8,
    ragged lengths, B > 1 with (B, S, H, D) views."""
    bf16 = torch.bfloat16
    return [
        (2, 4, 2, 384, 384, 256, True, None, 30.0, bf16, "bshd"),
        (2, 4, 1, 300, 300, 256, False, None, None, bf16, "bshd"),
        (2, 6, 2, 300, 1000, 256, True, None, None, bf16, "bhsd"),
        (1, 4, 2, 100, 260, 256, False, 70, None, bf16, "bhsd"),
        (2, 4, 4, 256, 256, 256, True, None, None, bf16, "bshd"),
        (1, 16, 8, 512, 512, 256, True, 128, None, bf16, "bshd"),
        (3, 8, 1, 700, 700, 256, True, 256, 50.0, bf16, "bshd"),
        # recurrentgemma-9b's train call on one model coordinate's heads at
        # model_ways 2 and 4 (8 and 4 of 16), its one KV head whole
        (1, 8, 1, 4096, 4096, 256, True, 2048, None, bf16, "bshd"),
        (1, 4, 1, 4096, 4096, 256, True, 2048, None, bf16, "bshd"),
    ]


def phase_flash_bwd_vs_plain():
    """Returns {(head_dim, S): max |kernel - plain| over dq, dk and dv} at
    smollm's and qwen3-4b's training calls (bf16, B 8, S 2048, D 64; B 2,
    S 4096, D 128; (B, S, H, D) views) and the
    case table's other bf16 calls on such views, slice 10's among them
    (seamless's non-causal calls train in phase z), and by label at each of
    slice 10's and slice 19's calls (SLICE10_CALLS, ZT_ROWS, with
    gemma2's global layer: the softcap route without a window); the D 256
    route also at every option (bwd_d256_cases)."""
    from repro_torch.kernels.bench import make_qkv
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import (attention_lse,
                                                         attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(2)
    main_err = {}
    cases = kernel_cases() + slice10_kernel_cases() + bwd_d256_cases() + \
        zt_kernel_cases() + [
        # smollm-135m's train step: B 8, S 2048, (B, S, H, D) views
        (8, 9, 3, 2048, 2048, 64, True, None, None, torch.bfloat16, "bshd"),
        # qwen3-4b's bf16 train step (wq): B 2, S 4096, GQA 32 / 8, D 128;
        # and its fp32 step, B 1, S 2048
        (QWEN_TRAIN_B, 32, 8, QWEN_TRAIN_S, QWEN_TRAIN_S, 128, True, None,
         None, torch.bfloat16, "bshd"),
        (1, 32, 8, QWEN_FP32_S, QWEN_FP32_S, 128, True, None, None,
         torch.float32, "bshd")]
    new_s = 0.0
    for case in cases:
        t0 = time.perf_counter()
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
        del leaves
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
            label = slice10_label(case) or zt_label(case)
            if label is not None:
                main_err[label] = main_err[(d, sq)]
            if label in SLICE20_ROWS:
                new_s += time.perf_counter() - t0
    log("p", f"seamless-m4t-medium's bf16 training calls "
             f"({', '.join(SLICE20_ROWS)}) held in {new_s:.1f} s")
    return main_err


def phase_kernel_vs_plain():
    """Returns {head_dim: max |kernel - plain|} at the main paths' prefill
    calls (bf16, B 4, S 512, (B, S, H, D) views; the largest over the
    head_dim 128 calls of slice 9), and by label at each of SLICE10_CALLS
    and ZT_ROWS in bf16."""
    from repro_torch.kernels.bench import make_qkv
    from repro_torch.kernels.flash_attention import kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = {}
    cases = kernel_cases() + zoo_kernel_cases() + slice10_kernel_cases()
    cases += [case for case in zt_kernel_cases() if case not in cases]
    new_s = 0.0
    for case in cases:
        t0 = time.perf_counter()
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
        label = slice10_label(case) or zt_label(case)
        if label is not None:
            main_err[label] = err.max().item()
        if label in SLICE20_ROWS:
            new_s += time.perf_counter() - t0
    log("c", f"seamless-m4t-medium's bf16 training calls "
             f"({', '.join(SLICE20_ROWS)}) held in {new_s:.1f} s")
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
        # one model coordinate's heads at model_ways 2 and 4 (12, 6), at
        # the train call, as (tk) passes them
        (TRAIN_B, TRAIN_S, 12, *m[1:], f32, "view"),
        (TRAIN_B, TRAIN_S, 12, *m[1:], bf16, "view"),
        (TRAIN_B, TRAIN_S, 6, *m[1:], bf16, "view"),
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
            (1, 4096, 4096, False), (*main, True), (2, 37, 1000, True),
            # one model coordinate's width at model_ways 2 and 4
            (1, RG_TRAIN_S, 2048, False), (1, RG_TRAIN_S, 1024, False)]


def phase_rglru_vs_plain():
    """The kernel against ref.py's sequential recurrence at RGLRU_ATOL /
    RGLRU_RTOL; returns the largest |error| at the main paths' shapes,
    {"prefill": serving's B 4, S 512, "train": training's B 1, S 4096}."""
    from repro_torch.kernels.bench import make_rglru_inputs
    from repro_torch.kernels.rglru import kernel
    from repro_torch.kernels.rglru.ref import rglru_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = {}
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
            main_err["prefill"] = err
        if (b, s, w, with_h0) == (1, RG_TRAIN_S, 4096, False):
            main_err["train"] = err
    return main_err


# -- (sb) the scans' backward kernels against plain ---------------------------------

# the SSD backward: (b, s, h, p, n, chunk, dtype, layout, with dh_final):
# mamba2's train call (views of the conv output) in both types, a ragged S
# (a short last chunk), a final state's gradient, tests/test_kernels.py's
# smallest shape and rows the kernel cannot read 16 bytes at a time; in
# bf16 also a small P and N with 5 heads and a ragged S, unaligned rows,
# and S 1
def ssd_bwd_cases():
    f32, bf16 = torch.float32, torch.bfloat16
    m = (24, 64, 128, 128)          # mamba2-130m: H, P, N, chunk
    return [
        (TRAIN_B, TRAIN_S, *m, f32, "view", False),
        (TRAIN_B, TRAIN_S, *m, bf16, "view", False),
        (2, 500, *m, f32, "view", False),
        (2, 500, *m, bf16, "view", False),
        (2, 500, *m, f32, "view", True),
        (2, 500, *m, bf16, "view", True),
        (2, 64, 3, 16, 32, 16, f32, "contiguous", True),
        (2, 300, 3, 16, 32, 64, f32, "unaligned", False),
        (2, 300, 5, 32, 64, 64, bf16, "view", False),
        (2, 300, 3, 16, 32, 64, bf16, "unaligned", True),
        (2, 1, 3, 16, 32, 16, bf16, "contiguous", True),
        # one model coordinate's heads at model_ways 2 and 4 (12, 6), the
        # bf16 route walking fewer heads a block
        (TRAIN_B, TRAIN_S, 12, *m[1:], f32, "view", False),
        (TRAIN_B, TRAIN_S, 12, *m[1:], bf16, "view", False),
        (TRAIN_B, TRAIN_S, 6, *m[1:], bf16, "view", False),
    ]


# the RG-LRU backward: (b, s, w, with h0): recurrentgemma's train call,
# with and without an initial state, the prefill's shape, a W no block
# width divides, S = 1; for the chained chunks of 128 steps also an S that
# is not a multiple of a chunk, S below one chunk, and W 1000 with h0 over
# several chunks
def rglru_bwd_cases():
    return [(1, RG_TRAIN_S, 4096, False), (1, RG_TRAIN_S, 4096, True),
            (PREFILL_B, PREFILL_S, 4096, False), (2, 37, 1000, True),
            (2, 1, 4096, True), (2, 1000, 4096, False),
            (1, 100, 4096, False), (3, 300, 1000, True),
            # one model coordinate's width at model_ways 2 and 4
            (1, RG_TRAIN_S, 2048, False), (1, RG_TRAIN_S, 1024, False)]


def phase_scan_bwd_vs_plain():
    """Each scan's backward kernel against torch autograd of its plain
    version (ssd_ref, rglru_ref) on the same inputs in fp32, every gradient
    max-normalised at BWD_TOL, as (p) holds the flash backward: fp32 sums in
    another order (the SSD's fp64 where they cancel), and in bf16 the
    kernel's inputs and outputs rounded. Returns the largest |kernel -
    plain| over the gradients at each kernel's main-path call (the SSD's
    in bf16). Two calls of each at that call must give the same bits."""
    from repro_torch.kernels.bench import make_rglru_inputs, make_ssd_inputs
    from repro_torch.kernels.rglru import kernel as rglru
    from repro_torch.kernels.rglru.ref import rglru_ref
    from repro_torch.kernels.ssd import kernel as ssd
    from repro_torch.kernels.ssd.ref import ssd_ref
    gen = torch.Generator(device="cuda").manual_seed(3)
    main_err = {}
    for b, s, h, p, n, chunk, dtype, layout, with_dh in ssd_bwd_cases():
        args = make_ssd_inputs(gen, b, s, h, p, n, dtype, layout)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(dtype)
        dh = torch.randn((b, h, p, n), generator=gen, device="cuda") \
            if with_dh else None
        _, _, ws = ssd.ssd_scan(*args, chunk=chunk, keep_workspace=True)
        got = ssd.ssd_scan_bwd(*args, dy, dh, ws, chunk=chunk)
        torch.cuda.synchronize()
        leaves = [t.float().requires_grad_(True) for t in args]
        y, hf = ssd_ref(*leaves)
        want = torch.autograd.grad([y, hf] if with_dh else [y], leaves,
                                   [dy.float(), dh] if with_dh
                                   else [dy.float()])
        del y, hf, leaves
        errs = [max_norm_err(g, w) for g, w in zip(got, want)]
        name = (f"B{b} S{s} H{h} P{p} N{n} chunk {chunk} "
                f"{str(dtype)[6:]} {layout}"
                + (" with dh_final" if with_dh else ""))
        log("sb", f"ssd_scan_bwd {name}: " + ", ".join(
            f"{k} {e:.3e}" for k, e in zip(("dx", "ddt", "da_log", "db",
                                            "dc"), errs))
            + f" (max-normalised, tol {BWD_TOL[dtype]})")
        if not all(torch.isfinite(g).all() for g in got) or \
                max(errs) > BWD_TOL[dtype] or any(
                    g.shape != t.shape or g.dtype != t.dtype
                    for g, t in zip(got, args)):
            raise AssertionError(f"ssd_scan_bwd disagrees with plain: {name}")
        if (b, s, dtype, with_dh) == (TRAIN_B, TRAIN_S, torch.bfloat16,
                                      False):
            main_err["ssd"] = max((g.float() - w).abs().max().item()
                                  for g, w in zip(got, want))
            # every sum runs in a fixed order: a second call, the same bits
            again = ssd.ssd_scan_bwd(*args, dy, dh, ws, chunk=chunk)
            torch.cuda.synchronize()
            same = [same_bits(g, a) for g, a in zip(got, again)]
            log("sb", f"ssd_scan_bwd {name}: a second call bit-equal: "
                      + ", ".join(f"{k} {v}" for k, v in zip(
                          ("dx", "ddt", "da_log", "db", "dc"), same)))
            if not all(same):
                raise AssertionError(f"ssd_scan_bwd is not deterministic: "
                                     f"{name}")
            del again
        del got, want, ws
    for b, s, w, with_h0 in rglru_bwd_cases():
        a, bb = make_rglru_inputs(gen, b, s, w)
        h0 = torch.randn((b, w), generator=gen, device="cuda") \
            if with_h0 else None
        dh = torch.randn((b, s, w), generator=gen, device="cuda")
        h = rglru.rglru_scan(a, bb, h0)
        got = rglru.rglru_scan_bwd(a, h, h0, dh)
        torch.cuda.synchronize()
        inputs = (a, bb, h0) if with_h0 else (a, bb)
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        want = torch.autograd.grad(rglru_ref(*leaves), leaves, dh)
        errs = [max_norm_err(g, wt) for g, wt in zip(got, want)]
        name = f"B{b} S{s} W{w} fp32" + (" with h0" if with_h0 else "")
        log("sb", f"rglru_scan_bwd {name}: " + ", ".join(
            f"{k} {e:.3e}" for k, e in zip(("da", "db", "dh0"), errs))
            + f" (max-normalised, tol {BWD_TOL[torch.float32]})")
        if not all(torch.isfinite(g).all() for g in got[:len(want)]) or \
                max(errs) > BWD_TOL[torch.float32] or \
                (got[2] is None) != (h0 is None):
            raise AssertionError(f"rglru_scan_bwd disagrees with plain: "
                                 f"{name}")
        if (b, s, with_h0) == (1, RG_TRAIN_S, False):
            main_err["rglru"] = max((g - wt).abs().max().item()
                                    for g, wt in zip(got, want))
            # the chunks' carries combine in a fixed order: a second call,
            # the same bits
            again = rglru.rglru_scan_bwd(a, h, h0, dh)
            torch.cuda.synchronize()
            same = [same_bits(g, x) for g, x in zip(got[:2], again[:2])]
            log("sb", f"rglru_scan_bwd {name}: a second call bit-equal: "
                      f"da {same[0]}, db {same[1]}")
            if not all(same):
                raise AssertionError(f"rglru_scan_bwd is not deterministic: "
                                     f"{name}")
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
    from repro_torch.kernels.reshard import kernel as box
    from repro_torch.kernels.rglru import kernel as rglru
    from repro_torch.kernels.ssd import kernel as ssd
    return {"flash_attention": flash.flash_attention,
            "flash_attention_bwd": flash.flash_attention_bwd,
            "ssd_scan": ssd.ssd_scan,
            "ssd_scan_bwd": ssd.ssd_scan_bwd,
            "rglru_scan": rglru.rglru_scan,
            "rglru_scan_bwd": rglru.rglru_scan_bwd,
            "box_copy": box.box_copy}


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


def flash_per_pass(cfg):
    """Flash forward launches of one forward or prefill of ``cfg``: one a
    layer that attends (every layer but the "ssd" and "rglru" ones), or for
    an encoder-decoder one an encoder layer and two a decoder layer (its
    self and cross attention)."""
    if cfg.family == "encdec":
        return cfg.enc_layers + 2 * cfg.num_layers
    kinds = layer_kinds(cfg)
    return cfg.num_layers - kinds.count("ssd") - kinds.count("rglru")


class WithInputs:
    """A model with its modality input bound, so that forward, prefill and
    decode_step take the text tokens alone, as a decoder's do: paligemma's
    patch embeddings ``front`` (B, P, E), prepended (forward drops their
    logits; the cache holds them first, so decode positions move by P), or
    seamless's frames (an EncDecLM's encoder input)."""

    def __init__(self, model, front):
        self.model, self.cfg, self.front = model, model.cfg, front
        self.encdec = model.cfg.family == "encdec"
        self.nf = 0 if self.encdec else front.shape[1]
        self.note = (f" over {front.shape[1]} frames" if self.encdec else
                     f" after {self.nf} patch embeddings")

    def forward(self, params, toks):
        if self.encdec:
            return self.model.forward(params, self.front, toks)
        logits, aux = self.model.forward(params, toks,
                                         extra_embeds=self.front)
        return logits[:, self.nf:], aux

    def prefill(self, params, toks, max_len):
        if self.encdec:
            return self.model.prefill(params, self.front, toks, max_len)
        return self.model.prefill(params, toks, max_len + self.nf,
                                  extra_embeds=self.front)

    def decode_step(self, params, cache, tok, pos):
        return self.model.decode_step(params, cache, tok, pos + self.nf)


def bare(model):
    return model


def phase_prefill(cfg, params, toks, label="e", hold=True, wrap=bare):
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
    be at most BF16_RATIO times the chunked path's. ``wrap`` binds a
    model's modality input (WithInputs)."""
    from repro_torch.models import build_model
    s = toks.shape[1]
    n_layers = flash_per_pass(cfg)
    models = {(dt, impl): wrap(build_model(dataclasses.replace(
        cfg, dtype=dt, attn_impl=impl)))
        for dt in ("float32", "bfloat16") for impl in ("auto", "chunked")}
    flash = counters()["flash_attention"]
    pre = {key: run_counted(
        lambda m=m: m.prefill(params, toks, max_len=s + 8), flash,
        n_layers if key[1] == "auto" else 0)[0]
        for key, m in models.items()}
    err32 = max_norm_err(pre["float32", "auto"], pre["float32", "chunked"])
    err16 = max_norm_err(pre["bfloat16", "auto"], pre["bfloat16", "chunked"])
    note = getattr(models["float32", "auto"], "note", "")
    log(label, f"{cfg.name} prefill B{toks.shape[0]} S{s}{note}: {n_layers} kernel "
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


def phase_decode(label, cfg, params, toks, steps, hold_fp32=True,
                 wrap=bare):
    """Prefill, then ``steps`` decode steps, against forward's logits at
    the same positions: fp32 at MODEL_TOL, as the reference's own
    decode-consistency test (printed, not held, when ``hold_fp32`` is
    False). bf16 is held as in phase_prefill: the mean distance of its
    prefill + decode logits from the fp32 forward's may be at most
    BF16_RATIO times the bf16 forward's own (bf16_distance). ``wrap``
    binds a model's modality input (WithInputs)."""
    from repro_torch.models import build_model
    s = toks.shape[1] - steps
    full = {}
    for dtype in ("float32", "bfloat16"):
        model = wrap(build_model(dataclasses.replace(cfg, dtype=dtype)))
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


def train_launches(cfg):
    """Every kernel's launches in one train step of ``cfg``: per layer a
    forward and a backward of its kernel (flash for the attention kinds,
    the SSD or RG-LRU scan for "ssd" and "rglru"); under remat the stacked
    units' layers run their forward twice (the checkpointed units run again
    in the backward pass), but for the flash forward under "dots", whose
    output the selective checkpoint keeps (transformer.DOTS); a tail or
    dense head layer's forward runs once. An encoder-decoder checkpoints
    every layer saving nothing: flash_per_pass's calls, twice under
    remat."""
    names = {"ssd": ("ssd_scan", "ssd_scan_bwd"),
             "rglru": ("rglru_scan", "rglru_scan_bwd")}
    out = {name: 0 for pair in (("flash_attention", "flash_attention_bwd"),
                                *names.values()) for name in pair}
    again = 1 if cfg.remat == "none" else 2
    if cfg.family == "encdec":
        n = flash_per_pass(cfg)
        return {**out, "flash_attention": again * n, "flash_attention_bwd": n}
    reps, tail = divmod(cfg.num_layers - cfg.first_dense_layers,
                        len(cfg.pattern))
    for kinds, times in ((list(cfg.pattern) * reps, again),
                         (list(cfg.pattern[:tail])
                          + [cfg.pattern[0]] * cfg.first_dense_layers, 1)):
        for kind in kinds:
            fwd, bwd = names.get(kind, ("flash_attention",
                                        "flash_attention_bwd"))
            saved = fwd == "flash_attention" and cfg.remat == "dots"
            out[fwd] += 1 if saved else times
            out[bwd] += 1
    return out


@contextlib.contextmanager
def plain_scans():
    """The models' scans on the card through their CPU paths (ssd_chunked,
    the log-depth rglru_scan) under torch autograd, the yardstick of the
    kernels' train steps, as attn_impl="chunked" is the flash kernels'."""
    from repro_torch.models import rglru, ssm
    kept = ssm.ssd_op, rglru.rglru_op
    ssm.ssd_op = lambda x, dt, a_log, b, c, chunk: ssm.ssd_chunked(
        x, dt, a_log, b, c, chunk)
    rglru.rglru_op = rglru.rglru_scan
    try:
        yield
    finally:
        ssm.ssd_op, rglru.rglru_op = kept


def train_grads(cfg, params, batch, want, plain=False, ways=1, **changes):
    """(loss, {leaf path: gradient}) of one fp32 train step of ``cfg`` with
    ``changes`` (``plain``: the scans' plain paths, plain_scans), checking
    its kernel launches against ``want``. ``ways`` > 1: at that many model
    coordinates (virtual devices of the card) in lockstep, each on its
    views of ``params`` (coordinate_views), so that the gradients are put
    together in the whole leaves."""
    from repro_torch.core import TP_DP_RULES, make_mesh, slice_devices
    from repro_torch.core.sharding import activation_rules
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(cfg, dtype="float32",
                                            **changes))
    leaves = with_grad(params)
    mesh = make_mesh(1, ways, devices=slice_devices(ways))
    args = leaves if ways == 1 else coordinate_views(model, leaves, mesh)

    def step():
        with plain_scans() if plain else contextlib.nullcontext(), \
                activation_rules(mesh, TP_DP_RULES):
            loss, _ = model.loss(args, batch)
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


def held_train_step(label, cfg, params, batch):
    """One fp32 train step of ``cfg`` through the flash kernels (the forward
    with the log-sum-exp and the backward kernel, exactly train_launches'
    launches) against attn_impl="chunked" (none) on the card, from the same
    parameters and batch. Raises where a gradient through the kernels is not
    finite or the loss or a gradient leaf parts from the chunked path's by
    more than MODEL_TOL, max-normalised. Returns (the kernels' (loss,
    gradients), {"loss" or leaf: distance})."""
    off = {"flash_attention": 0, "flash_attention_bwd": 0}
    kernel = train_grads(cfg, params, batch, train_launches(cfg))
    errs = grad_errs(kernel, train_grads(cfg, params, batch, off,
                                         attn_impl="chunked"))
    if not all(torch.isfinite(g).all() for g in kernel[1].values()) or \
            max(errs.values()) > MODEL_TOL:
        raise AssertionError(
            f"({label}) {cfg.name}'s fp32 train step through the kernels "
            f"disagrees with the chunked path (tol {MODEL_TOL}): "
            f"{sorted(errs.items(), key=lambda e: -e[1])[:5]}")
    return kernel, errs


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
    held = held_train_step("q", cfg, sane, batch)[1]
    kernel = train_grads(cfg, params, batch, train_launches(cfg))
    chunked = train_grads(cfg, params, batch, n_off, attn_impl="chunked")
    floor = grad_errs(train_grads(cfg, params, batch, n_off,
                                  attn_impl="chunked", attn_chunk=256),
                      chunked)
    seen = grad_errs(kernel, chunked)
    log("q", f"{cfg.name} fp32 train step {shape} (remat {cfg.remat}, "
             f"{train_launches(cfg)} launches), weights at a per-layer "
             f"fan-in: through the kernels vs chunked, max-normalised "
             + ", ".join(f"{k} {e:.3e}" for k, e in held.items())
             + f" (tol {MODEL_TOL})")
    log("q", f"at the reference's init (not held): loss "
             f"{kernel[0].item():.6f} through the kernels, "
             f"{chunked[0].item():.6f} chunked; kernels vs chunked, largest "
             f"leaf {max(seen.values()):.3e}; chunked at attn_chunk 256 vs "
             f"512 (the rounding floor) {max(floor.values()):.3e}")
    if not all(torch.isfinite(g).all() for g in kernel[1].values()):
        raise AssertionError("the fp32 train step through the kernels "
                             "is not finite at the reference's init")


def phase_train_bf16(cfg, params, data_cfg, steps, label="q", lr=3e-3):
    """(q) ``steps`` bf16 steps of ElasticTrainer.train at ``lr`` from
    ``params`` (or from what a callable ``params`` returns, so that the
    caller need hold no reference to the tree while the steps replace it):
    every loss finite, the last below the first, and exactly the kernel
    launches the layers and remat imply per step (train_launches). Returns
    (trainer, state, the next batch), for the step times of (k)."""
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import ElasticTrainer, TrainerConfig
    model = build_model(cfg)
    trainer = ElasticTrainer(
        model, AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps),
        data_cfg, TrainerConfig(steps=steps, log_period=1))
    per_step = train_launches(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = counted_launches(
        lambda: trainer.train(state=trainer.init_state(
            params=params() if callable(params) else params)),
        {name: steps * n for name, n in per_step.items()})
    seconds = time.perf_counter() - t0
    losses = [m["loss"] for m in trainer.metrics]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(label, f"{cfg.name} ({cfg.num_layers} layers) {cfg.dtype} "
               f"ElasticTrainer.train, {steps} steps "
               f"B{data_cfg.global_batch} S{data_cfg.seq_len}, lr {lr}, in "
               f"{seconds:.1f} s ({per_step} launches a step); losses "
               + ", ".join(f"{x:.4f}" for x in losses)
               + f"; peak device memory {peak:.2f} GiB")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            int(state["step"]) != steps:
        raise AssertionError("bf16 training did not bring the loss down")
    return trainer, state, trainer.data.batch(steps)


def phase_scan_train_fp32(label, cfg, params, batch, reference=None):
    """(hq), (mq) One fp32 train step of a scan model (loss.backward(),
    remat as configured) through the kernels (its scans' forward and
    backward kernels; flash forward and backward for its attention layers)
    against the plain paths on the card (plain_scans, attn_impl="chunked"),
    from the same parameters and batch: the loss and every gradient leaf
    max-normalised at MODEL_TOL with ``params`` drawn at a per-layer
    fan-in, and exactly train_launches(cfg) launches. ``reference``: the
    same weights at the reference's init, where the comparison is printed,
    not held (its stacked weights take the layers axis as fan-in). Printed
    beside the held comparison: the plain paths against themselves at half
    their chunks (the same function summed in another order), the
    rounding floor of any comparison at these weights."""
    off = {name: 0 for name in train_launches(cfg)}
    shape = f"B{batch['tokens'].shape[0]} S{batch['tokens'].shape[1]}"

    def plain(p, **changes):
        return train_grads(cfg, p, batch, off, plain=True,
                           attn_impl="chunked", **changes)

    def kernels_vs_plain(p):
        kernel = train_grads(cfg, p, batch, train_launches(cfg))
        want = plain(p)
        errs = grad_errs(kernel, want)
        finite = all(torch.isfinite(g).all() for g in kernel[1].values())
        return kernel[0].item(), errs, finite, want
    loss, held, finite, want = kernels_vs_plain(params)
    floor = grad_errs(plain(params, ssd_chunk=cfg.ssd_chunk // 2,
                            attn_chunk=cfg.attn_chunk // 2), want)
    del want
    worst = max(held, key=held.get)
    log(label, f"{cfg.name} ({cfg.num_layers} layers) fp32 train step "
               f"{shape} (remat {cfg.remat}, {train_launches(cfg)} "
               f"launches), weights at a per-layer fan-in: loss {loss:.6f}; "
               f"through the kernels vs the plain paths, max-normalised: "
               + ", ".join(f"{k} {e:.3e}" for k, e in held.items())
               + f"; largest {worst} {held[worst]:.3e} (tol {MODEL_TOL}); "
               f"the plain paths at half their chunks vs themselves (the "
               f"rounding floor), largest leaf {max(floor.values()):.3e}")
    if reference is not None:
        ref_loss, seen, _, _ = kernels_vs_plain(reference)
        log(label, f"at the reference's init (not held): loss "
                   f"{ref_loss:.6f}; kernels vs plain paths, loss "
                   f"{seen['loss']:.3e}, largest leaf "
                   f"{max(seen.values()):.3e}")
    if not finite or held[worst] > MODEL_TOL:
        raise AssertionError("the fp32 train step through the kernels "
                             "disagrees with the plain paths")


def profile_split(fns):
    """One torch.profiler session over ``fns`` ({name: fn}), each called
    once between synchronises and marks (bench.profiled, every interval
    held by bench.check_profile): {name: (card busy ms, kernels and
    copies, [(kernel name, ms, count)] the top 5 by device time, {kernel
    name: (ms, count)} of every one)}."""
    from repro_torch.kernels import bench
    out = {}
    for name, events in zip(fns, bench.profiled(
            list(fns.values()), [f"{name}" for name in fns])):
        by = {}
        for kernel, ms in events:
            t, n = by.get(kernel[:60], (0.0, 0))
            by[kernel[:60]] = (t + ms, n + 1)
        out[name] = (sum(ms for _, ms in events), len(events),
                     sorted(((k, t, n) for k, (t, n) in by.items()),
                            key=lambda e: -e[1])[:5], by)
    return out


def step_times(entries):
    """(k) Train steps, {(label, slices): (cfg, data_cfg, slices, step
    fn)}: the wall
    time (host clock around 3 steps ending in a synchronise), the card's
    busy time in one step (all in one profile_split session, each step's
    interval held by bench.check_profile) and tokens/s."""
    walls = {}
    for key, (*_, step) in entries.items():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        walls[key] = (time.perf_counter() - t0) / 3 * 1e3
    busy = profile_split({key: entry[-1] for key, entry in entries.items()})
    for key, (cfg, data_cfg, n, _) in entries.items():
        ms, launches, top, _ = busy[key]
        tokens = data_cfg.global_batch * data_cfg.seq_len
        log("k", f"{key[0]} ({cfg.num_layers} layers, remat {cfg.remat}) "
                 f"bf16 train step B{data_cfg.global_batch} "
                 f"S{data_cfg.seq_len} at {n} "
                 f"slice(s) of the card: {walls[key]:.3f} ms wall, card busy "
                 f"{ms:.3f} ms in {launches} kernels and copies "
                 f"({100 * (1 - ms / walls[key]):.1f}% idle), "
                 f"{tokens / walls[key] * 1e3:.0f} tokens/s; top: "
                 + "; ".join(f"{k} {t:.3f} ms x{c}" for k, t, c in top))
    return walls, busy


def phase_train_step_time(cfg, trainer, state, batch, data_cfg, others=()):
    """(k) One bf16 train step of ``cfg`` at 1, 2 and 4 slices of the card
    (the trained state resharded from 1), with the parameters replicated
    and, at 2 and 4, in blocks over the slices (FSDP_RULES: each slice's
    step gathers them first), and of each of ``others`` ((cfg, trainer,
    state, batch, data_cfg)) at 1: step_times."""
    from repro_torch.core import FSDP_RULES, make_mesh, reshard, slice_devices
    from repro_torch.runtime import ElasticTrainer
    entries = {}
    for n, rules in ((1, None), (2, None), (4, None), (2, FSDP_RULES),
                     (4, FSDP_RULES)):
        if n == 1:
            tr, st = trainer, state
        else:
            changes = dict(max_slices=n)
            if rules is not None:
                changes["rules"] = rules
            tr = ElasticTrainer(trainer.model, trainer.opt_cfg, trainer.data,
                                dataclasses.replace(trainer.cfg, **changes),
                                devices=slice_devices(n))
            st = reshard(state, tr._state_shardings(make_mesh(
                n, 1, devices=tr.devices)))
        label = cfg.name + ("" if rules is None else " FSDP")
        entries[label, n] = (cfg, data_cfg, n,
                             lambda tr=tr, st=st: tr.train_step(st, batch))
    for o_cfg, o_tr, o_st, o_batch, o_data in others:
        entries[o_cfg.name, 1] = (
            o_cfg, o_data, 1, lambda tr=o_tr, st=o_st, b=o_batch:
            tr.train_step(st, b))
    step_times(entries)


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
    from repro_torch.core import gather, mesh_model_ways, reshard
    from repro_torch.models.layers import tree_map
    stats = dict(moved=0, local=0, kept=0, copies=0, kept_at=set())

    def leaf(x, sh):
        log_ = []
        y = reshard(x, sh, transfers=log_)
        if not same_bits(gather(y), gather(x)):
            raise AssertionError(f"reshard changed a leaf {x}")
        olds = [storage_of(t) for t in x.shards.values()]
        ways = mesh_model_ways(sh.mesh)
        for c, t in y.shards.items():
            if t.device.type != "cuda":
                raise AssertionError(f"block {c} is not on the card")
            r = storage_of(t)
            k = c[0]
            # one whole local piece for each model coordinate of the slice
            into = [tr for tr in log_ if tr.dst == k]
            if any(r[0] < o[1] and o[0] < r[1] for o in olds):
                if r not in olds or len(into) != ways or \
                        not all(tr.local for tr in into):
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


def random_moments(tr, params, seed):
    """A TrainState of trainer ``tr`` from ``params`` with AdamW moments
    drawn whole on the card from ``seed`` (|normal|) and laid out by the
    trainer's rules, so that any layout holds the same values, at step 5."""
    from repro_torch.core import place
    from repro_torch.models.layers import tree_map
    state = tr.init_state(params=params)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name in ("mu", "nu"):
        state["opt"][name] = tree_map(lambda x: place(torch.randn(
            x.shape, generator=gen, device="cuda").abs(), x.sharding),
            state["opt"][name])
    state["step"] = state["step"].map(lambda t: t + 5)
    state["opt"]["step"] = state["opt"]["step"].map(lambda t: t + 5)
    return state


def copies_vs_plain(label, state, shardings):
    """``state`` onto ``shardings`` as reshard lays it out (plan_copies),
    its copies run by the box-copy kernel and, into blocks of their own, by
    its plain version from the same sources: every new block bit-equal
    between the two and every leaf to its input. Returns (the resharded
    state, the pieces, the bytes copied)."""
    from repro_torch.core import gather
    from repro_torch.core.reshard import plan_copies
    from repro_torch.kernels.reshard import kernel as box
    from repro_torch.kernels.reshard.ref import box_copy_ref, piece_bytes
    from repro_torch.models.layers import tree_leaves
    out, groups = plan_copies(state, shardings)
    pieces = copied = 0
    for sdev, ddev, srcs, dsts, table in groups:
        if sdev != ddev or sdev.type != "cuda":
            raise AssertionError(f"{label}: pieces from {sdev} to {ddev}")
        box.box_copy(srcs, dsts, table)
        plain = [torch.empty_like(d) for d in dsts]
        box_copy_ref(srcs, plain, table)
        bad = sum(not same_bits(a, b) for a, b in zip(dsts, plain))
        if bad:
            raise AssertionError(f"{label}: {bad} of {len(dsts)} new blocks "
                                 f"differ between the kernel and its plain "
                                 f"version")
        pieces += len(table)
        copied += int(piece_bytes(table).sum())
    for a, b in zip(tree_leaves(state), tree_leaves(out)):
        if not same_bits(gather(a), gather(b)):
            raise AssertionError(f"{label}: a leaf changed")
    return out, pieces, copied


def phase_box_copy_vs_plain(cfg, params, data_cfg):
    """(bc) The reshard's box-copy kernel against its plain version on the
    card, bit for bit (copies_vs_plain): every resize of (t)'s grid (the CI
    geometries both ways at 64 MiB, 256 MiB and 1 GiB, a row-sharded
    float32 array onto resized_mesh) and smollm-135m's TrainState (random
    moments) expanded 2 -> 4 and shrunk back under TP_DP_RULES and
    FSDP_RULES. Returns the largest difference (0: bit-equal, else the
    phase fails)."""
    from repro_torch.calib.measure import (CI_DATA_BYTES, CI_GEOMETRIES,
                                           _elems_for, _placed)
    from repro_torch.core import (FSDP_RULES, NamedSharding, PartitionSpec,
                                  make_mesh, resized_mesh, slice_devices)
    t0 = time.perf_counter()
    devices = slice_devices(64)
    n = pieces = copied = 0
    for p, q in CI_GEOMETRIES:
        for a, b in ((p, q), (q, p)):
            old = make_mesh(a, 1, devices=devices)
            new = NamedSharding(resized_mesh(old, b, devices=devices),
                                PartitionSpec("data"))
            for nbytes in CI_DATA_BYTES:
                x = _placed(_elems_for(nbytes, max(a, b)), old)
                _, k, c = copies_vs_plain(f"{a} -> {b}, {nbytes} bytes", x,
                                          new)
                n, pieces, copied = n + 1, pieces + k, copied + c
                del x
    log("bc", f"(t)'s grid: {n} resizes, {pieces} pieces, "
              f"{copied / 2 ** 30:.2f} GiB copied, the kernel bit-equal to "
              f"its plain version")
    for name, changes in (("TP_DP_RULES", {}),
                          ("FSDP_RULES", {"rules": FSDP_RULES})):
        tr = elastic_trainer(cfg, data_cfg, 1, 2, **changes)
        s2 = random_moments(tr, params, 9)
        m4 = resized_mesh(tr.mesh, 4, devices=slice_devices(ELASTIC_SLICES))
        s4, k4, c4 = copies_vs_plain(f"{name} 2 -> 4", s2,
                                     tr._state_shardings(m4))
        _, k2, c2 = copies_vs_plain(f"{name} 4 -> 2", s4,
                                    tr._state_shardings(tr.mesh))
        log("bc", f"{cfg.name} TrainState under {name}: expand 2 -> 4 "
                  f"{k4} pieces, {c4 / 1e9:.3f} GB copied; shrink 4 -> 2 "
                  f"{k2} pieces, {c2 / 1e9:.3f} GB copied (views kept in "
                  f"place read as strided sources); the kernel bit-equal "
                  f"to its plain version")
        del s2, s4
    torch.cuda.empty_cache()
    log("bc", f"{time.perf_counter() - t0:.1f} s")
    return 0.0


def phase_fsdp_step(cfg, model, params, data_cfg):
    """(r) One fp32 train step of smollm-135m at full width (weights at a
    per-layer fan-in) on 2 and 4 virtual slices with the parameters in
    blocks over the slices (FSDP_RULES: each slice gathers its whole
    parameters before its forward and frees them after its backward; each
    block is updated from its part of the summed gradients) against the
    same step with them replicated (TP_DP_RULES), from one state and one
    batch: the loss, and every parameter and moment gathered after the
    update, max-normalised at MODEL_TOL. The moments are random, so that
    an update is no sign of its gradient: the flash backward sums dQ in an
    order that changes from run to run, which could flip the sign of a
    gradient near 0 and with it a fresh AdamW update by 2 lr."""
    from repro_torch.core import FSDP_RULES, TP_DP_RULES, gather
    from repro_torch.core.sharding import distinct_blocks
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.layers import tree_map
    f32 = dataclasses.replace(cfg, dtype="float32")
    sane = at_per_layer_fan_in(model, params, cfg.pattern_repeats[0])
    batch = {k: t.cuda() for k, t in SyntheticLMData(data_cfg).batch(
        0).items()}
    per_step = train_launches(cfg)
    worst = {}
    for n in (2, 4):
        out = {}
        for name, rules in (("replicated", TP_DP_RULES),
                            ("FSDP", FSDP_RULES)):
            tr = elastic_trainer(f32, data_cfg, 1, n, rules=rules)
            state = random_moments(tr, sane, seed=6)
            wq = state["params"]["blocks"]["p0"]["attn"]["wq"]
            blocks = len(distinct_blocks(wq))
            if blocks != (n if rules is FSDP_RULES else 1):
                raise AssertionError(f"{name}: wq in {blocks} blocks at "
                                     f"{n} slices")
            new, metrics = counted_launches(
                lambda: tr.train_step(state, batch),
                {k: n * v for k, v in per_step.items()})
            out[name] = (metrics["loss"].reshape(1),
                         tree_paths(tree_map(gather, {
                             "params": new["params"], "mu": new["opt"]["mu"],
                             "nu": new["opt"]["nu"]})))
            del state, new
        errs = {"loss": max_norm_err(out["FSDP"][0], out["replicated"][0])}
        errs.update({"/".join(path): max_norm_err(t, out["replicated"][1][
            path]) for path, t in out["FSDP"][1].items()})
        top = max(errs, key=errs.get)
        worst[n] = errs[top]
        log("r", f"{cfg.name} fp32 B{data_cfg.global_batch} "
                 f"S{data_cfg.seq_len} step at {n} slices, FSDP_RULES "
                 f"against replicated (per-layer fan-in, random moments): "
                 f"loss {out['FSDP'][0].item():.6f} / "
                 f"{out['replicated'][0].item():.6f}, max-normalised "
                 f"{errs['loss']:.3e}; parameters and moments after the "
                 f"update, largest {top} {errs[top]:.3e} over {len(errs) - 1}"
                 f" leaves (tol {MODEL_TOL})")
        del out
    if max(worst.values()) > MODEL_TOL:
        raise AssertionError("the FSDP step disagrees with the replicated "
                             "one")


def checked_loop(tr, params, per_slice):
    """``tr.train`` from ``params`` with every reshard by checked_reshard and
    every step's kernel launches counted: a step's must be ``per_slice``
    (``{name: count}``) times its slices. Returns (the final state, each
    reshard's stats)."""
    from repro_torch.core import reshard
    from repro_torch.runtime import trainer as trainer_mod
    resizes, calls, wrappers = [], [], counters()

    def checked(state, shardings):
        out, stats = checked_reshard(state, shardings)
        resizes.append(stats)
        return out

    step_fn = tr.train_step

    def step(state, batch):
        before = {n: wrappers[n].launches for n in per_slice}
        out = step_fn(state, batch)
        calls.append((tr.slices, {n: wrappers[n].launches - before[n]
                                  for n in per_slice}))
        return out

    tr.train_step = step
    trainer_mod.reshard = checked
    try:
        state = tr.train(state=tr.init_state(params=params))
    finally:
        trainer_mod.reshard = reshard
    bad = [c for c in calls if c[1] != {n: c[0] * k
                                        for n, k in per_slice.items()}]
    if bad or not calls:
        raise AssertionError(f"kernel launches per step {bad}, expected "
                             f"{per_slice} per slice")
    return state, resizes


def nonlocal_bytes(src, sh):
    """The bytes of the plan's non-local transfers of reshard(src, sh)."""
    from repro_torch.core import reshard
    plan = []
    reshard(src, sh, transfers=plan)
    return sum(t.nbytes for t in plan if not t.local)


def log_loop(label, cfg, data_cfg, what, tr, resizes, losses):
    log(label, f"{cfg.name} bf16 B{data_cfg.global_batch} S{data_cfg.seq_len}"
               f" {what}, {tr.cfg.steps} steps: resizes "
               + "; ".join(f"{r['action']} {r['from']} -> {r['to']} at step "
                           f"{r['step']} in {r['resize_s'] * 1e3:.3f} ms"
                           for r in tr.resize_log)
               + " (each checked leaf by leaf: bit-equal, "
               + ", ".join(f"{x['moved'] / 1e9:.3f} GB moved in "
                           f"{x['copies']} copies, {x['kept']} blocks kept"
                           for x in resizes)
               + f"); slices by step {[m['slices'] for m in tr.metrics]}; "
               f"losses " + ", ".join(f"{x:.4f}" for x in losses))


def phase_fsdp_elastic(cfg, params, data_cfg):
    """(r) The elastic loop under FSDP_RULES, bf16: ElasticTrainer.train
    from 2 of 4 virtual slices, a scripted RMS that EXPANDs the job to 4 at
    its first reconfiguration point and SHRINKs it back to 2 at its second;
    each reshard of the TrainState by checked_reshard (every leaf
    bit-equal, a block kept in place only by a local transfer), its bytes
    of non-local transfers beside those of the same resize of the
    replicated layout's state, and both layouts' resize ms (timed_reshard,
    best of 3); the flash launches a step are the slices' count times
    (q)'s; the loss falls."""
    from repro_torch.core import (FSDP_RULES, Action, Decision, reshard,
                                  resized_mesh, slice_devices, timed_reshard)
    steps, devices = 6, slice_devices(ELASTIC_SLICES)
    tr = elastic_trainer(cfg, data_cfg, steps, 2, rms=ScriptedRMS(
        {1: Decision(Action.EXPAND, 4), 2: Decision(Action.SHRINK, 2)}),
        check_period=2, rules=FSDP_RULES)
    state, resizes = checked_loop(tr, params, train_launches(cfg))
    losses = [m["loss"] for m in tr.metrics]
    moves = {}
    for name, changes in (("replicated", {}), ("FSDP", {"rules": FSDP_RULES})):
        t2 = elastic_trainer(cfg, data_cfg, 1, 2, **changes)
        s2 = t2.init_state(params=params)
        sh4 = t2._state_shardings(resized_mesh(t2.mesh, 4, devices=devices))
        s4 = reshard(s2, sh4)
        moves[name] = [
            (nonlocal_bytes(src, sh), min(timed_reshard(src, sh)[1] * 1e3
                                          for _ in range(3)))
            for src, sh in ((s2, sh4), (s4, t2._state_shardings(t2.mesh)))]
        del s2, s4
    log_loop("r", cfg, data_cfg, "under FSDP_RULES", tr, resizes, losses)
    for name, ((grow_b, grow_ms), (shrink_b, shrink_ms)) in moves.items():
        log("r", f"{cfg.name} TrainState, parameters {name}: expand 2 -> 4 "
                 f"{grow_b / 1e9:.3f} GB of non-local transfers in "
                 f"{grow_ms:.3f} ms, shrink 4 -> 2 {shrink_b / 1e9:.3f} GB in "
                 f"{shrink_ms:.3f} ms (timed_reshard, best of 3)")
    if [(r["action"], r["from"], r["to"]) for r in tr.resize_log] != \
            [("EXPAND", 2, 4), ("SHRINK", 4, 2)] or len(resizes) != 2:
        raise AssertionError(f"the FSDP loop's resizes {tr.resize_log}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            int(state["step"]) != steps:
        raise AssertionError("the FSDP loop did not bring the loss down")


# -- (tps) smollm-135m with tensor parallelism inside a slice ------------------------

# smollm's model coordinates a slice: 9 / 3 heads do not divide by 2, so
# every coordinate computes the whole attention (its gradients are sums over
# the coordinates) while the MLP and the vocab are split
TP_WAYS = 2


def phase_tp_step(cfg, model, params, data_cfg):
    """(tps) One fp32 train step of smollm-135m at full width (weights at a
    per-layer fan-in) at model_ways TP_WAYS on 1 and 2 slices (2 and 4
    virtual devices of the card) against the same step at model_ways 1 on
    as many slices, from one state (random moments, random_moments) and
    one batch: the loss and every parameter and moment gathered after the
    update, max-normalised at MODEL_TOL; each coordinate runs the whole
    attention, so a slice launches TP_WAYS times (q)'s flash kernels."""
    from repro_torch.core import gather
    from repro_torch.data import SyntheticLMData
    from repro_torch.models.layers import tree_map
    f32 = dataclasses.replace(cfg, dtype="float32")
    sane = at_per_layer_fan_in(model, params, cfg.pattern_repeats[0])
    batch = {k: t.cuda() for k, t in SyntheticLMData(data_cfg).batch(
        0).items()}
    per_step = train_launches(cfg)
    worst = {}
    for n in (1, 2):
        out = {}
        for ways in (1, TP_WAYS):
            tr = elastic_trainer(f32, data_cfg, 1, n, model_ways=ways)
            state = random_moments(tr, sane, seed=6)
            new, metrics = counted_launches(
                lambda: tr.train_step(state, batch),
                {k: n * ways * v for k, v in per_step.items()})
            out[ways] = (metrics["loss"].reshape(1),
                         tree_paths(tree_map(gather, {
                             "params": new["params"], "mu": new["opt"]["mu"],
                             "nu": new["opt"]["nu"]})))
            del state, new
        errs = {"loss": max_norm_err(out[TP_WAYS][0], out[1][0])}
        errs.update({"/".join(path): max_norm_err(t, out[1][1][path])
                     for path, t in out[TP_WAYS][1].items()})
        top = max(errs, key=errs.get)
        worst[n] = errs[top]
        log("tps", f"{cfg.name} fp32 B{data_cfg.global_batch} "
                   f"S{data_cfg.seq_len} step at {n} slice(s), model_ways "
                   f"{TP_WAYS} against 1 (per-layer fan-in, random "
                   f"moments): loss {out[TP_WAYS][0].item():.6f} / "
                   f"{out[1][0].item():.6f}, max-normalised "
                   f"{errs['loss']:.3e}; parameters and moments after the "
                   f"update, largest {top} {errs[top]:.3e} over "
                   f"{len(errs) - 1} leaves (tol {MODEL_TOL})")
        del out
    if max(worst.values()) > MODEL_TOL:
        raise AssertionError("the step at model_ways 2 disagrees with "
                             "model_ways 1")
    return worst


def phase_tp_elastic(cfg, params, data_cfg):
    """(tps) The elastic loop at model_ways TP_WAYS, bf16, under TP_DP_RULES
    and FSDP_RULES: ElasticTrainer.train from 1 of 2 slices (4 virtual
    devices of the card), a scripted RMS that EXPANDs the job to 2 at its
    first reconfiguration point and SHRINKs it back to 1 at its second;
    each reshard by checked_reshard (every leaf bit-equal, a block kept in
    place only by its slice's local transfers); the flash launches a step
    TP_WAYS times (q)'s per slice; the loss falls. Then the resize's bytes
    of non-local transfers and ms (timed_reshard, best of 3) beside the
    model_ways 1 layout's, under both rule tables."""
    from repro_torch.core import (FSDP_RULES, TP_DP_RULES, Action, Decision,
                                  reshard, resized_mesh, slice_devices,
                                  timed_reshard)
    steps, devices = 6, slice_devices(ELASTIC_SLICES)
    per_slice = {n: TP_WAYS * k for n, k in train_launches(cfg).items()}
    tables = {"replicated": TP_DP_RULES, "FSDP": FSDP_RULES}
    for name, rules in tables.items():
        tr = elastic_trainer(cfg, data_cfg, steps, 1, rms=ScriptedRMS(
            {1: Decision(Action.EXPAND, 2), 2: Decision(Action.SHRINK, 1)}),
            check_period=2, rules=rules, model_ways=TP_WAYS)
        state, resizes = checked_loop(tr, params, per_slice)
        losses = [m["loss"] for m in tr.metrics]
        log_loop("tps", cfg, data_cfg, f"at model_ways {TP_WAYS}, parameters "
                 f"{name}", tr, resizes, losses)
        if [(r["action"], r["from"], r["to"]) for r in tr.resize_log] != \
                [("EXPAND", 1, 2), ("SHRINK", 2, 1)] or len(resizes) != 2:
            raise AssertionError(f"the loop's resizes {tr.resize_log}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
                int(state["step"]) != steps:
            raise AssertionError("the loop at model_ways 2 did not bring "
                                 "the loss down")
        del state
    moves = {}
    for name, rules in tables.items():
        for ways in (1, TP_WAYS):
            t1 = elastic_trainer(cfg, data_cfg, 1, 1, rules=rules,
                                 model_ways=ways)
            s1 = t1.init_state(params=params)
            sh2 = t1._state_shardings(resized_mesh(t1.mesh, 2,
                                                   devices=devices))
            s2 = reshard(s1, sh2)
            moves[name, ways] = [
                (nonlocal_bytes(src, sh),
                 min(timed_reshard(src, sh)[1] * 1e3 for _ in range(3)))
                for src, sh in ((s1, sh2),
                                (s2, t1._state_shardings(t1.mesh)))]
            del s1, s2
    for (name, ways), ((grow_b, grow_ms), (shrink_b, shrink_ms)) in \
            moves.items():
        log("tps", f"{cfg.name} TrainState, parameters {name}, model_ways "
                   f"{ways}: expand 1 -> 2 {grow_b / 1e9:.3f} GB of "
                   f"non-local transfers in {grow_ms:.3f} ms, shrink 2 -> 1 "
                   f"{shrink_b / 1e9:.3f} GB in {shrink_ms:.3f} ms "
                   f"(timed_reshard, best of 3)")
    return {f"{name} model_ways {ways}": v for (name, ways), v in
            moves.items()}


def phase_elastic_fp32(cfg, model, params, data_cfg):
    """(r) fp32 at full width, weights at a per-layer fan-in: a run that
    expands 2 -> 4 slices at its first reconfiguration point against the
    same steps at 4 slices from the same state, the losses within
    ELASTIC_TOL; the first steps at 1, 2 and 4 slices within SLICES_TOL."""
    f32 = dataclasses.replace(cfg, dtype="float32")
    from repro_torch.core import Action, Decision
    sane = at_per_layer_fan_in(model, params, cfg.pattern_repeats[0])

    from repro_torch.core.reshard import PROGRAMS

    def run(slices, steps, rms=None):
        tr = elastic_trainer(f32, data_cfg, steps, slices, rms=rms,
                             check_period=2)
        tr.train(state=tr.init_state(params=sane))
        return [m["loss"] for m in tr.metrics], tr

    fixed, _ = run(4, ELASTIC_FP32_STEPS)
    compiled = PROGRAMS.compiles
    elastic, tr = run(2, ELASTIC_FP32_STEPS,
                      ScriptedRMS({1: Decision(Action.EXPAND, 4)}))
    compiled = PROGRAMS.compiles - compiled
    one, _ = run(1, 2)
    diff = max(abs(a - b) for a, b in zip(fixed, elastic))
    spread = max(abs(a - b) for run_ in (one, elastic[:2])
                 for a, b in zip(run_, fixed[:2]))
    log("r", f"{cfg.name} fp32 B{data_cfg.global_batch} S{data_cfg.seq_len} "
             f"(per-layer fan-in): losses at 4 slices "
             + ", ".join(f"{x:.6f}" for x in fixed) + "; 2 -> 4 "
             + ", ".join(f"{x:.6f}" for x in elastic)
             + f" (resize {tr.resize_log}, {compiled} walks compiled in "
             f"it); largest difference {diff:.3e} "
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
    from repro_torch.core.reshard import PROGRAMS
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
    per_step = train_launches(cfg)
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
        compiled = PROGRAMS.compiles
        t0 = time.perf_counter()
        state = tr.train(state=tr.init_state(params=params))
        seconds = time.perf_counter() - t0
        compiled = PROGRAMS.compiles - compiled
        saved = sorted(p.name for p in Path(ckpt).glob("ckpt_*"))
    losses = [m["loss"] for m in tr.metrics]
    log("r", f"{cfg.name} bf16 B{data_cfg.global_batch} S{data_cfg.seq_len}"
             f", LocalRMS of {ELASTIC_SLICES} nodes: {LOOP_STEPS} steps in "
             f"{seconds:.1f} s; cluster {cluster.events}; resizes "
             + "; ".join(f"{r['action']} {r['from']} -> {r['to']} at step "
                         f"{r['step']} in {r['resize_s'] * 1e3:.3f} ms"
                         for r in tr.resize_log)
             + f" ({compiled} walks compiled in them: a geometry's first "
             f"resize compiles its leaves' walks); recoveries "
             f"{tr.recoveries}; checkpoints kept {saved}; "
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
    """(k) timed_reshard for the TrainState's expand 2 -> 4 and shrink
    4 -> 2, three of each, through the box-copy kernel (reshard), its plain
    version (plain_reshard: the same compiled walk, one copy_ a piece) and
    checkpoint_reshard, with the plan's bytes (non-local transfers) and the
    rate they imply; one expand under the profiler (bench.device_profile,
    held by check_profile: the box-copy kernel listed with device time);
    each resize's copies alone (copies_times); then migrate_slice(0, 2) of
    every leaf of the 4-slice state. Returns the expand's copies_times,
    the kernel's row."""
    from repro_torch.core import (checkpoint_reshard, migrate_slice,
                                  reshard, resized_mesh, slice_devices,
                                  timed_reshard)
    from repro_torch.core.reshard import synchronize
    from repro_torch.kernels import bench
    from repro_torch.models.layers import tree_leaves, tree_map
    smi = bench.card()
    m4 = resized_mesh(trainer.mesh, 4,
                      devices=slice_devices(ELASTIC_SLICES))
    cases = {"expand 2 -> 4": (s2, trainer._state_shardings(m4)),
             "shrink 4 -> 2": (s4, trainer._state_shardings(trainer.mesh))}
    for name, (src, sh) in cases.items():
        plan = []
        reshard(src, sh, transfers=plan)
        moved = sum(t.nbytes for t in plan if not t.local)
        times = {}
        for impl in (reshard, plain_reshard, checkpoint_reshard):
            times[impl.__name__] = [timed_reshard(src, sh, impl=impl)[1]
                                    * 1e3 for _ in range(3)]
        best = min(times["reshard"])
        best_plain = min(times["plain_reshard"])
        slow = min(times["checkpoint_reshard"])
        log("k", f"{cfg.name} TrainState {name} virtual slices: reshard "
                 + ", ".join(f"{t:.3f}" for t in times["reshard"])
                 + f" ms through the box-copy kernel ({moved / 1e9:.3f} GB "
                 f"of non-local transfers, {moved / best / 1e6:.1f} GB/s at "
                 f"the best); its plain version after the same walk "
                 + ", ".join(f"{t:.3f}" for t in times["plain_reshard"])
                 + f" ms ({moved / best_plain / 1e6:.1f} GB/s); "
                 f"checkpoint_reshard "
                 + ", ".join(f"{t:.3f}" for t in times["checkpoint_reshard"])
                 + f" ms (to the host and back, pageable memory), "
                 f"{slow / best:.1f}x the reshard; on-card copies, not the "
                 f"paper's links between nodes; {smi}")
    src, sh = cases["expand 2 -> 4"]
    prof = bench.device_profile(lambda: reshard(src, sh), top=8,
                                what="a TrainState expand 2 -> 4")
    log("k", f"{cfg.name} TrainState expand 2 -> 4 under the profiler: "
             f"{prof['busy_ms']:.3f} ms busy, {prof['kernels']} kernels, "
             f"{prof['launches']} kernels and copies; top " + ", ".join(
                 f"{name} {ms:.4f} ms x{k}" for name, ms, k in prof["top"]))
    rows = {name: copies_times(*case) for name, case in cases.items()}
    for name, row in rows.items():
        log("k", f"box_copy, {cfg.name} TrainState {name} ({row['pieces']} "
                 f"pieces, {row['copied'] / 1e9:.3f} GB copied, one launch): "
                 f"{row['ms']:.4f} ms "
                 f"({2 * row['copied'] / row['ms'] / 1e6:.1f} GB/s read + "
                 f"written), bound {row['bound_ms']:.4f} ms "
                 f"(bytes), plain {row['plain_ms']:.4f} ms, "
                 f"torch._foreach_copy_ {row['library_ms']:.4f} ms; {smi}")
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
    return rows["expand 2 -> 4"]


def copies_times(src, sh):
    """The table of reshard(src, sh) (plan_copies) run by the box-copy
    kernel, by its plain version and by torch._foreach_copy_ over the same
    pieces' views, each in device time (CUDA events around 10 calls), and
    the kernel's bound: each copied byte read and written once at the HBM
    rate."""
    from repro_torch.core.reshard import plan_copies
    from repro_torch.kernels import bench
    from repro_torch.kernels.reshard import kernel as box
    from repro_torch.kernels.reshard.ref import (box_copy_ref, byte_view,
                                                 piece_bytes)
    out, groups = plan_copies(src, sh)
    (_, _, srcs, dsts, table), = groups
    copied = int(piece_bytes(table).sum())
    views = {id(t): (byte_view(t), t.storage_offset() * t.element_size())
             for t in (*srcs, *dsts)}

    def as_view(t, off, strides, shape):
        v, base = views[id(t)]
        return v.as_strided(shape, strides, base + off)
    src_views, dst_views = [], []
    for rec in table:
        shape = [*rec["ext"].tolist(), int(rec["run"])]
        src_views.append(as_view(srcs[rec["src"]], int(rec["src_off"]),
                                 [*rec["src_stride"].tolist(), 1], shape))
        dst_views.append(as_view(dsts[rec["dst"]], int(rec["dst_off"]),
                                 [*rec["dst_stride"].tolist(), 1], shape))
    return {"ms": bench.eager_ms(lambda: box.box_copy(srcs, dsts, table),
                                 iters=10),
            "plain_ms": bench.eager_ms(
                lambda: box_copy_ref(srcs, dsts, table), iters=10),
            "library_ms": bench.eager_ms(
                lambda: torch._foreach_copy_(dst_views, src_views),
                iters=10),
            "bound_ms": 2 * copied / bench.PEAK_BYTES * 1e3,
            "bound_by": "bytes", "pieces": len(table), "copied": copied}


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


def plain_reshard(state, shardings):
    """reshard with its copies run by the box-copy kernel's plain version
    (one copy_ a piece), after the same compiled walk (plan_copies)."""
    from repro_torch.core.reshard import plan_copies
    from repro_torch.kernels.reshard.ref import box_copy_ref
    out, groups = plan_copies(state, shardings)
    for *_, srcs, dsts, table in groups:
        box_copy_ref(srcs, dsts, table)
    return out


def sample_key(s):
    return s["kind"], s["old"], s["new"], s["bytes"]


def plain_grid(config):
    """Each resize of ``config``'s grid timed through plain_reshard as
    measure_grid times the reshard (the same array and meshes, one warm-up,
    the best of config.repeats timed_reshard calls): {sample_key:
    seconds}."""
    from repro_torch.calib.measure import _best_of, _elems_for, _placed
    from repro_torch.core import (NamedSharding, PartitionSpec, make_mesh,
                                  resized_mesh, slice_devices, timed_reshard)
    out = {}
    for p, q in config.geometries:
        for nbytes in config.data_bytes:
            for kind, a, b in (("expand", p, q), ("shrink", q, p)):
                devices = slice_devices(max(a, b))
                old = make_mesh(a, 1, devices=devices)
                new = NamedSharding(resized_mesh(old, b, devices=devices),
                                    PartitionSpec("data"))
                x = _placed(_elems_for(nbytes, max(a, b)), old)
                out[kind, a, b, nbytes] = _best_of(lambda: timed_reshard(
                    x, new, impl=plain_reshard), config.repeats)
                del x
    return out


def phase_calibration():
    """(t) measure_grid(MeasureConfig(backend="torch")) on the CI grid: the
    port's reshard of 64 MiB - 1 GiB between 1 and 64 virtual slices of the
    card, its copies in one box-copy launch a resize, each resize checked
    by measure_grid itself (bit-equal, the reshard's transfers carrying the
    plan's non-local bytes) and here (each sample's plan features, positive
    seconds); the grid again through the plain version's copies, printed
    beside; then the fit of the kernel's samples. The fit's verdict is
    printed, not asserted: the paper's model divides the busiest link's
    bytes by a per-node bandwidth, and virtual slices share one HBM, so a
    refusal (FitError) is a finding about one card."""
    from repro_torch.calib import (FitError, MeasureConfig, fit_report_rows,
                                   fit_samples, make_artifact, measure_grid,
                                   validate_calibration)
    from repro_torch.calib.measure import resize_features
    from repro_torch.kernels import bench
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
    # the same grid with the plain version's copies (the same compiled
    # walk, one copy_ a piece), printed beside the kernel's, not fitted
    t0 = time.perf_counter()
    resizes = [s for s in samples if s["kind"] in ("expand", "shrink")]
    plain = plain_grid(config)
    log("t", f"the grid again through the plain version's copies in "
             f"{time.perf_counter() - t0:.1f} s; {bench.card()}")
    # each geometry alone: seconds against busiest-link bytes over the data
    # sizes, the copy rate its slope gives and the time at zero bytes (the
    # host's share), which the model's one spawn_s cannot follow
    for label, seconds in (("box-copy kernel", lambda s: s["seconds"]),
                           ("plain", lambda s: plain[sample_key(s)])):
        by_geometry = {}
        for s in resizes:
            by_geometry.setdefault((s["kind"], s["old"], s["new"]),
                                   []).append((s["busiest_bytes"],
                                               seconds(s)))
        for (kind, old, new), pts in by_geometry.items():
            slope, at_zero = np.polyfit(*zip(*pts), 1)
            rate = f"{1 / slope / 1e12:.3f} TB/s" if slope > 0 else "no rate"
            log("t", f"{kind} {old} -> {new} alone, {label}: {rate} of "
                     f"busiest-link bytes, {at_zero * 1e3:.4f} ms at zero "
                     f"bytes")
    for s in resizes:
        log("t", f"{s['kind']} {s['old']} -> {s['new']}, "
                 f"{s['bytes'] / 2 ** 20:.0f} MiB: box-copy kernel "
                 f"{s['seconds'] * 1e3:.4f} ms, plain "
                 f"{plain[sample_key(s)] * 1e3:.4f} ms")
    try:
        fitted, residuals, checks = fit_samples(samples)
    except FitError as err:
        log("t", f"fit: FitError: {err}")
        for s in samples:
            if s["kind"] in ("expand", "shrink"):
                log("t", f"{s['kind']} {s['old']} -> {s['new']}, "
                         f"{s['bytes'] / 2 ** 20:.0f} MiB: busiest link "
                         f"{s['busiest_bytes'] / 2 ** 20:g} MiB, "
                         f"{s['participants']} participants")
        return None
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
    return doc


# -- (ws) workload simulation: the paper's section 7 testbed, host code ----------

# Table 4 (section 7.5): workloads of 50-400 jobs on the paper's 64 nodes,
# EASY scheduling, synchronous DMR checks, fixed against flexible
WS_SIZES, WS_NODES, WS_SEED = (50, 100, 200, 400), 64, 7
# the runs sanitised (every structural invariant checked around each event)
WS_SANITIZED = 50
# the phase's host seconds it should stay within (printed, not asserted:
# a shared host's load is not the port's)
WS_BUDGET_S = 30.0
GOLDEN_ENGINE = ROOT / "tests" / "data" / "golden_engine_trace.json"


def golden_engine_bytes(report):
    """The golden scenario's report serialised as
    tests/test_engine_determinism.py serialises it, with the file's final
    newline."""
    doc = {
        "makespan": round(report.makespan, 6),
        "actions": [
            {"t": round(a.t, 6), "job_id": a.job_id, "action": a.action,
             "decide_s": round(a.decide_s, 6),
             "apply_s": round(a.apply_s, 6),
             "from_nodes": a.from_nodes, "to_nodes": a.to_nodes,
             "timed_out": a.timed_out, "reason": a.reason}
            for a in report.actions],
    }
    return json.dumps(doc, indent=1, sort_keys=True).encode() + b"\n"


def ws_golden():
    """The reference's golden engine scenario in the port, sanitised: 12
    jobs of make_workload on 32 nodes, a node failure at 400 s, a
    straggler from 200 s. Returns the sanitizer's event checks."""
    from repro_torch.rms import ClusterSimulator, SimConfig
    from repro_torch.workload import make_workload
    sim = ClusterSimulator(make_workload(12, seed=WS_SEED), SimConfig(
        num_nodes=32, flexible=True, seed=WS_SEED, failures=((400.0, 0),),
        stragglers=((200.0, 1, 3.0),), sanitize=True))
    report = sim.run()      # a violated invariant raises SanitizerError
    if sim.sanitizer is None or sim.sanitizer.checks == 0:
        raise AssertionError("the golden scenario ran unsanitised")
    if golden_engine_bytes(report) != GOLDEN_ENGINE.read_bytes():
        raise AssertionError("the golden scenario's trace differs from "
                             "tests/data/golden_engine_trace.json")
    return sim.sanitizer.checks, len(report.actions), report.makespan


def resize_stats(actions, kind):
    """decide_s + apply_s of one kind of action: (count, min, mean, max)."""
    xs = [a.decide_s + a.apply_s for a in actions if a.action == kind]
    if not xs:
        return 0, 0.0, 0.0, 0.0
    return len(xs), min(xs), float(np.mean(xs)), max(xs)


def ws_table4(cost, sizes=WS_SIZES):
    """Table 4's rows under one reconfiguration cost model: per workload
    size, the fixed and the flexible run. Every job must complete. Returns
    {n: (fixed report, flexible report)}."""
    from repro_torch.rms import (ClusterSimulator, JobState, SchedulerConfig,
                                 SimConfig)
    from repro_torch.workload import make_workload
    out = {}
    for n in sizes:
        runs = []
        for flexible in (False, True):
            config = SimConfig(num_nodes=WS_NODES, flexible=flexible,
                               scheduling="sync", seed=WS_SEED, cost=cost,
                               sched=SchedulerConfig(policy="easy"),
                               sanitize=n == WS_SANITIZED)
            report = ClusterSimulator(make_workload(n, seed=WS_SEED),
                                      config).run()
            done = sum(j.state is JobState.COMPLETED for j in report.jobs)
            if done != n:
                raise AssertionError(f"Table 4, {n} jobs, flexible "
                                     f"{flexible}: {done} of {n} completed")
            runs.append(report)
        out[n] = tuple(runs)
    return out


def table4_claims(fixed, flexible):
    """The reference's four Table 4 claims at one workload size
    (benchmarks/table4_throughput.py)."""
    (bw, be, bc), (fw, fe, fc) = fixed.averages(), flexible.averages()
    return {
        "flexible lowers allocation rate ~30%":
            flexible.utilization()[0] < fixed.utilization()[0] - 10,
        "waiting time reduced": fw < bw,
        "execution time increases": fe > be,
        "completion time improves": fc < bc}


def log_table4(label, table):
    """One line per row: utilisation, mean wait / exec / completion,
    makespan, the makespan and wait gains against the fixed run, and the
    flexible run's expand and shrink times (decide_s + apply_s)."""
    for n, (fixed, flexible) in table.items():
        base_w = fixed.averages()[0]
        for version, rep in (("fixed", fixed), ("flexible", flexible)):
            w, e, c = rep.averages()
            gain = (fixed.makespan - rep.makespan) / fixed.makespan * 100
            wgain = (base_w - w) / base_w * 100 if base_w else 0.0
            line = (f"{label}: {n} jobs {version}: utilisation "
                    f"{rep.utilization()[0]:.1f}%, wait {w:.1f} s, exec "
                    f"{e:.1f} s, completion {c:.1f} s, makespan "
                    f"{rep.makespan:.1f} s, makespan gain {gain:.1f}%, "
                    f"wait gain {wgain:.1f}%, {len(rep.actions)} actions")
            if version == "flexible":
                for kind in ("expand", "shrink"):
                    k, lo, mean, hi = resize_stats(rep.actions, kind)
                    line += (f"; {kind} x{k} min {lo:.4f} mean {mean:.4f} "
                             f"max {hi:.4f} s")
            log("ws", line)


def phase_workload_sim(artifact, sizes=WS_SIZES, card=None):
    """(ws) The paper's section 7 testbed on the port's event engine and
    simulator: host code whose one input from the card is the cost model
    (t) fitted (``artifact``, or None when its fit raised FitError). The
    golden engine scenario, sanitised, must reproduce the reference's
    trace; Table 4 runs under the paper-fit model (its four claims held at
    the smallest size), then under the card's fitted model when there is
    one. All times but the last line's are simulated seconds. Returns the
    tables by cost model's label."""
    from repro_torch.rms import ReconfigCostModel
    t0 = time.perf_counter()
    checks, n_actions, makespan = ws_golden()
    log("ws", f"golden engine scenario (12 jobs, 32 nodes, a failure at "
              f"400 s, a straggler from 200 s), sanitised: {checks} event "
              f"checks, no violation, {n_actions} actions, makespan "
              f"{makespan:.6f} s, byte-equal to "
              f"tests/data/golden_engine_trace.json")
    paper = ReconfigCostModel()
    tables = {"paper-fit": ws_table4(paper, sizes)}
    log_table4("paper-fit (the reference's model, calibration_id None, "
               f"link_bw {paper.link_bw:.4g} B/s)", tables["paper-fit"])
    claims = table4_claims(*tables["paper-fit"][sizes[0]])
    for name, ok in claims.items():
        log("ws", f"paper-fit claim at {sizes[0]} jobs: {name}: {ok}")
    if not all(claims.values()):
        raise AssertionError(f"Table 4's claims under the paper-fit model: "
                             f"{claims}")
    if artifact is None:
        log("ws", "no fitted model from this card: (t)'s fit raised "
                  "FitError (its line above); Table 4 runs under the "
                  "paper-fit model only")
    else:
        card_model = ReconfigCostModel.from_artifact(artifact)
        label = (f"fitted ({artifact['backend']} backend, calibration_id "
                 f"{card_model.calibration_id}, "
                 f"link_bw {card_model.link_bw:.4g} B/s, sched_base_s "
                 f"{card_model.sched_base_s:.4g}, spawn_s "
                 f"{card_model.spawn_s:.4g})")
        tables[card_model.calibration_id] = ws_table4(card_model, sizes)
        log_table4(label, tables[card_model.calibration_id])
        for name, ok in table4_claims(
                *tables[card_model.calibration_id][sizes[0]]).items():
            log("ws", f"fitted model's claim at {sizes[0]} jobs: {name}: "
                      f"{ok}")
    secs = time.perf_counter() - t0
    log("ws", f"{secs:.2f} s of host time (budget {WS_BUDGET_S:.0f} s"
              f"{'' if secs <= WS_BUDGET_S else ', exceeded'})"
              f"{'' if card is None else f', beside {card}'}")
    return tables


# -- (sw) sweeps, observability and lint: the rest of the JAX package's ------
# modules in the port, host code fed (t)'s fit

DATA = ROOT / "tests" / "data"
SAMPLE_SWF = DATA / "sample.swf"
GOLDEN_CALIBRATION = DATA / "golden_calibration.json"
# where (t)'s artifact is written for the zoo's points to read, and the
# phase's artifacts, journals and traces (emptied at the phase's start)
SW_CALIBRATION = ROOT / "build" / "chip_smoke_calibration.json"
SW_WORKDIR = ROOT / "build" / "chip_smoke_sweep"
# the committed golden sweeps: smoke_grid's keywords and the artifact file
SW_GOLDENS = (({}, "golden_sweep.json"),
              ({"churn": "smoke"}, "golden_capacity_sweep.json"),
              ({"serving": True}, "golden_serving_sweep.json"))
SW_WORKERS = 2
# the policy zoo (benchmarks/policy_zoo.py:40, copied as data): every
# registered policy x these five mixes x fixed and flexible on sample.swf,
# the paper's 64 nodes, seed 7; run as SW_SHARDS shards and merged
SW_ZOO_MIXES = "1:0:0:0,0.2:0.2:0.6:0,0:0:1:0,0.2:0.1:0.4:0.3,0:0:0.3:0.7"
SW_ZOO_NODES, SW_ZOO_SEED, SW_SHARDS = 64, 7, 2
# the phase's host seconds it should stay within (printed, not asserted,
# as (ws)'s)
SW_BUDGET_S = 30.0
# a sweep row's action columns by action kind (a timed-out action counts
# as a timeout, whatever its kind), as repro_torch.rms.sweep counts them
SW_ROW_ACTIONS = {"expand": "expands", "shrink": "shrinks",
                  "preempt_shrink": "preempts",
                  "preempt_requeue": "requeues",
                  "phase_change": "phase_changes", "node_drain": "drains",
                  "node_join": "joins", "power_off": "power_offs",
                  "power_on": "power_ons"}


def sw_goldens():
    """The three golden grids through the port's sweep driver on a spawn
    pool of SW_WORKERS, each byte-equal to its committed artifact after
    load_artifact's v4 -> v5 upgrade."""
    from repro_torch.rms import sweep
    for kwargs, name in SW_GOLDENS:
        t0 = time.perf_counter()
        points, grid = sweep.smoke_grid(str(SAMPLE_SWF), **kwargs)
        rows = sweep.run_sweep(points, workers=SW_WORKERS)
        got = sweep.dumps_artifact(sweep.artifact(rows, grid))
        if got != sweep.dumps_artifact(sweep.load_artifact(str(DATA / name))):
            raise AssertionError(f"the {kwargs or 'smoke'} grid's artifact "
                                 f"differs from tests/data/{name}")
        log("sw", f"golden grid {kwargs or 'smoke'}: {len(points)} points "
                  f"at {SW_WORKERS} workers in "
                  f"{time.perf_counter() - t0:.2f} s, byte-equal to "
                  f"tests/data/{name}")


def sw_calibration(artifact, out=SW_CALIBRATION):
    """The calibration the zoo runs under: (t)'s artifact written to
    ``out`` by the port's write_calibration, or, when (t)'s fit raised
    FitError (``artifact`` None), the committed golden artifact."""
    if artifact is None:
        log("sw", "no fitted model from this card: (t)'s fit raised "
                  "FitError (its line above); the zoo runs under "
                  "tests/data/golden_calibration.json")
        return str(GOLDEN_CALIBRATION)
    from repro_torch.calib.artifact import write_calibration
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    write_calibration(str(out), artifact)
    log("sw", f"(t)'s artifact, calibration_id "
              f"{artifact['calibration_id']}, written to {out.name}")
    return str(out)


def sw_main(argv, log_path):
    """``python -m repro_torch.rms.sweep`` in this process, its CSV lines
    sent to ``log_path``; a non-zero exit fails the phase."""
    from repro_torch.rms import sweep
    with open(log_path, "a") as fh, contextlib.redirect_stdout(fh):
        rc = sweep.main([str(a) for a in argv])
    if rc != 0:
        raise AssertionError(f"repro_torch.rms.sweep {argv} exited {rc}")


def sw_zoo(calibration, workdir):
    """The policy zoo's 80 points under ``calibration`` through the sweep
    CLI: serially, then as SW_SHARDS shards each with its own journal,
    merged by --resume over all the journals; the merged artifact must be
    the serial one's bytes. Returns the rows."""
    from repro_torch.rms import POLICY_REGISTRY, sweep
    from repro_torch.rms.journal import GridJournal
    grid = ["--trace", SAMPLE_SWF, "--policies",
            ",".join(sorted(POLICY_REGISTRY)), "--mixes", SW_ZOO_MIXES,
            "--fixed", "--nodes", SW_ZOO_NODES, "--seed", SW_ZOO_SEED,
            "--calibration", calibration]
    log_path = workdir / "zoo.csv.log"
    t0 = time.perf_counter()
    sw_main([*grid, "--out", workdir / "zoo_serial.json"], log_path)
    serial_s = time.perf_counter() - t0
    journals = [workdir / f"zoo_shard{i}.jsonl" for i in range(SW_SHARDS)]
    for i, path in enumerate(journals):
        sw_main([*grid, "--shard", f"{i}/{SW_SHARDS}", "--journal", path,
                 "--out", workdir / f"zoo_shard{i}.json"], log_path)
    n_points = len(POLICY_REGISTRY) * len(SW_ZOO_MIXES.split(",")) * 2
    held = [len(GridJournal.load(str(p))) for p in journals]
    if sum(held) != n_points:
        raise AssertionError(f"the shards' journals hold {held} rows, not "
                             f"{n_points} in all")
    merged = workdir / "zoo_merged.json"
    sw_main([*grid, *(a for p in journals for a in ("--journal", p)),
             "--resume", "--out", merged], log_path)
    serial = (workdir / "zoo_serial.json").read_bytes()
    if merged.read_bytes() != serial:
        raise AssertionError("the shards' merged zoo artifact differs from "
                             "the serial run's")
    rows = sweep.load_artifact(str(merged))["results"]
    if len(rows) != n_points:
        raise AssertionError(f"the zoo has {len(rows)} rows, not {n_points}")
    ids = sorted({r["calibration_id"] for r in rows})
    log("sw", f"policy zoo: {len(POLICY_REGISTRY)} policies x "
              f"{len(SW_ZOO_MIXES.split(','))} mixes x fixed and flexible = "
              f"{len(rows)} points on sample.swf, {SW_ZOO_NODES} nodes, seed "
              f"{SW_ZOO_SEED}, serially in {serial_s:.2f} s; {SW_SHARDS} "
              f"shards ({', '.join(map(str, held))} journaled rows), two "
              f"shards merged by --resume, byte-equal to the serial run; "
              f"rows' calibration_id {', '.join(ids)}")
    for metric in ("makespan_s", "node_hours"):
        for key, policy in sweep.winners_by_mix(rows, metric).items():
            best = min(float(r[metric]) for r in rows
                       if r["policy"] == policy and
                       (r["trace"], r["rigid"], r["moldable"], r["malleable"],
                        r["evolving"], r["serving"]) == key)
            log("sw", f"mix {':'.join(f'{x:g}' for x in key[1:])}: winner "
                      f"by {metric} {policy} ({best:.6f})")
    return rows


def sw_churn_scenario():
    """The reference's golden capacity-churn scenario
    (tests/test_capacity.py::churn_scenario) on the port's classes."""
    from repro_torch.rms import AppModel, ClusterSimulator, Job, SimConfig
    apps = {
        "grow": AppModel("grow", iterations=600, t1_iter_s=2.0,
                         serial_frac=0.0, data_bytes=1 << 20, min_nodes=2,
                         max_nodes=8, preferred=8, check_period_s=5.0),
        "wall": AppModel("wall", iterations=100, t1_iter_s=6.0,
                         serial_frac=0.0, data_bytes=0, min_nodes=6,
                         max_nodes=6, preferred=None, check_period_s=0.0),
    }
    grower = Job(job_id=0, app="grow", submit_time=0.0, work=600.0,
                 min_nodes=2, max_nodes=8, preferred=8, malleable=True,
                 check_period_s=5.0, requested_nodes=2, data_bytes=1 << 20)
    wall = Job(job_id=1, app="wall", submit_time=8.0, work=100.0,
               min_nodes=6, max_nodes=6, preferred=None, malleable=False,
               requested_nodes=6)
    cfg = SimConfig(num_nodes=8, flexible=True, scheduling="async",
                    checkpoint_period_s=0.0, expand_timeout_s=500.0,
                    joins=((40.0, -1), (41.0, -1), (200.0, -1)),
                    drains=((80.0, 9), (120.0, 2), (160.0, 3)))
    return ClusterSimulator([grower, wall], cfg, apps=apps)


def sw_obs_golden():
    """The golden churn scenario under the port's TraceRecorder: the
    artifact's bytes and its decision-audit report must be the committed
    files'."""
    from repro_torch.obs import TraceRecorder, build_artifact, dumps_artifact
    from repro_torch.obs.report import ledger_total, render_report
    sim = sw_churn_scenario()
    rec = TraceRecorder(sim, meta={"scenario": "capacity-churn"}).install()
    report = sim.run()
    rec.finalize(report)
    doc = build_artifact(rec)
    if dumps_artifact(doc) != (DATA / "golden_obs_trace.json").read_bytes():
        raise AssertionError("the traced churn scenario's artifact differs "
                             "from tests/data/golden_obs_trace.json")
    if render_report(doc) != (DATA / "golden_obs_report.txt").read_text(
            encoding="utf-8"):
        raise AssertionError("the traced churn scenario's report differs "
                             "from tests/data/golden_obs_report.txt")
    if ledger_total(doc) != len(report.actions):
        raise AssertionError("the ledger does not account for every action")
    log("sw", f"traced churn scenario: {len(doc['spans'])} spans, "
              f"{ledger_total(doc)} actions in the ledger, byte-equal to "
              f"tests/data/golden_obs_trace.json; its report byte-equal to "
              f"tests/data/golden_obs_report.txt")


def sw_traced_point(point, trace_dir):
    """``point`` replayed under a TraceRecorder (the sweep's trace_dir):
    its row, its ledger's total, the action spans and the Chrome trace's
    events. Each action span is one ActionRecord; counted as the sweep
    counts actions, they must give the row's action columns."""
    from repro_torch.obs.report import ledger_total, load_artifact
    from repro_torch.rms import sweep
    row = sweep.run_point(dataclasses.replace(point, trace_dir=trace_dir))
    prefix = os.path.join(trace_dir, point.slug)
    doc = load_artifact(prefix + ".obs.json")
    actions = [s for s in doc["spans"]
               if s["kind"] in ("dmr", "capacity", "disruption")]
    counted = dict.fromkeys((*SW_ROW_ACTIONS.values(), "timeouts"), 0)
    for span in actions:
        col = ("timeouts" if span["args"].get("timed_out")
               else SW_ROW_ACTIONS.get(span["name"]))
        if col is not None:
            counted[col] += 1
    wrong = {c: (n, row[c]) for c, n in counted.items() if row[c] != n}
    if wrong:
        raise AssertionError(f"the traced point's action spans do not count "
                             f"its row's actions: {wrong}")
    with open(prefix + ".perfetto.json") as fh:
        events = len(json.load(fh)["traceEvents"])
    return {"row": row, "ledger": ledger_total(doc), "actions": len(actions),
            "events": events}


def sw_lint():
    """``python -m repro_torch.lint src/repro_torch --check`` in this
    process; a finding fails the phase. Returns (rules, files)."""
    from repro_torch.lint import REGISTRY
    from repro_torch.lint.cli import main as lint_main
    from repro_torch.lint.core import iter_files
    path = str(ROOT / "src" / "repro_torch")
    rc = lint_main([path, "--check"])
    if rc != 0:
        raise AssertionError(f"the port's lint exited {rc} (its findings "
                             f"above)")
    files = sum(1 for _ in iter_files([path]))
    log("sw", f"python -m repro_torch.lint src/repro_torch --check: no "
              f"finding, {len(REGISTRY)} rules over {files} files")
    return len(REGISTRY), files


def phase_sweep(artifact, card=None, workdir=SW_WORKDIR,
                calibration_out=SW_CALIBRATION):
    """(sw) The last modules of the JAX package in the port, host code whose
    one input from the card is (t)'s fit (``artifact``, or None when it
    raised FitError): the golden sweeps on a pool, the policy zoo under
    the card's cost model as two journaled shards merged, the golden obs
    trace and one traced zoo point, and the port's lint."""
    from repro_torch.rms import POLICY_REGISTRY, sweep
    t0 = time.perf_counter()
    workdir = Path(workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    sw_goldens()
    calibration = sw_calibration(artifact, calibration_out)
    rows = sw_zoo(calibration, workdir)
    sw_obs_golden()
    point = sweep.build_grid(
        [str(SAMPLE_SWF)], [sorted(POLICY_REGISTRY)[0]],
        sweep.parse_mixes(SW_ZOO_MIXES)[-1:], (True,), num_nodes=SW_ZOO_NODES,
        seed=SW_ZOO_SEED, calibration=calibration)[0]
    traced = sw_traced_point(point, str(workdir / "traces"))
    want = [r for r in rows if sweep.row_key(r) == sweep.row_key(
        traced["row"])]
    if want != [traced["row"]]:
        raise AssertionError("the traced zoo point's row differs from the "
                             "untraced one")
    if traced["ledger"] != traced["actions"]:
        raise AssertionError(f"the ledger holds {traced['ledger']} actions, "
                             f"the trace {traced['actions']}")
    log("sw", f"zoo point {point.slug} traced: its row equal to the untraced "
              f"row, {traced['ledger']} actions in the ledger, the row's "
              f"action columns counted from the spans; Chrome trace of "
              f"{traced['events']} events")
    rules, files = sw_lint()
    secs = time.perf_counter() - t0
    log("sw", f"{secs:.2f} s of host time (budget {SW_BUDGET_S:.0f} s"
              f"{'' if secs <= SW_BUDGET_S else ', exceeded'})"
              f"{'' if card is None else f', beside {card}'}")
    return {"calibration_id": rows[0]["calibration_id"],
            "zoo_points": len(rows), "lint_rules": rules,
            "lint_files": files, "events": traced["events"], "seconds": secs}


# -- (u)-(x) slice 9: gemma2, the MoE families, qwen3 and granite, and the --------
# compressed all-reduce

# the decoders whose fp32 weights at their published depth do not fit the
# card, and the two whose full-depth Servers took a minute of the run's time
# limit (qwen3-4b, granite-3-2b): (published depth, layers drawn at its
# scale and driven). Since slice 19, whose training paths (zt) take the
# time, qwen3 and granite are cut from 12 layers to 4 and the MoE models
# from 4 to 2 (at 4 their two paths took 71.0 s of a 1188.9 s run on an
# NVIDIA H100 80GB HBM3 at 700 W)
ZOO_CUT = {"gemma2-27b": (46, 4), "phi3.5-moe-42b-a6.6b": (32, 2),
           "deepseek-moe-16b": (28, 2), "qwen3-4b": (36, 4),
           "granite-3-2b": (40, 4)}
# MoE routing, card against CPU from the same fp32 input: their router
# logits differ by about 1e-5 (the attention's and the projections'
# rounding); a token whose chosen experts differ at a logit gap under
# NEAR_TIE is a near tie, reported with its probability gap, its tokens
# left out of that block's output comparison. A flip at a larger gap fails.
NEAR_TIE = 1e-3
# the compressed all-reduce: virtual slices of the card, and the steps of
# the error-feedback check (tests/test_multidevice.py:144)
COMPRESS_SLICES, COMPRESS_STEPS = (2, 4), 12
# what the child processes of (u)-(z) and of (mq) hand back (run_child)
ZOO_RESULT = ROOT / "build" / "chip_smoke_zoo.json"
RG_TRAIN_RESULT = ROOT / "build" / "chip_smoke_rg_train.json"
QWEN_TRAIN_RESULT = ROOT / "build" / "chip_smoke_qwen_train.json"


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


# -- (y), (z) slice 10: paligemma-3b's patch prefix, seamless-m4t-medium's ---------
# encoder-decoder

# paligemma-3b: its 256 patch embeddings (frontend_tokens) and the text
# after them in the prefill and in the decode check. seamless-m4t-medium:
# frames and prompt tokens of the prefill (the enc_dec split of seq_len
# 1024), and of the decode check, where 264 queries over 256 frames fit one
# chunk and the reference's cross attention attends every frame (ROADMAP.md,
# "Reference behaviour the port mirrors on purpose"); the fp32 train step's
# batch and its halves.
VLM_TEXT = 256
ENCDEC_S, ENCDEC_DECODE_S, ENCDEC_TRAIN = 512, 256, (2, 512)
# paligemma-3b's layers at the reference's init, drawn at its 18 layers'
# scale: its Server and step times at 18 layers took 10-16 s of the run
# (PERF.md), and all 18 train in (zt)
VLM_REF_LAYERS = 4


def phase_encdec_grads(label, cfg, params, batch):
    """(z) One fp32 train step of the encoder-decoder (loss.backward(), remat
    as configured) through the kernels (the forward with the log-sum-exp,
    the backward kernel: the encoder's and the cross attention's calls
    without a causal mask, the cross one at Sq != Sk where the batch says
    so) against attn_impl="chunked", from the same parameters and batch:
    the loss and every gradient leaf max-normalised at MODEL_TOL, with
    exactly the launches train_launches gives."""
    errs = held_train_step(label, cfg, params, batch)[1]
    worst = max(errs, key=errs.get)
    log(label, f"{cfg.name} fp32 train step B{batch['tokens'].shape[0]}, "
               f"{batch['frontend'].shape[1]} frames, "
               f"{batch['tokens'].shape[1]} tokens (remat {cfg.remat}, "
               f"{train_launches(cfg)} launches): through the kernels vs "
               f"chunked, max-normalised: loss {errs['loss']:.3e}, "
               f"{len(errs) - 1} gradient leaves, largest {worst} "
               f"{errs[worst]:.3e} (tol {MODEL_TOL})")


def drive_with_inputs(label, cfg, rng):
    """(y) paligemma-3b or (z) seamless-m4t-medium at its published widths
    and depth, twice, each from its own draw on the card, as drive_zoo:
    first each layer at its own fan-in, every check held: the prefill at
    B 4 through the kernel against the chunked path (fp32, and bf16 by its
    distance from fp32), exactly flash_per_pass launches a prefill;
    prefill + 8 decode steps against forward; for seamless one fp32 train
    step (phase_encdec_grads). Then at the reference's init, the fp32
    comparisons printed, with paligemma's Server (text, as the reference's)
    and the step times, paligemma cut to VLM_REF_LAYERS layers drawn at its
    depth's scale. Returns (launch counts, Server tok/s or None, peak
    GiB, the seconds of the draw at the reference's init)."""
    from repro_torch.data import DataConfig, SyntheticLMData
    encdec = cfg.family == "encdec"
    b, e = PREFILL_B, cfg.d_model

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).cuda()
    if encdec:
        s, ds = ENCDEC_S, ENCDEC_DECODE_S
        front, decode_front = randn(b, s, e), randn(b, ds, e)
    else:
        s = ds = VLM_TEXT
        front = decode_front = randn(b, cfg.frontend_tokens, e)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).cuda()
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (b, ds + 8))).cuda()

    def wrap(model):
        return WithInputs(model, front)

    def decode_wrap(model):
        return WithInputs(model, decode_front)
    torch.cuda.reset_peak_memory_stats()
    _, params = model_and_params(cfg, label, on_card=True, per_layer=True)
    phases = [
        lambda: phase_prefill(cfg, params, toks, label, wrap=wrap),
        lambda: phase_decode(label, cfg, params, seq, steps=8,
                             wrap=decode_wrap)]
    if encdec:
        rows, seq_len = ENCDEC_TRAIN
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=rows, frontend=cfg.frontend,
                          d_model=e, enc_dec=True)
        batch = {k: t.cuda() for k, t in SyntheticLMData(data).batch(0)
                 .items()}
        phases.append(lambda: phase_encdec_grads(label, cfg, params, batch))
    held, _ = drive(label, phases)
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    depth = None
    if not encdec:
        depth = cfg.num_layers
        cfg = dataclasses.replace(cfg, num_layers=VLM_REF_LAYERS)
    model, params = model_and_params(cfg, label, depth, on_card=True)
    phases = [
        lambda: phase_prefill(cfg, params, toks, label, hold=False,
                              wrap=wrap),
        lambda: phase_decode(label, cfg, params, seq, steps=8,
                             hold_fp32=False, wrap=decode_wrap)]
    if not encdec:
        phases.append(lambda: phase_server(label, model, params))
    counts, results = drive(label, phases)
    tok_s = None if encdec else results[-1]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(label, f"{cfg.name}: peak device memory {peak:.2f} GiB")
    counts = {k: held[k] + counts[k] for k in counts}
    if counts["flash_attention"] == 0 or \
            (encdec and counts["flash_attention_bwd"] == 0):
        raise AssertionError(f"{cfg.name}'s path never launched the flash "
                             "kernels")
    phase_step_times(cfg, params, toks, wrap=wrap)
    ref_s = time.perf_counter() - t0
    log(label, f"{cfg.name} at the reference's init ({cfg.num_layers} "
               f"layers), its path and step times in {ref_s:.1f} s")
    return counts, tok_s, peak, ref_s


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


def phase_step_times(cfg, params, toks, wrap=bare):
    """End to end: one full-width bf16 prefill (for attention models through
    the kernel and through the chunked path) and one batch-4 decode step;
    for each, the card's busy time under the profiler against the
    unprofiled wall time. ``wrap`` binds a model's modality input."""
    from repro_torch.kernels.bench import device_profile, eager_ms
    from repro_torch.models import build_model
    s = toks.shape[1]
    steps = {}
    impls = ("auto", "chunked") if "global" in cfg.pattern else ("auto",)
    for impl in impls:
        model = wrap(build_model(dataclasses.replace(cfg, attn_impl=impl)))
        name = f"prefill B{toks.shape[0]} S{s}{getattr(model, 'note', '')}" \
            + (f" attn_impl={impl}" if len(impls) > 1 else "")
        steps[name] = lambda m=model: m.prefill(params, toks, max_len=s + 1)
    _, cache = model.prefill(params, toks, max_len=s + 1)
    pos = s + getattr(model, "nf", 0)     # after paligemma's patches
    steps[f"decode_step B{toks.shape[0]} at pos {pos}"] = (
        lambda: model.decode_step(params, cache, toks[:, -1:], s))
    for name, fn in steps.items():
        wall = eager_ms(fn, iters=5)
        prof = device_profile(fn, what=f"{cfg.name} {name}")
        log("k", f"{cfg.name} bf16 {name}: {wall:.3f} ms wall; card busy "
                 f"{prof['busy_ms']:.3f} ms in {prof['launches']} kernels "
                 f"and copies ({100 * (1 - prof['busy_ms'] / wall):.1f}% "
                 f"idle); top: " + "; ".join(
                     f"{k} {ms:.3f} ms x{n}" for k, ms, n in prof["top"]))


def build_kernels():
    """(b) nvcc on every kernel source at once; print ptxas's registers and
    spills."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.reshard import kernel as box
    from repro_torch.kernels.rglru import kernel as rglru
    from repro_torch.kernels.ssd import kernel as ssd
    kernels = (("flash_attention", flash.load),
               ("flash_attention_bwd", flash.load_bwd),
               ("ssd_scan", ssd.load), ("ssd_scan_bwd", ssd.load_bwd),
               ("rglru_scan and rglru_scan_bwd", rglru.load),
               ("box_copy", box.load))
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
    fan-in (at_per_layer_fan_in of that draw). An encoder-decoder is drawn
    at its own depth; ``per_layer`` rescales both of its stacks."""
    from repro_torch.models import CausalLM
    from repro_torch.models.layers import (init_from_specs, torch_dtype,
                                           tree_map)
    cfg = model.cfg
    specs = model.specs()
    if isinstance(model, CausalLM):
        reps = model._pattern_layout()[0]
        full = CausalLM(dataclasses.replace(cfg, num_layers=depth),
                        model.device)._pattern_layout()[0]
        stacks = {"blocks": (reps, full)}
    else:
        stacks = {key: (specs[key]["ln1"].shape[0],) * 2
                  for key in ("enc_blocks", "dec_blocks")}
    for key, (reps, full) in stacks.items():
        def scale(sp, reps=reps, full=full):
            if sp.init != "normal":
                return sp
            at = (full / layer_fan_in(sp)) ** 0.5 if per_layer else 1.0
            return dataclasses.replace(
                sp, scale=sp.scale * (reps / full) ** 0.5 * at)
        specs[key] = tree_map(scale, specs[key])
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
    if cfg.enc_layers:
        depth = f" (and {cfg.enc_layers} encoder layers)" + depth
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


def held_library(rows, tol):
    """Raises where the library call of a flash row, flex_attention's where
    a softcap is on, parts from the plain version by more than ``tol``
    (``library_err``, max-normalised): its time would not be that of the
    kernel's function."""
    for label, row in rows.items():
        if row.get("library_err", 0.0) > tol:
            raise AssertionError(f"{label}: the library call parts from the "
                                 f"plain version by {row['library_err']:.3e}"
                                 f" (tol {tol})")


def zt_path(arch, result):
    """The name of ``arch``'s training path (zt) in launches_by_path, with
    the flash routes it put on a main path."""
    routes = {"gemma2-27b": "D 128 with softcap 50, window 4096 in the "
                            "local layer, none in the global",
              "paligemma-3b": "bf16 D 256 without a window, GQA 8:1",
              "phi3.5-moe-42b-a6.6b": "D 128, GQA 4:1, under a MoE",
              "granite-3-2b": "D 64, GQA 4:1",
              "seamless-m4t-medium": "D 64 at S 2048: the encoder's and the "
                                     "cross attention without a causal "
                                     "mask, the decoder's causal"}[arch]
    return f"{arch} training, {result['layers']} layers ({routes})"


def zt_record_row(name, row, label, result, err, timed):
    """A kernel row at one of ZT_ROWS, its launches those of the path
    ``result`` (main_zoo_train's), the shape from bench's tables."""
    from repro_torch.kernels import bench
    b, h, kv, sq, sk, d, _, causal, window, softcap = bench.bwd_call(label)
    options = "".join((f", window {window}" if window else "",
                       f", softcap {softcap:g}" if softcap else ""))
    what = ("dq / dk / dv from the forward's lse"
            if name == "flash_attention_bwd" else "the forward's output")
    length = f"S{sq}" if sq == sk else f"Sq{sq} Sk{sk}"
    mask = "causal" if causal else "non-causal"
    out = record_row(name, row["source"], row["replaces"],
                     result["counts"][name], err, timed,
                     f"B{b} H{h} KV{kv} {length} D{d} bf16 {mask}{options}, "
                     f"(B, S, H, D) views, {what}")
    out["library_backend"] = timed["library_backend"]
    if "library_err" in timed:
        out["library_err"] = timed["library_err"]
    if label in ZT_CALLS:
        out["calls"] = ZT_CALLS[label]
    return out


def main_zoo():
    """(u)-(x), run by ``chip_smoke.py --zoo`` in a process of its own (see
    run_child): each decoder of slice 9 at its published widths, its depth
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
            # every layer driven, one shorter row (the CPU's share)
            def blocks_of(cfg, params, z_toks=z_toks):
                return cfg, params, z_toks[:1, :128], 128 + 8
        t0 = time.perf_counter()
        counts, tok_s, peak = drive_zoo(label, cfg, depth, z_toks,
                                        blocks_of, long_toks)
        zoo[arch] = {"counts": counts, "tok_s": tok_s, "peak": peak,
                     "seconds": time.perf_counter() - t0}
        log(label, f"{arch} ({cfg.num_layers} layers): both draws' paths "
                   f"in {zoo[arch]['seconds']:.1f} s")
        torch.cuda.empty_cache()
    phase_compression()
    for arch, label in (("paligemma-3b", "y"), ("seamless-m4t-medium", "z")):
        counts, tok_s, peak, ref_s = drive_with_inputs(
            label, get_config(arch), rng)
        zoo[arch] = {"counts": counts, "tok_s": tok_s, "peak": peak,
                     "ref_seconds": ref_s}
        torch.cuda.empty_cache()
    ZOO_RESULT.parent.mkdir(parents=True, exist_ok=True)
    ZOO_RESULT.write_text(json.dumps(zoo))
    return 0



def predict_cell(label, cfg, batch, seq, opt_cfg, remats, ways=1):
    """The dry-run's count (repro_torch.launch.dryrun, on the meta device in
    this process, touching no card) of ``cfg``'s train step at B ``batch``,
    S ``seq`` on one card under each of ``remats`` (None: cfg's own), as the
    trainer runs it: replicated parameters, one micro-batch, ``opt_cfg``;
    at ``ways`` > 1 in the layout one card runs with tensor parallelism, a
    (1, ways) mesh of virtual devices, the count one coordinate's share.
    Returns {remat: the dry-run's record}."""
    from repro_torch.core import TP_DP_RULES
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.shapes import ShapeSpec
    out = {}
    for remat in remats:
        overrides = {"num_layers": cfg.num_layers, "ce_chunk": cfg.ce_chunk,
                     "remat": remat or cfg.remat}
        t0 = time.perf_counter()
        rec = run_cell(cfg.name, ShapeSpec(f"{label}-cut", seq, batch,
                                           "train"),
                       "h100x1" if ways == 1 else (1, ways), None,
                       verbose=False, rules=TP_DP_RULES,
                       cfg_overrides=overrides, accum=1, opt_cfg=opt_cfg)
        if rec["status"] != "ok":
            raise AssertionError(f"the dry-run could not count {cfg.name}: "
                                 f"{rec.get('error')}")
        rl, cost, mem = rec["roofline"], rec["cost"], rec["memory"]
        where = "on one card" if ways == 1 else \
            f"a coordinate's share at model_ways {ways}"
        log(label, f"dry-run of {cfg.name} ({cfg.num_layers} layers, remat "
                   f"{overrides['remat']}) B{batch} S{seq} {where} "
                   f"(meta, {time.perf_counter() - t0:.1f} s): predicted "
                   f"one-step peak {mem['peak_bytes'] / 2 ** 30:.2f} GiB "
                   f"(TrainState {mem['argument_size_in_bytes'] / 2 ** 30:.2f}"
                   f" GiB), {cost['flops']:.4e} FLOPs, {cost['bytes']:.4e} "
                   f"HBM bytes in {cost['ops']} ops; compute "
                   f"{rl['compute_s'] * 1e3:.1f} ms, memory "
                   f"{rl['memory_s'] * 1e3:.1f} ms, step "
                   f"{rl['step_s'] * 1e3:.1f} ms ({rl['dominant']}); model "
                   f"FLOPs {rl['model_flops']:.4e}; kernel ops "
                   f"{cost['kernel_calls']}; collectives "
                   f"{rec['collectives']}")
        out[remat] = rec
    return out


def hold_prediction(label, name, rec, peak_gib, busy_ms, ways=1):
    """Print the dry-run's prediction ``rec`` beside the measured one-step
    peak and card busy time, with the step's MFU (model FLOPs over busy
    time at the bf16 peak) and the card's memory beside the HBM constant;
    fail when the peak is off by more than PEAK_MARGIN or the busy time is
    below the predicted compute time (FLOPs at the peak rate bound it).
    ``ways`` > 1: ``rec`` is one coordinate's share of a step whose
    ``ways`` coordinates all ran on this card, so the prediction is
    ``ways`` times the share's peak and compute time."""
    from repro_torch.roofline.hardware import HBM_BYTES, PEAK_BF16_FLOPS
    rl = dict(rec["roofline"])
    for k in ("compute_s", "memory_s", "step_s"):
        rl[k] *= ways
    predicted = ways * rec["memory"]["peak_bytes"] / 2 ** 30
    off = predicted / peak_gib - 1
    mfu = rl["model_flops"] / (busy_ms / 1e3 * PEAK_BF16_FLOPS)
    total = torch.cuda.get_device_properties(0).total_memory
    log(label, f"{name}: one-step peak predicted {predicted:.2f} GiB, "
               f"measured {peak_gib:.2f} GiB ({100 * off:+.2f}%, margin "
               f"{100 * PEAK_MARGIN:.0f}%); predicted compute "
               f"{rl['compute_s'] * 1e3:.1f} ms, memory "
               f"{rl['memory_s'] * 1e3:.1f} ms, step "
               f"{rl['step_s'] * 1e3:.1f} ms, measured busy {busy_ms:.3f} ms "
               f"({busy_ms / (rl['step_s'] * 1e3):.2f}x the step term); MFU "
               f"{mfu:.4f} ({rl['model_flops']:.4e} model FLOPs / (busy x "
               f"{PEAK_BF16_FLOPS:.3g} FLOP/s)); the card's total_memory "
               f"{total} bytes ({total / 2 ** 30:.2f} GiB) beside HBM_BYTES "
               f"{HBM_BYTES:.3g}")
    if abs(off) > PEAK_MARGIN:
        raise AssertionError(f"{name}: predicted peak {predicted:.2f} GiB "
                             f"is off the measured {peak_gib:.2f} GiB by "
                             f"more than {PEAK_MARGIN:.0%}")
    if busy_ms / 1e3 < rl["compute_s"]:
        raise AssertionError(f"{name}: busy {busy_ms:.3f} ms below the "
                             f"predicted compute time "
                             f"{rl['compute_s'] * 1e3:.3f} ms")
    return {"predicted_gib": predicted, "measured_gib": peak_gib,
            "busy_ms": busy_ms, "compute_ms": rl["compute_s"] * 1e3,
            "memory_ms": rl["memory_s"] * 1e3, "mfu": mfu}


def main_rg_train():
    """(mq), run by ``chip_smoke.py --rg-train`` in a process of its own
    (run_child), with the card to itself: recurrentgemma-9b's training at
    full width, its first unit and 2-layer tail (RG_TRAIN_LAYERS), drawn on
    the card at each layer's own fan-in (as the 38-layer model's layers
    would be, rescaled), B 1, S RG_TRAIN_S, the loss by ce_chunk. One fp32
    train step through the RG-LRU and flash (D 256, window 2048) kernels
    against the plain paths, then RG_TRAIN_STEPS bf16 ElasticTrainer
    steps, then the step's times. Writes the path's launch counts and peak
    GiB to RG_TRAIN_RESULT. Before any step, the dry-run counts the same
    cell (predict_cell); after the bf16 steps, one step's peak (the
    allocator's peak reset, the TrainState held) and its busy time are held
    against that count (hold_prediction)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.optim import AdamWConfig
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              num_layers=RG_TRAIN_LAYERS, ce_chunk=1024)
    predicted = predict_cell("mq", cfg, 1, RG_TRAIN_S, AdamWConfig(
        lr=RG_TRAIN_LR, warmup_steps=1, total_steps=RG_TRAIN_STEPS),
        (None,))[None]
    _, params = model_and_params(cfg, "mq", init_depth=RG_DEPTH,
                                 on_card=True, per_layer=True)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=RG_TRAIN_S,
                      global_batch=1)
    batch = {k: t.cuda() for k, t in SyntheticLMData(data).batch(0).items()}
    counts, (_, trained) = drive("mq", (
        lambda: phase_scan_train_fp32("mq", cfg, params, batch),
        lambda: phase_train_bf16(cfg, params, data, RG_TRAIN_STEPS,
                                 label="mq", lr=RG_TRAIN_LR)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("flash_attention", "flash_attention_bwd", "rglru_scan",
                 "rglru_scan_bwd"):
        if counts[name] == 0:
            raise AssertionError(f"recurrentgemma's training path never "
                                 f"launched {name}")
    del params
    trainer, state, next_batch = trained
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(state, next_batch)
    torch.cuda.synchronize()
    one_step = torch.cuda.max_memory_allocated() / 2 ** 30
    log("mq", f"{cfg.name}: peak device memory {one_step:.2f} GiB in a step "
              f"(the TrainState held)")
    _, busy = step_times({(cfg.name, 1): (cfg, data, 1, lambda: trainer
                                          .train_step(state, next_batch))})
    held = hold_prediction("mq", f"{cfg.name} ({cfg.num_layers} layers)",
                           predicted, one_step, busy[cfg.name, 1][0])
    RG_TRAIN_RESULT.parent.mkdir(parents=True, exist_ok=True)
    RG_TRAIN_RESULT.write_text(json.dumps({"counts": counts, "peak": peak,
                                           "prediction": held}))
    return 0


def phase_remat_train_fp32(cfg, params, batch):
    """(wq) One fp32 train step (loss.backward()) of ``cfg`` through the
    flash kernels (forward with the log-sum-exp, backward; D 128, GQA
    32 / 8) under remat "dots" and under "nothing_saveable", and through
    attn_impl="chunked" under "dots", from the same parameters (each layer
    at its own fan-in) and batch: the kernels against the chunked path and
    "dots" against "nothing_saveable", the loss and every gradient leaf
    max-normalised at MODEL_TOL. Each kernel step launches one backward
    flash kernel a layer and one forward a layer under "dots", whose
    selective checkpoint keeps the forward's output and log-sum-exp (12 +
    12), and two under "nothing_saveable", where the backward pass runs the
    layer's unit again (24 + 12)."""
    dots = dataclasses.replace(cfg, remat="dots")
    want = {remat: {"flash_attention": times * cfg.num_layers,
                    "flash_attention_bwd": cfg.num_layers}
            for remat, times in (("dots", 1), ("nothing_saveable", 2))}
    for remat, counts in want.items():
        got = train_launches(dataclasses.replace(cfg, remat=remat))
        if {k: got[k] for k in counts} != counts:
            raise AssertionError(f"train_launches under {remat}: {got}")
    kernel, held = held_train_step("wq", dots, params, batch)
    other = grad_errs(train_grads(cfg, params, batch,
                                  want["nothing_saveable"],
                                  remat="nothing_saveable"), kernel)
    shape = f"B{batch['tokens'].shape[0]} S{batch['tokens'].shape[1]}"
    for name, errs in (("through the kernels vs chunked", held),
                       ('"dots" vs "nothing_saveable" through the kernels',
                        other)):
        top = max(errs, key=errs.get)
        log("wq", f"{cfg.name} ({cfg.num_layers} layers) fp32 train step "
                  f"{shape} ({want} launches a step), each layer at its own "
                  f"fan-in: loss {kernel[0].item():.6f}; {name}, "
                  f"max-normalised, loss {errs['loss']:.3e}, largest leaf "
                  f"{top} {errs[top]:.3e} over {len(errs) - 1} leaves (tol "
                  f"{MODEL_TOL})")
    if max(other.values()) > MODEL_TOL:
        raise AssertionError("qwen3's fp32 train step disagrees between "
                             "the remats")


def phase_remat_step_times(cfg, trainer, state, batch, data_cfg):
    """(wq) The bf16 train step of ``trainer``'s model under remat "dots"
    and under "nothing_saveable", from one state and batch, in this one
    process: the peak device memory of each (one step after the allocator's
    peak is reset, the TrainState held), then step_times' wall, busy and
    tokens/s of both in one profiler session. Returns {remat: {"wall_ms",
    "busy_ms", "peak_gib"}}."""
    from repro_torch.models import build_model
    from repro_torch.runtime import ElasticTrainer
    entries, peaks = {}, {}
    for remat in ("dots", "nothing_saveable"):
        c = dataclasses.replace(cfg, remat=remat)
        tr = trainer if remat == trainer.model.cfg.remat else ElasticTrainer(
            build_model(c), trainer.opt_cfg, trainer.data, trainer.cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr.train_step(state, batch)
        torch.cuda.synchronize()
        peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 30
        log("wq", f"{cfg.name} remat {remat}: peak device memory "
                  f"{peaks[remat]:.2f} GiB in a step (the TrainState held)")
        entries[f"{cfg.name} remat {remat}", 1] = (
            c, data_cfg, 1, lambda tr=tr: tr.train_step(state, batch))
    walls, busy = step_times(entries)
    return {remat: {"wall_ms": walls[key], "busy_ms": busy[key][0],
                    "peak_gib": peaks[remat]}
            for remat, key in zip(peaks, entries)}


def main_qwen_train():
    """(wq), run by ``chip_smoke.py --qwen-train`` in a process of its own
    (run_child), with the card to itself: qwen3-4b's training at its
    published widths, cut to QWEN_TRAIN_LAYERS layers, drawn on the card at
    each layer's own fan-in (as the 36-layer model's layers would be,
    rescaled), the loss by ce_chunk: one fp32 step at B 1, S QWEN_FP32_S
    under both remats against the chunked path (phase_remat_train_fp32),
    then QWEN_TRAIN_STEPS bf16 ElasticTrainer steps at B QWEN_TRAIN_B, S
    QWEN_TRAIN_S under "dots", the loss falling (the flash backward's bf16
    route at D 128 on a main path), then the step's times and peak memory
    under both remats. Writes the path's launch counts and peak GiB to
    QWEN_TRAIN_RESULT. Before any step, the dry-run counts the bf16 cell
    under both remats (predict_cell); their one-step peaks and busy times
    are held against the counts (hold_prediction)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.optim import AdamWConfig
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("qwen3-4b"),
                              num_layers=QWEN_TRAIN_LAYERS,
                              ce_chunk=QWEN_CE_CHUNK, remat="dots")
    predicted = predict_cell("wq", cfg, QWEN_TRAIN_B, QWEN_TRAIN_S,
                             AdamWConfig(lr=QWEN_TRAIN_LR, warmup_steps=1,
                                         total_steps=QWEN_TRAIN_STEPS),
                             ("dots", "nothing_saveable"))
    _, params = model_and_params(cfg, "wq", init_depth=QWEN_DEPTH,
                                 on_card=True, per_layer=True)
    one = DataConfig(vocab_size=cfg.vocab_size, seq_len=QWEN_FP32_S,
                     global_batch=1)
    batch = {k: t.cuda() for k, t in SyntheticLMData(one).batch(0).items()}
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=QWEN_TRAIN_S,
                      global_batch=QWEN_TRAIN_B)
    torch.cuda.reset_peak_memory_stats()
    counts, (_, trained) = drive("wq", (
        lambda: phase_remat_train_fp32(cfg, params, batch),
        lambda: phase_train_bf16(cfg, params, data, QWEN_TRAIN_STEPS,
                                 label="wq", lr=QWEN_TRAIN_LR)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("flash_attention", "flash_attention_bwd"):
        if counts[name] == 0:
            raise AssertionError(f"qwen3's training path never launched "
                                 f"{name}")
    del params
    trainer, state, next_batch = trained
    times = phase_remat_step_times(cfg, trainer, state, next_batch, data)
    for remat, t in times.items():
        t["prediction"] = hold_prediction(
            "wq", f"{cfg.name} ({cfg.num_layers} layers) remat {remat}",
            predicted[remat], t["peak_gib"], t["busy_ms"])
    QWEN_TRAIN_RESULT.parent.mkdir(parents=True, exist_ok=True)
    QWEN_TRAIN_RESULT.write_text(json.dumps({"counts": counts, "peak": peak,
                                             "times": times}))
    return 0


# -- (tp) qwen3-4b with tensor parallelism inside a slice ----------------------------

# qwen3-4b's model_ways in the fp32 check and the step times (the bf16 loop
# runs at the first); bf16 steps; the child's result
QWEN_TP_WAYS, QWEN_TP_STEPS = (2, 4), 4
TP_RESULT = ROOT / "build" / "chip_smoke_tp.json"


def coordinate_views(model, params, mesh):
    """One tree per model coordinate of ``mesh``'s first slice: views of
    ``params``' leaves on the coordinate's block over the model axis
    (TP_DP_RULES), so that autograd adds the coordinates' gradients of a
    leaf into the whole leaf, the blocks every coordinate holds whole
    summed."""
    from repro_torch.core import TP_DP_RULES
    from repro_torch.core import tensor_parallel as tp
    from repro_torch.models.layers import tree_map
    sh = tree_map(lambda lg, spec: TP_DP_RULES.sharding_for(
        lg, spec.shape, mesh), model.logical(), model.specs())
    return [tree_map(lambda x, s, c=c: x[tp.model_spec(s).index(x.shape, c)],
                     params, sh) for c in tp.slices_of(mesh)[0]]


def phase_tp_fp32(cfg, params, batch):
    """(tp) One fp32 train step of ``cfg`` (remat "dots") at model_ways 2
    and 4 against model_ways 1, from the same parameters (each layer at its
    own fan-in) and batch: the loss and every gradient, put together from
    the coordinates' blocks, max-normalised at MODEL_TOL. Under "dots" a
    step launches one flash forward and one backward a layer and
    coordinate, on its H / M query and KV / M heads."""
    per = {"flash_attention": cfg.num_layers,
           "flash_attention_bwd": cfg.num_layers}
    base = train_grads(cfg, params, batch, per)
    shape = f"B{batch['tokens'].shape[0]} S{batch['tokens'].shape[1]}"
    worst = {}
    for ways in QWEN_TP_WAYS:
        want = {k: ways * n for k, n in per.items()}
        got = train_grads(cfg, params, batch, want, ways=ways)
        errs = grad_errs(got, base)
        finite = all(torch.isfinite(g).all() for g in got[1].values())
        del got
        top = max(errs, key=errs.get)
        worst[ways] = errs[top] if finite else float("inf")
        log("tp", f"{cfg.name} ({cfg.num_layers} layers) fp32 train step "
                  f"{shape} at model_ways {ways} ({want} launches, H "
                  f"{cfg.num_heads // ways} KV {cfg.num_kv_heads // ways} a "
                  f"coordinate) against 1: loss {base[0].item():.6f}, "
                  f"max-normalised {errs['loss']:.3e}; largest leaf {top} "
                  f"{errs[top]:.3e} over {len(errs) - 1} leaves (tol "
                  f"{MODEL_TOL})")
    if max(worst.values()) > MODEL_TOL:
        raise AssertionError("qwen3's fp32 step under tensor parallelism "
                             "disagrees with one model way")
    return worst


def phase_tp_bf16(cfg, params, data_cfg):
    """(tp) QWEN_TP_STEPS bf16 ElasticTrainer steps of ``cfg`` at model_ways
    QWEN_TP_WAYS[0] on as many virtual devices of the card: every loss
    finite, the last below the first, exactly M x layers flash forward and
    backward launches a step. Returns (the trainer, its TrainState put
    together whole on the card, the next batch, the losses)."""
    from repro_torch.core import gather, slice_devices
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import ElasticTrainer, TrainerConfig
    ways = QWEN_TP_WAYS[0]
    tr = ElasticTrainer(
        build_model(cfg), AdamWConfig(lr=QWEN_TRAIN_LR, warmup_steps=1,
                                      total_steps=QWEN_TP_STEPS),
        data_cfg, TrainerConfig(steps=QWEN_TP_STEPS, log_period=1,
                                model_ways=ways),
        devices=slice_devices(ways))
    per_step = {"flash_attention": ways * cfg.num_layers,
                "flash_attention_bwd": ways * cfg.num_layers}
    t0 = time.perf_counter()
    state = counted_launches(
        lambda: tr.train(state=tr.init_state(params=params)),
        {k: QWEN_TP_STEPS * n for k, n in per_step.items()})
    seconds = time.perf_counter() - t0
    losses = [m["loss"] for m in tr.metrics]
    log("tp", f"{cfg.name} ({cfg.num_layers} layers) bf16 ElasticTrainer at "
              f"model_ways {ways} (mesh {tr.mesh.shape}), {QWEN_TP_STEPS} "
              f"steps B{data_cfg.global_batch} S{data_cfg.seq_len}, lr "
              f"{QWEN_TRAIN_LR}, in {seconds:.1f} s ({per_step} launches a "
              f"step); losses " + ", ".join(f"{x:.4f}" for x in losses))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            int(state["step"]) != QWEN_TP_STEPS:
        raise AssertionError("bf16 training at model_ways 2 did not bring "
                             "the loss down")
    whole = tree_map(gather, state)
    return tr, whole, tr.data.batch(QWEN_TP_STEPS), losses


def view_state(whole, shardings):
    """A TrainState laid out by ``shardings`` whose blocks are views of the
    whole tensors ``whole``: the layouts of several model_ways share one
    state's memory (a step reads its state and writes a new one)."""
    from repro_torch.core import ShardedTensor
    from repro_torch.models.layers import tree_map
    return tree_map(lambda x, sh: ShardedTensor(x.shape, x.dtype, sh, {
        c: x[sh.index(x.shape, c)] for c in sh.mesh.coords()}),
        whole, shardings)


def phase_tp_step_times(cfg, trainer, whole, batch, data_cfg, label="tp"):
    """(tp), (tk) The bf16 train step of ``trainer``'s model at model_ways
    1, 2 and 4 from one TrainState (view_state of ``whole``) and batch:
    each one's launches (M x train_launches: qwen3's M x layers flash
    forwards and backwards) and one-step peak device memory (the
    allocator's peak reset, the state held), then step_times' wall, busy
    and tokens/s of the three in one profiler session, with the share of
    busy time in on-card copies (Memcpy DtoD: the copies of each
    all-reduce's sum and of the gathers). Returns {M: {...}}."""
    from repro_torch.core import slice_devices
    from repro_torch.runtime import ElasticTrainer, TrainerConfig
    entries, peaks = {}, {}
    per = {k: n for k, n in train_launches(cfg).items() if n}
    for ways in (1, *QWEN_TP_WAYS):
        tr = ElasticTrainer(trainer.model, trainer.opt_cfg, trainer.data,
                            TrainerConfig(model_ways=ways),
                            devices=slice_devices(ways))
        st = view_state(whole, tr._state_shardings(tr.mesh))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counted_launches(lambda: tr.train_step(st, batch),
                         {k: ways * n for k, n in per.items()})
        peaks[ways] = torch.cuda.max_memory_allocated() / 2 ** 30
        key = f"{cfg.name} model_ways {ways}", 1
        entries[key] = (cfg, data_cfg, 1,
                        lambda tr=tr, st=st: tr.train_step(st, batch))
    walls, busy = step_times(entries)
    tokens = data_cfg.global_batch * data_cfg.seq_len
    out = {}
    for ways, key in zip(peaks, entries):
        ms, launches, _, table = busy[key]
        dtod = sum(v[0] for k, v in table.items()
                   if k.startswith("Memcpy DtoD"))
        out[ways] = {"wall_ms": walls[key], "busy_ms": ms,
                     "tok_s": tokens / walls[key] * 1e3,
                     "peak_gib": peaks[ways], "launches": launches,
                     "dtod_ms": dtod}
        log(label, f"{cfg.name} ({cfg.num_layers} layers) bf16 B"
                   f"{data_cfg.global_batch} S{data_cfg.seq_len} at "
                   f"model_ways {ways}: {walls[key]:.3f} ms wall, "
                   f"{ms:.3f} ms busy in {launches} kernels and copies "
                   f"({100 * (1 - ms / walls[key]):.1f}% idle), "
                   f"{out[ways]['tok_s']:.0f} tokens/s, on-card copies "
                   f"{dtod:.3f} ms ({100 * dtod / ms:.2f}% of busy), peak "
                   f"{peaks[ways]:.2f} GiB in a step")
    return out


def main_tp():
    """(tp), run by ``chip_smoke.py --tp`` in a process of its own
    (run_child), with the card to itself: qwen3-4b at its published
    widths, cut to TP_LAYERS layers, each layer at its own
    fan-in, remat "dots", the loss by ce_chunk, with tensor parallelism
    inside a slice on virtual devices of the card: one fp32 step at B 1, S
    QWEN_FP32_S at model_ways 2 and 4 against 1 (phase_tp_fp32), then
    QWEN_TP_STEPS bf16 ElasticTrainer steps at B QWEN_TRAIN_B, S
    QWEN_TRAIN_S at model_ways 2, the loss falling (phase_tp_bf16), then
    the step's times and peaks at 1, 2 and 4 (phase_tp_step_times). Before
    any step, the dry-run counts the bf16 step at model_ways 2 and 4 in
    the layout it runs here (predict_cell); each one's peak and busy time
    are held against M times a coordinate's count (hold_prediction).
    Writes the path's launch counts and the numbers to TP_RESULT."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=TP_LAYERS,
                              ce_chunk=QWEN_CE_CHUNK, remat="dots")
    t0 = time.perf_counter()
    opt = AdamWConfig(lr=QWEN_TRAIN_LR, warmup_steps=1,
                      total_steps=QWEN_TP_STEPS)
    predicted = {ways: predict_cell("tp", cfg, QWEN_TRAIN_B, QWEN_TRAIN_S,
                                    opt, ("dots",), ways=ways)["dots"]
                 for ways in QWEN_TP_WAYS}
    log("tp", f"the dry-run's counts at model_ways {QWEN_TP_WAYS} in "
              f"{time.perf_counter() - t0:.1f} s")
    _, params = model_and_params(cfg, "tp", init_depth=QWEN_DEPTH,
                                 on_card=True, per_layer=True)
    one = DataConfig(vocab_size=cfg.vocab_size, seq_len=QWEN_FP32_S,
                     global_batch=1)
    batch = {k: t.cuda() for k, t in SyntheticLMData(one).batch(0).items()}
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=QWEN_TRAIN_S,
                      global_batch=QWEN_TRAIN_B)
    counts, (fp32, trained) = drive("tp", (
        lambda: phase_tp_fp32(cfg, params, batch),
        lambda: phase_tp_bf16(cfg, params, data)))
    for name in ("flash_attention", "flash_attention_bwd"):
        if counts[name] == 0:
            raise AssertionError(f"qwen3's path under tensor parallelism "
                                 f"never launched {name}")
    del params
    trainer, whole, next_batch, losses = trained
    del trained
    times = phase_tp_step_times(cfg, trainer, whole, next_batch, data)
    for ways, rec in predicted.items():
        times[ways]["prediction"] = hold_prediction(
            "tp", f"{cfg.name} ({cfg.num_layers} layers) remat dots at "
                  f"model_ways {ways}", rec, times[ways]["peak_gib"],
            times[ways]["busy_ms"], ways=ways)
    TP_RESULT.parent.mkdir(parents=True, exist_ok=True)
    TP_RESULT.write_text(json.dumps({"counts": counts, "fp32": fp32,
                                     "losses": losses, "times": times}))
    return 0


# -- (tk) tensor parallelism for the SSD, RG-LRU, MoE and encoder-decoder blocks

TP_KINDS_RESULT = ROOT / "build" / "chip_smoke_tp_kinds.json"
# recurrentgemma-9b cut to one pattern unit (rglru, rglru, local), and
# deepseek-moe-16b to its dense first layer and two MoE layers; the bf16
# ElasticTrainer steps at model_ways 2 and their learning rate; deepseek's
# batch (B, S)
TPK_RG_LAYERS, TPK_DS_LAYERS, TPK_STEPS, TPK_LR = 3, 3, 4, 1e-3
TPK_MOE_B, TPK_MOE_S = 2, 1024
# seamless-m4t-medium's bf16 steps in (tk): B 2 rows of 2048 frames and 2048
# tokens (the zt row's at a quarter of its batch)
TPK_ENCDEC_TRAIN = (2, 4096)


@contextlib.contextmanager
def launch_shapes():
    """What each kernel op the models call sees, by op: the SSD scan's
    heads, the RG-LRU scan's width, the flash kernel's (query, KV) heads
    and head_dim. Yields {op: set}."""
    from repro_torch.models import attention, rglru, ssm
    seen = {"ssd_scan": set(), "rglru_scan": set(), "flash_attention": set()}
    kept = ssm.ssd_op, rglru.rglru_op, attention.flash_attention_op

    def ssd(x, *args, **kw):
        seen["ssd_scan"].add(x.shape[2])
        return kept[0](x, *args, **kw)

    def rg(a, b, *args, **kw):
        seen["rglru_scan"].add(a.shape[-1])
        return kept[1](a, b, *args, **kw)

    def flash(q, k, v, **kw):
        seen["flash_attention"].add((q.shape[1], k.shape[1], q.shape[-1]))
        return kept[2](q, k, v, **kw)
    ssm.ssd_op, rglru.rglru_op, attention.flash_attention_op = ssd, rg, flash
    try:
        yield seen
    finally:
        ssm.ssd_op, rglru.rglru_op, attention.flash_attention_op = kept


def tp_shares(cfg, ways):
    """The shares launch_shapes should see at ``ways`` model coordinates:
    H / M SSD heads, W / M RG-LRU channels, H / M query heads over KV / M
    KV heads (the KV heads whole where they do not divide)."""
    out = {"ssd_scan": set(), "rglru_scan": set(), "flash_attention": set()}
    kinds = set(cfg.pattern) | ({"global"} if cfg.enc_layers else set())
    if "ssd" in kinds:
        out["ssd_scan"].add(cfg.ssm_heads // ways)
    if "rglru" in kinds:
        out["rglru_scan"].add((cfg.lru_width or cfg.d_model) // ways)
    if kinds - {"ssd", "rglru"}:
        kv = cfg.num_kv_heads
        out["flash_attention"].add((cfg.num_heads // ways, kv // ways
                                    if kv % ways == 0 else kv, cfg.head_dim))
    return out


@contextlib.contextmanager
def projection_noise():
    """Every SSD mixer's projection [z, x, B, C, dt] multiplied by 1 +- 2^-24
    (a random sign an element, from a fixed seed): half an fp32 ulp, the
    size of the rounding by which the same product computed in column
    blocks may differ."""
    from repro_torch.models import ssm
    kept = ssm._split_proj
    gen = torch.Generator(device="cuda").manual_seed(1)

    def noisy(cfg, zxbcdt):
        sign = torch.randint(0, 2, zxbcdt.shape, generator=gen,
                             device=zxbcdt.device) * 2 - 1
        return kept(cfg, zxbcdt * (1 + sign * 2.0 ** -24))
    ssm._split_proj = noisy
    try:
        yield
    finally:
        ssm._split_proj = kept


def phase_tpk_fp32(label, cfg, params, batch):
    """(tk) One fp32 train step of ``cfg`` at model_ways 2 and 4 against 1
    (train_grads: the coordinates in lockstep on virtual devices of the
    card, each on its views of the same parameters), the loss and every
    gradient max-normalised at MODEL_TOL, exactly M x train_launches(cfg)
    launches, each kernel call on one coordinate's share (tp_shares).
    An SSD model's step at full depth turns rounding-sized differences
    into more than MODEL_TOL (PERF.md, Findings): for it the same step at one
    model way with half an ulp of noise on every projection (the rounding
    floor, projection_noise) is measured too, and the tolerance is twice
    that floor where it exceeds MODEL_TOL. Returns {M: the largest
    error}."""
    per = train_launches(cfg)
    base = train_grads(cfg, params, batch, per)
    shape = f"B{batch['tokens'].shape[0]} S{batch['tokens'].shape[1]}"
    tol = MODEL_TOL
    if "ssd" in cfg.pattern:
        with projection_noise():
            errs = grad_errs(train_grads(cfg, params, batch, per), base)
        top = max(errs, key=errs.get)
        tol = max(MODEL_TOL, 2 * errs[top])
        log(label, f"{cfg.name} ({cfg.num_layers} layers) fp32 train step "
                   f"{shape} at model_ways 1 with half an ulp of noise on "
                   f"its projections against without (the rounding floor): "
                   f"largest leaf {top} {errs[top]:.3e}; tolerance "
                   f"{tol:.3e}")
    worst = {}
    for ways in QWEN_TP_WAYS:
        want = {k: ways * n for k, n in per.items()}
        with launch_shapes() as seen:
            got = train_grads(cfg, params, batch, want, ways=ways)
        errs = grad_errs(got, base)
        finite = all(torch.isfinite(g).all() for g in got[1].values())
        del got
        top = max(errs, key=errs.get)
        worst[ways] = errs[top] if finite else float("inf")
        shares = {k: sorted(v) for k, v in seen.items() if v}
        log(label, f"{cfg.name} ({cfg.num_layers} layers) fp32 train step "
                   f"{shape} at model_ways {ways} against 1: "
                   f"{ {k: n for k, n in want.items() if n} } launches on "
                   f"shares {shares}; loss {base[0].item():.6f}, "
                   f"max-normalised {errs['loss']:.3e}; largest leaf {top} "
                   f"{errs[top]:.3e} over {len(errs) - 1} leaves (tol "
                   f"{tol:.3e})")
        if seen != tp_shares(cfg, ways):
            raise AssertionError(f"{cfg.name} at model_ways {ways}: kernel "
                                 f"calls on {seen}, not each coordinate's "
                                 f"share {tp_shares(cfg, ways)}")
    if max(worst.values()) > tol:
        raise AssertionError(f"{cfg.name}'s fp32 step under tensor "
                             "parallelism disagrees with one model way")
    return worst


def phase_tpk_bf16(label, cfg, params, data_cfg):
    """(tk) TPK_STEPS bf16 ElasticTrainer steps of ``cfg`` at model_ways
    QWEN_TP_WAYS[0] on as many virtual devices of the card: every loss
    finite, the last below the first, exactly M x train_launches(cfg)
    launches a step. Returns (trainer, the TrainState put together whole,
    the next batch, the losses, the peak GiB)."""
    from repro_torch.core import gather, slice_devices
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import ElasticTrainer, TrainerConfig
    ways = QWEN_TP_WAYS[0]
    tr = ElasticTrainer(
        build_model(cfg), AdamWConfig(lr=TPK_LR, warmup_steps=1,
                                      total_steps=TPK_STEPS),
        data_cfg, TrainerConfig(steps=TPK_STEPS, log_period=1,
                                model_ways=ways),
        devices=slice_devices(ways))
    per_step = {k: ways * n for k, n in train_launches(cfg).items() if n}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = counted_launches(
        lambda: tr.train(state=tr.init_state(params=params)),
        {k: TPK_STEPS * n for k, n in per_step.items()})
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [m["loss"] for m in tr.metrics]
    log(label, f"{cfg.name} ({cfg.num_layers} layers) bf16 ElasticTrainer at "
               f"model_ways {ways} (mesh {tr.mesh.shape}), {TPK_STEPS} steps "
               f"B{data_cfg.global_batch} S{data_cfg.seq_len}, lr {TPK_LR}, "
               f"in {seconds:.1f} s ({per_step} launches a step); losses "
               + ", ".join(f"{x:.4f}" for x in losses)
               + f"; peak device memory {peak:.2f} GiB")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
            int(state["step"]) != TPK_STEPS:
        raise AssertionError(f"{cfg.name}'s bf16 training at model_ways "
                             f"{ways} did not bring the loss down")
    whole = tree_map(gather, state)
    return tr, whole, tr.data.batch(TPK_STEPS), losses, peak


def phase_tpk_serve(label, cfg, params, toks, steps=8):
    """(tk) An SSD model's fp32 prefill of all but the last ``steps``
    tokens and ``steps`` decode steps at model_ways 2 against 1: the logits
    of each, and every leaf of the cache after them (the SSD state and conv
    rows put together whole), max-normalised at MODEL_TOL, the prefill's
    SSD launches M times one way's."""
    from repro_torch.core import TP_DP_RULES, make_mesh, slice_devices
    from repro_torch.core.sharding import activation_rules
    from repro_torch.models import build_model
    from repro_torch.models.layers import tree_leaves
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    s = toks.shape[1] - steps
    ways = QWEN_TP_WAYS[0]
    mesh = make_mesh(1, ways, devices=slice_devices(ways))
    per = sum(kind == "ssd" for kind in layer_kinds(cfg))

    def run(args):
        logits, cache = model.prefill(args, toks[:, :s], s + steps)
        return [logits] + [model.decode_step(
            args, cache, toks[:, s + i:s + i + 1], s + i)[0]
            for i in range(steps)], cache
    with torch.no_grad():
        runs = [counted_launches(lambda: run(params), {"ssd_scan": per})]
        with activation_rules(mesh, TP_DP_RULES):
            views = coordinate_views(model, params, mesh)
            runs.append(counted_launches(lambda: run(views),
                                         {"ssd_scan": ways * per}))
    (want, want_cache), (got, got_cache) = runs
    err = max(max_norm_err(g, w) for g, w in zip(got, want))
    cache_err = max(max_norm_err(g.float(), w.float()) for g, w in
                    zip(tree_leaves(got_cache), tree_leaves(want_cache)))
    log(label, f"{cfg.name} fp32 prefill B{toks.shape[0]} S{s} and {steps} "
               f"decode steps at model_ways {ways} against 1: logits "
               f"max-normalised {err:.3e}, cache {cache_err:.3e} (tol "
               f"{MODEL_TOL})")
    if max(err, cache_err) > MODEL_TOL:
        raise AssertionError(f"{cfg.name}'s prefill and decode at model_ways "
                             f"{ways} disagree with one model way")
    return err


def routing_flips(label, cfg, i, probs, experts, other, cap, sides):
    """The tokens of MoE block ``i`` whose experts ``other`` differ from
    ``experts`` (chosen from ``probs``), each printed with its logit gap;
    raises on one beyond a near tie (NEAR_TIE), and where none flipped, on
    a different number of choices dropped at capacity ``cap``. ``sides``:
    how to name ``other``'s path and ``experts``' path. Returns the number
    of flipped tokens."""
    from repro_torch.models import moe
    flips = 0
    for b, t in (other != experts).any(-1).nonzero().tolist():
        j = int((other[b, t] != experts[b, t]).nonzero()[0])
        p = probs[b, t]
        gap = abs(float(torch.log(p[other[b, t, j]])
                        - torch.log(p[experts[b, t, j]])))
        log(label, f"{cfg.name} block {i}: token ({b}, {t}) chose expert "
                   f"{int(other[b, t, j])} {sides[0]} and "
                   f"{int(experts[b, t, j])} {sides[1]}, logit gap "
                   f"{gap:.3e}")
        if gap >= NEAR_TIE:
            raise AssertionError(f"{cfg.name}: routing {sides[0]} differs "
                                 f"beyond a near tie")
        flips += 1
    ne = cfg.num_experts
    dropped = [int((moe.dispatch_slots(e, ne, cap) == ne * cap).sum())
               for e in (other, experts)]
    if not flips and dropped[0] != dropped[1]:
        raise AssertionError(f"{cfg.name}: block {i} drops {dropped[0]} "
                             f"choices {sides[0]}, {dropped[1]} {sides[1]}")
    return flips


@contextlib.contextmanager
def routings():
    """Every routing the MoE blocks make, in order: (probabilities,
    experts) of each call of moe.route_logits."""
    from repro_torch.models import moe
    calls, kept = [], moe.route_logits

    def spy(logits, cfg, load=None):
        out = kept(logits, cfg, load)
        calls.append((out[0].detach(), out[1].detach()))
        return out
    moe.route_logits = spy
    try:
        yield calls
    finally:
        moe.route_logits = kept


def phase_tpk_routing(label, cfg, params, batch):
    """(tk) A MoE model's routing at model_ways 2 against 1 on the same
    batch (the loss's forward pass): every coordinate of every MoE block
    chooses the experts one way chooses, but for near ties (a logit gap
    below NEAR_TIE, the router's product summed in blocks), and drops the
    same number of choices at capacity. Returns (choices, drops)."""
    from repro_torch.core import TP_DP_RULES, make_mesh, slice_devices
    from repro_torch.core.sharding import activation_rules
    from repro_torch.models import build_model, moe
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    ways = QWEN_TP_WAYS[0]
    mesh = make_mesh(1, ways, devices=slice_devices(ways))
    seen = []
    with torch.no_grad():
        for args, m in ((params, make_mesh(1, 1, devices=slice_devices(1))),
                        (coordinate_views(model, params, mesh), mesh)):
            with routings() as calls, activation_rules(m, TP_DP_RULES):
                model.loss(args, batch)
            seen.append(calls)
    one, many = seen
    cap = moe.capacity(cfg, batch["tokens"].shape[1], cfg.capacity_factor)
    ne = cfg.num_experts
    flips = drops = 0
    for i, (probs, experts) in enumerate(one):
        drops += int((moe.dispatch_slots(experts, ne, cap) == ne * cap)
                     .sum())
        for _, experts_m in many[i * ways:(i + 1) * ways]:
            flips += routing_flips(label, cfg, i, probs, experts, experts_m,
                                   cap, (f"at model_ways {ways}", "at 1"))
    choices = sum(e.numel() for _, e in one)
    log(label, f"{cfg.name}: routing of {choices} choices in {len(one)} MoE "
               f"blocks (top-{cfg.top_k} of {ne}, capacity {cap}) at "
               f"model_ways {ways} against 1: {flips} near-tie flips, "
               f"{drops} choices dropped at capacity on both")
    return choices, drops


def phase_tpk_slices(label, cfg, params, batch):
    """(tk) One fp32 train step of a mixture-of-experts ``cfg`` on 2 virtual
    data slices of the card against 1, from the same parameters and batch:
    the loss and every gradient as ElasticTrainer.train_step hands them to
    apply_step (kept from running), max-normalised at MODEL_TOL. The
    router's loss is a product of two means over the whole batch, so at 2
    slices each slice's takes the whole batch's routed shares from the
    trainer's routing pre-pass, one forward a slice more than the step's
    launches. Returns the largest error."""
    from repro_torch.core import slice_devices
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import ElasticTrainer, TrainerConfig
    from repro_torch.runtime import trainer as trainer_mod
    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    per = {k: n for k, n in train_launches(cfg).items() if n}
    seen, kept, got = {}, trainer_mod.apply_step, {}

    def spy(opt_cfg, state, grads, loss):
        seen["step"] = loss, tree_paths(grads)
        return state, {"loss": loss}

    trainer_mod.apply_step = spy
    try:
        for slices in (1, 2):
            tr = ElasticTrainer(model, AdamWConfig(), None,
                                TrainerConfig(max_slices=slices),
                                devices=slice_devices(2), slices=slices)
            state = tr.init_state(params=params)
            want = {k: slices * n for k, n in per.items()}
            if slices > 1:
                want["flash_attention"] += slices * flash_per_pass(cfg)
            t0 = time.perf_counter()
            counted_launches(lambda: tr.train_step(state, batch), want)
            got[slices] = seen.pop("step")
            log(label, f"{cfg.name} ({cfg.num_layers} layers) fp32 train "
                       f"step at {slices} data slice(s): loss "
                       f"{got[slices][0].item():.6f}, {want} launches, "
                       f"{time.perf_counter() - t0:.2f} s")
            del state, tr
            torch.cuda.empty_cache()
    finally:
        trainer_mod.apply_step = kept
    errs = grad_errs(got[2], got[1])
    top = max(errs, key=errs.get)
    log(label, f"{cfg.name} fp32 step at 2 data slices against 1, B"
               f"{batch['tokens'].shape[0]} S{batch['tokens'].shape[1]}: "
               f"loss max-normalised {errs['loss']:.3e}; largest leaf {top} "
               f"{errs[top]:.3e} over {len(errs) - 1} leaves (tol "
               f"{MODEL_TOL})")
    if errs[top] > MODEL_TOL:
        raise AssertionError(f"{cfg.name}'s step at 2 data slices disagrees "
                             "with one slice")
    return errs[top]


def main_tp_kinds():
    """(tk), run by ``chip_smoke.py --tp-kinds`` in a process of its own
    (run_child), with the card to itself: tensor parallelism inside a
    slice for the SSD, RG-LRU, mixture-of-experts and encoder-decoder
    blocks, on virtual devices of the card, each model at its published
    widths, drawn on the card at each layer's own fan-in, freed after its
    path. mamba2-130m at full depth: an fp32 step at B TRAIN_B, S TRAIN_S
    at model_ways 2 and 4 against 1, TPK_STEPS bf16 ElasticTrainer steps
    at 2, fp32 prefill and decode at 2 against 1, the bf16 step's times at
    1, 2 and 4; recurrentgemma-9b cut to one unit (TPK_RG_LAYERS): the fp32
    step at B 1, S RG_TRAIN_S at 2 and 4 against 1, bf16 steps at 2;
    deepseek-moe-16b cut to TPK_DS_LAYERS (its dense first layer, two MoE
    layers): the routing and drops at 2 against 1, the fp32 step at 2 and
    4 against 1, bf16 steps at 2, the step's times, and its fp32 step at 2
    data slices against 1 (phase_tpk_slices); seamless-m4t-medium:
    its fp32 step at 2 and 4 against 1, as phase (z)'s batch, TPK_STEPS
    bf16 steps at 2 as zt trains it (remat "dots", ce_chunk) at
    TPK_ENCDEC_TRAIN, and the step's times at 1, 2 and 4. Writes the
    path's launch counts and the numbers to TP_KINDS_RESULT."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def batch_of(data):
        return {k: t.cuda() for k, t in SyntheticLMData(data).batch(0)
                .items()}
    out = {"fp32": {}, "losses": {}, "peak": {}, "times": {}}
    totals = {name: 0 for name in counters()}

    def add(counts):
        for k, n in counts.items():
            totals[k] += n

    mamba = get_config("mamba2-130m")
    _, params = model_and_params(mamba, "tk", on_card=True, per_layer=True)
    data = DataConfig(vocab_size=mamba.vocab_size, seq_len=TRAIN_S,
                      global_batch=TRAIN_B)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, mamba.vocab_size, (PREFILL_B, PREFILL_S + 8))).cuda()
    counts, (fp32, trained, _) = drive("tk", (
        lambda: phase_tpk_fp32("tk", mamba, params, batch_of(data)),
        lambda: phase_tpk_bf16("tk", mamba, params, data),
        lambda: phase_tpk_serve("tk", mamba, params, toks)))
    add(counts)
    del params
    trainer, whole, next_batch, losses, peak = trained
    del trained
    out["fp32"][mamba.name], out["losses"][mamba.name] = fp32, losses
    out["peak"][mamba.name] = peak
    out["times"][mamba.name] = phase_tp_step_times(
        mamba, trainer, whole, next_batch, data, label="tk")
    del trainer, whole
    torch.cuda.empty_cache()

    rg = dataclasses.replace(get_config("recurrentgemma-9b"),
                             num_layers=TPK_RG_LAYERS, ce_chunk=1024)
    _, params = model_and_params(rg, "tk", init_depth=RG_DEPTH, on_card=True,
                                 per_layer=True)
    data = DataConfig(vocab_size=rg.vocab_size, seq_len=RG_TRAIN_S,
                      global_batch=1)
    counts, (fp32, trained) = drive("tk", (
        lambda: phase_tpk_fp32("tk", rg, params, batch_of(data)),
        lambda: phase_tpk_bf16("tk", rg, params, data)))
    add(counts)
    del params
    out["fp32"][rg.name], out["losses"][rg.name] = fp32, trained[3]
    out["peak"][rg.name] = trained[4]
    del trained
    torch.cuda.empty_cache()

    ds = dataclasses.replace(get_config("deepseek-moe-16b"),
                             num_layers=TPK_DS_LAYERS)
    _, params = model_and_params(ds, "tk", init_depth=28, on_card=True,
                                 per_layer=True)
    data = DataConfig(vocab_size=ds.vocab_size, seq_len=TPK_MOE_S,
                      global_batch=TPK_MOE_B)
    counts, (routing, fp32, slices_err, trained) = drive("tk", (
        lambda: phase_tpk_routing("tk", ds, params, batch_of(data)),
        lambda: phase_tpk_fp32("tk", ds, params, batch_of(data)),
        lambda: phase_tpk_slices("tk", ds, params, batch_of(data)),
        lambda: phase_tpk_bf16("tk", ds, params, data)))
    add(counts)
    del params
    trainer, whole, next_batch, losses, peak = trained
    del trained
    out["fp32"][ds.name], out["losses"][ds.name] = fp32, losses
    out["peak"][ds.name], out["routing"] = peak, routing
    out["slices"] = {ds.name: slices_err}
    out["times"][ds.name] = phase_tp_step_times(
        ds, trainer, whole, next_batch, data, label="tk")
    del trainer, whole
    torch.cuda.empty_cache()

    sm = get_config("seamless-m4t-medium")
    _, params = model_and_params(sm, "tk", on_card=True, per_layer=True)
    rows, seq_len = ENCDEC_TRAIN
    data = DataConfig(vocab_size=sm.vocab_size, seq_len=seq_len,
                      global_batch=rows, frontend=sm.frontend,
                      d_model=sm.d_model, enc_dec=True)
    # its bf16 steps as zt trains it (remat "dots", the loss by ce_chunk),
    # at TPK_ENCDEC_TRAIN's (B, S)
    sm_bf16 = zt_config(sm.name, sm.num_layers)
    bf16_data = zt_data(sm_bf16, *TPK_ENCDEC_TRAIN)
    t0 = time.perf_counter()
    counts, (fp32, trained) = drive("tk", (
        lambda: phase_tpk_fp32("tk", sm, params, batch_of(data)),
        lambda: phase_tpk_bf16("tk", sm_bf16, params, bf16_data)))
    add(counts)
    del params
    trainer, whole, next_batch, losses, peak = trained
    del trained
    out["fp32"][sm.name], out["losses"][sm.name] = fp32, losses
    out["peak"][sm.name] = peak
    out["times"][sm.name] = phase_tp_step_times(
        sm_bf16, trainer, whole, next_batch, bf16_data, label="tk")
    del trainer, whole
    out["seconds"] = {sm.name: time.perf_counter() - t0}
    log("tk", f"{sm.name}'s fp32 steps, bf16 steps at model_ways "
              f"{QWEN_TP_WAYS[0]} and step times in "
              f"{out['seconds'][sm.name]:.1f} s")
    # every kernel of the models; the path resizes nothing (no box_copy)
    for name in counters():
        if name != "box_copy" and totals[name] == 0:
            raise AssertionError(f"the tensor-parallel kinds' path never "
                                 f"launched {name}")
    out["counts"] = totals
    TP_KINDS_RESULT.parent.mkdir(parents=True, exist_ok=True)
    TP_KINDS_RESULT.write_text(json.dumps(out))
    return 0


# -- (zt) the training of gemma2-27b, paligemma-3b, phi3.5-moe, granite-3-2b ---
# and seamless-m4t-medium

# the families whose training no card had run before slice 19, and
# seamless-m4t-medium, which had run only fp32 steps before slice 20:
# {arch: (published depth, the cuts tried, deepest first, the fp32 step's
# (B, S), the bf16 steps' (B, S))}. gemma2: one (local, global) unit, else
# the local layer alone, S 4352 where the window of 4096 bites; paligemma:
# 256 patches + 256 tokens a row; phi3.5: two MoE layers, else one;
# granite: all 40 layers; seamless: all 12 encoder and 12 decoder layers,
# each row S / 2 frames and S / 2 tokens (the bf16 steps' S 4096 the
# reference's train_4k sequence split by enc_dec)
ZT_CELLS = {"gemma2-27b": (46, (2, 1), (1, 4352), (1, 4352)),
            "paligemma-3b": (18, (18, 12), (2, 512), (8, 512)),
            "phi3.5-moe-42b-a6.6b": (32, (2, 1), (2, 1024), (2, 4096)),
            "granite-3-2b": (40, (40, 32), (1, 2048), (2, 4096)),
            "seamless-m4t-medium": (12, (12,), (2, 1024), (8, 4096))}
# bf16 ElasticTrainer steps under remat "dots", their learning rate, the
# loss's ce_chunk, and the largest counted one-step peak a cut may have (the
# card's 79.19 GiB less room for the allocator's blocks of other sizes and
# the fp32 check's gradients, which the bf16 count does not hold)
ZT_STEPS, ZT_LR, ZT_CE_CHUNK, ZT_PEAK_GIB = 4, 1e-3, 1024, 74.0
ZOO_TRAIN_RESULT = ROOT / "build" / "chip_smoke_zoo_train.json"


def zt_config(arch, layers):
    """``arch`` at its published widths cut to ``layers``, the loss by
    ZT_CE_CHUNK, remat "dots"."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), num_layers=layers,
                               ce_chunk=ZT_CE_CHUNK, remat="dots")


def zt_count(arch):
    """The dry-run's count of ``arch``'s bf16 train step (ZT_CELLS' bf16
    shape, remat "dots", the trainer's step on the meta device) at each of
    ZT_CELLS' cuts in turn, up to the first whose one-step peak is at most
    ZT_PEAK_GIB, which it takes. Returns {"layers", "counted": {layers:
    peak GiB}, "record": the chosen cut's record}."""
    from repro_torch.optim import AdamWConfig
    _, cuts, _, (b, s) = ZT_CELLS[arch]
    opt = AdamWConfig(lr=ZT_LR, warmup_steps=1, total_steps=ZT_STEPS)
    counted = {}
    for layers in cuts:
        record = predict_cell("zt", zt_config(arch, layers), b, s, opt,
                              ("dots",))["dots"]
        counted[layers] = record["memory"]["peak_bytes"] / 2 ** 30
        if counted[layers] <= ZT_PEAK_GIB:
            break
    else:
        raise AssertionError(f"{arch}: no cut's counted peak is within "
                             f"{ZT_PEAK_GIB} GiB: {counted}")
    log("zt", f"{arch}: the deepest cut within {ZT_PEAK_GIB} GiB is "
              f"{layers} layers; counted one-step peaks " + ", ".join(
                  f"{n} layers {g:.2f} GiB" for n, g in counted.items()))
    return {"layers": layers, "counted": counted, "record": record}


def phase_zt_routing(cfg, params, batch):
    """(zt) A MoE model's routing through the flash kernels against the
    chunked path on the same fp32 batch (the loss's forward): each MoE
    block chooses the same experts for every token but for near ties (a
    logit gap below NEAR_TIE: the two attentions round differently), each
    flip printed with its gap, and drops as many choices at capacity.
    Returns (choices, flips, drops)."""
    from repro_torch.models import build_model, moe
    seen = []
    with torch.no_grad():
        for impl in ("auto", "chunked"):
            model = build_model(dataclasses.replace(cfg, dtype="float32",
                                                    attn_impl=impl))
            with routings() as calls:
                model.loss(params, batch)
            seen.append(calls)
    kernel, chunked = seen
    cap = moe.capacity(cfg, batch["tokens"].shape[1], cfg.capacity_factor)
    ne = cfg.num_experts
    flips = drops = 0
    for i, ((probs, experts), (_, other)) in enumerate(zip(chunked, kernel)):
        drops += int((moe.dispatch_slots(experts, ne, cap) == ne * cap)
                     .sum())
        flips += routing_flips("zt", cfg, i, probs, experts, other, cap,
                               ("through the kernels", "chunked"))
    choices = sum(e.numel() for _, e in chunked)
    log("zt", f"{cfg.name}: routing of {choices} choices in {len(chunked)} "
              f"MoE blocks (top-{cfg.top_k} of {ne}, capacity {cap}) through "
              f"the kernels against chunked: {flips} near-tie flips, "
              f"{drops} choices dropped at capacity")
    return choices, flips, drops


def phase_zt_fp32(cfg, params, batch):
    """(zt) held_train_step of ``cfg`` (remat "dots"), each layer at its own
    fan-in. Returns the largest distance."""
    kernel, held = held_train_step("zt", cfg, params, batch)
    want = train_launches(cfg)
    top = max(held, key=held.get)
    shape = f"B{batch['tokens'].shape[0]} S{batch['tokens'].shape[1]}"
    if "frontend" in batch:
        word = {"patches": "patch embeddings"}.get(cfg.frontend, cfg.frontend)
        shape += f" (+ {batch['frontend'].shape[1]} {word})"
    log("zt", f"{cfg.name} ({cfg.num_layers} layers) fp32 train step "
              f"{shape}, remat dots ({want['flash_attention']} + "
              f"{want['flash_attention_bwd']} flash launches), each layer "
              f"at its own fan-in: loss {kernel[0].item():.6f} through the "
              f"kernels; against chunked, max-normalised, loss "
              f"{held['loss']:.3e}, largest leaf {top} {held[top]:.3e} over "
              f"{len(held) - 1} leaves (tol {MODEL_TOL})")
    return max(held.values())


def zt_data(cfg, b, s):
    """The synthetic stream's config for ``cfg`` at B ``b``, S ``s``
    (paligemma: s - 256 text tokens after its patch embeddings; an
    encoder-decoder: s / 2 frames and s / 2 tokens)."""
    from repro_torch.data import DataConfig
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                      frontend=cfg.frontend,
                      frontend_tokens=cfg.frontend_tokens,
                      d_model=cfg.d_model, enc_dec=cfg.family == "encdec")


def drive_zt(arch, count):
    """(zt) One model's training path, ``count`` its zt_count: the model
    drawn on the card at the counted cut, each layer at its own fan-in; for
    a MoE, the routing through the kernels against chunked; the fp32 step
    against chunked; ZT_STEPS bf16 ElasticTrainer steps, the loss falling;
    then the step's wall, busy, idle and tokens/s (step_times) and its peak
    (the TrainState held) against the count. Returns the path's numbers."""
    from repro_torch.data import SyntheticLMData
    depth, _, (fb, fs), (b, s) = ZT_CELLS[arch]
    cfg = zt_config(arch, count["layers"])
    box = {"params": model_and_params(cfg, "zt", init_depth=depth,
                                      on_card=True, per_layer=True)[1]}
    fp32_batch = {k: t.cuda() for k, t in SyntheticLMData(
        zt_data(cfg, fb, fs)).batch(0).items()}
    data = zt_data(cfg, b, s)
    phases = [lambda: phase_zt_fp32(cfg, box["params"], fp32_batch),
              lambda: phase_train_bf16(cfg, lambda: box.pop("params"), data,
                                       ZT_STEPS, label="zt", lr=ZT_LR)]
    if cfg.num_experts:
        phases.insert(0, lambda: phase_zt_routing(cfg, box["params"],
                                                  fp32_batch))
    counts, (*checks, trained) = drive("zt", phases)
    for name in ("flash_attention", "flash_attention_bwd"):
        if counts[name] == 0:
            raise AssertionError(f"{arch}'s training path never launched "
                                 f"{name}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer, state, next_batch = trained
    del trained, fp32_batch
    # step_times' steps from the held TrainState: their peak is one step's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, busy = step_times({(cfg.name, 1): (
        cfg, data, 1, lambda: trainer.train_step(state, next_batch))})
    one_step = torch.cuda.max_memory_allocated() / 2 ** 30
    wall, busy = walls[cfg.name, 1], busy[cfg.name, 1][0]
    held = hold_prediction("zt", f"{cfg.name} ({cfg.num_layers} layers)",
                           count["record"], one_step, busy)
    out = {"layers": cfg.num_layers, "counts": counts, "peak": peak,
           "fp32_err": checks[-1],
           "losses": [m["loss"] for m in trainer.metrics],
           "times": {"wall_ms": wall, "busy_ms": busy,
                     "idle": 1 - busy / wall,
                     "tok_s": b * s / wall * 1e3, "peak_gib": one_step},
           "prediction": held, "counted": count["counted"]}
    if cfg.num_experts:
        out["routing"] = dict(zip(("choices", "flips", "drops"), checks[0]))
    log("zt", f"{cfg.name} ({cfg.num_layers} layers) bf16 step B{b} S{s}: "
              f"{wall:.3f} ms wall, {busy:.3f} ms busy "
              f"({100 * out['times']['idle']:.1f}% idle), "
              f"{out['times']['tok_s']:.0f} tokens/s, one-step peak "
              f"{one_step:.2f} GiB (the dry-run's "
              f"{held['predicted_gib']:.2f}), path peak {peak:.2f} GiB")
    return out


def main_zoo_train():
    """(zt), run by ``chip_smoke.py --zoo-train`` in a process of its own
    (run_child), with the card to itself: the training of each model of
    ZT_CELLS (gemma2-27b, paligemma-3b, phi3.5-moe-42b-a6.6b, granite-3-2b,
    seamless-m4t-medium) at its published widths, each at the deepest cut
    whose counted one-step peak is within ZT_PEAK_GIB (zt_count, every one
    counted before any draw), each freed after its path (drive_zt), with
    each path's seconds. Writes each path's numbers to ZOO_TRAIN_RESULT."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    if "ZT_COUNTS" in os.environ:
        counts = json.loads(Path(os.environ["ZT_COUNTS"]).read_text())
    else:
        counts = {arch: zt_count(arch) for arch in ZT_CELLS}
        log("zt", f"the {len(counts)} counts in "
                  f"{time.perf_counter() - t0:.1f} s")
    out = {}
    for arch in ZT_CELLS:
        t1 = time.perf_counter()
        out[arch] = drive_zt(arch, counts[arch])
        out[arch]["seconds"] = time.perf_counter() - t1
        log("zt", f"{arch}'s training path in {out[arch]['seconds']:.1f} s")
        torch.cuda.empty_cache()
    log("zt", f"the {len(out)} training paths in "
              f"{time.perf_counter() - t0:.1f} s")
    ZOO_TRAIN_RESULT.parent.mkdir(parents=True, exist_ok=True)
    ZOO_TRAIN_RESULT.write_text(json.dumps(out))
    return 0


# (nc) the dry-run's count of qwen3-4b's train_4k cell on the node layouts
# with a model axis, each in a process of its own on the host's CPU beside
# the card's phases
NODE_LAYOUTS = ("h100x8_m8", "h100x8_m4")


def node_count_result(name):
    return ROOT / "build" / f"chip_smoke_node_{name}.json"


def main_node_count():
    """(nc), run by ``chip_smoke.py --node-count NAME`` (start_node_counts):
    the dry-run's count of qwen3-4b's train_4k cell at its published size
    on the node layout NAME, on the meta device (one card's share, the
    collectives by kind), written to node_count_result(NAME). Touches no
    card, and yields the host's cores to the card's phases (nice 19, one
    thread)."""
    from repro_torch.launch.dryrun import run_cell
    name = sys.argv[2]
    os.nice(19)
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    rec = run_cell("qwen3-4b", "train_4k", name, None, verbose=False)
    rec["seconds"] = time.perf_counter() - t0
    node_count_result(name).parent.mkdir(parents=True, exist_ok=True)
    node_count_result(name).write_text(json.dumps(rec, default=str))
    return 0 if rec["status"] == "ok" else 1


def start_node_counts():
    """Start main_node_count for each of NODE_LAYOUTS, the card hidden from
    it; each is killed when this process exits."""
    procs = {}
    for name in NODE_LAYOUTS:
        node_count_result(name).unlink(missing_ok=True)
        procs[name] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--node-count",
             name], stdout=subprocess.DEVNULL,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                 "OMP_NUM_THREADS": "1"})
    atexit.register(lambda: [p.kill() for p in procs.values()
                             if p.poll() is None])
    return procs


def finish_node_counts(procs, timeout=600):
    """Wait for start_node_counts' processes and print each layout's
    per-card terms and collectives; a count that failed fails the run."""
    out = {}
    for name, proc in procs.items():
        rc = proc.wait(timeout=timeout)
        path = node_count_result(name)
        rec = json.loads(path.read_text()) if path.exists() else {}
        if rc != 0 or rec.get("status") != "ok":
            raise AssertionError(f"the dry-run's count on {name} failed "
                                 f"(exit {rc}): {rec.get('error')}")
        rl, mem = rec["roofline"], rec["memory"]
        log("nc", f"qwen3-4b train_4k on {name} ({rec['chips']} cards, "
                  f"{rec['rules']}, {rec['note']}), per card, counted in "
                  f"{rec['seconds']:.1f} s on the host: compute "
                  f"{rl['compute_s'] * 1e3:.1f} ms, memory "
                  f"{rl['memory_s'] * 1e3:.1f} ms, collective "
                  f"{rl['collective_s'] * 1e3:.1f} ms ({rl['dominant']}), "
                  f"MFU {rl['mfu']:.4f}, peak "
                  f"{mem['peak_bytes'] / 2 ** 30:.2f} GiB (fits "
                  f"{mem['fits']}); collectives " + ", ".join(
                      f"{k} {v / 1e6:.1f} MB" for k, v in
                      sorted(rec["collectives"].items())))
        out[name] = rec
    return out


# (hw) host work beside the card's phases, in one process of its own at
# nice 19 started once the kernels are built (start_host_work): the first
# calls of the flex_attention yardstick at the softcapped calls, which
# leave torch.compile's caches warm for (k), then the dry-run's counts of
# the zt cells, which the zt child reads (ZT_COUNTS); its log
HOST_WORK_LOG = ROOT / "build" / "chip_smoke_host_work.log"
ZT_COUNTS = ROOT / "build" / "chip_smoke_zt_counts.json"


def compile_caches():
    """torch.compile's and Triton's caches in the checkout's build
    directory, for this process and the ones it starts."""
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def main_host_work():
    """(hw), run by ``chip_smoke.py --host-work`` (start_host_work), at nice
    19: bench.warm_flex at each softcapped label of bench.SHAPES, then
    zt_count of each of ZT_CELLS, written to ZT_COUNTS."""
    from repro_torch.kernels import bench
    os.nice(19)
    compile_caches()
    t0 = time.perf_counter()
    labels = [label for label, shape in bench.SHAPES.items()
              if shape[-1] is not None]
    for label in labels:
        bench.warm_flex(label)
    log("hw", f"flex_attention's forward and backward compiled at {labels} "
              f"in {time.perf_counter() - t0:.1f} s")
    counts = {arch: zt_count(arch) for arch in ZT_CELLS}
    ZT_COUNTS.write_text(json.dumps(counts))
    log("hw", f"done in {time.perf_counter() - t0:.1f} s")
    return 0


def start_host_work():
    """Start main_host_work, its output to HOST_WORK_LOG; it is killed when
    this process exits."""
    ZT_COUNTS.unlink(missing_ok=True)
    HOST_WORK_LOG.parent.mkdir(parents=True, exist_ok=True)
    with HOST_WORK_LOG.open("w") as out:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--host-work"],
            stdout=out, stderr=subprocess.STDOUT,
            env={**os.environ, "OMP_NUM_THREADS": "1"})
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def finish_host_work(proc, timeout=600):
    """Wait for start_host_work's process and print its log; its failure
    fails the run."""
    rc = proc.wait(timeout=timeout)
    for line in HOST_WORK_LOG.read_text().splitlines():
        if line.startswith("["):
            print(line, flush=True)
    if rc != 0 or not ZT_COUNTS.exists():
        raise AssertionError(f"chip_smoke.py --host-work failed (exit {rc}):"
                             f" {HOST_WORK_LOG.read_text()[-2000:]}")


def run_child(flag, result, env=None):
    """Run ``chip_smoke.py flag`` in a child process and return the JSON it
    wrote to ``result``. The child loads the kernels this process built.
    The heavy paths run there for memory: each starts with the card to
    itself, with no other path's freed blocks left in the allocator
    (recurrentgemma's training, mq, needs it nearly whole). The zoo first
    ran there because its paths left torch.profiler losing kernel records
    in this process; bench.session's sentinel kernels now absorb that
    (PERF.md, section 7)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    result.unlink(missing_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           flag], check=False,
                          env=None if env is None else {**os.environ, **env})
    if proc.returncode != 0:
        raise AssertionError(f"chip_smoke.py {flag} failed (exit "
                             f"{proc.returncode})")
    log("k", f"chip_smoke.py {flag} ran {time.perf_counter() - t0:.1f} s")
    return json.loads(result.read_text())


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
    node_counts = start_node_counts()
    compile_caches()
    build_kernels()
    host_work = start_host_work()
    flash_err = phase_kernel_vs_plain()
    bwd_err = phase_flash_bwd_vs_plain()
    ssd_err = phase_ssd_vs_plain()
    rglru_err = phase_rglru_vs_plain()
    scan_bwd_err = phase_scan_bwd_vs_plain()
    log("sb", f"kernels held against their plain versions; "
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
    box_err = phase_box_copy_vs_plain(smollm, params, data_cfg)
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
        lambda: phase_elastic_loop(smollm, params, data_cfg),
        lambda: phase_fsdp_step(smollm, model, params, data_cfg),
        lambda: phase_fsdp_elastic(smollm, params, data_cfg)))
    for name in ("flash_attention", "flash_attention_bwd", "box_copy"):
        if elastic_counts[name] == 0:
            raise AssertionError(f"smollm's elastic path never launched "
                                 f"{name}")
    tps_counts, _ = drive("tps", (
        lambda: phase_tp_step(smollm, model, params, data_cfg),
        lambda: phase_tp_elastic(smollm, params, data_cfg)))
    for name in ("flash_attention", "flash_attention_bwd", "box_copy"):
        if tps_counts[name] == 0:
            raise AssertionError(f"smollm's path at model_ways {TP_WAYS} "
                                 f"never launched {name}")
    t0 = time.perf_counter()
    calib_counts, (*_, artifact) = drive("t", (
        phase_apps_parity, lambda: phase_apps_times(phase_apps_table1()),
        phase_calibration))
    if calib_counts["box_copy"] == 0:
        raise AssertionError("the apps' and the calibration's reshards never "
                             "launched box_copy")
    torch.cuda.empty_cache()
    log("t", f"apps and calibration in {time.perf_counter() - t0:.1f} s")
    phase_workload_sim(artifact, card=smi)
    phase_sweep(artifact, card=smi)

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
    m_data = DataConfig(vocab_size=mamba.vocab_size, seq_len=TRAIN_S,
                        global_batch=TRAIN_B)
    m_batch = {k: t.cuda()
               for k, t in SyntheticLMData(m_data).batch(0).items()}
    m_train_counts, (_, m_trained) = drive("hq", (
        lambda: phase_scan_train_fp32(
            "hq", mamba, at_per_layer_fan_in(m_model, m_params,
                                             mamba.pattern_repeats[0]),
            m_batch, reference=m_params),
        lambda: phase_train_bf16(mamba, m_params, m_data, TRAIN_STEPS,
                                 label="hq")))
    for name in ("ssd_scan", "ssd_scan_bwd"):
        if m_train_counts[name] == 0:
            raise AssertionError(f"mamba2's training path never launched "
                                 f"{name}")

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

    finish_host_work(host_work)
    log("k", f"the kernel timings from {time.perf_counter() - start:.1f} s")
    flash_rows = {label: bench.time_flash_attention(label)
                  for label in (*bench.SHAPES, *bench.NONCAUSAL_SHAPES)}
    for row in flash_rows.values():
        log("k", bench.describe(row))
    held_library(flash_rows, BF16_ROW_TOL)
    ssd_rows = {label: bench.time_ssd_scan(label)
                for label in bench.SSD_SHAPES}
    # each split (bench.split_kernels) fails where the profile misses one
    # of the route's CUDA kernels or lists one without device time
    for row in ssd_rows.values():
        log("k", bench.describe_ssd(row))
    rglru_rows = {label: bench.time_rglru_scan(label)
                  for label in bench.RGLRU_SHAPES}
    for row in rglru_rows.values():
        log("k", bench.describe_rglru(row))
    # the backwards' CUDA kernels under the profiler
    flash_bwd_split = {label: bench.flash_bwd_kernels(label) for label in
                       (*bench.BWD_SHAPES, *bench.NONCAUSAL_BWD_SHAPES)}
    for label, kernels in flash_bwd_split.items():
        log("k", f"flash_attention_bwd {label}: " + ", ".join(
            f"{name} {ms:.4f} ms x{n}" for name, ms, n in kernels))
    ssd_bwd_split = {label: bench.ssd_bwd_kernels(label)
                     for label in bench.SSD_BWD_SHAPES}
    ssd_bwd_rows = {label: bench.time_ssd_scan_bwd(
        label, passes=ssd_bwd_split[label]) for label in bench.SSD_BWD_SHAPES}
    for row in ssd_bwd_rows.values():
        log("k", bench.describe_ssd_bwd(row))
    rglru_bwd_rows = {label: bench.time_rglru_scan_bwd(label)
                      for label in bench.RGLRU_BWD_SHAPES}
    for row in rglru_bwd_rows.values():
        log("k", bench.describe_rglru_bwd(row))
    phase_step_times(smollm, params, toks[:, :PREFILL_S])
    phase_step_times(mamba, m_params, m_toks[:, :PREFILL_S])
    phase_step_times(rg, rg_params, rg_toks)
    box_times = phase_reshard_times(smollm, *resharded)
    del resharded
    phase_train_step_time(smollm, *trained, data_cfg,
                          others=[(mamba, *m_trained, m_data)])
    # the backward last: its library yardstick is autograd's backward in a
    # CUDA graph, after which no profile runs
    bwd_rows = {label: bench.time_flash_attention_bwd(label) for label in
                (*bench.BWD_SHAPES, *bench.NONCAUSAL_BWD_SHAPES)}
    for row in bwd_rows.values():
        log("k", bench.describe_bwd(row))
    held_library(bwd_rows, BWD_TOL[torch.bfloat16])
    # slice 9 in a process of its own, with the card's memory this one no
    # longer needs
    del params, m_params, rg_params, model, m_model, rg_model, trained
    del m_trained
    torch.cuda.empty_cache()
    log("k", f"this process holds {torch.cuda.memory_allocated() / 2**30:.2f}"
             f" GiB of the card ({torch.cuda.memory_reserved() / 2**30:.2f} "
             f"reserved) while the child runs")
    log("k", f"the children from {time.perf_counter() - start:.1f} s")
    zoo_result = run_child("--zoo", ZOO_RESULT)
    zoo = {arch: (v["counts"], v["tok_s"], v["peak"])
           for arch, v in zoo_result.items()}
    # the allocator's expandable segments: its 65 GiB peak leaves no room
    # for blocks split at another size
    rg_train = run_child("--rg-train", RG_TRAIN_RESULT, env={
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    pred = rg_train["prediction"]
    log("mq", f"recurrentgemma-9b training: peak device memory "
              f"{rg_train['peak']:.2f} GiB; one step "
              f"{pred['measured_gib']:.2f} GiB against the dry-run's "
              f"{pred['predicted_gib']:.2f}, busy {pred['busy_ms']:.3f} ms "
              f"against its compute {pred['compute_ms']:.1f} and memory "
              f"{pred['memory_ms']:.1f} ms, MFU {pred['mfu']:.4f}")
    rg_train = rg_train["counts"]
    qwen_train = run_child("--qwen-train", QWEN_TRAIN_RESULT, env={
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    log("wq", f"qwen3-4b training ({QWEN_TRAIN_LAYERS} layers): peak device "
              f"memory {qwen_train['peak']:.2f} GiB; bf16 step B"
              f"{QWEN_TRAIN_B} S{QWEN_TRAIN_S} " + "; ".join(
                  f"remat {k}: {v['wall_ms']:.3f} ms wall, "
                  f"{v['busy_ms']:.3f} ms busy, {v['peak_gib']:.2f} GiB peak "
                  f"(the dry-run's {v['prediction']['predicted_gib']:.2f}; "
                  f"MFU {v['prediction']['mfu']:.4f})"
                  for k, v in qwen_train["times"].items()))
    qwen_train = qwen_train["counts"]
    tp = run_child("--tp", TP_RESULT, env={
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    log("tp", f"qwen3-4b ({TP_LAYERS} layers) under tensor "
              f"parallelism: fp32 step against model_ways 1, largest "
              f"max-normalised error " + ", ".join(
                  f"{e:.3e} at model_ways {m}" for m, e in tp["fp32"].items())
              + f"; bf16 losses at model_ways {QWEN_TP_WAYS[0]} "
              + ", ".join(f"{x:.4f}" for x in tp["losses"]) + "; step B"
              f"{QWEN_TRAIN_B} S{QWEN_TRAIN_S} " + "; ".join(
                  f"model_ways {m}: {v['wall_ms']:.3f} ms wall, "
                  f"{v['busy_ms']:.3f} ms busy, {v['tok_s']:.0f} tokens/s, "
                  f"{v['peak_gib']:.2f} GiB peak" + (
                      f" (the dry-run's {v['prediction']['predicted_gib']:.2f}"
                      f", compute {v['prediction']['compute_ms']:.1f} ms)"
                      if "prediction" in v else "")
                  for m, v in tp["times"].items()))
    tp = tp["counts"]
    tpk = run_child("--tp-kinds", TP_KINDS_RESULT, env={
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    log("tk", "SSD, RG-LRU, MoE and encoder-decoder blocks under tensor "
              "parallelism: fp32 step against model_ways 1, largest "
              "max-normalised error " + "; ".join(
                  f"{arch} " + ", ".join(f"{e:.3e} at {m}"
                                         for m, e in v.items())
                  for arch, v in tpk["fp32"].items())
              + f"; bf16 losses at model_ways {QWEN_TP_WAYS[0]} " + "; ".join(
                  f"{arch} " + ", ".join(f"{x:.4f}" for x in v)
                  + f" (peak {tpk['peak'][arch]:.2f} GiB)"
                  for arch, v in tpk["losses"].items()) + "; steps " + "; ".join(
                  f"{arch} model_ways {m}: {v['wall_ms']:.3f} ms wall, "
                  f"{v['busy_ms']:.3f} ms busy, {v['peak_gib']:.2f} GiB peak"
                  for arch, t in tpk["times"].items() for m, v in t.items())
              + "; fp32 step at 2 data slices against 1: " + ", ".join(
                  f"{arch} {e:.3e}" for arch, e in tpk["slices"].items()))
    tpk_seconds = tpk["seconds"]
    tpk = tpk["counts"]
    zt = run_child("--zoo-train", ZOO_TRAIN_RESULT, env={
        "PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
        "ZT_COUNTS": str(ZT_COUNTS)})
    log("zt", "the training paths of " + ", ".join(zt) + ": " + "; ".join(
                  f"{arch} ({v['layers']} layers) fp32 step within "
                  f"{v['fp32_err']:.3e} of chunked, bf16 losses "
                  + ", ".join(f"{x:.4f}" for x in v["losses"])
                  + f", step {v['times']['wall_ms']:.3f} ms wall, "
                  f"{v['times']['busy_ms']:.3f} ms busy, "
                  f"{v['times']['tok_s']:.0f} tokens/s, one-step peak "
                  f"{v['times']['peak_gib']:.2f} GiB (the dry-run's "
                  f"{v['prediction']['predicted_gib']:.2f}), launches "
                  f"{v['counts']['flash_attention']} + "
                  f"{v['counts']['flash_attention_bwd']}"
                  for arch, v in zt.items()))
    log("k", f"Server {smollm_tok_s:.1f} tok/s (smollm-135m bf16, batch 4), "
             f"{mamba_tok_s:.1f} tok/s (mamba2-130m bf16, batch 4), "
             f"{rg_tok_s:.1f} tok/s (recurrentgemma-9b at {RG_LAYERS} "
             f"layers, bf16, batch 4), " + ", ".join(
                 (f"{tok_s:.1f} tok/s" if tok_s is not None else "no Server")
                 + f" ({arch}, peak {peak:.2f} GiB)"
                 for arch, (_, tok_s, peak) in zoo.items()))
    finish_node_counts(node_counts)
    sm = "seamless-m4t-medium"
    log("k", f"slice 20's new work: the zt row of {sm} "
             f"{zt[sm]['seconds']:.1f} s, its (tk) steps "
             f"{tpk_seconds[sm]:.1f} s (its (c) and (p) cases above); the "
             f"cut: paligemma-3b at the reference's init in (y), "
             f"{zoo_result['paligemma-3b']['ref_seconds']:.1f} s at "
             f"{VLM_REF_LAYERS} layers")
    log("k", f"chip_smoke ran {time.perf_counter() - start:.1f} s")
    # each kernel's row at the shape its first main path launches; flash
    # attention runs on two paths: its launches are both paths', and its
    # row at recurrentgemma's shape (D 256, window 2048) rides along
    flash_row = record_row(
        "flash_attention", "src/repro_torch/kernels/flash_attention/csrc/"
        "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:93",
        smollm_counts["flash_attention"] + train_counts["flash_attention"]
        + elastic_counts["flash_attention"] + rg_counts["flash_attention"]
        + sum(counts["flash_attention"] for counts, _, _ in zoo.values())
        + rg_train["flash_attention"] + qwen_train["flash_attention"]
        + tps_counts["flash_attention"] + tp["flash_attention"]
        + tpk["flash_attention"]
        + sum(v["counts"]["flash_attention"] for v in zt.values()),
        flash_err[64], flash_rows["prefill-512"],
        f"B{PREFILL_B} H9 KV3 S{PREFILL_S} D64 bf16 causal, (B, S, H, D) "
        "views")
    flash_row["launches_by_path"] = {
        "smollm-135m": smollm_counts["flash_attention"],
        "smollm-135m training": train_counts["flash_attention"],
        "smollm-135m elastic training": elastic_counts["flash_attention"],
        "recurrentgemma-9b": rg_counts["flash_attention"],
        "recurrentgemma-9b training": rg_train["flash_attention"],
        "qwen3-4b training": qwen_train["flash_attention"],
        "smollm-135m training at model_ways 2": tps_counts["flash_attention"],
        "qwen3-4b training at model_ways 2 and 4": tp["flash_attention"],
        "recurrentgemma-9b, deepseek-moe-16b and seamless-m4t-medium "
        "training at model_ways 2 and 4": tpk["flash_attention"],
        **{arch: counts["flash_attention"]
           for arch, (counts, _, _) in zoo.items()},
        **{zt_path(arch, v): v["counts"]["flash_attention"]
           for arch, v in zt.items()}}
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
    # and at one model coordinate's heads of qwen3-4b's train call at
    # model_ways 2 (its launches: the whole tensor-parallel path's)
    flash_row["qwen3_tp2"] = record_row(
        "flash_attention", flash_row["source"], flash_row["replaces"],
        tp["flash_attention"], flash_err[128], flash_rows["qwen3-tp2-4096"],
        "B2 H16 KV4 S4096 D128 bf16 causal, (B, S, H, D) views: one model "
        "coordinate's heads at model_ways 2")
    # and slice 10's calls: paligemma-3b's prefill (D 256, no window, GQA
    # 8 / 1), seamless-m4t-medium's non-causal ones (its whole path's
    # launches beside each)
    for label, arch in (("paligemma-512", "paligemma-3b"),
                        ("seamless-512", "seamless-m4t-medium"),
                        ("seamless-cross-264", "seamless-m4t-medium")):
        b, h, kv, sq, sk, d, causal = SLICE10_CALLS[label]
        flash_row[label] = record_row(
            "flash_attention", flash_row["source"], flash_row["replaces"],
            zoo[arch][0]["flash_attention"], flash_err[label],
            flash_rows[label],
            f"B{b} H{h} KV{kv} Sq{sq} Sk{sk} D{d} bf16 "
            f"{'causal' if causal else 'non-causal'}, (B, S, H, D) views")
    # and slice 19's training calls (zt): gemma2-27b's local layer, with its
    # softcap; paligemma-3b's at B 8; granite-3-2b's (each path's launches)
    for label, arch in ZT_ROWS.items():
        flash_row[label] = zt_record_row(
            "flash_attention", flash_row, label, zt[arch], flash_err[label],
            flash_rows[label])
    ssd_row = record_row(
        "ssd_scan", "src/repro_torch/kernels/ssd/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd/kernel.py:67", mamba_counts["ssd_scan"],
        ssd_err, ssd_rows["prefill-512"],
        f"B{PREFILL_B} S{PREFILL_S} H24 P64 N128 chunk 128 bf16, views of "
        "the conv output")
    ssd_row["launches"] += m_train_counts["ssd_scan"] + tpk["ssd_scan"]
    ssd_row["launches_by_path"] = {
        "mamba2-130m": mamba_counts["ssd_scan"],
        "mamba2-130m training": m_train_counts["ssd_scan"],
        "mamba2-130m at model_ways 2 and 4": tpk["ssd_scan"]}
    # CUDA kernels one wrapper call launched at this shape, under the
    # profiler in this run (the passes: chunk states, state passing, chunk
    # outputs)
    ssd_row["cuda_kernels_per_launch"] = ssd_rows["prefill-512"][
        "cuda_kernels"]
    rglru_row = record_row(
        "rglru_scan", "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
        "src/repro/kernels/rglru/kernel.py:39", rg_counts["rglru_scan"],
        rglru_err["prefill"], rglru_rows["prefill-512"],
        f"B{PREFILL_B} S{PREFILL_S} W4096 fp32, the gates of every rglru "
        "layer")
    rglru_row["launches"] += rg_train["rglru_scan"] + tpk["rglru_scan"]
    rglru_row["launches_by_path"] = {
        "recurrentgemma-9b": rg_counts["rglru_scan"],
        "recurrentgemma-9b training": rg_train["rglru_scan"],
        "recurrentgemma-9b training at model_ways 2 and 4":
            tpk["rglru_scan"]}
    # and at recurrentgemma's training call, B 1, S 4096
    rglru_row["train"] = record_row(
        "rglru_scan", rglru_row["source"], rglru_row["replaces"],
        rg_train["rglru_scan"], rglru_err["train"], rglru_rows["train-4096"],
        f"B1 S{RG_TRAIN_S} W4096 fp32, the gates of every rglru layer in "
        "training")
    b, s, h, p, n, chunk, layout = bench.SSD_BWD_SHAPES["train-2048"]
    ssd_bwd_row = record_row(
        "ssd_scan_bwd", "src/repro_torch/kernels/ssd/csrc/ssd_scan_bwd.cu",
        "none: the Pallas kernel has no backward; the reference trains "
        "through XLA's autodiff of ssd_chunked (src/repro/models/ssm.py:53)",
        m_train_counts["ssd_scan_bwd"] + tpk["ssd_scan_bwd"],
        scan_bwd_err["ssd"],
        ssd_bwd_rows["train-2048"], f"B{b} S{s} H{h} P{p} N{n} chunk "
        f"{chunk} bf16, views of the conv output, from the forward's "
        "workspace")
    ssd_bwd_row["launches_by_path"] = {
        "mamba2-130m training": m_train_counts["ssd_scan_bwd"],
        "mamba2-130m training at model_ways 2 and 4": tpk["ssd_scan_bwd"]}
    ssd_bwd_row["cuda_kernels_per_launch"] = ssd_bwd_rows["train-2048"][
        "cuda_kernels"]
    # each CUDA kernel of one call, device ms under the profiler
    ssd_bwd_row["cuda_kernel_ms"] = {
        name: ms for name, ms, _ in ssd_bwd_rows["train-2048"]["passes"]}
    b, s, w = bench.RGLRU_BWD_SHAPES["train-4096"]
    rglru_bwd_row = record_row(
        "rglru_scan_bwd", "src/repro_torch/kernels/rglru/csrc/rglru_scan.cu",
        "none: the Pallas kernel has no backward; the reference trains "
        "through XLA's autodiff of its associative scan "
        "(src/repro/models/rglru.py:56)",
        rg_train["rglru_scan_bwd"] + tpk["rglru_scan_bwd"],
        scan_bwd_err["rglru"], rglru_bwd_rows["train-4096"],
        f"B{b} S{s} W{w} fp32, from the forward's h")
    rglru_bwd_row["launches_by_path"] = {
        "recurrentgemma-9b training": rg_train["rglru_scan_bwd"],
        "recurrentgemma-9b training at model_ways 2 and 4":
            tpk["rglru_scan_bwd"]}
    b, h, kv, s, d, *_ = bench.BWD_SHAPES["train-2048"]
    bwd_row = record_row(
        "flash_attention_bwd", "src/repro_torch/kernels/flash_attention/"
        "csrc/flash_attention_bwd.cu", "none: the Pallas kernel has no "
        "backward; the reference trains through XLA's autodiff of "
        "chunked_attention (src/repro/models/attention.py:94)",
        train_counts["flash_attention_bwd"]
        + elastic_counts["flash_attention_bwd"]
        + sum(counts["flash_attention_bwd"] for counts, _, _ in zoo.values())
        + rg_train["flash_attention_bwd"] + qwen_train["flash_attention_bwd"]
        + tps_counts["flash_attention_bwd"] + tp["flash_attention_bwd"]
        + tpk["flash_attention_bwd"]
        + sum(v["counts"]["flash_attention_bwd"] for v in zt.values()),
        bwd_err[(d, s)],
        bwd_rows["train-2048"], f"B{b} H{h} KV{kv} S{s} D{d} bf16 causal, "
        "(B, S, H, D) views, dq / dk / dv from the forward's lse")
    bwd_row["launches_by_path"] = {
        "smollm-135m training": train_counts["flash_attention_bwd"],
        "smollm-135m elastic training":
            elastic_counts["flash_attention_bwd"],
        "seamless-m4t-medium training":
            zoo["seamless-m4t-medium"][0]["flash_attention_bwd"],
        "recurrentgemma-9b training": rg_train["flash_attention_bwd"],
        "qwen3-4b training": qwen_train["flash_attention_bwd"],
        "smollm-135m training at model_ways 2":
            tps_counts["flash_attention_bwd"],
        "qwen3-4b training at model_ways 2 and 4": tp["flash_attention_bwd"],
        "recurrentgemma-9b, deepseek-moe-16b and seamless-m4t-medium "
        "training at model_ways 2 and 4": tpk["flash_attention_bwd"],
        **{zt_path(arch, v): v["counts"]["flash_attention_bwd"]
           for arch, v in zt.items()}}
    # CUDA kernels one call launched at this shape, under the profiler in
    # this run, and each one's device ms (delta, the main pass, dq)
    bwd_row["cuda_kernels_per_launch"] = sum(
        n for *_, n in flash_bwd_split["train-2048"])
    bwd_row["cuda_kernel_ms"] = {
        name: ms for name, ms, _ in flash_bwd_split["train-2048"]}
    # and at recurrentgemma's training call: D 256, window 2048, S 4096
    b, h, kv, s, d, _, window, _ = bench.BWD_SHAPES["recurrentgemma-4096"]
    bwd_row["recurrentgemma"] = record_row(
        "flash_attention_bwd", bwd_row["source"], bwd_row["replaces"],
        rg_train["flash_attention_bwd"], bwd_err[(d, s)],
        bwd_rows["recurrentgemma-4096"], f"B{b} H{h} KV{kv} S{s} D{d} bf16 "
        f"causal, window {window}, (B, S, H, D) views, dq / dk / dv from the "
        "forward's lse")
    # and at qwen3-4b's: D 128, GQA 32 / 8, S 4096, B 2, its bf16 steps
    b, h, kv, s, d, *_ = bench.BWD_SHAPES["qwen3-4096"]
    bwd_row["qwen3"] = record_row(
        "flash_attention_bwd", bwd_row["source"], bwd_row["replaces"],
        qwen_train["flash_attention_bwd"], bwd_err[(d, s)],
        bwd_rows["qwen3-4096"], f"B{b} H{h} KV{kv} S{s} D{d} bf16 causal, "
        "(B, S, H, D) views, dq / dk / dv from the forward's lse")
    # and at one model coordinate's heads of qwen3-4b's at model_ways 2
    b, h, kv, s, d, *_ = bench.BWD_SHAPES["qwen3-tp2-4096"]
    bwd_row["qwen3_tp2"] = record_row(
        "flash_attention_bwd", bwd_row["source"], bwd_row["replaces"],
        tp["flash_attention_bwd"], bwd_err[(d, s)],
        bwd_rows["qwen3-tp2-4096"], f"B{b} H{h} KV{kv} S{s} D{d} bf16 "
        "causal, (B, S, H, D) views, dq / dk / dv from the forward's lse: "
        "one model coordinate's heads at model_ways 2")
    # and slice 19's training calls: gemma2's local layer (the softcap
    # route), paligemma's (the bf16 D 256 route without a window), granite's
    for label, arch in ZT_ROWS.items():
        bwd_row[label] = zt_record_row(
            "flash_attention_bwd", bwd_row, label, zt[arch], bwd_err[label],
            bwd_rows[label])
        bwd_row[label]["cuda_kernel_ms"] = {
            name: ms for name, ms, _ in flash_bwd_split[label]}
    # the library's backward in device time (a CUDA graph, like the
    # kernel's), its eager call, and the backend PyTorch picked
    bwd_row["library_eager_ms"] = bwd_rows["train-2048"]["library_eager_ms"]
    bwd_row["library_backend"] = bwd_rows["train-2048"]["library_backend"]
    # the reshard's copies: one launch a resize on the card, on every path
    # that resizes (the elastic loops, the apps' states, the calibration)
    box_row = {"name": "box_copy", "route": "cuda",
               "source": "src/repro_torch/kernels/reshard/csrc/box_copy.cu",
               "replaces": "none: the reference's reshard is jax.device_put "
                           "(src/repro/core/reshard.py:42)",
               "launches": elastic_counts["box_copy"]
               + tps_counts["box_copy"] + calib_counts["box_copy"],
               "max_abs_err": box_err,
               **{k: box_times[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")},
               "shape": f"{smollm.name} TrainState expand 2 -> 4 virtual "
                        f"slices: {box_times['pieces']} pieces, "
                        f"{box_times['copied'] / 1e9:.3f} GB copied, one "
                        "launch",
               "library": "torch._foreach_copy_ over the pieces' views",
               "launches_by_path": {
                   "smollm-135m elastic training": elastic_counts["box_copy"],
                   "smollm-135m elastic training at model_ways 2":
                       tps_counts["box_copy"],
                   "apps' reshards and the calibration":
                       calib_counts["box_copy"]}}
    record = {"kernels": [flash_row, bwd_row, ssd_row, ssd_bwd_row,
                          rglru_row, rglru_bwd_row, box_row]}
    print(json.dumps(record))
    print(bench.card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit({"--zoo": main_zoo, "--rg-train": main_rg_train,
              "--qwen-train": main_qwen_train, "--tp": main_tp,
              "--tp-kinds": main_tp_kinds, "--zoo-train": main_zoo_train,
              "--host-work": main_host_work,
              "--node-count": main_node_count}.get(
        (sys.argv[1:] or [None])[0], main)())
