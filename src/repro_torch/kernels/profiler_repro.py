"""Replay, each in a fresh process, the sequences that have left
torch.profiler partly blank in a long process, and count what a later
profile of two known calls shows.

    PYTHONPATH=src python -m repro_torch.kernels.profiler_repro [NAME ...]

The known calls: the flash forward at smollm-135m's S 2048 call
(``bench.SHAPES["smollm-2048"]``, one CUDA kernel) and its backward at the
train call (``bench.BWD_SHAPES["train-2048"]``, three). In each process
both are profiled once before the sequence, then ROUNDS times after it in
each of MODES, each in a profiler session of its own (``probe``): plain;
with host sleep on each side of the call; after bench.sentinel's kernels,
as bench.session starts; after them and with CUPTI's records flushed by
force before the session ends. Each profile is counted: the known call's
kernels among Kineto's raw device events (``kineto_results.events()``)
and among the parsed events that ``prof.events()`` returns, each with how
many have no device time, every device event, and the CUDA runtime's
kernel launches on the host; their difference is the kernels the session
lost. A probe is blank when it lists fewer of the known call's kernels
than the call launched, or one without device time. Each process prints
one JSON line; the parent prints a row per sequence (the blank probes and
the kernels lost a session, by mode) and, from each child's standard
error, the lines that Kineto or CUPTI wrote.

The sequences (``SEQUENCES``): nothing; torch.profiler over a
``loss.backward()`` through the flash op (its backward kernel on autograd's
device thread), over a plain backward, over a bf16 train step; autograd
backwards outside any profile (two of ``ssd_ref`` at mamba2-130m's train
call, as before a split that missed a kernel; one of a small product);
``bench.profile_kernels`` (``bench --profile``); a model's prefill, decode
steps, Server and their profiles (the zoo phases), and each part alone; a
build of a new source, a child process, a library loaded again; many
profiles in a row; CUDA graphs of the forward and of autograd's backward
(bench's yardsticks).
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import time
from collections import Counter

import torch

from repro_torch.kernels.bench import base_name

# the known calls' CUDA kernels, by the names the profiler gives them
FWD_KERNELS = ("flash_fwd_bf16",)
BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_wgmma", "flash_bwd_dq")
LAUNCH = re.compile(r"^cu(da)?LaunchKernel")


def known_calls():
    """{"fwd": the forward call, "bwd": the backward call}, bf16."""
    from repro_torch.kernels import bench
    from repro_torch.kernels.flash_attention import kernel
    b, h, kv, s, d, layout, _, _ = bench.SHAPES["smollm-2048"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = bench.make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16, layout)
    b, h, kv, s, d, layout, _, _ = bench.BWD_SHAPES["train-2048"]
    bq, bk, bv = bench.make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16,
                                layout)
    do = torch.randn_like(bq)
    out, lse = kernel.flash_attention(bq, bk, bv, return_lse=True)
    return {"fwd": lambda: kernel.flash_attention(q, k, v),
            "bwd": lambda: kernel.flash_attention_bwd(bq, bk, bv, out, lse,
                                                      do)}


def probe(fn, names, pad_ms: float = 0.0, first=None, last=None) -> dict:
    """One call of ``fn`` (after one untimed) in a profiler session of its
    own, ``pad_ms`` of host sleep before and after it inside the session,
    after ``first()`` and before ``last()`` where given (bench.sentinel's
    kernels, cupti_flush), counted: ``raw`` / ``parsed`` the kernels of
    ``names`` among Kineto's raw device events / the parsed events,
    ``raw_zero`` / ``parsed_zero``
    how many of them have no device time, ``device`` every raw device
    event, ``launches`` the host's CUDA kernel launches, ``missing`` the
    names of the known kernels not listed; and on the clock of the
    session's events, in us from the host's time just inside the session
    (``time.time_ns``): ``trace_start`` Kineto's start of the trace,
    ``launch`` each kernel launch's start on the host, ``kernels`` each
    known kernel (name, start, end) as listed, ``leave`` the host's time
    just before the session ends."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        enter = time.time_ns()
        if first is not None:
            first()
        time.sleep(pad_ms / 1e3)
        fn()
        torch.cuda.synchronize()
        time.sleep(pad_ms / 1e3)
        if last is not None:
            last()
        leave = time.time_ns()
    results = prof.profiler.kineto_results
    raw = list(results.events())
    device = [e for e in raw if e.device_type() == DeviceType.CUDA]
    ours = [e for e in device if base_name(e.name()) in names]
    launches = sorted(e.start_ns() for e in raw
                      if e.device_type() == DeviceType.CPU
                      and LAUNCH.match(e.name()))
    parsed = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and base_name(e.name) in names]

    def us(ns):
        return round((ns - enter) / 1e3, 1)
    return {"raw": len(ours),
            "raw_zero": sum(e.duration_ns() <= 0 for e in ours),
            "parsed": len(parsed),
            "parsed_zero": sum(e.self_device_time_total <= 0
                               for e in parsed),
            "device": len(device), "launches": len(launches),
            "missing": sorted((Counter(names) - Counter(
                base_name(e.name()) for e in ours)).elements()),
            "trace_start": us(results.trace_start_ns()),
            "launch": [us(t) for t in launches],
            "kernels": [(base_name(e.name()), us(e.start_ns()),
                         us(e.end_ns())) for e in ours],
            "leave": us(leave)}


def cupti_flush() -> bool:
    """Make CUPTI hand over every activity record it holds now, complete or
    not (``cuptiActivityFlushAll`` with CUPTI_ACTIVITY_FLAG_FLUSH_FORCED),
    through the libcupti this process loaded for torch.profiler, a remedy
    tried at the end of a session ("flush"): it did not keep sessions whole
    (PERF.md). False where no libcupti is loaded or the call fails."""
    with open("/proc/self/maps") as maps:
        path = next((line.split()[-1] for line in maps
                     if "libcupti" in line.rsplit("/", 1)[-1]), None)
    if path is None:
        return False
    flush = ctypes.CDLL(path).cuptiActivityFlushAll
    flush.argtypes, flush.restype = [ctypes.c_uint32], ctypes.c_int
    return flush(1) == 0


def probe_both(calls, mode: str = "plain") -> dict:
    """Both known calls probed: "plain", "padded" (PAD_MS of host sleep on
    each side of the call), "sentinel" (bench.sentinel's kernels first, as
    bench.session) or "flush" (the sentinel's kernels first, cupti_flush
    last)."""
    from repro_torch.kernels import bench
    kw = {"plain": {}, "padded": {"pad_ms": PAD_MS},
          "sentinel": {"first": bench.sentinel},
          "flush": {"first": bench.sentinel, "last": cupti_flush}}[mode]
    return {"fwd": probe(calls["fwd"], FWD_KERNELS, **kw),
            "bwd": probe(calls["bwd"], BWD_KERNELS, **kw)}


def _smollm():
    """smollm-135m at its published widths on the card, seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("smollm-135m")
    model = build_model(cfg, device="cuda")
    return cfg, model, model.init(torch.Generator(device="cuda")
                                  .manual_seed(0))


def seq_control():
    """nothing"""


def seq_profiled_flash_backward():
    """torch.profiler over loss.backward() through the flash op at the
    backward's train call (the backward kernel on autograd's device
    thread)"""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import bench
    from repro_torch.kernels.flash_attention.ops import flash_attention_op
    b, h, kv, s, d, layout, _, _ = bench.BWD_SHAPES["train-2048"]
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (t.detach().requires_grad_(True) for t in bench.make_qkv(
        gen, b, h, kv, s, s, d, torch.bfloat16, layout))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        flash_attention_op(q, k, v).float().square().mean().backward()
        torch.cuda.synchronize()


def seq_profiled_plain_backward():
    """torch.profiler over a plain autograd backward (a product, no kernel
    of the port)"""
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(256, 256, device="cuda")
    w = torch.randn(256, 256, device="cuda", requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        (x @ w).square().sum().backward()
        torch.cuda.synchronize()


def seq_profiled_train_step():
    """torch.profiler over one bf16 ElasticTrainer.train_step of
    smollm-135m at B 8, S 2048 (a step_times reading)"""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import ElasticTrainer, TrainerConfig
    cfg, model, params = _smollm()
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=2048,
                      global_batch=8)
    trainer = ElasticTrainer(model, AdamWConfig(lr=1e-3), data,
                             TrainerConfig(steps=2))
    state = trainer.init_state(params=params)
    batch = {k: t.cuda() for k, t in SyntheticLMData(data).batch(0).items()}
    state = trainer.train_step(state, batch)[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        trainer.train_step(state, batch)
        torch.cuda.synchronize()


def seq_plain_backward_twice():
    """two autograd backwards of ssd_ref at mamba2-130m's train call, no
    profiler (as before a split that once missed flash_bwd_delta)"""
    from repro_torch.kernels import bench
    from repro_torch.kernels.ssd.ref import ssd_ref
    b, s, h, p, n, _, layout = bench.SSD_BWD_SHAPES["train-2048"]
    gen = torch.Generator(device="cuda").manual_seed(3)
    args = bench.make_ssd_inputs(gen, b, s, h, p, n, torch.bfloat16, layout)
    dy = torch.randn((b, s, h, p), generator=gen, device="cuda").to(
        torch.bfloat16)
    run = bench.backward_of(lambda *t: ssd_ref(*t)[0], args, dy)
    run()
    run()
    torch.cuda.synchronize()


def seq_small_backward():
    """one autograd backward of a small product, no profiler"""
    x = torch.randn(64, 64, device="cuda")
    w = torch.randn(64, 64, device="cuda", requires_grad=True)
    (x @ w).sum().backward()
    torch.cuda.synchronize()


def seq_bench_profile():
    """bench.profile_kernels (``bench --profile``): every kernel at every
    shape under the profiler, then the library backwards"""
    from repro_torch.kernels import bench
    bench.profile_kernels()


def seq_zoo():
    """smollm-135m's serving path as the zoo phases drive a model: prefill
    at B 4, S 512, 8 decode steps, Server.run, then device_profile of the
    prefill and a decode step"""
    from repro_torch.kernels import bench
    from repro_torch.runtime import Request, Server
    cfg, model, params = _smollm()
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (4, 520), generator=gen,
                         device="cuda")
    _, cache = model.prefill(params, toks[:, :512], max_len=520)
    for i in range(8):
        _, cache = model.decode_step(params, cache, toks[:, 512 + i:513 + i],
                                     512 + i)
    reqs = [Request(rid=i, prompt=toks[i % 4, :16 + i].cpu().numpy(),
                    max_new_tokens=8) for i in range(8)]
    Server(model, params, batch=4, max_len=64).run(reqs)
    bench.device_profile(lambda: model.prefill(params, toks[:, :512],
                                               max_len=513))
    bench.device_profile(lambda: model.decode_step(params, cache,
                                                   toks[:, :1], 512))


def _scratch():
    """A directory of the checkout's build/ for the sequences' files."""
    from repro_torch.kernels import build
    path = build.BUILD_DIR.parent / "profiler_repro"
    path.mkdir(parents=True, exist_ok=True)
    return path


def seq_build():
    """nvcc builds a source of one empty kernel, new to this process, and
    ctypes loads it (what kernels/build.py does at a kernel's first use)"""
    from repro_torch.kernels import build
    source = _scratch() / f"noop_{time.time_ns()}.cu"
    source.write_text('__global__ void noop() {}\n'
                      'extern "C" int noop_launch(void* stream) {\n'
                      '  noop<<<1, 1, 0, (cudaStream_t)stream>>>();\n'
                      '  return (int)cudaGetLastError();\n}\n')
    build.load(source)


def seq_fork():
    """a child process started and waited for (fork and exec, as nvcc's
    build runs), no kernel built"""
    subprocess.run([sys.executable, "-c", "pass"], check=True)


def seq_dlopen():
    """ctypes loads a copy of the built forward library under a new name,
    nothing built"""
    import shutil

    from repro_torch.kernels.flash_attention import kernel
    copy = _scratch() / f"copy_{time.time_ns()}.so"
    shutil.copy(kernel.load().path, copy)
    ctypes.CDLL(str(copy))


def seq_prefill():
    """one bf16 prefill of smollm-135m at B 4, S 512, no profiler"""
    cfg, model, params = _smollm()
    toks = torch.randint(0, cfg.vocab_size, (4, 512), device="cuda")
    model.prefill(params, toks, max_len=513)


def seq_server():
    """smollm-135m's Server.run over 8 requests, no profiler"""
    from repro_torch.runtime import Request, Server
    cfg, model, params = _smollm()
    gen = torch.Generator().manual_seed(4)
    reqs = [Request(rid=i, prompt=torch.randint(
        0, cfg.vocab_size, (16 + i,), generator=gen).numpy(),
        max_new_tokens=8) for i in range(8)]
    Server(model, params, batch=4, max_len=64).run(reqs)


def seq_profiled_prefill():
    """bench.device_profile of one bf16 prefill of smollm-135m at B 4,
    S 512 (a session of about 2500 kernels)"""
    from repro_torch.kernels import bench
    cfg, model, params = _smollm()
    toks = torch.randint(0, cfg.vocab_size, (4, 512), device="cuda")
    bench.device_profile(lambda: model.prefill(params, toks, max_len=513))


def seq_many_profiles():
    """thirty profiler sessions of the flash forward in a row"""
    calls = known_calls()
    for _ in range(30):
        probe(calls["fwd"], FWD_KERNELS)


def seq_graph():
    """a CUDA graph of the flash forward, captured and replayed
    (bench.graph_ms)"""
    from repro_torch.kernels import bench
    bench.graph_ms(known_calls()["fwd"])


def seq_graph_backward():
    """a CUDA graph of autograd's backward of scaled_dot_product_attention,
    captured and replayed (bench's library yardstick)"""
    from repro_torch.kernels import bench
    b, h, kv, s, d, layout, _, _ = bench.BWD_SHAPES["train-2048"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = bench.make_qkv(gen, b, h, kv, s, s, d, torch.bfloat16, layout)
    library, stream = bench.library_backward(q, k, v, torch.randn_like(q))
    bench.graph_ms(library, stream=stream)


SEQUENCES = {name[4:]: fn for name, fn in dict(globals()).items()
             if name.startswith("seq_")}


# host sleep before and after the known call inside a padded probe's
# session; the modes of the probes after a sequence, ROUNDS of each in turn
PAD_MS, MODES, ROUNDS = 20.0, ("plain", "padded", "sentinel", "flush"), 10


def blank(p: dict) -> bool:
    """Whether a probe lists fewer of its call's kernels than the call
    launched, or one without device time."""
    return bool(p["missing"] or p["parsed"] < p["raw"] or p["raw_zero"]
                or p["parsed_zero"])


def run_one(name: str) -> dict:
    """In this process: the known calls probed, the sequence, then ROUNDS
    rounds of a probe of each call in each of MODES."""
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = known_calls()
    before = probe_both(calls)
    SEQUENCES[name]()
    torch.cuda.synchronize()
    after = {mode: [] for mode in MODES}
    for _ in range(ROUNDS):
        for mode in MODES:
            after[mode].append(probe_both(calls, mode))
    return {"sequence": name, "before": before, "after": after,
            "cupti_flush": cupti_flush()}


def cell(p: dict) -> str:
    """A probe in a few words: what it listed and, for a blank one, where
    its launches and kernels fell in the session."""
    text = f"{p['raw']} listed"
    if p["missing"]:
        text += f", missing {p['missing']}"
    if p["raw_zero"] or p["parsed_zero"] or p["parsed"] != p["raw"]:
        text += (f" ({p['raw_zero']} raw, {p['parsed_zero']} parsed "
                 f"without time, {p['parsed']} parsed)")
    if blank(p):
        text += (f"; trace start {p['trace_start']} us, launches at "
                 f"{p['launch']} us, kernels {p['kernels']} us, left at "
                 f"{p['leave']} us")
    return text


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("profiler_repro: no CUDA device available", file=sys.stderr)
        return 2
    if argv[:1] == ["--one"]:
        print(json.dumps(run_one(argv[1])), flush=True)
        return 0
    from repro_torch.kernels import bench
    print(f"{bench.card()}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}", flush=True)
    names = argv or list(SEQUENCES)
    out, failed = [], 0
    for name in names:
        proc = subprocess.run([sys.executable, "-m", __spec__.name, "--one",
                               name], capture_output=True, text=True,
                              check=False)
        notes = [line for line in proc.stderr.splitlines()
                 if re.search(r"kineto|cupti|profil|activit", line, re.I)]
        if proc.returncode != 0:
            failed += 1
            print(f"{name}: exit {proc.returncode}\n{proc.stderr[-3000:]}",
                  flush=True)
            continue
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["notes"] = notes[:20]
        out.append(rec)
        doc = " ".join((SEQUENCES[name].__doc__ or "").split())
        counts = {mode: {k: sum(blank(p[k]) for p in probes)
                         for k in ("fwd", "bwd")}
                  for mode, probes in rec["after"].items()}
        # kernels launched and not listed, each probe, each mode: the lost
        lost = {mode: [p[k]["launches"] - p[k]["device"] for p in probes
                       for k in ("fwd", "bwd")]
                for mode, probes in rec["after"].items()}
        print(f"{name} ({doc}; libcupti's forced flush "
              f"{'called' if rec['cupti_flush'] else 'not found'}): before: "
              f"forward "
              f"{cell(rec['before']['fwd'])}; backward "
              f"{cell(rec['before']['bwd'])}; after, blank probes of "
              f"{ROUNDS}: " + "; ".join(
                  f"{mode} forward {c['fwd']}, backward {c['bwd']}"
                  for mode, c in counts.items()), flush=True)
        print("  kernels lost a session, by mode: " + "; ".join(
            f"{mode} {dict(sorted(Counter(n).items()))}"
            for mode, n in lost.items()), flush=True)
        for mode, probes in rec["after"].items():
            shown = [(k, p[k]) for p in probes for k in ("fwd", "bwd")
                     if blank(p[k])][:3]
            for k, p in shown:
                print(f"  {mode} {k}: {cell(p)}", flush=True)
        for line in dict.fromkeys(notes):
            print(f"  stderr: {line}", flush=True)
    print(json.dumps({"profiler_repro": out}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
