"""One run of one cell: set-up, the measured window, optionally a traced
window, the check against the reference, and the result line.

    python3 dmrbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The untraced run reports the cell's end-to-end metrics: ``setup_s``
(process start to the first timed step), ``train_tokens_per_s`` (the tokens
of every step of the window over the window's seconds, the window closing
on a synchronise, resizes inside it) and, where the cell resizes,
``reconfig_ms`` (the mean stall of the window's resizes). A traced run runs
the same window, then ``trace_steps`` more steps under torch.profiler, and
reports the cell's per-layer metrics, each read from the run's records by
its own reader (``metrics/<name>.py``), with the device's busy time and the
top device operations and idle gaps. Every run ends with the check
(``check.py``): once the window has closed and the peak memory has been
read, the program's state is freed and the reference follows the first
steps from the same weights and batches.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the JAX package and JAX itself, by top-level module name
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names=None) -> list:
    """The loaded modules (or ``names``) whose top-level name is
    forbidden."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def environment(root: Path) -> None:
    """Caches inside the checkout, at fixed paths; the allocator's
    expandable segments (granite's training state fills the card, PR 30);
    nothing that would load JAX through a library; no DMR inhibitor."""
    build = root / "build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    os.environ.pop("DMR_INHIBITOR_SECONDS", None)


def metric(value, unit: str) -> dict:
    return {"value": value, "unit": unit}


def run_cell(cell, seed: int, seconds: float, traced: bool, device,
             started: float) -> dict:
    """One run of ``cell`` (``spec.Cell``). Returns the result's fields and
    the check's rows (``checks``)."""
    import torch

    from dmrbench import check, trainrun
    run = trainrun.TrainCell(cell, seed, device)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    run.setup()
    setup_s = time.perf_counter() - started
    window = run.window(seconds)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    out = {"attempted": window["steps"], "failed": 0}
    if not traced:
        values = {"setup_s": setup_s,
                  "train_tokens_per_s": window["tokens"] / window["seconds"]}
        if window["resizes"]:
            values["reconfig_ms"] = 1e3 * sum(
                r["stall_s"] for r in window["resizes"]) / len(
                    window["resizes"])
        out["metrics"] = {k: metric(v, units[k]) for k, v in values.items()
                          if k in units}
    else:
        rec = {"m": run.m, "mix": run.mix, "window": window,
               "trace": run.traced()}
        values = {name: read(rec) for name, read in cell.readers.items()}
        out["metrics"] = {k: metric(v, units[k]) for k, v in values.items()
                          if v is not None}
        out["breakdown"] = {k: rec["trace"][k]
                            for k in ("device_ops", "idle_gaps")}
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    out["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": peak}
    if traced:
        out["device"].update(busy_s=rec["trace"]["busy_s"],
                             window_s=rec["trace"]["window_s"])
    program = run.readings
    run.free()
    values = check.numbers(program, run.reference_readings())
    out["correct"], out["checks"] = check.verdict(values, cell.limits)
    return out


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, started: float = None, root: Path = ROOT) -> int:
    started = time.perf_counter() if started is None else started
    args = parse(argv)
    environment(root)
    import torch

    import repro_torch  # noqa: F401  (the program: nothing runs without it)
    from dmrbench.spec import Bench
    cell = Bench(root).cell(args.workload)
    if not torch.cuda.is_available():
        print("dmrbench: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"dmrbench: {args.workload} needs {cell.entry['chips']} "
              f"cards, {torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), started)
    bad = forbidden_modules()
    if bad:
        print(f"dmrbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, row in out["checks"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    checks = {k: {n: (v if math.isfinite(v) else None) for n, v in r.items()}
              for k, r in out.pop("checks").items()}
    line = {k: out[k] for k in ("correct", "attempted", "failed", "metrics",
                                "device", "breakdown") if k in out}
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0
