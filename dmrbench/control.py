"""The readings a cell's limits are set from, in one process on the card.

    python3 dmrbench/control.py --workload <cell> --seeds 11 12 13 ... \
        [--control 3] [--faults half exchange] [--out FILE]

For each seed: the program's set-up (``trainrun.TrainCell.setup``, the very
steps a run checks) and the reference over the same weights and batches,
compared as a run compares them (``check.numbers``); for the first
``--control`` seeds also the control (the reference in float8 products, put
in the program's place) and each named fault of ``faults.py`` planted in the
program. One JSON line a reading, on standard output and in ``--out``. The
benchmark's runs never run this. The limits in ``limits/<cell>.json`` lie
between the program's largest reading and the smallest reading of the
control or of a fault that fails a number (see PERF.md).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def witness(cell):
    """``cell`` with the program computing in float32: a second witness of
    the program's numbers (its kernels' fp32 routes) against the
    reference."""
    import copy
    cell = copy.deepcopy(cell)
    cell.config["port"]["dtype"] = "float32"
    return cell


def readings(cell, seed: int, device, kinds) -> list:
    """[(kind, numbers, its losses, the reference's)] of ``kinds``
    ("program", "fp32": the program computing in float32, "control", or
    a fault's name) at ``seed``, each against one reference run."""
    from dmrbench import check, faults, trainrun
    got = {}
    for kind in kinds:
        if kind == "control":
            continue
        run = trainrun.TrainCell(witness(cell) if kind == "fp32" else cell,
                                 seed, device)
        with (faults.FAULTS[kind]() if kind in faults.FAULTS
              else contextlib.nullcontext()):
            run.setup()
        got[kind] = run.readings
        run.free()
    run = trainrun.TrainCell(cell, seed, device)
    ref = run.reference_readings()
    if "control" in kinds:
        got["control"] = run.reference_readings("fp8")
    return [(k, check.numbers(got[k], ref), got[k]["losses"],
             ref["losses"], check.worst(got[k], ref)) for k in kinds]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fp32", type=int, default=0,
                   help="seeds of the float32 witness, among the first")
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from dmrbench.harness import environment
    environment(ROOT)
    from dmrbench.spec import Bench
    cell = Bench(ROOT).cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        kinds = ["program"] + (["fp32"] if i < args.fp32 else [])
        if i < args.control:
            kinds += ["control", *args.faults]
        for kind, numbers, losses, ref_losses, worst in readings(
                cell, seed, "cuda", kinds):
            line = json.dumps({"cell": args.workload, "seed": seed,
                               "kind": kind, "numbers": numbers,
                               "losses": losses, "ref_losses": ref_losses,
                               "worst": worst})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
