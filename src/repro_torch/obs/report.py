"""Decision-audit CLI over ``repro.obs`` artifacts.

``python -m repro_torch.obs run.obs.json`` renders three deterministic text
sections from a trace artifact:

- the per-job time breakdown (queued / compute / reconfig attribution —
  the per-job timeline currency of the malleable-scheduling evaluations);
- the DMR action ledger: expand/shrink/no-action (and every disruption
  and capacity action) counted by vocabulary reason — the paper's
  Table-2 shape.  Ledger counts sum to the run's exact ``ActionRecord``
  total, which is what makes it an *audit*;
- the serving SLO timeline summary (violations, served requests, p99).

``--check GOLDEN`` byte-compares the rendered report against a golden
file (CI uses this on the churn smoke artifact).  All rendering returns
strings; only ``main`` prints.
"""
from __future__ import annotations

import argparse
import json
from typing import List

from repro_torch.obs.export import SCHEMA_ID, SCHEMA_VERSION


def load_artifact(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    if doc.get("schema") != SCHEMA_ID:
        raise ValueError(f"{path}: not a {SCHEMA_ID} artifact")
    if doc.get("version") != SCHEMA_VERSION:
        raise ValueError(f"{path}: schema version {doc.get('version')!r}, "
                         f"expected {SCHEMA_VERSION}")
    return doc


def _fmt(value, width: int = 9, digits: int = 2) -> str:
    if value is None:
        return "-".rjust(width)
    return f"{value:>{width}.{digits}f}"


def job_table(doc: dict) -> str:
    lines = ["== per-job time breakdown =="]
    header = (f"{'job':>4} {'app':<10} {'state':<10} {'submit':>9} "
              f"{'start':>9} {'end':>9} {'queued':>9} {'run':>9} "
              f"{'reconfig':>9} {'compute':>9} {'resizes':>7}")
    lines.append(header)
    for j in doc["jobs"]:
        lines.append(
            f"{j['job_id']:>4} {j['app']:<10.10} {j['state']:<10.10} "
            f"{_fmt(j['submit_t'])} {_fmt(j['start_t'])} "
            f"{_fmt(j['end_t'])} {_fmt(j['queued_s'])} "
            f"{_fmt(j['run_s'])} {_fmt(j['reconfig_s'])} "
            f"{_fmt(j['compute_s'])} {j['resizes']:>7}")
    util = doc.get("utilization", {})
    lines.append(f"makespan {_fmt(doc['makespan'], 1)}s   "
                 f"utilization {_fmt(util.get('avg_pct'), 1)}% "
                 f"(std {_fmt(util.get('std_pct'), 1)}%)")
    return "\n".join(lines)


def ledger_table(doc: dict) -> str:
    lines = ["== DMR action ledger =="]
    lines.append(f"{'action':<18} {'reason':<28} {'count':>6} "
                 f"{'decide_s':>9} {'apply_s':>9}")
    total = 0
    for row in doc["ledger"]:
        total += row["count"]
        lines.append(f"{row['action']:<18.18} {row['reason']:<28.28} "
                     f"{row['count']:>6} {_fmt(row['decide_s'])} "
                     f"{_fmt(row['apply_s'])}")
    lines.append(f"{'total':<18} {'':<28} {total:>6}")
    return "\n".join(lines)


def slo_summary(doc: dict) -> str:
    lines = ["== serving SLO summary =="]
    serving = doc.get("serving", {})
    if not serving:
        lines.append("(no serving jobs)")
        return "\n".join(lines)
    lines.append(f"{'job':>4} {'violations':>10} {'served':>12} "
                 f"{'p99_s':>9}")
    for jid, s in sorted(serving.items(), key=lambda kv: int(kv[0])):
        lines.append(f"{int(jid):>4} {s['slo_violations']:>10} "
                     f"{_fmt(s['served_requests'], 12)} "
                     f"{_fmt(s['p99_s'])}")
    return "\n".join(lines)


def render_report(doc: dict) -> str:
    return "\n\n".join(
        [job_table(doc), ledger_table(doc), slo_summary(doc)]) + "\n"


def ledger_total(doc: dict) -> int:
    """Total actions accounted for by the ledger (== ActionRecord count)."""
    return sum(row["count"] for row in doc["ledger"])


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Render the decision-audit report of a repro.obs "
                    "trace artifact.")
    parser.add_argument("artifact", help="path to a <run>.obs.json file")
    parser.add_argument("--check", metavar="GOLDEN",
                        help="byte-compare the rendered report against "
                             "this golden file; exit 1 on drift")
    parser.add_argument("--section", choices=("all", "jobs", "ledger",
                                              "slo"), default="all")
    args = parser.parse_args(argv)
    doc = load_artifact(args.artifact)
    if args.section == "jobs":
        text = job_table(doc) + "\n"
    elif args.section == "ledger":
        text = ledger_table(doc) + "\n"
    elif args.section == "slo":
        text = slo_summary(doc) + "\n"
    else:
        text = render_report(doc)
    if args.check:
        with open(args.check, "r", encoding="utf-8") as fh:
            golden = fh.read()
        if text != golden:
            print(f"OBS REPORT DRIFT vs {args.check}")
            print("--- got ---")
            print(text, end="")
            return 1
        print(f"obs report matches {args.check}")
        return 0
    print(text, end="")
    return 0
