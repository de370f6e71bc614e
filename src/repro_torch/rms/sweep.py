"""Parallel sweep driver: trace × policy × malleability-mix grids.

Trace replays are embarrassingly parallel (ROADMAP "engine-level parallel
sweeps"): every grid point is an independent, fully-seeded simulation.  This
module fans a grid of :class:`SweepPoint` across a ``multiprocessing`` pool
and emits one *versioned* artifact (JSON and/or CSV) whose byte content is
identical for serial and parallel runs — the golden-artifact regression
test (``tests/test_sweep_golden.py``) pins this.

Artifact schema (``SCHEMA_ID``/``SCHEMA_VERSION``): a JSON object

.. code-block:: json

    {"schema": "repro.rms.sweep", "version": 5,
     "grid": {"traces": [...], "policies": [...],
              "mixes": [[r,m,f,e,s], ...]},
     "results": [{"trace": ..., "policy": ..., "rigid": ...,
                  "calibration_id": "paper-fit", "churn": "", ...}]}

Schema v5 (this version) adds the SERVING job class: mixes widen to five
fractions — ``(rigid, moldable, malleable, evolving, serving)`` — and
rows carry the SLO axis next to makespan/node-hours: ``slo_violations``
(TrafficTick probes above the SLO), ``p99_latency`` (worst per-job p99
queueing delay, seconds) and ``served_requests`` (total request drain).
Pre-serving artifacts auto-upgrade with ``serving=0.0`` and zeroed
serving metrics, which is exactly what a fresh run of the same grid
produces — the existing golden files stay valid as v4 on disk.
Schema v4 added the elastic-capacity columns: ``churn``
(the named :data:`repro_torch.rms.capacity.CHURN_SCENARIOS` drain/join/power
schedule the row ran under, ``""`` for a fixed cluster), ``node_hours``
(integral of live capacity over the run — the cost axis next to
makespan), ``powered_off_hours`` (node·hours parked by the power
manager) and the capacity event counts ``drains`` / ``joins`` /
``power_offs`` / ``power_ons``.
Schema v3 added the ``calibration_id`` provenance column:
which reconfiguration-cost calibration (:mod:`repro_torch.calib` artifact) the
row was simulated under — ``"paper-fit"`` for the hand-fit Table 2/Fig. 3
constants.  A grid point carries the artifact path in
``SweepPoint.calibration`` (CLI ``--calibration``); the row records the
artifact's content-hash id, so results are machine-independent.
Schema v2 widened malleability mixes to four fractions —
``(rigid, moldable, malleable, evolving)`` — and added the ``evolving``
and ``phase_changes`` row columns.  Older artifacts load transparently:
:func:`load_artifact` upgrades v1, v2 and v3 in place (``evolving=0.0``,
``phase_changes=0``, ``calibration_id="paper-fit"``, ``churn=""`` with
``node_hours`` back-computed from the fixed capacity × makespan).

``results`` rows carry only deterministic fields (no wall-clock times),
floats rounded to :data:`ROUND_DIGITS` decimals, rows sorted by
:func:`row_key` — so ``dumps_artifact`` is reproducible byte-for-byte.
The same row schema is shared by ``benchmarks/trace_replay.py``,
``benchmarks/table4_throughput.py`` (via :func:`report_row`) and
``benchmarks/policy_zoo.py``.

Long grids are *resumable*: ``--journal path.jsonl`` appends every
completed row durably as it finishes (:mod:`repro_torch.rms.journal`),
``--resume`` skips journaled points (validating each against the grid
point's fingerprint), and ``--shard i/N`` deterministically partitions
the grid for multi-host chunking.  Because rows are re-sorted by
:func:`row_key` before serialization, a kill-resume-merge artifact is
byte-identical to a fresh serial run — the golden determinism contract
extends to journals (``tests/test_journal.py``).

CLI (the CI smoke step runs the ``--smoke`` grid with two workers)::

    PYTHONPATH=src python -m repro_torch.rms.sweep \\
        --trace tests/data/sample.swf \\
        --policies easy,sjf --mixes 0:0:1,0.5:0.25:0.25 --workers 2 \\
        --out sweep.json [--check tests/data/golden_sweep.json] [--smoke] \\
        [--journal sweep.jsonl [--resume]] [--shard 0/4]
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import io
import json
import multiprocessing
import os
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.calib.artifact import PAPER_FIT_ID

SCHEMA_ID = "repro.rms.sweep"
SCHEMA_VERSION = 5
ROUND_DIGITS = 6

#: Fixed CSV column order — the row schema, version ``SCHEMA_VERSION``.
COLUMNS = ("trace", "policy", "rigid", "moldable", "malleable", "evolving",
           "serving",
           "flexible", "scheduling", "num_nodes", "seed", "time_scale",
           "calibration_id", "churn", "jobs", "completed", "makespan_s",
           "util_avg_pct", "util_std_pct", "avg_wait_s", "avg_exec_s",
           "avg_completion_s", "node_hours", "powered_off_hours",
           "expands", "shrinks", "preempts", "requeues",
           "timeouts", "phase_changes", "drains", "joins", "power_offs",
           "power_ons", "slo_violations", "p99_latency", "served_requests")

#: Default smoke grid (2 policies × 3 mixes) — also the golden-artifact grid.
SMOKE_POLICIES = ("easy", "sjf")
SMOKE_MIXES = ((0.0, 0.0, 1.0, 0.0, 0.0), (0.5, 0.25, 0.25, 0.0, 0.0),
               (0.25, 0.15, 0.3, 0.3, 0.0))

#: Serving smoke grid (``--smoke --serving``): batch-vs-serving
#: co-scheduling mixes behind ``tests/data/golden_serving_sweep.json``.
#: ``preempt`` may shrink serving jobs for the batch head (the makespan
#: side of the trade-off); ``easy`` leaves them to SLO negotiation.
SMOKE_SERVING_POLICIES = ("easy", "preempt")
SMOKE_SERVING_MIXES = ((0.0, 0.0, 0.7, 0.0, 0.3),
                       (0.25, 0.0, 0.25, 0.2, 0.3),
                       (0.0, 0.0, 0.4, 0.0, 0.6))

Mix = Tuple[float, float, float, float, float]


def norm_mix(mix: Sequence[float]) -> Mix:
    """Normalize a 3-/4-/5-tuple mix to ``(rigid, moldable, malleable,
    evolving, serving)`` — shorter tuples are pre-v2/pre-v5 and carry no
    evolving/serving share."""
    vals = tuple(float(x) for x in mix)
    if len(vals) in (3, 4):
        return vals + (0.0,) * (5 - len(vals))
    if len(vals) != 5:
        raise ValueError(f"mix needs 3, 4 or 5 fractions, got {mix!r}")
    return vals


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One grid point: everything a worker needs to replay deterministically.

    ``trace`` is a filesystem path; the artifact stores its basename as the
    trace label so artifacts are machine-independent.
    """
    trace: str
    policy: str
    mix: Tuple[float, ...]  # (rigid, moldable, malleable[, evolving[, serving]])
    flexible: bool = True
    num_nodes: int = 64
    seed: int = 7
    scheduling: str = "sync"
    time_scale: float = 1.0
    max_jobs: Optional[int] = None
    # Path to a repro_torch.calib calibration artifact; None => paper-fit
    # constants.  The artifact's calibration_id lands in the row.
    calibration: Optional[str] = None
    # Named capacity-churn scenario (repro_torch.rms.capacity.CHURN_SCENARIOS):
    # scheduled drains/joins + power management; None/"" => fixed cluster.
    churn: Optional[str] = None
    # Observability replay: when set, the point runs under a
    # :class:`repro_torch.obs.recorder.TraceRecorder` and writes its span/
    # metrics/Perfetto artifacts under this directory.  Deliberately NOT
    # part of the journal key or fingerprint — tracing never changes the
    # row (the observer-effect guarantee, ``tests/test_obs.py``).
    trace_dir: Optional[str] = None

    @property
    def label(self) -> str:
        return os.path.basename(self.trace)

    @property
    def slug(self) -> str:
        """Deterministic per-point file stem for ``trace_dir`` artifacts."""
        m = norm_mix(self.mix)
        mix = "-".join(f"{x:g}" for x in m)
        parts = [self.label, self.policy, mix,
                 "flex" if self.flexible else "fixed", self.scheduling,
                 f"n{self.num_nodes}", f"s{self.seed}"]
        if self.churn:
            parts.append(f"churn_{self.churn}")
        return "__".join(parts).replace("/", "_")


def build_grid(traces: Sequence[str], policies: Sequence[str],
               mixes: Sequence[Sequence[float]],
               flexibles: Sequence[bool] = (True,),
               **fixed) -> List[SweepPoint]:
    """Cross product of the axes; ``fixed`` forwards SweepPoint fields."""
    return [SweepPoint(trace=t, policy=p, mix=norm_mix(m), flexible=f,
                       **fixed)
            for t in traces for p in policies for m in mixes
            for f in flexibles]


# ---------------------------------------------------------------------------
# Worker
# ---------------------------------------------------------------------------

def _action_counts(actions) -> Dict[str, int]:
    out = {"expands": 0, "shrinks": 0, "preempts": 0, "requeues": 0,
           "timeouts": 0, "phase_changes": 0, "drains": 0, "joins": 0,
           "power_offs": 0, "power_ons": 0}
    for a in actions:
        if a.timed_out:
            out["timeouts"] += 1
        elif a.action == "expand":
            out["expands"] += 1
        elif a.action == "shrink":
            out["shrinks"] += 1
        elif a.action == "preempt_shrink":
            out["preempts"] += 1
        elif a.action == "preempt_requeue":
            out["requeues"] += 1
        elif a.action == "phase_change":
            out["phase_changes"] += 1
        elif a.action == "node_drain":
            out["drains"] += 1
        elif a.action == "node_join":
            out["joins"] += 1
        elif a.action == "power_off":
            out["power_offs"] += 1
        elif a.action == "power_on":
            out["power_ons"] += 1
    return out


def report_row(report, *, trace: str, policy: str,
               mix: Sequence[float], flexible: bool,
               scheduling: str = "sync", seed: int = 7,
               time_scale: float = 1.0,
               calibration_id: str = PAPER_FIT_ID,
               churn: str = "") -> Dict[str, object]:
    """Serialize a :class:`~repro_torch.rms.simulator.SimReport` into the
    shared row schema — deterministic fields only, floats rounded."""
    from repro_torch.rms.job import JobState

    mix = norm_mix(mix)
    util_avg, util_std = report.utilization()
    wait, exec_, comp = report.averages()
    completed = sum(1 for j in report.jobs
                    if j.state is JobState.COMPLETED)
    row: Dict[str, object] = {
        "trace": trace, "policy": policy,
        "rigid": round(mix[0], ROUND_DIGITS),
        "moldable": round(mix[1], ROUND_DIGITS),
        "malleable": round(mix[2], ROUND_DIGITS),
        "evolving": round(mix[3], ROUND_DIGITS),
        "serving": round(mix[4], ROUND_DIGITS),
        "flexible": bool(flexible), "scheduling": scheduling,
        # provenance column: the *configured* initial capacity of the
        # point, not a denominator
        "num_nodes": report.config.num_nodes,    # lint: disable=CAP001
        "seed": seed,
        "time_scale": round(time_scale, ROUND_DIGITS),
        "calibration_id": calibration_id, "churn": churn or "",
        "jobs": len(report.jobs), "completed": completed,
        "makespan_s": round(float(report.makespan), ROUND_DIGITS),
        "util_avg_pct": round(float(util_avg), ROUND_DIGITS),
        "util_std_pct": round(float(util_std), ROUND_DIGITS),
        "avg_wait_s": round(float(wait), ROUND_DIGITS),
        "avg_exec_s": round(float(exec_), ROUND_DIGITS),
        "avg_completion_s": round(float(comp), ROUND_DIGITS),
        "node_hours": round(float(report.node_hours()), ROUND_DIGITS),
        "powered_off_hours": round(float(report.powered_off_hours()),
                                   ROUND_DIGITS),
        "slo_violations": int(report.slo_violations()),
        "p99_latency": round(float(report.p99_latency()), ROUND_DIGITS),
        "served_requests": round(float(report.served_requests()),
                                 ROUND_DIGITS),
    }
    row.update(_action_counts(report.actions))
    return row


def run_point(point: SweepPoint) -> Dict[str, object]:
    """Replay one grid point (top-level: picklable for worker pools)."""
    from repro_torch.rms.costmodel import ReconfigCostModel
    from repro_torch.rms.simulator import ClusterSimulator, SimConfig
    from repro_torch.rms.scheduler import SchedulerConfig
    from repro_torch.workload.swf import (MalleabilityMix, jobs_from_swf,
                                          parse_swf)

    m = norm_mix(point.mix)
    mix = MalleabilityMix(rigid=m[0], moldable=m[1], malleable=m[2],
                          evolving=m[3], serving=m[4])
    trace = parse_swf(point.trace)
    jobs, apps = jobs_from_swf(trace, num_nodes=point.num_nodes, mix=mix,
                               seed=point.seed, max_jobs=point.max_jobs,
                               time_scale=point.time_scale)
    from repro_torch.rms.capacity import churn_schedule

    drains, joins, capacity = churn_schedule(point.churn, point.num_nodes)
    cfg = SimConfig(num_nodes=point.num_nodes, flexible=point.flexible,
                    scheduling=point.scheduling, seed=point.seed,
                    sched=SchedulerConfig(policy=point.policy),
                    capacity=capacity, drains=drains, joins=joins)
    calibration_id = PAPER_FIT_ID
    if point.calibration:
        cost = ReconfigCostModel.from_artifact(point.calibration)
        cfg = dataclasses.replace(cfg, cost=cost)
        calibration_id = cost.calibration_id or PAPER_FIT_ID
    sim = ClusterSimulator(jobs, cfg, apps=apps)
    recorder = None
    if point.trace_dir:
        from repro_torch.obs.recorder import TraceRecorder
        recorder = TraceRecorder(sim, meta={
            "trace": point.label, "policy": point.policy,
            "mix": list(norm_mix(point.mix)),
            "flexible": bool(point.flexible),
            "scheduling": point.scheduling,
            "num_nodes": point.num_nodes, "seed": point.seed,
            "churn": point.churn or "",
            "calibration_id": calibration_id}).install()
    report = sim.run()
    if recorder is not None:
        from repro_torch.obs.export import write_trace
        recorder.finalize(report)
        write_trace(os.path.join(point.trace_dir, point.slug), recorder)
    return report_row(report, trace=point.label, policy=point.policy,
                      mix=point.mix, flexible=point.flexible,
                      scheduling=point.scheduling, seed=point.seed,
                      time_scale=point.time_scale,
                      calibration_id=calibration_id,
                      churn=point.churn or "")


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def row_key(row: Dict[str, object]) -> Tuple:
    """Canonical sort key: artifact row order is independent of worker
    completion order."""
    return (row["trace"], row["policy"], row["rigid"], row["moldable"],
            row["malleable"], row.get("evolving", 0.0),
            row.get("serving", 0.0),
            not row["flexible"], row["scheduling"],
            row["num_nodes"], row["seed"], row["time_scale"],
            row.get("calibration_id", PAPER_FIT_ID),
            row.get("churn", ""))


# Calibration artifacts are read once per path, not once per grid point:
# point keys/fingerprints need the content-hash id before any simulation
# runs, so resume can decide what to skip without touching the simulator.
_calibration_ids: Dict[str, str] = {}    # lint: disable=MUT002
# (the cache is keyed by path and holds content-hash ids, so a stale
# entry is impossible without editing the artifact file mid-process)


def _calibration_id(path: Optional[str]) -> str:
    if not path:
        return PAPER_FIT_ID
    cached = _calibration_ids.get(path)
    if cached is None:
        from repro_torch.calib.artifact import load_calibration
        cached = str(load_calibration(path)["calibration_id"])
        _calibration_ids[path] = cached
    return cached


def point_journal_key(point: SweepPoint) -> str:
    """The journal key for a grid point — the same tuple :func:`row_key`
    derives from the *finished* row, computed up front from the point so a
    resume can skip it without running anything.  JSON-encoded so it is a
    stable, hashable JSONL dict key."""
    m = norm_mix(point.mix)
    return json.dumps((point.label, point.policy,
                       round(m[0], ROUND_DIGITS), round(m[1], ROUND_DIGITS),
                       round(m[2], ROUND_DIGITS), round(m[3], ROUND_DIGITS),
                       round(m[4], ROUND_DIGITS),
                       not point.flexible, point.scheduling,
                       point.num_nodes, point.seed,
                       round(point.time_scale, ROUND_DIGITS),
                       _calibration_id(point.calibration),
                       point.churn or ""))


def point_fingerprint(point: SweepPoint) -> Dict[str, object]:
    """Full deterministic identity of a grid point — a superset of the key
    (``max_jobs`` changes results but is not a row column), recorded with
    each journal entry and verified on resume so a journal written under a
    different grid fails loudly instead of serving wrong rows."""
    m = norm_mix(point.mix)
    return {"trace": point.label, "policy": point.policy,
            "mix": [round(x, ROUND_DIGITS) for x in m],
            "flexible": bool(point.flexible),
            "num_nodes": point.num_nodes, "seed": point.seed,
            "scheduling": point.scheduling,
            "time_scale": round(point.time_scale, ROUND_DIGITS),
            "max_jobs": point.max_jobs,
            "calibration_id": _calibration_id(point.calibration),
            "churn": point.churn or ""}


def _run_indexed(item: Tuple[int, SweepPoint]) -> Tuple[int, Dict[str, object]]:
    """Pool worker for the journaled path: ``imap_unordered`` streams rows
    back as they complete, and the index ties each row to its journal key."""
    idx, point = item
    return idx, run_point(point)


def run_sweep(points: Sequence[SweepPoint], *, workers: int = 0,
              journal: Optional[str] = None,
              resume_from: Sequence[str] = ()) -> List[Dict[str, object]]:
    """Run the grid; ``workers <= 1`` is serial, else a spawn-context pool
    (spawn: safe after CUDA initialization in the parent).

    With ``journal`` set, every completed row is durably appended to that
    JSONL file the moment it finishes (kill-safe; see
    :mod:`repro_torch.rms.journal`).  With ``resume_from`` journals, points
    whose key is already journaled are *not* re-run — their rows are reused
    after a fingerprint check.  Either way the returned rows are sorted by
    :func:`row_key`, so the artifact is byte-identical to a fresh serial
    run of the same grid.
    """
    points = list(points)
    resume_paths = [p for p in resume_from if p]
    if journal is None and not resume_paths:
        # Fast path — unchanged from the pre-journal driver.
        if workers <= 1 or len(points) <= 1:
            rows = [run_point(p) for p in points]
        else:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(min(workers, len(points))) as pool:
                rows = pool.map(run_point, points)
        return sorted(rows, key=row_key)

    from repro_torch.rms.journal import GridJournal, JournalMismatch

    keyed = [(point_journal_key(p), point_fingerprint(p), p) for p in points]
    seen: Dict[str, Dict[str, object]] = {}
    for key, fp, _ in keyed:
        if key in seen and seen[key] != fp:
            raise ValueError(
                f"grid points collide on journal key {key}: same row "
                f"identity, different fingerprints ({seen[key]!r} vs "
                f"{fp!r}) — the journal cannot tell them apart")
        seen[key] = fp

    done = GridJournal.load_many(resume_paths)
    rows: List[Dict[str, object]] = []
    todo: List[Tuple[str, Dict[str, object], SweepPoint]] = []
    for key, fp, point in keyed:
        entry = done.get(key)
        if entry is None:
            todo.append((key, fp, point))
            continue
        recorded = entry.get("point")
        if recorded is not None and recorded != fp:
            raise JournalMismatch(
                f"journal entry {key} was produced by a different grid "
                f"point: recorded {recorded!r}, expected {fp!r}")
        rows.append(dict(entry["row"]))

    writer = GridJournal(journal) if journal else None
    try:
        if workers <= 1 or len(todo) <= 1:
            for key, fp, point in todo:
                row = run_point(point)
                if writer is not None:
                    writer.append(key, row, fp)
                rows.append(row)
        elif todo:
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(min(workers, len(todo))) as pool:
                items = [(i, point) for i, (_, _, point) in enumerate(todo)]
                for idx, row in pool.imap_unordered(_run_indexed, items):
                    key, fp, _ = todo[idx]
                    if writer is not None:
                        writer.append(key, row, fp)
                    rows.append(row)
    finally:
        if writer is not None:
            writer.close()
    return sorted(rows, key=row_key)


def artifact(rows: Sequence[Dict[str, object]],
             grid: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    return {"schema": SCHEMA_ID, "version": SCHEMA_VERSION,
            "grid": grid or {}, "results": list(rows)}


def dumps_artifact(doc: Dict[str, object]) -> str:
    """Canonical byte-stable serialization of an artifact."""
    return json.dumps(doc, sort_keys=True, indent=2) + "\n"


def write_artifact(path: str, doc: Dict[str, object]) -> None:
    with open(path, "w") as fh:
        fh.write(dumps_artifact(doc))


def _upgrade_v1(doc: Dict[str, object]) -> Dict[str, object]:
    """In-place v1 → v2: pre-evolving artifacts carry a zero evolving
    fraction and no phase changes."""
    for row in doc.get("results", []):
        row.setdefault("evolving", 0.0)
        row.setdefault("phase_changes", 0)
    grid = doc.get("grid") or {}
    if "mixes" in grid:
        grid["mixes"] = [list(norm_mix(m)) for m in grid["mixes"]]
    doc["version"] = 2
    return doc


def _upgrade_v2(doc: Dict[str, object]) -> Dict[str, object]:
    """In-place v2 → v3: pre-calibration artifacts were simulated under
    the hand-fit constants."""
    for row in doc.get("results", []):
        row.setdefault("calibration_id", PAPER_FIT_ID)
    doc["version"] = 3
    return doc


def _upgrade_v3(doc: Dict[str, object]) -> Dict[str, object]:
    """In-place v3 → v4: pre-elastic artifacts ran on a fixed cluster, so
    their node-hour integral is exactly capacity × makespan, nothing was
    ever parked, and no capacity events fired."""
    for row in doc.get("results", []):
        row.setdefault("churn", "")
        row.setdefault("node_hours", round(
            row["num_nodes"] * row["makespan_s"] / 3600.0, ROUND_DIGITS))
        row.setdefault("powered_off_hours", 0.0)
        for col in ("drains", "joins", "power_offs", "power_ons"):
            row.setdefault(col, 0)
    doc["version"] = 4
    return doc


def _upgrade_v4(doc: Dict[str, object]) -> Dict[str, object]:
    """In-place v4 → v5: pre-serving artifacts carry a zero serving
    fraction and no serving traffic, so every SLO metric is zero —
    exactly what a fresh v5 run of the same grid produces."""
    for row in doc.get("results", []):
        row.setdefault("serving", 0.0)
        row.setdefault("slo_violations", 0)
        row.setdefault("p99_latency", 0.0)
        row.setdefault("served_requests", 0.0)
    grid = doc.get("grid") or {}
    if "mixes" in grid:
        grid["mixes"] = [list(norm_mix(m)) for m in grid["mixes"]]
    doc["version"] = SCHEMA_VERSION
    return doc


def load_artifact(path: str) -> Dict[str, object]:
    with open(path) as fh:
        doc = json.load(fh)
    if doc.get("schema") != SCHEMA_ID:
        raise ValueError(f"not a sweep artifact: schema={doc.get('schema')!r}")
    version = doc.get("version")
    if version == 1:
        doc = _upgrade_v1(doc)
        version = doc["version"]
    if version == 2:
        doc = _upgrade_v2(doc)
        version = doc["version"]
    if version == 3:
        doc = _upgrade_v3(doc)
        version = doc["version"]
    if version == 4:
        doc = _upgrade_v4(doc)
        version = doc["version"]
    if version != SCHEMA_VERSION:
        raise ValueError(f"sweep artifact version {version} != "
                         f"supported {SCHEMA_VERSION}")
    return doc


def _csv_line(values) -> str:
    buf = io.StringIO()
    csv.writer(buf, lineterminator="").writerow(list(values))
    return buf.getvalue()


def csv_lines(rows: Sequence[Dict[str, object]]) -> List[str]:
    """One CSV line per row under csv-module (RFC 4180) quoting: a trace
    name carrying a comma, quote, or newline round-trips through
    ``csv.reader`` instead of silently shifting every later column.
    Values without special characters serialize exactly as ``str(value)``
    did before, so normal-grid artifacts stay byte-identical."""
    lines = [_csv_line(COLUMNS)]
    for row in rows:
        lines.append(_csv_line(str(row.get(c, "")) for c in COLUMNS))
    return lines


def write_csv(path: str, rows: Sequence[Dict[str, object]]) -> None:
    with open(path, "w") as fh:
        fh.write("\n".join(csv_lines(rows)) + "\n")


def winners_by_mix(rows: Sequence[Dict[str, object]],
                   metric: str = "makespan_s") -> Dict[Tuple, str]:
    """Per ``(trace, rigid, moldable, malleable, evolving, serving)``: the
    policy minimizing ``metric`` (ties broken by policy name for
    determinism).

    The key must include the trace: keying by mix alone collapsed a
    multi-trace sweep into one winner table, silently crowning whichever
    trace happened to produce the global minimum ``metric`` for the mix.
    """
    best: Dict[Tuple, Tuple[float, str]] = {}
    for row in rows:
        key = (str(row.get("trace", "")), row["rigid"], row["moldable"],
               row["malleable"], row.get("evolving", 0.0),
               row.get("serving", 0.0))
        cand = (float(row[metric]), str(row["policy"]))
        if key not in best or cand < best[key]:
            best[key] = cand
    return {key: policy for key, (_, policy) in sorted(best.items())}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def smoke_grid(trace: str, *, num_nodes: int = 64, seed: int = 7,
               churn: Optional[str] = None, serving: bool = False
               ) -> Tuple[List[SweepPoint], Dict[str, object]]:
    """The tiny deterministic grid behind ``--smoke`` and the golden
    artifacts (``tests/data/golden_sweep.json``; with ``churn="smoke"``,
    ``tests/data/golden_capacity_sweep.json``; with ``serving=True``,
    ``tests/data/golden_serving_sweep.json``) — keep them in sync by
    construction."""
    policies = SMOKE_SERVING_POLICIES if serving else SMOKE_POLICIES
    mixes = SMOKE_SERVING_MIXES if serving else SMOKE_MIXES
    points = build_grid([trace], policies, mixes, (True,),
                        num_nodes=num_nodes, seed=seed, churn=churn)
    grid = {"traces": [os.path.basename(trace)],
            "policies": list(policies),
            "mixes": [list(norm_mix(m)) for m in mixes],
            "flexibles": [True], "num_nodes": num_nodes, "seed": seed}
    if churn:
        grid["churn"] = churn
    return points, grid


def parse_mixes(spec: str) -> List[Mix]:
    """``"0:0:1,0.2:0.1:0.4:0.3"`` -> 5-tuples; 3-/4-field specs are
    pre-v2/pre-v5 and get zero evolving/serving shares."""
    mixes = []
    for part in spec.split(","):
        vals = tuple(float(x) for x in part.strip().split(":"))
        if len(vals) not in (3, 4, 5):
            raise ValueError(f"mix needs "
                             f"rigid:moldable:malleable[:evolving[:serving]],"
                             f" got {part!r}")
        mixes.append(norm_mix(vals))
    return mixes


def main(argv=None) -> int:
    default_trace = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                                 "tests", "data", "sample.swf")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="append", default=None,
                    help="SWF trace path (repeatable)")
    ap.add_argument("--policies", default="easy,fcfs")
    ap.add_argument("--mixes", default="0.2:0.2:0.6",
                    help="comma list of rigid:moldable:malleable")
    ap.add_argument("--fixed", action="store_true",
                    help="also sweep the fixed (non-malleable) configuration")
    ap.add_argument("--nodes", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--time-scale", type=float, default=1.0)
    ap.add_argument("--max-jobs", type=int, default=None)
    ap.add_argument("--calibration", default=None,
                    help="repro_torch.calib artifact path: simulate under its "
                         "fitted cost model (rows record its id)")
    ap.add_argument("--churn", default=None,
                    help="named capacity-churn scenario "
                         "(repro_torch.rms.capacity.CHURN_SCENARIOS): "
                         "scheduled drains/joins + CLUES-style power "
                         "management")
    ap.add_argument("--trace-dir", default=None, metavar="DIR",
                    help="replay every grid point under a TraceRecorder "
                         "and write repro_torch.obs span/metrics/Perfetto "
                         "artifacts into DIR (rows are unchanged: tracing "
                         "is observer-effect-free)")
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--journal", action="append", default=None,
                    metavar="PATH",
                    help="append completed rows to this JSONL journal as "
                         "they finish (kill-safe); repeatable — the first "
                         "path is the write target, and with --resume ALL "
                         "listed journals are read (shard merge)")
    ap.add_argument("--resume", action="store_true",
                    help="skip grid points already completed in the "
                         "--journal files (fingerprint-checked)")
    ap.add_argument("--shard", default=None, metavar="I/N",
                    help="run only grid points I, I+N, I+2N, ... of the "
                         "deterministic build order; merge shard journals "
                         "later with --resume")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fixed grid (the golden-artifact grid)")
    ap.add_argument("--serving", action="store_true",
                    help="with --smoke: the serving co-scheduling grid "
                         "(tests/data/golden_serving_sweep.json)")
    ap.add_argument("--out", default=None, help="write JSON artifact here")
    ap.add_argument("--csv", default=None, help="write CSV artifact here")
    ap.add_argument("--check", default=None,
                    help="golden JSON artifact to byte-compare against "
                         "(exit 1 on mismatch)")
    args = ap.parse_args(argv)
    if args.resume and not args.journal:
        ap.error("--resume needs at least one --journal to read")
    shard = None
    if args.shard:
        from repro_torch.rms.journal import parse_shard
        try:
            shard = parse_shard(args.shard)
        except ValueError as exc:
            ap.error(str(exc))

    traces = args.trace or [os.path.normpath(default_trace)]
    if args.churn:
        from repro_torch.rms.capacity import CHURN_SCENARIOS
        if args.churn not in CHURN_SCENARIOS:
            ap.error(f"unknown churn scenario {args.churn!r}; "
                     f"registered: {','.join(sorted(CHURN_SCENARIOS))}")
    if args.smoke:
        if args.calibration:
            ap.error("--smoke is the fixed paper-fit golden grid; "
                     "run a calibrated sweep without --smoke")
        points, grid = smoke_grid(traces[0], num_nodes=args.nodes,
                                  seed=args.seed, churn=args.churn,
                                  serving=args.serving)
    else:
        if args.serving:
            ap.error("--serving selects the serving smoke grid; without "
                     "--smoke, put a serving share in --mixes "
                     "(rigid:moldable:malleable:evolving:serving)")
        policies = [p.strip() for p in args.policies.split(",") if p.strip()]
        mixes = parse_mixes(args.mixes)
        flexibles = (False, True) if args.fixed else (True,)
        calibration_id = PAPER_FIT_ID
        if args.calibration:
            from repro_torch.calib.artifact import load_calibration
            calibration_id = str(
                load_calibration(args.calibration)["calibration_id"])
        points = build_grid(traces, policies, mixes, flexibles,
                            num_nodes=args.nodes, seed=args.seed,
                            time_scale=args.time_scale,
                            max_jobs=args.max_jobs,
                            calibration=args.calibration,
                            churn=args.churn)
        grid = {"traces": [os.path.basename(t) for t in traces],
                "policies": policies, "mixes": [list(m) for m in mixes],
                "flexibles": list(flexibles), "num_nodes": args.nodes,
                "seed": args.seed, "calibration_id": calibration_id}
        if args.churn:
            grid["churn"] = args.churn
    if shard is not None:
        # A shard artifact covers a subset of the grid and says so; the
        # merge run (--resume over all shard journals, no --shard) has no
        # "shard" key, so its bytes match a fresh serial full-grid run.
        points = points[shard[0]::shard[1]]
        grid = dict(grid)
        grid["shard"] = shard
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        points = [dataclasses.replace(p, trace_dir=args.trace_dir)
                  for p in points]
    journal_path = args.journal[0] if args.journal else None
    resume_from = tuple(args.journal) if args.resume else ()
    rows = run_sweep(points, workers=args.workers, journal=journal_path,
                     resume_from=resume_from)
    doc = artifact(rows, grid)
    for line in csv_lines(rows):
        print(line)
    if args.out:
        write_artifact(args.out, doc)
        print(f"# wrote {args.out} ({len(rows)} rows)")
    if args.csv:
        write_csv(args.csv, rows)
        print(f"# wrote {args.csv}")
    if args.check:
        golden = dumps_artifact(load_artifact(args.check))
        mine = dumps_artifact(doc)
        if golden != mine:
            print(f"# MISMATCH against {args.check}: artifact bytes differ "
                  f"(schema or semantics changed — regenerate the golden "
                  f"file only for intentional changes)")
            return 1
        print(f"# artifact matches {args.check}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
