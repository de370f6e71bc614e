"""Byte-deterministic trace artifacts: obs JSON, JSONL spans, Perfetto.

Three renderings of one :class:`~repro_torch.obs.recorder.TraceRecorder`:

- ``<prefix>.obs.json`` — the ``repro.obs`` schema-v1 artifact (spans +
  metrics + per-job breakdown + DMR ledger), golden-locked in CI;
- ``<prefix>.spans.jsonl`` — one span per line, for streaming tooling;
- ``<prefix>.perfetto.json`` — Chrome trace-event JSON loadable in
  Perfetto / ``chrome://tracing``: jobs as tracks, DMR negotiations and
  disruptions on per-job negotiation tracks, resizes as flow arrows from
  the negotiation to the job track, metrics as counter tracks.

Determinism: floats are rounded to 6 digits at export (non-finite maps
to ``null``), spans are sorted by ``(t0, track, name, dur)``, and every
JSON document is dumped with ``sort_keys=True`` — two identical runs
produce byte-identical files (the contract ``docs/determinism.md``
extends to trace artifacts).
"""
from __future__ import annotations

import json
import os
from typing import List

from repro_torch.obs.metrics import _num

SCHEMA_ID = "repro.obs"
SCHEMA_VERSION = 1

# Perfetto process ids: one per track family.
_PID_JOBS = 1        # job lifecycle tracks
_PID_DMR = 2         # per-job DMR negotiation / disruption / SLO tracks
_PID_CLUSTER = 3     # cluster capacity track
_PID_METRICS = 4     # counter tracks


def build_artifact(rec) -> dict:
    """The schema-v1 obs document for a finalized recorder."""
    if not rec._finalized:
        raise RuntimeError("finalize(report) the recorder before export")
    spans = sorted(rec.spans, key=lambda s: (s.t0, s.track, s.name, s.dur))
    avg, std = rec.utilization()
    return {
        "schema": SCHEMA_ID,
        "version": SCHEMA_VERSION,
        "meta": {str(k): rec.meta[k] for k in sorted(rec.meta)},
        "makespan": _num(rec.makespan),
        "utilization": {"avg_pct": _num(avg), "std_pct": _num(std)},
        "jobs": [_job_doc(j) for j in rec.jobs],
        "ledger": [{"action": row["action"], "reason": row["reason"],
                    "count": row["count"],
                    "decide_s": _num(row["decide_s"]),
                    "apply_s": _num(row["apply_s"])}
                   for row in rec.ledger()],
        "serving": {str(jid): {"slo_violations": s["slo_violations"],
                               "served_requests": _num(
                                   s["served_requests"]),
                               "p99_s": _num(s["p99_s"])}
                    for jid, s in sorted(rec.serving.items())},
        "spans": [_span_doc(s) for s in spans],
        "metrics": rec.metrics.to_doc(),
    }


def _job_doc(j: dict) -> dict:
    out = dict(j)
    for key in ("submit_t", "start_t", "end_t", "queued_s", "run_s",
                "reconfig_s", "compute_s"):
        out[key] = _num(out[key])
    return out


def _span_doc(span) -> dict:
    return {"name": span.name, "kind": span.kind, "track": span.track,
            "t0": _num(span.t0), "dur": _num(span.dur),
            "args": {k: (_num(v) if isinstance(v, float) else v)
                     for k, v in sorted(span.args.items())}}


def dumps_artifact(doc: dict) -> bytes:
    return (json.dumps(doc, indent=1, sort_keys=True) + "\n").encode()


def spans_jsonl(doc: dict) -> bytes:
    lines = [json.dumps(s, sort_keys=True, separators=(",", ":"))
             for s in doc["spans"]]
    return ("\n".join(lines) + "\n").encode() if lines else b""


# ---------------------------------------------------------------------------
# Chrome trace-event JSON (Perfetto)
# ---------------------------------------------------------------------------

def _us(t: float) -> float:
    v = round(t * 1e6, 3)
    return int(v) if v == int(v) else v


def _track_pid_tid(track: str):
    if track.startswith("job/"):
        return _PID_JOBS, int(track[4:]) + 1
    if track.startswith("dmr/job") or track.startswith("slo/job"):
        return _PID_DMR, int(track[7:]) + 1
    return _PID_CLUSTER, 1


def chrome_trace(doc: dict) -> dict:
    """Chrome trace-event rendering of an obs artifact document."""
    events: List[dict] = []
    threads = {}     # (pid, tid) -> thread name
    for pid, name in ((_PID_JOBS, "jobs"), (_PID_DMR, "dmr"),
                      (_PID_CLUSTER, "cluster"), (_PID_METRICS, "metrics")):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": name}})
    flow_id = 0
    for span in doc["spans"]:
        pid, tid = _track_pid_tid(span["track"])
        threads.setdefault((pid, tid), span["track"])
        ev = {"name": span["name"], "cat": span["kind"],
              "pid": pid, "tid": tid, "ts": _us(span["t0"]),
              "args": span["args"]}
        if span["dur"] and span["dur"] > 0:
            ev["ph"] = "X"
            ev["dur"] = _us(span["dur"])
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
        # a granted resize: flow arrow negotiation-track -> job track
        if span["kind"] == "dmr" and span["name"] in ("expand", "shrink") \
                and span["args"].get("from") != span["args"].get("to"):
            flow_id += 1
            job_tid = tid
            events.append({"ph": "s", "id": flow_id, "name": "resize",
                           "cat": "resize", "pid": pid, "tid": tid,
                           "ts": _us(span["t0"])})
            events.append({"ph": "f", "bp": "e", "id": flow_id,
                           "name": "resize", "cat": "resize",
                           "pid": _PID_JOBS, "tid": job_tid,
                           "ts": _us(span["t0"] + (span["dur"] or 0))})
            threads.setdefault((_PID_JOBS, job_tid),
                               f"job/{job_tid - 1}")
    for (pid, tid), name in sorted(threads.items()):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    for gauge in doc["metrics"]["gauges"]:
        label = gauge["name"]
        if gauge["labels"]:
            inner = ",".join(f"{k}={v}"
                             for k, v in sorted(gauge["labels"].items()))
            label = f"{label}{{{inner}}}"
        for t, v in gauge["samples"]:
            events.append({"ph": "C", "name": label, "pid": _PID_METRICS,
                           "tid": 0, "ts": _us(t),
                           "args": {"value": v}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"schema": doc["schema"],
                          "version": doc["version"]}}


def dumps_chrome(trace: dict) -> bytes:
    return (json.dumps(trace, sort_keys=True, separators=(",", ": "))
            + "\n").encode()


# ---------------------------------------------------------------------------
# File bundle
# ---------------------------------------------------------------------------

def write_trace(prefix: str, rec) -> dict:
    """Write the three artifacts under ``prefix``; returns their paths."""
    doc = build_artifact(rec)
    parent = os.path.dirname(prefix)
    if parent:
        os.makedirs(parent, exist_ok=True)
    paths = {"obs": prefix + ".obs.json",
             "spans": prefix + ".spans.jsonl",
             "perfetto": prefix + ".perfetto.json"}
    with open(paths["obs"], "wb") as fh:
        fh.write(dumps_artifact(doc))
    with open(paths["spans"], "wb") as fh:
        fh.write(spans_jsonl(doc))
    with open(paths["perfetto"], "wb") as fh:
        fh.write(dumps_chrome(chrome_trace(doc)))
    return paths
