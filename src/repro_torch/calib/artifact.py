"""Versioned calibration artifacts — byte-deterministic, schema-checked.

A copy of ``repro.calib.artifact``: one schema for both packages, so an
artifact the port writes loads in the reference unchanged, and the other
way round.

A *calibration artifact* is the durable output of one measure → fit run:
the raw timing samples, the fitted
:class:`~repro_torch.rms.costmodel.ReconfigCostModel` parameters, residual
diagnostics, and the shape checks (Fig. 3b) — all in one JSON document
whose canonical serialization is byte-stable.  The ``calibration_id`` is a
content hash of the entire artifact body (samples, fitted parameters,
backend label, grid, diagnostics), so any consumer can record *which*
calibration produced its numbers and hand-edits are detected at load time.

Schema (``SCHEMA_ID`` / ``SCHEMA_VERSION``)::

    {"schema": "repro.calib", "version": 1,
     "calibration_id": "<12 hex chars of sha256>",
     "backend": "plan" | "jax" | "torch",
     "environment": {...},                  # device kind/count, slices
     "grid": {"geometries": [[p, q], ...], "data_bytes": [...],
              "repeats": ..., "seed": ...},
     "samples": [{"kind": "expand|shrink|migrate|sched", "old": p,
                  "new": q, "bytes": b, "participants": k,
                  "busiest_bytes": B, "seconds": t}, ...],
     "fitted": {"link_bw": ..., "spawn_s": ..., "shrink_sync_s": ...,
                "sched_base_s": ..., "sched_per_node_s": ...},
     "residuals": {"resize_rms_s": ..., "resize_max_s": ..., "r2": ...,
                   "n_resize": ..., "n_sched": ...},
     "checks": {"more_participants_faster": ..., "shrink_ge_expand": ...,
                "link_bw_positive": ...},
     "paper_defaults": {...}}               # the hand-fit constants, for diff

``tests/data/golden_calibration.json`` pins the deterministic (``plan``
backend) CI grid: re-measuring, re-fitting, and re-serializing it must
reproduce the committed bytes exactly, in either package.
"""
from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Sequence

SCHEMA_ID = "repro.calib"
SCHEMA_VERSION = 1

#: Rounding applied before serialization so artifact bytes don't depend on
#: sub-nanosecond float noise: timing samples to nanoseconds, fitted
#: parameters / residuals to 6 significant digits.
SAMPLE_DIGITS = 9
FIT_SIG_DIGITS = 6

#: ``calibration_id`` value consumers report when no artifact is loaded —
#: the hand-fit Table 2 / Fig. 3 constants in
#: ``repro_torch.rms.costmodel``.
PAPER_FIT_ID = "paper-fit"


def round_sig(x: float, sig: int = FIT_SIG_DIGITS) -> float:
    """Round ``x`` to ``sig`` significant digits (0.0 stays 0.0)."""
    if x == 0 or not (x == x) or x in (float("inf"), float("-inf")):
        return x
    return float(f"{x:.{sig}g}")


def dumps_calibration(doc: Dict[str, object]) -> str:
    """Canonical byte-stable serialization (same style as sweep artifacts)."""
    return json.dumps(doc, sort_keys=True, indent=2) + "\n"


def content_id(doc: Dict[str, object]) -> str:
    """Deterministic 12-hex content hash of the whole artifact body.

    Everything except the id field itself is covered — samples, fitted
    parameters, but also the backend label, grid, environment, residuals
    and checks — so no part of the document can be hand-edited (e.g.
    relabelling a synthetic ``plan`` run as a ``torch`` measurement)
    without tripping :func:`validate_calibration`.
    """
    body = {k: v for k, v in sorted(doc.items())
            if k != "calibration_id"}
    blob = json.dumps(body, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def make_artifact(*, samples: Sequence[Dict[str, object]],
                  fitted: Dict[str, float],
                  residuals: Dict[str, object],
                  checks: Dict[str, bool],
                  grid: Dict[str, object],
                  backend: str,
                  environment: Optional[Dict[str, object]] = None
                  ) -> Dict[str, object]:
    """Assemble a schema-v1 artifact; the inputs must already be rounded
    (the fitter and measurement harness do so)."""
    from repro_torch.rms.costmodel import ReconfigCostModel
    paper = ReconfigCostModel()
    doc: Dict[str, object] = {
        "schema": SCHEMA_ID, "version": SCHEMA_VERSION,
        "backend": backend,
        "environment": dict(environment or {}),
        "grid": dict(grid),
        "samples": list(samples),
        "fitted": dict(fitted),
        "residuals": dict(residuals),
        "checks": dict(checks),
        "paper_defaults": {
            "link_bw": paper.link_bw, "spawn_s": paper.spawn_s,
            "shrink_sync_s": paper.shrink_sync_s,
            "sched_base_s": paper.sched_base_s,
            "sched_per_node_s": paper.sched_per_node_s,
        },
    }
    doc["calibration_id"] = content_id(doc)
    return doc


def validate_calibration(doc: Dict[str, object]) -> Dict[str, object]:
    """Schema/version/content checks shared by loaders and consumers."""
    if doc.get("schema") != SCHEMA_ID:
        raise ValueError(
            f"not a calibration artifact: schema={doc.get('schema')!r}")
    if doc.get("version") != SCHEMA_VERSION:
        raise ValueError(f"calibration artifact version "
                         f"{doc.get('version')} != supported "
                         f"{SCHEMA_VERSION}")
    fitted = doc.get("fitted")
    if not isinstance(fitted, dict) or "link_bw" not in fitted:
        raise ValueError("calibration artifact has no fitted parameters")
    if doc.get("calibration_id") != content_id(doc):
        raise ValueError("calibration_id does not match artifact content "
                         "(corrupted or hand-edited artifact)")
    return doc


def write_calibration(path: str, doc: Dict[str, object]) -> None:
    with open(path, "w") as fh:
        fh.write(dumps_calibration(doc))


def load_calibration(path: str) -> Dict[str, object]:
    with open(path) as fh:
        doc = json.load(fh)
    return validate_calibration(doc)


def samples_by_kind(doc: Dict[str, object]
                    ) -> Dict[str, List[Dict[str, object]]]:
    """Group a loaded artifact's samples by kind (expand/shrink/…)."""
    out: Dict[str, List[Dict[str, object]]] = {}
    for s in doc.get("samples", []):
        out.setdefault(str(s["kind"]), []).append(s)
    return out
