"""Least-squares fit of ``ReconfigCostModel`` parameters from samples.

A copy of ``repro.calib.fit``.

The Fig. 3 cost model is linear in its parameters once the transfer-plan
features are extracted (:func:`repro_torch.core.redistribute.plan_stats`):

- redistribution: ``t = spawn_s + busiest_bytes / link_bw
  + shrink_sync_s * participants``            (sync term: shrinks only)
- scheduling:     ``t = sched_base_s + sched_per_node_s * nodes``

so both fits are ordinary least squares (`numpy.linalg.lstsq`) over the
measured samples.  The fitted parameters are clamped to their physical
domain (non-negative constants, strictly positive finite bandwidth — a fit
that produces anything else raises), rounded to a fixed number of
significant digits for byte-stable artifacts, and validated against the
paper's Fig. 3b observations:

- *more participants ⇒ faster redistribution* — the fitted model must time
  a 1→2 expand slower than a 32→64 expand at equal bytes;
- *shrinks pay the per-participant sync term* — a q→p shrink must cost at
  least the p→q expand at equal geometry and bytes.

``migrate`` samples (the straggler path) are diagnostic only: they are
carried in the artifact but excluded from the fit, because slice migration
is a swap of two slices' shards inside one mesh, not a factor-plan
transfer.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.calib.artifact import round_sig

Samples = Sequence[Dict[str, object]]


class FitError(ValueError):
    """The samples do not support a physical fit (e.g. non-positive
    bandwidth)."""


def _resize_design(samples: Samples) -> Tuple[np.ndarray, np.ndarray]:
    rows, ys = [], []
    for s in samples:
        if s["kind"] not in ("expand", "shrink"):
            continue
        sync_parts = float(s["participants"]) if s["kind"] == "shrink" \
            else 0.0
        rows.append([1.0, float(s["busiest_bytes"]), sync_parts])
        ys.append(float(s["seconds"]))
    return np.asarray(rows, dtype=np.float64), np.asarray(ys,
                                                          dtype=np.float64)


def _sched_design(samples: Samples) -> Tuple[np.ndarray, np.ndarray]:
    rows, ys = [], []
    for s in samples:
        if s["kind"] != "sched":
            continue
        rows.append([1.0, float(s["old"])])
        ys.append(float(s["seconds"]))
    return np.asarray(rows, dtype=np.float64), np.asarray(ys,
                                                          dtype=np.float64)


def _lstsq(a: np.ndarray, y: np.ndarray) -> np.ndarray:
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    return coef


def fit_samples(samples: Samples) -> Tuple[Dict[str, float],
                                           Dict[str, object],
                                           Dict[str, bool]]:
    """Fit the cost-model parameters; returns ``(fitted, residuals,
    checks)`` ready for :func:`repro_torch.calib.artifact.make_artifact`."""
    a, y = _resize_design(samples)
    if len(y) < 3:
        raise FitError(f"need >= 3 expand/shrink samples, got {len(y)}")
    if float(a[:, 1].max() - a[:, 1].min()) <= 0.0:
        # A constant busiest-bytes column is collinear with the spawn
        # intercept: the bandwidth is unidentifiable, don't fit garbage.
        raise FitError("samples carry no busiest-bytes variation — "
                       "cannot identify link_bw")
    spawn, inv_bw, sync = _lstsq(a, y)
    if not np.isfinite(inv_bw) or inv_bw <= 0:
        raise FitError(f"fitted 1/link_bw = {inv_bw!r} is not positive — "
                       f"the samples carry no usable bandwidth signal")
    fitted: Dict[str, float] = {
        "link_bw": round_sig(1.0 / float(inv_bw)),
        "spawn_s": round_sig(max(float(spawn), 0.0)),
        "shrink_sync_s": round_sig(max(float(sync), 0.0)),
    }

    sa, sy = _sched_design(samples)
    if len(sy) >= 2:
        base, per_node = _lstsq(sa, sy)
        fitted["sched_base_s"] = round_sig(max(float(base), 0.0))
        fitted["sched_per_node_s"] = round_sig(max(float(per_node), 0.0))
    else:
        # No scheduling samples: keep the paper-fit transaction constants.
        from repro_torch.rms.costmodel import ReconfigCostModel
        paper = ReconfigCostModel()
        fitted["sched_base_s"] = paper.sched_base_s
        fitted["sched_per_node_s"] = paper.sched_per_node_s

    residuals = _residuals(fitted, a, y, sa, sy)
    checks = validate_fit(fitted)
    return fitted, residuals, checks


def _predict_resize(fitted: Dict[str, float], a: np.ndarray) -> np.ndarray:
    return (fitted["spawn_s"] + a[:, 1] / fitted["link_bw"]
            + fitted["shrink_sync_s"] * a[:, 2])


def _residuals(fitted: Dict[str, float], a: np.ndarray, y: np.ndarray,
               sa: np.ndarray, sy: np.ndarray) -> Dict[str, object]:
    """Diagnostics computed with the *clamped, rounded* parameters — the
    model consumers will actually run."""
    r = y - _predict_resize(fitted, a)
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    out: Dict[str, object] = {
        "n_resize": int(len(y)), "n_sched": int(len(sy)),
        "resize_rms_s": round_sig(float(np.sqrt(np.mean(r ** 2)))),
        "resize_max_s": round_sig(float(np.max(np.abs(r)))),
        "resize_r2": round_sig(1.0 - float(np.sum(r ** 2)) / ss_tot
                               if ss_tot > 0 else 1.0),
    }
    if len(sy):
        sr = sy - (fitted["sched_base_s"]
                   + fitted["sched_per_node_s"] * sa[:, 1])
        out["sched_rms_s"] = round_sig(float(np.sqrt(np.mean(sr ** 2))))
    return out


def validate_fit(fitted: Dict[str, float],
                 probe_bytes: int = 1 << 30) -> Dict[str, bool]:
    """Fig. 3b shape checks on the fitted model (see module docstring)."""
    from repro_torch.rms.costmodel import ReconfigCostModel
    model = ReconfigCostModel(
        link_bw=fitted["link_bw"], spawn_s=fitted["spawn_s"],
        shrink_sync_s=fitted["shrink_sync_s"],
        sched_base_s=fitted["sched_base_s"],
        sched_per_node_s=fitted["sched_per_node_s"])
    small = model.resize_time(1, 2, probe_bytes)
    expand = model.resize_time(32, 64, probe_bytes)
    shrink = model.resize_time(64, 32, probe_bytes)
    return {
        "link_bw_positive": bool(np.isfinite(fitted["link_bw"])
                                 and fitted["link_bw"] > 0),
        "params_nonnegative": all(
            fitted[k] >= 0 for k in ("spawn_s", "shrink_sync_s",
                                     "sched_base_s", "sched_per_node_s")),
        "more_participants_faster": bool(expand < small),
        "shrink_ge_expand": bool(shrink >= expand),
    }


def fit_report_rows(doc: Dict[str, object]) -> List[Dict[str, object]]:
    """Measured vs fitted vs paper-default times per resize sample group —
    the comparison ``benchmarks/fig3_reconfig_overhead.py`` prints."""
    from repro_torch.rms.costmodel import ReconfigCostModel
    fitted_model = ReconfigCostModel.from_artifact(doc)
    paper = ReconfigCostModel()
    groups: Dict[Tuple, List[float]] = {}
    for s in doc["samples"]:
        if s["kind"] not in ("expand", "shrink"):
            continue
        key = (s["kind"], s["old"], s["new"], s["bytes"])
        groups.setdefault(key, []).append(float(s["seconds"]))
    rows = []
    for (kind, old, new, nbytes), secs in sorted(groups.items()):
        rows.append({
            "action": kind, "from": old, "to": new, "bytes": nbytes,
            "measured_s": round_sig(float(np.mean(secs))),
            "fitted_s": round_sig(fitted_model.resize_time(old, new,
                                                           nbytes)),
            "paper_s": round_sig(paper.resize_time(old, new, nbytes)),
        })
    return rows
