"""Reason codes of the DMR policy's decisions (from ``repro.rms.reasons``).

A reason is ``CODE`` or ``CODE:DETAIL``: a code from :data:`REASON_CODES`
and an optional free-form detail after a single colon. The port copies the
codes ``ReconfigPolicy.decide`` emits; the reference's simulator adds codes
for faults, capacity churn and asynchronous negotiation.
"""
from __future__ import annotations

REASON_CODES = frozenset({
    # -- DMR policy decisions (paper §4 modes) ------------------------------
    "requested-expand",            # §4.1 app asked min>cur, granted
    "requested-expand-denied",     # §4.1 asked, no factor step / no nodes
    "requested-shrink",            # §4.1 app asked max<cur, granted
    "requested-shrink-denied",     # §4.1 asked, no factor step fits
    "slo-expand",                  # serving band pushed up by SLO pressure
    "slo-expand-denied",           # SLO asked up, cluster could not grant
    "slo-shrink",                  # serving band released nodes on ebb
    "slo-shrink-denied",           # SLO asked down, no factor step fits
    "slo-steady",                  # SLO band holds the current size
    "preferred-grow-empty-queue",  # §4.2 empty queue, grow toward max
    "at-preferred-or-max",         # §4.2 empty queue, nothing to grant
    "toward-preferred",            # §4.2 steer toward preferred size
    "preferred-shrink-unavailable",  # §4.2 wants down, no step available
    "preferred-expand-denied",     # §4.2 wants up, blocked by queue/nodes
    "at-preferred",                # §4.2 already at preferred
    "wide-expand",                 # §4.3 spare nodes no queued job can use
    "wide-shrink",                 # §4.3 shrink frees a queued job (detail)
    "wide-no-action",              # §4.3 nothing helps
})


def make_reason(code: str, detail=None) -> str:
    """Build a validated reason string ``code`` or ``code:detail``."""
    if code not in REASON_CODES:
        raise ValueError(f"unknown reason code: {code!r}")
    return code if detail is None else f"{code}:{detail}"
