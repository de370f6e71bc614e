"""Closed vocabulary of ``ActionRecord.reason`` codes — the audit currency.

Every ``ActionRecord`` the simulator emits carries a ``reason`` string of
the form ``CODE`` or ``CODE:DETAIL``: a stable, enum-like *code* drawn
from :data:`REASON_CODES` plus an optional free-form *detail* (a node id,
a phase index, a boosted job id) after a single colon.  The observability
ledger groups actions by code, so codes must never embed varying data —
historically ``phase{i}`` and ``node{n}`` did, which made two distinct
causes (a node joining vs. a node draining idle) collide and every phase
index a fresh "reason".

Adding a code is an intentional vocabulary change: add it here *and* to
the taxonomy table in ``docs/observability.md``; the regression test
``tests/test_reasons.py`` fails on any emission outside the vocabulary.
"""
from __future__ import annotations

#: Every reason code any simulator/policy code path may emit.
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
    # -- asynchronous negotiation pathology (§5.2.1) ------------------------
    "stale-grant",                 # waited expand superseded before grant
    "rj-timeout",                  # resizer-job reservation expired
    # -- preemptive scheduling ----------------------------------------------
    "head-reservation-slip",       # preempted to honor head-of-queue ETA
    # -- EVOLVING job class -------------------------------------------------
    "phase-entered",               # new phase announced a new band (detail)
    # -- faults and stragglers ----------------------------------------------
    "node-failed",                 # shrink/requeue off a dead node (detail)
    "slice-migration",             # straggler slice moved to healthy node
    # -- elastic cluster capacity -------------------------------------------
    "node-join",                   # capacity arrived (detail = node id)
    "node-drain",                  # drain bookkeeping on a busy node
    "node-drain-idle",             # drain released an idle node directly
    "drain-vacate",                # owner migrated/shrunk/requeued off it
    "power-off",                   # idle timer parked nodes (detail = ids)
    "power-on",                    # parked node booted back (detail = id)
})


def make_reason(code: str, detail=None) -> str:
    """Build a validated reason string ``code`` or ``code:detail``."""
    if code not in REASON_CODES:
        raise ValueError(f"unknown reason code: {code!r}")
    return code if detail is None else f"{code}:{detail}"


def reason_code(reason: str) -> str:
    """The vocabulary code of a reason string (strips any detail)."""
    return reason.partition(":")[0]


def reason_detail(reason: str) -> str:
    """The detail part of a reason string ('' when there is none)."""
    return reason.partition(":")[2]


def is_known_reason(reason: str) -> bool:
    """True iff ``reason`` parses to a recognized vocabulary code."""
    return reason_code(reason) in REASON_CODES
