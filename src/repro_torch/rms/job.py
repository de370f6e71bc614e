"""Job model for the RMS (paper §2 taxonomy).

A job is *fixed* (rigid/moldable: constant process count) or *flexible*
(malleable/evolving: reconfigurable on-the-fly).  The RMS counts resources in
*nodes*; in the port one node = one data-parallel slice of devices (tensor
parallelism inside the slice is fixed, like cores within a node).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import TYPE_CHECKING, List, Optional, Tuple

if TYPE_CHECKING:   # import cycle: workload.swf builds Job instances
    from repro_torch.workload.traffic import TrafficSpec


class JobState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    CANCELLED = "cancelled"


def clamp_band(min_nodes: int, max_nodes: int, preferred: Optional[int],
               cap: int) -> Tuple[int, int, Optional[int]]:
    """Pin ``1 <= min <= preferred <= max <= cap``.

    The single source of the band invariant — used by the SWF adapter, the
    synthetic evolving schedules, and the simulator's PhaseChange handler.
    Without it, a recorded size far above the simulated cluster (or an
    aggressive evolving phase band) could invert the band into one no
    scheduler can satisfy.
    """
    hi = max(1, min(max_nodes, cap))
    lo = max(1, min(min_nodes, hi))
    if preferred is None:
        return lo, hi, None
    return lo, hi, min(max(preferred, lo), hi)


@dataclasses.dataclass(frozen=True)
class JobPhase:
    """One phase of an EVOLVING job (§2 taxonomy).

    The application consumes ``work`` work units in this phase while
    demanding the ``(min_nodes, max_nodes, preferred)`` band; the optional
    per-phase ``serial_frac``/``data_bytes`` override the app model's so the
    execution rate and the reconfiguration cost stay honest across phases
    (``None`` inherits the app-level value).
    """
    work: float
    min_nodes: int
    max_nodes: int
    preferred: Optional[int] = None
    serial_frac: Optional[float] = None
    data_bytes: Optional[int] = None


@dataclasses.dataclass
class Job:
    job_id: int
    app: str                      # "cg" | "jacobi" | "nbody" | "fs" | "lm:<arch>"
    submit_time: float
    work: float                   # total work units (app iterations)
    min_nodes: int
    max_nodes: int
    preferred: Optional[int]      # Table 1 "Preferred"
    factor: int = 2               # resize factor (Table 1: 2 for all malleable)
    malleable: bool = True
    check_period_s: float = 15.0  # Table 1 "Scheduling period" (0 = every iter)
    requested_nodes: int = 0      # submission size (paper: launched at max)
    data_bytes: int = 0           # redistributed state size (FS: 1 GB)
    user: int = 0                 # submitting user (fair-share accounting)
    # Phase schedule for EVOLVING jobs (empty: demand fixed for the whole
    # run).  ``min_nodes``/``max_nodes``/``preferred`` above are the *live*
    # band — the PhaseChange handler rewrites them per phase, and every
    # scheduling policy must consult them instead of submission-time copies.
    phases: Tuple[JobPhase, ...] = ()
    # SERVING class: the open-loop request stream this job drains.  When
    # set, ``work`` is the stream's total arrivals, progress is request
    # drain (no checkpoint rewind — served requests can't be un-served),
    # and DMR negotiation runs on SLO pressure instead of remaining work.
    traffic: Optional["TrafficSpec"] = None

    # -- dynamic state (owned by the RMS / simulator) ------------------------
    state: JobState = JobState.PENDING
    nodes: int = 0                # current allocation
    priority_boost: float = 0.0   # max-priority path (shrink trigger / RJ)
    start_time: float = -1.0
    end_time: float = -1.0
    work_done: float = 0.0
    last_progress_t: float = -1.0
    paused_until: float = -1.0    # reconfiguration in progress
    completion_version: int = 0   # invalidates stale completion events
    resizer_for: Optional[int] = None   # this job is an RJ for job `id`
    phase_index: int = 0                # current phase (EVOLVING jobs)
    nodes_history: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)

    def __post_init__(self):
        if self.requested_nodes == 0:
            self.requested_nodes = self.max_nodes

    @property
    def evolving(self) -> bool:
        return bool(self.phases)

    @property
    def serving(self) -> bool:
        return self.traffic is not None

    def current_phase(self) -> Optional[JobPhase]:
        if not self.phases:
            return None
        return self.phases[min(self.phase_index, len(self.phases) - 1)]

    def phase_boundary(self) -> Optional[float]:
        """Cumulative work at the end of the current phase; None when the
        job is in its last phase (completion ends it) or has no phases."""
        nxt = self.phase_index + 1
        if not self.phases or nxt >= len(self.phases):
            return None
        return sum(ph.work for ph in self.phases[:nxt])

    # -- metrics (paper §7.4/§7.5 definitions) -------------------------------
    @property
    def wait_time(self) -> float:
        if self.start_time < 0:
            return 0.0
        return self.start_time - self.submit_time

    @property
    def exec_time(self) -> float:
        if self.end_time < 0 or self.start_time < 0:
            return 0.0
        return self.end_time - self.start_time

    @property
    def completion_time(self) -> float:
        """Submission -> finalization (wait + exec)."""
        if self.end_time < 0:
            return 0.0
        return self.end_time - self.submit_time

    def record_nodes(self, t: float) -> None:
        self.nodes_history.append((t, self.nodes))

    def node_seconds(self) -> float:
        """Integral of allocated nodes over time (for utilization)."""
        total, hist = 0.0, self.nodes_history
        for (t0, n0), (t1, _n1) in zip(hist, hist[1:]):
            total += n0 * (t1 - t0)
        return total
