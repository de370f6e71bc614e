"""Job model for the RMS (paper §2 taxonomy), from ``repro.rms.job``.

A job is *fixed* (rigid/moldable: constant process count) or *flexible*
(malleable/evolving: reconfigurable on-the-fly). The RMS counts resources in
*nodes*; in the port one node is one data-parallel slice of the mesh (a card,
or a virtual slice of one). The port copies what ``LocalRMS`` and the policy
read; the reference's evolving phases, serving traffic and simulator
bookkeeping are left out.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class JobState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    CANCELLED = "cancelled"


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

    # -- dynamic state (owned by the RMS) ------------------------------------
    state: JobState = JobState.PENDING
    nodes: int = 0                # current allocation
    priority_boost: float = 0.0   # max-priority path (shrink trigger / RJ)
    start_time: float = -1.0
    end_time: float = -1.0
    resizer_for: Optional[int] = None   # this job is an RJ for job `id`

    def __post_init__(self):
        if self.requested_nodes == 0:
            self.requested_nodes = self.max_nodes
