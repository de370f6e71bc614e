"""In-process RMS endpoint for live (non-simulated) elastic jobs.

A copy of ``repro.runtime.local_rms``. Wraps the same
:class:`~repro_torch.rms.policy.ReconfigPolicy` the reference's simulator
uses, over a real :class:`~repro_torch.rms.cluster.Cluster`, with
wall-clock timing —
this is what a single-controller deployment talks to (in a multi-controller
deployment the same protocol rides a gRPC/socket transport to the real
scheduler; the policy code is identical).
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional, Tuple

from repro_torch.core.actions import Action, Decision
from repro_torch.rms.cluster import Cluster
from repro_torch.rms.job import Job, JobState
from repro_torch.rms.policy import PolicyConfig, ReconfigPolicy
from repro_torch.rms.scheduler import MAX_PRIORITY


class LocalRMS:
    """RMSProtocol implementation over an in-process cluster."""

    def __init__(self, num_nodes: int,
                 policy: PolicyConfig = PolicyConfig()):
        self.cluster = Cluster(num_nodes)
        self.policy = ReconfigPolicy(policy)
        self.jobs: List[Job] = []
        self._lock = threading.Lock()

    def submit(self, job: Job, start: bool = False) -> Job:
        with self._lock:
            self.jobs.append(job)
            if start:
                self.cluster.allocate(job.job_id, job.requested_nodes)
                job.nodes = job.requested_nodes
                job.state = JobState.RUNNING
                job.start_time = time.monotonic()
        return job

    def finish(self, job_id: int) -> None:
        with self._lock:
            self.cluster.release(job_id)
            for j in self.jobs:
                if j.job_id == job_id:
                    j.state = JobState.COMPLETED

    def pending(self) -> List[Job]:
        return [j for j in self.jobs if j.state is JobState.PENDING]

    # -- RMSProtocol -------------------------------------------------------

    def request_reconfig(self, job_id: int, *, current: int, minimum: int,
                         maximum: int, factor: int,
                         preferred: Optional[int]) -> Decision:
        with self._lock:
            job = next(j for j in self.jobs if j.job_id == job_id)
            t0 = time.perf_counter()
            decision = self.policy.decide(
                self.cluster, self.pending(), job, minimum=minimum,
                maximum=maximum, factor=factor, preferred=preferred)
            elapsed = time.perf_counter() - t0
            if decision.action is not Action.NO_ACTION:
                self.cluster.resize(job_id, decision.new_slices)
                job.nodes = decision.new_slices
            if decision.boost_job_id is not None:
                for q in self.jobs:
                    if q.job_id == decision.boost_job_id:
                        q.priority_boost = MAX_PRIORITY
            import dataclasses
            return dataclasses.replace(decision, schedule_time_s=elapsed)

    def confirm_resize(self, job_id: int, decision: Decision,
                       timeout_s: float) -> Tuple[bool, float]:
        # Single-controller: the resize transaction in request_reconfig is
        # atomic, so the RJ is already running by construction.
        return True, 0.0
