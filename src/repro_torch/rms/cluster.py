"""Homogeneous-cluster node inventory, from ``repro.rms.cluster``.

Tracks node identity, not just counts. Expansion reuses a job's original
nodes and appends new ones (the paper's resizer-job protocol, §5.2.1);
shrinking releases the tail (the sender nodes of the fold, §5.2.2). The
port keeps what ``LocalRMS`` and the policy use: allocation, resize and
release over a fixed pool. The reference's node churn, quarantine of slow
nodes, drains and failures belong to its simulator and are left out, so
``live_capacity`` is the free and the allocated nodes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class Cluster:
    num_nodes: int          # capacity (nodes present at t=0)

    def __post_init__(self):
        self.free: List[int] = list(range(self.num_nodes))
        self.owned: Dict[int, List[int]] = {}     # job_id -> ordered node list

    # -- queries --------------------------------------------------------------

    @property
    def free_nodes(self) -> int:
        """Allocatable nodes right now."""
        return len(self.free)

    @property
    def live_capacity(self) -> int:
        """Nodes that can host work now: free + allocated."""
        return len(self.free) + self.allocated_nodes

    def allocation(self, job_id: int) -> int:
        return len(self.owned.get(job_id, ()))

    @property
    def allocated_nodes(self) -> int:
        return sum(len(v) for v in self.owned.values())

    # -- mutations -------------------------------------------------------------

    def allocate(self, job_id: int, n: int) -> List[int]:
        if n > self.free_nodes:
            raise RuntimeError(
                f"over-allocation: job {job_id} wants {n}, "
                f"free {self.free_nodes}")
        nodes, self.free = self.free[:n], self.free[n:]
        self.owned.setdefault(job_id, []).extend(nodes)
        return nodes

    def resize(self, job_id: int, new_n: int) -> int:
        """Grow/shrink a job's allocation; returns delta (nodes gained)."""
        cur = self.allocation(job_id)
        if new_n > cur:
            self.allocate(job_id, new_n - cur)
        elif new_n < cur:
            released = self.owned[job_id][new_n:]
            self.owned[job_id] = self.owned[job_id][:new_n]
            self.free.extend(released)
        return new_n - cur

    def release(self, job_id: int) -> None:
        self.free.extend(self.owned.pop(job_id, []))
