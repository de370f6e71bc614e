"""Homogeneous-cluster resource inventory with an *elastic* node pool.

Tracks node identity (not just counts) so node failures, stragglers, and
capacity churn can target specific nodes.  Expansion reuses a job's
original nodes and appends new ones (the paper's resizer-job protocol,
§5.2.1); shrinking releases the tail (the sender nodes of the fold,
§5.2.2).

Node lifecycle (each node is in exactly one state at any time)::

    join ──> FREE <──────> OWNED            fail ──> DEAD (terminal unless
              │  quarantine │ drain                   re-joined "repaired")
              │  (slow,     │  (vacate first)
              │  alloc-last)▼
              ├─────────> DRAINING ──join──> FREE
              ▼
          POWERED_OFF ──power-on──> FREE

``live_capacity`` — free + quarantined + allocated — is the single source
of truth for "how many nodes can host work right now": band clamping,
utilization denominators, and scheduler normalization all read it instead
of the construction-time ``num_nodes`` (which is *initial* capacity and is
never mutated after churn; see the stale-denominator bug this replaced).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set


@dataclasses.dataclass
class Cluster:
    num_nodes: int          # initial capacity (nodes present at t=0)

    def __post_init__(self):
        self.free: List[int] = list(range(self.num_nodes))
        self.quarantine: List[int] = []   # slow nodes: allocatable *last*
        self.owned: Dict[int, List[int]] = {}     # job_id -> ordered node list
        self.draining: List[int] = []     # drained out of the pool (rejoinable)
        self.powered_off: List[int] = []  # parked for energy (rebootable)
        self.dead: Set[int] = set()
        self.slow: Dict[int, float] = {}          # node -> slowdown multiplier
        # drain requested on an owned node: routed to `draining` (not `free`)
        # the moment its job vacates it
        self._drain_pending: Set[int] = set()
        self.nodes_ever_joined: int = self.num_nodes
        self._next_node_id: int = self.num_nodes

    # -- queries --------------------------------------------------------------

    @property
    def free_nodes(self) -> int:
        """Allocatable nodes right now (healthy free + quarantined)."""
        return len(self.free) + len(self.quarantine)

    @property
    def live_capacity(self) -> int:
        """Nodes that can host work now: free + quarantined + allocated.

        Excludes drained, powered-off, and dead nodes — the one denominator
        for band clamping, utilization, and scheduler normalization.
        """
        return len(self.free) + len(self.quarantine) + self.allocated_nodes

    def allocation(self, job_id: int) -> int:
        return len(self.owned.get(job_id, ()))

    @property
    def allocated_nodes(self) -> int:
        return sum(len(v) for v in self.owned.values())

    def state_counts(self) -> Dict[str, int]:
        """Disjoint per-state node counts; values sum to
        ``nodes_ever_joined`` (the conservation invariant the capacity
        property test pins).  An owned node with a pending drain counts as
        ``allocated`` until its job vacates it."""
        return {"free": self.free_nodes,
                "allocated": self.allocated_nodes,
                "draining": len(self.draining),
                "powered_off": len(self.powered_off),
                "dead": len(self.dead)}

    def owner_of(self, node: int) -> Optional[int]:
        for job_id, nodes in sorted(self.owned.items()):
            if node in nodes:
                return job_id
        return None

    def job_rate_factor(self, job_id: int) -> float:
        """min over owned nodes of 1/slowdown — a straggler gates the job."""
        if not self.slow:
            return 1.0            # hot path: no stragglers anywhere
        nodes = self.owned.get(job_id, ())
        if not nodes:
            return 1.0
        worst = max((self.slow.get(n, 1.0) for n in nodes), default=1.0)
        return 1.0 / worst

    # -- mutations -------------------------------------------------------------

    def allocate(self, job_id: int, n: int) -> List[int]:
        """Healthy-first: quarantined (slow) nodes are handed out only when
        no healthy free node is left."""
        if n > self.free_nodes:
            raise RuntimeError(
                f"over-allocation: job {job_id} wants {n}, "
                f"free {self.free_nodes}")
        nodes, self.free = self.free[:n], self.free[n:]
        if len(nodes) < n:
            k = n - len(nodes)
            nodes += self.quarantine[:k]
            self.quarantine = self.quarantine[k:]
        self.owned.setdefault(job_id, []).extend(nodes)
        return nodes

    def _route_released(self, nodes: List[int]) -> None:
        """Return vacated nodes to the right pool: a pending drain retires
        the node, a known-slow node is quarantined (allocate healthy-first),
        everything else goes back to ``free``."""
        for node in nodes:
            if node in self._drain_pending:
                self._drain_pending.discard(node)
                self.draining.append(node)
            elif self.slow.get(node, 1.0) > 1.0:
                self.quarantine.append(node)
            else:
                self.free.append(node)

    def resize(self, job_id: int, new_n: int) -> int:
        """Grow/shrink a job's allocation; returns delta (nodes gained)."""
        cur = self.allocation(job_id)
        if new_n > cur:
            self.allocate(job_id, new_n - cur)
        elif new_n < cur:
            released = self.owned[job_id][new_n:]
            self.owned[job_id] = self.owned[job_id][:new_n]
            self._route_released(released)
        return new_n - cur

    def release(self, job_id: int) -> None:
        self._route_released(self.owned.pop(job_id, []))

    def move_to_tail(self, job_id: int, node: int) -> bool:
        """Reorder a job's node list so ``node`` is released first by the
        next tail-shrink (the §5.2.2 fold senders are the tail)."""
        nodes = self.owned.get(job_id)
        if not nodes or node not in nodes:
            return False
        nodes.remove(node)
        nodes.append(node)
        return True

    # -- capacity churn ---------------------------------------------------------

    def _remove_from_pools(self, node: int) -> Optional[str]:
        """Drop ``node`` from whichever idle pool holds it; returns the pool
        name or None when the node is owned / not a live member."""
        for name in ("free", "quarantine", "powered_off", "draining"):
            pool: List[int] = getattr(self, name)
            if node in pool:
                pool.remove(node)
                return name
        return None

    def join_node(self, node: Optional[int] = None) -> int:
        """Bring a node into the ``free`` pool.

        ``None`` (or a negative id) joins a brand-new node under a fresh
        id; a known drained or dead id re-joins (maintenance done /
        repaired); an unknown explicit id joins as new capacity.  Joining a
        node that is already live is a no-op (idempotent).
        """
        if node is None or node < 0:
            node = self._next_node_id
            self._next_node_id += 1
            self.nodes_ever_joined += 1
        elif node in self.draining:
            self.draining.remove(node)
        elif node in self.dead:
            self.dead.discard(node)     # repaired: re-enters healthy
        elif node in self.free or node in self.quarantine or \
                node in self.powered_off or self.owner_of(node) is not None:
            return node                 # already a live member
        else:
            self.nodes_ever_joined += 1
            self._next_node_id = max(self._next_node_id, node + 1)
        self.slow.pop(node, None)       # joins come back healthy
        self._drain_pending.discard(node)
        self.free.append(node)
        return node

    def drain_node(self, node: int) -> Optional[int]:
        """Take ``node`` out of the allocatable pool for maintenance /
        reclamation.

        Idle nodes (free / quarantined / powered-off) retire immediately;
        returns ``None``.  An owned node returns the owning ``job_id`` and
        is flagged: the caller must negotiate the job off it (migrate /
        shrink / requeue) — the node retires automatically when vacated.
        Draining a dead, already-draining, or unknown node is a no-op.
        """
        if node in self.dead or node in self.draining:
            return None
        pool = self._remove_from_pools(node)
        if pool is not None:
            self.draining.append(node)
            return None
        owner = self.owner_of(node)
        if owner is not None:
            self._drain_pending.add(node)
        return owner

    def power_off_node(self, node: int) -> bool:
        """Park an *idle* node (free or quarantined) to save energy."""
        if node in self.free:
            self.free.remove(node)
        elif node in self.quarantine:
            self.quarantine.remove(node)
        else:
            return False
        self.powered_off.append(node)
        return True

    def power_on_node(self, node: int) -> bool:
        """Bring a powered-off node back to the allocatable pool."""
        if node not in self.powered_off:
            return False
        self.powered_off.remove(node)
        if self.slow.get(node, 1.0) > 1.0:
            self.quarantine.append(node)
        else:
            self.free.append(node)
        return True

    # -- failures / stragglers ---------------------------------------------------

    def fail_node(self, node: int):
        """Mark a node dead; idempotent.  Returns the owning job_id (or
        None).  A second failure of the same node — or of a node that never
        joined / already left — changes nothing, so capacity accounting
        cannot be double-decremented (regression: ``_on_failure`` used to
        charge ``num_nodes`` once per event)."""
        if node in self.dead:
            return None
        pool = self._remove_from_pools(node)
        if pool is not None:
            self.dead.add(node)
            self._drain_pending.discard(node)
            return None
        for job_id, nodes in sorted(self.owned.items()):
            if node in nodes:
                nodes.remove(node)
                self.dead.add(node)
                self._drain_pending.discard(node)
                return job_id
        return None                     # unknown node: nothing to fail

    def set_straggler(self, node: int, slowdown: float):
        """Owning job (if any) is returned so the RMS can react.  A free
        slow node moves to the quarantine pool (allocated healthy-first)."""
        self.slow[node] = slowdown
        if slowdown > 1.0 and node in self.free:
            self.free.remove(node)
            self.quarantine.append(node)
        return self.owner_of(node)

    def replace_node(self, job_id: int, node: int) -> Optional[int]:
        """Swap ``node`` out of a job's allocation for a healthy free node
        (one slice migration).  The vacated node is routed by state:
        drain-pending retires it, slow quarantines it.  Returns the
        replacement node id, or None when no healthy node is free."""
        nodes = self.owned.get(job_id)
        if not nodes or node not in nodes or not self.free:
            return None
        repl = self.free.pop(0)
        nodes[nodes.index(node)] = repl
        self._route_released([node])
        return repl

    def swap_straggler(self, job_id: int) -> int:
        """Migrate the job off its slowest node onto a free healthy node.

        Returns the number of swaps performed (0 or 1).  Data movement is
        one slice migration (``repro_torch.core.redistribute.migrate_slice``).
        The swapped-out straggler lands in the quarantine pool — never at
        the head of ``free`` — so the very next allocation cannot hand the
        known-slow node to a fresh job while healthy nodes exist.
        """
        nodes = self.owned.get(job_id, ())
        if not nodes:
            return 0
        worst = max(nodes, key=lambda n: self.slow.get(n, 1.0))
        if self.slow.get(worst, 1.0) <= 1.0:
            return 0
        return 1 if self.replace_node(job_id, worst) is not None else 0
