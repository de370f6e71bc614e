"""DMR reconfiguration policy — the resource-selection plug-in of paper §4.

A copy of ``repro.rms.policy``.

Three modes, of increasing scheduler freedom, evaluated in order:

1. *Request an action* (§4.1): the application "strongly suggests" a
   direction by sending ``minimum > current`` (expand) or
   ``maximum < current`` (shrink); the RMS grants subject to global state.
2. *Preferred number of nodes* (§4.2): "no action" when already at the
   preferred size — except that with an empty queue the job may grow up to
   its maximum; otherwise the RMS steers the job toward the preferred size.
3. *Wide optimization* (§4.3): expand iff the spare nodes could not start
   any queued job; shrink iff that lets a queued job start — the triggering
   queued job is raised to maximum priority so it runs next.

All targets are *factor-consistent*: the new size is ``current * factor^k``
or ``current / factor^k`` (Listing 3's homogeneous mappings need an integer
mapping factor), clamped to ``[minimum, maximum]`` and to the job's
min/max.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.actions import Action, Decision
from repro_torch.rms.cluster import Cluster
from repro_torch.rms.job import Job, JobState
from repro_torch.rms.reasons import make_reason


def factor_sizes(cur: int, factor: int, lo: int, hi: int) -> List[int]:
    """Factor-consistent *adjacent* sizes in [lo, hi] (excluding ``cur``).

    Every reconfiguration in the paper is a single factor step (Fig. 3
    measures exactly the pairs 1→2 … 32→64 and 64→32 … 2→1; §7.4 explains
    execution-time degradation as "halving the resources").  Larger moves
    happen over successive reconfiguration points.
    """
    if factor <= 1:
        return [n for n in range(lo, hi + 1) if n != cur]
    sizes = []
    if cur % factor == 0 and lo <= cur // factor <= hi:
        sizes.append(cur // factor)
    if lo <= cur * factor <= hi:
        sizes.append(cur * factor)
    return sorted(sizes)


def _expansions(cur, factor, lo, hi):
    return [s for s in factor_sizes(cur, factor, lo, hi) if s > cur]


def _shrinks(cur, factor, lo, hi):
    return [s for s in factor_sizes(cur, factor, lo, hi) if s < cur]


@dataclasses.dataclass
class PolicyConfig:
    # Expansions never steal nodes a queued job could use (spirit of §4.3).
    conservative_expand: bool = True
    # Shrinks toward preferred are granted eagerly (§7.5: jobs are
    # "scaled-down as soon as possible").
    eager_preferred_shrink: bool = True


class ReconfigPolicy:
    """Stateless decision function over cluster + queue state."""

    def __init__(self, config: Optional[PolicyConfig] = None):
        self.config = PolicyConfig() if config is None else config

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _startable(job: Job, free: int) -> bool:
        return job.requested_nodes <= free

    def _queue_can_use(self, pending: Sequence[Job], free: int) -> bool:
        return any(self._startable(j, free) for j in pending)

    # -- the policy ----------------------------------------------------------

    def decide(self, cluster: Cluster, pending: Sequence[Job], job: Job, *,
               minimum: int, maximum: int, factor: int = 2,
               preferred: Optional[int] = None,
               slo_pressure: Optional[float] = None) -> Decision:
        cur = cluster.allocation(job.job_id) or job.nodes
        free = cluster.free_nodes
        pending = [j for j in pending
                   if j.state is JobState.PENDING and j.resizer_for is None]
        # negotiate over the band the *live* cluster can host: after a
        # drain/failure the app-declared band may exceed real capacity
        live = max(cluster.live_capacity, 1)
        lo = max(1, min(minimum, live))
        hi = max(lo, min(maximum, live))
        # SERVING jobs ride mode 1 with dedicated reasons: the band was
        # derived from p99/SLO pressure, not remaining work, and a steady
        # announcement (neither bound crosses ``cur``) holds deliberately
        # instead of falling through to modes 2/3 — batch heuristics must
        # not resize a latency-bound job the SLO rule chose to leave alone.
        slo = slo_pressure is not None

        # ---- mode 1: request an action (§4.1) ------------------------------
        if minimum > cur:
            ups = _expansions(cur, factor, minimum, hi)
            ups = [s for s in ups if s - cur <= free]
            if ups:
                return Decision(Action.EXPAND, ups[0],
                                reason="slo-expand" if slo
                                else "requested-expand")
            return Decision(Action.NO_ACTION, cur,
                            reason="slo-expand-denied" if slo
                            else "requested-expand-denied")
        if maximum < cur:
            downs = _shrinks(cur, factor, lo, maximum)
            if downs:
                return Decision(Action.SHRINK, downs[-1],
                                reason="slo-shrink" if slo
                                else "requested-shrink")
            return Decision(Action.NO_ACTION, cur,
                            reason="slo-shrink-denied" if slo
                            else "requested-shrink-denied")
        if slo:
            return Decision(Action.NO_ACTION, cur, reason="slo-steady")

        # ---- mode 2: preferred number of nodes (§4.2) ----------------------
        if preferred is not None:
            if not pending:
                # Empty queue: "the expansion can be granted up to a
                # specified maximum" — grow from any current size.
                ups = [s for s in _expansions(cur, factor, lo, hi)
                       if s - cur <= free]
                if ups:
                    return Decision(Action.EXPAND, ups[-1],
                                    reason="preferred-grow-empty-queue")
                return Decision(Action.NO_ACTION, cur,
                                reason="at-preferred-or-max")
            if preferred < cur:
                # Queue pressure: steer down to the preferred size
                # ("scaled-down as soon as possible", §7.5).
                downs = [s for s in _shrinks(cur, factor, lo, hi)
                         if s >= preferred]
                if downs and (self.config.eager_preferred_shrink or pending):
                    return Decision(Action.SHRINK, downs[0],
                                    reason="toward-preferred")
                return Decision(Action.NO_ACTION, cur,
                                reason="preferred-shrink-unavailable")
            if preferred > cur:
                ups = [s for s in _expansions(cur, factor, lo, hi)
                       if s <= preferred and s - cur <= free]
                blocked = (self.config.conservative_expand
                           and self._queue_can_use(pending, free))
                if ups and not blocked:
                    return Decision(Action.EXPAND, ups[-1],
                                    reason="toward-preferred")
                return Decision(Action.NO_ACTION, cur,
                                reason="preferred-expand-denied")
            return Decision(Action.NO_ACTION, cur, reason="at-preferred")

        # ---- mode 3: wide optimization (§4.3) ------------------------------
        ups = [s for s in _expansions(cur, factor, lo, hi) if s - cur <= free]
        if ups and (not pending or not self._queue_can_use(pending, free)):
            return Decision(Action.EXPAND, ups[-1], reason="wide-expand")
        if pending:
            downs = _shrinks(cur, factor, lo, hi)
            for new in reversed(downs):   # minimal shrink that helps
                freed = cur - new
                for qjob in sorted(pending,
                                   key=lambda j: j.requested_nodes):
                    if qjob.requested_nodes <= free + freed:
                        return Decision(
                            Action.SHRINK, new,
                            reason=make_reason("wide-shrink",
                                               f"job{qjob.job_id}"),
                            boost_job_id=qjob.job_id)
        return Decision(Action.NO_ACTION, cur, reason="wide-no-action")
