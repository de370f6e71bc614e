"""Queue scheduling policies: multifactor priority + a pluggable registry.

The paper configures Slurm with the *backfill* scheduling policy and the
*multifactor* priority plug-in (defaults); that pair is the ``"easy"``
policy below and remains the default.  The registry adds the classic
alternatives studied in the malleable-scheduling literature (Chadha et al.;
Zojer et al.) so trace replays can compare them:

- ``fcfs``           strict priority order, no backfill — the head of the
                     queue blocks everything behind it.
- ``easy``           EASY backfill: the head job gets a reservation at the
                     earliest time enough nodes free up; lower-priority jobs
                     may start now only if they don't delay that reservation
                     (using runtime estimates).
- ``conservative``   every queued job gets a reservation; a backfill
                     candidate must not delay *any* reservation.  With
                     ``backfill=False`` it degenerates to strict priority
                     order (fcfs semantics).
- ``malleable``      EASY variant that knows running malleable jobs can be
                     shrunk at their next reconfiguration point, so the head
                     reservation lands earlier and backfill is bolder.
- ``sjf``            shortest-job-first EASY variant: queue ordered by
                     estimated remaining runtime, with an age guard — jobs
                     older than ``sjf_starvation_age_s`` jump ahead of every
                     younger job, so SJF never starves long jobs.
- ``fairshare``      EASY variant whose priority subtracts each user's
                     exponentially-decayed node-seconds usage
                     (half-life ``fairshare_halflife_s``) — heavy users sink,
                     light users rise.
- ``preempt``        preemptive backfill: when the head reservation slips
                     beyond ``preempt_grace_s``, running malleable jobs of
                     lower priority are shrunk one factor step (optionally
                     requeued) until the head starts *now*.
- ``moldable``       start-size optimizer: moldable/malleable jobs start at
                     the power-of-two size in ``[min_nodes, max_nodes]``
                     minimizing estimated completion (runtime scaling + the
                     ``ReconfigCostModel`` cost of factor-stepping to the
                     preferred size afterwards).

Shared priority: ``age_weight * age + size_weight * (1 - size/cluster)
+ boost`` where *boost* is the maximum-priority path used for resizer jobs
and for queued jobs that triggered a wide-optimization shrink (§4.3).

Evolving jobs (§2 EVOLVING): policies read ``Job.min_nodes`` /
``Job.max_nodes`` / ``Job.preferred`` / ``Job.requested_nodes`` at
schedule time — these are the *live* band, rewritten by the simulator's
``PhaseChange`` handler each time the application enters a new phase.  No
policy may cache submission-time copies: the malleable release estimate,
the preempt victim shrink floor, and the moldable candidate sizes all
follow the current phase automatically because they go through the live
fields.

Select a policy via ``SchedulerConfig(policy="conservative")`` — reachable
from ``SimConfig(sched=...)`` — or register new ones with
``@register_policy("name")``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Type

from repro_torch.rms.cluster import Cluster
from repro_torch.rms.costmodel import ReconfigCostModel
from repro_torch.rms.job import Job, JobState

MAX_PRIORITY = 1e12

RuntimeEstimate = Callable[[Job], float]


@dataclasses.dataclass
class SchedulerConfig:
    age_weight: float = 1.0
    size_weight: float = 100.0
    backfill: bool = True          # False => strict priority, no backfill
    policy: str = "easy"           # key into POLICY_REGISTRY
    # -- sjf ------------------------------------------------------------------
    sjf_starvation_age_s: float = 3600.0   # age guard: older jobs jump ahead
    # -- fairshare ------------------------------------------------------------
    fairshare_halflife_s: float = 3600.0   # usage decay half-life
    fairshare_weight: float = 200.0        # priority penalty per capacity-
                                           # half-life of decayed usage
    # -- preempt --------------------------------------------------------------
    preempt_grace_s: float = 60.0          # tolerated head-reservation slip
    preempt_requeue: bool = False          # requeue victims stuck at min size


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

POLICY_REGISTRY: Dict[str, Type["SchedulingPolicy"]] = {}


def register_policy(name: str):
    def deco(cls: Type["SchedulingPolicy"]):
        cls.name = name
        POLICY_REGISTRY[name] = cls
        return cls
    return deco


def make_policy(cluster: Cluster, config: SchedulerConfig,
                cost: Optional[ReconfigCostModel] = None
                ) -> "SchedulingPolicy":
    try:
        cls = POLICY_REGISTRY[config.policy]
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {config.policy!r}; "
            f"registered: {sorted(POLICY_REGISTRY)}") from None
    return cls(cluster, config, cost=cost)


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

class SchedulingPolicy:
    """Base: multifactor priority + a `schedule` hook.

    ``schedule`` must not mutate the cluster; the simulator/runtime applies
    starts so that start-up costs are accounted in one place.
    """

    name = "base"

    def __init__(self, cluster: Cluster, config: SchedulerConfig,
                 cost: Optional[ReconfigCostModel] = None):
        self.cluster = cluster
        self.config = config
        # The reconfiguration cost model policies reason with (moldable's
        # start-size optimizer) — calibrated when the caller threads a
        # fitted model through (``Scheduler(..., cost=...)``), the
        # paper-fit constants otherwise.
        self.cost = cost if cost is not None else ReconfigCostModel()

    # -- priority ------------------------------------------------------------

    def priority(self, job: Job, now: float) -> float:
        if job.priority_boost:
            return job.priority_boost
        age = now - job.submit_time
        # normalize by *live* capacity so the size bias tracks the cluster
        # that actually exists after failures/drains/joins
        size = 1.0 - job.requested_nodes / max(self.cluster.live_capacity, 1)
        return (self.config.age_weight * age
                + self.config.size_weight * size)

    def order(self, pending: List[Job], now: float) -> List[Job]:
        return sorted(pending, key=lambda j: (-self.priority(j, now),
                                              j.submit_time, j.job_id))

    # -- helpers -------------------------------------------------------------

    def _queue(self, pending: List[Job], now: float) -> List[Job]:
        return self.order([j for j in pending
                           if j.state is JobState.PENDING], now)

    def _releases(self, running: List[Job], now: float,
                  runtime_estimate: RuntimeEstimate
                  ) -> List[Tuple[float, int]]:
        """(time, nodes) future node releases, soonest first."""
        return sorted(
            (now + max(runtime_estimate(j), 0.0), j.nodes)
            for j in running if j.state is JobState.RUNNING)

    # -- hook ----------------------------------------------------------------

    def schedule(self, pending: List[Job], running: List[Job], now: float,
                 runtime_estimate: RuntimeEstimate
                 ) -> List[Tuple[Job, int]]:
        raise NotImplementedError


@register_policy("fcfs")
class FCFSPolicy(SchedulingPolicy):
    """Strict priority order; the first job that doesn't fit blocks all."""

    def schedule(self, pending, running, now, runtime_estimate):
        free = self.cluster.free_nodes
        starts: List[Tuple[Job, int]] = []
        for job in self._queue(pending, now):
            if job.requested_nodes > free:
                break
            starts.append((job, job.requested_nodes))
            free -= job.requested_nodes
        return starts


@register_policy("easy")
class EasyBackfillPolicy(SchedulingPolicy):
    """EASY backfill (paper §7.2 setup): one reservation for the head job.

    Subclasses customize *sizing*, not structure: ``_start_size`` picks the
    allocation a job starts with now (None: must wait), ``_reservation_need``
    the head's reservation size, ``_est_end`` the backfill end estimate —
    the moldable start-size optimizer overrides exactly these three.
    """

    def _start_size(self, job: Job, free: int,
                    runtime_estimate: RuntimeEstimate) -> Optional[int]:
        """Nodes to start ``job`` with right now; None when it must wait."""
        return job.requested_nodes if job.requested_nodes <= free else None

    def _reservation_need(self, head: Job) -> int:
        return head.requested_nodes

    def _est_end(self, job: Job, size: int, now: float,
                 runtime_estimate: RuntimeEstimate) -> float:
        return now + max(runtime_estimate(job), 0.0)

    def schedule(self, pending, running, now, runtime_estimate):
        free = self.cluster.free_nodes
        queue = self._queue(pending, now)
        starts: List[Tuple[Job, int]] = []
        i = 0
        # Head-of-queue jobs start in priority order while they fit.
        while i < len(queue):
            s = self._start_size(queue[i], free, runtime_estimate)
            if s is None:
                break
            starts.append((queue[i], s))
            free -= s
            i += 1
        if i >= len(queue) or not self.config.backfill:
            return starts
        # Reservation for the blocked head: when will enough nodes free up?
        head_need = self._reservation_need(queue[i])
        avail = free
        shadow_time: Optional[float] = None
        shadow_free_at_reservation = 0
        for t, n in self._releases(running, now, runtime_estimate):
            avail += n
            if avail >= head_need:
                shadow_time = t
                shadow_free_at_reservation = avail - head_need
                break
        # Backfill the rest: start now iff it fits in `free` and either ends
        # before the reservation or fits in the reservation's spare nodes.
        for job in queue[i + 1:]:
            s = self._start_size(job, free, runtime_estimate)
            if s is None:
                continue
            est_end = self._est_end(job, s, now, runtime_estimate)
            if shadow_time is None or est_end <= shadow_time or \
                    s <= shadow_free_at_reservation:
                starts.append((job, s))
                free -= s
                if shadow_time is not None and est_end > shadow_time:
                    shadow_free_at_reservation -= s
        return starts


@register_policy("conservative")
class ConservativeBackfillPolicy(SchedulingPolicy):
    """Conservative backfill: no queued job's reservation may be delayed.

    Builds a piecewise node-availability profile from running-job release
    estimates, reserves every queued job at its earliest feasible slot in
    priority order, and lets a job start *now* only when `now` is that
    earliest slot — so nobody leapfrogs anybody's reservation.

    ``SchedulerConfig.backfill=False`` is honored: without backfill no job
    may start ahead of a blocked higher-priority job, which is exactly fcfs.
    """

    def schedule(self, pending, running, now, runtime_estimate):
        if not self.config.backfill:
            return FCFSPolicy.schedule(self, pending, running, now,
                                       runtime_estimate)
        queue = self._queue(pending, now)
        if not queue:
            return []
        # profile: sorted list of [time, free_nodes_from_t_onward]
        profile: List[List[float]] = [[now, float(self.cluster.free_nodes)]]
        for t, n in self._releases(running, now, runtime_estimate):
            profile.append([t, profile[-1][1] + n])
        starts: List[Tuple[Job, int]] = []
        for job in queue:
            need = job.requested_nodes
            dur = max(runtime_estimate(job), 0.0)
            t0 = self._earliest(profile, need, dur)
            if t0 is None:
                # Never fits the foreseeable profile (e.g. request larger
                # than the cluster): no reservation, nothing carved.
                continue
            if t0 <= now:
                starts.append((job, need))
            self._carve(profile, t0, t0 + dur, need)
        return starts

    @staticmethod
    def _earliest(profile, need: int, dur: float) -> Optional[float]:
        """Earliest start where `need` nodes stay free for `dur` seconds;
        None when no such window exists in the profile."""
        for i, (t0, _) in enumerate(profile):
            ok = True
            for t, avail in profile[i:]:
                if t >= t0 + dur:
                    break
                if avail < need:
                    ok = False
                    break
            if ok:
                return t0
        return None

    @staticmethod
    def _carve(profile, t0: float, t1: float, need: int) -> None:
        """Subtract `need` nodes from the profile on [t0, t1)."""
        # Split segments at t0 and t1 so subtraction stays piecewise-exact.
        for t_split in (t0, t1):
            for i, (t, avail) in enumerate(profile):
                if t == t_split:
                    break
                if t > t_split:
                    profile.insert(i, [t_split, profile[i - 1][1]])
                    break
            else:
                profile.append([t_split, profile[-1][1]])
        for seg in profile:
            if t0 <= seg[0] < t1:
                seg[1] -= need


@register_policy("malleable")
class MalleableEasyPolicy(EasyBackfillPolicy):
    """EASY backfill that exploits malleability of *running* jobs.

    A running malleable job can be shrunk by one factor step at its next
    reconfiguration point (§4.3 wide optimization), so those nodes count as
    an early release when placing the head reservation.  The reservation
    lands earlier, backfill windows shrink, and queued jobs start sooner —
    the scheduler-side half of the paper's productivity argument.

    ``j.min_nodes`` here is the *live* band floor: for an evolving job it
    reflects the current phase, so a phase that raises the floor stops this
    policy from counting a shrink that the DMR check would no longer grant.
    """

    def _releases(self, running, now, runtime_estimate):
        releases: List[Tuple[float, int]] = []
        for j in running:
            if j.state is not JobState.RUNNING:
                continue
            end = now + max(runtime_estimate(j), 0.0)
            shrunk = j.nodes // max(j.factor, 2)
            # A SERVING job negotiates on SLO pressure, not queue pressure:
            # its DMR check only releases nodes when traffic ebbs, so the
            # reservation must not bank on shrinking it (the grant may
            # never come while the diurnal peak holds).
            if j.serving:
                releases.append((end, j.nodes))
                continue
            if j.malleable and j.nodes > shrunk >= max(j.min_nodes, 1):
                # Split, not duplicate: the shrinkable part frees at the
                # next reconfig point, only the remainder at end of run.
                horizon = now + max(j.check_period_s, 1.0)
                releases.append((horizon, j.nodes - shrunk))
                releases.append((end, shrunk))
            else:
                releases.append((end, j.nodes))
        return sorted(releases)


@register_policy("sjf")
class SJFPolicy(EasyBackfillPolicy):
    """Shortest-job-first with EASY backfill and a starvation guard.

    Priority ranks by *estimated remaining runtime* (shorter first) plus the
    usual age term; any job older than ``sjf_starvation_age_s`` is promoted
    above every younger job (among the aged, older wins), so a long job can
    wait at most the guard age plus the drain of already-started work.
    """

    def __init__(self, cluster: Cluster, config: SchedulerConfig,
                 cost: Optional[ReconfigCostModel] = None):
        super().__init__(cluster, config, cost)
        self._est: Optional[RuntimeEstimate] = None

    def priority(self, job: Job, now: float) -> float:
        if job.priority_boost:
            return job.priority_boost
        age = now - job.submit_time
        if age >= self.config.sjf_starvation_age_s:
            # Aged out: beats any runtime estimate, loses only to boosts.
            return MAX_PRIORITY / 2 + age
        est = self._est(job) if self._est is not None else 0.0
        return self.config.age_weight * age - max(est, 0.0)

    def schedule(self, pending, running, now, runtime_estimate):
        self._est = runtime_estimate
        try:
            return super().schedule(pending, running, now, runtime_estimate)
        finally:
            self._est = None


@register_policy("fairshare")
class FairSharePolicy(EasyBackfillPolicy):
    """Multifactor priority minus per-user decayed usage (Slurm fair-share).

    Usage is node-seconds, decayed exponentially with half-life
    ``fairshare_halflife_s`` and charged on every ``schedule`` call from the
    running set.  The penalty is normalized by one *capacity half-life*
    (``num_nodes * halflife`` node-seconds), so ``fairshare_weight`` is
    comparable to the other priority weights.
    """

    def __init__(self, cluster: Cluster, config: SchedulerConfig,
                 cost: Optional[ReconfigCostModel] = None):
        super().__init__(cluster, config, cost)
        self._usage: Dict[int, float] = {}
        self._last_t: Optional[float] = None
        self._known: Dict[int, Job] = {}   # every job ever seen, until final

    # -- usage ledger --------------------------------------------------------

    def usage(self, user: int) -> float:
        return self._usage.get(user, 0.0)

    def record_usage(self, user: int, node_seconds: float) -> None:
        self._usage[user] = self._usage.get(user, 0.0) + node_seconds

    @staticmethod
    def _node_seconds(job: Job, a: float, b: float) -> float:
        """Node-seconds ``job`` consumed over ``(a, b]``, from its recorded
        allocation history (exact across starts/resizes/requeues)."""
        if b <= a:
            return 0.0
        hist = job.nodes_history
        if not hist:
            return 0.0
        total = 0.0
        for (t0, n0), (t1, _n1) in zip(hist, hist[1:]):
            lo, hi = max(t0, a), min(t1, b)
            if hi > lo:
                total += n0 * (hi - lo)
        # the open-ended last segment accrues only while still running
        t_last, n_last = hist[-1]
        if job.state is JobState.RUNNING and b > max(t_last, a):
            total += n_last * (b - max(t_last, a))
        return total

    def observe(self, jobs: List[Job], now: float) -> None:
        """Decay the ledger to ``now`` and charge the interval since the
        previous call.

        Every job ever seen (pending included) is tracked until it
        completes, and charged from its ``nodes_history`` — so a job that
        starts *and* finishes between two passes, is resized, or is
        requeued by a failure/preemption is still billed exactly for the
        node-seconds it held.
        """
        last = now if self._last_t is None else self._last_t
        dt = now - last
        if dt > 0:
            half = max(self.config.fairshare_halflife_s, 1e-9)
            decay = 0.5 ** (dt / half)
            self._usage = {u: v * decay
                           for u, v in sorted(self._usage.items())}
        for j in jobs:
            self._known.setdefault(j.job_id, j)
        if dt > 0:
            finished = []
            for job_id, j in sorted(self._known.items()):
                ns = self._node_seconds(j, last, now)
                if ns > 0:
                    self.record_usage(j.user, ns)
                if j.state in (JobState.COMPLETED, JobState.CANCELLED):
                    finished.append(job_id)     # history is final: settled
            for job_id in finished:
                del self._known[job_id]
        self._last_t = now

    # -- policy --------------------------------------------------------------

    def priority(self, job: Job, now: float) -> float:
        if job.priority_boost:
            return job.priority_boost
        cap = max(self.cluster.live_capacity, 1) * \
            max(self.config.fairshare_halflife_s, 1.0)
        return (super().priority(job, now)
                - self.config.fairshare_weight * self.usage(job.user) / cap)

    def schedule(self, pending, running, now, runtime_estimate):
        self.observe(list(pending) + list(running), now)
        return super().schedule(pending, running, now, runtime_estimate)


@register_policy("preempt")
class PreemptiveBackfillPolicy(EasyBackfillPolicy):
    """Preemptive backfill: shrink low-priority malleable runners for the head.

    When the blocked head's reservation would land more than
    ``preempt_grace_s`` in the future, running malleable jobs with priority
    below the head's are shrunk by one factor step (lowest priority first)
    until the head fits *now*.  Victims already at their minimum size are
    requeued instead when ``preempt_requeue`` is set.  If no plan frees
    enough nodes the policy falls back to plain EASY — no pointless churn.

    ``schedule`` itself stays mutation-free: the shrink/requeue directives
    are queued on :attr:`preemptions` (``(job, new_nodes)``, ``0`` means
    requeue) and applied by the simulator/runtime *before* the returned
    starts, so capacity accounting stays in one place.
    """

    def __init__(self, cluster: Cluster, config: SchedulerConfig,
                 cost: Optional[ReconfigCostModel] = None):
        super().__init__(cluster, config, cost)
        self.preemptions: List[Tuple[Job, int]] = []

    def pop_preemptions(self) -> List[Tuple[Job, int]]:
        out, self.preemptions = self.preemptions, []
        return out

    def _head_slip(self, free, head, running, now, runtime_estimate):
        """Seconds until the head's reservation (None: never in profile)."""
        avail = free
        for t, n in self._releases(running, now, runtime_estimate):
            avail += n
            if avail >= head.requested_nodes:
                return t - now
        return None

    def schedule(self, pending, running, now, runtime_estimate):
        self.preemptions = []
        free = self.cluster.free_nodes
        queue = self._queue(pending, now)
        starts: List[Tuple[Job, int]] = []
        i = 0
        # Same head-of-queue loop as EASY, via the sizing hook so preempt
        # composes with sizing overrides.
        while i < len(queue):
            s = self._start_size(queue[i], free, runtime_estimate)
            if s is None:
                break
            starts.append((queue[i], s))
            free -= s
            i += 1
        if i >= len(queue):
            return starts
        head = queue[i]
        slip = self._head_slip(free, head, running, now, runtime_estimate)
        if slip is not None and slip <= self.config.preempt_grace_s:
            return super().schedule(pending, running, now, runtime_estimate)
        head_pr = self.priority(head, now)
        victims = sorted(
            (j for j in running if j.state is JobState.RUNNING
             and j.malleable and self.priority(j, now) < head_pr),
            key=lambda j: (self.priority(j, now), j.job_id))
        plan: List[Tuple[Job, int]] = []
        freed = 0
        for v in victims:
            if free + freed >= head.requested_nodes:
                break
            factor = max(v.factor, 2)
            shrunk = v.nodes // factor
            if v.nodes % factor == 0 and shrunk >= max(v.min_nodes, 1):
                plan.append((v, shrunk))
                freed += v.nodes - shrunk
            elif self.config.preempt_requeue:
                plan.append((v, 0))
                freed += v.nodes
        if not plan or free + freed < head.requested_nodes:
            return super().schedule(pending, running, now, runtime_estimate)
        self.preemptions = plan
        starts.append((head, head.requested_nodes))
        free = free + freed - head.requested_nodes
        # Continue in strict priority order with what's left; stopping at the
        # first non-fitting job protects the *new* head from being leapfrogged.
        for job in queue[i + 1:]:
            s = self._start_size(job, free, runtime_estimate)
            if s is None:
                break
            starts.append((job, s))
            free -= s
        return starts


@register_policy("moldable")
class MoldableStartPolicy(EasyBackfillPolicy):
    """Moldable start-size optimizer (ROADMAP "policy zoo" item).

    For each startable job, picks the power-of-two size in
    ``[min_nodes, max_nodes]`` minimizing estimated completion: runtime
    scaled linearly from the requested-size estimate, plus — for malleable
    jobs — the :class:`ReconfigCostModel` cost of factor-stepping from the
    start size to the preferred size afterwards.  Jobs whose range contains
    no power of two start at their requested size unchanged.

    Uses the base class's ``self.cost`` — so a calibrated model threaded
    through ``SimConfig(cost=...)`` tightens the start-size estimates too.
    """

    # -- the optimizer -------------------------------------------------------

    @staticmethod
    def candidate_sizes(job: Job, cap: Optional[int] = None) -> List[int]:
        """Powers of two within the job's [min_nodes, max_nodes].

        ``cap`` (the cluster's live capacity) tightens the ceiling so the
        optimizer never weighs sizes the surviving cluster cannot host.
        """
        hi = job.max_nodes if cap is None else min(job.max_nodes, cap)
        sizes, p = [], 1
        while p <= hi:
            if p >= max(job.min_nodes, 1):
                sizes.append(p)
            p *= 2
        return sizes

    def reconfig_path_s(self, job: Job, start: int) -> float:
        """Redistribution cost of factor-stepping start -> preferred."""
        target = job.preferred or job.requested_nodes
        factor = max(job.factor, 2)
        total, cur = 0.0, start
        while cur < target and cur * factor <= job.max_nodes:
            total += self.cost.resize_time(cur, cur * factor, job.data_bytes)
            cur *= factor
        while cur > target and cur % factor == 0 and \
                cur // factor >= max(job.min_nodes, 1):
            total += self.cost.resize_time(cur, cur // factor, job.data_bytes)
            cur //= factor
        return total

    def best_start(self, job: Job, free: int,
                   runtime_estimate: RuntimeEstimate) -> Optional[int]:
        """Best power-of-two start size fitting ``free`` (None: none fits)."""
        cands = [s for s in self.candidate_sizes(
            job, self.cluster.live_capacity) if s <= free]
        if not cands:
            return None
        base = max(runtime_estimate(job), 0.0)
        req = max(job.requested_nodes, 1)
        best, best_cost = None, None
        for s in cands:
            t = base * req / s          # ~linear scaling around requested
            if job.malleable:
                t += self.reconfig_path_s(job, s)
            if best_cost is None or t < best_cost - 1e-12 or \
                    (abs(t - best_cost) <= 1e-12 and s < best):
                best, best_cost = s, t
        return best

    # -- EASY hooks: only the sizing differs from the base policy ------------

    def _start_size(self, job: Job, free: int,
                    runtime_estimate: RuntimeEstimate) -> Optional[int]:
        if not self.candidate_sizes(job):
            # No power of two in range (odd rigid request): as submitted.
            return job.requested_nodes if job.requested_nodes <= free else None
        return self.best_start(job, free, runtime_estimate)

    def _reservation_need(self, head: Job) -> int:
        # Reserve at the smallest size the head could ever start with.
        return min(self.candidate_sizes(head, self.cluster.live_capacity)
                   or [head.requested_nodes])

    def _est_end(self, job: Job, size: int, now: float,
                 runtime_estimate: RuntimeEstimate) -> float:
        return now + max(runtime_estimate(job), 0.0) * \
            max(job.requested_nodes, 1) / size


# ---------------------------------------------------------------------------
# Facade (back-compat API used by the simulator and runtime)
# ---------------------------------------------------------------------------

class Scheduler:
    """Thin facade: owns the policy selected by ``SchedulerConfig.policy``."""

    def __init__(self, cluster: Cluster,
                 config: Optional[SchedulerConfig] = None,
                 cost: Optional[ReconfigCostModel] = None):
        self.cluster = cluster
        self.config = SchedulerConfig() if config is None else config
        self.policy = make_policy(cluster, self.config, cost=cost)

    def priority(self, job: Job, now: float) -> float:
        return self.policy.priority(job, now)

    def order(self, pending: List[Job], now: float) -> List[Job]:
        return self.policy.order(pending, now)

    def schedule(self, pending: List[Job], running: List[Job], now: float,
                 runtime_estimate: RuntimeEstimate
                 ) -> List[Tuple[Job, int]]:
        return self.policy.schedule(pending, running, now, runtime_estimate)

    def pop_preemptions(self) -> List[Tuple[Job, int]]:
        """Drain preemption directives queued by the last ``schedule``.

        ``(job, new_nodes)`` pairs; ``new_nodes == 0`` means requeue.  Empty
        for policies that never preempt.
        """
        pop = getattr(self.policy, "pop_preemptions", None)
        return pop() if pop is not None else []
