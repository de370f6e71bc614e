"""Opt-in runtime invariant sanitizer — the dynamic half of the
determinism/correctness tooling (the static half is the reference's
``repro.lint``).

Enabled with ``SimConfig(sanitize=True)`` or ``REPRO_SANITIZE=1``, the
sanitizer installs itself as the engine's ``monitor`` and validates the
simulation's structural invariants around every dispatched event:

==========================  ================================================
Invariant name              Meaning
==========================  ================================================
``node_conservation``       free + quarantine + allocated + draining +
                            powered_off + dead == nodes_ever_joined.
``node_state_disjoint``     no node appears in two lifecycle pools at once
                            (gated full scan).
``dead_node_allocated``     no job owns a dead / powered-off / quarantined
                            node (gated full scan).
``quarantine_routing``      a known-slow node never sits in the healthy
                            ``free`` pool.
``allocation_mismatch``     ``job.nodes`` matches the cluster's allocation
                            (0 unless RUNNING).
``band_order``              1 <= min_nodes <= preferred <= max_nodes.
``band_capacity``           a freshly-applied phase band fits live capacity.
``stale_expand_wait``       every async expand wait belongs to a RUNNING job.
``stale_rj_reservation``    every RJ pseudo-allocation has a live wait.
``epoch_monotonic``         per-job epoch counters never move backwards and
                            no event carries an epoch from the future.
``duplicate_check_chain``   at most one pending ReconfigPoint /
                            CheckpointTick / PhaseChange per (job, epoch) —
                            a duplicated chain doubles the check frequency.
``completion_version``      at most one pending JobFinish per (job, version)
                            — a version that isn't bumped before reschedule
                            can double-complete a job.
``causal_schedule``         no event is scheduled in the past.
``heap_invariant``          the engine's event heap satisfies the heap
                            property (gated full scan).
``fairshare_billing``       the FairShare ledger matches an independent
                            shadow re-billing to < 1e-9 relative drift.
``serving_backlog``         a SERVING job's backlog / served counters are
                            non-negative and served never exceeds the
                            stream total.
``serving_conservation``    open-loop conservation: arrivals accrued ==
                            backlog + served (requests are neither minted
                            nor dropped by resizes/requeues).
==========================  ================================================

A violation raises :class:`SanitizerError` carrying the invariant name,
the triggering event, and the simulation time — it is a *structural* bug
in the simulator (or a deliberately seeded mutation in the test suite),
never a property of the workload.

Cost: per-event checks are O(running jobs); the pool-membership scans are
amortized (every ``FULL_SCAN_EVERY`` events, plus every capacity-churn
event).  The engine-bench ``sanitize`` scenario pins the overhead < 3x.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from repro_torch.rms.engine import (CheckpointTick, Event, ExpandTimeout,
                                    JobFinish, NodeDrain, NodeFail, NodeJoin,
                                    NodePowerOff, NodePowerOn, PhaseChange,
                                    ReconfigPoint, TrafficTick)
from repro_torch.rms.job import Job, JobState
from repro_torch.rms.scheduler import FairSharePolicy

# Absolute slack for float comparisons on simulation timestamps.
T_EPS = 1e-9
# Relative drift tolerated between the fairshare ledger and the shadow.
BILLING_TOL = 1e-9
# Pool-membership / heap scans run every N events (and on churn events).
FULL_SCAN_EVERY = 256

# Events that move nodes between lifecycle pools: always worth a full scan.
CHURN_EVENTS = (NodeFail, NodeJoin, NodeDrain, NodePowerOff, NodePowerOn)

# Chain events deduplicated per (kind, job_id, epoch).  ExpandTimeout is
# excluded: two pending timeouts under one epoch are legal (a wait can be
# granted and re-entered without an epoch bump; ``since`` disambiguates).
_CHAIN_KINDS = {ReconfigPoint: "reconfig", CheckpointTick: "ckpt",
                PhaseChange: "phase", TrafficTick: "traffic"}

_EPOCH_ATTRS = {ReconfigPoint: "_reconfig_epoch",
                CheckpointTick: "_ckpt_epoch",
                PhaseChange: "_phase_epoch",
                ExpandTimeout: "_expand_epoch",
                TrafficTick: "_traffic_epoch"}

# Relative slack for the serving conservation check: the drain integrates
# float arithmetic per event, and completion snaps a remainder of at most
# 1e-6 * work into served.
SERVING_TOL = 1e-6


class SanitizerError(AssertionError):
    """A structural invariant of the simulation was violated.

    Attributes:
        invariant: machine-readable invariant name (table in module doc).
        t:         simulation time at the violation.
        event:     the event being scheduled/dispatched (may be None).
        detail:    human-readable description of the violated condition.
    """

    def __init__(self, invariant: str, t: float, event: Optional[Event],
                 detail: str):
        self.invariant = invariant
        self.t = t
        self.event = event
        self.detail = detail
        super().__init__(
            f"[{invariant}] t={t:.6f} event={event!r}: {detail}")


def _true_node_seconds(job: Job, a: float, b: float) -> float:
    """Independent reimplementation of the fairshare node-second integral
    (NOT ``FairSharePolicy._node_seconds`` — the shadow must not inherit a
    bug, or a test mutation, in the code under check)."""
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
    t_last, n_last = hist[-1]
    if job.state is JobState.RUNNING and b > max(t_last, a):
        total += n_last * (b - max(t_last, a))
    return total


class SimSanitizer:
    """Engine monitor validating simulator invariants around every event.

    Install with :meth:`install` *before* ``engine.run()`` (the hot loop
    hoists the monitor reference).  ``ClusterSimulator`` does this in its
    constructor when ``SimConfig.sanitize`` / ``REPRO_SANITIZE`` asks.
    """

    def __init__(self, sim):
        self.sim = sim
        self.engine = sim.engine
        self.checks = 0             # after_event invocations
        # pending JobFinish versions per job (duplicate => double-complete)
        self._finish_versions: Dict[int, Set[int]] = {}
        # pending chain events per (kind, job_id, epoch)
        self._chain_counts: Dict[Tuple[str, int, int], int] = {}
        # high-water mark of the simulator's stored epoch per (kind, job)
        self._epoch_high: Dict[Tuple[str, int], int] = {}
        self._fs_policy: Optional[FairSharePolicy] = None
        self._fs_usage: Dict[int, float] = {}
        self._fs_last_t: Optional[float] = None
        self._fs_known: Dict[int, Job] = {}

    # -- installation --------------------------------------------------------

    def install(self) -> "SimSanitizer":
        self.engine.add_monitor(self)
        self._wrap_phase_band()
        policy = self.sim.scheduler.policy
        if isinstance(policy, FairSharePolicy):
            self._wrap_fairshare(policy)
        return self

    def _wrap_phase_band(self):
        """Post-check every band application at the exact moment it happens
        — the only point where ``max_nodes <= live_capacity`` is guaranteed
        (later drains may legally strand an applied band above capacity)."""
        sim = self.sim
        inner = sim._apply_phase_band

        def checked(job, phase_idx, min_nodes, max_nodes, preferred):
            inner(job, phase_idx, min_nodes, max_nodes, preferred)
            self._check_band_order(job, None)
            cap = max(sim.cluster.live_capacity, 1)
            if job.max_nodes > cap:
                self._fail("band_capacity", None,
                           f"job {job.job_id} phase {phase_idx} band max "
                           f"{job.max_nodes} exceeds live capacity {cap}")

        sim._apply_phase_band = checked

    def _wrap_fairshare(self, policy: FairSharePolicy):
        """Shadow the usage ledger: re-bill every observe() from an
        independent node-second integral and compare per-user."""
        self._fs_policy = policy
        inner = policy.observe

        def observed(jobs, now):
            self._fs_shadow_observe(jobs, now)
            inner(jobs, now)
            self._fs_compare()

        policy.observe = observed

    # -- engine monitor hooks ------------------------------------------------

    def on_schedule(self, event: Event):
        now = self.engine.now
        if event.t < now - T_EPS:
            self._fail("causal_schedule", event,
                       f"scheduled at t={event.t} before now={now}")
        cls = type(event)
        if cls is JobFinish:
            pending = self._finish_versions.setdefault(event.job_id, set())
            if event.version in pending:
                self._fail("completion_version", event,
                           f"job {event.job_id} already has a pending "
                           f"JobFinish for version {event.version} — "
                           f"completion_version was not bumped")
            pending.add(event.version)
            return
        kind = _CHAIN_KINDS.get(cls)
        if kind is not None:
            key = (kind, event.job_id, event.epoch)
            n = self._chain_counts.get(key, 0) + 1
            self._chain_counts[key] = n
            if n > 1:
                self._fail("duplicate_check_chain", event,
                           f"{n} pending {kind} events for job "
                           f"{event.job_id} epoch {event.epoch}")

    def before_event(self, event: Event):
        # Bookkeeping must decrement *before* handlers run: a handler
        # rescheduling its own chain (the legal steady state) would
        # otherwise look like a duplicate.
        cls = type(event)
        if cls is JobFinish:
            pending = self._finish_versions.get(event.job_id)
            if pending is not None:
                pending.discard(event.version)
            return
        kind = _CHAIN_KINDS.get(cls)
        if kind is not None:
            key = (kind, event.job_id, event.epoch)
            n = self._chain_counts.get(key, 0)
            if n <= 1:
                self._chain_counts.pop(key, None)
            else:
                self._chain_counts[key] = n - 1

    def after_event(self, event: Event):
        self.checks += 1
        cluster = self.sim.cluster
        # node-state conservation: disjoint state counts must sum to every
        # node that ever joined (count form: O(running) per event)
        counts = cluster.state_counts()
        total = (counts["free"] + counts["allocated"] + counts["draining"]
                 + counts["powered_off"] + counts["dead"])
        if total != cluster.nodes_ever_joined:
            self._fail("node_conservation", event,
                       f"state counts {counts} sum to {total}, expected "
                       f"nodes_ever_joined={cluster.nodes_ever_joined}")
        # known-slow nodes must never sit in the healthy free pool
        if cluster.slow:
            for node in cluster.free:
                if cluster.slow.get(node, 1.0) > 1.0:
                    self._fail("quarantine_routing", event,
                               f"slow node {node} (x"
                               f"{cluster.slow[node]}) in the free pool")
        job_id = getattr(event, "job_id", None)
        if job_id is not None and job_id >= 0:
            job = self.sim._by_id.get(job_id)
            if job is not None:
                self._check_job(job, event)
        self._check_expand_waits(event)
        self._check_epochs(event)
        if self.checks % FULL_SCAN_EVERY == 0 or \
                isinstance(event, CHURN_EVENTS):
            self._full_scan(event)

    # -- invariant checks ----------------------------------------------------

    def _fail(self, invariant: str, event: Optional[Event], detail: str):
        raise SanitizerError(invariant, self.engine.now, event, detail)

    def _check_band_order(self, job: Job, event: Optional[Event]):
        lo, hi, pref = job.min_nodes, job.max_nodes, job.preferred
        if not 1 <= lo <= hi:
            self._fail("band_order", event,
                       f"job {job.job_id} band min={lo} max={hi} violates "
                       f"1 <= min <= max")
        if pref is not None and not lo <= pref <= hi:
            self._fail("band_order", event,
                       f"job {job.job_id} preferred={pref} outside band "
                       f"[{lo}, {hi}]")

    def _check_job(self, job: Job, event: Optional[Event]):
        self._check_band_order(job, event)
        alloc = self.sim.cluster.allocation(job.job_id)
        if job.state is JobState.RUNNING:
            if alloc != job.nodes or alloc <= 0:
                self._fail("allocation_mismatch", event,
                           f"RUNNING job {job.job_id} has job.nodes="
                           f"{job.nodes} but cluster allocation {alloc}")
        elif alloc != 0:
            self._fail("allocation_mismatch", event,
                       f"{job.state.name} job {job.job_id} still holds "
                       f"{alloc} cluster nodes")
        if job.traffic is not None:
            self._check_serving(job, event)

    def _check_serving(self, job: Job, event: Optional[Event]):
        """SERVING queueing state: sign bounds + open-loop conservation.

        The stream is open-loop, so at any instant the arrivals accrued up
        to ``_traffic_seen`` must equal backlog + served exactly (to float
        slack): a resize or requeue can delay requests but can neither
        drop nor mint them.  The re-derivation reads the generator — pure
        in (seed, curve) — not the simulator's own accounting.
        """
        sim = self.sim
        jid = job.job_id
        gen = sim._traffic.get(jid)
        if gen is None:
            self._fail("serving_backlog", event,
                       f"serving job {jid} has no traffic generator")
        backlog = sim._backlog.get(jid, 0.0)
        tol = SERVING_TOL * max(job.work, 1.0)
        if backlog < -T_EPS:
            self._fail("serving_backlog", event,
                       f"job {jid} backlog is negative: {backlog!r}")
        if not -T_EPS <= job.work_done <= job.work + tol:
            self._fail("serving_backlog", event,
                       f"job {jid} served {job.work_done!r} outside "
                       f"[0, work={job.work!r}]")
        seen = sim._traffic_seen.get(jid, job.traffic.t0)
        arrivals = gen.arrivals_until(seen)
        if abs(arrivals - (backlog + job.work_done)) > tol:
            self._fail("serving_conservation", event,
                       f"job {jid}: arrivals({seen!r})={arrivals!r} but "
                       f"backlog {backlog!r} + served {job.work_done!r} "
                       f"= {backlog + job.work_done!r}")

    def _check_expand_waits(self, event: Optional[Event]):
        waiting: Set[int] = set()
        for w in self.sim._waiting_expands:
            job = w["job"]
            waiting.add(job.job_id)
            if job.state is not JobState.RUNNING:
                self._fail("stale_expand_wait", event,
                           f"expand wait for job {job.job_id} in state "
                           f"{job.state.name}")
        for owner in self.sim.cluster.owned:
            if owner < 0 and (-owner - 1) not in waiting:
                self._fail("stale_rj_reservation", event,
                           f"RJ reservation {owner} (job {-owner - 1}) has "
                           f"no pending expand wait")

    def _check_epochs(self, event: Event):
        attr = _EPOCH_ATTRS.get(type(event))
        if attr is None:
            return
        stored = getattr(self.sim, attr).get(event.job_id, 0)
        if event.epoch > stored:
            self._fail("epoch_monotonic", event,
                       f"event epoch {event.epoch} is ahead of the stored "
                       f"{attr} {stored} for job {event.job_id}")
        key = (attr, event.job_id)
        prev = self._epoch_high.get(key)
        if prev is not None and stored < prev:
            self._fail("epoch_monotonic", event,
                       f"stored {attr} for job {event.job_id} moved "
                       f"backwards: {prev} -> {stored}")
        self._epoch_high[key] = stored

    def _full_scan(self, event: Optional[Event]):
        cluster = self.sim.cluster
        owned_nodes: List[int] = []
        for owner in sorted(cluster.owned):
            owned_nodes.extend(cluster.owned[owner])
        pools = (list(cluster.free) + list(cluster.quarantine)
                 + list(cluster.draining) + list(cluster.powered_off)
                 + sorted(cluster.dead) + owned_nodes)
        if len(pools) != len(set(pools)):
            seen: Set[int] = set()
            dupes = sorted(n for n in pools
                           if n in seen or seen.add(n))
            self._fail("node_state_disjoint", event,
                       f"nodes in more than one lifecycle pool: {dupes}")
        unusable = (set(cluster.dead) | set(cluster.powered_off)
                    | set(cluster.quarantine))
        bad = unusable.intersection(owned_nodes)
        if bad:
            self._fail("dead_node_allocated", event,
                       f"jobs own dead/powered-off/quarantined nodes: "
                       f"{sorted(bad)}")
        for job_id in sorted(self.sim._by_id):
            self._check_job(self.sim._by_id[job_id], event)
        heap = self.engine._heap
        for i in range(1, len(heap)):
            if heap[i] < heap[(i - 1) >> 1]:
                self._fail("heap_invariant", event,
                           f"heap property violated at index {i}")

    # -- fairshare shadow ledger ---------------------------------------------

    def _fs_shadow_observe(self, jobs: List[Job], now: float):
        """Mirror ``FairSharePolicy.observe`` arithmetic exactly (same
        operation order per user), but bill from the independent
        node-second integral."""
        policy = self._fs_policy
        last = now if self._fs_last_t is None else self._fs_last_t
        dt = now - last
        if dt > 0:
            half = max(policy.config.fairshare_halflife_s, 1e-9)
            decay = 0.5 ** (dt / half)
            self._fs_usage = {u: v * decay
                              for u, v in sorted(self._fs_usage.items())}
        for j in jobs:
            self._fs_known.setdefault(j.job_id, j)
        if dt > 0:
            finished = []
            for job_id, j in sorted(self._fs_known.items()):
                ns = _true_node_seconds(j, last, now)
                if ns > 0:
                    self._fs_usage[j.user] = \
                        self._fs_usage.get(j.user, 0.0) + ns
                if j.state in (JobState.COMPLETED, JobState.CANCELLED):
                    finished.append(job_id)
            for job_id in finished:
                del self._fs_known[job_id]
        self._fs_last_t = now

    def _fs_compare(self):
        real = self._fs_policy._usage
        for user in sorted(set(self._fs_usage) | set(real)):
            want = self._fs_usage.get(user, 0.0)
            got = real.get(user, 0.0)
            tol = BILLING_TOL * max(1.0, abs(want), abs(got))
            if abs(want - got) > tol:
                self._fail("fairshare_billing", None,
                           f"user {user} ledger drift: policy billed "
                           f"{got!r}, shadow billed {want!r}")
