"""Cluster simulator — the paper's §7 testbed on the event-driven engine.

Runs a workload of jobs (CG / Jacobi / N-body / FS / elastic-LM, or SWF
trace replays via :mod:`repro_torch.workload.swf`) through the RMS with either
the *fixed* or the *flexible* (malleable) configuration and either
*synchronous* or *asynchronous* DMR scheduling, reproducing the paper's
measurements:

- per-action overheads (Table 2, Fig. 3),
- cluster utilization + per-job wait/exec/completion gains (Table 3),
- workload throughput across sizes (Table 4, Figs. 4/5),
- time-evolution traces and per-job diffs (Figs. 6/7/8).

Beyond the paper: node-failure and straggler events exercise the
fault-tolerance paths (shrink-to-survivors, checkpoint restart, slice
migration) that make the same mechanism deployable at scale, and
``PhaseChange`` events realize the §2 EVOLVING class — jobs whose demand
band changes per phase at the application's initiative, renegotiated
through the same §5.2 DMR check as malleable resizes.

The discrete-event mechanics live in :mod:`repro_torch.rms.engine`; this module
registers one handler per event type, so new scenario classes are new
event types + handlers, not edits to a monolithic loop.
"""
from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.actions import Action, Decision
from repro_torch.rms.capacity import (CapacityConfig, CapacityManager,
                                      plan_drain)
from repro_torch.rms.cluster import Cluster
from repro_torch.rms.costmodel import PAPER_APPS, AppModel, ReconfigCostModel
from repro_torch.rms.engine import (CheckpointTick, ExpandTimeout, JobFinish,
                                    JobSubmit, NodeDrain, NodeFail, NodeJoin,
                                    NodePowerOff, NodePowerOn, PhaseChange,
                                    ReconfigPoint, SimulationEngine,
                                    StragglerOnset, StragglerScan, TrafficTick)
from repro_torch.rms.job import Job, JobState, clamp_band
from repro_torch.rms.policy import PolicyConfig, ReconfigPolicy
from repro_torch.rms.reasons import make_reason
from repro_torch.rms.scheduler import MAX_PRIORITY, Scheduler, SchedulerConfig
from repro_torch.workload.traffic import TrafficGenerator


@dataclasses.dataclass
class SimConfig:
    num_nodes: int = 64
    flexible: bool = True
    scheduling: str = "sync"          # "sync" | "async"
    expand_timeout_s: float = 40.0
    launch_latency_s: float = 1.0
    checkpoint_period_s: float = 120.0
    straggler_scan_s: float = 30.0
    straggler_threshold: float = 0.8
    # SERVING class: latency-probe cadence and the SLO-pressure negotiation
    # knobs — expand targets run at <= ``serving_headroom`` of capacity;
    # shrink only when the smaller size still clears demand by
    # ``serving_shrink_margin`` (hysteresis against diurnal flapping)
    traffic_tick_s: float = 10.0
    serving_headroom: float = 0.85
    serving_shrink_margin: float = 1.3
    seed: int = 7
    policy: PolicyConfig = dataclasses.field(default_factory=PolicyConfig)
    sched: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    cost: ReconfigCostModel = dataclasses.field(
        default_factory=ReconfigCostModel)
    # checked mode: install the runtime invariant sanitizer
    # (:mod:`repro_torch.rms.sanitizer`); also enabled by ``REPRO_SANITIZE=1``
    sanitize: bool = False
    failures: Tuple[Tuple[float, int], ...] = ()          # (time, node)
    stragglers: Tuple[Tuple[float, int, float], ...] = () # (time, node, slow)
    # elastic capacity: scheduled churn + CLUES-style power management
    capacity: CapacityConfig = dataclasses.field(
        default_factory=CapacityConfig)
    drains: Tuple[Tuple[float, int], ...] = ()            # (time, node)
    joins: Tuple[Tuple[float, int], ...] = ()             # (time, node|-1)


@dataclasses.dataclass
class ActionRecord:
    t: float
    job_id: int
    action: str
    decide_s: float      # RMS decision latency (Table 2 reports this)
    apply_s: float       # data redistribution + waits (Fig. 3b)
    from_nodes: int
    to_nodes: int
    timed_out: bool = False
    reason: str = ""


@dataclasses.dataclass
class SimReport:
    config: SimConfig
    jobs: List[Job]
    actions: List[ActionRecord]
    timeline: List[Tuple[float, int, int, int]]  # (t, allocated, running, done)
    makespan: float
    wall_time_s: float
    # real measured in-process policy latencies (seconds), for Table 2
    policy_wall_s: List[float] = dataclasses.field(default_factory=list)
    # capacity step function: (t, live_capacity, powered_off) — recorded at
    # every capacity-changing event (fail/drain/join/power cycle)
    capacity_timeline: List[Tuple[float, int, int]] = \
        dataclasses.field(default_factory=list)
    # SERVING class: per-job (slo_violations, served_requests, p99_s)
    serving_stats: Dict[int, Tuple[int, float, float]] = \
        dataclasses.field(default_factory=dict)

    # -- aggregate measures (paper definitions) -----------------------------

    def utilization(self, sample_s: float = 10.0) -> Tuple[float, float]:
        """Time-sampled allocated-node fraction: (avg %, std %).

        Each sample is normalized by the *live* capacity at that instant
        (the capacity step function), not the construction-time
        ``config.num_nodes`` — after a failure or drain the old stale
        denominator under-reported utilization of the surviving cluster.
        """
        if not self.timeline:
            return 0.0, 0.0
        ts = np.array([e[0] for e in self.timeline])
        alloc = np.array([e[1] for e in self.timeline], dtype=float)
        t_end = self.makespan if self.makespan > 0 else ts[-1]
        grid = np.arange(0.0, max(t_end, sample_s), sample_s)
        idx = np.clip(np.searchsorted(ts, grid, side="right") - 1, 0, None)
        if self.capacity_timeline:
            cts = np.array([e[0] for e in self.capacity_timeline])
            live = np.array([e[1] for e in self.capacity_timeline],
                            dtype=float)
            cidx = np.clip(np.searchsorted(cts, grid, side="right") - 1,
                           0, None)
            denom = np.maximum(live[cidx], 1.0)
        else:
            # initial capacity IS the live capacity when no churn event
            # ever recorded a snapshot
            denom = float(max(self.config.num_nodes,  # lint: disable=CAP001
                              1))
        samples = alloc[idx] / denom * 100.0
        return float(samples.mean()), float(samples.std())

    def _capacity_integral(self, col: int) -> float:
        """Integrate a capacity_timeline column over [0, makespan] (h)."""
        t_end = self.makespan
        if t_end <= 0:
            return 0.0
        pts = self.capacity_timeline or \
            [(0.0, self.config.num_nodes, 0)]    # lint: disable=CAP001
        total = 0.0
        for i, pt in enumerate(pts):
            t0 = min(pt[0], t_end)
            t1 = t_end if i + 1 == len(pts) else min(pts[i + 1][0], t_end)
            if t1 > t0:
                total += pt[col] * (t1 - t0)
        return total / 3600.0

    def node_hours(self) -> float:
        """Live (powered, non-dead) node·hours over the run — the second
        objective axis next to makespan: what the cluster *cost*."""
        return self._capacity_integral(1)

    def powered_off_hours(self) -> float:
        """Node·hours spent parked by the power manager — energy saved."""
        return self._capacity_integral(2)

    def job_metrics(self) -> Dict[int, Tuple[float, float, float]]:
        return {j.job_id: (j.wait_time, j.exec_time, j.completion_time)
                for j in self.jobs if j.state is JobState.COMPLETED}

    # -- serving aggregates (SLO axis next to makespan/node-hours) ----------

    def slo_violations(self) -> int:
        """Total TrafficTick probes that found p99 above the job's SLO."""
        return sum(v[0] for _, v in sorted(self.serving_stats.items()))

    def served_requests(self) -> float:
        """Total requests drained by serving jobs over the run."""
        return sum(v[1] for _, v in sorted(self.serving_stats.items()))

    def p99_latency(self) -> float:
        """Worst per-job p99 queueing delay (seconds) across serving jobs —
        the cluster violates the SLO iff its worst tenant does."""
        if not self.serving_stats:
            return 0.0
        return max(v[2] for _, v in sorted(self.serving_stats.items()))

    def averages(self) -> Tuple[float, float, float]:
        m = list(self.job_metrics().values())
        if not m:
            return 0.0, 0.0, 0.0
        arr = np.array(m)
        return tuple(arr.mean(axis=0))  # wait, exec, completion


class ClusterSimulator:
    """RMS simulation: handlers over a :class:`SimulationEngine`."""

    def __init__(self, jobs: List[Job], config: Optional[SimConfig] = None,
                 apps: Optional[Dict[str, AppModel]] = None):
        config = SimConfig() if config is None else config
        self.config = config
        self.apps = dict(PAPER_APPS if apps is None else apps)
        self.jobs = jobs
        # the one legal construction-time read: t=0 initial capacity
        self.cluster = Cluster(config.num_nodes)   # lint: disable=CAP001
        self.policy = ReconfigPolicy(config.policy)
        # The scheduler's moldable start-size optimizer and the resize
        # accounting below share one cost model — calibrated when
        # ``config.cost`` came from a calibration artifact.
        self.scheduler = Scheduler(self.cluster, config.sched,
                                   cost=config.cost)
        self.rng = np.random.default_rng(config.seed)
        self.engine = SimulationEngine()
        self.capacity = CapacityManager(self.cluster, self.engine,
                                        config.capacity)
        self.actions: List[ActionRecord] = []
        self.timeline: List[Tuple[float, int, int, int]] = []
        self.capacity_timeline: List[Tuple[float, int, int]] = []
        self._by_id = {j.job_id: j for j in jobs}
        # Hot-path job-set tracking: the scheduler pass and every DMR check
        # need "pending jobs submitted by now" and "running jobs"; scanning
        # the whole workload per event is O(jobs) each time (quadratic over
        # a trace replay).  Instead the sets are maintained incrementally
        # at the three state-transition sites (start / requeue / complete)
        # plus a submit-time pointer, and materialized in ``self.jobs``
        # order so every consumer sees exactly the order the full scan
        # produced (byte-identical golden traces).
        self._pos = {j.job_id: i for i, j in enumerate(jobs)}
        self._by_submit = sorted(jobs, key=lambda j: j.submit_time)
        self._submit_idx = 0
        self._pending_map: Dict[int, Job] = {}
        self._running_map: Dict[int, Job] = {}
        # Amdahl rates are pure in (app, nodes, serial_frac) — memoized so
        # runtime estimates (hottest call in backfill passes) stop
        # recomputing the same division chain.
        self._rate_memo: Dict[Tuple[str, int, Optional[float]], float] = {}
        self._est_memo: Dict[int, Tuple[Tuple, float]] = {}
        self._completed = 0
        self._waiting_expands: List[dict] = []   # async stale-grant waits
        self._pending_async: Dict[int, Tuple[Decision, float]] = {}
        self._ckpt_work: Dict[int, float] = {}
        self._ckpt_epoch: Dict[int, int] = {}    # active tick chain per job
        self._reconfig_epoch: Dict[int, int] = {}  # active check chain / job
        self._phase_epoch: Dict[int, int] = {}   # live phase prediction / job
        self._expand_epoch: Dict[int, int] = {}  # live expand waits / job
        self._wall_decide_s: List[float] = []
        # SERVING class: one open-loop generator per serving job, plus the
        # queueing state it drives.  ``work`` is pinned to the stream's
        # total arrivals so the conservation invariant
        # (arrivals == backlog + served) is exact by construction.
        self._traffic: Dict[int, TrafficGenerator] = {}
        self._traffic_seen: Dict[int, float] = {}   # arrivals accrued to t
        self._backlog: Dict[int, float] = {}        # queued requests
        self._slo_violations: Dict[int, int] = {}
        self._p99_samples: Dict[int, List[float]] = {}
        self._traffic_epoch: Dict[int, int] = {}    # live tick chain / job
        for j in jobs:
            if j.traffic is not None:
                gen = TrafficGenerator(j.traffic)
                self._traffic[j.job_id] = gen
                j.work = gen.total()
                self._traffic_seen[j.job_id] = j.traffic.t0
                self._backlog[j.job_id] = 0.0
                self._slo_violations[j.job_id] = 0
                self._p99_samples[j.job_id] = []
        self._wire_handlers()
        self.sanitizer = None
        if config.sanitize or \
                os.environ.get("REPRO_SANITIZE", "") not in ("", "0"):
            # imported lazily: the sanitizer is optional machinery and
            # imports scheduler/cluster/engine names from this package
            from repro_torch.rms.sanitizer import SimSanitizer
            self.sanitizer = SimSanitizer(self).install()

    @property
    def now(self) -> float:
        return self.engine.now

    # -- plumbing ------------------------------------------------------------

    def _wire_handlers(self):
        e = self.engine
        e.on(JobSubmit, lambda ev: self._on_arrival(self._by_id[ev.job_id]))
        e.on(JobFinish, lambda ev: self._on_complete(self._by_id[ev.job_id],
                                                     ev.version))
        e.on(ReconfigPoint, lambda ev: self._on_check(self._by_id[ev.job_id],
                                                     ev.epoch))
        e.on(ExpandTimeout,
             lambda ev: self._on_expand_timeout(ev.job_id, ev.since,
                                                ev.epoch))
        e.on(PhaseChange, self._on_phase_change)
        e.on(NodeFail, lambda ev: self._on_failure(ev.node))
        e.on(NodeJoin, lambda ev: self._on_node_join(ev.node))
        e.on(NodeDrain, lambda ev: self._on_node_drain(ev.node))
        e.on(NodePowerOff, lambda ev: self._on_power_off(ev.node))
        e.on(NodePowerOn, lambda ev: self._on_power_on(ev.node))
        e.on(StragglerOnset,
             lambda ev: self._on_straggler(ev.node, ev.slowdown))
        e.on(StragglerScan, lambda ev: self._on_straggler_scan(ev.job_id))
        e.on(CheckpointTick,
             lambda ev: self._on_checkpoint(ev.job_id, ev.epoch))
        e.on(TrafficTick,
             lambda ev: self._on_traffic_tick(ev.job_id, ev.epoch))

    def _app(self, job: Job) -> AppModel:
        return self.apps[job.app]

    def _serial_frac(self, job: Job) -> Optional[float]:
        """Per-phase serial-fraction override (None: app default)."""
        ph = job.current_phase()
        return None if ph is None else ph.serial_frac

    def _data_bytes(self, job: Job) -> int:
        """State moved on reconfiguration — per-phase when evolving."""
        ph = job.current_phase()
        if ph is not None and ph.data_bytes is not None:
            return ph.data_bytes
        return self._app(job).data_bytes

    def _app_rate(self, job: Job, nodes: int) -> float:
        """Memoized ``AppModel.rate`` — pure in (app, nodes, serial_frac)."""
        sf = self._serial_frac(job)
        key = (job.app, nodes, sf)
        r = self._rate_memo.get(key)
        if r is None:
            r = self._app(job).rate(nodes, sf)
            self._rate_memo[key] = r
        return r

    def _rate(self, job: Job) -> float:
        return (self._app_rate(job, job.nodes)
                * self.cluster.job_rate_factor(job.job_id))

    def _advance(self, job: Job):
        if job.state is not JobState.RUNNING:
            return
        if job.traffic is not None:
            self._serving_advance(job)
            return
        t0 = max(job.last_progress_t, job.paused_until)
        if self.now > t0 >= 0:
            job.work_done = min(job.work,
                                job.work_done + self._rate(job)
                                * (self.now - t0))
        job.last_progress_t = max(self.now, job.paused_until)

    def _serving_advance(self, job: Job):
        """SERVING progress = request drain against an open-loop stream.

        Arrivals accrue unconditionally (pauses and requeues cannot slow
        the world down — the lazy catch-up from ``_traffic_seen`` covers
        any gap); drain happens only over the unpaused interval, capped by
        what the backlog holds.  ``work_done`` counts served requests, so
        ``arrivals == backlog + work_done`` at all times (the sanitizer's
        ``serving_conservation`` invariant).
        """
        jid = job.job_id
        gen = self._traffic[jid]
        seen = self._traffic_seen[jid]
        if self.now > seen:
            self._backlog[jid] += gen.arrivals_between(seen, self.now)
            self._traffic_seen[jid] = self.now
        t0 = max(job.last_progress_t, job.paused_until)
        if self.now > t0 >= 0:
            served = min(self._backlog[jid],
                         self._rate(job) * (self.now - t0))
            self._backlog[jid] -= served
            job.work_done = min(job.work, job.work_done + served)
        job.last_progress_t = max(self.now, job.paused_until)
        # window over and drained: snap the float-drift remainder into
        # served so completion is exact, not asymptotic
        if self._traffic_seen[jid] >= job.traffic.end and \
                self._backlog[jid] <= 1e-6 * max(job.work, 1.0):
            self._backlog[jid] = 0.0
            job.work_done = job.work

    def _pause(self, job: Job, seconds: float):
        self._advance(job)
        job.paused_until = max(job.paused_until, self.now) + seconds
        job.last_progress_t = job.paused_until

    def _schedule_completion(self, job: Job):
        job.completion_version += 1
        remaining = max(job.work - job.work_done, 0.0)
        t0 = max(self.now, job.paused_until)
        if job.traffic is not None:
            # a serving job cannot finish before its window closes, and the
            # drain-rate estimate below is optimistic (arrivals keep
            # coming) — _on_complete re-checks and refines, converging
            # once ``now >= end`` because remaining == backlog then
            t_end = max(t0 + remaining / self._rate(job), job.traffic.end)
            self.engine.schedule(JobFinish(t_end, job.job_id,
                                           job.completion_version))
            return
        t_end = t0 + remaining / self._rate(job)
        self.engine.schedule(JobFinish(t_end, job.job_id,
                                       job.completion_version))
        self._schedule_phase_change(job, t0)

    def _schedule_phase_change(self, job: Job, t0: float):
        """(Re)predict when the running job crosses its next phase boundary.

        Called alongside every completion (re)scheduling — both predictions
        depend on the same ``(work_done, rate, paused_until)`` state, so
        they stay consistent by construction.  The epoch bump invalidates
        any prediction from a prior start/resize.
        """
        epoch = self._phase_epoch.get(job.job_id, 0) + 1
        self._phase_epoch[job.job_id] = epoch
        boundary = job.phase_boundary()
        if boundary is None or boundary >= job.work - 1e-9:
            return
        to_go = max(boundary - job.work_done, 0.0)
        nxt = job.phases[job.phase_index + 1]
        self.engine.schedule(PhaseChange(
            t0 + to_go / self._rate(job), job.job_id,
            job.phase_index + 1, nxt.min_nodes, nxt.max_nodes,
            nxt.preferred, epoch))

    def _snapshot(self):
        running = sum(1 for j in self._running_map.values()
                      if j.state is JobState.RUNNING)
        self.timeline.append((self.now, self.cluster.allocated_nodes,
                              running, self._completed))

    def _capacity_snapshot(self):
        self.capacity_timeline.append(
            (self.now, self.cluster.live_capacity,
             len(self.cluster.powered_off)))

    def _pending_jobs(self) -> List[Job]:
        """Pending jobs submitted by ``now``, in workload order.

        Incremental: newly-reachable submissions are folded in by
        advancing a pointer over the submit-time-sorted workload (a job
        with ``submit_time == now`` is visible even before its JobSubmit
        event dispatches, exactly like the full scan this replaces), and
        started jobs were already removed at their transition.
        """
        bys = self._by_submit
        i, n, now = self._submit_idx, len(bys), self.now
        while i < n and bys[i].submit_time <= now:
            j = bys[i]
            if j.state is JobState.PENDING:
                self._pending_map[j.job_id] = j
            i += 1
        self._submit_idx = i
        out = [j for j in                          # re-sorted by _pos below
               self._pending_map.values()          # lint: disable=DET001
               if j.state is JobState.PENDING]
        if len(out) != len(self._pending_map):    # externally mutated job
            self._pending_map = {j.job_id: j for j in out}
        out.sort(key=lambda j: self._pos[j.job_id])
        return out

    def _running_jobs(self) -> List[Job]:
        """Running jobs in workload order (see :meth:`_pending_jobs`)."""
        out = [j for j in                          # re-sorted by _pos below
               self._running_map.values()          # lint: disable=DET001
               if j.state is JobState.RUNNING]
        if len(out) != len(self._running_map):    # externally mutated job
            self._running_map = {j.job_id: j for j in out}
        out.sort(key=lambda j: self._pos[j.job_id])
        return out

    def _runtime_estimate(self, job: Job) -> float:
        if job.traffic is not None:
            # a serving job occupies nodes until its window closes plus
            # whatever requests are left to drain; depends on (now, drain
            # state) so it stays out of the memo below.  Outstanding work
            # is counted from the arrival curve, not the accrued backlog:
            # a job still PENDING after its window elapsed has zero
            # backlog on the books but a full window of requests to
            # serve, and an estimate of 0 makes reservation-based
            # policies (conservative) carve empty profiles and
            # over-allocate.
            nodes = job.nodes or job.requested_nodes
            gen = self._traffic[job.job_id]
            outstanding = max(
                gen.arrivals_until(min(self.now, job.traffic.end)) -
                job.work_done, 0.0)
            return max(job.traffic.end - self.now, 0.0) + \
                outstanding / self._app_rate(job, nodes)
        # Memoized on the exact state the estimate depends on: work_done
        # only moves at _advance calls, so between events the same value
        # is requested hundreds of times by backfill priority sorts.
        key = (job.work_done, job.nodes, job.requested_nodes,
               job.phase_index)
        hit = self._est_memo.get(job.job_id)
        if hit is not None and hit[0] == key:
            return hit[1]
        nodes = job.nodes or job.requested_nodes
        remaining = max(job.work - job.work_done, 0.0)
        est = remaining / self._app_rate(job, nodes)
        self._est_memo[job.job_id] = (key, est)
        return est

    # -- scheduling ------------------------------------------------------------

    def _scheduler_pass(self):
        self._grant_waiting_expands()
        starts = self.scheduler.schedule(
            self._pending_jobs(), self._running_jobs(),
            self.now, self._runtime_estimate)
        # Preemption directives (preempt policy) free capacity the returned
        # starts already count on, so they are applied first.
        preempted = self.scheduler.pop_preemptions()
        for job, new in preempted:
            self._apply_preemption(job, new)
        for job, n in starts:
            self.cluster.allocate(job.job_id, n)
            job.nodes = n
            job.state = JobState.RUNNING
            self._pending_map.pop(job.job_id, None)
            self._running_map[job.job_id] = job
            job.start_time = self.now
            job.priority_boost = 0.0
            job.last_progress_t = self.now + self.config.launch_latency_s
            job.paused_until = job.last_progress_t
            job.record_nodes(self.now)
            # Restore point = progress carried into this start (0 for fresh
            # jobs; preserved work for failure/preemption requeue restarts).
            self._ckpt_work[job.job_id] = job.work_done
            self._schedule_completion(job)
            if self.config.flexible and job.malleable:
                # New epoch: a check chain surviving a preemption/failure
                # requeue must die at the guard, not double the frequency.
                repoch = self._reconfig_epoch.get(job.job_id, 0) + 1
                self._reconfig_epoch[job.job_id] = repoch
                self.engine.schedule(ReconfigPoint(
                    self._next_check_time(job), job.job_id, repoch))
            if self.config.checkpoint_period_s > 0:
                # New epoch: a chain surviving a requeue/restart goes stale.
                epoch = self._ckpt_epoch.get(job.job_id, 0) + 1
                self._ckpt_epoch[job.job_id] = epoch
                self.engine.schedule(CheckpointTick(
                    self.now + self.config.checkpoint_period_s, job.job_id,
                    epoch))
            if job.traffic is not None:
                # New epoch: a tick chain surviving a requeue goes stale.
                tepoch = self._traffic_epoch.get(job.job_id, 0) + 1
                self._traffic_epoch[job.job_id] = tepoch
                self.engine.schedule(TrafficTick(
                    self.now + self.config.traffic_tick_s, job.job_id,
                    tepoch))
        if starts or preempted:
            self._snapshot()
        # power management observes queue pressure after every pass; unmet
        # waiting-expand deltas count as demand (a starving RJ can boot a
        # parked node, §5.2.1 meets CLUES)
        if self.config.capacity.enabled:
            extra = sum(
                max(w["decision"].new_slices - w["job"].nodes
                    - self.cluster.allocation(-(w["job"].job_id + 1)), 0)
                for w in self._waiting_expands)
            self.capacity.note_pass(self._pending_jobs(), self.now, extra)

    def _drop_waiting_expands(self, job_id: int) -> bool:
        """Structurally void a job's pending expand waits: remove the wait
        entries, release the RJ reservation, and bump the epoch so any
        in-flight ``ExpandTimeout`` dies at its guard instead of matching a
        stale ``(job_id, since)`` pair.  Returns True when a wait (and its
        reservation) was actually dropped."""
        self._expand_epoch[job_id] = self._expand_epoch.get(job_id, 0) + 1
        kept = [w for w in self._waiting_expands
                if w["job"].job_id != job_id]
        dropped = len(kept) != len(self._waiting_expands)
        if dropped:
            self.cluster.release(-(job_id + 1))
        self._waiting_expands = kept
        return dropped

    def _apply_phase_band(self, job: Job, phase_idx: int, min_nodes: int,
                          max_nodes: int, preferred: Optional[int]):
        """Make ``phase_idx`` the live phase with the announced band:
        rewrite the job's band (clamped to the cluster) and keep the
        restart size inside it."""
        job.phase_index = phase_idx
        # clamp to *live* capacity: after a failure/drain the old
        # ``config.num_nodes`` ceiling let a phase band exceed the real
        # cluster and blow up in ``allocate`` (over-allocation RuntimeError)
        lo, hi, pref = clamp_band(min_nodes, max_nodes, preferred,
                                  max(self.cluster.live_capacity, 1))
        job.min_nodes, job.max_nodes, job.preferred = lo, hi, pref
        job.requested_nodes = min(max(job.requested_nodes, lo), hi)

    def _sync_phase_to_work(self, job: Job):
        """A checkpoint restore can rewind ``work_done`` into an earlier
        phase; re-derive the live phase/band from the preserved progress so
        the queued job advertises the demand it will actually resume with
        (the skipped transitions re-fire as the replayed work crosses the
        boundaries again)."""
        if not job.phases:
            return
        cum, idx = 0.0, len(job.phases) - 1
        for i, ph in enumerate(job.phases):
            cum += ph.work
            if job.work_done < cum - 1e-9:
                idx = i
                break
        if idx != job.phase_index:
            ph = job.phases[idx]
            self._apply_phase_band(job, idx, ph.min_nodes, ph.max_nodes,
                                   ph.preferred)

    def _requeue(self, job: Job, action: str, from_nodes: int, reason: str):
        """Kill a running job back to the queue; progress survives."""
        self.cluster.release(job.job_id)
        job.state = JobState.PENDING
        job.nodes = 0
        self._running_map.pop(job.job_id, None)
        self._pending_map[job.job_id] = job
        job.completion_version += 1
        self._pending_async.pop(job.job_id, None)  # decision is stale now
        self._drop_waiting_expands(job.job_id)     # RJ wait is stale too
        # a stale phase prediction must not fire against the restart
        self._phase_epoch[job.job_id] = \
            self._phase_epoch.get(job.job_id, 0) + 1
        # a stale traffic-tick chain must not survive into the restart
        if job.traffic is not None:
            self._traffic_epoch[job.job_id] = \
                self._traffic_epoch.get(job.job_id, 0) + 1
        self._sync_phase_to_work(job)
        job.record_nodes(self.now)
        self.actions.append(ActionRecord(
            self.now, job.job_id, action, 0.0, 0.0, from_nodes, 0,
            reason=reason))

    def _apply_preemption(self, job: Job, new: int):
        """Shrink (``new > 0``) or requeue (``new == 0``) a running victim."""
        if job.state is not JobState.RUNNING:
            return
        self._advance(job)
        old = job.nodes
        if new <= 0:
            self._requeue(job, "preempt_requeue", old,
                          "head-reservation-slip")
            return
        self.cluster.resize(job.job_id, new)
        resize_s = self.config.cost.resize_time(
            old, new, self._data_bytes(job))
        self._pause(job, resize_s)
        job.nodes = new
        job.record_nodes(self.now)
        self._ckpt_work[job.job_id] = job.work_done   # state moved with it
        self.actions.append(ActionRecord(
            self.now, job.job_id, "preempt_shrink", 0.0, resize_s, old, new,
            reason="head-reservation-slip"))
        self._schedule_completion(job)

    def _next_check_time(self, job: Job) -> float:
        app = self._app(job)
        period = app.check_period_s or \
            app.iter_time(job.nodes, self._serial_frac(job))
        return max(self.now, job.paused_until) + period

    # -- the DMR check (paper §5) ----------------------------------------------

    def _serving_demand(self, job: Job) -> Tuple[float, float]:
        """(needed_rps, slo_pressure) for a serving job right now.

        Demand = the live arrival rate plus the throughput required to
        drain the current backlog within one SLO period; pressure is the
        p99-vs-SLO ratio the negotiation reasons report (>= 1: violating).
        """
        jid = job.job_id
        gen = self._traffic[jid]
        backlog = self._backlog.get(jid, 0.0)
        slo = max(job.traffic.slo_p99_s, 1e-9)
        needed = gen.rate(self.now) + backlog / slo
        rate = self._rate(job)
        pressure = (backlog / rate) / slo if rate > 0 else float("inf")
        return needed, pressure

    def _serving_target(self, job: Job, needed: float) -> int:
        """Smallest factor-ladder size in the band whose throughput covers
        ``needed`` req/s at ``serving_headroom`` occupancy."""
        lo = max(job.min_nodes, 1)
        hi = max(job.max_nodes, lo)
        f = max(job.factor, 2)
        n = lo
        while n < hi:
            if self._app_rate(job, n) * self.config.serving_headroom \
                    >= needed:
                return n
            n = min(n * f, hi)
        return hi

    def _serving_band(self, job: Job) -> Tuple[int, int, Optional[int],
                                               float]:
        """SLO-pressure band for the DMR check (§5.2 with a new trigger).

        Instead of remaining work, the serving job's announcement is
        derived from queueing pressure: when the target size is above the
        current one the job *requests* an expansion (step-capped to the
        adjacent factor size so mode-1 negotiation always has a legal
        step); when traffic ebbs enough that the next step down still
        clears demand by ``serving_shrink_margin`` it offers the nodes
        back; otherwise it holds (preferred = current).
        """
        needed, pressure = self._serving_demand(job)
        cur = job.nodes
        lo, hi = max(job.min_nodes, 1), max(job.max_nodes, 1)
        target = self._serving_target(job, needed)
        if target > cur:
            return min(target, cur * max(job.factor, 2)), hi, None, pressure
        down = max(cur // max(job.factor, 2), lo)
        if down < cur and self._app_rate(job, down) * \
                self.config.serving_headroom >= \
                needed * self.config.serving_shrink_margin:
            return lo, down, None, pressure
        return lo, hi, cur, pressure

    def _decide(self, job: Job) -> Tuple[Decision, float]:
        app = self._app(job)
        # SERVING jobs negotiate on SLO pressure (backlog / capacity), not
        # remaining work; EVOLVING jobs negotiate over their *live* band
        # (rewritten by the PhaseChange handler); fixed-demand jobs keep
        # the app model's.
        pressure = None
        if job.serving:
            lo, hi, pref, pressure = self._serving_band(job)
        elif job.evolving:
            lo, hi, pref = job.min_nodes, job.max_nodes, job.preferred
        else:
            lo, hi, pref = app.min_nodes, app.max_nodes, app.preferred
        wall0 = _time.perf_counter()
        decision = self.policy.decide(
            self.cluster, self._pending_jobs(), job,
            minimum=lo, maximum=hi,
            factor=job.factor, preferred=pref, slo_pressure=pressure)
        wall = _time.perf_counter() - wall0  # real policy latency (measured)
        self._wall_decide_s.append(wall)
        nodes_involved = max(job.nodes, decision.new_slices)
        model_s = self.config.cost.schedule_time(
            decision.action, nodes_involved, rng=self.rng)
        # deterministic sim time: the measured in-process latency is
        # reported separately (SimReport.policy_wall_s), not injected.
        return decision, model_s

    def _apply(self, job: Job, decision: Decision, decide_s: float,
               waited_s: float = 0.0, pause_decide: bool = True):
        app = self._app(job)
        old = job.nodes
        if decision.action is Action.NO_ACTION:
            self.actions.append(ActionRecord(
                self.now, job.job_id, "no_action", decide_s, 0.0, old, old,
                reason=decision.reason))
            return
        new = decision.new_slices
        if decision.action is Action.EXPAND and \
                new - old > self.cluster.free_nodes:
            # Stale grant that cannot be satisfied now (async path).
            self.actions.append(ActionRecord(
                self.now, job.job_id, "expand", decide_s, waited_s, old, old,
                timed_out=True, reason="stale-grant"))
            return
        resize_s = self.config.cost.resize_time(old, new,
                                                self._data_bytes(job))
        self.cluster.resize(job.job_id, new)
        # Async mode hides the scheduling latency behind the previous step
        # (§5.1: "the communication overhead in that step is avoided").
        self._pause(job, (decide_s if pause_decide else 0.0) + resize_s)
        job.nodes = new
        job.record_nodes(self.now)
        self._ckpt_work[job.job_id] = job.work_done
        name = "expand" if decision.action is Action.EXPAND else "shrink"
        self.actions.append(ActionRecord(
            self.now, job.job_id, name, decide_s, waited_s + resize_s,
            old, new, reason=decision.reason))
        if decision.boost_job_id is not None:
            for q in self.jobs:
                if q.job_id == decision.boost_job_id:
                    q.priority_boost = MAX_PRIORITY
        self._schedule_completion(job)
        self._snapshot()
        if new < old:
            self._scheduler_pass()   # freed nodes may start queued jobs

    def _grant_waiting_expands(self):
        """Feed freed nodes to waiting resizer jobs (max priority, §5.2.1).

        An RJ holds a *reservation*: nodes it has already claimed are
        invisible to the scheduler until the expand completes or times out —
        this queue starvation is the async-mode pathology of Table 2.
        """
        still = []
        for w in self._waiting_expands:
            job, decision = w["job"], w["decision"]
            rj_id = -(job.job_id + 1)           # pseudo-job for the RJ
            if job.state is not JobState.RUNNING:
                self.cluster.release(rj_id)
                continue
            delta = decision.new_slices - job.nodes
            need = delta - self.cluster.allocation(rj_id)
            grab = min(need, self.cluster.free_nodes)
            if grab > 0:
                self.cluster.allocate(rj_id, grab)
            if self.cluster.allocation(rj_id) >= delta:
                self.cluster.release(rj_id)     # hand the nodes to the job
                waited = self.now - w["since"]
                # _apply reschedules completion itself (the grant always
                # takes the resize path: the released reservation covers
                # the delta, so the stale-grant branch can't trigger) —
                # rescheduling again here bumped completion_version twice
                # and left a dead JobFinish in the heap per granted expand.
                self._apply(job, decision, w["decide_s"], waited_s=waited,
                            pause_decide=False)
            else:
                still.append(w)
        self._waiting_expands = still

    def _on_check(self, job: Job, epoch: int = 0):
        if job.state is not JobState.RUNNING or \
                epoch != self._reconfig_epoch.get(job.job_id, 0):
            return
        self._advance(job)
        if any(w["job"].job_id == job.job_id for w in self._waiting_expands):
            self.engine.schedule(ReconfigPoint(self._next_check_time(job),
                                               job.job_id, epoch))
            return
        if self.config.scheduling == "async":
            # Apply the decision scheduled at the previous point…
            prev = self._pending_async.pop(job.job_id, None)
            if prev is not None:
                decision, decide_s = prev
                if decision.action is Action.EXPAND and \
                        decision.new_slices - job.nodes > \
                        self.cluster.free_nodes:
                    # …whose resources may have vanished: wait w/ timeout.
                    self._pause(job, 0.0)
                    self._waiting_expands.append(dict(
                        job=job, decision=decision, decide_s=decide_s,
                        since=self.now))
                    self.engine.schedule(ExpandTimeout(
                        self.now + self.config.expand_timeout_s,
                        job.job_id, self.now,
                        self._expand_epoch.get(job.job_id, 0)))
                    self.engine.schedule(ReconfigPoint(
                        self._next_check_time(job), job.job_id, epoch))
                    return
                self._apply(job, decision, decide_s, pause_decide=False)
            # …and schedule the next decision concurrently (zero job cost).
            decision, decide_s = self._decide(job)
            if decision.action is Action.NO_ACTION:
                self.actions.append(ActionRecord(
                    self.now, job.job_id, "no_action", decide_s, 0.0,
                    job.nodes, job.nodes, reason=decision.reason))
            else:
                self._pending_async[job.job_id] = (decision, decide_s)
        else:
            decision, decide_s = self._decide(job)
            self._apply(job, decision, decide_s)
        if job.state is JobState.RUNNING:
            self.engine.schedule(ReconfigPoint(self._next_check_time(job),
                                               job.job_id, epoch))

    # -- events ------------------------------------------------------------------

    def _on_arrival(self, job: Job):
        self._scheduler_pass()

    def _on_complete(self, job: Job, version: int):
        if job.state is not JobState.RUNNING or \
                version != job.completion_version:
            return
        self._advance(job)
        if job.work_done < job.work - 1e-9:
            self._schedule_completion(job)
            return
        job.state = JobState.COMPLETED
        job.end_time = self.now
        job.record_nodes(self.now)
        self.cluster.release(job.job_id)
        self._running_map.pop(job.job_id, None)
        self._completed += 1
        self._pending_async.pop(job.job_id, None)
        self._snapshot()
        self._scheduler_pass()

    def _on_expand_timeout(self, job_id: int, since: float, epoch: int = 0):
        if epoch != self._expand_epoch.get(job_id, 0):
            return          # requeue/phase-change voided this wait chain
        for w in list(self._waiting_expands):
            if w["job"].job_id == job_id and w["since"] == since:
                self._waiting_expands.remove(w)
                job = w["job"]
                self.cluster.release(-(job_id + 1))   # drop RJ reservation
                waited = self.now - since
                self.actions.append(ActionRecord(
                    self.now, job_id, "expand", w["decide_s"], waited,
                    job.nodes, job.nodes, timed_out=True,
                    reason="rj-timeout"))
                job.paused_until = max(job.paused_until, self.now)
                job.last_progress_t = job.paused_until
                self._schedule_completion(job)
                self._scheduler_pass()

    def _on_checkpoint(self, job_id: int, epoch: int):
        """Periodic checkpoint (§6): refresh the NodeFail restore point."""
        job = self._by_id.get(job_id)
        if job is None or job.state is not JobState.RUNNING or \
                epoch != self._ckpt_epoch.get(job_id):
            return
        self._advance(job)
        self._ckpt_work[job_id] = job.work_done
        self.engine.schedule(CheckpointTick(
            self.now + self.config.checkpoint_period_s, job_id, epoch))

    def _on_traffic_tick(self, job_id: int, epoch: int):
        """SERVING latency probe: accrue arrivals, drain, sample p99.

        The p99 proxy is the time to drain the current backlog at the
        current allocation — the queueing delay the *next* arriving
        request would see.  The chain re-arms itself while the job runs;
        the epoch guard retires a chain left over from a prior start
        (same pattern as ReconfigPoint/CheckpointTick).
        """
        job = self._by_id.get(job_id)
        if job is None or job.state is not JobState.RUNNING or \
                epoch != self._traffic_epoch.get(job_id, 0):
            return
        self._advance(job)
        rate = self._rate(job)
        backlog = self._backlog.get(job_id, 0.0)
        p99 = backlog / rate if rate > 0 else float("inf")
        self._p99_samples[job_id].append(p99)
        if p99 > job.traffic.slo_p99_s:
            self._slo_violations[job_id] += 1
        if job.work_done >= job.work - 1e-9:
            # window over and drained (the _serving_advance snap fired):
            # finalize now instead of waiting for the estimate to land
            self._schedule_completion(job)
            return
        self.engine.schedule(TrafficTick(
            self.now + self.config.traffic_tick_s, job_id, epoch))

    def _on_phase_change(self, ev: PhaseChange):
        """EVOLVING (§2): the application enters its next phase.

        Applies the band the event carries to the job's *live*
        ``min_nodes``/``max_nodes``/``preferred`` (every scheduling policy
        reads those, so the new demand is visible at the next pass), voids
        any outstanding expand wait negotiated under the old band, and
        forces an immediate DMR check (§5.2) on a fresh epoch so the RMS
        reacts now instead of at the next periodic point.
        """
        job = self._by_id.get(ev.job_id)
        if job is None or job.state is not JobState.RUNNING or \
                ev.epoch != self._phase_epoch.get(ev.job_id, 0):
            return
        self._advance(job)
        boundary = sum(ph.work for ph in job.phases[:ev.phase])
        if job.work_done < boundary - 1e-9:
            # prediction went stale without a reschedule (e.g. a straggler
            # slowed the rate after it was made): re-predict from actual
            # progress, same pattern as _on_complete
            self._schedule_phase_change(job, max(self.now, job.paused_until))
            return
        # apply exactly the band the application announced in the event
        self._apply_phase_band(job, ev.phase, ev.min_nodes, ev.max_nodes,
                               ev.preferred)
        self.actions.append(ActionRecord(
            self.now, job.job_id, "phase_change", 0.0, 0.0,
            job.nodes, job.nodes,
            reason=make_reason("phase-entered", ev.phase)))
        # an expand wait negotiated under the old band is void; if its RJ
        # reservation held nodes, offer them to the queue now (same as the
        # timeout path) instead of letting them idle until the next event
        if self._drop_waiting_expands(job.job_id):
            self._scheduler_pass()
        self._pending_async.pop(job.job_id, None)
        # rate may have changed (per-phase serial fraction): re-predict
        # completion and the next boundary
        self._schedule_completion(job)
        if self.config.flexible and job.malleable:
            repoch = self._reconfig_epoch.get(job.job_id, 0) + 1
            self._reconfig_epoch[job.job_id] = repoch
            self.engine.schedule(ReconfigPoint(self.now, job.job_id, repoch))

    def _on_failure(self, node: int):
        # ``fail_node`` is idempotent and live_capacity is derived from the
        # pools, so a double-failed node costs exactly one node of capacity
        # (the old ``cluster.num_nodes -= 1`` here charged it per event).
        owner = self.cluster.fail_node(node)
        self._capacity_snapshot()
        if owner is None:
            self._snapshot()
            return
        if owner < 0:
            # the node was held by an RJ reservation, not a job: the expand
            # it was reserved for can no longer count on it
            self._snapshot()
            self._scheduler_pass()
            return
        job = self._by_id[owner]
        self._advance(job)
        if job.traffic is None:
            # ckpt restore — serving jobs never rewind: a served request
            # cannot be un-served, only the backlog re-queues
            job.work_done = self._ckpt_work.get(job.job_id, 0.0)
            # the restore may rewind into an earlier phase: the live band
            # (and the min-nodes test below) must reflect the resumed phase
            self._sync_phase_to_work(job)
        survivors = self.cluster.allocation(job.job_id)
        # live band floor: for evolving jobs the current phase's minimum,
        # not the submission-time envelope (identical for fixed-demand jobs)
        min_floor = job.min_nodes if job.evolving else \
            self._app(job).min_nodes
        if job.malleable and survivors >= min_floor:
            # Shrink-to-survivors: largest factor-consistent size that fits.
            new = job.nodes
            while new > survivors or (new != survivors and new > min_floor):
                if new % job.factor or new // job.factor < 1:
                    break
                new //= job.factor
                if new <= survivors:
                    break
            new = max(min(new, survivors), 1)
            self.cluster.resize(job.job_id, new)
            resize_s = self.config.cost.resize_time(
                job.nodes, new, self._data_bytes(job))
            self._pause(job, resize_s + 5.0)   # restore overhead
            job.nodes = new
            job.record_nodes(self.now)
            self.actions.append(ActionRecord(
                self.now, job.job_id, "failure_shrink", 0.0, resize_s,
                survivors + 1, new,
                reason=make_reason("node-failed", node)))
            self._schedule_completion(job)
        else:
            # Rigid job (or too few survivors): requeue, checkpoint restart.
            self._requeue(job, "failure_requeue", survivors + 1,
                          make_reason("node-failed", node))
        self._snapshot()
        self._scheduler_pass()

    # -- elastic capacity (beyond-paper: the pool itself is dynamic) -----------

    def _on_node_join(self, node: int):
        """A node enters the pool (scale-out / maintenance done / repaired).

        Freed capacity is offered immediately: waiting resizer jobs grant
        first (max priority, §5.2.1), then queued jobs.
        """
        before = self.cluster.live_capacity
        nid = self.cluster.join_node(node if node >= 0 else None)
        after = self.cluster.live_capacity
        if after == before:
            return                      # already a live member: no-op
        self.actions.append(ActionRecord(
            self.now, -1, "node_join", 0.0, 0.0, before, after,
            reason=make_reason("node-join", nid)))
        self._capacity_snapshot()
        self._scheduler_pass()

    def _on_node_drain(self, node: int):
        """A node must leave the pool; negotiate its owner off it first.

        Idle nodes retire immediately.  For an owned node the RMS picks the
        cheapest exit (:func:`repro_torch.rms.capacity.plan_drain`): slice
        migration to a healthy free node, a factor-consistent DMR shrink
        (§5.2.2 fold), or a checkpoint requeue — then the vacated node is
        routed to ``draining`` instead of back to ``free``.
        """
        before = self.cluster.live_capacity
        owner = self.cluster.drain_node(node)
        if owner is None:
            if self.cluster.live_capacity != before:
                self.actions.append(ActionRecord(
                    self.now, -1, "node_drain", 0.0, 0.0, before,
                    self.cluster.live_capacity,
                    reason=make_reason("node-drain-idle", node)))
                self._capacity_snapshot()
            return
        if owner < 0:
            # held by an RJ reservation: it retires when the reservation
            # releases (grant or timeout) — nothing to negotiate with
            return
        job = self._by_id[owner]
        self._advance(job)
        min_floor = job.min_nodes if job.evolving else \
            self._app(job).min_nodes
        kind, new = plan_drain(self.cluster, job, node, min_floor)
        if kind == "migrate":
            self.cluster.replace_node(owner, node)
            migrate_s = self.config.cost.resize_time(
                job.nodes, max(job.nodes // 2, 1),
                self._data_bytes(job) // max(job.nodes, 1))
            self._pause(job, migrate_s)
            self.actions.append(ActionRecord(
                self.now, owner, "drain_migrate", 0.0, migrate_s,
                job.nodes, job.nodes,
                reason=make_reason("drain-vacate", node)))
            self._schedule_completion(job)
        elif kind == "shrink":
            old = job.nodes
            self.cluster.move_to_tail(owner, node)   # fold sender = tail
            self.cluster.resize(owner, new)
            resize_s = self.config.cost.resize_time(
                old, new, self._data_bytes(job))
            self._pause(job, resize_s)
            job.nodes = new
            job.record_nodes(self.now)
            self._ckpt_work[job.job_id] = job.work_done
            self.actions.append(ActionRecord(
                self.now, owner, "drain_shrink", 0.0, resize_s, old, new,
                reason=make_reason("drain-vacate", node)))
            self._schedule_completion(job)
        else:
            self._requeue(job, "drain_requeue", job.nodes,
                          make_reason("drain-vacate", node))
        self.actions.append(ActionRecord(
            self.now, -1, "node_drain", 0.0, 0.0, before,
            self.cluster.live_capacity,
            reason=make_reason("node-drain", node)))
        self._capacity_snapshot()
        self._snapshot()
        self._scheduler_pass()

    def _on_power_off(self, node: int):
        """Park idle capacity: explicit node, or let the armed manager
        timer pick (re-validated against queue pressure at fire time)."""
        before = self.cluster.live_capacity
        if node >= 0:
            offs = [node] if self.cluster.power_off_node(node) else []
        else:
            offs = self.capacity.confirm_power_off(
                self._pending_jobs(), self.now)
        if not offs:
            return
        self.actions.append(ActionRecord(
            self.now, -1, "power_off", 0.0, 0.0, before,
            self.cluster.live_capacity,
            reason=make_reason("power-off",
                               ",".join(str(n) for n in offs))))
        self._capacity_snapshot()

    def _on_power_on(self, node: int):
        """A parked node finished booting: back into the pool, and offer
        it to waiting expands / queued jobs immediately."""
        before = self.cluster.live_capacity
        if not self.capacity.confirm_power_on(node):
            return
        self.actions.append(ActionRecord(
            self.now, -1, "power_on", 0.0, 0.0, before,
            self.cluster.live_capacity,
            reason=make_reason("power-on", node)))
        self._capacity_snapshot()
        self._scheduler_pass()

    def _on_straggler(self, node: int, slowdown: float):
        owner = self.cluster.set_straggler(node, slowdown)
        if owner is not None:
            self.engine.schedule(StragglerScan(
                self.now + self.config.straggler_scan_s, owner))

    def _on_straggler_scan(self, job_id: int):
        job = self._by_id.get(job_id)
        if job is None or job.state is not JobState.RUNNING:
            return
        if self.cluster.job_rate_factor(job_id) >= \
                self.config.straggler_threshold:
            return
        self._advance(job)
        if self.cluster.swap_straggler(job_id):
            migrate_s = self.config.cost.resize_time(
                job.nodes, max(job.nodes // 2, 1),
                self._data_bytes(job) // max(job.nodes, 1))
            self._pause(job, migrate_s)
            self.actions.append(ActionRecord(
                self.now, job_id, "straggler_migrate", 0.0, migrate_s,
                job.nodes, job.nodes, reason="slice-migration"))
            self._schedule_completion(job)
        else:
            self.engine.schedule(StragglerScan(
                self.now + self.config.straggler_scan_s, job_id))

    # -- main loop ------------------------------------------------------------------

    def run(self) -> SimReport:
        wall0 = _time.perf_counter()
        for job in self.jobs:
            if not self.config.flexible:
                job.malleable = False
            self.engine.schedule(JobSubmit(job.submit_time, job.job_id))
        for t, node in self.config.failures:
            self.engine.schedule(NodeFail(t, node))
        for t, node, slow in self.config.stragglers:
            self.engine.schedule(StragglerOnset(t, node, slow))
        for t, node in self.config.drains:
            self.engine.schedule(NodeDrain(t, node))
        for t, node in self.config.joins:
            self.engine.schedule(NodeJoin(t, node))
        self._capacity_snapshot()       # t=0 anchor of the step function
        self.engine.run()
        makespan = max((j.end_time for j in self.jobs
                        if j.end_time > 0), default=0.0)
        rep = SimReport(self.config, self.jobs, self.actions, self.timeline,
                        makespan, _time.perf_counter() - wall0,
                        capacity_timeline=self.capacity_timeline)
        rep.policy_wall_s = list(self._wall_decide_s)
        for jid in sorted(self._traffic):
            samples = self._p99_samples[jid]
            p99 = float(np.percentile(np.asarray(samples), 99)) \
                if samples else 0.0
            rep.serving_stats[jid] = (
                self._slo_violations[jid],
                self._by_id[jid].work_done, p99)
        return rep
