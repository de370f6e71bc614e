"""``TraceRecorder`` — the engine monitor behind the observability layer.

Installed via ``engine.add_monitor`` (so it composes with the sanitizer),
the recorder turns the simulator's existing audit surfaces into typed
spans and event-sampled metrics *without touching simulation state*:

- job lifecycle spans (submit -> queued -> run segments -> finish) from
  ``Job.nodes_history``, with per-job queue/compute/reconfig attribution;
- DMR negotiation spans from new ``ActionRecord`` entries (decision,
  band, vocabulary reason from :mod:`repro_torch.rms.reasons`, duration);
- capacity/power/drain spans from the capacity-churn action records;
- SLO-pressure samples at every SERVING ``TrafficTick`` probe.

Observer-effect guarantee: every hook only *reads* simulator state and
appends to recorder-private structures, so a traced run's ``SimReport``
is byte-identical to a plain run (locked by ``tests/test_obs.py``).

Overhead: ``after_event`` is O(1) per event — it length-diffs the
simulator's append-only ``actions`` / ``timeline`` / ``capacity_timeline``
lists instead of scanning them, and the per-event metric updates are a
handful of dict lookups.  The budget is < 2x, pinned by the
``trace_sjf_mixed_sync`` twin in ``benchmarks/engine_bench.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.rms.engine import Event, TrafficTick
from repro_torch.rms.reasons import reason_code

#: Actions that move a job's data (Fig. 3 costs): charged to the job's
#: reconfiguration time and observed by the duration histogram.
RESIZE_ACTIONS = frozenset({
    "expand", "shrink", "preempt_shrink", "failure_shrink",
    "drain_shrink", "drain_migrate", "straggler_migrate",
})

#: The §4 negotiation outcomes proper — the DMR span track.
DMR_ACTIONS = frozenset({"expand", "shrink", "no_action"})

#: Cluster-level capacity actions (``job_id == -1``).
CAPACITY_ACTIONS = frozenset({
    "node_join", "node_drain", "power_off", "power_on",
})


@dataclasses.dataclass(frozen=True, slots=True)
class Span:
    """One typed span: ``[t0, t0+dur]`` on a named track."""
    name: str      # e.g. "expand", "run", "queued", "node_drain"
    kind: str      # taxonomy: job | dmr | capacity | disruption | slo
    track: str     # e.g. "job/0", "dmr/job0", "cluster"
    t0: float
    dur: float
    args: dict


class TraceRecorder:
    """Engine monitor recording spans + metrics for one simulation run.

    Usage::

        sim = ClusterSimulator(jobs, cfg)
        rec = TraceRecorder(sim).install()
        report = sim.run()
        rec.finalize(report)
        write_trace("/tmp/run", rec)        # repro_torch.obs.export

    Install *before* ``sim.run()`` — the engine hot loop hoists the
    monitor reference.  When no recorder is installed the engine path is
    exactly as before (zero overhead when disabled).
    """

    def __init__(self, sim, meta: Optional[dict] = None):
        from repro_torch.obs.metrics import MetricsRegistry
        self.sim = sim
        self.engine = sim.engine
        self.meta = dict(meta or {})
        self.metrics = MetricsRegistry()
        self.spans: List[Span] = []
        self.jobs: List[dict] = []          # per-job breakdown (finalize)
        self.serving: Dict[int, dict] = {}  # per-job SLO totals (finalize)
        self.makespan = 0.0
        self._finalized = False
        # cursors into the simulator's append-only audit lists
        self._n_actions = 0
        self._n_timeline = 0
        self._n_capacity = 0
        # private copies for the utilization cross-check
        self._timeline: List[Tuple[float, int, int, int]] = []
        self._capacity: List[Tuple[float, int, int]] = []
        # ledger: (action, reason code) -> [count, decide_s, apply_s]
        self._ledger: Dict[Tuple[str, str], List[float]] = {}
        self._reconfig_s: Dict[int, float] = {}   # job -> charged seconds
        self._resizes: Dict[int, int] = {}        # job -> resize count
        self._p99_seen: Dict[int, int] = {}       # job -> samples consumed
        self._event_counters: Dict[str, object] = {}
        # hoisted gauges (touched every event)
        m = self.metrics
        self._g_alloc = m.gauge("allocated_nodes")
        self._g_running = m.gauge("running_jobs")
        self._g_done = m.gauge("completed_jobs")
        self._g_queue = m.gauge("queue_depth")
        self._g_live = m.gauge("live_capacity")
        self._g_off = m.gauge("powered_off_nodes")
        self._sync = sim.config.scheduling == "sync"
        self._launch_s = sim.config.launch_latency_s

    # -- installation --------------------------------------------------------

    def install(self) -> "TraceRecorder":
        self.engine.add_monitor(self)
        return self

    def uninstall(self) -> None:
        self.engine.remove_monitor(self)

    # -- engine monitor hooks ------------------------------------------------

    def on_schedule(self, event: Event) -> None:
        pass

    def before_event(self, event: Event) -> None:
        pass

    def after_event(self, event: Event) -> None:
        sim = self.sim
        t = self.engine.now
        name = type(event).__name__
        counter = self._event_counters.get(name)
        if counter is None:
            counter = self._event_counters[name] = \
                self.metrics.counter("events_total", type=name)
        counter.value += 1

        actions = sim.actions
        n = len(actions)
        if n != self._n_actions:
            for record in actions[self._n_actions:]:
                self._record_action(record)
            self._n_actions = n
        timeline = sim.timeline
        n = len(timeline)
        if n != self._n_timeline:
            for row in timeline[self._n_timeline:]:
                self._timeline.append(row)
                self._g_alloc.set(row[0], row[1])
                self._g_running.set(row[0], row[2])
                self._g_done.set(row[0], row[3])
            self._n_timeline = n
        capacity = sim.capacity_timeline
        n = len(capacity)
        if n != self._n_capacity:
            for row in capacity[self._n_capacity:]:
                self._capacity.append(row)
                self._g_live.set(row[0], row[1])
                self._g_off.set(row[0], row[2])
            self._n_capacity = n
        self._g_queue.set(t, len(sim._pending_map))
        if type(event) is TrafficTick:
            self._sample_slo(event, t)

    # -- action -> span/ledger/metrics ---------------------------------------

    def _record_action(self, a) -> None:
        code = reason_code(a.reason)
        key = (a.action, code)
        row = self._ledger.get(key)
        if row is None:
            row = self._ledger[key] = [0, 0.0, 0.0]
        row[0] += 1
        row[1] += a.decide_s
        row[2] += a.apply_s

        if a.action in RESIZE_ACTIONS and not a.timed_out:
            self.metrics.histogram("reconfig_duration_s",
                                   reason=code).observe(
                a.decide_s + a.apply_s)
            if a.job_id >= 0:
                # sync DMR pauses the app for the decision too; async
                # overlaps it with compute, so only the apply is charged
                charged = a.apply_s + (a.decide_s if self._sync else 0.0)
                self._reconfig_s[a.job_id] = \
                    self._reconfig_s.get(a.job_id, 0.0) + charged
                self._resizes[a.job_id] = \
                    self._resizes.get(a.job_id, 0) + 1

        dur = a.decide_s + a.apply_s
        args = {"reason": a.reason, "from": a.from_nodes, "to": a.to_nodes}
        if a.timed_out:
            args["timed_out"] = True
        if a.action in DMR_ACTIONS and a.job_id >= 0:
            job = self.sim._by_id.get(a.job_id)
            if job is not None:
                args["band"] = [job.min_nodes, job.max_nodes,
                                job.preferred]
            kind, track = "dmr", f"dmr/job{a.job_id}"
        elif a.job_id < 0:
            kind, track = "capacity", "cluster"
        else:
            # disruptions: preempt/failure/drain/straggler paths and
            # EVOLVING phase_change announcements
            kind, track = "disruption", f"dmr/job{a.job_id}"
        self.spans.append(Span(a.action, kind, track, a.t, dur, args))

    def _sample_slo(self, event: TrafficTick, t: float) -> None:
        sim = self.sim
        jid = event.job_id
        samples = sim._p99_samples.get(jid)
        if samples is None:
            return
        seen = self._p99_seen.get(jid, 0)
        if len(samples) <= seen:
            return            # stale-epoch tick: the handler ignored it
        self._p99_seen[jid] = len(samples)
        p99 = samples[-1]
        job = sim._by_id[jid]
        slo = job.traffic.slo_p99_s
        backlog = sim._backlog.get(jid, 0.0)
        violated = p99 > slo
        self.metrics.gauge("serving_backlog", job=jid).set(t, backlog)
        self.metrics.gauge("serving_p99_s", job=jid).set(t, p99)
        if violated:
            self.metrics.counter("slo_violations", job=jid).inc()
        self.spans.append(Span(
            "slo_probe", "slo", f"slo/job{jid}", t, 0.0,
            {"p99_s": p99, "slo_s": slo, "backlog": backlog,
             "violated": violated}))

    # -- finalization --------------------------------------------------------

    def finalize(self, report, meta: Optional[dict] = None
                 ) -> "TraceRecorder":
        """Fold the finished run's report into per-job lifecycle spans,
        the breakdown table rows, and serving totals.  Idempotent inputs
        only: call once, after ``sim.run()``."""
        if self._finalized:
            return self
        self._finalized = True
        if meta:
            self.meta.update(meta)
        self.makespan = report.makespan
        for job in sorted(report.jobs, key=lambda j: j.job_id):
            self._finalize_job(job, report.makespan)
        for jid, (viol, served, p99) in sorted(
                report.serving_stats.items()):
            self.serving[jid] = {"slo_violations": viol,
                                 "served_requests": served, "p99_s": p99}
        return self

    def _finalize_job(self, job, makespan: float) -> None:
        end = job.end_time if job.end_time > 0 else makespan
        points: List[Tuple[float, Optional[int]]] = \
            [(job.submit_time, 0)] + list(job.nodes_history)
        # collapse to constant-value segments, emit one span per segment
        queued_s = run_s = 0.0
        starts = 0
        prev_t, prev_n = points[0]
        for t, n in points[1:] + [(end, None)]:
            t = min(t, end)
            if t > prev_t:
                dur = t - prev_t
                if prev_n == 0:
                    queued_s += dur
                    self.spans.append(Span(
                        "queued", "job", f"job/{job.job_id}",
                        prev_t, dur, {"nodes": 0}))
                else:
                    run_s += dur
                    self.spans.append(Span(
                        "run", "job", f"job/{job.job_id}",
                        prev_t, dur, {"nodes": prev_n}))
            if n is not None and n > 0 and prev_n == 0:
                starts += 1
            if n is not None:
                prev_t, prev_n = max(prev_t, t), n
        reconfig_s = self._reconfig_s.get(job.job_id, 0.0) + \
            starts * self._launch_s
        self.jobs.append({
            "job_id": job.job_id,
            "app": job.app,
            "state": job.state.value,
            "submit_t": job.submit_time,
            "start_t": job.start_time,
            "end_t": job.end_time,
            "queued_s": queued_s,
            "run_s": run_s,
            "reconfig_s": reconfig_s,
            "compute_s": max(run_s - reconfig_s, 0.0),
            "resizes": self._resizes.get(job.job_id, 0),
            "starts": starts,
        })

    # -- derived views -------------------------------------------------------

    def ledger(self) -> List[dict]:
        """DMR action ledger: (action, reason code) -> count + time sums.

        Every ``ActionRecord`` of the run lands in exactly one row, so
        the count column sums to ``len(report.actions)`` — the exactness
        the decision-audit CLI is checked against."""
        return [{"action": action, "reason": code, "count": row[0],
                 "decide_s": row[1], "apply_s": row[2]}
                for (action, code), row in sorted(self._ledger.items())]

    def utilization(self, sample_s: float = 10.0) -> Tuple[float, float]:
        """Recorder-side recomputation of ``SimReport.utilization`` from
        the recorder's private timeline copies — same sampling grid,
        same live-capacity denominator (the observer-effect cross-check).
        """
        if not self._timeline:
            return 0.0, 0.0
        ts = np.array([e[0] for e in self._timeline])
        alloc = np.array([e[1] for e in self._timeline], dtype=float)
        t_end = self.makespan if self.makespan > 0 else ts[-1]
        grid = np.arange(0.0, max(t_end, sample_s), sample_s)
        idx = np.clip(np.searchsorted(ts, grid, side="right") - 1, 0, None)
        if self._capacity:
            cts = np.array([e[0] for e in self._capacity])
            live = np.array([e[1] for e in self._capacity], dtype=float)
            cidx = np.clip(np.searchsorted(cts, grid, side="right") - 1,
                           0, None)
            denom = np.maximum(live[cidx], 1.0)
        else:
            denom = float(max(self.sim.config.num_nodes, 1))
        samples = alloc[idx] / denom * 100.0
        return float(samples.mean()), float(samples.std())
