"""Standard Workload Format (SWF) trace ingestion — real-trace replay.

The Parallel Workloads Archive's SWF is the lingua franca of scheduling
studies: one job per line, 18 whitespace-separated fields, ``;`` comment
lines carrying header metadata (``; MaxNodes: 128``).  The ElastiSim-style
malleability studies (Chadha et al.; Zojer et al.) replay such traces with
a configurable fraction of jobs *annotated* as rigid / moldable /
malleable; conclusions about malleability shift materially with the trace
and the fractions, which is exactly why the simulator must ingest them.

This module provides:

- :func:`parse_swf` — tolerant line parser returning :class:`SWFJob`
  records (malformed/truncated lines are skipped and counted, or raised in
  ``strict`` mode).
- :func:`annotate_malleability` — deterministic
  rigid/moldable/malleable/evolving assignment from a
  :class:`MalleabilityMix`.
- :func:`jobs_from_swf` — trace → (:class:`repro_torch.rms.job.Job` list,
  per-job ``AppModel`` dict) adapter; each trace job becomes an
  Amdahl-model app calibrated so that running at the recorded size takes
  the recorded runtime.  The SWF ``user_id`` is threaded onto
  ``Job.user`` (fair-share scheduling); moldable-annotated jobs get a
  factor-of-two size band around the recorded size so the moldable
  start-size optimizer has real freedom; evolving-annotated jobs get a
  deterministic per-phase demand schedule (§2 EVOLVING) whose bands,
  serial fractions, and data sizes cycle around the recorded size.

All size bands pass through :func:`clamp_band`, which pins the invariant
``1 <= min_nodes <= preferred <= max_nodes <= cluster`` — without it a
recorded size far above the simulated cluster (or an aggressive phase
band) could invert the band and wedge the scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.rms.costmodel import AppModel
from repro_torch.rms.job import Job, JobPhase, clamp_band
from repro_torch.workload.traffic import (DiurnalCurve, TrafficGenerator,
                                          TrafficSpec)

#: SWF field indices (0-based), per the Parallel Workloads Archive spec.
_FIELDS = ("job_id", "submit_time", "wait_time", "run_time",
           "allocated_procs", "avg_cpu_time", "used_memory",
           "requested_procs", "requested_time", "requested_memory",
           "status", "user_id", "group_id", "executable", "queue",
           "partition", "preceding_job", "think_time")

RIGID, MOLDABLE, MALLEABLE, EVOLVING = ("rigid", "moldable", "malleable",
                                        "evolving")
SERVING = "serving"


@dataclasses.dataclass(frozen=True)
class SWFJob:
    """One parsed SWF record (missing fields default to -1, per the spec)."""
    job_id: int
    submit_time: float
    wait_time: float
    run_time: float
    allocated_procs: int
    requested_procs: int
    requested_time: float
    status: int
    user_id: int = -1
    executable: int = -1
    queue: int = -1

    @property
    def procs(self) -> int:
        """Best-known size: allocated, falling back to requested."""
        if self.allocated_procs > 0:
            return self.allocated_procs
        return max(self.requested_procs, 1)


@dataclasses.dataclass
class SWFTrace:
    jobs: List[SWFJob]
    header: Dict[str, str]          # "; Key: Value" comment metadata
    skipped_lines: int = 0

    @property
    def max_nodes(self) -> Optional[int]:
        for key in ("MaxNodes", "MaxProcs"):
            raw = self.header.get(key)
            if raw is not None:
                try:
                    return int(raw.split()[0])
                except ValueError:
                    continue
        return None


def parse_swf(source: Union[str, Iterable[str]], *,
              strict: bool = False) -> SWFTrace:
    """Parse SWF text.

    ``source`` is a filesystem path or an iterable of lines.  Comment lines
    (``;``) feed the header dict; blank lines are ignored; lines with
    non-numeric or too-few fields are skipped (counted in
    ``SWFTrace.skipped_lines``) unless ``strict=True``.
    """
    if isinstance(source, str):
        with open(source) as fh:
            lines = fh.readlines()
    else:
        lines = list(source)
    jobs: List[SWFJob] = []
    header: Dict[str, str] = {}
    skipped = 0
    for lineno, line in enumerate(lines, 1):
        text = line.strip()
        if not text:
            continue
        if text.startswith(";"):
            body = text.lstrip(";").strip()
            if ":" in body:
                key, _, value = body.partition(":")
                header[key.strip()] = value.strip()
            continue
        fields = text.split()
        # A record needs at least the scheduling-relevant prefix
        # (through requested_time, field 9); shorter lines are truncated.
        if len(fields) < 9:
            if strict:
                raise ValueError(f"SWF line {lineno}: truncated "
                                 f"({len(fields)} fields): {text!r}")
            skipped += 1
            continue
        try:
            vals = [float(x) for x in fields[:len(_FIELDS)]]
        except ValueError:
            if strict:
                raise ValueError(f"SWF line {lineno}: non-numeric field: "
                                 f"{text!r}") from None
            skipped += 1
            continue
        rec = dict(zip(_FIELDS, vals))
        job = SWFJob(
            job_id=int(rec["job_id"]),
            submit_time=float(rec["submit_time"]),
            wait_time=float(rec["wait_time"]),
            run_time=float(rec["run_time"]),
            allocated_procs=int(rec["allocated_procs"]),
            requested_procs=int(rec.get("requested_procs", -1)),
            requested_time=float(rec.get("requested_time", -1.0)),
            status=int(rec.get("status", -1)),
            user_id=int(rec.get("user_id", -1)),
            executable=int(rec.get("executable", -1)),
            queue=int(rec.get("queue", -1)))
        if job.run_time <= 0 or job.procs <= 0:
            # Cancelled / never-ran records carry no load; skip.
            skipped += 1
            continue
        jobs.append(job)
    return SWFTrace(jobs=jobs, header=header, skipped_lines=skipped)


# ---------------------------------------------------------------------------
# Malleability annotation (trace jobs carry no such flag; studies assign it)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MalleabilityMix:
    """Fractions annotated rigid / moldable / malleable / evolving /
    serving."""
    rigid: float = 0.0
    moldable: float = 0.0
    malleable: float = 1.0
    evolving: float = 0.0
    serving: float = 0.0

    def __post_init__(self):
        total = (self.rigid + self.moldable + self.malleable
                 + self.evolving + self.serving)
        if abs(total - 1.0) > 1e-9:
            raise ValueError(f"fractions must sum to 1, got {total}")
        if min(self.rigid, self.moldable, self.malleable,
               self.evolving, self.serving) < 0:
            raise ValueError("fractions must be non-negative")

    def as_tuple(self) -> Tuple[float, float, float, float, float]:
        return (self.rigid, self.moldable, self.malleable, self.evolving,
                self.serving)


def annotate_malleability(jobs: Sequence[SWFJob],
                          mix: Optional[MalleabilityMix] = None,
                          *, seed: int = 7) -> List[str]:
    """Deterministically assign a kind to each job, honouring the mix.

    Uses a seeded permutation + exact quota split (not per-job coin flips)
    so the realised fractions match the requested ones to within one job.
    The quota layout keeps earlier classes' slots where they were before
    each later class existed (serving slots come after evolving, before
    the malleable fill), so 3- and 4-way mixes reproduce their historic
    assignment exactly.
    """
    mix = MalleabilityMix() if mix is None else mix
    n = len(jobs)
    n_rigid = min(int(round(mix.rigid * n)), n)
    n_mold = min(int(round(mix.moldable * n)), n - n_rigid)
    n_evol = min(int(round(mix.evolving * n)), n - n_rigid - n_mold)
    n_serv = min(int(round(mix.serving * n)),
                 n - n_rigid - n_mold - n_evol)
    kinds = ([RIGID] * n_rigid + [MOLDABLE] * n_mold + [EVOLVING] * n_evol
             + [SERVING] * n_serv
             + [MALLEABLE] * (n - n_rigid - n_mold - n_evol - n_serv))
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    out = [""] * n
    for slot, kind in zip(perm, kinds):
        out[slot] = kind
    return out


# ---------------------------------------------------------------------------
# Trace -> Job adapter
# ---------------------------------------------------------------------------

def _pow2_at_most(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def _evolving_phases(rec: SWFJob, iterations: int, base: int, cap: int,
                     serial_frac: float, data_bytes_per_node: int
                     ) -> Tuple[JobPhase, ...]:
    """Deterministic phase schedule for an EVOLVING trace job.

    2–4 phases (``2 + job_id % 3``) split the work evenly; the demanded
    preferred size cycles base → up → down around the recorded size, with
    per-phase serial fractions and data sizes moving in step so both the
    execution rate and the reconfiguration cost track the phase.  Pure
    arithmetic on the record — no RNG — so the schedule is reproducible
    from the trace alone.
    """
    n_phases = 2 + rec.job_id % 3
    prefs = (base, min(base * 2, cap), max(base // 2, 1), min(base * 4, cap))
    fracs = (serial_frac, serial_frac * 0.5, min(serial_frac * 2.0, 0.5),
             serial_frac)
    phases = []
    for p in range(n_phases):
        pref = prefs[p % len(prefs)]
        lo, hi, pref = clamp_band(max(pref // 2, 1), pref * 2, pref, cap)
        phases.append(JobPhase(
            work=iterations / n_phases, min_nodes=lo, max_nodes=hi,
            preferred=pref, serial_frac=fracs[p % len(fracs)],
            data_bytes=data_bytes_per_node * pref))
    return tuple(phases)


def _serving_spec(rec: SWFJob, app: AppModel, seed: int) -> TrafficSpec:
    """Deterministic request stream for a SERVING trace job.

    The window is the job's recorded lifetime; the mean arrival rate sits
    at 60% of the recorded-size throughput with a ±50% diurnal swing
    compressed so two full cycles fit inside the window — peaks push
    occupancy through the DMR headroom (forcing SLO expands), ebbs drop
    it far enough that the negotiation hands nodes back to the batch
    queue.  Pure arithmetic on ``(workload seed, record id)``.
    """
    duration = max(rec.run_time, 1.0)
    period = max(duration / 2.0, 1.0)
    curve = DiurnalCurve(
        base_rps=0.6 * app.rate(app.preferred), amplitude=0.5,
        period_s=period, phase_s=period * (rec.job_id % 8) / 8.0)
    return TrafficSpec(
        curve=curve, seed=seed * 100003 + rec.job_id,
        t0=rec.submit_time, duration_s=duration, slo_p99_s=2.0,
        bucket_s=max(min(60.0, duration / 8.0), 1.0))


def _trace_app(rec: SWFJob, kind: str, num_nodes: int,
               serial_frac: float, data_bytes_per_node: int) -> AppModel:
    """Amdahl model calibrated so exec at the recorded size = run_time.

    Work is measured in seconds-at-recorded-size: ``iterations =
    run_time`` with ``iter_time(recorded) = 1``.  Malleable jobs may move
    a factor-of-2 around the recorded size; rigid/moldable stay put;
    evolving jobs carry a per-phase demand schedule.
    """
    size = min(rec.procs, num_nodes)
    cap = _pow2_at_most(num_nodes)
    phases: Tuple[JobPhase, ...] = ()
    iterations = max(int(round(rec.run_time)), 1)
    if kind == MALLEABLE:
        base = _pow2_at_most(size)
        min_nodes, max_nodes, preferred = clamp_band(
            max(base // 4, 1), base * 2, base, cap)
        period = 15.0
    elif kind == MOLDABLE:
        # Startable at any power-of-two in a factor-of-two band around the
        # recorded size (the "moldable" start-size optimizer exploits this),
        # but never reconfigured after launch.
        base = _pow2_at_most(size)
        min_nodes, max_nodes, preferred = clamp_band(
            max(base // 4, 1), base * 2, base, cap)
        period = 0.0
    elif kind == SERVING:
        # Wide elastic band around the recorded size: the SLO-pressure
        # negotiation rides the diurnal curve across it.
        base = _pow2_at_most(size)
        min_nodes, max_nodes, preferred = clamp_band(
            max(base // 4, 1), base * 4, base, cap)
        period = 15.0
    elif kind == EVOLVING:
        base = _pow2_at_most(size)
        phases = _evolving_phases(rec, iterations, base, cap, serial_frac,
                                  data_bytes_per_node)
        # envelope band on the app; the live per-phase band lives on Job
        min_nodes = min(ph.min_nodes for ph in phases)
        max_nodes = max(ph.max_nodes for ph in phases)
        preferred = phases[0].preferred
        period = 15.0
    else:
        base = size
        min_nodes, max_nodes, preferred = clamp_band(size, size, size,
                                                     num_nodes)
        period = 0.0
    t_at_base = rec.run_time / iterations
    t1 = t_at_base / (serial_frac + (1.0 - serial_frac) / max(base, 1))
    return AppModel(
        name=f"swf:{rec.job_id}", iterations=iterations, t1_iter_s=t1,
        serial_frac=serial_frac, data_bytes=data_bytes_per_node * base,
        min_nodes=min_nodes, max_nodes=max_nodes, preferred=preferred,
        check_period_s=period, phases=phases)


def jobs_from_swf(trace: Union[SWFTrace, Sequence[SWFJob]], *,
                  num_nodes: int = 64,
                  mix: Optional[MalleabilityMix] = None,
                  seed: int = 7,
                  serial_frac: float = 0.05,
                  data_bytes_per_node: int = 64 * 1024 ** 2,
                  max_jobs: Optional[int] = None,
                  time_scale: float = 1.0
                  ) -> Tuple[List[Job], Dict[str, AppModel]]:
    """Convert a parsed trace into simulator jobs + their app models.

    ``time_scale`` compresses submit/run times (e.g. 0.1 replays a day-long
    trace in a tenth of simulated time, preserving relative load);
    ``mix`` controls the rigid/moldable/malleable/evolving annotation; the
    recorded size is clamped to ``num_nodes``.  Returns ``(jobs, apps)``
    ready for ``ClusterSimulator(jobs, SimConfig(num_nodes=...),
    apps=apps)``.
    """
    records = list(trace.jobs if isinstance(trace, SWFTrace) else trace)
    if max_jobs is not None:
        records = records[:max_jobs]
    kinds = annotate_malleability(records, mix, seed=seed)
    t0 = min((r.submit_time for r in records), default=0.0)
    jobs: List[Job] = []
    apps: Dict[str, AppModel] = {}
    for i, (rec, kind) in enumerate(zip(records, kinds)):
        scaled = dataclasses.replace(
            rec, submit_time=(rec.submit_time - t0) * time_scale,
            run_time=max(rec.run_time * time_scale, 1.0))
        app = _trace_app(scaled, kind, num_nodes, serial_frac,
                         data_bytes_per_node)
        apps[app.name] = app
        start_nodes = (app.preferred if kind in (MALLEABLE, MOLDABLE,
                                                 EVOLVING, SERVING)
                       else app.max_nodes)
        # An evolving job's *live* band starts at phase 0 (the app model
        # keeps the envelope); the PhaseChange handler rewrites it per phase.
        if kind == EVOLVING:
            ph0 = app.phases[0]
            band = (ph0.min_nodes, ph0.max_nodes, ph0.preferred)
        else:
            band = (app.min_nodes, app.max_nodes, app.preferred)
        # A serving job's work is its stream's total arrivals (requests),
        # not the calibrated iteration count.
        spec = None
        work = float(app.iterations)
        if kind == SERVING:
            spec = _serving_spec(scaled, app, seed)
            work = TrafficGenerator(spec).total()
        jobs.append(Job(
            job_id=i, app=app.name, submit_time=float(scaled.submit_time),
            work=work,
            min_nodes=band[0], max_nodes=band[1],
            preferred=band[2], factor=2,
            malleable=(kind in (MALLEABLE, EVOLVING, SERVING)),
            check_period_s=app.check_period_s,
            requested_nodes=start_nodes, data_bytes=app.data_bytes,
            user=max(int(rec.user_id), 0), phases=app.phases,
            traffic=spec))
    return jobs, apps
