"""Workload generation — Feitelson's statistical model (paper §7.1).

The paper generates workloads with Feitelson's rigid-job model [4],
customizing two knobs: the number of jobs and the inter-arrival times
("Poisson distribution of factor 10" — exponential inter-arrivals with a
10-second mean scale, which avoids bursts while keeping a realistic arrival
pattern).  Each job instantiates one of the three applications (CG, Jacobi,
N-body) chosen by a randomly-sorted sequence with a fixed seed; jobs are
submitted with their *maximum* size (the user-preferred fast-execution
scenario, §7.5).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.rms.costmodel import PAPER_APPS, AppModel
from repro_torch.rms.job import Job, JobPhase, clamp_band


def feitelson_sizes(rng: np.random.Generator, n: int, max_size: int
                    ) -> np.ndarray:
    """Feitelson'96 size model: sizes biased to small values & powers of two.

    Used for synthetic rigid workloads (the paper's non-app experiments);
    the throughput workloads take sizes from the applications' Table-1
    maxima instead.
    """
    log_max = int(np.log2(max_size))
    # Harmonic-ish distribution over log2 sizes, with extra mass on serial.
    probs = np.array([1.0 / (k + 1.5) for k in range(log_max + 1)])
    probs /= probs.sum()
    k = rng.choice(log_max + 1, size=n, p=probs)
    sizes = 2 ** k
    # Feitelson: ~30% of jobs perturb away from an exact power of two.
    jitter = rng.random(n) < 0.3
    sizes = np.where(jitter & (sizes > 1),
                     np.maximum(1, sizes - rng.integers(0, 3, n)), sizes)
    return np.minimum(sizes, max_size)


def poisson_arrivals(rng: np.random.Generator, n: int,
                     scale_s: float = 10.0) -> np.ndarray:
    """Exponential inter-arrivals (Poisson process), mean ``scale_s``."""
    gaps = rng.exponential(scale_s, size=n)
    t = np.cumsum(gaps)
    t[0] = 0.0
    return t


def evolving_phases_for(app: AppModel, n_phases: int = 3
                        ) -> Tuple[JobPhase, ...]:
    """Deterministic EVOLVING schedule derived from an app's Table-1 band.

    Demand rises then falls: preferred → maximum → minimum-side, with the
    serial fraction halving in the wide middle phase (scalable burst) and
    doubling in the narrow final phase — so rate and reconfiguration cost
    genuinely change per phase.  Pure arithmetic, no RNG.
    """
    pref0 = app.preferred or app.max_nodes
    targets = (pref0, app.max_nodes, max(app.min_nodes, pref0 // 2))
    fracs = (app.serial_frac, app.serial_frac * 0.5,
             min(app.serial_frac * 2.0, 0.5))
    phases = []
    for p in range(n_phases):
        t = targets[p % len(targets)]
        lo, hi, pref = clamp_band(max(t // 2, 1), max(t * 2, t), t,
                                  app.max_nodes)
        phases.append(JobPhase(
            work=app.iterations / n_phases, min_nodes=lo, max_nodes=hi,
            preferred=pref, serial_frac=fracs[p % len(fracs)],
            data_bytes=max(app.data_bytes // (1 if t >= pref0 else 2), 1)))
    return tuple(phases)


def make_workload(num_jobs: int, *, seed: int = 7,
                  apps: Optional[Dict[str, AppModel]] = None,
                  app_names: Sequence[str] = ("cg", "jacobi", "nbody"),
                  arrival_scale_s: float = 10.0,
                  malleable: bool = True,
                  num_users: int = 5,
                  evolving_fraction: float = 0.0) -> List[Job]:
    """The paper's throughput workloads (§7.5): randomly-sorted app jobs,
    fixed seed, Poisson arrivals, launched at their maximum size.  Jobs are
    spread over ``num_users`` submitting users (fair-share accounting).

    ``evolving_fraction`` marks that share of jobs EVOLVING (§2): they get
    the deterministic :func:`evolving_phases_for` schedule.  The flag draw
    happens *after* all historic draws, so workloads with the fraction at
    0 are bit-identical to pre-evolving ones.
    """
    rng = np.random.default_rng(seed)
    apps = dict(PAPER_APPS if apps is None else apps)
    arrivals = poisson_arrivals(rng, num_jobs, arrival_scale_s)
    choices = rng.choice(len(app_names), size=num_jobs)
    users = rng.integers(0, max(num_users, 1), size=num_jobs)
    evolving = (rng.random(num_jobs) < evolving_fraction
                if evolving_fraction > 0 else np.zeros(num_jobs, bool))
    jobs = []
    for i in range(num_jobs):
        app = apps[app_names[choices[i]]]
        phases = evolving_phases_for(app) if evolving[i] else ()
        band = (phases[0] if phases else app)
        jobs.append(Job(
            job_id=i, app=app.name, submit_time=float(arrivals[i]),
            work=float(app.iterations),
            min_nodes=band.min_nodes, max_nodes=band.max_nodes,
            preferred=band.preferred, factor=2,
            malleable=malleable or bool(phases),
            check_period_s=app.check_period_s,
            requested_nodes=(band.preferred or band.max_nodes)
            if phases else app.max_nodes,
            data_bytes=app.data_bytes,
            user=int(users[i]), phases=phases))
    return jobs
