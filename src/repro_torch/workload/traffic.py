"""Open-loop request-arrival model for SERVING jobs (diurnal traffic).

A serving job's "work" is not a fixed iteration count but a stream of
requests arriving from outside the cluster.  The stream is **open-loop**:
arrivals are a pure function of ``(seed, rate curve)`` and never react to
allocation decisions — the cluster can fall behind (backlog grows) but it
cannot slow the world down.  That property is what makes the SLO-pressure
negotiation in :mod:`repro_torch.rms.simulator` meaningful, and it is what the
property tests in ``tests/test_traffic.py`` lock down.

The model is *fluid*: rather than drawing millions of individual arrival
timestamps (a day of traffic at 10k req/s is ~1e9 events), we integrate a
deterministic diurnal rate curve analytically and modulate each
``bucket_s``-wide bucket with a seeded multiplicative noise factor.  The
cumulative-arrivals function ``F(t)`` is then exact and partition-additive:
``arrivals_between(a, c) == arrivals_between(a, b) + arrivals_between(b, c)``
holds to float precision by construction, which the simulator's
conservation invariant (``serving_conservation``) relies on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

#: Default traffic bucket width (seconds).  Noise is i.i.d. per bucket.
DEFAULT_BUCKET_S = 60.0


@dataclasses.dataclass(frozen=True)
class DiurnalCurve:
    """Deterministic request-rate curve: cosine diurnal + additive bursts.

    ``rate(t) = base_rps * (1 + amplitude * cos(2*pi*(t - phase_s)/period_s))
    + sum(extra_rps for active bursts)``, clamped at zero.  Bursts are
    additive rectangles ``(start_s, duration_s, extra_rps)`` so the integral
    stays closed-form.

    A curve with ``base_rps=2300`` and ``period_s=86400`` models roughly
    200M requests/day — the "millions of users" scale from the ROADMAP —
    but smoke scenarios scale the same shape down to minutes.
    """

    base_rps: float
    amplitude: float = 0.5
    period_s: float = 86400.0
    phase_s: float = 0.0
    bursts: Tuple[Tuple[float, float, float], ...] = ()

    def __post_init__(self):
        if self.base_rps < 0:
            raise ValueError(f"base_rps must be >= 0, got {self.base_rps}")
        if not 0.0 <= self.amplitude <= 1.0:
            raise ValueError(
                f"amplitude must be in [0, 1], got {self.amplitude}")
        if self.period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {self.period_s}")

    def rate(self, t: float) -> float:
        """Instantaneous request rate (req/s) at time ``t``."""
        w = 2.0 * math.pi / self.period_s
        r = self.base_rps * (1.0 + self.amplitude * math.cos(
            w * (t - self.phase_s)))
        for start, dur, extra in self.bursts:
            if start <= t < start + dur:
                r += extra
        return max(r, 0.0)

    def integral(self, a: float, b: float) -> float:
        """Exact integral of :meth:`rate` over ``[a, b]`` (requests).

        Closed-form: the cosine term integrates to a sine difference and
        each burst contributes ``extra * overlap``.  Amplitude <= 1 keeps
        the diurnal term non-negative, so no clamping is needed inside.
        """
        if b <= a:
            return 0.0
        w = 2.0 * math.pi / self.period_s
        total = self.base_rps * (b - a)
        total += (self.base_rps * self.amplitude / w) * (
            math.sin(w * (b - self.phase_s)) - math.sin(w * (a - self.phase_s)))
        for start, dur, extra in self.bursts:
            lo = max(a, start)
            hi = min(b, start + dur)
            if hi > lo:
                total += extra * (hi - lo)
        return max(total, 0.0)


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Everything that defines a serving job's request stream + SLO."""

    curve: DiurnalCurve
    seed: int
    t0: float = 0.0
    duration_s: float = 86400.0
    slo_p99_s: float = 2.0
    bucket_s: float = DEFAULT_BUCKET_S
    noise: float = 0.1

    def __post_init__(self):
        if self.duration_s <= 0:
            raise ValueError(
                f"duration_s must be > 0, got {self.duration_s}")
        if self.bucket_s <= 0:
            raise ValueError(f"bucket_s must be > 0, got {self.bucket_s}")
        if not 0.0 <= self.noise < 1.0:
            raise ValueError(f"noise must be in [0, 1), got {self.noise}")

    @property
    def end(self) -> float:
        return self.t0 + self.duration_s


class TrafficGenerator:
    """Seeded fluid arrival process: cumulative arrivals ``F(t)``.

    ``F`` is piecewise: within bucket ``k`` (a ``bucket_s`` window starting
    at ``t0 + k*bucket_s``) arrivals accrue at ``m_k * curve.rate(t)``
    where ``m_k`` is a multiplicative noise factor drawn from
    ``np.random.default_rng([seed, k])`` — each bucket's noise is an
    independent, order-free function of ``(seed, k)``, so two generators
    with the same spec agree bucket-for-bucket no matter which times they
    were queried at first.
    """

    def __init__(self, spec: TrafficSpec):
        self.spec = spec
        # cumulative arrivals at bucket boundaries; _cum[k] = F(t0 + k*dt)
        self._cum: List[float] = [0.0]
        self._mult: List[float] = []

    def _bucket_mult(self, k: int) -> float:
        """Noise multiplier for bucket ``k`` (pure in (seed, k))."""
        if self.spec.noise == 0.0:
            return 1.0
        rng = np.random.default_rng([self.spec.seed, k])
        return 1.0 + self.spec.noise * (2.0 * float(rng.random()) - 1.0)

    def _extend(self, k: int) -> None:
        """Ensure boundary cumulative sums exist through bucket ``k``."""
        t0, dt = self.spec.t0, self.spec.bucket_s
        while len(self._cum) <= k:
            j = len(self._cum) - 1      # bucket index being closed
            mult = self._bucket_mult(j)
            self._mult.append(mult)
            lo = t0 + j * dt
            hi = min(lo + dt, self.spec.end)
            self._cum.append(
                self._cum[-1] + mult * self.spec.curve.integral(lo, hi))

    def arrivals_until(self, t: float) -> float:
        """Cumulative arrivals ``F(t)`` since the window opened."""
        t = min(max(t, self.spec.t0), self.spec.end)
        rel = t - self.spec.t0
        dt = self.spec.bucket_s
        k = int(rel // dt)
        self._extend(k + 1)
        lo = self.spec.t0 + k * dt
        if t <= lo:
            return self._cum[k]
        return self._cum[k] + self._mult[k] * self.spec.curve.integral(lo, t)

    def arrivals_between(self, a: float, b: float) -> float:
        """Arrivals in ``[a, b]`` — exactly ``F(b) - F(a)``."""
        return self.arrivals_until(b) - self.arrivals_until(a)

    def total(self) -> float:
        """Total arrivals over the whole window (the job's ``work``)."""
        return self.arrivals_until(self.spec.end)

    def rate(self, t: float) -> float:
        """Noise-adjusted instantaneous rate at ``t`` (0 outside window)."""
        if not self.spec.t0 <= t < self.spec.end:
            return 0.0
        k = int((t - self.spec.t0) // self.spec.bucket_s)
        self._extend(k + 1)
        return self._mult[k] * self.spec.curve.rate(t)
