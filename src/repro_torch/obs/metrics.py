"""Deterministic metrics registry — counters, gauges, histograms.

Everything here is sampled on *simulation* time supplied by the caller;
no metric ever reads a wall clock, so two runs of the same scenario
produce byte-identical metric documents.  Gauges store their full
``(t, value)`` step function (deduplicated: a sample is recorded only
when the value changes, and a later write at the same instant replaces
the earlier one — matching how ``searchsorted(side="right")`` reads a
step function).  Histograms use fixed bucket bounds declared at creation
so bucket layout can never drift between runs.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

#: Default duration buckets (seconds) for reconfiguration latencies —
#: spans Fig. 3's measured resize costs (sub-second) up to checkpoint
#: requeue restarts (minutes).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


class Counter:
    """Monotonic event counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    """A step function of simulation time: changed-value samples only."""

    __slots__ = ("samples",)

    def __init__(self):
        self.samples: List[Tuple[float, float]] = []

    @property
    def last(self) -> Optional[float]:
        return self.samples[-1][1] if self.samples else None

    def set(self, t: float, value: float) -> None:
        samples = self.samples
        if samples:
            lt, lv = samples[-1]
            if lt == t:
                if len(samples) >= 2 and samples[-2][1] == value:
                    samples.pop()          # re-write erased the change
                else:
                    samples[-1] = (t, value)
                return
            if lv == value:
                return                     # unchanged: step continues
        samples.append((t, value))

    def integral(self, t_end: float) -> float:
        """Step-function integral over ``[t0_first_sample, t_end]``."""
        total = 0.0
        samples = self.samples
        for i, (t0, v) in enumerate(samples):
            t1 = t_end if i + 1 == len(samples) else samples[i + 1][0]
            t1 = min(t1, t_end)
            if t1 > t0:
                total += v * (t1 - t0)
        return total


class Histogram:
    """Fixed-bound cumulative-style histogram (``value <= bound``)."""

    __slots__ = ("bounds", "counts", "total", "count")

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)   # +1: overflow bucket
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.total += value
        self.count += 1


class MetricsRegistry:
    """Keyed store of metrics; keys are ``(name, sorted label items)``.

    A metric keeps its kind for life — re-registering the same
    name+labels as a different kind is a programming error and raises.
    """

    def __init__(self):
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            object] = {}

    def _get(self, name: str, labels: dict, kind: type, factory):
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        metric = self._metrics.get(key)
        if metric is None:
            metric = self._metrics[key] = factory()
        elif type(metric) is not kind:
            raise TypeError(f"metric {key} already registered "
                            f"as {type(metric).__name__}")
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge, Gauge)

    def histogram(self, name: str,
                  bounds: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(name, labels, Histogram, lambda: Histogram(bounds))

    # -- deterministic export ------------------------------------------------

    def to_doc(self) -> dict:
        """Sorted, JSON-ready document: counters, gauges, histograms."""
        counters, gauges, histograms = [], [], []
        for (name, labels), metric in sorted(self._metrics.items()):
            entry = {"name": name, "labels": dict(labels)}
            if isinstance(metric, Counter):
                entry["value"] = _num(metric.value)
                counters.append(entry)
            elif isinstance(metric, Gauge):
                entry["samples"] = [[_num(t), _num(v)]
                                    for t, v in metric.samples]
                gauges.append(entry)
            else:
                entry.update(bounds=[_num(b) for b in metric.bounds],
                             counts=list(metric.counts),
                             total=_num(metric.total), count=metric.count)
                histograms.append(entry)
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}


def _num(x: float):
    """JSON-safe deterministic number: 6-digit round, non-finite -> None."""
    x = float(x)
    if x != x or x in (float("inf"), float("-inf")):
        return None
    r = round(x, 6)
    return int(r) if r == int(r) else r
