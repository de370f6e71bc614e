"""Deterministic observability layer over the RMS simulator.

Four pieces, layered on the engine's monitor fan-out:

- :mod:`repro_torch.obs.recorder` — ``TraceRecorder``, an engine monitor that
  turns the event stream + ``ActionRecord`` audit trail into typed spans
  and event-sampled metrics (zero overhead when not installed);
- :mod:`repro_torch.obs.metrics` — the counters/gauges/histograms registry,
  sampled on simulation time only, never wall clock;
- :mod:`repro_torch.obs.export` — byte-deterministic artifacts: the
  ``repro.obs`` schema-v1 JSON, a JSONL span log, and a Chrome
  trace-event file loadable in Perfetto;
- :mod:`repro_torch.obs.report` + ``python -m repro_torch.obs`` — the per-job
  time-breakdown / DMR-action-ledger / SLO-timeline CLI.

The determinism contract extends here: a traced run's simulation output
is byte-identical to an untraced run, and the trace artifacts themselves
are byte-identical across repeated runs (``docs/observability.md``).
"""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.recorder import Span, TraceRecorder
from repro_torch.obs.export import (SCHEMA_ID, SCHEMA_VERSION, build_artifact,
                              chrome_trace, dumps_artifact, write_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "TraceRecorder",
    "SCHEMA_ID", "SCHEMA_VERSION", "build_artifact", "chrome_trace",
    "dumps_artifact", "write_trace",
]
