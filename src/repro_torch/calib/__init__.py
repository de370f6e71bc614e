"""Measured-cost calibration: fit the Fig. 3 overhead model from real runs.

Counterpart of ``repro.calib``: measure → fit → artifact.

**1. measure** (:mod:`repro_torch.calib.measure`) — time the port's own
:func:`~repro_torch.core.reshard.reshard` between meshes of different slice
counts (the :func:`~repro_torch.core.redistribute.expand_plan` /
:func:`~repro_torch.core.redistribute.shrink_plan` transfers, on virtual
slices of the card), ``migrate_slice`` and ``ReconfigPolicy.decide``
latency, across a grid of ``(old_nodes, new_nodes, data_bytes)``::

    from repro_torch.calib import MeasureConfig, measure_grid
    samples, env = measure_grid(MeasureConfig(backend="torch"))

The ``plan`` backend generates the same sample schema deterministically
(seeded noise around hidden ground-truth parameters): that is what the
committed golden artifact and the fit-recovery tests use.

**2. fit** (:mod:`repro_torch.calib.fit`) — ordinary least squares for
``link_bw``, ``spawn_s``, ``shrink_sync_s``, ``sched_base_s``,
``sched_per_node_s``, with residual diagnostics and the Fig. 3b shape
checks; :class:`FitError` when the samples carry no positive bandwidth.

**3. artifact** (:mod:`repro_torch.calib.artifact`) — the versioned,
byte-deterministic JSON document (schema ``repro.calib`` v1) the reference
reads unchanged; :meth:`ReconfigCostModel.from_artifact
<repro_torch.rms.costmodel.ReconfigCostModel.from_artifact>` builds the
fitted model from it.

One-shot CLI::

    PYTHONPATH=src python -m repro_torch.calib --backend plan \\
        --check tests/data/golden_calibration.json
    PYTHONPATH=src python -m repro_torch.calib --backend torch [--quick]
"""
from repro_torch.calib.artifact import (PAPER_FIT_ID, dumps_calibration,
                                        load_calibration, make_artifact,
                                        validate_calibration,
                                        write_calibration)
from repro_torch.calib.fit import (FitError, fit_report_rows, fit_samples,
                                   validate_fit)
from repro_torch.calib.measure import MeasureConfig, calibrate, measure_grid

__all__ = [
    "MeasureConfig", "measure_grid", "calibrate",
    "fit_samples", "validate_fit", "fit_report_rows", "FitError",
    "make_artifact", "validate_calibration", "load_calibration",
    "write_calibration", "dumps_calibration", "PAPER_FIT_ID",
]
