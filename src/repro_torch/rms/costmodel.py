"""Application scaling & reconfiguration cost models (calibrated to paper §7).

Execution model: Amdahl-style per-iteration time
``t_iter(P) = t1 * (s + (1 - s) / P)`` with per-app serial fraction ``s``.
The paper states CG and Jacobi scale ~linearly (halving resources doubles
iteration time — §7.4), while N-body *prefers a single node* (Table 1), i.e.
it scales poorly; its preferred=1 only makes sense with a large serial
fraction, which also matches §8's remark that for some applications the
execution-time drawback of shrinking "can be negligible".

Calibration: per-iteration times are set so each application runs ≈600 s at
its maximum (submission) size, matching the fixed-workload execution times in
Table 4 (520–620 s).

Reconfiguration model (Fig. 3): scheduling time grows mildly with the node
count involved (Fig. 3a); redistribution time follows the factor-based
transfer plans of :mod:`repro_torch.core.redistribute` over per-node links —
more participants ⇒ smaller concurrent chunks ⇒ faster (Fig. 3b), and
shrinks pay an extra synchronization term per participant (§5.2.2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.actions import Action
from repro_torch.core.redistribute import (expand_plan, shrink_plan,
                                           transfer_time_s)
from repro_torch.rms.job import JobPhase
from repro_torch.roofline.hardware import PEAK_BF16_FLOPS

GiB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class AppModel:
    name: str
    iterations: int
    t1_iter_s: float          # per-iteration time on 1 node
    serial_frac: float        # Amdahl serial fraction
    data_bytes: int           # state redistributed on reconfiguration
    min_nodes: int
    max_nodes: int
    preferred: Optional[int]
    check_period_s: float     # 0 => check at every iteration (Table 1 "-")
    # EVOLVING (§2): per-phase demand bands + serial-fraction/data-size
    # overrides; empty for the paper's fixed-demand applications.  The
    # ``min_nodes``/``max_nodes``/``preferred`` above are the envelope.
    phases: Tuple[JobPhase, ...] = ()

    def iter_time(self, nodes: int,
                  serial_frac: Optional[float] = None) -> float:
        p = max(nodes, 1)
        s = self.serial_frac if serial_frac is None else serial_frac
        return self.t1_iter_s * (s + (1.0 - s) / p)

    def rate(self, nodes: int,
             serial_frac: Optional[float] = None) -> float:
        """Work units (iterations) per second."""
        return 1.0 / self.iter_time(nodes, serial_frac)

    def exec_time(self, nodes: int) -> float:
        return self.iterations * self.iter_time(nodes)


def _calibrated(name, iterations, serial_frac, calib_nodes, calib_exec_s,
                data_bytes, min_nodes, max_nodes, preferred, period):
    t_iter_at_max = calib_exec_s / iterations
    t1 = t_iter_at_max / (serial_frac + (1 - serial_frac) / calib_nodes)
    return AppModel(name, iterations, t1, serial_frac, data_bytes,
                    min_nodes, max_nodes, preferred, period)


# Table 1 parameters; ≈600 s execution at maximum size.
PAPER_APPS: Dict[str, AppModel] = {
    "fs": AppModel("fs", iterations=2, t1_iter_s=60.0, serial_frac=0.0,
                   data_bytes=1 * GiB, min_nodes=1, max_nodes=20,
                   preferred=None, check_period_s=0.0),
    "cg": _calibrated("cg", 10000, 0.05, 32, 600.0, 1 * GiB, 2, 32, 8, 15.0),
    "jacobi": _calibrated("jacobi", 10000, 0.02, 32, 600.0, 2 * GiB,
                          2, 32, 8, 15.0),
    "nbody": _calibrated("nbody", 25, 0.70, 16, 600.0, GiB // 2,
                         1, 16, 1, 0.0),
}


@dataclasses.dataclass(frozen=True)
class ReconfigCostModel:
    """Fig. 3 overhead model.

    The defaults are the hand-fit paper constants;
    :meth:`from_artifact` replaces them with parameters fitted from
    measured redistribute runs (:mod:`repro_torch.calib`), tagging the instance
    with the artifact's ``calibration_id`` so consumers (simulator reports,
    benchmarks) can record which calibration produced their numbers.
    """

    link_bw: float = 5e9            # FDR10 InfiniBand ≈ 5 GB/s per node
    sched_base_s: float = 0.35      # Slurm resize transaction (Table 2 ≈0.42)
    sched_per_node_s: float = 0.003 # Fig. 3a mild growth with node count
    noaction_s: float = 0.009       # Table 2 "no action" ≈ 0.009–0.014 s
    spawn_s: float = 0.05           # process-spawn / mesh-rebuild constant
    shrink_sync_s: float = 0.004    # ACK sync per participant (§5.2.2)
    calibration_id: Optional[str] = None   # None: the paper-fit constants

    @classmethod
    def from_artifact(cls, source) -> "ReconfigCostModel":
        """Build the model from a calibration artifact (path or loaded
        document) produced by :mod:`repro_torch.calib` or ``repro.calib``
        (one schema)."""
        from repro_torch.calib.artifact import (load_calibration,
                                                validate_calibration)
        doc = load_calibration(source) if isinstance(source, str) \
            else validate_calibration(source)
        f = doc["fitted"]
        return cls(link_bw=float(f["link_bw"]),
                   sched_base_s=float(f["sched_base_s"]),
                   sched_per_node_s=float(f["sched_per_node_s"]),
                   spawn_s=float(f["spawn_s"]),
                   shrink_sync_s=float(f["shrink_sync_s"]),
                   calibration_id=str(doc["calibration_id"]))

    def schedule_time(self, action: Action, nodes_involved: int,
                      rng=None) -> float:
        if action is Action.NO_ACTION:
            base = self.noaction_s
        else:
            base = self.sched_base_s + self.sched_per_node_s * nodes_involved
        if rng is not None:
            base *= max(0.2, 1.0 + 0.15 * rng.standard_normal())
        return base

    def resize_time(self, old_nodes: int, new_nodes: int,
                    data_bytes: int) -> float:
        """Redistribution time for the factor-based plan (Fig. 3b)."""
        if new_nodes == old_nodes or data_bytes == 0:
            return 0.0
        if new_nodes > old_nodes:
            plan = expand_plan(old_nodes, new_nodes, data_bytes)
            sync = 0.0
        else:
            plan = shrink_plan(old_nodes, new_nodes, data_bytes)
            sync = self.shrink_sync_s
        return self.spawn_s + transfer_time_s(
            plan, link_bw=self.link_bw, sync_s_per_participant=sync)


def lm_app_model(name: str, *, params: int, step_flops: float,
                 iterations: int, chip_flops: float = PEAK_BF16_FLOPS,
                 model_ways: int = 16, mfu: float = 0.4,
                 min_nodes: int = 1, max_nodes: int = 16,
                 preferred: Optional[int] = None,
                 bytes_per_param: int = 18) -> AppModel:
    """An elastic LM-training job as a malleable app (beyond-paper workload).

    One "node" = one data-parallel slice of ``model_ways`` devices.  Per-step
    time on P slices ≈ step_flops / (P * model_ways * chip_flops * mfu);
    state moved on reconfiguration = params + grads + optimizer moments.
    ``chip_flops`` defaults to the H100's dense bf16 peak
    (:data:`repro_torch.roofline.hardware.PEAK_BF16_FLOPS`).
    """
    t1 = step_flops / (model_ways * chip_flops * mfu)
    return AppModel(f"lm:{name}", iterations=iterations, t1_iter_s=t1,
                    serial_frac=0.02, data_bytes=params * bytes_per_param,
                    min_nodes=min_nodes, max_nodes=max_nodes,
                    preferred=preferred, check_period_s=30.0)
