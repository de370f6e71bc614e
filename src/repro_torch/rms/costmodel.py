"""The Fig. 3 reconfiguration cost model, from ``repro.rms.costmodel``.

Scheduling time grows mildly with the node count involved (Fig. 3a);
redistribution time follows the factor-based transfer plans of
:mod:`repro_torch.core.redistribute` over per-node links — more
participants ⇒ smaller concurrent chunks ⇒ faster (Fig. 3b), and shrinks
pay an extra synchronization term per participant (§5.2.2).

The port copies what the calibration reads (:mod:`repro_torch.calib`):
:class:`ReconfigCostModel` with its paper-fit defaults. The reference's
``AppModel`` / ``PAPER_APPS`` (Amdahl per-iteration times of the Table 1
applications) feed only its simulator, which stays host-side in the
reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.actions import Action
from repro_torch.core.redistribute import (expand_plan, shrink_plan,
                                           transfer_time_s)


@dataclasses.dataclass(frozen=True)
class ReconfigCostModel:
    """Fig. 3 overhead model.

    The defaults are the hand-fit paper constants;
    :meth:`from_artifact` replaces them with parameters fitted from
    measured redistribute runs (:mod:`repro_torch.calib`), tagging the
    instance with the artifact's ``calibration_id`` so consumers can record
    which calibration produced their numbers.
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
