"""Elastic cluster capacity: power management + drain negotiation.

The paper's throughput-aware DMR loop assumes a fixed cluster; production
clusters churn (maintenance drains, spot reclamation, energy management).
This module makes capacity a first-class dynamic quantity:

- :class:`CapacityConfig` — the knobs, reachable via ``SimConfig.capacity``.
- :class:`CapacityManager` — a CLUES-style hysteresis power manager
  (after ``indigo_orchestrator``'s power-on/off task queues): nodes are
  parked only after the queue has been pressure-free for
  ``idle_power_off_s`` (the armed :class:`~repro_torch.rms.engine.NodePowerOff`
  timer re-validates at fire time), and are booted back — with a
  ``power_up_delay_s`` boot cost — the moment pending demand exceeds the
  free + already-booting headroom.
- :func:`plan_drain` — the graceful-drain negotiation: migrate the owning
  job's slice to a healthy free node if one exists, else fold it down one
  factor-consistent DMR shrink step, else checkpoint-requeue.  The
  simulator applies the plan so all cost accounting stays in one place.
- :data:`CHURN_SCENARIOS` — named deterministic drain/join/power-cycling
  schedules so capacity churn can run through a parameter sweep with
  byte-stable artifacts.

Everything is deterministic: the manager schedules typed events through
the engine and keeps no wall-clock state, so serial / parallel / resumed
sweeps over churn scenarios stay byte-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.rms.cluster import Cluster
from repro_torch.rms.engine import NodePowerOff, NodePowerOn, SimulationEngine
from repro_torch.rms.job import Job, JobState


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Power-management knobs (``enabled=False`` keeps the cluster fixed —
    bit-identical to the pre-elastic behavior)."""
    enabled: bool = False
    idle_power_off_s: float = 300.0   # queue pressure-free this long => park
    min_free: int = 1                 # hot headroom never powered off
    power_up_delay_s: float = 30.0    # boot time before a parked node serves


class CapacityManager:
    """CLUES-style hysteresis: park idle nodes, boot them under pressure.

    Driven from the simulator's scheduler pass (event-driven, no polling
    loop): :meth:`note_pass` observes queue pressure after every pass and
    either books power-ons for unmet demand or arms the idle power-off
    timer; the timer's event calls :meth:`confirm_power_off`, which
    re-validates idleness at fire time — pressure that arrived in between
    simply disarms the park (the hysteresis half of CLUES).
    """

    def __init__(self, cluster: Cluster, engine: SimulationEngine,
                 config: CapacityConfig):
        self.cluster = cluster
        self.engine = engine
        self.config = config
        self.last_pressure_t = 0.0     # last time a pending job was seen
        self._off_armed = False        # a NodePowerOff event is in flight
        self._booting: List[int] = []  # parked nodes with a booked power-on

    # -- pressure observation ------------------------------------------------

    def pending_demand(self, pending: Sequence[Job]) -> int:
        return sum(j.requested_nodes for j in pending
                   if j.state is JobState.PENDING)

    def note_pass(self, pending: Sequence[Job], now: float,
                  extra_demand: int = 0) -> None:
        """Observe queue pressure after a scheduler pass.

        ``extra_demand`` carries demand invisible to the queue — e.g. the
        unmet node deltas of waiting resizer-job expands — so a starving
        expand can also trigger a power-up.
        """
        if not self.config.enabled:
            return
        demand = self.pending_demand(pending) + max(extra_demand, 0)
        if demand > 0:
            self.last_pressure_t = now
            self._book_power_ons(demand, now)
        elif not self._off_armed and \
                self.cluster.free_nodes > self.config.min_free:
            self._off_armed = True
            self.engine.schedule(NodePowerOff(
                now + self.config.idle_power_off_s, -1))

    def _book_power_ons(self, demand: int, now: float) -> None:
        need = demand - self.cluster.free_nodes - len(self._booting)
        for node in self.cluster.powered_off:
            if need <= 0:
                break
            if node in self._booting:
                continue
            self._booting.append(node)
            self.engine.schedule(NodePowerOn(
                now + self.config.power_up_delay_s, node))
            need -= 1

    # -- event confirmations -------------------------------------------------

    def confirm_power_off(self, pending: Sequence[Job],
                          now: float) -> List[int]:
        """The armed idle timer fired: park idle nodes above the headroom
        iff the queue stayed pressure-free the whole interval.  Quarantined
        (known-slow) nodes are parked first — they are the least valuable
        capacity.  Returns the nodes actually powered off."""
        self._off_armed = False
        if not self.config.enabled:
            return []
        if self.pending_demand(pending) > 0 or \
                now - self.last_pressure_t < self.config.idle_power_off_s:
            return []                   # pressure arrived mid-interval
        off: List[int] = []
        excess = self.cluster.free_nodes - self.config.min_free
        while excess > 0:
            pool = self.cluster.quarantine or self.cluster.free
            if not pool:
                break
            node = pool[-1]
            if not self.cluster.power_off_node(node):
                break
            off.append(node)
            excess -= 1
        return off

    def confirm_power_on(self, node: int) -> bool:
        """A booked boot finished: move the node back to the pool."""
        if node in self._booting:
            self._booting.remove(node)
        return self.cluster.power_on_node(node)


# ---------------------------------------------------------------------------
# Graceful drain negotiation
# ---------------------------------------------------------------------------

def plan_drain(cluster: Cluster, job: Job, node: int,
               min_floor: int) -> Tuple[str, int]:
    """Decide how to get ``job`` off ``node`` before release (pure).

    Returns ``(kind, new_nodes)``:

    - ``("migrate", nodes)`` — a healthy free node exists: one slice
      migration replaces the draining node (cheapest; the §5.2.2 fold
      mechanics on a single slice), allocation size unchanged.
    - ``("shrink", new)`` — malleable job folds down to the largest
      factor-consistent size that fits the surviving nodes and respects
      the *live* band floor ``min_floor`` (a DMR shrink, §5.2.2).
    - ``("requeue", 0)`` — rigid job, or no factor-consistent size fits:
      checkpoint requeue (§6 deployment path).
    """
    if cluster.free:                       # healthy replacements only
        return "migrate", job.nodes
    survivors = job.nodes - 1
    if job.malleable and survivors >= max(min_floor, 1):
        factor = max(job.factor, 2)
        new = job.nodes
        while new > survivors:
            if new % factor or new // factor < 1:
                break
            new //= factor
        if new <= survivors and new >= max(min_floor, 1):
            return "shrink", new
    return "requeue", 0


# ---------------------------------------------------------------------------
# Named churn scenarios (deterministic drain/join/power schedules)
# ---------------------------------------------------------------------------

Schedule = Tuple[Tuple[float, int], ...]


def _smoke_churn(num_nodes: int) -> Tuple[Schedule, Schedule, CapacityConfig]:
    """The CI smoke schedule: two maintenance drains mid-run, both nodes
    re-join later, one brand-new node arrives near the end, with the power
    manager parking idle capacity in between.  Pure arithmetic in
    ``num_nodes`` so every worker rebuilds it identically."""
    drains = ((600.0, 0), (1200.0, 1))
    joins = ((2100.0, 0), (2400.0, 1), (2700.0, -1))
    cfg = CapacityConfig(enabled=True, idle_power_off_s=300.0,
                         min_free=max(2, num_nodes // 16),
                         power_up_delay_s=60.0)
    return drains, joins, cfg


CHURN_SCENARIOS: Dict[str, Callable[[int],
                                    Tuple[Schedule, Schedule,
                                          CapacityConfig]]] = {
    "smoke": _smoke_churn,
}


def churn_schedule(name: Optional[str], num_nodes: int
                   ) -> Tuple[Schedule, Schedule, CapacityConfig]:
    """Resolve a named churn scenario to ``(drains, joins, config)``.

    ``None``/empty means no churn: empty schedules, power management off.
    """
    if not name:
        return (), (), CapacityConfig()
    try:
        build = CHURN_SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown churn scenario {name!r}; "
            f"registered: {sorted(CHURN_SCENARIOS)}") from None
    return build(num_nodes)
