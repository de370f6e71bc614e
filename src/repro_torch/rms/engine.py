"""Event-driven simulation engine — the substrate under the RMS testbed.

The monolithic ``ClusterSimulator`` loop is split into a small, generic
discrete-event core (this module) plus pluggable handlers registered per
event *type*.  New scenario classes (preemption, power capping, network
contention, …) become new :class:`Event` subclasses with their own
handlers instead of edits to one hard-wired loop.

Event types map onto the source paper as follows:

=================  ==========================================================
Event              Paper section
=================  ==========================================================
``JobSubmit``      §7.1 workload generation — a job enters the RMS queue.
``JobFinish``      §7.4 metrics — completion bookkeeping (wait/exec/
                   completion times; invalidated by ``version`` on resize).
``ReconfigPoint``  §5.2 — the periodic DMR check where the application
                   contacts the RMS and an EXPAND/SHRINK/NO_ACTION decision
                   is taken (synchronous or asynchronous, §5.1).
``ExpandTimeout``  §5.2.1 / Table 2 — the asynchronous resizer-job (RJ)
                   reservation expires; the pathological async wait ceiling.
                   Carries an ``epoch`` so a requeue structurally kills the
                   pending timeout instead of relying on float equality.
``PhaseChange``    §2 taxonomy EVOLVING — the application enters its next
                   phase and announces a new ``(min, max, preferred)``
                   demand band; the handler updates the live band and
                   forces an immediate DMR check (§5.2 hook).
``NodeFail``       beyond-paper fault path: shrink-to-survivors for
                   malleable jobs, checkpoint requeue for rigid ones (§8's
                   deployment argument).
``NodeJoin``       beyond-paper elastic capacity: a node enters the pool
                   (scale-out, maintenance done, spot granted) — waiting
                   expands and queued jobs can claim it immediately.
``NodeDrain``      beyond-paper elastic capacity: a node must leave the
                   pool (maintenance, spot reclamation); the RMS negotiates
                   the owning job off it — slice migration, DMR shrink, or
                   checkpoint requeue — before release.
``NodePowerOff``   beyond-paper energy management (CLUES-style): the
                   capacity manager's armed idle timer fires; idle nodes
                   above the ``min_free`` headroom are parked.
``NodePowerOn``    beyond-paper energy management: a parked node finishes
                   booting (``power_up_delay_s`` after queue pressure
                   demanded it) and rejoins the allocatable pool.
``StragglerOnset`` beyond-paper: a node slows down; gates the whole job.
``StragglerScan``  beyond-paper: periodic detection + slice migration
                   (mechanically the §5.2.2 shrink data-fold on one slice).
``CheckpointTick`` §6 deployment — periodic checkpoint, the restore point
                   used by the ``NodeFail`` path.
``TrafficTick``    beyond-paper SERVING class: the periodic latency probe of
                   an open-loop request stream — drains backlog at the app
                   rate, samples p99 vs the SLO, and (like ReconfigPoint)
                   carries an ``epoch`` so a requeue structurally retires
                   the pending chain.
=================  ==========================================================

Determinism contract: events are dispatched in ``(t, seq)`` order where
``seq`` is the scheduling sequence number, so two runs that schedule the
same events in the same order replay identically (tier-1 golden-trace test
``tests/test_engine_determinism.py`` locks this down).

Hot-path notes: event dataclasses are ``slots=True`` (a simulation
allocates one per scheduled event — millions in a big sweep) and the
dispatcher resolves each event type's handler chain once, caching the
MRO walk, instead of re-walking it on every dispatch.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple, Type


# ---------------------------------------------------------------------------
# Typed events
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, slots=True)
class Event:
    """Base event: ``t`` is the simulation time the event fires at."""
    t: float


@dataclasses.dataclass(frozen=True, slots=True)
class JobSubmit(Event):
    job_id: int


@dataclasses.dataclass(frozen=True, slots=True)
class JobFinish(Event):
    job_id: int
    version: int          # invalidates stale completions after a resize


@dataclasses.dataclass(frozen=True, slots=True)
class ReconfigPoint(Event):
    job_id: int
    epoch: int = 0        # invalidates a chain left over from a prior start


@dataclasses.dataclass(frozen=True, slots=True)
class ExpandTimeout(Event):
    job_id: int
    since: float          # identifies which pending wait this timeout guards
    epoch: int = 0        # invalidated structurally when the job requeues


@dataclasses.dataclass(frozen=True, slots=True)
class NodeFail(Event):
    node: int


@dataclasses.dataclass(frozen=True, slots=True)
class NodeJoin(Event):
    """A node joins the pool; ``node < 0`` joins brand-new capacity under a
    fresh id, a known id re-joins after a drain (or repaired after death)."""
    node: int = -1


@dataclasses.dataclass(frozen=True, slots=True)
class NodeDrain(Event):
    """``node`` must leave the pool (maintenance / spot reclamation)."""
    node: int


@dataclasses.dataclass(frozen=True, slots=True)
class NodePowerOff(Event):
    """The capacity manager's idle timer: ``node < 0`` lets the manager
    pick which idle nodes to park (quarantined slow nodes first)."""
    node: int = -1


@dataclasses.dataclass(frozen=True, slots=True)
class NodePowerOn(Event):
    """A parked node finishes booting and becomes allocatable."""
    node: int = -1


@dataclasses.dataclass(frozen=True, slots=True)
class StragglerOnset(Event):
    node: int
    slowdown: float


@dataclasses.dataclass(frozen=True, slots=True)
class StragglerScan(Event):
    job_id: int


@dataclasses.dataclass(frozen=True, slots=True)
class CheckpointTick(Event):
    job_id: int
    epoch: int = 0        # invalidates a chain left over from a prior start


@dataclasses.dataclass(frozen=True, slots=True)
class TrafficTick(Event):
    """Periodic backlog/latency probe for a SERVING job.

    The handler accrues open-loop arrivals, drains what the current
    allocation served since the last tick, samples the queueing-delay p99
    against the job's SLO, and re-arms itself; ``epoch`` guards against a
    stale chain surviving a requeue/restart (same pattern as
    ReconfigPoint).
    """
    job_id: int
    epoch: int = 0        # invalidates a chain left over from a prior start


@dataclasses.dataclass(frozen=True, slots=True)
class PhaseChange(Event):
    """An EVOLVING job enters phase ``phase`` and demands a new band.

    The event carries the band so the handler applies exactly what the
    application announced; ``epoch`` guards against stale events left over
    from a prior start/resize prediction (same pattern as ReconfigPoint).
    """
    job_id: int
    phase: int            # index of the phase being entered
    min_nodes: int
    max_nodes: int
    preferred: Optional[int] = None
    epoch: int = 0        # invalidates a prediction from a prior start


Handler = Callable[[Event], None]


# ---------------------------------------------------------------------------
# Monitors
# ---------------------------------------------------------------------------

class _MonitorFanout:
    """Dispatches monitor hooks to several monitors in registration order.

    Only materialized when two or more monitors are installed, so the
    common cases (none, or just the sanitizer / just the recorder) pay no
    extra indirection: the hot loop sees either ``None`` or the single
    monitor object itself.
    """

    __slots__ = ("monitors",)

    def __init__(self, monitors):
        self.monitors = tuple(monitors)

    def on_schedule(self, event: Event) -> None:
        for m in self.monitors:
            m.on_schedule(event)

    def before_event(self, event: Event) -> None:
        for m in self.monitors:
            m.before_event(event)

    def after_event(self, event: Event) -> None:
        for m in self.monitors:
            m.after_event(event)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class SimulationEngine:
    """Minimal deterministic discrete-event dispatcher.

    Handlers are registered per event type with :meth:`on`; dispatch walks
    the event's MRO so a handler registered for :class:`Event` observes
    everything (useful for tracing/monitor plugins).
    """

    def __init__(self, max_events: int = 5_000_000):
        self.now = 0.0
        self.max_events = max_events
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = itertools.count()
        self._handlers: Dict[Type[Event], List[Handler]] = {}
        # Per concrete event type: the flattened handler chain (own type
        # first, then base types up the MRO).  Rebuilt lazily after every
        # registration — dispatch never walks the MRO itself.
        self._chain: Dict[Type[Event], Tuple[Handler, ...]] = {}
        self.dispatched = 0
        # Optional monitors (sanitizer, trace recorder, …): objects with
        # ``on_schedule(event)`` / ``before_event(event)`` /
        # ``after_event(event)``, observing every event in registration
        # order.  ``_monitor`` holds the composed view the hot paths read:
        # None when empty, the sole monitor itself when one is installed,
        # a _MonitorFanout above that.  Install *before* run() — the hot
        # loop hoists the reference, so a mid-run change is not observed.
        self._monitors: Tuple = ()
        self._monitor = None

    # -- monitors ------------------------------------------------------------

    @property
    def monitor(self):
        """The composed monitor view (None / single monitor / fan-out)."""
        return self._monitor

    @monitor.setter
    def monitor(self, value) -> None:
        # Backwards-compatible single-slot assignment: replaces the whole
        # monitor set (``engine.monitor = None`` uninstalls everything).
        self._monitors = () if value is None else (value,)
        self._compose()

    def add_monitor(self, monitor) -> None:
        """Append ``monitor`` to the ordered fan-out (idempotent)."""
        if monitor not in self._monitors:
            self._monitors = self._monitors + (monitor,)
            self._compose()

    def remove_monitor(self, monitor) -> None:
        """Remove ``monitor`` if installed; no-op otherwise."""
        if monitor in self._monitors:
            self._monitors = tuple(
                m for m in self._monitors if m is not monitor)
            self._compose()

    def _compose(self) -> None:
        n = len(self._monitors)
        if n == 0:
            self._monitor = None
        elif n == 1:
            self._monitor = self._monitors[0]
        else:
            self._monitor = _MonitorFanout(self._monitors)

    # -- registration --------------------------------------------------------

    def on(self, event_type: Type[Event], handler: Handler = None):
        """Register ``handler`` for ``event_type``; usable as a decorator."""
        if handler is None:
            def deco(fn: Handler) -> Handler:
                self.on(event_type, fn)
                return fn
            return deco
        self._handlers.setdefault(event_type, []).append(handler)
        self._chain.clear()    # chains are stale once registrations change
        return handler

    def _build_chain(self, event_type: Type[Event]) -> Tuple[Handler, ...]:
        chain: List[Handler] = []
        for klass in event_type.__mro__:
            if klass is object:
                break
            chain.extend(self._handlers.get(klass, ()))
        out = tuple(chain)
        self._chain[event_type] = out
        return out

    # -- scheduling ----------------------------------------------------------

    def schedule(self, event: Event) -> None:
        monitor = self._monitor
        if monitor is not None:
            monitor.on_schedule(event)
        heapq.heappush(self._heap, (event.t, next(self._seq), event))

    def schedule_at(self, t: float, event_type: Type[Event], **fields) -> None:
        self.schedule(event_type(t=t, **fields))

    # -- main loop -----------------------------------------------------------

    def _dispatch(self, event: Event) -> None:
        cls = type(event)
        chain = self._chain.get(cls)
        if chain is None:
            chain = self._build_chain(cls)
        for handler in chain:
            handler(event)

    def step(self) -> bool:
        """Dispatch the next event; returns False when the heap is empty."""
        if not self._heap:
            return False
        t, _, event = heapq.heappop(self._heap)
        self.now = t
        self.dispatched += 1
        if self.dispatched > self.max_events:
            raise RuntimeError("simulation runaway: max_events exceeded")
        monitor = self._monitor
        if monitor is not None:
            monitor.before_event(event)
        self._dispatch(event)
        if monitor is not None:
            monitor.after_event(event)
        return True

    def run(self) -> None:
        # Tight inlining of step(): the loop body runs once per event, so
        # attribute lookups are hoisted out of it.  ``self._chain`` is
        # aliased, not copied — a handler registering new handlers mid-run
        # clears the same dict, so stale chains cannot be reused.
        heap = self._heap
        pop = heapq.heappop
        chains = self._chain
        dispatched = self.dispatched
        max_events = self.max_events
        monitor = self._monitor
        try:
            while heap:
                t, _, event = pop(heap)
                self.now = t
                dispatched += 1
                if dispatched > max_events:
                    raise RuntimeError(
                        "simulation runaway: max_events exceeded")
                cls = type(event)
                chain = chains.get(cls)
                if chain is None:
                    chain = self._build_chain(cls)
                if monitor is None:
                    for handler in chain:
                        handler(event)
                else:
                    monitor.before_event(event)
                    for handler in chain:
                        handler(event)
                    monitor.after_event(event)
        finally:
            self.dispatched = dispatched
