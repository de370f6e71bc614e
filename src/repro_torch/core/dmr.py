"""The DMR (Dynamic Management of Resources) API — paper §5.1.

A copy of ``repro.core.dmr`` (host code; the port imports nothing of
``repro``).

Two entry points, mirroring the paper exactly:

- :meth:`DMR.check_status` (``dmr_check_status``): synchronously contact the
  RMS, which inspects cluster + queue state and returns an action —
  ``EXPAND``, ``SHRINK`` or ``NO_ACTION`` — plus the new number of slices and
  an opaque :class:`~repro_torch.core.actions.ResizeHandler`.
- :meth:`DMR.icheck_status` (``dmr_icheck_status``): the asynchronous
  variant — schedules the decision for the *next* reconfiguration point
  while the current step executes.  The decision is taken against a queue
  snapshot that may go stale; stale expand grants can time out while waiting
  for the resizer job (the pathology of Table 2 that leads the paper to
  dismiss async scheduling).

Arguments (paper §5.1): minimum and maximum number of processes, resizing
factor (resize only to multiples/divisors of ``factor``), preferred number of
processes.  A *checking inhibitor* ignores DMR calls for a configurable
period after the last RMS contact (env var ``DMR_INHIBITOR_SECONDS``),
intended for iterative applications with short iterations.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Protocol, Tuple

from repro_torch.core.actions import Action, Decision, ResizeHandler

INHIBITOR_ENV = "DMR_INHIBITOR_SECONDS"


class RMSProtocol(Protocol):
    """What the DMR runtime layer needs from a resource manager."""

    def request_reconfig(self, job_id: int, *, current: int, minimum: int,
                         maximum: int, factor: int,
                         preferred: Optional[int]) -> Decision:
        """Run the reconfiguration policy; may create a resizer job."""

    def confirm_resize(self, job_id: int, decision: Decision,
                       timeout_s: float) -> Tuple[bool, float]:
        """Expand path: wait for the resizer job to run (§5.2.1).

        Returns ``(granted, wait_time_s)``; ``granted=False`` means the
        wait hit the timeout and the action is aborted (the RJ is
        cancelled).
        """


class DMR:
    """Per-job DMR endpoint exposed by the runtime."""

    def __init__(self, rms: RMSProtocol, job_id: int, *,
                 current_slices: int,
                 inhibitor_s: Optional[float] = None,
                 expand_timeout_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.rms = rms
        self.job_id = job_id
        self.current_slices = current_slices
        if inhibitor_s is None:
            inhibitor_s = float(os.environ.get(INHIBITOR_ENV, "0"))
        self.inhibitor_s = inhibitor_s
        self.expand_timeout_s = expand_timeout_s
        self.clock = clock
        self._last_contact = -float("inf")
        self._pending: Optional[Future] = None
        self._pending_args = None
        self._pool: Optional[ThreadPoolExecutor] = None
        # Telemetry for the overhead study (Table 2).
        self.history: list[ResizeHandler] = []

    # -- internals ----------------------------------------------------------

    def _inhibited(self) -> bool:
        return (self.clock() - self._last_contact) < self.inhibitor_s

    def _query(self, minimum: int, maximum: int, factor: int,
               preferred: Optional[int]) -> Decision:
        t0 = self.clock()
        decision = self.rms.request_reconfig(
            self.job_id, current=self.current_slices, minimum=minimum,
            maximum=maximum, factor=factor, preferred=preferred)
        elapsed = self.clock() - t0
        if decision.schedule_time_s == 0.0:
            import dataclasses as _dc
            decision = _dc.replace(decision, schedule_time_s=elapsed)
        return decision

    def _finalize(self, decision: Decision) -> Tuple[Action, int,
                                                     Optional[ResizeHandler]]:
        handler = ResizeHandler(
            job_id=self.job_id, action=decision.action,
            old_slices=self.current_slices, new_slices=decision.new_slices,
            resizer_job_id=decision.resizer_job_id,
            schedule_time_s=decision.schedule_time_s,
            granted_at=self.clock())
        if decision.action is Action.EXPAND:
            granted, waited = self.rms.confirm_resize(
                self.job_id, decision, timeout_s=self.expand_timeout_s)
            handler.wait_time_s = waited
            if not granted:
                # §5.2.1: RJ cancelled, action aborted — resources were
                # assigned to a different job while we waited.
                handler.timed_out = True
                handler.action = Action.NO_ACTION
                handler.new_slices = self.current_slices
                self.history.append(handler)
                return Action.NO_ACTION, self.current_slices, None
        if decision.action is not Action.NO_ACTION:
            self.current_slices = decision.new_slices
        self.history.append(handler)
        if decision.action is Action.NO_ACTION:
            return Action.NO_ACTION, self.current_slices, None
        return handler.action, handler.new_slices, handler

    # -- public API (paper §5.1) -------------------------------------------

    def check_status(self, *, minimum: int, maximum: int, factor: int = 1,
                     preferred: Optional[int] = None
                     ) -> Tuple[Action, int, Optional[ResizeHandler]]:
        """``dmr_check_status`` — synchronous reconfiguration check."""
        if self._inhibited():
            return Action.NO_ACTION, self.current_slices, None
        self._last_contact = self.clock()
        decision = self._query(minimum, maximum, factor, preferred)
        return self._finalize(decision)

    def icheck_status(self, *, minimum: int, maximum: int, factor: int = 1,
                      preferred: Optional[int] = None
                      ) -> Tuple[Action, int, Optional[ResizeHandler]]:
        """``dmr_icheck_status`` — asynchronous reconfiguration check.

        Returns the decision scheduled at the *previous* reconfiguration
        point (or ``NO_ACTION`` on the first call / while none is ready) and
        schedules a fresh decision to be computed concurrently with the next
        execution step.
        """
        if self._inhibited():
            return Action.NO_ACTION, self.current_slices, None
        result: Tuple[Action, int, Optional[ResizeHandler]]
        if self._pending is not None and self._pending.done():
            decision: Decision = self._pending.result()
            self._pending = None
            result = self._finalize(decision)
        else:
            result = (Action.NO_ACTION, self.current_slices, None)
        if self._pending is None:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1,
                                                thread_name_prefix="dmr")
            self._last_contact = self.clock()
            self._pending = self._pool.submit(
                self._query, minimum, maximum, factor, preferred)
        return result

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
