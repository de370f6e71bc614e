"""Action types and the opaque resize handler of the DMR API (a copy of
``repro.core.actions``)."""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class Action(enum.IntEnum):
    """Reconfiguration action decided by the RMS (paper §4/§5.1)."""

    NO_ACTION = 0
    EXPAND = 1
    SHRINK = 2

    def __bool__(self) -> bool:  # `if action:` idiom of Listing 2/3
        return self is not Action.NO_ACTION


@dataclasses.dataclass
class ResizeHandler:
    """Opaque handler returned by ``dmr_check_status`` (paper §5.1).

    Identifies the pending reconfiguration: which job, from how many slices
    to how many, and — once the runtime materializes it — the new mesh the
    surviving/expanded job continues on.  Subsequent operations (the offload
    of ``compute`` onto the new configuration, Listing 2 line 13) take this
    handler.
    """

    job_id: int
    action: Action
    old_slices: int
    new_slices: int
    resizer_job_id: Optional[int] = None   # expand path: the RJ of §5.2.1
    granted_at: float = 0.0
    # Filled in by the runtime when the new parallel context exists:
    new_mesh: Any = None
    # Diagnostics for the overhead study (Fig. 3 / Table 2):
    schedule_time_s: float = 0.0           # RMS decision latency
    wait_time_s: float = 0.0               # resizer-job pending->running wait
    resize_time_s: float = 0.0             # data-redistribution time
    timed_out: bool = False

    @property
    def factor(self) -> int:
        a, b = self.old_slices, self.new_slices
        if b >= a:
            return b // max(a, 1)
        return a // max(b, 1)


@dataclasses.dataclass(frozen=True)
class Decision:
    """RMS reply to a reconfiguration request."""

    action: Action
    new_slices: int
    schedule_time_s: float = 0.0
    reason: str = ""
    resizer_job_id: Optional[int] = None
    # Wide-optimization shrink: the queued job whose start triggered the
    # shrink — it inherits maximum priority (§4.3).
    boost_job_id: Optional[int] = None
