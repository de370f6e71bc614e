"""Reading the card's busy time through torch.profiler: a frozen copy of
``src/repro_torch/kernels/bench.py``'s ``base_name``, ``check_profile``,
``sentinel`` and ``session`` (commit 8108f17), the one way to read busy and
idle time on this torch build that has held (PERF.md: in some processes
torch.profiler loses a session's first kernel records; the session's 256
sentinel kernels before and after the interval absorb them, and
``check_profile`` refuses an interval that lists fewer of the program's
kernels than its wrappers launched).

Changed from the original: one interval a session, whose device events are
returned with their start and duration, and the host's events beside them
(to name what the host was doing in each idle gap); the program's kernel
names and launch counts are arguments, read from the program by the caller;
the allocator's cache is not emptied first, so that the traced steps run on
the blocks the steps before them cached, as the measured window's do.
"""
from __future__ import annotations

import re
from collections import Counter

import torch

MARK, MARK_CYCLES, SENTINELS = "spin_kernel", 20000, 256
# the caller's host spans, whose device lanes are not device work
ANNOTATIONS = "dmrbench."


def base_name(name: str) -> str:
    """A CUDA kernel's own name from the profiler's: no return type,
    namespace, template arguments or parameters."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void\s+)?([\w:]+)", name)
    return m.group(1).rsplit("::", 1)[-1] if m else name


def check_profile(events, launched: Counter, ours: frozenset,
                  what: str) -> None:
    """Raise unless the interval's device events ``events`` [(name, start
    ns, duration ns)] hold at least one event and list each of the
    program's CUDA kernels (``ours``, by base name) as often as its
    wrappers counted launching it (``launched``), each with device time."""
    if not events:
        raise RuntimeError(f"the profile of {what} holds no device event")
    seen, timeless = Counter(), Counter()
    for name, _, dur in events:
        base = base_name(name)
        if base in ours:
            seen[base] += 1
            timeless[base] += dur <= 0
    timeless = +timeless
    if seen != +launched or timeless:
        raise RuntimeError(
            f"the profile of {what} lists the program's CUDA kernels "
            f"{dict(seen)}, {sum(timeless.values())} of them without device "
            f"time; the wrappers launched {dict(launched)}")


def sentinel() -> None:
    """SENTINELS small CUDA kernels, finished."""
    for _ in range(SENTINELS):
        torch.zeros(1, device="cuda")
    torch.cuda.synchronize()


def session(fn, counter: Counter):
    """One torch.profiler session over ``fn()``, called once between two
    marks (a spin kernel, the card synchronised on each side), between the
    sentinel's kernels. ``counter``: the program's count of the CUDA kernels
    its wrappers launch, by name. The device lanes of the caller's host
    spans (``record_function`` names starting with ``ANNOTATIONS``) are not
    device events. Returns (fn's result, the device events of
    the interval [(name, start ns, duration ns)] in time order, the host
    events that overlap it [(name, start ns, end ns)], the kernels the
    wrappers launched in it, the interval's (start ns, end ns) on the
    card's clock)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def mark():
        torch.cuda.synchronize()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sentinel()
        mark()
        before = Counter(counter)
        out = fn()
        launched = Counter(counter) - before
        mark()
        sentinel()
    raw = prof.profiler.kineto_results.events()
    cuda = sorted((ev for ev in raw if ev.device_type() == DeviceType.CUDA
                   and not ev.name().startswith(ANNOTATIONS)),
                  key=lambda ev: ev.start_ns())
    marks = [i for i, ev in enumerate(cuda) if base_name(ev.name()) == MARK]
    if len(marks) != 2:
        raise RuntimeError(f"the profile lists {len(marks)} of its 2 marks "
                           f"among {len(cuda)} device events")
    if marks[0] == 0 or marks[-1] == len(cuda) - 1:
        raise RuntimeError(f"the profile lost all {SENTINELS} kernels the "
                           f"session began or ended with")
    lo, hi = marks
    t0 = cuda[lo].start_ns() + cuda[lo].duration_ns()
    t1 = cuda[hi].start_ns()
    events = [(ev.name(), ev.start_ns(), ev.duration_ns())
              for ev in cuda[lo + 1:hi]]
    host = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in raw if ev.device_type() != DeviceType.CUDA
            and ev.start_ns() < t1 and ev.start_ns() + ev.duration_ns() > t0]
    host.sort(key=lambda e: e[1])
    return out, events, host, launched, (t0, t1)
