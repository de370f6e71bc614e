"""From a profiled window's events to the records the per-layer metrics read.

``reduce`` takes the device events and host events of ``frozen_profile.
session`` and the program's kernel names by family, and returns: the busy
time (the union of the device events' intervals), the device time of each
family of the program's kernels (each box copy's time apart, in order), the
device time of PyTorch's elementwise kernels, the device operations that
took the most time, and the idle gaps by what the host was doing: the
innermost host event open at the gap's start, under the harness's own span
(``dmrbench.*``).
"""
from __future__ import annotations

from collections import Counter, defaultdict

from dmrbench.frozen_profile import ANNOTATIONS as SPAN
from dmrbench.frozen_profile import base_name

TOP = 10


def program_kernels() -> dict:
    """The program's CUDA kernel names (base names) by family: the flash
    attention forward and backward, the SSD scan's, the RG-LRU scan's and
    the reshard's box copy, as its kernel modules name them. A name in two
    families (the SSD's ``state_pass``) is resolved by order: it takes the
    family of the last event of one family alone."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.reshard import kernel as box
    from repro_torch.kernels.rglru import kernel as rglru
    from repro_torch.kernels.ssd import kernel as ssd
    fams = defaultdict(set)
    for dt in (torch.float32, torch.bfloat16):
        fams["flash_fwd"].update(flash.cuda_kernels(dt))
        for d in flash.HEAD_DIMS:
            for splits in (1, 2):
                fams["flash_bwd"].update(flash.bwd_cuda_kernels(dt, d,
                                                                splits))
        fams["ssd_fwd"].update(ssd.cuda_kernels(dt))
        fams["ssd_bwd"].update(ssd.bwd_cuda_kernels(dt))
    fams["rglru"].update(rglru.CUDA_KERNEL + rglru.BWD_CUDA_KERNEL)
    fams["box_copy"].update(box.CUDA_KERNEL)
    return {k: frozenset(v) for k, v in fams.items()}


def launch_counters() -> dict:
    """The program's launch counters by family (``<wrapper>.launches``)."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.reshard import kernel as box
    from repro_torch.kernels.ssd import kernel as ssd
    return {"flash_fwd": flash.flash_attention,
            "flash_bwd": flash.flash_attention_bwd,
            "ssd_fwd": ssd.ssd_scan, "ssd_bwd": ssd.ssd_scan_bwd,
            "box_copy": box.box_copy}


def busy_intervals(events) -> list:
    """The union of the events' [start, end) intervals, ns, in order."""
    out = []
    for _, start, dur in sorted(events, key=lambda e: e[1]):
        end = start + max(dur, 0)
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def families_of(events, kernels: dict) -> list:
    """Each device event's family of the program's kernels (or None)."""
    by_name = defaultdict(list)
    for fam, names in kernels.items():
        for n in names:
            by_name[n].append(fam)
    out, last = [], None
    for name, _, _ in events:
        fams = by_name.get(base_name(name), [])
        if len(fams) == 1:
            last = fams[0]
            out.append(last)
        elif fams:
            out.append(last if last in fams else fams[0])
        else:
            out.append(None)
    return out


def host_label(host, t: int, opened: list, i: int) -> tuple:
    """The label of host time ``t`` from the host events ``host`` (sorted
    by start), sweeping forward: (label, the events still open, the next
    index). ``t`` must not decrease between calls."""
    while i < len(host) and host[i][1] <= t:
        opened.append(host[i])
        i += 1
    opened[:] = [e for e in opened if e[2] > t]
    span = [e for e in opened if e[0].startswith(SPAN)]
    inner = [e for e in opened if not e[0].startswith(SPAN)]
    label = min(span, key=lambda e: e[2] - e[1])[0] if span else "(no span)"
    if inner:
        label += ": " + max(inner, key=lambda e: e[1])[0][:60]
    return label, opened, i


def reduce(events, host, window, kernels: dict) -> dict:
    """The traced window's records (see the module's docstring). ``window``:
    its (start, end) ns on the card's clock."""
    t0, t1 = window
    busy = busy_intervals(events)
    fams = families_of(events, kernels)
    family_s, box_copy_s, elementwise_s = Counter(), [], 0.0
    ops = Counter()
    for (name, _, dur), fam in zip(events, fams):
        s = dur / 1e9
        ops[base_name(name)] += s
        if fam is not None:
            family_s[fam] += s
            if fam == "box_copy":
                box_copy_s.append(s)
        if "elementwise_kernel" in base_name(name):
            elementwise_s += s
    gaps, edges = Counter(), [t0]
    for start, end in busy:
        edges += [start, end]
    edges.append(t1)
    opened, i = [], 0
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi > lo:
            label, opened, i = host_label(host, lo, opened, i)
            gaps[label] += (hi - lo) / 1e9
    return {"window_s": (t1 - t0) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "family_s": dict(family_s), "box_copy_s": box_copy_s,
            "elementwise_s": elementwise_s,
            "device_ops": [[n, s] for n, s in ops.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(TOP)]}
