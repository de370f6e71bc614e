"""The comparison that decides ``correct``.

The program's first steps and the reference's (``reference.Reference.run``)
are read as four numbers; each that the cell's limits name
(``limits/<cell>.json``) is held to its limit:

- ``loss``: the widest gap of a step's loss from the reference's, over the
  reference's loss;
- ``grad_norm``: the gap of the first gradient's global norm before
  clipping (the trainer's ``grad_norm``) from the reference's, over the
  reference's;
- ``grad``: the first gradient as AdamW takes it, by the worst leaf: the gap
  between the program's norm of a leaf and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
- ``change``: the parameters' change after the last checked step, by the
  worst leaf in the same measure, leaving out the leaves whose first
  gradient in the reference is under a thousandth of the median leaf's
  (they move by round-off alone).

A leaf is one layer of a stacked parameter, or an unstacked one.
"""
from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3


def gaps(got: dict, want: dict, keys) -> dict:
    """{leaf: the gap of its norms over the reference's norm of it or of the
    median leaf, whichever is larger} over ``keys``."""
    keys = list(keys)
    if set(got) != set(want):
        raise ValueError(f"the program's leaves differ from the "
                         f"reference's: {sorted(set(got) ^ set(want))[:8]}")
    floor = statistics.median(want[k] for k in keys)
    return {k: abs(got[k] - want[k]) / max(want[k], floor, 1e-30)
            for k in keys}


def moved(want: dict) -> list:
    """The leaves whose first gradient in the reference is not nought."""
    raw = want["grad_raw"]
    floor = statistics.median(raw.values())
    return [k for k in want["change"] if raw[k] >= NOUGHT * floor]


def numbers(got: dict, want: dict) -> dict:
    """The three numbers of ``got`` (the program's, or the control's)
    against ``want`` (the reference's): each a dict of ``losses`` [per
    step], ``grad`` and ``change`` {leaf: norm}; ``want`` also ``grad_raw``,
    the first gradient before clipping."""
    if len(got["losses"]) != len(want["losses"]):
        raise ValueError("the program and the reference ran different steps")
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(got["losses"], want["losses"]))
    return {"loss": loss,
            "grad_norm": abs(got["grad_norm"] - want["grad_norm"])
            / want["grad_norm"],
            "grad": max(gaps(got["grad"], want["grad"],
                             want["grad"]).values()),
            "change": max(gaps(got["change"], want["change"],
                               moved(want)).values())}


def worst(got: dict, want: dict, n: int = 6) -> dict:
    """The ``n`` leaves with the widest gaps of ``grad`` and ``change``,
    with the two norms: where a number's reading comes from."""
    out = {}
    for name, keys in (("grad", list(want["grad"])),
                       ("change", moved(want))):
        g = gaps(got[name], want[name], keys)
        out[name] = [(k, g[k], got[name][k], want[name][k])
                     for k in sorted(g, key=g.get, reverse=True)[:n]]
    return out


def limit_between(lower: float, upper: float) -> float:
    """A limit two thirds of the way from ``lower`` (the program's largest
    reading) to ``upper`` (the smallest that fails), on a log scale: room
    on both sides, the more of it above the lower."""
    return lower ** (1 / 3) * upper ** (2 / 3)


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}) over the numbers the cell's
    limits name: every one finite and at most its limit."""
    rows = {k: {"value": values.get(k, math.nan),
                "limit": lim["limit"]} for k, lim in limits.items()}
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"]
             for r in rows.values())
    return ok, rows
