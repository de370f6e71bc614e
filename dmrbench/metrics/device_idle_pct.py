"""The traced window's share in which no operation ran on the card, %:
1 - busy / window, both from the profiler's device events."""


def read(rec):
    t = rec["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
