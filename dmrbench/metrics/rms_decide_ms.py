"""The RMS's decision time at the measured window's resizes (the policy's
``Decision.schedule_time_s``, as ``LocalRMS`` times it), mean, ms."""


def read(rec):
    rs = rec["window"]["resizes"]
    if not rs:
        return None
    return 1e3 * sum(r["decide_s"] for r in rs) / len(rs)
