"""The host's share of a resize in the traced window: its stall (timed
around ``maybe_reconfigure``, the card synchronised on both sides) less its
RMS decision and its box copy's device time, mean, ms. Each resize on one
card launches one box copy, in order."""


def read(rec):
    t = rec["trace"]
    rs, copies = t["resizes"], t["box_copy_s"]
    if not rs or len(copies) != len(rs):
        return None
    return 1e3 * sum(r["stall_s"] - r["decide_s"] - c
                     for r, c in zip(rs, copies)) / len(rs)
