"""The reshard's box copy against its bound: 2 x the bytes the traced
window's resizes wrote into new blocks, at the card's 3.35 TB/s, over the
box copy's device time, %."""
from dmrbench.frozen_work import PEAK_BYTES


def read(rec):
    t = rec["trace"]
    rs, copies = t["resizes"], t["box_copy_s"]
    if not rs or not copies:
        return None
    bound = sum(2.0 * r["copied_bytes"] for r in rs) / PEAK_BYTES
    return 100.0 * bound / sum(copies)
