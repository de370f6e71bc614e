"""A kernel family's share of its roofline in a traced window: the sum of
each call's bound (``frozen_work``) over the family's device time. A call's
shape is the cell's, on one slice's rows of the global batch; the calls a
step made are the program's launch counts."""
from __future__ import annotations

from dmrbench import frozen_work as w


def call_work(m: dict, family: str, rows: int, seq: int) -> tuple:
    """(flops, bytes) of one call of ``family`` on ``rows`` x ``seq``."""
    if family.startswith("flash"):
        h, kv = m["num_heads"], m["num_kv_heads"]
        hd = m["head_dim"] or m["d_model"] // h
        fn = w.attention_work if family == "flash_fwd" \
            else w.attention_bwd_work
        return fn(rows, h, kv, seq, seq, hd, 2)
    di = m["ssm_expand"] * m["d_model"]
    p = m["ssm_head_dim"]
    fn = w.ssd_work if family == "ssd_fwd" else w.ssd_bwd_work
    return fn(rows, seq, di // p, p, m["ssm_state"], m["ssd_chunk"], 2)


def share(rec: dict, family: str):
    """100 x (the bound of the traced window's calls of ``family``) / (its
    device time), or None where the window has none."""
    t, m, mix = rec["trace"], rec["m"], rec["mix"]
    seconds = t["family_s"].get(family, 0.0)
    bound = sum(s["launches"][family] * w.bound_s(*call_work(
        m, family, mix["batch"] // s["slices"], mix["seq"]))
        for s in t["steps"])
    if not seconds or not bound:
        return None
    return 100.0 * bound / seconds
