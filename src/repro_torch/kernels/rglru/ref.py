"""Plain versions of the RG-LRU scan.

``rglru_ref``: the naive sequential recurrence, counterpart of
``repro.kernels.rglru.ref.rglru_ref``; the forward and backward kernels are
held against it and torch autograd of it.

``rglru_bwd_ref``: the backward kernel's reverse recurrence, step by step,
so that its arithmetic stays under test on hosts without a card.
"""
from __future__ import annotations

import torch


def rglru_ref(a, b, h0=None):
    """h_t = a_t * h_{t-1} + b_t, step by step in fp32.

    a, b: (B, S, W); h0: (B, W) or None (zeros). Returns h: (B, S, W) in
    a's dtype.
    """
    bsz, s, w = a.shape
    af, bf = a.float(), b.float()
    h = torch.zeros((bsz, w), dtype=torch.float32, device=a.device) \
        if h0 is None else h0.float()
    hs = []
    for t in range(s):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def rglru_bwd_ref(a, h, h0, dh):
    """Gradients (da, db, dh0) of h = rglru_ref(a, b, h0) given dh, from
    the forward's h: g_t = dh_t + a_{t+1} g_{t+1} from the last step, then
    db_t = g_t, da_t = g_t h_{t-1} (h_{-1} = h0, or 0) and dh0 = a_0 g_0
    (None without h0). fp32."""
    bsz, s, w = a.shape
    af, hf, dhf = a.float(), h.float(), dh.float()
    g = torch.zeros((bsz, w), dtype=torch.float32, device=a.device)
    da, db = [None] * s, [None] * s
    for t in reversed(range(s)):
        g = dhf[:, t] + (af[:, t + 1] * g if t + 1 < s else 0.0)
        before = hf[:, t - 1] if t > 0 else (
            h0.float() if h0 is not None else torch.zeros_like(g))
        db[t], da[t] = g, g * before
    dh0 = af[:, 0] * g if h0 is not None else None
    return torch.stack(da, dim=1), torch.stack(db, dim=1), dh0
