"""Plain version of the RG-LRU scan: the naive sequential recurrence.

Counterpart of ``repro.kernels.rglru.ref.rglru_ref``.
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
