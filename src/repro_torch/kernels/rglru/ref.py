"""Plain versions of the RG-LRU scan.

``rglru_ref``: the naive sequential recurrence, counterpart of
``repro.kernels.rglru.ref.rglru_ref``; the forward and backward kernels are
held against it and torch autograd of it.

``rglru_bwd_ref``: the backward kernel's reverse recurrence, step by step,
so that its arithmetic stays under test on hosts without a card.

``rglru_bwd_chunks``: the same gradients in the backward kernel's order:
segments of steps, chunks of segments, the chunks' carries chained right to
left, each segment rescanned from its carry.
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


def rglru_bwd_chunks(a, h, h0, dh, chunk: int = 128, seg: int = 16):
    """:func:`rglru_bwd_ref`'s gradients as the backward kernel forms them:
    each segment of ``seg`` steps scanned from its right end into a pair
    (product of a_{t+1}, local g), the pairs of a chunk of ``chunk`` steps
    composed right to left into the chunk's aggregate, the chunks' carries
    chained from the last chunk (carry_c = aggregate_{c+1} applied to
    carry_{c+1}), each segment's carry from its chunk's carry through the
    segments to its right, then its steps rescanned from it. fp32."""
    bsz, s, w = a.shape
    nch, nseg = -(-s // chunk), chunk // seg
    af, hf, dhf = a.float(), h.float(), dh.float()
    coef = af.new_zeros((bsz, nch * chunk, w))
    coef[:, :s - 1] = af[:, 1:]
    d = af.new_zeros((bsz, nch * chunk, w))
    d[:, :s] = dhf
    coef = coef.view(bsz, nch, nseg, seg, w)
    d = d.view(bsz, nch, nseg, seg, w)
    prod = af.new_ones((bsz, nch, nseg, w))
    local = af.new_zeros((bsz, nch, nseg, w))
    for u in reversed(range(seg)):
        prod = prod * coef[:, :, :, u]
        local = coef[:, :, :, u] * local + d[:, :, :, u]
    cp = af.new_ones((bsz, nch, w))
    cl = af.new_zeros((bsz, nch, w))
    for j in reversed(range(nseg)):
        cl = prod[:, :, j] * cl + local[:, :, j]
        cp = prod[:, :, j] * cp
    carry = af.new_zeros((bsz, nch, w))
    g = af.new_zeros((bsz, w))
    for c in reversed(range(nch)):
        carry[:, c] = g
        g = cp[:, c] * g + cl[:, c]
    seg_in = af.new_zeros((bsz, nch, nseg, w))
    state = carry
    for j in reversed(range(nseg)):
        seg_in[:, :, j] = state
        state = prod[:, :, j] * state + local[:, :, j]
    gs = af.new_zeros((bsz, nch, nseg, seg, w))
    state = seg_in
    for u in reversed(range(seg)):
        state = coef[:, :, :, u] * state + d[:, :, :, u]
        gs[:, :, :, u] = state
    gs = gs.reshape(bsz, nch * chunk, w)[:, :s]
    before = af.new_zeros((bsz, s, w))
    before[:, 1:] = hf[:, :-1]
    if h0 is not None:
        before[:, 0] = h0.float()
    dh0 = af[:, 0] * gs[:, 0] if h0 is not None else None
    return gs * before, gs.clone(), dh0
