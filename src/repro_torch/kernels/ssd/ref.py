"""Plain versions of the SSD scan.

``ssd_ref``: the naive step-by-step SSM recurrence, counterpart of
``repro.kernels.ssd.ref.ssd_ref``; it also returns the final state, which
the CUDA kernel writes too. The CUDA kernel is held against it.

``ssd_passes``: the CUDA kernel's three passes (chunk states, state
passing, chunk outputs) in plain PyTorch, with seg = cumsum(dt * a) summed
in fp64 within each chunk as the kernel sums it, and ragged S padded with
zeros as the kernel masks it. Tests hold it against the reference, so the
kernel's decomposition stays under test on hosts without a card; nothing
on the main path calls it.

``ssd_bwd_passes``: the same for the backward kernel (``csrc/ssd_scan_bwd.cu``):
the gradients of the chunked algorithm, pass by pass. Its yardstick is
torch autograd of ``ssd_ref`` (tests) or of the model's ``ssd_chunked``.
"""
from __future__ import annotations

import torch

MAX_CHUNK = 128


def ssd_ref(x, dt, a_log, b, c):
    """Sequential scan oracle.

    x: (B,S,H,P); dt: (B,S,H) (already softplus'ed); a_log: (H,);
    b, c: (B,S,N). Returns (y (B,S,H,P) in x's dtype, h_final (B,H,P,N)
    fp32), with the fp32 state
        h_t = exp(dt_t * a) h_{t-1} + dt_t * B_t x_t ;  y_t = C_t . h_t
    and a = -exp(a_log).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        da = torch.exp(dtf[:, t] * a[None, :])                # (B,H)
        bx = torch.einsum("bn,bhp->bhpn", bf[:, t],
                          xf[:, t] * dtf[:, t][..., None])
        state = state * da[..., None, None] + bx
        ys.append(torch.einsum("bn,bhpn->bhp", cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype), state


def _chunked(t, q: int):
    """(B, S, ...) -> (B, NC, q, ...), rows past S as zeros."""
    s = t.shape[1]
    nc = -(-s // q)
    pad = torch.zeros((t.shape[0], nc * q - s, *t.shape[2:]), dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, pad], dim=1).reshape(t.shape[0], nc, q,
                                              *t.shape[2:])


def _segments(dt, a_log, q: int):
    """seg (B, NC, q, H) fp64: the within-chunk cumsum of fp32(dt * a)."""
    a = -torch.exp(a_log.float())
    return (_chunked(dt.float(), q) * a).double().cumsum(dim=2)


def chunk_states(x, dt, a_log, b, q: int):
    """Pass 1: each chunk's own contribution to the state,
    B^T ((x dt) exp(seg_last - seg)), (B, NC, H, P, N) fp32, and each
    chunk's total seg_last (B, NC, H) fp32."""
    seg = _segments(dt, a_log, q)
    total = seg[:, :, -1]                                      # (B,NC,H)
    rem = torch.exp((total[:, :, None] - seg).float())         # (B,NC,q,H)
    xdt = _chunked(x.float() * dt.float()[..., None], q)       # (B,NC,q,H,P)
    states = torch.einsum("bcqhp,bcqn->bchpn", xdt * rem[..., None],
                          _chunked(b.float(), q))
    return states, total.float()


def state_passing(states, totals):
    """Pass 2: h_in[c + 1] = exp(seg_last[c]) h_in[c] + S[c] in fp32, from
    h_in[0] = 0. Returns (h_in (B, NC, H, P, N), h_final (B, H, P, N))."""
    h = torch.zeros_like(states[:, 0])
    h_in = []
    for ci in range(states.shape[1]):
        h_in.append(h)
        h = h * torch.exp(totals[:, ci])[..., None, None] + states[:, ci]
    return torch.stack(h_in, dim=1), h


def chunk_outputs(x, dt, a_log, b, c, h_in, q: int):
    """Pass 3: y = ((C B^T) exp(seg_i - seg_j) on j <= i) (x dt)
    + exp(seg_i) C h_in, (B, S, H, P) in x's dtype."""
    s = x.shape[1]
    seg = _segments(dt, a_log, q)                              # (B,NC,q,H)
    cc, bc = _chunked(c.float(), q), _chunked(b.float(), q)
    xdt = _chunked(x.float() * dt.float()[..., None], q)
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]       # (B,NC,q,q,H)
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  -torch.inf).float())
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * decay, xdt)
    y = y + torch.einsum("bcin,bchpn->bcihp", cc, h_in) * \
        torch.exp(seg.float())[..., None]
    return y.reshape(x.shape[0], -1, *x.shape[2:])[:, :s].to(x.dtype)


def ssd_passes(x, dt, a_log, b, c, *, chunk: int = 128):
    """The CUDA kernel's decomposition, in chunks of ``min(chunk, S, 128)``
    rows: (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) fp32)."""
    q = min(chunk, x.shape[1], MAX_CHUNK)
    states, totals = chunk_states(x, dt, a_log, b, q)
    h_in, h_final = state_passing(states, totals)
    return chunk_outputs(x, dt, a_log, b, c, h_in, q), h_final


def _unchunked(t, s: int):
    """(B, NC, q, ...) -> (B, S, ...), the rows past S dropped."""
    return t.reshape(t.shape[0], -1, *t.shape[3:])[:, :s]


def ssd_bwd_passes(x, dt, a_log, b, c, dy, dh_final=None, *,
                   chunk: int = 128):
    """Gradients (dx, ddt, da_log, db, dc) of :func:`ssd_passes`' (y,
    h_final) for their gradients ``dy`` and ``dh_final`` (None: zeros), by
    the backward kernel's passes, in fp32 with fp64 sums where they cancel:

    1. each chunk's own share of the gradient of its incoming state,
       Sd = sum_i exp(seg_i) dy_i (x) C_i;
    2. in reverse over the chunks, dh_out[c] = dh_in[c + 1] (dh_final for
       the last), dh_in[c] = exp(seg_last) dh_out[c] + Sd[c];
    3. per chunk, with G = (C B^T) exp(seg_i - seg_j) and
       PD = (dy (x dt)^T) exp(seg_i - seg_j) on j <= i, M = PD (C B^T):
       d(x dt) = G^T dy + exp(seg_last - seg) B dh_out^T,
       dC = PD B + exp(seg) dy h_in, dB = PD^T C + exp(seg_last - seg)
       (x dt) dh_out. d(dt a)_k sums what each exponent gives: the pairs
       i >= k > j of M (M's row sums less its column sums, in fp64, summed
       over i >= k), the carried-state term's C_i . dC_i (its h_in part)
       over i >= k, exp(seg_last) dh_out . h_in, and the chunk-state
       term's u_j = B_j . dB_j (its dh_out part) over j < k. Then
       ddt = d(x dt) . x + d(dt a) a and da_log = sum d(dt a) dt a.
    db and dc sum over the heads; outputs take their inputs' dtypes."""
    bsz, s, h, p = x.shape
    q = min(chunk, s, MAX_CHUNK)
    seg = _segments(dt, a_log, q)                              # (B,NC,q,H)
    total = seg[:, :, -1]
    states, totals = chunk_states(x, dt, a_log, b, q)
    h_in, h_final = state_passing(states, totals)
    xc, dtc = _chunked(x.float(), q), _chunked(dt.float(), q)
    bc, cc = _chunked(b.float(), q), _chunked(c.float(), q)
    dyc = _chunked(dy.float(), q)
    xdt = xc * dtc[..., None]
    eseg = torch.exp(seg.float())
    rem = torch.exp((total[:, :, None] - seg).float())
    # passes 1 and 2
    sd = torch.einsum("bcqhp,bcqn->bchpn", dyc * eseg[..., None], cc)
    g = torch.zeros_like(h_final) if dh_final is None else dh_final.float()
    dh_out = [None] * sd.shape[1]
    for ci in reversed(range(sd.shape[1])):
        dh_out[ci] = g
        g = g * torch.exp(totals[:, ci])[..., None, None] + sd[:, ci]
    dh_out = torch.stack(dh_out, dim=1)                        # (B,NC,H,P,N)
    # pass 3
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    diff = seg[:, :, :, None, :] - seg[:, :, None, :, :]       # (B,NC,i,j,H)
    decay = torch.exp(torch.where(mask[None, None, :, :, None], diff,
                                  -torch.inf).float())
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)[..., None]
    dxdt = torch.einsum("bcijh,bcihp->bcjhp", cb * decay, dyc) + \
        rem[..., None] * torch.einsum("bcjn,bchpn->bcjhp", bc, dh_out)
    pd = torch.einsum("bcihp,bcjhp->bcijh", dyc, xdt) * decay
    m = (pd * cb).double()
    dc_state = eseg[..., None] * torch.einsum("bcihp,bchpn->bcihn", dyc,
                                              h_in)
    db_state = rem[..., None] * torch.einsum("bcjhp,bchpn->bcjhn", xdt,
                                             dh_out)
    dch = torch.einsum("bcijh,bcjn->bcihn", pd, bc) + dc_state
    dbh = torch.einsum("bcijh,bcin->bcjhn", pd, cc) + db_state
    carried = (dc_state * cc[:, :, :, None]).sum(-1)           # (B,NC,q,H)
    u = (db_state * bc[:, :, :, None]).sum(-1).double()
    ends = (torch.exp(totals)[..., None, None] * dh_out * h_in).sum((-2, -1))
    dda = (m.sum(3) - m.sum(2) + carried.double()).flip(2).cumsum(2) \
        .flip(2) + u.cumsum(2) - u + ends.double()[:, :, None]  # d(dt a)
    a = -torch.exp(a_log.float())
    ddt = (dxdt * xc).sum(-1) + dda.float() * a
    da_log = (dda * dtc.double() * a.double()).sum((0, 1, 2))
    return (_unchunked(dxdt * dtc[..., None], s).to(x.dtype),
            _unchunked(ddt, s).to(dt.dtype), da_log.to(a_log.dtype),
            _unchunked(dbh.sum(3), s).to(b.dtype),
            _unchunked(dch.sum(3), s).to(c.dtype))
