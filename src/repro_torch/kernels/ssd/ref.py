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
the gradients of the chunked algorithm, pass by pass as its bf16 route runs
them (one pass per chunk walks the heads and sums dB and dC over them). Its
yardstick is torch autograd of ``ssd_ref`` (tests) or of the model's
``ssd_chunked``.
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
    the backward kernel's passes (its bf16 route's), in fp32 with fp64 sums
    where they cancel:

    1. each chunk's own share of the gradient of its incoming state,
       Sd = sum_i exp(seg_i) dy_i (x) C_i;
    2. in reverse over the chunks, dh_out[c] = dh_in[c + 1] (dh_final for
       the last), dh_in[c] = exp(seg_last) dh_out[c] + Sd[c];
    3. per (batch, chunk), S = C B^T once (B and C are shared by the heads),
       then head by head, in order. First the state terms: dC_h =
       exp(seg) dy h_in (its row dots with C are the carried term),
       dB_h = exp(seg_last - seg) (x dt) dh_out (its row dots with B are
       u), d(x dt) = exp(seg_last - seg) B dh_out^T, and exp(seg_last)
       dh_out . h_in. Then the triangles, with L = exp(seg_i - seg_j) on
       j <= i, G = S L and PD = (dy (x dt)^T) L: d(x dt) += G^T dy,
       dB_h += PD^T C, dC_h += PD B, and M = PD S's row sums less its
       column sums (fp64). dB and dC add dB_h and dC_h in head order.
       d(dt a)_k sums what each exponent gives: the pairs i >= k > j of M
       (M's row less column sums plus the carried term, over i >= k), the
       chunk state's term exp(seg_last) dh_out . h_in, and u over j < k.
       ddt = d(x dt) . x + d(dt a) a;
    4. da_log = sum over the chunks of d(dt a) dt a.

    Outputs take their inputs' dtypes."""
    bsz, s, h, p = x.shape
    q = min(chunk, s, MAX_CHUNK)
    seg = _segments(dt, a_log, q)                              # (B,NC,q,H)
    total = seg[:, :, -1]
    states, totals = chunk_states(x, dt, a_log, b, q)
    h_in, h_final = state_passing(states, totals)
    xc, dtc = _chunked(x.float(), q), _chunked(dt.float(), q)
    bc, cc = _chunked(b.float(), q), _chunked(c.float(), q)
    dyc = _chunked(dy.float(), q)
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
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)               # S = C B^T
    db_sum, dc_sum = torch.zeros_like(bc), torch.zeros_like(cc)
    dxdts, ddas = [], []
    for hh in range(h):
        sg, r, e = seg[..., hh], rem[..., hh, None], eseg[..., hh, None]
        xdt = xc[:, :, :, hh] * dtc[:, :, :, hh, None]         # (B,NC,q,P)
        dyh = dyc[:, :, :, hh]
        hin, dho = h_in[:, :, hh], dh_out[:, :, hh]            # (B,NC,P,N)
        dch = e * torch.einsum("bcip,bcpn->bcin", dyh, hin)
        carried = (dch * cc).sum(-1)
        dbh = r * torch.einsum("bcjp,bcpn->bcjn", xdt, dho)
        u = (dbh * bc).sum(-1).double()
        dxdt = r * torch.einsum("bcjn,bcpn->bcjp", bc, dho)
        ends = torch.exp(totals[..., hh]) * (dho * hin).sum((-2, -1))
        decay = torch.exp(torch.where(
            mask, sg[:, :, :, None] - sg[:, :, None, :], -torch.inf).float())
        pd = torch.einsum("bcip,bcjp->bcij", dyh, xdt) * decay
        dxdt = dxdt + torch.einsum("bcij,bcip->bcjp", cb * decay, dyh)
        dbh = dbh + torch.einsum("bcij,bcin->bcjn", pd, cc)
        dch = dch + torch.einsum("bcij,bcjn->bcin", pd, bc)
        m = (pd * cb).double()
        v = m.sum(3) - m.sum(2) + carried.double()
        ddas.append(v.flip(2).cumsum(2).flip(2) + u.cumsum(2) - u
                    + ends.double()[..., None])                # d(dt a)
        dxdts.append(dxdt)
        db_sum, dc_sum = db_sum + dbh, dc_sum + dch
    dxdt, dda = torch.stack(dxdts, dim=3), torch.stack(ddas, dim=3)
    a = -torch.exp(a_log.float())
    ddt = (dxdt * xc).sum(-1) + dda.float() * a
    # pass 4
    da_log = (dda * dtc.double() * a.double()).sum((0, 1, 2))
    return (_unchunked(dxdt * dtc[..., None], s).to(x.dtype),
            _unchunked(ddt, s).to(dt.dtype), da_log.to(a_log.dtype),
            _unchunked(db_sum, s).to(b.dtype),
            _unchunked(dc_sum, s).to(c.dtype))
