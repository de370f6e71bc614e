"""Plain version of the SSD scan: the naive step-by-step SSM recurrence.

Counterpart of ``repro.kernels.ssd.ref.ssd_ref``; it also returns the final
state, which the CUDA kernel writes too.
"""
from __future__ import annotations

import torch


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
