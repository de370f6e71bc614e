"""The plain reference of the benchmark's training cells, and its control.

Plain PyTorch, written from the published architectures and imported by
nothing of the program: a decoder of pre-norm blocks with grouped-query
causal attention (RoPE, half split) and a SiLU-gated MLP (the ``dense``
family: granite-3-2b as the port runs it), or of Mamba-2 SSD mixers (the
``ssm`` family: a causal depthwise conv, the scan h_t = exp(dt_t A) h_{t-1}
+ dt_t B_t x_t, y_t = C_t h_t + D x_t, a gated RMSNorm over the inner width;
one group of B and C shared by the heads), both with a tied unembedding and
the mean next-token cross-entropy; AdamW with a linear warmup and a cosine,
clipping by the global norm and decoupled weight decay on every stored
tensor of two or more dimensions. Norm scales are zero-centred (x * (1 +
scale)), as the port stores them.

``precision="fp32"`` is the reference: float32 throughout, TF32 off.
``precision="fp8"`` is the control, the step below the bf16 compute the
configurations state: the same computed in float8 wherever the program
computes in bf16: both operands of every matrix product, the projections'
and the logits' outputs, the norms', convolution's, gates' and scan's
outputs and the residual stream (not the attention's scores, the scan's
internals nor dt, which the program keeps in fp32); each tensor rounded to
e4m3 forward and its gradient to e5m2, scaled by its largest magnitude.

The layer loops run each layer under ``torch.utils.checkpoint`` and the
cross-entropy by chunks, so that the reference fits beside nothing else on
the card at the cells' own sizes.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

STACKED = "blocks/"


class _FP8(torch.autograd.Function):
    """Rounds a tensor to float8: e4m3 forward, its gradient e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def _round8(x, dtype, top):
    scale = top / x.detach().abs().amax().float().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32 (not TF32) for the block's length."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def layout(m: dict) -> Dict[str, tuple]:
    """Every parameter of the model ``m`` (the port's config fields), by
    path: (shape, how it is drawn). Layers are stacked on a leading axis
    under ``blocks/p0/``. The ``dense`` family: a matrix normal with std 1
    / sqrt(what one layer's product sums over) (the embedding: 1 /
    sqrt(vocab)), norms at 0 (x * (1 + 0)). The ``ssm`` family: the
    published Mamba-2 initialisation (mamba_ssm: the embedding std 0.02;
    linear layers at PyTorch's default, std 1 / sqrt(3 fan-in), the output
    projection divided by sqrt(layers); the conv's weight and bias as
    PyTorch's Conv1d draws them; A uniform in [1, 16]; dt log-uniform in
    [0.001, 0.1] through the inverse softplus; D at 1), each drawn as a
    normal of the same std where the original is uniform."""
    d, L, V = m["d_model"], m["num_layers"], m["vocab_size"]

    def normal(fan, scale=1.0):
        return ("normal", scale / math.sqrt(fan))
    zeros, ones = ("zeros", None), ("ones", None)
    if m["family"] == "dense":
        h, kv = m["num_heads"], m["num_kv_heads"]
        hd = m["head_dim"] or d // h
        f = m["d_ff"]
        embed = normal(V)
        blk = {"ln1": ((d,), zeros),
               "attn/wq": ((d, h, hd), normal(d)),
               "attn/wk": ((d, kv, hd), normal(d)),
               "attn/wv": ((d, kv, hd), normal(d)),
               "attn/wo": ((h, hd, d), normal(h * hd)),
               "ln2": ((d,), zeros),
               "ffn/w_gate": ((d, f), normal(d)),
               "ffn/w_up": ((d, f), normal(d)),
               "ffn/w_down": ((f, d), normal(f))}
    elif m["family"] == "ssm":
        di = m["ssm_expand"] * d
        n, k = m["ssm_state"], m["conv_width"]
        heads = di // m["ssm_head_dim"]
        embed = ("normal", 0.02)
        third = 1 / math.sqrt(3)
        mix = {"in_proj": normal(d, third), "conv_w": normal(k, third),
               "conv_b": normal(k, third), "A_log": ("a_log", (1, 16)),
               "dt_bias": ("dt_bias", (1e-3, 1e-1)),
               "out_proj": normal(di, third / math.sqrt(L))}
        blk = {"ln1": ((d,), zeros),
               "mixer/in_proj": ((d, 2 * di + 2 * n + heads), mix["in_proj"]),
               "mixer/conv_w": ((k, di + 2 * n), mix["conv_w"]),
               "mixer/conv_b": ((di + 2 * n,), mix["conv_b"]),
               "mixer/A_log": ((heads,), mix["A_log"]),
               "mixer/D": ((heads,), ones),
               "mixer/dt_bias": ((heads,), mix["dt_bias"]),
               "mixer/norm": ((di,), zeros),
               "mixer/out_proj": ((di, d), mix["out_proj"])}
    else:
        raise ValueError(f"no reference for family {m['family']!r}")
    out = {"embed/tokens": ((V, d), embed)}
    for name, (shape, how) in blk.items():
        out[STACKED + "p0/" + name] = ((L, *shape), how)
    out["final_norm"] = ((d,), zeros)
    return out


def leaf_seed(seed: int, i: int) -> int:
    """The generator seed of parameter ``i`` under run seed ``seed``."""
    a, b = np.random.SeedSequence([int(seed), 1, i]).generate_state(
        2, dtype=np.uint32)
    return int(a) << 32 | int(b)


def draw_leaf(m: dict, seed: int, path: str, device) -> torch.Tensor:
    """One parameter of ``layout(m)``, fp32, drawn from ``seed`` on
    ``device`` in one call (every layer of a stacked leaf at once)."""
    leaves = layout(m)
    shape, (kind, arg) = leaves[path]
    if kind == "zeros":
        return torch.zeros(shape, device=device)
    if kind == "ones":
        return torch.ones(shape, device=device)
    gen = torch.Generator(device=device).manual_seed(
        leaf_seed(seed, list(leaves).index(path)))
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=device).mul_(arg)
    u = torch.rand(shape, generator=gen, device=device)
    lo, hi = arg
    if kind == "a_log":
        return torch.log(lo + (hi - lo) * u)
    if kind == "dt_bias":
        dt = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
        dt = dt.clamp_min(1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(f"unknown init {kind!r}")


def draw(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of ``layout(m)`` by path (``draw_leaf``)."""
    return {p: draw_leaf(m, seed, p, device) for p in layout(m)}


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """{"a/b/c": t} as {"a": {"b": {"c": t}}}."""
    out: dict = {}
    for path, t in flat.items():
        node = out
        *inner, last = path.split("/")
        for k in inner:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def leaf_norms(path: str, t: torch.Tensor) -> Dict[str, float]:
    """The norm of each leaf of the model in ``t``: one a layer of a
    stacked parameter, named ``path[layer]``."""
    t = t.detach().float()
    if path.startswith(STACKED):
        return {f"{path}[{i}]": float(v)
                for i, v in enumerate(t.flatten(1).norm(dim=1).tolist())}
    return {path: float(t.norm())}


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, theta):
    """Half-split rotary embedding of x (B, S, heads, D), positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                    device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Reference:
    """The model ``m`` (the port's config fields) trained by ``train``
    (AdamW's settings), in ``precision``."""

    Q_BLOCK, CE_CHUNK, SSD_CHUNK = 512, 256, 128

    def __init__(self, m: dict, train: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(precision)
        self.m, self.train, self.precision = m, train, precision
        self.paths = list(layout(m))
        self.block_paths = [p for p in self.paths if p.startswith(STACKED)]

    # -- products -------------------------------------------------------------

    def mm(self, eq: str, a, b, out8: bool = False):
        """A product; in the control, of float8 operands, its output
        rounded too where ``out8`` (the program keeps it in bf16)."""
        if self.precision != "fp8":
            return torch.einsum(eq, a, b)
        out = torch.einsum(eq, _FP8.apply(a), _FP8.apply(b))
        return _FP8.apply(out) if out8 else out

    def act(self, x):
        """The residual stream as the program holds it (the control's in
        float8)."""
        return _FP8.apply(x) if self.precision == "fp8" else x

    # -- the dense block ------------------------------------------------------

    def attention(self, q, k, v):
        """Causal attention of q (B, S, H, D) over k, v (B, S, KV, D), query
        head h reading KV head h // (H / KV), by blocks of queries."""
        h, kv = q.shape[2], k.shape[2]
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
        s, scale = q.shape[1], 1.0 / math.sqrt(q.shape[-1])
        outs = []
        for lo in range(0, s, self.Q_BLOCK):
            hi = min(lo + self.Q_BLOCK, s)
            sc = self.mm("bqhd,bkhd->bhqk", q[:, lo:hi], k[:, :hi]) * scale
            keep = (torch.arange(hi, device=q.device)[None, :]
                    <= torch.arange(lo, hi, device=q.device)[:, None])
            p = torch.softmax(sc.masked_fill(~keep, -math.inf), dim=-1)
            outs.append(self.mm("bhqk,bkhd->bqhd", p, v[:, :hi]))
        return torch.cat(outs, dim=1)

    def dense_layer(self, x, ln1, wq, wk, wv, wo, ln2, wg, wu, wd):
        m, eps, a = self.m, self.m["norm_eps"], self.act
        h = a(rms_norm(x, ln1, eps))
        q = a(rope(self.mm("bse,ehd->bshd", h, wq, True), m["rope_theta"]))
        k = a(rope(self.mm("bse,ehd->bshd", h, wk, True), m["rope_theta"]))
        v = self.mm("bse,ehd->bshd", h, wv, True)
        o = a(self.attention(q, k, v))
        x = a(x + self.mm("bshd,hde->bse", o, wo, True))
        h = a(rms_norm(x, ln2, eps))
        g = a(a(F.silu(self.mm("bse,ef->bsf", h, wg, True)))
              * self.mm("bse,ef->bsf", h, wu, True))
        return x + self.mm("bsf,fe->bse", g, wd, True)

    # -- the SSD block --------------------------------------------------------

    def ssd(self, x, dt, a, bm, cm):
        """The scan over x (B, S, H, P), dt (B, S, H), a (H,) (negative),
        B and C (B, S, N), zero initial state, by chunks: within a chunk
        the quadratic form, across chunks the carried state."""
        b, s, h, p = x.shape
        n = bm.shape[-1]
        q = min(self.SSD_CHUNK, s)
        if s % q:
            raise ValueError(f"sequence {s} is not a multiple of {q}")
        c = s // q
        da = (dt * a).reshape(b, c, q, h)
        xdt = (x * dt[..., None]).reshape(b, c, q, h, p)
        bc, cc = bm.reshape(b, c, q, n), cm.reshape(b, c, q, n)
        acs = torch.cumsum(da.double(), dim=2)                 # (b,c,q,h)
        tril = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]   # (b,c,i,j,h)
        decay = torch.exp(seg.masked_fill(~tril[:, :, None], -math.inf)
                          .float())
        cb = self.mm("bcin,bcjn->bcij", cc, bc)
        y = self.mm("bcijh,bcjhp->bcihp", cb[..., None] * decay, xdt)
        last = acs[:, :, -1:, :]
        to_end = torch.exp((last - acs).float())[..., None]
        states = self.mm("bcjn,bcjhp->bchpn", bc, xdt * to_end)
        across = torch.exp(last[:, :, 0].float())              # (b,c,h)
        carried, hcur = [], torch.zeros_like(states[:, 0])
        for ci in range(c):
            carried.append(hcur)
            hcur = hcur * across[:, ci, :, None, None] + states[:, ci]
        carried = torch.stack(carried, dim=1)                  # (b,c,h,p,n)
        y = y + self.mm("bcin,bchpn->bcihp", cc, carried) \
            * torch.exp(acs.float())[..., None]
        return y.reshape(b, s, h, p)

    def ssm_layer(self, x, ln1, in_proj, conv_w, conv_b, a_log, dskip,
                  dt_bias, norm, out_proj):
        m, eps, a = self.m, self.m["norm_eps"], self.act
        di = m["ssm_expand"] * m["d_model"]
        n, p = m["ssm_state"], m["ssm_head_dim"]
        heads = di // p
        h = a(rms_norm(x, ln1, eps))
        z, xbc, dt = torch.split(self.mm("bse,ef->bsf", h, in_proj, True),
                                 [di, di + 2 * n, heads], dim=-1)
        k, s = conv_w.shape[0], x.shape[1]
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        conv = a(sum(pad[:, i:i + s] * conv_w[i] for i in range(k)))
        xs, bm, cm = torch.split(a(F.silu(conv + conv_b)), [di, n, n],
                                 dim=-1)
        xh = xs.reshape(*xs.shape[:2], heads, p)
        dt = F.softplus(dt + dt_bias)
        y = a(self.ssd(xh, dt, -torch.exp(a_log), bm, cm))
        y = a(y + xh * dskip[:, None]).reshape(*xs.shape)
        y = a(rms_norm(a(y * a(F.silu(z))), norm, eps))
        return x + self.mm("bsf,fe->bse", y, out_proj, True)

    # -- the loss -------------------------------------------------------------

    def nll(self, x, labels, table):
        logits = self.mm("bse,ve->bsv", x, table, True)
        logp = torch.log_softmax(logits, dim=-1)
        keep = labels >= 0
        ll = logp.gather(-1, labels.clamp_min(0).long()[..., None])[..., 0]
        return -(ll * keep).sum()

    def loss(self, p: Dict[str, torch.Tensor], tokens, labels):
        """The mean cross-entropy of the next tokens ``labels`` (-1: none)
        after ``tokens``, fp32."""
        layer = (self.dense_layer if self.m["family"] == "dense"
                 else self.ssm_layer)
        x = self.act(p["embed/tokens"][tokens.long()])
        for i in range(self.m["num_layers"]):
            x = self.act(checkpoint(layer, x,
                                    *[p[k][i] for k in self.block_paths],
                                    use_reentrant=False))
        x = self.act(rms_norm(x, p["final_norm"], self.m["norm_eps"]))
        c = self.CE_CHUNK
        total = sum(checkpoint(self.nll, x[:, i:i + c], labels[:, i:i + c],
                               p["embed/tokens"], use_reentrant=False)
                    for i in range(0, x.shape[1], c))
        return total / (labels >= 0).sum().clamp_min(1)

    # -- AdamW ----------------------------------------------------------------

    def lr(self, t: int) -> float:
        o = self.train
        warm = min(t / max(o["warmup_steps"], 1), 1.0)
        frac = min(max((t - o["warmup_steps"])
                       / max(o["total_steps"] - o["warmup_steps"], 1), 0.0),
                   1.0)
        cos = 0.5 * (1 + math.cos(math.pi * frac))
        return o["lr"] * warm * (o["min_lr_ratio"]
                                 + (1 - o["min_lr_ratio"]) * cos)

    def run(self, initial: Callable[[str], torch.Tensor], batches: List[dict],
            device) -> dict:
        """Train from the parameters ``initial(path)`` for one step a batch
        of ``batches`` ({"tokens", "labels"}). Returns each step's loss, the
        first step's gradient as AdamW takes it (clipped) and before
        clipping, the first gradient's global norm before clipping
        (``grad_norm``), and the change of the parameters after the last step,
        each as leaf_norms."""
        o = self.train
        b1, b2 = o["beta1"], o["beta2"]
        p = {k: initial(k).requires_grad_(True) for k in self.paths}
        mu = {k: torch.zeros_like(v) for k, v in p.items()}
        nu = {k: torch.zeros_like(v) for k, v in p.items()}
        out = {"losses": [], "grad": {}, "grad_raw": {}, "change": {}}
        with no_tf32():
            for t, batch in enumerate(batches, start=1):
                loss = self.loss(p, batch["tokens"].to(device),
                                 batch["labels"].to(device))
                loss.backward()
                out["losses"].append(loss.item())
                with torch.no_grad():
                    gnorm = torch.sqrt(sum(v.grad.square().sum()
                                           for v in p.values()))
                    scale = 1.0 if o["clip_norm"] is None else torch.clamp(
                        o["clip_norm"] / (gnorm + 1e-9), max=1.0)
                    lr, c1, c2 = self.lr(t), 1 - b1 ** t, 1 - b2 ** t
                    if t == 1:
                        out["grad_norm"] = float(gnorm)
                    for k, v in p.items():
                        g = v.grad * scale
                        if t == 1:
                            out["grad"].update(leaf_norms(k, g))
                            out["grad_raw"].update(leaf_norms(k, v.grad))
                        mu[k].mul_(b1).add_(g, alpha=1 - b1)
                        nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                        u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + o["eps"])
                        if v.ndim >= 2:
                            u = u + o["weight_decay"] * v
                        v.sub_(lr * u)
                        v.grad = None
            del mu, nu
            with torch.no_grad():
                for k in self.paths:
                    out["change"].update(leaf_norms(
                        k, p.pop(k).detach() - initial(k)))
        return out
