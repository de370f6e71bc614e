"""The paper's evaluation applications, in plain PyTorch (§7).

Counterpart of ``repro.apps.paper_apps``. CG (conjugate gradient on a 2D
Laplacian), Jacobi (5-point stencil), N-body (all-pairs gravity) and
Flexible Sleep (the synthetic overhead probe). Each is an iterative kernel
whose state is a flat tree (dicts, or the :func:`tree_node` dataclass
``CGState``) shardable over the ``data`` axis — i.e. each is a *malleable
job*: the DMR runtime can resize it and :func:`repro_torch.core.reshard.
reshard` its state exactly like an LM TrainState.

The reference computes them with XLA outside any Pallas kernel; here they
are fp32 tensor code on an explicit device, the initial state drawn from
an explicit ``torch.Generator`` on that device. ``calibrate()`` measures
per-iteration wall time, the device synchronised after each step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sharding import NamedSharding, PartitionSpec
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.layers import tree_map, tree_node


def _generator(seed: int, device, generator: Optional[torch.Generator]
               ) -> Tuple[torch.device, torch.Generator]:
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return dev, generator


def _normal(shape, generator: torch.Generator, dev: torch.device):
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(dev)


def _neighbours(x):
    """The (N, N) grid's up, down, left and right neighbours, zero past the
    boundary."""
    up = F.pad(x[:-1, :], (0, 0, 1, 0))
    dn = F.pad(x[1:, :], (0, 0, 0, 1))
    lf = F.pad(x[:, :-1], (1, 0, 0, 0))
    rt = F.pad(x[:, 1:], (0, 1, 0, 0))
    return up, dn, lf, rt


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


# -- Conjugate Gradient (2D Laplacian, matrix-free) ---------------------------


def laplacian_matvec(x):
    """5-point stencil matvec on an (N, N) grid with zero boundaries."""
    up, dn, lf, rt = _neighbours(x)
    return 4.0 * x - up - dn - lf - rt


@tree_node
@dataclasses.dataclass
class CGState:
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rs: torch.Tensor


def cg_init(n: int, generator: Optional[torch.Generator] = None,
            device=DEFAULT_DEVICE) -> CGState:
    dev, gen = _generator(0, device, generator)
    b = _normal((n, n), gen, dev)
    x = torch.zeros((n, n), dtype=torch.float32, device=dev)
    r = b - laplacian_matvec(x)
    return CGState(x=x, r=r, p=r, rs=_dot(r, r))


def cg_step(s: CGState) -> CGState:
    ap = laplacian_matvec(s.p)
    alpha = s.rs / _dot(s.p, ap)
    x = s.x + alpha * s.p
    r = s.r - alpha * ap
    rs_new = _dot(r, r)
    p = r + (rs_new / s.rs) * s.p
    return CGState(x=x, r=r, p=p, rs=rs_new)


# -- Jacobi (5-point stencil relaxation) ----------------------------------------


def jacobi_init(n: int, generator: Optional[torch.Generator] = None,
                device=DEFAULT_DEVICE):
    dev, gen = _generator(1, device, generator)
    grid = _normal((n, n), gen, dev)
    rhs = _normal((n, n), gen, dev)
    return {"grid": grid, "rhs": rhs}


def jacobi_step(s):
    up, dn, lf, rt = _neighbours(s["grid"])
    return {"grid": 0.25 * (up + dn + lf + rt + s["rhs"]), "rhs": s["rhs"]}


# -- N-body (all-pairs gravity) ---------------------------------------------------


def nbody_init(n: int, generator: Optional[torch.Generator] = None,
               device=DEFAULT_DEVICE):
    dev, gen = _generator(2, device, generator)
    pos = _normal((n, 3), gen, dev)
    vel = _normal((n, 3), gen, dev) * 0.01
    mass = F.softplus(_normal((n,), gen, dev)) + 0.1
    return {"pos": pos, "vel": vel, "mass": mass}


def nbody_step(s, dt: float = 0.01, eps: float = 1e-2):
    d = s["pos"][None, :, :] - s["pos"][:, None, :]          # (N,N,3)
    r2 = torch.sum(d * d, dim=-1) + eps
    # the pair with itself: r2 == eps, no force
    inv_r3 = torch.where(r2 > eps, r2 ** -1.5, 0.0)
    acc = torch.einsum("ijk,ij,j->ik", d, inv_r3, s["mass"])
    vel = s["vel"] + dt * acc
    return {"pos": s["pos"] + dt * vel, "vel": vel, "mass": s["mass"]}


# -- Flexible Sleep (the synthetic overhead probe, §7.3) --------------------------


@dataclasses.dataclass
class FlexibleSleep:
    """Holds ``nbytes`` of state and 'computes' by sleeping — isolating the
    framework's reconfiguration cost from application compute (Fig. 3)."""

    nbytes: int = 1 << 30
    step_s: float = 1.0

    def init(self, device=DEFAULT_DEVICE):
        n = self.nbytes // 4
        return {"data": torch.zeros((n,), dtype=torch.float32,
                                    device=resolve_device(device))}

    def step(self, state):
        time.sleep(self.step_s)
        return state


APPS = {
    "cg": (cg_init, cg_step),
    "jacobi": (jacobi_init, jacobi_step),
    "nbody": (nbody_init, nbody_step),
}


def data_shardings(state, mesh):
    """Every leaf of an app's state cut along its first axis over the
    mesh's ``data`` slices (CG's ``rs``, a scalar, replicated): the
    NamedShardings :func:`~repro_torch.core.sharding.place` and
    :func:`~repro_torch.core.reshard.reshard` take."""
    return tree_map(lambda x: NamedSharding(
        mesh, PartitionSpec("data") if x.dim() else PartitionSpec()), state)


def calibrate(app: str, n: int, iters: int = 10,
              device=DEFAULT_DEVICE) -> Tuple[float, float]:
    """Measured per-iteration seconds (mean, std) on ``device``, which is
    synchronised after each step (the reference's ``block_until_ready``)."""
    init, step = APPS[app]
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    s = step(init(n, device=dev))
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        s = step(s)
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.mean(times)), float(np.std(times))
