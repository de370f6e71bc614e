"""Measurement harness: time real reshards between slice counts.

Counterpart of ``repro.calib.measure``. Two backends:

- ``torch`` — the *real* path, in place of the reference's ``jax``: for
  each grid geometry ``(p, q)`` a float32 array of ``data_bytes`` is laid
  out with ``PartitionSpec("data")`` over a ``p``-slice mesh and moved by
  the port's own :func:`~repro_torch.core.reshard.reshard` onto
  :func:`~repro_torch.core.meshes.resized_mesh` of ``q`` slices, so the
  blocks kept in place are the Listing-3 plans' local transfers and every
  other block is a copy (on a card, all of a resize's copies in one launch
  of the box-copy kernel). Slices are
  :func:`~repro_torch.core.meshes.slice_devices` of one device (virtual
  slices of the card, or of the CPU), so every geometry of the grid, up to
  64 slices, runs for real and no link proxy is needed. Each resize is
  also checked before it is timed: the data comes back bit-equal, and the
  transfers the reshard reports carry the plan's non-local bytes.
  ``migrate_slice`` (the straggler path) is timed the same way, and RMS
  scheduling latency is sampled from real ``ReconfigPolicy.decide``
  calls: one warm-up, then the best of ``repeats``.

- ``plan`` — the *deterministic* backend behind the committed golden
  artifact, copied as it is: samples are generated from hidden "ground
  truth" parameters (:data:`TRUE_PARAMS`) plus seeded multiplicative
  noise, with the reference's draws in the reference's order, so both
  packages write the same bytes. Artifacts are labelled with their
  backend, so a ``plan`` calibration can never masquerade as a measurement.

CLI::

    PYTHONPATH=src python -m repro_torch.calib --backend plan \\
        [--out calib.json] [--check tests/data/golden_calibration.json]
    PYTHONPATH=src python -m repro_torch.calib --backend torch [--quick] \\
        [--device cpu] [--out calib.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.calib.artifact import SAMPLE_DIGITS
from repro_torch.device import DEFAULT_DEVICE

MiB = 1024 ** 2
GiB = 1024 ** 3

#: The CI grid: factor-2 geometries across the Fig. 3 x-axis and three data
#: sizes.  ``(p, q)`` with ``q > p`` is an expand; every geometry is also
#: measured in the shrink direction ``(q, p)``.
CI_GEOMETRIES: Tuple[Tuple[int, int], ...] = (
    (1, 2), (2, 4), (4, 8), (8, 16), (16, 32), (32, 64))
CI_DATA_BYTES: Tuple[int, ...] = (64 * MiB, 256 * MiB, GiB)
CI_SCHED_NODES: Tuple[int, ...] = (2, 4, 8, 16, 32, 64)

#: Hidden ground truth of the ``plan`` backend — what the fitter must
#: recover.  Deliberately off the paper-fit constants so a fit that just
#: echoes the defaults fails the recovery test.
TRUE_PARAMS: Dict[str, float] = {
    "link_bw": 4.6e9, "spawn_s": 0.055, "shrink_sync_s": 0.0045,
    "sched_base_s": 0.38, "sched_per_node_s": 0.0028,
}
#: Multiplicative log-normal noise sigma of the ``plan`` backend.
PLAN_NOISE_SIGMA = 0.03


@dataclasses.dataclass(frozen=True)
class MeasureConfig:
    """One measurement campaign: geometries × data sizes (+ sched nodes)."""
    geometries: Tuple[Tuple[int, int], ...] = CI_GEOMETRIES
    data_bytes: Tuple[int, ...] = CI_DATA_BYTES
    sched_nodes: Tuple[int, ...] = CI_SCHED_NODES
    repeats: int = 3
    seed: int = 2026
    backend: str = "plan"            # "plan" | "torch"

    def grid_doc(self) -> Dict[str, object]:
        return {"geometries": [list(g) for g in self.geometries],
                "data_bytes": list(self.data_bytes),
                "sched_nodes": list(self.sched_nodes),
                "repeats": self.repeats, "seed": self.seed}


def _sample(kind: str, old: int, new: int, nbytes: int,
            participants: int, busiest: int, seconds: float
            ) -> Dict[str, object]:
    return {"kind": kind, "old": old, "new": new, "bytes": nbytes,
            "participants": participants, "busiest_bytes": busiest,
            "seconds": round(seconds, SAMPLE_DIGITS)}


def resize_features(kind: str, p: int, q: int, nbytes: int
                    ) -> Tuple[int, int]:
    """``(participants, busiest_bytes)`` of the (p → q, nbytes) plan."""
    from repro_torch.core.redistribute import (expand_plan, plan_stats,
                                               shrink_plan)
    plan = expand_plan(p, q, nbytes) if kind == "expand" else \
        shrink_plan(p, q, nbytes)
    return plan_stats(plan)


# ---------------------------------------------------------------------------
# plan backend — deterministic synthetic measurement
# ---------------------------------------------------------------------------

def _measure_plan(config: MeasureConfig
                  ) -> Tuple[List[Dict[str, object]], Dict[str, object]]:
    rng = np.random.default_rng(config.seed)
    tp = TRUE_PARAMS
    samples: List[Dict[str, object]] = []

    def noisy(t: float) -> float:
        return t * float(np.exp(PLAN_NOISE_SIGMA * rng.standard_normal()))

    for p, q in config.geometries:
        for nbytes in config.data_bytes:
            for kind, a, b in (("expand", p, q), ("shrink", q, p)):
                parts, busiest = resize_features(kind, a, b, nbytes)
                sync = tp["shrink_sync_s"] if kind == "shrink" else 0.0
                true_t = (tp["spawn_s"] + busiest / tp["link_bw"]
                          + sync * parts)
                for _ in range(config.repeats):
                    samples.append(_sample(kind, a, b, nbytes, parts,
                                           busiest, noisy(true_t)))
    for nodes in config.sched_nodes:
        true_t = tp["sched_base_s"] + tp["sched_per_node_s"] * nodes
        for _ in range(config.repeats):
            samples.append(_sample("sched", nodes, nodes, 0, nodes, 0,
                                   noisy(true_t)))
    env = {"backend": "plan", "noise_sigma": PLAN_NOISE_SIGMA,
           "true_params": dict(TRUE_PARAMS)}
    return samples, env


# ---------------------------------------------------------------------------
# torch backend — the port's reshard between virtual slices of one device
# ---------------------------------------------------------------------------

def _best_of(timed, repeats: int) -> float:
    """kernel_bench-style timing: one warm-up call, then best of N.
    ``timed()`` returns ``(result, seconds)`` as
    :func:`~repro_torch.core.reshard.timed_reshard` does, the devices
    synchronised before each clock reading."""
    timed()
    return min(timed()[1] for _ in range(max(repeats, 1)))


def _elems_for(nbytes: int, slices: int) -> int:
    """float32 element count ≈ nbytes, divisible by the slice count."""
    per_slice = max(nbytes // 4 // slices, 1)
    return per_slice * slices


def _placed(elems: int, mesh):
    """``elems`` float32 values laid out over ``mesh``'s slices, each
    element's bits distinct (the int32 counter viewed as float32: small
    positive finite numbers), so a block put in the wrong place shows."""
    import torch

    from repro_torch.core.sharding import NamedSharding, PartitionSpec, place
    dev = mesh.device(mesh.coords()[0])
    bits = torch.arange(elems, dtype=torch.int32, device=dev)
    return place(bits.view(torch.float32),
                 NamedSharding(mesh, PartitionSpec("data")))


def _same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _check_resize(kind: str, x, sh, nbytes: int) -> None:
    """One untimed reshard of ``x`` onto ``sh``: the data must come back
    bit-equal, and the transfers it reports must carry the plan's
    participants, busiest-link bytes and non-local bytes."""
    from repro_torch.core.redistribute import (expand_plan, plan_stats,
                                               shrink_plan)
    from repro_torch.core.reshard import reshard
    from repro_torch.core.sharding import gather

    p = len(x.shards)
    q = len(sh.mesh.coords())
    moved = []
    y = reshard(x, sh, transfers=moved)
    if not _same_bits(gather(y), gather(x)):
        raise RuntimeError(f"{kind} {p} -> {q} of {nbytes} bytes changed "
                           f"the data")
    plan = (expand_plan if kind == "expand" else shrink_plan)(p, q,
                                                              x.nbytes)
    want = (plan_stats(plan), sum(t.nbytes for t in plan if not t.local))
    got = (plan_stats(moved), sum(t.nbytes for t in moved if not t.local))
    if got != want:
        raise RuntimeError(f"{kind} {p} -> {q} of {nbytes} bytes moved "
                           f"(participants, busiest), non-local bytes "
                           f"{got}, the plan {want}")


def _measure_resize_torch(kind: str, p: int, q: int, nbytes: int,
                          repeats: int, device) -> float:
    """Time the port's reshard of a p-slice array onto a q-slice mesh."""
    from repro_torch.core.meshes import make_mesh, resized_mesh, \
        slice_devices
    from repro_torch.core.reshard import timed_reshard
    from repro_torch.core.sharding import NamedSharding, PartitionSpec

    devices = slice_devices(max(p, q), device)
    old = make_mesh(p, 1, devices=devices)
    new = NamedSharding(resized_mesh(old, q, devices=devices),
                        PartitionSpec("data"))
    x = _placed(_elems_for(nbytes, max(p, q)), old)
    _check_resize(kind, x, new, nbytes)
    return _best_of(lambda: timed_reshard(x, new), repeats)


def _measure_migrate_torch(slices: int, nbytes: int, repeats: int,
                           device) -> float:
    from repro_torch.core.meshes import make_mesh, slice_devices
    from repro_torch.core.redistribute import migrate_slice
    from repro_torch.core.reshard import timed_reshard

    mesh = make_mesh(slices, 1, devices=slice_devices(slices, device))
    x = _placed(_elems_for(nbytes, slices), mesh)
    return _best_of(lambda: timed_reshard(
        x, mesh, impl=lambda s, m: migrate_slice(s, m, 0, slices - 1)),
        repeats)


def _measure_sched(nodes: int, repeats: int) -> float:
    """Real in-process RMS policy latency (the measured part of Fig. 3a)."""
    from repro_torch.rms.cluster import Cluster
    from repro_torch.rms.job import Job, JobState
    from repro_torch.rms.policy import ReconfigPolicy

    pol = ReconfigPolicy()
    cluster = Cluster(2 * nodes)
    job = Job(job_id=0, app="fs", submit_time=0, work=2, min_nodes=1,
              max_nodes=2 * nodes, preferred=None, requested_nodes=nodes)
    job.state = JobState.RUNNING
    job.nodes = nodes
    cluster.allocate(0, nodes)
    pol.decide(cluster, [], job, minimum=nodes, maximum=nodes, factor=2)
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        pol.decide(cluster, [], job, minimum=nodes, maximum=nodes, factor=2)
        best = min(best, time.perf_counter() - t0)
    return best


def _measure_torch(config: MeasureConfig, device
                   ) -> Tuple[List[Dict[str, object]], Dict[str, object]]:
    import torch

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    samples: List[Dict[str, object]] = []
    for p, q in config.geometries:
        for nbytes in config.data_bytes:
            for kind, a, b in (("expand", p, q), ("shrink", q, p)):
                parts, busiest = resize_features(kind, a, b, nbytes)
                secs = _measure_resize_torch(kind, a, b, nbytes,
                                             config.repeats, dev)
                samples.append(_sample(kind, a, b, nbytes, parts, busiest,
                                       secs))
        if p >= 2:
            nbytes = config.data_bytes[0]
            secs = _measure_migrate_torch(p, nbytes, config.repeats, dev)
            samples.append(_sample("migrate", p, p, nbytes, 2,
                                   nbytes // p, secs))
    for nodes in config.sched_nodes:
        samples.append(_sample("sched", nodes, nodes, 0, nodes, 0,
                               _measure_sched(nodes, config.repeats)))
    cuda = dev.type == "cuda"
    env = {"backend": "torch",
           "device_kind": torch.cuda.get_device_name(dev) if cuda
           else "cpu",
           "num_devices": torch.cuda.device_count() if cuda else 1,
           "slices": "virtual slices of one device (slice_devices): "
                     "on-device copies, not links between nodes",
           "link_proxy_samples": 0}
    return samples, env


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def measure_grid(config: MeasureConfig, device=DEFAULT_DEVICE
                 ) -> Tuple[List[Dict[str, object]], Dict[str, object]]:
    """Run the campaign; returns ``(samples, environment)``. ``device``
    holds the ``torch`` backend's virtual slices (the card unless the
    caller asks for the CPU); the ``plan`` backend touches no device."""
    if config.backend == "plan":
        return _measure_plan(config)
    if config.backend == "torch":
        return _measure_torch(config, device)
    raise ValueError(f"unknown backend {config.backend!r} "
                     f"(expected 'plan' or 'torch')")


def calibrate(config: Optional[MeasureConfig] = None,
              device=DEFAULT_DEVICE) -> Dict[str, object]:
    """measure → fit → artifact in one call."""
    from repro_torch.calib.artifact import make_artifact
    from repro_torch.calib.fit import fit_samples

    config = MeasureConfig() if config is None else config

    samples, env = measure_grid(config, device)
    fitted, residuals, checks = fit_samples(samples)
    return make_artifact(samples=samples, fitted=fitted,
                         residuals=residuals, checks=checks,
                         grid=config.grid_doc(), backend=config.backend,
                         environment=env)


QUICK_GEOMETRIES = ((1, 2), (2, 4), (4, 8))
QUICK_DATA_BYTES = (4 * MiB, 16 * MiB)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", choices=("plan", "torch"), default="plan")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="the torch backend's device (default: the card)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--quick", action="store_true",
                    help="small grid (runs on the CPU in seconds)")
    ap.add_argument("--out", default=None,
                    help="write the calibration artifact here")
    ap.add_argument("--check", default=None,
                    help="golden artifact to byte-compare against "
                         "(exit 1 on mismatch)")
    args = ap.parse_args(argv)

    kw: Dict[str, object] = dict(backend=args.backend,
                                 repeats=args.repeats, seed=args.seed)
    if args.quick:
        kw.update(geometries=QUICK_GEOMETRIES, data_bytes=QUICK_DATA_BYTES)
    from repro_torch.calib.fit import FitError
    try:
        doc = calibrate(MeasureConfig(**kw), device=args.device)
    except FitError as err:
        print(f"# FAIL: the samples support no physical fit: {err}")
        return 2

    f = doc["fitted"]
    print(f"# calibration {doc['calibration_id']} backend={doc['backend']} "
          f"samples={len(doc['samples'])}")
    print(f"# fitted: link_bw={f['link_bw']:.4g} B/s "
          f"spawn_s={f['spawn_s']:.4g} shrink_sync_s="
          f"{f['shrink_sync_s']:.4g} sched_base_s={f['sched_base_s']:.4g} "
          f"sched_per_node_s={f['sched_per_node_s']:.4g}")
    print(f"# residuals: {doc['residuals']}")
    print(f"# checks: {doc['checks']}")
    if not all(doc["checks"].values()):
        print("# FAIL: fitted model violates the Fig. 3 shape checks")
        return 2
    if args.out:
        from repro_torch.calib.artifact import write_calibration
        write_calibration(args.out, doc)
        print(f"# wrote {args.out}")
    if args.check:
        from repro_torch.calib.artifact import (dumps_calibration,
                                                load_calibration)
        golden = dumps_calibration(load_calibration(args.check))
        if dumps_calibration(doc) != golden:
            print(f"# MISMATCH against {args.check}: calibration bytes "
                  f"differ (grid or fitter changed — regenerate the golden "
                  f"only for intentional changes)")
            return 1
        print(f"# artifact matches {args.check}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
