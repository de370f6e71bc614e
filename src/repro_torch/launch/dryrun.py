"""Dry-run: count every (arch x shape x mesh) cell on the meta device.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
onto 512 placeholder TPU devices. Here each cell's step is the port's own
eager program, run once on meta tensors (``roofline/count.py``): nothing is
allocated, no kernel is built or launched and CUDA is never touched, so it
runs on a host with no card and no ``nvcc``. For every live cell it:

  1. builds the mesh (``launch/mesh.py``: ``h100x1``, one card; one HGX
     node of 8 as 8 data slices, ``h100x8``, or with a model axis, 1 x 8
     ``h100x8_m8`` and 2 x 4 ``h100x8_m4``),
  2. builds the cell (``launch/cells.py``): one card's blocks under the
     cell's rules (a slice's model coordinates' blocks, run in lockstep),
  3. counts its step: one card's FLOPs, HBM bytes, peak memory (the
     arguments held) and the collectives over the model axis that the step
     calls, by kind,
  4. adds the bytes a card sends over the data axes under those rules,
  5. derives the roofline terms against the H100 (``roofline/analysis.py``)
     and whether the peak fits the card's HBM,
  6. writes a JSON artifact, which ``python -m repro_torch.roofline.report``
     reads.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh all [--out build/dryrun] [--skip-existing] \\
      [--reduced]

``--mesh`` takes ``single`` (h100x1), ``node`` (h100x8), ``node_m8``
(h100x8_m8), ``node_m4`` (h100x8_m4), ``both`` (single and node) or
``all`` (the four).

``--reduced`` counts each arch's reduced config (``models.reduced_config``,
a few narrow layers) at the same shapes: a quick check of the tooling, in
seconds.

A cell that is not applicable (``launch/shapes.py``) is written as
"skipped" with the reference's reason; one that raises as "error", and the
command then exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Optional, Union

from repro_torch.launch.cells import build_cell, rules_name
from repro_torch.launch.mesh import MESHES, meta_mesh
from repro_torch.launch.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.roofline.analysis import (cost_summary, memory_summary,
                                           roofline_terms)
from repro_torch.roofline.count import count_step

MESH_OF = {"single": "h100x1", "node": "h100x8", "node_m8": "h100x8_m8",
           "node_m4": "h100x8_m4"}
MESH_SETS = {"both": ["single", "node"], "all": list(MESH_OF)}
DEFAULT_OUT = "build/dryrun"


def artifact_path(out_dir: pathlib.Path, arch: str, shape: str,
                  mesh_name: str, tag: str = "") -> pathlib.Path:
    suffix = f"__{tag}" if tag else ""
    return out_dir / f"{arch}__{shape}__{mesh_name}{suffix}.json"


def run_cell(arch: str, shape: Union[str, ShapeSpec],
             mesh_name: Union[str, tuple], out_dir: Optional[pathlib.Path],
             verbose: bool = True, rules=None, cfg_overrides=None,
             accum=None, opt_cfg=None, tag: str = "") -> dict:
    """Count one cell and write its artifact (unless ``out_dir`` is None);
    returns the record. ``shape`` is a name of ``SHAPES`` or a
    ``ShapeSpec`` (a cut cell, with ``cfg_overrides`` such as
    ``num_layers``); ``mesh_name`` a name of ``MESHES`` or a (data, model)
    pair (a layout of virtual devices on one card, named ``d{data}m{model}``
    in the record)."""
    shape_name = shape if isinstance(shape, str) else shape.name
    if isinstance(mesh_name, str):
        dims = (MESHES[mesh_name]["data"], MESHES[mesh_name]["model"])
    else:
        dims, mesh_name = tuple(mesh_name), "d{}m{}".format(*mesh_name)
    chips = dims[0] * dims[1]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "status": "ok", "tag": tag}
    ok, why = applicable(arch, shape_name)
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        try:
            mesh = meta_mesh(*dims)
            t0 = time.perf_counter()
            kw = {} if opt_cfg is None else {"opt_cfg": opt_cfg}
            cell = build_cell(arch, shape, mesh, rules=rules,
                              cfg_overrides=cfg_overrides, accum=accum, **kw)
            t1 = time.perf_counter()
            _, count = count_step(cell.fn, *cell.args, ways=cell.ways)
            t2 = time.perf_counter()
            mem = memory_summary(count)
            cost = cost_summary(count)
            coll = dict(cell.collectives, **count.collectives)
            coll_total = float(sum(coll.values()))
            rl = roofline_terms(per_device_flops=count.flops,
                                per_device_bytes=count.bytes,
                                per_device_coll_bytes=coll_total,
                                chips=chips, model_flops=cell.model_flops)
            rec.update(build_s=round(t1 - t0, 2), count_s=round(t2 - t1, 2),
                       memory=mem, cost=cost, collectives=coll,
                       roofline=rl.as_dict(), tokens=cell.tokens,
                       fits=mem["fits"], rules=rules_name(cell.rules),
                       note=cell.note)
            if verbose:
                print(f"[{arch} x {shape_name} x {mesh_name}] build "
                      f"{t1 - t0:.1f}s count {t2 - t1:.1f}s "
                      f"({rules_name(cell.rules)}; {cell.note})")
                print(f"  memory: args={mem['argument_size_in_bytes']/1e9:.2f}"
                      f"GB peak={mem['peak_bytes']/1e9:.2f}GB (per card; "
                      f"HBM {mem['hbm_bytes']/1e9:.0f}GB, fits "
                      f"{mem['fits']})")
                print(f"  count: flops/card={count.flops:.3e} "
                      f"bytes/card={count.bytes:.3e} ops={count.ops}")
                print("  collectives/card: " + (", ".join(
                    f"{k}={v/1e6:.1f}MB"
                    for k, v in sorted(coll.items())) or "none"))
                print(f"  roofline: compute={rl.compute_s*1e3:.2f}ms "
                      f"memory={rl.memory_s*1e3:.2f}ms "
                      f"collective={rl.collective_s*1e3:.2f}ms "
                      f"-> dominant={rl.dominant} mfu={rl.mfu:.3f} "
                      f"useful={rl.useful_ratio:.2f}")
        except Exception as e:  # noqa: BLE001
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
            if verbose:
                print(f"[{arch} x {shape_name} x {mesh_name}] FAILED: "
                      f"{rec['error']}")
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        artifact_path(out_dir, arch, shape_name, mesh_name, tag).write_text(
            json.dumps(rec, indent=1, default=str))
    return rec


def reduced_overrides(arch: str) -> dict:
    """The fields ``models.reduced_config`` changes in ``arch``'s config."""
    from repro_torch.configs import get_config
    from repro_torch.models import reduced_config
    cfg = get_config(arch)
    return {k: v for k, v in dataclasses.asdict(reduced_config(cfg)).items()
            if getattr(cfg, k) != v}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=sorted(set(MESH_OF) | set(MESH_SETS)))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs import list_archs
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = MESH_SETS.get(args.mesh, [args.mesh])
    out = pathlib.Path(args.out)

    n_ok = n_skip = n_err = 0
    for arch in archs:
        for shape in shapes:
            for which in meshes:
                mesh_name = MESH_OF[which]
                path = artifact_path(out, arch, shape, mesh_name)
                if args.skip_existing and path.exists():
                    prev = json.loads(path.read_text())
                    if prev.get("status") == "ok":
                        n_ok += 1
                        continue
                rec = run_cell(arch, shape, mesh_name, out,
                               cfg_overrides=(reduced_overrides(arch)
                                              if args.reduced else None))
                n_ok += rec["status"] == "ok"
                n_skip += rec["status"] == "skipped"
                n_err += rec["status"] == "error"
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
