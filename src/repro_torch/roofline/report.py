"""Roofline report: reads the dry-run's artifacts, prints the 40-cell table
of each mesh.

Counterpart of ``benchmarks/roofline_report.py``, with the H100's terms
and whether a cell's counted peak fits the card's HBM (``fits``) in place
of the reference's 16 GB test, and the collective term split by kind
(``collectives``: MB a card sends for each, ``;``-separated).

  PYTHONPATH=src python -m repro_torch.roofline.report [--art build/dryrun]
      [--mesh single | node | node_m8 | node_m4 | both | all]
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.configs import list_archs
from repro_torch.launch.dryrun import (DEFAULT_OUT, MESH_OF, MESH_SETS,
                                       artifact_path)
from repro_torch.launch.shapes import SHAPES, applicable
from repro_torch.roofline.hardware import (HBM_BYTES, NVLINK_BYTES,
                                           PEAK_BF16_FLOPS, PEAK_BYTES)


def load(art: pathlib.Path, mesh: str = "h100x1"):
    rows = []
    for arch in list_archs():
        for shape in SHAPES:
            path = artifact_path(art, arch, shape, mesh)
            ok, why = applicable(arch, shape)
            if not ok:
                rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                             "status": "skipped", "reason": why})
                continue
            if not path.exists():
                rows.append({"arch": arch, "shape": shape, "mesh": mesh,
                             "status": "missing"})
                continue
            rows.append(json.loads(path.read_text()))
    return rows


def table(art: pathlib.Path, mesh: str) -> int:
    """Print one mesh's table; returns the cells missing or in error."""
    print(f"# Roofline ({mesh}, H100 SXM: {PEAK_BF16_FLOPS / 1e12:.0f}TF "
          f"bf16 / {PEAK_BYTES / 1e12:.2f}TB/s HBM / "
          f"{NVLINK_BYTES / 1e9:.0f}GB/s NVLink a direction / "
          f"{HBM_BYTES / 1e9:.0f}GB)")
    print("arch,shape,status,rules,compute_ms,memory_ms,collective_ms,"
          "dominant,mfu,useful_ratio,fits,peak_gb,collectives")
    n_ok = n_skip = n_other = 0
    for r in load(art, mesh):
        if r.get("status") == "ok":
            rl = r["roofline"]
            print(f"{r['arch']},{r['shape']},ok,{r['rules']},"
                  f"{rl['compute_s']*1e3:.2f},{rl['memory_s']*1e3:.2f},"
                  f"{rl['collective_s']*1e3:.2f},{rl['dominant']},"
                  f"{rl['mfu']:.4f},{rl['useful_ratio']:.3f},"
                  f"{r['fits']},{r['memory']['peak_bytes'] / 1e9:.2f},"
                  + ";".join(f"{k}={v / 1e6:.1f}MB" for k, v in
                             sorted(r["collectives"].items())))
            n_ok += 1
        elif r.get("status") == "skipped":
            print(f"{r['arch']},{r['shape']},skipped({r['reason'][:40]})"
                  ",,,,,,,,,,")
            n_skip += 1
        else:
            print(f"{r['arch']},{r['shape']},{r.get('status')},,,,,,,,,,")
            n_other += 1
    print(f"# {n_ok} ok, {n_skip} skipped, {n_other} missing/error")
    return n_other


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default=DEFAULT_OUT)
    ap.add_argument("--mesh", default="both",
                    choices=sorted(set(MESH_OF) | set(MESH_SETS)))
    args = ap.parse_args(argv)
    meshes = MESH_SETS.get(args.mesh, [args.mesh])
    bad = sum(table(pathlib.Path(args.art), MESH_OF[m]) for m in meshes)
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
