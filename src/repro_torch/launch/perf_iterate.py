"""Perf hillclimb harness: count one cell under a named variant and diff
its roofline terms against the stored baseline artifact.

Counterpart of ``benchmarks/perf_iterate.py``, on the dry-run's meta
count (``launch/dryrun.py``):

  PYTHONPATH=src python -m repro_torch.launch.perf_iterate \\
      --arch smollm-135m --shape train_4k --variant dp_only \\
      [--mesh h100x8_m4 | --node]

Each variant writes a tagged artifact next to the baseline's directory.
``dp_only*`` cut the batch over the model axis too, which makes it data
parallelism (``DP_ONLY_RULES``), and ``decode_seq*`` split the KV cache's
sequence over it and leave the attention whole on every coordinate
(``DECODE_SEQ_RULES``): on a mesh with a model axis (``h100x8_m8``,
``h100x8_m4``) each counts its layout; on one of model 1 it is the
baseline's. The reference's ``attn_chunk_2k``, ``attn_chunk_512`` and
``ssd_chunk_1k`` raise: they would count the baseline's program under
another name (``KERNEL_TILES``).
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.core.sharding import FSDP_RULES, TP_DP_RULES
from repro_torch.launch.dryrun import (DEFAULT_OUT, artifact_path,
                                       reduced_overrides, run_cell)
from repro_torch.launch.mesh import MESHES
from repro_torch.optim import AdamWConfig

# copies of the reference's (benchmarks/perf_iterate.py): the batch cut
# over both axes, the model axis extra data parallelism, for models whose
# attention cannot use tensor parallelism
DP_ONLY_RULES = TP_DP_RULES.replace(
    batch=("pod", "data", "model"), heads=(), kv_heads=(), mlp=(),
    experts=(), vocab=(), zero1=("pod", "data", "model"))

# flash-decode: the KV cache cut along its sequence over the model axis,
# for GQA models whose KV heads are fewer than the model ways (the cache
# would otherwise be whole on every coordinate); the query and the
# attention's weights whole on every coordinate, each attending over its
# block, the partial softmaxes combined
DECODE_SEQ_RULES = TP_DP_RULES.replace(
    kv_seq=("model",), heads=(), kv_heads=())
# the reference's chunk variants, which cannot change the port's program
KERNEL_TILES = {
    "attn_chunk_2k": "the flash kernel tiles on its own; attn_chunk steers "
                     "only the chunked path, which a card's tensor never takes",
    "attn_chunk_512": "the flash kernel tiles on its own; attn_chunk steers "
                      "only the chunked path, which a card's tensor never "
                      "takes",
    "ssd_chunk_1k": "the SSD kernel works in chunks of at most 128 rows "
                    "whatever ssd_chunk says",
}

VARIANTS = {
    "baseline": {},
    "fsdp": {"rules": FSDP_RULES},
    "tp_dp": {"rules": TP_DP_RULES},
    "ce_chunk": {"cfg_overrides": {"ce_chunk": 512}},
    "ce_chunk_1k": {"cfg_overrides": {"ce_chunk": 1024}},
    "accum_2": {"accum": 2},
    "accum_4": {"accum": 4},
    "accum_16": {"accum": 16},
    "no_zero1": {"opt_cfg": AdamWConfig(zero1=False)},
    "grad_bf16": {"opt_cfg": AdamWConfig(grad_reduce_dtype="bfloat16")},
    "remat_dots": {"cfg_overrides": {"remat": "dots"}},
    "decode_seq": {"rules": DECODE_SEQ_RULES},
    "decode_seq_bf16": {"rules": DECODE_SEQ_RULES,
                        "cfg_overrides": {"param_dtype": "bfloat16"}},
    "dp_only": {"rules": DP_ONLY_RULES},
    "dp_only_ce": {"rules": DP_ONLY_RULES,
                   "cfg_overrides": {"ce_chunk": 512}},
    "dp_only_dots": {"rules": DP_ONLY_RULES,
                     "cfg_overrides": {"remat": "dots"}},
    "dp_only_dots_ce": {"rules": DP_ONLY_RULES,
                        "cfg_overrides": {"remat": "dots",
                                          "ce_chunk": 1024}},
}


def variant(name: str) -> dict:
    """The ``run_cell`` keywords of variant ``name``."""
    if name in KERNEL_TILES:
        raise ValueError(f"variant {name} counts the baseline's program: "
                         f"{KERNEL_TILES[name]}")
    return dict(VARIANTS[name])


def show(rec, label):
    if rec.get("status") != "ok":
        print(f"{label}: {rec.get('status')} {rec.get('error', '')[:200]}")
        return None
    rl = rec["roofline"]
    mem = rec["memory"]
    print(f"{label:>16s}: compute={rl['compute_s']*1e3:9.2f}ms "
          f"memory={rl['memory_s']*1e3:9.2f}ms "
          f"coll={rl['collective_s']*1e3:9.2f}ms "
          f"dom={rl['dominant']:<10s} mfu={rl['mfu']:.4f} "
          f"useful={rl['useful_ratio']:.2f} "
          f"peak={mem['peak_bytes']/1e9:.1f}GB fits={rec['fits']}")
    return rl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True,
                    choices=sorted(set(VARIANTS) | set(KERNEL_TILES)))
    ap.add_argument("--mesh", default="h100x1", choices=sorted(MESHES))
    ap.add_argument("--node", action="store_true",
                    help="the 8-card mesh h100x8 (as --mesh h100x8)")
    ap.add_argument("--base", default=DEFAULT_OUT)
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced config, as dryrun --reduced "
                         "(compared with --base's artifact of the cell)")
    ap.add_argument("--out", default="build/perf")
    args = ap.parse_args(argv)

    mesh_name = "h100x8" if args.node else args.mesh
    spec = variant(args.variant)
    base_path = artifact_path(pathlib.Path(args.base), args.arch, args.shape,
                              mesh_name)
    base = json.loads(base_path.read_text()) if base_path.exists() else None
    if base:
        show(base, "baseline")
    overrides = spec.pop("cfg_overrides", {})
    if args.reduced:
        overrides = dict(reduced_overrides(args.arch), **overrides)
    rec = run_cell(args.arch, args.shape, mesh_name, pathlib.Path(args.out),
                   verbose=False, tag=args.variant,
                   cfg_overrides=overrides or None, **spec)
    rl = show(rec, args.variant)
    if base and rl and base.get("status") == "ok":
        b = base["roofline"]
        for k in ("compute_s", "memory_s", "collective_s", "step_s"):
            delta = (rl[k] - b[k]) / b[k] * 100 if b[k] else 0.0
            print(f"   {k:>13s}: {b[k]*1e3:9.2f} -> {rl[k]*1e3:9.2f} ms "
                  f"({delta:+.1f}%)")
        print(f"   {'mfu':>13s}: {b['mfu']:.4f} -> {rl['mfu']:.4f}")
    return 0 if rl else 1


if __name__ == "__main__":
    raise SystemExit(main())
