"""Serving launcher: batched decode for the ported architectures.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --no-reduced

Counterpart of ``repro.launch.serve``. ``--reduced`` (the default) serves
the tiny same-family config in float32, as the reference does;
``--no-reduced`` serves the published widths (recurrentgemma-9b's 38
layers take 37.6 GB of fp32 parameters, drawn on the host first). Runs on
``--device`` (default ``cuda``); on the card it also prints the peak of
allocated device memory.
"""
import argparse
import dataclasses
import sys
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    help="smollm-135m, mamba2-130m or recurrentgemma-9b "
                         "(the ported ones)")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced_config
    from repro_torch.runtime import Request, Server

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced_config(cfg), dtype="float32")
    model = build_model(cfg, device=args.device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator().manual_seed(0))
    init_s = time.perf_counter() - t0
    server = Server(model, params, batch=args.batch, max_len=args.max_len)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = server.run(reqs)
    dt = time.perf_counter() - t0
    tokens = sum(len(v) for v in done.values())
    print(f"{cfg.name} on {model.device}: {tokens} tokens, {len(done)} "
          f"requests, {tokens/dt:.1f} tok/s")
    memory = ""
    if model.device.type == "cuda":
        memory = (f", peak device memory "
                  f"{torch.cuda.max_memory_allocated(model.device) / 2**30:.2f}"
                  f" GiB")
    print(f"{cfg.name}: {cfg.num_layers} layers, init {init_s:.1f} s"
          f"{memory}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
