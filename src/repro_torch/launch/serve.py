"""Serving launcher: batched decode for the ported architectures.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
  PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --no-reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b \
      --no-reduced

Counterpart of ``repro.launch.serve``. ``--arch`` takes every decoder of
the zoo: smollm-135m, granite-3-2b, qwen3-4b, gemma2-27b,
recurrentgemma-9b, mamba2-130m, phi3.5-moe-42b-a6.6b, deepseek-moe-16b
and paligemma-3b, which serves text alone: the ``Server`` passes no patch
embeddings, as the reference's never does. seamless-m4t-medium is refused:
the reference's ``EncDecLM`` has no ``init_cache``, so its ``Server``
cannot serve it, and the port adds no such path; it runs through
``EncDecLM.prefill`` and ``decode_step`` (``chip_smoke.py`` phase z).
``--reduced`` (the default) serves the tiny same-family config in float32,
as the reference does; ``--no-reduced`` serves the published widths at the
published depth, drawn on the host first (recurrentgemma-9b's 38 layers
take 37.6 GB of fp32 parameters). On the card it refuses, before drawing,
a model whose fp32 parameters do not fit the card's memory: gemma2-27b,
phi3.5-moe and deepseek-moe at their published depth (``chip_smoke.py``
drives them at their widths with the depth cut). Runs on ``--device``
(default ``cuda``); on the card it also prints the peak of allocated
device memory.
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
                    help="a decoder of the zoo (seamless-m4t-medium, an "
                         "encoder-decoder, has no Server path)")
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
    if cfg.family == "encdec":
        raise SystemExit(
            f"{cfg.name}: an encoder-decoder has no Server path: the "
            f"reference's EncDecLM has no init_cache, so its Server cannot "
            f"serve it; run EncDecLM.prefill and decode_step instead")
    if args.reduced:
        cfg = dataclasses.replace(reduced_config(cfg), dtype="float32")
    model = build_model(cfg, device=args.device)
    if model.device.type == "cuda":
        need = 4 * cfg.param_count()
        have = torch.cuda.get_device_properties(model.device).total_memory
        if need > have:
            raise SystemExit(
                f"{cfg.name}: {need / 1e9:.1f} GB of fp32 parameters at "
                f"{cfg.num_layers} layers do not fit the card's "
                f"{have / 1e9:.1f} GB")
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
