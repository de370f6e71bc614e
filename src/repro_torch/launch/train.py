"""Training launcher for the ported architectures, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --no-reduced \
      --seq-len 2048 --global-batch 8 --steps 20

Counterpart of ``repro.launch.train``. ``--reduced`` (the default) trains
the tiny same-family config; ``--no-reduced`` the published widths. Runs on
``--device`` (default ``cuda``), where it also prints the wall time of a
step and the peak of allocated device memory. Elasticity (``--elastic``,
``--devices``, ``--slices`` > 1, ``--model-ways`` > 1) and checkpoints
(``--ckpt-dir``) are not ported yet and raise.
"""
import argparse
import sys
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="reduced config (CPU-friendly)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--slices", type=int, default=1)
    ap.add_argument("--model-ways", type=int, default=1)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.elastic or args.devices:
        raise NotImplementedError(
            "--elastic and --devices are not ported yet (ROADMAP.md, Queue "
            "1 items 2-3: resharding and the elastic trainer)")

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model, reduced_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import ElasticTrainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg, device=args.device)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch,
                      frontend=cfg.frontend,
                      frontend_tokens=cfg.frontend_tokens,
                      d_model=cfg.d_model, enc_dec=cfg.family == "encdec")
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      total_steps=args.steps)
    trainer = ElasticTrainer(
        model, opt, data,
        TrainerConfig(steps=args.steps, grad_accum=args.grad_accum,
                      model_ways=args.model_ways,
                      max_slices=max(args.slices, 1),
                      log_period=max(args.steps // 10, 1),
                      ckpt_dir=args.ckpt_dir))
    t0 = time.perf_counter()
    trainer.train(seed=args.seed)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    for m in trainer.metrics:
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"slices {m['slices']}")
    tokens = args.steps * args.global_batch * args.seq_len
    line = (f"{cfg.name} on {model.device}: {args.steps} steps in "
            f"{dt:.1f} s, {tokens / dt:.0f} tokens/s")
    if model.device.type == "cuda":
        line += (f", peak device memory "
                 f"{torch.cuda.max_memory_allocated(model.device) / 2**30:.2f}"
                 f" GiB")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
