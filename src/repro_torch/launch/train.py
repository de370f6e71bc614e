"""Training launcher for the ported architectures, optionally elastic.

  PYTHONPATH=src python -m repro_torch.launch.train --steps 100
  PYTHONPATH=src python -m repro_torch.launch.train --no-reduced \
      --seq-len 2048 --global-batch 8 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --no-reduced \
      --seq-len 2048 --global-batch 8 --slices 2 --devices 4 --elastic
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --no-reduced --seq-len 2048 --global-batch 8 --steps 20

Counterpart of ``repro.launch.train``. ``--reduced`` (the default) trains
the tiny same-family config; ``--no-reduced`` the published widths. Every
architecture of the zoo trains, on the card through the hand-written
kernels' forward and backward (flash attention; mamba2's SSD scan and
recurrentgemma's RG-LRU scan), on the CPU through their plain versions:
paligemma-3b's batches carry patch embeddings, seamless-m4t-medium's
frames (``data.pipeline``). Runs on ``--device`` (default ``cuda``). ``--devices N`` gives the job N virtual
slices of that one device (``core.meshes.slice_devices``), as the
reference's ``--devices`` gives it N host devices of one CPU; the first
line says so. Each slice is ``--model-ways`` virtual devices (tensor
parallelism inside a slice, for every family), so the
job's mesh draws from ``max(N, 1) * model_ways`` of them. The job starts on
``--slices`` slices. ``--elastic`` attaches a ``LocalRMS`` of ``max(N,
1)`` nodes and honours its DMR decisions at a reconfiguration point every
``max(steps // 10, 1)`` steps, up to that many slices. ``--ckpt-dir``
checkpoints every 50 steps. It prints the per-step lines, the
``resize_log`` and, on the card, each resize's time, the wall time of the
steps and the peak of allocated device memory. On the card it refuses,
before drawing, a model whose fp32 training state does not fit the card
(``training_state_refusal``): at ``--no-reduced`` on an 80 GB card,
gemma2-27b, phi3.5-moe-42b-a6.6b, deepseek-moe-16b and recurrentgemma-9b.

Reference behaviour it departs from, on purpose (``repro.launch.train``):

- ``--devices`` counts slices; the reference's counts devices, each
  slice taking ``--model-ways`` of them.
- ``--elastic`` lets the job grow to ``--devices`` slices; the reference
  caps it at ``--slices``, so its launcher never expands.
- ``--grad-accum`` reaches the trainer; the reference parses it and drops
  it.
- The reconfiguration and log period is ``max(steps // 10, 1)`` steps; the
  reference's trainer keeps its default of 10.
"""
import argparse
import sys
import time

import torch


# bytes of fp32 training state a parameter holds: the parameter, its
# gradient and AdamW's two moments
TRAIN_STATE_BYTES = 16


def training_state_refusal(cfg, have_bytes: int):
    """Why ``cfg``'s fp32 training state (TRAIN_STATE_BYTES a parameter by
    ``cfg.param_count()``) cannot fit a device of ``have_bytes``, or None
    where it can (activations not counted)."""
    need = TRAIN_STATE_BYTES * cfg.param_count()
    if need <= have_bytes:
        return None
    return (f"{cfg.name}: {need / 1e9:.1f} GB of fp32 training state "
            f"(parameters, gradients and two AdamW moments, "
            f"{TRAIN_STATE_BYTES} bytes a parameter, {cfg.param_count()} "
            f"parameters at {cfg.num_layers} layers) do not fit the card's "
            f"{have_bytes / 1e9:.1f} GB")


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
    ap.add_argument("--devices", type=int, default=0,
                    help="N virtual slices of --device, each of "
                         "--model-ways virtual devices")
    ap.add_argument("--elastic", action="store_true",
                    help="attach a LocalRMS and honour DMR decisions")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.core import slice_devices
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model, reduced_config
    from repro_torch.optim import AdamWConfig
    from repro_torch.rms import Job
    from repro_torch.runtime import ElasticTrainer, LocalRMS, TrainerConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    model = build_model(cfg, device=args.device)
    if model.device.type == "cuda":
        why = training_state_refusal(cfg, torch.cuda.get_device_properties(
            model.device).total_memory)
        if why is not None:
            raise SystemExit(why)
    nodes = max(args.devices, 1)
    devices = slice_devices(nodes * args.model_ways, args.device)
    if args.devices:
        card = devices[0].type == "cuda"
        name = f", {torch.cuda.get_device_name(devices[0])}" if card else ""
        ways = (f", {args.model_ways} model coordinates each"
                if args.model_ways > 1 else "")
        print(f"{args.devices} virtual slices of one "
              f"{'card' if card else 'device'} ({devices[0]}{name}){ways}, "
              f"each with buffers of its own")
    rms = None
    if args.elastic:
        rms = LocalRMS(num_nodes=nodes)
        rms.submit(Job(job_id=0, app=f"lm:{cfg.name}", submit_time=0.0,
                       work=args.steps, min_nodes=1,
                       max_nodes=rms.cluster.num_nodes, preferred=None,
                       requested_nodes=args.slices), start=True)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.global_batch,
                      frontend=cfg.frontend,
                      frontend_tokens=cfg.frontend_tokens,
                      d_model=cfg.d_model, enc_dec=cfg.family == "encdec")
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      total_steps=args.steps)
    period = max(args.steps // 10, 1)
    trainer = ElasticTrainer(
        model, opt, data,
        TrainerConfig(steps=args.steps, grad_accum=args.grad_accum,
                      model_ways=args.model_ways,
                      max_slices=nodes if args.elastic else args.slices,
                      check_period=period, log_period=period,
                      ckpt_dir=args.ckpt_dir),
        rms=rms, job_id=0, devices=devices, slices=args.slices)
    t0 = time.perf_counter()
    trainer.train(seed=args.seed)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    for m in trainer.metrics:
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"slices {m['slices']}")
    if trainer.resize_log:
        print("resizes:", trainer.resize_log)
    if model.device.type == "cuda":
        for r in trainer.resize_log:
            print(f"resize {r['action']} {r['from']} -> {r['to']} slices at "
                  f"step {r['step']}: {r['resize_s'] * 1e3:.3f} ms")
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
