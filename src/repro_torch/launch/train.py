"""End-to-end training entry point, as the JAX package's
``repro.launch.train``.

Wires config → fp32 master init from a seeded ``torch.Generator`` →
deterministic xoshiro token pipeline → train step (microbatching, AdamW,
clipping) → checkpoint manager with async saves, crash-resume and
straggler monitoring, on the card unless ``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch olmo-1b --variant smoke --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --variant full --steps 4 --batch 4 --seq 2048 --ckpt-dir ckpt

``--seconds`` in each history row is the step's host-clock time, ending in
a device synchronisation.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import load_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models.model import init_params, resolve_device
from repro_torch.train.fault import CheckpointManager, StragglerMonitor
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--variant", choices=["full", "smoke"], default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--autotune", action="store_true",
                    help="let repro_torch.tune pick the COPIFT kernel "
                         "tilings (cached; first run searches, later runs "
                         "are free)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.autotune:
        from repro_torch.kernels import ops as kops
        kops.set_tuned_defaults(True)
        print("[tune] kernel block tilings autotuned "
              "(repro_torch.api.default_tuner cache)")
    device = resolve_device(args.device)
    cfg = load_config(args.arch, args.variant)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    pipe = TokenPipeline(cfg, shape, PipelineConfig(seed=args.seed + 1),
                         device)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 10))
    step_fn = make_train_step(cfg, opt_cfg, n_microbatches=args.microbatches)

    def init_fn():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        masters = init_params(cfg.replace(dtype=cfg.param_dtype), gen, device)
        return init_train_state(cfg, masters)

    manager = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if manager is not None:
        state, start_step = manager.restore_or_init(init_fn)
        if start_step:
            print(f"[resume] from step {start_step}")
    else:
        state = init_fn()

    monitor = StragglerMonitor()
    history = []
    saved = None
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = pipe.host_batch_at(step)
        state, metrics = step_fn(state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        flagged = monitor.record(f"host{pipe.host}", step, dt)
        history.append(dict(step=step, seconds=dt, straggler=flagged,
                            **metrics))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={metrics['loss']:.4f} "
                  f"nll={metrics['nll']:.4f} lr={metrics['lr']:.2e} "
                  f"gnorm={metrics['grad_norm']:.2f} {dt*1e3:.0f}ms",
                  flush=True)
        if manager is not None and (step + 1) % args.ckpt_every == 0:
            saved = step + 1
            manager.save(saved, state.state_dict())
    if manager is not None:
        if saved != args.steps:       # the last periodic save may be it
            manager.save(args.steps, state.state_dict())
        manager.wait()
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(history, f)
    final = history[-1]["loss"] if history else float("nan")
    first = history[0]["loss"] if history else float("nan")
    print(f"[done] steps={args.steps} loss {first:.4f} -> {final:.4f}")
    return history


if __name__ == "__main__":
    main()
