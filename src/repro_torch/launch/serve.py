"""Serving entry point: initialises params for --arch from a seeded
``torch.Generator`` (or takes the masters of a training checkpoint,
``--params``, cast to the compute dtype) and decodes a batch of synthetic
prompts through the ServeEngine (prefill + step loop), on the card unless
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
      --variant full --batch 4 --prompt-len 128 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --params ckpt/step_00000020.pt
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import load_config
from repro_torch.models.model import init_params, load_params, resolve_device
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import checkpoint as ckpt

_MASTERS = "params/"


def params_from_checkpoint(path: str, cfg, device):
    """The model of a training checkpoint's masters (``params/<name>``),
    cast to ``cfg``'s storage dtypes."""
    arrays, _ = ckpt.load(path)
    masters = {k[len(_MASTERS):]: v for k, v in arrays.items()
               if k.startswith(_MASTERS)}
    return load_params(masters, cfg, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--variant", choices=["full", "smoke"], default="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--params", default="",
                    help="a checkpoint of launch.train to serve")
    args = ap.parse_args(argv)

    cfg = load_config(args.arch, args.variant)
    if cfg.is_encoder_only:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode step")
    device = resolve_device(args.device)
    if args.params:
        params = params_from_checkpoint(args.params, cfg, device)
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        params = init_params(cfg, gen, device)

    engine = ServeEngine(cfg, params, max_len=args.prompt_len + args.gen + 1,
                         batch=args.batch, temperature=args.temperature,
                         seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    result = engine.generate(prompts, args.gen)
    dt = result.prefill_s + result.decode_s
    tps = args.batch * args.gen / dt if dt > 0 else float("inf")
    print(f"[serve] {cfg.name} on {device}: {args.batch}×{args.gen} tokens "
          f"in {dt:.2f}s ({tps:.1f} tok/s; prefill "
          f"{result.prefill_s * 1e3:.1f} ms, decode "
          f"{result.decode_s * 1e3 / max(args.gen, 1):.2f} ms/token)")
    print("sample:", result.tokens[0, args.prompt_len:args.prompt_len + 16])
    return result


if __name__ == "__main__":
    main()
