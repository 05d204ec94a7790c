"""AdamW with global-norm clipping, linear warmup and cosine decay, as the
JAX package's ``repro.train.optimizer``.

Parameters, gradients and moments are flat dicts keyed by
``LMModel.state_dict()`` names.  ``adamw_update`` updates the parameters
(the fp32 masters) and the moments IN PLACE, where the JAX package returns
new trees: the update then needs no second copy of the state.  The
arithmetic is the JAX package's: the schedule and the bias corrections in
fp32 from an int32 step, the moments in ``opt_state_dtype`` (bf16 moments
are rounded each step), the update in fp32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

#: Last names of the parameters that take weight decay (with ndim >= 2):
#: matrices, not norm gains, biases or scalars.
DECAYED = ("w", "table", "up", "down", "gate")


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_at(c: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio·lr, an fp32 tensor."""
    step = step.to(torch.float32)
    warm = c.lr * step / max(1, c.warmup_steps)
    t = torch.clamp((step - c.warmup_steps)
                    / max(1, c.total_steps - c.warmup_steps), 0.0, 1.0)
    cos = c.lr * (c.min_lr_ratio
                  + (1 - c.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < c.warmup_steps, warm, cos)


def init_opt_state(params: dict[str, torch.Tensor],
                   dtype: str = "float32") -> dict:
    """Zero moments of ``dtype`` beside each parameter, and an int32 step."""
    dt = getattr(torch, dtype)
    device = next(iter(params.values())).device
    return {"m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """Scales ``grads`` IN PLACE (in fp32, then back to each dtype) so that
    their global norm is at most ``max_norm``; returns (grads, norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    for g in grads.values():
        g.copy_(g.to(torch.float32) * scale)
    return grads, gn


def _is_matrix(name: str) -> bool:
    """Weight decay by the parameter's last name, as the JAX package decides
    by the last key of its tree path."""
    return name.rsplit(".", 1)[-1] in DECAYED


@torch.no_grad()
def adamw_update(c: AdamWConfig, params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict) -> dict:
    """One AdamW step on ``params`` and ``state`` (``m``, ``v``, ``step``),
    all IN PLACE; ``grads`` are clipped in place.  Returns the metrics
    ``lr`` and ``grad_norm``."""
    grads, gn = clip_by_global_norm(grads, c.grad_clip)
    state["step"] += 1
    step = state["step"]
    lr = lr_at(c, step)
    b1, b2 = c.beta1, c.beta2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        gf = grads[name].to(torch.float32)
        mf = b1 * m.to(torch.float32) + (1 - b1) * gf
        vf = b2 * v.to(torch.float32) + (1 - b2) * torch.square(gf)
        upd = (mf / bc1) / (torch.sqrt(vf / bc2) + c.eps)
        if c.weight_decay and _is_matrix(name) and p.ndim >= 2:
            upd = upd + c.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * upd)
        m.copy_(mf)
        v.copy_(vf)
    return {"lr": lr, "grad_norm": gn}
