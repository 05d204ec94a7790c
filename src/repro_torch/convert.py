"""Carry parameters from the JAX package's parameter tree into the port.

``params_from_jax`` takes the tree that ``repro.models.model.init_params``
returns, with every leaf already converted to a numpy array (so this module
needs no JAX), and returns the port's ``LMModel`` holding the same values.
The stacked period parameters ``stack.periods.sub{i}.*`` are split along
their leading ``n_periods`` axis onto the per-period modules.  Weight
matrices are stored in ``cfg.dtype`` and 1-D parameters in fp32, which is
the arithmetic of the JAX package's cast of its fp32 masters before use.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import LMModel, resolve_device


def _flatten(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


def state_dict_from_jax(np_params: dict) -> dict[str, np.ndarray]:
    """The JAX tree as ``LMModel.state_dict()`` names, periods unstacked."""
    out = {}
    for name, arr in _flatten(np_params):
        if name.startswith("stack.periods."):
            rest = name[len("stack.periods."):]
            for i in range(arr.shape[0]):
                out[f"stack.periods.{i}.{rest}"] = arr[i]
        else:
            out[name] = arr
    return out


def params_from_jax(np_params: dict, cfg: ModelConfig,
                    device: torch.device | str = "cuda") -> LMModel:
    device = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    sd = {name: torch.tensor(arr).to(
              device=device, dtype=dt if arr.ndim >= 2 else torch.float32)
          for name, arr in state_dict_from_jax(np_params).items()}
    model = LMModel(cfg, device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    return model
