"""Carry parameters from the JAX package's parameter tree into the port.

``params_from_jax`` takes the tree that ``repro.models.model.init_params``
returns, with every leaf already converted to a numpy array (so this module
needs no JAX), and returns the port's ``LMModel`` holding the same values.
The stacked period parameters ``stack.periods.sub{i}.*`` (1-D vectors, 2-D
matrices and MoE's 3-D expert banks alike) are split along their leading
``n_periods`` axis onto the per-period modules.  Each parameter is stored
in its ``models.model.working_dtype``, the JAX package's cast of its fp32
masters before use.
``train_state_from_jax`` carries a whole JAX train state across, so that
both packages can train from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import LMModel, load_params
from repro_torch.train.train_step import TrainState, init_train_state


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
    return load_params(state_dict_from_jax(np_params), cfg, device)


def _fp32(arr: np.ndarray) -> np.ndarray:
    """A writable fp32 copy of ``arr``: exact for bf16 (whose numpy dtype
    torch does not read) and fp32 alike."""
    return np.array(arr, dtype=np.float32)


def train_state_from_jax(np_state: dict, cfg: ModelConfig,
                         device: torch.device | str = "cuda") -> TrainState:
    """The port's ``TrainState`` from the JAX package's train state
    ``{"params", "opt": {"m", "v", "step"}}`` with numpy leaves: fp32
    masters, the working copy cast from them, the moments in
    ``cfg.opt_state_dtype`` and the step."""
    params = state_dict_from_jax(np_state["params"])
    masters = load_params({k: _fp32(v) for k, v in params.items()},
                          cfg.replace(dtype=cfg.param_dtype), device)
    state = init_train_state(cfg, masters)
    for part in ("m", "v"):
        for name, arr in state_dict_from_jax(np_state["opt"][part]).items():
            state.opt[part][name].copy_(torch.from_numpy(_fp32(arr)))
    state.opt["step"].fill_(int(np_state["opt"]["step"]))
    return state
