"""Stand-ins on the ``meta`` device for every model input, as the JAX
package's ``repro.launch.specs``: shapes and dtypes with no storage.

``input_specs(cfg, shape)`` returns the arguments the cell's step
function takes: for training ``{state, batch}``; for decode ``{params,
cache, tokens, cache_index}``.  Everything is built by the port's real
init functions (``LMModel``, ``init_train_state``, ``init_stack_cache``)
on ``meta``, so the specs cannot drift from the code.  Parameters are the
fp32 masters (``cfg.param_dtype``), as the JAX package's parameter tree
holds them.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.model import LMModel
from repro_torch.models.transformer import init_stack_cache
from repro_torch.train.train_step import TrainState, init_train_state

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A ``meta`` tensor: the counterpart of ``jax.ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def params_specs(cfg: ModelConfig) -> LMModel:
    """The master parameters: an ``LMModel`` on ``meta`` in
    ``cfg.param_dtype``."""
    return LMModel(cfg.replace(dtype=cfg.param_dtype), META)


def train_state_specs(cfg: ModelConfig) -> TrainState:
    """``init_train_state`` of the masters on ``meta``: masters, the
    working copy in ``cfg``'s storage dtypes, moments and step."""
    return init_train_state(cfg, params_specs(cfg))


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    B, T = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio":
        return {"embeds": sds((B, T, cfg.d_model), getattr(torch, cfg.dtype)),
                "labels": sds((B, T), torch.int32)}
    return {"tokens": sds((B, T), torch.int32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig):
    return init_stack_cache(cfg, shape.global_batch, shape.seq_len, META)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    return {"params": params_specs(cfg),
            "cache": cache_specs(cfg, shape),
            "tokens": sds((shape.global_batch, 1), torch.int32),
            "cache_index": sds((), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The full argument spec set for the cell's step function."""
    if shape.kind == "decode":
        return decode_specs(cfg, shape)
    return {"state": train_state_specs(cfg), "batch": batch_specs(cfg, shape)}
