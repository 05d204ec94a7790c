"""Top-level model: embedding → stack → norm → readout.

Inputs are a dict ("batch"): ``tokens`` (B, T) int, with optional
``positions`` (B, T), or ``positions3`` (3, B, T) for M-RoPE.  ``forward``
covers prefill (no cache) and decode (cache + index).  The loss waits for
the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names the card and
    there is none, so nothing carries on quietly on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but PyTorch sees no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    return device


class LMModel(nn.Module):
    """The parameters, named as the JAX package's parameter tree: ``embed``,
    ``stack``, ``final_norm`` and, without tied embeddings, ``head``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        if cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.frontend} frontend is not ported to "
                "repro_torch yet")
        dt = getattr(torch, cfg.dtype)
        self.embed = L.Embedding(cfg.vocab_size, cfg.d_model, dt, device)
        self.stack = T.Stack(cfg, device)
        self.final_norm = L.Norm(cfg.norm, cfg.d_model, device)
        self.head = (None if cfg.tie_embeddings else
                     L.Linear(cfg.d_model, cfg.vocab_size, dt, device))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str = "cuda") -> LMModel:
    """Random parameters drawn from ``generator``, which must live on
    ``device``: truncated normals in ±2σ with the JAX package's scales, norm
    gains 1, biases 0.  Weight matrices are stored in ``cfg.dtype``, 1-D
    parameters in fp32."""
    model = LMModel(cfg, resolve_device(device))
    for m in model.modules():
        if hasattr(m, "init_"):
            m.init_(generator)
    return model


def _positions(cfg: ModelConfig, batch: dict, B: int, T_len: int, device,
               cache_index=None):
    if cfg.rope == "mrope":
        if "positions3" in batch:
            return batch["positions3"]
        base = torch.arange(T_len, dtype=torch.int32, device=device)
        base = base[None].expand(B, T_len)
        if cache_index is not None:
            base = base + cache_index
        return torch.stack([base, base, base])        # text: t = h = w
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(T_len, dtype=torch.int32, device=device)[None]
    pos = pos.expand(B, T_len)
    if cache_index is not None:
        pos = pos + cache_index
    return pos


def _readout(params: LMModel, cfg: ModelConfig, x):
    dt = getattr(torch, cfg.dtype)
    if cfg.tie_embeddings:
        return L.unembed(params.embed, x, dt)
    return L.linear(params.head, x, dt)


def forward(params: LMModel, cfg: ModelConfig, batch: dict, cache=None,
            cache_index: int | None = None, logits_mode: str = "all"):
    """returns (logits, cache, aux_loss); a cache is updated in place.

    logits_mode: "all" (B,T,V) | "last" (B,1,V — decode/prefill readout) |
    "hidden" (B,T,D)."""
    dt = getattr(torch, cfg.dtype)
    tokens = batch["tokens"]
    x = L.embed(params.embed, tokens, dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    B, T_len = x.shape[:2]
    positions = _positions(cfg, batch, B, T_len, x.device, cache_index)

    x, cache, aux = T.apply_stack(params.stack, cfg, x, positions, cache,
                                  cache_index)
    x = L.norm(cfg.norm, params.final_norm, x)
    if logits_mode == "hidden":
        return x, cache, aux
    if logits_mode == "last":
        x = x[:, -1:]
    logits = _readout(params, cfg, x)
    return logits.to(torch.float32), cache, aux
