"""Block assembly and the layer stack.

The stack is decomposed as in the JAX package: a non-periodic PREFIX plus a
PERIODIC tail, the smallest repeating unit of (mixer type, is-moe).  The
JAX package scans one compiled period body over stacked parameters; PyTorch
runs eagerly, so here the periods are an ``nn.ModuleList`` walked by a
Python loop, and a cache is a list with one entry per period.

When gradients are on and there is no cache, ``cfg.remat == "full"``
recomputes each period in the backward pass (``torch.utils.checkpoint``),
as the JAX package's ``jax.checkpoint`` of its period body does; the
recompute launches the period's kernels a second time.

This slice ports the dense attention sub-layer (mixer ``"a"`` with a dense
FFN).  The Mamba and RWKV-6 mixers and MoE FFNs raise
``NotImplementedError`` until their ROADMAP item is done.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

_NOT_PORTED = ("ROADMAP.md §1, 'MoE and SSM mixers': {what} is not ported to "
               "repro_torch yet")


@dataclass(frozen=True)
class SubLayer:
    mixer: str                  # 'a' | 'm' | 'r'
    is_moe: bool


def moe_layer_pattern(cfg: ModelConfig, layer_idx: int) -> bool:
    e = cfg.moe
    if e is None:
        return False
    if e.layer_pattern == "all":
        return True
    if e.layer_pattern == "all_but_first":
        return layer_idx > 0
    if e.layer_pattern == "every_2":
        return layer_idx % 2 == 1
    raise ValueError(e.layer_pattern)


def layer_plan(cfg: ModelConfig) -> tuple[list[SubLayer], list[SubLayer], int]:
    """(prefix, period, n_periods)."""
    seq = [SubLayer(cfg.layer_types[i], moe_layer_pattern(cfg, i))
           for i in range(cfg.n_layers)]
    # Smallest period wins; prefix breaks ties.
    best = None
    for prefix_len in range(0, 2):            # dense-first archs need 1
        tail = seq[prefix_len:]
        if not tail:
            continue
        for p in range(1, len(tail) + 1):
            if len(tail) % p:
                continue
            if all(tail[i] == tail[i % p] for i in range(len(tail))):
                cand = (p, prefix_len)
                if best is None or cand < best[:2]:
                    best = (p, prefix_len, seq[:prefix_len], tail[:p],
                            len(tail) // p)
                break
    if best is not None:
        return best[2], best[3], best[4]
    return seq, [], 0                          # fully explicit fallback


# ---------------------------------------------------------------------------
# one sub-layer
# ---------------------------------------------------------------------------

def _check_ported(sub: SubLayer) -> None:
    if sub.mixer == "m":
        raise NotImplementedError(_NOT_PORTED.format(what="the Mamba mixer"))
    if sub.mixer == "r":
        raise NotImplementedError(_NOT_PORTED.format(what="the RWKV-6 mixer"))
    if sub.is_moe:
        raise NotImplementedError(_NOT_PORTED.format(what="the MoE FFN"))


class Block(nn.Module):
    """One sub-layer: norm → mixer → residual, norm → FFN → residual."""

    def __init__(self, cfg: ModelConfig, sub: SubLayer, device):
        super().__init__()
        _check_ported(sub)
        self.norm1 = L.Norm(cfg.norm, cfg.d_model, device)
        self.norm2 = L.Norm(cfg.norm, cfg.d_model, device)
        self.attn = A.Attention(cfg, device)
        self.ffn = L.FFN(cfg.d_model, cfg.d_ff, cfg.act,
                         getattr(torch, cfg.dtype), device)


def init_sublayer_cache(cfg: ModelConfig, sub: SubLayer, batch: int,
                        max_len: int, device):
    """Decode-time state for one sub-layer: its KV cache."""
    _check_ported(sub)
    dt = getattr(torch, cfg.dtype)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def apply_sublayer(p: Block, cfg: ModelConfig, x, positions, cache=None,
                   cache_index=None):
    """returns (x, cache); the cache is updated in place.  A dense FFN has
    no auxiliary loss, so unlike the JAX package there is none to return."""
    h = L.norm(cfg.norm, p.norm1, x)
    out, cache = A.attention(p.attn, cfg, h, positions, kv_cache=cache,
                             cache_index=cache_index)
    x = x + out
    h = L.norm(cfg.norm, p.norm2, x)
    out = L.ffn(p.ffn, h, cfg.act, getattr(torch, cfg.dtype))
    return x + out, cache


# ---------------------------------------------------------------------------
# the full stack
# ---------------------------------------------------------------------------

class Stack(nn.Module):
    """``prefix``: one Block per prefix sub-layer; ``periods``: one
    ``ModuleDict`` of ``sub{i}`` Blocks per period."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        prefix, period, n_periods = layer_plan(cfg)
        self.prefix = nn.ModuleList([Block(cfg, sub, device)
                                     for sub in prefix])
        self.periods = nn.ModuleList([
            nn.ModuleDict({f"sub{i}": Block(cfg, sub, device)
                           for i, sub in enumerate(period)})
            for _ in range(n_periods)])


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int,
                     device="cuda"):
    prefix, period, n_periods = layer_plan(cfg)
    return {"prefix": [init_sublayer_cache(cfg, sub, batch, max_len, device)
                       for sub in prefix],
            "periods": [{f"sub{i}": init_sublayer_cache(cfg, sub, batch,
                                                        max_len, device)
                         for i, sub in enumerate(period)}
                        for _ in range(n_periods)]}


def _remat_wrap(cfg: ModelConfig, fn):
    """``fn`` recomputed in the backward pass for ``remat="full"``."""
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        raise NotImplementedError(
            "remat='dots' (keep the matmul outputs, recompute the rest) is "
            "not ported to repro_torch yet: ROADMAP.md §1 item 4")
    return fn


def apply_stack(params: Stack, cfg: ModelConfig, x, positions, cache=None,
                cache_index=None):
    """returns (x, cache, total_aux); the cache is updated in place and the
    auxiliary loss of a dense stack is 0.  Periods are rematerialised as
    ``cfg.remat`` says when gradients are on and there is no cache."""
    prefix, period, n_periods = layer_plan(cfg)
    for i in range(len(prefix)):
        c = cache["prefix"][i] if cache is not None else None
        x, _ = apply_sublayer(params.prefix[i], cfg, x, positions, c,
                              cache_index)

    def period_body(x, blocks, pcache):
        for i in range(len(period)):
            c = pcache[f"sub{i}"] if pcache is not None else None
            x, _ = apply_sublayer(blocks[f"sub{i}"], cfg, x, positions, c,
                                  cache_index)
        return x

    body = period_body
    if cache is None and torch.is_grad_enabled():
        body = _remat_wrap(cfg, period_body)
    for j in range(n_periods):
        pcache = cache["periods"][j] if cache is not None else None
        x = body(x, params.periods[j], pcache)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)
