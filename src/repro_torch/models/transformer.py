"""Block assembly and the layer stack.

The stack is decomposed as in the JAX package: a non-periodic PREFIX plus a
PERIODIC tail, the smallest repeating unit of (mixer type, is-moe).  The
JAX package scans one compiled period body over stacked parameters; PyTorch
runs eagerly, so here the periods are an ``nn.ModuleList`` walked by a
Python loop, and a cache is a list with one entry per period.

When gradients are on and there is no cache, ``cfg.remat == "full"``
recomputes each period in the backward pass (``torch.utils.checkpoint``),
as the JAX package's ``jax.checkpoint`` of its period body does; the
recompute launches the period's kernels a second time.  ``"dots"`` keeps
the outputs of the period's dense projections (``aten.mm``) and recomputes
the rest, the JAX package's ``dots_with_no_batch_dims_saveable``.

Sub-layers hold the JAX package's mixers: attention (``"a"``), Mamba
(``"m"``) or RWKV-6 (``"r"``), then a dense FFN, an MoE FFN or RWKV's
channel mix.  Caches are dicts updated in place: ``k``/``v`` for
attention, ``conv`` and ``h`` for Mamba, ``x_prev``, ``S`` and
``cm_prev`` for RWKV-6.
"""

from __future__ import annotations

from dataclasses import dataclass

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.parallel import autoshard


@dataclass(frozen=True)
class SubLayer:
    mixer: str                  # 'a' | 'm' | 'r'
    is_moe: bool


def layer_plan(cfg: ModelConfig) -> tuple[list[SubLayer], list[SubLayer], int]:
    """(prefix, period, n_periods)."""
    seq = [SubLayer(cfg.layer_types[i], M.moe_layer_pattern(cfg, i))
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

class Block(nn.Module):
    """One sub-layer: norm → mixer → residual, norm → FFN → residual.  The
    mixer is ``attn``, ``mamba`` or ``rwkv`` and the FFN ``ffn``, ``moe``
    or ``cmix``, as in the JAX parameter tree."""

    def __init__(self, cfg: ModelConfig, sub: SubLayer, device):
        super().__init__()
        self.norm1 = L.Norm(cfg.norm, cfg.d_model, device)
        self.norm2 = L.Norm(cfg.norm, cfg.d_model, device)
        if sub.mixer == "a":
            self.attn = A.Attention(cfg, device)
        elif sub.mixer == "m":
            self.mamba = S.Mamba(cfg, device)
        else:
            self.rwkv = S.RWKV6(cfg, device)
        if sub.mixer == "r":
            self.cmix = S.RWKV6ChannelMix(cfg, device)
        elif sub.is_moe:
            self.moe = M.MoE(cfg, device)
        else:
            self.ffn = L.FFN(cfg.d_model, cfg.d_ff, cfg.act,
                             getattr(torch, cfg.dtype), device)


def init_sublayer_cache(cfg: ModelConfig, sub: SubLayer, batch: int,
                        max_len: int, device):
    """Decode-time state for one sub-layer."""
    dt = getattr(torch, cfg.dtype)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if sub.mixer == "a":
        shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
        return {"k": zeros(shape), "v": zeros(shape)}
    if sub.mixer == "m":
        di = cfg.ssm.expand * cfg.d_model
        return {"conv": zeros((batch, cfg.ssm.d_conv - 1, di)),
                "h": zeros((batch, di, cfg.ssm.d_state), torch.float32)}
    hs = cfg.ssm.head_dim
    H = cfg.d_model // hs
    return {"x_prev": zeros((batch, cfg.d_model)),
            "S": zeros((batch, H, hs, hs), torch.float32),
            "cm_prev": zeros((batch, cfg.d_model))}


def _store(cache: dict, **states) -> None:
    """Write a mixer's new states into its cache, in place."""
    for name, value in states.items():
        cache[name].copy_(value)


def apply_sublayer(p: Block, cfg: ModelConfig, x, positions, cache=None,
                   cache_index=None):
    """returns (x, cache, aux_loss); the cache is updated in place, and
    aux_loss is None unless the FFN is an MoE (no zero tensor to add up
    on the card for every other sub-layer)."""
    aux = None
    h = L.norm(cfg.norm, p.norm1, x)
    if hasattr(p, "attn"):
        out, cache = A.attention(p.attn, cfg, h, positions, kv_cache=cache,
                                 cache_index=cache_index)
    elif hasattr(p, "mamba"):
        state = (cache["conv"], cache["h"]) if cache is not None else None
        out, (conv, hst) = S.mamba_mix(p.mamba, cfg, h, state)
        if cache is not None:
            _store(cache, conv=conv, h=hst)
    else:
        state = (cache["x_prev"], cache["S"]) if cache is not None else None
        out, (xp, st) = S.rwkv6_mix(p.rwkv, cfg, h, state)
        if cache is not None:
            _store(cache, x_prev=xp, S=st)
    x = x + autoshard.barrier(out)

    h = L.norm(cfg.norm, p.norm2, x)
    x = autoshard.hidden(x)
    if hasattr(p, "cmix"):
        out, cmp_ = S.rwkv6_channel_mix(
            p.cmix, cfg, h, cache["cm_prev"] if cache is not None else None)
        if cache is not None:
            _store(cache, cm_prev=cmp_)
    elif hasattr(p, "moe"):
        out, aux = M.moe_ffn(p.moe, cfg, h)
    else:
        out = L.ffn(p.ffn, h, cfg.act, getattr(torch, cfg.dtype))
    return autoshard.hidden(x + autoshard.barrier(out)), cache, aux


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


#: The ops whose outputs ``remat="dots"`` keeps: products without batch
#: dimensions.  The dense projections ``x @ w`` (``layers.linear``) reach
#: the dispatcher as ``aten.mm`` on the folded (B*T, D) input; the
#: attention einsums and the expert banks, which carry batch dimensions,
#: reach it as ``aten.bmm`` and are recomputed, as under JAX's
#: ``dots_with_no_batch_dims_saveable``.
DOTS_SAVED_OPS = (torch.ops.aten.mm.default,)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in DOTS_SAVED_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(cfg: ModelConfig, fn):
    """``fn`` recomputed in the backward pass: all of it for
    ``remat="full"``, all but the outputs of ``DOTS_SAVED_OPS`` for
    ``"dots"``.  The CUDA kernels launch through ctypes into buffers the
    recompute allocates anew, so the recompute launches them again."""
    if cfg.remat == "full":
        return lambda *args: checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
        return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                        context_fn=context_fn)
    return fn


def apply_stack(params: Stack, cfg: ModelConfig, x, positions, cache=None,
                cache_index=None):
    """returns (x, cache, total_aux): the cache is updated in place, and
    total_aux is the sum of the MoE auxiliary losses over the prefix and
    the periods.  Periods are rematerialised as ``cfg.remat`` says when
    gradients are on and there is no cache."""
    prefix, period, n_periods = layer_plan(cfg)
    aux_total = L.replicated_like(
        torch.zeros((), dtype=torch.float32, device=x.device), x)
    for i in range(len(prefix)):
        c = cache["prefix"][i] if cache is not None else None
        x, _, aux = apply_sublayer(params.prefix[i], cfg, x, positions, c,
                                   cache_index)
        if aux is not None:
            aux_total = aux_total + aux

    def period_body(x, aux_acc, blocks, pcache):
        for i in range(len(period)):
            c = pcache[f"sub{i}"] if pcache is not None else None
            x, _, aux = apply_sublayer(blocks[f"sub{i}"], cfg, x, positions,
                                       c, cache_index)
            if aux is not None:
                aux_acc = aux_acc + aux
        return x, aux_acc

    body = period_body
    if cache is None and torch.is_grad_enabled():
        body = _remat_wrap(cfg, period_body)
    for j in range(n_periods):
        pcache = cache["periods"][j] if cache is not None else None
        x, aux_total = body(x, aux_total, params.periods[j], pcache)
    return x, cache, aux_total
