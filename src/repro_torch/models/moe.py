"""Mixture-of-Experts FFN, as the JAX package's ``repro.models.moe``:
top-k token-choice routing with per-group capacity, shared experts
(DeepSeekMoE), per-expert batched matrix products, and a Switch-style
load-balance auxiliary loss.

Dispatch is permutation-based: the (token, slot) pairs are sorted by expert
id (a stable sort), each pair's rank inside its expert's run is its slot in
the (E, C, D) buffer, and pairs ranked at or beyond the capacity C are
dropped.  Every expert computes its C slots whether they are filled or not,
so the expert products cost E·C rows a group.

The router's softmax is ``torch.softmax``, as the JAX package's is
``jax.nn.softmax``: the COPIFT kernel runs where the JAX package calls it,
in attention.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.parallel import autoshard

GROUP = 4096          # tokens per dispatch group (bounds the (E,C,D) buffer)


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


class ExpertBank(nn.Module):
    """``n`` experts' weights: ``up`` and ``gate`` (n, d, df), ``down``
    (n, df, d), in the compute dtype."""

    def __init__(self, n: int, d: int, df: int, gated: bool, dtype, device):
        super().__init__()
        self.up = L._param((n, d, df), dtype, device)
        self.down = L._param((n, df, d), dtype, device)
        self.gate = L._param((n, d, df), dtype, device) if gated else None

    def init_(self, generator: torch.Generator) -> None:
        d, df = self.up.shape[1:]
        L.truncnorm_(self.up, d ** -0.5, generator)
        L.truncnorm_(self.down, df ** -0.5, generator)
        if self.gate is not None:
            L.truncnorm_(self.gate, d ** -0.5, generator)


class MoE(nn.Module):
    """``router`` (d, E), ``experts`` and, with shared experts, ``shared``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        e = cfg.moe
        d, df = cfg.d_model, (e.d_expert or cfg.d_ff)
        dt = getattr(torch, cfg.dtype)
        gated = cfg.act in ("swiglu", "geglu")
        self.router = L.Linear(d, e.n_experts, dt, device)
        self.experts = ExpertBank(e.n_experts, d, df, gated, dt, device)
        self.shared = (ExpertBank(e.n_shared, d, df, gated, dt, device)
                       if e.n_shared else None)


def _bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.bmm(x, w)`` of (E, M, K) and (E, K, N).  On DTensors it runs
    on each rank's shards in ``w``'s layout: a mesh dimension that shards
    ``w``'s experts or its contraction takes ``x``'s matching slice and
    gives a result sharded on the experts or holding partial sums; one
    that shards ``w``'s columns gives a result sharded on them.  The layout
    is the rule table's, and DTensor's search for a batched product's
    sharding over a 3-D mesh takes minutes."""
    if not isinstance(w, DTensor):
        return torch.bmm(x, w)
    mesh = w.device_mesh
    need, out = [], []
    for p in w.placements:
        d = p.dim if p.is_shard() else None
        need.append(Shard(0) if d == 0 else Shard(2) if d == 1
                    else Replicate())
        out.append(Shard(0) if d == 0 else Partial() if d == 1
                   else Shard(2) if d == 2 else Replicate())
    if list(x.placements) != need:
        x = x.redistribute(mesh, need)
    y = torch.bmm(x.to_local(), w.to_local())
    return DTensor.from_local(y, mesh, out, run_check=False)


def _expert_ffn(bank: ExpertBank, x: torch.Tensor, cfg: ModelConfig):
    """x: (E, C, D) → (E, C, D) by per-expert batched matrix products."""
    dt = getattr(torch, cfg.dtype)
    up = L.reduced(_bmm(x, bank.up.to(dt)))
    if bank.gate is not None:
        up = up * L.act_fn(cfg.act, L.reduced(_bmm(x, bank.gate.to(dt))))
    else:
        up = L.act_fn(cfg.act, up)
    return _bmm(up, bank.down.to(dt))


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert for a group of ``n_tokens``, in the JAX package's
    float64 arithmetic."""
    e = cfg.moe
    return int(np.ceil(n_tokens * e.top_k / e.n_experts * e.capacity_factor))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries of each row, the lower
    index first among equal values, as ``jax.lax.top_k`` orders them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_group(p: MoE, cfg: ModelConfig, xg: torch.Tensor):
    """Route one token group.  xg: (S, D) → (out (S, D), aux_loss scalar).

    A sharded group (a DTensor) is gathered first: capacity and the
    dispatch order are the whole group's.  Every rank then routes the
    whole group on its local copy, with plain ops (the same on every rank,
    and none of them needs a DTensor sharding rule), and computes its
    shards of the expert banks (``_bmm``)."""
    e = cfg.moe
    dt = getattr(torch, cfg.dtype)
    xg = L.replicated(xg)
    S, D = xg.shape
    E, K = e.n_experts, e.top_k
    C = capacity(cfg, S)
    dev = xg.device

    logits = L.linear(p.router, xg, torch.float32)           # (S, E)
    if isinstance(xg, DTensor):
        mesh = xg.device_mesh

        def wrap(t):
            return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                      run_check=False)

        xg, logits = xg.to_local(), L.replicated(logits).to_local()
    else:
        def wrap(t):
            return t

    probs = torch.softmax(logits, dim=-1)
    gate, idx = top_k(probs, K)                              # (S, K)
    gate = gate / gate.sum(dim=-1, keepdim=True)             # renormalize

    # Switch load-balance loss: E · Σ_e f_e · p_e, f from the first choice.
    me = probs.mean(dim=0)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, idx[:, 0], torch.ones(S, dtype=torch.float32, device=dev)) / S
    aux = E * (me * ce).sum()

    # --- permutation dispatch: sort (token, slot) pairs by expert.
    flat_e = idx.reshape(-1)                                 # (S·K,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=dev),
                                side="left")
    pos = torch.arange(S * K, device=dev) - starts[sorted_e]  # rank in expert
    keep = pos < C
    slot = torch.where(keep, pos, 0)
    tok = order // K                                         # source token
    # Dropped pairs add 0 at slot 0 of their expert, as the JAX scatter does.
    vals = torch.where(keep[:, None], xg[tok].to(dt), 0)
    buf = torch.zeros((E, C, D), dtype=dt, device=dev).index_put(
        (sorted_e, slot), vals, accumulate=True)

    h = _expert_ffn(p.experts, wrap(buf), cfg)               # (E, C, D)
    if isinstance(h, DTensor):
        h = L.replicated(h).to_local()

    # --- combine: each (token, slot) reads back its expert output.
    slot_val = torch.where(keep[:, None], h[sorted_e, slot], 0)   # (S·K, D)
    inv = torch.argsort(order, stable=True)                  # undo the sort
    per_slot = slot_val[inv].reshape(S, K, D)
    out = wrap((per_slot * gate[..., None].to(dt)).sum(dim=1))

    if p.shared is not None:
        xs = xg.to(dt)[None].expand(e.n_shared, S, D)        # (n_shared,S,D)
        out = out + L.replicated(_expert_ffn(p.shared, wrap(xs),
                                             cfg)).sum(dim=0)
    return out, wrap(aux)


def moe_ffn(p: MoE, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, T, D) → (out, aux_loss).

    Routing groups are batch rows: capacity is enforced per row, and the
    auxiliary loss is the mean over rows.  Small inputs (at most ``GROUP``
    tokens) and decode (one token a row) take one group of the flattened
    batch."""
    B, T, D = x.shape
    if B * T <= GROUP or T == 1:
        out, aux = _dispatch_group(p, cfg, x.reshape(B * T, D))
        return out.reshape(B, T, D), aux
    outs, auxs = zip(*(_dispatch_group(p, cfg, x[b]) for b in range(B)))
    return autoshard.hidden(torch.stack(outs)), torch.stack(auxs).mean()
