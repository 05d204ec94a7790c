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
from repro_torch.obs import card
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
    """(B, E, M, N) of (B, E, M, K) rows of groups and (E, K, N) experts'
    weights, from one ``torch.bmm`` of (E, B·M, K), as the JAX package's
    vmapped einsum.

    On DTensors it runs on each rank's shards in ``w``'s layout: a mesh
    dimension that shards ``w``'s experts or its contraction takes ``x``'s
    matching slice and gives a result sharded on the experts or holding
    partial sums; one that shards ``w``'s columns gives a result sharded on
    them.  A mesh dimension that shards ``x``'s rows keeps them and takes
    ``w`` whole there (the batch's data axes).  The layout is the rule
    table's, and DTensor's search for a batched product's sharding over a
    3-D mesh takes minutes."""
    if not isinstance(w, DTensor):
        return _bmm_local(x, w)
    mesh = w.device_mesh
    need, w_need, out, x_grad, w_grad = [], [], [], [], []
    for xp, p in zip(x.placements, w.placements):
        if xp.is_shard() and xp.dim == 0:    # the rows' own axis
            need.append(xp)
            w_need.append(Replicate())
            out.append(xp)
            x_grad.append(xp)
            w_grad.append(Partial())     # each rank's rows' share
            continue
        d = p.dim if p.is_shard() else None
        need.append(Shard(1) if d == 0 else Shard(3) if d == 1
                    else Replicate())
        w_need.append(p)
        out.append(Shard(1) if d == 0 else Partial() if d == 1
                   else Shard(3) if d == 2 else Replicate())
        # x's gradient sums over w's column shards.
        x_grad.append(Partial() if d == 2 else need[-1])
        w_grad.append(p)
    if list(x.placements) != need:
        x = x.redistribute(mesh, need)
    if list(w.placements) != w_need:
        w = w.redistribute(mesh, w_need)
    y = _bmm_local(x.to_local(grad_placements=x_grad),
                   w.to_local(grad_placements=w_grad))
    return DTensor.from_local(y, mesh, out, run_check=False)


def _bmm_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, E, M, K = x.shape
    y = torch.bmm(x.transpose(0, 1).reshape(E, B * M, K), w)
    return y.reshape(E, B, M, -1).transpose(0, 1)


def _expert_ffn(bank: ExpertBank, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, E, C, D) → (B, E, C, D) by per-expert batched matrix
    products."""
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
    """Route one token group.  xg: (S, D) → (out (S, D), aux_loss scalar):
    ``_dispatch_rows`` of one row.  A sharded group (a DTensor) is
    gathered first (``_Rows`` keeps shards of the row axis only):
    capacity and the dispatch order are the whole group's."""
    out, aux = _dispatch_rows(p, cfg, xg[None])
    return out[0], aux[0]


class _Rows:
    """The layout of the per-row dispatch on DTensors: each rank keeps the
    rows that the batch's placement gives it (dimension 0) and every
    other mesh dimension is replicated.  ``local`` brings a tensor to that
    layout and returns the rank's shard, ``wrap`` makes a DTensor of a
    rank's (B_local, ...) rows.  Without a mesh each is the identity."""

    def __init__(self, x: torch.Tensor):
        self.mesh = x.device_mesh if isinstance(x, DTensor) else None
        if self.mesh is not None:
            self.placements = [p if p.is_shard() and p.dim == 0
                               else Replicate() for p in x.placements]

    def local(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return t
        if list(t.placements) != self.placements:
            t = t.redistribute(self.mesh, self.placements)
        return t.to_local()

    def wrap(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return t
        return DTensor.from_local(t, self.mesh, self.placements,
                                  run_check=False)


def _dispatch_rows(p: MoE, cfg: ModelConfig, x: torch.Tensor):
    """Route each row of x (B, S, D) as its own group: the JAX package's
    ``jax.vmap`` of ``_dispatch_group``, with a leading row axis on every
    step.  Returns (out (B, S, D), aux (B,)).

    On a DTensor each rank routes the rows it holds, with plain ops (no
    DTensor has a sharding rule for ``searchsorted``): rows sharded over
    the batch are never gathered (a row's own tokens are: its capacity
    and dispatch order are the whole row's).  The (B, E, C, D) buffer, a
    DTensor of the batch's placement, reshards onto the expert banks'
    layout in ``_bmm`` and comes back to the batch's placement for the
    combine."""
    e = cfg.moe
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    rows = _Rows(x)
    x = rows.local(x)
    B, S, D = x.shape
    E, K = e.n_experts, e.top_k
    C = capacity(cfg, S)
    dev = x.device

    # The router is a DTensor product: where the rows are whole on every
    # rank (one group), its contraction splits over the router's shards.
    with card.span("moe.router") as sp:
        logits = rows.local(L.linear(p.router, rows.wrap(sp.input(x)),
                                     f32))                      # (B,S,E)
        probs = torch.softmax(logits, dim=-1)
        gate, idx = top_k(probs, K)                              # (B, S, K)
        gate = sp.output(gate / gate.sum(dim=-1, keepdim=True))  # renormalize

        # Switch load-balance loss: E · Σ_e f_e · p_e, f from the first
        # choice.
        me = probs.mean(dim=1)                                   # (B, E)
        ce = torch.zeros((B, E), dtype=f32, device=dev).scatter_add_(
            1, idx[..., 0], torch.ones((B, S), dtype=f32, device=dev)) / S
        aux = E * (me * ce).sum(dim=-1)                          # (B,)

    # --- permutation dispatch: sort (token, slot) pairs by expert.
    with card.span("moe.dispatch") as sp:
        xd = sp.input(x)
        flat_e = idx.reshape(B, S * K)
        order = torch.argsort(flat_e, dim=-1, stable=True)
        sorted_e = flat_e.gather(1, order)
        starts = torch.searchsorted(
            sorted_e, torch.arange(E, device=dev).expand(B, E).contiguous(),
            side="left")
        # Each pair's rank inside its expert's run is its slot.
        pos = torch.arange(S * K, device=dev) - starts.gather(1, sorted_e)
        keep = pos < C
        slot = torch.where(keep, pos, 0)
        tok = order // K                                     # source token
        row = torch.arange(B, device=dev)[:, None].expand(B, S * K)
        # Dropped pairs add 0 at slot 0 of their expert, as the JAX scatter
        # does.
        vals = torch.where(keep[..., None], xd[row, tok].to(dt), 0)
        buf = sp.output(torch.zeros((B, E, C, D), dtype=dt,
                                    device=dev).index_put(
            (row, sorted_e, slot), vals, accumulate=True))
        sp.count(routed=B * S * K, slots=B * E * C, kept=keep)

    with card.span("moe.experts") as sp:
        h = sp.output(rows.local(_expert_ffn(
            p.experts, rows.wrap(sp.input(buf)), cfg)))

    # --- combine: each (token, slot) reads back its expert output.
    with card.span("moe.combine") as sp:
        hc = sp.input(h)
        slot_val = torch.where(keep[..., None], hc[row, sorted_e, slot], 0)
        inv = torch.argsort(order, dim=-1, stable=True)      # undo the sort
        per_slot = slot_val.gather(1, inv[..., None].expand(B, S * K, D))
        out = sp.output((per_slot.reshape(B, S, K, D)
                         * gate[..., None].to(dt)).sum(dim=2))

    if p.shared is not None:
        with card.span("moe.experts") as sp:
            xs = sp.input(x).to(dt)[:, None].expand(B, e.n_shared, S, D)
            out = out + sp.output(rows.local(_expert_ffn(
                p.shared, rows.wrap(xs), cfg)).sum(dim=1))
    return rows.wrap(out), rows.wrap(aux)


def moe_ffn(p: MoE, cfg: ModelConfig, x: torch.Tensor):
    """x: (B, T, D) → (out, aux_loss).

    Routing groups are batch rows (``_dispatch_rows``): capacity is
    enforced per row, and the auxiliary loss is the mean over rows.  Small
    inputs (at most ``GROUP`` tokens) and decode (one token a row) take
    one group of the flattened batch."""
    B, T, D = x.shape
    if B * T <= GROUP or T == 1:
        out, aux = _dispatch_group(p, cfg, x.reshape(B * T, D))
        return out.reshape(B, T, D), aux
    out, aux = _dispatch_rows(p, cfg, x)
    return autoshard.hidden(out), aux.mean()
