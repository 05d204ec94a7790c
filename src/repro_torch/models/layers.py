"""Primitive layers: linear, norms, rotary embeddings, activations,
embedding tables.

Conventions (the JAX package's ``repro.models.layers``, in PyTorch idiom):
* parameters live in ``nn.Module``s whose attribute names follow the JAX
  parameter tree, so ``repro_torch.convert`` maps one onto the other;
* weight matrices are (d_in, d_out) and stored in the compute dtype, 1-D
  parameters (norm gains, biases) in fp32 until ``models.model`` applies
  the JAX package's cast rule (``working_dtype``), which puts a period's
  1-D parameters in the compute dtype too;
* modules are created on an explicit ``device`` with uninitialised storage;
  ``init_`` fills them from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)


def _param(shape, dtype, device) -> nn.Parameter:
    # Created without gradients, as serving needs none;
    # ``train.train_step.init_train_state`` turns them on for the working
    # copy that training differentiates.
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def truncnorm_(p: torch.Tensor, scale: float,
               generator: torch.Generator) -> None:
    """Fill ``p`` with a standard normal truncated to ±2, times ``scale``,
    drawn in fp32 and cast to ``p``'s dtype (as ``layers._truncnorm``)."""
    w = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    p.copy_(w * scale)


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``t``, a tensor the model makes that every rank would make whole
    (positions, masks, rotary frequencies, constants), as a replicated
    DTensor on ``ref``'s mesh when ``ref`` is a DTensor (the sharded step),
    else ``t`` itself: DTensor ops take no plain tensor beside a DTensor."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def sharded_like(t: torch.Tensor, ref: torch.Tensor,
                 dims: tuple[int | None, ...] | None = None) -> torch.Tensor:
    """``t``, a tensor the model makes whole on every rank whose dimensions
    are ``ref``'s leading ones (positions beside a (B, T, D) activation),
    or ``ref``'s dimensions ``dims`` (one entry per dimension of ``t``,
    ``None`` for one ``ref`` does not have: a zero state (B, H, hs, hs)
    beside a (B, T, H, hs) input is ``dims=(0, 2, None, None)``), as a
    DTensor sharded where ``ref`` shards those dimensions and replicated
    elsewhere; each rank keeps its shard, with no collective.  ``t``
    itself when ``ref`` is no DTensor."""
    if not isinstance(ref, DTensor):
        return t
    dims = tuple(range(t.ndim)) if dims is None else tuple(dims)
    placements = [Shard(dims.index(p.dim)) if p.is_shard() and p.dim in dims
                  else Replicate() for p in ref.placements]
    return distribute_tensor(t, ref.device_mesh, placements,
                             src_data_rank=None)


def split_dim(x: torch.Tensor, dim: int, sizes: tuple[int, ...]):
    """``x`` with dimension ``dim`` split into ``sizes`` (a view).  A DTensor
    sharded on ``dim`` over n ranks in all splits so only if ``sizes[0]``
    divides by n; otherwise the dimension is gathered first, as XLA
    reshards before such a reshape (the TP heads of a model with fewer
    heads than ranks)."""
    dim = dim % x.ndim
    if isinstance(x, DTensor):
        n = math.prod(x.device_mesh.size(i)
                      for i, p in enumerate(x.placements)
                      if p.is_shard() and p.dim == dim)
        if sizes[0] % n:
            x = whole(x, dim)
    return x.unflatten(dim, sizes)


def whole(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dimension ``dim`` gathered where a DTensor shards it (a
    gather or a reshape needs it whole); any other tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    pl = [Replicate() if p.is_shard() and p.dim == dim else p
          for p in x.placements]
    return x if pl == list(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """``x`` made whole on every rank (all-gathered and all-reduced) when
    it is a DTensor; any other tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def reduced(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its partial sums all-reduced when it is a DTensor that
    holds them (a contraction over a sharded dimension gives them), where
    the next op is not linear; any other tensor as it is."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


# ---------------------------------------------------------------------------
# linear / embedding
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """``w`` (d_in, d_out) and an optional fp32 bias ``b``."""

    def __init__(self, d_in: int, d_out: int, dtype, device,
                 bias: bool = False, scale: float | None = None):
        super().__init__()
        self.scale = scale if scale is not None else d_in ** -0.5
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), torch.float32, device) if bias else None

    def init_(self, generator: torch.Generator) -> None:
        truncnorm_(self.w, self.scale, generator)
        if self.b is not None:
            self.b.data.zero_()


def linear(p: Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    # A product of partial sums would be the whole product on every rank
    # of their axis: they are reduced first.
    y = reduced(x).to(dtype) @ p.w.to(dtype)
    if p.b is not None:
        y = y + p.b.to(dtype)
    return y


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device):
        super().__init__()
        self.table = _param((vocab, d), dtype, device)

    def init_(self, generator: torch.Generator) -> None:
        truncnorm_(self.table, self.table.shape[1] ** -0.5, generator)


def embed(p: Embedding, ids: torch.Tensor, dtype) -> torch.Tensor:
    # ``F.embedding`` rather than indexing: the same gather, and DTensor
    # shards its backward (a sharded batch gives a partial-sum gradient of
    # the replicated table), where an index's backward replicates the ids.
    # A vocabulary-sharded table gives masked partial sums, which DTensor
    # can reduce only once: they are reduced here.  The table's d is
    # gathered where FSDP shards it, as FSDP gathers a parameter: left
    # sharded, DTensor gathers the batch's ids to every rank of the axis
    # instead, and moves the (B, T, d/n) result onto the batch's shards.
    return reduced(F.embedding(ids, whole(p.table.to(dtype), 1)))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """The learned part of a norm: none for ``nonparam_ln``, ``g`` and ``b``
    for ``layernorm``, ``g`` for the RMSNorms."""

    def __init__(self, kind: str, d: int, device):
        super().__init__()
        self.kind = kind
        learned = kind != "nonparam_ln"
        self.g = _param((d,), torch.float32, device) if learned else None
        self.b = (_param((d,), torch.float32, device)
                  if kind == "layernorm" else None)

    def init_(self, generator: torch.Generator | None = None) -> None:
        if self.g is not None:
            self.g.data.fill_(1.0)
        if self.b is not None:
            self.b.data.zero_()


def norm(kind: str, p: Norm, x: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if kind in ("layernorm", "nonparam_ln"):
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * p.g.to(torch.float32) + p.b.to(torch.float32)
        return y.to(x.dtype)
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps)
    g = p.g.to(torch.float32)
    if kind == "gemma_rmsnorm":               # gemma scales by (1 + g)
        y = y * (1.0 + g)
    else:
        y = y * g
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE and qwen2-vl's M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def _rotate_pairs(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, T, H, Dh); positions: (B, T) int."""
    inv = replicated_like(rope_freqs(x.shape[-1], theta, x.device),
                          positions)                          # (Dh/2,)
    ang = positions[..., None].to(torch.float32) * inv        # (B, T, Dh/2)
    return _rotate_pairs(x, ang)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple[int, int, int]) -> torch.Tensor:
    """qwen2-vl M-RoPE: the Dh/2 frequency slots are split into (t, h, w)
    sections, each rotated by its own position stream.

    x: (B, T, H, Dh); positions3: (3, B, T).  For text tokens the three
    streams are equal, which reduces exactly to 1-D RoPE.
    """
    d_head = x.shape[-1]
    inv = replicated_like(rope_freqs(d_head, theta, x.device), positions3)
    sec = np.asarray(sections)
    if sec.sum() != d_head // 2:
        raise ValueError(f"M-RoPE sections {sections} do not sum to "
                         f"d_head/2 = {d_head // 2}")
    # The stream of each frequency slot, made where x lies (no copy from
    # the host, which a CUDA graph of a decode step could not capture).
    slot = torch.arange(d_head // 2, device=x.device)
    sel = replicated_like((slot >= int(sec[0])).long()
                          + (slot >= int(sec[0] + sec[1])).long(), positions3)
    pos = positions3.index_select(0, sel)                     # (Dh/2, B, T)
    ang = pos.movedim(0, -1).to(torch.float32) * inv
    return _rotate_pairs(x, ang)


# ---------------------------------------------------------------------------
# activations / gated FFN
# ---------------------------------------------------------------------------

def act_fn(kind: str, x: torch.Tensor) -> torch.Tensor:
    if kind in ("swiglu", "silu"):
        return F.silu(x)
    # geglu / gelu: gemma uses tanh-approximated GELU.
    return F.gelu(x, approximate="tanh")


class FFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str, dtype, device):
        super().__init__()
        self.up = Linear(d_model, d_ff, dtype, device)
        self.down = Linear(d_ff, d_model, dtype, device, scale=d_ff ** -0.5)
        self.gate = (Linear(d_model, d_ff, dtype, device)
                     if act in ("swiglu", "geglu") else None)


def ffn(p: FFN, x: torch.Tensor, act: str, dtype) -> torch.Tensor:
    up = linear(p.up, x, dtype)
    if p.gate is not None:
        up = up * act_fn(act, linear(p.gate, x, dtype))
    else:
        up = act_fn(act, up)
    return linear(p.down, up, dtype)
