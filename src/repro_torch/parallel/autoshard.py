"""Activation sharding, as the JAX package's ``repro.parallel.autoshard``,
on DTensors.

The JAX package pins the batch (or, in SP mode, the sequence) dimension of
large intermediates with sharding constraints, because XLA's propagation
may drop it inside scans.  The port's model code calls ``hidden()``,
``scores()`` and ``logits()`` at the same sites; under an active context
(``activation_sharding``) a DTensor is redistributed to the placements of
the JAX package's spec.  Without a context, or on a plain tensor, every
call is a no-op, so single-device code never sees a mesh.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from repro_torch.parallel.sharding import mesh_shape, to_placements

_TLS = threading.local()


@dataclass(frozen=True)
class ActivationSharding:
    dp: tuple[str, ...]            # data-parallel axes for the batch dim
    tp: str | None = "model"       # tensor-parallel axis
    seq_sharded: bool = False      # SP: shard T instead of B (long_500k)
    mesh: object = None

    def axis_size(self, name: str) -> int:
        return mesh_shape(self.mesh).get(name, 1) \
            if self.mesh is not None else 1


def current() -> ActivationSharding | None:
    return getattr(_TLS, "ctx", None)


@contextmanager
def activation_sharding(mesh, dp=("data",), tp="model", seq_sharded=False):
    prev = current()
    _TLS.ctx = ActivationSharding(dp=tuple(dp), tp=tp,
                                  seq_sharded=seq_sharded, mesh=mesh)
    try:
        yield
    finally:
        _TLS.ctx = prev


def _constrain(x, spec: tuple):
    """``x`` redistributed to ``spec``'s placements when it is a DTensor
    on the context's mesh, its gradient too, as a JAX sharding constraint
    constrains the cotangent; anything else is returned as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    placements = to_placements(spec, x.device_mesh, tuple(x.shape))
    if tuple(x.placements) != placements:
        x = x.redistribute(x.device_mesh, placements)
    return grad_placed(x)


def grad_placed(x):
    """``x``, whose gradient takes ``x``'s placements when it is a DTensor
    that needs one; anything else as it is."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and x.requires_grad:
        return _GradPlaced.apply(x)
    return x


class _GradPlaced(torch.autograd.Function):
    """The identity, whose gradient takes the placements of the forward's
    tensor.  DTensor otherwise lets a gradient keep the partial sums or
    shards that its op's rule gives, and a partial gradient that reaches
    a matrix product makes every rank of the axis compute the whole
    product (torch 2.11's backward of a row-parallel projection)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def _dp_size(ctx) -> int:
    n = 1
    for a in ctx.dp:
        n *= ctx.axis_size(a)
    return n


def hidden(x):
    """(B, T, D) residual stream."""
    ctx = current()
    if ctx is None or x.ndim != 3:
        return x
    if ctx.seq_sharded and x.shape[1] % _dp_size(ctx) == 0:
        return _constrain(x, (None, ctx.dp, None))
    if x.shape[0] % _dp_size(ctx) == 0:
        return _constrain(x, (ctx.dp, None, None))
    return x


def scores(s):
    """(B, Hkv, g, T, C) attention scores/probs inside chunked attention."""
    ctx = current()
    if ctx is None or s.ndim != 5:
        return s
    if s.shape[0] % _dp_size(ctx) != 0:
        return s
    m = ctx.tp if ctx.tp and ctx.tp not in ctx.dp and ctx.axis_size(ctx.tp) \
        else None
    for dim in (1, 2):
        if m and s.shape[dim] % ctx.axis_size(m) == 0:
            spec = [ctx.dp, None, None, None, None]
            spec[dim] = m
            return _constrain(s, tuple(spec))
    return _constrain(s, (ctx.dp, None, None, None, None))


def logits(x):
    """(B, T, V) (or (B, chunk, V)) readout."""
    ctx = current()
    if ctx is None or x.ndim != 3:
        return x
    m = ctx.tp if (ctx.tp and ctx.tp not in ctx.dp
                   and ctx.axis_size(ctx.tp)
                   and x.shape[-1] % ctx.axis_size(ctx.tp) == 0) else None
    if ctx.seq_sharded and x.shape[1] % _dp_size(ctx) == 0:
        return _constrain(x, (None, ctx.dp, m))
    if x.shape[0] % _dp_size(ctx) == 0:
        return _constrain(x, (ctx.dp, None, m))
    return x


def barrier(x):
    """The identity.  The JAX package's barrier is an XLA optimization
    barrier that stops the compiler from commuting a bf16 convert across
    an SPMD-inserted all-reduce (which would double the TP traffic);
    PyTorch runs the ops in program order, so there is nothing to pin."""
    return x


def tokens_nd(x):
    """(B, T) / (B, T, D) data inputs."""
    ctx = current()
    if ctx is None:
        return x
    if ctx.seq_sharded and x.ndim >= 2 and x.shape[1] % _dp_size(ctx) == 0:
        return _constrain(x, (None, ctx.dp, *([None] * (x.ndim - 2))))
    if x.shape[0] % _dp_size(ctx) == 0:
        return _constrain(x, (ctx.dp, *([None] * (x.ndim - 1))))
    return x
