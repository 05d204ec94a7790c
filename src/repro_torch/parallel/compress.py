"""Gradient compression for the slow cross-pod (DCI) axis: int8
quantization with error feedback; the port's copy of the JAX package's
``repro.parallel.compress``, on tensors.

``quantize_dequantize`` is the numerical core (per-tensor absmax int8,
bit for bit the JAX package's: the scale is ``max(max|g|, 1e-12) / 127``
in fp32, rounding half to even as ``jnp.round`` does); ``ef_compress``
carries the residual so the quantization error is re-injected next step
— the standard EF-SGD construction that keeps convergence despite 4x
payload reduction.  ``make_train_step(compress_pod_grads=True)`` applies
the round trip to every gradient on one device.  ``compressed_psum`` is
the collective used when training spans pods, over one mesh dimension's
process group.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

__all__ = ["quantize_dequantize", "ef_init", "ef_compress",
           "compressed_psum"]


def quantize_dequantize(g: torch.Tensor, amax: torch.Tensor | None = None):
    """Per-tensor absmax int8 round-trip. Returns (g_hat, residual).

    ``amax`` overrides ``max|g|``: the tensors of one JAX leaf that the
    port holds apart (a layer period's parameters, stacked over the
    periods in the JAX tree) share the leaf's scale."""
    g = g.to(torch.float32)
    if amax is None:
        amax = g.abs().amax()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    g_hat = q.to(torch.float32) * scale
    return g_hat, g - g_hat


def _leaves(tree):
    """The tensors of nested dicts, lists and tuples, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for sub in tree:
            yield from _leaves(sub)
    else:
        yield tree


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken from the iterator
    ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def ef_init(grads: Any) -> Any:
    return _unflatten(grads, (torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device)
                              for g in _leaves(grads)))


def ef_compress(grads: Any, error: Any):
    """Error-feedback compression: quantize (g + e), carry the residual."""
    outs = [quantize_dequantize(g.to(torch.float32) + e)
            for g, e in zip(_leaves(grads), _leaves(error))]
    g_hat = _unflatten(grads, (o[0] for o in outs))
    new_e = _unflatten(grads, (o[1] for o in outs))
    return g_hat, new_e


def compressed_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """int8-quantize, all-reduce the int payload, dequantize: the JAX
    package's ``shard_map`` collective on ``group``, one mesh dimension's
    process group (``mesh.get_group(axis)``; the default group when
    ``None``), called by every rank with its own ``g``.

    The JAX package's arithmetic and order: each rank quantizes with its
    own scale, the int32 payloads are summed, the scales reduced by max,
    and the sum dequantized with the largest scale and divided by the
    rank count.  That biases the result (ranks with smaller scales count
    too much) exactly as the JAX package's does."""
    scale = torch.clamp(g.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    # Sum int8 payloads in int32 to avoid overflow across the axis.
    summed = q.to(torch.int32)
    dist.all_reduce(summed, dist.ReduceOp.SUM, group=group)
    # Each shard contributed its own scale; use the max scale (conservative).
    max_scale = scale.clone()
    dist.all_reduce(max_scale, dist.ReduceOp.MAX, group=group)
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32,
                     device=g.device)
    return summed.to(torch.float32) * max_scale / n
