"""Decode attention over a KV cache: the CUDA kernels ``csrc/decode_attn.cu``,
their wrappers and their plain PyTorch versions.

One query a row, ``q`` (B, 1, Hkv, g, Dh), against a cache of keys and values
(B, S, Hkv, Dh) whose slots [lo, hi) the causal and sliding-window mask
keeps.  ``decode_scores`` gives the fp32 scores (B, Hkv, g, 1, S): the scaled
dot products on [lo, hi), ``NEG_INF`` elsewhere; the softmax runs between;
``decode_pv`` gives the probabilities times the values (B, 1, Hkv, g, Dh) in
the cache's dtype.  The kernels read the cache in place, once, and only on
[lo, hi); they replace no TPU kernel (the JAX package leaves decode
attention to XLA).

The plain versions keep the arithmetic of the port's einsum path: the fp32
score product over every slot, times the scale, plus the mask's bias and
the validity bias, added in that order (a slot past the position, masked by
both, reads -inf); the PV product over every slot.  Their outputs are the
einsum path's bit for bit.  The kernels sum in another order; the softmax
gives exactly 0 wherever either version masks, so the probabilities and
the PV product agree but for that order.

The CUDA wrappers take the position as a 0-d int64 tensor on the card and
a sliding window, and the kernels work out [lo, hi) from it there, so that
a CUDA graph of a decode step replays unchanged as the position moves.  The
plain versions take [lo, hi) as ints or as 0-d tensors (``bounds``), with
the same bits.

``decode_scores_cuda.launches`` and ``decode_pv_cuda.launches`` count the
wrappers' launches; a CUDA graph's replays launch without calling them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

#: The additive mask of a score attention leaves out: -0.7 of fp32's
#: largest, so that a sum of two of them, or one and a score, stays
#: negative and the softmax's exp gives 0.
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

#: Blocks a launch aims for: about two on each of the H100's 132 SMs.
TARGET_BLOCKS = 2 * 132
#: ``csrc/decode_attn.cu``: threads a block, slots a lane has in flight,
#: the largest head size, the most query heads a KV head and the most
#: blocks a pair (a cluster's, for the PV product).
THREADS, UNROLL, MAX_DH, MAX_GROUP, MAX_SPLITS = 128, 4, 256, 8, 8


def bounds(pos, window: int = 0):
    """[lo, hi) of the query at position ``pos`` (an int, or a 0-d integer
    tensor: then 0-d tensors, but a ``lo`` of 0 without a window): the
    slots the causal mask and a sliding window of ``window`` slots (0:
    none) keep."""
    if not window:
        return 0, pos + 1
    if isinstance(pos, torch.Tensor):
        return torch.clamp(pos - (window - 1), min=0), pos + 1
    return max(0, pos - window + 1), pos + 1


def _bias(S: int, lo, hi, device) -> torch.Tensor:
    """(1, S): the causal and sliding-window mask at the query's position
    plus the mask of the cache slots past it, as the einsum path adds
    them; ``lo`` and ``hi`` ints or 0-d tensors."""
    pos = torch.arange(S, device=device)[None, :]
    keep = (pos >= lo) & (pos < hi)
    bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32)
    return bias + torch.where(pos < hi, 0.0, NEG_INF).to(torch.float32)


def decode_scores_plain(q: torch.Tensor, k_cache: torch.Tensor, lo, hi,
                        scale: float) -> torch.Tensor:
    """Plain version of ``decode_scores``: every slot's fp32 dot product,
    times ``scale``, plus the bias."""
    scores = torch.einsum("bthgd,bshd->bhgts", q.to(torch.float32),
                          k_cache.to(torch.float32))
    scores = scores * scale
    bias = _bias(k_cache.shape[1], lo, hi, q.device)
    return scores + bias[None, None, None]


def decode_pv_plain(p: torch.Tensor, v_cache: torch.Tensor, lo,
                    hi) -> torch.Tensor:
    """Plain version of ``decode_pv``: the product over every slot (``p`` is
    0 outside [lo, hi)); ``lo`` and ``hi`` change no value."""
    return torch.einsum("bhgts,bshd->bthgd", p, v_cache)


def lanes_per_slot(dh: int) -> int:
    """Lanes a cache slot takes: ``dh / 8`` rounded up to a power of 2."""
    return 1 << max(0, (dh // 8 - 1).bit_length())


def splits(pairs: int, rows: int, dh: int) -> int:
    """Blocks each (batch row, KV head) pair takes along its ``rows`` cache
    slots: the least of 1, 2, 4, 8 that gives the launch ``TARGET_BLOCKS``
    blocks, as long as each block keeps a whole pass of its warps over the
    slots (``THREADS / 32`` warps, ``32 / lanes_per_slot`` slots a warp,
    ``UNROLL`` a lane)."""
    per_pass = THREADS // 32 * (32 // lanes_per_slot(dh)) * UNROLL
    k = 1
    while (k < MAX_SPLITS and pairs * k < TARGET_BLOCKS
           and rows >= 2 * k * per_pass):
        k *= 2
    return k


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I64, _INT, _F32 = _build.PTR, _build.I64, _build.INT, _build.F32
_SCORES_ARGS = (_P, _P, _P, _I64, _INT, _INT, _INT, _I64, _P, _I64, _INT,
                _F32, _F32, _P)
_PV_ARGS = (_P, _P, _P, _I64, _INT, _INT, _INT, _I64, _P, _I64, _INT, _INT,
            _P)


def _check(x: torch.Tensor, cache: torch.Tensor, shape: tuple, g: int,
           pos: torch.Tensor, window: int, what: str) -> None:
    """Raise unless ``x`` (a query or probabilities, of ``shape`` with ``g``
    query heads a KV head), ``cache`` (B, S, Hkv, Dh), the position ``pos``
    (a 0-d int64 tensor beside them) and ``window`` are what the kernel
    takes: shapes, dtypes and layout first, then the device."""
    if cache.ndim != 4 or tuple(x.shape) != shape:
        raise ValueError(f"{what}: expected {shape} beside a (B, S, Hkv, Dh) "
                         f"cache, got {tuple(x.shape)} and "
                         f"{tuple(cache.shape)}")
    if cache.dtype not in _SUFFIX or x.dtype != cache.dtype:
        raise TypeError(f"{what}: dtypes {x.dtype} and {cache.dtype}; the "
                        f"kernel takes one of {tuple(_SUFFIX)} for both")
    if not isinstance(pos, torch.Tensor) or pos.ndim or \
            pos.dtype != torch.int64:
        raise TypeError(f"{what}: the position is a 0-d int64 tensor, got "
                        f"{pos!r}")
    if not (x.is_contiguous() and cache.is_contiguous()):
        raise ValueError(f"{what}: expected contiguous tensors")
    dh = cache.shape[-1]
    if dh % 8 or dh > MAX_DH:
        raise ValueError(f"{what}: head size {dh} is not a multiple of 8 "
                         f"up to {MAX_DH}")
    if not 1 <= g <= MAX_GROUP:
        raise ValueError(f"{what}: {g} query heads a KV head, not 1 to "
                         f"{MAX_GROUP}")
    if window < 0:
        raise ValueError(f"{what}: window {window} < 0")
    for t in (x, cache):
        _build.check_cuda_tensor(t, (cache.dtype,), what)
    if not x.device == cache.device == pos.device:
        raise ValueError(f"{what}: inputs on {x.device}, {cache.device} and "
                         f"{pos.device}")
    if x.data_ptr() % 16 or cache.data_ptr() % 16:
        raise ValueError(f"{what}: an input is not 16-byte aligned")


def _dims(cache: torch.Tensor, x: torch.Tensor, group_dim: int):
    """(B, S, Hkv, Dh) of the cache and g of ``x``; zeros for a rank that
    is not the kernel's, which ``_check`` then refuses."""
    B, S, Hkv, Dh = cache.shape if cache.ndim == 4 else (0,) * 4
    return B, S, Hkv, Dh, x.shape[group_dim] if x.ndim == 5 else 0


def decode_scores_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                       pos: torch.Tensor, window: int,
                       scale: float) -> torch.Tensor:
    """Launch ``csrc/decode_attn.cu``'s score product at the slots
    ``bounds(pos, window)``, the position ``pos`` (a 0-d int64 tensor) read
    on the card: ``q`` (B, 1, Hkv, g, Dh) and ``k_cache`` (B, S, Hkv, Dh),
    contiguous CUDA tensors of one dtype, bf16 or fp32; fp32 scores (B,
    Hkv, g, 1, S)."""
    B, S, Hkv, Dh, g = _dims(k_cache, q, 3)
    _check(q, k_cache, (B, 1, Hkv, g, Dh), g, pos, window,
           "decode_scores_cuda")
    out = torch.empty((B, Hkv, g, 1, S), dtype=torch.float32,
                      device=q.device)
    _build.launch("decode_attn", f"decode_scores_{_SUFFIX[q.dtype]}",
                  _SCORES_ARGS, q.data_ptr(), k_cache.data_ptr(),
                  out.data_ptr(), B, Hkv, g, Dh, S, pos.data_ptr(), window,
                  splits(B * Hkv, S, Dh), scale, NEG_INF, _build.stream(q))
    decode_scores_cuda.launches += 1
    return out


decode_scores_cuda.launches = 0


def decode_pv_cuda(p: torch.Tensor, v_cache: torch.Tensor, pos: torch.Tensor,
                   window: int) -> torch.Tensor:
    """Launch ``csrc/decode_attn.cu``'s PV product at the slots
    ``bounds(pos, window)``, the position ``pos`` (a 0-d int64 tensor) read
    on the card: ``p`` (B, Hkv, g, 1, S) and ``v_cache`` (B, S, Hkv, Dh),
    contiguous CUDA tensors of one dtype, bf16 or fp32; (B, 1, Hkv, g, Dh)
    in that dtype, summed in fp32 over [lo, hi).  A cluster of ``splits``
    blocks over the whole cache a pair, of which the kernel uses the blocks
    ``splits`` gives the position's slots."""
    B, S, Hkv, Dh, g = _dims(v_cache, p, 2)
    _check(p, v_cache, (B, Hkv, g, 1, S), g, pos, window, "decode_pv_cuda")
    out = torch.empty((B, 1, Hkv, g, Dh), dtype=p.dtype, device=p.device)
    _build.launch("decode_attn", f"decode_pv_{_SUFFIX[p.dtype]}", _PV_ARGS,
                  p.data_ptr(), v_cache.data_ptr(), out.data_ptr(), B, Hkv,
                  g, Dh, S, pos.data_ptr(), window, splits(B * Hkv, S, Dh),
                  TARGET_BLOCKS, _build.stream(p))
    decode_pv_cuda.launches += 1
    return out


decode_pv_cuda.launches = 0
