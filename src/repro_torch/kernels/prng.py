"""Counter-based uniforms: the CUDA kernel ``csrc/prng.cu``, its wrapper and
its plain PyTorch version.

The kernel replaces the JAX package's ``repro/kernels/prng.py:_uniform_kernel``.
Element ``i`` seeds its own stream from ``splitmix32((i + seed) mod 2**32)``
and takes one LCG or xoshiro128+ step; the top 24 bits scale to [0, 1).  The
kernel and the plain version are bit-exact against the JAX package.
``uniform_plan`` gives the kernel's launch for a tiling ``block_rows``;
``uniform_cuda.tiling_launches`` counts the launches of each block size.

``uniform_rows_cuda`` draws a row a seed in one launch, the seeds read on
the card (the serving engine's sampler, inside a CUDA graph): row ``r`` is
``uniform_cuda(seeds[r], n)`` bit for bit; ``uniform_rows_plain`` is its
plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (_MASK, _PHI, LCG_A, LCG_C, _mul32,
                                     splitmix32, uniform_from_bits)

KINDS = {"lcg": 0, "xoshiro128p": 1}
#: The JAX package's default tile height (``repro/kernels/prng.py``); the
#: kernel's 256 threads a block correspond to it.
DEFAULT_BLOCK_ROWS = 64


def _check_args(seed: int, n: int, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of "
                         f"{tuple(KINDS)}")
    if not 0 <= int(seed) <= _MASK:
        raise ValueError(f"seed {seed} is not a uint32")
    if n < 0:
        raise ValueError(f"n={n} must be >= 0")


def uniform_plain(seed: int, n: int, kind: str = "xoshiro128p",
                  device: torch.device | str = "cpu",
                  block_rows: int | None = None) -> torch.Tensor:
    """Plain version of the uniform kernel: ``n`` fp32 values in [0, 1).
    ``block_rows`` is the kernel's tiling, which changes no bit; it is
    ignored."""
    _check_args(seed, n, kind)
    idx = (torch.arange(n, dtype=torch.int64, device=device) + int(seed)) & _MASK
    return _draw(idx, kind)


def _draw(idx: torch.Tensor, kind: str) -> torch.Tensor:
    """The uniforms of the counters ``idx`` (uint32 values in int64)."""
    if kind == "lcg":
        nxt = (_mul32(splitmix32(idx), LCG_A) + LCG_C) & _MASK
        bits = (nxt >> 9) ^ nxt
    else:
        bits = (splitmix32(idx)
                + splitmix32((idx + 3 * _PHI) & _MASK)) & _MASK
    return uniform_from_bits(bits)


def _row_seeds(seeds: torch.Tensor) -> torch.Tensor:
    """``seeds`` (R,) int32 or int64 as uint32 values in int64: an int32
    holds the seed's bits (the card's ``uint32_t``)."""
    if seeds.ndim != 1 or seeds.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"seeds: expected a 1-d int32 or int64 tensor, got "
                         f"{tuple(seeds.shape)} {seeds.dtype}")
    return seeds.to(torch.int64) & _MASK


def uniform_rows_plain(seeds: torch.Tensor, n: int,
                       kind: str = "xoshiro128p") -> torch.Tensor:
    """Plain version of ``uniform_rows_cuda``: (R, n) fp32, row ``r``
    ``uniform_plain(seeds[r], n, kind)``, on ``seeds``' device."""
    _check_args(0, n, kind)
    s = _row_seeds(seeds)
    idx = (torch.arange(n, dtype=torch.int64, device=seeds.device)[None]
           + s[:, None]) & _MASK
    return _draw(idx, kind)


class UniformPlan(NamedTuple):
    """The launch of ``csrc/prng.cu``'s grid-stride kernel: ``grid`` blocks
    of ``threads``."""
    threads: int
    grid: int


def uniform_plan(n: int, block_rows: int | None = None) -> UniformPlan:
    """``block_rows`` (the JAX package's tile height, ``DEFAULT_BLOCK_ROWS``
    when ``None``) sets the threads a block, ``_build.block_threads``; the
    grid covers ``n`` up to its cap of 132 x 16 blocks."""
    threads = _build.block_threads(block_rows or DEFAULT_BLOCK_ROWS,
                                   DEFAULT_BLOCK_ROWS)
    return UniformPlan(threads, _build.grid_stride_blocks(n, threads))


_ARGS = (_build.PTR, _build.I64, _build.U32, _build.INT, _build.INT,
         _build.PTR)


def uniform_cuda(seed: int, n: int, kind: str = "xoshiro128p",
                 device: torch.device | str = "cuda",
                 block_rows: int | None = None) -> torch.Tensor:
    """Launch ``csrc/prng.cu``: ``n`` fp32 values in [0, 1) on ``device``,
    at the tiling ``uniform_plan`` gives ``block_rows``."""
    _check_args(seed, n, kind)
    out = torch.empty(n, dtype=torch.float32, device=device)
    _build.check_cuda_tensor(out, (torch.float32,), "uniform_cuda")
    if n:
        plan = uniform_plan(n, block_rows)
        _build.launch("prng", "copift_uniform_f32", _ARGS, out.data_ptr(), n,
                      int(seed), KINDS[kind], plan.threads,
                      _build.stream(out))
        uniform_cuda.launches += 1
        _build.count_tiling(uniform_cuda, plan.threads)
    return out


uniform_cuda.launches = 0
uniform_cuda.tiling_launches = {}


_ROWS_ARGS = (_build.PTR, _build.PTR, _build.I64, _build.I64, _build.INT,
              _build.INT, _build.PTR)


def uniform_rows_cuda(seeds: torch.Tensor, n: int, kind: str = "xoshiro128p",
                      block_rows: int | None = None) -> torch.Tensor:
    """Launch ``csrc/prng.cu``'s rows kernel once: (R, n) fp32 on ``seeds``'
    device, row ``r`` drawn from ``seeds[r]`` (a contiguous (R,) int32 CUDA
    tensor holding uint32 bits, read on the card), at the tiling
    ``uniform_plan`` gives ``block_rows``."""
    _check_args(0, n, kind)
    if seeds.ndim != 1:
        raise ValueError(f"uniform_rows_cuda: seeds of shape "
                         f"{tuple(seeds.shape)}, expected (R,)")
    _build.check_cuda_tensor(seeds, (torch.int32,), "uniform_rows_cuda")
    rows = seeds.shape[0]
    out = torch.empty((rows, n), dtype=torch.float32, device=seeds.device)
    if rows and n:
        plan = uniform_plan(n, block_rows)
        _build.launch("prng", "copift_uniform_rows_f32", _ROWS_ARGS,
                      out.data_ptr(), seeds.data_ptr(), rows, n, KINDS[kind],
                      plan.threads, _build.stream(out))
        uniform_rows_cuda.launches += 1
        _build.count_tiling(uniform_rows_cuda, plan.threads)
    return out


uniform_rows_cuda.launches = 0
uniform_rows_cuda.tiling_launches = {}
