"""Counter-based uniforms: the CUDA kernel ``csrc/prng.cu``, its wrapper and
its plain PyTorch version.

The kernel replaces the JAX package's ``repro/kernels/prng.py:_uniform_kernel``.
Element ``i`` seeds its own stream from ``splitmix32((i + seed) mod 2**32)``
and takes one LCG or xoshiro128+ step; the top 24 bits scale to [0, 1).  The
kernel and the plain version are bit-exact against the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (_MASK, _PHI, LCG_A, LCG_C, _mul32,
                                     splitmix32, uniform_from_bits)

KINDS = {"lcg": 0, "xoshiro128p": 1}


def _check_args(seed: int, n: int, kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of "
                         f"{tuple(KINDS)}")
    if not 0 <= int(seed) <= _MASK:
        raise ValueError(f"seed {seed} is not a uint32")
    if n < 0:
        raise ValueError(f"n={n} must be >= 0")


def uniform_plain(seed: int, n: int, kind: str = "xoshiro128p",
                  device: torch.device | str = "cpu") -> torch.Tensor:
    """Plain version of the uniform kernel: ``n`` fp32 values in [0, 1)."""
    _check_args(seed, n, kind)
    idx = (torch.arange(n, dtype=torch.int64, device=device) + int(seed)) & _MASK
    if kind == "lcg":
        nxt = (_mul32(splitmix32(idx), LCG_A) + LCG_C) & _MASK
        bits = (nxt >> 9) ^ nxt
    else:
        bits = (splitmix32(idx)
                + splitmix32((idx + 3 * _PHI) & _MASK)) & _MASK
    return uniform_from_bits(bits)


_ARGS = (_build.PTR, _build.I64, _build.U32, _build.INT, _build.PTR)


def uniform_cuda(seed: int, n: int, kind: str = "xoshiro128p",
                 device: torch.device | str = "cuda") -> torch.Tensor:
    """Launch ``csrc/prng.cu``: ``n`` fp32 values in [0, 1) on ``device``."""
    _check_args(seed, n, kind)
    out = torch.empty(n, dtype=torch.float32, device=device)
    _build.check_cuda_tensor(out, (torch.float32,), "uniform_cuda")
    if n:
        _build.launch("prng", "copift_uniform_f32", _ARGS, out.data_ptr(), n,
                      int(seed), KINDS[kind], _build.stream(out))
        uniform_cuda.launches += 1
    return out


uniform_cuda.launches = 0
