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
from repro_torch.kernels.ref import LCG_A, LCG_C

KINDS = {"lcg": 0, "xoshiro128p": 1}

_MASK = 0xFFFFFFFF
_PHI = 0x9E3779B9

# uint32 on the CPU: PyTorch has no uint32 ``+``, ``>>`` or ``<<`` there, so
# the plain version holds each uint32 word in an int64 tensor and masks with
# ``& 0xFFFFFFFF`` after every add and multiply.


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a · c) mod 2**32 for a uint32 word ``a`` held in int64 and a uint32
    constant ``c``.  The full product can pass 2**63; multiplying by the two
    16-bit halves of ``c`` keeps every partial product below 2**48, so no
    int64 overflow happens, and the low 32 bits are the uint32 product."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _splitmix32(z: torch.Tensor) -> torch.Tensor:
    z = (z + _PHI) & _MASK
    z = _mul32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mul32(z ^ (z >> 13), 0xC2B2AE35)
    return z ^ (z >> 16)


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
        nxt = (_mul32(_splitmix32(idx), LCG_A) + LCG_C) & _MASK
        bits = (nxt >> 9) ^ nxt
    else:
        bits = (_splitmix32(idx)
                + _splitmix32((idx + 3 * _PHI) & _MASK)) & _MASK
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


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
