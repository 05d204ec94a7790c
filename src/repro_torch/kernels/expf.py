"""COPIFT exp: the CUDA kernel ``csrc/expf.cu``, its wrapper and its plain
PyTorch version.

The kernel replaces the JAX package's ``repro/kernels/expf.py:_exp_kernel``.
``exp_phases`` is the plain version of the device function in
``csrc/copift_exp.cuh``, which the softmax kernel shares; it keeps the
kernel's phase order so that the two agree to fp32 rounding.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _EXP2_POLY, _LN2_HI, _LN2_LO, _LOG2E


def exp_phases(x: torch.Tensor, clamp_hi: bool) -> torch.Tensor:
    """The three COPIFT phases on an fp32 tensor.  ``clamp_hi`` adds the exp
    kernel's ``x > 88 → inf``; the softmax kernel leaves it out."""
    # --- FP phase 0: z, round-to-nearest kd, Cody–Waite remainder r.
    z = x * _LOG2E
    kd = torch.round(z)               # half to even, as jnp.round and rintf
    r = (x - kd * _LN2_HI) - kd * _LN2_LO
    # --- INT phase 1: 2^kd in the exponent field.  Masked scores make kd
    # ±inf; clamping before the conversion keeps it in int32 range.
    ki = kd.clamp(-126.0, 127.0).to(torch.int32)
    s = ((ki + 127) << 23).view(torch.float32)
    # --- FP phase 2: Horner polynomial and scale.
    p = torch.full_like(r, _EXP2_POLY[0])
    for c in _EXP2_POLY[1:]:
        p = p * r + c
    y = (p * r + 1.0) * s
    if clamp_hi:
        y = torch.where(x > 88.0, math.inf, y)
    # Masked scores leave y NaN; this select, kept last, makes them 0.
    return torch.where(x < -87.0, 0.0, y)


def exp_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the exp kernel: fp32 in, fp32 out."""
    return exp_phases(x.to(torch.float32), clamp_hi=True)


_ARGS = (_build.PTR, _build.PTR, _build.I64, _build.PTR)


def exp_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/expf.cu`` on a contiguous fp32 CUDA tensor."""
    _build.check_cuda_tensor(x, (torch.float32,), "exp_cuda")
    y = torch.empty_like(x)
    if x.numel():
        _build.launch("expf", "copift_exp_f32", _ARGS, x.data_ptr(),
                      y.data_ptr(), x.numel(), _build.stream(x))
        exp_cuda.launches += 1
    return y


exp_cuda.launches = 0
