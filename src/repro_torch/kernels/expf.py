"""COPIFT exp: the CUDA kernel ``csrc/expf.cu``, its wrapper and its plain
PyTorch version.

The kernel replaces the JAX package's ``repro/kernels/expf.py:_exp_kernel``.
``exp_phases`` is the plain version of the device function in
``csrc/copift_exp.cuh``, which the softmax kernel shares; it keeps the
kernel's phase order so that the two agree to fp32 rounding.  ``exp_plan``
picks the kernel's vector or scalar path by alignment;
``exp_cuda.path_launches`` counts the launches of each.
"""

from __future__ import annotations

import math
from typing import NamedTuple

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


class ExpPlan(NamedTuple):
    """The kernel of ``csrc/expf.cu`` an input takes: ``"vector"`` over
    ``n_vec4`` float4s and a scalar tail of ``n_tail`` elements, or
    ``"scalar"`` over all of them."""
    path: str
    n_vec4: int
    n_tail: int


def exp_plan(n: int, x_ptr: int, y_ptr: int) -> ExpPlan:
    """The vector kernel when both pointers are 16-byte aligned, else the
    scalar one: chosen by alignment alone."""
    if x_ptr % 16 or y_ptr % 16:
        return ExpPlan("scalar", 0, n)
    return ExpPlan("vector", n // 4, n % 4)


_ARGS = {"scalar": (_build.PTR, _build.PTR, _build.I64, _build.PTR),
         "vector": (_build.PTR, _build.PTR, _build.I64, _build.I64,
                    _build.PTR)}


def exp_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/expf.cu`` on a contiguous fp32 CUDA tensor, with the
    kernel ``exp_plan`` gives its alignment."""
    _build.check_cuda_tensor(x, (torch.float32,), "exp_cuda")
    y = torch.empty_like(x)
    n = x.numel()
    if n:
        plan = exp_plan(n, x.data_ptr(), y.data_ptr())
        if plan.path == "vector":
            _build.launch("expf", "copift_exp_vec_f32", _ARGS["vector"],
                          x.data_ptr(), y.data_ptr(), plan.n_vec4, n,
                          _build.stream(x))
        else:
            _build.launch("expf", "copift_exp_f32", _ARGS["scalar"],
                          x.data_ptr(), y.data_ptr(), n, _build.stream(x))
        exp_cuda.launches += 1
        exp_cuda.path_launches[plan.path] += 1
    return y


exp_cuda.launches = 0
exp_cuda.path_launches = {"vector": 0, "scalar": 0}
