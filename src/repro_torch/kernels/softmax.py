"""COPIFT row softmax: the CUDA kernel ``csrc/softmax.cu``, its wrapper and
its plain PyTorch version.

The kernel replaces the JAX package's
``repro/kernels/softmax_tpu.py:_softmax_kernel``.  Compute is fp32 and the
output keeps the input's dtype (fp32 or bf16).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.expf import exp_phases


def softmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the softmax kernel over the last axis: cast to fp32,
    row max, exp of ``x - max`` without the high clamp, divide by the row
    sum, cast back."""
    xf = x.to(torch.float32)
    m = torch.amax(xf, dim=-1, keepdim=True)
    e = exp_phases(xf - m, clamp_hi=False)
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


_ARGS = (_build.PTR, _build.PTR, _build.I64, _build.I64, _build.PTR)
_LAUNCHERS = {torch.float32: "copift_softmax_f32",
              torch.bfloat16: "copift_softmax_bf16"}


def softmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/softmax.cu`` on a contiguous (rows, cols) CUDA tensor
    of fp32 or bf16; one thread block per row."""
    _build.check_cuda_tensor(x, tuple(_LAUNCHERS), "softmax_cuda")
    if x.ndim != 2:
        raise ValueError(f"softmax_cuda: expected (rows, cols), got "
                         f"{tuple(x.shape)}")
    rows, cols = x.shape
    if rows >= 2 ** 31:
        raise ValueError(f"softmax_cuda: {rows} rows exceed one grid "
                         "dimension")
    y = torch.empty_like(x)
    if x.numel():
        _build.launch("softmax", _LAUNCHERS[x.dtype], _ARGS, x.data_ptr(),
                      y.data_ptr(), rows, cols, _build.stream(x))
        softmax_cuda.launches += 1
    return y


softmax_cuda.launches = 0
