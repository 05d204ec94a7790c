"""COPIFT log: the CUDA kernel ``csrc/logf.cu``, its wrapper and its plain
PyTorch version.

The kernel replaces the JAX package's ``repro/kernels/logf.py:_log_kernel``:
glibc-style logf on positive normals, with the 16-entry ``invc``/``logc``
tables gathered at an integer-computed index.  It maps lanes with
``x <= 0`` to 1.0 before the INT phase, as the JAX package's ``ops.log``
does before its Pallas kernel; ``log_plain`` does the same, so the two agree
on every input.  ``ref.log_ref`` has no such map (nor has the JAX oracle).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import log_ref, logf_tables


def log_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the log kernel: fp32 in, fp32 out, ``log_ref``'s
    phases after the ``x <= 0 → 1`` map."""
    x = x.to(torch.float32)
    return log_ref(torch.where(x <= 0, 1.0, x))


_ARGS = (_build.PTR, _build.PTR, _build.I64, _build.PTR, _build.PTR,
         _build.PTR)


def log_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/logf.cu`` on a contiguous fp32 CUDA tensor."""
    _build.check_cuda_tensor(x, (torch.float32,), "log_cuda")
    y = torch.empty_like(x)
    if x.numel():
        invc, logc = logf_tables(x.device)
        _build.launch("logf", "copift_log_f32", _ARGS, x.data_ptr(),
                      y.data_ptr(), x.numel(), invc.data_ptr(),
                      logc.data_ptr(), _build.stream(x))
        log_cuda.launches += 1
    return y


log_cuda.launches = 0
