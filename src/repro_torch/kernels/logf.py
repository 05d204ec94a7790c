"""COPIFT log: the CUDA kernel ``csrc/logf.cu``, its wrapper and its plain
PyTorch version.

The kernel replaces the JAX package's ``repro/kernels/logf.py:_log_kernel``:
glibc-style logf on positive normals, with the 16-entry ``invc``/``logc``
tables gathered at an integer-computed index.  It maps lanes with
``x <= 0`` to 1.0 before the INT phase, as the JAX package's ``ops.log``
does before its Pallas kernel; ``log_plain`` does the same, so the two agree
on every input.  ``ref.log_ref`` has no such map (nor has the JAX oracle).
``log_plan`` picks the kernel's vector or scalar path by alignment and its
tiling from ``block_rows``; ``log_cuda.path_launches`` counts the launches
of each path and ``log_cuda.tiling_launches`` those of each block size.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.expf import UNROLL
from repro_torch.kernels.ref import log_ref, logf_tables

#: The JAX package's default tile height (``repro/kernels/logf.py``); the
#: kernel's 256 threads a block correspond to it.
DEFAULT_BLOCK_ROWS = 64


def log_plain(x: torch.Tensor, block_rows: int | None = None) -> torch.Tensor:
    """Plain version of the log kernel: fp32 in, fp32 out, ``log_ref``'s
    phases after the ``x <= 0 → 1`` map.  ``block_rows`` is the kernel's
    tiling, which changes no value; it is ignored."""
    x = x.to(torch.float32)
    return log_ref(torch.where(x <= 0, 1.0, x))


class LogPlan(NamedTuple):
    """The kernel of ``csrc/logf.cu`` an input takes, with its launch:
    ``"vector"`` over ``n_vec4`` float4s and a scalar tail of ``n_tail``
    elements, ``chunk`` float4s a block; or ``"scalar"`` over all of them, a
    grid-stride loop (``chunk`` 0).  ``grid`` blocks of ``threads``."""
    path: str
    n_vec4: int
    n_tail: int
    threads: int = _build.DEFAULT_BLOCK_THREADS
    grid: int = 0
    chunk: int = 0


def log_plan(n: int, x_ptr: int, y_ptr: int,
             block_rows: int | None = None) -> LogPlan:
    """The vector kernel when both pointers are 16-byte aligned, else the
    scalar one: chosen by alignment alone.  ``block_rows`` (the JAX
    package's tile height, ``DEFAULT_BLOCK_ROWS`` when ``None``) sets the
    threads a block of either kernel, ``_build.block_threads``; the vector
    kernel's chunk is ``UNROLL`` float4s a thread."""
    threads = _build.block_threads(block_rows or DEFAULT_BLOCK_ROWS,
                                   DEFAULT_BLOCK_ROWS)
    if x_ptr % 16 or y_ptr % 16:
        return LogPlan("scalar", 0, n, threads,
                       _build.grid_stride_blocks(n, threads))
    n_vec4, chunk = n // 4, UNROLL * threads
    return LogPlan("vector", n_vec4, n % 4, threads,
                   max(1, -(-n_vec4 // chunk)), chunk)


_ARGS = {"scalar": (_build.PTR, _build.PTR, _build.I64, _build.INT,
                    _build.PTR, _build.PTR, _build.PTR),
         "vector": (_build.PTR, _build.PTR, _build.I64, _build.I64,
                    _build.INT, _build.PTR, _build.PTR, _build.PTR)}


def log_cuda(x: torch.Tensor, block_rows: int | None = None) -> torch.Tensor:
    """Launch ``csrc/logf.cu`` on a contiguous fp32 CUDA tensor, with the
    kernel and tiling ``log_plan`` gives its alignment and
    ``block_rows``."""
    _build.check_cuda_tensor(x, (torch.float32,), "log_cuda")
    y = torch.empty_like(x)
    n = x.numel()
    if n:
        invc, logc = logf_tables(x.device)
        plan = log_plan(n, x.data_ptr(), y.data_ptr(), block_rows)
        if plan.path == "vector":
            _build.launch("logf", "copift_log_vec_f32", _ARGS["vector"],
                          x.data_ptr(), y.data_ptr(), plan.n_vec4, n,
                          plan.threads, invc.data_ptr(), logc.data_ptr(),
                          _build.stream(x))
        else:
            _build.launch("logf", "copift_log_f32", _ARGS["scalar"],
                          x.data_ptr(), y.data_ptr(), n, plan.threads,
                          invc.data_ptr(), logc.data_ptr(), _build.stream(x))
        log_cuda.launches += 1
        log_cuda.path_launches[plan.path] += 1
        _build.count_tiling(log_cuda, plan.threads)
    return y


log_cuda.launches = 0
log_cuda.path_launches = {"vector": 0, "scalar": 0}
log_cuda.tiling_launches = {}
