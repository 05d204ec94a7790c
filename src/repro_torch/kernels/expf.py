"""COPIFT exp: the CUDA kernel ``csrc/expf.cu``, its wrapper and its plain
PyTorch version.

The kernel replaces the JAX package's ``repro/kernels/expf.py:_exp_kernel``.
``exp_phases`` is the plain version of the device function in
``csrc/copift_exp.cuh``, which the softmax kernel shares; it keeps the
kernel's phase order so that the two agree to fp32 rounding.
``exp_phase_plan`` gives the same three phases to the COPIFT planner
(``core.copift``).  ``exp_plan``
picks the kernel's vector or scalar path by alignment and its tiling from
``block_rows``; ``exp_cuda.path_launches`` counts the launches of each path
and ``exp_cuda.tiling_launches`` those of each block size.  ``ExpFn`` gives
the exp a gradient: its forward is the kernel (or, on the CPU, the plain
version), its backward ``g * y`` in plain PyTorch from the saved output, as
the JAX package has no backward kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import _EXP2_POLY, _LN2_HI, _LN2_LO, _LOG2E

#: The JAX package's default tile height (``repro/kernels/expf.py``); the
#: kernel's 256 threads a block correspond to it.
DEFAULT_BLOCK_ROWS = 64


def exp_phases(x: torch.Tensor, clamp_hi: bool) -> torch.Tensor:
    """The three COPIFT phases on an fp32 tensor.  ``clamp_hi`` adds the exp
    kernel's ``x > 88 → inf``; the softmax kernel leaves it out.

    ``x`` enters the phases clamped to [-104, 89], as the JAX package's
    ``exp_ref`` does: the final selects overwrite every value the clamp
    moves, so the result is the kernel's, and autograd through this version
    stays finite at masked scores (an unclamped ``-inf`` makes ``r`` NaN,
    whose gradient the select would multiply by 0)."""
    kd, r = exp_phase0(x)
    return exp_phase2(x, r, exp_phase1(kd), clamp_hi)


def exp_phase0(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """FP phase 0: z, round-to-nearest kd, Cody–Waite remainder r."""
    xc = x.clamp(-104.0, 89.0)
    z = xc * _LOG2E
    kd = torch.round(z)               # half to even, as jnp.round and rintf
    r = (xc - kd * _LN2_HI) - kd * _LN2_LO
    return kd, r


def exp_phase1(kd: torch.Tensor) -> torch.Tensor:
    """INT phase 1: 2^kd in the exponent field; clamping before the
    conversion keeps it in the exponent's range."""
    ki = kd.clamp(-126.0, 127.0).to(torch.int32)
    return ((ki + 127) << 23).view(torch.float32)


def exp_phase2(x: torch.Tensor, r: torch.Tensor, s: torch.Tensor,
               clamp_hi: bool) -> torch.Tensor:
    """FP phase 2: Horner polynomial, scale and the selects on ``x``."""
    p = torch.full_like(r, _EXP2_POLY[0])
    for c in _EXP2_POLY[1:]:
        p = p * r + c
    y = (p * r + 1.0) * s
    if clamp_hi:
        y = torch.where(x > 88.0, math.inf, y)
    # Masked scores leave y NaN; this select, kept last, makes them 0.
    return torch.where(x < -87.0, 0.0, y)


def exp_phase_plan(n_elements: int):
    """The exp kernel's phases as a COPIFT plan over ``n_elements`` values
    (``core.copift``): FP phase 0 writes ``kd`` and ``r``, INT phase 1 reads
    ``kd`` and writes ``s``, FP phase 2 reads ``r`` and ``s`` and, as an
    extern, ``x``.  The block is the Table-I rule's: the largest whose
    buffer replicas fit the scratch budget.  ``core.copift.execute`` of the
    plan on ``{"x": x, "y": ...}`` gives ``exp_plain(x)`` bit for bit."""
    from repro_torch.core.copift import PhaseDef, make_plan
    from repro_torch.core.isa import Domain

    def fp0(x):
        kd, r = exp_phase0(x)
        return {"kd": kd, "r": r}

    return make_plan("expf", [
        PhaseDef(fp0, Domain.FP, writes=("kd", "r"), extern_reads=("x",)),
        PhaseDef(lambda kd: {"s": exp_phase1(kd)}, Domain.INT,
                 reads=("kd",), writes=("s",)),
        PhaseDef(lambda r, s, x: {"y": exp_phase2(x, r, s, True)},
                 Domain.FP, reads=("r", "s"), extern_reads=("x",),
                 extern_writes=("y",)),
    ], n_elements=n_elements)


def exp_plain(x: torch.Tensor, block_rows: int | None = None) -> torch.Tensor:
    """Plain version of the exp kernel: fp32 in, fp32 out.  ``block_rows``
    is the kernel's tiling, which changes no value; it is ignored."""
    return exp_phases(x.to(torch.float32), clamp_hi=True)


class ExpPlan(NamedTuple):
    """The kernel of ``csrc/expf.cu`` an input takes, with its launch:
    ``"vector"`` over ``n_vec4`` float4s and a scalar tail of ``n_tail``
    elements, ``chunk`` float4s a block; or ``"scalar"`` over all of them, a
    grid-stride loop (``chunk`` 0).  ``grid`` blocks of ``threads``."""
    path: str
    n_vec4: int
    n_tail: int
    threads: int = _build.DEFAULT_BLOCK_THREADS
    grid: int = 0
    chunk: int = 0


#: float4s a thread of the vector kernel loads before it computes
#: (``csrc/expf.cu``'s kUnroll); ``csrc/logf.cu`` has the same.
UNROLL = 2


def exp_plan(n: int, x_ptr: int, y_ptr: int,
             block_rows: int | None = None) -> ExpPlan:
    """The vector kernel when both pointers are 16-byte aligned, else the
    scalar one: chosen by alignment alone.  ``block_rows`` (the JAX
    package's tile height, ``DEFAULT_BLOCK_ROWS`` when ``None``) sets the
    threads a block of either kernel, ``_build.block_threads``; the
    vector kernel's chunk is ``UNROLL`` float4s a thread."""
    threads = _build.block_threads(block_rows or DEFAULT_BLOCK_ROWS,
                                   DEFAULT_BLOCK_ROWS)
    if x_ptr % 16 or y_ptr % 16:
        return ExpPlan("scalar", 0, n, threads,
                       _build.grid_stride_blocks(n, threads))
    n_vec4, chunk = n // 4, UNROLL * threads
    return ExpPlan("vector", n_vec4, n % 4, threads,
                   max(1, -(-n_vec4 // chunk)), chunk)


_ARGS = {"scalar": (_build.PTR, _build.PTR, _build.I64, _build.INT,
                    _build.PTR),
         "vector": (_build.PTR, _build.PTR, _build.I64, _build.I64,
                    _build.INT, _build.PTR)}


def exp_cuda(x: torch.Tensor, block_rows: int | None = None) -> torch.Tensor:
    """Launch ``csrc/expf.cu`` on a contiguous fp32 CUDA tensor, with the
    kernel and tiling ``exp_plan`` gives its alignment and ``block_rows``."""
    _build.check_cuda_tensor(x, (torch.float32,), "exp_cuda")
    y = torch.empty_like(x)
    n = x.numel()
    if n:
        plan = exp_plan(n, x.data_ptr(), y.data_ptr(), block_rows)
        if plan.path == "vector":
            _build.launch("expf", "copift_exp_vec_f32", _ARGS["vector"],
                          x.data_ptr(), y.data_ptr(), plan.n_vec4, n,
                          plan.threads, _build.stream(x))
        else:
            _build.launch("expf", "copift_exp_f32", _ARGS["scalar"],
                          x.data_ptr(), y.data_ptr(), n, plan.threads,
                          _build.stream(x))
        exp_cuda.launches += 1
        exp_cuda.path_launches[plan.path] += 1
        _build.count_tiling(exp_cuda, plan.threads)
    return y


exp_cuda.launches = 0
exp_cuda.path_launches = {"vector": 0, "scalar": 0}
exp_cuda.tiling_launches = {}


class ExpFn(torch.autograd.Function):
    """The COPIFT exp with a gradient.  ``use_kernel`` picks the forward:
    ``exp_cuda`` at ``block_rows`` on a CUDA tensor, ``exp_plain``
    otherwise (which has no tiling); both return ``x``'s dtype, and a
    DTensor is computed on its local shard (``_build.on_local``).  The
    backward is ``g * y`` from the saved output, in fp32."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, use_kernel: bool,
                block_rows: int | None = None) -> torch.Tensor:
        def run(x):
            if use_kernel:
                return exp_cuda(x.to(torch.float32).contiguous(),
                                block_rows).to(x.dtype)
            return exp_plain(x).to(x.dtype)

        y = _build.on_local(run, x, "exp")
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (y,) = ctx.saved_tensors
        return ((g.to(torch.float32) * y.to(torch.float32)).to(y.dtype),
                None, None)
