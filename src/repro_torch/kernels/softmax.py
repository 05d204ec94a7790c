"""COPIFT row softmax: the CUDA kernel ``csrc/softmax.cu``, its wrapper and
its plain PyTorch version.

The kernel replaces the JAX package's
``repro/kernels/softmax_tpu.py:_softmax_kernel``.  Compute is fp32 and the
output keeps the input's dtype (fp32 or bf16).  ``softmax_plan`` picks one
of the kernel's three paths by shape; ``softmax_cuda.path_launches`` counts
the launches of each.
"""

from __future__ import annotations

import dataclasses

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


#: Path (a) takes rows up to this many columns, a warp per row.
WARP_MAX_COLS = 1024
#: Values a lane of path (a) holds in registers: the smallest bucket with
#: 32 * values >= cols.
_PER_LANE = (1, 2, 4, 8, 16, 32)
#: Path (b): SMs to fill, cluster sizes, shared memory a block may use on
#: the H100 and the part of it the kernel keeps for its reduction slots
#: (``csrc/softmax.cu``'s kSmemPerBlock and kSlotBytes).
SMS = 132
CLUSTER_SIZES = (1, 2, 4, 8)
SMEM_PER_BLOCK = 232_448
SLOT_BYTES = 256
#: Columns of one slice of path (b): fp32 values, a multiple of 8 so that
#: every slice starts 16-byte aligned in fp32 and in bf16.
MAX_SLICE_COLS = (SMEM_PER_BLOCK - SLOT_BYTES) // 4 // 8 * 8
CLUSTER_MAX_COLS = CLUSTER_SIZES[-1] * MAX_SLICE_COLS
_GRID_LIMIT = 2 ** 31


@dataclasses.dataclass(frozen=True)
class SoftmaxPlan:
    """The path of ``csrc/softmax.cu`` a shape takes, with its launch
    parameters: ``"warp"`` (a), ``"cluster"`` (b) or ``"sweep"`` (c)."""
    path: str
    grid: int
    threads: int
    per_lane: int = 0       # (a): values a lane holds in registers
    cluster: int = 0        # (b): blocks a row (the cluster size k)
    slice_cols: int = 0     # (b): columns a block holds in shared memory
    smem_bytes: int = 0     # (b): dynamic shared memory a block
    vec: bool = False       # (b): 16-byte loads, if the pointers allow


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def softmax_plan(rows: int, cols: int, dtype: torch.dtype) -> SoftmaxPlan:
    """The path and launch parameters for a (rows, cols) softmax, from the
    shape and dtype alone.

    (a) ``cols <= WARP_MAX_COLS``: a warp per row, 8 rows a 256-thread
    block.  (b) ``cols <= CLUSTER_MAX_COLS``: a cluster of k blocks per row,
    k the smallest of 1, 2, 4, 8 with ``rows * k >= SMS`` (8 at most),
    raised until a slice fits a block's shared memory.  (c) otherwise: one
    block per row, three sweeps."""
    if rows <= 0 or cols <= 0:
        raise ValueError(f"softmax_plan: empty shape ({rows}, {cols})")
    if cols <= WARP_MAX_COLS:
        per_lane = next(p for p in _PER_LANE if 32 * p >= cols)
        plan = SoftmaxPlan("warp", grid=-(-rows // 8), threads=256,
                           per_lane=per_lane)
    elif cols <= CLUSTER_MAX_COLS:
        k = next((k for k in CLUSTER_SIZES if rows * k >= SMS),
                 CLUSTER_SIZES[-1])
        while _round_up(-(-cols // k), 8) > MAX_SLICE_COLS:
            k *= 2
        slice_cols = _round_up(-(-cols // k), 8)
        # About 64 values a thread, in 256 to 1024 threads: larger blocks
        # leave fewer clusters resident at once, and a launch that needs
        # more runs in waves (tools/softmax_cluster_costs.py).
        threads = min(1024, max(256, _next_pow2(-(-slice_cols // 64))))
        vec = cols % (16 // dtype.itemsize) == 0
        plan = SoftmaxPlan("cluster", grid=rows * k, threads=threads,
                           cluster=k, slice_cols=slice_cols,
                           smem_bytes=4 * slice_cols, vec=vec)
    else:
        plan = SoftmaxPlan("sweep", grid=rows, threads=256)
    if plan.grid >= _GRID_LIMIT:
        raise ValueError(f"softmax_plan: ({rows}, {cols}) needs {plan.grid} "
                         "blocks, beyond one grid dimension")
    return plan


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I64, _INT = _build.PTR, _build.I64, _build.INT
_ARGS = {"warp": (_P, _P, _I64, _I64, _INT, _P),
         "cluster": (_P, _P, _I64, _I64, _INT, _INT, _INT, _INT, _INT, _P),
         "sweep": (_P, _P, _I64, _I64, _P)}


def _launch_args(plan: SoftmaxPlan, x: torch.Tensor, y: torch.Tensor):
    """The arguments of ``plan``'s launcher after (x, y, rows, cols)."""
    if plan.path == "warp":
        return (plan.per_lane,)
    if plan.path == "cluster":
        vec = plan.vec and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
        return (plan.cluster, plan.slice_cols, plan.threads, plan.smem_bytes,
                int(vec))
    return ()


def softmax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/softmax.cu`` on a contiguous (rows, cols) CUDA tensor
    of fp32 or bf16, on the path ``softmax_plan`` gives its shape."""
    _build.check_cuda_tensor(x, tuple(_SUFFIX), "softmax_cuda")
    if x.ndim != 2:
        raise ValueError(f"softmax_cuda: expected (rows, cols), got "
                         f"{tuple(x.shape)}")
    y = torch.empty_like(x)
    if x.numel():
        rows, cols = x.shape
        plan = softmax_plan(rows, cols, x.dtype)
        _build.launch("softmax", f"copift_softmax_{plan.path}_"
                      f"{_SUFFIX[x.dtype]}", _ARGS[plan.path], x.data_ptr(),
                      y.data_ptr(), rows, cols, *_launch_args(plan, x, y),
                      _build.stream(x))
        softmax_cuda.launches += 1
        softmax_cuda.path_launches[plan.path] += 1
    return y


softmax_cuda.launches = 0
softmax_cuda.path_launches = {"warp": 0, "cluster": 0, "sweep": 0}
