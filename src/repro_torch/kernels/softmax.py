"""COPIFT row softmax: the CUDA kernel ``csrc/softmax.cu``, its wrapper and
its plain PyTorch version.

The kernel replaces the JAX package's
``repro/kernels/softmax_tpu.py:_softmax_kernel``.  Compute is fp32 and the
output keeps the input's dtype (fp32 or bf16).  ``softmax_plan`` picks one
of the kernel's three paths by shape, and the warp path's rows a block from
``block_rows``; ``softmax_cuda.path_launches`` counts the launches of each
path and ``softmax_cuda.tiling_launches`` the warp path's launches at each
rows a block.  ``SoftmaxFn`` gives the softmax a gradient: its
forward is the kernel (or, on the CPU, the plain version), its backward
``y * (g - sum(g * y))`` in plain PyTorch from the saved output, as the JAX
package has no backward kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.expf import exp_phases


def softmax_plain(x: torch.Tensor,
                  block_rows: int | None = None) -> torch.Tensor:
    """Plain version of the softmax kernel over the last axis: cast to fp32,
    row max, exp of ``x - max`` without the high clamp, divide by the row
    sum, cast back.  ``block_rows`` is the kernel's tiling, which changes no
    value; it is ignored."""
    xf = x.to(torch.float32)
    m = torch.amax(xf, dim=-1, keepdim=True)
    e = exp_phases(xf - m, clamp_hi=False)
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


#: Path (a) takes rows up to this many columns, a warp per row.
WARP_MAX_COLS = 1024
#: Path (a)'s rows (warps) a block: the JAX package's default tile height
#: (``repro/kernels/ops.py:softmax``), and the most a block holds.
DEFAULT_BLOCK_ROWS = 8
MAX_ROWS_PER_BLOCK = 32
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
    rows_per_block: int = 0  # (a): rows (warps) a block
    cluster: int = 0        # (b): blocks a row (the cluster size k)
    slice_cols: int = 0     # (b): columns a block holds in shared memory
    smem_bytes: int = 0     # (b): dynamic shared memory a block
    vec: bool = False       # (b): 16-byte loads, if the pointers allow


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def softmax_plan(rows: int, cols: int, dtype: torch.dtype,
                 block_rows: int | None = None) -> SoftmaxPlan:
    """The path and launch parameters for a (rows, cols) softmax, from the
    shape and dtype and, on path (a), the tiling ``block_rows``.

    (a) ``cols <= WARP_MAX_COLS``: a warp per row, ``block_rows`` rows a
    block (``DEFAULT_BLOCK_ROWS`` = 8 when ``None``, 256 threads; clamped to
    1..32), ``ceil(rows / block_rows)`` blocks, the last one ragged.
    (b) ``cols <= CLUSTER_MAX_COLS``: a cluster of k blocks per row, k the
    smallest of 1, 2, 4, 8 with ``rows * k >= SMS`` (8 at most), raised
    until a slice fits a block's shared memory.  (c) otherwise: one block
    per row, three sweeps.  Paths (b) and (c) take one row a cluster or a
    block, set by the shape, and ignore ``block_rows``."""
    if rows <= 0 or cols <= 0:
        raise ValueError(f"softmax_plan: empty shape ({rows}, {cols})")
    if block_rows is not None and block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if cols <= WARP_MAX_COLS:
        per_lane = next(p for p in _PER_LANE if 32 * p >= cols)
        rpb = min(MAX_ROWS_PER_BLOCK, block_rows or DEFAULT_BLOCK_ROWS)
        plan = SoftmaxPlan("warp", grid=-(-rows // rpb), threads=32 * rpb,
                           per_lane=per_lane, rows_per_block=rpb)
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
_ARGS = {"warp": (_P, _P, _I64, _I64, _INT, _INT, _P),
         "cluster": (_P, _P, _I64, _I64, _INT, _INT, _INT, _INT, _INT, _P),
         "sweep": (_P, _P, _I64, _I64, _P)}


def _launch_args(plan: SoftmaxPlan, x: torch.Tensor, y: torch.Tensor):
    """The arguments of ``plan``'s launcher after (x, y, rows, cols)."""
    if plan.path == "warp":
        return (plan.per_lane, plan.rows_per_block)
    if plan.path == "cluster":
        vec = plan.vec and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
        return (plan.cluster, plan.slice_cols, plan.threads, plan.smem_bytes,
                int(vec))
    return ()


def softmax_cuda(x: torch.Tensor,
                 block_rows: int | None = None) -> torch.Tensor:
    """Launch ``csrc/softmax.cu`` on a contiguous (rows, cols) CUDA tensor
    of fp32 or bf16, on the path ``softmax_plan`` gives its shape (and, on
    the warp path, ``block_rows`` rows a block)."""
    _build.check_cuda_tensor(x, tuple(_SUFFIX), "softmax_cuda")
    if x.ndim != 2:
        raise ValueError(f"softmax_cuda: expected (rows, cols), got "
                         f"{tuple(x.shape)}")
    y = torch.empty_like(x)
    if x.numel():
        rows, cols = x.shape
        plan = softmax_plan(rows, cols, x.dtype, block_rows)
        _build.launch("softmax", f"copift_softmax_{plan.path}_"
                      f"{_SUFFIX[x.dtype]}", _ARGS[plan.path], x.data_ptr(),
                      y.data_ptr(), rows, cols, *_launch_args(plan, x, y),
                      _build.stream(x))
        softmax_cuda.launches += 1
        softmax_cuda.path_launches[plan.path] += 1
        if plan.path == "warp":
            _build.count_tiling(softmax_cuda, plan.rows_per_block)
    return y


softmax_cuda.launches = 0
softmax_cuda.path_launches = {"warp": 0, "cluster": 0, "sweep": 0}
softmax_cuda.tiling_launches = {}


class SoftmaxFn(torch.autograd.Function):
    """The COPIFT softmax over the last axis, with a gradient.
    ``use_kernel`` picks the forward: ``softmax_cuda`` at ``block_rows`` on
    a CUDA tensor, ``softmax_plain`` otherwise; a DTensor's rows are
    computed on its local shard (``_build.on_local``), which raises when
    the last axis is sharded.  The backward computes in
    fp32 from the saved output and returns ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, use_kernel: bool,
                block_rows: int | None = None) -> torch.Tensor:
        def run(x):
            if not use_kernel:
                return softmax_plain(x)
            cols = x.shape[-1]
            return softmax_cuda(x.reshape(-1, cols).contiguous(),
                                block_rows).reshape(x.shape)

        y = _build.on_local(run, x, "softmax", reduced_dim=-1)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (y,) = ctx.saved_tensors
        yf, gf = y.to(torch.float32), g.to(torch.float32)
        dx = yf * (gf - (gf * yf).sum(dim=-1, keepdim=True))
        return dx.to(y.dtype), None, None
