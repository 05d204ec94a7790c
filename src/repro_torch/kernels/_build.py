"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``src/repro_torch/csrc/*.cu`` file becomes one shared library with a
plain C interface, built by ``nvcc`` with ``NVCC_FLAGS``; the builds of all
files start together.  The libraries go to ``build/repro_torch_kernels/``
at the root of the checkout, named by a hash of every file in ``csrc/``, so
an edited source is rebuilt and an unchanged one is loaded as it is.

A launcher returns the ``cudaError_t`` of its launch; :func:`launch` raises
with ``cudaGetErrorString``'s message when that is not 0.  Nothing here runs
when the module is imported, and nothing falls back to a plain version: a
kernel that does not build or launch raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
from torch.distributed.tensor import DTensor

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

#: ctypes argument types: pointers and the stream are ``c_void_p`` (a
#: ``c_int`` would cut a 64-bit address), sizes ``c_int64``, seeds
#: ``c_uint32`` (seeds reach 2**32 - 1, beyond a ``c_int``).
PTR, I64, U32, INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_int

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(stem: str) -> Path:
    return BUILD_DIR / f"{stem}-{_digest()}.so"


def build_all() -> float:
    """Build every source whose library is missing, all at once.  Returns
    the seconds spent (0.0 when everything was built already)."""
    todo = [src for src in sorted(CSRC.glob("*.cu"))
            if not library_path(src.stem).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in todo:
        final = library_path(src.stem)
        tmp = final.with_name(f".{final.name}.{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, tmp, final, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for src, tmp, final, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            failures.append(f"{src.name}:\n{out}")
        else:
            os.replace(tmp, final)   # atomic: a concurrent build sees all or none
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def _function(stem: str, name: str, argtypes) -> ctypes._CFuncPtr:
    key = (stem, name)
    if key not in _fns:
        if stem not in _libs:
            build_all()
            lib = ctypes.CDLL(str(library_path(stem)))
            lib.repro_error_string.argtypes = [INT]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[stem] = lib
        fn = getattr(_libs[stem], name)
        fn.argtypes = list(argtypes)
        fn.restype = INT
        _fns[key] = fn
    return _fns[key]


def launch(stem: str, name: str, argtypes, *args) -> None:
    """Call launcher ``name`` of ``csrc/<stem>.cu``; raise if it reports a
    CUDA error."""
    code = _function(stem, name, argtypes)(*args)
    if code:
        msg = _libs[stem].repro_error_string(code).decode()
        raise RuntimeError(f"{stem}.{name}: CUDA error {code}: {msg}")


#: The tiled kernels' block sizes (``csrc/common.cuh``): multiples of 32
#: from 32 to 1024, 256 at the default tiling.
MIN_BLOCK_THREADS, DEFAULT_BLOCK_THREADS, MAX_BLOCK_THREADS = 32, 256, 1024
#: The cap on a grid-stride launch's blocks (``grid_stride_blocks``).
GRID_STRIDE_CAP = 132 * 16


def block_threads(block_rows: int, default_rows: int) -> int:
    """Threads a block for a tiled kernel: the JAX package's tile height
    ``block_rows`` scaled from the 256 threads of its default
    ``default_rows``, ``256 * block_rows / default_rows`` to the nearest
    multiple of 32 (halves up), clamped to [32, 1024]."""
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    nearest = (8 * block_rows + default_rows // 2) // default_rows
    return min(MAX_BLOCK_THREADS, max(MIN_BLOCK_THREADS, 32 * nearest))


def grid_stride_blocks(n: int, threads: int) -> int:
    """``grid_stride_blocks`` of ``csrc/common.cuh``: the blocks of a
    grid-stride loop over ``n`` elements."""
    return min(-(-n // threads), GRID_STRIDE_CAP)


def count_tiling(wrapper, key: int) -> None:
    """Add one launch at tiling ``key`` (threads a block, or softmax's rows
    a block) to ``wrapper.tiling_launches``."""
    wrapper.tiling_launches[key] = wrapper.tiling_launches.get(key, 0) + 1


def stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_local(fn, x: torch.Tensor, what: str,
             reduced_dim: int | None = None) -> torch.Tensor:
    """``fn(x)`` for a plain tensor.  For a DTensor, ``fn`` of its local
    shard, wrapped with the same placements: right for an elementwise
    ``fn`` and for one that reduces dimension ``reduced_dim`` alone, as
    long as that dimension is whole on every rank.  Raises when it is
    sharded, or when ``x`` holds partial sums; nothing is gathered."""
    if not isinstance(x, DTensor):
        return fn(x)
    for p in x.placements:
        if p.is_partial():
            raise ValueError(f"{what}: the DTensor holds partial sums "
                             f"({x.placements}); reduce it first")
        if (reduced_dim is not None and p.is_shard()
                and p.dim % x.ndim == reduced_dim % x.ndim):
            raise ValueError(f"{what}: dimension {reduced_dim} is sharded "
                             f"({x.placements}), and the kernel reduces "
                             "over it whole")
    y = fn(x.to_local())
    return DTensor.from_local(y, x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def check_cuda_tensor(t: torch.Tensor, dtypes: tuple[torch.dtype, ...],
                      what: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``,
    and no DTensor: a kernel reads one rank's memory, so a sharded tensor
    reaches it as its local shard (``on_local``)."""
    if isinstance(t, DTensor):
        raise TypeError(f"{what}: got a DTensor; launch on its local shard")
    if t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got one on "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
