#!/usr/bin/env python3
"""Does FMA contraction flip Monte-Carlo hits?  Run on a machine with an
NVIDIA GPU and the CUDA toolkit, from the root of a checkout:

  python3 tools/fma_contraction_check.py

It builds ``src/repro_torch/csrc/montecarlo.cu`` a second time with its
``__fmul_rn``/``__fadd_rn`` replaced by plain ``*`` and ``+``, which nvcc
contracts into fused multiply-adds by default, counts the FFMA instructions
of both builds (``cuobjdump -sass``), and prints, for each of {pi, poly} x
{lcg, xoshiro128p} at 2**26 samples, in how many lanes the contracted
build's hit count differs from the shipped kernel's.  The build goes to
``build/fma_contraction_check/``.  A measurement: it checks nothing.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import montecarlo as mc  # noqa: E402

_PLAIN_OPS = """
__device__ __forceinline__ float fmul_c(float a, float b) { return a * b; }
__device__ __forceinline__ float fadd_c(float a, float b) { return a + b; }
"""


def _ffma_count(library: Path) -> int:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    return sass.count(" FFMA ")


def main() -> int:
    if not torch.cuda.is_available():
        print("fma_contraction_check: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all()
    out_dir = ROOT / "build" / "fma_contraction_check"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "montecarlo.cu").read_text()
    src = src.replace("__fmul_rn(", "fmul_c(").replace("__fadd_rn(", "fadd_c(")
    src = src.replace('#include "prng.cuh"\n',
                      '#include "prng.cuh"\n' + _PLAIN_OPS)
    (out_dir / "montecarlo_contracted.cu").write_text(src)
    lib_path = out_dir / "montecarlo_contracted.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib_path),
                    str(out_dir / "montecarlo_contracted.cu")], check=True)
    print("FFMA instructions: shipped build",
          _ffma_count(_build.library_path("montecarlo")),
          "| contracted build", _ffma_count(lib_path))
    fn = ctypes.CDLL(str(lib_path)).copift_mc_f32
    fn.argtypes = list(mc._ARGS)
    fn.restype = ctypes.c_int
    for n_blocks in (1024, 8):
        iters = (1 << 26) // (n_blocks * mc.LANES)
        for problem in ("pi", "poly"):
            for kind in ("lcg", "xoshiro128p"):
                got = torch.empty(n_blocks, mc.LANES, device="cuda")
                code = fn(got.data_ptr(), got.numel(), 42, mc.KINDS[kind],
                          mc.PROBLEMS[problem], iters,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed: CUDA error {code}")
                shipped = mc.mc_partial_sums_cuda(
                    42, kind=kind, problem=problem, iters=iters,
                    n_blocks=n_blocks)
                torch.cuda.synchronize()
                print(f"n_blocks {n_blocks}, {iters} samples per lane, "
                      f"{problem} {kind}: the contracted build differs in "
                      f"{int((got != shipped).sum())} of {got.numel()} "
                      f"lanes; hits {int(got.double().sum())} against "
                      f"{int(shipped.double().sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
