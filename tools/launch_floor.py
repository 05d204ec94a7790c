#!/usr/bin/env python3
"""Time an empty kernel (``tools/launch_floor.cu``) beside the uniform
kernel at the same grids: the card's floor for one launch.  Run on a
machine with an NVIDIA GPU and the CUDA toolkit, from the root of a
checkout:

  python3 tools/launch_floor.py

Each case is timed with ``chip_smoke._device_ms`` (10 launches captured in
a CUDA graph, the replay timed with CUDA events, the median of 20): the
empty kernel at one block and at the grids ``csrc/prng.cu`` launches for
8,196 values (the token pipeline's draw at batch 4 × 2,049) and 50,304
(one sampling draw at OLMo's vocabulary), 256 threads a block, and the
uniform kernel (``uniform_cuda``) at those two sizes.  It prints the
card's name and power limit and one JSON line.  The build goes to
``build/launch_floor/``; ``chip_smoke.py`` starts it beside the kernels'
own builds and calls ``measure``.  A measurement: it checks nothing.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, prng  # noqa: E402

LIB = ROOT / "build" / "launch_floor" / "launch_floor.so"
THREADS = _build.DEFAULT_BLOCK_THREADS   # csrc/prng.cu's default block
SIZES = (8196, 50304)


def start_build() -> subprocess.Popen:
    """Start nvcc on ``tools/launch_floor.cu``; ``measure`` waits for it."""
    LIB.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(LIB),
         str(ROOT / "tools" / "launch_floor.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def measure(build: subprocess.Popen) -> dict:
    """ms of the empty kernel at 1 block and at the uniform kernel's grids,
    and of the uniform kernel at ``SIZES``."""
    out, _ = build.communicate()
    if build.returncode:
        raise RuntimeError(f"nvcc failed on tools/launch_floor.cu:\n{out}")
    fn = ctypes.CDLL(str(LIB)).launch_floor_empty
    fn.argtypes = [_build.INT, _build.INT, _build.PTR]
    fn.restype = _build.INT
    probe = torch.empty(1, device="cuda")

    def empty(blocks):
        def run():
            code = fn(blocks, THREADS, _build.stream(probe))
            if code:
                raise RuntimeError(f"launch_floor_empty: CUDA error {code}")
        return run

    grids = {n: _build.grid_stride_blocks(n, THREADS) for n in SIZES}
    res = {"threads": THREADS, "empty_ms": {}, "uniform_ms": {}}
    for blocks in (1, *grids.values()):
        res["empty_ms"][f"{blocks} blocks"] = chip_smoke._device_ms(
            empty(blocks))
    for n in SIZES:
        res["uniform_ms"][f"n={n} ({grids[n]} blocks)"] = \
            chip_smoke._device_ms(lambda: prng.uniform_cuda(7, n))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_floor: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._smi("name,power.limit"))
    build = start_build()
    _build.build_all()
    print(json.dumps(measure(build)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
