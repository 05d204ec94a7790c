#!/usr/bin/env python3
"""Time the COPIFT log kernel's three table gathers beside the shipped
kernel and ``torch.log``.  Run on a machine with an NVIDIA GPU and the CUDA
toolkit, from the root of a checkout:

  python3 tools/logf_variants.py

At 16 M fp32 positive normals (``chip_smoke.log_input``), on one input, it
times with ``chip_smoke._device_ms`` (CUDA-graph replays between CUDA
events) the vector kernel of ``src/repro_torch/csrc/logf.cu`` with each
gather of ``tools/logf_variants.cu`` (tables in shared memory behind a
barrier, a warp shuffle from registers, ``__ldg`` from device memory), the
shipped wrapper ``log_cuda`` and ``torch.log``.  The list runs forward and
then backward, so each is read twice, and every result is held against the
plain version first (rtol 1e-5 / atol 1e-6).  It prints the card's name and
power limit and one JSON line.  The build goes to ``build/logf_variants/``;
``chip_smoke.py`` starts it beside the kernels' own builds and calls
``measure``.  A measurement: it checks only the results.
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
from repro_torch.kernels import _build, logf  # noqa: E402
from repro_torch.kernels.ref import logf_tables  # noqa: E402

LIB = ROOT / "build" / "logf_variants" / "logf_variants.so"
VARIANTS = {"shared": "tables in shared memory, one barrier a block",
            "shuffle": "lane l holds entry l & 15, __shfl_sync gather",
            "ldg": "__ldg from the device tables"}


def start_build() -> subprocess.Popen:
    """Start nvcc on ``tools/logf_variants.cu``; ``measure`` waits for it."""
    LIB.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         str(LIB), str(ROOT / "tools" / "logf_variants.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def measure(build: subprocess.Popen, x: torch.Tensor) -> dict:
    """ms of each gather (two readings each), the shipped kernel and
    ``torch.log`` on ``x`` (16-byte aligned, fp32, on the card)."""
    out, _ = build.communicate()
    if build.returncode:
        raise RuntimeError(f"nvcc failed on tools/logf_variants.cu:\n{out}")
    lib = ctypes.CDLL(str(LIB))
    n = x.numel()
    y = torch.empty_like(x)
    invc, logc = logf_tables(x.device)
    want = logf.log_plain(x)

    def variant(name):
        fn = getattr(lib, f"logf_variant_{name}")
        fn.argtypes = list(logf._ARGS["vector"])

        def run():
            code = fn(x.data_ptr(), y.data_ptr(), n // 4, n,
                      _build.DEFAULT_BLOCK_THREADS, invc.data_ptr(),
                      logc.data_ptr(), _build.stream(x))
            if code:
                raise RuntimeError(f"logf_variant_{name}: CUDA error {code}")
            return y
        return run

    runs = {f"{k}: {v}": variant(k) for k, v in VARIANTS.items()}
    runs["shipped wrapper (log_cuda)"] = lambda: logf.log_cuda(x)
    runs["torch.log"] = lambda: torch.log(x)
    for name, fn in runs.items():
        if name == "torch.log":
            continue
        got = fn()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{name}: {m}")
    times = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        times[name].append(chip_smoke._device_ms(runs[name]))
    return {"n": n, "bytes_bound_ms": 8 * n / chip_smoke.HBM_BYTES_PER_S * 1e3,
            "ms": times}


def main() -> int:
    if not torch.cuda.is_available():
        print("logf_variants: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._smi("name,power.limit"))
    build = start_build()
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(json.dumps(measure(build, chip_smoke.log_input(torch, gen))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
