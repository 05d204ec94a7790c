#!/usr/bin/env python3
"""Time the shipped COPIFT exp kernel beside two designs it does not ship
and beside ``torch.exp``.  Run on a machine with an NVIDIA GPU and the CUDA
toolkit, from the root of a checkout:

  python3 tools/exp_variants.py

At 16 M fp32 values (one KV chunk of the chunked-attention prefill), on one
input, it times with ``chip_smoke._device_ms`` (CUDA-graph replays between
CUDA events): the shipped vector kernel (``exp_cuda``), the shipped scalar
kernel on the same aligned input, the two designs of
``tools/exp_variants.cu`` (a grid sized from occupancy with a grid-stride
loop, and a ring of TMA bulk copies), and ``torch.exp``.  The list runs
forward and then backward, so each is read twice, and every result is held
against the plain version first (rtol 2e-6).  It prints the card's name and
power limit and one JSON line.  The build goes to
``build/exp_variants/``.  A measurement: it checks only the results.
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
from repro_torch.kernels import _build, expf  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_variants: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._smi("name,power.limit"))
    _build.build_all()
    out_dir = ROOT / "build" / "exp_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "exp_variants.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib_path),
                    str(ROOT / "tools" / "exp_variants.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    args = [_build.PTR, _build.PTR, _build.I64, _build.PTR]
    for name in ("exp_variant_occupancy", "exp_variant_tma"):
        getattr(lib, name).argtypes = args

    n = 16 * 1024 * 1024
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.empty(n, device="cuda").uniform_(-90.0, 2.0, generator=gen)
    y = torch.empty_like(x)
    want = expf.exp_plain(x)

    def variant(name):
        def run():
            code = getattr(lib, name)(x.data_ptr(), y.data_ptr(), n // 4,
                                      _build.stream(x))
            if code:
                raise RuntimeError(f"{name}: CUDA error {code}")
            return y
        return run

    def scalar():
        _build.launch("expf", "copift_exp_f32", expf._ARGS["scalar"],
                      x.data_ptr(), y.data_ptr(), n,
                      _build.DEFAULT_BLOCK_THREADS, _build.stream(x))
        return y

    runs = {"shipped vector kernel (exp_cuda)": lambda: expf.exp_cuda(x),
            "shipped scalar kernel": scalar,
            "occupancy grid, grid-stride, 4 float4s a thread":
                variant("exp_variant_occupancy"),
            "TMA bulk-copy ring, 4 stages of 16 KB": variant("exp_variant_tma"),
            "torch.exp": lambda: torch.exp(x)}
    for name, fn in runs.items():
        got = fn()
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-30,
                                   msg=lambda m: f"{name}: {m}")
    times = {name: [] for name in runs}
    for name in [*runs, *reversed(runs)]:
        times[name].append(chip_smoke._device_ms(runs[name]))
    bound_ms = 8 * n / chip_smoke.HBM_BYTES_PER_S * 1e3
    print(json.dumps({"n": n, "bytes_bound_ms": bound_ms, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
