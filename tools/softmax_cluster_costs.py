#!/usr/bin/env python3
"""Where the softmax kernel's cluster path spends its time.  Run on a
machine with an NVIDIA GPU and the CUDA toolkit, from the root of a
checkout:

  python3 tools/softmax_cluster_costs.py

Two measurements, each with ``chip_smoke._device_ms`` (CUDA-graph replays
between CUDA events):

1. The shipped cluster launcher (``copift_softmax_cluster_f32``) at
   16x5120, 64x32768 and 64x1025 fp32, for every cluster size k in
   {1, 2, 4, 8} and block size in {128, 256, 512, 1024} whose slice fits
   shared memory, each result held against the plain version (rtol 3e-5,
   atol 3e-7) first; ``torch.softmax`` beside them.  The plan that
   ``softmax_plan`` picks is marked.  Beside each time, the clusters of
   that shape the card holds at once (``cudaOccupancyMaxActiveClusters``)
   against the clusters the launch needs (its rows).
2. Empty kernels (``tools/softmax_cluster_costs.cu``) on 128 and 256
   blocks: a plain launch, and launches in clusters of 1, 2, 4 and 8
   blocks with 0 and 3 cluster barriers.

It prints the card's name and power limit and one JSON line.  The build
goes to ``build/softmax_cluster_costs/``.  A measurement: it checks only
the results.
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
from repro_torch.kernels import _build, softmax  # noqa: E402
from repro_torch.models.attention import NEG_INF  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("softmax_cluster_costs: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._smi("name,power.limit"))
    _build.build_all()
    out_dir = ROOT / "build" / "softmax_cluster_costs"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "softmax_cluster_costs.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib_path),
                    str(ROOT / "tools" / "softmax_cluster_costs.cu")],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.empty_cluster_launch.argtypes = [_build.INT] * 4 + [_build.PTR]
    lib.softmax_active_clusters.argtypes = [_build.INT] * 3 + [
        ctypes.POINTER(ctypes.c_int)]

    def active_clusters(k, threads, smem_bytes):
        error = ctypes.c_int(0)
        n = lib.softmax_active_clusters(k, threads, smem_bytes,
                                        ctypes.byref(error))
        if error.value:
            raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error "
                               f"{error.value}")
        return n

    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"shapes": {}, "active_clusters": {}, "empty": {}}

    for rows, cols in [(16, 5120), (64, 32768), (64, 1025)]:
        x = torch.randn(rows, cols, device="cuda", generator=gen) * 4
        x[:, cols // 2 + 1:] = NEG_INF
        y = torch.empty_like(x)
        want = softmax.softmax_plain(x)
        chosen = softmax.softmax_plan(rows, cols, torch.float32)
        times = {"torch.softmax": chip_smoke._device_ms(
            lambda: torch.softmax(x, dim=-1))}
        active = {"clusters needed": rows}
        for k in softmax.CLUSTER_SIZES:
            width = -(-(-(-cols // k)) // 8) * 8
            if width > softmax.MAX_SLICE_COLS:
                continue
            for threads in (128, 256, 512, 1024):
                def run(k=k, width=width, threads=threads):
                    _build.launch(
                        "softmax", "copift_softmax_cluster_f32",
                        softmax._ARGS["cluster"], x.data_ptr(), y.data_ptr(),
                        rows, cols, k, width, threads, 4 * width,
                        int(cols % 4 == 0), _build.stream(x))
                run()
                torch.cuda.synchronize()
                torch.testing.assert_close(y, want, rtol=3e-5, atol=3e-7)
                mark = (" (softmax_plan)" if (k, threads) == (
                    chosen.cluster, chosen.threads) else "")
                times[f"k={k} threads={threads}{mark}"] = \
                    chip_smoke._device_ms(run)
                active[f"k={k} threads={threads}"] = active_clusters(
                    k, threads, 4 * width)
        result["shapes"][f"{rows}x{cols}"] = times
        result["active_clusters"][f"{rows}x{cols}"] = active

    for grid in (128, 256):
        for threads in (128, 512):
            for cluster, syncs in [(0, 0), (1, 0), (2, 0), (4, 0), (8, 0),
                                   (1, 3), (2, 3), (4, 3), (8, 3)]:
                def run(grid=grid, threads=threads, cluster=cluster,
                        syncs=syncs):
                    code = lib.empty_cluster_launch(
                        grid, threads, cluster, syncs,
                        torch.cuda.current_stream().cuda_stream)
                    if code:
                        raise RuntimeError(f"CUDA error {code}")
                label = (f"grid {grid}, {threads} threads, " +
                         (f"clusters of {cluster}, {syncs} barriers"
                          if cluster else "no cluster attribute"))
                result["empty"][label] = chip_smoke._device_ms(run)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
