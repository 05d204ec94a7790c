#!/usr/bin/env python3
"""Sweep the segment count S of the Monte-Carlo kernel's segment path.  Run
on a machine with an NVIDIA GPU and the CUDA toolkit, from the root of a
checkout:

  python3 tools/mc_segments.py

At 2**26 samples, n_blocks 2, 4, 8, 16, 32, 64, 132 and 1024, for
{pi, poly} x {lcg, xoshiro128p},
it launches ``copift_mc_seg_f32`` of ``src/repro_torch/csrc/montecarlo.cu``
through ctypes with every S of ``montecarlo.SEGMENTS`` (an explicit S: the
wrapper's own choice, ``mc_plan``, is not used), holds each result bit for
bit against the lane kernel's, and times both with
``chip_smoke._device_ms`` (CUDA-graph replays between CUDA events).  It
prints the card's name and power limit and one JSON line with, per case,
the lane kernel's ms, each S's ms and the S ``mc_plan`` picks.
``chip_smoke.py`` calls ``sweep`` and ``run_segments`` in its own run.  No
launch here moves the wrappers' launch counters.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import _build, prng  # noqa: E402
from repro_torch.kernels import montecarlo as mc  # noqa: E402

VARIANTS = [(p, k) for p in ("pi", "poly") for k in ("lcg", "xoshiro128p")]


def run_segments(seed: int, *, kind: str, problem: str, iters: int,
                 n_blocks: int, segments: int) -> torch.Tensor:
    """The segment path's partial sums, shape (n_blocks, 1024), fp32, with
    ``segments`` segments a lane."""
    out = torch.empty(n_blocks, mc.LANES, dtype=torch.float32, device="cuda")
    table = mc.jump_table_on(kind, iters, segments, out.device)
    _build.launch("montecarlo", "copift_mc_seg_f32", mc._ARGS["segment"],
                  out.data_ptr(), out.numel(), int(seed), prng.KINDS[kind],
                  mc.PROBLEMS[problem], iters, segments,
                  mc.segment_length(iters, segments), table.data_ptr(),
                  _build.stream(out))
    return out


def run_lanes(seed: int, *, kind: str, problem: str, iters: int,
              n_blocks: int) -> torch.Tensor:
    """The lane path's partial sums, as ``run_segments``."""
    out = torch.empty(n_blocks, mc.LANES, dtype=torch.float32, device="cuda")
    _build.launch("montecarlo", "copift_mc_f32", mc._ARGS["lane"],
                  out.data_ptr(), out.numel(), int(seed), prng.KINDS[kind],
                  mc.PROBLEMS[problem], iters, _build.stream(out))
    return out


def sweep(samples: int = 1 << 26, seed: int = 42,
          n_blocks_list: tuple[int, ...] = (2, 4, 8, 16, 32, 64, 132, 1024)
          ) -> list[dict]:
    """Every S at each n_blocks, each variant, against the lane kernel:
    bit-exact, then timed."""
    rows = []
    for n_blocks in n_blocks_list:
        iters = samples // (n_blocks * mc.LANES)
        for problem, kind in VARIANTS:
            kw = dict(kind=kind, problem=problem, iters=iters,
                      n_blocks=n_blocks)
            want = run_lanes(seed, **kw)
            ms = {}
            for s in mc.SEGMENTS:
                got = run_segments(seed, segments=s, **kw)
                if not torch.equal(got, want):
                    raise RuntimeError(f"mc_segments {kw} S={s}: not "
                                       "bit-exact against the lane kernel")
                ms[s] = chip_smoke._device_ms(
                    lambda s=s: run_segments(seed, segments=s, **kw))
            rows.append(dict(problem=problem, kind=kind, n_blocks=n_blocks,
                             iters=iters,
                             lane_ms=chip_smoke._device_ms(
                                 lambda: run_lanes(seed, **kw)),
                             segment_ms=ms,
                             plan=mc.mc_plan(n_blocks * mc.LANES, iters)))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("mc_segments: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._smi("name,power.limit"))
    _build.build_all()
    print(json.dumps({"mc_segments": sweep()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
