#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. The card's name and power limit (``nvidia-smi``), its SM count and
   maximum SM clock (from which the FP32 and INT32 rates follow), then
   the build of every CUDA kernel from ``src/repro_torch/csrc`` (nvcc into
   ``build/``).
2. Every kernel held against its plain PyTorch version on the card, at the
   shapes the serving path or the facade gives it (Monte Carlo bit-exact at
   256 samples per lane for {pi, poly} x {lcg, xoshiro128p} and two seeds),
   softmax also at the edges of its three paths (warp per row, a thread
   block cluster per row, three sweeps), twice, bit-identical, and exp at a
   ragged tail, a misaligned view (its scalar kernel) and the attention
   correction's 16 K values; each case records the path it took,
   and timed with CUDA events (median of 20 runs after warm-up; device time
   from CUDA-graph replays, plus the eager per-call time) beside its plain
   version, one PyTorch library call computing the same function where
   there is one, and its bound: the larger of bytes over 3.35 TB/s (H100 SXM
   HBM3) and instructions over the card's FP32 and INT32 dispatch rates.
   Monte Carlo's instruction counts are read from its built kernels' SASS
   (``cuobjdump``), and it gets two bounds of one lane beside the card's:
   its generator's dependent chain (latency) and its instructions at one
   per clock (dispatch).  One JSON line ``{"kernels": [...]}`` at the end.
3. A reference check: the olmo-1b smoke model on the card (kernels) against
   the same parameters on the CPU (plain versions).
4. OLMo-1B at full width, random weights from a seeded ``torch.Generator``,
   bf16 compute, served through the port's entry points:
   (a) ``repro_torch.launch.serve.main``, batch 4, prompt 128, 32 new
       tokens, greedy, twice (the tokens must be identical);
   (b) the same at temperature 1.0, seed 3 (the uniform kernel's path);
   (c) ``ServeEngine(max_len=5120, batch=1)``, prompt 2048, 8 new tokens
       (prefill takes the chunked attention path, the exp kernel's).
   Every kernel's launch counter is set to 0 just before each request and
   read just after; softmax must launch in (a), uniform in (b), exp in (c).
   The per-path counters must show (a) and (b) on softmax's warp path,
   (c)'s decode on its cluster path and (c)'s prefill on exp's vector path.
   Every logit must be finite and every token inside the vocabulary.
5. The kernel facade: every spec of ``repro_torch.api`` with an entry point
   run through ``kernel(name).run`` under ``config(impl="cuda")`` at full
   size (Monte Carlo at 2**26 samples, n_blocks 8 and 1024), held against
   ``.ref`` or the plain version; the estimates within 0.002 of pi and 0.4.
   The counters are set to 0 before the phase and read after it: every
   kernel must have launched.  The logf and Monte-Carlo launch counts in the
   JSON line are this phase's, the others the serving phase's.
6. The last line: ``{"ok": true, "device": {...}}``.

fp32 matmuls and convolutions are pinned to full fp32 (TF32 off).
"""

from __future__ import annotations

import functools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
#: Lanes per SM: an H100 SM has four schedulers, each issuing one warp
#: instruction per clock, over 128 FP32 lanes and 64 INT32 lanes.  An INT32
#: warp instruction holds its pipe for two clocks; FP32 and INT32
#: instructions from the same scheduler overlap in their pipes, as the
#: paper's integer and FP threads do, but share its one dispatch slot per
#: clock.
FP32_LANES_PER_SM = 128
INT32_LANES_PER_SM = 64
#: Latency between dependent integer ALU instructions (IADD3, LOP3, SHF,
#: IMAD) on Hopper, in clocks: an assumption for the latency bound, not a
#: measurement.
ALU_LATENCY_CLOCKS = 4

# Instructions per element, counted from the kernels' sources: (all
# instructions, those of them that only the integer pipe executes: shifts,
# logic, integer adds).  Multiplies and multiply-adds of integers
# (IMAD) and int-to-float conversions may go to the FP32 pipe, so they
# count only in the first.  These three kernels are bound by bytes with a
# wide margin; Monte Carlo's counts, which decide its bound, are read from
# the built kernel's SASS instead (``mc_sass_counts``).
#: COPIFT exp: z, rint, two Cody-Waite multiply-adds, clamp (2), the float
#: to int conversion, seven Horner multiply-adds, the scale multiply, two
#: compare-selects (4); add and shift for the scale bits (integer pipe).
EXP_OPS = (20, 2)
#: Softmax: one exp with its subtraction, the max, the sum, an IEEE
#: division (a reciprocal and three fix-up multiply-adds).
SOFTMAX_OPS = (EXP_OPS[0] + 1 + 2 + 4, EXP_OPS[1])
#: Uniform: counter add, splitmix32 (add, three shift-xor pairs on the
#: integer pipe, two multiplies), the generator step, shift, conversion;
#: one scale multiply.
UNIFORM_OPS = {"lcg": (16, 10), "xoshiro128p": (24, 16)}
#: logf: the x <= 0 compare-select (2), r = z*invc - 1, three Horner steps
#: and the multiply by r, + logc, the exponent's conversion and k*ln2, two
#: table loads; the integer phase: re-bias, index shift and mask, exponent
#: shift, mantissa mask and subtraction (integer pipe).
LOG_OPS = (18, 6)
#: Dependent integer instructions per generator step on the path from one
#: state to the next: the LCG's multiply-add; xoshiro128+'s shift then
#: three-input xor (s2), or xor then rotate (s3).
MC_CHAIN = {"lcg": 1, "xoshiro128p": 2}
#: Opcodes that only the integer pipe executes, and the loop's own control
#: (the branch, its compare, the uniform datapath), left out of the count.
INT_PIPE_OPS = ("LOP3", "SHF", "IADD3")
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*);")


def mc_sass_counts(library: Path) -> dict[tuple[str, str],
                                          tuple[float, float]]:
    """(all, integer-pipe) instructions per sample in the loop of each
    Monte-Carlo kernel, read from the SASS of the built ``library``
    (``cuobjdump -sass``).  A loop iteration's samples are its int-to-float
    conversions over 2 (one per draw)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"mc_kernelILb([01])ENS_\d+(Lcg|Xoshiro128p)", fn)
        if not m:
            continue
        key = ("pi" if m.group(1) == "1" else "poly",
               "lcg" if m.group(2) == "Lcg" else "xoshiro128p")
        ins = [(int(a, 16), op.split(".")[0], args)
               for a, op, args in _SASS_LINE.findall(fn)]
        loops = [(int(t.group(1), 16), a) for a, op, args in ins
                 if op == "BRA" and (t := re.search(r"0x([0-9a-f]+)", args))
                 and int(t.group(1), 16) < a]
        if not loops:
            _fail(f"montecarlo SASS: no loop in {key}")
        lo, hi = max(loops, key=lambda loop: loop[1] - loop[0])
        body = [op for a, op, _ in ins if lo <= a <= hi
                and op not in ("BRA", "ISETP") and not op.startswith("U")]
        samples = body.count("I2FP") / 2
        if not samples:
            _fail(f"montecarlo SASS: no conversion in the loop of {key}")
        counts[key] = (len(body) / samples,
                       sum(op in INT_PIPE_OPS for op in body) / samples)
    if len(counts) != 4:
        _fail(f"montecarlo SASS: found the kernels {sorted(counts)}")
    return counts


class Card:
    """The card's rates, from its SM count (``torch``) and its maximum SM
    clock (``nvidia-smi``)."""

    def __init__(self, torch, smi):
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        mhz = smi("clocks.max.sm", units=False)
        self.clock_hz = float(mhz) * 1e6
        self.fp32_per_s = self.sms * FP32_LANES_PER_SM * self.clock_hz
        self.int32_per_s = self.sms * INT32_LANES_PER_SM * self.clock_hz

    def describe(self) -> str:
        return (f"rates: {self.sms} SMs at {self.clock_hz / 1e6:.0f} MHz: "
                f"fp32 {self.fp32_per_s:.4g} instructions/s "
                f"({2 * self.fp32_per_s:.4g} FLOP/s with a multiply-add as "
                f"2), int32 {self.int32_per_s:.4g} instructions/s, "
                f"device memory {HBM_BYTES_PER_S:.4g} B/s")

    def bound(self, nbytes: float,
              ops: tuple[float, float]) -> tuple[float, str]:
        """The least time for ``nbytes`` of device memory and ``ops`` = (all
        instructions, integer-pipe instructions), in ms, and what binds it.
        Every instruction takes one of the four dispatch slots per SM and
        clock (a warp instruction each, 128 lanes: the FP32 rate); the
        integer-pipe ones also take the INT32 lanes (64 per SM)."""
        total, int_pipe = ops
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(total / self.fp32_per_s,
                    int_pipe / self.int32_per_s) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def latency_ms(self, steps: float, chain: int) -> float:
        """The least time of ``steps`` sequential generator steps, each a
        chain of ``chain`` dependent integer instructions."""
        return steps * chain * ALU_LATENCY_CLOCKS / self.clock_hz * 1e3


def _smi(fields: str, units: bool = True) -> str:
    """``nvidia-smi --query-gpu=<fields>`` for the first card."""
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           f"--format={fmt}"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one eager call of ``fn`` between two CUDA events: the
    device time, or the host's launch cost where that is longer."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, per_graph: int = 10, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``per_graph`` calls captured in a
    CUDA graph, the graph replayed ``reps`` times between CUDA events
    (after a warm-up replay), the median divided by ``per_graph``.  The
    replay takes the host out, so a launch-bound call reads as what the
    card spends on it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return _call_ms(graph.replay, reps=reps, warmup=1) / per_graph


def _times(kernel, plain, library) -> dict:
    """``ms``, ``plain_ms`` and ``library_ms`` are device times per call
    (``_device_ms``); ``call_ms`` is the kernel's eager per-call time."""
    return dict(ms=_device_ms(kernel), plain_ms=_device_ms(plain),
                library_ms=None if library is None else _device_ms(library),
                call_ms=_call_ms(kernel))


def _bf16_ulp_err(got, want) -> float:
    """Largest |got - want| in units of one bf16 ulp of ``want``."""
    import torch
    g, w = got.float(), want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), (e - 8).to(torch.int32))
    err = (g - w).abs() / torch.where(w == 0, torch.ones_like(w), ulp)
    return float(torch.where(w == 0, (g != 0).float() * 1e9, err).max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(torch, gen, card) -> list[dict]:
    from repro_torch.kernels import expf, prng, softmax
    from repro_torch.models.attention import NEG_INF

    entries = []

    # --- softmax: attention scores with masked (NEG_INF) columns, and row 0
    # masked whole.
    cases = []
    f32, bf16 = torch.float32, torch.bfloat16
    for rows, cols, dt, what in [
            (8192, 161, f32, "prefill (a)"),
            (64, 161, f32, "decode (a)"),
            (16, 5120, f32, "decode (c)"),
            (64, 32768, f32, "long row"),
            (64, 161, bf16, "decode, bf16"),
            (64, 1024, f32, "widest row of the warp path"),
            (64, 1025, f32, "narrowest row of the cluster path"),
            (8191, 161, f32, "prefill shape, ragged last block"),
            (64, 32768, bf16, "long row, bf16"),
            (16, 5121, bf16, "cluster path, 4-byte loads, bf16"),
            (2, softmax.CLUSTER_MAX_COLS, f32,
             "widest row of the cluster path"),
            (2, 1 << 20, f32, "beyond the cluster path")]:
        x = torch.randn(rows, cols, device="cuda", generator=gen) * 4
        x[:, cols // 2 + 1:] = NEG_INF
        x[0] = NEG_INF
        x = x.to(dt).contiguous()
        path = softmax.softmax_plan(rows, cols, dt).path
        before = dict(softmax.softmax_cuda.path_launches)
        got = softmax.softmax_cuda(x)
        again = softmax.softmax_cuda(x)
        want = softmax.softmax_plain(x)
        torch.cuda.synchronize()
        after = softmax.softmax_cuda.path_launches
        if {k: after[k] - before[k] for k in after} != {
                k: 2 * (k == path) for k in after}:
            _fail(f"softmax {what}: launches {before} -> {after}, expected "
                  f"two on the {path} path")
        if got.dtype != x.dtype:
            _fail(f"softmax {what}: dtype {got.dtype} != {x.dtype}")
        if not torch.equal(got, again):
            _fail(f"softmax {what}: two runs differ")
        if dt == torch.bfloat16:
            ulps = _bf16_ulp_err(got, want)
            if ulps > 1.0:
                _fail(f"softmax {what}: {ulps} bf16 ulps from the plain version")
        else:
            torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-7)
        nbytes = 2 * x.numel() * x.element_size()
        bound_ms, bound_by = card.bound(
            nbytes, [x.numel() * c for c in SOFTMAX_OPS])
        cases.append(dict(
            shape=[rows, cols], dtype=str(dt).removeprefix("torch."), what=what,
            path=path,
            max_abs_err=float((got.float() - want.float()).abs().max()),
            bound_ms=bound_ms, bound_by=bound_by,
            **_times(lambda: softmax.softmax_cuda(x),
                     lambda: softmax.softmax_plain(x),
                     lambda: torch.softmax(x, dim=-1))))
    entries.append(_entry("softmax", "src/repro_torch/csrc/softmax.cu",
                          "src/repro/kernels/softmax_tpu.py:44", cases, 1))

    # --- exp: one chunk of chunked attention, the extremes, a ragged tail,
    # a misaligned view and the attention correction's shape.
    ext = torch.tensor([-1e4, -87.5, 0.0, 88.9, 1e4, NEG_INF, float("-inf"),
                        float("inf"), float("nan")], device="cuda")
    for inp in (ext, torch.cat([ext[:1], ext])[1:]):   # aligned, misaligned
        got, want = expf.exp_cuda(inp), expf.exp_plain(inp)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-30,
                                   equal_nan=True)
        e = got.tolist()
        if e[0] != 0.0 or e[2] != 1.0 or e[4] != float("inf") or e[5] != 0.0:
            _fail(f"exp extremes: {e}")
    cases = []
    n16m = 16 * 1024 * 1024
    for n, offset, shape, what in [
            (n16m, 0, [1, 16, 1, 1024, 1024], "one KV chunk of prefill (c)"),
            (n16m + 3, 0, [n16m + 3], "16 M + 3: a tail of 3"),
            (n16m, 1, [n16m], "16 M, a view at a 4-byte offset"),
            (16384, 0, [1, 16, 1, 1024], "the correction of prefill (c)")]:
        buf = torch.empty(n + offset, device="cuda").uniform_(-90.0, 2.0,
                                                              generator=gen)
        buf[::97] = NEG_INF
        x = buf[offset:]
        before = dict(expf.exp_cuda.path_launches)
        got, want = expf.exp_cuda(x), expf.exp_plain(x)
        torch.cuda.synchronize()
        path = expf.exp_plan(n, x.data_ptr(), got.data_ptr()).path
        after = expf.exp_cuda.path_launches
        if {k: after[k] - before[k] for k in after} != {
                k: int(k == path) for k in after}:
            _fail(f"exp {what}: launches {before} -> {after}, expected one "
                  f"on the {path} path")
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-30)
        bound_ms, bound_by = card.bound(8 * n, [n * c for c in EXP_OPS])
        cases.append(dict(shape=shape, dtype="float32", what=what, path=path,
                          max_abs_err=float((got - want).abs().max()),
                          bound_ms=bound_ms, bound_by=bound_by,
                          **_times(lambda: expf.exp_cuda(x),
                                   lambda: expf.exp_plain(x),
                                   lambda: torch.exp(x))))
    entries.append(_entry("exp", "src/repro_torch/csrc/expf.cu",
                          "src/repro/kernels/expf.py:38", cases, 0))

    # --- uniform: bit-exact for both generators and the seed extremes.
    cases = []
    for n, what in [(50304, "one sampling draw, V = 50304"),
                    (1 << 24, "16 M values")]:
        for kind in ("xoshiro128p", "lcg"):
            for seed in (0, 2 ** 31 + 5, 2 ** 32 - 1):
                got = prng.uniform_cuda(seed, n, kind)
                want = prng.uniform_plain(seed, n, kind, "cuda")
                if not torch.equal(got, want):
                    _fail(f"uniform {kind} n={n} seed={seed}: not bit-exact")
            bound_ms, bound_by = card.bound(
                4 * n, [n * c for c in UNIFORM_OPS[kind]])
            cases.append(dict(
                shape=[n], dtype="float32", what=f"{what}, {kind}",
                max_abs_err=0.0,
                bound_ms=bound_ms, bound_by=bound_by,
                **_times(lambda: prng.uniform_cuda(seed, n, kind),
                         lambda: prng.uniform_plain(seed, n, kind, "cuda"),
                         None)))
    entries.append(_entry("uniform", "src/repro_torch/csrc/prng.cu",
                          "src/repro/kernels/prng.py:46", cases, 0))
    entries.append(check_log(torch, gen, card))
    entries.append(check_montecarlo(torch, card))
    return entries


def log_input(torch, gen):
    """16 M positive normals, log-uniform over 1e-30..1e30."""
    x = torch.empty(16 * 1024 * 1024, device="cuda")
    x.uniform_(math.log(1e-30), math.log(1e30), generator=gen)
    return torch.exp(x)


def check_log(torch, gen, card) -> dict:
    import numpy as np

    from repro_torch.kernels import logf

    x = log_input(torch, gen)
    got, want = logf.log_cuda(x), logf.log_plain(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    err = float((got - want).abs().max())
    # Accuracy against fp64 over the whole normal range of the tests.
    grid = np.logspace(-30, 30, 4097).astype(np.float32)
    g = logf.log_cuda(torch.from_numpy(grid).cuda()).cpu().numpy()
    np.testing.assert_allclose(g.astype(np.float64),
                               np.log(grid.astype(np.float64)),
                               rtol=1e-5, atol=6e-7)
    # Outside the domain the kernel maps x <= 0 to 1, as its plain version.
    odd = torch.tensor([-3.0, -0.0, 0.0, 1.0, 2.5], device="cuda")
    torch.testing.assert_close(logf.log_cuda(odd), logf.log_plain(odd),
                               rtol=1e-5, atol=1e-6)
    bound_ms, bound_by = card.bound(8 * x.numel(),
                                    [x.numel() * c for c in LOG_OPS])
    cases = [dict(shape=[x.numel()], dtype="float32",
                  what="16 M positive normals, log-uniform 1e-30..1e30",
                  max_abs_err=err, bound_ms=bound_ms, bound_by=bound_by,
                  **_times(lambda: logf.log_cuda(x),
                           lambda: logf.log_plain(x),
                           lambda: torch.log(x)))]
    print("logf: within rtol 1e-5 / atol 1e-6 of its plain version on 16 M "
          "values; within rtol 1e-5 / atol 6e-7 of fp64 log on "
          "logspace(-30, 30, 4097)")
    return _entry("logf", "src/repro_torch/csrc/logf.cu",
                  "src/repro/kernels/logf.py:34", cases, 0)


MC_SAMPLES = 1 << 26


def check_montecarlo(torch, card) -> dict:
    from repro_torch.kernels import montecarlo as mc

    variants = [(p, k) for p in ("pi", "poly") for k in ("lcg", "xoshiro128p")]
    # Bit-exact against the plain version, at a moderate iters.
    for problem, kind in variants:
        for seed in (0, 2 ** 32 - 1):
            kw = dict(kind=kind, problem=problem, iters=256, n_blocks=8)
            got = mc.mc_partial_sums_cuda(seed, **kw)
            want = mc.mc_blocked_plain(seed, device="cuda", **kw)
            if not torch.equal(got, want):
                _fail(f"montecarlo {problem} {kind} seed={seed}: partial "
                      "sums not bit-exact")
    print("montecarlo: partial sums bit-exact against the plain version for "
          "{pi, poly} x {lcg, xoshiro128p}, seeds 0 and 2**32-1, n_blocks 8, "
          "iters 256")
    # Timed at full size: 2**26 samples, the facade's default n_blocks = 8
    # (one warp per scheduler on 64 SMs) and n_blocks = 1024 (the card
    # full).  The plain version takes one Python step per sample, so it is
    # timed as one eager call.  Beside the card's bound, two bounds of one
    # lane, which runs its samples in order: the dependent chain of its
    # generator (latency) and its instructions at one per clock (dispatch).
    from repro_torch.kernels import _build
    sass = mc_sass_counts(_build.library_path("montecarlo"))
    print("montecarlo: instructions per sample in the kernels' loops (SASS; "
          "all, integer pipe):", json.dumps({f"{p} {k}": v for (p, k), v
                                             in sorted(sass.items())}))
    cases = []
    for n_blocks in (8, 1024):
        iters = MC_SAMPLES // (n_blocks * mc.LANES)
        for problem, kind in variants:
            kw = dict(kind=kind, problem=problem, iters=iters,
                      n_blocks=n_blocks)
            kernel = functools.partial(mc.mc_partial_sums_cuda, 42, **kw)
            plain = functools.partial(mc.mc_blocked_plain, 42,
                                      device="cuda", **kw)
            samples = iters * n_blocks * mc.LANES
            per_sample = sass[problem, kind]
            bound_ms, bound_by = card.bound(
                4 * n_blocks * mc.LANES, [samples * c for c in per_sample])
            cases.append(dict(
                shape=[n_blocks, mc.LANES], dtype="float32",
                what=f"{problem} {kind}, 2**26 samples, n_blocks {n_blocks}",
                iters=iters, max_abs_err=0.0,
                bound_ms=bound_ms, bound_by=bound_by,
                instructions_per_sample=per_sample,
                latency_bound_ms=card.latency_ms(2 * iters, MC_CHAIN[kind]),
                lane_dispatch_bound_ms=(iters * per_sample[0] / card.clock_hz
                                     * 1e3),
                ms=_device_ms(kernel), call_ms=_call_ms(kernel),
                plain_ms=_call_ms(plain, reps=1 if n_blocks == 8 else 3,
                                  warmup=0),
                plain_timing="eager, one Python step per sample",
                library_ms=None))
    return _entry("montecarlo", "src/repro_torch/csrc/montecarlo.cu",
                  "src/repro/kernels/montecarlo.py:76", cases, 1)


def _entry(name, source, replaces, cases, headline) -> dict:
    """One kernel's line entry: the numbers of its headline case (the shape
    its main path launches most), every case beside them."""
    h = cases[headline]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None,
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=h["ms"], kernel_ms=h["ms"], plain_ms=h["plain_ms"],
                bound_ms=h["bound_ms"], bound_by=h["bound_by"],
                library_ms=h["library_ms"], call_ms=h["call_ms"],
                headline=h["what"], cases=cases)


# ---------------------------------------------------------------------------
# phase 3: the port on the card against the port on the CPU, small model
# ---------------------------------------------------------------------------

def check_reference(torch) -> None:
    import numpy as np

    from repro_torch.configs import load_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = load_config("olmo-1b", "smoke")
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = init_params(cfg, torch.Generator().manual_seed(0), "cpu").cuda()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    for kw in (dict(), dict(temperature=1.0, seed=2)):
        want = ServeEngine(cfg, cpu, max_len=40, batch=2, device="cpu",
                           **kw).generate(prompts, 12)
        got = ServeEngine(cfg, card, max_len=40, batch=2, device="cuda",
                          **kw).generate(prompts, 12)
        torch.testing.assert_close(got.logits.cpu(), want.logits, rtol=1e-4,
                                   atol=1e-4)
        if not np.array_equal(got.tokens, want.tokens):
            _fail(f"smoke reference {kw}: tokens on the card differ from "
                  "the CPU's")
    print("reference: olmo-1b smoke on the card matches the CPU "
          "(logits rtol 1e-4 atol 1e-4, tokens identical, greedy and sampled)")


# ---------------------------------------------------------------------------
# phase 4: serving OLMo-1B at full width
# ---------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels import expf, logf, montecarlo, prng, softmax
    return {"softmax": softmax.softmax_cuda, "exp": expf.exp_cuda,
            "uniform": prng.uniform_cuda, "logf": logf.log_cuda,
            "montecarlo": montecarlo.mc_partial_sums_cuda}


def _reset_counters() -> dict:
    """Set every launch counter, and every per-path counter, to 0."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
        for path in getattr(c, "path_launches", {}):
            c.path_launches[path] = 0
    return counters


def _path_launches(counters) -> dict:
    return {k: dict(c.path_launches) for k, c in counters.items()
            if hasattr(c, "path_launches")}


def _request(label, fn, vocab):
    """Run one request with every launch counter at 0; check its output."""
    import torch
    counters = _reset_counters()
    t0 = time.perf_counter()
    res = fn()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    paths = _path_launches(counters)
    B, n = res.tokens.shape[0], res.steps
    if res.logits.shape != (B, n, vocab):
        _fail(f"{label}: logits shape {tuple(res.logits.shape)}")
    if not bool(torch.isfinite(res.logits).all()):
        _fail(f"{label}: non-finite logits")
    if not ((res.tokens >= 0) & (res.tokens < vocab)).all():
        _fail(f"{label}: token outside [0, {vocab})")
    row = dict(request=label, batch=B, prompt=res.tokens.shape[1] - n,
               new_tokens=n, prefill_ms=res.prefill_s * 1e3,
               decode_ms_per_token=res.decode_s * 1e3 / n,
               tokens_per_s=B * n / (res.prefill_s + res.decode_s),
               wall_s_with_init=wall, launches=launches,
               path_launches=paths)
    print("serve:", json.dumps(row))
    return res, row


def profile_serving(torch, engine, prompts, n_steps: int) -> None:
    """Where the time of a request of (a)'s shape goes: one generate()
    under torch.profiler, its device activity read from the exported
    trace.  Prints the device-busy share of the request's wall time and
    the kernels that take the most device time.  A measurement only: it
    checks nothing, and the profiler's own cost inflates the wall time."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    engine.generate(prompts, 2)                      # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = engine.generate(prompts, n_steps)
    trace = ROOT / "build" / "chip_smoke_trace.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = Counter()
    for e in dev:
        by_name[e["name"][:80]] += e["dur"] / 1e3
    busy_ms = sum(by_name.values())
    wall_ms = (res.prefill_s + res.decode_s) * 1e3
    print("profile:", json.dumps(dict(
        request=f"batch 4, prompt 128, {n_steps} new tokens, greedy",
        wall_ms_under_profiler=wall_ms,
        device_busy_ms=busy_ms if dev else "not measured",
        device_busy_share=busy_ms / wall_ms if dev else "not measured",
        device_ops=len(dev),
        top=[[k, v] for k, v in by_name.most_common(8)])))


def serve_full(torch) -> dict:
    import numpy as np

    from repro_torch.configs import load_config
    from repro_torch.launch import serve
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = load_config("olmo-1b", "full")
    V = cfg.vocab_size
    argv = ["--arch", "olmo-1b", "--variant", "full", "--batch", "4",
            "--prompt-len", "128", "--gen", "32", "--device", "cuda"]
    total = {k: 0 for k in _counters()}
    paths = {k: dict.fromkeys(v, 0)
             for k, v in _path_launches(_counters()).items()}
    rows = []

    a1, row = _request("a: greedy, run 1", lambda: serve.main(argv), V)
    rows.append(row)
    a2, row = _request("a: greedy, run 2", lambda: serve.main(argv), V)
    rows.append(row)
    if not np.array_equal(a1.tokens, a2.tokens):
        _fail("(a): two greedy runs gave different tokens")
    if not np.array_equal(a1.tokens[:, 128:], a1.logits.argmax(-1).cpu()):
        _fail("(a): greedy tokens are not the argmax of their logits")
    b, row = _request("b: temperature 1.0, seed 3", lambda: serve.main(
        argv + ["--temperature", "1.0", "--seed", "3"]), V)
    rows.append(row)
    del a1, a2, b

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    engine = ServeEngine(cfg, params, max_len=5120, batch=1, device="cuda")
    prompt = np.random.default_rng(0).integers(0, V, (1, 2048)).astype(np.int32)
    _, row = _request("c: prompt 2048, max_len 5120",
                      lambda: engine.generate(prompt, 8), V)
    rows.append(row)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve: peak device memory {peak_gb:.2f} GB")
    profile_serving(torch, ServeEngine(cfg, params, max_len=161, batch=4,
                                       device="cuda"),
                    np.random.default_rng(1).integers(0, V, (4, 128)), 16)

    for r in rows:
        for k, v in r["launches"].items():
            total[k] += v
        for k, by_path in r["path_launches"].items():
            for path, v in by_path.items():
                paths[k][path] += v
    need = {"softmax": rows[0], "uniform": rows[2], "exp": rows[3]}
    for k, r in need.items():
        if r["launches"][k] <= 0:
            _fail(f"the {k} kernel was not launched in request {r['request']}")
    # (a) and (b): 8192x161 prefill and 64x161 decode, on the warp path;
    # (c): 16x5120 decode on the cluster path, its chunked prefill on exp's
    # vector path.
    for r in rows[:3]:
        sm = r["path_launches"]["softmax"]
        if sm["warp"] <= 0 or sm["cluster"] or sm["sweep"]:
            _fail(f"{r['request']}: softmax paths {sm}, expected the warp "
                  "path only")
    sm = rows[3]["path_launches"]["softmax"]
    ex = rows[3]["path_launches"]["exp"]
    if sm["cluster"] <= 0 or sm["warp"] or sm["sweep"]:
        _fail(f"(c): softmax paths {sm}, expected the cluster path only")
    if ex["vector"] <= 0 or ex["scalar"]:
        _fail(f"(c): exp paths {ex}, expected the vector path only")
    return total, paths


# ---------------------------------------------------------------------------
# phase 5: the kernel facade, every runnable spec through kernel(name).run
# ---------------------------------------------------------------------------

def _facade_cases(torch, gen):
    """name -> a function that runs the spec's ``.run`` on the card at full
    size and holds it against ``.ref`` (or the plain version where the spec
    has no oracle), returning the largest error."""
    from repro_torch.kernels import ops, softmax
    from repro_torch.models.attention import NEG_INF

    def expf(spec):
        x = torch.empty(16 * 1024 * 1024, device="cuda").uniform_(
            -90.0, 2.0, generator=gen)
        x[::97] = NEG_INF
        got, want = spec.run(x), spec.ref(x)
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-30)
        return float((got - want).abs().max())

    def logf(spec):
        x = log_input(torch, gen)
        got, want = spec.run(x), spec.ref(x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        return float((got - want).abs().max())

    def softmax_(spec):
        err = 0.0
        for rows, cols, dt in [(8192, 161, torch.float32),
                               (64, 161, torch.float32),
                               (16, 5120, torch.float32),
                               (64, 32768, torch.float32),
                               (64, 161, torch.bfloat16)]:
            x = torch.randn(rows, cols, device="cuda", generator=gen) * 4
            x[:, cols // 2 + 1:] = NEG_INF
            x = x.to(dt)
            got = spec.run(x)
            if dt == torch.float32:
                want = spec.ref(x)
                torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-7)
            else:
                # The oracle subtracts the max in the input dtype, as the
                # JAX oracle does; the kernel does it in fp32.  In bf16 the
                # kernel is held to its plain version instead.
                want = softmax.softmax_plain(x)
                if _bf16_ulp_err(got, want) > 1.0:
                    _fail("facade softmax bf16: more than 1 bf16 ulp from "
                          "the plain version")
            err = max(err, float((got.float() - want.float()).abs().max()))
        return err

    def prng(spec):
        for kind in ("xoshiro128p", "lcg"):
            for n in (50304, 1 << 24):
                got = spec.run(2 ** 32 - 1, (n,), kind)
                if not torch.equal(got, spec.ref(kind, 2 ** 32 - 1, (n,))):
                    _fail(f"facade prng {kind} n={n}: not bit-exact")
        return 0.0

    def montecarlo(fn, truth):
        def run(spec):
            for n_blocks in (8, 1024):
                est = spec.run(42, MC_SAMPLES, n_blocks=n_blocks)
                want = fn(42, MC_SAMPLES, n_blocks=n_blocks, impl="reference")
                if float(est) != float(want):
                    _fail(f"facade {spec.name} n_blocks={n_blocks}: "
                          f"{float(est)!r} != plain {float(want)!r}")
                if not abs(float(est) - truth) < 0.002:
                    _fail(f"facade {spec.name} n_blocks={n_blocks}: "
                          f"estimate {float(est)!r} is not within 0.002 "
                          f"of {truth}")
                print(f"facade: {spec.name} n_blocks={n_blocks}: "
                      f"{float(est)!r} (2**26 samples, equal to the plain "
                      "version)")
            return 0.0
        return run

    return {"expf": expf, "logf": logf, "softmax": softmax_, "prng": prng,
            "pi_xoshiro128p": montecarlo(ops.mc_pi, math.pi),
            "poly_xoshiro128p": montecarlo(ops.mc_poly, 0.4)}


def check_facade(torch, gen) -> dict:
    """Every spec of ``repro_torch.api`` that has an entry point, run through
    ``kernel(name).run`` on the card under ``config(impl="cuda")``.  Every
    launch counter is set to 0 just before and read just after; each kernel
    must have launched."""
    from repro_torch import api

    cases = _facade_cases(torch, gen)
    runnable = [s for s in api.specs() if s.op is not None]
    missing = sorted({s.name for s in runnable} - set(cases))
    if missing:
        _fail(f"facade: no check for the runnable specs {missing}")
    if api.kernel("montecarlo") is not api.kernel("pi_xoshiro128p"):
        _fail("facade: 'montecarlo' does not resolve to pi_xoshiro128p")
    counters = _reset_counters()
    errs = {}
    with api.config(impl="cuda"):
        for spec in runnable:
            errs[spec.name] = cases[spec.name](spec)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    print("facade:", json.dumps(dict(max_abs_err=errs, launches=launches)))
    for k, n in launches.items():
        if n <= 0:
            _fail(f"facade: the {k} kernel was not launched")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    smi = _smi("name,power.limit")
    print(smi)
    card = Card(torch, _smi)
    print(card.describe())
    t_build = _build.build_all()
    print(f"kernels built in {t_build:.1f} s into {_build.BUILD_DIR}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    entries = check_kernels(torch, gen, card)
    check_reference(torch)
    serving, serving_paths = serve_full(torch)
    facade = check_facade(torch, gen)
    for e in entries:
        phase = "facade" if e["name"] in ("logf", "montecarlo") else "serving"
        e["launches"] = (facade if phase == "facade" else serving)[e["name"]]
        e["launches_counted_in"] = f"the {phase} phase"
        if e["name"] in serving_paths:
            e["launches_by_path"] = serving_paths[e["name"]]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
