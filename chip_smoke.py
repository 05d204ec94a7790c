#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. The card's name and power limit (``nvidia-smi``), then the build of every
   CUDA kernel from ``src/repro_torch/csrc`` (nvcc into ``build/``).
2. Every kernel held against its plain PyTorch version on the card, at the
   shapes the serving path gives it, and timed with CUDA events (median of
   20 runs after warm-up; device time from CUDA-graph replays, plus the
   eager per-call time) beside its plain version, one PyTorch library call
   computing the same function where there is one, and its bound: the
   larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s (H100 SXM
   HBM3 and fp32 non-tensor peaks).  One JSON line ``{"kernels": [...]}``.
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
   Every logit must be finite and every token inside the vocabulary.
5. The last line: ``{"ok": true, "device": {...}}``.

fp32 matmuls and convolutions are pinned to full fp32 (TF32 off).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
#: Operations per element of the COPIFT exp: z, rint, two Cody–Waite
#: multiply-adds (4), clamp (2), convert, add, shift, seven Horner
#: multiply-adds (14), scale multiply, two compare-selects (4).
EXP_OPS = 27
#: Integer operations per element of the uniform kernel: counter add,
#: splitmix32 (9 each), the generator step, shift, convert, scale.
UNIFORM_OPS = {"lcg": 1 + 9 + 4 + 3, "xoshiro128p": 2 + 2 * 9 + 1 + 3}


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


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

def check_kernels(torch, gen) -> list[dict]:
    from repro_torch.kernels import expf, prng, softmax
    from repro_torch.models.attention import NEG_INF

    entries = []

    # --- softmax: attention scores with masked (NEG_INF) columns.
    cases = []
    for rows, cols, dt, what in [(8192, 161, torch.float32, "prefill (a)"),
                                 (64, 161, torch.float32, "decode (a)"),
                                 (16, 5120, torch.float32, "decode (c)"),
                                 (64, 32768, torch.float32, "long row"),
                                 (64, 161, torch.bfloat16, "decode, bf16")]:
        x = torch.randn(rows, cols, device="cuda", generator=gen) * 4
        x[:, cols // 2 + 1:] = NEG_INF
        x = x.to(dt).contiguous()
        got = softmax.softmax_cuda(x)
        want = softmax.softmax_plain(x)
        torch.cuda.synchronize()
        if got.dtype != x.dtype:
            _fail(f"softmax {what}: dtype {got.dtype} != {x.dtype}")
        if dt == torch.bfloat16:
            ulps = _bf16_ulp_err(got, want)
            if ulps > 1.0:
                _fail(f"softmax {what}: {ulps} bf16 ulps from the plain version")
        else:
            torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-7)
        nbytes = 2 * x.numel() * x.element_size()
        bound_ms, bound_by = _bound(nbytes, x.numel() * (2 * (EXP_OPS + 1) + 3))
        cases.append(dict(
            shape=[rows, cols], dtype=str(dt).removeprefix("torch."), what=what,
            max_abs_err=float((got.float() - want.float()).abs().max()),
            bound_ms=bound_ms, bound_by=bound_by,
            **_times(lambda: softmax.softmax_cuda(x),
                     lambda: softmax.softmax_plain(x),
                     lambda: torch.softmax(x, dim=-1))))
    entries.append(_entry("softmax", "src/repro_torch/csrc/softmax.cu",
                          "src/repro/kernels/softmax_tpu.py:44", cases, 1))

    # --- exp: one chunk of chunked attention, then the extremes.
    x = torch.empty(16 * 1024 * 1024, device="cuda").uniform_(-90.0, 2.0,
                                                               generator=gen)
    x[::97] = NEG_INF
    ext = torch.tensor([-1e4, -87.5, 0.0, 88.9, 1e4, NEG_INF, float("-inf"),
                        float("inf"), float("nan")], device="cuda")
    for inp in (ext, x):
        got, want = expf.exp_cuda(inp), expf.exp_plain(inp)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-30,
                                   equal_nan=True)
    e = expf.exp_cuda(ext).tolist()
    if e[0] != 0.0 or e[2] != 1.0 or e[4] != float("inf") or e[5] != 0.0:
        _fail(f"exp extremes: {e}")
    fin = torch.isfinite(want)
    bound_ms, bound_by = _bound(8 * x.numel(), EXP_OPS * x.numel())
    cases = [dict(shape=[1, 16, 1, 1024, 1024], dtype="float32",
                  what="one KV chunk of prefill (c)",
                  max_abs_err=float((got - want)[fin].abs().max()),
                  bound_ms=bound_ms, bound_by=bound_by,
                  **_times(lambda: expf.exp_cuda(x),
                           lambda: expf.exp_plain(x),
                           lambda: torch.exp(x)))]
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
            bound_ms, bound_by = _bound(4 * n, UNIFORM_OPS[kind] * n)
            cases.append(dict(
                shape=[n], dtype="float32", what=f"{what}, {kind}",
                max_abs_err=0.0,
                bound_ms=bound_ms, bound_by=bound_by,
                **_times(lambda: prng.uniform_cuda(seed, n, kind),
                         lambda: prng.uniform_plain(seed, n, kind, "cuda"),
                         None)))
    entries.append(_entry("uniform", "src/repro_torch/csrc/prng.cu",
                          "src/repro/kernels/prng.py:46", cases, 0))
    return entries


def _entry(name, source, replaces, cases, headline) -> dict:
    """One kernel's line entry: the numbers of its headline case (the shape
    the serving path launches most), every case beside them."""
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
    from repro_torch.kernels import expf, prng, softmax
    return {"softmax": softmax.softmax_cuda, "exp": expf.exp_cuda,
            "uniform": prng.uniform_cuda}


def _request(label, fn, vocab):
    """Run one request with every launch counter at 0; check its output."""
    import torch
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = fn()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
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
               wall_s_with_init=wall, launches=launches)
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
    need = {"softmax": rows[0], "uniform": rows[2], "exp": rows[3]}
    for k, r in need.items():
        if r["launches"][k] <= 0:
            _fail(f"the {k} kernel was not launched in request {r['request']}")
    return total


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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t_build = _build.build_all()
    print(f"kernels built in {t_build:.1f} s into {_build.BUILD_DIR}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    entries = check_kernels(torch, gen)
    check_reference(torch)
    launches = serve_full(torch)
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
