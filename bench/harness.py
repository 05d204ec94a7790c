"""What every cell shares: the files a cell is made of, the card, the
program's model built from the benchmark's weights, the window, the
metric readers and the result line.

A cell is ``bench/workloads/<cell>.json``.  It names a configuration
(``bench/configs/<config>.json``), a traffic mix
(``bench/traffic/<traffic>.json``, whose ``kind`` picks the driver
``bench/drivers/<kind>.py``) and the limits of its check.  A metric is
``bench/metrics/<metric>.py``, whose ``read(ctx)`` returns the number or
None; ``BENCHMARK.json`` says which cells report it.
"""

from __future__ import annotations

import copy
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from bench.reference.weights import ParamSpec, Redraw, chunk_seed, make_all

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
#: top-level modules that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoCard(SystemExit):
    pass


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(cell: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(workload, configuration, traffic) of ``cell``."""
    w = load_json(root / "bench" / "workloads" / f"{cell}.json")
    if w["name"] != cell:
        raise ValueError(f"workload file {cell}.json names {w['name']!r}")
    c = load_json(root / "bench" / "configs" / f"{w['config']}.json")
    t = load_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    return w, c, t


def metrics_of(benchmark: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports."""
    return [mt for mt in benchmark[kind]
            if "workloads" not in mt or cell in mt["workloads"]]


def load_metric(name: str, root: Path = ROOT):
    """The reader ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return importlib.import_module(f"bench.drivers.{kind}")


def require_card(chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("PyTorch sees no CUDA device: this benchmark runs on "
                     "the card only")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, PyTorch sees "
                     f"{torch.cuda.device_count()}")


def smi(fields: str) -> str:
    """One line of ``nvidia-smi`` for the first card, or "not read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip() or "not read"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sub_seed(seed: int, what: int) -> int:
    return chunk_seed(seed, (1 << 40) + what)


# ---------------------------------------------------------------------------
# the program, from the benchmark's configuration and weights
# ---------------------------------------------------------------------------

#: configuration keys the program's ``ModelConfig`` must hold as stated
MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "vocab_size", "norm", "act", "rope_theta",
              "tie_embeddings", "dtype", "param_dtype", "remat")
MOE_KEYS = ("n_experts", "top_k", "n_shared", "d_expert", "capacity_factor",
            "layer_pattern")


def program_config(config: dict):
    """The program's ``ModelConfig`` for ``config``, checked against every
    size and choice the file states."""
    from repro_torch.configs import load_config
    from repro_torch.models import moe as program_moe
    from repro_torch.models.model import loss_fn
    p = config["program"]
    cfg = load_config(p["arch"], p.get("variant", "full")).replace(
        **p.get("replace", {}))
    want = config["model"]
    bad = [k for k in MODEL_KEYS if getattr(cfg, k) != want[k]]
    if not cfg.use_copift_softmax or cfg.rope != "rope" or not cfg.causal:
        bad.append("use_copift_softmax/rope/causal")
    if (cfg.moe is None) != (want.get("moe") is None):
        bad.append("moe")
    elif cfg.moe is not None:
        bad += [f"moe.{k}" for k in MOE_KEYS
                if getattr(cfg.moe, k) != want["moe"][k]]
        if program_moe.GROUP != want["moe"]["group_tokens"]:
            bad.append("moe.group_tokens")
    import inspect
    sig = inspect.signature(loss_fn).parameters
    for k in ("aux_weight", "z_weight"):
        if sig[k].default != config["loss"][k]:
            bad.append(f"loss.{k}")
    if bad:
        raise ValueError(f"{config['name']}: the program's configuration "
                         f"differs from the file in {bad}")
    return cfg


def program_model(cfg, specs: list[ParamSpec], seed: int, matrix_dtype,
                  const_dtype, device):
    """The program's ``LMModel`` holding the benchmark's seeded weights:
    matrices drawn on the card in ``matrix_dtype``, constants in
    ``const_dtype(name)``.  Raises unless the program's parameters are the
    reference's, name for name and shape for shape."""
    from repro_torch.models.model import LMModel
    model = LMModel(cfg, "meta")
    have = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    want = [(s.name, s.shape) for s in specs]
    if have != want:
        diff = [(h, w) for h, w in zip(have, want) if h != w][:3]
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's: {diff or (len(have), len(want))}")
    tensors = make_all(specs, seed, matrix_dtype, device, const_dtype)
    model.load_state_dict(tensors, strict=True, assign=True)
    return model


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

@dataclass
class Context:
    """What a driver and the metric readers share."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    device: str = "cuda"
    ref: object = None            # the reference module the config names
    model: object = None
    specs: list = None
    units: list = field(default_factory=list)
    setup_s: float = 0.0
    window_s: float = 0.0
    trace: object = None          # trace.TraceData in a traced run
    traced_units: list = field(default_factory=list)

    def __post_init__(self):
        self.ref = importlib.import_module(
            f"bench.reference.{self.config['reference']}")
        self.model = self.ref.Model.from_config(self.config)
        self.specs = self.ref.param_specs(self.model)


def run_window(run, ctx: Context, seconds: float) -> None:
    """Whole units back to back until ``seconds`` have passed, into
    ``ctx.units``: the window that the end-to-end metrics and the
    host-clock per-layer metrics read."""
    from torch.profiler import record_function
    from bench import trace

    t0 = time.perf_counter()
    with record_function(trace.WINDOW):
        while True:
            with record_function(trace.UNIT):
                ctx.units.append(run.unit())
            if time.perf_counter() - t0 >= seconds:
                break
    sync(ctx.device)
    ctx.window_s = time.perf_counter() - t0


def run_traced(run, ctx: Context) -> None:
    """The traffic's ``trace_units`` units under ``torch.profiler``, into
    ``ctx.traced_units``, and their trace into ``ctx.trace``: the window
    that the device-trace metrics read."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from bench import trace

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            for _ in range(ctx.traffic["trace_units"]):
                with record_function(trace.UNIT):
                    ctx.traced_units.append(run.unit())
        sync(ctx.device)
    ctx.trace = trace.read(prof)


def all_units(ctx: Context) -> list[dict]:
    """Every unit the run timed, the traced ones last."""
    return ctx.units + ctx.traced_units


def sample_units(ctx: Context, n: int) -> list[tuple]:
    """(unit index in ``all_units``, row) of ``n`` requests drawn from the
    seed among those the run finished (all when fewer)."""
    pairs = [(u, r) for u, rec in enumerate(all_units(ctx))
             for r in range(rec["requests"])]
    rng = np.random.default_rng([ctx.seed & ((1 << 63) - 1), 7])
    pick = rng.choice(len(pairs), size=min(n, len(pairs)), replace=False)
    return [pairs[i] for i in sorted(pick)]


def sample_whole_units(ctx: Context, n: int) -> list[int]:
    """Indices in ``all_units`` of ``n`` units drawn from the seed among
    those the run finished (all when fewer)."""
    units = all_units(ctx)
    rng = np.random.default_rng([ctx.seed & ((1 << 63) - 1), 8])
    return sorted(int(u) for u in rng.choice(len(units),
                                             size=min(n, len(units)),
                                             replace=False))


def metric_view(ctx: Context, source: str) -> Context:
    """``ctx`` as a reader of ``source`` sees it: a device-trace metric
    reads the traced units, every other metric the untraced window's."""
    if source != "device_trace":
        return ctx
    view = copy.copy(ctx)
    view.units = ctx.traced_units
    return view


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reference_mode() -> None:
    """fp32 products as fp32 (no TF32) for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def redraw(ctx: Context, dtype, device) -> Redraw:
    return Redraw(ctx.specs, ctx.seed, dtype, device)


def measure(benchmark: dict, ctx: Context, run, seconds: float,
            traced: bool) -> tuple[dict, list[str]]:
    """The window (in a traced run, then ``trace_units`` more units under
    the profiler), then the program's state freed and the check: the
    result (every key but the card's name) and the check's lines."""
    from bench.reference import check
    cuda = torch.device(ctx.device).type == "cuda"
    run_window(run, ctx, seconds)
    if traced:
        run_traced(run, ctx)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = run.failed() if hasattr(run, "failed") else 0
    attempted = sum(u["requests"] for u in all_units(ctx))
    if hasattr(run, "after_window"):
        run.after_window()
    run.free()
    if cuda:
        torch.cuda.empty_cache()
    numbers = run.check()
    limits = ctx.cell["check"]["limits"]
    correct, lines = check.verdict(numbers, limits)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for mt in metrics_of(benchmark, ctx.cell["name"], kind):
        value = load_metric(mt["name"]).read(metric_view(ctx, mt["source"]))
        if value is not None:
            metrics[mt["name"]] = {"value": value, "unit": mt["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if traced:
        from bench import trace
        device.update(busy_s=ctx.trace.busy_s(), window_s=ctx.trace.window_s)
        result["breakdown"] = trace.breakdown(ctx.trace)
    result["check"] = {
        k: {"value": numbers[k] if math.isfinite(numbers.get(k, math.nan))
            else None, "limit": v} for k, v in limits.items()}
    return result, lines
