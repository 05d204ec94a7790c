"""Smoke-size cells for the CPU tests: the program's smoke configurations
(fp32 compute, tiny widths) described in the benchmark's file format, with
limits for fp32 against fp32."""

import copy
import json

from bench import harness

OPT = harness.load_json(harness.BENCH / "traffic" / "train_8x2048.json")[
    "optimizer"]
#: fp32 program against the fp32 reference: the gaps are rounding
LIMITS = {"train": {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4},
          "serve": {"served_gap": 1e-3},
          "prefill": {"logit_error": 1e-4},
          "moe_prefill": {"logit_error": 1e-4, "routing_gap": 1e-4,
                          "rerun_mismatch": 0.0}}


def config(arch: str, **moe) -> dict:
    """The file of ``arch`` rewritten for its smoke variant (and ``moe``
    keys replaced in both the program and the file)."""
    from repro_torch.configs import load_config
    cfg = load_config(arch, "smoke")
    c = copy.deepcopy(harness.load_json(
        harness.BENCH / "configs" / f"{arch}.json"))
    for k in harness.MODEL_KEYS:
        c["model"][k] = getattr(cfg, k)
    replace = {}
    if cfg.moe:
        for k in harness.MOE_KEYS:
            c["model"]["moe"][k] = getattr(cfg.moe, k)
        c["model"]["moe"].update(moe)
        if moe:
            import dataclasses
            replace["moe"] = dataclasses.replace(cfg.moe, **moe)
    c["program"] = {"arch": arch, "variant": "smoke", "replace": replace}
    return c


def train_traffic(batch=2, seq=32) -> dict:
    return {"kind": "train", "batch": batch, "seq": seq, "optimizer": OPT,
            "trace_units": 2}


def serve_traffic(batch=4, prompt=16, new=8, temperature=0.8) -> dict:
    return {"kind": "serve", "batch": batch, "prompt": prompt,
            "new_tokens": new, "temperature": temperature, "prompt_sets": 2,
            "warmup_calls": 1, "warmup_new_tokens": min(new, 2),
            "trace_units": 2}


def context(arch: str, traffic: dict, seed: int = 2 ** 33 + 5,
            requests: int = 4, limits: str | None = None,
            **moe) -> harness.Context:
    kind = traffic["kind"]
    chk = {"steps": 3} if kind == "train" else {"requests": requests}
    chk["limits"] = dict(LIMITS[limits or kind])
    cell = {"name": f"{arch}.smoke", "check": chk}
    return harness.Context(cell, config(arch, **moe), traffic, seed,
                           device="cpu")


def benchmark_for(ctx: harness.Context) -> dict:
    """BENCHMARK.json with the smoke cell added to every metric's cells."""
    b = json.loads(json.dumps(harness.load_json(harness.ROOT /
                                                "BENCHMARK.json")))
    for kind in ("end_to_end", "per_layer"):
        for mt in b[kind]:
            if "workloads" in mt:
                mt["workloads"].append(ctx.cell["name"])
    return b
