"""Every file of the benchmark loads, and a cell, a traffic mix and a
metric added as new files are found without an edit elsewhere."""

import json
import shutil

import pytest

from bench import harness

BENCHMARK = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    entry = {w["name"]: w for w in BENCHMARK["workloads"]}[cell]
    w, c, t = harness.cell_files(cell)
    assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert c["name"] == w["config"] and t["name"] == w["traffic"]
    run_cls = harness.driver(t["kind"]).Run
    ctx = harness.Context(w, c, t, seed=1, device="cpu")
    run_cls(ctx)
    assert set(w["check"]["limits"]) <= {
        "served_gap", "logit_error", "routing_gap", "rerun_mismatch",
        "loss_gap", "grad_gap", "change_gap"}
    for kind in ("end_to_end", "per_layer"):
        assert harness.metrics_of(BENCHMARK, cell, kind)


@pytest.mark.parametrize("entry", BENCHMARK["configs"],
                         ids=[c["name"] for c in BENCHMARK["configs"]])
def test_config_is_the_programs(entry):
    """The file states the program's configuration, and the program's
    parameters are the reference's, name for name and shape for shape."""
    from repro_torch.models.model import LMModel
    c = harness.load_json(harness.ROOT / entry["file"])
    assert c["name"] == entry["name"] and c["source"] == entry["source"]
    assert c["reduced"] == entry["reduced"]
    cfg = harness.program_config(c)
    ctx = harness.Context({"name": "x"}, c, {}, seed=1, device="cpu")
    have = [(n, tuple(p.shape))
            for n, p in LMModel(cfg, "meta").named_parameters()]
    assert have == [(s.name, s.shape) for s in ctx.specs]


def test_every_metric_has_a_reader():
    for kind in ("end_to_end", "per_layer"):
        for mt in BENCHMARK[kind]:
            assert callable(harness.load_metric(mt["name"]).read), mt["name"]


def test_a_new_cell_is_found_from_new_files(tmp_path):
    """A later change adds a traffic mix, a cell and a metric as files."""
    shutil.copytree(harness.BENCH, tmp_path / "bench")
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in tmp_path.rglob("*") if p.is_file()}
    t = harness.load_json(harness.BENCH / "traffic" / "decode_128x1024.json")
    t.update(name="decode_4x128", batch=4, prompt=128, new_tokens=32)
    (tmp_path / "bench/traffic/decode_4x128.json").write_text(json.dumps(t))
    cell = {"name": "olmo-1b.decode.b4", "config": "olmo-1b",
            "traffic": "decode_4x128", "chips": 1, "why": "latency regime",
            "check": {"requests": 4, "limits": {"served_gap": 1.0}}}
    (tmp_path / "bench/workloads/olmo-1b.decode.b4.json").write_text(
        json.dumps(cell))
    (tmp_path / "bench/metrics/engine.calls.py").write_text(
        "def read(ctx):\n    return float(len(ctx.units))\n")
    w, c, t2 = harness.cell_files("olmo-1b.decode.b4", root=tmp_path)
    assert (c["name"], t2["batch"]) == ("olmo-1b", 4)
    ctx = harness.Context(w, c, t2, seed=1, device="cpu")
    harness.driver(t2["kind"]).Run(ctx)
    ctx.units = [{}, {}]
    assert harness.load_metric("engine.calls", root=tmp_path).read(ctx) == 2
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in tmp_path.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
