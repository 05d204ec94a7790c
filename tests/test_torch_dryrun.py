"""The port's dry-run (``repro_torch.launch.dryrun``) and per-rank dispatch
counts (``repro_torch.launch.comm_analysis``) in a fake world, with no
device: ``cells()`` equals the JAX package's list; ``run_cell`` on an
olmo-1b smoke train cell and a DeepSeekMoE smoke decode cell records the
JAX package's keys, and the train cell's per-rank FLOPs equal a matmul
count written here (rtol 1e-9: ``torch.utils.flop_counter`` counts
2·m·n·k a product, exactly); N redistributions in a loop count N
collectives, as ``tests/test_hlo_analysis.py`` holds the JAX package's
trip counts.  Every fake process group is destroyed on exit.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, load_config  # noqa: E402
from repro_torch.launch import comm_analysis as CA  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

#: The keys of a record of the JAX package's ``repro.launch.dryrun.run_cell``.
KEYS = {"arch", "shape", "mesh", "devices", "fsdp", "ep", "n_params",
        "n_active_params", "lower_s", "compile_s", "memory", "cost",
        "collectives"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "code_bytes", "total_bytes"}


def test_cells_equal_jax():
    """The JAX package's module pins 512 host devices when it is imported,
    so its list is read in a subprocess."""
    code = ("from repro.launch.dryrun import cells\n"
            "print(repr(list(cells())))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = eval(out.stdout.strip().splitlines()[-1])
    assert list(D.cells()) == want
    assert {a for a, _ in want} == set(ARCHS)


def _check_record(rec, arch, shape, mesh, devices):
    assert set(rec) == KEYS and set(rec["memory"]) == MEMORY
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["devices"]) == \
        (arch, shape, mesh, devices)
    assert rec["compile_s"] is None and rec["memory"]["code_bytes"] is None
    assert set(rec["cost"]) == {"flops", "transcendentals", "bytes_accessed"}
    assert set(rec["collectives"]) == {"bytes", "counts", "total_bytes"}
    assert set(rec["collectives"]["counts"]) == set(CA.COLLECTIVES)
    m = rec["memory"]
    assert m["total_bytes"] == (m["argument_bytes"] + m["output_bytes"]
                                + m["temp_bytes"] - m["alias_bytes"])


def _train_matmul_flops(cfg, B, T) -> int:
    """One rank's matmul FLOPs of a train step of the olmo smoke config on
    B × T tokens: every product once forward and twice backward (remat
    "none"), the chunked CE's readout once more (recomputed); attention is
    chunked at T = 4096 into 1024² blocks, causal (10 block pairs)."""
    D, H, Hkv, Dh, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.d_head, cfg.d_ff, cfg.vocab_size)
    N = B * T
    proj = 2 * N * D * (H * Dh + 2 * Hkv * Dh) + 2 * N * H * Dh * D
    ffn = 3 * 2 * N * D * F                          # up, gate, down
    nq = T // 1024
    pairs = nq * (nq + 1) // 2
    attn = pairs * 2 * (2 * B * H * 1024 * 1024 * Dh)   # q·k and p·v
    readout = 2 * B * (T - 1) * D * V
    return 3 * cfg.n_layers * (proj + ffn + attn) + 4 * readout


def test_olmo_smoke_train_cell():
    cfg = load_config("olmo-1b", "smoke")
    rec = D.run_cell("olmo-1b", "train_4k", "pod", variant="smoke")
    _check_record(rec, "olmo-1b", "train_4k", "pod", 256)
    assert (rec["fsdp"], rec["ep"]) == (False, False)
    assert rec["n_params"] == cfg.n_params()
    # Pure DP: a rank holds the whole state and 1 of the 256 rows.
    want = _train_matmul_flops(cfg, 1, 4096)
    assert rec["cost"]["flops"] == pytest.approx(want, rel=1e-9)
    # The gradients of the replicated parameters are all-reduced, over the
    # data and model axes in turn: 2 a parameter, each 2× its fp32 bytes;
    # and the nll, whose exp (the perplexity) needs the whole sum.
    params = dict(D.SP.params_specs(cfg).named_parameters())
    elems = sum(p.numel() for p in params.values())
    coll = rec["collectives"]
    assert coll["counts"] == {"all-gather": 0,
                              "all-reduce": 2 * len(params) + 2,
                              "reduce-scatter": 0, "all-to-all": 0,
                              "collective-permute": 0}
    assert coll["total_bytes"] == 2 * 2 * 4 * (elems + 1)
    state_bytes = 3 * 4 * elems + 4               # masters, m, v, step
    assert rec["memory"]["argument_bytes"] == state_bytes + 4 * 4096
    assert rec["memory"]["alias_bytes"] == state_bytes


def test_deepseek_moe_smoke_decode_cell():
    rec = D.run_cell("deepseek-moe-16b", "decode_32k", "multipod",
                     variant="smoke")
    _check_record(rec, "deepseek-moe-16b", "decode_32k", "multipod", 512)
    cfg = load_config("deepseek-moe-16b", "smoke")
    assert rec["n_active_params"] == cfg.n_active_params()
    assert rec["cost"]["flops"] > 0
    # Batch 128 does not fill 512 ranks: TP, without EP (4 experts do not
    # divide by 16), so the step communicates; the cache is updated in
    # place (aliased).
    assert not rec["ep"] and rec["collectives"]["total_bytes"] > 0
    assert 0 < rec["memory"]["alias_bytes"] < rec["memory"]["argument_bytes"]


@pytest.mark.parametrize("n", [1, 5])
def test_redistributions_in_a_loop_count_once_a_trip(n):
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import make_mesh
    with D.fake_world(4):
        mesh = make_mesh((4,), ("data",), "cpu")
        x = DTensor.from_local(torch.ones(2, 8), mesh, [Shard(0)],
                               run_check=False)
        p = DTensor.from_local(torch.ones(8, 8), mesh, [Partial()],
                               run_check=False)
        with CA.StepCounter() as counter:
            for _ in range(n):
                x.redistribute(mesh, [Replicate()])
                p.redistribute(mesh, [Replicate()])
    got = counter.collective_bytes()
    assert got["counts"] == {"all-gather": n, "all-reduce": n,
                             "reduce-scatter": 0, "all-to-all": 0,
                             "collective-permute": 0}
    # all-gather: the (8, 8) fp32 result once; all-reduce: 2× its buffer.
    assert got["bytes"]["all-gather"] == n * 8 * 8 * 4
    assert got["bytes"]["all-reduce"] == n * 2 * 8 * 8 * 4
    assert got["total_bytes"] == n * 3 * 8 * 8 * 4


def test_collective_bytes_cost_model():
    got = CA.collective_bytes([("all-reduce", 100), ("all-gather", 10),
                               ("reduce-scatter", 3), ("all-to-all", 7)])
    assert got["bytes"] == {"all-gather": 10, "all-reduce": 200,
                            "reduce-scatter": 3, "all-to-all": 7,
                            "collective-permute": 0}
    assert got["total_bytes"] == 220
