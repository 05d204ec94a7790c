"""The port's dry-run (``repro_torch.launch.dryrun``) and per-rank dispatch
counts (``repro_torch.launch.comm_analysis``) in a fake world, with no
device: ``cells()`` equals the JAX package's list; ``run_cell`` on an
olmo-1b smoke train cell and a DeepSeekMoE smoke decode cell records the
JAX package's keys, and the train cell's per-rank FLOPs equal a matmul
count written here (rtol 1e-9: ``torch.utils.flop_counter`` counts
2·m·n·k a product, exactly); N redistributions in a loop count N
collectives, as ``tests/test_hlo_analysis.py`` holds the JAX package's
trip counts.  The sharded path of every family: smoke cells of each, one
in the full DeepSeekMoE cell's TP + EP + FSDP layout (per-rank FLOPs
exact, no batch moved over "data"), one in the full Jamba cell's TP +
FSDP layout (Mamba's fused ``in_proj`` FLOPs exact, no activation
gathered at its split, every backward twice its forward), and the
repaired DTensor gaps.
Every fake process group is destroyed on exit.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, load_config  # noqa: E402
from repro_torch.launch import comm_analysis as CA  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import moe  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

#: The keys of a record of the JAX package's ``repro.launch.dryrun.run_cell``.
KEYS = {"arch", "shape", "mesh", "devices", "fsdp", "ep", "n_params",
        "n_active_params", "lower_s", "compile_s", "memory", "cost",
        "collectives", "torch_version"}
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
    assert rec["torch_version"] == torch.__version__
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


# ---------------------------------------------------------------------------
# the sharded path of every family: smoke cells and the repaired DTensor gaps
# ---------------------------------------------------------------------------

def _moe_train_matmul_flops(cfg, B, T) -> int:
    """One rank's matmul FLOPs of a train step of the DeepSeekMoE smoke
    config on B rows of T tokens, as ``_train_matmul_flops`` counts them:
    attention and the readout as there, layer 0's dense FFN, and each MoE
    layer's router, its E experts over C = ceil(T·k/E·cf) slots a row and
    its shared experts over every token."""
    D, H, Hkv, Dh, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_head, cfg.vocab_size)
    e = cfg.moe
    F, N = e.d_expert, B * T
    C = math.ceil(T * e.top_k / e.n_experts * e.capacity_factor)
    proj = 2 * N * D * (H * Dh + 2 * Hkv * Dh) + 2 * N * H * Dh * D
    nq = T // 1024
    attn = nq * (nq + 1) // 2 * 2 * (2 * B * H * 1024 * 1024 * Dh)
    dense = 3 * 2 * N * D * cfg.d_ff
    moe = (2 * N * D * e.n_experts + 3 * e.n_experts * B * C * 2 * D * F
           + 3 * e.n_shared * 2 * N * D * F)
    n_moe = cfg.n_layers - 1                     # all but the first
    readout = 2 * B * (T - 1) * D * V
    return (3 * (cfg.n_layers * (proj + attn) + (cfg.n_layers - n_moe)
                 * dense + n_moe * moe) + 4 * readout)


def _n_read(cfg) -> int:
    """The parameters a train step reads (HuBERT's token table and RWKV-6's
    ``mu_x`` are not), from gradients of the loss on 16 tokens."""
    from repro_torch.models.model import init_params, loss_fn
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ps = list(params.parameters())
    for p in ps:
        p.requires_grad_(True)
    if cfg.frontend == "audio":
        batch = {"embeds": torch.zeros(1, 16, cfg.d_model),
                 "labels": torch.zeros(1, 16, dtype=torch.int32)}
    else:
        batch = {"tokens": torch.zeros(1, 16, dtype=torch.int32)}
    grads = torch.autograd.grad(loss_fn(params, cfg, batch)[0], ps,
                                allow_unused=True)
    return sum(g is not None for g in grads)


def _pure_dp_collectives(arch, rec):
    """A train cell in pure DP all-reduces the gradient of each parameter
    the step reads over the data and model axes in turn (an MoE router's
    where its local copy is taken), and the nll; it gathers nothing.  An
    MoE layer's aux, a mean over the rows, adds at most its own two
    all-reduces, as DTensor adds the layers' shares to the sum."""
    cfg = load_config(arch, "smoke")
    assert (rec["fsdp"], rec["ep"]) == (False, False)
    counts = dict(rec["collectives"]["counts"])
    n_ar = counts.pop("all-reduce")
    assert counts == {"all-gather": 0, "reduce-scatter": 0, "all-to-all": 0,
                      "collective-permute": 0}
    n_moe = sum(moe.moe_layer_pattern(cfg, i) for i in range(cfg.n_layers))
    base = 2 * _n_read(cfg) + 2
    assert base <= n_ar <= base + 2 * n_moe
    return cfg


def test_deepseek_moe_smoke_train_cell_routes_own_rows():
    """Each of the 256 ranks routes its one row of 4,096 tokens: the FLOPs
    are one row's, and no hidden state is gathered (on the parent tree
    each rank routed all 256 rows, with 1,028 all-gathers)."""
    rec = D.run_cell("deepseek-moe-16b", "train_4k", "pod", variant="smoke")
    _check_record(rec, "deepseek-moe-16b", "train_4k", "pod", 256)
    cfg = _pure_dp_collectives("deepseek-moe-16b", rec)
    assert 256 * 4096 > moe.GROUP          # the rows path
    assert rec["cost"]["flops"] == pytest.approx(
        _moe_train_matmul_flops(cfg, 1, 4096), rel=1e-9)


def _tp_ep_fsdp_config():
    """The DeepSeekMoE smoke config with the widths that shard on the pod
    mesh's model axis of 16 as the full config's do: 16 heads, 16
    experts (EP) and a vocabulary of 512."""
    cfg = load_config("deepseek-moe-16b", "smoke")
    return dataclasses.replace(
        cfg, n_heads=16, n_kv_heads=16, d_head=cfg.d_model // 16,
        vocab_size=512, moe=dataclasses.replace(cfg.moe, n_experts=16))


def test_moe_tp_ep_fsdp_train_cell(monkeypatch):
    """deepseek-moe-16b x train_4k x pod's layout (TP, EP and FSDP, the
    thresholds lowered) at the smoke depth; the full cell takes ~30 s
    here.  Each rank holds 16 of the 256 rows (the data axis) and does
    1/16 of every product on them (the model axis), and routes only
    those rows: the JAX package's per-row dispatch.  A product of partial
    sums, or a partial gradient reaching a product (torch 2.11's backward
    of the attention's output projection), adds the whole product on
    every rank of the axis.  No placement change
    gathers or replicates a (B, ...) activation or gradient over "data":
    its rows stay on their data rank (a shard may move between its
    dimensions, an all-to-all)."""
    from repro_torch.parallel import sharding
    cfg = _tp_ep_fsdp_config()
    monkeypatch.setattr(sharding, "TP_THRESHOLD", 0)
    monkeypatch.setattr(sharding, "FSDP_THRESHOLD", 0)
    monkeypatch.setattr(D, "load_config", lambda arch, variant: cfg)
    rec = D.run_cell("deepseek-moe-16b", "train_4k", "pod", "smoke",
                     by_site=True)
    assert (rec["fsdp"], rec["ep"]) == (True, True)
    B, T = 256, 4096
    want = _moe_train_matmul_flops(cfg, B // 16, T) / 16
    assert rec["cost"]["flops"] == pytest.approx(want, rel=1e-9)
    batch = [r for r in rec["redistributions"]
             if r["shape"][:1] == [B] and len(r["shape"]) >= 3]
    assert batch
    for r in batch:
        for c in r["changes"]:
            if c.startswith("data:"):
                assert c.startswith("data:S(") and "->S(" in c, r


def test_mamba_tp_fsdp_train_cell(monkeypatch):
    """jamba-v0.1-52b x train_4k x pod's layout (TP and FSDP, the
    thresholds lowered) at the smoke widths, cut to one Mamba layer and
    one attention + MoE layer.  The rule table shards Mamba's fused
    (D, 2·di) ``in_proj`` on its columns over "model": x and z must each
    come out of the projection sharded on their di, with no (B, T, 2·di)
    or (B, T, di) activation or gradient gathered over "model" (a split
    of the fused product gathered it on every rank; only weights may be
    gathered at the mixer), and each rank must do 1/16 of the
    projection's product and of its backward (the input's and the
    weight's gradients), on its 16 of the 256 rows.  No product's
    backward may do more than its two gradients, each as large as the
    forward product on the rank (x_proj's partial-sum gradient made its
    input gradient whole on every rank)."""
    from repro_torch.models import ssm
    from repro_torch.parallel import sharding
    cfg = load_config("jamba-v0.1-52b", "smoke").replace(n_layers=2,
                                                         layer_types="ma")
    monkeypatch.setattr(sharding, "TP_THRESHOLD", 0)
    monkeypatch.setattr(sharding, "FSDP_THRESHOLD", 0)
    monkeypatch.setattr(D, "load_config", lambda arch, variant: cfg)
    rec = D.run_cell("jamba-v0.1-52b", "train_4k", "pod", "smoke",
                     by_site=True)
    assert rec["fsdp"]
    faults = D.mamba_tp_faults(rec, cfg)
    B, T, (di, _) = 256, 4096, ssm._dims(cfg)
    whole = 2 * (B // 16) * T * cfg.d_model * (2 * di)  # a data rank's
    assert faults.pop("in_proj_want") == {"forward": whole / 16,
                                          "MmBackward0": 2 * whole / 16}
    assert faults == {"gathers": [], "replicated": [], "in_proj": {},
                      "backward_over_forward": {}}


def test_shard_to_shard_is_an_all_to_all():
    """In the dry-run's world a shard that moves between dimensions is one
    all-to-all of the rank's new shard, as on the production mesh (on a
    CPU mesh DTensor gathers the whole tensor)."""
    from torch.distributed.tensor import DTensor, Shard
    with D.fake_world(4):
        mesh = _fake_mesh()
        x = DTensor.from_local(torch.zeros(2, 8, device="meta"), mesh,
                               [Shard(0)], run_check=False)
        with CA.StepCounter() as counter:
            y = x.redistribute(mesh, [Shard(1)])
    assert tuple(y.to_local().shape) == (8, 2)
    assert counter.collectives == [("all-to-all", 8 * 2 * 4)]


def test_sharding_constraint_places_the_gradient():
    """``autoshard``'s constraint holds for the gradient too, as a JAX
    sharding constraint does for the cotangent: a partial-sum gradient
    leaves it reduce-scattered onto the constrained shards."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from repro_torch.parallel import autoshard
    with D.fake_world(4):
        mesh = _fake_mesh()
        x = DTensor.from_local(torch.ones(2, 3), mesh, [Shard(0)],
                               run_check=False).requires_grad_(True)
        y = autoshard._constrain(x, ("data", None))
        g = DTensor.from_local(torch.ones(8, 3), mesh, [Partial()],
                               run_check=False)
        (gx,) = torch.autograd.grad(y, x, g)
    assert tuple(gx.placements) == (Shard(0),)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b",
                                  "hubert-xlarge"])
def test_family_smoke_train_cell(arch):
    """RWKV-6 and Jamba's scans (their zero states were plain tensors
    beside the sharded input) and HuBERT's audio frontend, in pure DP:
    every rank steps its one row."""
    rec = D.run_cell(arch, "train_4k", "pod", variant="smoke")
    _check_record(rec, arch, "train_4k", "pod", 256)
    _pure_dp_collectives(arch, rec)
    assert rec["cost"]["flops"] > 0


def test_qwen2_vl_smoke_decode_cell():
    """M-RoPE's section index was a plain tensor beside the sharded
    positions.  Batch 128 does not fill 512 ranks: TP."""
    rec = D.run_cell("qwen2-vl-72b", "decode_32k", "multipod",
                     variant="smoke")
    _check_record(rec, "qwen2-vl-72b", "decode_32k", "multipod", 512)
    assert rec["cost"]["flops"] > 0 and not rec["ep"]
    assert 0 < rec["memory"]["alias_bytes"] < rec["memory"]["argument_bytes"]


def _fake_mesh():
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((4,), ("data",), "cpu")


def _rows(t, mesh, dim=0):
    from torch.distributed.tensor import DTensor, Shard
    n = t.shape[dim] // 4
    return DTensor.from_local(t.narrow(dim, 0, n), mesh, [Shard(dim)],
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def test_mrope_on_batch_sharded_dtensors():
    """``apply_mrope`` of a batch-sharded query and (3, B, T) positions with
    three different streams, in a fake world of 4 ranks: rank 0's shard
    equals the unsharded rotation of its rows, bit for bit."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 6, 2, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 50, (3, 8, 6)).astype(np.int32))
    want = L.apply_mrope(x, pos, 1e4, (2, 3, 3))
    with D.fake_world(4):
        mesh = _fake_mesh()
        got = L.apply_mrope(_rows(x, mesh), _rows(pos, mesh, 1), 1e4,
                            (2, 3, 3))
    assert tuple(got.shape) == tuple(want.shape)
    assert torch.equal(got.to_local(), want[:2])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_ssm_mixers_from_zero_state_on_batch_sharded_dtensors(arch):
    """RWKV-6's time and channel mix and Mamba from no state (zero states
    made inside the mixer) on a batch-sharded input with replicated
    parameters, in a fake world of 4 ranks: rank 0's outputs and states
    equal the unsharded mixer's on its rows, bit for bit."""
    from repro_torch.models import ssm
    from repro_torch.models.model import init_params
    from repro_torch.parallel.sharding import distribute_module
    cfg = load_config(arch, "smoke")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    block = next(b for b in params.stack.modules()
                 if isinstance(b, (ssm.RWKV6, ssm.Mamba)))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(8, 16, cfg.d_model))
                         .astype(np.float32))
    mix = ssm.rwkv6_mix if arch.startswith("rwkv") else ssm.mamba_mix
    with torch.no_grad():
        want = [mix(block, cfg, x)]
        if arch.startswith("rwkv"):
            cmix = next(b for b in params.stack.modules()
                        if isinstance(b, ssm.RWKV6ChannelMix))
            want.append(ssm.rwkv6_channel_mix(cmix, cfg, x))
        with D.fake_world(4):
            mesh = _fake_mesh()
            distribute_module(params, {n: (None,) * p.ndim for n, p in
                                       params.named_parameters()}, mesh)
            xs = _rows(x, mesh)
            got = [mix(block, cfg, xs)]
            if arch.startswith("rwkv"):
                got.append(ssm.rwkv6_channel_mix(cmix, cfg, xs))
    from torch.utils._pytree import tree_flatten
    for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0],
                    strict=True):
        assert torch.equal(g.to_local(), w[:2])
