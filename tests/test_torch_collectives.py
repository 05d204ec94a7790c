"""The port's collectives and sharded training in four ``gloo`` processes on
the CPU, started once for the module (``tests/_torch_dist_worker.py``,
joined through a ``FileStore`` under ``tmp_path``), with JAX's
``shard_map`` run once on four forced host devices in a subprocess (JAX
locks its device count at import):

* ``compressed_psum`` over four ranks, bit-equal to the JAX package's, and
  ROADMAP's two-rank example ([1, 0.25] and [0.5, 0.5] give [1.0, 0.62598]
  on both ranks: the JAX package's bias, copied);
* Mamba's fused ``in_proj`` weight split into x's and z's halves
  (``ssm._halves``) with its columns over the "model" axis of a (1, 4)
  mesh: the halves equal the whole weight's, and the backward gives the
  weight its gradient in its own placements, both bit for bit;
* olmo-1b smoke trained 2 steps on a (2, 2) mesh through the rule table's
  placements, in three modes (pure DP, TP with a batch of 2 that does not
  fill the mesh, and TP-less FSDP with ``FSDP_THRESHOLD`` at 0), against
  the unsharded single-process step: metrics rtol 1e-6 and every master,
  moment and step rtol 1e-5 / atol 1e-6 (fp32; the partial sums of the
  data-parallel gradients are added in another order);
* ``elastic_restore``: the FSDP state saved under (2, 2) and restored onto
  the (2,) "data" sub-mesh, sharded there, with full tensors equal;
* DeepSeekMoE smoke decoding 3 tokens at batch 2 on the (2, 2) mesh (TP
  with EP, the cache's head dimension over "model"), against the
  unsharded ``serve_step``: logits, of magnitude ~1, rtol 1e-5 / atol
  1e-5 (fp32; the scores' partial sums over the head dimension and the
  experts' over d_model are added in another order: 1.9e-6 at most);
* every other family on the same mesh, against its unsharded step at the
  same tolerances: DeepSeekMoE, grok-1 and Jamba trained 2 steps with EP
  (4 experts over the model axis of 2) and ``moe.GROUP`` lowered to 16 in
  both runs, so that each rank routes its own batch row
  (``moe._dispatch_rows``; grok-1's bf16 moments within one bf16 step,
  rtol 2^-7); Jamba again with ``FSDP_THRESHOLD`` at 0 (the dry-run
  cell's TP + EP + FSDP layout: Mamba's channels and its fused
  ``in_proj``'s columns over "model", x and z each computed on its own
  columns); RWKV-6 trained with its heads over "model";
  HuBERT trained in pure DP; qwen2-vl's prefill (M-RoPE) with TP; RWKV-6
  and Jamba decoding 3 tokens.

Every process group is destroyed by the process that made it.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import load_config  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import _torch_dist_worker as W  # noqa: E402

REPO = TESTS.parent
WORLD = 4

_JAX_PSUM = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, sys.argv[1])
import _torch_dist_worker as W
from repro.launch.mesh import make_mesh
from repro.parallel.compress import compressed_psum
try:
    from jax import shard_map
    kw = {}
except ImportError:
    from jax.experimental.shard_map import shard_map
    kw = {"check_rep": False}
mesh = make_mesh((4,), ("pod",))
g = jnp.asarray(W.psum_input().reshape(-1))
f = shard_map(lambda x: compressed_psum(x, "pod"), mesh=mesh,
              in_specs=P("pod"), out_specs=P("pod"), **kw)
np.save(sys.argv[2], np.asarray(jax.jit(f)(g)).reshape(4, -1))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(results of rank 0 of the gloo run, JAX's compressed_psum per
    shard); the five processes run side by side."""
    out = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    store = out / "store"
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_dist_worker.py"), str(r),
         str(WORLD), str(store), str(out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]
    jax_out = out / "jax_psum.npy"
    jproc = subprocess.Popen(
        [sys.executable, "-c", _JAX_PSUM, str(TESTS), str(jax_out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = []
    for p in procs + [jproc]:
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs + [jproc]:
                q.kill()
            raise
    for p, log in zip(procs + [jproc], logs):
        assert p.returncode == 0, log[-4000:]
    return torch.load(out / "results.pt", weights_only=False), \
        np.load(jax_out)


def test_compressed_psum_bit_equal_to_jax(runs):
    res, jax_psum = runs
    for shard in jax_psum:          # every shard holds the same sum
        np.testing.assert_array_equal(res["psum"].numpy(), shard)


def test_compressed_psum_copies_the_jax_bias(runs):
    res, _ = runs
    np.testing.assert_array_equal(
        res["psum2"].numpy(),
        np.array([1.0, 0.62598425], dtype=np.float32))


def test_mamba_in_proj_halves_on_a_model_axis_of_4(runs):
    """On 4 ranks the all-to-all of ``_halves`` moves blocks between
    different ranks (on 2 each rank keeps one of its blocks): rank r
    holds fused blocks 2r and 2r + 1 and needs x's block r and z's."""
    res, _ = runs
    got = res["halves"]
    w, g = W.halves_inputs()
    assert got["placements"] == "(Replicate(), Shard(dim=2))"
    assert got["grad_placements"] == "(Replicate(), Shard(dim=1))"
    assert torch.equal(got["full"], w.unflatten(1, (2, -1)))
    assert torch.equal(got["grad"], g.flatten(1))


def _unsharded(mode, arch="olmo-1b"):
    cfg = load_config(arch, "smoke")
    state = W.fresh_state(cfg)
    b = W.batch(cfg, W.FAMILIES[arch] if mode == "family"
                else W.MODES[mode])
    fn = make_train_step(cfg, AdamWConfig())
    rows = []
    for _ in range(2):
        state, m = fn(state, b)
        rows.append({k: float(v) for k, v in m.items()})
    return rows, state.state_dict()


def _check_train(got, rows, want):
    for g, w in zip(got["metrics"], rows, strict=True):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    assert got["params"].keys() == want.keys()
    for k, v in want.items():
        # A bf16 tensor (grok-1's moments, ``opt_state_dtype``) rounds
        # grads that differ at 1e-7 to neighbouring values: one bf16 step.
        rtol = 2.0 ** -7 if v.dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(got["params"][k].float().numpy(),
                                   v.float().numpy(), rtol=rtol, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("mode,rules,placements", [
    ("dp", (False, False, ("data", "model")),
     ("(Replicate(), Replicate())", "(Replicate(), Replicate())")),
    ("tp", (True, False, ("data",)),
     ("(Replicate(), Replicate())", "(Replicate(), Shard(dim=1))")),
    ("fsdp", (False, True, ("data", "model")),
     ("(Shard(dim=1), Shard(dim=1))", "(Shard(dim=0), Shard(dim=0))")),
])
def test_sharded_train_step_matches_unsharded(runs, mode, rules, placements):
    got = runs[0][f"train/{mode}"]
    assert got["rules"] == rules
    assert tuple(got["placements"].values()) == placements
    _check_train(got, *_unsharded(mode))


def test_elastic_restore_onto_a_smaller_mesh(runs):
    res = runs[0]
    got, saved = res["restore"], res["train/fsdp"]["params"]
    assert got["step"] == 2 and got["mesh"] == ("data",)
    assert got["placements"] == {
        "params/embed.table": "(Shard(dim=1),)",
        "opt/m/stack.periods.0.sub0.attn.q.w": "(Shard(dim=0),)"}
    assert got["params"].keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(got["params"][k], v), k


@pytest.mark.parametrize("arch,rules,ep", [
    ("deepseek-moe-16b", (True, False, ("data",)), True),
    ("grok-1-314b", (True, False, ("data",)), True),
    ("jamba-v0.1-52b", (True, False, ("data",)), True),
    ("rwkv6-1.6b", (True, False, ("data",)), False),
    ("hubert-xlarge", (False, False, ("data", "model")), False),
    ("jamba-v0.1-52b/fsdp", (True, True, ("data",)), True),
])
def test_sharded_family_train_step_matches_unsharded(runs, monkeypatch,
                                                     arch, rules, ep):
    from repro_torch.models import moe
    got = runs[0][f"family/{arch}"]
    assert (got["rules"], got["ep"]) == (rules, ep)
    fsdp = arch.endswith("/fsdp")
    arch = arch.removesuffix("/fsdp")
    if ep:      # the experts over "model", each rank's own rows routed
        assert [v for k, v in got["placements"].items()
                if k.endswith("moe.experts.up")] == \
            ["(Shard(dim=1), Shard(dim=0))" if fsdp else
             "(Replicate(), Shard(dim=0))"]
        cfg = load_config(arch, "smoke")
        assert W.FAMILIES[arch] * W.SEQ > W.GROUP
        assert cfg.moe.n_experts % 2 == 0
    if arch.startswith("jamba"):    # Mamba's fused in_proj: columns split
        assert [v for k, v in got["placements"].items()
                if k.endswith("mamba.in_proj.w")] == \
            ["(Shard(dim=0), Shard(dim=1))" if fsdp else
             "(Replicate(), Shard(dim=1))"]
    monkeypatch.setattr(moe, "GROUP", W.GROUP)
    _check_train(got, *_unsharded("family", arch))


def test_sharded_mrope_prefill_matches_unsharded(runs):
    from repro_torch.models.model import forward, init_params
    got = runs[0]["prefill/qwen2-vl-72b"]
    assert got["rules"] == (True, False, ("data",))
    cfg = load_config("qwen2-vl-72b", "smoke")
    assert cfg.rope == "mrope"
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        want = forward(params, cfg, W.batch(cfg, 2), logits_mode="last")[0]
    np.testing.assert_allclose(got["logits"].numpy(), want[:, 0].numpy(),
                               rtol=1e-5, atol=1e-5)


def _unsharded_decode(got, arch):
    from repro_torch.models.model import init_params
    from repro_torch.models.transformer import init_stack_cache
    from repro_torch.serve.engine import make_serve_step
    cfg = load_config(arch, "smoke")
    B = W.DECODE[arch]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = init_stack_cache(cfg, B, 8, "cpu")
    step = make_serve_step(cfg)
    toks = W.decode_tokens(cfg, B)
    with torch.no_grad():
        for i, g in enumerate(got["logits"]):
            want, cache = step(params, cache, toks[:, i:i + 1], i)
            np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"step {i}")


@pytest.mark.parametrize("arch,rules", [
    ("rwkv6-1.6b", (False, False, ("data", "model"))),
    ("jamba-v0.1-52b", (True, True, ("data",))),
])
def test_sharded_ssm_decode_matches_unsharded(runs, arch, rules):
    got = runs[0][f"decode/{arch}"]
    assert got["rules"] == rules
    _unsharded_decode(got, arch)


def test_sharded_decode_matches_unsharded(runs):
    got = runs[0]["decode"]
    assert got["rules"] == (True, True, ("data",))
    assert got["k_placements"] == "(Shard(dim=0), Shard(dim=3))"
    _unsharded_decode(got, "deepseek-moe-16b")
