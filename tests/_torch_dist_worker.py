"""One rank of the four-process ``gloo`` run that
``tests/test_torch_collectives.py`` starts: it joins a process group
through a ``FileStore`` and runs every multi-rank scenario of that file,
then rank 0 writes what the tests compare to ``<out>/results.pt``.

  python tests/_torch_dist_worker.py RANK WORLD STORE_FILE OUT_DIR

Scenarios (inputs are made from numpy seeds, the same in the test):
* ``psum``: ``compressed_psum`` of each rank's row of ``psum_input()``
  over the world group; ``psum2``: ROADMAP's two-rank example on the
  (2, 2) mesh's "model" groups;
* ``halves``: ``ssm._halves`` of a (3, 16) weight whose columns are
  sharded over the "model" axis of a (1, 4) mesh, and the gradient that
  its backward gives the weight;
* ``train/<mode>``: olmo-1b smoke trained 2 steps on a (2, 2) mesh through
  ``launch.dryrun._step_and_specs`` in three modes: ``dp`` (the rules'
  default), ``tp`` (a batch of 2 that does not fill the mesh) and ``fsdp``
  (``FSDP_THRESHOLD`` set to 0); the metrics, every master's full tensor
  and the placements of two of them;
* ``restore``: the fsdp state saved under the (2, 2) mesh and restored by
  ``elastic_restore`` onto the (2,) "data" sub-mesh: the full tensors and
  placements there;
* ``decode``: DeepSeekMoE smoke decoding 3 tokens at batch 2 on the
  (2, 2) mesh (TP with EP: the experts and the cache's head dimension
  over "model"), the logits of each step;
* ``family/<arch>``: the other families' smoke configs trained 2 steps on
  the (2, 2) mesh through ``_step_and_specs`` at the batch of
  ``FAMILIES``, with ``moe.GROUP`` at ``GROUP`` so that the MoE layers
  route each row on its own (``_dispatch_rows``): DeepSeekMoE, grok-1 and
  Jamba at batch 2 (TP with EP: 4 experts over the model axis of 2; RWKV-6
  at batch 2 too, its heads over "model"), HuBERT at batch 8 (pure DP);
  ``family/jamba-v0.1-52b/fsdp``: Jamba so again with ``FSDP_THRESHOLD``
  at 0, the dry-run's TP + EP + FSDP layout (Mamba's channels over
  "model", its ``in_proj`` columns too, d_model over "data");
* ``prefill/qwen2-vl-72b``: qwen2-vl smoke's prefill step at batch 2 (TP),
  the last position's logits;
* ``decode/<arch>``: RWKV-6 and Jamba smoke decoding 3 tokens at the batch
  of ``DECODE`` (RWKV-6's 2 periods would take the rule table's batch
  dimension of its stacked states at batch 2), the logits of each step.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
sys.path.insert(0, SRC)

SEQ = 32
MODES = {"dp": 8, "tp": 2, "fsdp": 8}       # mode: global batch
#: arch: global batch of its sharded train step.
FAMILIES = {"deepseek-moe-16b": 2, "grok-1-314b": 2, "jamba-v0.1-52b": 2,
            "rwkv6-1.6b": 2, "hubert-xlarge": 8}
#: arch: batch of its sharded decode.
DECODE = {"deepseek-moe-16b": 2, "rwkv6-1.6b": 4, "jamba-v0.1-52b": 2}
#: ``moe.GROUP`` in the family steps: below B·T, so rows route alone.
GROUP = 16


def psum_input() -> np.ndarray:
    """(4, 64) fp32: row r is rank r's gradient, at scales 1e-2 to 10."""
    rng = np.random.default_rng(7)
    g = rng.normal(size=(4, 64)).astype(np.float32)
    return g * np.float32(10.0) ** np.arange(-2, 2, dtype=np.float32)[:, None]


def batch(cfg, B: int) -> dict:
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, size=(B, SEQ), dtype=np.int32)
    if cfg.frontend == "audio":
        embeds = rng.normal(0, 1, (B, SEQ, cfg.d_model)).astype(np.float32)
        return {"embeds": torch.from_numpy(embeds),
                "labels": torch.from_numpy(toks)}
    return {"tokens": torch.from_numpy(toks)}


def fresh_state(cfg):
    from repro_torch.models.model import init_params
    from repro_torch.train.train_step import init_train_state
    gen = torch.Generator().manual_seed(0)
    return init_train_state(cfg, init_params(
        cfg.replace(dtype=cfg.param_dtype), gen, "cpu"))


def _full(t):
    from torch.distributed.tensor import DTensor
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def train(mesh, mode: str, arch: str = "olmo-1b", fsdp: bool = False):
    """``mode`` is one of ``MODES`` for olmo-1b, or ``"family"``: ``arch``
    at its ``FAMILIES`` batch, with ``FSDP_THRESHOLD`` at 0 if ``fsdp``."""
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import _step_and_specs
    from repro_torch.parallel import sharding
    from repro_torch.parallel.sharding import ShardingRules
    cfg = load_config(arch, "smoke")
    B = FAMILIES[arch] if mode == "family" else MODES[mode]
    shape = ShapeConfig("t", SEQ, B, "train")
    threshold = sharding.FSDP_THRESHOLD
    if mode == "fsdp" or fsdp:
        sharding.FSDP_THRESHOLD = 0
    try:
        rules = ShardingRules(cfg, mesh, shape)
        fn, _, place = _step_and_specs(cfg, shape, rules, mesh)
        state, b = place((fresh_state(cfg), batch(cfg, B)))
        rows = []
        for _ in range(2):
            state, m = fn(state, b)
            rows.append({k: float(_full(v)) for k, v in m.items()})
    finally:
        sharding.FSDP_THRESHOLD = threshold
    sd = state.state_dict()
    names = [k for k in ("params/embed.table",
                         "params/stack.periods.0.sub0.attn.q.w") if k in sd]
    for leaf in ("moe.experts.up", "mamba.in_proj.w"):
        names += [k for k in sd if k.startswith("params/")
                  and k.endswith(leaf)][:1]
    return state, rules, {
        "rules": (rules.use_tp, rules.fsdp, rules.dp_axes),
        "ep": rules.ep,
        "metrics": rows,
        "params": {k: _full(v) for k, v in sd.items()},
        "placements": {k: str(tuple(sd[k].placements)) for k in names}}


def prefill(mesh, arch: str = "qwen2-vl-72b") -> dict:
    """``arch``'s smoke prefill step at batch 2: the last logits."""
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import _step_and_specs
    from repro_torch.models.model import init_params
    from repro_torch.parallel.sharding import ShardingRules
    cfg = load_config(arch, "smoke")
    shape = ShapeConfig("p", SEQ, 2, "prefill")
    rules = ShardingRules(cfg, mesh, shape)
    fn, _, place = _step_and_specs(cfg, shape, rules, mesh)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params, b = place((params, batch(cfg, 2)))
    return {"rules": (rules.use_tp, rules.fsdp, rules.dp_axes),
            "logits": _full(fn(params, b))}


def decode_tokens(cfg, B: int = 2) -> torch.Tensor:
    rng = np.random.default_rng(13)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, 3),
                                         dtype=np.int32))


def decode(mesh, arch: str = "deepseek-moe-16b"):
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import _step_and_specs
    from repro_torch.models.model import init_params
    from repro_torch.models.transformer import init_stack_cache
    from repro_torch.parallel.sharding import ShardingRules, distribute
    cfg = load_config(arch, "smoke")
    B = DECODE[arch]
    shape = ShapeConfig("d", 8, B, "decode")
    rules = ShardingRules(cfg, mesh, shape)
    fn, _, place = _step_and_specs(cfg, shape, rules, mesh)
    toks = decode_tokens(cfg, B)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params, cache, _, _ = place((params, init_stack_cache(cfg, B, 8, "cpu"),
                                 toks[:, :1], 0))
    logits = []
    for i in range(toks.shape[1]):
        tok = distribute(toks[:, i:i + 1], rules.batch_spec(shape), mesh)
        out, cache = fn(params, cache, tok, i)
        logits.append(_full(out))
    first = cache["periods"][0]["sub0"]
    return {"rules": (rules.use_tp, rules.ep, rules.dp_axes),
            "k_placements": str(tuple(first["k"].placements))
            if "k" in first else None,
            "logits": logits}


def halves_inputs():
    """(the weight (3, 16), the gradient of ``_halves``' (3, 2, 8))."""
    rng = np.random.default_rng(5)
    return (torch.from_numpy(rng.standard_normal((3, 16), np.float32)),
            torch.from_numpy(rng.standard_normal((3, 2, 8), np.float32)))


def halves(mesh):
    """``ssm._halves`` on ``mesh``, the weight's columns over "model": the
    halves and the weight's gradient, full, with their placements."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.models import ssm
    w, g = halves_inputs()
    w = distribute_tensor(w, mesh, [Replicate(), Shard(1)]).requires_grad_()
    h = ssm._halves(w)
    (h * distribute_tensor(g, mesh, h.placements)).sum().backward()
    return {"full": _full(h), "placements": str(tuple(h.placements)),
            "grad": _full(w.grad),
            "grad_placements": str(tuple(w.grad.placements))}


def main(rank: int, world: int, store_file: str, out: str) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.configs import load_config
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.parallel.compress import compressed_psum
        from repro_torch.train.fault import CheckpointManager, elastic_restore
        res = {}
        res["psum"] = compressed_psum(torch.from_numpy(psum_input()[rank]))
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        two = torch.tensor([[1.0, 0.25], [0.5, 0.5]])[
            mesh.get_coordinate()[1]]
        res["psum2"] = compressed_psum(two, mesh.get_group("model"))
        res["halves"] = halves(make_mesh((1, 4), ("data", "model"), "cpu"))
        res["decode"] = decode(mesh)
        from repro_torch.models import moe
        moe.GROUP = GROUP
        for arch in FAMILIES:
            res[f"family/{arch}"] = train(mesh, "family", arch)[2]
        res["family/jamba-v0.1-52b/fsdp"] = train(
            mesh, "family", "jamba-v0.1-52b", fsdp=True)[2]
        res["prefill/qwen2-vl-72b"] = prefill(mesh)
        for arch in ("rwkv6-1.6b", "jamba-v0.1-52b"):
            res[f"decode/{arch}"] = decode(mesh, arch)
        for mode in MODES:
            state, rules, res[f"train/{mode}"] = train(mesh, mode)

        # elastic restore: the fsdp state (the last trained) onto (2,).
        cfg = load_config("olmo-1b", "smoke")
        manager = CheckpointManager(os.path.join(out, "ckpt"),
                                    async_save=False)
        manager.save(2, state.state_dict())
        dist.barrier()
        from repro_torch.parallel import sharding
        sharding.FSDP_THRESHOLD = 0
        sub = mesh["data"]
        got, step = elastic_restore(manager, lambda d: fresh_state(cfg),
                                    "cpu", mesh=sub, cfg=cfg)
        sd = got.state_dict()
        res["restore"] = {
            "step": step, "mesh": tuple(sub.mesh_dim_names),
            "params": {k: _full(v) for k, v in sd.items()},
            "placements": {k: str(tuple(sd[k].placements)) for k in (
                "params/embed.table", "opt/m/stack.periods.0.sub0.attn.q.w")}}
        if rank == 0:
            torch.save(res, os.path.join(out, "results.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
