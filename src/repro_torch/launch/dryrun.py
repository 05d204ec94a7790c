"""The multi-pod dry-run on DTensor, as the JAX package's
``repro.launch.dryrun``: for every (architecture × input shape × mesh)
cell, the real sharded step runs on the 16×16 single-pod mesh AND the
2×16×16 two-pod mesh, with no device.

A cell opens a fake world of 256 or 512 ranks (``torch.distributed``'s
``fake`` backend), builds the production mesh, places the step's inputs by
the rule table as DTensors over ``meta`` shards (``parallel.sharding``)
and runs the cell's step (train, prefill or decode) inside the
activation-sharding context.  Meta tensors carry shapes and no data, so
the step costs host time only; the Python loops run every trip.  The
step runs twice: the first run fills DTensor's sharding-propagation
cache (an op it has not seen runs once more on global-shape fake tensors,
which is not the rank's work), the second is counted.  Per cell it
records the JAX package's keys, with the port's own values:

* ``memory`` — per-rank bytes: arguments and outputs from the local shard
  shapes exactly, ``alias_bytes`` the outputs that are arguments updated
  in place (the train state, the decode cache), ``temp_bytes`` the peak of
  the storage that the step's ops held alive at once
  (``comm_analysis.StepCounter``);
* ``cost`` — per-rank FLOPs (``torch.utils.flop_counter``'s formulas on
  the local shapes), transcendental elements, and bytes accessed (each
  eager op's inputs and outputs once);
* ``collectives`` — per-rank collective bytes and counts of every
  redistribution the step dispatched (``comm_analysis``);
* ``lower_s`` — the wall time of placing the inputs and both runs.

Where the card launches one CUDA kernel (softmax, exp), the cell runs its
plain version's ops, and ``bytes_accessed`` counts theirs.

``compile_s`` and ``memory.code_bytes`` are ``null``: PyTorch runs the
step eagerly, with no compiler and no generated code to size.

Records go to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh pod|multipod|both]

Cells missing from ``--out`` run at once, each in a process of its own, as
many as the host has cores.  For the per-op view of a cell call
``run_cell(..., by_site=True)``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

import torch

from repro_torch.configs import SHAPES, applicable_shapes, load_config
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import specs as SP
from repro_torch.launch.comm_analysis import MetaKernelCache, StepCounter
from repro_torch.launch.mesh import (PRODUCTION, make_production_mesh,
                                     mesh_context)
from repro_torch.models import ssm
from repro_torch.models.model import forward
from repro_torch.parallel.sharding import (ShardingRules, distribute,
                                           distribute_module)
from repro_torch.serve.engine import make_serve_step
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (distribute_train_state,
                                          make_train_step)

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks on the ``fake``
    backend (this process is rank 0; collectives move nothing), destroyed
    on exit.  Inside it DTensor's shard-to-shard redistributions are
    all-to-alls (``_alltoall``)."""
    import torch.distributed as dist
    # Private API: the fake store lives in PyTorch's testing package.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        with _alltoall():
            yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _alltoall():
    """DTensor moves a shard from one dimension to another by an
    all-to-all, except on a CPU mesh, where it all-gathers the whole tensor
    and keeps its chunk (gloo has no all-to-all).  The production mesh is
    no CPU mesh, and the fake backend has the all-to-all: here DTensor's
    ``shard_dim_alltoall`` (private API, also bound in
    ``placement_types``) calls it whatever the mesh's device."""
    from torch.distributed.tensor import _collective_utils, placement_types

    def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    mods = [m for m in (_collective_utils, placement_types)
            if hasattr(m, "shard_dim_alltoall")]
    saved = [m.shard_dim_alltoall for m in mods]
    for m in mods:
        m.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.shard_dim_alltoall = f


def _distribute_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _distribute_tree(v, specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_distribute_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return distribute(tree, specs, mesh)


def _step_and_specs(cfg, shape, rules: ShardingRules, mesh):
    """Returns (fn, args, place): the cell's step function, run inside the
    activation-sharding context; its arguments as ``meta`` stand-ins
    (``launch.specs``); and ``place(args)``, which returns arguments of
    the same structure (the stand-ins, or real tensors of their shapes on
    every rank) as DTensors on ``mesh`` placed by ``rules``.  A train
    state is spent by ``place`` (``distribute_train_state``)."""
    bspec = rules.batch_spec(shape)
    seq_sharded = bspec[0] is None and bspec[1] is not None

    def with_ctx(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with mesh_context(mesh, dp=rules.dp_axes,
                              tp="model" if rules.use_tp else None,
                              seq_sharded=seq_sharded):
                return fn(*a, **kw)
        return wrapped

    def batch_spec(t):
        return bspec + (None,) * (t.ndim - 2)

    if shape.kind == "decode":
        sp = SP.decode_specs(cfg, shape)
        step = with_ctx(torch.no_grad()(make_serve_step(cfg)))
        tok_spec = bspec if shape.global_batch > 1 else (None, None)

        def place(args):
            params, cache, tokens, cache_index = args
            distribute_module(params, rules.params_pspecs(
                dict(params.named_parameters())), mesh)
            cache = _distribute_tree(cache, rules.cache_pspecs(cache, shape),
                                     mesh)
            return params, cache, distribute(tokens, tok_spec, mesh), \
                cache_index

        # The port's decode step takes the cache index as a Python int; one
        # step's work does not depend on it (the whole cache is attended,
        # masked), so the cell decodes at the last position.
        args = (sp["params"], sp["cache"], sp["tokens"], shape.seq_len - 1)
        return step, args, place

    if shape.kind == "prefill":
        params = SP.params_specs(cfg)
        batch = SP.batch_specs(cfg, shape)

        @torch.no_grad()
        def prefill_step(params, batch):
            logits, _, _ = forward(params, cfg, batch, logits_mode="last")
            return logits[:, 0]

        def place(args):
            params, batch = args
            distribute_module(params, rules.params_pspecs(
                dict(params.named_parameters())), mesh)
            return params, {k: distribute(v, batch_spec(v), mesh)
                            for k, v in batch.items()}

        return with_ctx(prefill_step), (params, batch), place

    # train
    sp = SP.input_specs(cfg, shape)
    step = with_ctx(make_train_step(cfg, AdamWConfig()))

    def place(args):
        state, batch = args
        return (distribute_train_state(state, rules),
                {k: distribute(v, batch_spec(v), mesh)
                 for k, v in batch.items()})

    return step, (sp["state"], sp["batch"]), place


def _storages(tree) -> dict:
    """{id of the untyped storage: bytes} of the local shards of every
    tensor in ``tree`` (a train state counts its live tensors and its
    working copy)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten
    out = {}
    for x in tree_flatten(tree)[0]:
        if hasattr(x, "state_dict") and hasattr(x, "model"):   # TrainState
            out.update(_storages((x.state_dict(),
                                  dict(x.model.named_parameters()))))
        elif isinstance(x, torch.nn.Module):
            out.update(_storages(dict(x.named_parameters())))
        elif isinstance(x, torch.Tensor):
            local = x.to_local() if isinstance(x, DTensor) else x
            st = local.untyped_storage()
            out[id(st)] = st.nbytes()
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             variant: str = "full", by_site: bool = False) -> dict:
    """The cell's record.  ``by_site`` adds the per-op view of
    ``StepCounter``: ``collective_sites``, every (source line, autograd
    node, DTensor op, collective) row by collective bytes;
    ``flop_sites``, every (source line, autograd node, op) row by FLOPs;
    and ``redistributions``, every placement change DTensor made.  In the
    backward pass the source line is the forward call's that made the
    node."""
    cfg = load_config(arch, variant)
    shape = SHAPES[shape_name]
    multi_pod = mesh_kind == "multipod"
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = ShardingRules(cfg, mesh, shape)
        record = dict(arch=arch, shape=shape_name, mesh=mesh_kind,
                      devices=mesh.size(), fsdp=rules.fsdp, ep=rules.ep,
                      n_params=cfg.n_params(),
                      n_active_params=cfg.n_active_params())
        fn, args, place = _step_and_specs(cfg, shape, rules, mesh)
        t0 = time.perf_counter()
        placed = place(args)
        arg_st = _storages(placed)
        counter = StepCounter(by_site=by_site)
        with MetaKernelCache():
            fn(*placed)              # fills the sharding-propagation cache
            with counter:
                out = fn(*placed)
        out_st = _storages(out)
        record["lower_s"] = round(time.perf_counter() - t0, 1)
        record["compile_s"] = None
        record["torch_version"] = torch.__version__
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    arg_b, out_b = sum(arg_st.values()), sum(out_st.values())
    record["memory"] = dict(
        argument_bytes=arg_b, output_bytes=out_b,
        temp_bytes=counter.peak_bytes, alias_bytes=alias, code_bytes=None,
        total_bytes=arg_b + out_b + counter.peak_bytes - alias)
    record["cost"] = {"flops": float(counter.flops),
                      "transcendentals": float(counter.transcendentals),
                      "bytes_accessed": float(counter.bytes_accessed)}
    record["collectives"] = counter.collective_bytes()
    if by_site:
        record["collective_sites"] = counter.sites()
        record["flop_sites"] = counter.flop_sites()
        record["redistributions"] = counter.redistributions()
    return record


def mamba_tp_faults(rec: dict, cfg) -> dict:
    """Where the per-op view (``run_cell(..., by_site=True)``) of a train
    cell of ``cfg`` on the pod mesh, Mamba's channels over "model", departs
    from a mixer that keeps x and z on their own channels.  Each entry is
    empty where it does not:

    * ``gathers``: all-gathers at ``models/ssm.py`` of more than the fused
      ``in_proj`` weight (fp32) a call;
    * ``replicated``: placement changes that take a (B, T, di) or
      (B, T, 2·di) activation or gradient to ``R`` over "model";
    * ``in_proj``: ``_in_proj``'s product FLOPs a rank by autograd node
      beside ``in_proj_want``, 1/16 of a data rank's whole product forward
      and twice that in its backward (the input's and the weight's
      gradients), where they differ;
    * ``backward_over_forward``: {site: [forward, backward FLOPs]} where a
      source line's backward does other than twice its forward's FLOPs
      (more is a product run whole on a rank)."""
    (data, model), _ = PRODUCTION["pod"]
    shape = SHAPES[rec["shape"]]
    B, T = shape.global_batch, shape.seq_len
    di, _ = ssm._dims(cfg)
    weight = cfg.d_model * 2 * di * 4
    whole = 2 * (B // data) * T * cfg.d_model * 2 * di \
        * cfg.layer_types.count("m")
    want = {"forward": whole / model, "MmBackward0": 2 * whole / model}
    in_proj, fwd, bwd = {}, {}, {}
    for r in rec["flop_sites"]:
        if r["site"].endswith(" _in_proj") and r["op"] == "mm":
            node = r["node"] or "forward"
            in_proj[node] = in_proj.get(node, 0) + r["flops"]
        if r["node"] != "recompute":
            d = fwd if r["node"] is None else bwd
            d[r["site"]] = d.get(r["site"], 0) + r["flops"]
    return dict(
        gathers=[r for r in rec["collective_sites"]
                 if "ssm.py" in r["site"] and r["collective"] == "all-gather"
                 and r["bytes"] > r["count"] * weight],
        replicated=[r for r in rec["redistributions"]
                    if r["shape"] in ([B, T, 2 * di], [B, T, di])
                    and any(c.startswith("model:") and c.endswith("->R")
                            for c in r["changes"])],
        in_proj={} if in_proj == want else in_proj,
        in_proj_want=want,
        backward_over_forward={
            site: [fwd.get(site, 0), bwd.get(site, 0)]
            for site in fwd.keys() | bwd.keys()
            if bwd.get(site, 0) != 2 * fwd.get(site, 0)})


def cells(archs=None, shapes=None):
    for arch in (archs or ARCHS):
        cfg = load_config(arch, "full")
        for sh in applicable_shapes(cfg):
            if shapes and sh not in shapes:
                continue
            yield arch, sh


def _run_and_save(arch: str, sh: str, mk: str, path: str) -> dict:
    """``run_cell`` of one cell, its record written to ``path``."""
    rec = run_cell(arch, sh, mk)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    todo = []
    for arch, sh in cells(args.arch, args.shape):
        for mk in meshes:
            tag = f"{arch}__{sh}__{mk}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[skip] {tag} (exists)")
            else:
                todo.append((tag, (arch, sh, mk, path)))
    n_cells = len(list(cells(args.arch, args.shape))) * len(meshes)
    failures = []
    # Each cell runs in a process of its own: its host time starts from
    # empty DTensor caches, as a cell run alone does.
    jobs = max(1, min(len(todo), os.cpu_count() or 1))
    print(f"[dryrun] {len(todo)} cells on {jobs} processes", flush=True)
    with ProcessPoolExecutor(jobs, mp_context=get_context("spawn"),
                             max_tasks_per_child=1) as pool:
        futures = {tag: pool.submit(_run_and_save, *cell)
                   for tag, cell in todo}
        for tag, fut in futures.items():
            try:
                rec = fut.result()
            except Exception:        # one cell's failure is reported
                failures.append(tag)
                print(f"[FAIL] {tag}:")
                traceback.print_exc()
                continue
            mem_gb = rec["memory"]["total_bytes"] / 2**30
            print(f"[ok] {tag}: mem/device={mem_gb:.2f}GiB "
                  f"flops/device={rec['cost']['flops']:.3e} "
                  f"coll={rec['collectives']['total_bytes']:.3e}B "
                  f"(run {rec['lower_s']}s)", flush=True)
    print(f"done: {n_cells - len(failures)} ok, "
          f"{len(failures)} failed {failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
