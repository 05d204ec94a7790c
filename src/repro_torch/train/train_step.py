"""The training step: microbatched gradient accumulation, global-norm
clipping, AdamW and optional int8 gradient compression, as the JAX
package's ``repro.train.train_step``.

The JAX package keeps fp32 master parameters and casts them once per
forward pass to the compute dtype; the gradient of a master is the
cotangent of its working copy, cast up.  ``TrainState`` does the same
arithmetic in PyTorch: ``params`` holds the fp32 masters, ``model`` the
working copy (each parameter in its ``models.model.working_dtype``: weight
matrices and a period's 1-D parameters in ``cfg.dtype``) that takes the
gradients, and after each update the masters are cast into the working
copy.  Where a parameter's working dtype is the master dtype (the prefix's
1-D parameters, and every parameter of an fp32 config) the master IS the
working parameter.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (LMModel, load_params, loss_fn,
                                      working_dtype)
from repro_torch.obs import card
from repro_torch.parallel.compress import quantize_dequantize
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         init_opt_state)


@dataclass
class TrainState:
    """``model``: the working copy, whose parameters take gradients;
    ``params``: the fp32 masters by state-dict name; ``opt``: ``m`` and
    ``v`` by the same names, and the int32 ``step``."""
    model: LMModel
    params: dict[str, torch.Tensor]
    opt: dict

    @torch.no_grad()
    def sync_working_copy(self) -> None:
        """Cast every master into its working parameter, where they differ:
        a master of the working dtype is the working parameter's own
        tensor (``init_train_state``)."""
        for name, w in self.model.named_parameters():
            master = self.params[name]
            if w.dtype != master.dtype:
                w.copy_(master)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The live tensors that define the state, flat: ``params/<name>``,
        ``opt/m/<name>``, ``opt/v/<name>`` and ``opt/step``.  The working
        copy is not among them: it is the masters, cast."""
        out = {f"params/{k}": v for k, v in self.params.items()}
        for part in ("m", "v"):
            out.update({f"opt/{part}/{k}": v
                        for k, v in self.opt[part].items()})
        out["opt/step"] = self.opt["step"]
        return out

    @torch.no_grad()
    def load_state_dict(self, arrays: dict[str, torch.Tensor]) -> None:
        """Copy ``arrays`` (this state's keys, shapes and dtypes) into the
        state, then refresh the working copy."""
        live = self.state_dict()
        if set(arrays) != set(live):
            missing = sorted(set(live) - set(arrays))[:5]
            extra = sorted(set(arrays) - set(live))[:5]
            raise KeyError(f"state keys differ: missing {missing}, "
                           f"unexpected {extra}")
        for k, t in live.items():
            a = arrays[k]
            if a.shape != t.shape or a.dtype != t.dtype:
                raise ValueError(f"{k}: stored {a.dtype}{tuple(a.shape)}, "
                                 f"state {t.dtype}{tuple(t.shape)}")
            t.copy_(a)
        self.sync_working_copy()


def init_train_state(cfg: ModelConfig, params: LMModel) -> TrainState:
    """A train state whose masters are ``params``'s values in
    ``cfg.param_dtype``, with zero moments.  ``params`` is best a model in
    the master dtype (``init_params(cfg.replace(dtype=cfg.param_dtype),
    ...)``): a model in a narrower dtype gives masters rounded to it.  The
    working copy is ``params`` itself when it already holds ``cfg``'s
    storage dtypes, else a new model cast from the masters."""
    pdt = getattr(torch, cfg.param_dtype)
    masters = {k: p.detach().to(pdt) for k, p in params.named_parameters()}
    if all(p.dtype == working_dtype(cfg, k, p.ndim)
           for k, p in params.named_parameters()):
        model = params
    else:
        model = load_params(masters, cfg, next(iter(masters.values())).device)
    for name, p in model.named_parameters():
        p.requires_grad_(True)
        if p.dtype == pdt:                   # one tensor for both roles
            masters[name] = p.data
    return TrainState(model=model, params=masters,
                      opt=init_opt_state(masters, cfg.opt_state_dtype))


#: A layer period's parameter name; the JAX tree stacks ``<rest>`` over the
#: periods into one leaf.
_PERIOD_NAME = re.compile(r"^stack\.periods\.\d+\.")


def compress_grads(grads: dict[str, torch.Tensor],
                   params: dict[str, torch.Tensor]) -> dict:
    """Every fp32 gradient round-tripped through int8 and cast to its
    master's dtype, with one scale per leaf of the JAX package's parameter
    tree: the periods' copies of one parameter share the largest
    ``max|g|`` among them, as their stacked leaf has it in JAX."""
    def leaf(name):
        return _PERIOD_NAME.sub("stack.periods.", name)

    amax: dict[str, torch.Tensor] = {}
    for k, g in grads.items():
        m = g.abs().amax()
        amax[leaf(k)] = torch.maximum(amax[leaf(k)], m) \
            if leaf(k) in amax else m
    return {k: quantize_dequantize(g, amax[leaf(k)])[0].to(params[k].dtype)
            for k, g in grads.items()}


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The gradient ``g`` of ``p`` in ``p``'s placements when both are
    DTensors: the data-parallel reduction (partial sums all-reduced, or
    reduce-scattered onto a sharded parameter) happens here, once."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    n_microbatches: int = 1, compress_pod_grads: bool = False):
    """Returns ``train_step(state, batch) -> (state, metrics)``, which
    updates ``state`` in place.

    ``batch``: a dict of (B, T) tensors.  With ``n_microbatches > 1`` the
    batch is split on its leading axis and the gradients are accumulated in
    fp32, ``acc + g / n`` per microbatch (the JAX package's ``lax.scan``),
    so that one microbatch's activations are alive at a time.  Metrics are
    0-d tensors: ``loss``, ``nll``, ``aux``, ``zloss``, ``ppl`` (means over
    the microbatches), ``lr`` and ``grad_norm``.

    ``compress_pod_grads`` round-trips every gradient through int8
    (``compress_grads``) before AdamW, as the JAX package emulates the
    compressed cross-pod all-reduce payload on one device; ``grad_norm``
    is then the compressed gradients' norm.
    """

    def grads_of(model: LMModel, batch: dict, dtype=None):
        """(loss, metrics, gradients by name), each gradient cast to
        ``dtype`` where one is given."""
        names, params = zip(*model.named_parameters())
        with card.span("train.forward"):
            loss, metrics = loss_fn(model, cfg, batch)
        with card.span("train.backward"):
            # A parameter the loss does not read (hubert's token embedding,
            # RWKV's ``mu_x``) has a zero gradient, as under ``jax.grad``.
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else _placed_like(g, p)
                     for p, g in zip(params, grads)]
            if dtype is not None:
                grads = [g.to(dtype) for g in grads]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            dict(zip(names, grads))

    def compute_grads(model: LMModel, batch: dict):
        if n_microbatches == 1:
            return grads_of(model, batch, torch.float32)
        for k, x in batch.items():
            if x.shape[0] % n_microbatches:
                raise ValueError(f"batch[{k!r}] has {x.shape[0]} rows, not "
                                 f"a multiple of {n_microbatches} "
                                 "microbatches")
        acc, losses, metricses = None, [], []
        for i in range(n_microbatches):
            mb = {k: x.chunk(n_microbatches)[i] for k, x in batch.items()}
            loss, metrics, grads = grads_of(model, mb)
            if acc is None:
                acc = {k: torch.zeros(g.shape, dtype=torch.float32,
                                      device=g.device)
                       for k, g in grads.items()}
            with card.span("train.backward"):
                for k, g in grads.items():
                    acc[k] += g.to(torch.float32) / n_microbatches
            losses.append(loss)
            metricses.append(metrics)
        metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                   for k in metricses[0]}
        return torch.stack(losses).mean(), metrics, acc

    def train_step(state: TrainState, batch: dict):
        with card.span("train.step", unit=True):
            loss, metrics, grads = compute_grads(state.model, batch)
            with card.span("train.optimizer"):
                if compress_pod_grads:
                    grads = compress_grads(grads, state.params)
                opt_metrics = adamw_update(opt_cfg, state.params, grads,
                                           state.opt)
                del grads
                state.sync_working_copy()
        return state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


@torch.no_grad()
def distribute_train_state(state: TrainState, rules) -> TrainState:
    """``state`` placed on ``rules.mesh`` by the rule table
    (``parallel.sharding.ShardingRules``), as a new ``TrainState`` of
    DTensors: each master, its working parameter and its moments take the
    parameter's spec (ZeRO-1: the moments take their master's placement),
    the step is replicated.  The working copy's parameters are replaced in
    ``state.model``, so ``state`` itself is spent.  Every rank must hold
    the whole state (the same seed): each keeps its own shards and no
    collective runs.  A state on ``meta`` gives the dry-run's shards."""
    from repro_torch.parallel.sharding import distribute, distribute_module
    mesh = rules.mesh
    specs = rules.params_pspecs(state.params)
    shared = {k for k, w in state.model.named_parameters()
              if w.dtype == state.params[k].dtype}
    distribute_module(state.model, specs, mesh)
    masters = {k: w.data if k in shared
               else distribute(state.params[k], specs[k], mesh)
               for k, w in state.model.named_parameters()}
    opt = {part: {k: distribute(t, specs[k], mesh)
                  for k, t in state.opt[part].items()}
           for part in ("m", "v")}
    opt["step"] = distribute(state.opt["step"], (), mesh)
    return TrainState(model=state.model, params=masters, opt=opt)
