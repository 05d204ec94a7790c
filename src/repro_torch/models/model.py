"""Top-level model: embedding → stack → norm → readout.

Inputs are a dict ("batch"): ``tokens`` (B, T) int, with optional
``positions`` (B, T), or ``positions3`` (3, B, T) for M-RoPE; for the audio
frontend (hubert), ``embeds`` (B, T, D) frame embeddings and ``labels``
(B, T) int.  ``forward`` covers training and prefill (no cache) and decode
(cache + index); ``loss_fn`` is the chunked cross-entropy with a z-loss
that training differentiates.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.parallel import autoshard


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names the card and
    there is none, so nothing carries on quietly on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but PyTorch sees no "
                           "CUDA device; pass device='cpu' to run on the CPU")
    return device


class LMModel(nn.Module):
    """The parameters, named as the JAX package's parameter tree: ``embed``,
    ``stack``, ``final_norm`` and, without tied embeddings, ``head``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = getattr(torch, cfg.dtype)
        self.embed = L.Embedding(cfg.vocab_size, cfg.d_model, dt, device)
        self.stack = T.Stack(cfg, device)
        self.final_norm = L.Norm(cfg.norm, cfg.d_model, device)
        self.head = (None if cfg.tie_embeddings else
                     L.Linear(cfg.d_model, cfg.vocab_size, dt, device))


_PERIODS = "stack.periods."


def working_dtype(cfg: ModelConfig, name: str, ndim: int) -> torch.dtype:
    """The dtype of parameter ``name`` (``ndim`` dimensions) in the working
    copy: the JAX package's ``_cast_once`` casts every master of rank >= 2
    to ``cfg.dtype`` and keeps the others in fp32.  A period's parameters
    are stacked there on a leading ``n_periods`` axis, so a period's 1-D
    parameters (norm gains, biases, RWKV's ``w0`` and ``mu_*``, Mamba's
    ``D``) have rank 2 and take ``cfg.dtype``; the prefix's and the final
    norm's stay fp32."""
    rank = ndim + name.startswith(_PERIODS)
    return getattr(torch, cfg.dtype) if rank >= 2 else torch.float32


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str = "cuda") -> LMModel:
    """Random parameters drawn from ``generator``, which must live on
    ``device``: truncated normals in ±2σ with the JAX package's scales and
    the JAX package's constants (norm gains 1, biases 0, RWKV's and
    Mamba's fills), drawn in fp32 and stored in ``working_dtype``."""
    model = LMModel(cfg, resolve_device(device))
    for m in model.modules():
        if hasattr(m, "init_"):
            m.init_(generator)
    for name, p in model.named_parameters():
        p.data = p.data.to(working_dtype(cfg, name, p.ndim))
    return model


def load_params(state_dict: Mapping[str, torch.Tensor | np.ndarray],
                cfg: ModelConfig,
                device: torch.device | str = "cuda") -> LMModel:
    """An ``LMModel`` holding copies of ``state_dict``'s values (its names,
    every parameter present), each cast to its ``working_dtype``: the JAX
    package's cast of its masters before use."""
    device = resolve_device(device)

    def copy(name, v):
        kw = dict(device=device, dtype=working_dtype(cfg, name, v.ndim))
        if isinstance(v, torch.Tensor):
            return v.detach().to(copy=True, **kw)
        return torch.tensor(v, **kw)

    sd = {name: copy(name, v) for name, v in state_dict.items()}
    model = LMModel(cfg, device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def _positions(cfg: ModelConfig, batch: dict, B: int, T_len: int, device,
               cache_index=None, like=None):
    """(B, T) positions, or (3, B, T) for M-RoPE; sharded as the batch
    dimensions of ``like`` when it is a DTensor."""
    pos = torch.arange(T_len, dtype=torch.int32, device=device)[None]
    pos = pos.expand(B, T_len)
    if cache_index is not None:
        pos = pos + cache_index
    if cfg.rope == "mrope":
        if "positions3" in batch:
            return batch["positions3"]
        pos = L.sharded_like(pos, like)
        return torch.stack([pos, pos, pos])           # text: t = h = w
    if "positions" in batch:
        return batch["positions"]
    return L.sharded_like(pos, like)


def _readout(params: LMModel, cfg: ModelConfig, x):
    """Logits of x (B, T, D).  With more than one token a row (the loss's
    chunks) the head is gathered where FSDP shards its d, as FSDP gathers
    a parameter: left sharded, DTensor moves the hidden state's d onto
    the head's shards instead, and the partial logits are reduce-scattered
    over the batch's ranks and their gradient gathered back, (B, chunk,
    V) a chunk.  One token a row (decode, prefill's last) moves less than
    the head."""
    dt = getattr(torch, cfg.dtype)
    if cfg.tie_embeddings:
        table = params.embed.table.to(dt)
        if x.shape[1] > 1:
            table = L.whole(table, 1)
        return x.to(dt) @ table.T
    w = params.head.w.to(dt)
    if x.shape[1] > 1:
        w = L.whole(w, 0)
    return x.to(dt) @ w


def forward(params: LMModel, cfg: ModelConfig, batch: dict, cache=None,
            cache_index: int | None = None, logits_mode: str = "all"):
    """returns (logits, cache, aux_loss); a cache is updated in place.

    logits_mode: "all" (B,T,V) | "last" (B,1,V — decode/prefill readout) |
    "hidden" (B,T,D)."""
    dt = getattr(torch, cfg.dtype)
    if cfg.frontend == "audio":
        x = batch["embeds"].to(dt)
    else:
        x = L.embed(params.embed, batch["tokens"], dt)
        if cfg.embed_scale:
            x = x * L.replicated_like(
                torch.tensor(cfg.d_model ** 0.5, dtype=dt), x)
    x = autoshard.hidden(x)
    B, T_len = x.shape[:2]
    positions = _positions(cfg, batch, B, T_len, x.device, cache_index, x)

    x, cache, aux = T.apply_stack(params.stack, cfg, x, positions, cache,
                                  cache_index)
    x = L.norm(cfg.norm, params.final_norm, x)
    if logits_mode == "hidden":
        return x, cache, aux
    if logits_mode == "last":
        x = x[:, -1:]
    logits = _readout(params, cfg, x)
    return logits.to(torch.float32), cache, aux


#: tokens per chunk of the chunked cross-entropy: the (B, chunk, V) fp32
#: logits of one chunk are the largest intermediate of the loss.
CE_CHUNK = 256


def _ce_terms(params: LMModel, cfg: ModelConfig, hidden, targets):
    """(Σ (logz - ll), Σ logz², count) over one chunk; fp32 math on the
    logits of the compute dtype."""
    logits = autoshard.logits(_readout(params, cfg, hidden)).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    if cfg.vocab_parallel_ce:
        # The JAX package's vocab-sharded form: the target's logit by a
        # one-hot contraction instead of a gather (one device: no shards).
        onehot = F.one_hot(targets.long(), cfg.vocab_size).to(logits.dtype)
        ll = (logits * onehot).sum(dim=-1)
    else:
        # The target's logit by a gather, over the whole vocabulary.
        ll = _target_logit(L.whole(logits, -1), targets)
    count = L.replicated_like(torch.tensor(float(targets.numel()),
                                           device=logits.device), logits)
    return (logz - ll).sum(), logz.square().sum(), count


def _target_logit(logits, targets):
    """(B, chunk) logits of the targets.  On DTensors (the vocabulary
    whole) each rank gathers from its own rows: DTensor's rule for the
    gather's backward makes a zero tensor of the whole batch's logits on
    every rank."""
    if not isinstance(logits, DTensor):
        return logits.gather(-1, targets.long()[..., None])[..., 0]
    mesh, placements = logits.device_mesh, logits.placements
    if targets.placements != placements:
        targets = targets.redistribute(mesh, placements)
    ll = logits.to_local().gather(
        -1, targets.to_local().long()[..., None])[..., 0]
    return DTensor.from_local(ll, mesh, placements, run_check=False)


def loss_fn(params: LMModel, cfg: ModelConfig, batch: dict,
            aux_weight: float = 0.01, z_weight: float = 1e-4):
    """Next-token (per-frame, against ``labels``, for encoder-only
    configs) cross-entropy + MoE auxiliary loss + z-loss.  The CE runs in
    ``CE_CHUNK``-token chunks, each under ``torch.utils.checkpoint``, so the
    logits never exceed (B, CE_CHUNK, V) and are recomputed in the backward
    pass.  Returns (loss, metrics) with metrics ``nll``, ``aux``, ``zloss``
    and ``ppl``, 0-d fp32 tensors."""
    hidden, _, aux = forward(params, cfg, batch, logits_mode="hidden")
    if cfg.is_encoder_only:
        targets = batch["labels"]
        pred_h = hidden
    else:
        targets = batch["tokens"][:, 1:]
        pred_h = hidden[:, :-1]
    T = targets.shape[1]
    chunk = min(CE_CHUNK, T)

    def ce_chunk(h, t):
        return _ce_terms(params, cfg, h, t)

    sums = None
    for lo in range(0, T, chunk):
        terms = checkpoint(ce_chunk, pred_h[:, lo:lo + chunk],
                           targets[:, lo:lo + chunk], use_reentrant=False)
        sums = terms if sums is None else [a + b for a, b in zip(sums, terms)]
    nll_sum, z_sum, count = sums
    nll = nll_sum / count
    zloss = z_sum / count
    loss = nll + aux_weight * aux + z_weight * zloss
    return loss, {"nll": nll, "aux": aux, "zloss": zloss,
                  "ppl": torch.exp(nll)}
