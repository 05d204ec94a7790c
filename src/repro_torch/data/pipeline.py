"""Deterministic synthetic token pipeline, driven by the paper's PRNGs, as
the JAX package's ``repro.data.pipeline``.

``kernels.ops.uniform`` (xoshiro128+ by default) produces the token stream:
on the card the CUDA uniform kernel, two launches a step, and a third for
the audio frontend's frame embeddings (B·T·d_model values).  ``global_batch_at
(step)`` depends only on (seed, step, shape), and its batches equal the JAX
package's bit for bit, so restart and resume reproduce the same batches.

Hosts: each process takes its slice of the global batch by rank.  With
``torch.distributed`` not initialised there is one process, and the slice
is the whole batch.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.model import resolve_device
from repro_torch.obs import card


@dataclass(frozen=True)
class PipelineConfig:
    seed: int = 1234
    kind: str = "xoshiro128p"      # the paper's PRNG


def _process_count_and_index() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class TokenPipeline:
    """Batches of ``shape`` for ``cfg`` on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 pcfg: PipelineConfig = PipelineConfig(),
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.shape = shape
        self.pcfg = pcfg
        self.device = resolve_device(device)
        self.n_hosts, self.host = _process_count_and_index()
        if shape.global_batch % self.n_hosts and shape.global_batch != 1:
            raise ValueError(f"global batch {shape.global_batch} does not "
                             f"split over {self.n_hosts} processes")
        self.host_batch = max(1, shape.global_batch // self.n_hosts)

    def _step_seed(self, step: int) -> int:
        # Golden-ratio stride decorrelates steps; every host draws the same
        # global stream and slices it, which keeps re-sharding reproducible.
        return (self.pcfg.seed + step * 0x9e3779b9) & 0x7fffffff

    def global_batch_at(self, step: int) -> dict:
        """Sticky-token stream: with probability 0.1 a token is a fresh
        uniform draw, else it repeats the one before, so that training
        curves fall.  ``{"tokens": (B, T) int32}``; for the audio frontend
        ``{"embeds": (B, T, d_model) bf16 uniforms in [-1, 1), "labels":
        (B, T) int32}``."""
        B, T = self.shape.global_batch, self.shape.seq_len
        p_stick = 0.9
        V = self.cfg.vocab_size
        u = kops.uniform(self._step_seed(step), (B, T + 1),
                         kind=self.pcfg.kind, device=self.device)
        fresh = torch.clamp((u * V).to(torch.int32), max=V - 1)
        ur = kops.uniform(self._step_seed(step) ^ 0x1b873593, (B, T + 1),
                          kind=self.pcfg.kind, device=self.device)
        t_idx = torch.arange(T + 1, device=self.device)[None, :]
        reset = (ur >= p_stick) | (t_idx == 0)
        src = torch.cummax(torch.where(reset, t_idx, 0), dim=1).values
        tokens = torch.gather(fresh, 1, src)
        if self.cfg.frontend == "audio":
            ue = kops.uniform(self._step_seed(step) ^ 0x5bd1e995,
                              (B, T, self.cfg.d_model), kind=self.pcfg.kind,
                              device=self.device)
            return {"embeds": (ue * 2 - 1).to(torch.bfloat16),
                    "labels": tokens[:, :T]}
        return {"tokens": tokens[:, :T]}

    def host_batch_at(self, step: int) -> dict:
        with card.span("data.batch"):
            full = self.global_batch_at(step)
            lo = self.host * self.host_batch
            return {k: v[lo:lo + self.host_batch] for k, v in full.items()}
