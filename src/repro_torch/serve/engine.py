"""Serving: prefill + single-token decode steps, and a batched generation
engine.

The decode step is ONE new token against a ``max_len``-deep KV cache, which
attention writes in place at ``cache_index``.  Temperature sampling draws
its Gumbel noise from the COPIFT xoshiro128+ uniform kernel, one counter
stream per (engine seed, slot, prompt, step).
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.model import forward, resolve_device
from repro_torch.models.transformer import init_stack_cache


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    return init_stack_cache(cfg, batch, max_len, device)


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens (B,1), cache_index) →
    (logits (B,V), cache); the cache is updated in place."""

    def serve_step(params, cache, tokens, cache_index: int):
        logits, cache, _ = forward(params, cfg, {"tokens": tokens},
                                   cache=cache, cache_index=cache_index,
                                   logits_mode="last")
        return logits[:, 0], cache

    return serve_step


def make_prefill(cfg: ModelConfig):
    """prefill(params, cache, tokens (B,T)) → (last_logits, cache); the
    cache is filled in place."""

    def prefill(params, cache, tokens):
        logits, cache, _ = forward(params, cfg, {"tokens": tokens},
                                   cache=cache, cache_index=0,
                                   logits_mode="last")
        return logits[:, 0], cache

    return prefill


def _mix32(*words: int) -> int:
    """Fold a tuple of ints into one well-scrambled uint32 stream seed
    (murmur3-finalizer avalanche per word), with explicit 32-bit masking."""
    h = 0x9E3779B9
    for w in words:
        h = (h ^ (int(w) & 0xFFFFFFFF)) & 0xFFFFFFFF
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        h ^= h >> 16
    return h


@dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, prompt+generated) int32
    steps: int
    #: (B, steps, V) fp32 on the engine's device: the logits each generated
    #: token was drawn from (None when steps == 0).
    logits: torch.Tensor | None = None
    #: Host-clock seconds of the prefill and of the decode steps, each
    #: ending in a device synchronisation.
    prefill_s: float = 0.0
    decode_s: float = 0.0


class ServeEngine:
    """Batched greedy/temperature decoding over a fixed slot set, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 batch: int = 4, temperature: float = 0.0, seed: int = 0,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.batch = batch
        self.temperature = temperature
        self.seed = seed
        self.device = resolve_device(device)
        self._prefill = make_prefill(cfg)
        self._step = make_serve_step(cfg)

    def _slot_seeds(self, prompts: np.ndarray) -> list[int]:
        """One PRNG stream seed per slot, decorrelated across
        (engine seed, slot index, prompt content)."""
        rows = np.ascontiguousarray(prompts, dtype=np.int32)
        return [_mix32(self.seed, slot, zlib.crc32(rows[slot].tobytes()))
                for slot in range(rows.shape[0])]

    def _sample(self, logits: torch.Tensor, step: int,
                slot_seeds: list[int]) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        # Gumbel trick with xoshiro uniforms (the paper's PRNG), one
        # counter stream per (engine, slot, step).
        u = torch.stack([kops.uniform(_mix32(s, step), logits.shape[-1:],
                                      device=logits.device)
                         for s in slot_seeds])
        g = -torch.log(-torch.log(torch.clamp(u, min=1e-12)))
        return torch.argmax(logits / self.temperature + g, dim=-1)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, n_steps: int) -> GenerationResult:
        """prompts: (B, P) int; decodes exactly ``n_steps`` tokens.
        ``n_steps=0`` returns the prompt unchanged (no prefill, no
        sampled token)."""
        prompts = np.asarray(prompts)
        B, plen = prompts.shape
        if B != self.batch:
            raise ValueError(
                f"prompts batch dimension is {B}, but this engine was "
                f"built with batch={self.batch}; rebuild the engine or "
                f"re-batch the prompts.")
        if n_steps < 0:
            raise ValueError(f"n_steps={n_steps} must be >= 0")
        if plen + n_steps > self.max_len:
            raise ValueError(
                f"prompt length {plen} + n_steps={n_steps} = "
                f"{plen + n_steps} exceeds max_len={self.max_len}; raise "
                f"max_len or decode fewer steps.")
        if n_steps == 0:
            return GenerationResult(prompts.astype(np.int32), 0)
        slot_seeds = self._slot_seeds(prompts)
        toks = torch.as_tensor(prompts, dtype=torch.int64, device=self.device)
        cache = make_cache(self.cfg, B, self.max_len, self.device)
        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, cache, toks)
        self._sync()
        t1 = time.perf_counter()
        out, seen = [toks], []
        for i in range(n_steps):
            seen.append(logits)
            tok = self._sample(logits, i, slot_seeds)[:, None]
            out.append(tok)
            if i + 1 < n_steps:
                logits, cache = self._step(self.params, cache, tok, plen + i)
        tokens = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        t2 = time.perf_counter()
        return GenerationResult(tokens, n_steps, torch.stack(seen, dim=1),
                                prefill_s=t1 - t0, decode_s=t2 - t1)
