"""Serving: prefill + single-token decode steps, and a batched generation
engine.

The decode step is ONE new token against a ``max_len``-deep KV cache, which
attention writes in place at ``cache_index``.  Temperature sampling draws
its Gumbel noise from the COPIFT xoshiro128+ uniform kernel, one counter
stream per (engine seed, slot, prompt, step).  ``autotune=True`` lets the
analytic model's tuner pick the kernels' tilings and the cluster operating
plan (and, with ``system=``, the manycore part's cluster count), as the JAX
package's engine does.
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
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.spans import span as _obs_span


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
    ``device`` (the card unless the caller asks for the CPU).

    ``autotune=True`` flips a process-wide kernel-config default (see
    ``__init__``); use the engine as a context manager or call
    :meth:`close` to restore it.  ``system=`` (a
    :class:`~repro_torch.system.SystemConfig`, a manycore deployment)
    also sizes the part under autotune: ``system_plan`` holds the cluster
    count x DVFS point for the decode-hot kernels, priced by the analytic
    model on the host; without autotune the config is only stored.
    """

    def __init__(self, cfg: ModelConfig, params, max_len: int = 256,
                 batch: int = 4, temperature: float = 0.0, seed: int = 0,
                 autotune: bool = False, power_cap_mw: float | None = None,
                 persist_tuned_defaults: bool = False, system=None,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.batch = batch
        self.temperature = temperature
        self.seed = seed
        self.autotune = autotune
        self.power_cap_mw = power_cap_mw
        self.system = system
        self.operating_plan = None
        self.system_plan = None
        self.device = resolve_device(device)
        self._prev_tuned: bool | None = None
        self._persist_tuned = persist_tuned_defaults
        self._closed = False
        if power_cap_mw is not None and not autotune:
            raise ValueError(
                f"power_cap_mw={power_cap_mw} only constrains the autotuned "
                f"operating plan, but autotune=False, so the cap would be "
                f"silently ignored. Either pass autotune=True so the engine "
                f"searches an operating plan under the cap, or drop "
                f"power_cap_mw to run with the static kernel defaults.")
        if autotune:
            # The softmax and uniform kernels run every decode step, so let
            # the facade's tuner pick their tiling once (cached).  A scoped
            # ``repro_torch.api.config`` would not outlive __init__, and
            # generate() may run on another thread, so this uses the
            # persistent setter and records the value it displaced;
            # ``close()`` (or leaving the engine's ``with`` block) restores
            # it, unless the caller opted out via persist_tuned_defaults.
            from repro_torch import api
            self._prev_tuned = kops.set_tuned_defaults(True)
            # The cluster operating plan for the decode-hot kernels: the
            # heterogeneous (DVFS-island) search with per-island block
            # refinement, which never scores worse than the homogeneous
            # ladder under the same power cap.  Advisory on this device —
            # ``operating_plan`` is what a Snitch-cluster deployment of the
            # engine would pin.
            tuner = api.Tuner(api.Target.homogeneous(
                power_cap_mw=power_cap_mw))
            t0 = time.perf_counter()
            with _obs_span("serve.autotune", power_cap_mw=power_cap_mw):
                self.operating_plan = {
                    name: tuner.operating_point(name, heterogeneous=True,
                                                per_island_blocks=True)
                    for name in ("softmax", "prng")}
                if system is not None:
                    # Manycore deployment: also size the part — cluster
                    # count x DVFS point under the same (system) power
                    # cap, priced through repro_torch.system.  ``system``
                    # is a SystemConfig whose cluster count is the upper
                    # bound of the search.
                    sys_tuner = api.Tuner(api.Target.system(
                        system, power_cap_mw=power_cap_mw))
                    self.system_plan = {
                        name: sys_tuner.operating_point(
                            name, n_clusters=system.n_clusters)
                        for name in ("softmax", "prng")}
            if _obs_metrics.enabled():
                _obs_metrics.set_gauge("serve.autotune.wall_s",
                                       time.perf_counter() - t0)
                for name, res in self.operating_plan.items():
                    c = res.best_cost
                    _obs_metrics.set_gauge(
                        f"serve.plan.{name}.cycles", c.cycles)
                    _obs_metrics.set_gauge(
                        f"serve.plan.{name}.energy_pj", c.energy_pj)
                    _obs_metrics.set_gauge(
                        f"serve.plan.{name}.power_mw", c.power_mw)
                    _obs_metrics.set_gauge(
                        f"serve.plan.{name}.time_ns", c.time_ns)
                if self.system_plan is not None:
                    for name, res in self.system_plan.items():
                        c = res.best_cost
                        _obs_metrics.set_gauge(
                            f"serve.plan.system.{name}.n_clusters",
                            res.n_clusters)
                        _obs_metrics.set_gauge(
                            f"serve.plan.system.{name}.power_mw", c.power_mw)
                        _obs_metrics.set_gauge(
                            f"serve.plan.system.{name}.time_ns", c.time_ns)
        self._prefill = make_prefill(cfg)
        self._step = make_serve_step(cfg)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Undo the engine's process-wide side effect: restore the tuned
        defaults setting that ``autotune=True`` displaced, unless
        ``persist_tuned_defaults=True``.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._prev_tuned is not None and not self._persist_tuned:
            kops.set_tuned_defaults(self._prev_tuned)

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- decoding -----------------------------------------------------------

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
