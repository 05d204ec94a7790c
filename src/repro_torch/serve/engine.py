"""Serving: prefill + single-token decode steps, and a batched generation
engine.

The decode step is ONE new token against a ``max_len``-deep KV cache, which
attention writes in place at ``cache_index``.  Temperature sampling draws
its Gumbel noise from the COPIFT xoshiro128+ uniform kernel, one counter
stream per (engine seed, slot, prompt, step), all of a step's rows in one
launch.  ``autotune=True`` lets the analytic model's tuner pick the
kernels' tilings and the cluster operating plan (and, with ``system=``, the
manycore part's cluster count), as the JAX package's engine does.

The engine's decode step reads everything from device memory at fixed
addresses (``_DecodeState``): the cache it owns, the last tokens, the
position as a 0-d tensor and the step's sampler seeds, and it writes its
tokens there.  On a CUDA device with plain-tensor parameters it captures
that step, the sample included, as one CUDA graph at its first decode step
and replays it once a token; elsewhere (the CPU, DTensor parameters) it
runs the same step eagerly.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.model import forward, resolve_device
from repro_torch.models.transformer import init_stack_cache
from repro_torch.obs import card
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.spans import span as _obs_span


def make_cache(cfg: ModelConfig, batch: int, max_len: int, device="cuda"):
    return init_stack_cache(cfg, batch, max_len, device)


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, cache, tokens (B,1), cache_index) →
    (logits (B,V), cache); the cache is updated in place.  ``cache_index``
    an int, or a 0-d int64 tensor on the cache's device."""

    def serve_step(params, cache, tokens, cache_index):
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


def _step_seeds(slot_seeds: list[int], steps: int) -> np.ndarray:
    """(steps, B) uint32: ``_mix32(slot_seeds[b], i)`` at [i, b], the
    murmur3 finaliser of ``_mix32`` in numpy's wrapping uint32."""
    h = np.full((steps, len(slot_seeds)), 0x9E3779B9, dtype=np.uint32)
    for w in (np.asarray(slot_seeds, dtype=np.uint32)[None],
              np.arange(steps, dtype=np.uint32)[:, None]):
        h = h ^ w
        h = h * np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h = h * np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


class _DecodeState:
    """What a decode step reads and writes, at addresses fixed for the
    engine's life: the cache, the last tokens (B, 1), the position (0-d
    int64), the step's number (1,), a row of sampler seeds a step (max_len,
    B) int32 and the sampled tokens (B, max_len) int64; and the step's CUDA
    graph once captured (its logits output and the kernel settings it was
    captured under)."""

    def __init__(self, cfg: ModelConfig, batch: int, max_len: int, device):
        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.cache = make_cache(cfg, batch, max_len, device)
        self.tok = zeros(batch, 1)
        self.pos = zeros()
        self.step = zeros(1)
        self.seeds = zeros(max_len, batch, dtype=torch.int32)
        self.tokens = zeros(batch, max_len)
        self.graph = self.logits = self.settings = None


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
        self._state: _DecodeState | None = None

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

    def _sample(self, logits: torch.Tensor, step: torch.Tensor,
                seeds: torch.Tensor) -> torch.Tensor:
        """(B,) tokens from logits (B, V): the argmax, or at a temperature
        the Gumbel trick with xoshiro uniforms (the paper's PRNG), one
        counter stream per (engine, slot, step), a step's rows in one
        launch.  ``step`` the step number (1,) int64 and ``seeds`` the
        seeds table (steps, B) int32 (``_step_seeds``), both on the logits'
        device, where the step's row is read."""
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        row = seeds.index_select(0, step)[0]
        u = kops.uniform_rows(row, logits.shape[-1])
        g = -torch.log(-torch.log(torch.clamp(u, min=1e-12)))
        return torch.argmax(logits / self.temperature + g, dim=-1)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode_state(self) -> _DecodeState:
        if self._state is None:
            self._state = _DecodeState(self.cfg, self.batch, self.max_len,
                                       self.device)
        return self._state

    def _take(self, st: _DecodeState, logits: torch.Tensor) -> None:
        """Sample step ``st.step``'s tokens from ``logits``, record them and
        feed them to the next step, on the device."""
        tok = self._sample(logits, st.step, st.seeds)[:, None]
        st.tokens.index_copy_(1, st.step, tok)
        st.tok.copy_(tok)
        st.step.add_(1)

    def _decode_step(self, st: _DecodeState) -> torch.Tensor:
        """One decode step, sampled, eagerly: the logits (B, V) of the
        tokens ``st.tok`` at ``st.pos``."""
        with card.span("serve.decode_step") as sp:
            sp.count(graph=0)
            logits, _ = self._step(self.params, st.cache, st.tok, st.pos)
            st.pos.add_(1)
        with card.span("serve.sample"):
            self._take(st, logits)
        return logits

    def _graphable(self) -> bool:
        """Whether the decode step is captured as a CUDA graph: on a CUDA
        device, with plain-tensor parameters (the cache is the engine's own,
        plain tensors), the step reads only device memory at fixed
        addresses and allocates only in the graph's pool.  A DTensor step
        stays eager."""
        return self.device.type == "cuda" and not any(
            isinstance(p, DTensor) for p in self.params.parameters())

    def _capture(self, st: _DecodeState) -> torch.Tensor:
        """Run the step this call is at eagerly on a side stream (the
        warm-up a capture needs), then capture the step, the sample in it,
        as ``st.graph``, leaving the cache, the position and the tokens as
        the eager step left them.  Returns the eager step's logits.  The
        capture calls the kernels' wrappers, which count it as a launch;
        a replay launches without calling them, and ``serve.decode_step``
        counts it as ``graph`` 1."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            logits = self._decode_step(st)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with card.off(), torch.cuda.graph(graph, stream=side):
            st.logits = self._decode_step(st)
        st.graph, st.settings = graph, self._settings()
        return logits

    @staticmethod
    def _settings() -> tuple:
        """The kernel settings a capture bakes in: the impl and the
        tilings."""
        return kops.current_impl(), kops.tuned_defaults_enabled()

    def _advance(self, st: _DecodeState, sp) -> torch.Tensor:
        """The next decode step: a replay of the captured graph, else its
        capture (the first on a CUDA device, or after a change of kernel
        settings), else an eager step."""
        if st.graph is not None and st.settings == self._settings():
            with card.span("serve.decode_step") as step_sp:
                step_sp.count(graph=1)
                st.graph.replay()
            return st.logits
        if self._graphable():
            sp.count(graph_captures=1)
            return self._capture(st)
        return self._decode_step(st)

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
        with card.span("serve.generate", unit=True) as sp:
            return self._generate(prompts, n_steps, sp)

    def _generate(self, prompts: np.ndarray, n_steps: int,
                  sp) -> GenerationResult:
        B, plen = prompts.shape
        st = self._decode_state()
        sp.count(graph_captures=0)
        if self.temperature > 0.0:
            seeds = _step_seeds(self._slot_seeds(prompts), n_steps)
            st.seeds[:n_steps].copy_(torch.from_numpy(seeds.view(np.int32)))
        toks = torch.as_tensor(prompts, dtype=torch.int64, device=self.device)
        # the cache as make_cache gives it: the recurrent states start at 0
        for t in tree_leaves(st.cache):
            t.zero_()
        t0 = time.perf_counter()
        with card.span("serve.prefill"):
            logits, _ = self._prefill(self.params, st.cache, toks)
            st.pos.fill_(plen)
            st.step.zero_()
        self._sync()
        t1 = time.perf_counter()
        seen = torch.empty((B, n_steps, logits.shape[-1]),
                           dtype=torch.float32, device=self.device)
        seen[:, 0].copy_(logits)
        with card.span("serve.sample"):
            self._take(st, logits)
        for i in range(1, n_steps):
            seen[:, i].copy_(self._advance(st, sp))
        new = st.tokens[:, :n_steps].cpu().numpy()
        tokens = np.concatenate([prompts, new], axis=1).astype(np.int32)
        t2 = time.perf_counter()
        return GenerationResult(tokens, n_steps, seen, prefill_s=t1 - t0,
                                decode_s=t2 - t1)
