"""Training traffic: the program's training step, as ``launch/train.py``
runs it.

Set-up builds one train state (fp32 masters from the benchmark's seeded
weights, zero AdamW moments, the bf16 working copy) and one step, drives
them through the first ``check_steps`` steps on the program's token
pipeline, and hands the same state to the window.  A unit is one step:
the pipeline's batch of that step, the step, and a device
synchronisation.

The check reads, during set-up, each step's loss, each parameter's norm
of the first step's gradient as AdamW got it (its first moment after one
step, over 1 − β1) and, after the last of those steps, each parameter's
norm of its change since the start (before the window's first step moves
it again).  After the window the reference trains the same steps on the
same batches in fp32 and compares (``reference/check.py``).
"""

from __future__ import annotations

import time

import torch

from bench import harness
from bench.reference import check, data


class Run:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        t = ctx.traffic
        self.B, self.T = t["batch"], t["seq"]
        self.opt = dict(t["optimizer"])
        self.steps = ctx.cell["check"]["steps"]
        self.pipe_seed = harness.sub_seed(ctx.seed, 2) & 0x7FFFFFFF
        self.check_s = 0.0            # set-up time the check's readings took
        self.phases: dict[str, float] = {}     # set-up's parts, seconds
        self.readings = None

    def setup(self, fault: str | None = None) -> None:
        """``fault`` plants one of the check's faults for its tests:
        ``"half_batch"`` (each step sees the first half of its rows) or
        ``"frozen"`` (a step that leaves the state as it was)."""
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
        from repro_torch.train.optimizer import AdamWConfig
        from repro_torch.train.train_step import (init_train_state,
                                                  make_train_step)
        ctx = self.ctx
        t_start = time.perf_counter()
        cfg = harness.program_config(ctx.config)
        f32 = getattr(torch, cfg.param_dtype)
        masters = harness.program_model(
            cfg.replace(dtype=cfg.param_dtype), ctx.specs, ctx.seed, f32,
            lambda n: f32, ctx.device)
        self.state = init_train_state(cfg, masters)
        step = make_train_step(cfg, AdamWConfig(**self.opt))
        if fault == "half_batch":
            self.step = lambda s, b: step(
                s, {k: v[:v.shape[0] // 2] for k, v in b.items()})
        elif fault == "frozen":
            self.step = lambda s, b: (s, {"loss": torch.zeros(())})
        elif fault is None:
            self.step = step
        else:
            raise ValueError(f"fault {fault!r}")
        self.pipe = TokenPipeline(
            cfg, ShapeConfig("bench", self.T, self.B, "train"),
            PipelineConfig(seed=self.pipe_seed), ctx.device)
        harness.sync(ctx.device)
        t_steps = time.perf_counter()
        self.phases["program and weights"] = t_steps - t_start
        losses, grad = [], None
        for k in range(self.steps):
            self.state, metrics = self.step(self.state,
                                            self.pipe.host_batch_at(k))
            losses.append(float(metrics["loss"]))
            if k == 0:
                t0 = time.perf_counter()
                grad = self._first_grad()
                self.check_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        self.readings = {"loss": losses, "grad": grad,
                         "change": self._change()}
        self.check_s += time.perf_counter() - t0
        self.next_step = self.steps
        harness.sync(ctx.device)
        self.phases["first steps"] = (time.perf_counter() - t_steps
                                      - self.check_s)
        self.phases["check readings"] = self.check_s

    @torch.no_grad()
    def _first_grad(self) -> dict[str, float]:
        m = self.state.opt["m"]
        return {n: float(m[n].norm()) / (1 - self.opt["beta1"]) for n in m}

    @torch.no_grad()
    def _change(self) -> dict[str, float]:
        start = harness.redraw(self.ctx, torch.float32, self.ctx.device)
        return {n: float((p - start(n)).norm())
                for n, p in self.state.params.items()}

    def unit(self) -> dict:
        t0 = time.perf_counter()
        batch = self.pipe.host_batch_at(self.next_step)
        self.state, metrics = self.step(self.state, batch)
        harness.sync(self.ctx.device)
        seconds = time.perf_counter() - t0
        self.next_step += 1
        return {"seconds": seconds, "requests": self.B,
                "tokens": self.B * self.T, "steps": 1,
                "loss": metrics["loss"].detach(),
                "forwards": [("train", self.B, self.T, self.T)]}

    def failed(self) -> int:
        return sum(1 for u in harness.all_units(self.ctx)
                   if not torch.isfinite(u["loss"]).item())

    def free(self) -> None:
        self.state = self.step = self.pipe = None

    def reference(self, prec: str = "fp32") -> dict:
        """The reference's loss, first gradient and change over the
        checked steps, from the seed's weights and batches."""
        ctx = self.ctx
        m = ctx.model
        harness.reference_mode()
        start = harness.redraw(ctx, torch.float32, ctx.device)
        params = {s.name: start(s.name) for s in ctx.specs}
        batches = [torch.as_tensor(data.batch_at(
            self.pipe_seed, k, self.B, self.T, m.vocab_size),
            device=ctx.device) for k in range(self.steps)]
        return ctx.ref.train(m, params, batches, self.opt, start,
                             ctx.ref.Precision(prec))

    def check(self, control: str | None = None) -> dict[str, float]:
        """``loss_gap``, ``grad_gap`` and ``change_gap`` of the program
        against the reference; with ``control`` (a precision) the same
        numbers of the reference at that precision in the program's place,
        prefixed ``control.``."""
        ref = self.reference()
        out = check.train_numbers(self.readings, ref)
        if control:
            low = self.reference(control)
            out.update({f"control.{k}": v for k, v in
                        check.train_numbers(low, ref).items()})
        return out
