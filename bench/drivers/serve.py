"""Serving traffic: closed-loop calls of ``ServeEngine.generate``.

A unit is one call: ``batch`` prompts of ``prompt`` tokens drawn on the
card from the seed, ``new_tokens`` tokens each, at the traffic's
temperature.  Calls run back to back, and each is timed whole on the
host, since the call's last act copies its tokens to the host.

The check: after the window, requests drawn from the seed among those the
window finished; the reference runs each prompt with its served tokens.
``served_gap`` reads, at every served position, by how far the served
token's score lies below the best score.  A score is the logit plus, for
sampled traffic, the temperature times the call's own Gumbel noise,
worked out again from the engine's seed: the program samples the token
whose score is highest, so a sound run reads only the noise of its
precision.  ``logit_error`` reads the logits ``generate`` returned, each
position's distance from the reference's over the reference's norm; the
driver keeps them only in a cell that compares it.

A mixture's routing is discrete: where two experts' probabilities nearly
tie, bf16 and fp32 choose differently, and over 27 layers those choices
part the two runs' states.  A cell that compares ``routing_gap`` samples
whole calls, and after the window runs each sampled call's prompts once
more through the same engine with the program's expert choices recorded
(a wrapper of ``repro_torch.models.moe.top_k``, which keeps them on the
card as uint8); the timed calls run unwrapped.  The reference follows
those choices: it computes its own router probabilities, gates,
capacities and drops, and ``routing_gap`` reads by how far (in
log-probability) a choice of the program lies below the reference's own
k-th choice.  ``rerun_mismatch`` counts the sampled requests whose token
in that second run differs from the one the window served: the calls are
greedy, so a sound program serves the same token again.
"""

from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from bench import harness
from bench.reference import check, data


def mix32(*words: int) -> int:
    """The engine's per-slot and per-step stream seeds: each word folded
    in with a murmur3 finaliser, 32-bit."""
    h = 0x9E3779B9
    for w in words:
        h = (h ^ (int(w) & 0xFFFFFFFF)) & 0xFFFFFFFF
        h = (h * 0x85EBCA6B) & 0xFFFFFFFF
        h ^= h >> 13
        h = (h * 0xC2B2AE35) & 0xFFFFFFFF
        h ^= h >> 16
    return h


def gumbel(engine_seed: int, prompt: np.ndarray, slot: int, steps: int,
           vocab: int) -> np.ndarray:
    """(steps, vocab) fp32 Gumbel noise of the request in ``slot`` with
    ``prompt``: −log(−log(max(u, 1e-12))) of the xoshiro128+ uniforms of
    stream mix32(mix32(seed, slot, crc32(prompt)), step)."""
    row = np.ascontiguousarray(prompt, dtype=np.int32)
    s = mix32(engine_seed, slot, zlib.crc32(row.tobytes()))
    out = np.empty((steps, vocab), dtype=np.float32)
    for i in range(steps):
        u = np.maximum(data.uniform(mix32(s, i), vocab), np.float32(1e-12))
        out[i] = -np.log(-np.log(u))
    return out


class Run:
    def __init__(self, ctx: harness.Context):
        self.ctx = ctx
        t = ctx.traffic
        self.B, self.P, self.N = t["batch"], t["prompt"], t["new_tokens"]
        self.temperature = float(t["temperature"])
        self.max_len = self.P + self.N + 1
        self.engine_seed = ctx.seed & 0xFFFFFFFF
        limits = ctx.cell["check"]["limits"]
        self.keep_logits = "logit_error" in limits
        self.follow = "routing_gap" in limits
        if self.follow and self.temperature > 0:
            raise NotImplementedError(
                "a cell that follows the program's routes runs its calls "
                "again, which serves the same tokens only when greedy")
        self.phases: dict[str, float] = {}     # set-up's parts, seconds
        self.sample = None            # (unit, row) pairs the check compares
        self.routes: dict = {}        # prompt set -> per mixture layer
        self.rerun_mismatch = 0
        m = ctx.model
        if m.moe is not None and (self.N > 1 or not ctx.ref.per_row_groups(
                m, self.B, self.P)):
            raise NotImplementedError(
                "the reference routes each served request as its own group: "
                "a mixture decoding more than one token, or whose batch "
                "routes as one group, needs a reference of its own")

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.models.model import working_dtype
        from repro_torch.serve.engine import ServeEngine
        ctx = self.ctx
        t0 = time.perf_counter()
        cfg = harness.program_config(ctx.config)
        dt = getattr(torch, cfg.dtype)
        params = harness.program_model(
            cfg, ctx.specs, ctx.seed, dt,
            lambda n: working_dtype(cfg, n, 1), ctx.device)
        self.engine = ServeEngine(cfg, params, max_len=self.max_len,
                                  batch=self.B, temperature=self.temperature,
                                  seed=self.engine_seed, device=ctx.device)
        g = torch.Generator(device=ctx.device).manual_seed(
            harness.sub_seed(ctx.seed, 1))
        self.prompts = torch.randint(
            0, ctx.model.vocab_size,
            (ctx.traffic["prompt_sets"], self.B, self.P), generator=g,
            device=ctx.device, dtype=torch.int32).cpu().numpy()
        harness.sync(ctx.device)
        t1 = time.perf_counter()
        self.phases["program and weights"] = t1 - t0
        # the cache is max_len long whatever a call decodes, so the
        # warm-up's few tokens run every shape the window's calls run
        for _ in range(ctx.traffic["warmup_calls"]):
            self.engine.generate(self.prompts[-1],
                                 ctx.traffic["warmup_new_tokens"])
        harness.sync(ctx.device)
        self.phases["warm-up"] = time.perf_counter() - t1

    # -- the window ---------------------------------------------------------

    def unit(self) -> dict:
        k = len(harness.all_units(self.ctx))
        prompts = self.prompts[k % len(self.prompts)]
        t0 = time.perf_counter()
        res = self.engine.generate(prompts, self.N)
        seconds = time.perf_counter() - t0
        return {"seconds": seconds, "requests": self.B,
                "logits": res.logits if self.keep_logits else None,
                "tokens": self.B * self.N, "prefill_s": res.prefill_s,
                "decode_s": res.decode_s, "decode_steps": self.N - 1,
                "prompt_set": k % len(self.prompts),
                "served": res.tokens[:, self.P:].copy(),
                "forwards": [("prefill", self.B, self.P, self.max_len)]
                + [("decode", self.B, self.P + i, self.max_len)
                   for i in range(self.N - 1)]}

    def after_window(self) -> None:
        """Draw the requests the check compares; where the cell follows
        the program's routes, run each sampled call's prompts again with
        its expert choices recorded."""
        ctx = self.ctx
        n = ctx.cell["check"]["requests"]
        if not self.follow:
            self.sample = harness.sample_units(ctx, n)
            return
        done = harness.all_units(ctx)
        units = harness.sample_whole_units(ctx, -(-n // self.B))
        self.sample = [(u, r) for u in units for r in range(self.B)][:n]
        from repro_torch.models import moe
        top_k = moe.top_k
        n_moe = sum(ctx.model.is_moe(i) for i in range(ctx.model.n_layers))
        for ps in sorted({done[u]["prompt_set"] for u in units}):
            made = []

            def recording(probs, k):
                vals, idx = top_k(probs, k)
                made.append(idx.to(torch.uint8))
                return vals, idx
            moe.top_k = recording
            try:
                res = self.engine.generate(self.prompts[ps], self.N)
            finally:
                moe.top_k = top_k
            if len(made) != n_moe:
                raise RuntimeError(
                    f"a call made {len(made)} calls of "
                    f"repro_torch.models.moe.top_k, the configuration has "
                    f"{n_moe} mixture layers: the recording of the "
                    f"program's expert choices no longer fits the program")
            self.routes[ps] = made
            again = res.tokens[:, self.P:]
            self.rerun_mismatch += sum(
                int(not np.array_equal(again[r], done[u]["served"][r]))
                for u, r in self.sample if done[u]["prompt_set"] == ps)

    def free(self) -> None:
        self.engine = None

    # -- the check ----------------------------------------------------------

    def _requests(self):
        done = harness.all_units(self.ctx)
        for u, r in self.sample:
            rec = done[u]
            prompt = self.prompts[rec["prompt_set"]][r]
            logits = rec["logits"][r] if self.keep_logits else None
            routes = ([c[r] for c in self.routes[rec["prompt_set"]]]
                      if self.follow else None)
            yield prompt, r, rec["served"][r], logits, routes

    def check(self, control: str | None = None) -> dict[str, float]:
        """``served_gap`` and, where kept, ``logit_error`` over the sampled
        requests; with ``control`` (a precision) also ``control_gap`` (the
        gap of the tokens that the reference at that precision puts first)
        and ``control_logit_error``."""
        ctx = self.ctx
        m = ctx.model
        harness.reference_mode()
        reqs = list(self._requests())
        dev = ctx.device
        tokens = torch.as_tensor(np.stack(
            [np.concatenate([p, s[:-1]]) for p, _, s, _, _ in reqs]),
            device=dev).long()
        positions = list(range(self.P - 1, self.P + self.N - 1))
        T = tokens.shape[1]
        rows = max(1, (1 << 31) // (m.n_heads * T * T * 4))
        w = harness.redraw(ctx, getattr(torch, ctx.config["model"]["dtype"]),
                           dev)
        moe_layers = [i for i in range(m.n_layers) if m.is_moe(i)]

        def followed(made):
            """The reference following the choices ``made`` (per mixture
            layer, a (R, T, k) tensor), and its routes' record."""
            routes = ctx.ref.Routes(dict(zip(moe_layers, made)))
            return ctx.ref.serve_logits(m, w, tokens, positions,
                                        rows_at_once=rows,
                                        routes=routes), routes

        if self.follow:
            ref, routes = followed([torch.stack([q[4][i] for q in reqs])
                                    for i in range(len(moe_layers))])
        else:
            ref, routes = ctx.ref.serve_logits(
                m, w, tokens, positions, rows_at_once=rows), None
        low = low_ref = low_routes = None
        if control:
            made = ctx.ref.Routes() if self.follow else None
            low = ctx.ref.serve_logits(m, w, tokens, positions,
                                       ctx.ref.Precision(control), rows,
                                       routes=made)
            low_ref = ref
            if self.follow:
                low_ref, low_routes = followed(
                    [torch.cat(made.made[i]) for i in moe_layers])
        gaps, cgaps, errs, cerrs = [], [], [], []
        for i, (prompt, slot, served, logits, _) in enumerate(reqs):
            if logits is not None:
                errs.append(check.logit_error(logits.to(dev), ref[i]))
            if low is not None:
                cerrs.append(check.logit_error(low[i], low_ref[i]))
            score = ref[i]
            if self.temperature > 0:
                noise = torch.as_tensor(gumbel(
                    self.engine_seed, prompt, slot, self.N, m.vocab_size),
                    device=dev)
                score = score + self.temperature * noise
            gaps.append(check.served_gap(
                score, torch.as_tensor(served, device=dev)))
            if low is not None:
                noise = score - ref[i]
                lscore = low[i] + noise
                cgaps.append(check.served_gap(low_ref[i] + noise,
                                              lscore.argmax(-1)))
        out = {"served_gap": max(gaps)}
        if errs:
            out["logit_error"] = max(errs)
        if routes is not None:
            out["routing_gap"] = max(routes.gaps)
            out["rerun_mismatch"] = float(self.rerun_mismatch)
        if control:
            out["control_gap"] = max(cgaps)
            out["control_logit_error"] = max(cerrs)
            if low_routes is not None:
                out["control_routing_gap"] = max(low_routes.gaps)
        return out
