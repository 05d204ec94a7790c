#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py
  python3 chip_smoke.py --phase 6     # build, then phase 6 alone
  python3 chip_smoke.py --phase 11    # build, then phase 11 alone
  python3 chip_smoke.py --phase 12    # build, then phase 12 alone
  python3 chip_smoke.py --phase 13    # build, then phase 13 alone
  python3 chip_smoke.py --phase 14    # build, then phase 14 alone

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line).  Every line printed also goes to
``chiprun_out/chip_smoke.log``:

1. The card's name and power limit (``nvidia-smi``), its SM count and
   maximum SM clock (from which the FP32 and INT32 rates follow), then
   the build of every CUDA kernel from ``src/repro_torch/csrc`` (nvcc into
   ``build/``).
2. Every kernel held against its plain PyTorch version on the card, at the
   shapes the serving path, the training path or the facade gives it, and at
   the edges of each kernel's paths; each case records the path it took.
   softmax at the edges of its three paths (warp per row, a thread block
   cluster per row, three sweeps) and at training's 131,072 x 2,048 scores,
   twice, bit-identical; uniform also at the token pipeline's 8,196; exp
   and logf at 16 M, a ragged tail, a misaligned view
   (their scalar kernels), exp also at the attention correction's 16 K values,
   logf also against fp64 on a 4097-point grid and outside its domain, through
   both kernels; Monte Carlo bit-exact for {pi, poly} x {lcg, xoshiro128p} and
   two seeds, through the wrapper at 256 samples per lane and through each
   path's launcher (the segment path at S 2, 8 and 32) at 0, 1, 7 and 257.  Each
   case is timed with CUDA events (median of 20 runs after warm-up; device time
   from CUDA-graph replays, plus the eager per-call time) beside its plain
   version, one PyTorch library call computing the same function where there is
   one, and its bound: the larger of bytes over 3.35 TB/s (H100 SXM HBM3) and
   instructions over the card's FP32 and INT32 dispatch rates.  Monte Carlo's
   instruction counts are read from its lane kernels' SASS (``cuobjdump``) and
   bound both paths; it gets two bounds of one lane beside the card's: its
   generator's dependent chain (latency) and its instructions at one per clock
   (dispatch).  Its 2**26-sample cases are held bit for bit against the plain
   version's timed call.  Two design sweeps run in the same phase: logf's three
   table gathers (``tools/logf_variants.py``, built beside the kernels) and
   every segment count S of Monte Carlo's segment path
   (``tools/mc_segments.py``).  Phase 7's shapes are among the cases:
   uniform at 10,485,760, exp at 32 M and 32 K, softmax at 32 x 8192.
   The tilings (``check_tilings``): exp, logf and uniform at 16 M and
   softmax at 8192 x 161 (warp path) at ``block_rows`` = default / 2,
   default and 2 x default (64 rows for the three, 8 for softmax): the
   default launch equal to the launch from before tilings (256 threads;
   exp's and logf's chunk 512 float4s), each launch counted at its plan's
   block size, each output bit for bit the default's; device ms and threads
   printed (``tiling:`` lines).
   The kernels' full entries go to ``chiprun_out/kernels.json``; a compact
   JSON line ``{"kernels": [...]}`` (each kernel's headline numbers and
   its launches in every phase) is printed at the end.
3. A reference check: the olmo-1b smoke model on the card (kernels) against
   the same parameters on the CPU (plain versions).
4. OLMo-1B at full width, random weights from a seeded ``torch.Generator``,
   bf16 compute, served through the port's entry points:
   (a) ``repro_torch.launch.serve.main``, batch 4, prompt 128, 32 new
       tokens, greedy, twice (the tokens must be identical);
   (b) the same at temperature 1.0, seed 3 (the uniform kernel's path);
   (c) ``ServeEngine(max_len=5120, batch=1)``, prompt 2048, 8 new tokens
       (prefill takes the chunked attention path, the exp kernel's).
   Every kernel's launch counter is set to 0 just before each request and
   read just after; softmax must launch in (a), uniform in (b), exp in (c).
   The per-path counters must show (a) and (b) on softmax's warp path,
   (c)'s decode on its cluster path and (c)'s prefill on exp's vector path.
   Every logit must be finite and every token inside the vocabulary.
5. The kernel facade: every spec of ``repro_torch.api`` with an entry point
   run through ``kernel(name).run`` under ``config(impl="cuda")`` at full
   size (Monte Carlo at 2**26 samples, n_blocks 8 and 1024), held against
   ``.ref`` or the plain version; the estimates within 0.002 of pi and 0.4.
   The counters are set to 0 before the phase and read after it: every
   kernel must have launched, logf on its vector path, Monte Carlo on its
   segment path at n_blocks 8 and its lane path at 1024.  The logf and
   Monte-Carlo launch counts (and counts by path) in the JSON line are this
   phase's, the others the serving phase's.
6. Training (``train_phase``), which prints its own wall time:
   (d) ``repro_torch.launch.train.main`` trains OLMo-1B at full width
       (bf16 compute, fp32 masters, ``remat="full"``), batch 4 × seq 2048,
       4 steps with a checkpoint every 2, then again with ``--steps 6``:
       the second run must print ``[resume] from step 4`` and record steps
       4 and 5 only.  Every loss and grad norm must be finite; uniform must
       launch in the token pipeline and softmax on its cluster path only.
   (e) one train step at batch 1 × seq 4096, the chunked attention path:
       exp must launch on its vector path; loss and grad norm finite.
   (f) one step of one full-width state and batch with the kernels
       (``softmax_impl="cuda"``) against one with the plain versions
       (``"reference"``): loss to rtol 1e-4, grad norm to rtol 1e-3; then
       one more step with the kernels under torch.profiler (its device-busy
       share and the kernels that take the most device time).  The
       softmax and exp ``autograd.Function``s' input gradients at the
       training shapes (softmax 131,072 × 2,048 fp32, causal mask; exp 16 M)
       against autograd through their plain versions, in row slices, to
       rtol 1e-5 / atol 1e-6.
   (g) the olmo-1b smoke model trains 3 steps on the card and on the CPU
       from the same state; the batches must be identical and the losses
       agree to rtol 1e-4.
   Launch counters are set to 0 just before each main-path run and read
   just after; they include the remat recompute, which launches each
   period's softmax (or exp) a second time.  Printed, not gated: ms per
   step (host clock ending in ``torch.cuda.synchronize``, median of the
   steps after the first), tokens/s, peak ``torch.cuda.max_memory_allocated``
   and launches per step of each kernel and path.
7. The MoE, Mamba, RWKV-6 and audio families (``families_phase``), each
   model freed before the next, random bf16 weights from a seeded
   ``torch.Generator`` on the card; prints each path's and the phase's
   wall time:
   (h) DeepSeekMoE-16B at full width and depth through
       ``launch.serve.main``, batch 4, prompt 128, 32 tokens, greedy twice
       (identical tokens), then at temperature 1.0, seed 3: softmax on its
       warp path only, uniform in the sampled run only; decode ms/token
       beside the bound of reading every weight once a step;
   (i) one full-width Jamba period (8 of its 32 layers, as one card holds
       it): ``ServeEngine(max_len=8192, batch=1)``, prompt 7168, 8 greedy
       tokens: exactly 50 exp launches on the vector path (25 query-block
       x KV-chunk pairs: the 4096 window skips 3 of the causal 28) and 7
       decode softmaxes on the cluster path (32 x 8192);
   (j) RWKV-6 1.6B at full width through ``launch.serve.main``, sampled:
       uniform once a slot and token, no softmax, no exp;
   (k) HuBERT-XLarge at full width trains 3 steps through
       ``launch.train.main`` (batch 4 x seq 2048, remat full): uniform 3 a
       step, one of them the 10,485,760 frame-embedding values; softmax 96
       a step on the cluster path (non-causal 131,072 x 2,048); exp 0;
       finite losses; ms/step, tokens/s, peak memory;
   (l) the smoke model of deepseek-moe, grok-1, jamba, rwkv6 and hubert on
       the card against the CPU: logits rtol 1e-4; jamba and rwkv6 also
       served as phase 3 serves olmo (prefill + 11 decode steps, greedy
       and sampled, identical tokens); deepseek and jamba train 3 steps as
       (g) trains olmo (one state, identical batches, losses rtol 1e-4).
   The JSON line's ``launches_families`` are this phase's.
8. The analytic model (``analytic_phase``), which prints one ``analytic:``
   JSON line with its host wall times beside the card's name and power limit:
   (a) ``check_counts`` and, for Table I's six kernels, ``evaluate_kernel``
       and ``evaluate_energy``: the geomean speedup, peak speedup and IPC,
       geomean IPC gain, geomean and max power ratio, geomean and peak
       energy saving, each within the JAX package's tolerance of
       ``core.analytics.PAPER_HEADLINE`` (rel 0.04 / 0.05; abs 0.04, 0.05,
       0.06 on the power and energy aggregates), expf the peak of both;
   (b) ``api.evaluate`` of every simulatable spec on ``Target()`` and an
       8-core homogeneous target from cleared caches and again warm (equal
       Reports), and the 1-core Report equal to the single-PE numbers;
   (c) ``kernels.expf.exp_phase_plan`` over 262,144 fp32 values on the
       card (block 292, the Table-I rule): ``core.copift.execute``
       pipelined and serial each equal ``exp_plain`` bit for bit and the
       CUDA exp kernel (``ops.exp``, counted from 0) within rtol 2e-6;
   (d) ``analyze(exp_plain, x)`` on the card's tensor equals the CPU's.
   The JSON line's ``launches_analytic`` (exp) is (c)'s count.
9. The tuner (``tune_phase``), with the port's tune cache in a temporary
   directory; prints its wall time:
   (a) ``Tuner(Target.homogeneous(power_cap_mw=250))``: ``plan``, ``block``
       and ``operating_point(heterogeneous=True, per_island_blocks=True)``
       of the five workloads from an empty cache, then warm (equal
       results; host wall times printed); ``kernels.ops._tuned_block_rows``
       gives the JAX package's 64, 32, 32, 8 (expf, logf, prng, softmax);
   (b) ``measure_candidates`` on the card for the five workloads at the 5
       blocks of ``block_ladder(w.max_block)``: a finite time for every
       candidate, the block size each launched, every output equal to the
       default tiling's (Monte Carlo's to the plain version at the same
       ``n_blocks``); then ``tune(w, measure_top_k=3)`` for softmax and
       expf;
   (c) OLMo-1B at full width with phase 4's parameters and prompts, batch
       4, prompt 128, 32 tokens, greedy and sampled: ``ServeEngine``
       without and with ``autotune=True, power_cap_mw=250``; identical
       tokens (greedy also phase 4 (a)'s); the tuned runs launch uniform at
       128 threads and softmax's warp path at 8 rows a block;
       ``operating_plan`` printed; ``close()`` restores the setting; decode
       ms per token with and without, beside the card's name and power
       limit (no claim made);
   (d) ``launch.train.main`` on the olmo-1b smoke model on the card, 3
       steps, without and with ``--autotune``: bit-equal losses.
   The JSON line's ``launches_tuned_serving`` and
   ``tiling_launches_tuned_serving`` are (c)'s tuned runs'.
10. The rest of ``obs`` and the manycore model (``obs_system_phase``), with
    the port's tune cache in a temporary directory; prints its wall time:
    (a) ``python -m repro_torch.obs.trace`` for expf and softmax (8 cores,
        ``--json --out``): exit 0, both documents parse, expf reconciles
        with 60 checks; ``Tuner(Target.homogeneous(power_cap_mw=250))
        .attribute`` of expf and softmax exact, deltas -2 and -4 cycles; a
        history store with one ``*cycles*`` metric raised 50 % fails
        ``python -m repro_torch.obs.history --check`` (exit 1);
        ``obs.report.save_report`` writes the trace, the attribution and
        the history into one HTML file;
    (b) every simulatable spec on a 1-cluster ``Target.system`` equals
        ``Target.homogeneous()``; expf's speedup on 4 clusters is the JAX
        package's; expf's weak and strong scaling and the cluster roofline
        printed;
    (c) OLMo-1B at full width with phase 4's parameters and prompts, batch
        4, prompt 128, 32 tokens, greedy and sampled, served by
        ``ServeEngine(autotune=True, power_cap_mw=1000, system=4 Snitch
        clusters)`` inside ``obs.session(trace=True, metrics=True)``:
        tokens equal phase 4 (a)'s (greedy) and phase 9's tuned engine's
        (sampled); ``system_plan`` one cluster with the JAX package's power
        and time; the ``serve.plan.system.*`` gauges and
        ``serve.autotune.wall_s`` in the session's metrics, the
        ``serve.autotune`` span in its saved Chrome trace; softmax on its
        warp path at 8 rows a block, uniform at 128 threads; ``close()``
        restores the tuned defaults.
   The JSON line's ``launches_system_serving`` and
   ``tiling_launches_system_serving`` are (c)'s.
11. The serving simulator, resilience, ``remat="dots"`` and int8 gradient
    compression (``sim_resilience_phase``); prints its wall time:
    (a) the JAX package's ``benchmarks/serve_bench.py`` scenario through
        ``repro_torch.serve`` on the host (bursty trace, 2400 ms, seed 11;
        SLO p99 10 ms, epoch 10 ms, queue cap 256; static, reactive and
        mpc): static misses the SLO, mpc meets it at no more energy, a
        second mpc run is ``==``, every policy's p50, p99 and energy are
        the JAX package's (Snitch-model ms and µJ, not card time);
    (b) the ``benchmarks/resilience_bench.py`` scenario (Poisson 1500
        rps, 200 ms, three core deaths, retry 3 / 25 ms / x2 / 0.5 ms,
        one slot of headroom): failover completes 288 of 288 with 0 SLO
        violations against naive's 283 and 13, a replay is ``==``, an
        empty ``FaultTrace`` leaves (a)'s static report ``==``; then
        ``api.evaluate(faults=...)`` of expf on ``Target()`` and
        ``Target.system("2x8c,hbm=256")``: a core death and a throttle
        window each slower than fault-free, an HBM window slower on the
        system and the identity on the cluster (no HBM port in the
        cluster model), the empty trace ``==``, every core dead raises
        ``AllCoresDeadError``;
    (c) OLMo-1B at full width (batch 4 x seq 2048, fp32 masters, bf16
        compute, seeded parameters, the token pipeline's batches), 3
        ``make_train_step`` steps each under ``remat="full"``,
        ``remat="dots"`` and ``"dots"`` with ``compress_pod_grads=True``:
        finite values; ``dots``' losses and grad norms equal ``full``'s
        (loss rtol 1e-4, grad norm 1e-3; whether bit-equal is printed);
        the compressed run's first loss equals the uncompressed one's;
        softmax 32 launches a step on its cluster path under both remat
        modes (the recompute launches it again).  ms/step, tokens/s and
        peak ``torch.cuda.max_memory_allocated`` of each are printed
        beside the card's name and power limit.
   The JSON line's ``launches_remat_dots`` (softmax, exp, uniform) are
   (c)'s ``dots`` run's.
12. The sharding rule table on DTensor (``sharding_phase``):
    (a) a one-process NCCL group (TCP on a free local port) and a (1, 1)
        ("data", "model") mesh; OLMo-1B at full width, batch 4 x seq 2048,
        ``remat="full"``, 3 steps unsharded (``make_train_step``) and 3
        through ``launch.dryrun._step_and_specs`` with every state tensor
        and batch placed by the rule table as DTensors, from the same
        seed: losses and grad norms equal (rtol 1e-4; whether bit-equal
        is printed), softmax 32 launches a step on its cluster path and
        uniform 2, through the DTensor route (each kernel on the local
        shard); ms a step and peak memory of both, and the collectives
        of one more sharded step (``launch.comm_analysis``);
    (c) on the same mesh, ``compressed_psum`` bit-equal to
        ``quantize_dequantize`` over one rank, and ``elastic_restore``
        onto the mesh reproducing a saved olmo-1b smoke state;
    (b) then, the NCCL group destroyed, the dry-run's fake world on the
        card's host: ``run_cell`` of olmo-1b x train_4k x pod and
        deepseek-moe-16b x decode_32k x multipod, the records printed
        with their wall time.
    The JSON line's ``launches_sharded`` (softmax, exp, uniform) are (a)'s
    sharded run's.
13. The sharded path of the MoE and SSM families (``placed_phase``), on a
    (1, 1) NCCL mesh as in phase 12, each model freed before the next:
    (a) DeepSeekMoE-16B at full width and depth, batch 4, prompt 128, 8
        greedy tokens: ``ServeEngine.generate`` unsharded (its decode
        attention on the einsum path that DTensors take,
        ``attention._scores_pv``, not the decode kernels), then the same
        loop through ``_step_and_specs``' decode placement (parameters and
        cache placed by the rule table, the engine's sampler on the
        gathered logits): identical tokens, the same launches, softmax on
        its warp path only and every softmax call on the DTensor route
        (``kernels._build.on_local`` given a DTensor);
    (b) DeepSeekMoE-16B at full width cut to 2 layers (dense, then MoE),
        batch 4 x seq 2048, ``remat="full"``, 3 steps unsharded and 3
        through the placements: losses and grad norms bit-equal, the MoE
        layer through the batched per-row dispatch (``moe._dispatch_rows``,
        twice a step: forward and recompute), softmax 3 and uniform 2
        launches a step; ms a step and peak memory of both;
    (c) RWKV-6 1.6B at full width and depth, batch 4, prompt 128, 8 tokens
        sampled at temperature 1, as (a): identical tokens, uniform once a
        slot and token;
    (d) then, the NCCL group destroyed, ``DRYRUN_HOST_CELLS`` of the
        dry-run in its fake world on the card's host, each record printed
        with its wall time and torch version (deepseek-moe-16b x train_4k
        x pod and x decode_32k x multipod with their per-op views: the
        collectives and FLOPs by source line, and the placement changes
        of (B, ...) tensors on "data" other than a shard moving between
        dimensions, none expected in the train cell); then Jamba's smoke
        config in jamba-v0.1-52b x train_4k x pod's layout, TP and FSDP
        (the rule table's thresholds at 0), with its per-op view: its
        FLOPs and collective bytes are printed, and it fails if Mamba's
        mixer gathers more than a weight over a mesh axis, moves a
        (B, T, di) or (B, T, 2·di) tensor to ``Replicate`` over "model",
        runs its fused ``in_proj`` product or the product's backward on
        more than 1/16 of a data rank's rows and columns on a rank, or
        runs a product's backward on more than twice the forward
        product's FLOPs (its two gradients); such sites elsewhere in the
        model are printed (``backward_over_forward``);
    (e) before (d), on the NCCL mesh: one full-width Jamba period (8
        layers, 7 of them Mamba) at batch 4, prompt 128, 8 greedy tokens,
        as (a): identical tokens and launches, every Mamba layer's
        ``in_proj`` through ``ssm._halves`` (its columns placed over
        "model", the weight's all-to-all and its inverse on NCCL) at each
        step, ``_halves`` called 7 times a step.
    The JSON line's ``launches_sharded_moe`` (softmax, exp, uniform) are
    (b)'s sharded run's.
14. Decode attention (``decode_phase``), OLMo-1B's 16 KV heads of 128:
    (a) at olmo-1b.decode's shape (batch 128, 1,153 cache slots, position
        1,088) and at batch 4 (161 slots, position 144), ``decode_scores``
        and ``decode_pv`` against fp64 on the kept slots (scores within
        1e-5, the PV product within 1 bf16 ulp, or 1e-6, of the fp64 sum
        rounded to bf16; the plain versions' errors printed beside), the
        softmax exactly 0 past the position, each timed (device ms from
        CUDA-graph replays, and the eager call) beside its plain version
        and its bound, the bytes it must move at 3.35 TB/s; the kernels'
        chain (``attention._decode``) beside the einsum path it replaces
        (``attention._scores_pv``), softmax included in both;
    (b) OLMo-1B at full width served as phase 4 (a), 8 tokens: each kernel
        launches once a layer and decode step, never in the prefill.
    The numbers also go to ``chiprun_out/decode_attn.json``.
15. The last line: ``{"ok": true, "device": {...}}``.

Phase 2 also times an empty kernel at the uniform kernel's grids
(``tools/launch_floor.py``, built beside the kernels): the card's floor
for one launch.  fp32 matmuls and convolutions are pinned to full fp32
(TF32 off).
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
#: Lanes per SM: an H100 SM has four schedulers, each issuing one warp
#: instruction per clock, over 128 FP32 lanes and 64 INT32 lanes.  An INT32
#: warp instruction holds its pipe for two clocks; FP32 and INT32
#: instructions from the same scheduler overlap in their pipes, as the
#: paper's integer and FP threads do, but share its one dispatch slot per
#: clock.
FP32_LANES_PER_SM = 128
INT32_LANES_PER_SM = 64
#: Latency between dependent integer ALU instructions (IADD3, LOP3, SHF,
#: IMAD) on Hopper, in clocks: an assumption for the latency bound, not a
#: measurement.
ALU_LATENCY_CLOCKS = 4

# Instructions per element, counted from the kernels' sources: (all
# instructions, those of them that only the integer pipe executes: shifts,
# logic, integer adds).  Multiplies and multiply-adds of integers
# (IMAD) and int-to-float conversions may go to the FP32 pipe, so they
# count only in the first.  These three kernels are bound by bytes with a
# wide margin; Monte Carlo's counts, which decide its bound, are read from
# the built kernel's SASS instead (``mc_sass_counts``).
#: COPIFT exp: z, rint, two Cody-Waite multiply-adds, clamp (2), the float
#: to int conversion, seven Horner multiply-adds, the scale multiply, two
#: compare-selects (4); add and shift for the scale bits (integer pipe).
EXP_OPS = (20, 2)
#: Softmax: one exp with its subtraction, the max, the sum, an IEEE
#: division (a reciprocal and three fix-up multiply-adds).
SOFTMAX_OPS = (EXP_OPS[0] + 1 + 2 + 4, EXP_OPS[1])
#: Uniform: counter add, splitmix32 (add, three shift-xor pairs on the
#: integer pipe, two multiplies), the generator step, shift, conversion;
#: one scale multiply.
UNIFORM_OPS = {"lcg": (16, 10), "xoshiro128p": (24, 16)}
#: logf: the x <= 0 compare-select (2), r = z*invc - 1, three Horner steps
#: and the multiply by r, + logc, the exponent's conversion and k*ln2, two
#: table loads; the integer phase: re-bias, index shift and mask, exponent
#: shift, mantissa mask and subtraction (integer pipe).
LOG_OPS = (18, 6)
#: Dependent integer instructions per generator step on the path from one
#: state to the next: the LCG's multiply-add; xoshiro128+'s shift then
#: three-input xor (s2), or xor then rotate (s3).
MC_CHAIN = {"lcg": 1, "xoshiro128p": 2}
#: Opcodes that only the integer pipe executes, and the loop's own control
#: (the branch, its compare, the uniform datapath), left out of the count.
INT_PIPE_OPS = ("LOP3", "SHF", "IADD3")
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*);")


def mc_sass_counts(library: Path) -> dict[tuple[str, str],
                                          tuple[float, float]]:
    """(all, integer-pipe) instructions per sample in the loop of each
    Monte-Carlo kernel, read from the SASS of the built ``library``
    (``cuobjdump -sass``).  A loop iteration's samples are its int-to-float
    conversions over 2 (one per draw)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"mc_kernelILb([01])ENS_\d+(Lcg|Xoshiro128p)", fn)
        if not m:
            continue
        key = ("pi" if m.group(1) == "1" else "poly",
               "lcg" if m.group(2) == "Lcg" else "xoshiro128p")
        ins = [(int(a, 16), op.split(".")[0], args)
               for a, op, args in _SASS_LINE.findall(fn)]
        loops = [(int(t.group(1), 16), a) for a, op, args in ins
                 if op == "BRA" and (t := re.search(r"0x([0-9a-f]+)", args))
                 and int(t.group(1), 16) < a]
        if not loops:
            _fail(f"montecarlo SASS: no loop in {key}")
        lo, hi = max(loops, key=lambda loop: loop[1] - loop[0])
        body = [op for a, op, _ in ins if lo <= a <= hi
                and op not in ("BRA", "ISETP") and not op.startswith("U")]
        samples = body.count("I2FP") / 2
        if not samples:
            _fail(f"montecarlo SASS: no conversion in the loop of {key}")
        counts[key] = (len(body) / samples,
                       sum(op in INT_PIPE_OPS for op in body) / samples)
    if len(counts) != 4:
        _fail(f"montecarlo SASS: found the kernels {sorted(counts)}")
    return counts


class Card:
    """The card's rates, from its SM count (``torch``) and its maximum SM
    clock (``nvidia-smi``)."""

    def __init__(self, torch, smi):
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        mhz = smi("clocks.max.sm", units=False)
        self.clock_hz = float(mhz) * 1e6
        self.fp32_per_s = self.sms * FP32_LANES_PER_SM * self.clock_hz
        self.int32_per_s = self.sms * INT32_LANES_PER_SM * self.clock_hz

    def describe(self) -> str:
        return (f"rates: {self.sms} SMs at {self.clock_hz / 1e6:.0f} MHz: "
                f"fp32 {self.fp32_per_s:.4g} instructions/s "
                f"({2 * self.fp32_per_s:.4g} FLOP/s with a multiply-add as "
                f"2), int32 {self.int32_per_s:.4g} instructions/s, "
                f"device memory {HBM_BYTES_PER_S:.4g} B/s")

    def bound(self, nbytes: float,
              ops: tuple[float, float]) -> tuple[float, str]:
        """The least time for ``nbytes`` of device memory and ``ops`` = (all
        instructions, integer-pipe instructions), in ms, and what binds it.
        Every instruction takes one of the four dispatch slots per SM and
        clock (a warp instruction each, 128 lanes: the FP32 rate); the
        integer-pipe ones also take the INT32 lanes (64 per SM)."""
        total, int_pipe = ops
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(total / self.fp32_per_s,
                    int_pipe / self.int32_per_s) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def latency_ms(self, steps: float, chain: int) -> float:
        """The least time of ``steps`` sequential generator steps, each a
        chain of ``chain`` dependent integer instructions."""
        return steps * chain * ALU_LATENCY_CLOCKS / self.clock_hz * 1e3


def _smi(fields: str, units: bool = True) -> str:
    """``nvidia-smi --query-gpu=<fields>`` for the first card."""
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           f"--format={fmt}"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one eager call of ``fn`` between two CUDA events: the
    device time, or the host's launch cost where that is longer."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, per_graph: int = 10, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``per_graph`` calls captured in a
    CUDA graph, the graph replayed ``reps`` times between CUDA events
    (after a warm-up replay), the median divided by ``per_graph``.  The
    replay takes the host out, so a launch-bound call reads as what the
    card spends on it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return _call_ms(graph.replay, reps=reps, warmup=1) / per_graph


def _times(kernel, plain, library) -> dict:
    """``ms``, ``plain_ms`` and ``library_ms`` are device times per call
    (``_device_ms``); ``call_ms`` is the kernel's eager per-call time."""
    return dict(ms=_device_ms(kernel), plain_ms=_device_ms(plain),
                library_ms=None if library is None else _device_ms(library),
                call_ms=_call_ms(kernel))


def _bf16_ulp_err(got, want) -> float:
    """Largest |got - want| in units of one bf16 ulp of ``want``."""
    import torch
    g, w = got.float(), want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), (e - 8).to(torch.int32))
    err = (g - w).abs() / torch.where(w == 0, torch.ones_like(w), ulp)
    return float(torch.where(w == 0, (g != 0).float() * 1e9, err).max())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(torch, gen, card, variants_build,
                  floor_build) -> list[dict]:
    from repro_torch.kernels import expf, prng, softmax
    from repro_torch.models.attention import NEG_INF

    entries = []

    # --- softmax: attention scores with masked (NEG_INF) columns, and row 0
    # masked whole.
    cases = []
    f32, bf16 = torch.float32, torch.bfloat16
    for rows, cols, dt, what in [
            (8192, 161, f32, "prefill (a)"),
            (64, 161, f32, "decode (a)"),
            (16, 5120, f32, "decode (c)"),
            (64, 32768, f32, "long row"),
            (64, 161, bf16, "decode, bf16"),
            (64, 1024, f32, "widest row of the warp path"),
            (64, 1025, f32, "narrowest row of the cluster path"),
            (8191, 161, f32, "prefill shape, ragged last block"),
            (64, 32768, bf16, "long row, bf16"),
            (16, 5121, bf16, "cluster path, 4-byte loads, bf16"),
            (2, softmax.CLUSTER_MAX_COLS, f32,
             "widest row of the cluster path"),
            (2, 1 << 20, f32, "beyond the cluster path"),
            (4 * 16 * 2048, 2048, f32, "training scores (d), cluster k 1"),
            (32, 8192, f32, "Jamba decode (i), 32 heads x 8192")]:
        x = torch.randn(rows, cols, device="cuda", generator=gen) * 4
        x[:, cols // 2 + 1:] = NEG_INF
        x[0] = NEG_INF
        x = x.to(dt).contiguous()
        path = softmax.softmax_plan(rows, cols, dt).path
        before = dict(softmax.softmax_cuda.path_launches)
        got = softmax.softmax_cuda(x)
        again = softmax.softmax_cuda(x)
        want = softmax.softmax_plain(x)
        torch.cuda.synchronize()
        after = softmax.softmax_cuda.path_launches
        if {k: after[k] - before[k] for k in after} != {
                k: 2 * (k == path) for k in after}:
            _fail(f"softmax {what}: launches {before} -> {after}, expected "
                  f"two on the {path} path")
        if got.dtype != x.dtype:
            _fail(f"softmax {what}: dtype {got.dtype} != {x.dtype}")
        if not torch.equal(got, again):
            _fail(f"softmax {what}: two runs differ")
        if dt == torch.bfloat16:
            ulps = _bf16_ulp_err(got, want)
            if ulps > 1.0:
                _fail(f"softmax {what}: {ulps} bf16 ulps from the plain version")
        else:
            torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-7)
        nbytes = 2 * x.numel() * x.element_size()
        bound_ms, bound_by = card.bound(
            nbytes, [x.numel() * c for c in SOFTMAX_OPS])
        cases.append(dict(
            shape=[rows, cols], dtype=str(dt).removeprefix("torch."), what=what,
            path=path,
            max_abs_err=float((got.float() - want.float()).abs().max()),
            bound_ms=bound_ms, bound_by=bound_by,
            **_times(lambda: softmax.softmax_cuda(x),
                     lambda: softmax.softmax_plain(x),
                     lambda: torch.softmax(x, dim=-1))))
    entries.append(_entry("softmax", "src/repro_torch/csrc/softmax.cu",
                          "src/repro/kernels/softmax_tpu.py:44", cases, 1))

    # --- exp: one chunk of chunked attention, the extremes, a ragged tail,
    # a misaligned view and the attention correction's shape.
    ext = torch.tensor([-1e4, -87.5, 0.0, 88.9, 1e4, NEG_INF, float("-inf"),
                        float("inf"), float("nan")], device="cuda")
    for inp in (ext, torch.cat([ext[:1], ext])[1:]):   # aligned, misaligned
        got, want = expf.exp_cuda(inp), expf.exp_plain(inp)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-30,
                                   equal_nan=True)
        e = got.tolist()
        if e[0] != 0.0 or e[2] != 1.0 or e[4] != float("inf") or e[5] != 0.0:
            _fail(f"exp extremes: {e}")
    cases = []
    n16m = 16 * 1024 * 1024
    for n, offset, shape, what in [
            (n16m, 0, [1, 16, 1, 1024, 1024], "one KV chunk of prefill (c)"),
            (n16m + 3, 0, [n16m + 3], "16 M + 3: a tail of 3"),
            (n16m, 1, [n16m], "16 M, a view at a 4-byte offset"),
            (16384, 0, [1, 16, 1, 1024], "the correction of prefill (c)"),
            (2 * n16m, 0, [1, 8, 4, 1024, 1024],
             "one KV chunk of Jamba's prefill (i)"),
            (32768, 0, [1, 8, 4, 1024], "the correction of prefill (i)")]:
        buf = torch.empty(n + offset, device="cuda").uniform_(-90.0, 2.0,
                                                              generator=gen)
        buf[::97] = NEG_INF
        x = buf[offset:]
        before = dict(expf.exp_cuda.path_launches)
        got, want = expf.exp_cuda(x), expf.exp_plain(x)
        torch.cuda.synchronize()
        path = expf.exp_plan(n, x.data_ptr(), got.data_ptr()).path
        after = expf.exp_cuda.path_launches
        if {k: after[k] - before[k] for k in after} != {
                k: int(k == path) for k in after}:
            _fail(f"exp {what}: launches {before} -> {after}, expected one "
                  f"on the {path} path")
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-30)
        bound_ms, bound_by = card.bound(8 * n, [n * c for c in EXP_OPS])
        cases.append(dict(shape=shape, dtype="float32", what=what, path=path,
                          max_abs_err=float((got - want).abs().max()),
                          bound_ms=bound_ms, bound_by=bound_by,
                          **_times(lambda: expf.exp_cuda(x),
                                   lambda: expf.exp_plain(x),
                                   lambda: torch.exp(x))))
    entries.append(_entry("exp", "src/repro_torch/csrc/expf.cu",
                          "src/repro/kernels/expf.py:38", cases, 0))

    # --- uniform: bit-exact for both generators and the seed extremes.
    cases = []
    for n, what in [(50304, "one sampling draw, V = 50304"),
                    (1 << 24, "16 M values"),
                    (4 * 2049, "one token-pipeline draw, batch 4 x 2049"),
                    (4 * 2048 * 1280,
                     "HuBERT's frame embeddings (k), 4 x 2048 x 1280")]:
        for kind in ("xoshiro128p", "lcg"):
            for seed in (0, 2 ** 31 + 5, 2 ** 32 - 1):
                got = prng.uniform_cuda(seed, n, kind)
                want = prng.uniform_plain(seed, n, kind, "cuda")
                if not torch.equal(got, want):
                    _fail(f"uniform {kind} n={n} seed={seed}: not bit-exact")
            bound_ms, bound_by = card.bound(
                4 * n, [n * c for c in UNIFORM_OPS[kind]])
            cases.append(dict(
                shape=[n], dtype="float32", what=f"{what}, {kind}",
                max_abs_err=0.0,
                bound_ms=bound_ms, bound_by=bound_by,
                **_times(lambda: prng.uniform_cuda(seed, n, kind),
                         lambda: prng.uniform_plain(seed, n, kind, "cuda"),
                         None)))
    entry = _entry("uniform", "src/repro_torch/csrc/prng.cu",
                   "src/repro/kernels/prng.py:46", cases, 0)
    from tools import launch_floor
    entry["launch_floor"] = launch_floor.measure(floor_build)
    print("launch floor:", json.dumps(entry["launch_floor"]))
    entries.append(entry)
    entries.append(check_log(torch, gen, card, variants_build))
    entries.append(check_montecarlo(torch, card))
    tilings = check_tilings(torch, gen)
    for e in entries:
        if e["name"] in tilings:
            e["tilings"] = tilings[e["name"]]
    return entries


#: Phase 2's tiling cases: the shape each kernel is tiled at.
TILING_N = 16 * 1024 * 1024
TILING_SOFTMAX = (8192, 161)


def check_tilings(torch, gen) -> dict:
    """exp, logf and uniform at 16 M values and softmax at 8192 x 161 (the
    warp path), each at ``block_rows`` = default / 2, default and 2 x
    default: the launch geometry from the plan function (the default equal
    to the launch before tilings existed: 256 threads, exp's and logf's
    chunk 512 float4s), the tiling counter of the launch, each output bit
    for bit the default's, and the device ms.  Returns ``{kernel: cases}``."""
    from repro_torch.kernels import expf, logf, prng, softmax
    from repro_torch.models.attention import NEG_INF

    n = TILING_N
    x_exp = torch.empty(n, device="cuda").uniform_(-90.0, 2.0, generator=gen)
    x_exp[::97] = NEG_INF
    x_log = log_input(torch, gen)
    rows, cols = TILING_SOFTMAX
    x_sm = torch.randn(rows, cols, device="cuda", generator=gen) * 4
    x_sm[:, cols // 2 + 1:] = NEG_INF
    n4 = n // 4
    kernels = {
        "exp": (expf.exp_cuda, expf.DEFAULT_BLOCK_ROWS,
                lambda br: expf.exp_cuda(x_exp, br),
                lambda br: expf.exp_plan(n, x_exp.data_ptr(),
                                           x_exp.data_ptr(), br),
                expf.ExpPlan("vector", n4, 0, 256, -(-n4 // 512), 512)),
        "logf": (logf.log_cuda, logf.DEFAULT_BLOCK_ROWS,
                 lambda br: logf.log_cuda(x_log, br),
                 lambda br: logf.log_plan(n, x_log.data_ptr(),
                                            x_log.data_ptr(), br),
                 logf.LogPlan("vector", n4, 0, 256, -(-n4 // 512), 512)),
        "uniform": (prng.uniform_cuda, prng.DEFAULT_BLOCK_ROWS,
                    lambda br: prng.uniform_cuda(7, n, "xoshiro128p", "cuda",
                                                 br),
                    lambda br: prng.uniform_plan(n, br),
                    prng.UniformPlan(256, min(-(-n // 256), 132 * 16))),
        "softmax": (softmax.softmax_cuda, softmax.DEFAULT_BLOCK_ROWS,
                    lambda br: softmax.softmax_cuda(x_sm, br),
                    lambda br: softmax.softmax_plan(rows, cols,
                                                    torch.float32, br),
                    softmax.SoftmaxPlan("warp", grid=rows // 8, threads=256,
                                        per_lane=8, rows_per_block=8))}
    out = {}
    for name, (wrapper, default, run, plan, before) in kernels.items():
        if plan(None) != before or plan(default) != before:
            _fail(f"tiling {name}: the default launch {plan(None)} is not "
                  f"{before}")
        want = run(None)
        cases = []
        for br in (default // 2, default, 2 * default):
            geometry = plan(br)
            wrapper.tiling_launches.clear()
            got = run(br)
            torch.cuda.synchronize()
            key = (geometry.rows_per_block if name == "softmax"
                   else geometry.threads)
            if wrapper.tiling_launches != {key: 1}:
                _fail(f"tiling {name} block_rows={br}: launches "
                      f"{wrapper.tiling_launches}, expected one at {key}")
            if not torch.equal(got, want):
                _fail(f"tiling {name} block_rows={br}: output differs from "
                      "the default tiling's")
            cases.append(dict(block_rows=br, threads=geometry.threads,
                              grid=geometry.grid,
                              ms=_device_ms(lambda: run(br))))
        out[name] = cases
        print("tiling:", json.dumps(dict(
            kernel=name, shape=list(x_sm.shape) if name == "softmax" else [n],
            bit_equal_to_default=True, cases=cases)))
    return out


def log_input(torch, gen, n: int = 16 * 1024 * 1024, offset: int = 0):
    """n positive normals, log-uniform over 1e-30..1e30: a view ``offset``
    values into a fresh buffer (an offset of 1 is 4 bytes past 16-byte
    alignment)."""
    x = torch.empty(n + offset, device="cuda")
    x.uniform_(math.log(1e-30), math.log(1e30), generator=gen)
    return torch.exp(x)[offset:]


def _log_paths(torch, x, what):
    """log_cuda(x) with a check that it launched once, on the path
    ``log_plan`` gives; returns (result, path)."""
    from repro_torch.kernels import logf
    before = dict(logf.log_cuda.path_launches)
    got = logf.log_cuda(x)
    torch.cuda.synchronize()
    path = logf.log_plan(x.numel(), x.data_ptr(), got.data_ptr()).path
    after = logf.log_cuda.path_launches
    if {k: after[k] - before[k] for k in after} != {
            k: int(k == path) for k in after}:
        _fail(f"logf {what}: launches {before} -> {after}, expected one on "
              f"the {path} path")
    return got, path


def check_log(torch, gen, card, variants_build) -> dict:
    import numpy as np

    from repro_torch.kernels import logf

    # Accuracy against fp64 over the whole normal range of the tests, and
    # outside the domain (x <= 0 maps to 1; NaN and inf give the plain
    # version's finite values), through both kernels: an aligned copy takes
    # the vector kernel, a view at a 4-byte offset the scalar one.
    grid = np.logspace(-30, 30, 4097).astype(np.float32)
    odd = [-3.0, -0.0, 0.0, 1.0, 2.5, float("nan"), float("inf"),
           float("-inf")]
    for offset, path in ((0, "vector"), (1, "scalar")):
        for vals in (grid, np.array(odd, np.float32)):
            buf = torch.zeros(len(vals) + offset, device="cuda")
            buf[offset:] = torch.from_numpy(vals).cuda()
            got, took = _log_paths(torch, buf[offset:], f"{len(vals)} values")
            if took != path:
                _fail(f"logf: offset {offset} took the {took} path")
            if vals is grid:
                np.testing.assert_allclose(
                    got.cpu().numpy().astype(np.float64),
                    np.log(grid.astype(np.float64)), rtol=1e-5, atol=6e-7)
            torch.testing.assert_close(got, logf.log_plain(buf[offset:]),
                                       rtol=1e-5, atol=1e-6)
    cases = []
    n16m = 16 * 1024 * 1024
    for n, offset, what in [
            (n16m, 0, "16 M positive normals, log-uniform 1e-30..1e30"),
            (n16m + 3, 0, "16 M + 3: a tail of 3"),
            (n16m, 1, "16 M, a view at a 4-byte offset")]:
        x = log_input(torch, gen, n, offset)
        got, path = _log_paths(torch, x, what)
        want = logf.log_plain(x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        bound_ms, bound_by = card.bound(8 * n, [n * c for c in LOG_OPS])
        cases.append(dict(shape=[n], dtype="float32", what=what, path=path,
                          max_abs_err=float((got - want).abs().max()),
                          bound_ms=bound_ms, bound_by=bound_by,
                          **_times(lambda: logf.log_cuda(x),
                                   lambda: logf.log_plain(x),
                                   lambda: torch.log(x))))
    print("logf: within rtol 1e-5 / atol 1e-6 of its plain version at 16 M, "
          "16 M + 3 and a misaligned 16 M view, and outside the domain; "
          "within rtol 1e-5 / atol 6e-7 of fp64 log on logspace(-30, 30, "
          "4097); through the vector and the scalar kernel")
    from tools import logf_variants
    gathers = logf_variants.measure(variants_build, log_input(torch, gen))
    print("logf gathers:", json.dumps(gathers))
    entry = _entry("logf", "src/repro_torch/csrc/logf.cu",
                   "src/repro/kernels/logf.py:34", cases, 0)
    entry["gather_variants_ms"] = gathers["ms"]
    return entry


MC_SAMPLES = 1 << 26


def check_montecarlo(torch, card) -> dict:
    from repro_torch.kernels import montecarlo as mc
    from tools import mc_segments

    variants = [(p, k) for p in ("pi", "poly") for k in ("lcg", "xoshiro128p")]
    # Bit-exact against the plain version at n_blocks 8: the wrapper at
    # iters 256 (mc_plan's S = 2), and each path through its launcher, the
    # lane kernel and the segment kernel with an explicit S, at iters 0, 1,
    # 7 (empty segments) and 257 (ragged ones).
    for problem, kind in variants:
        for seed in (0, 2 ** 32 - 1):
            kw = dict(kind=kind, problem=problem, iters=256, n_blocks=8)
            got = mc.mc_partial_sums_cuda(seed, **kw)
            want = mc.mc_blocked_plain(seed, device="cuda", **kw)
            if not torch.equal(got, want):
                _fail(f"montecarlo {problem} {kind} seed={seed}: partial "
                      "sums not bit-exact")
            for iters in (0, 1, 7, 257):
                kw = dict(kind=kind, problem=problem, iters=iters, n_blocks=8)
                want = mc.mc_blocked_plain(seed, device="cuda", **kw)
                runs = {"lane": mc_segments.run_lanes(seed, **kw)}
                for segments in (2, 8, 32):
                    runs[f"S {segments}"] = mc_segments.run_segments(
                        seed, segments=segments, **kw)
                for what, got in runs.items():
                    if not torch.equal(got, want):
                        _fail(f"montecarlo {what} {kw} seed={seed}: not "
                              "bit-exact")
    print("montecarlo: partial sums bit-exact against the plain version for "
          "{pi, poly} x {lcg, xoshiro128p}, seeds 0 and 2**32-1, n_blocks 8: "
          "the wrapper at iters 256, the lane path and the segment path "
          "(S 2, 8 and 32) at iters 0, 1, 7 and 257")
    # Timed at full size: 2**26 samples, the facade's default n_blocks = 8
    # (the segment path) and n_blocks = 1024 (the lane path, the card
    # full).  The plain version takes one Python step per sample, so it is
    # timed as one eager call; the kernel's result is held bit for bit
    # against that call's.  The bound is the work of 2**26 samples at the
    # lane kernel's instructions per sample (its SASS), whichever path
    # runs.  Beside it, two bounds of one lane of the lane path, which runs
    # its samples in order: the dependent chain of its generator (latency)
    # and its instructions at one per clock (dispatch).
    from repro_torch.kernels import _build
    sass = mc_sass_counts(_build.library_path("montecarlo"))
    print("montecarlo: instructions per sample in the lane kernels' loops "
          "(SASS; all, integer pipe):", json.dumps({f"{p} {k}": v for (p, k), v
                                                    in sorted(sass.items())}))
    cases = []
    for n_blocks in (8, 1024):
        iters = MC_SAMPLES // (n_blocks * mc.LANES)
        segments = mc.mc_plan(n_blocks * mc.LANES, iters)
        for problem, kind in variants:
            kw = dict(kind=kind, problem=problem, iters=iters,
                      n_blocks=n_blocks)
            kernel = functools.partial(mc.mc_partial_sums_cuda, 42, **kw)
            plain_out = []
            plain_ms = _call_ms(lambda: plain_out.append(mc.mc_blocked_plain(
                42, device="cuda", **kw)), reps=1 if n_blocks == 8 else 3,
                warmup=0)
            before = dict(mc.mc_partial_sums_cuda.path_launches)
            got = kernel()
            after = mc.mc_partial_sums_cuda.path_launches
            path = "lane" if segments == 1 else "segment"
            if {k: after[k] - before[k] for k in after} != {
                    k: int(k == path) for k in after}:
                _fail(f"montecarlo {kw}: launches {before} -> {after}, "
                      f"expected one on the {path} path")
            if not torch.equal(got, plain_out[-1]):
                _fail(f"montecarlo {kw}: not bit-exact against the plain "
                      "version at 2**26 samples")
            samples = iters * n_blocks * mc.LANES
            per_sample = sass[problem, kind]
            bound_ms, bound_by = card.bound(
                4 * n_blocks * mc.LANES, [samples * c for c in per_sample])
            cases.append(dict(
                shape=[n_blocks, mc.LANES], dtype="float32",
                what=f"{problem} {kind}, 2**26 samples, n_blocks {n_blocks}",
                iters=iters, path=path, segments=segments, max_abs_err=0.0,
                bound_ms=bound_ms, bound_by=bound_by,
                instructions_per_sample=per_sample,
                latency_bound_ms=card.latency_ms(2 * iters, MC_CHAIN[kind]),
                lane_dispatch_bound_ms=(iters * per_sample[0] / card.clock_hz
                                     * 1e3),
                ms=_device_ms(kernel), call_ms=_call_ms(kernel),
                plain_ms=plain_ms,
                plain_timing="eager, one Python step per sample",
                library_ms=None))
    print("montecarlo: bit-exact against the plain version at 2**26 samples, "
          "n_blocks 8 (segment path) and 1024 (lane path)")
    swept = mc_segments.sweep(MC_SAMPLES)
    print("montecarlo segments:", json.dumps(swept))
    entry = _entry("montecarlo", "src/repro_torch/csrc/montecarlo.cu",
                   "src/repro/kernels/montecarlo.py:76", cases, 1)
    entry["segment_sweep"] = swept
    return entry


def _entry(name, source, replaces, cases, headline) -> dict:
    """One kernel's line entry: the numbers of its headline case (the shape
    its main path launches most), every case beside them."""
    h = cases[headline]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None,
                max_abs_err=max(c["max_abs_err"] for c in cases),
                ms=h["ms"], kernel_ms=h["ms"], plain_ms=h["plain_ms"],
                bound_ms=h["bound_ms"], bound_by=h["bound_by"],
                library_ms=h["library_ms"], call_ms=h["call_ms"],
                headline=h["what"], cases=cases)


# ---------------------------------------------------------------------------
# phase 3: the port on the card against the port on the CPU, small model
# ---------------------------------------------------------------------------

def check_reference(torch, arch: str = "olmo-1b") -> None:
    """``arch``'s smoke model served on the card and on the CPU: prefill
    and 11 decode steps, greedy and sampled."""
    import numpy as np

    from repro_torch.configs import load_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = load_config(arch, "smoke")
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = init_params(cfg, torch.Generator().manual_seed(0), "cpu").cuda()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    for kw in (dict(), dict(temperature=1.0, seed=2)):
        want = ServeEngine(cfg, cpu, max_len=40, batch=2, device="cpu",
                           **kw).generate(prompts, 12)
        got = ServeEngine(cfg, card, max_len=40, batch=2, device="cuda",
                          **kw).generate(prompts, 12)
        torch.testing.assert_close(got.logits.cpu(), want.logits, rtol=1e-4,
                                   atol=1e-4)
        if not np.array_equal(got.tokens, want.tokens):
            _fail(f"{arch} smoke reference {kw}: tokens on the card differ "
                  "from the CPU's")
    print(f"reference: {arch} smoke on the card matches the CPU "
          "(logits rtol 1e-4 atol 1e-4, tokens identical, greedy and sampled)")


# ---------------------------------------------------------------------------
# phase 4: serving OLMo-1B at full width
# ---------------------------------------------------------------------------

def _counters():
    from repro_torch.kernels import expf, logf, montecarlo, prng, softmax
    return {"softmax": softmax.softmax_cuda, "exp": expf.exp_cuda,
            "uniform": prng.uniform_cuda, "logf": logf.log_cuda,
            "montecarlo": montecarlo.mc_partial_sums_cuda}


def _reset_counters() -> dict:
    """Set every launch counter, every per-path counter and every tiling
    counter to 0."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
        for path in getattr(c, "path_launches", {}):
            c.path_launches[path] = 0
        getattr(c, "tiling_launches", {}).clear()
    return counters


def _path_launches(counters) -> dict:
    return {k: dict(c.path_launches) for k, c in counters.items()
            if hasattr(c, "path_launches")}


def _tiling_launches(counters) -> dict:
    """Launches by tiling: threads a block (exp, logf, uniform), rows a
    block on softmax's warp path."""
    return {k: dict(c.tiling_launches) for k, c in counters.items()
            if hasattr(c, "tiling_launches")}


def _request(label, fn, vocab):
    """Run one request with every launch counter at 0; check its output."""
    import torch
    counters = _reset_counters()
    t0 = time.perf_counter()
    res = fn()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    paths = _path_launches(counters)
    B, n = res.tokens.shape[0], res.steps
    if res.logits.shape != (B, n, vocab):
        _fail(f"{label}: logits shape {tuple(res.logits.shape)}")
    if not bool(torch.isfinite(res.logits).all()):
        _fail(f"{label}: non-finite logits")
    if not ((res.tokens >= 0) & (res.tokens < vocab)).all():
        _fail(f"{label}: token outside [0, {vocab})")
    row = dict(request=label, batch=B, prompt=res.tokens.shape[1] - n,
               new_tokens=n, prefill_ms=res.prefill_s * 1e3,
               decode_ms_per_token=res.decode_s * 1e3 / n,
               tokens_per_s=B * n / (res.prefill_s + res.decode_s),
               wall_s_with_init=wall, launches=launches,
               path_launches=paths)
    print("serve:", json.dumps(row))
    return res, row


def _profiled(torch, fn, label: str) -> dict:
    """Run ``fn`` once under torch.profiler and read its device activity
    from the exported trace (``build/chip_smoke_trace_<label>.json``):
    (result, host-clock ms under the profiler ending in a synchronisation,
    device-busy ms, device operations, device ms by kernel name)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = ROOT / "build" / f"chip_smoke_trace_{label}.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = Counter()
    for e in dev:
        by_name[e["name"][:80]] += e["dur"] / 1e3
    return res, wall_ms, sum(by_name.values()), len(dev), by_name


def profile_serving(torch, engine, prompts, n_steps: int,
                    label: str = "serve", model: str = "OLMo-1B") -> None:
    """Where the time of a request of (a)'s shape goes: one generate()
    under torch.profiler.  Prints the device-busy share of the request's
    wall time and the kernels that take the most device time.  A
    measurement only: it checks nothing, and the profiler's own cost
    inflates the wall time."""
    engine.generate(prompts, 2)                      # warm-up
    res, _, busy_ms, n_ops, by_name = _profiled(
        torch, lambda: engine.generate(prompts, n_steps), label)
    wall_ms = (res.prefill_s + res.decode_s) * 1e3
    print("profile:", json.dumps(dict(
        request=f"{model}, batch 4, prompt 128, {n_steps} new tokens, "
                "greedy",
        wall_ms_under_profiler=wall_ms,
        device_busy_ms=busy_ms if n_ops else "not measured",
        device_busy_share=busy_ms / wall_ms if n_ops else "not measured",
        device_ops=n_ops,
        top=[[k, v] for k, v in by_name.most_common(8)])))


def serve_cli(arch: str, greedy: str, sampled: str) -> tuple[list, object]:
    """``launch.serve.main`` at full width, batch 4, prompt 128, 32 new
    tokens: greedy twice (identical tokens, each the argmax of its
    logits), then at temperature 1.0, seed 3.  Returns the three rows and
    the greedy tokens."""
    import numpy as np

    from repro_torch.configs import load_config
    from repro_torch.launch import serve

    V = load_config(arch, "full").vocab_size
    argv = ["--arch", arch, "--variant", "full", "--batch", "4",
            "--prompt-len", "128", "--gen", "32", "--device", "cuda"]
    rows = []
    a1, row = _request(f"{greedy}: greedy, run 1", lambda: serve.main(argv),
                       V)
    rows.append(row)
    a2, row = _request(f"{greedy}: greedy, run 2", lambda: serve.main(argv),
                       V)
    rows.append(row)
    if not np.array_equal(a1.tokens, a2.tokens):
        _fail(f"({greedy}): two greedy runs gave different tokens")
    if not np.array_equal(a1.tokens[:, 128:], a1.logits.argmax(-1).cpu()):
        _fail(f"({greedy}): greedy tokens are not the argmax of their "
              "logits")
    tokens = a1.tokens
    del a1, a2
    _, row = _request(f"{sampled}: temperature 1.0, seed 3", lambda: serve.main(
        argv + ["--temperature", "1.0", "--seed", "3"]), V)
    rows.append(row)
    return rows, tokens


def serve_full(torch) -> tuple[dict, dict, dict]:
    """Phase 4.  Returns the launches of each kernel, the launches by path,
    and what phase 9 serves again: the parameters (``launch.serve``'s, from
    seed 0) and (a)'s greedy tokens."""
    import numpy as np

    from repro_torch.configs import load_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = load_config("olmo-1b", "full")
    V = cfg.vocab_size
    total = {k: 0 for k in _counters()}
    paths = {k: dict.fromkeys(v, 0)
             for k, v in _path_launches(_counters()).items()}
    rows, greedy_tokens = serve_cli("olmo-1b", "a", "b")

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    engine = ServeEngine(cfg, params, max_len=5120, batch=1, device="cuda")
    prompt = np.random.default_rng(0).integers(0, V, (1, 2048)).astype(np.int32)
    _, row = _request("c: prompt 2048, max_len 5120",
                      lambda: engine.generate(prompt, 8), V)
    rows.append(row)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve: peak device memory {peak_gb:.2f} GB")
    profile_serving(torch, ServeEngine(cfg, params, max_len=161, batch=4,
                                       device="cuda"),
                    np.random.default_rng(1).integers(0, V, (4, 128)), 16)

    for r in rows:
        for k, v in r["launches"].items():
            total[k] += v
        for k, by_path in r["path_launches"].items():
            for path, v in by_path.items():
                paths[k][path] += v
    need = {"softmax": rows[0], "uniform": rows[2], "exp": rows[3]}
    for k, r in need.items():
        if r["launches"][k] <= 0:
            _fail(f"the {k} kernel was not launched in request {r['request']}")
    # (a) and (b): 8192x161 prefill and 64x161 decode, on the warp path;
    # (c): 16x5120 decode on the cluster path, its chunked prefill on exp's
    # vector path.
    for r in rows[:3]:
        sm = r["path_launches"]["softmax"]
        if sm["warp"] <= 0 or sm["cluster"] or sm["sweep"]:
            _fail(f"{r['request']}: softmax paths {sm}, expected the warp "
                  "path only")
    sm = rows[3]["path_launches"]["softmax"]
    ex = rows[3]["path_launches"]["exp"]
    if sm["cluster"] <= 0 or sm["warp"] or sm["sweep"]:
        _fail(f"(c): softmax paths {sm}, expected the cluster path only")
    if ex["vector"] <= 0 or ex["scalar"]:
        _fail(f"(c): exp paths {ex}, expected the vector path only")
    return total, paths, dict(params=params, greedy_tokens=greedy_tokens)


# ---------------------------------------------------------------------------
# phase 5: the kernel facade, every runnable spec through kernel(name).run
# ---------------------------------------------------------------------------

def _facade_cases(torch, gen):
    """name -> a function that runs the spec's ``.run`` on the card at full
    size and holds it against ``.ref`` (or the plain version where the spec
    has no oracle), returning the largest error."""
    from repro_torch.kernels import ops, softmax
    from repro_torch.kernels.logf import log_cuda
    from repro_torch.kernels.montecarlo import mc_partial_sums_cuda as mc_cuda
    from repro_torch.models.attention import NEG_INF

    def expf(spec):
        x = torch.empty(16 * 1024 * 1024, device="cuda").uniform_(
            -90.0, 2.0, generator=gen)
        x[::97] = NEG_INF
        got, want = spec.run(x), spec.ref(x)
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-30)
        return float((got - want).abs().max())

    def logf(spec):
        x = log_input(torch, gen)
        before = dict(log_cuda.path_launches)
        got, want = spec.run(x), spec.ref(x)
        if log_cuda.path_launches["vector"] != before["vector"] + 1:
            _fail("facade logf: not launched on the vector path")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        return float((got - want).abs().max())

    def softmax_(spec):
        err = 0.0
        for rows, cols, dt in [(8192, 161, torch.float32),
                               (64, 161, torch.float32),
                               (16, 5120, torch.float32),
                               (64, 32768, torch.float32),
                               (64, 161, torch.bfloat16)]:
            x = torch.randn(rows, cols, device="cuda", generator=gen) * 4
            x[:, cols // 2 + 1:] = NEG_INF
            x = x.to(dt)
            got = spec.run(x)
            if dt == torch.float32:
                want = spec.ref(x)
                torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-7)
            else:
                # The oracle subtracts the max in the input dtype, as the
                # JAX oracle does; the kernel does it in fp32.  In bf16 the
                # kernel is held to its plain version instead.
                want = softmax.softmax_plain(x)
                if _bf16_ulp_err(got, want) > 1.0:
                    _fail("facade softmax bf16: more than 1 bf16 ulp from "
                          "the plain version")
            err = max(err, float((got.float() - want.float()).abs().max()))
        return err

    def prng(spec):
        for kind in ("xoshiro128p", "lcg"):
            for n in (50304, 1 << 24):
                got = spec.run(2 ** 32 - 1, (n,), kind)
                if not torch.equal(got, spec.ref(kind, 2 ** 32 - 1, (n,))):
                    _fail(f"facade prng {kind} n={n}: not bit-exact")
        return 0.0

    def montecarlo(fn, truth):
        def run(spec):
            for n_blocks, path in ((8, "segment"), (1024, "lane")):
                before = dict(mc_cuda.path_launches)
                est = spec.run(42, MC_SAMPLES, n_blocks=n_blocks)
                if mc_cuda.path_launches[path] != before[path] + 1:
                    _fail(f"facade {spec.name} n_blocks={n_blocks}: not "
                          f"launched on the {path} path")
                want = fn(42, MC_SAMPLES, n_blocks=n_blocks, impl="reference")
                if float(est) != float(want):
                    _fail(f"facade {spec.name} n_blocks={n_blocks}: "
                          f"{float(est)!r} != plain {float(want)!r}")
                if not abs(float(est) - truth) < 0.002:
                    _fail(f"facade {spec.name} n_blocks={n_blocks}: "
                          f"estimate {float(est)!r} is not within 0.002 "
                          f"of {truth}")
                print(f"facade: {spec.name} n_blocks={n_blocks}: "
                      f"{float(est)!r} (2**26 samples, {path} path, equal to "
                      "the plain version)")
            return 0.0
        return run

    return {"expf": expf, "logf": logf, "softmax": softmax_, "prng": prng,
            "pi_xoshiro128p": montecarlo(ops.mc_pi, math.pi),
            "poly_xoshiro128p": montecarlo(ops.mc_poly, 0.4)}


def check_facade(torch, gen) -> dict:
    """Every spec of ``repro_torch.api`` that has an entry point, run through
    ``kernel(name).run`` on the card under ``config(impl="cuda")``.  Every
    launch counter is set to 0 just before and read just after; each kernel
    must have launched."""
    from repro_torch import api

    cases = _facade_cases(torch, gen)
    runnable = [s for s in api.specs() if s.op is not None]
    missing = sorted({s.name for s in runnable} - set(cases))
    if missing:
        _fail(f"facade: no check for the runnable specs {missing}")
    if api.kernel("montecarlo") is not api.kernel("pi_xoshiro128p"):
        _fail("facade: 'montecarlo' does not resolve to pi_xoshiro128p")
    counters = _reset_counters()
    errs = {}
    with api.config(impl="cuda"):
        for spec in runnable:
            errs[spec.name] = cases[spec.name](spec)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    paths = _path_launches(counters)
    print("facade:", json.dumps(dict(max_abs_err=errs, launches=launches,
                                     path_launches=paths)))
    for k, n in launches.items():
        if n <= 0:
            _fail(f"facade: the {k} kernel was not launched")
    return launches, paths


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

class _Tee(io.TextIOBase):
    """Writes to every stream it holds: the console and a capture."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)
        return len(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def _train_main(argv):
    """``repro_torch.launch.train.main(argv)``: (history, printed text)."""
    from repro_torch.launch import train
    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(buf, sys.stdout)):
        history = train.main(argv)
    return history, buf.getvalue()


def _check_finite(label, rows):
    for r in rows:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])):
            _fail(f"{label}: step {r['step']}: loss {r['loss']!r}, grad "
                  f"norm {r['grad_norm']!r}")


def _main_path_run(torch, fn):
    """Run ``fn`` with every launch counter at 0; return (result,
    launches, launches by path, seconds)."""
    counters = _reset_counters()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res, {k: c.launches for k, c in counters.items()},
            _path_launches(counters), wall)


def _full_state(torch, cfg, seed=0):
    """A fresh full-width train state: fp32 masters from a seeded
    generator on the card, the bf16 working copy, zero moments."""
    from repro_torch.models.model import init_params
    from repro_torch.train.train_step import init_train_state
    gen = torch.Generator(device="cuda").manual_seed(seed)
    masters = init_params(cfg.replace(dtype=cfg.param_dtype), gen, "cuda")
    return init_train_state(cfg, masters)


def train_full(torch, smi) -> dict:
    """(d): launch.train at full width, 4 steps, then resumed to 6.
    Returns the launches of each kernel over both runs."""
    d = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(d, ignore_errors=True)
    ckpt_dir, metrics = d / "ckpt", d / "metrics.json"
    argv = ["--arch", "olmo-1b", "--variant", "full", "--batch", "4",
            "--seq", "2048", "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2",
            "--metrics-out", str(metrics), "--log-every", "1",
            "--device", "cuda"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (hist, out), launches, paths, wall = _main_path_run(
        torch, lambda: _train_main(argv + ["--steps", "4"]))
    peak = torch.cuda.max_memory_allocated()
    if [r["step"] for r in hist] != [0, 1, 2, 3]:
        _fail(f"(d): steps {[r['step'] for r in hist]}")
    if [r["step"] for r in json.loads(metrics.read_text())] != [0, 1, 2, 3]:
        _fail("(d): --metrics-out does not hold steps 0 to 3")
    _check_finite("(d)", hist)
    (hist2, out2), launches2, _, wall2 = _main_path_run(
        torch, lambda: _train_main(argv + ["--steps", "6"]))
    if "[resume] from step 4" not in out2:
        _fail("(d): the second run did not print '[resume] from step 4'")
    if [r["step"] for r in hist2] != [4, 5]:
        _fail(f"(d): the resumed run recorded steps "
              f"{[r['step'] for r in hist2]}, not 4 and 5")
    _check_finite("(d) resumed", hist2)
    ckpts = sorted(p.name for p in ckpt_dir.iterdir())
    if ckpts != [f"step_{s:08d}.pt" for s in (2, 4, 6)]:
        _fail(f"(d): checkpoints {ckpts}")
    steps = 4
    if launches["uniform"] != 2 * steps:
        _fail(f"(d): uniform launched {launches['uniform']} times in "
              f"{steps} steps, not 2 a step")
    sm = paths["softmax"]
    if sm["cluster"] <= 0 or sm["warp"] or sm["sweep"]:
        _fail(f"(d): softmax paths {sm}, expected the cluster path only")
    secs = [r["seconds"] for r in hist]
    ms = statistics.median(secs[1:]) * 1e3
    row = dict(
        phase="d: OLMo-1B full width, batch 4 x seq 2048, bf16 compute, "
              "fp32 masters, remat full",
        card=smi, steps=steps, ms_per_step=ms,
        ms_per_step_all=[t * 1e3 for t in secs],
        resumed_ms_per_step=[r["seconds"] * 1e3 for r in hist2],
        tokens_per_s=4 * 2048 / (ms / 1e3),
        peak_memory_gb=peak / 1e9,
        losses=[r["loss"] for r in hist + hist2],
        grad_norms=[r["grad_norm"] for r in hist + hist2],
        launches_per_step={k: v / steps for k, v in launches.items()},
        path_launches_per_step={k: {p: v / steps for p, v in by.items()}
                                for k, by in paths.items()},
        wall_s_run1=wall, wall_s_run2=wall2,
        checkpoint_bytes=(ckpt_dir / ckpts[-1]).stat().st_size)
    print("train:", json.dumps(row))
    shutil.rmtree(d, ignore_errors=True)
    return {k: launches[k] + launches2[k] for k in launches}


def train_chunked(torch, smi) -> dict:
    """(e): one step at batch 1 x seq 4096, chunked attention.  Returns the
    launches of each kernel."""
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    cfg = load_config("olmo-1b", "full")
    state = _full_state(torch, cfg)
    batch = TokenPipeline(cfg, ShapeConfig("e", 4096, 1, "train"),
                          device="cuda").host_batch_at(0)
    fn = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=1))
    torch.cuda.reset_peak_memory_stats()
    (_, m), launches, paths, wall = _main_path_run(
        torch, lambda: fn(state, batch))
    m = {k: float(v) for k, v in m.items()}
    _check_finite("(e)", [dict(m, step=0)])
    ex = paths["exp"]
    if ex["vector"] <= 0 or ex["scalar"]:
        _fail(f"(e): exp paths {ex}, expected the vector path only")
    print("train:", json.dumps(dict(
        phase="e: batch 1 x seq 4096, chunked attention", card=smi,
        ms_step_with_first_launches=wall * 1e3, loss=m["loss"],
        grad_norm=m["grad_norm"],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches_per_step=launches, path_launches_per_step=paths)))
    return launches


def train_against_plain(torch, smi) -> None:
    """(f): one step with the kernels against one with the plain versions,
    and the Functions' gradients at the training shapes."""
    from repro_torch import api
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import expf, softmax
    from repro_torch.models.attention import NEG_INF
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    cfg = load_config("olmo-1b", "full")
    state = _full_state(torch, cfg, seed=1)
    snapshot = {k: v.clone() for k, v in state.state_dict().items()}
    batch = TokenPipeline(cfg, ShapeConfig("f", 2048, 4, "train"),
                          device="cuda").host_batch_at(0)
    opt = AdamWConfig(warmup_steps=1, total_steps=1)
    got = {}
    for impl in ("cuda", "reference"):
        state.load_state_dict(snapshot)
        fn = make_train_step(cfg.replace(softmax_impl=impl), opt)
        with api.config(impl=impl):
            _, m = fn(state, batch)
        got[impl] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    # Where a step's time goes: one more step with the kernels, profiled.
    fn = make_train_step(cfg, opt)
    _, wall_ms, busy_ms, n_ops, by_name = _profiled(
        torch, lambda: fn(state, batch), "train")
    print("profile:", json.dumps(dict(
        step="OLMo-1B full width, batch 4 x seq 2048, remat full",
        card=smi, wall_ms_under_profiler=wall_ms,
        device_busy_ms=busy_ms if n_ops else "not measured",
        device_busy_share=busy_ms / wall_ms if n_ops else "not measured",
        device_ops=n_ops,
        top=[[k, v] for k, v in by_name.most_common(12)])))
    del state, snapshot
    a, b = got["cuda"], got["reference"]
    if not math.isclose(a["loss"], b["loss"], rel_tol=1e-4):
        _fail(f"(f): loss {a['loss']!r} (kernels) vs {b['loss']!r} (plain)")
    if not math.isclose(a["grad_norm"], b["grad_norm"], rel_tol=1e-3):
        _fail(f"(f): grad norm {a['grad_norm']!r} (kernels) vs "
              f"{b['grad_norm']!r} (plain)")

    gen = torch.Generator(device="cuda").manual_seed(5)
    T, rows = 2048, 4 * 16 * 2048
    x = torch.randn(rows, T, device="cuda", generator=gen) * 4
    t = torch.arange(rows, device="cuda")[:, None] % T
    x = torch.where(torch.arange(T, device="cuda")[None, :] <= t, x, NEG_INF)
    g = torch.randn(rows, T, device="cuda", generator=gen)
    xg = x.clone().requires_grad_(True)
    plan = softmax.softmax_plan(rows, T, torch.float32)
    (dx,) = torch.autograd.grad(softmax.SoftmaxFn.apply(xg, True), xg, g)
    err_sm = 0.0
    for lo in range(0, rows, 16384):
        xs = x[lo:lo + 16384].clone().requires_grad_(True)
        (want,) = torch.autograd.grad(softmax.softmax_plain(xs), xs,
                                      g[lo:lo + 16384])
        torch.testing.assert_close(dx[lo:lo + 16384], want, rtol=1e-5,
                                   atol=1e-6)
        err_sm = max(err_sm, float((dx[lo:lo + 16384] - want).abs().max()))
    del x, xg, g, dx, want, xs
    n = 16 * 1024 * 1024
    x = torch.empty(n, device="cuda").uniform_(-90.0, 2.0, generator=gen)
    x[::97] = NEG_INF
    g = torch.randn(n, device="cuda", generator=gen)
    xg = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(expf.ExpFn.apply(xg, True), xg, g)
    xp = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(expf.exp_plain(xp), xp, g)
    torch.testing.assert_close(dx, want, rtol=1e-5, atol=1e-6)
    err_exp = float((dx - want).abs().max())
    print("train:", json.dumps(dict(
        phase="f: kernels against plain versions, with gradients", card=smi,
        kernels=a, plain=b,
        softmax_grad=dict(shape=[rows, T], path=plan.path,
                          cluster=plan.cluster, max_abs_err=err_sm),
        exp_grad=dict(shape=[n], max_abs_err=err_exp))))


def train_card_against_cpu(torch, arch: str = "olmo-1b",
                           tag: str = "g") -> None:
    """(g): ``arch``'s smoke model trains 3 steps on the card and on the
    CPU from one state, on identical batches."""
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = load_config(arch, "smoke")
    fn = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=1,
                                          total_steps=3))
    losses, batches = {}, {}
    for device in ("cpu", "cuda"):
        masters = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        state = init_train_state(cfg, masters.to(device))
        pipe = TokenPipeline(cfg, ShapeConfig("g", 64, 4, "train"),
                             device=device)
        losses[device], batches[device] = [], []
        for step in range(3):
            batch = pipe.host_batch_at(step)
            state, m = fn(state, batch)
            losses[device].append(float(m["loss"]))
            batches[device].append(batch["tokens"].cpu())
    for a, b in zip(batches["cpu"], batches["cuda"]):
        if not torch.equal(a, b):
            _fail(f"({tag}) {arch}: the card's token batches differ from "
                  "the CPU's")
    for a, b in zip(losses["cuda"], losses["cpu"]):
        if not math.isclose(a, b, rel_tol=1e-4):
            _fail(f"({tag}) {arch}: losses {losses['cuda']} on the card vs "
                  f"{losses['cpu']} on the CPU")
    print(f"train: ({tag}) {arch} smoke, 3 steps: losses on the card "
          f"{losses['cuda']} match the CPU's {losses['cpu']} (rtol 1e-4); "
          "batches identical")


def train_phase(torch, smi) -> dict:
    """Phase 6.  Returns the main-path launches of each kernel over (d)'s
    two runs and (e)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    full = train_full(torch, smi)
    torch.cuda.empty_cache()
    chunked = train_chunked(torch, smi)
    torch.cuda.empty_cache()
    train_against_plain(torch, smi)
    torch.cuda.empty_cache()
    train_card_against_cpu(torch)
    print(f"train: phase wall time {time.perf_counter() - t0:.1f} s")
    return {k: full[k] + chunked[k] for k in full}


# ---------------------------------------------------------------------------
# phase 7: the MoE, Mamba, RWKV-6 and audio families
# ---------------------------------------------------------------------------

#: Jamba's one period at full width: eight layers of 32, as one card holds.
JAMBA_PERIOD = dict(n_layers=8, layer_types="mmmmammm")


def _weight_bytes(cfg) -> int:
    """Bytes of every parameter a decode step reads: all but the token
    embedding, of which it gathers one row a token."""
    from repro_torch.models.model import LMModel, working_dtype
    model = LMModel(cfg, "meta")
    return sum(p.numel() * working_dtype(cfg, n, p.ndim).itemsize
               for n, p in model.named_parameters() if n != "embed.table")


def _n_params(cfg) -> int:
    from repro_torch.models.model import LMModel
    return sum(p.numel() for p in LMModel(cfg, "meta").parameters())


def _only_path(label, by_path, path, n=None):
    """Fail unless ``by_path`` counts launches on ``path`` alone (exactly
    ``n`` of them where given)."""
    others = {k: v for k, v in by_path.items() if k != path}
    if by_path[path] <= 0 or any(others.values()) or (
            n is not None and by_path[path] != n):
        want = f"{n} on" if n is not None else "launches on"
        _fail(f"{label}: paths {by_path}, expected {want} the {path} path "
              "only")


def _free(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def family_deepseek(torch, smi) -> list:
    """(h): DeepSeekMoE-16B, full width and depth, served twice greedy and
    once sampled through ``launch.serve.main``, then a request profiled."""
    import numpy as np

    from repro_torch.configs import load_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = load_config("deepseek-moe-16b", "full")
    V = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    rows, _ = serve_cli(cfg.name, "h", "h")
    for r in rows:
        _only_path(r["request"], r["path_launches"]["softmax"], "warp")
        if r["launches"]["exp"]:
            _fail(f"{r['request']}: exp launched")
        if (r["launches"]["uniform"] > 0) != (r is rows[2]):
            _fail(f"{r['request']}: uniform launched "
                  f"{r['launches']['uniform']} times")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    profile_serving(torch, ServeEngine(cfg, params, max_len=161, batch=4,
                                       device="cuda"),
                    np.random.default_rng(1).integers(0, V, (4, 128)), 16,
                    label="deepseek", model="DeepSeekMoE-16B")
    del params
    bound_ms = _weight_bytes(cfg) / HBM_BYTES_PER_S * 1e3
    print("families:", json.dumps(dict(
        path="h: DeepSeekMoE-16B full width, 28 layers, batch 4, prompt 128, "
             "32 new tokens", card=smi, parameters=_n_params(cfg),
        prefill_ms=[r["prefill_ms"] for r in rows],
        decode_ms_per_token=[r["decode_ms_per_token"] for r in rows],
        decode_bound_ms_per_token=bound_ms,
        decode_bound="every weight but the embedding read once a step "
                     "(capacity dispatch computes all 64 experts a layer)",
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)))
    _free(torch)
    return rows


def family_jamba(torch, smi) -> list:
    """(i): one full-width Jamba period (8 layers of 32) prefills 7,168
    tokens through chunked attention and decodes 8."""
    import numpy as np

    from repro_torch.configs import load_config
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    cfg = load_config("jamba-v0.1-52b", "full").replace(**JAMBA_PERIOD)
    V = cfg.vocab_size
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    engine = ServeEngine(cfg, params, max_len=8192, batch=1, device="cuda")
    prompt = np.random.default_rng(0).integers(0, V, (1, 7168)).astype(
        np.int32)
    res, row = _request("i: jamba one period, prompt 7168, max_len 8192",
                        lambda: engine.generate(prompt, 8), V)
    # Query blocks 0..6 of 1024 against KV chunks of 1024: causal alone
    # gives 1+2+...+7 = 28 block pairs; the 4096 window starts blocks 5 and
    # 6 at chunks 1 and 2, so 25 pairs run, two exps each.
    _only_path("(i) prefill", row["path_launches"]["exp"], "vector", 50)
    _only_path("(i) decode", row["path_launches"]["softmax"], "cluster", 7)
    if row["launches"]["uniform"]:
        _fail("(i): uniform launched in a greedy request")
    bound_ms = _weight_bytes(cfg) / HBM_BYTES_PER_S * 1e3
    print("families:", json.dumps(dict(
        path="i: Jamba-v0.1 full width, one period of 8 layers (the depth "
             "cut from 32: 52 B parameters take ~104 GB in bf16), prompt "
             "7168, 8 new tokens", card=smi, parameters=_n_params(cfg),
        prefill_ms=row["prefill_ms"],
        decode_ms_per_token=row["decode_ms_per_token"],
        decode_bound_ms_per_token=bound_ms,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)))
    del params, engine, res
    _free(torch)
    return [row]


def family_rwkv(torch, smi) -> list:
    """(j): RWKV-6 1.6B, full width and depth, sampled."""
    from repro_torch.configs import load_config
    from repro_torch.launch import serve

    cfg = load_config("rwkv6-1.6b", "full")
    argv = ["--arch", cfg.name, "--variant", "full", "--batch", "4",
            "--prompt-len", "128", "--gen", "32", "--temperature", "1.0",
            "--seed", "3", "--device", "cuda"]
    _, row = _request("j: rwkv6 temperature 1.0, seed 3",
                      lambda: serve.main(argv), cfg.vocab_size)
    if row["launches"]["uniform"] != 4 * 32:
        _fail(f"(j): uniform launched {row['launches']['uniform']} times, "
              "not once a slot and token")
    if row["launches"]["softmax"] or row["launches"]["exp"]:
        _fail(f"(j): attention kernels launched in an attention-free "
              f"model: {row['launches']}")
    print("families:", json.dumps(dict(
        path="j: RWKV-6 1.6B full width, 24 layers, batch 4, prompt 128, "
             "32 sampled tokens", card=smi, parameters=_n_params(cfg),
        prefill_ms=row["prefill_ms"],
        decode_ms_per_token=row["decode_ms_per_token"])))
    _free(torch)
    return [row]


def family_hubert(torch, smi) -> list:
    """(k): HuBERT-XLarge, full width and depth, trains 3 steps through
    ``launch.train.main``.  Returns its row of launches."""
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline

    cfg = load_config("hubert-xlarge", "full")
    n_embeds = 4 * 2048 * cfg.d_model
    # One pipeline step alone: three uniform launches, one of them the
    # frame embeddings' 10,485,760 values.
    (batch, launches, _, _) = _main_path_run(
        torch, lambda: TokenPipeline(cfg, ShapeConfig("k", 2048, 4, "train"),
                                     device="cuda").host_batch_at(0))
    if launches["uniform"] != 3 or batch["embeds"].numel() != n_embeds or \
            batch["embeds"].dtype != torch.bfloat16:
        _fail(f"(k): pipeline step launched uniform {launches['uniform']} "
              f"times for embeds {tuple(batch['embeds'].shape)} "
              f"{batch['embeds'].dtype}")
    del batch
    steps = 3
    argv = ["--arch", cfg.name, "--variant", "full", "--batch", "4",
            "--seq", "2048", "--steps", str(steps), "--log-every", "1",
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    (hist, _), launches, paths, wall = _main_path_run(
        torch, lambda: _train_main(argv))
    peak = torch.cuda.max_memory_allocated()
    _check_finite("(k)", hist)
    if launches["uniform"] != 3 * steps:
        _fail(f"(k): uniform launched {launches['uniform']} times in "
              f"{steps} steps, not 3 a step")
    # 48 layers, each softmax once in the forward and once in the remat
    # recompute: non-causal 131,072 x 2,048 scores on the cluster path.
    _only_path("(k)", paths["softmax"], "cluster", 96 * steps)
    if launches["exp"]:
        _fail(f"(k): exp launched {launches['exp']} times")
    secs = [r["seconds"] for r in hist]
    ms = statistics.median(secs[1:]) * 1e3
    print("families:", json.dumps(dict(
        path="k: HuBERT-XLarge full width, 48 layers, batch 4 x seq 2048, "
             "bf16 compute, fp32 masters, remat full", card=smi,
        parameters=_n_params(cfg), ms_per_step=ms,
        ms_per_step_all=[t * 1e3 for t in secs],
        tokens_per_s=4 * 2048 / (ms / 1e3), peak_memory_gb=peak / 1e9,
        losses=[r["loss"] for r in hist],
        grad_norms=[r["grad_norm"] for r in hist],
        launches_per_step={k: v / steps for k, v in launches.items()},
        wall_s=wall)))
    _free(torch)
    return [dict(launches=launches, path_launches=paths)]


def family_smokes(torch) -> None:
    """(l): each new family's smoke model on the card (kernels) against the
    CPU (plain versions): forward logits; prefill and 11 decode steps,
    greedy and sampled, for the recurrent families; 3 train steps of one
    MoE and one SSM family."""
    import numpy as np

    from repro_torch.configs import load_config
    from repro_torch.models.model import forward, init_params

    rng = np.random.default_rng(0)
    for arch in ("deepseek-moe-16b", "grok-1-314b", "jamba-v0.1-52b",
                 "rwkv6-1.6b", "hubert-xlarge"):
        cfg = load_config(arch, "smoke")
        cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = init_params(cfg, torch.Generator().manual_seed(0),
                           "cpu").cuda()
        if cfg.frontend == "audio":
            batch = {"embeds": torch.from_numpy(rng.uniform(
                -1, 1, (2, 24, cfg.d_model)).astype(np.float32))}
        else:
            batch = {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (2, 24)).astype(np.int32))}
        with torch.no_grad():
            want, _, _ = forward(cpu, cfg, batch)
            got, _, _ = forward(card, cfg, {k: v.cuda()
                                            for k, v in batch.items()})
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        print(f"families: (l) {arch} smoke forward on the card matches the "
              "CPU (logits rtol 1e-4 atol 1e-4)")
    for arch in ("jamba-v0.1-52b", "rwkv6-1.6b"):
        check_reference(torch, arch)
    for arch in ("deepseek-moe-16b", "jamba-v0.1-52b"):
        train_card_against_cpu(torch, arch, "l")


def families_phase(torch, smi) -> dict:
    """Phase 7: (h) to (l), each freed before the next.  Returns the
    main-path launches of each kernel, in total and by path."""
    t0 = time.perf_counter()
    rows, walls = [], {}
    for label, run in (("h", family_deepseek), ("i", family_jamba),
                       ("j", family_rwkv), ("k", family_hubert)):
        t = time.perf_counter()
        rows += run(torch, smi)
        walls[label] = time.perf_counter() - t
    t = time.perf_counter()
    family_smokes(torch)
    walls["l"] = time.perf_counter() - t
    total = {k: sum(r["launches"][k] for r in rows) for k in _counters()}
    paths = {k: dict.fromkeys(v, 0)
             for k, v in _path_launches(_counters()).items()}
    for r in rows:
        for k, by_path in r["path_launches"].items():
            for path, v in by_path.items():
                paths[k][path] += v
    print("families: wall time by path (s)", json.dumps(walls))
    print(f"families: phase wall time {time.perf_counter() - t0:.1f} s")
    return total, paths


# ---------------------------------------------------------------------------
# phase 8: the analytic model
# ---------------------------------------------------------------------------

#: The JAX package's own tolerances on the paper's headline
#: (``tests/test_timing_energy.py``): ("rel" | "abs", tolerance).
HEADLINE_TOL = {"geomean_speedup": ("rel", 0.04),
                "peak_speedup": ("rel", 0.05), "peak_ipc": ("rel", 0.05),
                "geomean_ipc_gain": ("rel", 0.04),
                "geomean_power_ratio": ("abs", 0.04),
                "max_power_ratio": ("abs", 0.05),
                "geomean_energy_saving": ("abs", 0.06),
                "peak_energy_saving": ("rel", 0.05)}
#: The exp phase plan's problem: 262,144 fp32 values.
PLAN_ELEMENTS = 1 << 18


def paper_headline() -> dict:
    """(a) Table I's kernels through the port's timing and energy models:
    ``check_counts`` holds, and the headline aggregates meet the paper's
    within the JAX package's tolerances."""
    from repro_torch.core import PAPER_HEADLINE, TABLE_I, geomean
    from repro_torch.core.energy import evaluate_energy
    from repro_torch.core.kernels_isa import (KERNELS, baseline_trace,
                                              check_counts, copift_schedule)
    from repro_torch.core.timing import evaluate_kernel

    t0 = time.perf_counter()
    bad = [k for k, v in check_counts().items() if not v["ok"]]
    if bad:
        _fail(f"analytic (a): Table-I instruction counts differ for {bad}")
    res = {k: evaluate_kernel(k, baseline_trace(k), copift_schedule(k),
                              TABLE_I[k].max_block) for k in KERNELS}
    en = {k: evaluate_energy(k) for k in KERNELS}
    got = dict(
        geomean_speedup=geomean([r.speedup for r in res.values()]),
        peak_speedup=max(r.speedup for r in res.values()),
        peak_ipc=max(r.ipc_copift for r in res.values()),
        geomean_ipc_gain=geomean([r.ipc_gain for r in res.values()]),
        geomean_power_ratio=geomean([e.power_ratio for e in en.values()]),
        max_power_ratio=max(e.power_ratio for e in en.values()),
        geomean_energy_saving=geomean([e.energy_saving
                                       for e in en.values()]),
        peak_energy_saving=max(e.energy_saving for e in en.values()))
    for key, (kind, tol) in HEADLINE_TOL.items():
        want = PAPER_HEADLINE[key]
        err = abs(got[key] - want) / (want if kind == "rel" else 1.0)
        if not err <= tol:
            _fail(f"analytic (a): {key} {got[key]} against the paper's "
                  f"{want} ({kind} {tol})")
    for key, pick in (("peak_speedup", lambda k: res[k].speedup),
                      ("peak_energy_saving", lambda k: en[k].energy_saving)):
        if max(KERNELS, key=pick) != "expf":
            _fail(f"analytic (a): {key} is not expf's")
    return dict(headline=got, kernels=len(KERNELS),
                seconds=time.perf_counter() - t0)


def evaluate_sweep() -> dict:
    """(b) ``api.evaluate`` of every simulatable spec on ``Target()`` and an
    8-core homogeneous target, from cleared caches (cold) and again (warm):
    the same Reports both times, and the 1-core Report equal to the
    single-PE timing and energy numbers."""
    from repro_torch import api
    from repro_torch.core import TABLE_I, evaluate_kernel
    from repro_torch.core.energy import evaluate_energy
    from repro_torch.core.kernels_isa import baseline_trace, copift_schedule
    from repro_torch.perf import clear_all

    names = [s.name for s in api.specs() if s.simulatable]
    targets = {"Target()": api.Target(),
               "homogeneous(8)": api.Target.homogeneous(n_cores=8)}

    def run():
        t0 = time.perf_counter()
        out = {(n, t): api.evaluate(n, tgt) for n in names
               for t, tgt in targets.items()}
        return out, time.perf_counter() - t0

    clear_all()
    cold, cold_s = run()
    warm, warm_s = run()
    if cold != warm:
        _fail("analytic (b): warm Reports differ from cold ones")
    for n in names:
        isa = api.kernel(n).isa_name
        pe = evaluate_kernel(isa, baseline_trace(isa), copift_schedule(isa),
                             TABLE_I[isa].max_block)
        e = evaluate_energy(isa)
        r = api.evaluate(n, api.Target.single_pe())
        if (r.speedup, r.ipc_copift, r.ipc_base, r.cycles_copift,
                r.cycles_base, r.energy_saving, r.power_ratio) != (
                pe.speedup, pe.ipc_copift, pe.ipc_base, pe.cycles_copift,
                pe.cycles_base, e.energy_saving, e.power_ratio):
            _fail(f"analytic (b): {n}'s 1-core Report is not the single-PE "
                  f"result")
    eight = {n: warm[(n, "homogeneous(8)")] for n in names}
    return dict(specs=len(names), evaluations=len(cold), cold_s=cold_s,
                warm_s=warm_s,
                speedup_8_cores={n: r.speedup for n, r in eight.items()})


def plan_on_card(torch, gen) -> dict:
    """(c) The exp kernel's three phases as a COPIFT plan over 262,144 fp32
    values on the card, at the Table-I block rule's block: pipelined and
    serial equal ``exp_plain`` bit for bit and the CUDA exp kernel (counted
    from 0 just before) within exp's gate.  (d) ``analyze(exp_plain)`` on the
    card's tensor gives the CPU's Analysis."""
    from repro_torch.core import analyze, execute
    from repro_torch.kernels import expf, ops

    x = torch.empty(PLAN_ELEMENTS, device="cuda").uniform_(
        -110.0, 95.0, generator=gen)
    x[:5] = torch.tensor([float("inf"), float("-inf"), 88.5, -87.5, 0.0])
    plan = expf.exp_phase_plan(x.numel())
    want = expf.exp_plain(x)
    walls = {}
    for pipelined in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = execute(plan, {"x": x, "y": torch.empty_like(x)},
                      pipelined=pipelined)["y"]
        torch.cuda.synchronize()
        walls["pipelined" if pipelined else "serial"] = \
            time.perf_counter() - t0
        if got.device.type != "cuda" or not torch.equal(got, want):
            _fail(f"analytic (c): execute(pipelined={pipelined}) is not "
                  f"exp_plain bit for bit")
    expf.exp_cuda.launches = 0
    with torch.no_grad():
        kernel = ops.exp(x, impl="cuda")
    torch.cuda.synchronize()
    launches = expf.exp_cuda.launches
    if launches < 1:
        _fail("analytic (c): the exp kernel was not launched")
    torch.testing.assert_close(got, kernel, rtol=2e-6, atol=1e-30,
                               equal_nan=True)
    on_card = analyze(expf.exp_plain, x)
    on_cpu = analyze(expf.exp_plain, x.cpu())
    if on_card != on_cpu:
        _fail(f"analytic (d): {on_card} on the card, {on_cpu} on the CPU")
    return dict(elements=x.numel(), block=plan.block,
                n_blocks=plan.pipeline.n_blocks, buffers=plan.buffers,
                wall_s=walls, exp_launches=launches,
                max_abs_err_vs_kernel=float(torch.where(
                    got == kernel, 0.0, (got - kernel).abs()).max()),
                analysis=dict(phases=[d.name for d in on_card.phase_domains],
                              n_int=on_card.n_int, n_fp=on_card.n_fp,
                              n_mem=on_card.n_mem,
                              cut_edges=on_card.n_cut_edges))


def analytic_phase(torch, smi) -> int:
    """Phase 8; returns the exp kernel's launches in (c)."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = dict(a=paper_headline(), b=evaluate_sweep(),
               c=plan_on_card(torch, gen), card=smi)
    out["phase_s"] = time.perf_counter() - t0
    print("analytic:", json.dumps(out))
    return out["c"]["exp_launches"]


# ---------------------------------------------------------------------------
# phase 9: the tuner, the tuned tilings and ServeEngine(autotune=True)
# ---------------------------------------------------------------------------

#: ``kernels.ops._tuned_block_rows`` at the default target: the JAX
#: package's values (its own tuner on the CPU, from an empty cache).
TUNED_BLOCK_ROWS = {"expf": 64, "logf": 32, "prng": 32, "softmax": 8}
#: The module default each of those scales.
DEFAULT_ROWS = {"expf": 64, "logf": 64, "prng": 64, "softmax": 8}
TUNE_CAP_MW = 250.0


def tune_host() -> dict:
    """(a) ``Tuner(Target.homogeneous(power_cap_mw=250))``: ``plan``,
    ``block`` and ``operating_point(heterogeneous=True,
    per_island_blocks=True)`` of the five workloads from an empty cache and
    cleared memos, then again warm (equal results, ``plan`` and ``block``
    from the cache); ``_tuned_block_rows`` equal to the JAX package's."""
    from repro_torch import api
    from repro_torch.kernels import ops
    from repro_torch.perf import clear_all
    from repro_torch.tune import BUILTIN_KERNELS

    tuner = api.Tuner(api.Target.homogeneous(power_cap_mw=TUNE_CAP_MW))

    def run():
        t0 = time.perf_counter()
        out = {name: (tuner.plan(name), tuner.block(name),
                      tuner.operating_point(name, heterogeneous=True,
                                            per_island_blocks=True))
               for name in BUILTIN_KERNELS}
        return out, time.perf_counter() - t0

    clear_all()
    cold, cold_s = run()
    warm, warm_s = run()
    for name in BUILTIN_KERNELS:
        for what, c, w in zip(("plan", "block", "operating_point"),
                              cold[name], warm[name]):
            if (c.best, c.best_cost) != (w.best, w.best_cost):
                _fail(f"tune (a): {name} {what} differs warm from cold")
        if not (warm[name][0].from_cache and warm[name][1].from_cache):
            _fail(f"tune (a): {name}'s warm plan or block missed the cache")
    ops._tuned_block_rows.cache_clear()
    rows = {k: ops._tuned_block_rows(k, d) for k, d in DEFAULT_ROWS.items()}
    if rows != TUNED_BLOCK_ROWS:
        _fail(f"tune (a): tuned block rows {rows}, not {TUNED_BLOCK_ROWS}")
    return dict(cold_s=cold_s, warm_s=warm_s, tuned_block_rows=rows,
                results={name: dict(
                    plan=dict(best=p.best.to_dict(),
                              predicted_speedup=p.predicted_speedup),
                    block=b.best.block,
                    operating_point=dict(best=o.best.to_dict(),
                                         cost=vars(o.best_cost)))
                    for name, (p, b, o) in cold.items()})


def tune_measure(torch) -> dict:
    """(b) ``measure_candidates`` on the card for the five workloads, the
    candidates of ``block_ladder(w.max_block)``: every candidate timed
    (finite), the block size each launched (the tiling counters), every
    output equal to the default tiling's and Monte Carlo's to the plain
    version at the same ``n_blocks``; then ``tune(w, measure_top_k=3)`` for
    softmax and expf."""
    from dataclasses import replace

    from repro_torch.kernels import ops
    from repro_torch.tune import (BUILTIN_KERNELS, block_ladder,
                                  candidate_runner, default_space,
                                  get_workload, measure_candidates, tune)

    out = {}
    for name in BUILTIN_KERNELS:
        w = get_workload(name)
        default = default_space(w).default
        cands = [replace(default, block=b) for b in block_ladder(w.max_block)]
        want = candidate_runner(w, default, device="cuda")()
        launched = {}
        for cand in cands:
            counters = _reset_counters()
            got = candidate_runner(w, cand, device="cuda")()
            torch.cuda.synchronize()
            tilings = {k: v for k, v in _tiling_launches(counters).items()
                       if v}
            if name == "montecarlo":
                n_blocks = max(1, round(8 * cand.block / w.max_block))
                launched[cand.block] = dict(n_blocks=n_blocks)
                plain = ops.mc_pi(0, n_samples=max(w.default_problem, 2048),
                                  n_blocks=n_blocks, impl="reference",
                                  device="cuda")
                if counters["montecarlo"].launches != 1 or \
                        not torch.equal(got, plain):
                    _fail(f"tune (b) montecarlo block {cand.block}: "
                          f"{float(got)!r} against the plain version's "
                          f"{float(plain)!r}")
            else:
                if len(tilings) != 1 or not torch.equal(got, want):
                    _fail(f"tune (b) {name} block {cand.block}: launches "
                          f"{tilings}, output equal to the default's: "
                          f"{torch.equal(got, want)}")
                launched[cand.block] = next(iter(tilings.values()))
        times = measure_candidates(w, cands, device="cuda")
        if set(times) != set(cands) or not all(
                math.isfinite(t) for t in times.values()):
            _fail(f"tune (b) {name}: times {times}")
        out[name] = [dict(block=c.block, launched=launched[c.block],
                          us=times[c]) for c in cands]
    refined = {}
    for name in ("softmax", "expf"):
        res = tune(name, measure_top_k=3)
        if len(res.measured_us) != 3 or not all(
                math.isfinite(t) for t in res.measured_us.values()):
            _fail(f"tune (b): tune({name}, measure_top_k=3) measured "
                  f"{res.measured_us}")
        refined[name] = dict(best=res.best.to_dict(),
                             measured_us=res.measured_us)
    return dict(candidates=out, measure_top_k_3=refined)


def tune_serve(torch, smi, state) -> tuple[dict, dict]:
    """(c) OLMo-1B at full width with phase 4's parameters and prompts,
    batch 4, prompt 128, 32 tokens, greedy and sampled (temperature 1.0,
    seed 3): ``ServeEngine`` without and with ``autotune=True,
    power_cap_mw=250``.  The tokens equal (greedy also phase 4 (a)'s); the
    tuned runs launch uniform at 128 threads a block and softmax on its
    warp path at 8 rows a block; ``close()`` restores the tuned-defaults
    setting.  Returns the tuned runs' launches and tiling launches, and
    keeps the tuned sampled tokens in ``state`` for phase 10."""
    import numpy as np

    from repro_torch.configs import load_config
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine

    cfg = load_config("olmo-1b", "full")
    V = cfg.vocab_size
    params = state["params"]
    prompts = np.random.default_rng(0).integers(0, V, (4, 128)).astype(
        np.int32)
    launches = dict.fromkeys(_counters(), 0)
    tilings = {}
    rows, plans = [], {}
    for mode, kw in (("greedy", {}), ("sampled", dict(temperature=1.0,
                                                       seed=3))):
        plain = ServeEngine(cfg, params, max_len=161, batch=4,
                            device="cuda", **kw)
        res_u, row_u = _request(f"tune (c) {mode}, autotune off",
                                lambda: plain.generate(prompts, 32), V)
        untuned = _tiling_launches(_counters())
        before = ops.tuned_defaults_enabled()
        engine = ServeEngine(cfg, params, max_len=161, batch=4,
                             autotune=True, power_cap_mw=TUNE_CAP_MW,
                             device="cuda", **kw)
        res_t, row_t = _request(f"tune (c) {mode}, autotune on",
                                lambda: engine.generate(prompts, 32), V)
        tuned = _tiling_launches(_counters())
        engine.close()
        if ops.tuned_defaults_enabled() != before:
            _fail(f"tune (c) {mode}: close() left tuned defaults "
                  f"{ops.tuned_defaults_enabled()}, not {before}")
        if not np.array_equal(res_u.tokens, res_t.tokens):
            _fail(f"tune (c) {mode}: autotune changed the tokens")
        if mode == "greedy" and not np.array_equal(res_u.tokens,
                                                   state["greedy_tokens"]):
            _fail("tune (c): greedy tokens differ from phase 4 (a)'s")
        if mode == "sampled":
            state["tuned_sampled_tokens"] = res_t.tokens
        _only_path(row_t["request"], row_t["path_launches"]["softmax"],
                   "warp")
        if set(tuned["softmax"]) != {8}:
            _fail(f"tune (c) {mode}: softmax rows a block {tuned['softmax']}")
        if mode == "sampled" and (set(tuned["uniform"]) != {128}
                                  or set(untuned["uniform"]) != {256}):
            _fail(f"tune (c): uniform threads {tuned['uniform']} tuned, "
                  f"{untuned['uniform']} untuned")
        for k, v in row_t["launches"].items():
            launches[k] += v
        for k, by in tuned.items():
            for key, v in by.items():
                tilings.setdefault(k, {})
                tilings[k][key] = tilings[k].get(key, 0) + v
        plans[mode] = {name: dict(best=r.best.to_dict(),
                                  cost=vars(r.best_cost))
                       for name, r in engine.operating_plan.items()}
        rows.append(dict(mode=mode, card=smi,
                         decode_ms_per_token_autotune_off=
                         row_u["decode_ms_per_token"],
                         decode_ms_per_token_autotune_on=
                         row_t["decode_ms_per_token"],
                         tiling_launches_off=untuned,
                         tiling_launches_on=tuned))
        del plain, engine
    if plans["greedy"] != plans["sampled"]:
        _fail("tune (c): the operating plan differs between two engines")
    for r in rows:
        print("tune serve:", json.dumps(r))
    print("tune operating_plan:", json.dumps(plans["greedy"]))
    return launches, tilings


def tune_train() -> dict:
    """(d) ``launch.train.main`` on the olmo-1b smoke model on the card, 3
    steps, without and with ``--autotune``: bit-equal losses; the process
    default is restored after the tuned run."""
    from repro_torch.kernels import ops

    argv = ["--arch", "olmo-1b", "--variant", "smoke", "--steps", "3",
            "--batch", "4", "--seq", "128", "--log-every", "1",
            "--device", "cuda"]
    plain, _ = _train_main(argv)
    before = ops.tuned_defaults_enabled()
    try:
        tuned, text = _train_main(argv + ["--autotune"])
    finally:
        ops.set_tuned_defaults(before)
    if "[tune] kernel block tilings autotuned" not in text:
        _fail("tune (d): --autotune printed no [tune] line")
    losses = [r["loss"] for r in plain]
    if [r["loss"] for r in tuned] != losses:
        _fail(f"tune (d): losses {[r['loss'] for r in tuned]} with "
              f"--autotune, {losses} without")
    return dict(losses=losses)


def tune_phase(torch, smi, state) -> tuple[dict, dict]:
    """Phase 9, with the port's tune cache in a temporary directory.
    Returns (c)'s launches and tiling launches."""
    import os
    import tempfile

    t0 = time.perf_counter()
    prev = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    with tempfile.TemporaryDirectory() as d:
        os.environ["REPRO_TORCH_TUNE_CACHE"] = str(Path(d) / "cache.json")
        try:
            host = tune_host()
            print("tune host:", json.dumps(dict(host, card=smi)))
            measured = tune_measure(torch)
            print("tune measure:", json.dumps(dict(measured, card=smi)))
            launches, tilings = tune_serve(torch, smi, state)
            trained = tune_train()
            print("tune train:", json.dumps(trained))
        finally:
            if prev is None:
                os.environ.pop("REPRO_TORCH_TUNE_CACHE", None)
            else:
                os.environ["REPRO_TORCH_TUNE_CACHE"] = prev
    print(f"tune: phase wall time {time.perf_counter() - t0:.1f} s")
    return launches, tilings


# ---------------------------------------------------------------------------
# phase 10: the rest of obs, the manycore model and ServeEngine(system=...)
# ---------------------------------------------------------------------------

#: ``Tuner(Target.system(4 Snitch clusters, power_cap_mw=1000))
#: .operating_point(name, n_clusters=4)``: (n_clusters, power_mw, time_ns),
#: the JAX package's values on the CPU.  The energy objective keeps one
#: cluster.
SYSTEM_PLAN = {"softmax": (1, 88.12124816086316, 208912.0),
               "prng": (1, 78.87609989543954, 205360.0)}
SYSTEM_CAP_MW = 1000.0
#: ``Tuner(Target.homogeneous(power_cap_mw=250)).attribute(name).delta``.
ATTRIBUTION_DELTAS = {"expf": -2, "softmax": -4}
#: ``api.evaluate("expf", Target.system(4)).speedup``.
EXPF_SYSTEM4_SPEEDUP = 2.1197842747658244


def _module_cli(args: list, tmp: Path) -> subprocess.CompletedProcess:
    """``python -m <args>`` with the checkout's ``src`` on the path."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m"] + args, env=env, cwd=tmp,
                          capture_output=True, text=True, timeout=300)


def obs_host(tmp: Path) -> dict:
    """(a) Observability over the analytic model, on the host:
    ``python -m repro_torch.obs.trace`` for expf and softmax (8 cores,
    ``--json --out``), exit 0 and both documents parse, expf's reconcile ok
    with 60 checks; the tuner's attribution of expf and softmax exact with
    deltas of -2 and -4 cycles; a history store whose third record raises
    one ``*cycles*`` metric 50 % fails ``python -m repro_torch.obs.history
    --check`` with exit 1; ``obs.report.save_report`` writes the trace, the
    attribution and the history into one HTML file."""
    from repro_torch import api
    from repro_torch.obs import history, report
    from repro_torch.obs.trace import trace_kernel

    traces = {}
    for name in ("expf", "softmax"):
        out = tmp / f"trace_{name}.json"
        t0 = time.perf_counter()
        proc = _module_cli(["repro_torch.obs.trace", name, "--cores", "8",
                            "--json", "--out", str(out)], tmp)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            _fail(f"obs (a): obs.trace {name} exited {proc.returncode}: "
                  f"{proc.stderr[-2000:]}")
        doc = json.loads(proc.stdout)
        if not json.loads(out.read_text())["traceEvents"]:
            _fail(f"obs (a): the {name} Chrome trace has no events")
        traces[name] = dict(wall_s=wall, reconcile=doc["reconcile"],
                            n_events=doc["n_events"], result=doc["result"])
    if traces["expf"]["reconcile"] != {"ok": True, "n_checks": 60}:
        _fail(f"obs (a): expf reconcile {traces['expf']['reconcile']}")

    tuner = api.Tuner(api.Target.homogeneous(power_cap_mw=TUNE_CAP_MW))
    t0 = time.perf_counter()
    atts = {name: tuner.attribute(name) for name in ATTRIBUTION_DELTAS}
    attrib_s = time.perf_counter() - t0
    for name, att in atts.items():
        print(att.render())
        if not att.exact or att.delta != ATTRIBUTION_DELTAS[name]:
            _fail(f"obs (a): {name} attribution exact={att.exact} delta "
                  f"{att.delta}, not exact with {ATTRIBUTION_DELTAS[name]}")

    store = tmp / "history.jsonl"
    for i, cycles in enumerate((1000.0, 1000.0, 1500.0)):
        history.append_record({"fig2/expf/cycles": cycles,
                               "tune/expf/speedup": 1.5},
                              source="chip_smoke", path=store,
                              sha="chip_smoke", ts=float(i))
    proc = _module_cli(["repro_torch.obs.history", "--path", str(store),
                        "--check"], tmp)
    if proc.returncode != 1 or "history.hard" not in proc.stdout:
        _fail(f"obs (a): history --check exited {proc.returncode}, not 1 "
              f"on a 50 % cycles regression: {proc.stdout[-1000:]}")

    sess, rep, checks = trace_kernel("expf", n_cores=8)
    html = tmp / "report.html"
    report.save_report(html, trace=sess, attribution=list(atts.values()),
                       history=store, title="chip_smoke phase 10")
    text = html.read_text()
    if not (checks["ok"] and "Per-lane issue timeline" in text
            and "Attribution waterfall" in text and "Metric trends" in text):
        _fail("obs (a): the HTML report lacks a section")
    return dict(trace_cli=traces, attribution_s=attrib_s,
                attribution={k: dict(exact=a.exact, delta=a.delta,
                                     kind=a.kind)
                             for k, a in atts.items()},
                history_check_rc=proc.returncode, report_bytes=len(text))


def system_host() -> dict:
    """(b) The manycore model on the host: every simulatable spec on a
    1-cluster system equals ``Target.homogeneous()`` with ``==``; expf on 4
    clusters has the JAX package's speedup; expf's weak and strong scaling
    and the cluster roofline printed as a table."""
    from repro_torch import api
    from repro_torch.cluster import SNITCH_CLUSTER, analytics
    from repro_torch.system import SystemConfig

    one = api.Target.system(SystemConfig.homogeneous(1, SNITCH_CLUSTER))
    names = [s.name for s in api.specs() if s.simulatable]
    for name in names:
        if api.evaluate(name, one) != api.evaluate(name,
                                                   api.Target.homogeneous()):
            _fail(f"system (b): {name} on a 1-cluster system differs from "
                  "the cluster")
    speedup = api.evaluate("expf", api.Target.system(4)).speedup
    if speedup != EXPF_SYSTEM4_SPEEDUP:
        _fail(f"system (b): expf speedup {speedup!r} on 4 clusters")
    weak = analytics.weak_scaling("expf")
    strong = analytics.strong_scaling("expf")
    rows = list(zip([r.n_cores for r in weak],
                    [r.cycles_copift for r in weak],
                    analytics.scaling_efficiency(weak),
                    [r.cycles_copift for r in strong],
                    analytics.scaling_efficiency(strong)))
    print("system (b): cores, weak cycles, weak eff, strong cycles (48 "
          "blocks), strong eff")
    for row in rows:
        print("system (b): " + ", ".join(f"{v:g}" for v in row))
    roof = analytics.cluster_roofline()
    for p in roof:
        print(f"system (b): roofline {p.name}: OI {p.oi_flops_per_byte:g} "
              f"flop/B, attainable {p.attainable_gflops:g} GFLOP/s, "
              f"achieved {p.achieved_gflops:g}, {p.bound}-bound")
    if not all(math.isfinite(e) and e > 0 for r in rows for e in r[1:]):
        _fail(f"system (b): scaling rows {rows}")
    return dict(cluster_equivalent=names, expf_speedup_4_clusters=speedup,
                scaling=rows)


def system_serve(torch, smi, state, tmp: Path) -> tuple[dict, dict]:
    """(c) OLMo-1B at full width with phase 4's parameters and prompts,
    batch 4, prompt 128, 32 tokens, greedy and sampled, served by
    ``ServeEngine(autotune=True, power_cap_mw=1000, system=4 Snitch
    clusters)`` inside ``obs.session(trace=True, metrics=True)``.  Tokens
    equal phase 4 (a)'s (greedy) and phase 9's tuned engine's (sampled);
    ``system_plan`` is the JAX package's; the session holds the
    ``serve.plan.system.*`` gauges and ``serve.autotune.wall_s`` and its
    saved Chrome trace the ``serve.autotune`` span; softmax on its warp
    path at 8 rows a block, uniform at 128 threads; ``close()`` restores
    the tuned defaults.  Returns the two requests' launches and tiling
    launches."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.cluster import SNITCH_CLUSTER
    from repro_torch.configs import load_config
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.system import SystemConfig

    cfg = load_config("olmo-1b", "full")
    V = cfg.vocab_size
    prompts = np.random.default_rng(0).integers(0, V, (4, 128)).astype(
        np.int32)
    system = SystemConfig.homogeneous(4, SNITCH_CLUSTER)
    want = {"greedy": state["greedy_tokens"],
            "sampled": state["tuned_sampled_tokens"]}
    launches = dict.fromkeys(_counters(), 0)
    tilings = {}
    for mode, kw in (("greedy", {}), ("sampled", dict(temperature=1.0,
                                                       seed=3))):
        before = ops.tuned_defaults_enabled()
        with obs.session(trace=True, metrics=True) as sess:
            engine = ServeEngine(cfg, state["params"], max_len=161, batch=4,
                                 autotune=True, power_cap_mw=SYSTEM_CAP_MW,
                                 system=system, device="cuda", **kw)
            res, row = _request(f"system (c) {mode}",
                                lambda: engine.generate(prompts, 32), V)
            tiled = _tiling_launches(_counters())
            engine.close()
        if ops.tuned_defaults_enabled() != before:
            _fail(f"system (c) {mode}: close() left tuned defaults "
                  f"{ops.tuned_defaults_enabled()}, not {before}")
        if not np.array_equal(res.tokens, want[mode]):
            _fail(f"system (c) {mode}: tokens differ from "
                  f"{'phase 4 (a)' if mode == 'greedy' else 'phase 9'}'s")
        plan = {name: (p.n_clusters, p.best_cost.power_mw,
                       p.best_cost.time_ns)
                for name, p in engine.system_plan.items()}
        if plan != SYSTEM_PLAN:
            _fail(f"system (c) {mode}: system plan {plan}")
        m = sess.metrics()
        gauges = {f"serve.plan.system.{name}.{k}": v
                  for name, vals in plan.items()
                  for k, v in zip(("n_clusters", "power_mw", "time_ns"),
                                  vals)}
        got = {k: m.get(k, {}).get("value") for k in gauges}
        if got != gauges or "serve.autotune.wall_s" not in m:
            _fail(f"system (c) {mode}: gauges {got}")
        trace = tmp / f"serve_{mode}.json"
        sess.save(trace)
        spans = {e["name"] for e in json.loads(trace.read_text())[
            "traceEvents"] if e.get("cat") == "span"}
        if "serve.autotune" not in spans:
            _fail(f"system (c) {mode}: spans {sorted(spans)}")
        _only_path(row["request"], row["path_launches"]["softmax"], "warp")
        if set(tiled["softmax"]) != {8}:
            _fail(f"system (c) {mode}: softmax rows a block "
                  f"{tiled['softmax']}")
        if mode == "sampled" and set(tiled["uniform"]) != {128}:
            _fail(f"system (c): uniform threads {tiled['uniform']}")
        for k, v in row["launches"].items():
            launches[k] += v
        for k, by in tiled.items():
            for key, v in by.items():
                tilings.setdefault(k, {})
                tilings[k][key] = tilings[k].get(key, 0) + v
        print("system serve:", json.dumps(dict(
            mode=mode, card=smi,
            decode_ms_per_token=row["decode_ms_per_token"],
            prefill_ms=row["prefill_ms"],
            autotune_wall_s=m["serve.autotune.wall_s"]["value"],
            system_plan=plan, spans=sorted(spans), tiling_launches=tiled)))
        del engine
    return launches, tilings


def obs_system_phase(torch, smi, state) -> tuple[dict, dict]:
    """Phase 10, with the port's tune cache in a temporary directory.
    Returns (c)'s launches and tiling launches."""
    import os
    import tempfile

    t0 = time.perf_counter()
    prev = os.environ.get("REPRO_TORCH_TUNE_CACHE")
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        os.environ["REPRO_TORCH_TUNE_CACHE"] = str(tmp / "cache.json")
        try:
            t = time.perf_counter()
            host = obs_host(tmp)
            print("obs host:", json.dumps(dict(
                host, wall_s=time.perf_counter() - t, card=smi)))
            t = time.perf_counter()
            model = system_host()
            print("system host:", json.dumps(dict(
                model, wall_s=time.perf_counter() - t, card=smi)))
            launches, tilings = system_serve(torch, smi, state, tmp)
        finally:
            if prev is None:
                os.environ.pop("REPRO_TORCH_TUNE_CACHE", None)
            else:
                os.environ["REPRO_TORCH_TUNE_CACHE"] = prev
    print(f"obs/system: phase wall time {time.perf_counter() - t0:.1f} s")
    return launches, tilings


# ---------------------------------------------------------------------------
# phase 11: the serving simulator, resilience, remat="dots" and compression
# ---------------------------------------------------------------------------

#: The JAX package's ``benchmarks/serve_bench.py`` scenario, full duration.
SERVE_BENCH = dict(
    spec="bursty:rate=860,burst=2.33,period_ms=1200,duty=0.22,"
         "kernel=softmax,elems=65536",
    seed=11, duration_ms=2400.0, slo_ms=10.0, epoch_ms=10.0, queue_cap=256)
#: What the JAX package's simulator gives on that scenario on the CPU
#: (Snitch-model milliseconds and microjoules): policy -> (p50, p99,
#: energy_uj).
SERVE_BENCH_JAX = {
    "static": (3.9397786666667116, 14.212271083697772, 255024.96359763845),
    "reactive": (5.909668000000011, 50.21503071665393, 220554.17025515574),
    "mpc": (2.9617560000001504, 8.00493583561979, 237295.72844955628)}
#: The JAX package's ``benchmarks/resilience_bench.py`` scenario.
RESILIENCE_BENCH = dict(
    spec="poisson:rate=1500,kernel=softmax,elems=65536", seed=11,
    duration_ms=200.0,
    faults="corefail@60:c0.0,corefail@60:c0.1,corefail@120:c0.2",
    slo_ms=25.0, epoch_ms=10.0, queue_cap=256,
    retry=dict(max_attempts=3, timeout_ms=25.0, backoff=2.0,
               base_delay_ms=0.5))
#: (completed, requests, slo_violations) of naive and failover there, the
#: JAX package's on the CPU.
RESILIENCE_BENCH_JAX = {"naive": (283, 288, 13), "failover": (288, 288, 0)}


def _sim_row(rep) -> dict:
    """A ``SimReport``'s figures; times and energies are the Snitch
    model's, not the card's."""
    return dict(policy=rep.policy, requests=rep.n_requests,
                completed=rep.n_completed, dropped=rep.n_dropped,
                lost=rep.n_lost, retried=rep.n_retried,
                batches_killed=rep.n_failed, failovers=rep.failovers,
                model_p50_ms=rep.latency_ms["p50"],
                model_p99_ms=rep.latency_ms["p99"],
                model_energy_uj=rep.energy_uj,
                plan_switches=rep.plan_switches, slo_met=rep.slo_met,
                slo_violations=rep.slo_violations)


def sim_host() -> tuple[dict, dict]:
    """(a) The serve_bench scenario through the port's simulator, three
    policies: static misses the p99 SLO, mpc meets it at no more energy
    than static, a second mpc run is ``==``, and every policy's p50, p99
    and energy equal the JAX package's.  Returns (the rows, the healthy
    static report and its trace for (b))."""
    from repro_torch.serve import (POLICIES, ModelPredictivePolicy,
                                   ServicePricer, SloSpec, make_trace,
                                   simulate)
    sb = SERVE_BENCH
    trace = make_trace(sb["spec"], duration_ms=sb["duration_ms"],
                       seed=sb["seed"])
    kw = dict(slo=SloSpec(latency_ms=sb["slo_ms"]), pricer=ServicePricer(),
              epoch_ms=sb["epoch_ms"], queue_cap=sb["queue_cap"])
    t0 = time.perf_counter()
    reps = {name: simulate(trace, f(trace.mean_rate_rps), **kw)
            for name, f in POLICIES.items()}
    wall = time.perf_counter() - t0
    rerun = simulate(trace, ModelPredictivePolicy(), **kw)
    static, mpc = reps["static"], reps["mpc"]
    if static.slo_met:
        _fail("sim (a): static met the p99 SLO")
    if not mpc.slo_met or mpc.energy_uj > static.energy_uj:
        _fail(f"sim (a): mpc slo_met={mpc.slo_met}, energy "
              f"{mpc.energy_uj!r} uJ vs static's {static.energy_uj!r}")
    if rerun != mpc:
        _fail("sim (a): a second mpc run differs")
    for name, rep in reps.items():
        got = (rep.latency_ms["p50"], rep.latency_ms["p99"], rep.energy_uj)
        if got != SERVE_BENCH_JAX[name]:
            _fail(f"sim (a): {name} (p50, p99, energy) {got}, the JAX "
                  f"package's {SERVE_BENCH_JAX[name]}")
    rows = dict(scenario=dict(sb, n_requests=trace.n_requests,
                              mean_rate_rps=trace.mean_rate_rps),
                units="Snitch-model ms and uJ (host simulation, not card "
                      "time)",
                policies=[_sim_row(reps[n]) for n in POLICIES],
                three_policies_wall_s=wall)
    return rows, dict(trace=trace, kw=kw, static=static)


def resilience_host(healthy: dict) -> dict:
    """(b) The resilience_bench scenario: failover completes at least the
    naive policy's fraction with fewer SLO violations (the JAX package's
    288/288 and 0 against 283 and 13), a replay is ``==``, an empty
    ``FaultTrace`` leaves (a)'s static report ``==``; then
    ``api.evaluate(faults=...)`` on a cluster target and on
    ``Target.system("2x8c,hbm=256")``: a core death and a throttle window
    each slower than fault-free, an HBM window slower on the system (on a
    cluster target, which has no HBM port in the model, the identity),
    the empty trace ``==`` fault-free, and every core dead raises
    ``AllCoresDeadError``."""
    from repro_torch import api
    from repro_torch.resilience import AllCoresDeadError, FaultState
    from repro_torch.serve import (FailoverPolicy, RetryPolicy,
                                   ServicePricer, SloSpec, SlotPlan,
                                   StaticPolicy, make_faults, make_trace,
                                   simulate)
    rb = RESILIENCE_BENCH
    trace = make_trace(rb["spec"], duration_ms=rb["duration_ms"],
                       seed=rb["seed"])
    kw = dict(slo=SloSpec(latency_ms=rb["slo_ms"]), pricer=ServicePricer(),
              epoch_ms=rb["epoch_ms"], queue_cap=rb["queue_cap"],
              faults=make_faults(rb["faults"],
                                 duration_ms=rb["duration_ms"]))
    plan = SlotPlan(n_slots=4, point="1.00GHz@0.80V", batch_max=4)
    retry = RetryPolicy(**rb["retry"])
    t0 = time.perf_counter()
    reps = {"naive": simulate(trace, StaticPolicy(plan=plan), **kw),
            "failover": simulate(trace, FailoverPolicy(
                StaticPolicy(plan=plan), headroom_slots=1), retry=retry,
                **kw)}
    wall = time.perf_counter() - t0
    replay = simulate(trace, FailoverPolicy(StaticPolicy(plan=plan),
                                            headroom_slots=1),
                      retry=retry, **kw)
    naive, fo = reps["naive"], reps["failover"]
    if not (fo.completed_frac >= naive.completed_frac
            and fo.slo_violations < naive.slo_violations):
        _fail(f"resilience (b): failover {fo.completed_frac} / "
              f"{fo.slo_violations} violations vs naive "
              f"{naive.completed_frac} / {naive.slo_violations}")
    for name, rep in reps.items():
        got = (rep.n_completed, rep.n_requests, rep.slo_violations)
        if got != RESILIENCE_BENCH_JAX[name]:
            _fail(f"resilience (b): {name} {got}, the JAX package's "
                  f"{RESILIENCE_BENCH_JAX[name]}")
    if replay != fo:
        _fail("resilience (b): the failover replay differs")
    empty = simulate(healthy["trace"],
                     StaticPolicy(rate_rps=healthy["trace"].mean_rate_rps),
                     faults=make_faults(
                         "", duration_ms=healthy["trace"].duration_ms),
                     **healthy["kw"])
    if empty != healthy["static"]:
        _fail("resilience (b): an empty FaultTrace changed (a)'s static "
              "report")

    evals = {}
    for label, target, n_clusters in (
            ("cluster", api.Target(), 1),
            ("system 2x8c,hbm=256", api.Target.system("2x8c,hbm=256"), 2)):
        base = api.evaluate("expf", target, total_blocks=64)
        row = dict(fault_free_us=base.time_us)
        for kind, spec in (("core death", "corefail@1:c0.0"),
                           ("throttle", "throttle@5-9:isl0>0.6GHz"),
                           ("hbm", "hbm@20-30:0.01x")):
            tr = make_faults(spec, duration_ms=50.0, n_clusters=n_clusters,
                             cores_per_cluster=8)
            t = tr.events[0].t_ms
            rep = api.evaluate("expf", target, total_blocks=64, faults=tr,
                               fault_t_ms=t)
            row[f"{kind}_us"] = rep.time_us
            identity = kind == "hbm" and n_clusters == 1
            if identity and rep != base:
                _fail(f"resilience (b): an HBM window changed the {label} "
                      "Report")
            if not identity and not rep.time_us > base.time_us:
                _fail(f"resilience (b): {kind} on {label}: "
                      f"{rep.time_us!r} us, fault-free {base.time_us!r}")
        if api.evaluate("expf", target, total_blocks=64,
                        faults=make_faults("")) != base:
            _fail(f"resilience (b): the empty trace changed the {label} "
                  "Report")
        try:
            api.evaluate("expf", target, faults=FaultState(
                dead_clusters=tuple(range(n_clusters))))
        except AllCoresDeadError:
            pass
        else:
            _fail(f"resilience (b): all cores dead on {label} did not "
                  "raise AllCoresDeadError")
        evals[label] = row
    return dict(scenario=dict(rb, n_requests=trace.n_requests),
                units="Snitch-model ms and uJ, model microseconds (host "
                      "simulation, not card time)",
                policies=[_sim_row(reps[n]) for n in ("naive", "failover")],
                two_runs_wall_s=wall, evaluate_faults=evals)


def _remat_run(torch, cfg, steps: int, compress: bool) -> tuple:
    """``steps`` train steps of a fresh seeded full-width state on the
    pipeline's batches, every launch counter at 0 first.  Returns (the
    rows, launches, launches by path, seconds a step, peak bytes)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    torch.cuda.empty_cache()
    state = _full_state(torch, cfg)
    pipe = TokenPipeline(cfg, ShapeConfig("remat", 2048, 4, "train"),
                         device="cuda")
    fn = make_train_step(cfg, AdamWConfig(warmup_steps=1,
                                          total_steps=steps),
                         compress_pod_grads=compress)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        rows, secs = [], []
        for step in range(steps):
            t0 = time.perf_counter()
            _, m = fn(state, pipe.host_batch_at(step))
            rows.append(dict(step=step, loss=float(m["loss"]),
                             grad_norm=float(m["grad_norm"])))
            secs.append(time.perf_counter() - t0)
        return rows, secs

    (rows, secs), launches, paths, _ = _main_path_run(torch, run)
    peak = torch.cuda.max_memory_allocated()
    del state, fn
    return rows, launches, paths, secs, peak


@contextlib.contextmanager
def _saved_by_dots():
    """Record what ``remat="dots"``'s policy keeps in the forward passes
    inside the block: (op name, output elements, bytes) of every op it
    marks to save."""
    from repro_torch.models import transformer
    policy, saved = transformer._dots_policy, []

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and \
                decision == transformer.CheckpointPolicy.MUST_SAVE:
            a, b = args[0], args[1]
            n = a.shape[0] * b.shape[1]
            saved.append((str(op), n, n * a.element_size()))
        return decision

    transformer._dots_policy = spy
    try:
        yield saved
    finally:
        transformer._dots_policy = policy


def remat_train(torch, smi) -> dict:
    """(c) OLMo-1B at full width (batch 4 x seq 2048, fp32 masters, bf16
    compute, seeded parameters), 3 steps each under ``remat="full"``,
    ``remat="dots"`` and ``"dots"`` with ``compress_pod_grads=True``:
    finite values; ``dots``' losses and grad norms equal ``full``'s (loss
    rtol 1e-4, grad norm 1e-3, as (f)); the compressed run's first loss
    equals the uncompressed one's; softmax launches 32 times a step, on
    its cluster path, under both remat modes.  Prints ms/step, tokens/s
    and peak memory of each.  Returns the ``dots`` run's launches."""
    from repro_torch.configs import load_config
    steps = 3
    base = load_config("olmo-1b", "full")
    runs = {}
    saved_per_step = None
    for label, remat, compress in (("full", "full", False),
                                   ("dots", "dots", False),
                                   ("dots+int8", "dots", True)):
        with _saved_by_dots() as saved:
            rows, launches, paths, secs, peak = _remat_run(
                torch, base.replace(remat=remat), steps, compress)
        _check_finite(f"(c) {label}", rows)
        if remat == "full" and saved:
            _fail(f"(c) full: the dots policy ran ({len(saved)} ops)")
        if remat == "dots":
            # q, k, v, o, gate, up and down of each layer, each step.
            want = 7 * base.n_layers * steps
            if len(saved) != want or {op for op, _, _ in saved} != \
                    {"aten.mm.default"}:
                _fail(f"(c) {label}: saved {len(saved)} ops "
                      f"{sorted({op for op, _, _ in saved})}, not {want} "
                      "aten.mm")
            saved_per_step = dict(
                ops=len(saved) // steps,
                values_per_token_layer=sum(n for _, n, _ in saved)
                // (steps * base.n_layers * 4 * 2048),
                gb=sum(b for _, _, b in saved) / steps / 1e9)
        ms = statistics.median(secs[1:]) * 1e3
        runs[label] = dict(rows=rows, launches=launches, paths=paths)
        if label != "dots+int8":
            if launches["softmax"] != 32 * steps:
                _fail(f"(c) {label}: softmax launched "
                      f"{launches['softmax']} times in {steps} steps, not "
                      "32 a step")
            _only_path(f"(c) {label}", paths["softmax"], "cluster")
        print("remat:", json.dumps(dict(
            phase=f"c: OLMo-1B full width, batch 4 x seq 2048, bf16 "
                  f"compute, fp32 masters, remat {remat}"
                  + (", int8 gradient compression" if compress else ""),
            card=smi, steps=steps, ms_per_step=ms,
            ms_per_step_all=[t * 1e3 for t in secs],
            tokens_per_s=4 * 2048 / (ms / 1e3), peak_memory_gb=peak / 1e9,
            dots_saved_per_step=saved_per_step if remat == "dots" else None,
            losses=[r["loss"] for r in rows],
            grad_norms=[r["grad_norm"] for r in rows],
            launches_per_step={k: v / steps for k, v in launches.items()},
            path_launches_per_step={k: {p: v / steps for p, v in by.items()}
                                    for k, by in paths.items()})))
    full, dots, comp = (runs[k]["rows"] for k in ("full", "dots",
                                                  "dots+int8"))
    for a, b in zip(dots, full):
        if not math.isclose(a["loss"], b["loss"], rel_tol=1e-4):
            _fail(f"(c): dots loss {a['loss']!r} vs full's {b['loss']!r}")
        if not math.isclose(a["grad_norm"], b["grad_norm"], rel_tol=1e-3):
            _fail(f"(c): dots grad norm {a['grad_norm']!r} vs full's "
                  f"{b['grad_norm']!r}")
    if comp[0]["loss"] != dots[0]["loss"]:
        _fail(f"(c): the compressed run's first loss {comp[0]['loss']!r} "
              f"differs from the uncompressed one's {dots[0]['loss']!r}")
    print("remat: dots against full: losses bit-equal "
          f"{[a['loss'] == b['loss'] for a, b in zip(dots, full)]}, grad "
          f"norms bit-equal "
          f"{[a['grad_norm'] == b['grad_norm'] for a, b in zip(dots, full)]}"
          f"; compressed first loss equal: True")
    return runs["dots"]["launches"]


def sim_resilience_phase(torch, smi) -> dict:
    """Phase 11.  Returns (c)'s ``remat="dots"`` launches."""
    t0 = time.perf_counter()
    rows, healthy = sim_host()
    print("sim (a):", json.dumps(dict(rows, card=smi)))
    res = resilience_host(healthy)
    print("resilience (b):", json.dumps(dict(res, card=smi)))
    launches = remat_train(torch, smi)
    print(f"sim/resilience/remat: phase wall time "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _train_both(torch, cfg, shape, mesh, steps: int):
    """``cfg`` trained ``steps`` steps on ``shape``'s batches from the token
    pipeline, unsharded (``make_train_step``) and then through
    ``launch.dryrun._step_and_specs`` with every state tensor and batch
    placed by the rule table on ``mesh``, from the same seed; then one more
    sharded step under ``StepCounter``.  Returns (unsharded run, sharded
    run, counter, rules, batch spec); a run is (rows of loss and grad
    norm, seconds a step, launches, launches by path, peak bytes)."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import dryrun
    from repro_torch.launch.comm_analysis import StepCounter
    from repro_torch.parallel.sharding import ShardingRules, distribute
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import make_train_step

    pipe = TokenPipeline(cfg, shape, device="cuda")
    rules = ShardingRules(cfg, mesh, shape)
    bspec = rules.batch_spec(shape)

    def train(fn, state, place_batch):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run():
            rows, secs = [], []
            for step in range(steps):
                t0 = time.perf_counter()
                _, m = fn(state, place_batch(pipe.host_batch_at(step)))
                rows.append({k: float(m[k].full_tensor()
                                      if hasattr(m[k], "full_tensor")
                                      else m[k])
                             for k in ("loss", "grad_norm")})
                secs.append(time.perf_counter() - t0)
            return rows, secs

        (rows, secs), launches, paths, _ = _main_path_run(torch, run)
        return rows, secs, launches, paths, torch.cuda.max_memory_allocated()

    _free(torch)
    state = _full_state(torch, cfg)
    plain = train(make_train_step(cfg, AdamWConfig()), state, lambda b: b)
    del state
    _free(torch)
    fn, _, place = dryrun._step_and_specs(cfg, shape, rules, mesh)
    state, _ = place((_full_state(torch, cfg), pipe.host_batch_at(0)))

    def place_batch(b):
        return {k: distribute(v, bspec + (None,) * (v.ndim - 2), mesh)
                for k, v in b.items()}

    sharded = train(fn, state, place_batch)
    with StepCounter() as counter:
        fn(state, place_batch(pipe.host_batch_at(steps)))
    torch.cuda.synchronize()
    del state
    _free(torch)
    return plain, sharded, counter, rules, bspec


def _train_both_row(plain, sharded, counter, rules, bspec, steps) -> dict:
    """The printed fields of ``_train_both``'s runs."""
    (prow, psecs, _, _, ppeak), (srow, ssecs, launches, paths, speak) = \
        plain, sharded
    return dict(
        steps=steps, use_tp=rules.use_tp, fsdp=rules.fsdp, ep=rules.ep,
        dp_axes=rules.dp_axes, batch_spec=bspec,
        ms_per_step=statistics.median(ssecs[1:]) * 1e3,
        ms_per_step_all=[t * 1e3 for t in ssecs],
        unsharded_ms_per_step=statistics.median(psecs[1:]) * 1e3,
        unsharded_ms_per_step_all=[t * 1e3 for t in psecs],
        peak_memory_gb=speak / 1e9, unsharded_peak_memory_gb=ppeak / 1e9,
        losses=[r["loss"] for r in srow],
        unsharded_losses=[r["loss"] for r in prow],
        grad_norms=[r["grad_norm"] for r in srow],
        unsharded_grad_norms=[r["grad_norm"] for r in prow],
        losses_bit_equal=[a["loss"] == b["loss"] for a, b in zip(srow, prow)],
        grad_norms_bit_equal=[a["grad_norm"] == b["grad_norm"]
                              for a, b in zip(srow, prow)],
        launches_per_step={k: v / steps for k, v in launches.items()},
        path_launches_per_step={k: {p: v / steps for p, v in by.items()}
                                for k, by in paths.items()},
        collectives_one_step=counter.collective_bytes())


def _sharded_runs(torch, smi, mesh) -> dict:
    """(a): OLMo-1B trained 3 steps unsharded, then 3 through the rule
    table's placements on ``mesh``.  Returns the sharded run's launches."""
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig

    steps = 3
    cfg = load_config("olmo-1b", "full").replace(remat="full")
    shape = ShapeConfig("sharded", 2048, 4, "train")
    runs = _train_both(torch, cfg, shape, mesh, steps)
    (prow, *_), (srow, _, launches, paths, _) = runs[:2]
    for a, b in zip(srow, prow):
        for k in ("loss", "grad_norm"):
            if not math.isclose(a[k], b[k], rel_tol=1e-4):
                _fail(f"(a): sharded {k} {a[k]!r} vs unsharded {b[k]!r}")
    if launches["softmax"] != 32 * steps or launches["uniform"] != 2 * steps:
        _fail(f"(a): launches {launches} in {steps} sharded steps, not "
              "softmax 32 and uniform 2 a step")
    _only_path("(a) sharded", paths["softmax"], "cluster")
    print("sharded (a):", json.dumps(dict(
        phase="a: OLMo-1B full width, batch 4 x seq 2048, bf16 compute, "
              "fp32 masters, remat full, on a (1, 1) NCCL mesh through the "
              "rule table's DTensor placements, against the unsharded step",
        card=smi, **_train_both_row(*runs, steps))))
    return launches


def _collectives_and_restore(torch, smi, mesh) -> None:
    """(c): ``compressed_psum`` and ``elastic_restore`` on ``mesh``."""
    from repro_torch.configs import load_config
    from repro_torch.models.model import init_params
    from repro_torch.parallel.compress import (compressed_psum,
                                               quantize_dequantize)
    from repro_torch.parallel.sharding import ShardingRules
    from repro_torch.train.fault import CheckpointManager, elastic_restore
    from repro_torch.train.train_step import (distribute_train_state,
                                              init_train_state)

    gen = torch.Generator(device="cuda").manual_seed(5)
    g = torch.randn(4096, 1024, generator=gen, device="cuda")
    got = compressed_psum(g, mesh.get_group("data"))
    if not torch.equal(got, quantize_dequantize(g)[0]):
        _fail("(c): compressed_psum over one rank differs from "
              "quantize_dequantize")
    cfg = load_config("olmo-1b", "smoke")

    def smoke_state(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return init_train_state(cfg, init_params(
            cfg.replace(dtype=cfg.param_dtype), gen, "cuda"))

    d = ROOT / "build" / "chip_smoke_restore"
    shutil.rmtree(d, ignore_errors=True)
    saved = distribute_train_state(smoke_state(1),
                                   ShardingRules(cfg, mesh)).state_dict()
    manager = CheckpointManager(str(d), async_save=False)
    manager.save(7, saved)
    state, step = elastic_restore(manager, lambda device: smoke_state(0),
                                  "cuda", mesh=mesh, cfg=cfg)
    restored = state.state_dict()
    same = step == 7 and all(torch.equal(restored[k].full_tensor(),
                                         v.full_tensor())
                             for k, v in saved.items())
    shutil.rmtree(d, ignore_errors=True)
    if not same:
        _fail("(c): elastic_restore did not reproduce the saved state")
    print("sharded (c):", json.dumps(dict(
        phase="c: compressed_psum over the mesh's data group (one rank) "
              "against quantize_dequantize; elastic_restore of an olmo-1b "
              "smoke state onto the mesh", card=smi,
        psum_elements=g.numel(), psum_bit_equal=True,
        restored_tensors=len(restored), restored_equal=True, step=step)))


def _dryrun_cells(smi) -> None:
    """(b): two cells of the dry-run in its fake world, on the host."""
    from repro_torch.launch import dryrun
    for arch, shape, mesh in (("olmo-1b", "train_4k", "pod"),
                              ("deepseek-moe-16b", "decode_32k",
                               "multipod")):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh)
        print("sharded (b):", json.dumps(dict(
            rec, phase="b: launch.dryrun.run_cell in a fake world of "
                       f"{rec['devices']} ranks, on the card's host",
            card=smi, wall_s=time.perf_counter() - t0)))


def sharding_phase(torch, smi) -> dict:
    """Phase 12.  Returns (a)'s sharded run's launches."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        launches = _sharded_runs(torch, smi, mesh)
        _collectives_and_restore(torch, smi, mesh)
    finally:
        dist.destroy_process_group()
    _dryrun_cells(smi)
    print(f"sharding: phase wall time {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the sharded path of the MoE and SSM families
# ---------------------------------------------------------------------------

#: The dry-run cells that (d) runs on the card's host, (arch, shape, mesh,
#: variant, with the per-op view): of the repaired families' cells, the
#: full-size ones that finish in about a minute (rwkv6-1.6b and
#: jamba-v0.1-52b x train_4k x pod take ~350 s in the CPU sandbox, and
#: qwen2-vl-72b x prefill_32k x pod ~730 s: their smoke cells, or a smoke
#: cell of the family, stand in), and the cells whose FLOPs or
#: collectives differed between torch versions.
DRYRUN_HOST_CELLS = (
    ("deepseek-moe-16b", "train_4k", "pod", "full", True),
    ("rwkv6-1.6b", "train_4k", "pod", "smoke", False),
    ("qwen2-vl-72b", "decode_32k", "multipod", "smoke", False),
    ("deepseek-moe-16b", "decode_32k", "multipod", "full", True))


@contextlib.contextmanager
def _dtensor_route():
    """Counts, by kernel, the wrapper calls that took the DTensor route
    (``kernels._build.on_local`` given a DTensor: the kernel runs on the
    local shard)."""
    from collections import Counter

    from torch.distributed.tensor import DTensor

    from repro_torch.kernels import _build
    counts, orig = Counter(), _build.on_local

    def on_local(fn, x, what, reduced_dim=None):
        if isinstance(x, DTensor):
            counts[what] += 1
        return orig(fn, x, what, reduced_dim)

    _build.on_local = on_local
    try:
        yield counts
    finally:
        _build.on_local = orig


def _placed_generate(torch, cfg, params, prompts, n_steps: int,
                     temperature: float, seed: int, mesh):
    """``ServeEngine.generate``'s loop through ``_step_and_specs``' decode
    placement on ``mesh``: ``params`` (placed in place) and the cache by the
    rule table, each step's tokens by the batch spec, the engine's own
    sampler on the gathered logits.  Returns (tokens, prefill s, decode
    s)."""
    import numpy as np

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import init_stack_cache
    from repro_torch.parallel.sharding import ShardingRules, distribute
    from repro_torch.serve.engine import ServeEngine

    B, plen = prompts.shape
    max_len = plen + n_steps
    shape = ShapeConfig("serve", max_len, B, "decode")
    rules = ShardingRules(cfg, mesh, shape)
    fn, _, place = dryrun._step_and_specs(cfg, shape, rules, mesh)
    sampler = ServeEngine(cfg, None, max_len, B, temperature, seed,
                          device="cuda")
    seeds = sampler._slot_seeds(prompts)
    toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    params, cache, _, _ = place((params, init_stack_cache(
        cfg, B, max_len, "cuda"), toks[:, :1], 0))
    spec = rules.batch_spec(shape)
    t0 = time.perf_counter()
    logits, cache = fn(params, cache, distribute(toks, spec, mesh), 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [toks]
    for i in range(n_steps):
        tok = sampler._sample(logits.full_tensor(), i, seeds)[:, None]
        out.append(tok)
        if i + 1 < n_steps:
            logits, cache = fn(params, cache, distribute(tok, spec, mesh),
                               plen + i)
    tokens = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
    return tokens, t1 - t0, time.perf_counter() - t1


@contextlib.contextmanager
def _einsum_decode():
    """The unsharded engine's decode attention on the einsum path that the
    placements take (``attention._scores_pv``: DTensors keep it), in place
    of the decode-attention kernels, so that both runs sum alike."""
    from repro_torch.models import attention as A
    kernels = A._decode
    A._decode = lambda cfg, qg, k, v, pos, dt, sp: A._scores_pv(
        cfg, qg, k, v, pos, True, dt)
    try:
        yield
    finally:
        A._decode = kernels


def _serve_both(torch, smi, label, cfg, prompts, n_steps, temperature,
                seed, mesh):
    """``cfg`` at full width served unsharded through ``ServeEngine`` (its
    decode attention on the einsum path, ``_einsum_decode``) and then
    through the rule table's placements on ``mesh`` (the same parameters,
    placed in place): the tokens must be identical.  Returns
    (unsharded launches and paths, sharded launches, paths and DTensor
    route counts, the printed row)."""
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    B, plen = prompts.shape
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    engine = ServeEngine(cfg, params, plen + n_steps, B, temperature, seed,
                         device="cuda")
    with _einsum_decode():
        res, plain, plain_paths, _ = _main_path_run(
            torch, lambda: engine.generate(prompts, n_steps))
    del engine
    with _dtensor_route() as route:
        (tokens, pre_s, dec_s), launches, paths, _ = _main_path_run(
            torch, lambda: _placed_generate(torch, cfg, params, prompts,
                                            n_steps, temperature, seed,
                                            mesh))
    del params
    peak = torch.cuda.max_memory_allocated()
    _free(torch)
    if not (tokens == res.tokens).all():
        _fail(f"{label}: tokens through the placements differ from the "
              f"unsharded engine's:\n{tokens[:, plen:]}\n"
              f"{res.tokens[:, plen:]}")
    row = dict(
        path=label, card=smi, batch=B, prompt=plen, new_tokens=n_steps,
        temperature=temperature, tokens_identical=True,
        new_token_ids=tokens[:, plen:].tolist(),
        prefill_ms=pre_s * 1e3, decode_ms_per_token=dec_s * 1e3 / n_steps,
        unsharded_prefill_ms=res.prefill_s * 1e3,
        unsharded_decode_ms_per_token=res.decode_s * 1e3 / n_steps,
        launches=launches, unsharded_launches=plain,
        path_launches=paths, dtensor_route=dict(route),
        peak_memory_gb=peak / 1e9)
    return plain, launches, paths, route, row


def placed_serve_moe(torch, smi, mesh) -> dict:
    """(a): DeepSeekMoE-16B, full width and depth, batch 4, prompt 128, 8
    greedy tokens.  Returns the sharded run's launches."""
    import numpy as np

    from repro_torch.configs import load_config
    cfg = load_config("deepseek-moe-16b", "full")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 128))
    label = ("a: DeepSeekMoE-16B full width, 28 layers, batch 4, prompt "
             "128, 8 greedy tokens, unsharded and through the rule table's "
             "placements on a (1, 1) NCCL mesh")
    plain, launches, paths, route, row = _serve_both(
        torch, smi, label, cfg, prompts, 8, 0.0, 0, mesh)
    _only_path("(a) sharded", paths["softmax"], "warp")
    if route["softmax"] != launches["softmax"]:
        _fail(f"(a): {launches['softmax']} softmax launches, "
              f"{route['softmax']} of them through the DTensor route")
    if launches != plain or launches["exp"] or launches["uniform"]:
        _fail(f"(a): launches {launches} sharded, {plain} unsharded")
    print("placed (a):", json.dumps(row))
    return launches


def placed_serve_rwkv(torch, smi, mesh) -> dict:
    """(c): RWKV-6 1.6B, full width and depth, batch 4, prompt 128, 8
    tokens sampled at temperature 1 (the uniform kernel).  Returns the
    sharded run's launches."""
    import numpy as np

    from repro_torch.configs import load_config
    cfg = load_config("rwkv6-1.6b", "full")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 128))
    label = ("c: RWKV-6 1.6B full width, 24 layers, batch 4, prompt 128, 8 "
             "tokens sampled at temperature 1.0, seed 3, unsharded and "
             "through the rule table's placements")
    plain, launches, _, _, row = _serve_both(
        torch, smi, label, cfg, prompts, 8, 1.0, 3, mesh)
    if launches != plain or launches["uniform"] != 4 * 8 or \
            launches["softmax"] or launches["exp"]:
        _fail(f"(c): launches {launches} sharded, {plain} unsharded; "
              "uniform once a slot and token, no attention kernel")
    print("placed (c):", json.dumps(row))
    return launches


def placed_serve_jamba(torch, smi, mesh) -> dict:
    """(e): one full-width Jamba period, batch 4, prompt 128, 8 greedy
    tokens, unsharded and through the placements, Mamba's fused
    ``in_proj`` split by ``ssm._halves`` on the NCCL mesh.  Returns the
    sharded run's launches."""
    import numpy as np

    from repro_torch.configs import load_config
    from repro_torch.models import ssm

    cfg = load_config("jamba-v0.1-52b", "full").replace(**JAMBA_PERIOD)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 128))
    label = ("e: Jamba-v0.1 full width, one period of 8 layers (7 Mamba), "
             "batch 4, prompt 128, 8 greedy tokens, unsharded and through "
             "the rule table's placements on a (1, 1) NCCL mesh")
    calls, orig = [], ssm._halves

    def counted(w):
        calls.append(str(tuple(w.placements)))
        return orig(w)

    ssm._halves = counted
    try:
        plain, launches, _, route, row = _serve_both(
            torch, smi, label, cfg, prompts, 8, 0.0, 0, mesh)
    finally:
        ssm._halves = orig
    n_mamba = cfg.layer_types.count("m")
    if len(calls) != n_mamba * 8 or not all(
            c.endswith(", Shard(dim=1))") for c in calls):
        _fail(f"(e): ssm._halves ran {len(calls)} times on {set(calls)}, "
              f"not {n_mamba} a step on in_proj's columns over 'model'")
    if launches != plain or route["softmax"] != launches["softmax"] or \
            launches["uniform"]:
        _fail(f"(e): launches {launches} sharded, {plain} unsharded, "
              f"DTensor route {dict(route)}")
    print("placed (e):", json.dumps(dict(
        row, halves_calls=len(calls), in_proj_placements=sorted(set(calls)),
        parameters=_n_params(cfg))))
    return launches


def placed_train_moe(torch, smi, mesh) -> dict:
    """(b): DeepSeekMoE-16B at full width cut to 2 layers (layer 0 dense,
    layer 1 MoE), batch 4 x seq 2048, ``remat="full"``, 3 steps unsharded
    and 3 through the placements: losses and grad norms bit-equal, the MoE
    layer through the batched per-row dispatch.  Returns the sharded run's
    launches."""
    from repro_torch.configs import load_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import moe

    steps = 3
    cfg = load_config("deepseek-moe-16b", "full").replace(
        n_layers=2, layer_types="aa", remat="full")
    shape = ShapeConfig("sharded", 2048, 4, "train")
    rows_calls, orig = [], moe._dispatch_rows

    def counted(p, c, x):
        rows_calls.append(tuple(x.shape))
        return orig(p, c, x)

    moe._dispatch_rows = counted
    try:
        with _dtensor_route() as route:
            runs = _train_both(torch, cfg, shape, mesh, steps)
    finally:
        moe._dispatch_rows = orig
    (prow, *_), (srow, _, launches, paths, _) = runs[:2]
    _check_finite("(b) sharded", [dict(r, step=i) for i, r in
                                  enumerate(srow)])
    if srow != prow:
        _fail(f"(b): sharded {srow} vs unsharded {prow}: not bit-equal")
    # One MoE layer, forward and recompute, in each of the 3 + 3 + 1 steps.
    if len(rows_calls) != 2 * (2 * steps + 1):
        _fail(f"(b): the per-row dispatch ran {len(rows_calls)} times")
    # softmax: the dense layer (the stack's prefix) once, the MoE layer
    # (its period) and its recompute.
    if launches["softmax"] != 3 * steps or launches["uniform"] != 2 * steps:
        _fail(f"(b): launches {launches} in {steps} sharded steps, not "
              "softmax 3 and uniform 2 a step")
    if route["softmax"] != 3 * (steps + 1):
        _fail(f"(b): {route['softmax']} softmax calls on the DTensor route")
    print("placed (b):", json.dumps(dict(
        phase="b: DeepSeekMoE-16B full width cut to 2 layers (dense, MoE), "
              "batch 4 x seq 2048, bf16 compute, fp32 masters, remat full, "
              "unsharded and through the rule table's placements on a "
              "(1, 1) NCCL mesh; the MoE layer routes each row "
              "(moe._dispatch_rows)", card=smi, parameters=_n_params(cfg),
        dispatch_rows_inputs=sorted(set(rows_calls)),
        dtensor_route=dict(route), **_train_both_row(*runs, steps))))
    return launches


def _batch_moves_over_data(redistributions, batch: int) -> list:
    """The placement changes on the "data" axis of a (batch, ...)
    activation or gradient, other than a shard moving between its
    dimensions: each gathers, replicates or reduces the whole batch's
    rows on every rank of the axis."""
    return [r for r in redistributions
            if r["shape"][:1] == [batch] and len(r["shape"]) >= 3
            and any(c.startswith("data:") and not (
                c.startswith("data:S(") and "->S(" in c)
                for c in r["changes"])]


def _dryrun_host(smi) -> None:
    """(d): ``DRYRUN_HOST_CELLS`` in the dry-run's fake world, on the
    card's host, each with its wall time and torch version (the ten rows
    of the most bytes and FLOPs of a per-op view); then
    ``_dryrun_mamba_tp``."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    for arch, shape, mesh, variant, by_site in DRYRUN_HOST_CELLS:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, mesh, variant, by_site=by_site)
        if by_site:
            rec["batch_moves_over_data"] = _batch_moves_over_data(
                rec.pop("redistributions"), SHAPES[shape].global_batch)
            for k in ("collective_sites", "flop_sites"):
                rec[k] = rec[k][:10]
        print("placed (d):", json.dumps(dict(
            rec, phase="d: launch.dryrun.run_cell in a fake world of "
                       f"{rec['devices']} ranks, on the card's host",
            variant=variant, card=smi, wall_s=time.perf_counter() - t0)))
    _dryrun_mamba_tp(smi)


def _dryrun_mamba_tp(smi) -> None:
    """(d): Jamba's smoke config (7 Mamba layers) in jamba-v0.1-52b x
    train_4k x pod's TP + FSDP layout, with the per-op view, checked by
    ``dryrun.mamba_tp_faults``.  The pod's "data" and "model" axes are 16
    ranks each."""
    from repro_torch.configs import load_config
    from repro_torch.launch import dryrun
    from repro_torch.parallel import sharding
    saved = sharding.TP_THRESHOLD, sharding.FSDP_THRESHOLD
    sharding.TP_THRESHOLD = sharding.FSDP_THRESHOLD = 0
    t0 = time.perf_counter()
    try:
        rec = dryrun.run_cell("jamba-v0.1-52b", "train_4k", "pod", "smoke",
                              by_site=True)
    finally:
        sharding.TP_THRESHOLD, sharding.FSDP_THRESHOLD = saved
    wall = time.perf_counter() - t0
    faults = dryrun.mamba_tp_faults(rec, load_config("jamba-v0.1-52b",
                                                     "smoke"))
    print("placed (d):", json.dumps(dict(
        phase="d: jamba-v0.1-52b smoke x train_4k x pod, TP + FSDP, "
              "launch.dryrun.run_cell(by_site=True) on the card's host",
        card=smi, torch_version=rec["torch_version"],
        fsdp=rec["fsdp"], ep=rec["ep"], flops=rec["cost"]["flops"],
        collectives=rec["collectives"],
        memory_total_bytes=rec["memory"]["total_bytes"], wall_s=wall,
        **faults)))
    if faults["gathers"] or faults["replicated"]:
        _fail("placed (d): Mamba's mixer gathers an activation over a "
              "mesh axis")
    if faults["in_proj"]:
        _fail(f"placed (d): in_proj's products {faults['in_proj']} FLOPs a "
              f"rank, not {faults['in_proj_want']}")
    # Sites elsewhere (the attention's output projection on torch 2.11,
    # ROADMAP.md §3) are printed above, not failed.
    mamba = {k: v for k, v in faults["backward_over_forward"].items()
             if "ssm.py" in k}
    if mamba:
        _fail(f"placed (d): a product of Mamba's mixer runs whole in the "
              f"backward: {mamba}")


def placed_phase(torch, smi) -> dict:
    """Phase 13.  Returns (b)'s sharded run's launches."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        placed_serve_moe(torch, smi, mesh)
        launches = placed_train_moe(torch, smi, mesh)
        placed_serve_rwkv(torch, smi, mesh)
        placed_serve_jamba(torch, smi, mesh)
    finally:
        dist.destroy_process_group()
    _dryrun_host(smi)
    print(f"placed: phase wall time {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: decode attention
# ---------------------------------------------------------------------------

#: (label, batch, cache slots, position): olmo-1b.decode's cell (128 chats,
#: 1,024 + 128 + 1 slots, the mean position of its decode steps) and phase
#: 4 (a)'s batch 4 (prompt 128, 32 tokens).
DECODE_SHAPES = (("olmo-1b.decode", 128, 1153, 1088),
                 ("batch 4", 4, 161, 144))


def _decode_case(torch, label, B, S, pos) -> dict:
    """OLMo-1B's decode attention (16 KV heads of 128, g 1) at one shape:
    the two kernels, their plain versions and, as the yardstick, the
    parent's einsum path (``attention._scores_pv``, softmax included)
    against the kernels' chain (``attention._decode``), device ms from
    CUDA-graph replays.  A product's bound: the bytes it must move at
    3.35 TB/s (the keys or values and the probabilities on [lo, hi), the
    query, the scores or the output written)."""
    from repro_torch.configs import load_config
    from repro_torch.kernels import decode_attn as D
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.obs import card

    cfg = load_config("olmo-1b", "full")
    Hkv, g, Dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device="cuda").manual_seed(B)
    q = torch.randn(B, 1, Hkv, g, Dh, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, S, Hkv, Dh, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, S, Hkv, Dh, device="cuda", generator=gen).bfloat16()
    lo, hi, scale = 0, pos + 1, Dh ** -0.5
    scores = D.decode_scores_cuda(q, k, lo, hi, scale)
    p = ops.softmax(scores).bfloat16()
    pv = D.decode_pv_cuda(p, v, lo, hi)
    # Against fp64 on the kept slots: the scores' error, and the PV
    # product's in bf16 ulps of the fp64 sum rounded once to bf16.
    s64 = torch.einsum("bthgd,bshd->bhgts", q.double(),
                       k[:, lo:hi].double()) * scale
    pv64 = torch.einsum("bhgts,bshd->bthgd", p[..., lo:hi].double(),
                        v[:, lo:hi].double()).bfloat16()
    err = dict(
        scores=float((scores[..., lo:hi] - s64).abs().max()),
        scores_plain=float((D.decode_scores_plain(q, k, lo, hi, scale)[
            ..., lo:hi] - s64).abs().max()),
        pv_ulp=_bf16_ulp_err(pv, pv64),
        pv_plain_ulp=_bf16_ulp_err(D.decode_pv_plain(p, v, lo, hi), pv64))
    # 1 bf16 ulp, or 1e-6 where the sum nearly cancels
    pv_ok = bool(((pv.float() - pv64.float()).abs()
                  <= 2 ** -7 * pv64.float().abs() + 1e-6).all())
    del s64, pv64
    if err["scores"] > 1e-5 or not pv_ok or not (p[..., hi:] == 0).all():
        _fail(f"decode ({label}): errors against fp64 {err}, or a masked "
              "probability not 0")
    slots = B * (hi - lo) * Hkv
    bytes_s = slots * Dh * 2 + q.numel() * 2 + scores.numel() * 4
    bytes_pv = slots * g * 2 + slots * Dh * 2 + pv.numel() * 2
    ms = dict(
        scores=_device_ms(lambda: D.decode_scores_cuda(q, k, lo, hi, scale)),
        pv=_device_ms(lambda: D.decode_pv_cuda(p, v, lo, hi)),
        scores_plain=_device_ms(
            lambda: D.decode_scores_plain(q, k, lo, hi, scale)),
        pv_plain=_device_ms(lambda: D.decode_pv_plain(p, v, lo, hi)),
        chain=_device_ms(lambda: A._decode(cfg, q, k, v, pos, torch.bfloat16,
                                           card.OFF)),
        yardstick=_device_ms(lambda: A._scores_pv(cfg, q, k, v, pos, True,
                                                  torch.bfloat16)))
    bound = dict(scores=bytes_s / HBM_BYTES_PER_S * 1e3,
                 pv=bytes_pv / HBM_BYTES_PER_S * 1e3)
    row = dict(shape=label, batch=B, slots=S, position=pos, kv_heads=Hkv,
               group=g, head=Dh, splits=D.splits(B * Hkv, S, Dh),
               errors_against_fp64=err, ms=ms,
               bound_ms=bound, bound_by="bytes",
               roofline_pct={n: 100 * bound[n] / ms[n] for n in bound},
               call_ms=dict(scores=_call_ms(
                   lambda: D.decode_scores_cuda(q, k, lo, hi, scale)),
                   pv=_call_ms(lambda: D.decode_pv_cuda(p, v, lo, hi))))
    print("decode_attn:", json.dumps(row))
    return row


def decode_phase(torch, smi) -> dict:
    """Phase 14.  Returns the kernels' launches in (b)'s decode steps."""
    import numpy as np

    from repro_torch.configs import load_config
    from repro_torch.kernels import decode_attn as D
    from repro_torch.models.model import init_params
    from repro_torch.serve.engine import ServeEngine

    t0 = time.perf_counter()
    rows = [_decode_case(torch, *shape) for shape in DECODE_SHAPES]
    _free(torch)
    # (b) the launches: OLMo-1B at full width served as phase 4 (a), 8
    # tokens: each kernel once a layer in each of the 7 decode steps, none
    # in the prefill.
    cfg = load_config("olmo-1b", "full")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    engine = ServeEngine(cfg, params, max_len=161, batch=4, device="cuda")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 128))
    engine.generate(prompts, 2)
    s0, p0 = D.decode_scores_cuda.launches, D.decode_pv_cuda.launches
    engine.generate(prompts, 8)
    launches = dict(decode_scores=D.decode_scores_cuda.launches - s0,
                    decode_pv=D.decode_pv_cuda.launches - p0)
    want = cfg.n_layers * 7
    if launches != dict(decode_scores=want, decode_pv=want):
        _fail(f"decode (b): launches {launches}, expected {want} each "
              f"({cfg.n_layers} layers x 7 decode steps)")
    del engine, params
    _free(torch)
    out = dict(card=smi, shapes=rows, launches_per_decode_step={
        k: v / 7 for k, v in launches.items()})
    (ROOT / "chiprun_out" / "decode_attn.json").write_text(
        json.dumps(out, indent=1))
    print("decode_attn launches:", json.dumps(out["launches_per_decode_step"]))
    print(f"decode: phase wall time {time.perf_counter() - t0:.1f} s")
    return launches


def _compact(entries) -> list:
    """Each kernel's headline numbers and launches in every phase, in a
    line of a few kilobytes (the full entries go to ``kernels.json``)."""
    keep = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return [dict({k: e[k] for k in keep},
                 **{k: v for k, v in e.items() if k.startswith("launches_")})
            for e in entries]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port "
                                 "on one NVIDIA GPU (phases 1 to 14).")
    ap.add_argument("--phase", type=int, choices=(6, 11, 12, 13, 14),
                    help="build the kernels, then run only phase 6 "
                         "(training), 11 (the serving simulator, "
                         "resilience, remat='dots' and compression), 12 "
                         "(the sharding rule table on DTensor), 13 (the "
                         "sharded path of the MoE and SSM families) or 14 "
                         "(decode attention); no result line is printed")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    # Every line printed here also goes to the log, for a caller that keeps
    # only the end of the output.
    with open(out / "chip_smoke.log", "w") as log, \
            contextlib.redirect_stdout(_Tee(sys.stdout, log)):
        return _drive(args, torch, out)


def _drive(args, torch, out: Path) -> int:
    """The phases, after ``main``'s checks."""
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    smi = _smi("name,power.limit")
    print(smi)
    if args.phase is not None:
        t_build = _build.build_all()
        print(f"kernels built in {t_build:.1f} s into {_build.BUILD_DIR}")
        run = {6: train_phase, 11: sim_resilience_phase,
               12: sharding_phase, 13: placed_phase,
               14: decode_phase}[args.phase]
        print(f"phase {args.phase} alone: launches",
              json.dumps(run(torch, smi)))
        return 0
    card = Card(torch, _smi)
    print(card.describe())
    from tools import logf_variants
    variants_build = logf_variants.start_build()   # beside the kernels'
    from tools import launch_floor
    floor_build = launch_floor.start_build()
    t_build = _build.build_all()
    print(f"kernels built in {t_build:.1f} s into {_build.BUILD_DIR}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    entries = check_kernels(torch, gen, card, variants_build, floor_build)
    check_reference(torch)
    serving, serving_paths, serve_state = serve_full(torch)
    facade, facade_paths = check_facade(torch, gen)
    training = train_phase(torch, smi)
    families, families_paths = families_phase(torch, smi)
    analytic_exp = analytic_phase(torch, smi)
    tuned, tuned_tilings = tune_phase(torch, smi, serve_state)
    sys_served, sys_tilings = obs_system_phase(torch, smi, serve_state)
    del serve_state
    remat_dots = sim_resilience_phase(torch, smi)
    sharded = sharding_phase(torch, smi)
    placed = placed_phase(torch, smi)
    decode_phase(torch, smi)
    for e in entries:
        if e["name"] in ("softmax", "exp", "uniform"):
            e["launches_remat_dots"] = remat_dots[e["name"]]
            e["launches_sharded"] = sharded[e["name"]]
            e["launches_sharded_moe"] = placed[e["name"]]
        e["launches_tuned_serving"] = tuned[e["name"]]
        if e["name"] in tuned_tilings:
            e["tiling_launches_tuned_serving"] = tuned_tilings[e["name"]]
        e["launches_system_serving"] = sys_served[e["name"]]
        if e["name"] in sys_tilings:
            e["tiling_launches_system_serving"] = sys_tilings[e["name"]]
        e["launches_training"] = training[e["name"]]
        e["launches_families"] = families[e["name"]]
        if e["name"] in families_paths:
            e["launches_families_by_path"] = families_paths[e["name"]]
        if e["name"] == "exp":
            e["launches_analytic"] = analytic_exp
        phase = "facade" if e["name"] in ("logf", "montecarlo") else "serving"
        counts, paths = ((facade, facade_paths) if phase == "facade"
                         else (serving, serving_paths))
        e["launches"] = counts[e["name"]]
        e["launches_counted_in"] = f"the {phase} phase"
        if e["name"] in paths:
            e["launches_by_path"] = paths[e["name"]]
    (out / "kernels.json").write_text(json.dumps({"kernels": entries},
                                                 indent=1))
    print(json.dumps({"kernels": _compact(entries)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
