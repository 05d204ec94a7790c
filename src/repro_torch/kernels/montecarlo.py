"""Hit-and-miss Monte Carlo: the CUDA kernel ``csrc/montecarlo.cu``, its
wrapper and its plain PyTorch version.

The kernel replaces the JAX package's ``repro/kernels/montecarlo.py:_mc_kernel``
(pi or poly × LCG or xoshiro128+).  Each of ``n_blocks × 1024`` lanes runs
``iters`` sequential samples of two draws (x, then u) from its own stream,
seeded by ``splitmix32`` of its global index plus the seed; step ``i`` adds
its hit to fp32 accumulator ``i % 3``, and the lane's partial sum is
``(a0 + a1) + a2``.  The kernel and the plain version are bit-exact against
the JAX package's ``mc_partial_sums`` and ``mc_blocked_ref``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prng import KINDS, _check_args
from repro_torch.kernels.ref import (_generator, mc_hit,
                                     uniform_from_bits)

LANES = 1024
PROBLEMS = {"pi": 0, "poly": 1}


def _check_mc(seed: int, kind: str, problem: str, iters: int,
              n_blocks: int) -> None:
    _check_args(seed, 0, kind)
    if problem not in PROBLEMS:
        raise ValueError(f"unknown problem {problem!r}; expected one of "
                         f"{tuple(PROBLEMS)}")
    if iters < 0:
        raise ValueError(f"iters={iters} must be >= 0")
    if not 1 <= n_blocks * LANES <= 2 ** 32:
        raise ValueError(f"n_blocks={n_blocks}: the lanes' global index "
                         "must fit a uint32, and n_blocks must be >= 1")


def mc_blocked_plain(seed: int, *, kind: str, problem: str, iters: int,
                     n_blocks: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Plain version of the Monte-Carlo kernel: per-lane hit counts, shape
    (n_blocks, 1024), fp32.  Every lane of every block advances together,
    one Python step per sample."""
    _check_mc(seed, kind, problem, iters, n_blocks)
    init, step = _generator(kind)
    state = init(seed, n_blocks * LANES, device)
    accs = [torch.zeros(n_blocks * LANES, dtype=torch.float32, device=device)
            for _ in range(3)]
    for i in range(iters):
        state, bx = step(state)
        state, bu = step(state)
        hit = mc_hit(problem, uniform_from_bits(bx), uniform_from_bits(bu))
        accs[i % 3] = accs[i % 3] + hit.to(torch.float32)
    return ((accs[0] + accs[1]) + accs[2]).reshape(n_blocks, LANES)


_ARGS = (_build.PTR, _build.I64, _build.U32, _build.INT, _build.INT,
         _build.I64, _build.PTR)


def mc_partial_sums_cuda(seed: int, *, kind: str, problem: str, iters: int,
                         n_blocks: int,
                         device: torch.device | str = "cuda") -> torch.Tensor:
    """Launch ``csrc/montecarlo.cu``: per-lane hit counts, shape
    (n_blocks, 1024), fp32, on ``device``."""
    _check_mc(seed, kind, problem, iters, n_blocks)
    out = torch.empty(n_blocks, LANES, dtype=torch.float32, device=device)
    _build.check_cuda_tensor(out, (torch.float32,), "mc_partial_sums_cuda")
    _build.launch("montecarlo", "copift_mc_f32", _ARGS, out.data_ptr(),
                  out.numel(), int(seed), KINDS[kind], PROBLEMS[problem],
                  iters, _build.stream(out))
    mc_partial_sums_cuda.launches += 1
    return out


mc_partial_sums_cuda.launches = 0


def mc_estimate(sums: torch.Tensor, problem: str, iters: int) -> torch.Tensor:
    """π (problem 'pi') or ∫₀¹ f (problem 'poly') from the partial sums, in
    fp32: the hit fraction over ``iters × sums.numel()`` samples.  No sample
    (``iters == 0``) gives NaN, as in the JAX package."""
    frac = torch.sum(sums) / (iters * sums.numel())
    return 4.0 * frac if problem == "pi" else frac
