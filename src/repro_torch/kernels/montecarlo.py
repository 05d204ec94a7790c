"""Hit-and-miss Monte Carlo: the CUDA kernel ``csrc/montecarlo.cu``, its
wrapper and its plain PyTorch version.

The kernel replaces the JAX package's ``repro/kernels/montecarlo.py:_mc_kernel``
(pi or poly × LCG or xoshiro128+).  Each of ``n_blocks × 1024`` lanes runs
``iters`` sequential samples of two draws (x, then u) from its own stream,
seeded by ``splitmix32`` of its global index plus the seed; step ``i`` adds
its hit to fp32 accumulator ``i % 3``, and the lane's partial sum is
``(a0 + a1) + a2``.  The kernel and the plain version are bit-exact against
the JAX package's ``mc_partial_sums`` and ``mc_blocked_ref``.

The kernel has two paths, chosen by shape in ``mc_plan``: a lane per thread,
or each lane's samples split over S segments, each started from the lane's
state advanced by a jump table (``jump_table``, built here with integer
numpy and cached on the device).  ``mc_segmented_plain`` is the plain
version of the segment path; ``mc_partial_sums_cuda.path_launches`` counts
the launches of each path.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prng import KINDS, _check_args
from repro_torch.kernels.ref import (_MASK, LCG_A, LCG_C, _generator,
                                     _mul32, mc_hit, uniform_from_bits)

LANES = 1024
PROBLEMS = {"pi": 0, "poly": 1}
#: Segment counts the segment path takes (the CUDA kernel's block is 32
#: lanes x S segments, at most 1024 threads).
SEGMENTS = (1, 2, 4, 8, 16, 32)
#: From this many lanes on, the lane path: its 128-thread blocks put a warp
#: on each of the four schedulers of all 132 SMs of an H100.
LANE_PATH_LANES = 132 * 128
#: The threads the segment path aims for: about four warps a scheduler
#: (3.9 on 132 SMs), where xoshiro128+'s time levels off on the H100 and
#: more segments only add jumps (PERF.md, tools/mc_segments.py).
SEGMENT_THREADS = 1 << 16
#: The fewest samples a segment takes, so that its jump (32 table loads and
#: 128 xors for xoshiro128+) stays a small part of its work.
MIN_SEGMENT_SAMPLES = 128
#: An fp32 count of 0/1 steps stops growing here (2**24 + 1 rounds to even).
SATURATION = 1 << 24


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


# ---------------------------------------------------------------------------
# the segment path: its plan, its jump tables and its plain version
# ---------------------------------------------------------------------------

def segment_length(iters: int, segments: int) -> int:
    """L = ceil(iters / S): segment s takes samples [s·L, min((s+1)·L,
    iters))."""
    return -(-iters // segments)


def mc_plan(n_lanes: int, iters: int) -> int:
    """The segment count S of each lane, chosen by shape alone.  1 (the lane
    path) from ``LANE_PATH_LANES`` lanes on.  Below that, among the S of
    ``SEGMENTS`` that give a segment at least ``MIN_SEGMENT_SAMPLES``
    samples and at most ``SATURATION`` (the kernel counts a segment's hits
    in fp32), the smallest with ``n_lanes · S >= SEGMENT_THREADS``, or the
    largest when none reaches it; 1 when none qualifies."""
    if n_lanes >= LANE_PATH_LANES:
        return 1
    best = 1
    for s in SEGMENTS[1:]:
        if iters < MIN_SEGMENT_SAMPLES * s:
            break
        if segment_length(iters, s) <= SATURATION:
            best = s
            if n_lanes * s >= SEGMENT_THREADS:
                break
    return best


def lcg_jump(k: int) -> tuple[int, int]:
    """(A, C) with k LCG steps = (A·state + C) mod 2**32."""
    a, c = 1, 0
    step_a, step_c = LCG_A, LCG_C
    while k:
        if k & 1:
            a, c = (step_a * a) & _MASK, (step_a * c + step_c) & _MASK
        step_a, step_c = ((step_a * step_a) & _MASK,
                          (step_a * step_c + step_c) & _MASK)
        k >>= 1
    return a, c


def _xoshiro_transition(words: np.ndarray) -> np.ndarray:
    """One xoshiro128+ state transition of (4, m) uint32 states; it is linear
    over GF(2)."""
    s0, s1, s2, s3 = (w.copy() for w in words)
    t = s1 << np.uint32(9)
    s2 ^= s0
    s3 ^= s1
    s1 ^= s2
    s0 ^= s3
    s2 ^= t
    s3 = (s3 << np.uint32(11)) | (s3 >> np.uint32(21))
    return np.stack([s0, s1, s2, s3])


_BITS = np.arange(32, dtype=np.uint32)


def _unpack(words: np.ndarray) -> np.ndarray:
    """(4, m) uint32 → (128, m) bits, row 32·w + b bit b of word w."""
    return ((words[:, None, :] >> _BITS[None, :, None]) & 1).reshape(
        128, -1).astype(np.uint8)


def _pack(bits: np.ndarray) -> np.ndarray:
    """(128, m) bits → (4, m) uint32, the inverse of ``_unpack``."""
    shifted = bits.reshape(4, 32, -1).astype(np.uint64) << _BITS[None, :,
                                                                 None]
    return shifted.sum(axis=1).astype(np.uint32)


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # Sums of at most 128 products of 0/1 are exact in float64.
    return (a.astype(np.float64) @ b.astype(np.float64) % 2).astype(np.uint8)


_XOSHIRO_T = _unpack(_xoshiro_transition(_pack(np.eye(128, dtype=np.uint8))))


def xoshiro_matrix(k: int) -> np.ndarray:
    """T**k over GF(2), (128, 128) bits: column c is the state after k
    transitions of the state with only bit c set (bit 32·w + b is bit b of
    word w)."""
    result = np.eye(128, dtype=np.uint8)
    base = _XOSHIRO_T
    while k:
        if k & 1:
            result = _gf2_matmul(base, result)
        base = _gf2_matmul(base, base)
        k >>= 1
    return result


def _matrix_words(m: np.ndarray) -> np.ndarray:
    """A (128, 128) bit matrix as the kernel reads it: 32 tables, one for
    each 4-bit nibble p of the state, of 16 entries of 4 uint32 words; entry
    v of table p is the xor of columns 4p + i for the bits i set in v."""
    cols = _pack(m).T                                    # (128, 4)
    tables = np.zeros((32, 16, 4), np.uint32)
    for i in range(4):
        sel = ((np.arange(16) >> i) & 1).astype(bool)
        tables[:, sel, :] ^= cols[i::4][:, None, :]
    return tables.reshape(-1)


def jump_words(kind: str, k: int) -> np.ndarray:
    """The table entry of a jump of k generator steps, uint32: (A, C) for
    the LCG, 2048 words (``xoshiro_matrix(k)`` as 32 nibble tables) for
    xoshiro128+."""
    if kind == "lcg":
        return np.array(lcg_jump(k), dtype=np.uint32)
    _generator(kind)                     # raises on an unknown kind
    return _matrix_words(xoshiro_matrix(k))


def jump_table(kind: str, iters: int, segments: int) -> np.ndarray:
    """(segments, words) uint32: entry s jumps 2·s·L steps (two draws a
    sample), L = ``segment_length(iters, segments)``, as ``jump_words``
    gives it.  The jump of 2·L is built once by squaring; each entry is the
    one before it times that."""
    _generator(kind)                     # raises on an unknown kind
    if segments not in SEGMENTS:
        raise ValueError(f"segments={segments} not in {SEGMENTS}")
    k = 2 * segment_length(iters, segments)
    if kind == "lcg":
        step_a, step_c = lcg_jump(k)
        entries = [(1, 0)]
        for _ in range(segments - 1):
            a, c = entries[-1]
            entries.append(((step_a * a) & _MASK,
                            (step_a * c + step_c) & _MASK))
        return np.array(entries, dtype=np.uint32)
    step = xoshiro_matrix(k)
    m = np.eye(128, dtype=np.uint8)
    rows = [_matrix_words(m)]
    for _ in range(segments - 1):
        m = _gf2_matmul(step, m)
        rows.append(_matrix_words(m))
    return np.stack(rows)


_JUMP_TABLES: dict[tuple, torch.Tensor] = {}


def jump_table_on(kind: str, iters: int, segments: int,
                  device: torch.device) -> torch.Tensor:
    """``jump_table`` on ``device`` (its uint32 bits as int32), copied there
    once: later calls, and launches captured in a CUDA graph, use the same
    tensor."""
    key = (kind, iters, segments, torch.device(device))
    if key not in _JUMP_TABLES:
        table = jump_table(kind, iters, segments)
        _JUMP_TABLES[key] = torch.from_numpy(
            np.ascontiguousarray(table).view(np.int32)).to(device)
    return _JUMP_TABLES[key]


def apply_jump(kind: str, state: torch.Tensor,
               words: np.ndarray) -> torch.Tensor:
    """Plain version of the kernel's jump: ``state`` as the generators of
    ``ref`` hold it (int64 words; (lanes,) for the LCG, (4, lanes) for
    xoshiro128+) advanced by the table entry ``words``: for xoshiro128+ the
    xor of one entry of each nibble's table."""
    if kind == "lcg":
        return (_mul32(state, int(words[0])) + int(words[1])) & _MASK
    tables = torch.from_numpy(words.reshape(32, 16, 4).astype(np.int64)).to(
        state.device)
    out = torch.zeros_like(state)
    for p in range(32):
        nibble = (state[p // 8] >> (4 * (p % 8))) & 15
        out ^= tables[p][nibble].T
    return out


def mc_segmented_plain(seed: int, *, kind: str, problem: str, iters: int,
                       n_blocks: int, segments: int,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """Plain version of the segment path: each lane's samples cut into
    ``segments`` segments, each started by ``apply_jump`` from the lane's
    state with ``jump_table``'s entry, hits counted as integers by the global
    sample index mod 3, counts clamped at 2**24 and summed as
    ``(a0 + a1) + a2`` in fp32.  Equal to ``mc_blocked_plain`` bit for
    bit."""
    _check_mc(seed, kind, problem, iters, n_blocks)
    table = jump_table(kind, iters, segments)
    seg_len = segment_length(iters, segments)
    init, step = _generator(kind)
    start = init(seed, n_blocks * LANES, device)
    counts = [torch.zeros(n_blocks * LANES, dtype=torch.int64, device=device)
              for _ in range(3)]
    for s in range(segments):
        state = apply_jump(kind, start, table[s])
        lo = min(s * seg_len, iters)
        for i in range(lo, min(lo + seg_len, iters)):
            state, bx = step(state)
            state, bu = step(state)
            counts[i % 3] += mc_hit(problem, uniform_from_bits(bx),
                                    uniform_from_bits(bu))
    a0, a1, a2 = (c.clamp(max=SATURATION).to(torch.float32) for c in counts)
    return ((a0 + a1) + a2).reshape(n_blocks, LANES)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

_ARGS = {"lane": (_build.PTR, _build.I64, _build.U32, _build.INT,
                  _build.INT, _build.I64, _build.PTR),
         "segment": (_build.PTR, _build.I64, _build.U32, _build.INT,
                     _build.INT, _build.I64, _build.INT, _build.I64,
                     _build.PTR, _build.PTR)}


def mc_partial_sums_cuda(seed: int, *, kind: str, problem: str, iters: int,
                         n_blocks: int,
                         device: torch.device | str = "cuda") -> torch.Tensor:
    """Launch ``csrc/montecarlo.cu``: per-lane hit counts, shape
    (n_blocks, 1024), fp32, on ``device``, on the path ``mc_plan`` gives the
    shape."""
    _check_mc(seed, kind, problem, iters, n_blocks)
    out = torch.empty(n_blocks, LANES, dtype=torch.float32, device=device)
    _build.check_cuda_tensor(out, (torch.float32,), "mc_partial_sums_cuda")
    n_lanes = out.numel()
    segments = mc_plan(n_lanes, iters)
    if segments == 1:
        path = "lane"
        _build.launch("montecarlo", "copift_mc_f32", _ARGS["lane"],
                      out.data_ptr(), n_lanes, int(seed), KINDS[kind],
                      PROBLEMS[problem], iters, _build.stream(out))
    else:
        path = "segment"
        table = jump_table_on(kind, iters, segments, out.device)
        _build.launch("montecarlo", "copift_mc_seg_f32", _ARGS["segment"],
                      out.data_ptr(), n_lanes, int(seed), KINDS[kind],
                      PROBLEMS[problem], iters, segments,
                      segment_length(iters, segments), table.data_ptr(),
                      _build.stream(out))
    mc_partial_sums_cuda.launches += 1
    mc_partial_sums_cuda.path_launches[path] += 1
    return out


mc_partial_sums_cuda.launches = 0
mc_partial_sums_cuda.path_launches = {"lane": 0, "segment": 0}


def mc_estimate(sums: torch.Tensor, problem: str, iters: int) -> torch.Tensor:
    """π (problem 'pi') or ∫₀¹ f (problem 'poly') from the partial sums, in
    fp32: the hit fraction over ``iters × sums.numel()`` samples.  No sample
    (``iters == 0``) gives NaN, as in the JAX package."""
    frac = torch.sum(sums) / (iters * sums.numel())
    return 4.0 * frac if problem == "pi" else frac
