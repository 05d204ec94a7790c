"""The training batches, worked out again in numpy.

The cells train on the program's synthetic token stream: for step s, a
stream seed ``(seed + s * 0x9e3779b9) & 0x7fffffff``; counter-based
xoshiro128+ uniforms ``u[i] = top24(splitmix32(i + k) + splitmix32(i + k +
3 * phi)) / 2**24`` over a (B, T + 1) grid for k the stream seed, and for k
the stream seed XOR 0x1b873593; a fresh token ``min(int(u * V), V - 1)``
at each position, kept where the second uniform is at least 0.9 (and at a
row's start), else the token before repeats; the first T of each row.
This module holds that definition in plain numpy, so the reference reads
the same batches without the program's kernels.
"""

from __future__ import annotations

import numpy as np

PHI = 0x9E3779B9
M32 = 0xFFFFFFFF


def splitmix32(z: np.ndarray) -> np.ndarray:
    z = (z + np.uint32(PHI)).astype(np.uint32)
    z = ((z ^ (z >> np.uint32(16))) * np.uint32(0x85EBCA6B)).astype(np.uint32)
    z = ((z ^ (z >> np.uint32(13))) * np.uint32(0xC2B2AE35)).astype(np.uint32)
    return z ^ (z >> np.uint32(16))


def uniform(seed: int, n: int) -> np.ndarray:
    """n xoshiro128+ uniforms in [0, 1), fp32, of stream ``seed``."""
    with np.errstate(over="ignore"):
        idx = (np.arange(n, dtype=np.uint64) + np.uint64(seed & M32))
        idx = (idx & np.uint64(M32)).astype(np.uint32)
        bits = (splitmix32(idx)
                + splitmix32((idx + np.uint32(3 * PHI & M32))
                             .astype(np.uint32))).astype(np.uint32)
    return (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def batch_at(seed: int, step: int, batch: int, seq: int,
             vocab: int) -> np.ndarray:
    """The (batch, seq) int64 tokens of ``step``."""
    k = (seed + step * PHI) & 0x7FFFFFFF
    n = batch * (seq + 1)
    fresh = np.minimum((uniform(k, n) * np.float32(vocab)).astype(np.int32),
                       vocab - 1).reshape(batch, seq + 1)
    keep = uniform(k ^ 0x1B873593, n).reshape(batch, seq + 1) >= np.float32(0.9)
    t = np.arange(seq + 1)[None, :]
    keep |= t == 0
    src = np.maximum.accumulate(np.where(keep, t, 0), axis=1)
    return np.take_along_axis(fresh, src, axis=1)[:, :seq].astype(np.int64)
