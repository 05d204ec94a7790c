"""COPIFT Step 6 — mapping FP loads/stores to SSR streams, stream fusion,
and ISSR indirection.

The port's copy of the JAX package's ``repro.core.streams``.

An SSR describes an affine memory access pattern as a function of up to four
loop induction variables (paper §II-A / SSR paper).  On a GPU the same
abstraction is a kernel's block addressing: an affine map from grid indices
to block offsets (the JAX package hands that map to a Pallas
``BlockSpec``).  :meth:`AffineStream.as_block_spec` makes that
correspondence executable.

Stream fusion (paper Fig. 1i): Snitch has only :data:`~repro_torch.core.isa.
NUM_SSRS` = 3 data movers, so multiple lower-dimensional streams over
contiguous, equal-length arrays are merged into a single higher-dimensional
stream.  We implement the same transformation: k 1-D streams of length B
become one 2-D stream of shape (B, k) over an interleaved buffer (or (k, B)
over a stacked buffer) — the layout the COPIFT kernels in ``repro_torch.kernels``
use for their inter-phase spill buffers.

Type-1 (dynamic address) dependencies either get converted to Type-2 by
prefetching into a dense staging buffer in the integer thread
(:func:`stage_type1_to_type2`, paper Fig. 1h) or are mapped directly onto an
:class:`IndirectStream` (ISSR) which performs the gather in hardware.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from repro_torch.core.isa import NUM_SSRS


@dataclass(frozen=True)
class BlockSpec:
    """A kernel's view of a stream: the block shape and the affine
    ``index_map`` from grid indices to block offsets (in blocks), as a
    Pallas ``BlockSpec`` carries them."""
    block_shape: tuple[int, ...]
    index_map: Callable[..., tuple[int, ...]]


@dataclass(frozen=True)
class AffineStream:
    """A ≤4-D affine stream: address(i0..i3) = base + Σ strides[d] * i[d].

    ``lengths``/``strides`` are ordered outermost→innermost, in elements.
    ``write`` distinguishes read streams from write streams.
    """
    name: str
    base: int
    lengths: tuple[int, ...]
    strides: tuple[int, ...]
    write: bool = False

    def __post_init__(self):
        if not (1 <= len(self.lengths) <= 4):
            raise ValueError("SSR streams support 1..4 dimensions")
        if len(self.lengths) != len(self.strides):
            raise ValueError("lengths/strides rank mismatch")

    @property
    def ndim(self) -> int:
        return len(self.lengths)

    @property
    def n_elements(self) -> int:
        n = 1
        for l in self.lengths:
            n *= l
        return n

    def addresses(self) -> torch.Tensor:
        """All addresses in stream order (innermost fastest), int64 — the
        oracle the fusion tests compare against."""
        axes = [torch.arange(n, dtype=torch.int64) for n in self.lengths]
        idx = torch.stack(torch.meshgrid(*axes, indexing="ij")).reshape(
            self.ndim, -1)
        strides = torch.tensor(self.strides, dtype=torch.int64)[:, None]
        return self.base + torch.sum(idx * strides, dim=0)

    def as_block_spec(self, block_shape: tuple[int, ...]) -> BlockSpec:
        """The kernel realization: an affine map from grid indices to block
        offsets.

        A 1-D stream of blocks maps grid step ``g`` to block offset
        ``base_blocks + g * stride_blocks`` — identical algebra, different
        memory mover (SSR FIFO → a thread block's loads from HBM).
        """
        stride_blocks = [max(1, s // max(1, b)) for s, b in
                         zip(self.strides, block_shape)]

        def index_map(*grid):
            # Innermost grid axis advances the innermost stream dimension.
            return tuple(g * sb for g, sb in zip(grid, stride_blocks))

        return BlockSpec(tuple(block_shape), index_map)


@dataclass(frozen=True)
class IndirectStream:
    """ISSR: a gather/scatter stream driven by an index stream.

    ``index`` supplies element offsets into ``base``; the hardware performs
    ``data[i] = mem[base + index[i]]``.  GPU realization: an in-kernel
    dynamic gather — see ``kernels/logf.py``, whose kernel reads the logf
    lookup tables through a warp shuffle.
    """
    name: str
    base: int
    index: AffineStream
    write: bool = False

    @property
    def n_elements(self) -> int:
        return self.index.n_elements


def fuse(streams: Sequence[AffineStream], name: str | None = None) -> AffineStream:
    """Fuse k 1-D streams into one 2-D stream (paper Fig. 1i).

    Requirements (checked): equal lengths, equal strides, and bases forming
    an arithmetic progression — i.e. the buffers are laid out at constant
    offset from each other, which Step 4's block allocation guarantees.
    The fused stream iterates (element, which-buffer): outer length B with
    the original stride, inner length k with stride = base delta.
    """
    if len(streams) == 1:
        return streams[0]
    first = streams[0]
    if any(s.ndim != 1 for s in streams):
        raise ValueError("fusion operates on 1-D streams")
    if any(s.lengths != first.lengths or s.strides != first.strides
           or s.write != first.write for s in streams):
        raise ValueError("fusion requires identical shape/stride/direction")
    bases = [s.base for s in streams]
    deltas = {b2 - b1 for b1, b2 in zip(bases, bases[1:])}
    if len(deltas) > 1:
        raise ValueError(f"bases must form an arithmetic progression, got {bases}")
    delta = deltas.pop() if deltas else 0
    return AffineStream(
        name=name or "+".join(s.name for s in streams),
        base=first.base,
        lengths=(first.lengths[0], len(streams)),
        strides=(first.strides[0], delta),
        write=first.write)


def allocate_ssrs(streams: Sequence[AffineStream | IndirectStream],
                  n_ssrs: int = NUM_SSRS) -> list[AffineStream | IndirectStream]:
    """Step 6's register-allocation problem: fit all streams into ``n_ssrs``
    movers by fusing compatible groups (reads with reads, writes with writes).
    Raises if the kernel's stream set cannot fit — the paper's kernels all do
    (expf fuses {x,t} reads and {w,ki,y} writes into 2 streams + 1 spare).
    """
    groups: dict[tuple, list[AffineStream]] = {}
    fixed: list[AffineStream | IndirectStream] = []
    for s in streams:
        if isinstance(s, IndirectStream):
            fixed.append(s)  # ISSRs occupy a dedicated mover
            continue
        if s.ndim != 1:
            fixed.append(s)
            continue
        groups.setdefault((s.lengths, s.strides, s.write), []).append(s)

    allocated: list[AffineStream | IndirectStream] = list(fixed)
    for members in groups.values():
        members = sorted(members, key=lambda s: s.base)
        # Greedily fuse the longest arithmetic-progression runs.
        run: list[AffineStream] = []
        def flush():
            if run:
                allocated.append(fuse(run) if len(run) > 1 else run[0])
        for s in members:
            if len(run) >= 2 and s.base - run[-1].base != run[1].base - run[0].base:
                flush(); run = []
            run.append(s)
        flush()
    if len(allocated) > n_ssrs:
        raise ValueError(
            f"{len(allocated)} streams do not fit in {n_ssrs} SSRs: "
            f"{[s.name for s in allocated]}")
    return allocated


def stage_type1_to_type2(prefetch: Callable[[torch.Tensor], torch.Tensor],
                         addresses: torch.Tensor) -> torch.Tensor:
    """Paper Fig. 1h — the integer thread prefetches dynamically-addressed
    data into a dense staging buffer so the FP thread sees a regular stream.

    ``prefetch`` is the integer-thread gather (address → value); the result
    is laid out contiguously, i.e. readable by a plain affine SSR.
    """
    return prefetch(addresses)
