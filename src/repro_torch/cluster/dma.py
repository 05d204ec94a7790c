"""Cluster DMA model — double-buffered L1 refill overlapped with compute.

The port's copy of the JAX package's ``repro.cluster.dma``, plain Python, so
that its numbers equal the JAX package's bit for bit.

``core/schedule.py`` multi-buffers *within* a PE so pipeline phases overlap;
this module lifts the same idea to the cluster: the (single, shared) DMA
engine streams the next blocks' operands from L2 into TCDM while the cores
compute on the current ones, and streams results back out.  With double
buffering the steady-state cluster time per batch of blocks is

    max(compute_cycles, transfer_cycles)

never the sum — and never *more* than the unoverlapped serial schedule
(``compute + transfer``), which is the invariant the tests pin.

Traffic per element follows the paper's kernel taxonomy (§III-B): the
streaming kernels (expf/logf) read one fp64 operand and write one fp64
result per element (16 B); the Monte-Carlo kernels generate their samples
in-core and only emit accumulators — their steady-state DMA traffic is nil,
which is exactly why the paper finds the MC baselines at lower power (DMA
idle).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.cluster.topology import ClusterConfig
from repro_torch.obs import metrics as _metrics

#: Steady-state DMA bytes per element (fp64 in + fp64 out for the streaming
#: kernels; Monte-Carlo kernels are generated in-core → no stream traffic).
BYTES_PER_ELEM = {
    "expf": 16.0,
    "logf": 16.0,
    "poly_lcg": 0.0,
    "pi_lcg": 0.0,
    "poly_xoshiro128p": 0.0,
    "pi_xoshiro128p": 0.0,
}


def kernel_bytes(name: str, elems: int) -> float:
    """Total L2↔TCDM DMA traffic for ``elems`` elements of kernel ``name``."""
    try:
        per_elem = BYTES_PER_ELEM[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; known: "
                       f"{sorted(BYTES_PER_ELEM)}") from None
    return per_elem * elems


@dataclass(frozen=True)
class DmaTiming:
    """Compute/transfer cycle pair for one steady-state batch."""
    compute_cycles: int
    transfer_cycles: int

    @property
    def overlapped_cycles(self) -> int:
        """Double-buffered: transfers hide under compute (or vice versa)."""
        return max(self.compute_cycles, self.transfer_cycles)

    @property
    def serial_cycles(self) -> int:
        """No overlap: every block waits for its refill."""
        return self.compute_cycles + self.transfer_cycles

    @property
    def dma_bound(self) -> bool:
        return self.transfer_cycles > self.compute_cycles

    @property
    def dma_utilization(self) -> float:
        """Fraction of the overlapped window the DMA engine is busy."""
        if self.overlapped_cycles == 0:
            return 0.0
        return self.transfer_cycles / self.overlapped_cycles


def transfer_cycles(cfg: ClusterConfig, total_bytes: float) -> int:
    """Cycles the shared engine needs for ``total_bytes`` (512-bit beats)."""
    cycles = math.ceil(total_bytes / cfg.dma_bytes_per_cycle)
    if _metrics.enabled():
        _metrics.inc("cluster.dma.transfers")
        _metrics.inc("cluster.dma.bytes", total_bytes)
        _metrics.inc("cluster.dma.transfer_cycles", cycles)
    return cycles


def cluster_dma_timing(cfg: ClusterConfig, name: str, total_elems: int,
                       compute_cycles: int) -> DmaTiming:
    """Steady-state compute-vs-transfer balance for the whole cluster: all
    cores' blocks share one DMA engine, so the transfer term aggregates the
    cluster's total traffic against the single engine's bandwidth."""
    t = DmaTiming(
        compute_cycles=compute_cycles,
        transfer_cycles=transfer_cycles(cfg, kernel_bytes(name, total_elems)))
    if _metrics.enabled():
        _metrics.inc("cluster.dma.bound_batches", int(t.dma_bound))
        _metrics.observe("cluster.dma.utilization", t.dma_utilization)
    return t
