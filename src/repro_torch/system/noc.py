"""Inter-cluster DMA contention — concurrent streams share HBM bandwidth; a
self-standing copy of the JAX package's ``repro.system.noc``.

Each cluster's DMA engine can sink ``dma_bytes_per_cycle`` on its own, but
every stream drains through the one HBM port.  The arbitration model is
*water-filling fair share*: the HBM bandwidth is split equally among the
active (non-zero-byte) streams, except that a stream narrower than its
equal share keeps exactly its own width and the leftover is re-split among
the wider streams — the steady-state behaviour of a round-robin NoC
arbiter with per-cluster link caps.

Exactness contract (the 1-cluster reduction): whenever a stream's
effective bandwidth equals its private DMA width and there is no NoC
latency, the transfer is priced by delegating *verbatim* to
:func:`repro_torch.cluster.dma.transfer_cycles` — same ``ceil``, same obs
metrics — so an unconstrained system is bit-for-bit the per-cluster
model.  Zero-byte streams always take that path (a cluster moving nothing
pays no interconnect latency).
"""

from __future__ import annotations

import math

from repro_torch.cluster.dma import transfer_cycles
from repro_torch.obs import metrics as _metrics
from repro_torch.system.topology import SystemConfig


def fair_shares(widths: tuple[float, ...],
                hbm_bytes_per_cycle: float) -> tuple[float, ...]:
    """Water-filling split of the HBM bandwidth over active stream widths.

    Returns each stream's *effective* bytes/cycle: ``min(width, share)``
    where narrow streams keep their width and the freed bandwidth is
    re-split among the rest.  Monotone non-decreasing in
    ``hbm_bytes_per_cycle`` (more bandwidth never slows anyone down —
    the property test's monotonicity invariant).
    """
    eff = [0.0] * len(widths)
    pool = list(range(len(widths)))
    remaining = hbm_bytes_per_cycle
    while pool:
        share = remaining / len(pool)
        narrow = [i for i in pool if widths[i] <= share]
        if not narrow:
            for i in pool:
                eff[i] = share
            break
        for i in narrow:
            eff[i] = widths[i]
            remaining -= widths[i]
        pool = [i for i in pool if widths[i] > share]
    return tuple(eff)


def is_saturated(system: SystemConfig,
                 active_bytes: tuple[float, ...] | None = None) -> bool:
    """True iff the active clusters' aggregate DMA demand exceeds the HBM
    bandwidth (``None`` bandwidth never saturates).  ``active_bytes`` marks
    which clusters are actually streaming; by default all are."""
    if system.hbm_bytes_per_cycle is None:
        return False
    widths = [c.dma_bytes_per_cycle for i, c in enumerate(system.clusters)
              if active_bytes is None or active_bytes[i] > 0]
    return sum(widths) > system.hbm_bytes_per_cycle


def system_transfer_cycles(system: SystemConfig,
                           cluster_bytes: tuple[float, ...]
                           ) -> tuple[int, ...]:
    """Per-cluster DMA transfer cycles for one concurrent round of streams.

    ``cluster_bytes[i]`` is cluster *i*'s total traffic.  Unconstrained
    HBM or a stream that gets its full private width (with zero NoC
    latency) prices through ``cluster.dma.transfer_cycles`` verbatim;
    an arbitrated stream costs ``noc_latency + ceil(bytes / eff_bw)``.
    """
    if len(cluster_bytes) != system.n_clusters:
        raise ValueError(f"expected {system.n_clusters} per-cluster byte "
                         f"counts, got {len(cluster_bytes)}")
    hbm = system.hbm_bytes_per_cycle
    noc = system.noc_latency_cycles
    active = [i for i, b in enumerate(cluster_bytes) if b > 0]
    if hbm is None:
        eff = {i: system.clusters[i].dma_bytes_per_cycle for i in active}
    else:
        shares = fair_shares(
            tuple(system.clusters[i].dma_bytes_per_cycle for i in active),
            hbm)
        eff = {i: min(system.clusters[i].dma_bytes_per_cycle, s)
               for i, s in zip(active, shares)}
    out = []
    for i, (cfg, nbytes) in enumerate(zip(system.clusters, cluster_bytes)):
        if nbytes <= 0:
            out.append(transfer_cycles(cfg, nbytes))
        elif noc == 0 and eff[i] >= cfg.dma_bytes_per_cycle:
            out.append(transfer_cycles(cfg, nbytes))
        else:
            cycles = noc + math.ceil(nbytes / eff[i])
            _metrics.inc("system.noc.arbitrated_transfers")
            _metrics.inc("system.noc.transfer_cycles", cycles)
            out.append(cycles)
    if is_saturated(system, tuple(cluster_bytes)):
        _metrics.inc("system.noc.saturated_rounds")
    return tuple(out)


def hbm_roofline_cycles(system: SystemConfig, total_bytes: float) -> int:
    """Lower bound on any schedule's transfer time: the whole part cannot
    drain ``total_bytes`` faster than the narrower of the HBM port and the
    summed cluster DMA widths allow."""
    if total_bytes <= 0:
        return 0
    bw = system.aggregate_dma_bytes_per_cycle
    if system.hbm_bytes_per_cycle is not None:
        bw = min(bw, system.hbm_bytes_per_cycle)
    return math.ceil(total_bytes / bw)
