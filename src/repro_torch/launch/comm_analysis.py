"""Per-rank counts of what a step dispatches: collectives, FLOPs, bytes and
live memory; the port's counterpart of the JAX package's
``repro.launch.hlo_analysis``.

The JAX package parses compiled HLO text and multiplies each ``while``
body's collectives by the loop's trip count, because XLA compiles a scan
body once.  PyTorch emits no HLO: it dispatches every op of every trip
of the Python loops (layers, attention blocks, CE chunks), so counting
dispatches counts each in-loop collective once per trip, which is what
the trip-count parsing reconstructs.

``StepCounter`` is a ``TorchDispatchMode`` that lets a DTensor op pass to
DTensor (returning ``NotImplemented``, as ``CommDebugMode`` does), so it
sees the local ops a rank runs, the collectives of each redistribution
among them, at the local shapes.  ``collective_bytes`` sums the
collectives with the JAX package's cost model.
"""

from __future__ import annotations

import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: The collective ops of ``_c10d_functional`` and ``c10d`` under the JAX
#: package's HLO names.
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
#: Functional-collective bookkeeping that moves no data.
_NOT_COLLECTIVES = ("wait_tensor",)
#: Elementwise ops XLA's cost analysis counts as transcendentals.
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "pow",
                   "logsumexp", "softplus", "silu", "gelu", "_softmax"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts, per rank, the ops dispatched while it is active:
    ``collectives`` (a list of (HLO name, result bytes)), ``flops`` (by
    ``torch.utils.flop_counter``'s formulas on the local shapes),
    ``transcendentals`` (elements of the ops in ``_TRANSCENDENTAL``),
    ``bytes_accessed`` (each op's inputs and outputs once: eager PyTorch
    fuses nothing) and ``peak_bytes``, the most bytes of storage that ops
    run under the counter held alive at once."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.collectives: list[tuple[str, int]] = []
        self.flops = 0
        self.transcendentals = 0
        self.bytes_accessed = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = weakref.WeakKeyDictionary()

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, n)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs, then its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name in _COLLECTIVE_OPS:
            self.collectives.append((_COLLECTIVE_OPS[name],
                                     sum(map(_nbytes, outs))))
        elif name not in _NOT_COLLECTIVES:
            if packet in self._flop_registry:
                self.flops += self._flop_registry[packet](
                    *args, **kwargs, out_val=out)
            if name in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in outs)
            self.bytes_accessed += sum(map(_nbytes, ins + outs))
        for t in outs:
            self._track(t)
        return out

    def collective_bytes(self) -> dict:
        return collective_bytes(self.collectives)


def collective_bytes(collectives) -> dict:
    """Per-rank collective payload bytes of ``collectives`` ((HLO name,
    result bytes) pairs, one a dispatch), in the JAX package's shape
    ``{"bytes": {op: n}, "counts": {op: n}, "total_bytes": n}``.

    Cost model per rank: all-reduce counts 2× its buffer (ring reduce and
    broadcast), everything else 1× the result."""
    b = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for op, nbytes in collectives:
        b[op] += nbytes * (2 if op == "all-reduce" else 1)
        counts[op] += 1
    return {"bytes": b, "counts": counts, "total_bytes": sum(b.values())}
