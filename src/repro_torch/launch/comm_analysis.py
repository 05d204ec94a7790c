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
collectives with the JAX package's cost model.  Its per-op view names the
model's source line of each op and its pass: forward, recompute, or the
autograd node of the backward pass running it, named by the line whose
forward call made the node (``_NodeSites``).
"""

from __future__ import annotations

import os
import sys
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

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
    "alltoall_base_": "all-to-all", "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
#: Functional-collective bookkeeping that moves no data.
_NOT_COLLECTIVES = ("wait_tensor",)
#: Elementwise ops XLA's cost analysis counts as transcendentals.
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh",
                   "sigmoid", "rsqrt", "sqrt", "sin", "cos", "erf", "pow",
                   "logsumexp", "softplus", "silu", "gelu", "_softmax"}


def _tensors(tree, out=None) -> list:
    """The tensors in ``tree``'s tuples, lists and dicts (an op's arguments
    and results; ``tree_flatten`` costs more than the op on ``meta``)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts, per rank, the ops dispatched while it is active:
    ``collectives`` (a list of (HLO name, result bytes)), ``flops`` (by
    ``torch.utils.flop_counter``'s formulas on the local shapes),
    ``transcendentals`` (elements of the ops in ``_TRANSCENDENTAL``),
    ``bytes_accessed`` (each op's inputs and outputs once: eager PyTorch
    fuses nothing) and ``peak_bytes``, the most bytes of storage that ops
    run under the counter held alive at once.

    With ``by_site`` it also keeps the per-op view: the collectives and the
    FLOPs by source line and autograd node (``sites``, ``flop_sites``),
    and every placement change DTensor makes (``redistributions``); in
    the backward pass the source line is the forward's (``_where``)."""

    def __init__(self, by_site: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        #: With ``by_site``: {(the port's source line that dispatched it,
        #: the autograd node running it or None in the forward, the last
        #: DTensor op before it, HLO name): [count, bytes]} of every
        #: collective, the per-op view of ``collectives``.
        self.by_site = {} if by_site else None
        #: With ``by_site``: {(source line, autograd node, aten op): FLOPs}.
        self.flop_by_site = {} if by_site else None
        #: With ``by_site``: {(source line, the autograd node running it or
        #: None in the forward, the global shape, the changed mesh
        #: dimensions as "axis:from->to"): count} of the redistributions.
        self.redistributed = {} if by_site else None
        self._unwatch = None
        self._node_sites = None
        self._dtensor_op = None
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

    def __enter__(self):
        if self.by_site is not None:
            self._unwatch = _watch_redistributions(self._redistribution)
            self._node_sites = _NodeSites()
            self._node_sites.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        if self._unwatch is not None:
            self._unwatch()
            self._unwatch = None
            self._node_sites.__exit__(*exc)
            self._node_sites = None
        return super().__exit__(*exc)

    def _redistribution(self, current, target) -> None:
        names = current.mesh.mesh_dim_names or range(current.mesh.ndim)
        changes = tuple(f"{n}:{a}->{b}" for n, a, b in zip(
            names, current.placements, target.placements) if a != b)
        if not changes:
            return
        key = (*_where(), tuple(current.shape), changes)
        self.redistributed[key] = self.redistributed.get(key, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            self._dtensor_op = str(func)
            return NotImplemented        # DTensor runs, then its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name in _COLLECTIVE_OPS:
            op, nbytes = _COLLECTIVE_OPS[name], sum(map(_nbytes, outs))
            self.collectives.append((op, nbytes))
            if self.by_site is not None:
                row = self.by_site.setdefault(
                    (*_where(), self._dtensor_op, op), [0, 0])
                row[0] += 1
                row[1] += nbytes * (2 if op == "all-reduce" else 1)
        elif name not in _NOT_COLLECTIVES:
            if packet in self._flop_registry:
                n = self._flop_registry[packet](*args, **kwargs, out_val=out)
                self.flops += n
                if self.flop_by_site is not None and n:
                    key = (*_where(), name)
                    self.flop_by_site[key] = self.flop_by_site.get(key, 0) + n
            if name in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in outs)
            self.bytes_accessed += sum(map(_nbytes, ins + outs))
        for t in outs:
            self._track(t)
        return out

    def collective_bytes(self) -> dict:
        return collective_bytes(self.collectives)

    def sites(self) -> list[dict]:
        """The rows of ``by_site``, most bytes (the cost model's) first."""
        rows = sorted(self.by_site.items(), key=lambda kv: -kv[1][1])
        return [dict(site=site, node=node, dtensor_op=op, collective=coll,
                     count=n, bytes=b)
                for (site, node, op, coll), (n, b) in rows]

    def flop_sites(self) -> list[dict]:
        """The rows of ``flop_by_site``, most FLOPs first."""
        rows = sorted(self.flop_by_site.items(), key=lambda kv: -kv[1])
        return [dict(site=site, node=node, op=op, flops=float(n))
                for (site, node, op), n in rows]

    def redistributions(self) -> list[dict]:
        """Every row of ``redistributed``, by source line."""
        return [dict(site=site, node=node, shape=list(shape),
                     changes=list(changes), count=n)
                for (site, node, shape, changes), n in sorted(
                    self.redistributed.items(), key=lambda kv: str(kv[0]))]


def _watch_redistributions(record):
    """Calls ``record(current_spec, target_spec)`` on each redistribution
    of a DTensor's local shard, until the returned function is called.
    DTensor's op dispatch and ``redistribute`` both call the private
    ``_redistribute.redistribute_local_tensor``; the dispatch module holds
    its own reference."""
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redistribute
    orig = redistribute.redistribute_local_tensor

    def watched(local, current, target, *args, **kwargs):
        record(current, target)
        return orig(local, current, target, *args, **kwargs)

    mods = [m for m in (redistribute, dispatch)
            if getattr(m, "redistribute_local_tensor", None) is orig]
    for m in mods:
        m.redistribute_local_tensor = watched

    def unwatch():
        for m in mods:
            m.redistribute_local_tensor = orig
    return unwatch


#: The key of an autograd node's ``metadata`` that holds its source line.
_SITE = "repro_torch.site"
_CHECKPOINT = os.path.join("torch", "utils", "checkpoint.py")
_LAYERS = os.path.join("repro_torch", "models", "layers.py")


def _where() -> tuple[str, str | None]:
    """(site, node) of the op or redistribution running now.  ``site`` is
    ``file:line function`` of the innermost frame of the port outside
    this module (the model code running it), and for a helper of
    ``models/layers.py`` also its caller's (``"... linear < ...
    mamba_mix"``); ``node`` is None in the forward pass, "recompute" in a
    checkpoint's recompute during the backward pass, else the name of the
    autograd node running it.  An op of a node with no Python frame of its
    own (the autograd engine comes before any frame of the port) takes the
    site whose forward call made the node, where ``_NodeSites`` tagged
    it."""
    current = torch._C._current_autograd_node()
    node = current.name() if current is not None else None
    site, done, f = None, False, sys._getframe(2)
    while f is not None:
        code = f.f_code
        path = code.co_filename
        if code.co_name == "_engine_run_backward":
            if site is not None:               # a Python backward's frames
                return site, node
            tag = current.metadata.get(_SITE) if current is not None else None
            if tag is not None:
                return tag, node
        elif site is not None and path.endswith(_CHECKPOINT):
            return site, "recompute"
        elif ("repro_torch" in path and not done
              and not path.endswith("comm_analysis.py")):
            line = (f"{path[path.rindex('repro_torch'):]}:{f.f_lineno} "
                    f"{code.co_name}")
            helper = path.endswith(_LAYERS)
            if site is None:
                site, done = line, not helper
            elif not helper:
                site, done = f"{site} < {line}", True
            if done and current is None:
                return site, None
        f = f.f_back
    return site or "?", node


class _NodeSites(TorchFunctionMode):
    """Tags each autograd node that a call under it makes with the call's
    source line (``_where``), for the per-op view of the backward pass.
    The nodes a call made are those its outputs reach before a tagged
    one."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        site = None
        todo = [t.grad_fn for t in _tensors(out)]
        while todo:
            node = todo.pop()
            if node is None or _SITE in node.metadata:
                continue
            site = site or _where()[0]
            node.metadata[_SITE] = site
            todo.extend(f for f, _ in node.next_functions)
        return out


class MetaKernelCache(TorchDispatchMode):
    """Runs each op on plain ``meta`` tensors once per signature: an op that
    returns fresh tensors (no view, no in-place write) returns new empty
    ``meta`` tensors of the outputs' sizes, strides and dtypes, as the
    first call of its signature (the op, its arguments' sizes, strides
    and dtypes, and every other argument) gave them.  A ``meta`` tensor
    has no values, so the outputs are the op's, and every count
    ``StepCounter`` takes of them is the same; PyTorch's ``meta`` kernels
    of elementwise ops are Python and cost ~0.2 ms a call, which a
    recurrence's T steps repeat.  DTensor ops pass (as in
    ``StepCounter``)."""

    def __init__(self):
        super().__init__()
        self._outs: dict = {}
        self._fresh: dict = {}          # op: returns fresh tensors

    @staticmethod
    def _key(x):
        if isinstance(x, torch.Tensor):
            if type(x) is not torch.Tensor or not x.is_meta:
                raise TypeError
            return ("T", tuple(x.shape), x.stride(), x.dtype)
        if isinstance(x, (tuple, list)):
            return (type(x).__name__,
                    tuple(MetaKernelCache._key(a) for a in x))
        if isinstance(x, dict):
            return tuple((k, MetaKernelCache._key(v)) for k, v in x.items())
        hash(x)
        return x

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        fresh = self._fresh.get(func)
        if fresh is None:
            schema = func._schema
            fresh = self._fresh[func] = not (
                any(r.alias_info is not None for r in schema.returns)
                or any(a.alias_info is not None and a.alias_info.is_write
                       for a in schema.arguments))
        if not fresh or not any(isinstance(a, torch.Tensor) for a in args):
            return func(*args, **kwargs)
        try:
            key = (func, self._key(args), self._key(kwargs))
        except TypeError:               # not meta, or unhashable
            return func(*args, **kwargs)
        spec = self._outs.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                self._outs[key] = (out.shape, out.stride(), out.dtype)
            elif isinstance(out, tuple) and all(
                    isinstance(t, torch.Tensor) for t in out):
                self._outs[key] = [(t.shape, t.stride(), t.dtype)
                                   for t in out]
            return out
        if isinstance(spec, tuple):
            return torch.empty_strided(spec[0], spec[1], dtype=spec[2],
                                       device="meta")
        return tuple(torch.empty_strided(sh, st, dtype=dt, device="meta")
                     for sh, st, dt in spec)


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
