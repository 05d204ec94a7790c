"""COPIFT Step 1 — data-flow graph construction and dependency typing.

The port's copy of the JAX package's ``repro.core.dfg``.  Two front-ends
produce the same graph format:

* :func:`build_dfg` — from an explicit :class:`~repro_torch.core.isa.KernelTrace`
  (RISC-V-level model, used for the paper's six kernels and Table I).
* :func:`fx_dfg` — from any PyTorch function, traced by
  ``torch.fx.experimental.proxy_tensor.make_fx`` into an aten graph (the
  port's counterpart of ``repro.core.dfg.jaxpr_dfg``).  Each aten call
  becomes a node classified into the int / fp / mem / ctrl domain by its
  operator and its output dtype (``meta["val"]``, as a jaxpr equation
  carries avals).

Graph format: :class:`DiGraph`, a small ordered digraph with the part of
``networkx.DiGraph``'s interface the partitioner reads (the port does not
depend on networkx).  Nodes carry ``domain``
(:class:`~repro_torch.core.isa.Domain`), ``opcode``, ``weight``
(instruction/op count the node stands for); edges carry ``dep``
(:class:`~repro_torch.core.isa.DepType`).
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.core.isa import DepType, Domain, Instr, KernelTrace, MEM_OPS, XRF_FP_OPS


class _NodeView:
    """``g.nodes``: iterate node ids, ``g.nodes[n]`` the attribute dict,
    ``g.nodes(data=True)`` (id, attributes) pairs — in insertion order."""

    __slots__ = ("_attrs",)

    def __init__(self, attrs: dict):
        self._attrs = attrs

    def __iter__(self):
        return iter(self._attrs)

    def __getitem__(self, n) -> dict:
        return self._attrs[n]

    def __call__(self, data: bool = False):
        return iter(self._attrs.items()) if data else iter(self._attrs)


class DiGraph:
    """An ordered directed graph with networkx's iteration order.

    Nodes iterate in insertion order, and each node's successors and
    predecessors in the order their edges were first added; re-adding an
    edge or a node updates its attributes in place.  The partitioner's
    greedy choices depend on these orders (``partition._improve`` sweeps
    ``g.nodes``, the list schedule releases ``g.successors``), so they are
    networkx's exactly: any other order changes phases."""

    def __init__(self, **graph_attrs):
        self.graph = dict(graph_attrs)
        self._node: dict[Any, dict] = {}
        self._succ: dict[Any, dict[Any, dict]] = {}
        self._pred: dict[Any, dict[Any, dict]] = {}

    def add_node(self, n, **attrs) -> None:
        if n not in self._node:
            self._node[n] = {}
            self._succ[n] = {}
            self._pred[n] = {}
        self._node[n].update(attrs)

    def add_edge(self, u, v, **attrs) -> None:
        self.add_node(u)
        self.add_node(v)
        data = self._succ[u].get(v)
        if data is None:
            data = self._succ[u][v] = self._pred[v][u] = {}
        data.update(attrs)

    @property
    def nodes(self) -> _NodeView:
        return _NodeView(self._node)

    def edges(self, data: bool = False):
        """(u, v) pairs, or (u, v, attributes) with ``data=True``, grouped by
        ``u`` in node order."""
        for u, nbrs in self._succ.items():
            for v, d in nbrs.items():
                yield (u, v, d) if data else (u, v)

    def successors(self, n):
        return iter(self._succ[n])

    def predecessors(self, n):
        return iter(self._pred[n])

    def in_degree(self, n) -> int:
        return len(self._pred[n])

    def out_degree(self, n) -> int:
        return len(self._succ[n])


# ---------------------------------------------------------------------------
# Front-end 1: RISC-V instruction traces
# ---------------------------------------------------------------------------

def _reg_bank(name: str) -> str:
    return "fp" if name.removeprefix("loop:").startswith("f") else "int"


def build_dfg(trace: KernelTrace) -> DiGraph:
    """Construct the DFG of a straight-line trace (paper Fig. 1c).

    Nodes are instruction indices.  An edge u→v is added when v consumes a
    register or memory location last produced by u.  Cross-domain edges are
    typed per the paper: Type 1 (dynamic mem), Type 2 (static mem),
    Type 3 (register traffic through cross-RF FP instructions).
    """
    g = DiGraph(name=trace.name)
    last_writer: dict[str, int] = {}

    for idx, ins in enumerate(trace.instrs):
        g.add_node(idx, opcode=ins.opcode, domain=_node_domain(ins), weight=1,
                   instr=ins)
        for src in ins.srcs:
            if src in last_writer:
                u = idx_src = last_writer[src]
                g.add_edge(u, idx, dep=_edge_type(trace.instrs[idx_src], ins, src))
        if ins.dst is not None:
            last_writer[ins.dst] = idx
    return g


def _node_domain(ins: Instr) -> Domain:
    """Assign memory ops to the thread that issues them."""
    if ins.domain is Domain.MEM:
        return Domain.FP if ins.is_fp_mem else Domain.INT
    if ins.domain is Domain.CTRL:
        return Domain.INT
    return ins.domain


def _edge_type(producer: Instr, consumer: Instr, via: str) -> DepType:
    pd, cd = _node_domain(producer), _node_domain(consumer)
    if pd == cd:
        return DepType.INTRA
    # FP load/store consuming an integer-computed address → memory dependency.
    if consumer.opcode in MEM_OPS and MEM_OPS[consumer.opcode]["fp"]:
        return DepType.DYN_MEM if consumer.dyn_addr else DepType.STA_MEM
    if producer.opcode in MEM_OPS and MEM_OPS[producer.opcode]["fp"]:
        return DepType.DYN_MEM if producer.dyn_addr else DepType.STA_MEM
    # Cross-RF FP instruction (fcvt / fmv / fcmp) → register dependency.
    if producer.opcode in XRF_FP_OPS or consumer.opcode in XRF_FP_OPS:
        return DepType.REG
    # Values flowing through memory cells tagged mem:* keep memory semantics.
    if via.startswith("mem:"):
        return DepType.STA_MEM
    return DepType.REG


def cross_edges(g: DiGraph) -> list[tuple[int, int, DepType]]:
    """All int↔fp edges with their paper dependency type."""
    out = []
    for u, v, data in g.edges(data=True):
        du, dv = g.nodes[u]["domain"], g.nodes[v]["domain"]
        if {du, dv} == {Domain.INT, Domain.FP}:
            out.append((u, v, data["dep"]))
    return out


# ---------------------------------------------------------------------------
# Front-end 2: aten graphs (the counterpart of the JAX package's jaxprs)
# ---------------------------------------------------------------------------

#: Operators that occupy the integer/control domain regardless of dtype
#: (the jaxpr's and/or/xor/not, shifts, iota, argmax/argmin, sort, top_k,
#: rem).
_INT_OPS = {
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "__and__", "__or__", "__xor__", "__lshift__", "__rshift__",
    "bitwise_left_shift", "bitwise_right_shift", "arange", "argmax",
    "argmin", "sort", "topk", "remainder", "fmod",
}
#: Operators that are pure data movement (mem domain): the jaxpr's gather,
#: scatter, slices, concatenate, broadcast, reshape, transpose, squeeze,
#: rev, pad and copy.  ``view.dtype`` is not among them: it is a bitcast,
#: classed by its output dtype as ``bitcast_convert_type`` is.
_MEM_OPS = {
    "view", "_unsafe_view", "reshape", "permute", "transpose", "t",
    "expand", "squeeze", "unsqueeze", "slice", "select", "cat", "stack",
    "split", "split_with_sizes", "unbind", "index", "index_select",
    "gather", "scatter", "scatter_add", "scatter_reduce", "index_put",
    "index_add", "slice_scatter", "select_scatter", "flip",
    "constant_pad_nd", "clone", "copy", "alias", "as_strided",
}
_CTRL_OPS = {"cond", "while_loop", "scan", "map_impl", "invoke_subgraph",
             "tag_activation_checkpoint"}
#: Constants: no node, and no producer for what reads them (a jaxpr's
#: literals and constvars are not equations either).
_CONST_OPS = {"full_like", "full", "scalar_tensor", "zeros_like",
              "ones_like", "empty_like", "zeros", "ones", "empty",
              "lift_fresh_copy", "_tensor_constant"}
#: No-ops: no node; what reads them reads their input's producer.
_ALIAS_OPS = {"detach", "getitem", "lift_fresh", "_assert_tensor_metadata"}
#: Conversions — ``_to_copy`` plays ``convert_element_type`` in the
#: register-edge rule below.
_CONVERT_OPS = ("_to_copy", "sign")
_CMP_OPS = ("lt", "le", "eq", "ge", "gt", "ne")


def _op_name(node) -> str:
    """The aten operator's name without namespace or overload (a jaxpr
    primitive's name), except the bitcast ``view.dtype``."""
    target = node.target
    packet = getattr(target, "overloadpacket", None)
    if packet is None:
        name = getattr(target, "__name__", None) or str(target)
        return name.rsplit(".", 1)[-1]
    name = packet.__name__
    if name == "view" and target._overloadname == "dtype":
        return "view.dtype"
    return name


def _node_dtype(node):
    val = node.meta.get("val")
    if isinstance(val, (tuple, list)):
        val = val[0] if val else None
    return getattr(val, "dtype", None)


def _op_domain(node, name: str) -> Domain:
    if name in _MEM_OPS:
        return Domain.MEM
    if name in _CTRL_OPS:
        return Domain.CTRL
    if name in _INT_OPS:
        return Domain.INT
    # Otherwise classify by the output dtype: float/complex → FP domain,
    # integer/bool → INT domain.  ``_to_copy`` with a domain change is the
    # aten analogue of fcvt (a Type-3 edge source/sink), ``view.dtype`` of
    # a bitcast.
    dt = _node_dtype(node)
    if dt is not None and (dt.is_floating_point or dt.is_complex):
        return Domain.FP
    return Domain.INT


def fx_dfg(fn: Callable, *example_args: Any, **kw) -> DiGraph:
    """Trace ``fn(*example_args, **kw)`` with ``make_fx`` and build the
    COPIFT DFG of its aten graph (the port's ``jaxpr_dfg``).  The example
    arguments may lie on any device; tracing runs no kernel's arithmetic
    twice and leaves them unchanged."""
    from torch.fx.experimental.proxy_tensor import make_fx

    gm = make_fx(lambda *args: fn(*args, **kw))(*example_args)
    return _fx_graph(gm.graph)


def _fx_graph(graph) -> DiGraph:
    g = DiGraph()
    producer: dict[Any, int] = {}
    idx = 0
    for node in graph.nodes:
        if node.op != "call_function":
            continue                  # placeholders, constants, the output
        name = _op_name(node)
        if name in _CONST_OPS:
            continue
        if name in _ALIAS_OPS:
            src = node.all_input_nodes
            if src and src[0] in producer:
                producer[node] = producer[src[0]]
            continue
        dom = _op_domain(node, name)
        g.add_node(idx, opcode=name, domain=dom, weight=1, fx_node=node)
        for inp in node.all_input_nodes:
            if inp in producer:
                u = producer[inp]
                du = g.nodes[u]["domain"]
                if {du, dom} == {Domain.INT, Domain.FP}:
                    # Conversions and comparisons crossing domains are
                    # register (Type-3) dependencies; gathers with computed
                    # indices are Type-1; everything else is Type-3 too,
                    # as in the jaxpr front-end.
                    pname = g.nodes[u]["opcode"]
                    if name in _CONVERT_OPS or pname == "_to_copy" or \
                       name in _CMP_OPS or pname in _CMP_OPS:
                        dep = DepType.REG
                    elif name in _MEM_OPS or pname in _MEM_OPS:
                        dep = DepType.DYN_MEM
                    else:
                        dep = DepType.REG
                else:
                    dep = DepType.INTRA
                g.add_edge(u, idx, dep=dep)
        producer[node] = idx
        idx += 1
    return g


def domain_counts(g: DiGraph) -> dict[Domain, int]:
    counts = {d: 0 for d in Domain}
    for _, data in g.nodes(data=True):
        counts[data["domain"]] += data.get("weight", 1)
    return counts
