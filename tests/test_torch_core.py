"""The port's analytic model (``repro_torch.core``) against the JAX
package's (``repro.core``), on the CPU, compared with ``==``: the ISA
tables, the Table-I kernels' traces and schedules, the timing model at
several blocks and contentions with the memo on and off, the energy model,
and the DFG and COPIFT partition of every Table-I kernel, which the port
builds on its own ordered digraph where the JAX package uses networkx."""

import contextlib
import dataclasses
import enum
from importlib import import_module

import pytest

pytest.importorskip("torch")

import networkx as nx  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch.core.analytics import TABLE_I  # noqa: E402

# ``core.partition`` is also the name of a function both packages export
# from ``core``, so the modules are taken from ``sys.modules``.
(jdfg, jenergy, jisa, jkisa, jpartition, jtiming, jmemo) = (
    import_module(f"repro.{m}") for m in (
        "core.dfg", "core.energy", "core.isa", "core.kernels_isa",
        "core.partition", "core.timing", "perf.memo"))
(dfg, energy, isa, kernels_isa, partition, timing, memo) = (
    import_module(f"repro_torch.{m}") for m in (
        "core.dfg", "core.energy", "core.isa", "core.kernels_isa",
        "core.partition", "core.timing", "perf.memo"))

KERNELS = kernels_isa.KERNELS


def plain(obj):
    """``obj`` as nested tuples, dicts and numbers: dataclasses by class
    name and fields, enums by class name and value — so that objects of
    the two packages' twin classes compare with ``==``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,) + tuple(
            (f.name, plain(getattr(obj, f.name)))
            for f in dataclasses.fields(obj))
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.value)
    if isinstance(obj, (list, tuple)):
        return tuple(plain(x) for x in obj)
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    return obj


def _constants(mod) -> dict:
    return {k: plain(v) for k, v in vars(mod).items()
            if k.isupper() and not k.startswith("_")}


def test_kernel_list_matches():
    assert KERNELS == jkisa.KERNELS == list(TABLE_I)


class TestIsa:
    def test_tables_and_constants(self):
        mine, theirs = _constants(isa), _constants(jisa)
        assert mine == theirs
        assert {"INT_OPS", "FP_OPS", "MEM_OPS", "L1_BUDGET_DWORDS",
                "NUM_SSRS"} <= set(mine)

    def test_classify_latency_and_encoding(self):
        opcodes = [op for t in (isa.INT_OPS, isa.FP_OPS, isa.XRF_FP_OPS,
                                isa.COPIFT_EXT_OPS, isa.MEM_OPS, isa.CTRL_OPS)
                   for op in t]
        for op in opcodes:
            assert plain(isa.classify(op)) == plain(jisa.classify(op)), op
            assert isa.latency(op) == jisa.latency(op), op
            assert isa.is_copift_ext(op) == jisa.is_copift_ext(op), op
        for op in isa.XRF_FP_OPS:
            try:
                want = jisa.copift_encode(op)
            except KeyError:
                with pytest.raises(KeyError):
                    isa.copift_encode(op)
            else:
                assert isa.copift_encode(op) == want
        with pytest.raises(KeyError, match="unknown opcode"):
            isa.classify("nope")


class TestKernelsIsa:
    @pytest.mark.parametrize("name", KERNELS)
    def test_traces_and_schedules_equal_as_data(self, name):
        assert plain(kernels_isa.baseline_trace(name)) == \
            plain(jkisa.baseline_trace(name))
        mine, theirs = (kernels_isa.copift_schedule(name),
                        jkisa.copift_schedule(name))
        assert plain(mine) == plain(theirs)
        assert plain(mine.fingerprint()) == plain(theirs.fingerprint())
        assert mine.block_overhead_instrs() == theirs.block_overhead_instrs()

    def test_check_counts(self):
        got = kernels_isa.check_counts()
        assert got == jkisa.check_counts()
        assert all(v["ok"] for v in got.values())
        assert set(got) == set(KERNELS)


#: (blocks, contentions) with the memo on; the cold runs re-simulate every
#: call, so they take fewer (contention enters the simulated total only as
#: a last term, which one value exercises).
_GRID = {True: ((1, 7, 64, None), (0.0, 0.37, 2.5)),
         False: ((7, None), (2.5,))}


def _memo_scope(enabled: bool):
    """Both packages' memos on (the default) or off."""
    if enabled:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(memo.memo_disabled())
    stack.enter_context(jmemo.memo_disabled())
    return stack


class TestTiming:
    @pytest.mark.parametrize("name", KERNELS)
    def test_evaluate_kernel(self, name):
        block = TABLE_I[name].max_block
        mine = timing.evaluate_kernel(name, kernels_isa.baseline_trace(name),
                                      kernels_isa.copift_schedule(name),
                                      block)
        theirs = jtiming.evaluate_kernel(name, jkisa.baseline_trace(name),
                                         jkisa.copift_schedule(name), block)
        assert plain(mine) == plain(theirs)
        assert mine.ipc_gain == theirs.ipc_gain

    @pytest.mark.parametrize("memo_on", [True, False], ids=["memo", "cold"])
    @pytest.mark.parametrize("name", KERNELS)
    def test_block_timings_at_blocks_and_contentions(self, name, memo_on):
        """``None`` in the grid stands for the kernel's Table-I block."""
        sched, jsched = (kernels_isa.copift_schedule(name),
                         jkisa.copift_schedule(name))
        base, jbase = (kernels_isa.baseline_trace(name),
                       jkisa.baseline_trace(name))
        blocks, contentions = _GRID[memo_on]
        with _memo_scope(memo_on):
            for b in blocks:
                b = b or TABLE_I[name].max_block
                for e in contentions:
                    for fn, jfn, a, ja in (
                            (timing.copift_block_timing,
                             jtiming.copift_block_timing, sched, jsched),
                            (timing.copift_serial_block_timing,
                             jtiming.copift_serial_block_timing, sched,
                             jsched),
                            (timing.baseline_timing,
                             jtiming.baseline_timing, base, jbase)):
                        mine = fn(a, b, extra_contention=e)
                        theirs = jfn(ja, b, extra_contention=e)
                        assert plain(mine) == plain(theirs), (fn, b, e)
                        assert mine.ipc == theirs.ipc

    @pytest.mark.parametrize("memo_on", [True, False], ids=["memo", "cold"])
    @pytest.mark.parametrize("name", ["poly_lcg", "expf"])
    def test_ipc_surface_and_problem_timing(self, name, memo_on):
        problems, blocks = [256, 4096], [32, 341]
        with _memo_scope(memo_on):
            assert timing.ipc_surface(
                kernels_isa.copift_schedule(name), problems, blocks) == \
                jtiming.ipc_surface(jkisa.copift_schedule(name), problems,
                                    blocks)
            for n, b in ((64, 64), (1000, 48), (1 << 14, 341)):
                assert plain(timing.copift_problem_timing(
                    kernels_isa.copift_schedule(name), n, b)) == \
                    plain(jtiming.copift_problem_timing(
                        jkisa.copift_schedule(name), n, b))

    def test_single_issue_and_thread_cycles(self):
        body = kernels_isa.baseline_trace("pi_lcg").instrs
        jbody = jkisa.baseline_trace("pi_lcg").instrs
        for iters in (1, 3, 9):
            assert plain(timing.simulate_single_issue(body, iters)) == \
                plain(jtiming.simulate_single_issue(jbody, iters))
            assert plain(timing.thread_cycles(body, iters)) == \
                plain(jtiming.thread_cycles(jbody, iters))


class TestEnergy:
    @pytest.mark.parametrize("name", KERNELS)
    def test_energy_and_power_breakdowns(self, name):
        assert plain(energy.evaluate_energy(name)) == \
            plain(jenergy.evaluate_energy(name))
        for fn, jfn in ((energy.baseline_power, jenergy.baseline_power),
                        (energy.copift_power, jenergy.copift_power)):
            mine, theirs = fn(name), jfn(name)
            assert plain(mine) == plain(theirs)
            assert mine.total == theirs.total
        e = energy.evaluate_energy(name)
        je = jenergy.evaluate_energy(name)
        assert (e.power_ratio, e.energy_saving) == \
            (je.power_ratio, je.energy_saving)

    def test_energy_constants(self):
        assert _constants(energy) == _constants(jenergy)


def _graph_data(g):
    nodes = [(n, d["opcode"], plain(d["domain"]), d["weight"])
             for n, d in g.nodes(data=True)]
    edges = [(u, v, plain(d["dep"])) for u, v, d in g.edges(data=True)]
    return nodes, edges


def _partition_data(part):
    return ([(p.index, plain(p.domain), list(p.nodes)) for p in part.phases],
            dict(part.node_phase), plain(part.cut_edges))


class TestDfgAndPartition:
    @pytest.mark.parametrize("name", KERNELS)
    def test_build_dfg_and_partition(self, name):
        trace = kernels_isa.baseline_trace(name)
        g, jg = dfg.build_dfg(trace), jdfg.build_dfg(jkisa.baseline_trace(name))
        assert _graph_data(g) == _graph_data(jg)
        assert g.graph == jg.graph
        assert plain(dfg.cross_edges(g)) == plain(jdfg.cross_edges(jg))
        assert plain(dfg.domain_counts(g)) == plain(jdfg.domain_counts(jg))
        part, jpart = partition.partition(g), jpartition.partition(jg)
        assert _partition_data(part) == _partition_data(jpart)
        assert part.n_cross_cuts == jpart.n_cross_cuts
        assert partition.reorder(len(trace.instrs), part) == \
            jpartition.reorder(len(trace.instrs), jpart)

    def test_max_phases_raises_as_the_jax_package(self):
        g = dfg.build_dfg(kernels_isa.baseline_trace("expf"))
        with pytest.raises(ValueError, match="phases > max 2"):
            partition.partition(g, max_phases=2)
        with pytest.raises(ValueError, match="phases > max 2"):
            jpartition.partition(
                jdfg.build_dfg(jkisa.baseline_trace("expf")), max_phases=2)


class TestDiGraph:
    def test_iteration_order_is_networkx(self):
        """Insertion order for nodes and neighbours; re-adding an edge
        updates its attributes and keeps its place; add_edge adds unknown
        nodes."""
        ops = [("n", 3, {"a": 1}), ("e", 3, 1, {"dep": 1}), ("e", 0, 1, {}),
               ("n", 1, {"a": 2}), ("e", 3, 2, {"dep": 2}),
               ("e", 3, 1, {"dep": 9}), ("e", 2, 0, {}), ("n", 3, {"b": 4})]
        g, ng = dfg.DiGraph(name="t"), nx.DiGraph(name="t")
        for op in ops:
            for h in (g, ng):
                if op[0] == "n":
                    h.add_node(op[1], **op[2])
                else:
                    h.add_edge(op[1], op[2], **op[3])
        assert list(g.nodes) == list(ng.nodes)
        assert list(g.nodes(data=True)) == list(ng.nodes(data=True))
        assert list(g.edges()) == list(ng.edges())
        assert list(g.edges(data=True)) == list(ng.edges(data=True))
        for n in ng.nodes:
            assert g.nodes[n] == ng.nodes[n]
            assert list(g.successors(n)) == list(ng.successors(n))
            assert list(g.predecessors(n)) == list(ng.predecessors(n))
            assert g.in_degree(n) == ng.in_degree(n)
            assert g.out_degree(n) == ng.out_degree(n)
        assert g.graph == ng.graph


def _random_dags(edges, n, doms):
    g, ng = dfg.DiGraph(), nx.DiGraph()
    for i in range(n):
        g.add_node(i, opcode="x", domain=isa.Domain[doms[i]], weight=1)
        ng.add_node(i, opcode="x", domain=jisa.Domain[doms[i]], weight=1)
    for u, v in edges:
        if u < v:
            g.add_edge(u, v, dep=isa.DepType.REG)
            ng.add_edge(u, v, dep=jisa.DepType.REG)
    return g, ng


@settings(max_examples=40, deadline=None)
@given(st.integers(4, 40), st.data())
def test_partition_random_dags_equal_the_jax_package(n, data):
    """Random DAGs with mixed domains, edges in a random insertion order:
    the port's partition of its digraph equals the JAX package's of the
    networkx graph, phase by phase."""
    doms = data.draw(st.lists(st.sampled_from(["INT", "FP", "MEM"]),
                              min_size=n, max_size=n))
    edges = data.draw(st.lists(
        st.tuples(st.integers(0, n - 1), st.integers(0, n - 1)),
        max_size=3 * n))
    g, ng = _random_dags(edges, n, doms)
    assert _partition_data(partition.partition(g)) == \
        _partition_data(jpartition.partition(ng))


def test_memo_switch_and_clear_all():
    """``$REPRO_TIMING_MEMO``'s switch, the scoped bypass and clear_all
    behave as the JAX package's."""
    assert memo.enabled() == jmemo.enabled()
    assert memo._env_enabled("off") is False and memo._env_enabled("1")
    sched = kernels_isa.copift_schedule("expf")
    memo.clear_all()
    timing.copift_block_timing(sched, 17)
    timing.copift_block_timing(sched, 17)
    stats = {s["name"]: s for s in memo.stats()}
    assert stats["timing"]["hits"] >= 1 and stats["timing"]["entries"] >= 1
    with memo.memo_disabled():
        assert not memo.enabled()
        before = memo.TIMING_MEMO.hits
        timing.copift_block_timing(sched, 17)
        assert memo.TIMING_MEMO.hits == before
    assert memo.enabled()
    cleared = []
    memo.register_cache(lambda: cleared.append(1))
    try:
        memo.clear_all()
    finally:
        memo._EXTRA_CLEARERS.pop()
    assert cleared == [1] and len(memo.TIMING_MEMO) == 0
