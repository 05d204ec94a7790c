"""The port's COPIFT Steps 4–7 and analyzer (``repro_torch.core``) against
the JAX package's, on the CPU: SSR streams (fusion, allocation, addresses
and the block offsets a kernel's grid walks), plans, the serial and
software-pipelined executors on torch tensors (bit for bit against each
other, rtol 1e-6 against the JAX package's outputs on the same inputs), the
exp kernel's phases as a plan, and ``analyze`` through the ``make_fx``
front-end, whose phases equal those of ``analyze`` through jaxprs."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.kernels.ref as jref  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.kernels import expf, ref  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402


def _stream_data(s):
    d = dataclasses.asdict(s)
    return type(s).__name__, d


# ---------------------------------------------------------------------------
# Streams (Step 6)
# ---------------------------------------------------------------------------

_STREAMS = [dict(base=100, lengths=(4,), strides=(2,)),
            dict(base=7, lengths=(3, 5), strides=(40, 3)),
            dict(base=0, lengths=(2, 3, 4), strides=(100, 10, 1)),
            dict(base=11, lengths=(2, 2, 3, 2), strides=(64, 16, 4, 1),
                 write=True)]


class TestStreams:
    @pytest.mark.parametrize("kw", _STREAMS)
    def test_addresses_equal_the_jax_package(self, kw):
        mine = core.AffineStream("s", **kw)
        theirs = jcore.AffineStream("s", **kw)
        got = mine.addresses()
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(theirs.addresses()))
        assert mine.n_elements == theirs.n_elements
        assert mine.ndim == theirs.ndim

    @pytest.mark.parametrize("kw,block_shape", [
        (_STREAMS[0], (2,)), (_STREAMS[1], (1, 3)), (_STREAMS[2], (1, 5, 1)),
        (_STREAMS[3], (2, 4, 2, 1))])
    def test_block_offsets_equal_the_pallas_index_map(self, kw, block_shape):
        """``as_block_spec``: the same affine map from grid indices to block
        offsets as the JAX package's Pallas ``BlockSpec``, over a grid."""
        mine = core.AffineStream("s", **kw).as_block_spec(block_shape)
        theirs = jcore.AffineStream("s", **kw).as_block_spec(block_shape)
        assert mine.block_shape == tuple(theirs.block_shape)
        for grid in np.ndindex(*(3,) * len(block_shape)):
            want = tuple(int(v) for v in theirs.index_map(*grid))
            assert mine.index_map(*grid) == want, grid

    def test_fuse_and_its_errors(self):
        a, b, c = (core.AffineStream(n, base=o, lengths=(4,), strides=(1,))
                   for n, o in (("a", 0), ("b", 100), ("c", 200)))
        ja, jb, jc = (jcore.AffineStream(n, base=o, lengths=(4,),
                                         strides=(1,))
                      for n, o in (("a", 0), ("b", 100), ("c", 200)))
        assert _stream_data(core.fuse([a, b, c])) == \
            _stream_data(jcore.fuse([ja, jb, jc]))
        assert core.fuse([a]) is a
        assert core.fuse([a, b]).addresses().tolist() == \
            [0, 100, 1, 101, 2, 102, 3, 103]
        bad = core.AffineStream("d", base=1, lengths=(8,), strides=(1,))
        with pytest.raises(ValueError, match="identical shape"):
            core.fuse([a, bad])
        off = core.AffineStream("e", base=250, lengths=(4,), strides=(1,))
        with pytest.raises(ValueError, match="arithmetic progression"):
            core.fuse([a, b, off])
        with pytest.raises(ValueError, match="1..4 dimensions"):
            core.AffineStream("f", base=0, lengths=(), strides=())

    @pytest.mark.parametrize("case", ["expf", "issr", "unfusable"])
    def test_allocate_ssrs_equals_the_jax_package(self, case):
        def build(pkg):
            if case == "expf":
                B = 157
                return ([pkg.AffineStream(n, base=i * 8 * B, lengths=(B,),
                                          strides=(1,))
                         for i, n in enumerate(("x", "w", "t"))]
                        + [pkg.AffineStream(n, base=(3 + i) * 8 * B,
                                            lengths=(B,), strides=(1,),
                                            write=True)
                           for i, n in enumerate(("w_out", "ki", "y"))])
            if case == "issr":
                idx = pkg.AffineStream("idx", base=0, lengths=(16,),
                                       strides=(1,))
                return [pkg.IndirectStream("table", base=4096, index=idx),
                        pkg.AffineStream("a", base=0, lengths=(16,),
                                         strides=(1,)),
                        pkg.AffineStream("b", base=128, lengths=(16,),
                                         strides=(1,))]
            return [pkg.AffineStream(f"s{i}", base=i * 977, lengths=(7,),
                                     strides=(3 + i,)) for i in range(5)]

        if case == "unfusable":
            with pytest.raises(ValueError, match="do not fit in 3 SSRs"):
                core.allocate_ssrs(build(core))
            with pytest.raises(ValueError, match="do not fit in 3 SSRs"):
                jcore.allocate_ssrs(build(jcore))
            return
        mine = core.allocate_ssrs(build(core))
        theirs = jcore.allocate_ssrs(build(jcore))
        assert [_stream_data(s) for s in mine] == \
            [_stream_data(s) for s in theirs]

    def test_type1_to_type2_staging(self):
        table = torch.arange(100, dtype=torch.float32) * 2.0
        addrs = torch.tensor([5, 17, 3, 99])
        staged = core.stage_type1_to_type2(lambda a: table[a], addrs)
        jtable = jnp.arange(100, dtype=jnp.float32) * 2.0
        want = jcore.stage_type1_to_type2(lambda a: jtable[a],
                                          jnp.array([5, 17, 3, 99]))
        np.testing.assert_array_equal(staged.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Plans and executors (Steps 4–5)
# ---------------------------------------------------------------------------

def _plan_data(plan):
    pipe = plan.pipeline
    return (plan.name, plan.block, plan.buffers, plan.depth, pipe.n_phases,
            [d.name for d in pipe.phase_domains],
            [(b.name, b.producer_phase, b.consumer_phase, b.replicas)
             for b in pipe.buffers], pipe.block, pipe.n_blocks,
            pipe.n_pipeline_iters, pipe.l1_dwords(),
            [pipe.active_phases(j) for j in range(pipe.n_pipeline_iters)])


def _exp3_phases(pkg, lib):
    """The JAX suite's 3-phase exp plan, in either package: ``lib`` is
    ``torch`` or ``jnp``."""
    def fp0(x):
        z = x * np.float32(1.4426950408889634)
        kd = lib.floor(z)
        return {"ki": kd, "w": z - kd}

    def int1(ki):
        if lib is torch:
            e = (ki.to(torch.int32) + 127) << 23
            return {"s": e.view(torch.float32)}
        e = (ki.astype(jnp.int32) + 127) << 23
        return {"s": jax.lax.bitcast_convert_type(e, jnp.float32)}

    def fp2(w, s):
        return {"y": lib.exp2(w) * s}

    D = pkg.Domain
    return [pkg.PhaseDef(fp0, D.FP, writes=("ki", "w"), extern_reads=("x",)),
            pkg.PhaseDef(int1, D.INT, reads=("ki",), writes=("s",)),
            pkg.PhaseDef(fp2, D.FP, reads=("w", "s"), extern_writes=("y",))]


class TestPlans:
    @pytest.mark.parametrize("n,block", [(64, 16), (96, 32), (128, 128),
                                         (40, 8), (1000, None), (5, 3)])
    def test_exp3_plan_and_executors(self, n, block):
        plan = core.make_plan("exp3", _exp3_phases(core, torch), n, block)
        jplan = jcore.make_plan("exp3", _exp3_phases(jcore, jnp), n, block)
        assert _plan_data(plan) == _plan_data(jplan)
        x = np.linspace(-3.0, 3.0, n, dtype=np.float32)
        tx = torch.from_numpy(x)
        ext = {"x": tx, "y": torch.full_like(tx, 7.0)}
        serial = core.execute(plan, ext, pipelined=False)["y"]
        piped = core.execute(plan, ext, pipelined=True)["y"]
        assert torch.equal(serial, piped)
        assert torch.equal(ext["y"], torch.full_like(tx, 7.0))  # unwritten
        want = jcore.execute(jplan, {"x": jnp.asarray(x),
                                     "y": jnp.zeros(n, jnp.float32)})["y"]
        np.testing.assert_allclose(piped.numpy(), np.asarray(want),
                                   rtol=1e-6)

    def test_choose_block_and_max_block(self):
        for slots in (1, 6, 7, 12, 13, 2048, 4096):
            assert core.max_block(slots) == jcore.max_block(slots)
            assert core.choose_block(slots) == jcore.choose_block(slots)
            assert core.choose_block(slots, 5) == jcore.choose_block(slots, 5)
        with pytest.raises(ValueError, match="must be >= 1"):
            core.choose_block(3, 0)

    def test_plan_errors_match(self):
        def bad(pkg):
            return [pkg.PhaseDef(lambda b: b, pkg.Domain.FP, reads=("b",))]

        def same_phase(pkg):
            return [pkg.PhaseDef(lambda b: b, pkg.Domain.FP, reads=("b",),
                                 writes=("b",))]

        for phases, msg in ((bad, "reads unproduced buffer b"),
                            (same_phase, "not produced before phase 0")):
            with pytest.raises(ValueError, match=msg):
                core.make_plan("p", phases(core), 8)
            with pytest.raises(ValueError, match=msg):
                jcore.make_plan("p", phases(jcore), 8)

    def test_tuned_plan_raises_naming_the_roadmap_item(self, tmp_path,
                                                       monkeypatch):
        """``make_plan(tune=True)`` takes the shared default tuner's block,
        as the JAX package's does (each package's tune cache under
        ``tmp_path``); a name without a tunable workload keeps the static
        rule."""
        monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
        monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "j.json"))
        for name, objective in (("expf", "cycles"), ("softmax", "energy"),
                                ("exp3", "cycles")):
            plan = core.make_plan(name, _exp3_phases(core, torch), 4096,
                                  tune=True, tune_objective=objective)
            jplan = jcore.make_plan(name, _exp3_phases(jcore, jnp), 4096,
                                    tune=True, tune_objective=objective)
            assert _plan_data(plan) == _plan_data(jplan)
        static = core.make_plan("exp3", _exp3_phases(core, torch), 4096)
        assert _plan_data(plan) == _plan_data(static)

    @pytest.mark.parametrize("name", ["expf", "logf", "pi_lcg"])
    def test_plan_from_partition(self, name):
        from repro.core.kernels_isa import baseline_trace as jtrace
        from repro_torch.core.kernels_isa import baseline_trace
        part = core.partition(core.build_dfg(baseline_trace(name)))
        jpart = jcore.partition(jcore.build_dfg(jtrace(name)))
        mine = core.plan_from_partition(part, block=32, n_blocks=5)
        theirs = jcore.plan_from_partition(jpart, block=32, n_blocks=5)
        assert [(b.name, b.producer_phase, b.consumer_phase, b.replicas)
                for b in mine.buffers] == \
            [(b.name, b.producer_phase, b.consumer_phase, b.replicas)
             for b in theirs.buffers]
        assert all(b.dtype is torch.float64 for b in mine.buffers)
        assert [d.name for d in mine.phase_domains] == \
            [d.name for d in theirs.phase_domains]
        assert mine.l1_dwords() == theirs.l1_dwords()


def _chain(pkg, depth, coefs):
    """The JAX suite's random linear phase chains."""
    D = pkg.Domain

    def mk(i):
        c = coefs[i]
        if i == 0:
            return pkg.PhaseDef(lambda x, c=c: {"b0": x * c}, D.FP,
                                writes=("b0",), extern_reads=("x",))
        if i == depth - 1:
            return pkg.PhaseDef(lambda c=c, **kw: {"y": kw[f"b{i-1}"] + c},
                                D.INT if i % 2 else D.FP,
                                reads=(f"b{i-1}",), extern_writes=("y",))
        return pkg.PhaseDef(lambda c=c, **kw: {f"b{i}": kw[f"b{i-1}"] * c},
                            D.INT if i % 2 else D.FP,
                            reads=(f"b{i-1}",), writes=(f"b{i}",))

    if depth == 1:
        return [pkg.PhaseDef(lambda x: {"y": x * coefs[0]}, D.FP,
                             extern_reads=("x",), extern_writes=("y",))]
    return [mk(i) for i in range(depth)]


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 6), st.integers(1, 4))
def test_random_phase_chains_equal_serial_and_the_jax_package(depth, blocks):
    rng = np.random.default_rng(depth * 10 + blocks)
    coefs = rng.normal(size=depth).astype(np.float32)
    B = 8
    plan = core.make_plan("chain", _chain(core, depth, coefs), B * blocks,
                          block=B)
    jplan = jcore.make_plan("chain", _chain(jcore, depth, coefs), B * blocks,
                            block=B)
    assert _plan_data(plan) == _plan_data(jplan)
    x = np.arange(B * blocks, dtype=np.float32)
    tx = torch.from_numpy(x)
    o1 = core.execute(plan, {"x": tx, "y": torch.zeros_like(tx)},
                      pipelined=False)["y"]
    o2 = core.execute(plan, {"x": tx, "y": torch.zeros_like(tx)},
                      pipelined=True)["y"]
    assert torch.equal(o1, o2)
    want = jcore.execute(jplan, {"x": jnp.asarray(x),
                                 "y": jnp.zeros_like(jnp.asarray(x))})["y"]
    np.testing.assert_allclose(o2.numpy(), np.asarray(want), rtol=1e-6)


def test_run_serial_and_pipelined_directly():
    """The executors on a program whose buffer names the plan does not
    know (the default replica count, the depth) and a ragged last block."""
    prog = schedule.PhaseProgram(
        phases=[lambda x: {"a": x + 1}, lambda a: {"b": a * 2},
                lambda a, b: {"y": a - b}],
        reads=[(), ("a",), ("a", "b")], writes=[("a",), ("b",), ()],
        extern_reads=[("x",), (), ()], extern_writes=[(), (), ("y",)])
    plan = schedule.PipelinePlan(
        n_phases=3, phase_domains=[core.Domain.FP, core.Domain.INT,
                                   core.Domain.FP],
        buffers=[], block=4, n_blocks=3)
    jprog = jschedule.PhaseProgram(
        phases=prog.phases, reads=prog.reads, writes=prog.writes,
        extern_reads=prog.extern_reads, extern_writes=prog.extern_writes)
    jplan = jschedule.PipelinePlan(
        n_phases=3, phase_domains=[jcore.Domain.FP, jcore.Domain.INT,
                                   jcore.Domain.FP],
        buffers=[], block=4, n_blocks=3)
    x = np.arange(10, dtype=np.float32)
    ext = {"x": torch.from_numpy(x), "y": torch.zeros(10)}
    want = jschedule.run_serial(jprog, jplan, {"x": jnp.asarray(x),
                                               "y": jnp.zeros(10)})["y"]
    for run in (schedule.run_serial, schedule.run_pipelined):
        np.testing.assert_array_equal(run(prog, plan, ext)["y"].numpy(),
                                      np.asarray(want))


class TestExpPhasePlan:
    """The exp kernel's own three phases (``kernels.expf``) as a plan:
    what ``chip_smoke.py`` phase 8 runs on the card."""

    @pytest.mark.parametrize("n", [1, 291, 292, 293, 4096 + 5])
    def test_equals_exp_plain_bit_for_bit(self, n):
        rng = np.random.default_rng(n)
        x = rng.uniform(-110.0, 95.0, n).astype(np.float32)
        x[: min(n, 4)] = [np.inf, -np.inf, 88.5, -87.5][: min(n, 4)]
        tx = torch.from_numpy(x)
        plan = expf.exp_phase_plan(n)
        assert plan.block == core.max_block(7) == 292
        assert plan.buffers == {"kd": 2, "r": 3, "s": 2}
        want = expf.exp_plain(tx)
        for pipelined in (True, False):
            got = core.execute(plan, {"x": tx, "y": torch.empty_like(tx)},
                               pipelined=pipelined)["y"]
            assert torch.equal(got, want)
        np.testing.assert_allclose(
            want.numpy(), np.asarray(jref.exp_ref(jnp.asarray(x))),
            rtol=2e-6)

    def test_phases_compose_to_exp_phases(self):
        x = torch.linspace(-100, 90, 1001)
        for hi in (True, False):
            kd, r = expf.exp_phase0(x)
            assert torch.equal(expf.exp_phase2(x, r, expf.exp_phase1(kd), hi),
                               expf.exp_phases(x, hi))


# ---------------------------------------------------------------------------
# The analyzer through make_fx (Steps 1–2 on any function)
# ---------------------------------------------------------------------------

#: Phases of the JAX package's ``analyze`` on its ``exp_ref``, ``log_ref``
#: and ``softmax_ref`` (256 values; softmax 16 x 16).
_PHASES = {"exp_ref": ["FP", "INT", "FP"], "log_ref": ["INT", "FP"],
           "softmax_ref": ["FP", "INT", "FP"]}


def _example(name):
    x = np.linspace(0.5, 3.0, 256, dtype=np.float32)
    return x.reshape(16, 16) if name == "softmax_ref" else x


class TestAnalyze:
    @pytest.mark.parametrize("name", sorted(_PHASES))
    def test_phases_equal_the_jax_package(self, name):
        x = _example(name)
        mine = core.analyze(getattr(ref, name), torch.from_numpy(x))
        theirs = jcore.analyze(getattr(jref, name), jnp.asarray(x))
        assert [d.name for d in mine.phase_domains] == _PHASES[name]
        assert [d.name for d in theirs.phase_domains] == _PHASES[name]
        assert mine.n_phases == theirs.n_phases
        assert mine.n_cut_edges == theirs.n_cut_edges
        assert mine.n_fp == theirs.n_fp

    def test_aten_graph_counts(self):
        """The aten graphs' node counts (INT / FP / MEM), which differ from
        the jaxprs' where aten has other operators (PERF.md §6)."""
        got = {name: (a.n_int, a.n_fp, a.n_mem) for name in _PHASES
               for a in [core.analyze(getattr(ref, name),
                                      torch.from_numpy(_example(name)))]}
        assert got == {"exp_ref": (6, 25, 0), "log_ref": (9, 14, 2),
                       "softmax_ref": (6, 29, 0)}

    def test_classification_of_the_traps(self):
        """The bitcast ``view.dtype`` goes by its output dtype, ``_to_copy``
        is a register edge, constants and ``detach`` leave no node."""
        g = core.fx_dfg(ref.exp_ref, torch.linspace(-3, 3, 64))
        ops = [d["opcode"] for _, d in g.nodes(data=True)]
        assert "full_like" not in ops and "scalar_tensor" not in ops
        assert "detach" not in ops
        dom = {d["opcode"]: d["domain"].name for _, d in g.nodes(data=True)}
        assert dom["view.dtype"] == "FP" and dom["__lshift__"] == "INT"
        assert dom["_to_copy"] == "INT"
        conv = [n for n, d in g.nodes(data=True) if d["opcode"] == "_to_copy"]
        assert all(g._pred[n][u]["dep"] is core.DepType.REG
                   for n in conv for u in g.predecessors(n))

    def test_memory_ops_and_keywords(self):
        def fn(x, *, k):
            idx = (x.view(torch.int32) & 7).long()
            return torch.gather(x.reshape(4, -1), 1, idx.reshape(4, -1)) * k

        g = core.fx_dfg(fn, torch.rand(64) + 1, k=2.0)
        dom = {d["opcode"]: d["domain"].name for _, d in g.nodes(data=True)}
        assert dom["gather"] == "MEM" and dom["bitwise_and"] == "INT"
        assert dom["view.dtype"] == "INT"
        a = core.analyze(fn, torch.rand(64) + 1, k=2.0)
        assert a.n_mem >= 1

    def test_analysis_predictions(self):
        a = core.analyze(ref.exp_ref, torch.linspace(-3, 3, 32))
        ja = jcore.analyze(jref.exp_ref, jnp.linspace(-3, 3, 32))
        assert a.thread_imbalance == ja.thread_imbalance
        assert a.predicted_speedup == ja.predicted_speedup
        assert a.predicted_ipc_gain == ja.predicted_ipc_gain
        assert a.cut_types == ja.cut_types
