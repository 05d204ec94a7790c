"""The port's ``api.evaluate`` (``repro_torch.api``) against the JAX
package's (``repro.api``), on the CPU: every ``Report`` field equal with
``==`` (and of the same type: exact ints on uniform cores) for every
simulatable kernel, on the default, single-PE, 8-core homogeneous and
heterogeneous island targets, under every scheduling strategy, weak and
strong scaling; ``sweep``, ``compare_strategies`` and ``headline``; the
single-PE reduction to ``core.timing`` / ``core.energy``; a traced evaluate's
summary; and the branches that wait for later ROADMAP items."""

import dataclasses
import enum

import pytest

pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.obs import record as jrecord  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.cluster import STRATEGIES  # noqa: E402
from repro_torch.core import TABLE_I, evaluate_kernel  # noqa: E402
from repro_torch.core.energy import evaluate_energy  # noqa: E402
from repro_torch.core.kernels_isa import (baseline_trace,  # noqa: E402
                                          copift_schedule)
from repro_torch.obs import record  # noqa: E402

SIMULATABLE = [s.name for s in api.specs() if s.simulatable]
_METRICS = ("speedup", "ipc_base", "ipc_copift", "power_ratio",
            "energy_saving", "time_us", "cycles_per_elem",
            "energy_pj_per_elem", "n_cores", "is_heterogeneous")


def plain(obj):
    """``obj`` with dataclasses and enums of either package as tuples."""
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


def assert_reports_equal(mine, theirs):
    assert plain(mine) == plain(theirs)
    for f in dataclasses.fields(theirs):
        assert type(getattr(mine, f.name)) is type(getattr(theirs, f.name)), \
            f.name
    for m in _METRICS:
        assert getattr(mine, m) == getattr(theirs, m), m


def _targets(pkg):
    """The same targets built in either package."""
    pts = pkg.OPERATING_POINTS
    return {
        "default": pkg.Target(),
        "single_pe": pkg.Target.single_pe(),
        "homogeneous8": pkg.Target.homogeneous(n_cores=8),
        "homogeneous3_slow": pkg.Target.homogeneous(n_cores=3, point=pts[1]),
        "islands": pkg.Target.heterogeneous(
            "2@1.45GHz@1.00V,6@0.50GHz@0.60V"),
        "islands_capped": pkg.Target.heterogeneous(
            "1@1.45GHz@1.00V,2@1.00GHz@0.80V,1@0.75GHz@0.70V",
            power_cap_mw=400.0),
    }


TARGETS = _targets(api)
JTARGETS = _targets(japi)
#: (blocks_per_core, total_blocks): weak scaling, then strong.
SCALINGS = ((1, None), (3, None), (1, 1), (1, 5), (1, 13))


@pytest.mark.parametrize("target", sorted(TARGETS))
@pytest.mark.parametrize("name", SIMULATABLE)
def test_reports_equal_under_every_strategy_and_scaling(name, target):
    for strategy in STRATEGIES:
        t = TARGETS[target].with_strategy(strategy)
        jt = JTARGETS[target].with_strategy(strategy)
        for bpc, total in SCALINGS:
            mine = api.evaluate(name, t, blocks_per_core=bpc,
                                total_blocks=total)
            theirs = japi.evaluate(name, jt, blocks_per_core=bpc,
                                   total_blocks=total)
            assert_reports_equal(mine, theirs)


class TestSinglePeReduction:
    @pytest.mark.parametrize("name", SIMULATABLE)
    def test_single_pe_bit_for_bit(self, name):
        isa = api.kernel(name).isa_name
        pe = evaluate_kernel(isa, baseline_trace(isa), copift_schedule(isa),
                             TABLE_I[isa].max_block)
        r = api.evaluate(name, api.Target.single_pe())
        assert (r.speedup, r.ipc_copift, r.ipc_base, r.cycles_copift,
                r.cycles_base) == (pe.speedup, pe.ipc_copift, pe.ipc_base,
                                   pe.cycles_copift, pe.cycles_base)
        en = evaluate_energy(isa)
        assert (r.energy_saving, r.power_ratio) == \
            (en.energy_saving, en.power_ratio)
        assert r.extra_contention == 0.0

    def test_homogeneous_cycles_are_exact_ints(self):
        r = api.evaluate("expf", api.Target.homogeneous(n_cores=8))
        assert isinstance(r.cycles_copift, int)
        assert isinstance(r.cycles_base, int)


class TestVerbs:
    def test_sweep(self):
        names = ["homogeneous8", "islands", "single_pe", "homogeneous8"]
        for name in ("expf", "pi_lcg"):
            mine = api.sweep(name, [TARGETS[t] for t in names],
                             total_blocks=9)
            theirs = japi.sweep(name, [JTARGETS[t] for t in names],
                                total_blocks=9)
            assert len(mine) == 4
            for a, b in zip(mine, theirs):
                assert_reports_equal(a, b)
            assert mine[0] == api.evaluate(name, TARGETS["homogeneous8"],
                                           total_blocks=9)

    @pytest.mark.parametrize("target", ["homogeneous8", "islands"])
    def test_compare_strategies(self, target):
        mine = api.compare_strategies("logf", TARGETS[target],
                                      blocks_per_core=2)
        theirs = japi.compare_strategies("logf", JTARGETS[target],
                                         blocks_per_core=2)
        assert list(mine) == list(theirs) == list(STRATEGIES)
        for s in STRATEGIES:
            assert_reports_equal(mine[s], theirs[s])
        sub = api.compare_strategies("logf", TARGETS[target],
                                     strategies=("lpt",), total_blocks=7)
        assert list(sub) == ["lpt"]

    @pytest.mark.parametrize("target", ["single_pe", "homogeneous8",
                                        "islands"])
    def test_headline(self, target):
        mine = api.headline([api.evaluate(n, TARGETS[target])
                             for n in SIMULATABLE])
        theirs = japi.headline([japi.evaluate(n, JTARGETS[target])
                                for n in SIMULATABLE])
        assert mine == theirs
        assert set(mine) == {"geomean_speedup", "peak_speedup", "peak_ipc",
                             "geomean_ipc_gain", "geomean_power_ratio",
                             "max_power_ratio", "geomean_energy_saving",
                             "peak_energy_saving"}

    def test_perf_lazy_sweep_and_aliases(self):
        import repro_torch.perf as perf
        assert perf.sweep is api.sweep
        from repro_torch.tune.cost import evaluate_batch
        assert perf.evaluate_batch is evaluate_batch  # the tuner's, ported
        with pytest.raises(AttributeError):
            perf.no_such_entry_point  # noqa: B018
        assert api.evaluate("montecarlo") == api.evaluate("pi_xoshiro128p")


@settings(max_examples=30, deadline=None)
@given(st.sampled_from(SIMULATABLE), st.sampled_from(sorted(TARGETS)),
       st.sampled_from(STRATEGIES), st.integers(1, 40), st.booleans())
def test_random_work_equals_the_jax_package(name, target, strategy, blocks,
                                            strong):
    """Blocks drawn from 1 up (zero blocks raise: the reference's own
    caveat), as strong or weak scaling."""
    kw = dict(total_blocks=blocks) if strong else dict(blocks_per_core=blocks)
    assert_reports_equal(
        api.evaluate(name, TARGETS[target].with_strategy(strategy), **kw),
        japi.evaluate(name, JTARGETS[target].with_strategy(strategy), **kw))


class TestErrors:
    def test_zero_blocks_raise_the_reference_value_error(self):
        for kw in (dict(total_blocks=0), dict(blocks_per_core=0),
                   dict(total_blocks=-2)):
            with pytest.raises(ValueError, match="at least one block"):
                api.evaluate("expf", api.Target.homogeneous(4), **kw)
            with pytest.raises(ValueError, match="at least one block"):
                japi.evaluate("expf", japi.Target.homogeneous(4), **kw)

    def test_tuner_only_kernel_rejected(self):
        with pytest.raises(ValueError, match="tuner-only"):
            api.evaluate("prng")
        with pytest.raises(ValueError, match="tuner-only"):
            japi.evaluate("prng")

    @pytest.mark.parametrize("kw,item", [
        (dict(plan=dict(block=64, fuse_fp=True, movers=2, pipelined=False)),
         "3d"),
        (dict(faults=object()), "3e")])
    def test_later_items_raise_naming_the_roadmap_item(self, kw, item):
        """``plan=`` came with the tuner (item 3d): a tuner candidate gives
        the JAX package's ``Report``.  ``faults=`` came with the fault
        model (item 3e): a fault state gives the JAX package's degraded
        ``Report``, and an object that is neither a trace nor a state
        raises the JAX package's ``TypeError``."""
        if item == "3e":
            from repro import resilience as jres

            from repro_torch import resilience
            for name, target in (("expf", "default"), ("logf", "islands")):
                mine = api.evaluate(name, TARGETS[target], total_blocks=5,
                                    faults=resilience.FaultState(
                                        dead_cores=((0, 1),),
                                        freq_caps=((0, 0.75),)))
                theirs = japi.evaluate(name, JTARGETS[target],
                                       total_blocks=5,
                                       faults=jres.FaultState(
                                           dead_cores=((0, 1),),
                                           freq_caps=((0, 0.75),)))
                assert_reports_equal(mine, theirs)
            for a in (api, japi):
                with pytest.raises(TypeError, match="FaultTrace or "
                                   "FaultState"):
                    a.evaluate("expf", a.Target(), **kw)
            return
        if item == "3d":
            from repro import tune as jtune
            from repro_torch import tune
            for name, target in (("expf", "default"), ("logf", "islands")):
                mine = api.evaluate(name, TARGETS[target], total_blocks=5,
                                    plan=tune.Candidate(**kw["plan"]))
                theirs = japi.evaluate(name, JTARGETS[target],
                                       total_blocks=5,
                                       plan=jtune.Candidate(**kw["plan"]))
                assert_reports_equal(mine, theirs)
            return
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP §1 item {item}"):
            api.evaluate("expf", api.Target(), **kw)

    def test_system_target_raises_naming_the_roadmap_item(self):
        """A system target, which raised until the manycore model was
        ported, gives the JAX package's ``Report``, and since the fault
        model was ported also under ``faults=``: a dead cluster and a
        narrowed HBM port give the JAX package's degraded ``Report``."""
        t = api.Target.system("2x8c,hbm=256")
        assert t.n_clusters == 2 and t.n_cores == 16
        jt = japi.Target.system("2x8c,hbm=256")
        assert plain(t.system_config) == plain(jt.system_config)
        assert_reports_equal(api.evaluate("expf", t),
                             japi.evaluate("expf", jt))
        from repro import resilience as jres

        from repro_torch import resilience
        for kw in (dict(dead_clusters=(1,)), dict(hbm_scale=0.25)):
            assert_reports_equal(
                api.evaluate("expf", t, faults=resilience.FaultState(**kw)),
                japi.evaluate("expf", jt, faults=jres.FaultState(**kw)))
        with pytest.raises(TypeError, match="FaultTrace or FaultState"):
            api.evaluate("expf", t, faults=object())

    def test_target_validation_matches(self):
        with pytest.raises(ValueError, match="unknown strategy"):
            api.Target(strategy="nope")
        with pytest.raises(ValueError, match="power_cap_mw"):
            api.Target(power_cap_mw=0)
        assert plain(TARGETS["islands"].core_points) == \
            plain(JTARGETS["islands"].core_points)
        assert TARGETS["islands"].is_heterogeneous


def test_traced_evaluate_records_the_jax_package_summary():
    """With a recorder active, evaluate re-runs the block timings per core
    and records the same summary as the JAX package's, and the same
    Report."""
    rec, jrec = record.TraceRecorder(), jrecord.TraceRecorder()
    t, jt = TARGETS["islands"], JTARGETS["islands"]
    with record.recording(rec):
        mine = api.evaluate("logf", t, total_blocks=3)
    with jrecord.recording(jrec):
        theirs = japi.evaluate("logf", jt, total_blocks=3)
    assert_reports_equal(mine, theirs)
    assert mine == api.evaluate("logf", t, total_blocks=3)
    assert rec.summaries == jrec.summaries
    assert [s["kind"] for s in rec.summaries] == ["evaluate"]
    assert [s["name"] for s in rec.spans] == \
        [s["name"] for s in jrec.spans] == ["api.evaluate"]
