"""The port's manycore model (``repro_torch.system``) and cluster analytics
(``repro_torch.cluster.analytics``) against the JAX package's, on the CPU.

Every system ``Report``, ``SystemPoint``, ``CostEstimate``, assignment and
transfer count equals the JAX package's with ``==``, and the port keeps
the model's own invariants: a 1-cluster system with unconstrained HBM is
bit for bit the single-cluster ``Report``; strong scaling of the
compute-only kernel is exactly linear; the shared-HBM roofline flattens the
curve; block conservation and HBM monotonicity hold over drawn cluster
shapes.  Mirrors ``tests/test_system_model.py`` (but its serving-simulator
class, held by ``tests/test_torch_serve_sim.py``, and its
benchmark-harness class: ``benchmarks/`` is not ported) and
``tests/test_system_properties.py``."""

import math

import pytest

pytest.importorskip("torch")

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402,E501
from test_torch_core import plain  # noqa: E402
from test_torch_evaluate import assert_reports_equal  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import system as jsystem  # noqa: E402
from repro.cluster import analytics as janalytics  # noqa: E402
from repro.cluster.scheduler import assign as jassign  # noqa: E402
from repro.cluster.topology import SNITCH_CLUSTER as JSNITCH  # noqa: E402
from repro_torch import api, system  # noqa: E402
from repro_torch.cluster import analytics  # noqa: E402
from repro_torch.cluster.scheduler import STRATEGIES, assign  # noqa: E402
from repro_torch.cluster.topology import SNITCH_CLUSTER  # noqa: E402
from repro_torch.core.kernels_isa import KERNELS  # noqa: E402
from repro_torch.system import (SystemConfig, SystemPoint,  # noqa: E402
                                assign_system, evaluate_system, fair_shares,
                                hbm_roofline_cycles, is_saturated,
                                parse_system, select_system_point,
                                system_cost, system_transfer_cycles)

SIMULATABLE = [s.name for s in api.specs() if s.simulatable]
SPEED_LADDER = (0.50, 0.75, 1.00, 1.25, 1.45)


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))


class TestSingleClusterReduction:
    """Target.system(1) with unconstrained HBM equals the single-cluster
    path exactly, and equals the JAX package's system Report."""

    @pytest.mark.parametrize("strategy", STRATEGIES)
    @pytest.mark.parametrize("name", KERNELS)
    def test_weak_and_strong_scaling_parity(self, name, strategy):
        for kw in (dict(blocks_per_core=3), dict(total_blocks=48)):
            sys_r = api.evaluate(name, api.Target.system(
                1, strategy=strategy), **kw)
            one = api.evaluate(name, api.Target(strategy=strategy), **kw)
            assert_reports_equal(sys_r, one)
            assert_reports_equal(sys_r, japi.evaluate(name, japi.Target.system(
                1, strategy=strategy), **kw))

    @pytest.mark.parametrize("name", SIMULATABLE)
    def test_every_spec_cluster_equivalent(self, name):
        """``evaluate(spec, Target.system(SystemConfig.homogeneous(1,
        SNITCH_CLUSTER)))`` equals ``evaluate(spec, Target.homogeneous())``
        with ``==``, and both equal the JAX package's."""
        one = api.evaluate(name, api.Target.system(
            SystemConfig.homogeneous(1, SNITCH_CLUSTER)))
        assert one == api.evaluate(name, api.Target.homogeneous())
        assert_reports_equal(one, japi.evaluate(name, japi.Target.system(
            jsystem.SystemConfig.homogeneous(1, JSNITCH))))

    def test_reference_values(self):
        """expf 7046 and logf 15940 COPIFT cycles on one cluster; on four,
        speedups 2.1197842747658244 and 1.5592220828105394."""
        for name, cycles, speedup in (("expf", 7046, 2.1197842747658244),
                                      ("logf", 15940, 1.5592220828105394)):
            assert api.evaluate(name, api.Target.system(1)).cycles_copift \
                == cycles
            four = api.evaluate(name, api.Target.system(4))
            assert four.speedup == speedup
            assert_reports_equal(four, japi.evaluate(name,
                                                     japi.Target.system(4)))

    def test_wide_hbm_and_zero_noc_stay_exact(self):
        sys_r = api.evaluate("expf", api.Target.system(
            1, hbm_bytes_per_cycle=64.0), total_blocks=48)
        one = api.evaluate("expf", api.Target(), total_blocks=48)
        assert_reports_equal(sys_r, one)


class TestSystemScaling:
    def test_compute_bound_strong_scaling_is_exactly_linear(self):
        r1 = api.evaluate("poly_lcg", api.Target.system(1), total_blocks=128)
        r8 = api.evaluate("poly_lcg", api.Target.system(8), total_blocks=128)
        assert r1.cycles_copift == 8 * r8.cycles_copift
        assert r8.power_copift_mw == pytest.approx(8 * r1.power_copift_mw)
        assert_reports_equal(r8, japi.evaluate(
            "poly_lcg", japi.Target.system(8), total_blocks=128))

    def test_hbm_roofline_flattens_the_curve(self):
        reps = {k: api.evaluate(
            "expf", api.Target.system(k, hbm_bytes_per_cycle=16.0),
            total_blocks=128) for k in (1, 2, 4, 8, 16)}
        cycles = {k: r.cycles_copift for k, r in reps.items()}
        assert all(cycles[b] <= cycles[a] for a, b in
                   zip((1, 2, 4, 8), (2, 4, 8, 16)))
        assert cycles[16] == cycles[8]
        free = api.evaluate("expf", api.Target.system(16),
                            total_blocks=128).cycles_copift
        assert cycles[16] > free
        assert reps[8].dma_bound
        for k in (2, 16):
            assert_reports_equal(reps[k], japi.evaluate(
                "expf", japi.Target.system(k, hbm_bytes_per_cycle=16.0),
                total_blocks=128))

    @pytest.mark.parametrize("spec", ["4x8c,hbm=64,noc=12,strategy=lpt",
                                      "3x4c,hbm=16,strategy=static_proportional",
                                      "2x8c,hbm=none"])
    def test_parsed_systems_equal_the_jax_package(self, spec):
        for name in ("expf", "pi_lcg"):
            for kw in (dict(), dict(total_blocks=37)):
                assert_reports_equal(
                    api.evaluate(name, api.Target.system(spec), **kw),
                    japi.evaluate(name, japi.Target.system(spec), **kw))

    def test_mixed_clusters_and_slow_point_equal_the_jax_package(self):
        def run(a, s, cluster):
            mixed = s.SystemConfig(clusters=(cluster, cluster.with_cores(4)),
                                   hbm_bytes_per_cycle=24.0)
            return a.evaluate("logf", a.Target.system(
                mixed, point=a.OPERATING_POINTS[1]), total_blocks=29)
        assert_reports_equal(run(api, system, SNITCH_CLUSTER),
                             run(japi, jsystem, JSNITCH))

    def test_report_totals_span_the_system(self):
        r = api.evaluate("expf", api.Target.system(4), blocks_per_core=2)
        assert r.n_cores == 4 * SNITCH_CLUSTER.n_cores
        assert len(r.core_points) == len(r.blocks_per_core) == r.n_cores
        assert r.total_blocks == 2 * r.n_cores

    def test_errors_match_the_jax_package(self):
        for a, ev in ((api, evaluate_system),
                      (japi, jsystem.evaluate_system)):
            with pytest.raises(ValueError, match="single-cluster"):
                a.evaluate("expf", a.Target.system(2), plan=object())
            with pytest.raises(ValueError, match="at least one block"):
                a.evaluate("expf", a.Target.system(2), total_blocks=0)
            with pytest.raises(ValueError, match="no SystemConfig"):
                ev("expf", a.Target())
            with pytest.raises(ValueError, match="tuner-only"):
                ev("softmax", a.Target.system(2))

    def test_faults_raise_naming_the_roadmap_item(self):
        """``evaluate_system(faults=...)``, which raised until the fault
        model was ported, degrades the part as the JAX package does: a
        dead core, a throttled island and a narrowed port; an all-dead
        part raises ``AllCoresDeadError``."""
        from repro import resilience as jres

        from repro_torch import resilience
        t, jt = api.Target.system(2, hbm_bytes_per_cycle=64.0), \
            japi.Target.system(2, hbm_bytes_per_cycle=64.0)
        base = evaluate_system("montecarlo", t, total_blocks=48)
        for kw in (dict(dead_cores=((1, 3),)), dict(freq_caps=((0, 0.6),)),
                   dict(hbm_scale=0.5)):
            mine = evaluate_system("montecarlo", t, total_blocks=48,
                                   faults=resilience.FaultState(**kw))
            assert_reports_equal(mine, jsystem.evaluate_system(
                "montecarlo", jt, total_blocks=48,
                faults=jres.FaultState(**kw)))
            assert mine.cycles_copift >= base.cycles_copift
        with pytest.raises(resilience.AllCoresDeadError):
            evaluate_system("expf", t, faults=resilience.FaultState(
                dead_clusters=(0, 1)))

    def test_default_target_is_the_lone_cluster(self):
        assert_reports_equal(evaluate_system("expf"),
                             jsystem.evaluate_system("expf"))


class TestTopologyAndGrammar:
    def test_defaults_are_the_lone_cluster(self):
        s = SystemConfig()
        assert s.n_clusters == 1 and s.n_cores == SNITCH_CLUSTER.n_cores
        assert s.is_uniform and s.hbm_bytes_per_cycle is None

    def test_parse_system_round_trip(self):
        s = parse_system("4x8c,hbm=256,noc=12,strategy=lpt", SNITCH_CLUSTER)
        assert (s.n_clusters, s.clusters[0].n_cores, s.hbm_bytes_per_cycle,
                s.noc_latency_cycles, s.cluster_strategy) == \
            (4, 8, 256.0, 12, "lpt")
        assert plain(s) == plain(jsystem.parse_system(
            "4x8c,hbm=256,noc=12,strategy=lpt", JSNITCH))

    @pytest.mark.parametrize("bad", [
        "", "4", "4x", "x8c", "0x8c", "4x0c", "4x8", "4x8c,hbm",
        "4x8c,hbm=-2", "4x8c,noc=1.5", "4x8c,strategy=nope",
        "4x8c,bogus=1"])
    def test_parse_system_grammar_errors(self, bad):
        with pytest.raises(ValueError):
            parse_system(bad, SNITCH_CLUSTER)

    def test_target_system_and_exports(self):
        by_int = api.Target.system(4, hbm_bytes_per_cycle=256.0)
        by_str = api.Target.system("4x8c,hbm=256")
        by_cfg = api.Target.system(SystemConfig.homogeneous(
            4, SNITCH_CLUSTER, hbm_bytes_per_cycle=256.0))
        assert by_int.system_config == by_str.system_config \
            == by_cfg.system_config
        assert (by_int.n_clusters, by_int.n_cores) == (4, 32)
        assert api.SystemConfig is SystemConfig
        assert api.parse_system is parse_system
        assert sorted(system.__all__) == sorted(jsystem.__all__)


class TestTunerClusterCount:
    @pytest.mark.parametrize("cap", [1000.0, 4000.0])
    @pytest.mark.parametrize("name,power,time_ns,cycles", [
        ("softmax", 88.12124816086316, 208912.0, 104456),
        ("prng", 78.87609989543954, 205360.0, 102680)])
    def test_system_plan_reference_values(self, name, power, time_ns,
                                          cycles, cap):
        """The serve engine's system search: ``Tuner(Target.system(4
        clusters, power_cap_mw)).operating_point(name, n_clusters=4)``
        keeps one cluster under the energy objective."""
        def run(a, s, cluster):
            return a.Tuner(a.Target.system(
                s.SystemConfig.homogeneous(4, cluster),
                power_cap_mw=cap)).operating_point(name, n_clusters=4)
        res = run(api, system, SNITCH_CLUSTER)
        assert isinstance(res, SystemPoint)
        assert (res.n_clusters, res.best_cost.power_mw, res.best_cost.time_ns,
                res.best_cost.cycles) == (1, power, time_ns, cycles)
        assert res.feasible and res.power_cap_mw == cap
        assert plain(res) == plain(run(japi, jsystem, JSNITCH))

    def test_system_point_under_power_cap(self):
        res = api.Tuner(api.Target.homogeneous(
            power_cap_mw=4000.0)).operating_point("softmax", n_clusters=4)
        assert 1 <= res.n_clusters <= 4 and res.feasible
        assert res.best_cost.power_mw <= 4000.0

    @pytest.mark.parametrize("objective,want", [("time", 4), ("energy", 1)])
    def test_objective_sizes_the_part(self, objective, want):
        res = api.Tuner().operating_point("softmax", n_clusters=(1, 2, 4),
                                          objective=objective)
        assert res.n_clusters == want
        assert plain(res) == plain(japi.Tuner().operating_point(
            "softmax", n_clusters=(1, 2, 4), objective=objective))

    def test_hbm_and_noc_from_the_target(self):
        """A system target's HBM and NoC settings price the search."""
        def run(a):
            return a.Tuner(a.Target.system("2x8c,hbm=8,noc=20",
                                           power_cap_mw=500.0)
                           ).operating_point("expf", n_clusters=3)
        assert plain(run(api)) == plain(run(japi))

    def test_select_system_point_validation(self):
        for sel in (select_system_point, jsystem.select_system_point):
            with pytest.raises(ValueError, match="counts must be"):
                sel("softmax", 0)
            with pytest.raises(ValueError, match="no cluster counts"):
                sel("softmax", ())

    @pytest.mark.parametrize("name", ["expf", "softmax", "prng"])
    def test_system_cost_equals_the_jax_package(self, name):
        for k, pt in ((2, SNITCH_CLUSTER.nominal.name),
                      (3, SNITCH_CLUSTER.operating_points[0].name)):
            est = system_cost(name, SystemConfig.homogeneous(
                k, SNITCH_CLUSTER), pt, problem=65536, power_cap_mw=200.0)
            jest = jsystem.system_cost(name, jsystem.SystemConfig.homogeneous(
                k, JSNITCH), pt, problem=65536, power_cap_mw=200.0)
            assert plain(est) == plain(jest)
            assert est.cycles > 0 and est.power_mw > 0


class TestClusterAnalytics:
    """``cluster.analytics``: the scaling curves, efficiency, roofline and
    strategy comparison equal the JAX package's."""

    def test_weak_and_strong_scaling(self):
        for fn, kw in ((analytics.weak_scaling, dict(blocks_per_core=2)),
                       (analytics.strong_scaling, dict(total_blocks=24))):
            mine = fn("expf", cores=(1, 2, 4, 8), **kw)
            theirs = getattr(janalytics, fn.__name__)(
                "expf", cores=(1, 2, 4, 8), **kw)
            for r, jr in zip(mine, theirs):
                assert_reports_equal(r, jr)
            assert analytics.scaling_efficiency(mine) == \
                janalytics.scaling_efficiency(theirs)
            assert analytics.scaling_efficiency(mine)[0] == 1.0

    def test_scaling_at_a_slow_point(self):
        pt = api.OPERATING_POINTS[0]
        mine = analytics.weak_scaling("logf", cores=(1, 3), point=pt)
        theirs = janalytics.weak_scaling("logf", cores=(1, 3),
                                         point=japi.OPERATING_POINTS[0])
        for r, jr in zip(mine, theirs):
            assert_reports_equal(r, jr)

    def test_cluster_roofline(self):
        mine = analytics.cluster_roofline()
        assert plain(mine) == plain(janalytics.cluster_roofline())
        assert [p.name for p in mine] == list(KERNELS)
        assert {p.bound for p in mine} <= {"compute", "memory"}
        assert all(p.achieved_gflops <= p.peak_gflops for p in mine)

    def test_compare_strategies(self):
        spec = "2@1.45GHz@1.00V,6@0.50GHz@0.60V"
        cfg = SNITCH_CLUSTER.with_islands(
            *api.parse_islands(spec, SNITCH_CLUSTER))
        jcfg = JSNITCH.with_islands(*japi.parse_islands(spec, JSNITCH))
        mine = analytics.compare_strategies("expf", cfg, total_blocks=13)
        theirs = janalytics.compare_strategies("expf", jcfg, total_blocks=13)
        assert sorted(mine) == sorted(theirs) == sorted(STRATEGIES)
        for s in mine:
            assert_reports_equal(mine[s], theirs[s])

    def test_aliases_and_exports(self):
        from repro.cluster import __all__ as jall
        from repro_torch.cluster import __all__ as all_
        assert analytics.ClusterKernelResult is api.Report
        assert analytics.HetClusterResult is api.Report
        assert sorted(all_) == sorted(jall)


# ---------------------------------------------------------------------------
# The hierarchical scheduler and the NoC (tests/test_system_properties.py)
# ---------------------------------------------------------------------------

def _assignment_data(sa):
    return (sa.n_blocks, sa.cluster_blocks,
            tuple(a.blocks_per_core for a in sa.core_assignments),
            sa.flat.blocks_per_core, sa.flat.core_speeds)


class TestSchedulerAndNocExamples:
    @pytest.mark.parametrize("strategy", STRATEGIES)
    @pytest.mark.parametrize("n_blocks,clusters", [
        (0, ((1.0,) * 8, (1.0,) * 8)),
        (1, ((0.5, 1.45), (1.0,))),
        (48, ((1.0,) * 8,) * 4),
        (97, ((1.45, 1.45, 0.5), (0.75,) * 5, (1.0, 1.25))),
    ])
    def test_block_conservation_across_clusters(self, strategy, n_blocks,
                                                clusters):
        sa = assign_system(n_blocks, clusters, cluster_strategy=strategy,
                           core_strategy=strategy)
        assert sum(sa.cluster_blocks) == n_blocks
        for share, inner in zip(sa.cluster_blocks, sa.core_assignments):
            assert sum(inner.blocks_per_core) == share
        assert sum(sa.flat.blocks_per_core) == n_blocks
        assert _assignment_data(sa) == _assignment_data(jsystem.assign_system(
            n_blocks, clusters, cluster_strategy=strategy,
            core_strategy=strategy))

    @pytest.mark.parametrize("strategy", STRATEGIES)
    def test_uniform_clusters_reduce_to_single_level(self, strategy):
        sa = assign_system(96, ((1.0,) * 8,) * 4, cluster_strategy=strategy,
                           core_strategy=strategy)
        for share, inner in zip(sa.cluster_blocks, sa.core_assignments):
            assert sorted(inner.blocks_per_core) == \
                sorted(assign(share, (1.0,) * 8, strategy).blocks_per_core)

    def test_assign_system_needs_a_cluster(self):
        with pytest.raises(ValueError, match="at least one cluster"):
            assign_system(4, ())

    def test_fair_shares_split_the_budget(self):
        assert fair_shares((64.0, 64.0, 64.0, 64.0), 64.0) == (16.0,) * 4
        shares = fair_shares((4.0, 64.0, 64.0), 64.0)
        assert shares == (4.0, 30.0, 30.0)
        assert shares == jsystem.fair_shares((4.0, 64.0, 64.0), 64.0)

    def test_hbm_monotone_example(self):
        sys16 = SystemConfig.homogeneous(4, SNITCH_CLUSTER,
                                         hbm_bytes_per_cycle=16.0)
        nbytes = (40192,) * 4
        t16 = system_transfer_cycles(sys16, nbytes)
        t64 = system_transfer_cycles(sys16.with_hbm(64.0), nbytes)
        tf = system_transfer_cycles(sys16.with_hbm(None), nbytes)
        assert all(b <= a for a, b in zip(t16, t64))
        assert all(b <= a for a, b in zip(t64, tf))
        j16 = jsystem.SystemConfig.homogeneous(4, JSNITCH,
                                               hbm_bytes_per_cycle=16.0)
        assert t16 == jsystem.system_transfer_cycles(j16, nbytes)
        assert is_saturated(sys16) and not is_saturated(sys16.with_hbm(None))
        with pytest.raises(ValueError, match="per-cluster byte counts"):
            system_transfer_cycles(sys16, (1, 2))

    def test_noc_metrics_and_roofline_equal_the_jax_package(self):
        from repro import obs as jobs
        from repro_torch import obs
        s = SystemConfig.homogeneous(3, SNITCH_CLUSTER,
                                     hbm_bytes_per_cycle=20.0,
                                     noc_latency_cycles=7)
        js = jsystem.SystemConfig.homogeneous(3, JSNITCH,
                                              hbm_bytes_per_cycle=20.0,
                                              noc_latency_cycles=7)
        nbytes = (5000, 0, 123457)
        with obs.session(trace=False) as sess:
            got = system_transfer_cycles(s, nbytes)
        with jobs.session(trace=False) as jsess:
            want = jsystem.system_transfer_cycles(js, nbytes)
        assert got == want
        m, jm = sess.metrics(), jsess.metrics()
        assert m["system.noc.arbitrated_transfers"]["value"] == 2
        assert {k: v for k, v in m.items() if k.startswith("system.")} == \
            {k: v for k, v in jm.items() if k.startswith("system.")}
        for total in (0, 1, 99999):
            assert hbm_roofline_cycles(s, total) == \
                jsystem.hbm_roofline_cycles(js, total)


def _cluster_speeds_strategy():
    core_speeds = st.lists(st.sampled_from(SPEED_LADDER),
                           min_size=1, max_size=8)
    return st.lists(core_speeds, min_size=1, max_size=6)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
class TestProperties:
    @settings(max_examples=100, deadline=None)
    @given(n_blocks=st.integers(min_value=0, max_value=512),
           clusters=_cluster_speeds_strategy(),
           cluster_strategy=st.sampled_from(STRATEGIES),
           core_strategy=st.sampled_from(STRATEGIES))
    def test_block_conservation(self, n_blocks, clusters, cluster_strategy,
                                core_strategy):
        """Scheduling draws 0 blocks too: only ``evaluate`` refuses them."""
        clusters = tuple(tuple(c) for c in clusters)
        sa = assign_system(n_blocks, clusters,
                           cluster_strategy=cluster_strategy,
                           core_strategy=core_strategy)
        assert sum(sa.cluster_blocks) == n_blocks
        for share, inner in zip(sa.cluster_blocks, sa.core_assignments):
            assert sum(inner.blocks_per_core) == share
            assert all(b >= 0 for b in inner.blocks_per_core)
        assert sum(sa.flat.blocks_per_core) == n_blocks
        assert sa.flat.n_cores == sum(len(c) for c in clusters)
        assert _assignment_data(sa) == _assignment_data(jsystem.assign_system(
            n_blocks, clusters, cluster_strategy=cluster_strategy,
            core_strategy=core_strategy))

    @settings(max_examples=100, deadline=None)
    @given(n_blocks=st.integers(min_value=0, max_value=512),
           n_clusters=st.integers(min_value=1, max_value=6),
           n_cores=st.integers(min_value=1, max_value=8),
           speed=st.sampled_from(SPEED_LADDER),
           strategy=st.sampled_from(STRATEGIES))
    def test_uniform_reduces_to_single_level(self, n_blocks, n_clusters,
                                             n_cores, speed, strategy):
        clusters = ((speed,) * n_cores,) * n_clusters
        sa = assign_system(n_blocks, clusters, cluster_strategy=strategy,
                           core_strategy=strategy)
        for share, inner in zip(sa.cluster_blocks, sa.core_assignments):
            flat = assign(share, (speed,) * n_cores, strategy)
            assert sorted(inner.blocks_per_core) == \
                sorted(flat.blocks_per_core)
            assert flat.blocks_per_core == jassign(
                share, (speed,) * n_cores, strategy).blocks_per_core

    @settings(max_examples=100, deadline=None)
    @given(widths=st.lists(st.sampled_from((4.0, 16.0, 64.0)),
                           min_size=1, max_size=8),
           hbm_lo=st.floats(min_value=1.0, max_value=256.0),
           scale=st.floats(min_value=1.0, max_value=8.0))
    def test_fair_shares_monotone_in_budget(self, widths, hbm_lo, scale):
        widths = tuple(widths)
        lo = fair_shares(widths, hbm_lo)
        hi = fair_shares(widths, hbm_lo * scale)
        assert all(b >= a - 1e-9 for a, b in zip(lo, hi))
        assert all(s <= w + 1e-9 for s, w in zip(lo, widths))
        assert sum(lo) <= hbm_lo + 1e-9 or sum(widths) <= hbm_lo
        assert lo == jsystem.fair_shares(widths, hbm_lo)

    @settings(max_examples=60, deadline=None)
    @given(n_clusters=st.integers(min_value=1, max_value=6),
           blocks_per_cluster=st.integers(min_value=1, max_value=64),
           hbm_lo=st.floats(min_value=2.0, max_value=128.0),
           scale=st.floats(min_value=1.0, max_value=16.0))
    def test_transfer_cycles_monotone_in_hbm(self, n_clusters,
                                             blocks_per_cluster, hbm_lo,
                                             scale):
        nbytes = tuple(2512 * blocks_per_cluster for _ in range(n_clusters))
        base = SystemConfig.homogeneous(n_clusters, SNITCH_CLUSTER,
                                        hbm_bytes_per_cycle=hbm_lo)
        lo = system_transfer_cycles(base, nbytes)
        hi = system_transfer_cycles(base.with_hbm(hbm_lo * scale), nbytes)
        free = system_transfer_cycles(base.with_hbm(None), nbytes)
        assert all(b <= a for a, b in zip(lo, hi))
        assert all(f <= b for f, b in zip(free, hi))
        assert all(t >= math.ceil(n / SNITCH_CLUSTER.dma_bytes_per_cycle)
                   for t, n in zip(lo, nbytes))
        assert lo == jsystem.system_transfer_cycles(
            jsystem.SystemConfig.homogeneous(n_clusters, JSNITCH,
                                             hbm_bytes_per_cycle=hbm_lo),
            nbytes)

    @settings(max_examples=12, deadline=None)
    @given(name=st.sampled_from(("expf", "logf", "poly_lcg")),
           spec=st.sampled_from(("2x8c", "3x4c,hbm=16", "2x2c,noc=5,hbm=4",
                                 "4x8c,hbm=64,strategy=lpt")),
           blocks=st.integers(min_value=1, max_value=40),
           strategy=st.sampled_from(STRATEGIES))
    def test_system_reports_equal_the_jax_package(self, name, spec, blocks,
                                                  strategy):
        """Drawn system targets and strong-scaling block counts (at least
        one: ``evaluate`` refuses 0 blocks in both packages) give the JAX
        package's ``Report``."""
        assert_reports_equal(
            api.evaluate(name, api.Target.system(spec, strategy=strategy),
                         total_blocks=blocks),
            japi.evaluate(name, japi.Target.system(spec, strategy=strategy),
                          total_blocks=blocks))
