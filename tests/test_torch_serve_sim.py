"""The port's serving simulator (``repro_torch.serve.{traffic,sim,
policies}``) against the JAX package's, on the CPU.

Every ``Trace``, ``CostEstimate``, ``SlotPlan`` and ``SimReport`` equals
the JAX package's with ``==`` on the same inputs (the latency series, the
percentile table, the energies and the plan switches bit for bit), and
the port keeps the simulator's own invariants: a replay is ``==``, a
1-core 1-request run costs exactly ``api.evaluate``'s cycles, drops break
the SLO, and on the JAX package's ``benchmarks/serve_bench.py`` scenario
static misses the p99 SLO while mpc meets it at no more energy.  Mirrors
the simulator classes of ``tests/test_serve.py`` (its engine and
latency-objective classes are held by ``tests/test_torch_serve.py`` and
``tests/test_torch_tune.py``).  The simulator's milliseconds and
microjoules are the Snitch model's."""

import math

import pytest

pytest.importorskip("torch")

from test_torch_core import plain  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.perf import memo as jmemo  # noqa: E402
from repro_torch import obs, serve  # noqa: E402
from repro_torch.perf import memo  # noqa: E402
from repro_torch.serve import (POLICIES, ModelPredictivePolicy,  # noqa: E402
                               ReactivePolicy, Request, ServicePricer,
                               SloSpec, SlotPlan, StaticPolicy, Trace,
                               make_trace, plan_for_rate, simulate)

#: The JAX package's ``benchmarks/serve_bench.py`` scenario.
BENCH_SPEC = ("bursty:rate=860,burst=2.33,period_ms=1200,duty=0.22,"
              "kernel=softmax,elems=65536")
BENCH_SEED, BENCH_SMOKE_MS, BENCH_SLO_MS = 11, 1200.0, 10.0
BENCH_EPOCH_MS, BENCH_QUEUE_CAP = 10.0, 256
PKGS = (serve, jserve)


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    memo.clear_all()
    jmemo.clear_all()


def assert_sims_equal(mine, theirs):
    """Every field and derived figure of two ``SimReport``\\ s."""
    assert plain(mine) == plain(theirs)
    for prop in ("completed_frac", "slo_met", "slo_violations",
                 "energy_uj_per_request"):
        a, b = getattr(mine, prop), getattr(theirs, prop)
        assert a == b or (a != a and b != b), prop
    assert mine.format_lines() == theirs.format_lines()


def _both(fn):
    """``fn(pkg)`` for the port and the JAX package."""
    return fn(serve), fn(jserve)


class TestTraffic:
    @pytest.mark.parametrize("spec", [
        "poisson:rate=500",
        "poisson:rate=800,kernel=expf,elems=4096",
        "bursty:rate=120,burst=6,period_ms=200,duty=0.15",
        "bursty:rate=200,burst=8,period_ms=100,duty=0.2,kernel=logf",
        "diurnal:low=40,high=400,period_ms=400",
        "diurnal:low=10,high=900",
        BENCH_SPEC])
    @pytest.mark.parametrize("seed", [0, 11])
    def test_trace_equals_the_jax_package(self, spec, seed):
        mine, theirs = _both(lambda p: p.make_trace(spec, duration_ms=600.0,
                                                    seed=seed))
        assert plain(mine) == plain(theirs) and mine.n_requests > 0
        assert mine.mean_rate_rps == theirs.mean_rate_rps
        assert mine.rate_profile(50.0) == theirs.rate_profile(50.0)
        assert make_trace(spec, duration_ms=600.0, seed=seed) == mine

    def test_seed_changes_the_requests(self):
        a = make_trace("poisson:rate=500", duration_ms=200.0, seed=9)
        assert a.requests != make_trace("poisson:rate=500",
                                        duration_ms=200.0,
                                        seed=10).requests

    def test_bursty_concentrates_arrivals_in_the_duty_window(self):
        tr = make_trace("bursty:rate=200,burst=8,period_ms=100,duty=0.2",
                        duration_ms=1000.0, seed=4)
        in_burst = sum((r.t_arrival_ms % 100.0) < 20.0 for r in tr.requests)
        assert in_burst > tr.n_requests / 2

    @pytest.mark.parametrize("bad,msg,kw", [
        ("pareto:rate=5", "unknown trace family", {}),
        ("poisson:rate", "bad trace-spec token", {}),
        ("poisson:kernel=softmax", "missing required", {}),
        ("poisson:rate=5,ratee=6", "unknown trace-spec keys", {}),
        ("bursty:rate=5,duty=1.5", "duty", {}),
        ("diurnal:low=9,high=3", "low <= high", {}),
        ("poisson:rate=5", "duration_ms", dict(duration_ms=0.0))])
    def test_spec_grammar_errors(self, bad, msg, kw):
        msgs = []
        for pkg in PKGS:
            with pytest.raises(ValueError, match=msg) as exc:
                pkg.make_trace(bad, **kw)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


class TestPricer:
    @pytest.mark.parametrize("kern", ["softmax", "prng", "expf", "logf"])
    def test_prices_equal_the_jax_package(self, kern):
        shapes = [(16384 * b, c, p) for b in (1, 4) for c in (1, 2, 8)
                  for p in ("0.50GHz@0.60V", "1.00GHz@0.80V")]
        mine, theirs = _both(lambda p: p.ServicePricer())
        assert plain(mine.price_many(kern, shapes)) == \
            plain(theirs.price_many(kern, shapes))
        assert plain([mine.price(kern, *s) for s in shapes[:3]]) == \
            plain([theirs.price(kern, *s) for s in shapes[:3]])
        for p in ("0.50GHz@0.60V", "1.45GHz@1.00V"):
            assert mine.idle_power_mw(kern, p) == \
                theirs.idle_power_mw(kern, p)

    @pytest.mark.parametrize("kern", ["softmax", "expf"])
    def test_system_pricer_equals_the_jax_package(self, kern):
        """``ServicePricer(system=...)``: slots of whole clusters priced
        through ``Target.system`` (simulatable kernels) or the ceil-shared
        tuner oracle (tuner-only), a sub-cluster slot on the cluster."""
        from repro.cluster.topology import SNITCH_CLUSTER as J
        from repro.system import SystemConfig as JSystem

        from repro_torch.cluster.topology import SNITCH_CLUSTER
        from repro_torch.system import SystemConfig
        mine = ServicePricer(system=SystemConfig.homogeneous(
            4, SNITCH_CLUSTER, hbm_bytes_per_cycle=256.0))
        theirs = jserve.ServicePricer(system=JSystem.homogeneous(
            4, J, hbm_bytes_per_cycle=256.0))
        assert mine.n_cores == theirs.n_cores == 32
        shapes = [(65536, c, "1.00GHz@0.80V") for c in (2, 8, 16, 32)]
        assert plain(mine.price_many(kern, shapes)) == \
            plain(theirs.price_many(kern, shapes))

    def test_system_pricer_needs_uniform_clusters(self):
        from repro_torch.cluster.topology import SNITCH_CLUSTER
        from repro_torch.system import SystemConfig
        odd = SystemConfig(clusters=(SNITCH_CLUSTER,
                                     SNITCH_CLUSTER.with_cores(4)))
        with pytest.raises(ValueError, match="uniform clusters"):
            ServicePricer(system=odd)


class TestSimulator:
    @pytest.mark.parametrize("policy", ["static", "reactive", "mpc"])
    def test_report_equals_the_jax_package(self, policy):
        mine, theirs = _both(lambda p: p.simulate(
            p.make_trace("bursty:rate=600,kernel=softmax,elems=16384",
                         duration_ms=400.0, seed=2),
            p.POLICIES[policy](600.0), slo=p.SloSpec(latency_ms=10.0),
            epoch_ms=10.0))
        assert_sims_equal(mine, theirs)

    def test_percentile_table_is_bit_reproducible(self):
        trace = make_trace("bursty:rate=600,kernel=softmax,elems=16384",
                           duration_ms=400.0, seed=2)
        slo, pricer = SloSpec(latency_ms=10.0), ServicePricer()
        a = simulate(trace, ModelPredictivePolicy(), slo=slo, pricer=pricer,
                     epoch_ms=10.0)
        b = simulate(trace, ModelPredictivePolicy(), slo=slo, pricer=pricer,
                     epoch_ms=10.0)
        assert a == b and a.latency_ms == b.latency_ms

    @pytest.mark.parametrize("kern,point", [("expf", "1.00GHz@0.80V"),
                                            ("logf", "0.50GHz@0.60V")])
    def test_one_core_one_request_reduces_to_api_evaluate(self, kern, point):
        from repro_torch.api import SNITCH_CLUSTER, Target, evaluate
        from repro_torch.api.registry import kernel
        elems = 8192
        trace = Trace(spec="manual", seed=0, duration_ms=1.0,
                      requests=(Request(0, 0.0, kern, elems),))
        plan = SlotPlan(n_slots=8, point=point, batch_max=1)
        rep = simulate(trace, StaticPolicy(plan=plan),
                       slo=SloSpec(latency_ms=100.0))
        blocks = -(-elems // kernel(kern).get_workload().max_block)
        ref = evaluate(kern, Target.homogeneous(
            n_cores=1, point=SNITCH_CLUSTER.point(point)),
            total_blocks=blocks)
        assert rep.n_completed == 1
        assert rep.latencies_ms[0] == \
            ref.cycles_copift / ref.ref_freq_ghz * 1e-6
        assert rep.active_energy_uj == pytest.approx(
            ref.power_copift_mw * ref.cycles_copift / ref.ref_freq_ghz
            * 1e-6)
        jrep = jserve.simulate(
            jserve.Trace(spec="manual", seed=0, duration_ms=1.0,
                         requests=(jserve.Request(0, 0.0, kern, elems),)),
            jserve.StaticPolicy(plan=jserve.SlotPlan(n_slots=8, point=point,
                                                     batch_max=1)),
            slo=jserve.SloSpec(latency_ms=100.0))
        assert_sims_equal(rep, jrep)

    def test_queue_cap_drops_break_the_slo(self):
        mine, theirs = _both(lambda p: p.simulate(
            p.make_trace("poisson:rate=4000,elems=65536", duration_ms=100.0,
                         seed=5),
            p.StaticPolicy(plan=p.SlotPlan(n_slots=1, point="0.50GHz@0.60V",
                                           batch_max=1)),
            slo=p.SloSpec(latency_ms=1000.0), queue_cap=2))
        assert_sims_equal(mine, theirs)
        assert mine.n_dropped > 0 and not mine.slo_met

    def test_slo_aware_admission_sheds(self):
        mine, theirs = _both(lambda p: p.simulate(
            p.make_trace("poisson:rate=3000,elems=65536", duration_ms=100.0,
                         seed=5),
            p.StaticPolicy(plan=p.SlotPlan(n_slots=2, point="0.50GHz@0.60V",
                                           batch_max=2)),
            slo=p.SloSpec(latency_ms=5.0), admission="slo_aware"))
        assert_sims_equal(mine, theirs)
        assert mine.n_shed > 0

    def test_empty_trace_yields_empty_report(self):
        trace = Trace(spec="manual", seed=0, duration_ms=10.0, requests=())
        rep = simulate(trace, StaticPolicy(
            plan=SlotPlan(n_slots=1, point="0.50GHz@0.60V")))
        assert rep.n_completed == 0 and rep.energy_uj == 0.0
        assert math.isnan(rep.latency_ms["p99"]) and rep.slo_met

    def test_validation_errors(self):
        trace = make_trace("poisson:rate=100", duration_ms=10.0, seed=0)
        pol = StaticPolicy(plan=SlotPlan(n_slots=1, point="0.50GHz@0.60V"))
        for kw, msg in ((dict(epoch_ms=0.0), "epoch_ms"),
                        (dict(queue_cap=0), "queue_cap"),
                        (dict(admission="lifo"), "unknown admission"),
                        (dict(admission="slo_aware"), "needs an SloSpec")):
            with pytest.raises(ValueError, match=msg):
                simulate(trace, pol, **kw)
        with pytest.raises(ValueError, match="does not divide"):
            SlotPlan(n_slots=3, point="0.50GHz@0.60V").validate(8)
        with pytest.raises(ValueError, match="n_slots"):
            SlotPlan(n_slots=0, point="0.50GHz@0.60V").validate(8)
        with pytest.raises(ValueError, match="batch_max"):
            SlotPlan(n_slots=1, point="0.50GHz@0.60V",
                     batch_max=0).validate(8)
        with pytest.raises(ValueError, match="latency_ms"):
            SloSpec(latency_ms=0.0)
        with pytest.raises(ValueError, match="percentile"):
            SloSpec(latency_ms=1.0, percentile=0.0)

    def test_sim_emits_the_jax_package_metrics(self):
        """Names and values of the metrics one simulation emits, but the
        spans' wall-clock histograms."""
        got = []
        for p, o in ((serve, obs), (jserve, jobs)):
            trace = p.make_trace("poisson:rate=300", duration_ms=50.0,
                                 seed=1)
            pol = p.StaticPolicy(plan=p.SlotPlan(n_slots=4,
                                                 point="0.75GHz@0.70V"))
            with o.session(trace=False, metrics=True) as sess:
                p.simulate(trace, pol, slo=p.SloSpec(latency_ms=50.0))
            got.append({k: v for k, v in sess.metrics().items()
                        if not k.startswith("span.")})
        assert got[0] == got[1]
        assert "serve.sim.static.p99_ms" in got[0]
        assert "serve.sim.static.energy_uj" in got[0]

    def test_system_pricer_simulation_equals_the_jax_package(self):
        from repro.cluster.topology import SNITCH_CLUSTER as J
        from repro.system import SystemConfig as JSystem

        from repro_torch.cluster.topology import SNITCH_CLUSTER
        from repro_torch.system import SystemConfig
        reps = []
        for p, pricer in (
                (serve, ServicePricer(system=SystemConfig.homogeneous(
                    2, SNITCH_CLUSTER))),
                (jserve, jserve.ServicePricer(system=JSystem.homogeneous(
                    2, J)))):
            reps.append(p.simulate(
                p.make_trace("poisson:rate=2000,kernel=softmax,elems=65536",
                             duration_ms=100.0, seed=3),
                p.ModelPredictivePolicy(), slo=p.SloSpec(latency_ms=10.0),
                pricer=pricer, epoch_ms=10.0))
        assert_sims_equal(*reps)


class TestPolicies:
    @staticmethod
    def _ctx(pkg, slo_ms=10.0, power_cap_mw=None):
        return pkg.PolicyContext(pricer=pkg.ServicePricer(), kernel="softmax",
                                 elems=16384, n_cores=8, epoch_ms=10.0,
                                 slo=pkg.SloSpec(latency_ms=slo_ms),
                                 power_cap_mw=power_cap_mw)

    @pytest.mark.parametrize("rate", [50.0, 400.0, 3000.0, 1e6])
    @pytest.mark.parametrize("cap", [None, 100.0])
    def test_plan_for_rate_equals_the_jax_package(self, rate, cap):
        mine, theirs = _both(lambda p: p.plan_for_rate(
            self._ctx(p, power_cap_mw=cap), rate))
        assert plain(mine) == plain(theirs)

    def test_plan_grid_equals_the_jax_package(self):
        mine, theirs = _both(lambda p: p.plan_grid(self._ctx(p)))
        assert plain(mine) == plain(theirs) and len(mine) == 4 * 5 * 4

    def test_plan_for_rate_scales_energy_with_load(self):
        ctx = self._ctx(serve)
        lo, hi = plan_for_rate(ctx, 50.0), plan_for_rate(ctx, 3000.0)

        def per_req(plan):
            est = ctx.pricer.price(ctx.kernel, ctx.elems * plan.batch_max,
                                   plan.cores_per_slot(8), plan.point)
            cap = plan.n_slots * plan.batch_max / (est.time_ns * 1e-9)
            return est.energy_pj / plan.batch_max, cap

        (e_lo, cap_lo), (e_hi, cap_hi) = per_req(lo), per_req(hi)
        assert cap_lo >= 1.25 * 50.0 and cap_hi >= 1.25 * 3000.0
        assert e_lo <= e_hi

    def test_plan_for_rate_respects_power_cap(self):
        ctx = self._ctx(serve, power_cap_mw=100.0)
        plan = plan_for_rate(ctx, 200.0)
        est = ctx.pricer.price(ctx.kernel, ctx.elems * plan.batch_max,
                               plan.cores_per_slot(8), plan.point)
        assert plan.n_slots * est.power_mw <= 100.0
        with pytest.raises(ValueError, match="empty plan grid"):
            plan_for_rate(ctx, 1.0, grid=[])

    def test_reactive_ladder_and_mpc_decisions_equal_the_jax_package(self):
        """The reactive policy's Pareto ladder and both policies' decisions
        over a scripted observation sequence."""
        obs_seq = [dict(queue_len=q, rate_rps=r)
                   for q, r in ((0, 100.0), (9, 900.0), (12, 2500.0),
                                (3, 1200.0), (0, 80.0), (0, 0.0))]
        for make in (lambda p: p.ReactivePolicy(),
                     lambda p: p.ModelPredictivePolicy()):
            mine, theirs = _both(make)
            mine.bind(self._ctx(serve))
            theirs.bind(self._ctx(jserve))
            if isinstance(mine, ReactivePolicy):
                assert plain(mine._ladder) == plain(theirs._ladder)
            for o in obs_seq:
                assert plain(mine.decide(o)) == plain(theirs.decide(o))

    def test_policy_constructor_validation(self):
        with pytest.raises(ValueError, match="exactly one"):
            StaticPolicy()
        with pytest.raises(ValueError, match="exactly one"):
            StaticPolicy(plan=SlotPlan(n_slots=1, point="x"), rate_rps=10.0)
        with pytest.raises(ValueError, match="lo_queue < hi_queue"):
            ReactivePolicy(hi_queue=4, lo_queue=4)
        with pytest.raises(ValueError, match="alpha"):
            ModelPredictivePolicy(alpha=0.0)

    def test_policies_table_and_exports(self):
        assert set(POLICIES) == {"static", "reactive", "mpc"}
        for factory in POLICIES.values():
            assert factory(100.0).name in POLICIES
        assert serve.__all__ == jserve.__all__
        assert serve.PERCENTILES == jserve.PERCENTILES


class TestServeBenchScenario:
    """The JAX package's ``benchmarks/serve_bench.py`` scenario at its
    1200 ms smoke duration: the three policies' reports equal the JAX
    package's, and the benchmark's acceptance inequality holds."""

    @pytest.fixture(scope="class")
    def reports(self):
        out = []
        for p in PKGS:
            trace = p.make_trace(BENCH_SPEC, duration_ms=BENCH_SMOKE_MS,
                                 seed=BENCH_SEED)
            slo, pricer = p.SloSpec(latency_ms=BENCH_SLO_MS), \
                p.ServicePricer()
            kw = dict(slo=slo, pricer=pricer, epoch_ms=BENCH_EPOCH_MS,
                      queue_cap=BENCH_QUEUE_CAP)
            reps = {name: p.simulate(trace, f(trace.mean_rate_rps), **kw)
                    for name, f in p.POLICIES.items()}
            reps["rerun"] = p.simulate(trace, p.ModelPredictivePolicy(),
                                       **kw)
            out.append(reps)
        return out

    @pytest.mark.parametrize("policy", ["static", "reactive", "mpc"])
    def test_reports_equal_the_jax_package(self, reports, policy):
        assert_sims_equal(reports[0][policy], reports[1][policy])

    def test_acceptance(self, reports):
        mine = reports[0]
        assert not mine["static"].slo_met
        assert mine["mpc"].slo_met
        assert mine["mpc"].energy_uj <= mine["static"].energy_uj
        assert mine["rerun"] == mine["mpc"]
