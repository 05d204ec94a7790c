"""The port's serving failover (``repro_torch.resilience.failover``,
``serve.simulate(faults=..., retry=...)``) against the JAX package's, on
the CPU.

Every fault-mode ``SimReport`` equals the JAX package's with ``==``, and
the port keeps the loop's own invariants: without fail-stop events the
report is the healthy loop's field for field, a replay is ``==``,
kill/retry/lost accounting conserves requests, the retry policy's attempt
and deadline bounds hold, ``FailoverPolicy`` headroom rounds to valid
slot counts, an all-dead machine drains instead of hanging, and the fault
lane and counters reach ``obs`` under the JAX package's names.  On the
JAX package's ``benchmarks/resilience_bench.py`` scenario failover
completes at least the naive policy's fraction with fewer SLO
violations.  Mirrors ``tests/test_failover.py``."""

import math

import pytest

pytest.importorskip("torch")

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402,E501
from test_torch_core import plain  # noqa: E402
from test_torch_serve_sim import assert_sims_equal  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import serve as jserve  # noqa: E402
from repro.perf import memo as jmemo  # noqa: E402
from repro.resilience.failover import _slot_divisor as j_slot_divisor  # noqa: E402,E501
from repro_torch import obs, resilience, serve  # noqa: E402
from repro_torch.perf import memo  # noqa: E402
from repro_torch.resilience.failover import _slot_divisor  # noqa: E402
from repro_torch.serve import (FailoverPolicy, RetryPolicy,  # noqa: E402
                               ServicePricer, SloSpec, SlotPlan,
                               StaticPolicy, make_faults, make_trace,
                               simulate)

FAULT = "corefail@0.5:c0.0"   # lands mid-flight in the first batch
#: The JAX package's ``benchmarks/resilience_bench.py`` scenario.
BENCH = dict(spec="poisson:rate=1500,kernel=softmax,elems=65536", seed=11,
             duration_ms=200.0,
             faults="corefail@60:c0.0,corefail@60:c0.1,corefail@120:c0.2",
             slo_ms=25.0, epoch_ms=10.0, queue_cap=256,
             retry=dict(max_attempts=3, timeout_ms=25.0, backoff=2.0,
                        base_delay_ms=0.5))
PKGS = (serve, jserve)


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    memo.clear_all()
    jmemo.clear_all()


def _trace(p, arrivals, elems=65536, kernel="softmax", duration_ms=20.0):
    """A hand-built trace in package ``p``: arrivals exactly where the
    test needs them (softmax at 65536 services in ~1.5 ms, Snitch model,
    on a 2-core slot)."""
    reqs = tuple(p.Request(rid=i, t_arrival_ms=float(t), kernel=kernel,
                           elems=elems) for i, t in enumerate(arrivals))
    return p.Trace(spec="handmade", seed=0, duration_ms=duration_ms,
                   requests=reqs)


def _run(p, trace, faults, *, retry=None, policy=None, pricer=None):
    plan = p.SlotPlan(n_slots=4, point="1.00GHz@0.80V", batch_max=1)
    return p.simulate(trace, policy or p.StaticPolicy(plan=plan),
                      slo=p.SloSpec(latency_ms=25.0),
                      pricer=pricer or p.ServicePricer(), epoch_ms=5.0,
                      queue_cap=64, faults=faults, retry=retry)


def _both(fn):
    """``fn(pkg)`` for the port and the JAX package; the two reports must
    be equal.  Returns the port's."""
    mine, theirs = fn(serve), fn(jserve)
    assert_sims_equal(mine, theirs)
    return mine


class TestRetryPolicy:
    def test_delay_is_exponential(self):
        r, j = RetryPolicy(base_delay_ms=0.5, backoff=2.0), \
            jserve.RetryPolicy(base_delay_ms=0.5, backoff=2.0)
        assert [r.delay_ms(a) for a in (1, 2, 3)] == \
            [j.delay_ms(a) for a in (1, 2, 3)] == [0.5, 1.0, 2.0]

    @pytest.mark.parametrize("kw,msg", [
        (dict(max_attempts=0), "max_attempts"),
        (dict(timeout_ms=0.0), "timeout_ms"),
        (dict(backoff=0.5), "backoff"),
        (dict(base_delay_ms=-1.0), "base_delay_ms"),
    ])
    def test_validation(self, kw, msg):
        with pytest.raises(ValueError, match=msg):
            RetryPolicy(**kw)


class TestFailoverPolicy:
    @pytest.mark.parametrize("n,want", [(8, 5), (8, 4), (8, 3), (8, 99),
                                        (6, 4), (8, 0), (12, 5), (7, 2)])
    def test_slot_divisor(self, n, want):
        assert _slot_divisor(n, want) == j_slot_divisor(n, want)

    def test_headroom_bumps_slots(self):
        rep = _both(lambda p: _run(p, _trace(p, [0.0]), p.make_faults(""),
                                   policy=p.FailoverPolicy(p.StaticPolicy(
                                       plan=p.SlotPlan(
                                           n_slots=4, point="1.00GHz@0.80V",
                                           batch_max=1)),
                                       headroom_slots=1)))
        assert rep.policy == "failover(static+1)"
        healthy = _run(serve, _trace(serve, [0.0]), make_faults(""))
        assert rep.latency_ms["p50"] > healthy.latency_ms["p50"]

    def test_zero_headroom_is_passthrough(self):
        trace = _trace(serve, [0.0, 1.0])
        plan = SlotPlan(n_slots=4, point="1.00GHz@0.80V", batch_max=1)
        rep = _run(serve, trace, make_faults(""), policy=FailoverPolicy(
            StaticPolicy(plan=plan), headroom_slots=0))
        assert rep.latencies_ms == _run(serve, trace,
                                        make_faults("")).latencies_ms

    def test_negative_headroom_rejected(self):
        with pytest.raises(ValueError, match="headroom_slots"):
            FailoverPolicy(StaticPolicy(plan=SlotPlan(1, "x")),
                           headroom_slots=-1)


class TestNoFaultPin:
    @pytest.mark.parametrize("spec", [
        "", "throttle@5-20:isl0>0.6GHz,hbm@10-15:0.5x"])
    def test_trace_without_failstops_is_the_healthy_loop(self, spec):
        """No fail-stop event: the report is the healthy loop's, field for
        field (window-only traces degrade the evaluate path)."""
        def run(p, faults):
            trace = p.make_trace(
                "poisson:rate=900,kernel=softmax,elems=65536",
                duration_ms=100.0, seed=4)
            return _run(p, trace, faults)
        base = _both(lambda p: run(p, None))
        faulted = _both(lambda p: run(p, p.make_faults(spec,
                                                       duration_ms=100.0)))
        assert faulted == base
        assert base.n_failed == base.n_lost == base.failovers == 0

    def test_failover_loop_is_deterministic(self):
        def run(p):
            return _run(p, p.make_trace(
                "poisson:rate=1200,kernel=softmax,elems=65536",
                duration_ms=100.0, seed=9),
                p.make_faults("corefail@20:c0.0,corefail@40:c0.5",
                              duration_ms=100.0),
                retry=p.RetryPolicy(max_attempts=3, timeout_ms=25.0))
        a = _both(run)
        assert run(serve) == a and a.failovers == 2


class TestKillAccounting:
    def test_kill_then_retry_completes(self):
        rep = _both(lambda p: _run(
            p, _trace(p, [0.0] * 4), p.make_faults(FAULT, duration_ms=20.0),
            retry=p.RetryPolicy(max_attempts=3, base_delay_ms=0.5)))
        assert (rep.n_failed, rep.n_retried, rep.n_lost) == (1, 1, 0)
        assert rep.n_completed == 4 and rep.completed_frac == 1.0
        assert rep.failovers == 1
        assert rep.max_latency_ms > 1.5 * min(rep.latencies_ms)

    def test_naive_mode_loses_killed_requests(self):
        rep = _both(lambda p: _run(
            p, _trace(p, [0.0] * 4), p.make_faults(FAULT, duration_ms=20.0)))
        assert rep.n_failed == 1 and rep.n_retried == 0
        assert rep.n_lost == 1 and rep.n_completed == 3
        assert rep.completed_frac == pytest.approx(0.75)
        assert not rep.slo_met and rep.slo_violations >= 1

    def test_attempt_budget_exhausts(self):
        rep = _both(lambda p: _run(
            p, _trace(p, [0.0] * 4), p.make_faults(FAULT, duration_ms=20.0),
            retry=p.RetryPolicy(max_attempts=1)))
        assert rep.n_retried == 0 and rep.n_lost == 1

    def test_deadline_abandons_late_retries(self):
        rep = _both(lambda p: _run(
            p, _trace(p, [0.0] * 4), p.make_faults(FAULT, duration_ms=20.0),
            retry=p.RetryPolicy(max_attempts=3, timeout_ms=0.8,
                                base_delay_ms=0.5)))
        assert rep.n_retried == 0 and rep.n_lost == 1

    @pytest.mark.parametrize("admission", ["tail_drop", "slo_aware"])
    def test_requests_conserved(self, admission):
        def run(p):
            return p.simulate(
                p.make_trace("poisson:rate=1500,kernel=softmax,elems=65536",
                             duration_ms=150.0, seed=11),
                p.StaticPolicy(plan=p.SlotPlan(n_slots=4,
                                               point="1.00GHz@0.80V",
                                               batch_max=1)),
                slo=p.SloSpec(latency_ms=25.0), pricer=p.ServicePricer(),
                epoch_ms=5.0, queue_cap=64, admission=admission,
                faults=p.make_faults("corefail@30:c0.0,corefail@30:c0.1,"
                                     "clusterfail@90:c0", duration_ms=150.0),
                retry=p.RetryPolicy(max_attempts=2, timeout_ms=40.0))
        rep = _both(run)
        assert (rep.n_completed + rep.n_dropped + rep.n_shed + rep.n_lost
                == rep.n_requests)

    def test_mttf_faults_on_a_system_pricer(self):
        """Sampled deaths on a 2-cluster part, retried, under mpc."""
        from repro.cluster.topology import SNITCH_CLUSTER as J
        from repro.system import SystemConfig as JSystem

        from repro_torch.cluster.topology import SNITCH_CLUSTER
        from repro_torch.system import SystemConfig
        systems = {serve: SystemConfig.homogeneous(2, SNITCH_CLUSTER),
                   jserve: JSystem.homogeneous(2, J)}

        def run(p):
            return p.simulate(
                p.make_trace("poisson:rate=2500,kernel=softmax,elems=65536",
                             duration_ms=100.0, seed=6),
                p.ModelPredictivePolicy(), slo=p.SloSpec(latency_ms=25.0),
                pricer=p.ServicePricer(system=systems[p]), epoch_ms=10.0,
                faults=p.make_faults("mttf=20ms", duration_ms=100.0, seed=5,
                                     n_clusters=2, cores_per_cluster=8),
                retry=p.RetryPolicy())
        rep = _both(run)
        assert rep.failovers > 0

    def test_format_lines_carries_fault_line(self):
        rep = _run(serve, _trace(serve, [0.0] * 4),
                   make_faults(FAULT, duration_ms=20.0))
        txt = "\n".join(rep.format_lines())
        assert "batches_killed=1" in txt and "lost=1" in txt
        healthy = _run(serve, _trace(serve, [0.0] * 4), make_faults(""))
        assert "batches_killed" not in "\n".join(healthy.format_lines())


class TestAllDead:
    def test_cluster_death_drains_the_queue(self):
        rep = _both(lambda p: _run(
            p, _trace(p, [0.0, 1.0, 6.0, 7.0]),
            p.make_faults("clusterfail@3:c0", duration_ms=20.0),
            retry=p.RetryPolicy(max_attempts=3)))
        assert rep.n_completed + rep.n_lost == 4
        assert rep.n_lost >= 2 and not rep.slo_met

    def test_mid_batch_cluster_death(self):
        rep = _both(lambda p: _run(
            p, _trace(p, [0.0] * 8),
            p.make_faults("clusterfail@0.5:c0", duration_ms=20.0),
            retry=p.RetryPolicy(max_attempts=3)))
        assert rep.n_completed == 0 and rep.n_lost == 8
        assert math.isnan(rep.max_latency_ms)


class TestObs:
    def test_fault_lane_and_metrics(self):
        """The fault lane's events and every metric but the spans'
        wall-clock histograms, as the JAX package records them."""
        got = []
        for p, o in ((serve, obs), (jserve, jobs)):
            with o.session(trace=True, metrics=True) as s:
                _run(p, _trace(p, [0.0] * 4),
                     p.make_faults(FAULT, duration_ms=20.0),
                     retry=p.RetryPolicy(max_attempts=3))
            lane = [e for e in s.recorder.events
                    if e[0] == resilience.FAULT_LANE]
            metrics = {k: v for k, v in s.metrics().items()
                       if not k.startswith("span.")}
            got.append((lane, metrics))
        assert got[0] == got[1]
        lane, m = got[0]
        assert [e[3] for e in lane] == ["corefail:c0.0"]
        assert m["resilience.faults.injected"]["value"] == 1
        assert m["resilience.batches_killed"]["value"] == 1
        assert m["resilience.requests_retried"]["value"] == 1
        assert m["resilience.static.completed_frac"]["value"] == 1.0


class TestResilienceBenchScenario:
    """The JAX package's ``benchmarks/resilience_bench.py`` scenario:
    naive and failover reports equal the JAX package's; failover
    completes at least naive's fraction with fewer SLO violations; a
    replay is ``==``; an empty ``FaultTrace`` leaves the serve_bench
    static table ``==``."""

    @pytest.fixture(scope="class")
    def reports(self):
        out = []
        for p in PKGS:
            trace = p.make_trace(BENCH["spec"],
                                 duration_ms=BENCH["duration_ms"],
                                 seed=BENCH["seed"])
            kw = dict(slo=p.SloSpec(latency_ms=BENCH["slo_ms"]),
                      pricer=p.ServicePricer(), epoch_ms=BENCH["epoch_ms"],
                      queue_cap=BENCH["queue_cap"],
                      faults=p.make_faults(BENCH["faults"],
                                           duration_ms=BENCH["duration_ms"]))
            plan = p.SlotPlan(n_slots=4, point="1.00GHz@0.80V", batch_max=4)
            retry = p.RetryPolicy(**BENCH["retry"])
            reps = {"naive": p.simulate(trace, p.StaticPolicy(plan=plan),
                                        **kw)}
            for key in ("failover", "rerun"):
                reps[key] = p.simulate(trace, p.FailoverPolicy(
                    p.StaticPolicy(plan=plan), headroom_slots=1),
                    retry=retry, **kw)
            out.append(reps)
        return out

    @pytest.mark.parametrize("policy", ["naive", "failover"])
    def test_reports_equal_the_jax_package(self, reports, policy):
        assert_sims_equal(reports[0][policy], reports[1][policy])

    def test_acceptance(self, reports):
        naive, failover = reports[0]["naive"], reports[0]["failover"]
        assert failover.completed_frac >= naive.completed_frac
        assert failover.slo_violations < naive.slo_violations
        assert reports[0]["rerun"] == failover
        assert (failover.n_completed, failover.n_requests,
                failover.slo_violations) == (288, 288, 0)
        assert (naive.n_completed, naive.slo_violations) == (283, 13)

    def test_empty_trace_leaves_the_serve_bench_table(self):
        from test_torch_serve_sim import (BENCH_EPOCH_MS, BENCH_QUEUE_CAP,
                                          BENCH_SEED, BENCH_SLO_MS,
                                          BENCH_SMOKE_MS, BENCH_SPEC)
        trace = make_trace(BENCH_SPEC, duration_ms=BENCH_SMOKE_MS,
                           seed=BENCH_SEED)
        kw = dict(slo=SloSpec(latency_ms=BENCH_SLO_MS),
                  pricer=ServicePricer(), epoch_ms=BENCH_EPOCH_MS,
                  queue_cap=BENCH_QUEUE_CAP)
        healthy = simulate(trace, StaticPolicy(rate_rps=trace.mean_rate_rps),
                           **kw)
        empty = simulate(trace, StaticPolicy(rate_rps=trace.mean_rate_rps),
                         faults=make_faults("", duration_ms=BENCH_SMOKE_MS),
                         **kw)
        assert empty == healthy and empty.latency_ms == healthy.latency_ms


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
class TestProperties:
    @given(arrivals=st.lists(st.floats(min_value=0.0, max_value=15.0),
                             min_size=1, max_size=12),
           t_fault=st.integers(min_value=0, max_value=150).map(
               lambda n: n / 10),
           core=st.integers(min_value=0, max_value=7),
           attempts=st.integers(min_value=1, max_value=3))
    @settings(max_examples=15, deadline=None)
    def test_accounting_equals_the_jax_package(self, arrivals, t_fault, core,
                                               attempts):
        """Drawn arrivals and one core death: the two packages' reports
        are ``==`` and every request is completed, dropped, shed or
        lost."""
        arrivals = sorted(arrivals)
        spec = f"corefail@{t_fault!r}:c0.{core}"
        rep = _both(lambda p: _run(
            p, _trace(p, arrivals), p.make_faults(spec, duration_ms=20.0),
            retry=p.RetryPolicy(max_attempts=attempts)))
        assert (rep.n_completed + rep.n_dropped + rep.n_shed + rep.n_lost
                == rep.n_requests)

    @given(arrivals=st.lists(st.floats(min_value=0.0, max_value=15.0),
                             min_size=1, max_size=12))
    @settings(max_examples=15, deadline=None)
    def test_empty_trace_identity(self, arrivals):
        arrivals = sorted(arrivals)
        healthy = _run(serve, _trace(serve, arrivals), None)
        assert _run(serve, _trace(serve, arrivals),
                    make_faults("", duration_ms=20.0)) == healthy
        assert plain(healthy) == plain(_run(jserve, _trace(jserve, arrivals),
                                            None))
