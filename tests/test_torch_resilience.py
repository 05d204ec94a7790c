"""The port's fault model (``repro_torch.resilience.faults`` and
``degrade``) and ``api.evaluate(faults=...)`` against the JAX package's,
on the CPU.

Every ``FaultTrace`` (the MTTF sampler's events included), ``FaultState``
and degraded ``Report`` equals the JAX package's with ``==`` on the same
spec, seed and shape; the port keeps the model's own invariants: the
empty trace is the identity on ``evaluate`` bit for bit, dead cores,
throttle windows and a narrowed HBM port make the model slower, never
faster, and an all-dead state raises ``AllCoresDeadError``.  Mirrors
``tests/test_resilience.py`` and ``tests/test_resilience_properties.py``
(whose ``blocks`` property draws from 0, where ``evaluate`` raises in
both packages; the port's draws blocks >= 1)."""

import math

import pytest

pytest.importorskip("torch")

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st  # noqa: E402,E501
from test_torch_core import plain  # noqa: E402
from test_torch_evaluate import assert_reports_equal  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import resilience as jres  # noqa: E402
from repro.perf import memo as jmemo  # noqa: E402
from repro_torch import api, resilience  # noqa: E402
from repro_torch.cluster.scheduler import STRATEGIES, assign  # noqa: E402
from repro_torch.cluster.topology import SNITCH_CLUSTER  # noqa: E402
from repro_torch.perf import memo  # noqa: E402
from repro_torch.resilience import (FaultState, FaultTrace,  # noqa: E402
                                    degrade_cluster, degrade_system_hbm,
                                    make_faults, masked_speeds,
                                    resolve_state, throttled_point)
from repro_torch.system import SystemConfig  # noqa: E402

#: Specs covering every event kind plus the stochastic MTTF sampler.
SPECS = (
    "",
    "corefail@2:c0.3",
    "clusterfail@5:c1,throttle@5-20:isl0>0.6GHz",
    "hbm@10-15:0.5x,corefail@1:c0.0",
    "mttf=40ms",
    "mttf=15ms,throttle@2-8:isl0>0.8GHz,hbm@4:0.75x",
    "corefail@2:c0.3,throttle@5-20:isl1>0.6GHz,hbm@10-15:0.5x,"
    "clusterfail@4:c1",
)
STATE_SPEC = ("corefail@2:c0.3,clusterfail@5:c1,throttle@5-20:isl0>0.6GHz,"
              "throttle@10-15:isl0>0.5GHz,hbm@10-15:0.5x,hbm@12-14:0.8x")


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))


@pytest.fixture(autouse=True, scope="module")
def _memos():
    """Both packages' memos cleared once for the module: a ``Report`` is
    a pure function of its inputs, whatever the memos hold (what they
    change is how many events a trace records, which no test here
    reads)."""
    memo.clear_all()
    jmemo.clear_all()


def _both_faults(spec, **kw):
    mine, theirs = make_faults(spec, **kw), jres.make_faults(spec, **kw)
    assert plain(mine) == plain(theirs)
    return mine, theirs


class TestGrammar:
    def test_full_spec_parses(self):
        tr, _ = _both_faults(SPECS[-1], duration_ms=50.0, n_clusters=2,
                             cores_per_cluster=8)
        assert [ev.kind for ev in tr.events] == \
            ["corefail", "clusterfail", "throttle", "hbm"]
        assert (tr.events[0].cluster, tr.events[0].core) == (0, 3)
        assert tr.events[0].t_end_ms == math.inf
        assert (tr.events[2].t_ms, tr.events[2].t_end_ms,
                tr.events[2].value) == (5.0, 20.0, 0.6)

    @pytest.mark.parametrize("spec", SPECS)
    @pytest.mark.parametrize("seed", [0, 7, 123])
    def test_trace_equals_the_jax_package(self, spec, seed):
        """Same (spec, seed, shape) -> the JAX package's event tuple, the
        MTTF sampler's PCG64 draws included; a replay is ``==``."""
        kw = dict(duration_ms=100.0, seed=seed, n_clusters=2,
                  cores_per_cluster=4)
        a, _ = _both_faults(spec, **kw)
        assert make_faults(spec, **kw) == a
        if "mttf" in spec:
            assert make_faults(spec, **dict(kw, seed=seed + 1)).events \
                != a.events

    def test_empty_spec_is_eventless(self):
        assert make_faults("").events == ()
        assert FaultTrace.empty().state_at(99.0).is_trivial
        assert plain(FaultTrace.empty()) == plain(jres.FaultTrace.empty())

    def test_mttf_spec(self):
        tr, _ = _both_faults("mttf=5ms", duration_ms=200.0, seed=3,
                             n_clusters=2, cores_per_cluster=4)
        assert tr.events and all(ev.kind == "corefail" for ev in tr.events)
        victims = [(ev.cluster, ev.core) for ev in tr.events]
        assert len(victims) == len(set(victims))

    @pytest.mark.parametrize("bad,msg", [
        ("meteor@2:c0.1", "unknown fault kind"),
        ("corefail@2", "missing ':<what>'"),
        ("corefail@2:c0", "corefail needs"),
        ("clusterfail@2:c0.1", "clusterfail takes"),
        ("corefail@x:c0.1", "bad time token"),
        ("throttle@9-5:isl0>0.6GHz", "bad time window"),
        ("throttle@5-9:isl0>0GHz", "throttle cap must be positive"),
        ("throttle@5-9:c0>0.6GHz", "bad throttle target"),
        ("hbm@5-9:1.5x", "HBM multiplier must be in"),
        ("hbm@5-9:half", "bad HBM multiplier"),
        ("mttf=40s", "expected 'mttf=<ms>ms'"),
        ("mttf=40ms,mttf=2ms", "duplicate mttf"),
        ("corefail@2:c9.0", "references cluster 9"),
        ("corefail@2:c0.99", "references core 99"),
    ])
    def test_rejections_name_the_problem(self, bad, msg):
        msgs = []
        for pkg in (resilience, jres):
            with pytest.raises(ValueError, match=msg) as exc:
                pkg.make_faults(bad, n_clusters=2, cores_per_cluster=8)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]

    def test_shape_validation(self):
        for pkg in (resilience, jres):
            with pytest.raises(ValueError, match="duration_ms"):
                pkg.make_faults("", duration_ms=0.0)
            with pytest.raises(ValueError, match="n_clusters"):
                pkg.make_faults("", n_clusters=0)


class TestStateAt:
    TRACES = _both_faults(STATE_SPEC, duration_ms=50.0, n_clusters=2,
                          cores_per_cluster=8)

    @pytest.mark.parametrize("t", [0.0, 1.0, 2.0, 5.0, 6.0, 10.0, 12.0,
                                   13.0, 14.0, 15.0, 20.0, 30.0])
    def test_state_equals_the_jax_package(self, t):
        mine, theirs = self.TRACES
        assert plain(mine.state_at(t)) == plain(theirs.state_at(t))
        assert mine.state_at(t).is_trivial == theirs.state_at(t).is_trivial
        assert plain(mine.failstop_events()) == \
            plain(theirs.failstop_events())

    def test_accumulation_windows_and_caps(self):
        tr = self.TRACES[0]
        assert tr.state_at(1.0).is_trivial
        s = tr.state_at(6.0)
        assert s.dead_cores == ((0, 3),) and s.dead_clusters == (1,)
        assert s.core_dead(0, 3) and s.core_dead(1, 0)
        assert not s.core_dead(0, 0)
        late = tr.state_at(30.0)
        assert late.freq_caps == () and late.hbm_scale == 1.0
        assert tr.state_at(12.0).freq_cap(0) == 0.5
        assert tr.state_at(6.0).freq_cap(1) is None
        assert tr.state_at(13.0).hbm_scale == \
            self.TRACES[1].state_at(13.0).hbm_scale

    def test_cluster_death_absorbs_core_deaths(self):
        tr, _ = _both_faults("corefail@1:c0.2,clusterfail@3:c0",
                             n_clusters=1, cores_per_cluster=8)
        s = tr.state_at(4.0)
        assert s.dead_clusters == (0,) and s.dead_cores == ()

    def test_resolve_state(self):
        assert resolve_state(None).is_trivial
        st_ = FaultState(dead_cores=((0, 1),))
        assert resolve_state(st_) is st_
        mine, theirs = self.TRACES
        assert plain(resolve_state(mine, 6.0)) == \
            plain(jres.resolve_state(theirs, 6.0))
        with pytest.raises(TypeError, match="FaultTrace or FaultState"):
            resolve_state("corefail@2:c0.3")


class TestDegrade:
    def test_throttled_point(self):
        ladder, nominal = SNITCH_CLUSTER.operating_points, \
            SNITCH_CLUSTER.nominal
        from repro.cluster.topology import SNITCH_CLUSTER as J
        for cap in (0.1, 0.5, 0.6, 0.8, 1.0, 1.45, 2.0):
            for i, p in enumerate(ladder):
                assert plain(throttled_point(p, cap, ladder)) == plain(
                    jres.throttled_point(J.operating_points[i], cap,
                                         J.operating_points))
        assert throttled_point(nominal, 0.8, ladder).freq_ghz == 0.75
        assert throttled_point(nominal, 1.0, ladder) is nominal

    @pytest.mark.parametrize("kw", [
        dict(dead_cores=((0, 2),), freq_caps=((0, 0.6),)),
        dict(dead_clusters=(0,)),
        dict(freq_caps=((1, 0.6),)),
        dict()])
    def test_degrade_cluster_and_masked_speeds(self, kw):
        from repro.cluster.topology import SNITCH_CLUSTER as J
        pts = (SNITCH_CLUSTER.nominal,) * 4
        mine = degrade_cluster(SNITCH_CLUSTER, pts, FaultState(**kw))
        theirs = jres.degrade_cluster(J, (J.nominal,) * 4,
                                      jres.FaultState(**kw))
        assert plain(mine) == plain(theirs)
        assert masked_speeds(*mine) == jres.masked_speeds(*theirs)
        if kw.get("dead_cores"):
            assert mine[1] == (True, True, False, True)
            assert masked_speeds(*mine) == (0.5, 0.5, 0.0, 0.5)

    def test_degrade_system_hbm(self):
        from repro.cluster.topology import SNITCH_CLUSTER as J
        from repro.system import SystemConfig as JSystem
        for hbm in (100.0, None):
            mine = SystemConfig.homogeneous(2, SNITCH_CLUSTER,
                                            hbm_bytes_per_cycle=hbm)
            theirs = JSystem.homogeneous(2, J, hbm_bytes_per_cycle=hbm)
            for scale in (0.5, 0.25, 1.0):
                a = degrade_system_hbm(mine, FaultState(hbm_scale=scale))
                b = jres.degrade_system_hbm(
                    theirs, jres.FaultState(hbm_scale=scale))
                assert plain(a) == plain(b)
            assert degrade_system_hbm(mine, FaultState()) is mine

    def test_require_survivors(self):
        from repro.resilience.degrade import require_survivors as jreq

        from repro_torch.resilience.degrade import require_survivors
        require_survivors((0.0, 0.5), "x")
        msgs = []
        for fn, err in ((require_survivors, resilience.AllCoresDeadError),
                        (jreq, jres.AllCoresDeadError)):
            with pytest.raises(err, match="no core alive") as exc:
                fn((0.0, 0.0), "the test target")
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


class TestZeroSpeedAssign:
    @pytest.mark.parametrize("strategy", STRATEGIES)
    def test_dead_cores_get_zero_blocks(self, strategy):
        from repro.cluster.scheduler import assign as jassign
        wa = assign(24, (1.0, 0.0, 1.0, 0.0), strategy)
        assert plain(wa) == plain(jassign(24, (1.0, 0.0, 1.0, 0.0),
                                          strategy))
        assert wa.blocks_per_core[1] == wa.blocks_per_core[3] == 0
        inner = assign(24, (1.0, 1.0), strategy)
        assert (wa.blocks_per_core[0], wa.blocks_per_core[2]) == \
            tuple(inner.blocks_per_core)


def _targets(pkg):
    return {
        "default": pkg.Target(),
        "islands": pkg.Target.heterogeneous(
            "2@1.45GHz@1.00V,6@0.50GHz@0.60V"),
        "system": pkg.Target.system("2x8c,hbm=256"),
        "system4": pkg.Target.system(4, hbm_bytes_per_cycle=128.0),
    }


TARGETS, JTARGETS = _targets(api), _targets(japi)
#: FaultState keyword sets: a core death, a throttle window, an HBM
#: window, a dead cluster, and all three of the first at once.
STATES = {
    "core": dict(dead_cores=((0, 0), (0, 1), (0, 2))),
    "throttle": dict(freq_caps=((0, 0.6),)),
    "hbm": dict(hbm_scale=0.25),
    "cluster1": dict(dead_clusters=(1,)),
    "mixed": dict(dead_cores=((0, 3),), freq_caps=((0, 0.75),),
                  hbm_scale=0.5),
}


class TestEvaluateFaults:
    @pytest.mark.parametrize("state", list(STATES))
    @pytest.mark.parametrize("target", list(TARGETS))
    def test_degraded_report_equals_the_jax_package(self, target, state):
        kw = STATES[state]
        if state == "cluster1" and not target.startswith("system"):
            kw = dict(dead_cores=((0, 5),))
        # Monte Carlo's block timings are the slowest to simulate from
        # cleared memos: one case takes it.
        names = ("expf", "logf")
        if (target, state) == ("system4", "cluster1"):
            names = ("expf", "montecarlo")
        for name in names:
            mine = api.evaluate(name, TARGETS[target], total_blocks=48,
                                faults=FaultState(**kw))
            theirs = japi.evaluate(name, JTARGETS[target], total_blocks=48,
                                   faults=jres.FaultState(**kw))
            assert_reports_equal(mine, theirs)

    @pytest.mark.parametrize("target", ["default", "system"])
    def test_each_fault_is_slower_than_fault_free(self, target):
        """A core death, a throttle window and an HBM window, each from a
        sampled trace: slower than fault-free (the HBM window only where
        the system's port binds: never faster)."""
        t = TARGETS[target]
        n_clusters = 2 if target == "system" else 1
        base = api.evaluate("expf", t, total_blocks=64)
        spec = ("corefail@1:c0.0,corefail@1:c0.1,throttle@5-9:isl0>0.6GHz,"
                "hbm@20-30:0.1x")
        tr, jtr = _both_faults(spec, duration_ms=50.0, n_clusters=n_clusters,
                               cores_per_cluster=8)
        for at, slower in ((2.0, True), (6.0, True), (25.0, False)):
            mine = api.evaluate("expf", t, total_blocks=64, faults=tr,
                                fault_t_ms=at)
            theirs = japi.evaluate("expf", JTARGETS[target],
                                   total_blocks=64, faults=jtr,
                                   fault_t_ms=at)
            assert_reports_equal(mine, theirs)
            assert mine.cycles_copift >= base.cycles_copift
            if slower:
                assert mine.time_us > base.time_us

    @pytest.mark.parametrize("target", list(TARGETS))
    def test_empty_trace_is_bit_for_bit(self, target):
        t = TARGETS[target]
        base = api.evaluate("expf", t, total_blocks=16)
        for faults in (FaultTrace.empty(), make_faults(""), FaultState()):
            assert api.evaluate("expf", t, total_blocks=16,
                                faults=faults) == base
        assert_reports_equal(base, japi.evaluate(
            "expf", JTARGETS[target], total_blocks=16,
            faults=jres.FaultTrace.empty()))

    def test_trace_sampling_at_time(self):
        tr, _ = _both_faults("corefail@10:c0.0,corefail@10:c0.1",
                             duration_ms=50.0)
        t = TARGETS["default"]
        before = api.evaluate("expf", t, total_blocks=32, faults=tr,
                              fault_t_ms=5.0)
        after = api.evaluate("expf", t, total_blocks=32, faults=tr,
                             fault_t_ms=15.0)
        assert before == api.evaluate("expf", t, total_blocks=32)
        assert after.cycles_copift > before.cycles_copift

    def test_all_dead_raises(self):
        for a, pkg in ((api, resilience), (japi, jres)):
            with pytest.raises(pkg.AllCoresDeadError, match="no core alive"):
                a.evaluate("expf", a.Target(),
                           faults=pkg.FaultState(dead_clusters=(0,)))
            with pytest.raises(pkg.AllCoresDeadError):
                a.evaluate("montecarlo", a.Target.system(2),
                           faults=pkg.FaultState(dead_clusters=(0, 1)))
        assert api.AllCoresDeadError is resilience.AllCoresDeadError

    def test_bad_faults_type(self):
        with pytest.raises(TypeError, match="FaultTrace or FaultState"):
            api.evaluate("expf", api.Target(), faults="corefail@2:c0.3")


class TestExamples:
    @pytest.mark.parametrize("strategy", STRATEGIES)
    @pytest.mark.parametrize("kernel", ["expf", "montecarlo"])
    def test_empty_trace_is_identity(self, kernel, strategy):
        target = api.Target(strategy=strategy)
        base = api.evaluate(kernel, target, total_blocks=13)
        assert api.evaluate(kernel, target, total_blocks=13,
                            faults=FaultTrace.empty()) == base
        assert api.evaluate(kernel, target, total_blocks=13,
                            faults=make_faults("")) == base


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
class TestProperties:
    @given(seed=st.integers(min_value=0, max_value=2**31 - 1),
           mttf=st.floats(min_value=5.0, max_value=200.0),
           n_clusters=st.integers(min_value=1, max_value=4),
           cores=st.integers(min_value=1, max_value=8))
    @settings(max_examples=25, deadline=None)
    def test_mttf_trace_equals_the_jax_package(self, seed, mttf, n_clusters,
                                               cores):
        kw = dict(duration_ms=200.0, n_clusters=n_clusters,
                  cores_per_cluster=cores, seed=seed)
        a, _ = _both_faults(f"mttf={mttf}ms", **kw)
        assert all(e.cluster < n_clusters and e.core < cores
                   for e in a.events)
        times = [e.t_ms for e in a.events]
        assert times == sorted(times)

    @given(strategy=st.sampled_from(STRATEGIES),
           blocks=st.integers(min_value=1, max_value=64))
    @settings(max_examples=20, deadline=None)
    def test_empty_trace_identity_over_blocks(self, strategy, blocks):
        target = api.Target(strategy=strategy)
        base = api.evaluate("expf", target, total_blocks=blocks)
        assert api.evaluate("expf", target, total_blocks=blocks,
                            faults=FaultTrace.empty()) == base
