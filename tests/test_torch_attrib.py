"""The port's differential cycle attribution (``repro_torch.obs.attrib``)
against the JAX package's (``repro.obs.attrib``), on the CPU.

Every ``Attribution`` must be exact (its ``Fraction`` step deltas sum bit
for bit to the ``Report`` cycle delta, every check green) and equal the
JAX package's on the same inputs with ``==``: kind, labels, endpoints,
every step's exact delta and detail, every check.  Mirrors
``tests/test_attrib.py``; the traced evaluations of the slow Monte-Carlo
kernels run on 2-core targets to keep the file's time down."""

from dataclasses import replace
from fractions import Fraction

import pytest

pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import tune as jtune  # noqa: E402
from repro.perf import memo as jmemo  # noqa: E402
from repro_torch import api, obs, tune  # noqa: E402
from repro_torch.cluster.scheduler import STRATEGIES  # noqa: E402
from repro_torch.obs.attrib import Attribution  # noqa: E402
from repro_torch.perf import memo  # noqa: E402

ALL_WORKLOADS = ("expf", "logf", "montecarlo", "prng", "softmax")
HET_SPEC = "2@1.45GHz@1.00V,6@0.50GHz@0.60V"
HET2_SPEC = "1@1.45GHz@1.00V,1@0.50GHz@0.60V"
#: Each package's (api, obs, tune).
PKGS = ((api, obs, tune), (japi, jobs, jtune))


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    memo.clear_all()
    jmemo.clear_all()


def _workload(t, name):
    try:
        return t.get_workload(name)
    except KeyError:
        a = api if t is tune else japi
        return a.kernel(name).get_workload()


def _tuned(t, name):
    """A plan that differs from the default without a tuner search: one
    block rung down."""
    w = _workload(t, name)
    space = t.default_space(w)
    d = space.default
    blocks = space.knob("block").values
    return w, d, replace(d, block=blocks[-2] if len(blocks) > 1 else d.block)


def _assert_exact(att):
    assert att.exact, [c for c in att.checks if not c["ok"]]
    total = sum((s.delta for s in att.steps), Fraction(0))
    assert total == Fraction(att.cycles_b) - Fraction(att.cycles_a)


def _assert_same(att, jatt):
    """Exact, and equal to the JAX package's attribution."""
    _assert_exact(att)
    assert type(att.cycles_a) is type(jatt.cycles_a)
    assert [(s.name, s.delta, s.detail) for s in att.steps] == \
        [(s.name, s.delta, s.detail) for s in jatt.steps]
    assert att.checks == jatt.checks
    assert att.to_dict() == jatt.to_dict()


def _pair(fn):
    """``fn(api, obs, tune)`` for the port, then for the JAX package."""
    return tuple(fn(*pkg) for pkg in PKGS)


class TestEvaluateAttribution:
    @pytest.mark.parametrize("which", ["copift", "base"])
    @pytest.mark.parametrize("name,cores", [("expf", None), ("logf", None),
                                            ("pi_xoshiro128p", 2)])
    def test_plan_vs_plan_homogeneous(self, name, cores, which):
        def run(a, o, t):
            _, d, tu = _tuned(t, name)
            target = None if cores is None else a.Target.homogeneous(cores)
            return o.attribute_evaluate(name, target, target, plan_a=d,
                                        plan_b=tu, which=which)
        att, jatt = _pair(run)
        _assert_same(att, jatt)
        assert att.kind == "evaluate" and att.which == which
        field = f"cycles_{which}"
        assert att.cycles_a == getattr(att.report_a, field)
        assert att.cycles_b == getattr(att.report_b, field)

    @pytest.mark.parametrize("strategy", STRATEGIES)
    @pytest.mark.parametrize("name", ["expf", "logf"])
    def test_plan_vs_plan_het_all_strategies(self, name, strategy):
        def run(a, o, t):
            target = a.Target.heterogeneous(HET2_SPEC, strategy=strategy)
            _, d, tu = _tuned(t, name)
            return o.attribute_evaluate(name, target, target, plan_a=d,
                                        plan_b=tu, total_blocks=5)
        _assert_same(*_pair(run))

    @pytest.mark.parametrize("name", ["expf", "logf", "poly_lcg", "pi_lcg",
                                      "poly_xoshiro128p", "pi_xoshiro128p"])
    def test_every_simulatable_kernel_target_vs_target(self, name):
        """Both decompositions from one pair of traces per package."""
        def run(a, o, t):
            with o.session() as sa:
                rep_a = a.evaluate(name, a.Target.homogeneous(n_cores=2))
            with o.session() as sb:
                rep_b = a.evaluate(name, a.Target.heterogeneous(HET2_SPEC))
            return [o.attribute(sa.recorder, sb.recorder, rep_a, rep_b,
                                which=which) for which in ("copift", "base")]
        for att, jatt in zip(*_pair(run)):
            _assert_same(att, jatt)

    def test_target_vs_target(self):
        def run(a, o, t):
            return [o.attribute_evaluate(
                "expf", a.Target.homogeneous(n_cores=8),
                a.Target.heterogeneous(HET_SPEC), which=which,
                label_a="hom8", label_b="big.LITTLE")
                for which in ("copift", "base")]
        for att, jatt in zip(*_pair(run)):
            _assert_same(att, jatt)
            assert (att.label_a, att.label_b) == ("hom8", "big.LITTLE")
            assert any(s.name == "schedule" for s in att.steps)

    def test_serialized_vs_pipelined_plan(self):
        def run(a, o, t):
            d = t.default_space(t.get_workload("logf")).default
            two = a.Target.homogeneous(2)
            return o.attribute_evaluate("logf", two, two, plan_a=replace(
                d, pipelined=False), plan_b=d)
        att, jatt = _pair(run)
        _assert_same(att, jatt)
        assert att.cycles_b <= att.cycles_a
        overlap = [s for s in att.steps if s.name == "dual_issue_overlap"]
        assert overlap and overlap[0].delta <= 0

    def test_identity_attribution_is_all_zeros(self):
        def run(a, o, t):
            d = t.default_space(t.get_workload("expf")).default
            two = a.Target.homogeneous(2)
            return o.attribute_evaluate("expf", two, two, plan_a=d,
                                        plan_b=d)
        att, jatt = _pair(run)
        _assert_same(att, jatt)
        assert att.delta == 0 and all(s.delta == 0 for s in att.steps)

    def test_island_plans_rejected(self):
        d = tune.default_space(tune.get_workload("expf")).default
        with pytest.raises(ValueError, match="island"):
            obs.attribute_evaluate("expf", plan_a=d, plan_b=replace(
                d, islands=(("1.00GHz", 4),)))

    def test_attribute_needs_an_evaluate_summary(self):
        with pytest.raises(ValueError, match="no matching 'evaluate'"):
            obs.attribute(obs.TraceRecorder(), obs.TraceRecorder())
        with pytest.raises(ValueError, match="which must be"):
            obs.attribute(obs.TraceRecorder(), obs.TraceRecorder(),
                          which="nope")


class TestPlanAttribution:
    @pytest.mark.parametrize("name", ALL_WORKLOADS)
    def test_all_workloads_exact(self, name):
        def run(a, o, t):
            w, d, tu = _tuned(t, name)
            return o.attribute_plans(w, d, tu), d, tu
        (att, d, tu), (jatt, _, _) = _pair(run)
        _assert_same(att, jatt)
        assert att.kind == "plan"
        assert (att.meta["block_a"], att.meta["block_b"]) == \
            (d.block, tu.block)
        assert att.meta == jatt.meta

    def test_accepts_workload_and_kernel_names(self):
        def run(a, o, t):
            _, d, tu = _tuned(t, "softmax")
            _, md, mtu = _tuned(t, "montecarlo")
            return (o.attribute_plans("softmax", d, tu),
                    o.attribute_plans("pi_xoshiro128p", md, mtu))
        for att, jatt in zip(*_pair(run)):
            _assert_same(att, jatt)

    @settings(max_examples=15, deadline=None)
    @given(name=st.sampled_from(ALL_WORKLOADS),
           block_idx_a=st.integers(0, 7), block_idx_b=st.integers(0, 7),
           fuse_a=st.booleans(), fuse_b=st.booleans(),
           pipe_a=st.booleans(), pipe_b=st.booleans())
    def test_property_random_plan_pairs_exact(self, name, block_idx_a,
                                              block_idx_b, fuse_a, fuse_b,
                                              pipe_a, pipe_b):
        def run(a, o, t):
            w = t.get_workload(name)
            space = t.default_space(w)
            blocks = space.knob("block").values
            d = space.default
            pa = replace(d, block=blocks[block_idx_a % len(blocks)],
                         fuse_fp=fuse_a, pipelined=pipe_a)
            pb = replace(d, block=blocks[block_idx_b % len(blocks)],
                         fuse_fp=fuse_b, pipelined=pipe_b)
            return o.attribute_plans(w, pa, pb)
        _assert_same(*_pair(run))


class TestAttributionObject:
    @pytest.fixture(scope="class")
    def att(self):
        _, d, t = _tuned(tune, "expf")
        return obs.attribute_evaluate("expf", api.Target.homogeneous(2),
                                      api.Target.homogeneous(2),
                                      plan_a=d, plan_b=t)

    def test_to_dict_json_roundtrip_preserves_exact(self, att):
        import json
        doc = json.loads(json.dumps(att.to_dict()))
        assert doc["exact"] is True
        back = Attribution.from_dict(doc)
        _assert_exact(back)
        assert back.cycles_a == att.cycles_a
        assert [(s.name, s.delta) for s in back.steps] == \
            [(s.name, s.delta) for s in att.steps]

    def test_render_and_render_dict_agree(self, att):
        text = att.render()
        assert "exact=True" in text and att.kernel in text
        assert Attribution.render_dict(att.to_dict()) == text
        jatt = jobs.attrib.Attribution.from_dict(att.to_dict())
        assert jatt.render() == text

    def test_speedup_and_delta(self, att):
        assert att.delta == att.cycles_b - att.cycles_a
        assert att.speedup == pytest.approx(att.cycles_a / att.cycles_b)


class TestTunerAttribute:
    @pytest.mark.parametrize("name,kind,delta", [("expf", "evaluate", -2),
                                                 ("softmax", "plan", -4)])
    def test_reference_values(self, name, kind, delta):
        """``Tuner(Target.homogeneous(power_cap_mw=250)).attribute``: the
        JAX package's waterfall, exact, with deltas of -2 and -4
        cycles."""
        att, jatt = _pair(lambda a, o, t: a.Tuner(
            a.Target.homogeneous(power_cap_mw=250)).attribute(name))
        _assert_same(att, jatt)
        assert att.kind == kind and att.delta == delta
        assert att.meta == jatt.meta
        assert "predicted_speedup" in att.meta

    def test_simulatable_kernel_goes_through_reports(self):
        att = api.Tuner().attribute("expf")
        _assert_exact(att)
        assert att.kind == "evaluate"
        assert (att.label_a, att.label_b) == ("default", "tuned")

    def test_accepts_precomputed_result(self):
        tuner = api.Tuner()
        res = tuner.plan("softmax")
        with obs.session(trace=False, metrics=True) as sess:
            att = tuner.attribute("softmax", result=res)
        _assert_exact(att)
        assert att.meta["plan_b"] == res.best.to_dict()
        assert "span.tuner.attribute.seconds" in sess.metrics()
