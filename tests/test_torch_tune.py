"""The port's autotuner (``repro_torch.tune``) against the JAX package's
(``repro.tune``), on the CPU: workload schedules, search spaces, the cost
oracle (scalar and batched) over every candidate of each workload's default
space, the searches and the front doors at two power caps, cache keys and a
cache file's round trip, the exhaustive-argmin property on both packages,
and ``measure_candidates`` through the plain versions.  Every result equals
the JAX package's with ``==``.  Both packages' cache files live under
``tmp_path``."""

import dataclasses
import math

import pytest

pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

from repro import tune as jtune  # noqa: E402
from repro.cluster.topology import SNITCH_CLUSTER as J_CLUSTER  # noqa: E402
from repro_torch import tune  # noqa: E402
from repro_torch.cluster.topology import SNITCH_CLUSTER  # noqa: E402
from repro_torch.tune import cache as tcache  # noqa: E402
from repro_torch.tune import search  # noqa: E402

NAMES = list(tune.BUILTIN_KERNELS)
CAPS = (None, 250.0)


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    """Each package's default cache file under ``tmp_path``."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))


def plain(obj):
    """``obj`` with dataclasses of either package as field dicts, so that
    the two packages' results compare with ``==``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(v) for v in obj)
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    return obj


def _pair(name):
    return tune.get_workload(name), jtune.get_workload(name)


def _result(res) -> dict:
    """A ``TuneResult`` as its cache payload, with ``from_cache``."""
    return dict(res.to_dict(), from_cache=res.from_cache)


class TestWorkloads:
    def test_registry(self):
        assert tune.BUILTIN_KERNELS == jtune.BUILTIN_KERNELS
        with pytest.raises(KeyError, match="no tunable workload"):
            tune.get_workload("nope")

    @pytest.mark.parametrize("name", NAMES)
    def test_static_facts_and_schedule(self, name):
        w, jw = _pair(name)
        for f in ("name", "max_block", "n_buffers_serial", "bytes_per_elem",
                  "uses_issr", "default_problem"):
            assert getattr(w, f) == getattr(jw, f)
        assert plain(w.schedule()) == plain(jw.schedule())


class TestSpace:
    @pytest.mark.parametrize("name", NAMES)
    @pytest.mark.parametrize("kw", [dict(), dict(cluster=True),
                                    dict(heterogeneous=True),
                                    dict(heterogeneous=True, max_islands=3)])
    def test_default_space(self, name, kw):
        w, jw = _pair(name)
        space = tune.default_space(w, **kw)
        jspace = jtune.default_space(jw, **kw)
        assert space.size == jspace.size
        assert [(k.name, k.values) for k in space.knobs] == \
            [(k.name, k.values) for k in jspace.knobs]
        assert space.default.to_dict() == jspace.default.to_dict()
        cands = list(space.candidates())
        assert [c.to_dict() for c in cands] == \
            [c.to_dict() for c in jspace.candidates()]
        assert all(c in space for c in cands)
        assert tune.Candidate(block=3) not in space
        jdefault = jspace.default
        assert [c.to_dict() for c in space.neighbors(space.default)] == \
            [c.to_dict() for c in jspace.neighbors(jdefault)]

    def test_ladders_and_candidate_round_trip(self):
        for cap in (8, 9, 157, 273, 512, 1000):
            assert tune.block_ladder(cap) == jtune.block_ladder(cap)
        assert tune.island_ladder(SNITCH_CLUSTER, 3) == \
            jtune.island_ladder(J_CLUSTER, 3)
        c = tune.Candidate(block=64, islands=("a", "b"),
                           island_blocks=(32, 64))
        assert tune.Candidate.from_dict(c.to_dict()) == c
        assert c.sort_key() == jtune.Candidate(**c.to_dict()).sort_key()


class TestCost:
    @pytest.mark.parametrize("name", NAMES)
    @pytest.mark.parametrize("kw, stride", [(dict(), 1),
                                            (dict(cluster=True), 1),
                                            (dict(heterogeneous=True), 41)],
                             ids=["default", "cluster", "heterogeneous"])
    def test_evaluate_every_candidate(self, name, kw, stride):
        """Every candidate of the default and cluster spaces; every 41st of
        the heterogeneous one (thousands of candidates)."""
        w, jw = _pair(name)
        cands = list(tune.default_space(w, **kw).candidates())[::stride]
        jcands = [jtune.Candidate(**c.to_dict()) for c in cands]
        for cap in CAPS:
            batch = tune.cost.evaluate_batch(w, cands, power_cap_mw=cap)
            jbatch = jtune.cost.evaluate_batch(jw, jcands, power_cap_mw=cap)
            assert plain(batch) == plain(jbatch)
            one = [tune.evaluate(w, c, power_cap_mw=cap) for c in cands[::7]]
            assert plain(one) == plain(batch[::7])

    def test_objectives_and_bounds(self):
        w, jw = _pair("softmax")
        c = tune.default_space(w).default
        est = tune.evaluate(w, c)
        jest = jtune.evaluate(jw, jtune.Candidate(**c.to_dict()))
        for obj in ("cycles", "time", "energy", "edp", "energy@time<=2.5ms",
                    "energy@time<=1ns", tune.constrain_latency("edp", 5e3)):
            assert tune.parse_objective(obj) == jtune.parse_objective(obj)
            assert tune.objective_value(est, obj) == \
                jtune.objective_value(jest, obj)
            assert tune.meets_latency(est, obj) == \
                jtune.meets_latency(jest, obj)
        for bad in ("speed", "energy@t<=1ms", "energy@time<=xms",
                    "energy@time<=-1ms"):
            with pytest.raises(ValueError):
                tune.parse_objective(bad)

    def test_canonicalize_and_tuned_schedule(self):
        w, jw = _pair("expf")
        c = tune.Candidate(block=64, n_cores=4, islands=("1.00GHz@0.80V",
                                                         "0.50GHz@0.60V"),
                           island_blocks=(32, 32), strategy="lpt")
        jc = jtune.Candidate(**c.to_dict())
        assert tune.cost._canonicalize(w, c).to_dict() == \
            jtune.cost._canonicalize(jw, jc).to_dict()
        fused = tune.Candidate(block=64, fuse_fp=True, movers=1,
                               pipelined=False)
        jfused = jtune.Candidate(**fused.to_dict())
        assert plain(tune.cost.tuned_schedule(w, fused)) == \
            plain(jtune.cost.tuned_schedule(jw, jfused))
        assert plain(tune.cost._core_power(w, w.schedule(), 64)) == \
            plain(jtune.cost._core_power(jw, jw.schedule(), 64))
        for bad in (dict(block=0), dict(block=10 ** 6), dict(block=8,
                                                              n_cores=0)):
            with pytest.raises(ValueError):
                tune.evaluate(w, tune.Candidate(**bad))


class TestSearch:
    @pytest.mark.parametrize("name", NAMES)
    @pytest.mark.parametrize("cap", CAPS)
    def test_strategies(self, name, cap):
        w, jw = _pair(name)
        space = tune.default_space(w, cluster=True)
        jspace = jtune.default_space(jw, cluster=True)
        for objective in ("cycles", "energy"):
            for fn in ("exhaustive_search", "local_search",
                       "successive_halving"):
                best, seen = getattr(tune, fn)(w, space, w.default_problem,
                                               objective=objective,
                                               power_cap_mw=cap)
                jbest, jseen = getattr(jtune, fn)(
                    jw, jspace, jw.default_problem, objective=objective,
                    power_cap_mw=cap)
                assert plain(best) == plain(jbest)
                assert plain(seen) == plain(jseen)

    @pytest.mark.parametrize("name", NAMES)
    @pytest.mark.parametrize("cap", CAPS)
    def test_front_doors(self, name, cap):
        got = tune.tune(name, cluster=True, power_cap_mw=cap, cache=False)
        want = jtune.tune(name, cluster=True, power_cap_mw=cap, cache=False)
        assert _result(got) == _result(want)
        assert got.predicted_speedup == want.predicted_speedup
        assert got.predicted_energy_saving == want.predicted_energy_saving
        for obj in ("cycles", "edp"):
            assert _result(tune.select_block(name, obj, cache=False)) == \
                _result(jtune.select_block(name, obj, cache=False))
        for het in (False, True):
            got = tune.select_operating_point(name, power_cap_mw=cap,
                                              heterogeneous=het, cache=False)
            want = jtune.select_operating_point(name, power_cap_mw=cap,
                                                heterogeneous=het,
                                                cache=False)
            assert _result(got) == _result(want)

    def test_halving_then_local_on_a_large_space(self):
        w, jw = _pair("softmax")
        got = tune.tune(w, cluster=True, power_cap_mw=250.0, cache=False,
                        objective="energy@time<=50us")
        want = jtune.tune(jw, cluster=True, power_cap_mw=250.0, cache=False,
                          objective="energy@time<=50us")
        assert got.method == "halving+local"
        assert _result(got) == _result(want)

    @pytest.mark.parametrize("name", ["expf", "logf", "montecarlo"])
    def test_table_i_rule_is_the_tuned_block(self, name):
        """The JAX package's pinned invariant: with the plan knobs at their
        defaults, whole blocks (the problem a multiple of the cap), the tuned
        block is Table I's."""
        w = tune.get_workload(name)
        space = tune.default_space(w)
        for knob in ("fuse_fp", "movers", "pipelined"):
            space = space.with_values(knob, (getattr(space.default, knob),))
        res = tune.tune(w, problem=64 * w.max_block, space=space, cache=False)
        assert res.best.block == w.max_block
        assert (res.best.n_cores, res.best.point) == (1, "1.00GHz@0.80V")

    @settings(max_examples=15, deadline=None)
    @given(blocks=st.sets(st.sampled_from((16, 32, 64, 98, 157)),
                          min_size=1, max_size=3),
           fuse=st.booleans(), pipe=st.booleans(),
           objective=st.sampled_from(("cycles", "energy", "edp")))
    def test_property_tune_is_exhaustive_argmin(self, blocks, fuse, pipe,
                                                objective):
        """The JAX package's property, on both packages, with equal
        answers."""
        answers = []
        for pkg in (tune, jtune):
            w = pkg.get_workload("expf")
            space = pkg.default_space(w)
            for knob, values in (("block", tuple(sorted(blocks))),
                                 ("fuse_fp", (False, True) if fuse
                                  else (False,)),
                                 ("pipelined", (True, False) if pipe
                                  else (True,))):
                space = space.with_values(knob, values)
            best, evaluated = pkg.exhaustive_search(w, space, 4096,
                                                    objective=objective)
            got = pkg.tune(w, problem=4096, objective=objective,
                           space=space, cache=False)
            assert len(evaluated) == space.size
            assert got.best == best.candidate
            assert pkg.objective_value(got.best_cost, objective) == \
                pkg.objective_value(best.cost, objective)
            answers.append((got.best.to_dict(), plain(got.best_cost)))
        assert answers[0] == answers[1]


class TestCache:
    @pytest.mark.parametrize("name", NAMES)
    def test_keys_equal_the_jax_packages(self, name):
        w, jw = _pair(name)
        for kw in (dict(), dict(cluster=True)):
            space = tune.default_space(w, **kw)
            jspace = jtune.default_space(jw, **kw)
            for cap, obj, k in ((None, "cycles", 0), (250.0, "energy", 3)):
                assert tune.cache_key(name, 4096, SNITCH_CLUSTER, obj, cap,
                                      space, measure_top_k=k) == \
                    jtune.cache_key(name, 4096, J_CLUSTER, obj, cap, jspace,
                                    measure_top_k=k)

    def test_round_trip_and_persistence(self, tmp_path):
        path = tmp_path / "c.json"
        first = tune.tune("prng", cache=tune.TuneCache(path))
        assert not first.from_cache and len(tune.TuneCache(path)) == 1
        again = tune.tune("prng", cache=tune.TuneCache(path))
        assert again.from_cache
        assert _result(again) == dict(_result(first), from_cache=True)
        want = jtune.tune("prng", cache=jtune.TuneCache(tmp_path / "j.json"))
        assert again.to_dict() == want.to_dict()
        tune.TuneCache(path).clear()
        assert len(tune.TuneCache(path)) == 0

    def test_own_default_path(self, tmp_path, monkeypatch):
        assert tune.default_cache().path == str(tmp_path / "torch.json")
        monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
        assert tcache._default_path().endswith(
            "repro-torch-tune/cache.json")
        assert tcache._default_path() != jtune.cache._default_path()

    def test_unwritable_location_degrades_to_memory(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("")
        store = tune.TuneCache(blocker / "sub" / "c.json")
        with pytest.warns(RuntimeWarning, match="not writable"):
            res = tune.tune("softmax", cache=store)
        assert not res.from_cache
        assert tune.tune("softmax", cache=store).from_cache

    def test_cli_warm_and_clear(self, tmp_path, capsys):
        path = str(tmp_path / "cli.json")
        tcache.main(["--path", path, "--warm", "--kernel", "expf"])
        out = capsys.readouterr().out
        assert "tune.cache.warm,expf,priced" in out
        assert out.strip().endswith("1_entries")
        tcache.main(["--path", path, "--warm", "--kernel", "expf"])
        assert "tune.cache.warm,expf,hit" in capsys.readouterr().out
        tcache.main(["--path", path, "--clear"])
        assert capsys.readouterr().out.strip().endswith("0_entries")

    def test_warm_prices_every_tunable_kernel(self, tmp_path):
        """Without ``--kernel`` the JAX package's ``warm`` raises at the
        first registry kernel without a workload; the port's warms the
        tunable ones, each then a hit of ``Tuner.plan``."""
        path = tmp_path / "all.json"
        with pytest.raises(KeyError, match="poly_lcg"):
            jtune.cache.warm(path=tmp_path / "jax_all.json")
        assert tcache.warm(path=path) == {
            "expf": False, "logf": False, "pi_xoshiro128p": False,
            "prng": False, "softmax": False}
        from repro_torch import api
        tuner = api.Tuner(cache=tune.TuneCache(path))
        assert all(tuner.plan(n).from_cache for n in tune.BUILTIN_KERNELS)


class TestMeasure:
    @pytest.mark.parametrize("name", NAMES)
    def test_one_finite_time_per_candidate_on_the_cpu(self, name):
        w = tune.get_workload(name)
        cands = [dataclasses.replace(tune.default_space(w).default, block=b)
                 for b in tune.block_ladder(w.max_block)]
        times = tune.measure_candidates(w, cands, repeats=1, device="cpu")
        assert set(times) == set(cands)
        assert all(math.isfinite(t) and t > 0 for t in times.values())

    def test_runners_take_each_candidates_tiling(self, monkeypatch):
        """``block_rows`` (and Monte Carlo's ``n_blocks``) differ between
        candidates: 64 x share for exp, logf and uniform, 8 x share for
        softmax, as in the JAX package."""
        from repro_torch.kernels import ops
        seen = []
        for op in ("exp", "log", "softmax", "uniform"):
            real = getattr(ops, op)
            monkeypatch.setattr(ops, op, lambda *a, _real=real, _op=op, **kw:
                                seen.append((_op, kw["block_rows"]))
                                or _real(*a, **kw))
        real_mc = ops.mc_pi
        monkeypatch.setattr(ops, "mc_pi", lambda *a, **kw: seen.append(
            ("mc_pi", kw["n_blocks"])) or real_mc(*a, **kw))
        for name, op in (("expf", "exp"), ("logf", "log"), ("prng", "uniform"),
                         ("softmax", "softmax"), ("montecarlo", "mc_pi")):
            w = tune.get_workload(name)
            ladder = tune.block_ladder(w.max_block)
            seen.clear()
            tune.measure_candidates(w, [tune.Candidate(block=b)
                                        for b in ladder],
                                    repeats=1, device="cpu")
            unit = 64 if op in ("exp", "log", "uniform") else 8
            want = [max(1, round(unit * b / w.max_block)) for b in ladder]
            got = [v for o, v in seen if o == op]
            assert got == [v for v in want for _ in range(2)]
            assert len(set(want)) > 1

    def test_a_failing_runner_raises(self, monkeypatch):
        """No fallback: the JAX package returns what it could time; the
        port raises."""
        from repro_torch.kernels import ops

        def broken(*a, **kw):
            raise RuntimeError("softmax.copift_softmax_warp_f32: CUDA error")
        monkeypatch.setattr(ops, "softmax", broken)
        w = tune.get_workload("softmax")
        with pytest.raises(RuntimeError, match="CUDA error"):
            tune.measure_candidates(w, [tune.Candidate(block=8)],
                                    device="cpu")
        with pytest.raises(KeyError):
            search.candidate_runner(dataclasses.replace(w, name="other"),
                                    tune.Candidate(block=8), device="cpu")

    def test_measured_refinement_needs_the_card(self):
        import torch
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises((RuntimeError, AssertionError)):
            tune.tune("expf", measure_top_k=2, cache=False)
