"""The port's tuner facade and the tuned tilings, on the CPU, against the
JAX package: ``api.Tuner`` (plan, block, the operating point with per-island
blocks) for every tunable spec, ``evaluate(plan=...)``,
``make_plan(tune=True)``, the tuner's ``KernelSpec`` views,
``perf.evaluate_batch``, ``kernels.ops._tuned_block_rows``,
``ServeEngine(autotune=True)`` on the olmo-1b smoke model and
``launch.train --autotune``; the system point, ``attribute`` and
``ServeEngine(system=...)``; and the kernels' tilings: ``exp_plan``, ``log_plan``,
``uniform_plan`` and ``softmax_plan`` at ``block_rows=None`` give the launch
from before tilings, and the rule ``threads = clamp(256 * block_rows /
default_rows, 32, 1024)`` holds, through the wrappers with the launch
recorded.  Both packages' tune caches live under ``tmp_path``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import perf as jperf  # noqa: E402
from repro import tune as jtune  # noqa: E402
from repro.configs import load_config as jax_load_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch import api, perf, tune  # noqa: E402
from repro_torch.configs import load_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import _build, expf, logf, ops, prng  # noqa: E402
from repro_torch.kernels import softmax  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

TUNABLE = [s.name for s in api.specs() if s.tunable]
#: ``_tuned_block_rows`` at the default target: the JAX package's answer.
TUNED_ROWS = {"expf": 64, "logf": 32, "prng": 32, "softmax": 8}
DEFAULT_ROWS = {"expf": 64, "logf": 64, "prng": 64, "softmax": 8}


@pytest.fixture(autouse=True)
def _caches(tmp_path, monkeypatch):
    """Each package's default tune cache under ``tmp_path``, and the tuned
    tiling memos dropped before and after."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "torch.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "jax.json"))
    ops._tuned_block_rows.cache_clear()
    jops._tuned_block_rows.cache_clear()
    yield
    ops._tuned_block_rows.cache_clear()
    jops._tuned_block_rows.cache_clear()


def _result(res) -> dict:
    return dict(res.to_dict(), from_cache=res.from_cache)


class TestTuner:
    @pytest.mark.parametrize("name", TUNABLE)
    @pytest.mark.parametrize("cap", [None, 250.0])
    def test_plan_block_operating_point(self, name, cap):
        tuner = api.Tuner(api.Target.homogeneous(power_cap_mw=cap))
        jtuner = japi.Tuner(japi.Target.homogeneous(power_cap_mw=cap))
        assert repr(tuner) == repr(jtuner)
        for run in (lambda t: t.plan(name),
                    lambda t: t.plan(name, cluster=True, latency_ns=2e4),
                    lambda t: t.block(name),
                    lambda t: t.block(name, objective="energy"),
                    lambda t: t.operating_point(name),
                    lambda t: t.operating_point(name, heterogeneous=True,
                                                per_island_blocks=True),
                    lambda t: t.operating_point(name, n_cores=4,
                                                latency_ns=5e4)):
            assert _result(run(tuner)) == _result(run(jtuner))
        # The second ask of a plan is a cache hit in both packages.
        assert _result(tuner.plan(name)) == _result(jtuner.plan(name))
        assert tuner.plan(name).from_cache

    def test_refined_island_blocks_never_worse(self):
        tuner = api.Tuner(api.Target.homogeneous(power_cap_mw=250.0),
                          cache=False)
        for name in ("softmax", "prng", "expf"):
            shared = tuner.operating_point(name, heterogeneous=True)
            refined = tuner.operating_point(name, heterogeneous=True,
                                            per_island_blocks=True)
            assert refined.best_cost.energy_pj <= shared.best_cost.energy_pj

    def test_resolves_workloads_and_raw_names(self):
        tuner = api.Tuner(cache=False)
        w = tune.get_workload("montecarlo")
        assert api.Tuner._workload("montecarlo") is w
        assert api.Tuner._workload(api.kernel("pi_xoshiro128p")) is w
        assert api.Tuner._workload(w) is w
        assert tuner.block(w).best == tuner.block("montecarlo").best
        with pytest.raises(KeyError, match="no tunable workload"):
            tuner.plan("poly_lcg")

    def test_default_tuner_is_shared(self):
        assert api.default_tuner() is api.default_tuner()
        assert api.default_tuner().cache is tune.default_cache()
        assert isinstance(api.default_tuner(), api.Tuner)

    def test_later_items_raise_naming_them(self):
        """The branches that raised until the manycore model and the
        attribution were ported now give the JAX package's results: a
        system target without ``n_clusters`` takes the cluster search, with
        ``n_clusters`` the system point; ``attribute`` the exact
        waterfall."""
        from test_torch_evaluate import plain
        system = api.Tuner(api.Target.system("2x8c,hbm=256"))
        jsystem = japi.Tuner(japi.Target.system("2x8c,hbm=256"))
        assert _result(system.operating_point("expf")) == \
            _result(jsystem.operating_point("expf"))
        for tuner, jtuner in ((system, jsystem), (api.Tuner(), japi.Tuner())):
            mine = tuner.operating_point("expf", n_clusters=2)
            theirs = jtuner.operating_point("expf", n_clusters=2)
            assert type(mine).__name__ == "SystemPoint"
            assert plain(mine) == plain(theirs)
        att, jatt = api.Tuner().attribute("expf"), japi.Tuner().attribute("expf")
        assert att.exact and jatt.exact
        assert att.to_dict() == jatt.to_dict()
        assert [(s.name, s.delta) for s in att.steps] == \
            [(s.name, s.delta) for s in jatt.steps]


class TestAnalyticConsumers:
    @pytest.mark.parametrize("name", ["expf", "logf", "montecarlo"])
    def test_evaluate_with_the_tuned_plan(self, name):
        from test_torch_evaluate import assert_reports_equal
        tuner, jtuner = api.Tuner(cache=False), japi.Tuner(cache=False)
        for target, jtarget in ((api.Target(), japi.Target()),
                                (api.Target.homogeneous(8),
                                 japi.Target.homogeneous(8))):
            for res, jres in ((tuner.plan(name), jtuner.plan(name)),
                              (tuner.block(name), jtuner.block(name))):
                assert_reports_equal(
                    api.evaluate(name, target, plan=res.best),
                    japi.evaluate(name, jtarget, plan=jres.best))

    def test_evaluate_rejects_island_plans(self):
        for pkg in (api, japi):
            cand = (tune if pkg is api else jtune).Candidate(
                block=64, islands=("1.00GHz@0.80V", "0.50GHz@0.60V"),
                island_blocks=(32, 64))
            with pytest.raises(ValueError, match="DVFS-island knobs"):
                pkg.evaluate("expf", pkg.Target(), plan=cand)

    def test_traced_serial_plan_stamps_sum(self):
        from repro.obs import record as jrecord
        from repro_torch.obs import record
        cand = dict(block=128, pipelined=False, movers=2)
        rec, jrec = record.TraceRecorder(), jrecord.TraceRecorder()
        with record.recording(rec):
            api.evaluate("logf", api.Target.homogeneous(2),
                         plan=tune.Candidate(**cand))
        with jrecord.recording(jrec):
            japi.evaluate("logf", japi.Target.homogeneous(2),
                          plan=jtune.Candidate(**cand))
        assert rec.summaries == jrec.summaries
        assert {c["combine"] for c in rec.summaries[0]["cores"]} == {"sum"}

    def test_kernel_spec_views(self):
        from test_torch_core import plain
        for name in TUNABLE:
            spec, jspec = api.kernel(name), japi.kernel(name)
            assert spec.get_workload() is tune.get_workload(spec.workload)
            assert spec.max_block == jspec.max_block
            assert plain(spec.schedule()) == plain(jspec.schedule())

    def test_perf_evaluate_batch(self):
        assert perf.evaluate_batch is tune.cost.evaluate_batch
        assert "evaluate_batch" in perf.__all__
        w = tune.get_workload("prng")
        cands = list(tune.default_space(w, cluster=True).candidates())
        got = perf.evaluate_batch("prng", cands, power_cap_mw=250.0)
        want = jperf.evaluate_batch(
            "prng", [jtune.Candidate(**c.to_dict()) for c in cands],
            power_cap_mw=250.0)
        assert [vars(e) for e in got] == [vars(e) for e in want]
        with pytest.raises(AttributeError):
            perf.nothing_here  # noqa: B018

    def test_tuned_block_rows(self):
        got = {k: ops._tuned_block_rows(k, d) for k, d in DEFAULT_ROWS.items()}
        want = {k: jops._tuned_block_rows(k, d)
                for k, d in DEFAULT_ROWS.items()}
        assert got == want == TUNED_ROWS

    def test_resolve_rows(self):
        assert ops._resolve_rows("prng", None, 64) == 64
        assert ops._resolve_rows("prng", 5, 64) == 5
        with ops.overrides(tuned_defaults=True):
            assert ops._resolve_rows("prng", None, 64) == 32
            assert ops._resolve_rows("prng", 5, 64) == 5
            # No tunable workload: the JAX package's KeyError catch keeps
            # the default.
            assert ops._resolve_rows("poly", None, 64) == 64
        assert ops._resolve_rows("prng", None, 64) == 64

    def test_set_tuned_defaults_returns_the_previous_value(self):
        before = ops.tuned_defaults_enabled()
        try:
            assert ops.set_tuned_defaults(True) == before
            assert ops.tuned_defaults_enabled() is True
            assert ops.set_tuned_defaults(False) is True
            with ops.overrides(tuned_defaults=True):
                assert ops.tuned_defaults_enabled() is True
            assert ops.tuned_defaults_enabled() is False
        finally:
            ops.set_tuned_defaults(before)


# ---------------------------------------------------------------------------
# ServeEngine(autotune=True) and launch.train --autotune
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmo():
    jcfg = jax_load_config("olmo-1b", "smoke")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    cfg = load_config("olmo-1b", "smoke")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _engine(**kw):
    kw.setdefault("batch", 2)
    kw.setdefault("max_len", 32)
    return ServeEngine(object(), None, device="cpu", **kw)


class TestEngineAutotune:
    @pytest.mark.parametrize("kw", [dict(), dict(temperature=1.0, seed=1)],
                             ids=["greedy", "sampled"])
    def test_tokens_and_plan_match(self, olmo, kw):
        jcfg, jparams, cfg, params = olmo
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int32)
        untuned = ServeEngine(cfg, params, max_len=32, batch=2,
                              device="cpu", **kw).generate(prompts, 10)
        with ServeEngine(cfg, params, max_len=32, batch=2, device="cpu",
                         autotune=True, power_cap_mw=250.0, **kw) as eng:
            got = eng.generate(prompts, 10)
            plan = eng.operating_plan
        with JaxServeEngine(jcfg, jparams, max_len=32, batch=2,
                            autotune=True, power_cap_mw=250.0, **kw) as jeng:
            want = jeng.generate(prompts, 10)
            jplan = jeng.operating_plan
        np.testing.assert_array_equal(got.tokens, untuned.tokens)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert sorted(plan) == sorted(jplan) == ["prng", "softmax"]
        assert {k: v.to_dict() for k, v in plan.items()} == \
            {k: v.to_dict() for k, v in jplan.items()}

    def test_gauges_and_span(self):
        from repro_torch.obs import metrics
        metrics.set_enabled(True)
        try:
            with _engine(autotune=True, power_cap_mw=250.0) as eng:
                pass
            for name in ("softmax", "prng"):
                c = eng.operating_plan[name].best_cost
                assert metrics.REGISTRY.value(
                    f"serve.plan.{name}.power_mw") == c.power_mw
                assert metrics.REGISTRY.value(
                    f"serve.plan.{name}.time_ns") == c.time_ns
            assert metrics.REGISTRY.value("serve.autotune.wall_s") > 0
        finally:
            metrics.set_enabled(False)

    def test_autotune_restores_process_default_on_close(self):
        prev = ops.tuned_defaults_enabled()
        try:
            eng = _engine(autotune=True)
            assert ops.tuned_defaults_enabled() is True
            eng.close()
            assert ops.tuned_defaults_enabled() == prev
            eng.close()   # idempotent
            assert ops.tuned_defaults_enabled() == prev
        finally:
            ops.set_tuned_defaults(prev)

    def test_context_manager_scopes_the_flip(self):
        prev = ops.tuned_defaults_enabled()
        try:
            with _engine(autotune=True) as eng:
                assert eng.operating_plan is not None
                assert ops.tuned_defaults_enabled() is True
            assert ops.tuned_defaults_enabled() == prev
        finally:
            ops.set_tuned_defaults(prev)

    def test_persist_escape_hatch_survives_close(self):
        prev = ops.tuned_defaults_enabled()
        try:
            eng = _engine(autotune=True, persist_tuned_defaults=True)
            eng.close()
            assert ops.tuned_defaults_enabled() is True
        finally:
            ops.set_tuned_defaults(prev)

    def test_close_without_autotune_is_a_noop(self):
        prev = ops.tuned_defaults_enabled()
        eng = _engine()
        eng.close()
        assert ops.tuned_defaults_enabled() == prev
        assert eng.operating_plan is None

    def test_guards(self, olmo):
        """The power-cap guard of both packages; ``system=`` (which raised
        until the manycore model was ported) prices the JAX package's
        ``system_plan`` on the smoke model, and only under autotune."""
        from test_torch_evaluate import plain
        jcfg, jparams, cfg, params = olmo
        with pytest.raises(ValueError, match="power_cap_mw=250.0 only"):
            _engine(power_cap_mw=250.0)
        with pytest.raises(ValueError, match="power_cap_mw=250.0 only"):
            JaxServeEngine(object(), None, power_cap_mw=250.0)
        with ServeEngine(cfg, params, max_len=32, batch=2, device="cpu",
                         autotune=True, power_cap_mw=1000.0,
                         system=api.parse_system("2x8c")) as eng:
            plan = eng.system_plan
        with JaxServeEngine(jcfg, jparams, max_len=32, batch=2,
                            autotune=True, power_cap_mw=1000.0,
                            system=japi.parse_system("2x8c")) as jeng:
            jplan = jeng.system_plan
        assert sorted(plan) == sorted(jplan) == ["prng", "softmax"]
        assert plain(plan) == plain(jplan)
        static = _engine(system=api.parse_system("2x8c"))
        assert static.system_plan is None and static.system.n_clusters == 2
        assert ops.tuned_defaults_enabled() is False


def test_launch_train_autotune_losses_equal(capsys):
    from repro_torch.launch import train as launch_train
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
            "--log-every", "1"]
    plain = launch_train.main(argv)
    before = ops.tuned_defaults_enabled()
    try:
        tuned = launch_train.main(argv + ["--autotune"])
    finally:
        ops.set_tuned_defaults(before)
    out = capsys.readouterr().out
    assert "[tune] kernel block tilings autotuned " \
        "(repro_torch.api.default_tuner cache)" in out
    assert [h["loss"] for h in tuned] == [h["loss"] for h in plain]
    assert [h["grad_norm"] for h in tuned] == [h["grad_norm"] for h in plain]


# ---------------------------------------------------------------------------
# the kernels' tilings
# ---------------------------------------------------------------------------

ROWS = (1, 32, 64, 128, 512)


def _rule(block_rows: int, default_rows: int) -> int:
    return min(1024, max(32, 32 * round(8 * block_rows / default_rows)))


class TestTilingPlans:
    def test_block_threads_rule(self):
        for br in ROWS:
            assert _build.block_threads(br, 64) == _rule(br, 64)
        assert [_build.block_threads(br, 64) for br in ROWS] == \
            [32, 128, 256, 512, 1024]
        assert _build.block_threads(8, 8) == 256
        assert _build.block_threads(48, 64) == 192
        with pytest.raises(ValueError, match="block_rows must be >= 1"):
            _build.block_threads(0, 64)

    @pytest.mark.parametrize("plan_fn", [expf.exp_plan, logf.log_plan])
    @pytest.mark.parametrize("n", [1, 3, 4097, (1 << 24) + 3])
    def test_exp_and_log_plans(self, plan_fn, n):
        vec = plan_fn(n, 0x7000_0000, 0x7800_0000)
        sca = plan_fn(n, 0x7000_0004, 0x7800_0000)
        n4 = n // 4
        # None is the launch from before tilings.
        assert tuple(vec) == ("vector", n4, n % 4, 256,
                              max(1, -(-n4 // 512)), 512)
        assert tuple(sca) == ("scalar", 0, n, 256, min(-(-n // 256), 2112),
                              0)
        for br in ROWS:
            t = _rule(br, 64)
            assert tuple(plan_fn(n, 0x7000_0000, 0x7800_0000, br)) == (
                "vector", n4, n % 4, t, max(1, -(-n4 // (2 * t))), 2 * t)
            assert tuple(plan_fn(n, 0x7000_0004, 0x7800_0000, br)) == (
                "scalar", 0, n, t, min(-(-n // t), 2112), 0)

    @pytest.mark.parametrize("n", [1, 8196, 50304, 1 << 24])
    def test_uniform_plan(self, n):
        assert prng.uniform_plan(n) == (256, min(-(-n // 256), 2112))
        for br in ROWS:
            t = _rule(br, 64)
            assert prng.uniform_plan(n, br) == (t, min(-(-n // t), 2112))

    @pytest.mark.parametrize("rows", [1, 64, 8191, 8192])
    def test_softmax_plan(self, rows):
        plan = softmax.softmax_plan(rows, 161, torch.float32)
        assert (plan.path, plan.grid, plan.threads, plan.per_lane,
                plan.rows_per_block) == ("warp", -(-rows // 8), 256, 8, 8)
        for br, rpb in ((1, 1), (3, 3), (8, 8), (32, 32), (64, 32),
                        (128, 32), (512, 32)):
            plan = softmax.softmax_plan(rows, 161, torch.float32, br)
            assert (plan.grid, plan.threads, plan.rows_per_block) == \
                (-(-rows // rpb), 32 * rpb, rpb)
        # The cluster and sweep paths take one row a cluster or a block.
        for cols in (5120, 1 << 20):
            assert softmax.softmax_plan(rows, cols, torch.float32, 1) == \
                softmax.softmax_plan(rows, cols, torch.float32)
        with pytest.raises(ValueError, match="block_rows must be >= 1"):
            softmax.softmax_plan(rows, 161, torch.float32, 0)


@pytest.fixture
def recorder(monkeypatch):
    """The four tiled wrappers on CPU tensors, the launch recorded, fresh
    counters; ``ops`` takes the kernel route."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda stem, name, argtypes, *args:
                        calls.append((stem, name, len(argtypes), args)))
    monkeypatch.setattr(_build, "check_cuda_tensor", lambda *a: None)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    monkeypatch.setattr(ops, "_use_kernel", lambda impl, device: True)
    for fn in (expf.exp_cuda, logf.log_cuda, prng.uniform_cuda,
               softmax.softmax_cuda):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "tiling_launches", {})
    return calls


class TestTiledLaunches:
    @pytest.mark.parametrize("tuned", [False, True])
    def test_ops_pass_the_tiling(self, recorder, tuned):
        """Through ``kernels.ops``: the default tiling, or with tuned
        defaults on the tuner's (uniform at 128 threads, logf at 128, exp
        at 256, softmax at 8 rows a block), or an explicit one."""
        x = torch.ones(4096)
        with ops.overrides(tuned_defaults=tuned):
            ops.exp(x)
            ops.log(x)
            ops.uniform(3, (4096,), device="cpu")
            ops.softmax(torch.zeros(64, 161))
            ops.uniform(3, (4096,), device="cpu", block_rows=128)
        e, lg, u, s, u2 = (args for _, _, _, args in recorder)
        small = 128 if tuned else 256
        assert (e[4], lg[4], u[4], u2[4]) == (256, small, small, 512)
        assert s[4:6] == (8, 8)                # per lane, rows a block
        assert prng.uniform_cuda.tiling_launches == {small: 1, 512: 1}
        assert softmax.softmax_cuda.tiling_launches == {8: 1}
        assert expf.exp_cuda.tiling_launches == {256: 1}
        assert logf.log_cuda.tiling_launches == {small: 1}

    @pytest.mark.parametrize("br", ROWS)
    def test_wrappers_launch_the_plans_geometry(self, recorder, br):
        n = 5000
        x = torch.ones(n)
        expf.exp_cuda(x, br)
        logf.log_cuda(x, br)
        prng.uniform_cuda(1, n, "lcg", "cpu", br)
        softmax.softmax_cuda(torch.zeros(100, 33), br)
        t = _rule(br, 64)
        (_, _, _, e), (_, _, _, lg), (_, _, _, u), (_, _, _, s) = recorder
        assert e[2:5] == (n // 4, n, t)
        assert lg[2:5] == (n // 4, n, t)
        assert u[1:5] == (n, 1, prng.KINDS["lcg"], t)
        assert s[4:6] == (2, min(br, 32))
        assert all(n_args == len(args) for _, _, n_args, args in recorder)

    def test_plain_versions_ignore_the_tiling(self):
        x = torch.linspace(-5.0, 5.0, 999)
        assert torch.equal(expf.exp_plain(x, 1), expf.exp_plain(x))
        assert torch.equal(logf.log_plain(x, 512), logf.log_plain(x))
        assert torch.equal(prng.uniform_plain(7, 999, block_rows=1),
                           prng.uniform_plain(7, 999))
        s = x.reshape(27, 37)
        assert torch.equal(softmax.softmax_plain(s, 3),
                           softmax.softmax_plain(s))
        for br in ROWS:
            assert torch.equal(ops.exp(x, block_rows=br), ops.exp(x))
            assert torch.equal(ops.softmax(s, block_rows=br), ops.softmax(s))
            assert torch.equal(ops.uniform(5, (999,), device="cpu",
                                           block_rows=br),
                               ops.uniform(5, (999,), device="cpu"))
            assert torch.equal(ops.log(x.abs() + 1, block_rows=br),
                               ops.log(x.abs() + 1))
