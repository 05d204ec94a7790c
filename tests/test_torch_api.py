"""The port's facade (``repro_torch.api``) against the JAX package's
(``repro.api``), on the CPU: every name and alias resolves to a spec with
the same metadata, ``.run`` and ``.ref`` of every runnable spec give the JAX
package's results on the same numpy inputs, the registry keeps its
overwrite rules and ``config`` its scoping.  The CUDA side of ``.run``
(``config(impl="cuda")``) runs in ``chip_smoke.py``'s facade phase."""

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import analytics as janalytics  # noqa: E402
from repro.core.kernels_isa import KERNELS as JAX_ISA_KERNELS  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import registry  # noqa: E402
from repro_torch.core import analytics  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

_FIELDS = ("name", "isa_name", "workload", "aliases", "default_problem",
           "doc", "simulatable", "tunable")


def _jax_names():
    return [n for s in japi.specs() for n in (s.name, *s.aliases)]


class TestRegistryMetadata:
    @pytest.mark.parametrize("name", _jax_names())
    def test_every_name_and_alias_resolves_to_an_equal_spec(self, name):
        mine, theirs = api.kernel(name), japi.kernel(name)
        for f in _FIELDS:
            assert getattr(mine, f) == getattr(theirs, f), f
        assert (mine.op is None) == (theirs.op is None)
        assert (mine.reference is None) == (theirs.reference is None)
        for ref in (mine.op, mine.reference):
            assert ref is None or ref.startswith("repro_torch.kernels.")

    def test_kernels_and_isa_registry_equal(self):
        assert api.kernels() == japi.kernels()
        assert [s.name for s in api.specs()] == list(japi.kernels())
        assert registry.ISA_KERNELS == list(JAX_ISA_KERNELS)

    @pytest.mark.parametrize("name", list(JAX_ISA_KERNELS))
    def test_max_block_and_table_i_equal(self, name):
        mine, theirs = api.kernel(name), japi.kernel(name)
        assert mine.max_block == theirs.max_block
        assert (dataclasses.asdict(mine.table_i)
                == dataclasses.asdict(theirs.table_i))
        for prop in ("thread_imbalance", "s_prime", "i_prime",
                     "s_double_prime"):
            assert getattr(mine.table_i, prop) == getattr(theirs.table_i, prop)

    def test_analytics_copy_equals_jax(self):
        assert analytics.TABLE_I_PRINTED == janalytics.TABLE_I_PRINTED
        assert analytics.PAPER_HEADLINE == janalytics.PAPER_HEADLINE
        assert analytics.table_rows() == janalytics.table_rows()
        xs = [1.1, 2.0, 1.47]
        assert analytics.geomean(xs) == janalytics.geomean(xs)

    def test_unknown_kernel_names_known_set(self):
        with pytest.raises(KeyError, match="montecarlo"):
            api.kernel("nope")
        with pytest.raises(ValueError, match="ISA registry"):
            api.KernelSpec("x", isa_name="nope")


def _run_args(name):
    """(args, port kwargs, JAX kwargs) of one ``.run`` call, from numpy."""
    rng = np.random.default_rng(len(name))
    if name == "expf":
        x = rng.uniform(-90, 90, (3, 700)).astype(np.float32)
        return (x,), {}, {}
    if name == "logf":
        return (rng.uniform(1e-3, 1e3, (2, 555)).astype(np.float32),), {}, {}
    if name == "softmax":
        return (rng.normal(0, 4, (6, 161)).astype(np.float32),), {}, {}
    if name == "prng":
        return (2 ** 32 - 1, (3, 1000), "lcg"), dict(device="cpu"), {}
    return (42, 1 << 18), dict(device="cpu"), {}


def _to_port(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


def _to_jax(a):
    return jnp.asarray(a) if isinstance(a, np.ndarray) else a


_RUNNABLE = [s.name for s in japi.specs() if s.op is not None]
_EXACT = ("prng", "poly_xoshiro128p", "pi_xoshiro128p")


class TestRun:
    @pytest.mark.parametrize("jax_impl", ["reference", "pallas"])
    @pytest.mark.parametrize("name", _RUNNABLE)
    def test_run_matches_jax(self, name, jax_impl):
        args, kw, jkw = _run_args(name)
        with api.config(impl="reference"):
            got = api.kernel(name).run(*map(_to_port, args), **kw)
        with japi.config(impl=jax_impl):
            want = np.asarray(japi.kernel(name).run(*map(_to_jax, args),
                                                    **jkw))
        assert tuple(got.shape) == want.shape
        if name in _EXACT:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            rtol, atol = {"expf": (2e-6, 1e-30), "logf": (1e-5, 1e-6),
                          "softmax": (3e-5, 3e-7)}[name]
            np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                       atol=atol)

    @pytest.mark.parametrize(
        "name", [s.name for s in japi.specs() if s.reference is not None])
    def test_ref_matches_jax(self, name):
        args, kw, jkw = _run_args(name)
        if name == "prng":                  # the oracle's order: kind first
            args = (args[2], args[0], args[1])
        got = api.kernel(name).ref(*map(_to_port, args), **kw)
        want = np.asarray(japi.kernel(name).ref(*map(_to_jax, args), **jkw))
        if name in _EXACT:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6)

    def test_quickstart_section_1(self):
        """``examples/quickstart.py`` section 1, the port on the CPU."""
        x = np.linspace(-5, 5, 2048, dtype=np.float32)
        with japi.config(impl="pallas"):
            want = np.asarray(japi.kernel("expf").run(jnp.asarray(x)))
        got = api.kernel("expf").run(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6)
        assert np.abs(got / np.exp(x.astype(np.float64)) - 1).max() < 2e-6
        pi = api.kernel("montecarlo").run(seed=42, n_samples=1 << 18,
                                          device="cpu")
        assert float(pi) == float(japi.kernel("montecarlo").run(
            seed=42, n_samples=1 << 18))

    def test_impl_cuda_on_the_cpu_raises(self):
        with api.config(impl="cuda"):
            with pytest.raises(ValueError, match="impl='cuda'"):
                api.kernel("logf").run(torch.ones(4))
            with pytest.raises(ValueError, match="impl='cuda'"):
                api.kernel("montecarlo").run(seed=1, n_samples=1 << 13,
                                             device="cpu")

    def test_model_only_specs_do_not_run(self):
        with pytest.raises(ValueError, match="no runnable entry point"):
            api.kernel("poly_lcg").run(1, 2)
        with pytest.raises(ValueError, match="no reference"):
            api.kernel("pi_xoshiro128p").ref(1, 2)


class TestNotPortedYet:
    def test_analytic_model_raises_naming_the_roadmap_item(self):
        """The ISA views and, since the tuner is ported, the tuner's
        workloads answer as the JAX package's do: traces, schedules and
        workloads equal as data, and ``max_block`` of the tuner-only
        specs."""
        from test_torch_core import plain
        for spec in api.specs():
            theirs = japi.kernel(spec.name)
            if spec.simulatable:
                assert plain(spec.baseline_trace()) == \
                    plain(theirs.baseline_trace())
            if spec.simulatable or spec.tunable:
                assert plain(spec.schedule()) == plain(theirs.schedule())
                assert spec.max_block == theirs.max_block
            if spec.tunable:
                w, jw = spec.get_workload(), theirs.get_workload()
                assert (w.name, w.max_block, w.n_buffers_serial,
                        w.bytes_per_elem, w.uses_issr) == \
                    (jw.name, jw.max_block, jw.n_buffers_serial,
                     jw.bytes_per_elem, jw.uses_issr)

    def test_failures_the_jax_package_raises_too(self):
        with pytest.raises(KeyError, match="no tunable workload"):
            api.kernel("poly_lcg").get_workload()
        with pytest.raises(KeyError, match="no tunable workload"):
            api.KernelSpec("bare").max_block
        with pytest.raises(ValueError, match="no ISA view"):
            api.kernel("prng").baseline_trace()
        with pytest.raises(ValueError, match="no ISA view"):
            api.kernel("softmax").table_i

    def test_tuned_defaults(self):
        """``config(tuned_defaults=True)`` scopes the tuned tilings as the
        JAX package's does: on inside the block, restored after it."""
        from repro.kernels import ops as jops
        assert ops.tuned_defaults_enabled() == jops.tuned_defaults_enabled()
        before = ops.tuned_defaults_enabled()
        with api.config(tuned_defaults=True), \
                japi.config(tuned_defaults=True):
            assert ops.tuned_defaults_enabled() is True
            assert jops.tuned_defaults_enabled() is True
            with api.config(tuned_defaults=False):
                assert ops.tuned_defaults_enabled() is False
            assert ops.tuned_defaults_enabled() is True
        assert ops.tuned_defaults_enabled() == before
        with api.config(impl="reference", tuned_defaults=False):
            assert ops.current_impl() == "reference"
            assert ops.tuned_defaults_enabled() is False


@pytest.fixture
def scratch_registry():
    """Restore the registry after a test that registers kernels."""
    snap_reg, snap_ali = dict(registry._REGISTRY), dict(registry._ALIASES)
    yield
    registry._REGISTRY.clear()
    registry._REGISTRY.update(snap_reg)
    registry._ALIASES.clear()
    registry._ALIASES.update(snap_ali)


class TestKernelRegistry:
    def test_register_kernel_hook_and_overwrite_guard(self, scratch_registry):
        spec = api.KernelSpec("user_exp", isa_name="expf",
                              op="repro_torch.kernels.ops:exp",
                              aliases=("my_exp",))
        api.register_kernel(spec)
        assert api.kernel("my_exp") is spec
        x = torch.linspace(-3, 3, 9)
        torch.testing.assert_close(api.kernel("my_exp").run(x), ops.exp(x))
        with pytest.raises(ValueError, match="overwrite=True"):
            api.register_kernel(api.KernelSpec("user_exp"))
        api.register_kernel(api.KernelSpec("user_exp", isa_name="logf",
                                           aliases=("my_exp",)),
                            overwrite=True)
        assert api.kernel("user_exp").isa_name == "logf"
        assert api.kernel("my_exp").isa_name == "logf"

    def test_overwrite_reclaims_alias_names(self, scratch_registry):
        """Registering over an existing alias purges the stale mapping, or
        kernel() would resolve past the new spec."""
        spec = api.KernelSpec("montecarlo", isa_name="pi_lcg")
        api.register_kernel(spec, overwrite=True)
        assert api.kernel("montecarlo") is spec
        assert api.kernel("pi_xoshiro128p").aliases == ("montecarlo",)

    def test_overwrite_drops_the_replaced_specs_aliases(self,
                                                        scratch_registry):
        api.register_kernel(api.KernelSpec("k1", aliases=("a1",)))
        api.register_kernel(api.KernelSpec("k1", aliases=("a2",)),
                            overwrite=True)
        assert api.kernel("a2").name == "k1"
        with pytest.raises(KeyError):
            api.kernel("a1")


class TestConfig:
    def test_scoped_and_restored(self):
        assert ops.current_impl() == "auto"
        with api.config(impl="reference"):
            assert ops.current_impl() == "reference"
            with api.config(impl="cuda"):
                assert ops.current_impl() == "cuda"
            assert ops.current_impl() == "reference"
        assert ops.current_impl() == "auto"

    def test_restores_on_error(self):
        with pytest.raises(RuntimeError):
            with api.config(impl="reference"):
                raise RuntimeError("boom")
        assert ops.current_impl() == "auto"

    def test_rejects_unknown_impl(self):
        with pytest.raises(ValueError, match="unknown impl"):
            with api.config(impl="pallas"):
                pass  # pragma: no cover

    def test_concurrent_threads_do_not_race(self):
        """An override in one thread is invisible to another running at the
        same time."""
        inside = threading.Event()
        release = threading.Event()
        seen = {}

        def override_thread():
            with api.config(impl="reference"):
                inside.set()
                release.wait(5)

        def observer_thread():
            inside.wait(5)
            seen["impl"] = ops.current_impl()
            release.set()

        t1 = threading.Thread(target=override_thread)
        t2 = threading.Thread(target=observer_thread)
        t1.start()
        t2.start()
        t1.join(5)
        t2.join(5)
        assert not t1.is_alive() and not t2.is_alive()
        assert seen["impl"] == "auto"
