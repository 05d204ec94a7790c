"""The port's kernels on the CPU: each plain PyTorch version held against
the JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py
runs it) and its oracle, on inputs made from a seed with numpy; plus the
dispatch rules of ``repro_torch.kernels.ops``.  The CUDA kernels themselves run only on the
card, where ``chip_smoke.py`` holds each against its plain version."""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import montecarlo as jmc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import NEG_INF  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import montecarlo as mc  # noqa: E402
from repro_torch.kernels.logf import log_plain  # noqa: E402

EXTREMES = np.array([-1e4, -87.5, 0.0, 88.9, 1e4], np.float32)


def _jax(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


class TestExp:
    @pytest.mark.parametrize("shape", [(8,), (3, 777), (2, 5, 129)])
    def test_matches_pallas(self, shape):
        rng = np.random.default_rng(sum(shape))
        x = rng.uniform(-100, 100, shape).astype(np.float32)
        x.reshape(-1)[:5] = EXTREMES
        want = _jax(jops.exp(jnp.asarray(x), impl="pallas"))
        got = ops.exp(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-30)

    def test_extremes_and_masked_scores(self):
        x = np.concatenate([EXTREMES, np.float32([NEG_INF, -np.inf, np.inf])])
        got = ops.exp(torch.from_numpy(x)).numpy()
        assert got[0] == 0.0 and got[2] == 1.0 and np.isinf(got[4])
        assert got[5] == 0.0 and got[6] == 0.0 and np.isinf(got[7])

    def test_ref_matches_jax_ref(self):
        x = np.random.default_rng(1).uniform(-120, 100, 4096).astype(np.float32)
        np.testing.assert_allclose(ref.exp_ref(torch.from_numpy(x)).numpy(),
                                   _jax(jref.exp_ref(jnp.asarray(x))),
                                   rtol=2e-6, atol=1e-30)

    def test_constants_are_the_jax_constants(self):
        assert ref._LOG2E == float(jref._LOG2E)
        assert ref._LN2_HI == float(jref._LN2_HI)
        assert ref._LN2_LO == float(jref._LN2_LO)
        assert ref._EXP2_POLY == tuple(float(c) for c in jref._EXP2_POLY)
        assert (ref.LCG_A, ref.LCG_C) == (int(jref.LCG_A), int(jref.LCG_C))


class TestSoftmax:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape", [(4, 128), (2, 8, 161), (3, 1000)])
    def test_matches_pallas(self, shape, dtype):
        rng = np.random.default_rng(shape[-1])
        x = rng.normal(0, 4, shape).astype(np.float32)
        x[..., shape[-1] // 2:] = NEG_INF      # masked scores
        x[0, ..., 3:] = -np.inf                # NEG_INF + NEG_INF overflows
        xj = jnp.asarray(x, getattr(jnp, dtype))
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        want = jops.softmax(xj, impl="pallas")
        got = ops.softmax(xt)
        assert got.dtype == xt.dtype and str(want.dtype) == dtype
        np.testing.assert_allclose(got.float().numpy(), _jax(want),
                                   rtol=3e-5, atol=3e-7)

    def test_rows_sum_to_one_and_non_last_axis(self):
        x = np.random.default_rng(4).normal(0, 10, (32, 50)).astype(np.float32)
        xt = torch.from_numpy(x)
        np.testing.assert_allclose(ops.softmax(xt).sum(-1).numpy(), 1.0,
                                   rtol=1e-5)
        np.testing.assert_allclose(
            ops.softmax(xt, axis=0).numpy(),
            _jax(jops.softmax(jnp.asarray(x), axis=0, impl="pallas")),
            rtol=3e-5, atol=3e-7)

    def test_ref_matches_jax_ref(self):
        x = np.random.default_rng(5).normal(0, 3, (6, 70)).astype(np.float32)
        np.testing.assert_allclose(
            ref.softmax_ref(torch.from_numpy(x)).numpy(),
            _jax(jref.softmax_ref(jnp.asarray(x))), rtol=3e-5, atol=3e-7)


class TestUniform:
    @pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 32 - 1])
    @pytest.mark.parametrize("kind", ["lcg", "xoshiro128p"])
    def test_bitexact_vs_pallas(self, kind, seed):
        n = 3000                                   # not a multiple of 1024
        want = np.asarray(jops.uniform(seed, (n,), kind=kind, impl="pallas"))
        got = ops.uniform(seed, (n,), kind=kind, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)

    def test_shape_and_range(self):
        u = ops.uniform(7, (3, 5, 77), device="cpu")
        assert u.shape == (3, 5, 77) and u.dtype == torch.float32
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0

    @pytest.mark.parametrize("bad", [dict(seed=-1), dict(seed=2 ** 32),
                                     dict(kind="philox")])
    def test_bad_arguments_raise(self, bad):
        kw = dict(seed=1, shape=(4,), device="cpu") | bad
        with pytest.raises(ValueError):
            ops.uniform(**kw)


class TestLog:
    @pytest.mark.parametrize("shape", [(16,), (2, 555), (7, 7, 7)])
    def test_matches_pallas_and_ref(self, shape):
        x = np.random.default_rng(42).uniform(1e-3, 1e3, shape).astype(
            np.float32)
        xt = torch.from_numpy(x)
        for impl in ("pallas", "reference"):
            want = _jax(jops.log(jnp.asarray(x), impl=impl))
            for got in (ops.log(xt, impl="reference"), ops.log(xt),
                        log_plain(xt)):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=1e-6)

    def test_accuracy_vs_fp64(self):
        x = np.logspace(-30, 30, 4097).astype(np.float32)
        want = np.log(x.astype(np.float64))
        xt = torch.from_numpy(x)
        for got in (ops.log(xt), log_plain(xt)):
            np.testing.assert_allclose(got.numpy().astype(np.float64), want,
                                       rtol=1e-5, atol=6e-7)

    @settings(max_examples=20, deadline=None)
    @given(st.floats(1e-20, 1e20), st.integers(1, 500))
    def test_property_scale_invariance(self, scale, n):
        x = (np.linspace(1.0, 2.0, n) * scale).astype(np.float32)
        got = ops.log(torch.from_numpy(x)).numpy().astype(np.float64)
        np.testing.assert_allclose(got, np.log(x.astype(np.float64)),
                                   rtol=1e-5, atol=6e-7)

    def test_tables_and_constants_are_the_jax_ones(self):
        for mine, theirs in ((ref.LOGF_INVC, jref.LOGF_INVC),
                             (ref.LOGF_LOGC, jref.LOGF_LOGC)):
            assert mine.shape == (16,) and mine.dtype == torch.float32
            np.testing.assert_array_equal(mine.numpy().view(np.int32),
                                          np.asarray(theirs).view(np.int32))
        assert ref._LN2 == float(jref._LN2)
        assert ref._LOGF_OFF == int(jref._LOGF_OFF)
        assert ref._LOGF_TABLE_BITS == jref._LOGF_TABLE_BITS
        assert ref._LOG1P_POLY == tuple(float(c) for c in jref._LOG1P_POLY)

    def test_outside_the_domain_as_in_jax(self):
        """The kernel path maps x <= 0 to 1, as the JAX Pallas path does;
        the reference path does not, as the JAX oracle does not."""
        x = np.float32([-3.0, -0.0, 0.0, 2.5, 1.0])
        xt = torch.from_numpy(x)
        np.testing.assert_allclose(
            log_plain(xt).numpy(),
            _jax(jops.log(jnp.asarray(x), impl="pallas")),
            rtol=1e-5, atol=1e-6)
        assert (log_plain(xt)[:3] == log_plain(xt)[4]).all()
        np.testing.assert_allclose(
            ops.log(xt, impl="reference").numpy(),
            _jax(jops.log(jnp.asarray(x), impl="reference")),
            rtol=1e-5, atol=1e-6)
        assert (ops.log(xt)[:3] != log_plain(xt)[4]).all()


SEEDS = [9, 2 ** 32 - 1]


class TestMonteCarlo:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("kind", ["lcg", "xoshiro128p"])
    @pytest.mark.parametrize("problem", ["pi", "poly"])
    def test_plain_bitexact_vs_pallas_and_blocked_ref(self, problem, kind,
                                                      seed):
        kw = dict(kind=kind, problem=problem, iters=16, n_blocks=4)
        got = mc.mc_blocked_plain(seed, **kw)
        assert got.shape == (4, 1024) and got.dtype == torch.float32
        pallas = jmc.mc_partial_sums(jnp.uint32(seed), interpret=True, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jmc.mc_blocked_ref(seed, **kw)))

    @pytest.mark.parametrize("kind", ["lcg", "xoshiro128p"])
    @pytest.mark.parametrize("problem", ["pi", "poly"])
    def test_estimates_equal_jax(self, problem, kind):
        """At 2**18 samples every sum stays below 2**24, so it is exact."""
        seed = {"pi": 11, "poly": 13}[problem]
        fn, jfn = {"pi": (ops.mc_pi, jops.mc_pi),
                   "poly": (ops.mc_poly, jops.mc_poly)}[problem]
        got = fn(seed, 1 << 18, kind=kind, device="cpu")
        want = np.asarray(jfn(seed, 1 << 18, kind=kind, impl="reference"))
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.numpy() == want
        truth = np.pi if problem == "pi" else ref.MC_POLY_INTEGRAL
        assert float(got) == pytest.approx(truth, abs=0.02)

    def test_no_sample_gives_nan_as_in_jax(self):
        for fn, jfn in ((ops.mc_pi, jops.mc_pi), (ops.mc_poly, jops.mc_poly)):
            assert np.isnan(float(jfn(1, 1000)))
            assert np.isnan(float(fn(1, 1000, device="cpu")))

    @pytest.mark.parametrize("kind", ["lcg", "xoshiro128p"])
    def test_refs_equal_jax(self, kind):
        for fn, jfn in ((ref.mc_pi_ref, jref.mc_pi_ref),
                        (ref.mc_poly_ref, jref.mc_poly_ref)):
            got = fn(kind, 2 ** 31 + 5, 1 << 15, device="cpu")
            assert got.numpy() == np.asarray(jfn(kind, 2 ** 31 + 5, 1 << 15))
        assert ref.MC_POLY_COEFFS == jref.MC_POLY_COEFFS
        assert ref.MC_POLY_INTEGRAL == jref.MC_POLY_INTEGRAL

    @pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 32 - 1])
    def test_generators_equal_jax(self, seed):
        """splitmix32, both generators' first steps and prng_uniform, bit for
        bit."""
        z = (np.arange(5000, dtype=np.uint32) * np.uint32(2654435761)
             + np.uint32(seed))
        np.testing.assert_array_equal(
            ref.splitmix32(torch.from_numpy(z.astype(np.int64))).numpy(),
            np.asarray(jref.splitmix32(jnp.asarray(z))).astype(np.int64))
        for kind in ("lcg", "xoshiro128p"):
            got = ref.prng_uniform(kind, seed, (3, 1000), device="cpu")
            want = jref.prng_uniform(kind, seed, (3, 1000))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        state = ref.xoshiro128p_init(seed, 777)
        jstate = jref.xoshiro128p_init(seed, 777)
        for _ in range(3):
            state, out = ref.xoshiro128p_next(state)
            jstate, jout = jref.xoshiro128p_next(jstate)
            np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))

    def test_partial_sums_bounded(self):
        sums = mc.mc_blocked_plain(1, kind="lcg", problem="pi", iters=8,
                                   n_blocks=2)
        assert bool((sums >= 0).all()) and bool((sums <= 8).all())

    @pytest.mark.parametrize("bad", [dict(seed=-1), dict(seed=2 ** 32),
                                     dict(kind="philox"),
                                     dict(problem="e"), dict(iters=-1),
                                     dict(n_blocks=0)])
    def test_bad_arguments_raise(self, bad):
        kw = dict(seed=1, kind="lcg", problem="pi", iters=2, n_blocks=1) | bad
        with pytest.raises(ValueError):
            mc.mc_blocked_plain(kw.pop("seed"), **kw)


class TestDispatch:
    def test_impl_cuda_on_cpu_raises(self):
        x = torch.zeros(4)
        with pytest.raises(ValueError, match="impl='cuda'"):
            ops.exp(x, impl="cuda")
        with pytest.raises(ValueError, match="impl='cuda'"):
            ops.log(x + 1, impl="cuda")
        with pytest.raises(ValueError, match="impl='cuda'"):
            ops.mc_pi(0, 1 << 13, impl="cuda", device="cpu")
        with pytest.raises(ValueError, match="impl='cuda'"):
            ops.softmax(x[None], impl="cuda")
        with pytest.raises(ValueError, match="impl='cuda'"):
            ops.uniform(0, (4,), impl="cuda", device="cpu")

    def test_unknown_impl_raises(self):
        with pytest.raises(ValueError, match="unknown impl"):
            ops.exp(torch.zeros(2), impl="pallas")
        with pytest.raises(ValueError, match="unknown impl"):
            ops.set_impl("triton")

    def test_overrides_scope_and_set_impl(self):
        assert ops.current_impl() == "auto"
        with ops.overrides(impl="reference"):
            assert ops.current_impl() == "reference"
        assert ops.current_impl() == "auto"
        prev = ops.set_impl("reference")
        try:
            assert prev == "auto" and ops.current_impl() == "reference"
        finally:
            ops.set_impl(prev)

    def test_wrappers_reject_cpu_tensors(self):
        from repro_torch.kernels.expf import exp_cuda
        from repro_torch.kernels.logf import log_cuda
        from repro_torch.kernels.softmax import softmax_cuda
        with pytest.raises(ValueError, match="CUDA tensor"):
            exp_cuda(torch.zeros(3))
        with pytest.raises(ValueError, match="CUDA tensor"):
            softmax_cuda(torch.zeros(2, 3))
        with pytest.raises(ValueError, match="CUDA tensor"):
            log_cuda(torch.ones(3))
        with pytest.raises(ValueError, match="CUDA tensor"):
            mc.mc_partial_sums_cuda(1, kind="lcg", problem="pi", iters=1,
                                    n_blocks=1, device="cpu")
        assert exp_cuda.launches == 0 and softmax_cuda.launches == 0
        assert log_cuda.launches == 0
        assert mc.mc_partial_sums_cuda.launches == 0

    def test_build_names_library_by_source_hash(self):
        sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
        assert sources == ["expf", "logf", "montecarlo", "prng", "softmax"]
        path = _build.library_path("softmax")
        assert path.parent == _build.BUILD_DIR
        assert path.name == f"softmax-{_build._digest()}.so"
        assert "-shared" in _build.NVCC_FLAGS
        assert "--use_fast_math" not in _build.NVCC_FLAGS
