"""The port's kernels on the CPU: each plain PyTorch version held against
the JAX package's Pallas kernel (interpret mode, as tests/test_kernels.py
runs it), on inputs made from a seed with numpy; plus the dispatch rules of
``repro_torch.kernels.ops``.  The CUDA kernels themselves run only on the
card, where ``chip_smoke.py`` holds each against its plain version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import NEG_INF  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

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


class TestDispatch:
    def test_impl_cuda_on_cpu_raises(self):
        x = torch.zeros(4)
        with pytest.raises(ValueError, match="impl='cuda'"):
            ops.exp(x, impl="cuda")
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
        from repro_torch.kernels.softmax import softmax_cuda
        with pytest.raises(ValueError, match="CUDA tensor"):
            exp_cuda(torch.zeros(3))
        with pytest.raises(ValueError, match="CUDA tensor"):
            softmax_cuda(torch.zeros(2, 3))
        assert exp_cuda.launches == 0 and softmax_cuda.launches == 0

    def test_build_names_library_by_source_hash(self):
        sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
        assert sources == ["expf", "prng", "softmax"]
        path = _build.library_path("softmax")
        assert path.parent == _build.BUILD_DIR
        assert path.name == f"softmax-{_build._digest()}.so"
        assert "-shared" in _build.NVCC_FLAGS
        assert "--use_fast_math" not in _build.NVCC_FLAGS
