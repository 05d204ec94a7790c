"""How the port's softmax and exp wrappers choose a kernel path, on the CPU.

``softmax_plan`` maps a shape to one of ``csrc/softmax.cu``'s three paths
(a warp per row, a thread block cluster per row, three sweeps) with its
launch parameters; ``exp_plan`` maps pointers to ``csrc/expf.cu``'s vector
or scalar kernel.  The wrappers are driven here with the launch replaced by
a recorder, since the kernels run only on the card.  A plain emulation of
the cluster path's split reduction (per-slice max and sum, combined in rank
order) is held against the JAX package's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and its oracle."""

import re

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models.attention import NEG_INF  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import expf, softmax  # noqa: E402
from repro_torch.kernels.expf import exp_phases  # noqa: E402

SMEM_PER_BLOCK = 232_448      # the H100's shared memory for one block
DTYPES = [torch.float32, torch.bfloat16]


def _slice_cols(cols: int, k: int) -> int:
    return -(-(-(-cols // k)) // 8) * 8


def _check_invariants(rows: int, cols: int, dtype) -> softmax.SoftmaxPlan:
    plan = softmax.softmax_plan(rows, cols, dtype)
    if cols <= 1024:
        assert plan.path == "warp" and plan.threads == 256
        assert plan.grid == -(-rows // 8)
        assert 32 * plan.per_lane >= cols
        assert plan.per_lane == 1 or 16 * plan.per_lane < cols
    elif cols <= softmax.CLUSTER_MAX_COLS:
        k = plan.cluster
        assert plan.path == "cluster" and k in (1, 2, 4, 8)
        assert plan.smem_bytes + softmax.SLOT_BYTES <= SMEM_PER_BLOCK
        assert plan.smem_bytes == 4 * plan.slice_cols
        assert plan.slice_cols % 8 == 0 and k * plan.slice_cols >= cols
        assert k == 8 or rows * k >= 132
        # k is the least size that fills the card and fits a slice.
        for smaller in (1, 2, 4, 8)[:(1, 2, 4, 8).index(k)]:
            assert (rows * smaller < 132
                    or _slice_cols(cols, smaller) > softmax.MAX_SLICE_COLS)
        assert plan.grid == rows * k
        assert plan.threads in (256, 512, 1024)
        assert plan.vec == (cols % (8 if dtype == torch.bfloat16 else 4) == 0)
    else:
        assert plan.path == "sweep" and plan.grid == rows
    return plan


class TestSoftmaxPlan:
    @pytest.mark.parametrize("dtype", DTYPES)
    @pytest.mark.parametrize("k", [1, 2, 4, 8])
    def test_path_edges(self, k, dtype):
        rows = -(-132 // k)              # the fewest rows that k fills
        assert softmax.softmax_plan(rows, 1024, dtype).path == "warp"
        plan = _check_invariants(rows, 1025, dtype)
        assert plan.path == "cluster" and plan.cluster == k
        if k > 1:                        # one row fewer needs twice the blocks
            assert softmax.softmax_plan(rows - 1, 1025,
                                        dtype).cluster == min(2 * k, 8)
        top = softmax.CLUSTER_MAX_COLS
        assert _check_invariants(rows, top, dtype).cluster == 8
        assert _check_invariants(rows, top + 1, dtype).path == "sweep"

    def test_cluster_path_limits(self):
        assert softmax.MAX_SLICE_COLS == 58_048
        assert softmax.CLUSTER_MAX_COLS == 464_384
        widest = softmax.softmax_plan(2, softmax.CLUSTER_MAX_COLS,
                                      torch.float32)
        assert widest.smem_bytes + softmax.SLOT_BYTES == SMEM_PER_BLOCK

    def test_cluster_raised_until_a_slice_fits(self):
        # 132 rows fill the card with k = 1, but a 100,000-column row needs
        # two slices of 50,000 to fit shared memory.
        plan = _check_invariants(132, 100_000, torch.float32)
        assert (plan.cluster, plan.slice_cols) == (2, 50_000)
        assert _check_invariants(132, 58_048, torch.float32).cluster == 1
        assert _check_invariants(132, 58_049, torch.float32).cluster == 2

    @pytest.mark.parametrize("rows, cols, want", [
        # (a) and (b) prefill, (a) and (b) decode, (c) decode
        (8192, 161, dict(path="warp", grid=1024, per_lane=8)),
        (64, 161, dict(path="warp", grid=8, per_lane=8)),
        (16, 5120, dict(path="cluster", grid=128, cluster=8,
                        slice_cols=640, vec=True)),
        (64, 32768, dict(path="cluster", grid=256, cluster=4,
                         slice_cols=8192, smem_bytes=32768, vec=True)),
        (8191, 161, dict(path="warp", grid=1024)),
        (2, 1 << 20, dict(path="sweep", grid=2)),
    ])
    def test_serving_and_smoke_shapes(self, rows, cols, want):
        plan = _check_invariants(rows, cols, torch.float32)
        assert {k: getattr(plan, k) for k in want} == want

    @settings(max_examples=200, deadline=None)
    @given(st.integers(1, 20_000), st.integers(1, 600_000),
           st.sampled_from(DTYPES))
    def test_property_invariants(self, rows, cols, dtype):
        _check_invariants(rows, cols, dtype)

    @pytest.mark.parametrize("rows, cols", [
        (0, 5), (5, 0), (2 ** 34, 161), (2 ** 31, 2048), (2 ** 31, 1 << 20)])
    def test_empty_or_too_large_raises(self, rows, cols):
        with pytest.raises(ValueError):
            softmax.softmax_plan(rows, cols, torch.float32)


class TestExpPlan:
    @pytest.mark.parametrize("n, x_ptr, y_ptr, want", [
        ((1 << 24) + 3, 0x7000_0000, 0x7800_0000, ("vector", 1 << 22, 3)),
        (1 << 24, 0x7000_0004, 0x7800_0000, ("scalar", 0, 1 << 24)),
        (1 << 24, 0x7000_0000, 0x7800_0008, ("scalar", 0, 1 << 24)),
        (16384, 0x7000_0010, 0x7800_0100, ("vector", 4096, 0)),
        (3, 0x7000_0000, 0x7800_0000, ("vector", 0, 3)),
        (9, 0x7000_000c, 0x7800_000c, ("scalar", 0, 9)),
    ])
    def test_split(self, n, x_ptr, y_ptr, want):
        plan = expf.exp_plan(n, x_ptr, y_ptr)
        assert tuple(plan)[:3] == want
        assert 4 * plan.n_vec4 + plan.n_tail == n
        # The default tiling is the launch from before tilings: 256
        # threads, a chunk of 512 float4s, or a capped grid-stride grid.
        assert plan.threads == 256
        if plan.path == "vector":
            assert (plan.chunk, plan.grid) == (512, max(1, -(-(n // 4) //
                                                             512)))
        else:
            assert (plan.chunk, plan.grid) == (0, min(-(-n // 256), 2112))


@pytest.fixture
def recorder(monkeypatch):
    """Replace the launch with a recorder; give both wrappers fresh
    counters (restored after the test) and take CPU tensors."""
    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda stem, name, argtypes, *args:
                        calls.append((stem, name, len(argtypes), args)))
    monkeypatch.setattr(_build, "check_cuda_tensor", lambda *a: None)
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    for fn, paths in ((softmax.softmax_cuda, ("warp", "cluster", "sweep")),
                      (expf.exp_cuda, ("vector", "scalar"))):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "path_launches", dict.fromkeys(paths, 0))
    return calls


class TestWrappers:
    @pytest.mark.parametrize("rows, cols, dtype, path, extra", [
        (8192, 161, torch.float32, "warp", (8, 8)),
        (64, 161, torch.bfloat16, "warp", (8, 8)),
        (16, 5120, torch.float32, "cluster", (8, 640, 256, 2560, 1)),
        (16, 5121, torch.bfloat16, "cluster", (8, 648, 256, 2592, 0)),
        (2, 1 << 20, torch.float32, "sweep", ()),
    ])
    def test_softmax_launcher_and_counters(self, recorder, rows, cols, dtype,
                                           path, extra):
        x = torch.zeros(rows, cols, dtype=dtype)
        y = softmax.softmax_cuda(x)
        assert y.shape == x.shape and y.dtype == dtype
        sfx = "f32" if dtype == torch.float32 else "bf16"
        [(stem, name, n_args, args)] = recorder
        assert (stem, name) == ("softmax", f"copift_softmax_{path}_{sfx}")
        assert n_args == len(args) and args[2:4] == (rows, cols)
        assert args[4:-1] == extra
        assert softmax.softmax_cuda.launches == 1
        assert softmax.softmax_cuda.path_launches == {
            p: int(p == path) for p in ("warp", "cluster", "sweep")}

    def test_softmax_cluster_misaligned_takes_4_byte_loads(self, recorder):
        base = torch.zeros(16 * 5120 + 1)
        x = base[1:].view(16, 5120)      # contiguous, 4 bytes past alignment
        softmax.softmax_cuda(x)
        [(_, name, _, args)] = recorder
        assert name == "copift_softmax_cluster_f32" and args[-2] == 0

    @pytest.mark.parametrize("n, offset, path", [
        ((1 << 12) + 3, 0, "vector"), (1 << 12, 1, "scalar"),
        (16384, 0, "vector"), (2, 0, "vector")])
    def test_exp_split_by_alignment(self, recorder, n, offset, path):
        x = torch.zeros(n + offset)[offset:]
        y = expf.exp_cuda(x)
        [(stem, name, n_args, args)] = recorder
        assert stem == "expf" and n_args == len(args)
        if path == "vector":
            assert name == "copift_exp_vec_f32"
            assert args[2:4] == (n // 4, n) and y.data_ptr() % 16 == 0
        else:
            assert name == "copift_exp_f32" and args[2] == n
        assert expf.exp_cuda.launches == 1
        assert expf.exp_cuda.path_launches == {
            p: int(p == path) for p in ("vector", "scalar")}


def _launchers(stem: str) -> dict[str, int]:
    """Each ``extern "C"`` launcher of ``csrc/<stem>.cu`` with its number of
    parameters."""
    src = (_build.CSRC / f"{stem}.cu").read_text()
    return {name: len(params.split(","))
            for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                           src)}


class TestSources:
    def test_softmax_launchers_match_the_wrapper(self):
        found = _launchers("softmax")
        for path, argtypes in softmax._ARGS.items():
            for sfx in ("f32", "bf16"):
                assert found[f"copift_softmax_{path}_{sfx}"] == len(argtypes)

    def test_exp_launchers_match_the_wrapper(self):
        found = _launchers("expf")
        assert found["copift_exp_f32"] == len(expf._ARGS["scalar"])
        assert found["copift_exp_vec_f32"] == len(expf._ARGS["vector"])

    def test_shared_memory_constants_match(self):
        src = (_build.CSRC / "softmax.cu").read_text()
        consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
        assert int(consts["kSmemPerBlock"]) == softmax.SMEM_PER_BLOCK
        assert int(consts["kSlotBytes"]) == softmax.SLOT_BYTES
        assert softmax.SMEM_PER_BLOCK == SMEM_PER_BLOCK
        # The warp path's block: 8 rows of 32 threads by default, at most
        # a block of 1024 threads (the tiled kernels' bounds).
        common = (_build.CSRC / "common.cuh").read_text()
        consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", common))
        assert int(consts["kDefaultBlockThreads"]) == 256 == \
            32 * softmax.DEFAULT_BLOCK_ROWS == _build.DEFAULT_BLOCK_THREADS
        assert int(consts["kMaxBlockThreads"]) == 1024 == \
            32 * softmax.MAX_ROWS_PER_BLOCK == _build.MAX_BLOCK_THREADS


def cluster_emulation(x: torch.Tensor, k: int) -> torch.Tensor:
    """Path (b)'s arithmetic in plain PyTorch: the row cut into k slices of
    ``softmax_plan``'s width; per-slice maxima, their max; exp(x - max) per
    slice; per-slice sums added in rank order; e / sum."""
    xf = x.to(torch.float32)
    width = _slice_cols(xf.shape[-1], k)
    slices = [xf[..., r * width:(r + 1) * width] for r in range(k)]
    neg = torch.full(xf.shape[:-1], -torch.inf)
    m = neg
    for s in slices:
        m = torch.maximum(m, s.amax(dim=-1) if s.shape[-1] else neg)
    es = [exp_phases(s - m[..., None], clamp_hi=False) for s in slices]
    total = torch.zeros(xf.shape[:-1])
    for e in es:                                  # rank order
        total = total + e.sum(dim=-1)
    return (torch.cat(es, dim=-1) / total[..., None]).to(x.dtype)


class TestClusterEmulation:
    @pytest.mark.parametrize("k", [1, 2, 4, 8])
    @pytest.mark.parametrize("shape", [(4, 40), (3, 161), (2, 1025)])
    def test_matches_pallas_and_ref(self, shape, k):
        rng = np.random.default_rng(shape[-1] + k)
        x = rng.normal(0, 4, shape).astype(np.float32)
        x[..., shape[-1] // 2 + 1:] = NEG_INF     # masked scores
        x[0] = NEG_INF                            # a row masked whole
        got = cluster_emulation(torch.from_numpy(x), k).numpy()
        for want in (jops.softmax(jnp.asarray(x), impl="pallas"),
                     jref.softmax_ref(jnp.asarray(x))):
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       rtol=3e-5, atol=3e-7)
        np.testing.assert_allclose(got[0], 1.0 / shape[-1], rtol=3e-5)

    def test_matches_the_plain_version(self):
        x = torch.from_numpy(np.random.default_rng(0).normal(
            0, 6, (5, 3000)).astype(np.float32))
        for k in (1, 2, 4, 8):
            torch.testing.assert_close(cluster_emulation(x, k),
                                       softmax.softmax_plain(x),
                                       rtol=3e-5, atol=3e-7)
