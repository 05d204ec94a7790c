"""How the port's logf and Monte-Carlo wrappers choose a kernel path, and the
arithmetic of the Monte-Carlo segment path, on the CPU.

``log_plan`` maps pointers to ``csrc/logf.cu``'s vector or scalar kernel;
``mc_plan`` maps a shape to ``csrc/montecarlo.cu``'s lane path (S = 1) or
its segment path (S segments a lane).  The wrappers are driven here with the
launch replaced by a recorder, since the kernels run only on the card.  The
segment path's jump tables are held against sequential generator steps, and
its plain version (``mc_segmented_plain``) bit for bit against the JAX
package's Pallas kernel (interpret mode, as tests/test_kernels.py runs it)
and its oracle ``mc_blocked_ref``."""

import re
from pathlib import Path

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import montecarlo as jmc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import _build, logf  # noqa: E402
from repro_torch.kernels import montecarlo as mc  # noqa: E402
from repro_torch.kernels.prng import KINDS  # noqa: E402

MASK = 0xFFFFFFFF
VARIANTS = [(p, k) for p in ("pi", "poly") for k in ("lcg", "xoshiro128p")]


class TestLogPlan:
    @pytest.mark.parametrize("n, x_ptr, y_ptr, want", [
        ((1 << 24) + 3, 0x7000_0000, 0x7800_0000, ("vector", 1 << 22, 3)),
        (1 << 24, 0x7000_0004, 0x7800_0000, ("scalar", 0, 1 << 24)),
        (1 << 24, 0x7000_0000, 0x7800_0008, ("scalar", 0, 1 << 24)),
        (4097, 0x7000_0010, 0x7800_0100, ("vector", 1024, 1)),
        (3, 0x7000_0000, 0x7800_0000, ("vector", 0, 3)),
        (9, 0x7000_000c, 0x7800_000c, ("scalar", 0, 9)),
    ])
    def test_split(self, n, x_ptr, y_ptr, want):
        plan = logf.log_plan(n, x_ptr, y_ptr)
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


class TestMcPlan:
    @pytest.mark.parametrize("n_blocks, iters, want", [
        (8, 8192, 8),           # the facade's default at 2**26 samples
        (1024, 64, 1),          # 2**26 samples over the card-filling lanes
        (1024, 8192, 1),
        (2, 32768, 32),         # 2048 x 32 = 65,536 threads
        (4, 16384, 16),
        (16, 4096, 4),
        (16, 1 << 20, 4),
        (32, 2048, 1),          # 32,768 lanes: the lane path
        (17, 4096, 1),          # 17,408 >= 132 x 128 lanes
        (16, 511, 2),           # 128 samples a segment cap S at 2
        (16, 512, 4),
        (8, 1024, 8),
        (8, 256, 2),
        (1, 1 << 20, 32),       # 32 segments of 1024 lanes: the most there is
        (1, 4095, 16),
        (8, 255, 1),
        (8, 0, 1),
        (8, 1, 1),
        (1, 1 << 40, 1),        # every segment would pass 2**24 samples
    ])
    def test_edges(self, n_blocks, iters, want):
        assert mc.mc_plan(n_blocks * mc.LANES, iters) == want

    def test_segments_are_powers_of_two_up_to_32(self):
        assert mc.SEGMENTS == tuple(1 << i for i in range(6))
        assert mc.LANE_PATH_LANES == 132 * 128

    @settings(max_examples=300, deadline=None)
    @given(st.integers(1, 4096), st.integers(0, 1 << 40))
    def test_property_rule(self, n_blocks, iters):
        n_lanes = n_blocks * mc.LANES
        s = mc.mc_plan(n_lanes, iters)
        assert s in mc.SEGMENTS
        if n_lanes >= mc.LANE_PATH_LANES:
            assert s == 1
            return
        ok = [t for t in mc.SEGMENTS[1:]
              if iters >= mc.MIN_SEGMENT_SAMPLES * t
              and mc.segment_length(iters, t) <= mc.SATURATION]
        full = [t for t in ok if n_lanes * t >= mc.SEGMENT_THREADS]
        assert s == (full[0] if full else ok[-1] if ok else 1)


# ---------------------------------------------------------------------------
# the jump tables against sequential steps
# ---------------------------------------------------------------------------

def _steps(kind: str, state: tuple[int, ...], k: int) -> tuple[int, ...]:
    """k generator steps of one state, in Python integers."""
    if kind == "lcg":
        (s,) = state
        for _ in range(k):
            s = (s * mc.LCG_A + mc.LCG_C) & MASK
        return (s,)
    s0, s1, s2, s3 = state
    for _ in range(k):
        t = (s1 << 9) & MASK
        s2 ^= s0
        s3 ^= s1
        s1 ^= s2
        s0 ^= s3
        s2 ^= t
        s3 = ((s3 << 11) & MASK) | (s3 >> 21)
    return (s0, s1, s2, s3)


def _jumped(kind: str, states: np.ndarray, k: int) -> np.ndarray:
    """``apply_jump`` of ``jump_words(kind, k)`` on (words, lanes) states."""
    t = torch.from_numpy(states.astype(np.int64))
    if kind == "lcg":
        t = t[0]
    got = mc.apply_jump(kind, t, mc.jump_words(kind, k)).numpy()
    return got.reshape(-1, states.shape[1])


def _random_states(kind: str, n: int, seed: int) -> np.ndarray:
    words = 1 if kind == "lcg" else 4
    return np.random.default_rng(seed).integers(
        0, 1 << 32, (words, n), dtype=np.uint64)


class TestJumpTables:
    @pytest.mark.parametrize("kind", ["lcg", "xoshiro128p"])
    @pytest.mark.parametrize("k", [0, 1, 2, 3, 1001, (1 << 20) + 1])
    def test_jump_equals_k_steps(self, kind, k):
        states = _random_states(kind, 2, k)
        got = _jumped(kind, states, k)
        for lane in range(states.shape[1]):
            want = _steps(kind, tuple(int(w) for w in states[:, lane]), k)
            assert tuple(int(w) for w in got[:, lane]) == want

    @settings(max_examples=40, deadline=None)
    @given(st.sampled_from(["lcg", "xoshiro128p"]), st.integers(0, 3000),
           st.integers(0, 2 ** 32 - 1))
    def test_property_jump_equals_steps(self, kind, k, seed):
        states = _random_states(kind, 1, seed)
        got = _jumped(kind, states, k)
        assert tuple(int(w) for w in got[:, 0]) == _steps(
            kind, tuple(int(w) for w in states[:, 0]), k)

    @settings(max_examples=25, deadline=None)
    @given(st.sampled_from(["lcg", "xoshiro128p"]),
           st.integers(0, 1 << 40), st.integers(0, 1 << 40))
    def test_property_jumps_compose(self, kind, a, b):
        states = _random_states(kind, 3, a ^ b)
        once = _jumped(kind, states, a + b)
        twice = _jumped(kind, _jumped(kind, states, a).astype(np.uint64), b)
        np.testing.assert_array_equal(once, twice)

    @pytest.mark.parametrize("kind", ["lcg", "xoshiro128p"])
    @pytest.mark.parametrize("iters, segments", [
        (8192, 32), (64, 32), (100, 16), (7, 4), (0, 2), (1, 1)])
    def test_table_entry_s_jumps_2_s_l(self, kind, iters, segments):
        table = mc.jump_table(kind, iters, segments)
        words = 2 if kind == "lcg" else 2048
        assert table.shape == (segments, words) and table.dtype == np.uint32
        seg_len = mc.segment_length(iters, segments)
        for s in range(segments):
            np.testing.assert_array_equal(
                table[s], mc.jump_words(kind, 2 * s * seg_len))

    def test_xoshiro_entry_is_32_nibble_tables(self):
        # Entry 0 is the identity: entry v of nibble p's table puts v back
        # at nibble p, that is word p // 8 equal to v << 4 * (p % 8).
        tables = mc.jump_words("xoshiro128p", 0).reshape(32, 16, 4)
        want = np.zeros((32, 16, 4), np.uint32)
        for p in range(32):
            for v in range(16):
                want[p, v, p // 8] = v << (4 * (p % 8))
        np.testing.assert_array_equal(tables, want)
        # One step: the entry for one set bit c is the transition of the
        # state with only bit c set; entries xor as their nibbles do.
        one = mc.jump_words("xoshiro128p", 1).reshape(32, 16, 4)
        for c in (0, 31, 32, 77, 127):
            basis = [0, 0, 0, 0]
            basis[c // 32] = 1 << (c % 32)
            assert tuple(int(w) for w in one[c // 4, 1 << (c % 4)]) == \
                _steps("xoshiro128p", tuple(basis), 1)
        np.testing.assert_array_equal(one[:, 5], one[:, 1] ^ one[:, 4])
        np.testing.assert_array_equal(one[:, 15], one[:, 7] ^ one[:, 8])

    def test_device_copy_is_cached(self):
        a = mc.jump_table_on("xoshiro128p", 100, 4, torch.device("cpu"))
        b = mc.jump_table_on("xoshiro128p", 100, 4, torch.device("cpu"))
        assert a is b and a.dtype == torch.int32 and a.shape == (4, 2048)
        np.testing.assert_array_equal(
            a.numpy().view(np.uint32), mc.jump_table("xoshiro128p", 100, 4))

    @pytest.mark.parametrize("bad", [
        dict(kind="pcg", iters=8, segments=2),
        dict(kind="lcg", iters=8, segments=3),
        dict(kind="lcg", iters=8, segments=64)])
    def test_bad_arguments_raise(self, bad):
        with pytest.raises(ValueError):
            mc.jump_table(**bad)


# ---------------------------------------------------------------------------
# the segment path's plain version against the JAX package
# ---------------------------------------------------------------------------

class TestSegmentedPlain:
    @pytest.mark.parametrize("iters", [0, 1, 2, 7, 31, 100])
    @pytest.mark.parametrize("seed", [0, 2 ** 32 - 1])
    @pytest.mark.parametrize("problem, kind", VARIANTS)
    def test_bitexact_vs_pallas_and_blocked_ref(self, problem, kind, seed,
                                                iters):
        kw = dict(kind=kind, problem=problem, iters=iters, n_blocks=2)
        lanes = mc.mc_blocked_plain(seed, **kw).numpy()
        pallas = np.asarray(jmc.mc_partial_sums(jnp.uint32(seed),
                                                interpret=True, **kw))
        blocked = np.asarray(jmc.mc_blocked_ref(seed, **kw))
        np.testing.assert_array_equal(lanes, pallas)
        np.testing.assert_array_equal(lanes, blocked)
        for segments in (1, 2, 4, 16, 32):
            got = mc.mc_segmented_plain(seed, segments=segments, **kw)
            assert got.dtype == torch.float32 and got.shape == (2, mc.LANES)
            np.testing.assert_array_equal(got.numpy(), pallas)

    def test_estimate_at_the_facade_shape(self):
        # n_blocks 8 at iters 16 (S = 32 has empty segments): the estimate
        # from the segment path equals JAX's.
        kw = dict(kind="xoshiro128p", problem="pi", iters=16, n_blocks=8)
        sums = mc.mc_segmented_plain(42, segments=32, **kw)
        want = jmc.mc_estimate(42, kind="xoshiro128p", problem="pi",
                               n_samples=16 * 8 * 1024, n_blocks=8,
                               interpret=True)
        assert float(mc.mc_estimate(sums, "pi", 16)) == float(want)


class TestSaturation:
    @pytest.mark.parametrize("start", [(1 << 24) - 3, 1 << 24])
    def test_step_at_the_boundary(self, start):
        for step in (0.0, 1.0):
            got = np.float32(min(start, 1 << 24)) + np.float32(step)
            assert int(got) == min(start + int(step), 1 << 24)

    def test_fp32_accumulation_is_the_clamped_count(self):
        # Sequential fp32 accumulation of 0/1 steps past 2**24 equals the
        # integer count clamped at 2**24 at every step.
        n = (1 << 24) + 4096
        steps = np.ones(n, np.float32)
        steps[np.random.default_rng(0).choice(n, 1000, replace=False)] = 0
        acc = np.add.accumulate(steps, dtype=np.float32)
        count = np.add.accumulate(steps.astype(np.int32), dtype=np.int32)
        assert count[-1] > mc.SATURATION
        np.testing.assert_array_equal(
            acc, np.minimum(count, mc.SATURATION).astype(np.float32))


class TestLogSemantics:
    def test_nan_and_inf_give_the_pallas_paths_finite_values(self):
        x = np.array([np.nan, np.inf, -np.inf, 0.0, -1.0, 2.0], np.float32)
        want = np.asarray(jops.log(jnp.asarray(x), impl="pallas"))
        got = logf.log_plain(torch.from_numpy(x)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the wrappers, with the launch recorded
# ---------------------------------------------------------------------------

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
    for fn, paths in ((logf.log_cuda, ("vector", "scalar")),
                      (mc.mc_partial_sums_cuda, ("lane", "segment"))):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "path_launches", dict.fromkeys(paths, 0))
    return calls


class TestWrappers:
    @pytest.mark.parametrize("n, offset, path", [
        ((1 << 12) + 3, 0, "vector"), (1 << 12, 1, "scalar"),
        (4097, 0, "vector"), (2, 0, "vector")])
    def test_log_split_by_alignment(self, recorder, n, offset, path):
        x = torch.ones(n + offset)[offset:]
        y = logf.log_cuda(x)
        [(stem, name, n_args, args)] = recorder
        assert stem == "logf" and n_args == len(args)
        if path == "vector":
            assert name == "copift_log_vec_f32"
            assert args[2:4] == (n // 4, n) and y.data_ptr() % 16 == 0
        else:
            assert name == "copift_log_f32" and args[2] == n
        invc, logc = logf.logf_tables(x.device)
        assert args[-3:-1] == (invc.data_ptr(), logc.data_ptr())
        assert logf.log_cuda.launches == 1
        assert logf.log_cuda.path_launches == {
            p: int(p == path) for p in ("vector", "scalar")}

    @pytest.mark.parametrize("problem, kind", VARIANTS)
    @pytest.mark.parametrize("n_blocks, iters", [(8, 8192), (1024, 64),
                                                 (8, 256)])
    def test_mc_path_by_shape(self, recorder, problem, kind, n_blocks, iters):
        out = mc.mc_partial_sums_cuda(2 ** 32 - 1, kind=kind, problem=problem,
                                      iters=iters, n_blocks=n_blocks,
                                      device="cpu")
        assert out.shape == (n_blocks, mc.LANES)
        [(stem, name, n_args, args)] = recorder
        assert stem == "montecarlo" and n_args == len(args)
        head = (n_blocks * mc.LANES, 2 ** 32 - 1, KINDS[kind],
                mc.PROBLEMS[problem], iters)
        assert args[1:6] == head
        segments = mc.mc_plan(n_blocks * mc.LANES, iters)
        path = "lane" if segments == 1 else "segment"
        if path == "lane":
            assert name == "copift_mc_f32"
        else:
            assert name == "copift_mc_seg_f32"
            table = mc.jump_table_on(kind, iters, segments,
                                     torch.device("cpu"))
            assert args[6:9] == (segments, mc.segment_length(iters, segments),
                                 table.data_ptr())
        assert mc.mc_partial_sums_cuda.launches == 1
        assert mc.mc_partial_sums_cuda.path_launches == {
            p: int(p == path) for p in ("lane", "segment")}


def _launchers(stem: str) -> dict[str, int]:
    """Each ``extern "C"`` launcher of ``csrc/<stem>.cu`` with its number of
    parameters."""
    src = (_build.CSRC / f"{stem}.cu").read_text()
    return {name: len(params.split(","))
            for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                           src)}


class TestSources:
    def test_log_launchers_match_the_wrapper(self):
        found = _launchers("logf")
        assert found["copift_log_f32"] == len(logf._ARGS["scalar"])
        assert found["copift_log_vec_f32"] == len(logf._ARGS["vector"])

    def test_mc_launchers_match_the_wrapper(self):
        found = _launchers("montecarlo")
        assert found["copift_mc_f32"] == len(mc._ARGS["lane"])
        assert found["copift_mc_seg_f32"] == len(mc._ARGS["segment"])

    def test_mc_constants_match(self):
        src = (_build.CSRC / "montecarlo.cu").read_text()
        assert int(re.search(r"constexpr int kMaxSegments = (\d+);",
                             src).group(1)) == max(mc.SEGMENTS)
        words = [eval(w) for w in re.findall(
            r"static constexpr int kJumpWords = ([\d *]+);", src)]
        assert words == [mc.jump_words("lcg", 5).size,
                         mc.jump_words("xoshiro128p", 5).size]

    def test_bound_reads_only_the_lane_kernels(self):
        # chip_smoke.py reads instructions per sample from the SASS of the
        # kernels its regex matches: the four lane kernels, never the
        # segment kernels (their mangled names as nvcc writes them).
        smoke = (Path(__file__).resolve().parents[1] / "chip_smoke.py")
        pattern = re.search(r're\.search\(r"([^"]+)", fn\)',
                            smoke.read_text()).group(1)
        lane = "_ZN12_GLOBAL__N_19mc_kernelILb1ENS_3LcgEEEvPflji"
        seg = "_ZN12_GLOBAL__N_117mc_segment_kernelILb1ENS_3LcgEEEvPfjllPKj"
        assert re.search(pattern, lane) and not re.search(pattern, seg)
        src = (_build.CSRC / "montecarlo.cu").read_text()
        assert "__global__ void mc_kernel(" in src
        assert "mc_segment_kernel(" in src
