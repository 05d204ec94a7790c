"""The serving engine's decode step read from device memory
(``repro_torch.serve.engine``: ``_DecodeState``, the sampler's rows of
uniforms) and its CUDA graph.

On the CPU: the sampler's rows (``uniform_rows_plain``, ``ops.uniform_rows``)
are stacked ``uniform_plain`` rows bit for bit, for both generators and
seeds near 2**32, and the seeds table is ``_mix32``'s; a decode step at a
position held in a 0-d tensor gives the bits of the step at the equal int
(OLMo smoke; Jamba smoke, whose attention has a sliding window); the
engine's own cache, zeroed at each call, gives a second call the tokens of
a fresh engine; the spans count ``graph`` 0 on every step and
``graph_captures`` 0; ``card.off`` keeps spans from recording.

On the card (marked ``card``; they skip without a CUDA device, and run with
``python3 -m pytest -m card tests/test_torch_serve_graph.py`` on a machine
with one): the rows launcher against the plain version; the graph engine
against the same engine's eager steps, tokens and logits bit for bit, at
olmo-1b.decode's batch and prompt and for every decoder family's smoke
model; ``graph`` 1 on every replayed step; the device trace shows each
replay's kernels, which the wrappers' counters do not count.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro_torch.configs import load_config  # noqa: E402
from repro_torch.kernels import decode_attn as D  # noqa: E402
from repro_torch.kernels import ops, prng  # noqa: E402
from repro_torch.models.model import forward, init_params  # noqa: E402
from repro_torch.obs import card  # noqa: E402
from repro_torch.serve import engine as E  # noqa: E402
from repro_torch.serve.engine import ServeEngine, make_cache  # noqa: E402

KINDS = ("xoshiro128p", "lcg")
#: seeds at both ends of the uint32 range: the counter wraps past 2**32
SEEDS = (0, 1, 12345, 2 ** 31, 2 ** 32 - 1000, 2 ** 32 - 1)
#: the decoder families (every served family but the audio encoder)
FAMILIES = ("olmo-1b", "phi3-mini-3.8b", "qwen3-32b", "gemma-2b",
            "deepseek-moe-16b", "grok-1-314b", "rwkv6-1.6b",
            "jamba-v0.1-52b", "qwen2-vl-72b")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def fresh_store():
    card.clear()
    yield
    card.clear()


def _model(arch: str, device="cpu", seed: int = 0):
    cfg = load_config(arch, "smoke")
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, params.to(device)


def _prompts(cfg, B: int, P: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)


def _bits(seeds) -> torch.Tensor:
    """uint32 seeds as the int32 bits the card reads."""
    return torch.from_numpy(np.array(seeds, dtype=np.uint32).view(np.int32))


class TestRows:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("n", [1, 503, 4099])
    def test_rows_are_stacked_uniform_plain(self, kind, n):
        want = torch.stack([prng.uniform_plain(s, n, kind) for s in SEEDS])
        as_int64 = torch.tensor(SEEDS, dtype=torch.int64)
        assert torch.equal(prng.uniform_rows_plain(as_int64, n, kind), want)
        assert torch.equal(prng.uniform_rows_plain(_bits(SEEDS), n, kind),
                           want)
        assert torch.equal(ops.uniform_rows(_bits(SEEDS), n, kind), want)

    def test_refuses_what_is_no_row_of_seeds(self):
        with pytest.raises(ValueError, match="1-d int32 or int64"):
            prng.uniform_rows_plain(torch.zeros(2, 2, dtype=torch.int32), 4)
        with pytest.raises(ValueError, match="1-d int32 or int64"):
            prng.uniform_rows_plain(torch.zeros(2), 4)
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            prng.uniform_rows_cuda(_bits(SEEDS), 4)

    def test_the_seeds_table_is_mix32(self):
        slots = [0, 7, 2 ** 32 - 1, 123456789, 2 ** 31]
        table = E._step_seeds(slots, 9)
        assert table.dtype == np.uint32 and table.shape == (9, len(slots))
        assert table.tolist() == [[E._mix32(s, i) for s in slots]
                                  for i in range(9)]

    @pytest.mark.parametrize("step", [0, 5])
    def test_sample_is_the_per_row_draws(self, step):
        """One launch a step gives the tokens of one uniform draw a row."""
        eng = ServeEngine(object(), None, batch=3, temperature=0.7, seed=5,
                          device="cpu")
        logits = torch.randn(3, 50, generator=torch.Generator().manual_seed(1))
        slot_seeds = [11, 2 ** 32 - 2, 9]
        u = torch.stack([ops.uniform(E._mix32(s, step), (50,), device="cpu")
                         for s in slot_seeds])
        g = -torch.log(-torch.log(torch.clamp(u, min=1e-12)))
        want = torch.argmax(logits / 0.7 + g, dim=-1)
        table = _bits(E._step_seeds(slot_seeds, 6))
        assert torch.equal(eng._sample(logits, torch.tensor([step]), table),
                           want)


class TestTensorPosition:
    @pytest.mark.parametrize("arch", ["olmo-1b", "jamba-v0.1-52b"])
    def test_a_step_at_a_tensor_position_is_the_step_at_the_int(self, arch):
        """Jamba's smoke window is 32 slots: at position 40 it keeps 9 to
        40."""
        cfg, params = _model(arch)
        B, P = 2, 40
        prompts = torch.from_numpy(_prompts(cfg, B, P)).long()
        tok = torch.from_numpy(_prompts(cfg, B, 1, seed=1)).long()
        got = []
        for pos in (P, torch.tensor(P)):
            cache = make_cache(cfg, B, P + 8, "cpu")
            with torch.no_grad():
                forward(params, cfg, {"tokens": prompts}, cache=cache,
                        cache_index=0, logits_mode="last")
                logits, cache, _ = forward(params, cfg, {"tokens": tok},
                                           cache=cache, cache_index=pos,
                                           logits_mode="last")
            got.append((logits, tree_leaves(cache)))
        (want, want_cache), (logits, cache) = got
        assert torch.equal(logits, want)
        assert all(torch.equal(a, b) for a, b in zip(cache, want_cache))

    def test_a_tensor_position_writes_one_token(self):
        cfg, params = _model("olmo-1b")
        cache = make_cache(cfg, 2, 16, "cpu")
        tokens = torch.zeros(2, 3, dtype=torch.long)
        with pytest.raises(ValueError, match="one token a row, not 3"):
            forward(params, cfg, {"tokens": tokens}, cache=cache,
                    cache_index=torch.tensor(4), logits_mode="last")


class TestEngineState:
    @pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b",
                                      "rwkv6-1.6b", "jamba-v0.1-52b"])
    def test_a_second_call_gives_a_fresh_engines_tokens(self, arch):
        """The KV cache and the recurrent states start at 0 in every
        call, as a new cache did."""
        cfg, params = _model(arch)
        kw = dict(max_len=24, batch=2, temperature=1.0, seed=3, device="cpu")
        eng = ServeEngine(cfg, params, **kw)
        eng.generate(_prompts(cfg, 2, 8, seed=1), 10)
        again = eng.generate(_prompts(cfg, 2, 8, seed=2), 10)
        fresh = ServeEngine(cfg, params, **kw).generate(
            _prompts(cfg, 2, 8, seed=2), 10)
        np.testing.assert_array_equal(again.tokens, fresh.tokens)
        assert torch.equal(again.logits, fresh.logits)

    def test_the_spans_count_graph_0_on_the_cpu(self):
        cfg, params = _model("olmo-1b")
        eng = ServeEngine(cfg, params, max_len=24, batch=2, temperature=1.0,
                          device="cpu")
        with profile(activities=[ProfilerActivity.CPU]):
            eng.generate(_prompts(cfg, 2, 8), 5)
        recs = card.read()
        steps = [r for r in recs if r.name == "serve.decode_step"]
        assert [r.counters for r in steps] == [{"graph": 0}] * 4
        (gen,) = [r for r in recs if r.name == "serve.generate"]
        assert gen.counters == {"graph_captures": 0}
        assert sum(r.name == "serve.sample" for r in recs) == 5
        assert eng._state.graph is None

    def test_off_keeps_spans_from_recording(self):
        with profile(activities=[ProfilerActivity.CPU]):
            with card.off():
                with card.span("hidden") as sp:
                    assert sp is card.OFF
            with card.span("seen"):
                pass
        assert [r.name for r in card.read()] == ["seen"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _graph_and_eager(monkeypatch, eng, prompts, n_steps: int):
    """``eng.generate`` with its captured graph (traced), then with eager
    steps: (graph result, its records, eager result)."""
    eng.generate(prompts, 2)                   # the capture
    assert eng._state.graph is not None
    card.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        graphed = eng.generate(prompts, n_steps)
    recs = card.read()
    monkeypatch.setattr(eng, "_graphable", lambda: False)
    eng._state.graph = None
    eager = eng.generate(prompts, n_steps)
    return graphed, recs, eager


@pytest.mark.card
class TestCard:
    @pytest.mark.parametrize("kind", KINDS)
    @pytest.mark.parametrize("rows,n", [(128, 50304), (3, 1), (70000, 3)])
    def test_the_rows_launcher_is_bit_exact(self, cuda, kind, rows, n):
        seeds = (np.arange(rows, dtype=np.uint64) * 2654435761 + 2 ** 32 - 7
                 ) % 2 ** 32
        bits = _bits(seeds).to(cuda)
        got = prng.uniform_rows_cuda(bits, n, kind)
        assert torch.equal(got, prng.uniform_rows_plain(bits, n, kind))
        for r in (0, rows - 1):
            assert torch.equal(got[r], prng.uniform_cuda(int(seeds[r]), n,
                                                         kind, cuda))

    def test_olmo_at_the_cell_shape(self, cuda, monkeypatch):
        """olmo-1b.decode's batch 128 and prompt 1,024, sampled at 0.8, 5
        tokens: the replays give the eager steps' tokens and logits."""
        cfg = load_config("olmo-1b", "full")
        params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
        eng = ServeEngine(cfg, params, max_len=1024 + 5, batch=128,
                          temperature=0.8, seed=2 ** 32 - 5, device=cuda)
        prompts = _prompts(cfg, 128, 1024)
        graphed, recs, eager = _graph_and_eager(monkeypatch, eng, prompts, 5)
        np.testing.assert_array_equal(graphed.tokens, eager.tokens)
        assert torch.equal(graphed.logits, eager.logits)
        steps = [r for r in recs if r.name == "serve.decode_step"]
        assert [r.counters for r in steps] == [{"graph": 1}] * 4

    @pytest.mark.parametrize("temperature", [0.0, 1.0],
                             ids=["greedy", "sampled"])
    @pytest.mark.parametrize("arch", FAMILIES)
    def test_each_family(self, cuda, monkeypatch, arch, temperature):
        cfg, params = _model(arch, cuda)
        eng = ServeEngine(cfg, params, max_len=48, batch=2,
                          temperature=temperature, seed=3, device=cuda)
        prompts = _prompts(cfg, 2, 36)
        graphed, recs, eager = _graph_and_eager(monkeypatch, eng, prompts, 12)
        np.testing.assert_array_equal(graphed.tokens, eager.tokens)
        assert torch.equal(graphed.logits, eager.logits)
        steps = [r for r in recs if r.name == "serve.decode_step"]
        assert [r.counters for r in steps] == [{"graph": 1}] * 11
        (gen,) = [r for r in recs if r.name == "serve.generate"]
        assert gen.counters == {"graph_captures": 0}

    def test_a_capture_is_counted_once(self, cuda):
        cfg, params = _model("olmo-1b", cuda)
        eng = ServeEngine(cfg, params, max_len=24, batch=2, device=cuda)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            eng.generate(_prompts(cfg, 2, 8), 4)
        recs = card.read()
        (gen,) = [r for r in recs if r.name == "serve.generate"]
        assert gen.counters == {"graph_captures": 1}
        steps = [r for r in recs if r.name == "serve.decode_step"]
        assert [r.counters for r in steps] == [{"graph": 0}, {"graph": 1},
                                               {"graph": 1}]

    def test_the_replays_launch_each_kernel_once_a_step(self, cuda,
                                                         tmp_path):
        """On the device each decode step launches each decode kernel once
        a layer and the rows kernel once, replayed or eager; the wrappers
        count only their calls: the warm-up step's and the capture's."""
        cfg, params = _model("olmo-1b", cuda)
        eng = ServeEngine(cfg, params, max_len=24, batch=2, temperature=1.0,
                          device=cuda)
        counted = (D.decode_scores_cuda, D.decode_pv_cuda,
                   prng.uniform_rows_cuda)
        before = [fn.launches for fn in counted]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.generate(_prompts(cfg, 2, 8), 8)
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(tmp_path / "trace.json"))
        events = json.loads((tmp_path / "trace.json").read_text())
        names = [e["name"] for e in events["traceEvents"]
                 if e.get("cat") == "kernel"]
        on_device = [sum(kernel in n for n in names) for kernel in (
            "decode_scores_kernel", "decode_pv_kernel", "uniform_rows_kernel")]
        assert on_device == [cfg.n_layers * 7, cfg.n_layers * 7, 8]
        wrapped = [fn.launches - b for fn, b in zip(counted, before)]
        assert wrapped == [cfg.n_layers * 2, cfg.n_layers * 2, 3]
