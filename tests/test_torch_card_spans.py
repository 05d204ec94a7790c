"""The port's card spans and counters (``repro_torch.obs.card``) on the CPU,
on the smoke configs of OLMo-1B and DeepSeekMoE-16B: nothing is recorded
and no hook registered without ``torch.profiler``; a training step and
``generate`` are bit-identical with the profiler on and off; the span
names, parents and passes (the backward halves, and ``recompute`` under
``remat="full"``); the MoE counters against a plain re-routing; the spans
as host events of a CPU profile with no user annotation; the bound on the
records; and the exclusive attribution of device time.

On the CPU a span makes no CUDA event, so records carry host times only;
the device times and the metrics that read them are the card's."""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import load_config  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.obs import card  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                          make_train_step)

MODEL_SPANS = {"attn", "attn.core", "moe.router", "moe.dispatch",
               "moe.experts", "moe.combine"}


@pytest.fixture(autouse=True)
def fresh_store():
    card.clear()
    yield
    card.clear()


def _cfg(arch, remat="full", capacity_factor=None):
    cfg = load_config(arch, "smoke").replace(remat=remat)
    if capacity_factor is not None:
        cfg = cfg.replace(moe=cfg.moe.__class__(
            **dict(vars(cfg.moe), capacity_factor=capacity_factor)))
    return cfg


def _train(cfg, traced, steps=1, seed=0):
    """The masters, the last step's metrics and the profile (or None) of
    ``steps`` steps from seeded parameters and tokens."""
    g = torch.Generator().manual_seed(seed)
    state = init_train_state(
        cfg, init_params(cfg.replace(dtype=cfg.param_dtype), g, "cpu"))
    step = make_train_step(cfg, AdamWConfig())
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    prof = None
    if traced:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(steps):
                state, metrics = step(state, {"tokens": toks})
    else:
        for _ in range(steps):
            state, metrics = step(state, {"tokens": toks})
    return state.params, metrics, prof


def _generate(cfg, traced, temperature=0.8, new=6):
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    engine = ServeEngine(cfg, params, max_len=32, batch=2,
                         temperature=temperature, seed=5, device="cpu")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16))
    if traced:
        with profile(activities=[ProfilerActivity.CPU]):
            return engine.generate(prompts, new)
    return engine.generate(prompts, new)


@pytest.fixture
def chunked(monkeypatch):
    """Attention's chunked path at the smoke sizes: 64 tokens in query
    blocks and KV chunks of 16."""
    monkeypatch.setattr(A, "CHUNKED_THRESHOLD", 1)
    monkeypatch.setattr(A, "KV_CHUNK", 16)
    monkeypatch.setattr(A, "Q_BLOCK", 16)


class TestOff:
    def test_no_record_and_no_hook_without_the_profiler(self, monkeypatch):
        made = []

        class Counted(card._Backward):
            __slots__ = ()

            def __init__(self, *a):
                made.append(a)
                super().__init__(*a)

        monkeypatch.setattr(card, "_Backward", Counted)
        cfg = _cfg("deepseek-moe-16b", capacity_factor=1.25)
        _train(cfg, traced=False)
        _generate(cfg, traced=False)
        assert card.read() == [] and made == []
        assert card.span("attn") is card.OFF
        _train(cfg, traced=True)
        assert made and card.read()

    def test_the_off_span_hands_tensors_through(self):
        x = torch.ones(3, requires_grad=True)
        with card.span("attn") as sp:
            assert sp.input(x) is x and sp.output(x) is x
            sp.count(kept=x)
        assert card.read() == []


class TestBitIdentical:
    @pytest.mark.parametrize("arch,remat", [
        ("olmo-1b", "full"), ("olmo-1b", "none"),
        ("deepseek-moe-16b", "full"), ("deepseek-moe-16b", "dots")])
    def test_train_step(self, arch, remat, chunked):
        cfg = _cfg(arch, remat,
                   1.25 if arch.startswith("deepseek") else None)
        off, m_off, _ = _train(cfg, traced=False, steps=2)
        on, m_on, _ = _train(cfg, traced=True, steps=2)
        assert card.read()
        assert torch.equal(m_off["loss"], m_on["loss"])
        assert torch.equal(m_off["grad_norm"], m_on["grad_norm"])
        for k in off:
            assert torch.equal(off[k], on[k]), k

    @pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-moe-16b"])
    def test_generate(self, arch):
        cfg = _cfg(arch, "none")
        off = _generate(cfg, traced=False)
        on = _generate(cfg, traced=True)
        np.testing.assert_array_equal(off.tokens, on.tokens)
        assert torch.equal(off.logits, on.logits)


class TestSpans:
    def test_olmo_step_under_remat_full(self, chunked):
        cfg = _cfg("olmo-1b", "full")
        _train(cfg, traced=True)
        recs = card.read()
        L = cfg.n_layers
        assert Counter((r.name, r.phase, r.parent) for r in recs) == Counter({
            ("train.step", "forward", None): 1,
            ("train.forward", "forward", "train.step"): 1,
            ("train.backward", "forward", "train.step"): 1,
            ("train.optimizer", "forward", "train.step"): 1,
            ("attn", "forward", "train.forward"): L,
            ("attn.core", "forward", "attn"): L,
            ("attn", "recompute", "train.backward"): L,
            ("attn.core", "recompute", "attn"): L,
            ("attn", "backward", "train.backward"): L,
            ("attn.core", "backward", "attn"): L})
        assert {r.unit for r in recs} == {0}
        assert all(r.host_end >= r.host_start for r in recs)
        assert all(r.device_start is None for r in recs)

    def test_backward_halves_nest_and_follow_the_forward(self):
        cfg = _cfg("olmo-1b", "none")
        _train(cfg, traced=True)
        recs = card.read()
        (bw,) = [r for r in recs if r.name == "train.backward"]
        fw = [r for r in recs if r.phase == "forward" and r.name == "attn"]
        halves = [r for r in recs if r.phase == "backward"]
        assert halves and all(
            bw.host_start <= r.host_start <= r.host_end <= bw.host_end
            for r in halves)
        attn = [r for r in halves if r.name == "attn"]
        assert len(attn) == len(fw) == cfg.n_layers
        for a in attn:
            core = [r for r in halves if r.name == "attn.core"
                    and a.host_start <= r.host_start <= a.host_end]
            assert len(core) == 1 and core[0].host_end <= a.host_end

    def test_moe_step_names_and_passes(self):
        cfg = _cfg("deepseek-moe-16b", "full", capacity_factor=1.25)
        _train(cfg, traced=True)
        recs = card.read()
        moe_layers = sum(M.moe_layer_pattern(cfg, i)
                         for i in range(cfg.n_layers))
        got = Counter((r.name, r.phase) for r in recs
                      if r.name in MODEL_SPANS)
        for name in ("moe.router", "moe.dispatch", "moe.combine"):
            for phase in ("forward", "recompute", "backward"):
                assert got[name, phase] == moe_layers, (name, phase)
        # the routed experts and the shared ones
        for phase in ("forward", "recompute", "backward"):
            assert got["moe.experts", phase] == 2 * moe_layers
        # the first layer is dense and outside the checkpointed periods
        assert got["attn", "forward"] == got["attn", "backward"] \
            == cfg.n_layers
        assert got["attn", "recompute"] == cfg.n_layers - 1

    def test_generate_units_and_steps(self):
        cfg = _cfg("olmo-1b", "none")
        _generate(cfg, traced=True, new=6)
        recs = card.read()
        got = Counter((r.name, r.parent) for r in recs)
        assert got["serve.generate", None] == 1
        assert got["serve.prefill", "serve.generate"] == 1
        assert got["serve.sample", "serve.generate"] == 6
        assert got["serve.decode_step", "serve.generate"] == 5
        assert got["attn", "serve.prefill"] == cfg.n_layers
        assert got["attn", "serve.decode_step"] == 5 * cfg.n_layers
        assert got["attn.core", "attn"] == 6 * cfg.n_layers
        assert {r.phase for r in recs} == {"forward"}

    def test_a_unit_numbers_its_records(self):
        cfg = _cfg("olmo-1b", "none")
        _train(cfg, traced=True, steps=2)
        recs = card.read()
        steps = [r for r in recs if r.name == "train.step"]
        assert [r.unit for r in steps] == [0, 1]
        for s in steps:
            inside = [r for r in recs
                      if s.host_start <= r.host_start <= s.host_end]
            assert {r.unit for r in inside} == {s.unit}


class TestMoECounters:
    @pytest.mark.parametrize("group", [None, 8], ids=["one-group", "rows"])
    def test_counters_equal_a_plain_rerouting(self, monkeypatch, group):
        if group:
            monkeypatch.setattr(M, "GROUP", group)
        cfg = _cfg("deepseek-moe-16b", capacity_factor=0.5)
        torch.manual_seed(0)
        layer = M.MoE(cfg, "cpu")
        for prm in layer.parameters():
            torch.nn.init.normal_(prm, std=0.5)
        x = torch.randn(3, 40, cfg.d_model)
        with profile(activities=[ProfilerActivity.CPU]):
            M.moe_ffn(layer, cfg, x)
        (rec,) = [r for r in card.read() if r.name == "moe.dispatch"]
        e = cfg.moe
        rows = x if group else x.reshape(1, -1, cfg.d_model)
        B, S = rows.shape[:2]
        C = M.capacity(cfg, S)
        logits = L.linear(layer.router, rows, torch.float32)
        idx = M.top_k(torch.softmax(logits, dim=-1), e.top_k)[1]
        per_expert = torch.stack([(idx == k).sum(dim=(1, 2))
                                  for k in range(e.n_experts)], 1)
        kept = int(torch.clamp(per_expert, max=C).sum())
        assert rec.counters == {"routed": B * S * e.top_k,
                                "slots": B * e.n_experts * C, "kept": kept}
        assert rec.counters["routed"] - kept > 0          # pairs dropped

    def test_counters_wait_for_the_read(self):
        cfg = _cfg("deepseek-moe-16b", capacity_factor=1.25)
        layer = M.MoE(cfg, "cpu")
        with profile(activities=[ProfilerActivity.CPU]):
            M.moe_ffn(layer, cfg, torch.randn(2, 8, cfg.d_model))
        (rec,) = [r for r in card._STORE.records if r.name == "moe.dispatch"]
        assert isinstance(rec.counters["kept"], torch.Tensor)
        card.read()
        assert isinstance(rec.counters["kept"], int)


class TestProfile:
    def test_ranges_are_host_events_without_annotations(self, chunked):
        cfg = _cfg("deepseek-moe-16b", "full", capacity_factor=1.25)
        *_, prof = _train(cfg, traced=True)
        kinds = Counter()
        names = Counter()
        for e in prof.profiler.kineto_results.events():
            kinds[e.activity_type()] += 1
            names[e.name()] += 1
        assert kinds["user_annotation"] == 0 and kinds["gpu_user_annotation"] \
            == 0
        for e in prof.profiler.kineto_results.events():
            if e.name() in MODEL_SPANS or e.name().startswith("train."):
                assert e.activity_type() == "cpu_op"
        ranged = Counter(r.name for r in card.read()
                         if r.phase != "backward")
        assert ranged and all(names[n] == c for n, c in ranged.items())


class TestBound:
    def test_records_stop_at_the_bound(self, monkeypatch):
        monkeypatch.setattr(card, "MAX_RECORDS", 7)
        _train(_cfg("deepseek-moe-16b", capacity_factor=1.25), traced=True)
        assert len(card.read()) == 7 and card.dropped() > 0
        card.clear()
        assert card.read() == [] and card.dropped() == 0


def _rec(name, start, end, unit=0, phase="forward"):
    return card.Record(name, None, unit, phase, 0, 0, start, end)


class TestExclusive:
    def test_nested_spans_give_each_instant_once(self):
        recs = [_rec("train.step", 0, 100), _rec("attn", 10, 50),
                _rec("attn.core", 20, 30), _rec("attn", 60, 70)]
        assert card.exclusive_ns(recs) == {"train.step": 50, "attn": 40,
                                           "attn.core": 10}

    def test_overlapping_spans_go_to_the_latest_start(self):
        # a backward half that outlives the span opened inside it
        recs = [_rec("train.step", 0, 100), _rec("moe.combine", 10, 60,
                                                 phase="backward"),
                _rec("moe.experts", 40, 80, phase="backward")]
        assert card.exclusive_ns(recs) == {"train.step": 30,
                                           "moe.combine": 30,
                                           "moe.experts": 40}

    def test_equal_starts_go_to_the_later_record(self):
        recs = [_rec("serve.generate", 0, 10), _rec("serve.decode_step", 0,
                                                    10)]
        assert card.exclusive_ns(recs) == {"serve.decode_step": 10}

    def test_units_are_timelines_of_their_own(self):
        recs = [_rec("train.step", 0, 10, unit=0), _rec("attn", 2, 4, 0),
                _rec("train.step", 0, 10, unit=1), _rec("attn", 0, 10, 1),
                _rec("attn", 1, 2, unit=None), _rec("x", 5, None, unit=1)]
        recs[-1].device_start = None
        assert card.exclusive_ns(recs) == {"train.step": 8, "attn": 13}
