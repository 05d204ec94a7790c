"""The readers of the program's card spans (``attention.share.*``,
``moe.dispatch_share.*``, ``moe.slot_fill.*``, ``train.optimizer_share``,
``engine.itl_p95_ms``) on hand-made records: exclusive attribution of
nested and overlapping spans, the shares, the p95, the traced window, and
None where a cell has no such span or the program no card spans."""

import sys
from types import SimpleNamespace

import pytest

from bench import harness, trace
from repro_torch import obs
from repro_torch.obs import card

TRAIN = ("attention.share.train", "moe.dispatch_share.train",
         "moe.slot_fill.train", "train.optimizer_share")
SERVE = ("attention.share.serve", "moe.dispatch_share.serve",
         "moe.slot_fill.serve", "engine.itl_p95_ms")
MS = 1_000_000


def rec(name, unit, start, end, host=1500, phase="forward", **counters):
    return card.Record(name, None, unit, phase, host, host + 1, start, end,
                       counters)


def ctx(kind, records, monkeypatch, window=(1000, 2000)):
    store = card._Store()
    store.records = records
    monkeypatch.setattr(card, "_STORE", store)
    return SimpleNamespace(traffic={"kind": kind}, trace=SimpleNamespace(
        window=trace.Span(trace.WINDOW, *window)))


def read(name, c):
    return harness.load_metric(name).read(c)


def train_records():
    """Two steps in the window and one after it; step 0 of 1,000 ns."""
    return [
        rec("data.batch", None, 0, 50, host=1050),
        rec("train.step", 0, 0, 1000),
        rec("train.forward", 0, 50, 450),
        rec("attn", 0, 100, 300),
        rec("attn.core", 0, 150, 250),
        rec("moe.dispatch", 0, 300, 350, routed=120, slots=150, kept=100),
        rec("moe.combine", 0, 350, 400),
        rec("train.backward", 0, 450, 800),
        # the recompute runs inside the backward half it serves
        rec("attn", 0, 500, 700, phase="backward"),
        rec("moe.dispatch", 0, 700, 700, phase="backward"),
        rec("attn", 0, 520, 560, phase="recompute"),
        rec("attn.core", 0, 530, 540, phase="recompute"),
        rec("moe.dispatch", 0, 560, 570, phase="recompute", routed=120,
            slots=150, kept=100),
        rec("train.optimizer", 0, 800, 1000),
        rec("train.step", 1, 0, 1000, host=1900),
        rec("attn", 1, 0, 1000, host=1901),
        rec("train.step", 2, 0, 1000, host=2500),
        rec("train.optimizer", 2, 0, 1000, host=2501),
    ]


def test_train_shares_attribute_each_instant_once(monkeypatch):
    c = ctx("train", train_records(), monkeypatch)
    # step 0: attn 100 + 100 core; the backward half 200 less the
    # recompute's 40 and the dispatch's 10; the recompute 30 + 10 core.
    # Step 1: attn whole.  Step 2 lies after the window.
    assert read("attention.share.train", c) == pytest.approx(
        100 * (390 + 1000) / 2000)
    assert read("moe.dispatch_share.train", c) == pytest.approx(
        100 * (50 + 50 + 10) / 2000)
    assert read("train.optimizer_share", c) == pytest.approx(100 * 200 / 2000)
    assert read("moe.slot_fill.train", c) == pytest.approx(100 * 200 / 300)


def test_overlapping_backward_halves_go_to_the_latest_start(monkeypatch):
    recs = [rec("train.step", 0, 0, 100),
            rec("moe.combine", 0, 10, 60, phase="backward"),
            rec("moe.dispatch", 0, 40, 80, phase="backward")]
    c = ctx("train", recs, monkeypatch)
    assert read("moe.dispatch_share.train", c) == pytest.approx(70)
    # a backward half has no counters: no slots were routed
    assert read("moe.slot_fill.train", c) is None


def test_the_serving_readers(monkeypatch):
    ends = [2, 3, 4.5, 5.5]
    recs = [rec("serve.generate", 0, 0, 10 * MS),
            rec("serve.prefill", 0, 0, 1 * MS),
            rec("attn", 0, int(0.2 * MS), int(0.8 * MS)),
            rec("moe.dispatch", 0, int(0.8 * MS), int(0.9 * MS), routed=60,
                slots=100, kept=55)]
    recs += [rec("serve.decode_step", 0, int((e - 0.9) * MS), int(e * MS))
             for e in ends]
    recs += [rec("attn", 0, int((e - 0.5) * MS), int((e - 0.1) * MS))
             for e in ends]
    c = ctx("serve", recs, monkeypatch)
    assert read("attention.share.serve", c) == pytest.approx(
        100 * (0.6 + 4 * 0.4) / 10)
    assert read("moe.dispatch_share.serve", c) == pytest.approx(1.0)
    assert read("moe.slot_fill.serve", c) == pytest.approx(55.0)
    assert read("engine.itl_p95_ms", c) == pytest.approx(1.45)


def test_none_where_a_cell_has_no_such_span(monkeypatch):
    recs = [rec("train.step", 0, 0, 1000), rec("attn", 0, 0, 10)]
    c = ctx("train", recs, monkeypatch)
    assert read("moe.dispatch_share.train", c) is None
    assert read("moe.slot_fill.train", c) is None
    assert read("train.optimizer_share", c) is None
    assert read("attention.share.train", c) == pytest.approx(1.0)
    for name in SERVE:             # a serving reader in a training cell
        assert read(name, c) is None
    c = ctx("serve", [rec("serve.generate", 0, 0, 10),
                      rec("serve.decode_step", 0, 0, 5)], monkeypatch)
    assert read("engine.itl_p95_ms", c) is None     # one step, no gap
    assert read("attention.share.serve", c) is None


def test_none_outside_the_window_and_without_a_trace(monkeypatch):
    c = ctx("train", train_records(), monkeypatch, window=(3000, 4000))
    for name in TRAIN:
        assert read(name, c) is None
    c.trace = None
    for name in TRAIN:
        assert read(name, c) is None


def test_none_from_a_program_without_card_spans(monkeypatch):
    c = ctx("train", train_records(), monkeypatch)
    monkeypatch.delattr(obs, "card")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.card", None)
    for name in TRAIN + SERVE:
        assert read(name, c) is None


def test_untimed_records_read_none(monkeypatch):
    """A CPU run makes no CUDA event: its records have no device times."""
    recs = [rec("train.step", 0, None, None), rec("attn", 0, None, None)]
    c = ctx("train", recs, monkeypatch)
    for name in TRAIN:
        assert read(name, c) is None
