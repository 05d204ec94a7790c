"""The serve and train drivers and the reference, on smoke-size cells on
the CPU: a sound run is correct; the same run with the timed path broken
underneath, and the reference at a lower precision in the program's
place (the control), are not."""

import numpy as np
import pytest

from bench import harness
from bench.reference import check
from bench.tests import smoke


def measure(ctx, setup_kw=None, before_window=None):
    run = harness.driver(ctx.traffic["kind"]).Run(ctx)
    run.setup(**(setup_kw or {}))
    if before_window:
        before_window(run)
    result, lines = harness.measure(smoke.benchmark_for(ctx), ctx, run, 0.0,
                                    traced=False)
    return result, run


@pytest.mark.parametrize("arch,traffic,moe,limits", [
    ("olmo-1b", smoke.train_traffic(), {}, None),
    ("deepseek-moe-16b", smoke.train_traffic(), {"capacity_factor": 1.0},
     None),
    # more tokens than a group: each row routes alone, pairs drop
    ("deepseek-moe-16b", smoke.train_traffic(batch=2, seq=2064),
     {"capacity_factor": 1.0}, None),
    ("olmo-1b", smoke.serve_traffic(), {}, None),
    ("olmo-1b", smoke.serve_traffic(temperature=0.0), {}, None),
    ("deepseek-moe-16b", smoke.serve_traffic(batch=3, prompt=1400, new=1,
                                             temperature=0.0),
     {"capacity_factor": 1.0}, "prefill"),
    ("deepseek-moe-16b", smoke.serve_traffic(batch=3, prompt=1400, new=1,
                                             temperature=0.0),
     {"capacity_factor": 1.0}, "moe_prefill"),
], ids=["olmo-train", "moe-train", "moe-train-rows", "olmo-sampled",
        "olmo-greedy", "moe-prefill-rows", "moe-prefill-followed"])
def test_a_sound_run_is_correct(arch, traffic, moe, limits):
    ctx = smoke.context(arch, traffic, limits=limits, **moe)
    result, _ = measure(ctx)
    assert result["correct"], result["check"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_a_broken_step_is_not_correct(fault):
    ctx = smoke.context("olmo-1b", smoke.train_traffic(batch=4))
    result, _ = measure(ctx, {"fault": fault})
    assert not result["correct"], result["check"]


def _alter_token(run):
    """The engine serves another token than it sampled, slot 0, step 2."""
    engine = run.engine
    sample = engine._sample

    def altered(logits, step, seeds):
        tok = sample(logits, step, seeds)
        if step == 2:
            tok = tok.clone()
            tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    engine._sample = altered


def _half_the_rows(run):
    """The engine answers the second half of its rows with the first
    half's tokens and logits."""
    engine = run.engine
    generate = engine.generate

    def half(prompts, n):
        res = generate(prompts, n)
        b = res.tokens.shape[0] // 2
        res.tokens[b:2 * b, prompts.shape[1]:] = res.tokens[:b,
                                                            prompts.shape[1]:]
        res.logits[b:2 * b] = res.logits[:b]
        return res
    engine.generate = half


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("fault", [_alter_token, _half_the_rows],
                         ids=["token_altered", "half_the_rows"])
def test_a_broken_call_is_not_correct(fault, temperature):
    ctx = smoke.context("olmo-1b", smoke.serve_traffic(
        temperature=temperature), requests=4)
    result, _ = measure(ctx, before_window=fault)
    assert not result["correct"], result["check"]


def test_a_broken_prefill_is_not_correct():
    """A cell that compares the returned logits: rows left out show."""
    ctx = smoke.context("olmo-1b", smoke.serve_traffic(new=1, temperature=0),
                        requests=4, limits="prefill")
    result, _ = measure(ctx)
    assert result["correct"], result["check"]
    ctx = smoke.context("olmo-1b", smoke.serve_traffic(new=1, temperature=0),
                        requests=4, limits="prefill")
    result, _ = measure(ctx, before_window=_half_the_rows)
    assert not result["correct"], result["check"]


def test_the_control_is_not_correct():
    """The reference in bf16 (the precision below the smoke configs' fp32)
    in the program's place fails the limits that the program meets."""
    ctx = smoke.context("olmo-1b", smoke.train_traffic(batch=4))
    run = harness.driver("train").Run(ctx)
    run.setup()
    numbers = run.check(control="bf16")
    low = {k.split(".", 1)[1]: v for k, v in numbers.items()
           if k.startswith("control.")}
    assert check.verdict(numbers, smoke.LIMITS["train"])[0]
    assert not check.verdict(low, smoke.LIMITS["train"])[0], low

    ctx = smoke.context("olmo-1b", smoke.serve_traffic(batch=8, new=16),
                        requests=8)
    run = harness.driver("serve").Run(ctx)
    run.setup()
    ctx.units.append(run.unit())
    run.after_window()
    run.free()
    numbers = run.check(control="bf16")
    assert numbers["served_gap"] <= smoke.LIMITS["serve"]["served_gap"]
    assert numbers["control_gap"] > smoke.LIMITS["serve"]["served_gap"]

    ctx = smoke.context("olmo-1b", smoke.serve_traffic(new=1, temperature=0),
                        requests=4, limits="prefill")
    run = harness.driver("serve").Run(ctx)
    run.setup()
    ctx.units.append(run.unit())
    run.after_window()
    run.free()
    numbers = run.check(control="bf16")
    limit = smoke.LIMITS["prefill"]["logit_error"]
    assert numbers["logit_error"] <= limit < numbers["control_logit_error"]


def test_the_followed_routes_and_their_control():
    """The reference follows the program's expert choices: a sound run
    reads no routing gap and the logits agree; the bf16 control, followed
    the same way, fails."""
    ctx = smoke.context("deepseek-moe-16b", smoke.serve_traffic(
        batch=3, prompt=1400, new=1, temperature=0.0), requests=3,
        limits="moe_prefill", capacity_factor=1.0)
    run = harness.driver("serve").Run(ctx)
    run.setup()
    ctx.units.append(run.unit())
    run.after_window()
    run.free()
    from repro_torch.models import moe
    assert moe.top_k.__name__ == "top_k"          # restored after the rerun
    numbers = run.check(control="bf16")
    assert numbers["routing_gap"] == 0.0
    assert numbers["rerun_mismatch"] == 0.0
    assert numbers["logit_error"] <= 1e-4
    assert numbers["control_logit_error"] > 1e-4


def test_served_gap_reads_the_served_token():
    ref = np.array([[0.0, 3.0, 1.0], [2.0, 0.5, 0.0]], dtype=np.float32)
    import torch
    t = torch.as_tensor(ref)
    assert check.served_gap(t, torch.tensor([1, 0])) == 0.0
    assert check.served_gap(t, torch.tensor([2, 0])) == 2.0


def test_leaf_gap_takes_the_median_leaf_as_floor():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-6}
    prog = {"a": 1.0, "b": 2.0, "c": 2e-6}
    # c's gap 1e-6 against the median leaf's norm 1.0
    assert check.leaf_gap(prog, ref) == pytest.approx(1e-6)
    assert check.still_leaves({"a": 1.0, "b": 1.0, "c": 1e-4}) == {"c"}


def _moe_prefill_context():
    return smoke.context("deepseek-moe-16b", smoke.serve_traffic(
        batch=3, prompt=1400, new=1, temperature=0.0), requests=3,
        limits="moe_prefill", capacity_factor=1.0)


def test_the_timed_calls_run_the_programs_own_routing():
    """The window's calls run ``moe.top_k`` as the program has it; only
    the rerun after the window records the expert choices."""
    from repro_torch.models import moe
    ctx = _moe_prefill_context()
    run = harness.driver("serve").Run(ctx)
    run.setup()
    seen = []
    generate = run.engine.generate

    def watched(prompts, n):
        seen.append(moe.top_k.__name__)
        return generate(prompts, n)
    run.engine.generate = watched
    ctx.units.append(run.unit())
    assert seen == ["top_k"]
    run.after_window()
    assert seen == ["top_k", "recording"]
    assert len(run.routes[0]) == sum(ctx.model.is_moe(i)
                                     for i in range(ctx.model.n_layers))
    assert moe.top_k.__name__ == "top_k"


def test_a_rerun_that_serves_other_tokens_is_not_correct():
    """Where the call run again to record the routes serves another token
    than the window did, ``rerun_mismatch`` counts it and the run fails."""
    ctx = _moe_prefill_context()
    run = harness.driver("serve").Run(ctx)
    run.setup()
    generate = run.engine.generate

    def other_in_window(prompts, n):
        res = generate(prompts, n)
        if len(ctx.units) == 0:
            res.tokens[0, -1] = (res.tokens[0, -1] + 1) % ctx.model.vocab_size
        return res
    run.engine.generate = other_in_window
    result, _ = harness.measure(smoke.benchmark_for(ctx), ctx, run, 0.0,
                                traced=False)
    assert result["check"]["rerun_mismatch"]["value"] == 1.0
    assert not result["correct"]


def test_a_recording_that_misses_layers_says_so():
    """A program that no longer calls ``moe.top_k`` once a mixture layer
    stops the run with a message, not with a misaligned check."""
    import dataclasses
    from repro_torch.models import moe
    ctx = _moe_prefill_context()
    run = harness.driver("serve").Run(ctx)
    run.setup()
    ctx.units.append(run.unit())
    # one mixture layer more than the program runs
    ctx.model = dataclasses.replace(ctx.model, n_layers=ctx.model.n_layers + 1)
    with pytest.raises(RuntimeError, match="mixture layers"):
        run.after_window()
    assert moe.top_k.__name__ == "top_k"
