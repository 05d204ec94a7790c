"""The port's token pipeline on the CPU against the JAX package's:
``TokenPipeline`` batches bit-equal for several steps, seeds, shapes and
both generators (the plain uniform here, bit-exact with the CUDA kernel on
the card), the host slice by rank, determinism, and the guards."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import load_config as jax_load_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline  # noqa: E402
from repro_torch.configs import load_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels import prng  # noqa: E402


def _pipes(arch, B, T, seed, kind):
    jp = JaxTokenPipeline(jax_load_config(arch, "smoke"),
                          JaxShapeConfig("t", T, B, "train"),
                          JaxPipelineConfig(seed=seed, kind=kind))
    tp = TokenPipeline(load_config(arch, "smoke"), ShapeConfig("t", T, B,
                                                               "train"),
                       PipelineConfig(seed=seed, kind=kind), device="cpu")
    return jp, tp


@pytest.mark.parametrize("arch,B,T,seed,kind", [
    ("olmo-1b", 8, 128, 1, "xoshiro128p"),
    ("olmo-1b", 4, 2048, 1, "xoshiro128p"),     # the full-width phase's shape
    ("olmo-1b", 3, 33, 2 ** 31 - 1, "xoshiro128p"),
    ("gemma-2b", 2, 64, 7, "lcg"),
    ("olmo-1b", 1, 17, 0, "lcg")])
def test_batches_bit_equal_to_jax(arch, B, T, seed, kind):
    jp, tp = _pipes(arch, B, T, seed, kind)
    for step in (0, 1, 2, 5, 1000, 2 ** 20 + 3):
        want = np.asarray(jp.global_batch_at(step)["tokens"])
        got = tp.global_batch_at(step)["tokens"]
        assert got.dtype == torch.int32 and tuple(got.shape) == (B, T)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{step}")
        np.testing.assert_array_equal(tp.host_batch_at(step)["tokens"],
                                      np.asarray(jp.host_batch_at(step)[
                                          "tokens"]))


def test_step_seeds_match_jax():
    jp, tp = _pipes("olmo-1b", 2, 8, 1234, "xoshiro128p")
    for step in (0, 1, 3, 2 ** 31, 2 ** 40 + 1):
        assert tp._step_seed(step) == jp._step_seed(step)


def test_two_uniform_draws_a_step(monkeypatch):
    calls = []
    real = tpipe.kops.uniform

    def spy(seed, shape, **kw):
        calls.append((seed, shape))
        return real(seed, shape, **kw)
    monkeypatch.setattr(tpipe.kops, "uniform", spy)
    _, tp = _pipes("olmo-1b", 4, 16, 5, "xoshiro128p")
    tp.global_batch_at(3)
    s = tp._step_seed(3)
    assert calls == [(s, (4, 17)), (s ^ 0x1b873593, (4, 17))]


def test_sticky_stream_structure():
    """Position 0 is always a fresh draw; about 90 % of the rest repeat
    their left neighbour; every token is inside the vocabulary."""
    _, tp = _pipes("olmo-1b", 8, 512, 3, "xoshiro128p")
    tok = tp.global_batch_at(0)["tokens"]
    assert int(tok.min()) >= 0 and int(tok.max()) < 503
    repeats = (tok[:, 1:] == tok[:, :-1]).float().mean().item()
    assert 0.85 < repeats < 0.95
    u = prng.uniform_plain(tp._step_seed(0), 8 * 513, "xoshiro128p")
    fresh = torch.clamp((u.reshape(8, 513) * 503).to(torch.int32), max=502)
    assert torch.equal(tok[:, 0], fresh[:, 0])


def test_deterministic_and_steps_differ():
    _, a = _pipes("olmo-1b", 2, 32, 9, "xoshiro128p")
    _, b = _pipes("olmo-1b", 2, 32, 9, "xoshiro128p")
    assert torch.equal(a.global_batch_at(4)["tokens"],
                       b.global_batch_at(4)["tokens"])
    assert not torch.equal(a.global_batch_at(4)["tokens"],
                           a.global_batch_at(5)["tokens"])


def test_host_slice_by_rank(monkeypatch):
    monkeypatch.setattr(tpipe, "_process_count_and_index", lambda: (2, 1))
    _, tp = _pipes("olmo-1b", 4, 8, 1, "xoshiro128p")
    assert (tp.n_hosts, tp.host, tp.host_batch) == (2, 1, 2)
    full = tp.global_batch_at(0)["tokens"]
    assert torch.equal(tp.host_batch_at(0)["tokens"], full[2:4])


def test_one_process_without_torch_distributed():
    assert tpipe._process_count_and_index() == (1, 0)


def test_batch_must_split_over_processes(monkeypatch):
    monkeypatch.setattr(tpipe, "_process_count_and_index", lambda: (2, 0))
    with pytest.raises(ValueError, match="does not split"):
        _pipes("olmo-1b", 3, 8, 1, "xoshiro128p")


@pytest.mark.parametrize("B,T,seed,kind", [(2, 16, 1, "xoshiro128p"),
                                            (3, 33, 2 ** 31 - 1, "lcg")])
def test_audio_batches_bit_equal_to_jax(B, T, seed, kind):
    """hubert: frame embeddings from a third uniform draw, (u·2 − 1) in
    bf16, and the token stream as per-frame labels."""
    jp, tp = _pipes("hubert-xlarge", B, T, seed, kind)
    for step in (0, 3):
        want = jp.global_batch_at(step)
        got = tp.global_batch_at(step)
        assert set(got) == set(want) == {"embeds", "labels"}
        assert got["embeds"].dtype == torch.bfloat16
        assert tuple(got["embeds"].shape) == want["embeds"].shape == (
            B, T, tp.cfg.d_model)
        np.testing.assert_array_equal(
            got["embeds"].view(torch.int16).numpy(),
            np.asarray(want["embeds"]).view(np.int16))
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      np.asarray(want["labels"]))
    assert float(got["embeds"].float().min()) >= -1.0


def test_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TokenPipeline(load_config("olmo-1b", "smoke"),
                      ShapeConfig("t", 8, 2, "train"))
