"""The port's model stack on the CPU against the JAX package: layers,
chunked attention, the whole forward pass and cached prefill + decode for
every decoder config (dense, MoE, Mamba hybrid, RWKV-6), the audio
encoder's forward pass from frame embeddings, and the full-size parameter
trees, on smoke configs in fp32 with the JAX package's own parameters
carried over by ``repro_torch.convert.params_from_jax``.  Tolerances: rtol 1e-5 / atol 1e-6
for one attention call, rtol 1e-4 / atol 1e-4 for whole-model logits, whose
fp32 sums run in another order in the two frameworks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import load_config as jax_load_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.models.model import init_params as jax_init_params  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import load_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.model import forward, init_params  # noqa: E402
from repro_torch.serve import engine as tengine  # noqa: E402

ARCHS = ["olmo-1b", "gemma-2b", "phi3-mini-3.8b", "qwen3-32b",
         "qwen2-vl-72b", "deepseek-moe-16b", "grok-1-314b", "jamba-v0.1-52b",
         "rwkv6-1.6b"]


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    """(jax cfg, jax params, port cfg, port params) for one smoke arch."""
    name = request.param
    jcfg = jax_load_config(name, "smoke")
    jparams = jax.jit(lambda k: jax_init_params(jcfg, k))(
        jax.random.PRNGKey(1))
    cfg = load_config(name, "smoke")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _close(got, want, rtol=1e-4, atol=1e-4, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


class TestLayers:
    @pytest.mark.parametrize("kind", ["nonparam_ln", "layernorm", "rmsnorm",
                                      "gemma_rmsnorm"])
    def test_norms(self, kind):
        rng = np.random.default_rng(2)
        x = rng.normal(1, 3, (2, 5, 32)).astype(np.float32)
        g = rng.normal(1, 0.1, 32).astype(np.float32)
        b = rng.normal(0, 0.1, 32).astype(np.float32)
        jp = {"nonparam_ln": {}, "layernorm": {"g": g, "b": b}}.get(
            kind, {"g": g})
        p = tlayers.Norm(kind, 32, "cpu")
        if p.g is not None:
            p.g.data.copy_(torch.from_numpy(g))
        if p.b is not None:
            p.b.data.copy_(torch.from_numpy(b))
        _close(tlayers.norm(kind, p, torch.from_numpy(x)),
               jlayers.norm(kind, jp, jnp.asarray(x)), 1e-5, 1e-6)

    def test_rope_and_mrope(self):
        rng = np.random.default_rng(3)
        x = rng.normal(0, 1, (2, 6, 3, 16)).astype(np.float32)
        pos = rng.integers(0, 50, (3, 2, 6)).astype(np.int32)
        _close(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                                  1e4),
               jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), 1e4),
               1e-5, 1e-5)
        _close(tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                                   1e4, (4, 2, 2)),
               jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e4,
                                   (4, 2, 2)), 1e-5, 1e-5)


class TestChunkedAttention:
    @pytest.mark.parametrize("window,valid", [(0, None), (24, None), (0, 40)])
    def test_matches_jax(self, monkeypatch, window, valid):
        for mod in (jattn, tattn):
            monkeypatch.setattr(mod, "KV_CHUNK", 16)
            monkeypatch.setattr(mod, "Q_BLOCK", 16)
        jcfg = jax_load_config("olmo-1b", "smoke").replace(
            sliding_window=window)
        cfg = load_config("olmo-1b", "smoke").replace(sliding_window=window)
        rng = np.random.default_rng(window + 1)
        q = rng.normal(0, 1, (2, 64, 2, 2, 16)).astype(np.float32)
        k = rng.normal(0, 1, (2, 64, 2, 16)).astype(np.float32)
        v = rng.normal(0, 1, (2, 64, 2, 16)).astype(np.float32)
        want = jattn._chunked_attention(jcfg, jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), 0, valid)
        got = tattn._chunked_attention(cfg, torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), 0, valid)
        _close(got, want, 1e-5, 1e-6)

    def test_init_kv_cache_matches_jax(self):
        cfg = load_config("gemma-2b", "smoke")
        want = jattn.init_kv_cache(jax_load_config("gemma-2b", "smoke"),
                                   batch=2, max_len=24, n_attn_layers=3)
        got = tattn.init_kv_cache(cfg, batch=2, max_len=24, n_attn_layers=3,
                                  device="cpu")
        for name in ("k", "v"):
            assert tuple(got[name].shape) == want[name].shape
            assert str(got[name].dtype) == f"torch.{want[name].dtype}"
            assert not got[name].any()


class TestForward:
    @pytest.mark.parametrize("mode", ["all", "last", "hidden"])
    def test_logits_match_jax(self, both, mode):
        jcfg, jparams, cfg, params = both
        toks = _tokens(cfg, 2, 24)
        want, _, want_aux = jax.jit(lambda p, b: jax_forward(
            p, jcfg, b, logits_mode=mode))(jparams,
                                           {"tokens": jnp.asarray(toks)})
        got, _, aux = forward(params, cfg, {"tokens": torch.from_numpy(toks)},
                              logits_mode=mode)
        assert tuple(got.shape) == want.shape
        assert (float(aux) == 0.0) == (cfg.moe is None)
        _close(got, want)
        _close(aux, want_aux, 1e-5, 1e-7)

    @pytest.mark.parametrize("mode", ["all", "hidden"])
    def test_audio_encoder_matches_jax(self, mode):
        """hubert: frame embeddings replace the token embedding; no causal
        mask, no rotary embedding, a per-frame head."""
        jcfg = jax_load_config("hubert-xlarge", "smoke")
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
        cfg = load_config("hubert-xlarge", "smoke")
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 "cpu")
        e = np.random.default_rng(3).uniform(-1, 1, (2, 24, cfg.d_model))
        e = e.astype(np.float32)
        want, _, _ = jax_forward(jparams, jcfg, {"embeds": jnp.asarray(e)},
                                 logits_mode=mode)
        got, _, aux = forward(params, cfg, {"embeds": torch.from_numpy(e)},
                              logits_mode=mode)
        assert tuple(got.shape) == want.shape and float(aux) == 0.0
        _close(got, want)


def _prefill_decode_pair(jcfg, jparams, cfg, params, B, T, plen, max_len):
    """Logits of prefill then one decode step per token, teacher-forced,
    from both packages."""
    toks = _tokens(cfg, B, T, seed=7)
    jcache = jengine.make_cache(jcfg, B, max_len)
    jl, jcache = jax.jit(jengine.make_prefill(jcfg))(
        jparams, jcache, jnp.asarray(toks[:, :plen]))
    cache = tengine.make_cache(cfg, B, max_len, "cpu")
    tl, cache = tengine.make_prefill(cfg)(
        params, cache, torch.from_numpy(toks[:, :plen]))
    pairs = [(tl, jl)]
    jstep = jax.jit(jengine.make_serve_step(jcfg))
    tstep = tengine.make_serve_step(cfg)
    for t in range(plen, T):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t))
        tl, cache = tstep(params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        pairs.append((tl, jl))
    return pairs


class TestDecode:
    def test_prefill_plus_decode_matches_jax(self, both):
        jcfg, jparams, cfg, params = both
        pairs = _prefill_decode_pair(jcfg, jparams, cfg, params, B=2, T=20,
                                     plen=8, max_len=24)
        for i, (got, want) in enumerate(pairs):
            _close(got, want, msg=f"step {i}")

    def test_chunked_prefill_with_cache_matches_jax(self, monkeypatch):
        """Lowered thresholds send the prefill down the chunked path, with
        the cache's unwritten slots masked by ``valid_limit``."""
        for mod in (jattn, tattn):
            monkeypatch.setattr(mod, "CHUNKED_THRESHOLD", 256)
            monkeypatch.setattr(mod, "KV_CHUNK", 16)
            monkeypatch.setattr(mod, "Q_BLOCK", 16)
        jcfg = jax_load_config("olmo-1b", "smoke")
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
        cfg = load_config("olmo-1b", "smoke")
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
        pairs = _prefill_decode_pair(jcfg, jparams, cfg, params, B=1, T=36,
                                     plen=32, max_len=48)
        for i, (got, want) in enumerate(pairs):
            _close(got, want, msg=f"step {i}")


class TestInit:
    def test_storage_dtypes_scales_and_determinism(self):
        cfg = load_config("olmo-1b", "smoke").replace(dtype="bfloat16")
        a = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        b = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        for (name, p), (_, q) in zip(a.named_parameters(),
                                     b.named_parameters()):
            assert torch.equal(p, q), name
            assert p.dtype == (torch.bfloat16 if p.ndim >= 2
                               else torch.float32), name
            assert not p.requires_grad
        w = a.stack.periods[0]["sub0"].ffn.down.w.float()
        assert float(w.abs().max()) <= 2 * cfg.d_ff ** -0.5 * 1.01
        assert abs(float(w.std()) / cfg.d_ff ** -0.5 - 0.88) < 0.05

    @staticmethod
    def _trees(jcfg, cfg):
        """(the JAX tree's shapes by port name, the port's shapes), traced
        abstractly on both sides."""
        from repro_torch.convert import state_dict_from_jax
        from repro_torch.models.model import LMModel
        jtree = jax.eval_shape(lambda: jax_init_params(
            jcfg, jax.random.PRNGKey(0)))
        zeros = jax.tree.map(  # zero-stride arrays: no memory
            lambda s: np.broadcast_to(np.float32(0), s.shape), jtree)
        jshapes = {k: v.shape for k, v in state_dict_from_jax(zeros).items()}
        model = LMModel(cfg, "meta")
        return jshapes, {k: tuple(p.shape) for k, p in
                         model.named_parameters()}

    def test_full_olmo_parameters_match_jax_tree(self):
        """Same names (periods unstacked) and sizes as the JAX package's
        full OLMo-1B tree."""
        jshapes, shapes = self._trees(jax_load_config("olmo-1b", "full"),
                                      load_config("olmo-1b", "full"))
        assert shapes == jshapes
        assert sum(map(np.prod, shapes.values())) == 1_176_764_416

    @pytest.mark.parametrize("arch,n_layers,count", [
        ("deepseek-moe-16b", None, 16_375_728_128),
        ("jamba-v0.1-52b", 8, 13_295_235_072),     # one period of eight
        ("rwkv6-1.6b", None, 1_584_140_288),
        ("hubert-xlarge", None, 945_256_960)])
    def test_full_parameters_match_jax_tree(self, arch, n_layers, count):
        """The new families at full width: the expert banks, the stacked
        periods of 2-D and 3-D leaves, the SSM parameters; Jamba cut to one
        period of eight layers as the card runs it."""
        jcfg, cfg = jax_load_config(arch, "full"), load_config(arch, "full")
        if n_layers:
            kw = dict(n_layers=n_layers, layer_types="mmmmammm")
            jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
        jshapes, shapes = self._trees(jcfg, cfg)
        assert shapes == jshapes
        assert sum(map(np.prod, shapes.values())) == count

    def test_cuda_default_raises_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        cfg = load_config("olmo-1b", "smoke")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(cfg, torch.Generator())
