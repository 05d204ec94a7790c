"""The port's MoE FFN (``repro_torch.models.moe``) on the CPU against the JAX
package's ``repro.models.moe``, with the JAX package's parameters carried
over: one dispatch group at capacity factor 1.25 (tokens dropped) and 8
(none dropped), shared experts, gated (swiglu, geglu) and ungated (gelu)
experts, the per-row path with ``GROUP`` lowered in both modules, the
auxiliary loss, the gradients against ``jax.grad``, the top-k order on ties
and the capacity arithmetic.

Tolerances: outputs and aux rtol 1e-5 / atol 1e-6, gradients rtol 1e-5 /
atol 1e-6 (fp32 sums in another order: the expert products and the sum over
the k choices).  Integer routing (top-k indices, capacity) is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import load_config as jax_load_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import load_config  # noqa: E402
from repro_torch.convert import state_dict_from_jax  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

# (arch, act override): deepseek has a shared expert and swiglu, grok geglu
# and no shared expert; gelu makes deepseek's experts ungated.
VARIANTS = [("deepseek-moe-16b", None), ("grok-1-314b", None),
            ("deepseek-moe-16b", "gelu")]
IDS = ["shared-swiglu", "geglu", "shared-ungated"]


def _cfgs(arch, act, cf):
    jcfg = jax_load_config(arch, "smoke")
    cfg = load_config(arch, "smoke")
    kw = {} if act is None else {"act": act}
    jcfg = jcfg.replace(moe=jcfg.moe.__class__(
        **dict(vars(jcfg.moe), capacity_factor=cf)), **kw)
    cfg = cfg.replace(moe=cfg.moe.__class__(
        **dict(vars(cfg.moe), capacity_factor=cf)), **kw)
    return jcfg, cfg


def _both(arch, act, cf, seed=0):
    """(jax cfg, jax params, port cfg, port MoE module)."""
    jcfg, cfg = _cfgs(arch, act, cf)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    sd = state_dict_from_jax(jax.tree.map(np.asarray, jp))
    m = tmoe.MoE(cfg, "cpu")
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                       sd.items()}, strict=True)
    return jcfg, jp, cfg, m


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _tokens(shape, seed=1):
    """Hidden states sharing one direction, so that the router favours some
    experts and a capacity of 1.25 × the mean load overflows; of unit
    scale, as the normed hidden states the FFN sees."""
    common = _x(shape[-1:], seed=seed + 100)
    return 0.5 * _x(shape, seed) + 0.8 * common


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(
        got, "detach") else got), np.asarray(want), rtol=rtol, atol=atol,
        err_msg=msg)


def _dropped(jcfg, jp, x):
    """How many (token, choice) pairs one group at ``jcfg``'s capacity
    drops, counted from the JAX router."""
    S = x.shape[0]
    C = int(np.ceil(S * jcfg.moe.top_k / jcfg.moe.n_experts
                    * jcfg.moe.capacity_factor))
    probs = jax.nn.softmax(x @ np.asarray(jp["router"]["w"]), axis=-1)
    _, idx = jax.lax.top_k(probs, jcfg.moe.top_k)
    counts = np.bincount(np.asarray(idx).ravel(),
                         minlength=jcfg.moe.n_experts)
    return int(np.maximum(counts - C, 0).sum())


class TestDispatchGroup:
    @pytest.mark.parametrize("cf", [1.25, 8.0])
    @pytest.mark.parametrize("arch,act", VARIANTS, ids=IDS)
    def test_matches_jax(self, arch, act, cf):
        jcfg, jp, cfg, m = _both(arch, act, cf)
        x = _tokens((48, cfg.d_model))
        dropped = _dropped(jcfg, jp, x)
        assert (dropped > 0) == (cf == 1.25), dropped
        want, want_aux = jax.jit(lambda p, xx: jmoe._dispatch_group(
            p, jcfg, xx))(jp, jnp.asarray(x))
        with torch.no_grad():
            got, aux = tmoe._dispatch_group(m, cfg, torch.from_numpy(x))
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got, want)
        _close(aux, want_aux)

    @pytest.mark.parametrize("arch,act", VARIANTS, ids=IDS)
    def test_gradients_match_jax(self, arch, act):
        """Gradients of <out, c> + aux for every parameter and the input,
        at capacity factor 1.25, where dropped slots must give 0.  The
        cotangent c is a unit normal over the token count, as a loss that
        is a mean over tokens gives, so the gradients are of order 1."""
        jcfg, jp, cfg, m = _both(arch, act, 1.25, seed=2)
        x = _tokens((48, cfg.d_model), seed=3)
        c = _x((48, cfg.d_model), seed=4) / 48

        def jloss(p, xx):
            out, aux = jmoe._dispatch_group(p, jcfg, xx)
            return jnp.sum(out * c) + aux

        jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jp, jnp.asarray(x))
        names, params = zip(*m.named_parameters())
        xt = torch.from_numpy(x).requires_grad_(True)
        for p in params:
            p.requires_grad_(True)
        out, aux = tmoe._dispatch_group(m, cfg, xt)
        loss = (out * torch.from_numpy(c)).sum() + aux
        *grads, gx = torch.autograd.grad(loss, (*params, xt))
        want = state_dict_from_jax(jax.tree.map(np.asarray, jg))
        assert set(names) == set(want)
        for name, g in zip(names, grads):
            _close(g, want[name], msg=name)
        _close(gx, jgx)


class TestMoeFfn:
    @pytest.mark.parametrize("group,B,T", [(4096, 2, 24), (16, 3, 32),
                                           (16, 4, 1)],
                             ids=["one-group", "per-row", "decode"])
    def test_matches_jax(self, monkeypatch, group, B, T):
        """GROUP 16 below B·T = 96 sends (3, 32) down the per-row path
        (capacity per row, aux the mean over rows); T = 1 always takes one
        group."""
        for mod in (jmoe, tmoe):
            monkeypatch.setattr(mod, "GROUP", group)
        jcfg, jp, cfg, m = _both("deepseek-moe-16b", None, 1.25, seed=5)
        x = _tokens((B, T, cfg.d_model), seed=6)
        want, want_aux = jax.jit(lambda p, xx: jmoe.moe_ffn(p, jcfg, xx))(
            jp, jnp.asarray(x))
        with torch.no_grad():
            got, aux = tmoe.moe_ffn(m, cfg, torch.from_numpy(x))
        _close(got, want)
        _close(aux, want_aux)

    def test_per_row_gradients_match_jax(self, monkeypatch):
        """The batched per-row dispatch (``_dispatch_rows``, JAX's vmap)
        under ``jax.grad``: every parameter's gradient and the input's, of
        <out, c> + aux at capacity factor 1.25 (drops in each row)."""
        for mod in (jmoe, tmoe):
            monkeypatch.setattr(mod, "GROUP", 16)
        jcfg, jp, cfg, m = _both("deepseek-moe-16b", None, 1.25, seed=2)
        x = _tokens((3, 32, cfg.d_model), seed=3)
        c = _x((3, 32, cfg.d_model), seed=4) / 96

        def jloss(p, xx):
            out, aux = jmoe.moe_ffn(p, jcfg, xx)
            return jnp.sum(out * c) + aux

        jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            jp, jnp.asarray(x))
        names, params = zip(*m.named_parameters())
        xt = torch.from_numpy(x).requires_grad_(True)
        for p in params:
            p.requires_grad_(True)
        out, aux = tmoe.moe_ffn(m, cfg, xt)
        loss = (out * torch.from_numpy(c)).sum() + aux
        *grads, gx = torch.autograd.grad(loss, (*params, xt))
        want = state_dict_from_jax(jax.tree.map(np.asarray, jg))
        for name, g in zip(names, grads):
            _close(g, want[name], msg=name)
        _close(gx, jgx)

    def test_per_row_dispatch_is_each_row_alone(self, monkeypatch):
        """Row b of the batched dispatch is ``_dispatch_group`` of row b,
        bit for bit, and the aux is the mean of the rows' (no Python loop
        over rows in ``moe_ffn``)."""
        monkeypatch.setattr(tmoe, "GROUP", 16)
        _, _, cfg, m = _both("deepseek-moe-16b", None, 1.25, seed=5)
        x = torch.from_numpy(_tokens((3, 32, cfg.d_model), seed=6))
        with torch.no_grad():
            out, aux = tmoe.moe_ffn(m, cfg, x)
            rows = [tmoe._dispatch_group(m, cfg, x[b]) for b in range(3)]
        for b, (o, _) in enumerate(rows):
            assert torch.equal(out[b], o), b
        assert torch.equal(aux, torch.stack([a for _, a in rows]).mean())

    def test_per_row_capacity_differs_from_one_group(self, monkeypatch):
        """The per-row path is a different function (capacity per row), not
        a tiling of the one-group path: at capacity factor 1.25 the two
        disagree, in both packages alike."""
        jcfg, jp, cfg, m = _both("deepseek-moe-16b", None, 1.25, seed=5)
        x = torch.from_numpy(_tokens((3, 32, cfg.d_model), seed=6))
        with torch.no_grad():
            one, _ = tmoe.moe_ffn(m, cfg, x)
            monkeypatch.setattr(tmoe, "GROUP", 16)
            rows, _ = tmoe.moe_ffn(m, cfg, x)
        assert not torch.allclose(one, rows)


class TestRouting:
    def test_top_k_order_on_ties_matches_lax(self):
        rng = np.random.default_rng(7)
        probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
        for k in (1, 2, 6):
            want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
            got_v, got_i = tmoe.top_k(torch.from_numpy(probs), k)
            np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))

    @pytest.mark.parametrize("arch", ["deepseek-moe-16b", "grok-1-314b",
                                      "jamba-v0.1-52b"])
    def test_capacity_matches_jax_arithmetic(self, arch):
        for variant in ("smoke", "full"):
            cfg = load_config(arch, variant)
            e = cfg.moe
            for cf in (1.0, 1.25, 1.1, 8.0):
                cfg = cfg.replace(moe=e.__class__(**dict(
                    vars(e), capacity_factor=cf)))
                for S in (1, 4, 7, 512, 4096, 7168):
                    want = int(np.ceil(S * e.top_k / e.n_experts * cf))
                    assert tmoe.capacity(cfg, S) == want

    def test_layer_pattern_matches_jax(self):
        for arch in ("deepseek-moe-16b", "grok-1-314b", "jamba-v0.1-52b",
                     "olmo-1b"):
            for variant in ("smoke", "full"):
                jcfg = jax_load_config(arch, variant)
                cfg = load_config(arch, variant)
                for i in range(cfg.n_layers):
                    assert tmoe.moe_layer_pattern(cfg, i) == \
                        jmoe.moe_layer_pattern(jcfg, i)

    def test_init_scales_and_dtype(self):
        cfg = load_config("deepseek-moe-16b", "smoke").replace(
            dtype="bfloat16")
        m = tmoe.MoE(cfg, "cpu")
        gen = torch.Generator().manual_seed(0)
        for mod in m.modules():
            if hasattr(mod, "init_"):
                mod.init_(gen)
        d, df = cfg.d_model, cfg.moe.d_expert
        assert tuple(m.experts.up.shape) == (cfg.moe.n_experts, d, df)
        assert tuple(m.shared.down.shape) == (cfg.moe.n_shared, df, d)
        for w, scale in ((m.experts.up, d ** -0.5),
                         (m.experts.down, df ** -0.5)):
            assert w.dtype == torch.bfloat16
            assert float(w.float().abs().max()) <= 2 * scale * 1.01
