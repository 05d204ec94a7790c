"""The port's state-space mixers (``repro_torch.models.ssm``) on the CPU
against the JAX package's ``repro.models.ssm``, with the JAX package's
parameters carried over: ``rwkv6_mix``, ``rwkv6_channel_mix`` and
``mamba_mix`` at T = 16 (one chunk) and T = 256 (two chunks of 128), from a
zero state and from a carried one; one call of T steps against T one-step
calls; gradients against ``jax.grad``; the chunked scan's refusal of a
ragged chunk count (JAX asserts); ``softplus`` against ``jax.nn.softplus``;
the decode caches' shapes and dtypes.

Tolerances: rtol 1e-5 / atol 1e-6 for outputs, states and gradients.  The
hidden states enter at unit scale and the gradients are taken of a mean over
tokens, so every compared value is of order 1 or below; the recurrences'
fp32 sums (over a head's 16 keys, or Mamba's 4 states) run in another order
in the two frameworks, a few ulps apart.  RWKV-6's state S needs more,
and after 256 steps its output too: they are compared at rtol 1e-4 / atol
1e-4.  S sums rank-one updates under a decay of ~0.9975 and grows to ~23
after 16 steps and ~120 after 256, so atol 1e-6 is below one ulp of its
large entries; the decay ``exp(-exp(w))`` differs by an ulp between XLA's
exp and PyTorch's, and XLA contracts ``w·S + kv`` into one fused
multiply-add, so the two recurrences drift apart by up to ~1e-4 (6 ulps of
S's largest entry), and the output, read from S through a layernorm, by
~2e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import load_config as jax_load_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtrans  # noqa: E402
from repro_torch.configs import load_config  # noqa: E402
from repro_torch.convert import state_dict_from_jax  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttrans  # noqa: E402

ARCH = {"rwkv": "rwkv6-1.6b", "cmix": "rwkv6-1.6b", "mamba": "jamba-v0.1-52b"}


def _perturb(tree, seed):
    """The JAX init with every constant fill (zeros, -6, -4.6, ones)
    replaced by a random value near it, so each parameter matters."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a, np.float32)
        return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
    return jax.tree.map(f, tree)


_INIT = {"rwkv": (jssm.init_rwkv6, tssm.RWKV6),
         "cmix": (jssm.init_rwkv6_channel_mix, tssm.RWKV6ChannelMix),
         "mamba": (jssm.init_mamba, tssm.Mamba)}
_MIX = {"rwkv": (jssm.rwkv6_mix, tssm.rwkv6_mix),
        "cmix": (jssm.rwkv6_channel_mix, tssm.rwkv6_channel_mix),
        "mamba": (jssm.mamba_mix, tssm.mamba_mix)}


@pytest.fixture(scope="module", params=["rwkv", "cmix", "mamba"])
def mixer(request):
    """(kind, jax cfg, jax params, port cfg, port module)."""
    kind = request.param
    jcfg = jax_load_config(ARCH[kind], "smoke")
    cfg = load_config(ARCH[kind], "smoke")
    jinit, Module = _INIT[kind]
    jp = _perturb(jinit(jax.random.PRNGKey(3), jcfg), seed=4)
    m = Module(cfg, "cpu")
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                       state_dict_from_jax(jp).items()}, strict=True)
    return kind, jcfg, jp, cfg, m


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _state(kind, cfg, B, seed):
    """A random carried state in the mixer's state layout (None for zero)."""
    D = cfg.d_model
    if kind == "cmix":
        return (_x((B, D), seed),)
    if kind == "rwkv":
        hs = cfg.ssm.head_dim
        return (_x((B, D), seed), 0.3 * _x((B, D // hs, hs, hs), seed + 1))
    di = cfg.ssm.expand * D
    return (_x((B, cfg.ssm.d_conv - 1, di), seed),
            0.3 * _x((B, di, cfg.ssm.d_state), seed + 1))


def _call_jax(kind, jcfg, jp, x, state):
    fn = _MIX[kind][0]
    if kind == "cmix":
        return fn(jp, jcfg, x, None if state is None else state[0])
    return fn(jp, jcfg, x, state)


def _call_port(kind, cfg, m, x, state):
    fn = _MIX[kind][1]
    if kind == "cmix":
        return fn(m, cfg, x, None if state is None else state[0])
    return fn(m, cfg, x, state)


def _flat(out):
    """(y, state) → [y, *state tensors]."""
    y, st = out
    return [y, *(st if isinstance(st, tuple) else (st,))]


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


class TestMixers:
    @pytest.mark.parametrize("T", [16, 256], ids=["one-chunk", "two-chunks"])
    @pytest.mark.parametrize("carried", [False, True],
                             ids=["zero-state", "carried-state"])
    def test_matches_jax(self, mixer, T, carried):
        kind, jcfg, jp, cfg, m = mixer
        B = 2
        x = _x((B, T, cfg.d_model), seed=T)
        st = _state(kind, cfg, B, seed=5) if carried else None
        want = _flat(jax.jit(lambda p, xx, s: _call_jax(kind, jcfg, p, xx, s))(
            jp, jnp.asarray(x),
            None if st is None else tuple(map(jnp.asarray, st))))
        with torch.no_grad():
            got = _flat(_call_port(kind, cfg, m, torch.from_numpy(x),
                                   None if st is None else
                                   tuple(map(torch.from_numpy, st))))
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert tuple(g.shape) == w.shape, i
            assert str(g.dtype) == f"torch.{w.dtype}", i
            from_s = kind == "rwkv" and (i == 2 or (i == 0 and T > 128))
            tol = (1e-4, 1e-4) if from_s else (1e-5, 1e-6)
            _close(g, w, *tol, msg=f"output {i}")

    def test_one_call_equals_one_step_calls(self, mixer):
        """Decode: T one-step calls carrying the state give the outputs and
        the final state of one call over the T steps."""
        kind, _, _, cfg, m = mixer
        T = 12
        x = torch.from_numpy(_x((2, T, cfg.d_model), seed=9))
        with torch.no_grad():
            whole = _flat(_call_port(kind, cfg, m, x, None))
            st, ys = None, []
            for t in range(T):
                y, st = _call_port(kind, cfg, m, x[:, t:t + 1], st)
                st = st if isinstance(st, tuple) else (st,)
                ys.append(y)
        steps = [torch.cat(ys, dim=1), *st]
        for i, (a, b) in enumerate(zip(steps, whole)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6,
                                       msg=f"output {i}")

    @pytest.mark.parametrize("T", [16, 256], ids=["one-chunk", "two-chunks"])
    def test_gradients_match_jax(self, mixer, T):
        """Gradients of a mean over tokens of <y, c> plus the final states'
        sums, for every parameter, the input and the carried state; at
        T = 256 through the checkpointed chunks."""
        kind, jcfg, jp, cfg, m = mixer
        B = 2
        x = _x((B, T, cfg.d_model), seed=T + 1)
        st = _state(kind, cfg, B, seed=6)
        c = _x((B, T, cfg.d_model), seed=7) / (B * T)

        def jloss(p, xx, s):
            y, *rest = _flat(_call_jax(kind, jcfg, p, xx, s))
            return jnp.sum(y * c) + sum(jnp.mean(r) for r in rest)

        jg, jgx, jgs = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
            jp, jnp.asarray(x), tuple(map(jnp.asarray, st)))
        names, params = zip(*m.named_parameters())
        for p in params:
            p.requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        stt = tuple(torch.from_numpy(s).requires_grad_(True) for s in st)
        y, *rest = _flat(_call_port(kind, cfg, m, xt, stt))
        loss = (y * torch.from_numpy(c)).sum() + sum(r.mean() for r in rest)
        grads = torch.autograd.grad(loss, (*params, xt, *stt),
                                    allow_unused=True)
        want = state_dict_from_jax(jax.tree.map(np.asarray, jg))
        assert set(names) == set(want)
        for name, g in zip(names, grads):
            if g is None:                  # read by no output (rwkv's mu_x)
                assert not np.asarray(want[name]).any(), name
                continue
            _close(g, want[name], msg=name)
        _close(grads[len(names)], jgx, msg="x")
        for i, (g, w) in enumerate(zip(grads[len(names) + 1:], jgs)):
            _close(g, w, msg=f"state {i}")

    def test_ragged_chunk_count_raises(self, mixer):
        """200 steps are more than one chunk and not a whole number of
        chunks: the scans refuse them; the channel mix has no scan and
        takes them, in both packages."""
        kind, jcfg, jp, cfg, m = mixer
        x = _x((1, 200, cfg.d_model), seed=8)
        if kind == "cmix":
            want = _flat(_call_jax(kind, jcfg, jp, jnp.asarray(x), None))
            with torch.no_grad():
                got = _flat(_call_port(kind, cfg, m, torch.from_numpy(x),
                                       None))
            for g, w in zip(got, want):
                _close(g, w)
            return
        with pytest.raises(AssertionError):
            _call_jax(kind, jcfg, jp, jnp.asarray(x), None)
        with pytest.raises(ValueError, match="whole number of chunks"):
            _call_port(kind, cfg, m, torch.from_numpy(x), None)


class TestPieces:
    def test_softplus_matches_jax(self):
        x = np.concatenate([np.linspace(-120, 120, 4001),
                            [-np.inf, np.inf, 0.0, 19.99, 20.0, 20.01, 88.0,
                             -88.0]]).astype(np.float32)
        got = tssm.softplus(torch.from_numpy(x)).numpy()
        # exp and log1p an ulp apart; XLA flushes denormal results to 0.
        np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(
            jnp.asarray(x))), rtol=2e-7, atol=np.finfo(np.float32).tiny)
        assert got[-2] == np.float32(88.0) and got[-8] == 0.0    # 88, -inf

    def test_chunked_scan_checkpoints_only_under_autograd(self, monkeypatch):
        calls = []

        def spy(fn, *args, **kw):
            calls.append(fn)
            return fn(*args)
        monkeypatch.setattr(tssm, "checkpoint", spy)

        def body(s, xs):
            return s + xs[0].sum(1), xs[0] * 2

        x = torch.ones(2, 256, 3)
        with torch.no_grad():
            s, y = tssm._chunked_scan(body, torch.zeros(2, 3), (x,))
        assert not calls and torch.equal(s, torch.full((2, 3), 256.0))
        tssm._chunked_scan(body, torch.zeros(2, 3),
                           (x.requires_grad_(True),))
        assert len(calls) == 2
        assert tuple(y.shape) == (2, 256, 3)

    @pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
    def test_caches_match_jax(self, arch):
        jcfg = jax_load_config(arch, "smoke")
        cfg = load_config(arch, "smoke")
        prefix, period, _ = jtrans.layer_plan(jcfg)
        for sub in {*prefix, *period}:
            want = jtrans.init_sublayer_cache(jcfg, sub, 3, 40)
            got = ttrans.init_sublayer_cache(
                cfg, ttrans.SubLayer(sub.mixer, sub.is_moe), 3, 40, "cpu")
            assert set(got) == set(want)
            for k, w in want.items():
                assert tuple(got[k].shape) == w.shape, k
                assert str(got[k].dtype) == f"torch.{w.dtype}", k
                assert not got[k].any()

    def test_mamba_init_matches_jax_constants(self):
        """A_log = log(1..d_state) per channel, dt_proj.b = -4.6, D = 1,
        conv_b = 0, conv_w a plain normal × (d_conv·di)^-½."""
        jcfg = jax_load_config("jamba-v0.1-52b", "smoke")
        cfg = load_config("jamba-v0.1-52b", "smoke").replace(d_model=256)
        jp = jssm.init_mamba(jax.random.PRNGKey(0), jcfg)
        m = tssm.Mamba(cfg, "cpu")
        gen = torch.Generator().manual_seed(0)
        for mod in m.modules():
            if hasattr(mod, "init_"):
                mod.init_(gen)
        np.testing.assert_array_equal(m.A_log[:4].numpy(),
                                      np.asarray(jp["A_log"])[:4])
        assert torch.equal(m.dt_proj.b, torch.full_like(m.dt_proj.b, -4.6))
        assert torch.equal(m.D, torch.ones_like(m.D))
        assert not m.conv_b.any()
        K, di = m.conv_w.shape
        std = float(m.conv_w.std()) / (K * di) ** -0.5
        assert abs(std - 1) < 0.05                  # not truncated: ~1
