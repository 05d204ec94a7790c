"""The port's training path on the CPU against the JAX package, on olmo-1b
smoke (and gemma-2b smoke where norm gains matter): ``loss_fn`` and every
parameter's gradient against ``jax.value_and_grad`` through the JAX
reference path, with and without rematerialisation (``remat="full"`` and
``"dots"``, whose saved ops are listed), also for the MoE
(deepseek: the auxiliary loss enters the loss), Mamba-hybrid (jamba),
RWKV-6 and audio-encoder (hubert: per-frame labels) families; the softmax
and exp ``autograd.Function``s against ``jax.vjp`` of the reference;
``adamw_update`` and ``lr_at``; three steps of ``make_train_step`` (1 and 2
microbatches, fp32 and bf16 compute; jamba in fp32) against the JAX loss
trajectory, also with int8 gradient compression
(``compress_pod_grads``; ``parallel.compress`` bit-equal to the JAX
package's); the ``NotImplementedError``s of what is not ported; the
``launch.train`` entry point.

Tolerances: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6 (fp32 sums in
another order; the port's analytic softmax/exp backward against JAX's
derivative of the exp polynomial, which differ by ~4e-7 relative); the
Functions rtol 1e-5 / atol 1e-6; AdamW rtol 1e-6 on the moments and rtol
1e-6 / atol 1e-7 on the parameters (the global norm sums its leaves in
another order, one fp32 ulp apart, and the clip scale carries that into
updates of up to ~20 at lr 1e-2) and atol 1e-9 on the moments (~one fp32
ulp at their 1e-2 scale, where ``0.9 m + 0.1 g`` cancels; bf16 moments to
one bf16 ulp); trajectories rtol 1e-4 in fp32 and 2e-3 in bf16, where the
two frameworks round matmul outputs and gradient sums to bf16 at different
places.  After three steps the parameters agree to rtol 1e-4 / atol 1e-6
but for at most 0.1 % of the elements, and all to lr: Adam's update of an
element whose gradient is ~0 is ~lr times the sign of that gradient's
rounding noise.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import load_config as jax_load_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.configs import load_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    params_from_jax, state_dict_from_jax, train_state_from_jax)
from repro_torch.kernels import expf, ops, softmax  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.attention import NEG_INF  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                          make_train_step)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def olmo():
    jcfg = jax_load_config("olmo-1b", "smoke")
    jparams = jax.jit(lambda k: jmodel.init_params(jcfg, k))(
        jax.random.PRNGKey(1))
    return jcfg, jparams, load_config("olmo-1b", "smoke")


def _tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _jax_loss_and_grads(jcfg, jparams, toks):
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))(
            jparams, {"tokens": jnp.asarray(toks)})
    return float(loss), _np(metrics), state_dict_from_jax(_np(grads))


def _port_loss_and_grads(cfg, np_params, toks):
    model = params_from_jax(np_params, cfg, "cpu")
    names, params = zip(*model.named_parameters())
    for p in params:
        p.requires_grad_(True)
    loss, metrics = tmodel.loss_fn(model, cfg, {"tokens":
                                                torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, params)
    return float(loss.detach()), metrics, dict(zip(names, grads))


class TestLossAndGrads:
    @pytest.mark.parametrize("remat,ce_chunk", [("none", 256), ("full", 256),
                                                ("full", 8), ("dots", 256)],
                             ids=["remat-none", "remat-full",
                                  "remat-full-ce-chunks", "remat-dots"])
    def test_match_jax(self, olmo, monkeypatch, remat, ce_chunk):
        """ce_chunk 8 over 20 targets: two chunks and a remainder of 4."""
        jcfg, jparams, cfg = olmo
        for mod in (jmodel, tmodel):
            monkeypatch.setattr(mod, "CE_CHUNK", ce_chunk)
        jcfg, cfg = jcfg.replace(remat=remat), cfg.replace(remat=remat)
        toks = _tokens(cfg, 2, 21)
        jl, jm, jg = _jax_loss_and_grads(jcfg, jparams, toks)
        tl, tm, tg = _port_loss_and_grads(cfg, _np(jparams), toks)
        _close(tl, jl, 1e-5, 0)
        for k in ("nll", "zloss", "ppl", "aux"):
            _close(tm[k].detach(), jm[k], 1e-5, 1e-7, k)
        assert set(tg) == set(jg)
        for name, g in tg.items():
            _close(g, jg[name], 1e-4, 1e-6, name)

    def test_remat_grads_bit_equal(self, olmo):
        """The recompute is the forward again: ``full`` and ``dots`` give
        ``none``'s loss and gradients bit for bit."""
        jcfg, jparams, cfg = olmo
        toks = _tokens(cfg, 2, 17, seed=3)
        loss, _, none = _port_loss_and_grads(cfg.replace(remat="none"),
                                             _np(jparams), toks)
        for remat in ("full", "dots"):
            l2, _, grads = _port_loss_and_grads(cfg.replace(remat=remat),
                                                _np(jparams), toks)
            assert l2 == loss, remat
            for name, g in none.items():
                assert torch.equal(g, grads[name]), (remat, name)

    def test_chunked_attention_grads_match_jax(self, olmo, monkeypatch):
        """Lowered thresholds send training down the chunked attention
        path, whose exp is the exp Function."""
        for mod in (jattn, tattn):
            monkeypatch.setattr(mod, "CHUNKED_THRESHOLD", 256)
            monkeypatch.setattr(mod, "KV_CHUNK", 16)
            monkeypatch.setattr(mod, "Q_BLOCK", 16)
        jcfg, jparams, cfg = olmo
        toks = _tokens(cfg, 1, 33, seed=5)
        jl, _, jg = _jax_loss_and_grads(jcfg, jparams, toks)
        tl, _, tg = _port_loss_and_grads(cfg, _np(jparams), toks)
        _close(tl, jl, 1e-5, 0)
        for name, g in tg.items():
            _close(g, jg[name], 1e-4, 1e-6, name)

    def test_vocab_parallel_ce_matches_jax(self, olmo):
        jcfg, jparams, cfg = olmo
        toks = _tokens(cfg, 2, 13, seed=4)
        gather, _, _ = _port_loss_and_grads(cfg, _np(jparams), toks)
        jl, _, _ = _jax_loss_and_grads(jcfg.replace(vocab_parallel_ce=True),
                                       jparams, toks)
        tl, _, _ = _port_loss_and_grads(cfg.replace(vocab_parallel_ce=True),
                                        _np(jparams), toks)
        _close(tl, jl, 1e-5, 0)
        _close(tl, gather, 1e-6, 0)


def _family_batch(cfg, B, T, seed):
    """The batch each family trains on, as numpy: tokens, or frame
    embeddings and labels for the audio encoder."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"embeds": rng.uniform(-1, 1, (B, T, cfg.d_model)).astype(
                    np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(
                    np.int32)}
    return {"tokens": _tokens(cfg, B, T, seed)}


class TestFamilies:
    """Loss, metrics and gradients of the new families' smoke configs.  The
    token embedding of hubert and RWKV's ``mu_x`` are read by no output:
    their gradients are 0 in JAX and unused in PyTorch."""

    @pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b",
                                      "rwkv6-1.6b", "hubert-xlarge"])
    def test_loss_and_grads_match_jax(self, arch):
        jcfg = jax_load_config(arch, "smoke")
        cfg = load_config(arch, "smoke")
        jparams = jax.jit(lambda k: jmodel.init_params(jcfg, k))(
            jax.random.PRNGKey(4))
        batch = _family_batch(cfg, 2, 21, seed=6)
        (jl, jm), jg = jax.jit(jax.value_and_grad(
            lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))(
                jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        jg = state_dict_from_jax(_np(jg))
        model = params_from_jax(_np(jparams), cfg, "cpu")
        names, params = zip(*model.named_parameters())
        for p in params:
            p.requires_grad_(True)
        loss, tm = tmodel.loss_fn(model, cfg, {k: torch.from_numpy(v)
                                               for k, v in batch.items()})
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        _close(float(loss.detach()), float(jl), 1e-5, 0)
        for k in ("nll", "zloss", "ppl", "aux"):
            _close(tm[k].detach(), jm[k], 1e-5, 1e-7, k)
        assert (float(jm["aux"]) > 0) == (cfg.moe is not None)
        assert set(names) == set(jg)
        for name, g in zip(names, grads):
            if g is None:
                assert not jg[name].any(), name
                continue
            _close(g, jg[name], 1e-4, 1e-6, name)

    def test_encoder_step_zeroes_the_unread_embedding(self):
        """``make_train_step`` gives a parameter that no output reads a zero
        gradient, as ``jax.grad`` does, instead of failing."""
        cfg = load_config("hubert-xlarge", "smoke")
        state = init_train_state(cfg, tmodel.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        before = state.params["embed.table"].clone()
        fn = make_train_step(cfg, topt.AdamWConfig(weight_decay=0.0))
        batch = {k: torch.from_numpy(v) for k, v in
                 _family_batch(cfg, 2, 9, seed=1).items()}
        _, m = fn(state, batch)
        assert np.isfinite(float(m["loss"]))
        assert torch.equal(state.params["embed.table"], before)


class TestKernelGradients:
    """The Functions' input gradients, for a random cotangent."""

    def _scores(self, rows=64, cols=161, seed=0):
        rng = np.random.default_rng(seed)
        x = (rng.normal(0, 1, (rows, cols)) * 4).astype(np.float32)
        x[:, cols // 2 + 1:] = NEG_INF
        x[0] = NEG_INF
        g = rng.normal(0, 1, (rows, cols)).astype(np.float32)
        return x, g

    def _port_vjp(self, fn, x, g):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = fn(xt)
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
        return y.detach(), dx

    def test_softmax_matches_jax(self):
        x, g = self._scores()
        y, vjp = jax.vjp(lambda a: jops.softmax(a, impl="reference"),
                         jnp.asarray(x))
        got_y, got = self._port_vjp(lambda a: ops.softmax(a), x, g)
        _close(got_y, y, 1e-5, 1e-7)
        _close(got, vjp(jnp.asarray(g))[0], 1e-5, 1e-6)

    def test_exp_matches_jax(self):
        rng = np.random.default_rng(1)
        x = (rng.normal(0, 10, 4096)).astype(np.float32)
        x[::97] = NEG_INF
        g = rng.normal(0, 1, 4096).astype(np.float32)
        y, vjp = jax.vjp(lambda a: jops.exp(a, impl="reference"),
                         jnp.asarray(x))
        got_y, got = self._port_vjp(lambda a: ops.exp(a), x, g)
        _close(got_y, y, 2e-6, 0)
        _close(got, vjp(jnp.asarray(g))[0], 1e-5, 1e-6)

    @pytest.mark.parametrize("name", ["softmax", "exp"])
    def test_function_matches_autograd_through_plain_version(self, name):
        """The check ``chip_smoke.py`` makes on the card at the training
        shapes, here at a small one: the analytic backward against autograd
        through the plain version (whose exp derivative is the polynomial's)."""
        x, g = self._scores(seed=2)
        fn = {"softmax": lambda a: softmax.SoftmaxFn.apply(a, False),
              "exp": lambda a: expf.ExpFn.apply(a, False)}[name]
        plain = {"softmax": softmax.softmax_plain, "exp": expf.exp_plain}[name]
        _, want = self._port_vjp(plain, x, g)
        got_y, got = self._port_vjp(fn, x, g)
        assert bool(torch.isfinite(want).all())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)

    def test_bf16_softmax_gradient_keeps_dtype(self):
        x, g = self._scores(seed=3)
        xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
        (dx,) = torch.autograd.grad(ops.softmax(xt), xt,
                                    torch.from_numpy(g).to(torch.bfloat16))
        assert dx.dtype == torch.bfloat16 and bool(torch.isfinite(dx).all())

    def test_other_axis_has_a_gradient(self):
        x, g = self._scores(rows=8, cols=8, seed=4)
        xt = torch.from_numpy(x).requires_grad_(True)
        (dx,) = torch.autograd.grad(ops.softmax(xt, axis=0), xt,
                                    torch.from_numpy(g))
        y = softmax.softmax_plain(xt.detach().T).T
        gt = torch.from_numpy(g)
        torch.testing.assert_close(dx, y * (gt - (gt * y).sum(0)),
                                   rtol=1e-5, atol=1e-6)


def _opt_inputs(arch, opt_dtype, seed=0):
    """A JAX train state of ``arch`` smoke at step 5 with random moments,
    and random gradients, as numpy."""
    jcfg = jax_load_config(arch, "smoke").replace(opt_state_dtype=opt_dtype)
    jparams = _np(jax.jit(lambda k: jmodel.init_params(jcfg, k))(
        jax.random.PRNGKey(2)))
    rng = np.random.default_rng(seed)
    dt = jnp.dtype(opt_dtype)

    def rand(scale, positive=False):
        def f(p):
            a = rng.normal(0, scale, p.shape).astype(np.float32)
            return np.asarray(np.abs(a) if positive else a).astype(dt)
        return jax.tree.map(f, jparams)
    state = {"params": jparams,
             "opt": {"m": rand(1e-2), "v": rand(1e-4, True),
                     "step": np.int32(5)}}
    grads = jax.tree.map(lambda p: rng.normal(0, 0.5, p.shape).astype(
        np.float32), jparams)
    return jcfg, state, grads


class TestAdamW:
    @pytest.mark.parametrize("arch", ["olmo-1b", "gemma-2b"])
    @pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
    def test_update_matches_jax(self, arch, opt_dtype):
        """gemma-2b has norm gains (named ``g``: no decay); the grads'
        global norm is above ``grad_clip``, so clipping scales them."""
        jcfg, np_state, np_grads = _opt_inputs(arch, opt_dtype)
        c = jopt.AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
        want_p, want_opt, want_m = jopt.adamw_update(
            c, np_state["params"], np_grads, np_state["opt"])
        cfg = load_config(arch, "smoke").replace(opt_state_dtype=opt_dtype)
        state = train_state_from_jax(np_state, cfg, "cpu")
        grads = {k: torch.from_numpy(np.array(v)) for k, v in
                 state_dict_from_jax(np_grads).items()}
        got_m = topt.adamw_update(topt.AdamWConfig(**vars(c)), state.params,
                                  grads, state.opt)
        assert float(want_m["grad_norm"]) > c.grad_clip
        _close(got_m["grad_norm"], want_m["grad_norm"], 1e-6, 0)
        _close(got_m["lr"], want_m["lr"], 1e-6, 0)
        assert int(state.opt["step"]) == int(want_opt["step"]) == 6
        for name, p in state_dict_from_jax(_np(want_p)).items():
            _close(state.params[name], p, 1e-6, 1e-7, name)
        for part in ("m", "v"):
            for name, a in state_dict_from_jax(_np(want_opt[part])).items():
                got = state.opt[part][name]
                assert str(got.dtype) == f"torch.{opt_dtype}"
                rtol = 1e-6 if opt_dtype == "float32" else 2 ** -7
                _close(got.float(), np.asarray(a, np.float32), rtol, 1e-9,
                       f"{part} {name}")

    def test_decay_by_name(self):
        assert topt._is_matrix("embed.table")
        assert topt._is_matrix("stack.periods.0.sub0.ffn.up.w")
        assert not topt._is_matrix("stack.periods.0.sub0.norm1.g")
        assert not topt._is_matrix("stack.periods.0.sub0.attn.q.b")
        c = topt.AdamWConfig(lr=1.0, weight_decay=0.5, warmup_steps=0,
                             total_steps=1, min_lr_ratio=1.0)
        params = {"a.w": torch.ones(2, 2), "a.g": torch.ones(2),
                  "b.g": torch.ones(2, 2)}
        zero = {k: torch.zeros_like(v) for k, v in params.items()}
        topt.adamw_update(c, params, zero, topt.init_opt_state(params))
        assert torch.equal(params["a.w"], torch.full((2, 2), 0.5))
        assert torch.equal(params["a.g"], torch.ones(2))
        assert torch.equal(params["b.g"], torch.ones(2, 2))

    def test_lr_schedule_matches_jax(self):
        c = jopt.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100)
        steps = np.arange(0, 120, dtype=np.int32)
        want = np.asarray(jax.vmap(lambda s: jopt.lr_at(c, s))(
            jnp.asarray(steps)))
        got = topt.lr_at(topt.AdamWConfig(**vars(c)), torch.from_numpy(steps))
        assert got.dtype == torch.float32
        _close(got, want, 1e-6, 0)


def _trajectories(jcfg, cfg, n_micro, steps=3, B=4, T=17, compress=False):
    jparams = jax.jit(lambda k: jmodel.init_params(jcfg, k))(
        jax.random.PRNGKey(3))
    jstate = jstep.init_train_state(jcfg, jparams)
    c = jopt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=steps)
    jfn = jax.jit(jstep.make_train_step(jcfg, c, n_microbatches=n_micro,
                                        compress_pod_grads=compress))
    state = train_state_from_jax(_np(jstate), cfg, "cpu")
    fn = make_train_step(cfg, topt.AdamWConfig(**vars(c)),
                         n_microbatches=n_micro,
                         compress_pod_grads=compress)
    want, got = [], []
    for s in range(steps):
        toks = _tokens(cfg, B, T, seed=10 + s)
        jstate, jm = jfn(jstate, {"tokens": jnp.asarray(toks)})
        state, m = fn(state, {"tokens": torch.from_numpy(toks)})
        want.append({k: float(v) for k, v in jm.items()})
        got.append({k: float(v) for k, v in m.items()})
    return want, got, jstate, state


class TestTrainStep:
    @pytest.mark.parametrize("n_micro", [1, 2])
    def test_trajectory_matches_jax(self, n_micro):
        jcfg = jax_load_config("olmo-1b", "smoke")
        want, got, jstate, state = _trajectories(
            jcfg, load_config("olmo-1b", "smoke"), n_micro)
        for s, (w, g) in enumerate(zip(want, got)):
            for k in ("loss", "nll", "zloss", "grad_norm", "lr"):
                _close(g[k], w[k], 1e-4, 0, f"step {s} {k}")
        for name, p in state_dict_from_jax(_np(jstate["params"])).items():
            got = state.params[name].numpy()
            far = ~np.isclose(got, p, rtol=1e-4, atol=1e-6)
            assert far.mean() <= 1e-3, (name, far.sum())
            assert np.abs(got - p).max() <= 1e-2, name      # lr

    def test_bf16_trajectory_matches_jax(self):
        jcfg = jax_load_config("olmo-1b", "smoke").replace(dtype="bfloat16")
        cfg = load_config("olmo-1b", "smoke").replace(dtype="bfloat16")
        want, got, _, state = _trajectories(jcfg, cfg, 1)
        for s, (w, g) in enumerate(zip(want, got)):
            _close(g["loss"], w["loss"], 2e-3, 0, f"step {s}")
        w = state.model.stack.periods[0]["sub0"].attn.q.w
        master = state.params["stack.periods.0.sub0.attn.q.w"]
        assert w.dtype == torch.bfloat16 and master.dtype == torch.float32
        assert torch.equal(w, master.to(torch.bfloat16))

    def test_jamba_trajectory_matches_jax(self):
        """Mamba layers (their checkpointed scans), one attention layer and
        MoE on every other layer, three steps."""
        jcfg = jax_load_config("jamba-v0.1-52b", "smoke")
        want, got, _, _ = _trajectories(
            jcfg, load_config("jamba-v0.1-52b", "smoke"), 1, B=2)
        for s, (w, g) in enumerate(zip(want, got)):
            for k in ("loss", "nll", "aux", "grad_norm", "lr"):
                _close(g[k], w[k], 1e-4, 0, f"step {s} {k}")

    def test_masters_of_fp32_configs_are_the_parameters(self, olmo):
        _, _, cfg = olmo
        model = tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu")
        state = init_train_state(cfg, model)
        assert state.model is model
        for name, p in model.named_parameters():
            assert p.requires_grad
            assert p.data_ptr() == state.params[name].data_ptr()

    def test_microbatches_must_divide_the_batch(self, olmo):
        _, _, cfg = olmo
        state = init_train_state(cfg, tmodel.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        fn = make_train_step(cfg, topt.AdamWConfig(), n_microbatches=2)
        with pytest.raises(ValueError, match="microbatches"):
            fn(state, {"tokens": torch.zeros((3, 9), dtype=torch.int32)})


class TestCompress:
    """``parallel.compress`` against the JAX package's
    ``repro.parallel.compress``, bit for bit."""

    @staticmethod
    def _inputs():
        rng = np.random.default_rng(7)
        # max |g| 127 makes the scale exactly 1, so g / scale = k / 2
        ties = np.append(np.arange(-20, 21, dtype=np.float32) * 0.5, 127.0)
        return {
            "seeded": rng.standard_normal((64, 33)).astype(np.float32) * 3,
            "zeros": np.zeros((5, 7), np.float32),
            "ties": ties.astype(np.float32),
            "tiny": rng.standard_normal(999).astype(np.float32) * 1e-20,
            "scalar": np.array(-2.5, dtype=np.float32),
        }

    @pytest.mark.parametrize("case", ["seeded", "zeros", "ties", "tiny",
                                      "scalar"])
    def test_quantize_dequantize_bit_equal(self, case):
        from repro.parallel import compress as jc

        from repro_torch.parallel import compress as tc
        x = self._inputs()[case]
        g_hat, resid = tc.quantize_dequantize(torch.from_numpy(x))
        jg, jr = jc.quantize_dequantize(jnp.asarray(x))
        assert g_hat.dtype == resid.dtype == torch.float32
        np.testing.assert_array_equal(g_hat.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(resid.numpy(), np.asarray(jr))
        if case == "ties":   # half to even: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
            np.testing.assert_array_equal(
                g_hat.numpy()[:-1], np.round(x[:-1]))
            assert x[[21, 23, 25]].tolist() == [0.5, 1.5, 2.5]
            assert g_hat.numpy()[[21, 23, 25]].tolist() == [0.0, 2.0, 2.0]

    def test_bf16_gradient_is_quantized_in_fp32(self):
        from repro.parallel import compress as jc

        from repro_torch.parallel import compress as tc
        x = np.random.default_rng(2).standard_normal(300).astype(np.float32)
        g = torch.from_numpy(x).to(torch.bfloat16)
        jg = jnp.asarray(x).astype(jnp.bfloat16)
        g_hat, resid = tc.quantize_dequantize(g)
        want = jc.quantize_dequantize(jg.astype(jnp.float32))
        np.testing.assert_array_equal(g_hat.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(resid.numpy(), np.asarray(want[1]))

    def test_error_feedback_residuals(self):
        """Two steps of ``ef_compress`` over a dict tree: the compressed
        gradients and the carried residuals equal the JAX package's."""
        from repro.parallel import compress as jc

        from repro_torch.parallel import compress as tc
        rng = np.random.default_rng(4)
        steps = [{"a": rng.standard_normal((8, 5)).astype(np.float32),
                  "b": [rng.standard_normal(11).astype(np.float32)]}
                 for _ in range(2)]
        e = tc.ef_init({"a": torch.zeros(8, 5), "b": [torch.zeros(11)]})
        je = jc.ef_init({"a": jnp.zeros((8, 5)), "b": [jnp.zeros(11)]})
        for g in steps:
            tg = {"a": torch.from_numpy(g["a"]),
                  "b": [torch.from_numpy(g["b"][0])]}
            g_hat, e = tc.ef_compress(tg, e)
            jg_hat, je = jc.ef_compress(jax.tree.map(jnp.asarray, g), je)
            for got, want in ((g_hat, jg_hat), (e, je)):
                np.testing.assert_array_equal(got["a"].numpy(),
                                              np.asarray(want["a"]))
                np.testing.assert_array_equal(got["b"][0].numpy(),
                                              np.asarray(want["b"][0]))
        assert isinstance(e["b"], list)
        assert float(e["a"].abs().max()) > 0

    def test_periods_share_their_stacked_leaf_scale(self):
        """The JAX tree stacks a period's parameters over the periods into
        one leaf, whose one int8 scale the port's per-period tensors must
        share: ``compress_grads`` equals ``quantize_dequantize`` of the
        stacked leaf, and the unstacked leaves keep their own scale."""
        from repro.parallel import compress as jc

        from repro_torch.train.train_step import compress_grads
        rng = np.random.default_rng(9)
        per = [rng.standard_normal((4, 6)).astype(np.float32) * s
               for s in (50.0, 1.0, 0.01)]
        emb = rng.standard_normal((5, 3)).astype(np.float32)
        grads = {f"stack.periods.{i}.sub0.attn.q.w": torch.from_numpy(g)
                 for i, g in enumerate(per)}
        grads["embed.table"] = torch.from_numpy(emb)
        params = {k: torch.zeros(g.shape) for k, g in grads.items()}
        out = compress_grads(grads, params)
        stacked = np.asarray(jc.quantize_dequantize(jnp.asarray(
            np.stack(per)))[0])
        for i in range(3):
            np.testing.assert_array_equal(
                out[f"stack.periods.{i}.sub0.attn.q.w"].numpy(), stacked[i])
        assert not out["stack.periods.2.sub0.attn.q.w"].any()
        np.testing.assert_array_equal(out["embed.table"].numpy(), np.asarray(
            jc.quantize_dequantize(jnp.asarray(emb))[0]))

    def test_compressed_psum_raises_naming_item_4(self):
        """Ported now (the name is kept from when it raised): over a group
        of one process, ``compressed_psum`` is the int8 round trip, bit
        for bit; tests/test_torch_collectives.py holds four processes
        against JAX's ``shard_map``."""
        import torch.distributed as dist
        from repro_torch.parallel import compress as tc
        g = torch.from_numpy(np.random.default_rng(3).normal(
            size=(5, 7)).astype(np.float32))
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            got = tc.compressed_psum(g)
        finally:
            dist.destroy_process_group()
        torch.testing.assert_close(got, tc.quantize_dequantize(g)[0],
                                   rtol=0, atol=0)


class TestNotPorted:
    def test_compress_pod_grads(self):
        """``make_train_step(compress_pod_grads=True)``, which raised until
        ``parallel.compress`` was ported: three steps of the olmo smoke
        model against the JAX package's compressed step at the fp32
        trajectory tolerances; the first loss equals the uncompressed
        step's (compression acts after the gradient), its grad norm does
        not."""
        jcfg = jax_load_config("olmo-1b", "smoke")
        cfg = load_config("olmo-1b", "smoke")
        want, got, jstate, state = _trajectories(jcfg, cfg, 1,
                                                 compress=True)
        for s, (w, g) in enumerate(zip(want, got)):
            for k in ("loss", "nll", "zloss", "grad_norm", "lr"):
                _close(g[k], w[k], 1e-4, 0, f"step {s} {k}")
        for name, p in state_dict_from_jax(_np(jstate["params"])).items():
            got_p = state.params[name].numpy()
            far = ~np.isclose(got_p, p, rtol=1e-4, atol=1e-6)
            assert far.mean() <= 1e-3, (name, far.sum())
            assert np.abs(got_p - p).max() <= 1e-2, name      # lr
        _, uncompressed, _, _ = _trajectories(jcfg, cfg, 1, steps=1)
        assert got[0]["loss"] == uncompressed[0]["loss"]
        assert got[0]["grad_norm"] != uncompressed[0]["grad_norm"]

    def test_remat_dots(self, olmo, monkeypatch):
        """``remat="dots"``, which raised until it was ported, saves the
        outputs of the period's dense projections and nothing else: on
        the olmo smoke model (2 layers, D 64, 4 heads of 16, 2 KV heads,
        FFN 128) the forward marks 7 ``aten.mm`` a layer to save, q and
        o (64 x 64), k and v (64 x 32), gate and up (64 x 128) and down
        (128 x 64) on the 2 x 17 tokens, and no ``aten.bmm`` (the
        attention einsums carry batch dimensions)."""
        from repro_torch.models import transformer
        saved = []
        policy = transformer._dots_policy

        def spy(ctx, op, *args, **kwargs):
            decision = policy(ctx, op, *args, **kwargs)
            if not ctx.is_recompute and \
                    decision == transformer.CheckpointPolicy.MUST_SAVE:
                saved.append((str(op), tuple(tuple(a.shape) for a in args)))
            return decision

        monkeypatch.setattr(transformer, "_dots_policy", spy)
        _, jparams, cfg = olmo
        _port_loss_and_grads(cfg.replace(remat="dots"), _np(jparams),
                             _tokens(cfg, 2, 17, seed=3))
        per_layer = sorted([((34, 64), (64, 64))] * 2
                           + [((34, 64), (64, 32))] * 2
                           + [((34, 64), (64, 128))] * 2
                           + [((34, 128), (128, 64))])
        assert sorted(shapes for _, shapes in saved) == \
            sorted(per_layer * cfg.n_layers)
        assert {op for op, _ in saved} == {"aten.mm.default"}

    def test_autotune(self, capsys, tmp_path, monkeypatch):
        """``--autotune`` turns the tuned tilings on and prints the JAX
        package's ``[tune]`` line; the tilings change no value, so the
        losses equal the run without it."""
        from repro_torch.kernels import ops
        monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
        argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
                "16"]
        plain = launch_train.main(argv)
        before = ops.tuned_defaults_enabled()
        try:
            tuned = launch_train.main(argv + ["--autotune"])
            assert ops.tuned_defaults_enabled() is True
        finally:
            ops.set_tuned_defaults(before)
        assert "[tune] kernel block tilings autotuned" in \
            capsys.readouterr().out
        assert [h["loss"] for h in tuned] == [h["loss"] for h in plain]


class TestLaunch:
    def test_main_on_cpu_prints_jax_launch_train_lines(self, capsys, tmp_path):
        out = tmp_path / "m.json"
        hist = launch_train.main(["--device", "cpu", "--steps", "3",
                                  "--batch", "2", "--seq", "16",
                                  "--log-every", "1", "--metrics-out",
                                  str(out)])
        text = capsys.readouterr().out
        assert [h["step"] for h in hist] == [0, 1, 2]
        for h in hist:
            assert np.isfinite([h["loss"], h["grad_norm"]]).all()
            assert h["seconds"] > 0
        assert "step     2 loss=" in text and " nll=" in text and \
            " lr=" in text and " gnorm=" in text
        assert f"[done] steps=3 loss {hist[0]['loss']:.4f} -> " \
            f"{hist[-1]['loss']:.4f}" in text
        assert out.exists()

    def test_card_is_the_default_device(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch_train.main(["--steps", "1"])
