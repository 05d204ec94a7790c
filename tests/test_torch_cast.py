"""The JAX package's cast of its fp32 masters to the working copy
(``repro.models.model._cast_once``) against the port's (``working_dtype``,
used by ``init_params``, ``load_params`` and ``init_train_state``), on
gemma-2b and jamba smoke in bf16 with every master perturbed off the bf16
grid.  ``_cast_once`` casts each leaf of rank >= 2 to the compute dtype; a
period's leaves are stacked on a leading ``n_periods`` axis, so a period's
norm gains, biases and SSM vectors are cast too, and only the prefix's and
the final norm's 1-D parameters stay fp32.

Tolerances: the working copy is compared bit for bit.  One bf16 train step
is compared at the loss tolerance of ``test_bf16_trajectory_matches_jax``
(rtol 2e-3), and its master gradients' global norm at rtol 2e-2: XLA fuses
chains of bf16 elementwise ops and rounds once at their end, PyTorch rounds
after every op (a bf16 FFN's outputs differ by one bf16 ulp in ~60 % of
their elements), and jamba's MoE router amplifies such roundings: JAX's own
jitted and op-by-op runs of this step differ by 0.9 % in jamba's gradient
norm, and the port lies 1.6 % from the jitted one.  Single gradient
elements of the two packages do not agree to 2e-3 in bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import load_config as jax_load_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import load_config  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 state_dict_from_jax, train_state_from_jax)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                          make_train_step)

ARCHS = ["gemma-2b", "jamba-v0.1-52b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def masters(request):
    """(jax cfg, port cfg, fp32 masters off the bf16 grid as numpy)."""
    arch = request.param
    jcfg = jax_load_config(arch, "smoke").replace(dtype="bfloat16")
    cfg = load_config(arch, "smoke").replace(dtype="bfloat16")
    rng = np.random.default_rng(0)

    def perturb(a):
        a = np.asarray(a, np.float32)
        return (a * (1 + rng.normal(0, 0.01, a.shape))
                + rng.normal(0, 0.01, a.shape)).astype(np.float32)
    params = jax.tree.map(perturb, jax.jit(
        lambda k: jmodel.init_params(jcfg, k))(jax.random.PRNGKey(1)))
    return jcfg, cfg, params


def _cast_once(jcfg, params):
    """``_cast_once``'s working copy by port name: (fp32 values, dtype)."""
    tree = _np(jmodel._cast_once(jax.tree.map(jnp.asarray, params), jcfg))
    return {k: (np.asarray(v, np.float32), str(v.dtype))
            for k, v in state_dict_from_jax(tree).items()}


def _assert_working_copy(model, want):
    assert set(dict(model.named_parameters())) == set(want)
    for name, p in model.named_parameters():
        values, dtype = want[name]
        assert str(p.dtype) == f"torch.{dtype}", name
        np.testing.assert_array_equal(p.detach().float().numpy(), values,
                                      err_msg=name)


def test_masters_are_off_the_bf16_grid(masters):
    _, _, params = masters
    sd = state_dict_from_jax(params)
    g = sd["stack.periods.0.sub0.norm1.g"]
    assert not np.array_equal(g, g.astype(jnp.bfloat16).astype(np.float32))


def test_period_vectors_are_cast_and_prefix_vectors_are_not(masters):
    jcfg, cfg, params = masters
    want = _cast_once(jcfg, params)
    assert want["stack.periods.0.sub0.norm1.g"][1] == "bfloat16"
    assert want["final_norm.g"][1] == "float32"
    for name, (_, dtype) in want.items():
        p = tmodel.LMModel(cfg, "meta").get_parameter(name)
        assert str(tmodel.working_dtype(cfg, name, p.ndim)) == \
            f"torch.{dtype}", name


def test_params_from_jax_equal_cast_once_bit_for_bit(masters):
    jcfg, cfg, params = masters
    _assert_working_copy(params_from_jax(params, cfg, "cpu"),
                         _cast_once(jcfg, params))


def test_train_state_working_copy_equals_cast_once(masters):
    """``train_state_from_jax`` and ``init_train_state`` of fp32 masters:
    the working copy is the cast, the masters stay fp32 and only leaves
    that stay fp32 alias their master."""
    jcfg, cfg, params = masters
    want = _cast_once(jcfg, params)
    state = train_state_from_jax(
        {"params": params, "opt": {"m": params, "v": params,
                                   "step": np.int32(0)}}, cfg, "cpu")
    _assert_working_copy(state.model, want)
    for name, p in state.model.named_parameters():
        assert state.params[name].dtype == torch.float32
        assert (p.data_ptr() == state.params[name].data_ptr()) == \
            (p.dtype == torch.float32), name


def test_init_params_stores_the_working_dtypes(masters):
    _, cfg, _ = masters
    model = tmodel.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for name, p in model.named_parameters():
        assert p.dtype == tmodel.working_dtype(cfg, name, p.ndim), name
    state = init_train_state(cfg, model)
    assert state.model is model          # already in the working dtypes
    fp32 = tmodel.init_params(cfg.replace(dtype="float32"),
                              torch.Generator().manual_seed(0), "cpu")
    state = init_train_state(cfg, fp32)
    assert state.model is not fp32
    for name, p in state.model.named_parameters():
        assert p.dtype == tmodel.working_dtype(cfg, name, p.ndim), name


def test_bf16_step_matches_jax(masters):
    """One train step from the same masters: the loss and the gradient norm
    against ``jax.value_and_grad`` of the masters, and the working copy
    after the update equal to the cast of the updated masters."""
    jcfg, cfg, params = masters
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 17)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True))(jax.tree.map(jnp.asarray, params))
    jgn = np.sqrt(sum(float(np.square(np.asarray(v, np.float64)).sum())
                      for v in jax.tree.leaves(jg)))

    zeros = jax.tree.map(np.zeros_like, params)
    state = train_state_from_jax(
        {"params": params, "opt": {"m": zeros, "v": zeros,
                                   "step": np.int32(0)}}, cfg, "cpu")
    fn = make_train_step(cfg, topt.AdamWConfig(lr=1e-2, warmup_steps=1,
                                               total_steps=1))
    state, m = fn(state, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=2e-3)
    np.testing.assert_allclose(float(m["grad_norm"]), jgn, rtol=2e-2)
    for name, p in state.model.named_parameters():
        master = state.params[name]
        assert master.dtype == torch.float32
        assert torch.equal(p, master.to(p.dtype)), name
