"""The port's sharding rule table (``repro_torch.parallel.sharding``), input
specs (``repro_torch.launch.specs``) and activation sharding
(``repro_torch.parallel.autoshard``) against the JAX package's, with no
device: the rules run over a shape-only mesh, as the JAX package's own
``tests/test_sharding.py`` runs them.

The parity cases are one parametrised test, every comparison with ``==``:
* ``params``: the spec of every tensor of the ten full configs, built on
  ``meta``, on the pod (16×16) and multipod (2×16×16) shapes, against the
  spec of its leaf in ``jax.eval_shape``'s tree (a layer period's tensor
  against its stacked leaf's spec without the leading ``None``);
* ``batch``: ``batch_spec`` for every ``SHAPES`` entry (with SP at batch 1),
  the rules built with the shape, as the dry-run builds them;
* ``cache``: ``cache_pspecs`` of every decode shape's cache.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import applicable_shapes as japplicable  # noqa: E402
from repro.configs import load_config as jload  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch.configs import (ARCHS, SHAPES,  # noqa: E402
                                 applicable_shapes, load_config)
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.parallel import autoshard  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402

MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Shape-only stand-in (never touches devices), as the JAX package's
    tests use; both packages read ``shape`` as ``{axis: size}``."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.size = int(np.prod(list(shape.values())))
        self.empty = False


def _key(k) -> str:
    return JS._key_name(k)


def _jax_specs(tree) -> dict:
    """{"/"-joined JAX path: spec tuple} of a tree of PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(_key(k) for k in kp): tuple(s) for kp, s in flat}


def _by_port_name(port: dict, jax_specs: dict) -> None:
    """Every port tensor's spec equals its JAX leaf's, and every JAX leaf
    is reached."""
    seen = set()
    for name, spec in port.items():
        path, stacked = S.jax_path(name)
        want = jax_specs[path]
        if stacked:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert spec == want, (name, spec, want)
        seen.add(path)
    assert seen == set(jax_specs)


def _at(tree, name: str):
    """The entry of nested dicts and lists at a dotted ``name``."""
    for k in name.split("."):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JSP.params_specs(jload(arch, "full"))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return dict(SP.params_specs(load_config(arch, "full")).named_parameters())


def _cases():
    out = []
    for arch in ARCHS:
        decode = [s for s in applicable_shapes(load_config(arch, "full"))
                  if SHAPES[s].kind == "decode"]
        for mesh in MESHES:
            out.append(("params", arch, mesh, None))
            out += [("batch", arch, mesh, shape) for shape in SHAPES]
            out += [("cache", arch, mesh, shape) for shape in decode]
    return out


@pytest.mark.parametrize("kind,arch,mesh,shape", _cases())
def test_specs_equal_jax(kind, arch, mesh, shape):
    jcfg, cfg = jload(arch, "full"), load_config(arch, "full")
    fm = FakeMesh(MESHES[mesh])
    jshape = JSHAPES[shape] if shape else None
    jrules = JS.ShardingRules(jcfg, fm, jshape)
    rules = S.ShardingRules(cfg, fm, SHAPES[shape] if shape else None)
    assert (rules.use_tp, rules.fsdp, rules.ep, rules.dp_axes) == \
        (jrules.use_tp, jrules.fsdp, jrules.ep, jrules.dp_axes)
    if kind == "params":
        _by_port_name(rules.params_pspecs(_port_params(arch)),
                      _jax_specs(jrules.params_pspecs(_jax_params(arch))))
    elif kind == "batch":
        assert rules.batch_spec(SHAPES[shape]) == \
            tuple(jrules.batch_spec(jshape))
    else:
        cache = SP.cache_specs(cfg, SHAPES[shape])
        port = rules.cache_pspecs(cache, SHAPES[shape])
        want = _jax_specs(jrules.cache_pspecs(
            JSP.cache_specs(jcfg, jshape), jshape))
        _by_port_name({name: _at(port, name)
                       for name, _ in S._flatten(cache)}, want)


def test_cases_cover_every_arch_shape_and_mesh():
    cases = _cases()
    assert {c[1] for c in cases} == set(ARCHS) and len(ARCHS) == 10
    assert {(c[1], c[2], c[3]) for c in cases if c[0] == "cache"} == {
        (a, m, s) for a in ARCHS for m in MESHES
        for s in japplicable(jload(a, "full"))
        if JSHAPES[s].kind == "decode"}
    assert sum(c[0] == "batch" for c in cases) == 10 * 2 * 4


def _shapes_dtypes(named: dict) -> dict:
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in named.items()}


def _jax_named(tree, prefix="") -> dict:
    """{the port's name: (shape, dtype)} of a JAX tree: ``.``-joined, with
    a stacked period leaf split into one entry per period."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(_key(k) for k in kp)
        head, sep, rest = name.partition("periods.")
        if sep and head in ("", "stack."):
            for i in range(leaf.shape[0]):
                out[f"{prefix}{head}periods.{i}.{rest}"] = (
                    tuple(leaf.shape[1:]), str(leaf.dtype))
        else:
            out[prefix + name] = (tuple(leaf.shape), str(leaf.dtype))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_shapes_and_dtypes_equal_jax(arch):
    """``train_state_specs`` (masters, moments, step), every applicable
    shape's batch and decode specs, against ``jax.eval_shape``'s trees."""
    jcfg, cfg = jload(arch, "full"), load_config(arch, "full")
    js = JSP.train_state_specs(jcfg)
    want = _jax_named(js["params"], "params/")
    for part in ("m", "v"):
        want.update(_jax_named(js["opt"][part], f"opt/{part}/"))
    want["opt/step"] = ((), "int32")
    st = SP.train_state_specs(cfg)
    assert _shapes_dtypes(st.state_dict()) == want
    for shape in japplicable(jcfg):
        jin = JSP.input_specs(jcfg, JSHAPES[shape])
        got = SP.input_specs(cfg, SHAPES[shape])
        assert got.keys() == jin.keys()
        if JSHAPES[shape].kind == "decode":
            assert _shapes_dtypes(dict(got["params"].named_parameters())) \
                == _jax_named(jin["params"])
            assert _shapes_dtypes(dict(S._flatten(got["cache"]))) == \
                _jax_named(jin["cache"])
            for k in ("tokens", "cache_index"):
                assert _shapes_dtypes({k: got[k]}) == {k: (
                    tuple(jin[k].shape), str(jin[k].dtype))}
        else:
            assert _shapes_dtypes(got["batch"]) == {
                k: (tuple(v.shape), str(v.dtype))
                for k, v in jin["batch"].items()}


class TestPlacements:
    MESH = FakeMesh({"pod": 2, "data": 4, "model": 2})

    def test_maps_axes_to_shards_in_mesh_order(self):
        from torch.distributed.tensor import Replicate, Shard
        assert S.to_placements((("pod", "data"), None, "model"), self.MESH,
                               (16, 3, 4)) == (Shard(0), Shard(0), Shard(2))
        assert S.to_placements((None, None), self.MESH, (3, 5)) == \
            (Replicate(),) * 3
        assert S.local_shape((("pod", "data"), None, "model"), self.MESH,
                             (16, 3, 4)) == (2, 3, 2)

    def test_raises_on_axes_out_of_mesh_order(self):
        with pytest.raises(ValueError, match="out of the mesh's order"):
            S.to_placements((("data", "pod"), None), self.MESH, (16, 4))

    def test_raises_on_a_dimension_that_does_not_divide(self):
        with pytest.raises(ValueError, match="does not divide by 8"):
            S.to_placements((("pod", "data"), None), self.MESH, (12, 4))
        with pytest.raises(ValueError, match="does not divide by 2"):
            S.to_placements((None, "model"), self.MESH, (12, 5))

    def test_raises_on_unknown_or_reused_axes(self):
        with pytest.raises(ValueError, match="no mesh axis"):
            S.to_placements(("seq", None), self.MESH, (4, 4))
        with pytest.raises(ValueError, match="used twice"):
            S.to_placements(("data", "data"), self.MESH, (4, 4))

    def test_jax_path(self):
        assert S.jax_path("stack.periods.3.sub1.moe.experts.up") == \
            ("stack/periods/sub1/moe/experts/up", True)
        assert S.jax_path("stack.prefix.0.attn.q.w") == \
            ("stack/prefix/0/attn/q/w", False)
        assert S.jax_path("periods.0.sub0.k") == ("periods/sub0/k", True)


def test_activation_sharding_is_a_no_op_without_a_context_or_a_dtensor():
    x = torch.ones(4, 8, 16)
    assert autoshard.current() is None
    for f in (autoshard.hidden, autoshard.logits, autoshard.tokens_nd,
              autoshard.barrier):
        assert f(x) is x
    s = torch.ones(4, 2, 1, 8, 8)
    assert autoshard.scores(s) is s
    mesh = FakeMesh({"data": 4, "model": 2})
    with autoshard.activation_sharding(mesh, dp=("data",)):
        ctx = autoshard.current()
        assert ctx.dp == ("data",) and ctx.axis_size("model") == 2
        assert autoshard.hidden(x) is x and autoshard.scores(s) is s
    assert autoshard.current() is None


class TestKernelRoute:
    """A DTensor reaches ``SoftmaxFn`` and ``ExpFn`` as its local shard
    (``kernels._build.on_local``), on the plain route here and the kernel
    route on the card, in a fake world of four ranks: values equal the
    local computation, placements are kept, gradients flow; a sharded
    softmax axis and partial sums raise, and no DTensor reaches a
    kernel's launcher."""

    @pytest.fixture()
    def mesh(self):
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_mesh
        with dryrun.fake_world(4):
            yield make_mesh((2, 2), ("data", "model"), "cpu")

    def _dt(self, mesh, placements, shape=(4, 6, 8)):
        """(a DTensor over a seeded local tensor that takes gradients,
        that local tensor)."""
        from torch.distributed.tensor import DTensor
        local = torch.randn(shape, generator=torch.Generator().manual_seed(0))
        local.requires_grad_()
        return DTensor.from_local(local, mesh, placements,
                                  run_check=False), local

    def test_softmax_and_exp_on_the_local_shard(self, mesh):
        from torch.distributed.tensor import Shard
        from repro_torch.kernels import expf, ops, softmax
        for f, fn in ((ops.softmax, softmax.SoftmaxFn),
                      (ops.exp, expf.ExpFn)):
            x, local = self._dt(mesh, [Shard(0), Shard(1)])
            y = f(x)
            assert y.placements == x.placements and y.shape == x.shape
            y.to_local().square().sum().backward()
            ref = local.detach().clone().requires_grad_()
            want = fn.apply(ref, False)
            want.square().sum().backward()
            assert torch.equal(y.to_local(), want)
            assert torch.equal(local.grad, ref.grad)

    def test_a_sharded_softmax_axis_raises(self, mesh):
        from torch.distributed.tensor import Partial, Replicate, Shard
        from repro_torch.kernels import ops
        with pytest.raises(ValueError, match="dimension -1 is sharded"):
            ops.softmax(self._dt(mesh, [Shard(0), Shard(2)])[0])
        with pytest.raises(ValueError, match="partial sums"):
            ops.softmax(self._dt(mesh, [Partial(), Replicate()])[0])
        with pytest.raises(ValueError, match="partial sums"):
            ops.exp(self._dt(mesh, [Replicate(), Partial()])[0])

    def test_the_kernel_route_takes_the_local_shard(self, mesh,
                                                    monkeypatch):
        from torch.distributed.tensor import DTensor, Shard
        from repro_torch.kernels import _build, expf, softmax
        seen = []

        def fake(plain):
            def launch(x, block_rows=None):
                seen.append(type(x))
                return plain(x)
            return launch

        monkeypatch.setattr(softmax, "softmax_cuda",
                            fake(softmax.softmax_plain))
        monkeypatch.setattr(expf, "exp_cuda", fake(expf.exp_plain))
        x, _ = self._dt(mesh, [Shard(0), Shard(1)])
        assert isinstance(softmax.SoftmaxFn.apply(x, True, 8), DTensor)
        assert isinstance(expf.ExpFn.apply(x, True, 8), DTensor)
        assert seen == [torch.Tensor, torch.Tensor]
        with pytest.raises(TypeError, match="got a DTensor"):
            _build.check_cuda_tensor(x, (torch.float32,), "softmax_cuda")
