"""Sharding rules: parameter name → spec (TP over "model", ZeRO/FSDP over
"data", DP over ("pod", "data")), plus activation and cache specs per
shape; the port's copy of the JAX package's ``repro.parallel.sharding``.

A spec is a tuple with one entry per tensor dimension, each ``None``, a
mesh axis name or a tuple of names: the content of a JAX
``PartitionSpec``.  The rules are plain Python over the mesh's
``{axis: size}`` shape (``mesh_shape``), so they need no device; a real
``DeviceMesh`` takes a spec through ``to_placements``.

The rules match on the JAX package's ``/``-joined parameter path, and are
copied unchanged.  The port names a parameter by its ``state_dict`` name,
with one tensor per layer period where the JAX tree stacks the periods
into one leaf of shape ``(n_periods, ...)``; ``jax_path`` rewrites a name
to the JAX path, and a period tensor takes its stacked leaf's spec
without the leading entry, which the rules leave ``None``.
"""

from __future__ import annotations

import math
import re
from collections.abc import Mapping

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

#: FSDP (ZeRO-3-style param sharding over "data") kicks in above this size.
FSDP_THRESHOLD = 500_000_000
#: Below this size, tensor parallelism is counterproductive at 256 chips —
#: the 2 activation all-reduces/layer dwarf everything a small model does.
#: The model axis is folded into data parallelism instead.
TP_THRESHOLD = 8_000_000_000

Spec = tuple


def spec(*entries) -> Spec:
    """A spec of ``entries``, normalised as ``PartitionSpec`` normalises
    them: a tuple of one axis becomes the axis, an empty one ``None``."""
    def one(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(one(e) for e in entries)


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (``mesh_dim_names`` and
    ``mesh.shape``) or of a shape-only mesh whose ``shape`` is that
    mapping already."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh has no mesh_dim_names")
    return dict(zip(names, mesh.shape))


def _divisible(dim: int | None, size: int) -> bool:
    return dim is not None and dim % size == 0


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


#: A period tensor's name; the JAX tree stacks ``stack/periods/<rest>``.
_PERIOD = re.compile(r"^(.*\bperiods)\.\d+\.")


def jax_path(name: str) -> tuple[str, bool]:
    """(the JAX package's ``/``-joined path of the port's tensor ``name``,
    whether the JAX tree stacks it over the layer periods)."""
    m = _PERIOD.match(name)
    if m:
        name = f"{m.group(1)}.{name[m.end():]}"
    return name.replace(".", "/"), m is not None


def to_placements(spec: Spec, mesh, shape: tuple[int, ...]):
    """``spec`` on ``mesh`` as DTensor placements, one per mesh dimension:
    ``Shard(d)`` where tensor dimension ``d`` names the mesh axis,
    ``Replicate()`` elsewhere.  Raises when a tuple's axes are out of the
    mesh's order (DTensor splits a dimension major-to-minor in mesh order),
    when an axis is unknown or used twice, and when a dimension does not
    divide by its axes' sizes; nothing is ever padded."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_shape(mesh)
    names = list(sizes)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                         f"tensor of shape {tuple(shape)}")
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        for a in axes:
            if a not in sizes:
                raise ValueError(f"spec {spec}: no mesh axis {a!r} in "
                                 f"{names}")
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {a!r} is used "
                                 "twice")
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec {spec}: axes {axes} of dimension {d} "
                             f"are out of the mesh's order {names}")
        size = math.prod(sizes[a] for a in axes)
        if shape[d] % size:
            raise ValueError(f"spec {spec}: dimension {d} of shape "
                             f"{tuple(shape)} does not divide by {size}")
        for p in pos:
            out[p] = Shard(d)
    return tuple(out)


def local_shape(spec: Spec, mesh, shape: tuple[int, ...]) -> tuple:
    """One rank's shard of a ``shape`` tensor placed by ``spec``."""
    sizes = mesh_shape(mesh)
    to_placements(spec, mesh, shape)              # the same checks
    return tuple(n // math.prod(sizes[a] for a in _axes(e))
                 for n, e in zip(shape, spec))


def distribute(t: torch.Tensor, spec: Spec, mesh):
    """``t`` as a DTensor on ``mesh`` placed by ``spec``.  Every rank holds
    the whole of ``t`` and keeps its own shard: no collective runs.  A
    ``meta`` tensor becomes a DTensor over a ``meta`` shard of the local
    shape (the dry-run's)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    placements = to_placements(spec, mesh, tuple(t.shape))
    if not t.is_meta:
        return distribute_tensor(t.detach(), mesh, placements,
                                 src_data_rank=None)
    local = torch.empty(local_shape(spec, mesh, tuple(t.shape)),
                        dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_module(model: torch.nn.Module, specs: Mapping, mesh) -> None:
    """Replace every parameter of ``model`` by a DTensor placed by
    ``specs[name]`` (``distribute``), in place."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(
            distribute(p, specs[name], mesh), requires_grad=p.requires_grad))


class ShardingRules:
    def __init__(self, cfg: ModelConfig, mesh,
                 shape: ShapeConfig | None = None):
        self.cfg = cfg
        self.mesh = mesh
        self.mesh_shape = ms = mesh_shape(mesh)
        # TP only pays for big models — BUT folding the model axis into DP
        # requires the global batch to actually fill the widened DP extent
        # (otherwise activations replicate across the idle axis, which is
        # strictly worse).  Shape-aware: small model + divisible batch → DP.
        full_dp = 1
        for a in ("pod", "data", "model"):
            full_dp *= ms.get(a, 1)
        batch_fills = (shape is None
                       or shape.global_batch % full_dp == 0)
        self.use_tp = (cfg.n_params() > TP_THRESHOLD) or not batch_fills
        self.model = ms.get("model", 1) if self.use_tp else 1
        self.data = ms.get("data", 1)
        self.fsdp = cfg.n_params() > FSDP_THRESHOLD
        dp = [a for a in ("pod", "data") if a in ms]
        if not self.use_tp and "model" in ms:
            dp.append("model")           # model axis becomes extra DP/ZeRO
        self.dp_axes = tuple(dp)
        self.ep = (cfg.moe is not None and self.use_tp
                   and cfg.moe.n_experts % self.model == 0)

    # -- helpers ----------------------------------------------------------
    @property
    def _zero_axes(self) -> tuple[str, ...]:
        """ZeRO/FSDP axes: data (+ the folded model axis when TP is off);
        never across the pod DCI."""
        axes = ["data"]
        if not self.use_tp and "model" in self.mesh_shape:
            axes.append("model")
        return tuple(axes)

    def _d(self, dim: int):
        """FSDP axes for a replicated-dim if divisible."""
        if not self.fsdp:
            return None
        axes = self._zero_axes
        size = math.prod(self.mesh_shape[a] for a in axes)
        if _divisible(dim, size):
            return axes if len(axes) > 1 else axes[0]
        return "data" if _divisible(dim, self.data) else None

    def _m(self, dim: int) -> str | None:
        if not self.use_tp:
            return None                # model axis folded into DP
        return "model" if _divisible(dim, self.model) else None

    # -- the rule table ----------------------------------------------------
    def param_spec(self, path: tuple[str, ...], shape: tuple[int, ...]) -> Spec:
        """The spec of the JAX leaf at ``path`` (its keys) with ``shape``."""
        s = "/".join(path)
        nd = len(shape)

        def tail(*axes):
            """Pad with leading Nones to the leaf's rank."""
            return spec(*([None] * (nd - len(axes)) + list(axes)))

        # ---- embeddings / head
        if s.endswith("embed/table"):
            return tail(self._m(shape[-2]), self._d(shape[-1]))
        if s.endswith("head/w"):
            return tail(self._d(shape[-2]), self._m(shape[-1]))
        # ---- MoE expert banks: leaf (E, d_in, d_out) (+ optional stack dim)
        if "/experts/" in s or "/shared/" in s:
            e_axis = "model" if (self.ep and "/experts/" in s
                                 and _divisible(shape[-3], self.model)) else None
            if s.endswith(("up", "gate")):
                inner = self._m(shape[-1]) if e_axis is None else None
                return tail(e_axis, self._d(shape[-2]), inner)
            inner = self._m(shape[-2]) if e_axis is None else None
            return tail(e_axis, inner, self._d(shape[-1]))     # down
        if s.endswith("router/w"):
            return tail(self._d(shape[-2]), None)
        # ---- attention
        if re.search(r"attn/(q|k|v)/w$", s):
            return tail(self._d(shape[-2]), self._m(shape[-1]))
        if s.endswith("attn/o/w"):
            return tail(self._m(shape[-2]), self._d(shape[-1]))
        # ---- dense FFN
        if re.search(r"ffn/(up|gate)/w$", s):
            return tail(self._d(shape[-2]), self._m(shape[-1]))
        if s.endswith("ffn/down/w"):
            return tail(self._m(shape[-2]), self._d(shape[-1]))
        # ---- mamba
        if s.endswith("in_proj/w"):
            return tail(self._d(shape[-2]), self._m(shape[-1]))
        if s.endswith("conv_w"):
            return tail(None, self._m(shape[-1]))
        if s.endswith(("conv_b", "D")):
            return tail(self._m(shape[-1]))
        if s.endswith("x_proj/w"):
            return tail(self._m(shape[-2]), None)
        if s.endswith("dt_proj/w"):
            return tail(None, self._m(shape[-1]))
        if s.endswith(("dt_proj/b",)):
            return tail(self._m(shape[-1]))
        if s.endswith("A_log"):
            return tail(self._m(shape[-2]), None)
        if s.endswith("out_proj/w"):
            return tail(self._m(shape[-2]), self._d(shape[-1]))
        # ---- rwkv6
        if re.search(r"rwkv/(r|k|v|g)/w$", s):
            return tail(self._d(shape[-2]), self._m(shape[-1]))
        if s.endswith("rwkv/o/w"):
            return tail(self._m(shape[-2]), self._d(shape[-1]))
        if s.endswith("cmix/k/w"):
            return tail(self._d(shape[-2]), self._m(shape[-1]))
        if s.endswith("cmix/v/w"):
            return tail(self._m(shape[-2]), self._d(shape[-1]))
        if s.endswith("cmix/r/w"):
            return tail(self._d(shape[-2]), None)
        # ---- everything small (norms, biases, mus, loras, u): replicated
        return (None,) * nd

    def _n_periods(self) -> int:
        from repro_torch.models.transformer import layer_plan
        return layer_plan(self.cfg)[2]

    def _by_name(self, spec_of, tensors: Mapping[str, torch.Tensor]):
        """``{name: spec}``: ``spec_of(path, jax_shape)`` of each tensor's
        JAX leaf, a period tensor's without the stacked leading entry."""
        n_periods = self._n_periods()
        out = {}
        for name, t in tensors.items():
            path, stacked = jax_path(name)
            shape = tuple(t.shape)
            if not stacked:
                out[name] = spec_of(path, shape)
                continue
            spec = spec_of(path, (n_periods, *shape))
            if spec[0] is not None:
                raise ValueError(f"{name}: the stacked leaf's spec {spec} "
                                 "shards the period axis, which the port "
                                 "holds as separate tensors")
            out[name] = spec[1:]
        return out

    def params_pspecs(self, params: Mapping[str, torch.Tensor]):
        """``{name: spec}`` of a ``state_dict``-like mapping."""
        return self._by_name(
            lambda path, shape: self.param_spec(tuple(path.split("/")),
                                                shape), params)

    # -- activations / data ---------------------------------------------------
    def batch_spec(self, shape: ShapeConfig) -> Spec:
        """(B, T) spec: batch over the largest DP-axis prefix that divides
        it, else sequence sharding (SP — the long_500k batch=1 case)."""
        dp = self.dp_axes
        for take in range(len(dp), 0, -1):
            axes = dp[:take]
            size = math.prod(self.mesh_shape[a] for a in axes)
            if shape.global_batch % size == 0:
                return spec(axes, None)
        dp_size = math.prod(self.mesh_shape[a] for a in dp)
        if shape.seq_len % dp_size == 0 and shape.global_batch == 1:
            return spec(None, dp)
        return (None, None)

    def cache_spec(self, path: str, leaf_shape: tuple[int, ...],
                   shape: ShapeConfig) -> Spec:
        """The spec of the JAX cache leaf at ``path`` with ``leaf_shape``."""
        dp = self.dp_axes
        dp_size = math.prod(self.mesh_shape[a] for a in dp)
        batch_on_dp = shape.global_batch % dp_size == 0
        nd = len(leaf_shape)
        if path.endswith(("/k", "/v")) and nd >= 4:
            # (..., B, S, Hkv, Dh)
            b = dp if batch_on_dp and leaf_shape[-4] % dp_size == 0 else None
            s_ax = None if b is not None else (
                dp if leaf_shape[-3] % dp_size == 0 else None)
            m = "model" if leaf_shape[-1] % self.model == 0 else None
            return spec(*([None] * (nd - 4) + [b, s_ax, None, m]))
        # Recurrent states (mamba/rwkv/shift): shard the batch dim (the
        # first dim matching global_batch) over DP when divisible;
        # otherwise replicate (they are O(1)-sized at batch=1).
        for i in range(nd):
            if leaf_shape[i] == shape.global_batch and batch_on_dp:
                return spec(*([None] * i + [dp] + [None] * (nd - i - 1)))
        return (None,) * nd

    def cache_pspecs(self, cache, shape: ShapeConfig):
        """The specs of a cache from ``init_stack_cache``, in its
        structure."""
        flat = dict(_flatten(cache))
        specs = self._by_name(
            lambda path, leaf: self.cache_spec(path, leaf, shape), flat)
        return _unflatten(cache, specs)


def _flatten(tree, prefix: str = ""):
    """(dotted name, leaf) of nested dicts and lists."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix[:-1], tree
        return
    for k, v in items:
        yield from _flatten(v, f"{prefix}{k}.")


def _unflatten(tree, by_name: Mapping, prefix: str = ""):
    if isinstance(tree, Mapping):
        return {k: _unflatten(v, by_name, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, by_name, f"{prefix}{i}.")
                          for i, v in enumerate(tree))
    return by_name[prefix[:-1]]
