"""Device meshes, as the JAX package's ``repro.launch.mesh``, on
``torch.distributed``'s ``DeviceMesh``.

Functions, not module-level constants: importing this module creates no
process group and touches no device.  A mesh needs a process group of
its size: ``torch.distributed.init_process_group`` on the card
(``"nccl"``) or the CPU (``"gloo"``), or the fake world of
``launch.dryrun`` for the production shapes, which no single machine has.
"""

from __future__ import annotations

#: The production meshes (TPU v5e: 256 chips a pod as (data 16, model 16);
#: two pods add a leading, pure-DP "pod" axis crossing the inter-pod DCI),
#: kept as data: a mesh of these shapes exists only in a fake world.
PRODUCTION = {"pod": ((16, 16), ("data", "model")),
              "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group, whose world size must be ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """The (16, 16) or (2, 16, 16) production mesh, in a world of 256 or
    512 ranks (the dry-run's fake one)."""
    shape, axes = PRODUCTION["multipod" if multi_pod else "pod"]
    return make_mesh(shape, axes, device_type)


def mesh_context(mesh, dp=("data",), tp="model", seq_sharded=False):
    """The activation-sharding context that ``parallel.autoshard`` reads,
    for ``mesh``: where the JAX package sets the mesh for tracing, the
    port's model code reads it from this context."""
    from repro_torch.parallel.autoshard import activation_sharding
    return activation_sharding(mesh, dp=dp, tp=tp, seq_sharded=seq_sharded)
