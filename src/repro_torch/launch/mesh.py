"""The production and host meshes (reference: ``repro.launch.mesh``).

single-pod : (16, 16)    axes ("data", "model")          — 256 cards
multi-pod  : (2, 16, 16) axes ("pod", "data", "model")   — 512 cards; "pod"
             is pure data parallelism across pods

A mesh here is either a ``torch.distributed`` ``DeviceMesh``
(:func:`make_production_mesh`, :func:`make_host_mesh`: a process group
per mesh axis, from ``init_device_mesh``) or an :class:`AbstractMesh`,
axis names and sizes with no device behind them, which the sharding rules
(``distributed.sharding``) and the cell plans (``launch.steps``) accept as
well: a 16 × 16 plan can be made on one card or on the CPU. Both are
read through :func:`axis_names` and :func:`axis_sizes`.

The reference's TPU constants (peak FLOP/s, HBM and link rates) belong to
its chip and are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, no devices: ``shape`` is ``{name:
    size}`` in axis order, as ``jax.sharding.Mesh.shape`` is."""
    sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axis_names):
            raise ValueError(f"AbstractMesh: {len(self.sizes)} sizes for "
                             f"axes {self.axis_names}")
        object.__setattr__(self, "sizes", tuple(int(s) for s in self.sizes))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of an :class:`AbstractMesh`, a ``DeviceMesh`` or a
    ``sharding.ClusterMesh``."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = mesh.mesh_dim_names
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in axis order, for any mesh
    :func:`axis_names` reads."""
    if hasattr(mesh, "axis_names"):
        return dict(mesh.shape)
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axes and sizes, without devices."""
    return AbstractMesh(*PRODUCTION_SHAPES[multi_pod])


def _device_mesh(shape, names, device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs a process group: call "
            "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"a {tuple(shape)} mesh needs a world of {n} "
                         f"processes, this one has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The (16, 16) or (2, 16, 16) ``DeviceMesh`` over the initialised
    world; raises unless the world has 256 (512) processes."""
    return _device_mesh(*PRODUCTION_SHAPES[multi_pod], device_type)


def make_host_mesh(*, device_type="cuda"):
    """The (1, 1) ("data", "model") mesh of a world of one (the
    reference's 1-device mesh for smoke runs)."""
    return _device_mesh((1, 1), ("data", "model"), device_type)


def mesh_chips(mesh) -> int:
    n = 1
    for s in axis_sizes(mesh).values():
        n *= s
    return n
