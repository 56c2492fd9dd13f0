"""Production mesh descriptions.

Counterpart of ``src/repro/launch/mesh.py``.  The reference builds jax
meshes of TPU chips; the port's stand-in is ``MeshSpec``, a frozen
(shape, axis names) pair that touches no device and no process group:
the sharding specs of launch/sharding.py are computed against it, and
``sharding.to_placements`` turns a spec into the DTensor placements of a
real ``torch.distributed`` ``DeviceMesh`` of the same shape.  The
single-pod mesh is 16 x 16 = 256 devices, ("data", "model"); multi-pod
adds a leading "pod" axis (2 pods, 512 devices).

``fake_device_mesh`` stands in for the reference's ``activate_mesh``
(jax's ambient mesh over 256 or 512 fake host devices): eager PyTorch
has no ambient mesh, a DTensor carries its own, so it makes a
``DeviceMesh`` of the spec's shape over a ``"fake"`` process group of
that many ranks, which runs no communication.  Not ported:
``cost_analysis_dict`` (XLA's compiled cost analysis; launch/dryrun.py
counts FLOPs with ``torch.utils.flop_counter``'s formulas instead).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A named device mesh's shape, as ``jax.sharding.AbstractMesh``
    describes one: ``axis_sizes`` (one extent an axis) and
    ``axis_names``."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh extents {self.axis_sizes} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: extent}, as a jax mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshSpec(shape, axes)


def data_axes(mesh) -> tuple:
    """Axes the global batch shards over."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def client_axes(mesh) -> tuple:
    """Axes the stacked client dimension shards over: the ``pod`` axis on
    multi-pod meshes (one simulated client per pod slice), else the
    ``data`` axis."""
    return ("pod",) if "pod" in mesh.axis_names else ("data",)


def client_axis_size(mesh) -> int:
    size = 1
    for a in client_axes(mesh):
        size *= mesh.shape[a]
    return size


def model_axis_size(mesh) -> int:
    return mesh.shape["model"]


def n_edges(mesh) -> int:
    """Edge-aggregator count of the client -> edge -> server hierarchy:
    one edge per pod on a multi-pod mesh, else a single (flat) edge."""
    if mesh is None:
        return 1
    return int(dict(mesh.shape).get("pod", 1))


@contextlib.contextmanager
def fake_device_mesh(mesh: MeshSpec):
    """A CPU ``DeviceMesh`` shaped as ``mesh`` (its axis names the mesh
    dims') over a ``"fake"`` process group of ``prod(axis_sizes)`` ranks
    (``torch.testing._internal.distributed.fake_pg``), this process rank
    0: collectives issued on it dispatch and return buffers of the right
    shapes, and move nothing.  The group is destroyed on exit, so the
    process is left with none.  Refuses to run while another default
    group exists."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_device_mesh: a default process group "
                           "already exists")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh.axis_sizes))
    try:
        yield init_device_mesh("cpu", tuple(mesh.axis_sizes),
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()
