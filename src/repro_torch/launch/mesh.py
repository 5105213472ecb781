"""The production mesh (the port of ``repro.launch.mesh``).

A mesh here is a description: its axis names and their sizes, the two
things ``dist.sharding`` reads.  Building it touches no device and no
process group; ``Mesh.to_device_mesh`` makes the
``torch.distributed`` mesh once a process group of its size exists.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    dims: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.dims) != len(self.axis_names):
            raise ValueError(f"mesh dims {self.dims} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def coords(self, rank: int) -> dict:
        """Axis name -> coordinate of ``rank``, row-major (the last axis
        varies fastest, as in ``DeviceMesh``)."""
        out = {}
        for name, n in zip(reversed(self.axis_names), reversed(self.dims)):
            rank, out[name] = divmod(rank, n)
        return {a: out[a] for a in self.axis_names}

    def to_device_mesh(self, device_type: str = "cuda"):
        """This mesh as a ``torch.distributed.device_mesh.DeviceMesh`` over
        the default process group, which must have ``size`` ranks."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        if not dist.is_initialized() or dist.get_world_size() != self.size:
            raise RuntimeError(f"a {self.dims} mesh needs an initialised "
                               f"process group of {self.size} ranks")
        return DeviceMesh(device_type,
                          torch.arange(self.size).reshape(self.dims),
                          mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 devices, or 2 x 16 x 16 = 512 over two pods."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small (data, model) mesh (tests, one host)."""
    return Mesh((data, model), ("data", "model"))
