"""Device meshes of a gang (counterpart of paddle_tpu/parallel/mesh.py).

Where the JAX package's mesh is a grid of devices that one program spans,
the port's is a grid of ranks: each rank of a gang (parallel/distributed.py)
is one process on one device, and a mesh names the gang's axes.  `Mesh` is
a small plain class -- axis names, their sizes and the rank grid -- and not
a `torch.distributed.device_mesh.DeviceMesh`, which needs a process group
before it can exist.  Data parallelism uses one axis, the batch axis; a
mesh with another axis of size above 1 waits for the model-parallel paths
(ROADMAP A10.3).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np


class Mesh:
    """A grid of ranks with named axes: `devices` (the rank grid, a numpy
    array), `axis_names`, and `shape` (axis name -> size, in order, as a
    JAX mesh's `shape`)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} with axes {self.axis_names}")
        self.shape = OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other):
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and np.array_equal(self.devices, other.devices))

    def __hash__(self):
        return hash((self.axis_names, tuple(self.devices.flat)))

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, ranks={self.devices.tolist()})"


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("dp",),
    devices=None,
) -> Mesh:
    """Build a Mesh.  Default: a 1-D `dp` mesh over every rank of the gang
    (one rank when no gang is initialized)."""
    if devices is None:
        from . import distributed

        devices = list(range(distributed.num_trainers()))
    devices = list(devices)
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        raise ValueError(f"mesh wants {n} devices, only {len(devices)} available")
    arr = np.asarray(devices[:n]).reshape(tuple(axis_sizes))
    return Mesh(arr, tuple(axis_names))


def data_axis_size(mesh, batch_axis: str = "dp") -> int:
    """The size of `mesh`'s batch axis, after checking that no other axis
    is larger than 1: those come with the model-parallel paths."""
    shape = dict(getattr(mesh, "shape", None) or {})
    if not shape:
        raise NotImplementedError(
            f"mesh {mesh!r}: only a Mesh of parallel.make_mesh is supported; "
            "other meshes come with the model-parallel paths (ROADMAP A10.3)")
    other = {a: n for a, n in shape.items() if a != batch_axis and n > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other} besides the batch axis {batch_axis!r}: sharding "
            "hints and model parallelism come with the model-parallel paths "
            "(ROADMAP A10.3)")
    return int(shape.get(batch_axis, 1))
