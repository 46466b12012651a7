"""The port's mesh: one rank of a ``torch.distributed`` process group.

The port of ``repro.parallel.mesh_utils``.  A JAX ``Mesh`` is a grid of
devices driven by one controller; ``torch.distributed`` runs one process
per rank, so the port's :class:`Mesh` is what ONE rank knows of that
grid: the axis names and sizes, the process group its collectives run
over, its own rank, and the device its tensors live on.  ``shape`` is a
mapping (``{"data": D}``), as ``jax.sharding.Mesh.shape`` is, so callers
read ``mesh.shape.get("data", 1)`` in both packages.

A mesh with no process group (``group is None``) has one rank: its
collectives are the identity (:mod:`repro_torch.core.spmd`).

``host_group`` carries the host's own exchanges (the engine's plan
digests) on CPU tensors, so they never wait on a device stream: the
group itself over gloo, a gloo group beside it over NCCL.

A mesh of several axes also carries a process group for every
combination of axes that is neither one rank nor the whole mesh
(``groups``, keyed by the axis names in mesh order), so that a
collective runs over one axis (``"data"``), or over several
(``("pod", "data")``), of a 2-D or 3-D grid: :meth:`Mesh.group_for`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from types import MappingProxyType
from typing import Iterable, Mapping, Optional, Sequence, Union

import torch

from repro_torch.device import resolve_device

@dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a device mesh.

    ``shape`` maps each axis name to its size, in ``axis_names`` order;
    ``size`` is their product, the ranks of ``group``.  ``rank`` is this
    process's rank in ``group`` and ``device`` the device its blocks live
    on.  ``backend`` names the group's transport (``"nccl"``, ``"gloo"``)
    or is ``None`` without a group.  ``host_group`` is a gloo group over
    the same ranks for exchanges of host values; it defaults to ``group``
    when that is gloo.  ``groups`` maps each combination of axes (names
    in mesh order) that spans more than one rank and fewer than all to
    the process group of this rank's coordinates on the other axes
    (built by :func:`repro_torch.launch.mesh.make_mesh_compat`).
    """

    axis_names: tuple
    shape: Mapping[str, int]
    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: Optional[str]
    host_group: Optional[object] = None
    groups: Optional[Mapping[tuple, object]] = None

    def __post_init__(self):
        names = tuple(self.axis_names)
        if tuple(self.shape) != names:
            raise ValueError(f"mesh shape {dict(self.shape)} does not follow "
                             f"the axis names {names}")
        if math.prod(self.shape.values()) != self.size:
            raise ValueError(f"mesh shape {dict(self.shape)} holds "
                             f"{math.prod(self.shape.values())} ranks, the "
                             f"group {self.size}")
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a group of "
                             f"{self.size}")
        if self.group is None and self.size != 1:
            raise ValueError("a mesh of several ranks needs a process group")
        if self.host_group is None and self.backend == "gloo":
            object.__setattr__(self, "host_group", self.group)
        if self.group is not None and self.host_group is None:
            raise ValueError(f"a {self.backend} mesh needs a gloo host_group")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "shape", MappingProxyType(dict(self.shape)))
        object.__setattr__(self, "device", torch.device(self.device))
        object.__setattr__(self, "groups",
                           MappingProxyType(dict(self.groups or {})))

    def axis_index(self, axis: str = "data") -> int:
        """This rank's coordinate along ``axis`` (row-major over the axes,
        as ``jax.lax.axis_index`` numbers a device)."""
        stride = 1
        for name in reversed(self.axis_names):
            if name == axis:
                return (self.rank // stride) % self.shape[name]
            stride *= self.shape[name]
        raise KeyError(f"mesh has no axis {axis!r}: {self.axis_names}")

    def mesh_axes(self, axes: Union[str, Iterable[str], None]) -> tuple:
        """``axes`` (a name, names, or None) as the names of more than one
        rank, in mesh order; raises on a name the mesh lacks."""
        names = (axes,) if isinstance(axes, str) else tuple(axes or ())
        for a in names:
            if a not in self.shape:
                raise KeyError(f"mesh has no axis {a!r}: {self.axis_names}")
        return tuple(a for a in self.axis_names
                     if a in names and self.shape[a] > 1)

    def axes_size(self, axes) -> int:
        """Ranks along ``axes`` together."""
        return math.prod(self.shape[a] for a in self.mesh_axes(axes))

    def axes_index(self, axes) -> int:
        """This rank's coordinate along ``axes`` taken together, row-major
        in the order given (``("pod", "data")``: pod-major)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes or ())
        idx = 0
        for a in names:
            idx = idx * self.shape[a] + self.axis_index(a)
        return idx

    def group_for(self, axes):
        """The process group of the ranks that differ from this one only
        along ``axes``, numbered row-major in mesh order (``None`` when
        that is this rank alone: the collective is the identity)."""
        key = self.mesh_axes(axes)
        n = math.prod(self.shape[a] for a in key)
        if n == 1:
            return None
        if n == self.size:
            return self.group
        if key not in self.groups:
            raise ValueError(f"mesh {dict(self.shape)} has no process group "
                             f"for axes {key}: build it with "
                             f"launch.mesh.make_mesh_compat")
        return self.groups[key]

    @property
    def host_staged(self) -> bool:
        """Whether collectives copy device tensors to the host and back:
        on a gloo group whose ranks keep their blocks on a GPU (several
        ranks sharing one card, where NCCL refuses)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def single_device_mesh(axes: Sequence[str] = ("data", "model"), *,
                       device=None) -> Mesh:
    """A mesh of this process alone (no process group), every axis of
    size 1, on ``device``: by default CUDA, raising without a GPU (pass
    ``device="cpu"`` to run on the CPU)."""
    axes = tuple(axes)
    return Mesh(axes, {a: 1 for a in axes}, None, 0, 1,
                resolve_device(device), None)


def mesh_axis_sizes(mesh: Mesh) -> dict:
    return dict(mesh.shape)


def validate_mesh(mesh: Mesh, expect_devices: int | None = None) -> None:
    n = math.prod(mesh.shape.values())
    if expect_devices is not None and n != expect_devices:
        raise ValueError(f"mesh has {n} devices, expected {expect_devices}")
