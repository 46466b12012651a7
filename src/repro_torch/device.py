"""Device selection for the port's entry points.

Every entry point that places records on a device (``SphereEngine``,
``RecordBatch.from_bytes``, the array executor) takes an explicit
``device``.  Leaving it out means CUDA: the port is written for the GPU,
and a machine without one must say so rather than quietly run the CPU
path.  Tests pass ``device="cpu"`` to run the plain PyTorch versions.
An entry point bound to a mesh keeps its records on the mesh's device.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda`` and
    raises when CUDA is unavailable."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def mesh_device(mesh=None, device=None) -> torch.device:
    """The device of an entry point bound to ``mesh``: the mesh's, which
    an explicit ``device`` must name (``"cuda"`` names any GPU); without a
    mesh, :func:`resolve_device`."""
    from repro_torch.parallel.mesh_utils import Mesh
    if mesh is None:
        return resolve_device(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch Mesh "
                        f"(launch.mesh.make_flat_mesh), got "
                        f"{type(mesh).__name__}")
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.device.type \
                or want.index not in (None, mesh.device.index):
            raise ValueError(f"device {want} is not the mesh's device "
                             f"{mesh.device}")
    return mesh.device
