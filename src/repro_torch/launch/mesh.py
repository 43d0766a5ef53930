"""Device meshes over the default process group (the port of the
reference's ``repro.launch.mesh``).

Each function builds a named :class:`~torch.distributed.device_mesh.DeviceMesh`
over the whole world, so the process group must be up with exactly the
world the mesh needs (:func:`repro_torch.launch.procgroup.init_process_group`);
a different world raises ``ValueError``, naming the world wanted.  There
is no module-level mesh: importing this module touches no process group.
"""

from __future__ import annotations

import math
from typing import Tuple

__all__ = ["batch_axes", "make_production_mesh", "make_test_mesh"]


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else None
    if world != need:
        have = f"a world of {world}" if world is not None else "no process group"
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh {axes} needs a process group of "
                         f"exactly {need} ranks; there is {have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod.

    Axis semantics: "pod" = pure data parallelism across pods (gradient
    all-reduce only); "data" = the data/FSDP axis within a pod; "model" =
    the tensor/sequence-parallel axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 0, device_type: str = "cuda"):
    """A small mesh with the same axis names."""
    if pod:
        return _make_mesh((pod, data, model), ("pod", "data", "model"), device_type)
    return _make_mesh((data, model), ("data", "model"), device_type)


def batch_axes(mesh) -> tuple:
    """The physical axes the global batch shards over."""
    from repro_torch.distributed.sharding import mesh_axes

    names, _ = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)
