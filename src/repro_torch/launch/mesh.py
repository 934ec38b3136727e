"""Mesh construction (port of the reference's ``repro/launch/mesh.py``).

``make_production_mesh`` and ``make_mesh`` are FUNCTIONS (not module
constants), so importing this module never touches a device or a process
group.  Both build a ``DeviceMesh`` over the default process group with
``init_device_mesh``, on the card's device type (``"cuda"``) unless
``device_type`` says otherwise; the caller starts the process group
(``torchrun`` or ``torch.distributed.init_process_group``).  With a world
size other than the mesh's they raise, naming the size they need.
"""
from __future__ import annotations

import math

import torch.distributed as dist

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def make_mesh(shape, axes, device_type: str = "cuda"):
    """Elastic-scaling entry point: any (shape, axes) the process group
    allows, ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(shape), tuple(axes)
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have != need:
        raise RuntimeError(f"mesh {shape} {axes} needs a world of {need} "
                           f"ranks, got {have} (start it with torchrun "
                           f"--nproc-per-node or init_process_group)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod: (pod=2, data=16, model=16) = 512 ranks."""
    if multi_pod:
        return make_mesh(MULTI_POD_SHAPE, MULTI_POD_AXES, device_type)
    return make_mesh(PRODUCTION_SHAPE, PRODUCTION_AXES, device_type)
