"""Mesh definitions, port of `repro.launch.mesh`, over the ranks of an
initialised `torch.distributed` process group.

Functions, not module constants: importing this module touches no device
and no process group. The device type of a mesh follows the default
group's backend (NCCL: "cuda", else "cpu") unless it is given; the
tensors a mesh shards must lie on that device type (the Trainer and
k-means raise otherwise).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist

from repro_torch.config import MeshConfig


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = None):
    """A DeviceMesh of `shape` named `axes` over every rank of the world;
    raises ValueError when the world does not have prod(shape) ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"a {tuple(shape)} mesh needs {need} ranks; the "
                         f"world has {world}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16 x 16 ("data", "model") a pod; 2 x 16 x 16 ("pod", "data",
    "model") over two pods. "data" carries DP and the FSDP weight shards,
    "model" TP/EP, "pod" the slow cross-pod DP axis. Needs 256 or 512
    ranks."""
    mc = MeshConfig(multi_pod=multi_pod)
    return make_mesh(mc.shape, mc.axes, device_type)


def make_host_mesh(device_type: Optional[str] = None):
    """A 1-D "data" mesh over every rank of the world."""
    return make_mesh((dist.get_world_size(),), ("data",), device_type)
