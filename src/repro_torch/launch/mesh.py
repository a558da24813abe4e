"""Mesh builders (the port of ``repro.launch.mesh``).

Functions, not module-level constants, so importing never touches the
process group. The caller initializes ``torch.distributed`` first (NCCL on
the card; ``init_process_group`` with its own address, world size and
rank, since nothing on the machine announces a cluster).

  single pod : (16, 16)        axes (data, model)      — 256 ranks
  multi  pod : (2, 16, 16)     axes (pod, data, model) — 512 ranks
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _make(shape, axes, device_type: str) -> DeviceMesh:
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"the process group has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device_type: str = "cuda") -> DeviceMesh:
    """A small (data, model) mesh over the whole process group: the CPU
    ranks of the tests (``device_type="cpu"`` over gloo), or a world of
    one over NCCL on the card."""
    return _make((n_data, n_model), ("data", "model"), device_type)
