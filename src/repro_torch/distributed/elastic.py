"""Elastic scaling: rebuild meshes and reshard state when capacity changes
(the port of ``repro.distributed.elastic``).

The flow on a real fleet: a node dies -> the job restarts on the surviving
ranks -> ``plan_remesh`` picks the largest valid (data, model) mesh for the
new rank count -> the checkpoint restores with the new shardings
(``CheckpointManager.restore(shardings=)`` keeps each rank's shard of the
host-loaded leaves). Divisibility comes from the model config: the TP
degree must divide every model-sharded dim, and the batch the data axis.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_devices: int


def valid_tp_degrees(cfg: ArchConfig, max_tp: int = 64) -> List[int]:
    """TP degrees that divide every model-sharded dim."""
    dims = [cfg.padded_vocab]
    if cfg.n_heads:
        dims += [cfg.n_heads * cfg.head_dim_, cfg.n_kv_heads * cfg.head_dim_]
    if cfg.d_ff:
        dims.append(cfg.d_ff)
    if cfg.is_moe:
        dims.append(cfg.n_experts)
    if cfg.ssm_state:
        dims.append(cfg.d_inner)
    if "rglru" in cfg.period:
        dims.append(cfg.lru_width_)
    return [tp for tp in range(1, max_tp + 1)
            if all(d % tp == 0 for d in dims)]


def plan_remesh(n_devices: int, cfg: ArchConfig, global_batch: int,
                prefer_tp: int = 16) -> RemeshPlan:
    """Largest (data, model) mesh usable with ``n_devices`` survivors."""
    tps = [t for t in valid_tp_degrees(cfg, prefer_tp) if t <= n_devices]
    best: Optional[RemeshPlan] = None
    for tp in sorted(tps, reverse=True):
        data = n_devices // tp
        while data > 1 and global_batch % data != 0:
            data -= 1
        used = data * tp
        plan = RemeshPlan(shape=(data, tp), axes=("data", "model"),
                          dropped_devices=n_devices - used)
        if best is None or used > best.shape[0] * best.shape[1] or (
                used == best.shape[0] * best.shape[1]
                and abs(tp - prefer_tp) < abs(best.shape[1] - prefer_tp)):
            best = plan
    if best is None:
        raise ValueError(f"no valid mesh for {n_devices} devices")
    return best


def build_mesh(plan: RemeshPlan, ranks: Optional[Sequence[int]] = None,
               device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of the plan's shape over the first
    ``shape[0] * shape[1]`` of ``ranks`` (default: the world's ranks in
    order). Every rank of the world calls it; a rank left out holds no
    coordinate (``get_coordinate()`` is None)."""
    n = plan.shape[0] * plan.shape[1]
    ranks = (list(range(torch.distributed.get_world_size()))
             if ranks is None else list(ranks))
    if len(ranks) < n:
        raise ValueError(f"plan {plan.shape} needs {n} ranks, "
                         f"{len(ranks)} given")
    return DeviceMesh(device_type,
                      torch.tensor(ranks[:n]).reshape(plan.shape),
                      mesh_dim_names=plan.axes)
