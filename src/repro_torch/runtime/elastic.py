"""Elastic scaling: survive device loss by re-meshing and restarting from
the latest checkpoint.

Port of ``repro/runtime/elastic.py``. The pattern is checkpoint-restart:

    1. a step deadline or heartbeat miss marks the job degraded
       (runtime/straggler.py),
    2. the launcher re-enumerates healthy devices and picks the largest
       feasible (data, model) mesh (``plan_degraded_mesh``),
    3. the job restarts from the latest checkpoint (runtime/checkpoint.py)
       and rescales the batch (``rescale_batch``).

``remesh`` returns a ``DeviceMesh`` over the first ``devices_needed``
surviving ranks in the candidate's shape and axes; ``checkpoint.load(...,
shardings=plan.param_shardings(cfg))`` on a plan over it reshards the
checkpoint onto it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MeshCandidate:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    devices_needed: int


def plan_degraded_mesh(healthy_devices: int,
                       prefer_model: int = 16) -> MeshCandidate:
    """Largest (data, model) mesh that fits the surviving devices.

    Keeps the model axis at the largest power-of-two divisor <=
    prefer_model (the tensor-parallel degree must divide weight dims),
    spends the rest on data. The launcher rescales the batch to keep the
    per-device batch constant.
    """
    assert healthy_devices >= 1
    model = 1
    while model * 2 <= min(prefer_model, healthy_devices):
        model *= 2
    data = healthy_devices // model
    return MeshCandidate(shape=(data, model), axes=("data", "model"),
                         devices_needed=data * model)


def remesh(candidate: MeshCandidate, devices: Optional[Sequence[int]] = None,
           device_type: str = "cuda"):
    """A ``DeviceMesh`` of the candidate's shape and axes over the first
    ``devices_needed`` of ``devices``, ranks of the running process group
    (default: every rank)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if devices is None:
        devices = range(dist.get_world_size())
    ranks = [int(r) for r in devices][: candidate.devices_needed]
    if len(ranks) < candidate.devices_needed:
        raise ValueError(f"{candidate} needs {candidate.devices_needed} "
                         f"ranks, got {len(ranks)}")
    return DeviceMesh(device_type,
                      torch.tensor(ranks).reshape(candidate.shape),
                      mesh_dim_names=candidate.axes)


def rescale_batch(global_batch: int, old_data: int, new_data: int) -> int:
    """Keep per-device batch constant across the re-mesh."""
    per_dev = max(global_batch // old_data, 1)
    return per_dev * new_data
