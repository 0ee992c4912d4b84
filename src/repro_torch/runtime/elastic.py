"""Elastic scaling: survive device loss by re-meshing and restarting from
the latest checkpoint.

Port of ``repro/runtime/elastic.py``. The pattern is checkpoint-restart:

    1. a step deadline or heartbeat miss marks the job degraded
       (runtime/straggler.py),
    2. the launcher re-enumerates healthy devices and picks the largest
       feasible (data, model) mesh (``plan_degraded_mesh``),
    3. the job restarts from the latest checkpoint (runtime/checkpoint.py)
       and rescales the batch (``rescale_batch``).

``remesh`` returns the chosen devices laid out in the candidate's shape;
building a ``DeviceMesh`` over them, and loading a checkpoint sharded onto
it, is ROADMAP 12f.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
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


def remesh(candidate: MeshCandidate,
           devices: Optional[Sequence] = None) -> np.ndarray:
    """The first ``devices_needed`` of ``devices`` (default: every CUDA
    device) as an object array of the candidate's shape."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)[: candidate.devices_needed]
    if len(devs) < candidate.devices_needed:
        raise ValueError(f"{candidate} needs {candidate.devices_needed} "
                         f"devices, got {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr.reshape(candidate.shape)


def rescale_batch(global_batch: int, old_data: int, new_data: int) -> int:
    """Keep per-device batch constant across the re-mesh."""
    per_dev = max(global_batch // old_data, 1)
    return per_dev * new_data
