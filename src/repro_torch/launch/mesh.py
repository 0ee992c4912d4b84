"""Device meshes over the ranks of a process group.

Port of ``repro/launch/mesh.py``: each function returns a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's shape
and axis names (``mesh_dim_names``), laid over ranks 0 .. n-1 of the
default process group in row-major order, as ``jax.make_mesh`` lays out
devices. A function, not a module-level constant: importing this module
starts no process group.

The device type is ``cuda`` unless the caller asks for ``cpu``. A mesh
needs that many ranks: a mesh larger than the world raises and names the
world size, as the reference's ``assert data * model <= n`` does; there
is no fallback to fewer ranks or to another device. ``make_host_mesh(1,
1)`` with no process group starts a one-rank group itself (NCCL on
``cuda``, gloo on ``cpu``, over an in-process ``HashStore``: no network),
the counterpart of JAX always having a device; ``end_local_group`` ends
it. The production meshes (256 and 512 ranks) are built by the dry-run
(launch/dryrun.py) over a ``fake`` process group of that size.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import MeshConfig

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def start_local_group(device_type: str = "cuda") -> None:
    """A one-rank process group over a ``HashStore``: NCCL on ``cuda``
    (bound to card 0), gloo on ``cpu``. Raises if a group exists."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already running")
    kw = {}
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: ask for device_type='cpu'")
        kw["device_id"] = torch.device("cuda", 0)
    dist.init_process_group(_BACKENDS[device_type], store=dist.HashStore(),
                            rank=0, world_size=1, **kw)


def end_local_group() -> None:
    """Destroy the default process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(shape, axes, device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0 ..
    prod(shape) - 1 of the running group."""
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(f"a {tuple(shape)} mesh needs a process group of "
                           f"{n} ranks; none is running")
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {tuple(shape)} mesh over {tuple(axes)} needs "
                         f"{n} ranks; the world size is {world}")
    ranks = torch.arange(n, dtype=torch.int64).reshape(tuple(shape))
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    cfg = MeshConfig(multi_pod=multi_pod)
    return make_mesh(cfg.shape, cfg.axes, device_type)


def make_mesh_from_config(mesh_cfg: MeshConfig,
                          device_type: str = "cuda") -> DeviceMesh:
    return make_production_mesh(multi_pod=mesh_cfg.multi_pod,
                                device_type=device_type)


def make_host_mesh(data: int = 1, model: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """A small (data, model) mesh over the running group's first ranks;
    a 1 x 1 mesh starts a one-rank group when none is running."""
    if data * model == 1 and not dist.is_initialized():
        start_local_group(device_type)
    return make_mesh((data, model), ("data", "model"), device_type)
