"""AdamW with optional reduced-precision moments, as plain functions on
nested dicts of tensors.

Port of ``repro/optim/adamw.py``. Its arithmetic, not
``torch.optim.AdamW``'s: the gradients are clipped by their global norm
(with ``+1e-9``), the bias corrections are computed in float32 from an
int32 step, weight decay is added to the step only for leaves of two or
more dims, and the moments are stored in ``moment_dtype`` while the update
runs in float32. ``moment_dtype="bfloat16"`` halves the optimizer state.
The update is elementwise, so a large leaf is updated in slices of
``UPDATE_CHUNK`` elements into its new tensors, with the same result: the
float32 temporaries of one leaf of 10^9 values (MiniCPM3-4B's stacked
MLP) would otherwise take ~36 GB beside the old and new state. With
``donate=True`` the new values are written into the old parameters and
moments, slice by slice, and those tensors come back: the counterpart of
the reference trainer's ``jax.jit(step, donate_argnums=(0, 1))``, with
the same bits and no second copy of the state (a caller that still reads
the old state must not donate it).

On a device mesh (launch/train.py's ``mesh=``) the leaves are DTensors
laid out by the sharding plan, the moments as their parameters. A
gradient comes back in whatever layout autograd leaves (``Partial(sum)``
for a replicated leaf read by sharded activations) and is first
redistributed to its parameter's placements; the global norm is DTensor
arithmetic, so it reduces across ranks; the step count and rate are
replicated scalars; the update itself runs on each rank's local shards,
slices and all, and is wrapped back in the parameter's placements. On a
1 x 1 mesh every result is bit-equal to the mesh-less update.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.parallel.act_sharding import is_dtensor

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
UPDATE_CHUNK = 1 << 26          # elements of a leaf updated at once


class AdamWState(NamedTuple):
    step: torch.Tensor              # 0-dim int32
    mu: Any
    nu: Any


def init(params, cfg: TrainConfig) -> AdamWState:
    dt = _DTYPES[cfg.moment_dtype]
    leaf = tree_leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def _local(x):
    """A replicated DTensor's value (a rank's shard of a sharded one) as
    a plain tensor; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def _as_param(g, p):
    """A gradient in its parameter's layout."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _like(t: torch.Tensor, p):
    """A rank's local result ``t`` wrapped in ``p``'s layout (``t`` as it
    is when ``p`` is a plain tensor)."""
    if not is_dtensor(p):
        return t
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def _pow32(b: float, step: torch.Tensor) -> torch.Tensor:
    """``float32(b) ** float32(step)`` rounded once to float32: computed
    in float64, which agrees with XLA's float32 power where torch's
    float32 ``pow`` is off by an ulp at some steps."""
    base = torch.tensor(float(np.float32(b)), dtype=torch.float64,
                        device=step.device)
    return torch.pow(base, step.to(torch.float64)).to(torch.float32)


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: TrainConfig, lr, *,
           donate: bool = False):
    """Returns (new_params, new_state, metrics); with ``donate`` the new
    parameters and moments are ``params``' and ``state``'s tensors,
    overwritten (module docstring)."""
    grads = tree_map(_as_param, grads, params)
    gnorm = global_norm(grads)
    scale = _local(torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)) \
        if cfg.grad_clip > 0 else 1.0
    lr = _local(lr)
    step = _local(state.step) + 1
    c1 = 1.0 - _pow32(cfg.b1, step)
    c2 = 1.0 - _pow32(cfg.b2, step)
    dt = _DTYPES[cfg.moment_dtype]

    def upd_slice(g, m, v, p, decay):
        g = g.to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + 1e-8)
        if decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        return new_p.to(p.dtype), m32.to(dt), v32.to(dt)

    def upd(g, m, v, p):
        out = upd_local(*(_local(t) for t in (g, m, v, p)))
        if donate:
            return p, m, v
        return tuple(_like(t, p) for t in out)

    def upd_local(g, m, v, p):
        decay = cfg.weight_decay > 0 and p.dim() >= 2
        n, chunk = p.numel(), UPDATE_CHUNK
        if n <= chunk and not donate:
            return upd_slice(g, m, v, p, decay)
        if donate:
            out = (p, m, v)
        else:
            out = (torch.empty_like(p),
                   torch.empty(p.shape, dtype=dt, device=p.device),
                   torch.empty(p.shape, dtype=dt, device=p.device))
        flat = [t.reshape(-1) for t in (g, m, v, p)]
        for a in range(0, n, chunk):
            part = upd_slice(*(t[a:a + chunk] for t in flat), decay)
            for o, x in zip(out, part):
                o.view(-1)[a:a + chunk] = x
        return out

    out = tree_map(upd, grads, state.mu, state.nu, params)
    new_params = tree_map(lambda t: t[0], out)
    new_mu = tree_map(lambda t: t[1], out)
    new_nu = tree_map(lambda t: t[2], out)
    return new_params, AdamWState(_like(step, state.step), new_mu, new_nu), {
        "grad_norm": gnorm}


def lr_schedule(cfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay; ``step`` is the optimizer's
    pre-increment step."""
    s = step.to(torch.float32) + 1.0
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.learning_rate * warm * 0.5 * (1 + torch.cos(math.pi * prog))
