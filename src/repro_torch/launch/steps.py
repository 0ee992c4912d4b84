"""Train / prefill / decode steps.

Port of ``repro/launch/steps.py`` in eager PyTorch: a step is a plain
function over nested dicts of tensors. ``make_train_step`` takes the
gradient of ``models/model.py:loss_fn`` (a training forward: blocks under
activation checkpointing, attention through the flash backward kernel)
with ``torch.autograd.grad``, accumulates microbatches in float32 as
``acc + g / m`` in the reference's order, and applies the port's AdamW
(optim/adamw.py) at ``lr_schedule``'s rate. With ``grad_compression`` the
gradient goes through int8 error feedback first
(parallel/compression.py). Microbatching cuts stored activations by the
microbatch factor. On a mesh (DTensor batches) each rank cuts its own
rows into the m microbatches, as data-parallel accumulation does; the
gradient is the same mean. The reference's overlap of each microbatch's
reduce-scatter with the next one's backward is not ported: eager DTensor
reduces when the gradient is read.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import model as M
from repro_torch.optim import adamw


def loss_grads(params, batch, cfg: ModelConfig):
    """(gradient of ``loss_fn``'s total w.r.t. every leaf of ``params``,
    in the leaf's dtype, as a tree of ``params``' structure; ce), as the
    reference's ``jax.value_and_grad(loss, has_aux=True)``."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    total, ce = M.loss_fn(p, batch, cfg)
    grads = iter(torch.autograd.grad(total, tree_leaves(p),
                                     allow_unused=True,
                                     materialize_grads=True))
    return tree_map(lambda _: next(grads), p), ce.detach()


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """Returns ``step(params, opt, batch) -> (params, opt, metrics)``;
    with ``tcfg.grad_compression`` the signature becomes ``step(params,
    opt, batch, residual) -> (..., residual)``: int8 error-feedback
    compression of the gradient before the update."""
    m = tcfg.microbatches

    def split(v):
        """(m, B / m, ...): the batch cut into microbatches; a DTensor's
        local rows cut on each rank."""
        from torch.distributed.tensor import DTensor
        if not isinstance(v, DTensor):
            return v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))
        local = v.to_local()
        local = local.reshape((m, local.shape[0] // m)
                              + tuple(local.shape[1:]))
        shape = (v.shape[0] // m,) + tuple(v.shape[1:])
        return [DTensor.from_local(part, v.device_mesh, v.placements,
                                   run_check=False, shape=shape,
                                   stride=torch.empty(shape,
                                                      device="meta").stride())
                for part in local]

    def _grads_and_ce(params, batch):
        if m > 1:
            B = batch["tokens"].shape[0]
            assert B % m == 0, (B, m)
            micro = {k: split(v) for k, v in batch.items()}
            acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params)
            ces = []
            for i in range(m):
                g, ce = loss_grads(params, {k: v[i] for k, v in micro.items()},
                                  cfg)
                acc = tree_map(lambda a, gi: a + gi.to(torch.float32) / m,
                               acc, g)
                ces.append(ce)
            return acc, torch.mean(torch.stack(ces))
        return loss_grads(params, batch, cfg)

    def train_step(params, opt_state, batch):
        lr = adamw.lr_schedule(tcfg, opt_state.step)
        grads, ce = _grads_and_ce(params, batch)
        new_params, new_opt, om = adamw.update(grads, opt_state, params,
                                               tcfg, lr)
        return new_params, new_opt, {"loss": ce, "lr": lr, **om}

    def train_step_compressed(params, opt_state, batch, residual):
        from repro_torch.parallel import compression as GC
        lr = adamw.lr_schedule(tcfg, opt_state.step)
        grads, ce = _grads_and_ce(params, batch)
        grads, residual = GC.apply_error_feedback(grads, residual)
        new_params, new_opt, om = adamw.update(grads, opt_state, params,
                                               tcfg, lr)
        return new_params, new_opt, {"loss": ce, "lr": lr, **om}, residual

    return train_step_compressed if tcfg.grad_compression else train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig):
    def prefill_step(params, batch):
        if cfg.family == "vlm":
            return M.prefill_vlm(params, batch, cfg)
        if cfg.family in ("hybrid", "ssm"):
            # recurrent families: prefill == full forward (state capture is
            # the decode path's job; compute profile identical)
            return M.forward(params, batch, cfg).logits
        return M.prefill(params, batch, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig, shape: ShapeConfig):
    def decode_step(params, token, caches, pos):
        return M.decode_step(params, token, caches, pos, cfg)

    return decode_step


def default_microbatches(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if shape.kind != "train":
        return 1
    big = M.count_params_analytic(cfg) > 1e9
    return 8 if big else 2
