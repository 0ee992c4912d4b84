"""End-to-end trainer: data pipeline -> train loop with
checkpoint/resume, async saves and a straggler watchdog.

Port of ``repro/launch/train.py``. Without a mesh the trainer runs on one
device, ``device="cuda"`` (the default; the CPU only when asked for, never
as a fallback). With ``mesh=`` (a ``DeviceMesh``, launch/mesh.py) it runs
the reference's mesh path: ``make_plan(..., "train")`` under the
reference's ``MeshConfig()``, the parameters, the optimizer state and
each batch laid out as DTensors by the plan (parallel/sharding.py), and
the step under ``activation_rules(plan.act_rules)``, where a plain tensor
the model makes (positions, masks) counts as replicated, as GSPMD
replicates it. Attention runs the kernels on each rank's local shards
(models/attention.py), AdamW updates local shards (optim/adamw.py) and
checkpoints gather and reshard (runtime/checkpoint.py). On a 1 x 1 mesh
the run is bit-equal to the mesh-less one. Parameters come from
``layers.init_params_keyed`` with the reference's key, so they are the
reference's ``M.init_params(cfg, PRNGKey(seed))``; the step is
``launch/steps.py:make_train_step`` (a training forward with
checkpointed blocks and the flash backward kernel), the data
``data/pipeline.py``'s counter-based batches, checkpoints
``runtime/checkpoint.py``'s format.

The audio and vlm families are refused up front: their forward reads
frames or patches beside the tokens, and the reference's trainer hands
its step only the pipeline's tokens, so it raises on them (``KeyError``
on 'frames', ``AttributeError`` on the missing patches). ``loss_fn`` and
``make_train_step`` train them on a batch that carries its memory.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_135m \
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
    # on the CPU at the smoke size:
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 20 \
        --batch 4 --seq 64 --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.configs.base import MeshConfig, ShapeConfig, TrainConfig
from repro_torch.core import prng
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.parallel.act_sharding import activation_rules, is_dtensor
from repro_torch.parallel.sharding import distribute, make_plan
from repro_torch.runtime.checkpoint import AsyncCheckpointer, latest_step, load
from repro_torch.runtime.straggler import StepWatchdog


def init_train_state(cfg, tcfg: TrainConfig, device="cuda"):
    """(params, AdamW state): the reference's ``M.init_params(cfg,
    PRNGKey(tcfg.seed))`` on ``device`` and fresh moments."""
    params = L.init_params_keyed(prng.PRNGKey(tcfg.seed), M.model_defs(cfg),
                                 M.torch_dtype(cfg.dtype), device=device)
    return params, adamw.init(params, tcfg)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


@contextlib.contextmanager
def _mesh_scope(plan, mesh):
    """A step on ``mesh``: the plan's activation rules, and plain tensors
    mixed with DTensors taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    with activation_rules(plan.act_rules, mesh=mesh), implicit_replication():
        yield


def _value(x) -> float:
    """A 0-dim tensor's value (a DTensor's reduced over its mesh)."""
    return float(x.full_tensor() if is_dtensor(x) else x)


def train(cfg, tcfg: TrainConfig, *, batch: int, seq: int, steps: int,
          ckpt_dir: str = None, ckpt_every: int = 50, device="cuda",
          mesh=None, log_every: int = 10, resume: bool = True):
    """Train ``steps`` steps (from the latest checkpoint's step when
    resuming) -> (params, opt_state, the losses of the steps run); with
    ``mesh`` the state comes back as DTensors laid out by the plan."""
    if cfg.family in M.MEMORY_KEYS:
        raise NotImplementedError(
            f"{cfg.family}: train is refused, as the reference cannot run "
            f"it: its trainer feeds the step only the pipeline's tokens, and "
            f"the forward reads {M.MEMORY_KEYS[cfg.family]!r} beside them; "
            f"train on batches that carry it through launch/steps.py:"
            f"make_train_step")
    device = torch.device(device) if mesh is None else _mesh_device(mesh)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--device "
                           "cpu) to train on the CPU")
    params, opt_state = init_train_state(cfg, tcfg, device)
    shardings = None
    if mesh is not None:
        plan = make_plan(cfg, ShapeConfig("custom", "train", seq, batch),
                         mesh, MeshConfig(), "train")
        shardings = (plan.param_shardings(cfg), plan.opt_shardings(cfg))
        params, opt_state = distribute((params, opt_state), shardings)
        batch_sh = plan.batch_shardings(cfg, "train")
        scope = functools.partial(_mesh_scope, plan, mesh)
    else:
        scope = contextlib.nullcontext
    start_step = 0

    ckpt = None
    if ckpt_dir:
        ckpt = AsyncCheckpointer(ckpt_dir)
        last = latest_step(ckpt_dir)
        if resume and last is not None:
            (params, opt_state), manifest = load(
                ckpt_dir, (params, opt_state), shardings=shardings)
            start_step = manifest["step"]
            print(f"[train] resumed from step {start_step}")

    pipe = TokenPipeline(DataConfig(cfg.vocab_size, seq, batch,
                                    seed=tcfg.seed),
                         shard=0, num_shards=1)
    step_fn = make_train_step(cfg, tcfg)
    watchdog = StepWatchdog()
    losses = []
    for step in range(start_step, steps):
        tokens = {k: torch.from_numpy(v).to(device)
                  for k, v in pipe.batch(step).items()}
        if mesh is not None:
            tokens = distribute(tokens, batch_sh)
        watchdog.start_step()
        with scope():
            params, opt_state, metrics = step_fn(params, opt_state, tokens)
        loss = _value(metrics["loss"])       # waits for the step's kernels
        slow = watchdog.end_step()
        losses.append(loss)
        if log_every and (step + 1) % log_every == 0:
            print(f"[train] step {step+1}: loss={loss:.4f} "
                  f"gnorm={_value(metrics['grad_norm']):.3f} "
                  f"p50={watchdog.p50 and round(watchdog.p50, 3)}s"
                  + (" SLOW" if slow else ""))
        if ckpt and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state), meta={"loss": loss})
        if watchdog.should_escalate:
            print("[train] straggler escalation -> checkpoint + exit "
                  "for re-mesh (runtime/elastic.py)")
            break
    if ckpt:
        ckpt.save(steps, (params, opt_state),
                  meta={"loss": losses[-1] if losses else None})
        ckpt.wait()
    return params, opt_state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm_135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, where the kernels' plain "
                         "versions run")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps,
                       microbatches=args.microbatches)
    t0 = time.time()
    _, _, losses = train(cfg, tcfg, batch=args.batch, seq=args.seq,
                         steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, device=args.device)
    if losses:
        print(f"[train] done in {time.time()-t0:.1f}s  "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
