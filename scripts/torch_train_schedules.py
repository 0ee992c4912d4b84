"""The first training steps of MiniCPM3-4B and Zamba2-1.2B under four
learning-rate schedules, on one NVIDIA GPU.

Each family trains at every width and depth through
``launch/train.py:train`` from the reference's keyed init (seed 0) on
the pipeline's batches of 8 x 1024 tokens, ``STEPS`` steps a schedule,
with ``chip_smoke.py``'s moment dtype for it (bf16 for MiniCPM3-4B:
float32 moments would not fit the card beside the update's copies). For
each schedule it prints the loss and the gradient's global norm at every
step (``[train]`` lines) and the loss curve. The schedules:

- ``chip_smoke.py``'s ``TRAIN_TCFG``: lr 1e-3, 5 warm-up steps of 30;
- the reference CLI's rate (3e-4) in that schedule;
- the reference CLI's own config for a run of ``STEPS`` steps: 3e-4, 10
  warm-up steps, ``total_steps=STEPS``;
- the reference's default ``TrainConfig()``: 3e-4, 100 warm-up steps of
  1000.

    python3 scripts/torch_train_schedules.py [arch ...]
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402

STEPS, SHAPE = 5, (8, 1024)
MOMENTS = {"minicpm3_4b": "bfloat16", "zamba2_1_2b": "float32"}
SCHEDULES = {
    "TRAIN_TCFG (1e-3, 5 warm-up of 30)":
        dict(learning_rate=1e-3, warmup_steps=5, total_steps=30),
    "the CLI's rate in it (3e-4, 5 of 30)":
        dict(learning_rate=3e-4, warmup_steps=5, total_steps=30),
    f"the CLI (3e-4, 10 warm-up, {STEPS} total)":
        dict(learning_rate=3e-4, warmup_steps=10, total_steps=STEPS),
    "TrainConfig() (3e-4, 100 of 1000)": {},
}


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("torch_train_schedules: CUDA is not available")
    print(torch.cuda.get_device_name(0))
    for arch in argv or list(MOMENTS):
        cfg = get_config(arch)
        for name, kw in SCHEDULES.items():
            tcfg = TrainConfig(moment_dtype=MOMENTS[arch], **kw)
            print(f"{cfg.name}, {name}, {tcfg.moment_dtype} moments:",
                  flush=True)
            params, opt, losses = TR.train(
                cfg, tcfg, batch=SHAPE[0], seq=SHAPE[1], steps=STEPS,
                log_every=1, device="cuda")
            print("  losses: " + " ".join(f"{x:.4f}" for x in losses)
                  + f" (fell {losses[0] - losses[-1]:.4f})", flush=True)
            del params, opt
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
