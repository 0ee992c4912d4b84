"""Time the bf16 flash forward's decode route pass by pass on one NVIDIA GPU:
the split pass and the combine pass apart, at ``chip_smoke.py``'s decode
shapes (the VLM's cross decode, Whisper's and one query at G 8, D 128).

    python3 scripts/torch_flash_decode_passes.py [--src DIR] [--decode-ctas N]

``--src`` (default: this checkout's ``src``) is the directory that holds
the ``repro_torch`` package whose kernels are built and timed, so one call
can time a variant tree unpacked under ``.archive/`` beside this one.
``--decode-ctas`` overrides the split target of ``decode_splits``
(``DECODE_CTAS``) for the run, to see how the split count moves the time.
Prints the card's name and power limit, then one line a shape: the split
count, each pass's device time a call from ``torch.profiler`` (50 calls
back to back) and the largest error against the plain version.
"""
import argparse
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (label, B, Skv, H, KH, D): one query each, non-causal
SHAPES = (("vlm cross decode", 4, 1601, 32, 8, 128),
          ("whisper decode cross", 4, 1500, 12, 12, 64),
          ("G 8 decode", 4, 1024, 32, 4, 128))
REPS = 50


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory holding the repro_torch package")
    ap.add_argument("--decode-ctas", type=int, default=0,
                    help="the split target in place of DECODE_CTAS")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build as KB
    from repro_torch.kernels.flash_attention import flash_attention as FA
    if not torch.cuda.is_available():
        sys.exit("torch_flash_decode_passes: CUDA is not available")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.decode_ctas:
        FA.DECODE_CTAS = args.decode_ctas
    KB.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for label, B, Skv, H, KH, D in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16)
                   for shape in ((B, 1, H, D), (B, Skv, KH, D),
                                 (B, Skv, KH, D)))
        got = FA.flash_attention_fwd(q, k, v, causal=False)
        want = FA.flash_attention_plain(q, k, v, causal=False)
        err = (got.float() - want.float()).abs().max().item()
        for _ in range(5):
            FA.flash_attention_fwd(q, k, v, causal=False)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                FA.flash_attention_fwd(q, k, v, causal=False)
            torch.cuda.synchronize()
        passes = {}
        for ev in prof.key_averages():
            name = re.search(r"flash_fwd_\w+", ev.key)
            if name:
                t = getattr(ev, "device_time_total", None)
                t = ev.cuda_time_total if t is None else t
                passes[name.group(0)] = (passes.get(name.group(0), 0.0)
                                         + t / REPS)
        # a tree from before the decode route has no decode_splits
        splits = (FA.decode_splits(B, 1, Skv, H, KH, torch.bfloat16)
                  if hasattr(FA, "decode_splits") else 0)
        print(f"{label} (B {B}, Skv {Skv}, H {H}, KH {KH}, D {D}): "
              f"{splits} splits; device {sum(passes.values()):.2f} us = "
              + " + ".join(f"{n} {t:.2f}" for n, t in sorted(passes.items()))
              + f"; max abs err {err:.3g}", flush=True)


if __name__ == "__main__":
    main()
