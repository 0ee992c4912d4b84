"""Time the flash-attention backward (or, with ``--forward``, the forward)
of one source tree on one NVIDIA GPU, over the cases and gates of this
checkout's ``chip_smoke.py``.

``chip_smoke.py``'s flash phase times only its own tree's kernels. To
compare a change with its parent on one card, unpack the parent with
``git archive`` under ``.archive/`` and call this script once per tree in
one command, parent, change, change, parent:

    for t in .archive/parent/src src src .archive/parent/src; do
        python3 scripts/torch_flash_bwd_compare.py --src $t; done

``--forward`` runs the forward's cases instead: every case of
``FLASH_CASES`` and ``CROSS_FLASH_CASES``, float32 and bf16, so one loop
gives the float32 kernel's parent times and the bf16 cases' check that
they did not move. ``--window`` runs the backward's windowed and offset
cases (``WINDOW_BWD_CASES``) after ``BWD_CASES``; the tree must take the
window. ``--case LABEL`` (repeatable) keeps only the cases of those
labels, e.g. ``--forward --case "vlm cross decode"``.

``--src`` (default: this checkout's ``src``) is the directory that holds
the ``repro_torch`` package whose kernels are built (into that package's
gitignored ``kernels/_build/``) and timed; its wrapper's interface must be
this checkout's. Prints the card's name and power limit, the build and
every kernel's registers and spill bytes, then one line per case of
``BWD_CASES`` (or of the forward's cases), as ``chip_smoke.py`` prints
them (device time by ``torch.profiler``, the event time, the plain
version, SDPA, the bound; each case passes its gates or the script
fails).
"""
import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory holding the repro_torch package "
                         "to time")
    ap.add_argument("--forward", action="store_true",
                    help="time the forward's cases, not the backward's")
    ap.add_argument("--window", action="store_true",
                    help="also time the backward's windowed cases")
    ap.add_argument("--case", action="append", default=[],
                    help="keep only the cases of this label (repeatable)")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    # import that tree's package first: chip_smoke's own imports then find
    # it in sys.modules, whatever it puts on sys.path
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.kernels.flash_attention import flash_attention as FA
    if not hasattr(FA, "decode_splits"):
        # a tree from before the decode route: every call takes the
        # prefill kernel (the flash lines print no split count)
        FA.decode_splits = lambda *shape: 0
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_flash_bwd_compare: CUDA is not available")
    import chip_smoke as C
    print(f"tree: {Path(repro_torch.__file__).resolve().parents[1]}")
    C.phase_card_and_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(C.SEED)
    if args.case:
        names = ("FLASH_CASES", "CROSS_FLASH_CASES") if args.forward \
            else ("BWD_CASES", "WINDOW_BWD_CASES") if args.window \
            else ("BWD_CASES",)
        for name in names:
            setattr(C, name, tuple(c for c in getattr(C, name)
                                   if c[0] in args.case))
        kept = sum(len(getattr(C, name)) for name in names)
        if kept != len(set(args.case)):
            sys.exit(f"torch_flash_bwd_compare: {kept} cases match "
                     f"{args.case}")
    cases = C._flash_fwd_cases if args.forward else C._flash_bwd_cases
    cases(torch.device("cuda"), gen)
    if args.window and C.WINDOW_BWD_CASES:
        torch.cuda.empty_cache()
        C._flash_window_bwd_cases(torch.device("cuda"), gen)


if __name__ == "__main__":
    main()
