"""Time chip_smoke.py's phases in two trees on one card, in one call.

Runs ``python3 chip_smoke.py`` from the root of each tree in the order
A, B, B, A (each run a process of its own, one after the other), writes
each run's output to ``chiprun_out/ab/<n>_<label>.log`` and prints, for
every run, the seconds between chip_smoke.py's consecutive "done" marks,
so a phase group's time in one tree sits beside its time in the other.
A run's first "build" includes compiling the kernels; the second run of
a tree reuses that tree's build.

Usage (each tree an unpacked ``git archive`` inside the repo):
    python3 scripts/torch_chip_smoke_ab.py .archive/parent .archive/final
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

MARK = re.compile(r"^\[(\d+\.\d+) s\] (.*) done$")


def marks(text: str):
    """[(group, seconds since the previous mark)] of one run's output."""
    out, prev = [], 0.0
    for line in text.splitlines():
        m = MARK.match(line)
        if m:
            t = float(m.group(1))
            out.append((m.group(2), round(t - prev, 1)))
            prev = t
    return out


def main(argv=None):
    a, b = (argv or sys.argv[1:])[:2]
    logs = Path("chiprun_out/ab")
    logs.mkdir(parents=True, exist_ok=True)
    runs = []
    for n, (label, tree) in enumerate((("A", a), ("B", b), ("B", b),
                                       ("A", a))):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                           capture_output=True, text=True, timeout=1500)
        (logs / f"{n}_{label}.log").write_text(r.stdout + "\n--- stderr\n"
                                               + r.stderr)
        runs.append({"run": n, "tree": label, "dir": tree,
                     "rc": r.returncode, "marks": marks(r.stdout)})
        print(json.dumps(runs[-1]), flush=True)
    groups = [g for g, _ in runs[1]["marks"]]
    print(f"{'group':60s}" + "".join(f"{r['tree'] + str(r['run']):>9s}"
                                     for r in runs))
    for g in groups:
        row = []
        for r in runs:
            d = dict(r["marks"])
            row.append(f"{d[g]:9.1f}" if g in d else f"{'-':>9s}")
        print(f"{g[:60]:60s}" + "".join(row))
    return 0 if all(r["rc"] == 0 for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
