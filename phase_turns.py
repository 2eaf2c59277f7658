#!/usr/bin/env python3
"""Time chip_smoke.py's phases 10 and 11 of this checkout and of another
one in turns on one machine.

    python3 phase_turns.py OTHER_ROOT [--seed N] [--phases tasks dag]

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked with `git archive <commit> | tar -x -C parent_tree`
(parent_tree/ is gitignored).  Each turn runs the named phases of one
checkout's chip_smoke.py at full size in a process of its own, from that
checkout's root (each builds its kernels into its own _build/), in the
order other, this, this, other.  Every check of the phases holds as in
chip_smoke.py.  Each phase's "phase ...: wall_s=..." lines are collected;
the last line is one JSON object of them by checkout and turn.  Without a
card the script exits non-zero before any turn.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

PHASES = {"tasks": "task_phase", "dag": "dag_phase"}
WALL = re.compile(r"^phase (.+?): wall_s=([0-9.]+)(.*)$")


def turn(root: str, phases, seed: int) -> dict:
    code = ("import sys, types, chip_smoke as c\n"
            "from tez_tpu_torch.ops import _build\n"
            "_build.build()\n"
            "args = types.SimpleNamespace(seed=%d)\n" % seed +
            "".join(f"c.{PHASES[p]}(args)\n" for p in phases))
    proc = subprocess.run([sys.executable, "-u", "-c", code], cwd=root,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    walls = {}
    for line in proc.stdout.splitlines():
        m = WALL.match(line.strip())
        if m:
            walls[m.group(1)] = float(m.group(2))
            print(f"{os.path.basename(root)}: {line.strip()}", flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], file=sys.stderr)
        raise SystemExit(f"{root}: phases failed (exit {proc.returncode})")
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_root")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", nargs="+", default=list(PHASES),
                    choices=list(PHASES))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("phase_turns: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(args.other_root)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), f"nproc {os.cpu_count()}", flush=True)
    out = {"card": card.strip(), "nproc": os.cpu_count(),
           "this": [], "other": []}
    for which, root in (("other", other), ("this", here), ("this", here),
                        ("other", other)):
        out[which].append(turn(root, args.phases, args.seed))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
