#!/usr/bin/env python3
"""Time the merge-rank kernel of this checkout and of another one in turns
on one CUDA card.

    python3 merge_rank_turns.py OTHER_ROOT [--seed N]

OTHER_ROOT is another checkout of the repository, for example the parent
commit unpacked with `git archive <commit> | tar -x -C parent_tree`
(parent_tree/ is gitignored).  Both checkouts' tez_tpu_torch packages are
loaded side by side, each building its own kernels into its own _build/.
For each of chip_smoke.py's phase-2 merge-rank cases and both count_equal
flavours, each checkout's kernels.merge_rank is checked bit for bit
against this checkout's plain version, then the two are timed in turns on
the same inputs: other, this, this, other (CUDA events, 20 calls each).
Only the public wrapper is called, so any checkout whose merge_rank keeps
its contract can be compared.  The last line is one JSON object of every
time.  Without a card the script exits non-zero before timing anything.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys

import numpy as np

import chip_smoke
from chip_smoke import check, cuda_ms, log

PACKAGE = "tez_tpu_torch"


def take_package() -> dict:
    """Remove the package's modules from sys.modules and return them."""
    mods = {k: v for k, v in sys.modules.items()
            if k == PACKAGE or k.startswith(PACKAGE + ".")}
    for k in mods:
        del sys.modules[k]
    return mods


@contextlib.contextmanager
def installed(mods: dict):
    """The package as `mods` has it, for imports made inside the block
    (the kernels module imports its build module when it launches)."""
    saved = take_package()
    sys.modules.update(mods)
    try:
        yield
    finally:
        take_package()
        sys.modules.update(saved)


def load_kernels(root: str):
    """The kernels module of the checkout at `root`, and the modules of its
    package."""
    with installed({}):
        sys.path.insert(0, root)
        try:
            kernels = importlib.import_module(PACKAGE + ".ops.kernels")
        finally:
            sys.path.remove(root)
        return kernels, {k: v for k, v in sys.modules.items()
                         if k == PACKAGE or k.startswith(PACKAGE + ".")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_root")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("merge_rank_turns: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"this": load_kernels(here),
             "other": load_kernels(os.path.abspath(args.other_root))}
    plain = trees["this"][0]._rank_search
    log(chip_smoke.card_line())
    dev = torch.device("cuda")
    results = []
    for label, run, query, _ in chip_smoke.merge_rank_inputs(
            np.random.default_rng(args.seed)):
        t, _, _ = chip_smoke.rank_tensors(run, query, dev)
        n, width, m = t[0].shape[0], t[0].shape[1], t[2].shape[0]
        for count_equal in (False, True):
            shape = f"{label} N={n} M={m} W={width} count_equal={count_equal}"
            want = plain(*t, count_equal)
            ms = {"this": [], "other": []}

            def timed(tree):
                kernels, mods = trees[tree]
                with installed(mods):
                    ms[tree].append(cuda_ms(
                        lambda: kernels.merge_rank(*t, count_equal), 20))

            for tree, (kernels, mods) in trees.items():
                with installed(mods):
                    check(torch.equal(kernels.merge_rank(*t, count_equal),
                                      want),
                          f"merge_rank {shape}: {tree} checkout disagrees "
                          f"with the plain version")
            for tree in ("other", "this", "this", "other"):
                timed(tree)
            log(f"merge_rank {shape}: this_ms={ms['this']} "
                f"other_ms={ms['other']}")
            results.append({"case": label, "n": n, "m": m, "w": width,
                            "count_equal": count_equal, **{
                                f"{k}_ms": v for k, v in ms.items()}})
        del t
    log(chip_smoke.card_line())
    log(json.dumps({"merge_rank_turns": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
