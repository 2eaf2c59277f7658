#!/usr/bin/env python3
"""Time one kernel of this checkout and of another one in turns on one CUDA
card.

    python3 kernel_turns.py KERNEL OTHER_ROOT [--seed N]

KERNEL names an entry of KERNELS: merge_rank (chip_smoke.py's phase-2
merge-rank cases, both count_equal flavours) or fnv_hash_bytes (phase 2's
FNV main row, N = 2^23, W = 16, then every FNV_SWEEP case).  OTHER_ROOT is
another checkout of the repository, for example the parent commit unpacked
with `git archive <commit> | tar -x -C parent_tree` (parent_tree/ is
gitignored).  Both checkouts' tez_tpu_torch packages are loaded side by
side, each building its own kernels into its own _build/.  For each case,
each checkout's public wrapper is checked bit for bit against this
checkout's plain version, then the two are timed in turns on the same
inputs: other, this, this, other (CUDA events).  Only the public wrapper
is called, so any checkout whose wrapper keeps its contract can be
compared.  The last line is one JSON object of every time.  Without a
card the script exits non-zero before timing anything.
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


def merge_rank_cases(seed: int, dev, card: str):
    """(fields, call, plain, calls) for each phase-2 merge-rank case: call
    and plain take a kernels module."""
    for label, run, query, _ in chip_smoke.merge_rank_inputs(
            np.random.default_rng(seed)):
        t, _, _ = chip_smoke.rank_tensors(run, query, dev)
        n, width, m = t[0].shape[0], t[0].shape[1], t[2].shape[0]
        for ce in (False, True):
            yield ({"case": label, "n": n, "m": m, "w": width,
                    "count_equal": ce},
                   lambda k, t=t, ce=ce: k.merge_rank(*t, ce),
                   lambda k, t=t, ce=ce: k._rank_search(*t, ce), 20)


def fnv_hash_bytes_cases(seed: int, dev, card: str):
    """(fields, call, plain, calls) for phase 2's FNV main row and each
    FNV_SWEEP case, with the case's byte bound."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    bw = chip_smoke.memory_tb_s(card)
    for case, n, w, p, view in (
            ("main", 1 << 23, 16, chip_smoke.NUM_PARTITIONS, False),
    ) + chip_smoke.FNV_SWEEP:
        mat, lens = chip_smoke.fnv_inputs(g, n, w, dev, view)
        yield ({"case": case, "n": n, "w": w, "p": p,
                "bound_ms": (n * w + 8 * n) / (bw * 1e12) * 1e3},
               lambda k, t=(mat, lens, p): k.fnv_hash_bytes(*t),
               lambda k, t=(mat, lens, p): k.fnv_hash_bytes_plain(*t),
               chip_smoke.fnv_timing_calls(n))


#: kernel -> its cases
KERNELS = {"merge_rank": merge_rank_cases,
           "fnv_hash_bytes": fnv_hash_bytes_cases}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("other_root")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"this": load_kernels(here),
             "other": load_kernels(os.path.abspath(args.other_root))}
    card = chip_smoke.card_line()
    log(card)
    results = []
    for fields, call, plain, calls in KERNELS[args.kernel](
            args.seed, torch.device("cuda"), card):
        shape = " ".join(f"{k}={v}" for k, v in fields.items())
        want = plain(trees["this"][0])
        for tree, (kernels, mods) in trees.items():
            with installed(mods):
                check(torch.equal(call(kernels), want),
                      f"{args.kernel} {shape}: {tree} checkout disagrees "
                      f"with the plain version")
        ms = {"this": [], "other": []}
        for tree in ("other", "this", "this", "other"):
            kernels, mods = trees[tree]
            with installed(mods):
                ms[tree].append(cuda_ms(lambda: call(kernels), calls))
        log(f"{args.kernel} {shape}: this_ms={ms['this']} "
            f"other_ms={ms['other']}")
        results.append(dict(fields, **{f"{k}_ms": v for k, v in ms.items()}))
    log(chip_smoke.card_line())
    log(json.dumps({"kernel_turns": {"kernel": args.kernel,
                                     "cases": results}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
