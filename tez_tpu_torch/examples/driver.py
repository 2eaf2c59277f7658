"""Example program driver: one CLI dispatching every shipped example.

Reference role: ExampleDriver
(tez-examples/src/main/java/org/apache/tez/examples/ExampleDriver.java:33),
which registers each example under a short name with Hadoop's
ProgramDriver.  `python -m tez_tpu_torch.examples.driver [--device D]
<name> <args...>` here, `hadoop jar tez-examples.jar <name> <args...>`
there.

The port's copy of tez_tpu.examples.driver: ``--device`` (``cuda``, the
default, or ``cpu``) is handed to the program's ``run``, as the port's
other mains take it; without a card the default device raises.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from tez_tpu_torch.examples import (cartesian_product, hash_join, mrr,
                                    ordered_wordcount, simple_session,
                                    sort_merge_join, wordcount)


def _two_arg(run):
    def go(argv, device):
        if len(argv) < 2:
            return None
        return run(argv[:-1], argv[-1], device=device)
    return go


def _three_arg(run):
    def go(argv, device):
        if len(argv) != 3:
            return None
        return run([argv[0]], [argv[1]], argv[2], device=device)
    return go


_PROGRAMS = {
    "wordcount": (
        _two_arg(wordcount.run), "<input...> <output_dir>",
        "hash-partitioned (unordered) word count"),
    "orderedwordcount": (
        _two_arg(ordered_wordcount.run), "<input...> <output_dir>",
        "word count with counts sorted via a second ordered edge"),
    "mrr": (
        _two_arg(mrr.run), "<input...> <output_dir>",
        "map -> reduce -> reduce chained-shuffle DAG"),
    "sortmergejoin": (
        _three_arg(sort_merge_join.run), "<left> <right> <output_dir>",
        "two ordered edges merged in one joiner vertex"),
    "hashjoin": (
        _three_arg(hash_join.run), "<stream> <hash> <output_dir>",
        "broadcast-edge hash join (small side replicated)"),
    "cartesianproduct": (
        _three_arg(cartesian_product.run), "<left> <right> <output_dir>",
        "cross product via the CUSTOM cartesian-product edge"),
    "simplesessionexample": (
        _two_arg(simple_session.run), "<input...> <output_dir>",
        "several DAGs through one session with runner reuse"),
}


def _usage() -> int:
    print("usage: tez-examples [--device cuda|cpu] <program> <args...>\n\n"
          "programs:")
    for name, (_, args, desc) in sorted(_PROGRAMS.items()):
        print(f"  {name:18s} {args}\n  {'':18s}   {desc}")
    return 2


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("-h", "--help"):
        _usage()
        return 0
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    opts, argv = ap.parse_known_args(argv)
    if not argv or argv[0] not in _PROGRAMS:
        return _usage()
    run, args_help, _ = _PROGRAMS[argv[0]]
    state = run(argv[1:], opts.device)
    if state is None:
        print(f"usage: tez-examples {argv[0]} {args_help}")
        return 2
    print(state)
    return 0 if state == "SUCCEEDED" else 1


if __name__ == "__main__":
    sys.exit(main())
