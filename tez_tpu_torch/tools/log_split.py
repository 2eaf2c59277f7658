"""Split a combined log stream into per-entity files.

Reference parity: tez-tools tez-log-split — carve an aggregated log (many
tasks interleaved in one file) into one file per task attempt so a single
attempt's story reads linearly.  Works off the attempt ids that NDC tagging
(tez_tpu_torch/common/ndc.py) and thread names put on log lines; lines naming no
attempt go to main.log, and continuation lines (e.g. traceback bodies)
follow the last attributed line.

The port's copy of tez_tpu.tools.log_split.
"""
from __future__ import annotations

import os
import re
import sys
from typing import Dict, List, TextIO

#: attempt_<appTs>_<appSeq>_<dagSeq>_<vertex>_<task>_<attempt>
ATTEMPT_RE = re.compile(r"attempt_\d+_\d+_\d+_\d+_\d+_\d+")

#: a line that starts a new log record (timestamp or level prefix); anything
#: else is a continuation (traceback line, wrapped message)
RECORD_START_RE = re.compile(
    r"^(\d{4}-\d{2}-\d{2}[ T]|\[?(DEBUG|INFO|WARNING|ERROR|CRITICAL)\b)")


MAX_OPEN_HANDLES = 64


def split_log(lines, out_dir: str) -> Dict[str, int]:
    """Write per-attempt files (<attempt_id>.log) + main.log under out_dir.
    Returns {file name: line count}."""
    os.makedirs(out_dir, exist_ok=True)
    handles: Dict[str, TextIO] = {}   # insertion-ordered: LRU-ish eviction
    counts: Dict[str, int] = {}
    current = "main.log"

    def sink(name: str) -> TextIO:
        fh = handles.get(name)
        if fh is None:
            if len(handles) >= MAX_OPEN_HANDLES:
                # a DAG can have more attempts than the fd limit: close the
                # coldest handle and reopen in append mode on next use
                evict = next(iter(handles))
                handles.pop(evict).close()
            mode = "a" if name in counts else "w"
            fh = handles[name] = open(os.path.join(out_dir, name), mode)
        return fh

    try:
        for line in lines:
            m = ATTEMPT_RE.search(line)
            if m is not None:
                current = m.group(0) + ".log"
            elif RECORD_START_RE.match(line):
                current = "main.log"
            # else: continuation line stays with `current`
            sink(current).write(line)
            counts[current] = counts.get(current, 0) + 1
    finally:
        for fh in handles.values():
            fh.close()
    return counts


def main() -> int:
    if len(sys.argv) != 3:
        print("usage: log_split <combined.log> <out-dir>")
        return 2
    with open(sys.argv[1]) as fh:
        counts = split_log(fh, sys.argv[2])
    for name in sorted(counts):
        print(f"{counts[name]:8d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
