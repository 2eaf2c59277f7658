#!/usr/bin/env python3
"""Where the host time of chip_smoke.py's phases 8 and 11 goes: a sampling
profile of every thread.

    python3 host_trace.py [--seed N] [--interval-ms 5]

Runs phase 8 with one producer and phase 11 (both legs) at full size on
the card, each under a sampler that reads every thread's stack every
interval and charges the sample to the innermost frame inside
tez_tpu_torch (a call into the host library or a kernel wrapper stays
with the Python function that made it), or else to the innermost frame.  Threads waiting on a lock, a
condition, a queue, a join or a sleep are not counted.  For each phase
it prints the functions holding the most samples, each with its share of
the busy samples and the seconds they stand for, then one JSON line of
them.
Without a card the script exits non-zero before any phase.
"""
from __future__ import annotations

import argparse
import collections
import json
import linecache
import os
import sys
import threading
import time
import types

import chip_smoke

PKG = os.sep + "tez_tpu_torch" + os.sep
#: innermost Python frames of a thread that waits rather than works
IDLE_FRAMES = {("threading.py", "wait"), ("threading.py", "join"),
               ("threading.py", "_wait_for_tstate_lock"),
               ("selectors.py", "select"), ("_base.py", "result")}
#: the same for a wait in a C call, read off the frame's current line
IDLE_CALLS = ("sleep(", ".wait(", ".acquire(", ".join(", ".get()",
              "queue.get(")


def idle(frame) -> bool:
    code = frame.f_code
    if (os.path.basename(code.co_filename), code.co_name) in IDLE_FRAMES:
        return True
    line = linecache.getline(code.co_filename, frame.f_lineno)
    return any(call in line for call in IDLE_CALLS)


class Sampler:
    """Samples every other thread's stack every `interval` seconds."""

    def __init__(self, interval: float):
        self.interval = interval
        self.counts: collections.Counter = collections.Counter()
        self.busy = 0
        self._stop = threading.Event()

    @staticmethod
    def _where(frame):
        if idle(frame):
            return None
        inner = frame.f_code
        while frame is not None:
            path = frame.f_code.co_filename
            if PKG in path:
                return f"{path.split(PKG, 1)[1]}:{frame.f_code.co_name}"
            frame = frame.f_back
        return (f"outside the package: "
                f"{os.path.basename(inner.co_filename)}:{inner.co_name}")

    def _run(self):
        me = threading.get_ident()
        while not self._stop.wait(self.interval):
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                where = self._where(frame)
                if where is not None:
                    self.counts[where] += 1
                    self.busy += 1

    def __enter__(self):
        self.t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *_):
        self._stop.set()
        self._thread.join(timeout=10)
        self.wall = time.perf_counter() - self.t0
        return False

    def report(self, label: str, top: int = 15) -> dict:
        rows = []
        for where, n in self.counts.most_common(top):
            rows.append({"where": where, "share": round(n / self.busy, 4),
                         "thread_s": round(n * self.interval, 3)})
            chip_smoke.log(f"trace {label}: {where} {n / self.busy:.4f} of "
                           f"busy samples, {n * self.interval:.3f} "
                           f"thread-seconds")
        chip_smoke.log(f"trace {label}: wall {self.wall:.3f} s, busy "
                       f"{self.busy * self.interval:.3f} thread-seconds")
        return {"wall_s": round(self.wall, 3),
                "busy_thread_s": round(self.busy * self.interval, 3),
                "top": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--interval-ms", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("host_trace: no CUDA device", file=sys.stderr)
        return 2
    from tez_tpu_torch.ops import _build
    _build.build()
    _build.build_host()
    chip_smoke.log(chip_smoke.card_line())
    chip_smoke.log(f"host: {os.cpu_count()} CPUs (nproc), "
                   f"{chip_smoke.cpu_model()}")
    smoke_args = types.SimpleNamespace(seed=args.seed)
    out = {}
    for label, run in (
            ("spill", lambda: chip_smoke.spill_phase(smoke_args,
                                                     producers=1)),
            ("dag", lambda: chip_smoke.dag_phase(smoke_args))):
        with Sampler(args.interval_ms / 1e3) as sampler:
            run()
        out[label] = sampler.report(label)
    chip_smoke.log(json.dumps({"host_trace": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
