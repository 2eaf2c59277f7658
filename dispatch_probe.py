#!/usr/bin/env python3
"""Run chip_smoke.py's phase 3b (the map side on the async span plane)
three times in one process and set each span's dispatch stage against
what else ran on the host meanwhile.

    python3 dispatch_probe.py [ROOT]

ROOT is a checkout of the repository (default: this one), for example the
parent commit unpacked with `git archive <commit> | tar -x -C parent_tree`
(parent_tree/ is gitignored).  After phase 3's synchronous spans, each
repetition runs the 4 producers x 2 spans of 256 MiB of phase 3b and
prints, per span, the dispatch stage's wall and thread CPU time and the
garbage collector's passes and staging calls (pinned slots, readback
targets) of every thread that overlapped it; then chip_smoke's own
phase 3b lines (the allocator's reserved MiB across each dispatch) and
whether its dispatch check held ("PROBE rep N check passed/failed").
Without a card the script exits non-zero.
"""
import gc
import os
import sys
import threading
import time

tree = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, tree)
os.chdir(tree)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("dispatch_probe: no CUDA device")
from tez_tpu_torch.ops import _build, device as dv  # noqa: E402

_build.build()
_build.build_host()
EV = []          # (kind, thread name, t0, t1, info)
gc_t0 = {}


def gccb(phase, info):
    t = time.perf_counter()
    if phase == "start":
        gc_t0[threading.get_ident()] = t
    else:
        EV.append(("gc", threading.current_thread().name,
                   gc_t0.pop(threading.get_ident(), t), t,
                   f"gen{info['generation']} collected={info['collected']}"))


gc.callbacks.append(gccb)
real_stage = dv.stage_resident_span


def stage(lanes, lengths, streams):
    t0 = time.perf_counter()
    c0 = time.thread_time()
    fresh = [s[0] is None for s in streams._slots]
    out = real_stage(lanes, lengths, streams)
    EV.append(("stage", threading.current_thread().name, t0,
               time.perf_counter(), f"fresh_slots={fresh} cpu_ms="
               f"{(time.thread_time() - c0) * 1e3:.1f}"))
    return out


dv.stage_resident_span = stage
span_bytes = int(256 * (1 << 20))
rng = np.random.default_rng(0)
vocab = cs.bench_vocab()
rec = cs.span_records(span_bytes)
pb = [[cs.bench_batch(rng, vocab, rec)[0] for _ in range(2)]
      for _ in range(4)]
print("gc objects", len(gc.get_objects()), "counts", gc.get_count())
cs.produce(pb, 12, span_bytes)
for rep in range(3):
    pipes = []
    EV.clear()
    h0 = cs.histogram_totals()
    cs.produce(pb, 12, span_bytes, pipelines=pipes, pipeline_depth=2)
    for i, pipe in enumerate(pipes):
        edges = {(ids, st, e): t for ids, st, e, t in pipe.events}
        for ids in sorted({k[0] for k in edges}, key=repr):
            d0 = edges.get((ids, "device.dispatch", "start"))
            d1 = edges.get((ids, "device.dispatch", "end"))
            if d0 is None or d1 is None:
                continue
            c = [pipe.dispatch_cpu.get((ids, e), 0.0)
                 for e in ("start", "end")]
            over = [f"{k}@{th}:{(max(a, d0) - d0) * 1e3:.1f}+"
                    f"{(min(b, d1) - max(a, d0)) * 1e3:.1f}ms {inf}"
                    for k, th, a, b, inf in EV if a < d1 and b > d0]
            print(f"rep {rep} producer {i} span {ids}: dispatch_ms="
                  f"{(d1 - d0) * 1e3:.3f} cpu_ms={(c[1] - c[0]) * 1e3:.1f} "
                  f"overlaps={over}")
    try:
        cs.report_pipelines("map_async", pipes, h0, "cuda")
        print(f"PROBE rep {rep} check passed")
    except cs.SmokeFailure as e:
        print(f"PROBE rep {rep} check failed:", e)
    print("gc events", [(k, th, round((b - a) * 1e3, 1), inf)
                        for k, th, a, b, inf in EV
                        if k == "gc" and b - a > 0.005])
