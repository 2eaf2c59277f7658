"""Runtime diagnostics: thread dumps + GC/CPU accounting.

Reference parity: tez-runtime-internals TezThreadDumpHelper.java:53 (periodic
jstack per task/AM, attachable via hooks) and tez-common GcTimeUpdater.java:34
(JVM GC time into counters) + TaskCounterUpdater (CPU/memory stats).

The port's copy of tez_tpu.runtime.diagnostics.
"""
from __future__ import annotations

import gc
import logging
import sys
import threading
import time
import traceback
from typing import Any, Optional

from tez_tpu_torch.common.counters import TaskCounter, TezCounters

log = logging.getLogger(__name__)


def dump_thread_stacks(out=None) -> str:
    """All-threads stack dump (the jstack analog)."""
    lines = []
    frames = sys._current_frames()
    for thread in threading.enumerate():
        frame = frames.get(thread.ident)
        lines.append(f'--- Thread "{thread.name}" '
                     f'(daemon={thread.daemon}, id={thread.ident}) ---')
        if frame is not None:
            lines.extend(l.rstrip() for l in traceback.format_stack(frame))
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text


class ThreadDumpHelper:
    """Periodic stack dumps while attached (reference: ThreadDumpDAGHook /
    ThreadDumpTaskAttemptHook)."""

    def __init__(self, interval_ms: int, label: str = ""):
        self.interval = interval_ms / 1000.0
        self.label = label
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ThreadDumpHelper":
        if self.interval <= 0:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"thread-dump-{self.label}")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            log.info("thread dump [%s]:\n%s", self.label,
                     dump_thread_stacks())

    def stop(self) -> None:
        self._stop.set()


class RuntimeStatsUpdater:
    """Snapshot-based CPU/GC counters for one task (reference:
    TaskCounterUpdater + GcTimeUpdater).  GC pause time is measured for
    real via gc callbacks (start/stop timestamps), matching the reference
    counter's milliseconds unit."""

    def __init__(self, counters: TezCounters):
        self.counters = counters
        self._t0 = time.process_time()
        self._gc_ns = 0
        self._gc_start: Optional[int] = None
        self._cb = self._on_gc
        gc.callbacks.append(self._cb)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.monotonic_ns()
        elif phase == "stop" and self._gc_start is not None:
            self._gc_ns += time.monotonic_ns() - self._gc_start
            self._gc_start = None

    def update(self, final: bool = False) -> None:
        cpu_ms = int((time.process_time() - self._t0) * 1000)
        self.counters.find_counter(TaskCounter.CPU_MILLISECONDS)\
            .set_value(cpu_ms)
        try:
            import resource
            usage = resource.getrusage(resource.RUSAGE_SELF)
            self.counters.find_counter(TaskCounter.PHYSICAL_MEMORY_BYTES)\
                .set_value(usage.ru_maxrss * 1024)
        except ImportError:
            pass
        self.counters.find_counter(TaskCounter.GC_TIME_MILLIS)\
            .set_value(self._gc_ns // 1_000_000)
        if final:
            try:
                gc.callbacks.remove(self._cb)
            except ValueError:
                pass
