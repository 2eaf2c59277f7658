"""Latency histograms: the port's copy of tez_tpu.common.metrics' observe().

Each observation lands in a process-global histogram and, when the caller
passes its TezCounters, in the ``LatencyHistogram.<name>`` bucket counters
(``LE_<bound>``, ``COUNT``, ``SUM_US``) exactly as tez_tpu lays them out.
Buckets are powers of two in milliseconds (1 ms .. 65536 ms, plus +Inf).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Tuple

BUCKET_BOUNDS_MS: Tuple[float, ...] = tuple(float(1 << i) for i in range(17))
NUM_BUCKETS = len(BUCKET_BOUNDS_MS) + 1          # + overflow (+Inf)
HIST_GROUP_PREFIX = "LatencyHistogram."
_BUCKET_COUNTER_NAMES: Tuple[str, ...] = tuple(
    f"LE_{int(b)}" for b in BUCKET_BOUNDS_MS) + ("LE_INF",)


def bucket_index(ms: float) -> int:
    """Index of the first bucket whose bound >= ms (bit_length == log2)."""
    if ms <= 1.0:
        return 0
    i = int(ms - 1e-9).bit_length()
    return i if i < len(BUCKET_BOUNDS_MS) else len(BUCKET_BOUNDS_MS)


class Histogram:
    """Fixed-bucket latency histogram; thread-safe."""

    __slots__ = ("name", "counts", "count", "sum_ms", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self.counts = [0] * NUM_BUCKETS
        self.count = 0
        self.sum_ms = 0.0
        self._lock = threading.Lock()

    def observe(self, ms: float) -> None:
        with self._lock:
            self.counts[bucket_index(ms)] += 1
            self.count += 1
            self.sum_ms += ms


class MetricsRegistry:
    """Process-global histograms by name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hist: Dict[str, Histogram] = {}

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hist.get(name)
            if h is None:
                h = self._hist[name] = Histogram(name)
            return h


_REG = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REG


def observe(name: str, ms: float, counters: Any = None) -> None:
    """Record one latency observation (see the module docstring)."""
    _REG.histogram(name).observe(ms)
    if counters is not None:
        g = counters.group(HIST_GROUP_PREFIX + name)
        g.find_counter(_BUCKET_COUNTER_NAMES[bucket_index(ms)]).increment(1)
        g.find_counter("COUNT").increment(1)
        g.find_counter("SUM_US").increment(int(ms * 1000.0))
