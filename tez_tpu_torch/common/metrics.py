"""Latency histograms and gauges: the port's copy of what it uses of
tez_tpu.common.metrics (observe, timer, set_gauge, registry().histograms()).

Each observation lands in a process-global histogram and, when the caller
passes its TezCounters, in the ``LatencyHistogram.<name>`` bucket counters
(``LE_<bound>``, ``COUNT``, ``SUM_US``) exactly as tez_tpu lays them out;
an armed flight recorder journals it too.  Buckets are powers of two in
milliseconds (1 ms .. 65536 ms, plus +Inf).  Gauges hold the last value
set (the async plane's ``device.breaker.state``).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Tuple

from tez_tpu_torch.obs import flight as _flight

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

    def snapshot(self) -> "Histogram":
        with self._lock:
            out = Histogram(self.name)
            out.counts = list(self.counts)
            out.count = self.count
            out.sum_ms = self.sum_ms
            return out


class MetricsRegistry:
    """Process-global histograms and gauges by name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hist: Dict[str, Histogram] = {}
        self._gauges: Dict[str, float] = {}

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hist.get(name)
            if h is None:
                h = self._hist[name] = Histogram(name)
            return h

    def histograms(self) -> Dict[str, Histogram]:
        """A consistent copy of every histogram."""
        with self._lock:
            return {k: v.snapshot() for k, v in self._hist.items()}

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauges(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._gauges)


_REG = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REG


def set_gauge(name: str, value: float) -> None:
    _REG.set_gauge(name, value)


def observe(name: str, ms: float, counters: Any = None) -> None:
    """Record one latency observation (see the module docstring)."""
    _REG.histogram(name).observe(ms)
    if _flight.armed():
        _flight.record(_flight.COUNTER, name, a=int(ms * 1000.0))
    if counters is not None:
        g = counters.group(HIST_GROUP_PREFIX + name)
        g.find_counter(_BUCKET_COUNTER_NAMES[bucket_index(ms)]).increment(1)
        g.find_counter("COUNT").increment(1)
        g.find_counter("SUM_US").increment(int(ms * 1000.0))


@contextmanager
def timer(name: str, counters: Any = None) -> Iterator[None]:
    """Time a block and observe() its duration in milliseconds."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        observe(name, (time.perf_counter() - t0) * 1000.0, counters)
