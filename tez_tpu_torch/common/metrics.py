"""Latency histograms, gauges and Prometheus text: the port's copy of
tez_tpu.common.metrics.

Each observation lands in a process-global histogram and, when the caller
passes its TezCounters, in the ``LatencyHistogram.<name>`` bucket counters
(``LE_<bound>``, ``COUNT``, ``SUM_US``) exactly as tez_tpu lays them out;
an armed flight recorder journals it too.  Buckets are powers of two in
milliseconds (1 ms .. 65536 ms, plus +Inf).  Gauges hold the last value
set (the async plane's ``device.breaker.state``).  The registry starts
empty: tez_tpu pre-registers its well-known families for its web UI's
scrape, which the port does not serve.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

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


def quantile_from_buckets(counts: List[int], q: float) -> float:
    """Estimate a quantile from per-bucket counts by linear interpolation
    inside the winning bucket.  Overflow observations report the last
    finite bound (a floor, same convention as Prometheus +Inf)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    seen = 0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if seen + c >= rank:
            if i >= len(BUCKET_BOUNDS_MS):          # +Inf bucket
                return BUCKET_BOUNDS_MS[-1]
            lo = BUCKET_BOUNDS_MS[i - 1] if i > 0 else 0.0
            hi = BUCKET_BOUNDS_MS[i]
            frac = (rank - seen) / c
            return lo + (hi - lo) * min(1.0, max(0.0, frac))
        seen += c
    return BUCKET_BOUNDS_MS[-1]


def max_bound_from_buckets(counts: List[int]) -> float:
    """Upper bound of the highest occupied bucket (0 when empty)."""
    for i in range(len(counts) - 1, -1, -1):
        if counts[i] > 0:
            return (BUCKET_BOUNDS_MS[i] if i < len(BUCKET_BOUNDS_MS)
                    else float("inf"))
    return 0.0


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

    def quantile(self, q: float) -> float:
        return quantile_from_buckets(self.counts, q)

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "counts": list(self.counts),
                "count": self.count, "sum_ms": self.sum_ms}


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

    def reset(self) -> None:
        with self._lock:
            self._hist = {}
            self._gauges.clear()


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


# --------------------------------------------------------------------------
# Reading histograms back out of counter dumps (history JSONL / to_dict)
# --------------------------------------------------------------------------

def histograms_from_counters(
        counters_dict: Mapping[str, Mapping[str, int]]
) -> Dict[str, Dict[str, Any]]:
    """Decode LatencyHistogram.* counter groups from a TezCounters.to_dict
    (or history dump) back into {name: {counts, count, sum_us, p50, p95,
    max_ms}} summaries."""
    out: Dict[str, Dict[str, Any]] = {}
    for gname, cs in counters_dict.items():
        if not gname.startswith(HIST_GROUP_PREFIX):
            continue
        name = gname[len(HIST_GROUP_PREFIX):]
        counts = [int(cs.get(b, 0)) for b in _BUCKET_COUNTER_NAMES]
        out[name] = {
            "counts": counts,
            "count": int(cs.get("COUNT", sum(counts))),
            "sum_us": int(cs.get("SUM_US", 0)),
            "p50": quantile_from_buckets(counts, 0.50),
            "p95": quantile_from_buckets(counts, 0.95),
            "max_ms": max_bound_from_buckets(counts),
        }
    return out


# --------------------------------------------------------------------------
# Prometheus text exposition (version 0.0.4)
# --------------------------------------------------------------------------

def _sanitize(name: str) -> str:
    out = "".join(ch if (ch.isalnum() or ch == "_") else "_" for ch in name)
    return out if not out[:1].isdigit() else "_" + out


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


def render_prometheus(
        histograms: Mapping[str, Histogram],
        gauges: Mapping[str, float],
        counters_dict: Optional[Mapping[str, Mapping[str, int]]] = None,
) -> str:
    """Render the standard text exposition format.  Histograms emit
    cumulative le-labelled buckets (Prometheus semantics) even though the
    internal representation is per-bucket."""
    lines: List[str] = []
    for name in sorted(histograms):
        h = histograms[name]
        metric = f"tez_latency_{_sanitize(name)}_ms"
        lines.append(f"# HELP {metric} latency histogram for {name}")
        lines.append(f"# TYPE {metric} histogram")
        cum = 0
        for i, bound in enumerate(BUCKET_BOUNDS_MS):
            cum += h.counts[i]
            lines.append(f'{metric}_bucket{{le="{bound:g}"}} {cum}')
        cum += h.counts[-1]
        lines.append(f'{metric}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{metric}_sum {h.sum_ms:g}")
        lines.append(f"{metric}_count {h.count}")
    for name in sorted(gauges):
        metric = f"tez_{_sanitize(name)}"
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {gauges[name]:g}")
    if counters_dict:
        lines.append("# HELP tez_counter Tez counter value")
        lines.append("# TYPE tez_counter gauge")
        for gname in sorted(counters_dict):
            if gname.startswith(HIST_GROUP_PREFIX):
                continue          # already rendered as histograms above
            for cname in sorted(counters_dict[gname]):
                lines.append(
                    f'tez_counter{{group="{_escape_label(gname)}",'
                    f'name="{_escape_label(cname)}"}} '
                    f"{counters_dict[gname][cname]}")
    return "\n".join(lines) + "\n"
