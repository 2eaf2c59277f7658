"""Live time-series telemetry: bounded ring-buffer series sampled on the
shared monotonic clock.

The flight ring and the metrics registry are *point-in-time*: the registry holds cumulative histograms since process
start, the flight ring holds raw events until they are overwritten, and
nothing answers "what happened in the last five seconds?" — the question
every live surface (GET /metrics.json windows, burn-rate SLO alerts,
``graft top``, the continuous doctor) actually asks.  This module adds
the missing axis: a :class:`TimeSeriesRegistry` that, on each sampler
tick (``am/telemetry.py``), snapshots

- every histogram in :mod:`tez_tpu_torch.common.metrics` (cumulative bucket
  counts + count + sum), and
- every gauge, plus any values produced by **registered collectors** —
  the hook ``store/``, ``shuffle/`` and ``parallel/`` use to publish
  occupancy without importing the AM —

into one bounded ring per series.  Windowed aggregation is a pure
function of ring contents and the window bounds (no wall-clock reads, no
randomness): a histogram window is the clamped delta of two cumulative
snapshots, so rate and p50/p95/p99 over "the last N seconds" are exact
and deterministic given the same samples.  Overflow is explicit: every
ring eviction and collector failure is counted and exposed (GET
/metrics.json ``accounting``, the ``TELEMETRY_SNAPSHOT`` journal record,
counter_diff's telemetry section) — a series silently aging out of its
ring is an observability bug, so it is never silent.

Timestamps are ``clock.mono_ns()`` — the flight recorder's axis — so a
windowed p95 can be joined against flight events without re-anchoring.

The port's copy of tez_tpu.obs.timeseries: the rings and their windows;
the doctor's plane attribution comes with the doctor, not ported yet.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from tez_tpu_torch.common import clock

#: default ring capacity per series (samples, not seconds: at the default
#: 250 ms sampler period this is ~2 min of history per series)
DEFAULT_CAPACITY = 512

# -- series -----------------------------------------------------------------

class Series:
    """One bounded ring of samples.  ``kind`` is ``"gauge"`` (points are
    ``(t_ns, value)``) or ``"hist"`` (points are ``(t_ns, counts_tuple,
    count, sum_ms)`` — cumulative, exactly the registry snapshot).  Not
    self-locking: the owning registry serializes appends and reads."""

    __slots__ = ("name", "kind", "capacity", "points", "evicted")

    def __init__(self, name: str, kind: str, capacity: int) -> None:
        self.name = name
        self.kind = kind
        self.capacity = max(2, int(capacity))
        self.points: List[Tuple] = []
        self.evicted = 0

    def append(self, point: Tuple) -> None:
        if len(self.points) >= self.capacity:
            # explicit overflow accounting: deque(maxlen) would drop the
            # oldest sample silently, and silent drops are the exact
            # failure mode the telemetry section of counter_diff flags
            del self.points[0]
            self.evicted += 1
        self.points.append(point)


def _hist_window(points: List[Tuple], window_ns: int, now_ns: int
                 ) -> Dict[str, Any]:
    """Deterministic windowed aggregate of cumulative histogram samples:
    the clamped per-bucket delta between the newest sample and the newest
    sample at or before the window start (falling back to the oldest
    sample the ring still holds — ``covered`` reports the span actually
    used, so a reader can tell a truncated window from a full one)."""
    from tez_tpu_torch.common import metrics
    if not points:
        return {"count": 0, "rate_per_s": 0.0, "p50": 0.0, "p95": 0.0,
                "p99": 0.0, "sum_ms": 0.0, "covered_s": 0.0}
    newest = points[-1]
    start = now_ns - window_ns
    base = None
    for p in reversed(points):
        if p[0] <= start:
            base = p
            break
    if base is None:
        base = points[0]
    d_counts = [max(0, n - b) for n, b in zip(newest[1], base[1])]
    d_count = max(0, newest[2] - base[2])
    d_sum = max(0.0, newest[3] - base[3])
    span_s = max((newest[0] - base[0]) / 1e9, 1e-9)
    return {
        "count": d_count,
        "rate_per_s": round(d_count / span_s, 4),
        "p50": round(metrics.quantile_from_buckets(d_counts, 0.50), 4),
        "p95": round(metrics.quantile_from_buckets(d_counts, 0.95), 4),
        "p99": round(metrics.quantile_from_buckets(d_counts, 0.99), 4),
        "sum_ms": round(d_sum, 4),
        "covered_s": round(min(span_s, window_ns / 1e9), 4),
    }


def _gauge_window(points: List[Tuple], window_ns: int, now_ns: int
                  ) -> Dict[str, Any]:
    start = now_ns - window_ns
    vals = [v for t, v in points if t > start]
    if not vals:
        last = points[-1][1] if points else 0.0
        return {"n": 0, "last": last, "min": last, "max": last,
                "mean": last}
    return {"n": len(vals), "last": vals[-1], "min": min(vals),
            "max": max(vals),
            "mean": round(sum(vals) / len(vals), 6)}


# -- registry ---------------------------------------------------------------

class TimeSeriesRegistry:
    """Bounded per-series rings + the sampler entry point."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self._lock = threading.Lock()
        self.capacity = max(2, int(capacity))
        self._series: Dict[str, Series] = {}
        #: named collectors: fn() -> {gauge_name: float}.  store/, shuffle/
        #: and parallel/ register here so lane occupancy and tier bytes
        #: ride the same rings as the AM's own gauges.
        self._collectors: Dict[str, Callable[[], Mapping[str, float]]] = {}
        self.samples = 0
        self.collector_errors = 0
        self.scrape_errors = 0      # bumped by the web layer on a failed
        #                             exposition render, so scrape health
        #                             is visible in the plane it broke in

    # -- collector hooks ----------------------------------------------------
    def register_collector(self, name: str,
                           fn: Callable[[], Mapping[str, float]]) -> None:
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def collectors(self) -> List[str]:
        with self._lock:
            return sorted(self._collectors)

    def note_scrape_error(self) -> None:
        with self._lock:
            self.scrape_errors += 1

    # -- sampling -----------------------------------------------------------
    def sample(self, now_ns: Optional[int] = None) -> int:
        """One sweep: snapshot every registry histogram and gauge plus
        every collector into the rings.  Returns the number of series
        touched.  Collector failures are counted, never raised — the
        sampler thread must survive a sick plane."""
        from tez_tpu_torch.common import metrics
        now = clock.mono_ns() if now_ns is None else int(now_ns)
        reg = metrics.registry()
        hists = reg.histograms()
        gauges = dict(reg.gauges())
        with self._lock:
            collectors = list(self._collectors.items())
        errors = 0
        for _cname, fn in collectors:
            try:
                for gname, value in fn().items():
                    gauges[gname] = float(value)
                    # write-through to the point-in-time gauge surface so
                    # GET /metrics shows collector gauges (lane occupancy,
                    # tier bytes) even between mutations of the plane
                    reg.set_gauge(gname, float(value))
            except Exception:  # noqa: BLE001 — a sick collector is counted
                errors += 1
        with self._lock:
            self.samples += 1
            self.collector_errors += errors
            for name, h in hists.items():
                s = self._series.get(name)
                if s is None:
                    s = self._series[name] = Series(
                        name, "hist", self.capacity)
                s.append((now, tuple(h.counts), h.count, h.sum_ms))
            for name, v in gauges.items():
                s = self._series.get(name)
                if s is None:
                    s = self._series[name] = Series(
                        name, "gauge", self.capacity)
                s.append((now, float(v)))
            return len(hists) + len(gauges)

    # -- reads --------------------------------------------------------------
    def series_names(self, kind: Optional[str] = None) -> List[str]:
        with self._lock:
            return sorted(n for n, s in self._series.items()
                          if kind is None or s.kind == kind)

    def window(self, name: str, window_s: float,
               now_ns: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Deterministic windowed summary of one series (None when the
        series does not exist yet)."""
        with self._lock:
            s = self._series.get(name)
            if s is None:
                return None
            points = list(s.points)
            kind = s.kind
        now = clock.mono_ns() if now_ns is None else int(now_ns)
        win = int(window_s * 1e9)
        out = (_hist_window(points, win, now) if kind == "hist"
               else _gauge_window(points, win, now))
        out["kind"] = kind
        return out

    def windows(self, window_s: float, now_ns: Optional[int] = None,
                kind: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
        """Windowed summaries for every series (optionally one kind)."""
        return {n: self.window(n, window_s, now_ns)
                for n in self.series_names(kind)}

    def accounting(self) -> Dict[str, int]:
        """Explicit overflow/health accounting: cardinality is reported,
        evictions/drops/errors are the flaggable signals."""
        with self._lock:
            return {
                "samples": self.samples,
                "series": len(self._series),
                "points": sum(len(s.points)
                              for s in self._series.values()),
                "evicted": sum(s.evicted for s in self._series.values()),
                "collector_errors": self.collector_errors,
                "scrape_errors": self.scrape_errors,
            }

    def reset(self) -> None:
        with self._lock:
            self._series.clear()
            self.samples = 0
            self.collector_errors = 0
            self.scrape_errors = 0
            # collectors survive a reset: they are wiring, not data


_REG = TimeSeriesRegistry()


def registry() -> TimeSeriesRegistry:
    return _REG


def reset() -> None:
    """Drop sampled data (tests); registered collectors stay."""
    _REG.reset()
