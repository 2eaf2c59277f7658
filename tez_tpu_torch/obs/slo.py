"""Per-tenant SLO watchdogs: declarative targets evaluated live from the
metrics registry, surfaced as breach gauges, ``GET /slo``, a typed
history event, and flight-recorder entries.

Targets (``tez.am.slo.*``, all disabled at 0):

- ``submit.p95-ms`` — per-tenant p95 submit→finish wall, read from the
  ``tenant.<t>.dag.latency`` histogram the admission controller already
  feeds on every DAG completion;
- ``queue-wait.p95-ms`` — p95 of ``am.admit.queue_wait`` (session-wide:
  the queue is one FIFO, so queue wait is a property of the session, not
  a tenant — reported under tenant ``*``);
- ``shed-rate`` — shed / (accepted + shed) per tenant, from the
  admission controller's live tenant stats;
- ``window.p95-ms`` — p95 window cut→commit latency of streaming mode,
  checked against BOTH the session-wide ``stream.window.latency``
  aggregate AND every per-stream ``stream.<s>.window.latency`` histogram
  the StreamDriver feeds, so one slow stream pages by name instead of
  hiding inside the session aggregate.

Breach evaluation is *edge-triggered and latched*: a (tenant, kind,
stream) triple breaches once when it crosses its target and clears once
when it drops back under, so chaos/soak assertions see one typed
``TENANT_SLO_BREACH`` history event per episode instead of one per DAG.
Every breach record carries ``tenant``/``kind``/``stream`` — the same
labels the time-series plane splits out at exposition — so doctor can
join breaches against burn alerts and windowed series per stream.
``tez.am.slo.min-count`` guards against declaring a breach off a single
observation.

**Burn-rate alerting** (``tez.am.slo.burn.*``, docs/telemetry.md): the
cumulative histograms above answer "is the SLO breached?" but are
dominated by history — a stream that just turned slow will not move a
10-minute-old cumulative p95 for a long time.  :meth:`evaluate_burn`
runs on the telemetry sampler's ticks against the *windowed* aggregates
of :mod:`tez_tpu_torch.obs.timeseries`: when a fast-window p95 crosses
``threshold × target`` it latches a typed ``SLO_BURN_ALERT`` history
event plus a flight MARK — strictly before the cumulative breach on a
ramping workload, which is the point: the alert fires while there is
still error budget left.  The latch clears only when the *slow* window
drops back under the threshold (multi-window hysteresis, SRE-workbook
style), so an oscillating series pages once per episode.  Burn
evaluation covers the p95 latency targets (submit / queue-wait /
window); shed-rate stays breach-only — it is already a rate.

The watchdog is deliberately pull-based — it recomputes from histograms
the planes already maintain, on the admission controller's completion/
shed ticks (breach) and the telemetry sampler's ticks (burn) — so it
adds no new lock ordering and costs nothing between ticks.

The port's copy of tez_tpu.obs.slo: the AM builds it in its constructor,
the admission controller and the stream driver tick ``evaluate`` and the
telemetry sampler ticks ``evaluate_burn``.  ``status`` is what tez_tpu's
``GET /slo`` serves; the port has no web UI yet, so callers read it
directly.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

from tez_tpu_torch.common import clock

log = logging.getLogger(__name__)

#: bounded breach/burn transition log kept for GET /slo
_HISTORY_LIMIT = 64

KIND_SUBMIT = "submit_p95_ms"
KIND_QUEUE_WAIT = "queue_wait_p95_ms"
KIND_SHED_RATE = "shed_rate"
KIND_WINDOW = "window_p95_ms"

#: suffix of the per-stream window-latency series the StreamDriver feeds
_STREAM_HIST_SUFFIX = ".window.latency"


class SloWatchdog:
    """Evaluates ``tez.am.slo.*`` targets against live histograms."""

    def __init__(self, conf: Any, journal: Any = None) -> None:
        from tez_tpu_torch.common import config as C
        self.submit_p95_ms = float(conf.get(C.AM_SLO_SUBMIT_P95_MS) or 0.0)
        self.queue_wait_p95_ms = float(
            conf.get(C.AM_SLO_QUEUE_WAIT_P95_MS) or 0.0)
        self.shed_rate = float(conf.get(C.AM_SLO_SHED_RATE) or 0.0)
        self.window_p95_ms = float(conf.get(C.AM_SLO_WINDOW_P95_MS) or 0.0)
        self.min_count = max(1, int(conf.get(C.AM_SLO_MIN_COUNT) or 1))
        self.burn_threshold = float(
            conf.get(C.AM_SLO_BURN_THRESHOLD) or 0.0)
        self.burn_fast_s = float(conf.get(C.AM_SLO_BURN_FAST_S) or 5.0)
        self.burn_slow_s = float(conf.get(C.AM_SLO_BURN_SLOW_S) or 60.0)
        self.burn_min_count = max(
            1, int(conf.get(C.AM_SLO_BURN_MIN_COUNT) or 1))
        self._journal = journal
        self._lock = threading.Lock()
        #: latched active breaches keyed (tenant, kind, stream)
        self._active: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
        #: latched active burn alerts, same key shape
        self._burning: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
        self._log: List[Dict[str, Any]] = []
        self._total = 0
        self._by_kind: Dict[str, int] = {}
        self._burn_total = 0
        self._burn_by_kind: Dict[str, int] = {}
        self._evaluations = 0
        self._burn_evaluations = 0

    def enabled(self) -> bool:
        return (self.submit_p95_ms > 0 or self.queue_wait_p95_ms > 0
                or self.shed_rate > 0 or self.window_p95_ms > 0)

    def burn_enabled(self) -> bool:
        return self.enabled() and self.burn_threshold > 0

    def targets(self) -> Dict[str, float]:
        return {KIND_SUBMIT: self.submit_p95_ms,
                KIND_QUEUE_WAIT: self.queue_wait_p95_ms,
                KIND_SHED_RATE: self.shed_rate,
                KIND_WINDOW: self.window_p95_ms}

    # -- breach evaluation --------------------------------------------------
    def _checks(self, tenant_stats: Dict[str, Dict[str, int]]
                ) -> List[Tuple[str, str, str, float, float]]:
        """(tenant, kind, stream, observed, target) tuples due for
        comparison."""
        from tez_tpu_torch.common import metrics
        hists = metrics.registry().histograms()
        out: List[Tuple[str, str, str, float, float]] = []
        for tenant, ts in sorted(tenant_stats.items()):
            label = tenant or "default"
            if self.submit_p95_ms > 0:
                h = hists.get(f"tenant.{label}.dag.latency")
                if h is not None and h.count >= self.min_count:
                    out.append((label, KIND_SUBMIT, "", h.quantile(0.95),
                                self.submit_p95_ms))
            if self.shed_rate > 0:
                total = int(ts.get("accepted", 0)) + int(ts.get("shed", 0))
                if total >= self.min_count:
                    out.append((label, KIND_SHED_RATE, "",
                                ts.get("shed", 0) / total, self.shed_rate))
        if self.queue_wait_p95_ms > 0:
            h = hists.get("am.admit.queue_wait")
            if h is not None and h.count >= self.min_count:
                out.append(("*", KIND_QUEUE_WAIT, "", h.quantile(0.95),
                            self.queue_wait_p95_ms))
        if self.window_p95_ms > 0:
            for name in sorted(hists):
                stream = _window_series_stream(name)
                if stream is None:
                    continue
                h = hists[name]
                if h.count >= self.min_count:
                    out.append(("*", KIND_WINDOW, stream, h.quantile(0.95),
                                self.window_p95_ms))
        return out

    def evaluate(self, tenant_stats: Dict[str, Dict[str, int]]
                 ) -> List[Dict[str, Any]]:
        """One sweep.  Returns the NEW breaches this sweep latched."""
        if not self.enabled():
            return []
        new: List[Dict[str, Any]] = []
        cleared: List[Dict[str, Any]] = []
        now = clock.wall_s()
        with self._lock:
            self._evaluations += 1
            for tenant, kind, stream, observed, target in \
                    self._checks(tenant_stats):
                key = (tenant, kind, stream)
                over = observed > target
                active = self._active.get(key)
                if over and active is None:
                    breach = {"tenant": tenant, "kind": kind,
                              "stream": stream,
                              "observed": round(observed, 4),
                              "target": target, "since": now}
                    self._active[key] = breach
                    self._total += 1
                    self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
                    new.append(dict(breach))
                elif over:
                    active["observed"] = round(observed, 4)
                elif active is not None:
                    del self._active[key]
                    cleared.append({"tenant": tenant, "kind": kind,
                                    "stream": stream,
                                    "observed": round(observed, 4),
                                    "target": target, "cleared_at": now})
            for entry in new:
                self._log.append(dict(entry, event="breach"))
            for entry in cleared:
                self._log.append(dict(entry, event="clear"))
            del self._log[:-_HISTORY_LIMIT]
            total = self._total
        self._publish(new, cleared, total)
        return new

    def _publish(self, new: List[Dict[str, Any]],
                 cleared: List[Dict[str, Any]], total: int) -> None:
        from tez_tpu_torch.common import metrics
        from tez_tpu_torch.obs import flight
        if new or cleared:
            metrics.set_gauge("slo.breach.total", float(total))
            metrics.set_gauge("slo.breach.active", float(len(self._active)))
        for b in new:
            # a = observed, b = target — micro-units for latencies,
            # basis points for rates, so both fit integer payload slots
            scale = 1000.0 if b["kind"] != KIND_SHED_RATE else 10000.0
            flight.record(flight.SLO, f"slo.breach.{b['kind']}",
                          b["stream"] or b["tenant"],
                          a=int(b["observed"] * scale),
                          b=int(b["target"] * scale))
            log.warning(
                "SLO breach: tenant=%s stream=%s %s observed=%.2f "
                "target=%.2f", b["tenant"], b["stream"] or "-", b["kind"],
                b["observed"], b["target"])
            self._journal_event("TENANT_SLO_BREACH", b)
        for c in cleared:
            flight.record(flight.SLO, f"slo.clear.{c['kind']}",
                          c["stream"] or c["tenant"])

    # -- burn-rate evaluation -----------------------------------------------
    def _burn_series(self) -> List[Tuple[str, str, str, str, float]]:
        """(series, tenant, kind, stream, target) for every latency
        series burn evaluation watches — derived from the time-series
        registry so a series starts being watched on its first sample."""
        from tez_tpu_torch.obs import timeseries
        out: List[Tuple[str, str, str, str, float]] = []
        for name in timeseries.registry().series_names("hist"):
            if self.submit_p95_ms > 0 and name.startswith("tenant.") \
                    and name.endswith(".dag.latency"):
                tenant = name.split(".")[1]
                out.append((name, tenant, KIND_SUBMIT, "",
                            self.submit_p95_ms))
            elif self.queue_wait_p95_ms > 0 \
                    and name == "am.admit.queue_wait":
                out.append((name, "*", KIND_QUEUE_WAIT, "",
                            self.queue_wait_p95_ms))
            elif self.window_p95_ms > 0:
                stream = _window_series_stream(name)
                if stream is not None:
                    out.append((name, "*", KIND_WINDOW, stream,
                                self.window_p95_ms))
        return out

    def evaluate_burn(self, now_ns: Optional[int] = None
                      ) -> List[Dict[str, Any]]:
        """One burn sweep off a telemetry sampler tick.  Returns the NEW
        burn alerts this sweep latched.

        Latch: fast-window p95 ≥ threshold × target (with at least
        ``burn.min-count`` observations inside the fast window).  Clear:
        slow-window p95 back under threshold × target.  A series whose
        breach is already latched never raises a burn alert — the page
        already went out at full severity."""
        if not self.burn_enabled():
            return []
        from tez_tpu_torch.obs import timeseries
        reg = timeseries.registry()
        now = clock.wall_s()
        new: List[Dict[str, Any]] = []
        cleared: List[Dict[str, Any]] = []
        with self._lock:
            self._burn_evaluations += 1
            for series, tenant, kind, stream, target in self._burn_series():
                key = (tenant, kind, stream)
                bar = self.burn_threshold * target
                burning = self._burning.get(key)
                if burning is None:
                    if key in self._active:
                        continue        # already breached: no pre-page
                    fast = reg.window(series, self.burn_fast_s, now_ns)
                    if (fast is None or fast["count"] < self.burn_min_count
                            or fast["p95"] < bar):
                        continue
                    alert = {"tenant": tenant, "kind": kind,
                             "stream": stream, "series": series,
                             "observed": round(fast["p95"], 4),
                             "target": target,
                             "threshold": self.burn_threshold,
                             "window_s": self.burn_fast_s, "since": now}
                    self._burning[key] = alert
                    self._burn_total += 1
                    self._burn_by_kind[kind] = \
                        self._burn_by_kind.get(kind, 0) + 1
                    new.append(dict(alert))
                else:
                    slow = reg.window(series, self.burn_slow_s, now_ns)
                    if (slow is not None and slow["count"] > 0
                            and slow["p95"] < bar):
                        del self._burning[key]
                        cleared.append({
                            "tenant": tenant, "kind": kind,
                            "stream": stream,
                            "observed": round(slow["p95"], 4),
                            "target": target, "cleared_at": now})
                    else:
                        fast = reg.window(series, self.burn_fast_s, now_ns)
                        if fast is not None and fast["count"] > 0:
                            burning["observed"] = round(fast["p95"], 4)
            for entry in new:
                self._log.append(dict(entry, event="burn"))
            for entry in cleared:
                self._log.append(dict(entry, event="burn_clear"))
            del self._log[:-_HISTORY_LIMIT]
        self._publish_burn(new, cleared)
        return new

    def _publish_burn(self, new: List[Dict[str, Any]],
                      cleared: List[Dict[str, Any]]) -> None:
        from tez_tpu_torch.common import metrics
        from tez_tpu_torch.obs import flight
        if new or cleared:
            metrics.set_gauge("slo.burn.total", float(self._burn_total))
            metrics.set_gauge("slo.burn.active", float(len(self._burning)))
        for a in new:
            flight.record(flight.MARK, f"slo.burn.{a['kind']}",
                          a["stream"] or a["tenant"],
                          a=int(a["observed"] * 1000),
                          b=int(a["target"] * 1000))
            log.warning(
                "SLO burn alert: tenant=%s stream=%s %s fast-window "
                "p95=%.2f >= %.0f%% of target %.2f", a["tenant"],
                a["stream"] or "-", a["kind"], a["observed"],
                a["threshold"] * 100, a["target"])
            self._journal_event("SLO_BURN_ALERT", a)
        for c in cleared:
            flight.record(flight.MARK, f"slo.burn_clear.{c['kind']}",
                          c["stream"] or c["tenant"])

    def _journal_event(self, type_name: str, payload: Dict[str, Any]
                       ) -> None:
        if self._journal is None:
            return
        from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
        try:
            self._journal(HistoryEvent(
                HistoryEventType[type_name], data=dict(payload)))
        except Exception:  # noqa: BLE001 — diagnostics never fail
            log.exception("SLO %s journal write failed", type_name)

    # -- the GET /slo surface ---------------------------------------------
    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": self.enabled(),
                "targets": self.targets(),
                "min_count": self.min_count,
                "active": [dict(b) for b in self._active.values()],
                "total_breaches": self._total,
                "breaches_by_kind": dict(self._by_kind),
                "evaluations": self._evaluations,
                "burn": {
                    "enabled": self.burn_enabled(),
                    "threshold": self.burn_threshold,
                    "fast_window_s": self.burn_fast_s,
                    "slow_window_s": self.burn_slow_s,
                    "min_count": self.burn_min_count,
                    "active": [dict(a) for a in self._burning.values()],
                    "total_alerts": self._burn_total,
                    "alerts_by_kind": dict(self._burn_by_kind),
                    "evaluations": self._burn_evaluations,
                },
                "log": [dict(e) for e in self._log],
            }


def _window_series_stream(name: str) -> Optional[str]:
    """``stream.window.latency`` -> "" (the session aggregate);
    ``stream.<s>.window.latency`` -> ``<s>``; anything else -> None."""
    if name == "stream" + _STREAM_HIST_SUFFIX:
        return ""
    if name.startswith("stream.") and name.endswith(_STREAM_HIST_SUFFIX):
        stream = name[len("stream."):-len(_STREAM_HIST_SUFFIX)]
        if stream and "." not in stream:
            return stream
    return None


def from_conf(conf: Any, journal: Any = None) -> Optional["SloWatchdog"]:
    """Build a watchdog when any target is declared, else None (the AM
    keeps a None attribute and every tick short-circuits)."""
    wd = SloWatchdog(conf, journal=journal)
    return wd if wd.enabled() else None
