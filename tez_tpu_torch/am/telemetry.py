"""The AM's live telemetry sampler.

One daemon thread per AM (``tez.am.metrics.sample-period-ms``, 0 = off):
every tick it sweeps the metrics registry and every registered collector
into the bounded rings of :mod:`tez_tpu_torch.obs.timeseries`, then runs
the SLO watchdog's burn-rate evaluation against the fresh windows, so
burn-alert latency is bounded by the sampler period, not by DAG
completions.  The tick is the only hot-path cost of the live plane: a
dict snapshot plus ring appends, off every data-plane lock.

On a graceful stop the sampler journals one ``TELEMETRY_SNAPSHOT``
summary event carrying the plane's overflow accounting (ring evictions,
collector failures, scrape errors).

A crash journals nothing — the accounting dies with the incarnation.
:meth:`TelemetrySampler.live_status` is the continuous doctor's payload:
per-plane instrumented-busy blame over the live windows, next to tenants,
streams, queue depth, lane occupancy and active SLO breaches and burns.

The port's copy of tez_tpu.am.telemetry.  The port has no web UI to serve
``live_status`` yet; callers read it directly.  Its collectors are
tez_tpu's three: the buffer store's tier and tenant bytes, the shuffle
service's registered-run inventory and the mesh exchange's per-device
lane occupancy.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

from tez_tpu_torch.obs import timeseries

log = logging.getLogger(__name__)


class TelemetrySampler:
    """Periodic sampler thread for one AM."""

    def __init__(self, am: Any) -> None:
        from tez_tpu_torch.common import config as C
        self.am = am
        conf = am.conf
        self.period_s = max(
            0.0,
            float(conf.get(C.AM_METRICS_SAMPLE_PERIOD_MS) or 0.0) / 1000.0)
        self.metrics_enabled = bool(conf.get(C.METRICS_ENABLED))
        reg = timeseries.registry()
        reg.capacity = max(2, int(conf.get(C.AM_METRICS_RING_SAMPLES)
                                  or timeseries.DEFAULT_CAPACITY))
        self.window_s = float(conf.get(C.AM_METRICS_WINDOW_S) or 10.0)
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.ticks = 0

    def enabled(self) -> bool:
        return self.period_s > 0 and self.metrics_enabled

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if not self.enabled() or self._thread is not None:
            return
        from tez_tpu_torch.parallel import coordinator
        from tez_tpu_torch.shuffle import service
        from tez_tpu_torch.store import buffer_store
        reg = timeseries.registry()
        reg.register_collector("store", buffer_store.telemetry_collector)
        reg.register_collector("shuffle", service.telemetry_collector)
        reg.register_collector("mesh", coordinator.telemetry_collector)
        self._stop_event.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"am-telemetry-{self.am.app_id}")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_event.wait(self.period_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — telemetry must not die
                log.exception("telemetry tick failed")

    def tick(self, now_ns: Optional[int] = None) -> None:
        """One sweep: sample the rings, then burn-evaluate.  Public so
        tests drive the plane deterministically without a thread."""
        timeseries.registry().sample(now_ns)
        self.ticks += 1
        wd = getattr(self.am, "slo_watchdog", None)
        if wd is not None:
            wd.evaluate_burn(now_ns)

    def stop(self) -> None:
        """Graceful stop: halt the thread, then journal the plane's
        overflow accounting as a TELEMETRY_SNAPSHOT summary event."""
        self._halt()
        if not self.enabled():
            return
        from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
        acct = timeseries.registry().accounting()
        acct["ticks"] = self.ticks
        try:
            self.am.history(HistoryEvent(
                HistoryEventType.TELEMETRY_SNAPSHOT, data=acct))
        except Exception:  # noqa: BLE001 — diagnostics never fail a stop
            log.exception("TELEMETRY_SNAPSHOT journal write failed")

    def crash(self) -> None:
        """SIGKILL analog: no journal, just thread hygiene."""
        self._halt()

    def _halt(self) -> None:
        self._stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    # -- the continuous doctor (GET /doctor/live, graft top) ----------------
    def live_status(self, window_s: Optional[float] = None
                    ) -> Dict[str, Any]:
        """The live triage payload: over the last ``window_s`` seconds,
        per-plane instrumented-busy blame (the post-hoc sweep's
        incremental form), plus tenants, streams, queue depth, lane
        occupancy, and active SLO breach/burn state."""
        win = float(window_s or self.window_s)
        reg = timeseries.registry()
        busy = reg.plane_busy_ms(win)
        blamed = {p: ms for p, ms in busy.items() if ms > 0}
        dominant = max(blamed, key=lambda p: blamed[p]) if blamed else None
        out: Dict[str, Any] = {
            "window_s": win,
            "sampler": {"enabled": self.enabled(),
                        "period_s": self.period_s, "ticks": self.ticks},
            "planes": {"busy_ms": busy, "dominant": dominant},
            "accounting": reg.accounting(),
        }
        admission = getattr(self.am, "admission", None)
        if admission is not None:
            st = admission.status()
            out["queue_depth"] = st.get("queue_depth", 0)
            out["running_dags"] = st.get("running", 0)
            out["tenants"] = st.get("tenants", {})
        streams: Dict[str, Any] = {}
        for name, driver in list(getattr(self.am, "streams", {}).items()):
            try:
                status = driver.status()
            except Exception:  # noqa: BLE001 — a dying driver is skipped
                continue
            w = reg.window(f"stream.{name}.window.latency", win)
            if w is not None:
                status["window_latency"] = w
            streams[name] = status
        out["streams"] = streams
        from tez_tpu_torch.common import metrics
        gauges = metrics.registry().gauges()
        out["lanes"] = {
            name.split(".")[2]: v for name, v in sorted(gauges.items())
            if name.startswith("mesh.lane.")
            and name.endswith(".occupancy")}
        wd = getattr(self.am, "slo_watchdog", None)
        if wd is not None:
            st = wd.status()
            out["slo"] = {"breaches": st["active"],
                          "burn": st["burn"]["active"]}
        return out


def window_rows(window_s: float, kind: Optional[str] = None
                ) -> List[Dict[str, Any]]:
    """Flat windowed-aggregate rows for every live series — the
    ``graft top`` series table (label-split like the exposition)."""
    from tez_tpu_torch.obs import exposition
    reg = timeseries.registry()
    rows: List[Dict[str, Any]] = []
    for name, w in reg.windows(window_s, kind=kind).items():
        if w is None:
            continue
        base, labels = exposition.split_labels(name)
        rows.append(dict(w, name=base, labels=labels, series=name))
    return rows
