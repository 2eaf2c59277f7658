"""The AM's live telemetry sampler.

One daemon thread per AM (``tez.am.metrics.sample-period-ms``, 0 = off):
every tick it sweeps the metrics registry and every registered collector
into the bounded rings of :mod:`tez_tpu_torch.obs.timeseries`.  The tick
is the only hot-path cost of the live plane: a dict snapshot plus ring
appends, off every data-plane lock.

On a graceful stop the sampler journals one ``TELEMETRY_SNAPSHOT``
summary event carrying the plane's overflow accounting (ring evictions,
collector failures, scrape errors).

The port's copy of tez_tpu.am.telemetry's TelemetrySampler.  The port has
no SLO watchdog (burn-rate evaluation) and no web UI (the continuous
doctor, ``live_status``).  Its collectors are tez_tpu's three: the buffer
store's tier and tenant bytes, the shuffle service's registered-run
inventory and the mesh exchange's per-device lane occupancy.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Optional

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
        """One sweep: sample the rings.  Public so tests drive the plane
        deterministically without a thread."""
        timeseries.registry().sample(now_ns)
        self.ticks += 1

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

    def _halt(self) -> None:
        self._stop_event.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
