"""Liveness monitoring: stale task attempts are timed out.

Reference parity: tez-dag/.../app/TaskHeartbeatHandler.java +
ContainerHeartbeatHandler.java — attempts whose umbilical has gone silent
past the timeout are failed so the task retries elsewhere.

The port's copy of tez_tpu.am.heartbeat.
"""
from __future__ import annotations

import logging
import threading
from typing import Any

from tez_tpu_torch.am.events import TaskAttemptEvent, TaskAttemptEventType
from tez_tpu_torch.common import clock, config as C
from tez_tpu_torch.common import faults

log = logging.getLogger(__name__)


class HeartbeatMonitor:
    def __init__(self, ctx: Any, check_interval: float = 1.0):
        self.ctx = ctx
        self.check_interval = check_interval
        self.timeout_ms = ctx.conf.get(C.TASK_HEARTBEAT_TIMEOUT_MS)
        #: -1 = off; >0 = kill attempts whose progress/events stall this
        #: long even though heartbeats keep arriving (hung-but-alive)
        self.stuck_ms = ctx.conf.get(C.TASK_PROGRESS_STUCK_INTERVAL_MS)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="heartbeat-monitor")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self.check_interval):
            try:
                self._check()
            except BaseException:  # noqa: BLE001
                log.exception("heartbeat check failed")

    def _check(self) -> None:
        # delay mode stalls the liveness sweep itself (failure detection
        # latency under chaos); the loop's BaseException guard absorbs fail
        # mode into a logged, skipped tick
        faults.fire("am.heartbeat.monitor")
        # a superseded AM's monitor must not keep dispatching TA_TIMED_OUT
        # or respawning runners against the live incarnation's resources
        from tez_tpu_torch.common import epoch as epoch_registry
        my_epoch = int(getattr(self.ctx, "attempt", 0) or 0)
        if my_epoch > 0 and epoch_registry.is_stale(
                getattr(self.ctx, "app_id", ""), my_epoch):
            faults.fire("fence.stale_epoch", detail="heartbeat.monitor")
            self._stop.set()
            return
        # Watchdog for the runner pool: a runner deciding to idle-exit still
        # counts as capacity at schedule time, so queued work could strand
        # with nothing re-triggering a spawn.  Re-examine the backlog every
        # tick (reference: the AM's scheduling heartbeat serves this role).
        backlog = self.ctx.task_scheduler.backlog()
        if backlog > 0:
            self.ctx.ensure_runners(backlog)
        now = clock.wall_s()
        if self.timeout_ms > 0:
            cutoff = self.timeout_ms / 1000.0
            for attempt_id, last in \
                    self.ctx.task_comm.sessions_snapshot().items():
                if now - last > cutoff:
                    log.warning("attempt %s heartbeat timed out (%.1fs)",
                                attempt_id, now - last)
                    self.ctx.dispatch(TaskAttemptEvent(
                        TaskAttemptEventType.TA_TIMED_OUT, attempt_id,
                        diagnostics=f"no heartbeat for {now - last:.1f}s"))
        if self.stuck_ms and self.stuck_ms > 0:
            # progress-stuck: heartbeats arrive but nothing moves
            # (TaskHeartbeatHandler progress check; reference:
            # tez.task.progress.stuck.interval-ms)
            cutoff = self.stuck_ms / 1000.0
            for attempt_id, last in \
                    self.ctx.task_comm.activity_snapshot().items():
                if now - last > cutoff:
                    log.warning("attempt %s made no progress for %.1fs; "
                                "killing for retry", attempt_id, now - last)
                    # the runner is ALIVE (it heartbeats): tell it to die
                    # so its container frees for the retry — TA_TIMED_OUT
                    # alone only updates AM state.  kill_attempt also
                    # drops the session from the snapshots, so this fires
                    # once per hang, not once per tick.
                    self.ctx.task_comm.kill_attempt(attempt_id)
                    self.ctx.dispatch(TaskAttemptEvent(
                        TaskAttemptEventType.TA_TIMED_OUT, attempt_id,
                        diagnostics=f"no progress for {now - last:.1f}s "
                                    f"(tez.task.progress.stuck.interval-ms="
                                    f"{self.stuck_ms})"))
