"""Runner pool: the container launcher + TezChild loop, in-process.

Reference parity: tez-dag ContainerLauncherManager.java:62 +
LocalContainerLauncher.java:87 (tasks as threads, uber-style) + the TezChild
run loop (tez-runtime-internals TezChild.java:214).  A "container" here is a
worker thread with an object registry (so kernel caches survive across tasks
— the analog of JVM container reuse); in a deployment each would be a
runner process on a host.

The port's copy of tez_tpu.am.launcher's RunnerPool: every runner thread
builds its TaskRunner on the AM's device (resolved once by the AM).
Runner processes (SubprocessRunnerPool) are not ported yet.
"""
from __future__ import annotations

import itertools
import logging
import threading
from typing import Any, Dict, Optional

from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
from tez_tpu_torch.api.runtime import ObjectRegistry
from tez_tpu_torch.common import clock, faults
from tez_tpu_torch.common.counters import DAGCounter
from tez_tpu_torch.common.ids import ContainerId

log = logging.getLogger(__name__)


class RunnerPool:
    def __init__(self, ctx: Any, max_runners: int,
                 idle_timeout: Optional[float] = None):
        self.ctx = ctx
        self.max_runners = max_runners
        conf = getattr(ctx, "conf", None)
        if idle_timeout is None:
            ms = conf.get("tez.am.container.idle.release-timeout-min.millis") \
                if conf is not None else None
            idle_timeout = (5000 if ms is None else ms) / 1000.0
        self.idle_timeout = idle_timeout
        #: session mode holds this many runners even when idle (reference:
        #: tez.am.session.min.held-containers)
        self.min_held = int(conf.get("tez.am.session.min.held-containers")
                            or 0) if conf is not None else 0
        #: reuse off = one task per container, fresh ObjectRegistry/caches
        #: every time (reference: tez.am.container.reuse.enabled)
        from tez_tpu_torch.common import config as C
        reuse = conf.get(C.AM_CONTAINER_REUSE_ENABLED) \
            if conf is not None else None
        self.reuse_enabled = True if reuse is None else bool(reuse)
        self._runners: Dict[ContainerId, threading.Thread] = {}
        self._seq = itertools.count()
        self._lock = threading.Lock()
        self._stopped = False

    def ensure_runners(self, backlog: int) -> None:
        """Spin up runner threads while there is queued work and capacity."""
        with self._lock:
            if self._stopped:
                return
            want = min(self.max_runners, len(self._runners) + max(0, backlog))
            while len(self._runners) < want:
                cid = ContainerId(self.ctx.app_id, next(self._seq))
                t = threading.Thread(target=self._runner_loop, args=(cid,),
                                     name=str(cid), daemon=True)
                self._runners[cid] = t
                t.start()

    def _runner_loop(self, container_id: ContainerId) -> None:
        """The TezChild loop: pull task, run, repeat until idle."""
        from tez_tpu_torch.runtime.task_runner import TaskRunner
        self.ctx.history(HistoryEvent(
            HistoryEventType.CONTAINER_LAUNCHED,
            container_id=str(container_id)))
        registry = ObjectRegistry()
        tasks_run = 0
        try:
            try:
                faults.fire("am.container.launch", detail=str(container_id))
            except Exception as e:  # noqa: BLE001 — injected launch failure
                # dies like a container that crashed at startup: the finally
                # emits CONTAINER_STOPPED and the watchdog respawns while
                # backlog remains
                log.warning("container %s launch failed: %s", container_id, e)
                return
            while not self._stopped:
                spec = self.ctx.task_comm.get_task(container_id,
                                                   timeout=self.idle_timeout)
                if spec is None:
                    tracker = getattr(self.ctx, "node_tracker", None)
                    if tracker is not None and \
                            not tracker.is_usable(self.ctx.node_id):
                        break   # blacklisted node must not hold-and-spin
                    # idle release — but session mode keeps min.held runners
                    # warm (container reuse across DAGs; kernel caches
                    # live).  Decision and table removal are ATOMIC so
                    # several simultaneously-idle runners can't all leave.
                    with self._lock:
                        if len(self._runners) > self.min_held:
                            self._runners.pop(container_id, None)
                            break
                    continue
                if tasks_run > 0:
                    self.ctx.dag_counters.increment(
                        DAGCounter.TOTAL_CONTAINER_REUSE_COUNT)
                tasks_run += 1
                runner = TaskRunner(spec, self.ctx.task_comm, registry,
                                    work_dir=self.ctx.work_dir,
                                    node_id=self.ctx.node_id,
                                    device=self.ctx.device)
                runner.run()
                registry.clear_scope(ObjectRegistry.VERTEX)
                if not self.reuse_enabled:
                    # one task per container: exit; ensure_runners spawns a
                    # fresh one (fresh registry) while backlog remains
                    with self._lock:
                        self._runners.pop(container_id, None)
                    break
        finally:
            with self._lock:
                self._runners.pop(container_id, None)
            self.ctx.history(HistoryEvent(
                HistoryEventType.CONTAINER_STOPPED,
                container_id=str(container_id),
                data={"tasks_run": tasks_run}))

    def live_count(self) -> int:
        with self._lock:
            return len(self._runners)

    def shutdown(self, wait: bool = True) -> None:
        self._stopped = True
        if wait:
            deadline = clock.wall_s() + 10
            for t in list(self._runners.values()):
                t.join(timeout=max(0.1, deadline - clock.wall_s()))
