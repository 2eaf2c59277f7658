"""The umbilical: runner <-> AM control protocol.

Reference parity: tez-runtime-internals/.../common/TezTaskUmbilicalProtocol.java:42
(getTask / heartbeat / canCommit) + tez-dag TaskCommunicatorManager.java:220
(heartbeat event routing) and TezTaskCommunicatorImpl (getTask :311).

In local mode this is a plain in-process object; a multi-host deployment puts
a gRPC server in front of the same interface (the TaskCommunicator service
plugin seam).  Heartbeats batch task events up and pull routed input events
down, exactly like TezHeartbeatRequest/Response.

The port's copy of tez_tpu.am.task_comm.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Any, Dict, List, Optional, Sequence

from tez_tpu_torch.api.events import TezAPIEvent, TezEvent
from tez_tpu_torch.am.events import (TaskAttemptEvent, TaskAttemptEventType,
                                     VertexEvent, VertexEventType)
from tez_tpu_torch.common import clock, epoch as epoch_registry
from tez_tpu_torch.common import faults, tracing
from tez_tpu_torch.common.counters import TezCounters
from tez_tpu_torch.common.ids import ContainerId, TaskAttemptId
from tez_tpu_torch.runtime.task_spec import TaskSpec

log = logging.getLogger(__name__)


@dataclasses.dataclass
class HeartbeatRequest:
    attempt_id: TaskAttemptId
    events: List[TezEvent]
    counters: Optional[TezCounters] = None
    progress: float = 0.0
    #: AM epoch stamped into the runner's TaskSpec (0 = unstamped/legacy)
    epoch: int = 0
    #: Streaming window coordinate of the generalized fence (0 = batch)
    window_id: int = 0
    #: Stream identity the window belongs to ("" = not streaming)
    stream: str = ""


@dataclasses.dataclass
class HeartbeatResponse:
    events: List[TezAPIEvent]
    should_die: bool = False


class _AttemptSession:
    __slots__ = ("edge_seqs", "killed", "last_heartbeat", "custom_events",
                 "custom_seq", "last_progress", "last_activity")

    def __init__(self) -> None:
        self.edge_seqs: Dict[str, int] = {}
        self.killed = False
        self.last_heartbeat = clock.wall_s()
        self.custom_events: List[TezAPIEvent] = []
        # progress-stuck detection (TaskHeartbeatHandler progress check):
        # an attempt that heartbeats but whose progress never moves and
        # which generates no events is hung, not alive
        self.last_progress = -1.0
        self.last_activity = clock.wall_s()


class TaskCommunicatorManager:
    """AM side of the umbilical."""

    def __init__(self, ctx: Any):
        self.ctx = ctx
        self._sessions: Dict[TaskAttemptId, _AttemptSession] = {}
        self._lock = threading.Lock()
        # epoch fencing: this comm serves exactly one AM incarnation; it
        # rejects messages stamped with an older epoch AND stops arbitrating
        # once a newer incarnation registers (zombie-AM self-fencing)
        self.epoch = int(getattr(ctx, "attempt", 0) or 0)
        from tez_tpu_torch.common import config as C
        conf = getattr(ctx, "conf", None)
        self._fencing = bool(conf.get(C.AM_EPOCH_FENCING_ENABLED)) \
            if conf is not None else True
        #: fencing rejections served by this incarnation (status surface;
        #: counter_diff reads the journaled ATTEMPT_FENCED records instead)
        self.fenced_count = 0
        if self.epoch > 0:
            epoch_registry.register(getattr(ctx, "app_id", ""), self.epoch)

    def _fenced(self, msg_epoch: int, detail: str,
                window_id: int = 0, stream: str = "") -> bool:
        """True when the caller (or this AM itself) is from a stale epoch,
        or — streaming mode — from a *known-older window* of a live stream
        (the ``(attempt_epoch, window_id)`` fence generalization)."""
        if not self._fencing or self.epoch <= 0:
            return False
        app_id = getattr(self.ctx, "app_id", "")
        if epoch_registry.is_stale_window(app_id, stream, window_id):
            faults.fire("fence.stale_window", detail=detail)
            tracing.event("fence.stale_window", seam="umbilical",
                          reason="stale_window", window_id=window_id,
                          stream=stream,
                          current=epoch_registry.current_window(
                              app_id, stream),
                          detail=detail)
            log.warning("fenced stale-window message (%s window %d < %d): %s",
                        stream, window_id,
                        epoch_registry.current_window(app_id, stream), detail)
            self._record_fence("stale_window", msg_epoch, detail,
                               window_id=window_id, stream=stream)
            return True
        if 0 < msg_epoch < self.epoch:
            faults.fire("fence.stale_epoch", detail=detail)
            tracing.event("fence.stale_epoch", seam="umbilical",
                          reason="stale_sender", msg_epoch=msg_epoch,
                          am_epoch=self.epoch, detail=detail)
            log.warning("fenced stale-epoch message (epoch %d < %d): %s",
                        msg_epoch, self.epoch, detail)
            self._record_fence("stale_sender", msg_epoch, detail)
            return True
        if epoch_registry.is_stale(app_id, self.epoch):
            faults.fire("fence.stale_epoch", detail=detail)
            tracing.event("fence.stale_epoch", seam="umbilical",
                          reason="superseded_am", am_epoch=self.epoch,
                          current=epoch_registry.current(app_id),
                          detail=detail)
            log.warning("AM epoch %d superseded by %d; refusing: %s",
                        self.epoch, epoch_registry.current(app_id), detail)
            self._record_fence("superseded_am", msg_epoch, detail)
            return True
        return False

    def _record_fence(self, reason: str, msg_epoch: int, detail: str,
                      window_id: int = 0, stream: str = "") -> None:
        """Make every fencing rejection forensically visible: a flight MARK
        (acceptance surface for chaos --am-kill) plus an ATTEMPT_FENCED
        journal record (counter_diff's zombie-fenced tally).  Rare by
        construction — a zombie runner dies on its first fenced heartbeat —
        so a journal record per rejection is cheap."""
        self.fenced_count += 1
        from tez_tpu_torch.obs import flight
        flight.record(flight.MARK, "fence.stale_epoch", detail,
                      a=msg_epoch, b=self.epoch)
        history = getattr(self.ctx, "history", None)
        if history is None:
            return
        try:
            from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
            data = {"reason": reason, "msg_epoch": msg_epoch,
                    "am_epoch": self.epoch, "detail": detail}
            if stream:
                data["stream"] = stream
                data["window_id"] = window_id
            history(HistoryEvent(HistoryEventType.ATTEMPT_FENCED, data=data))
        except Exception:  # noqa: BLE001 — forensics never block fencing
            log.exception("ATTEMPT_FENCED journaling failed")

    # -- runner-facing API (called from runner threads) ----------------------
    def get_task(self, container_id: ContainerId, timeout: float = 1.0,
                 node_id: str = "") -> Optional[TaskSpec]:
        node = node_id or self.ctx.node_id
        tracker = getattr(self.ctx, "node_tracker", None)
        if tracker is not None:
            tracker.node_seen(node)
            if not tracker.is_usable(node):
                # blacklisted node: starve its runner so it exits and the
                # pool replaces it elsewhere (AMNodeImpl blacklisting)
                return None
        spec = self.ctx.task_scheduler.get_task(container_id, timeout)
        if spec is None:
            return None
        with self._lock:
            self._sessions[spec.attempt_id] = _AttemptSession()
        self.ctx.dispatch(TaskAttemptEvent(
            TaskAttemptEventType.TA_STARTED_REMOTELY, spec.attempt_id,
            container_id=container_id, node_id=node))
        return spec

    def heartbeat(self, request: HeartbeatRequest) -> HeartbeatResponse:
        # delay mode here starves the liveness monitor (the runner's
        # heartbeat thread stalls before the AM sees the beat); fail mode
        # surfaces as an umbilical fault on the runner side
        faults.fire("am.heartbeat", detail=str(request.attempt_id))
        if self._fenced(getattr(request, "epoch", 0),
                        f"heartbeat {request.attempt_id}",
                        window_id=getattr(request, "window_id", 0),
                        stream=getattr(request, "stream", "")):
            # a zombie runner must stop, not keep feeding a dead (or wrong)
            # incarnation's state machines
            return HeartbeatResponse(events=[], should_die=True)
        session = self._session(request.attempt_id)
        session.last_heartbeat = clock.wall_s()
        if request.events or request.progress != session.last_progress:
            session.last_progress = request.progress
            session.last_activity = session.last_heartbeat
        if request.events:
            self._route_events(request.attempt_id, request.events)
        if request.counters is not None or request.progress:
            self.ctx.dispatch(TaskAttemptEvent(
                TaskAttemptEventType.TA_STATUS_UPDATE, request.attempt_id,
                counters=request.counters, progress=request.progress))
        events = self._pull_events(request.attempt_id, session)
        return HeartbeatResponse(events=events, should_die=session.killed)

    def can_commit(self, attempt_id: TaskAttemptId, epoch: int = 0,
                   window_id: int = 0, stream: str = "") -> bool:
        # commit arbitration is the last line of exactly-once defense: a
        # zombie attempt (or this comm itself, once superseded) never wins,
        # and neither does a straggler from a sealed streaming window
        if self._fenced(epoch, f"can_commit {attempt_id}",
                        window_id=window_id, stream=stream):
            return False
        vertex = self._vertex_for(attempt_id)
        if vertex is None:
            return False
        task = vertex.tasks.get(attempt_id.task_id.id)
        if task is None:
            return False
        with self._lock:  # serialize commit arbitration
            return task.can_commit(attempt_id)

    def task_done(self, attempt_id: TaskAttemptId, events: List[TezEvent],
                  counters: Optional[TezCounters], epoch: int = 0,
                  window_id: int = 0, stream: str = "") -> None:
        if self._fenced(epoch, f"task_done {attempt_id}",
                        window_id=window_id, stream=stream):
            return
        if events:
            self._route_events(attempt_id, events)
        self.ctx.dispatch(TaskAttemptEvent(
            TaskAttemptEventType.TA_DONE, attempt_id, counters=counters))
        self._drop_session(attempt_id)

    def task_failed(self, attempt_id: TaskAttemptId, diagnostics: str,
                    fatal: bool = False,
                    counters: Optional[TezCounters] = None) -> None:
        if self._fenced(0, f"task_failed {attempt_id}"):
            return
        self.ctx.dispatch(TaskAttemptEvent(
            TaskAttemptEventType.TA_FAILED, attempt_id,
            diagnostics=diagnostics, fatal=fatal, counters=counters))
        self._drop_session(attempt_id)

    def task_killed(self, attempt_id: TaskAttemptId, diagnostics: str) -> None:
        if self._fenced(0, f"task_killed {attempt_id}"):
            return
        self.ctx.dispatch(TaskAttemptEvent(
            TaskAttemptEventType.TA_KILL_REQUEST, attempt_id,
            diagnostics=diagnostics))
        self._drop_session(attempt_id)

    def should_die(self, attempt_id: TaskAttemptId) -> bool:
        with self._lock:
            s = self._sessions.get(attempt_id)
        return s.killed if s is not None else True

    # -- AM-facing -----------------------------------------------------------
    def kill_attempt(self, attempt_id: TaskAttemptId) -> None:
        with self._lock:
            s = self._sessions.get(attempt_id)
            if s is not None:
                s.killed = True

    def deliver_custom_events(self, attempt_id: TaskAttemptId,
                              events: Sequence[TezAPIEvent]) -> None:
        with self._lock:
            s = self._sessions.get(attempt_id)
            if s is not None:
                s.custom_events.extend(events)

    def sessions_snapshot(self) -> Dict[TaskAttemptId, float]:
        """Excludes sessions already marked to die — the monitor must not
        re-fire on an attempt whose teardown is in flight."""
        with self._lock:
            return {a: s.last_heartbeat for a, s in self._sessions.items()
                    if not s.killed}

    def activity_snapshot(self) -> Dict[TaskAttemptId, float]:
        """attempt -> last time its progress moved or it produced events
        (the progress-stuck detector's input); killed sessions excluded."""
        with self._lock:
            return {a: s.last_activity for a, s in self._sessions.items()
                    if not s.killed}

    # -- internals -----------------------------------------------------------
    def _session(self, attempt_id: TaskAttemptId) -> _AttemptSession:
        with self._lock:
            s = self._sessions.get(attempt_id)
            if s is None:
                s = self._sessions[attempt_id] = _AttemptSession()
            return s

    def _drop_session(self, attempt_id: TaskAttemptId) -> None:
        # Session survives until the attempt's terminal event is processed;
        # dropping immediately is fine because routed events were flushed.
        with self._lock:
            self._sessions.pop(attempt_id, None)

    def _route_events(self, attempt_id: TaskAttemptId,
                      events: List[TezEvent]) -> None:
        vertex_id = attempt_id.vertex_id
        for tez_event in events:
            self.ctx.dispatch(VertexEvent(
                VertexEventType.V_ROUTE_EVENT, vertex_id,
                tez_event=tez_event))

    def _vertex_for(self, attempt_id: TaskAttemptId) -> Any:
        """Resolve through the live-DAG registry — the attempt's id chain
        names its DAG, so concurrent DAGs never cross wires here."""
        find = getattr(self.ctx, "find_dag", None)
        dag = find(attempt_id.vertex_id.dag_id) if find is not None \
            else getattr(self.ctx, "current_dag", None)
        return dag.vertex_by_id(attempt_id.vertex_id) \
            if dag is not None else None

    def _pull_events(self, attempt_id: TaskAttemptId,
                     session: _AttemptSession) -> List[TezAPIEvent]:
        vertex = self._vertex_for(attempt_id)
        if vertex is None:
            return []
        # bound one heartbeat response (tez.task.max-event-backlog): a
        # 10k-source fan-in must stream events across heartbeats, not ship
        # one giant response that stalls the umbilical
        from tez_tpu_torch.common import config as C
        max_events = int(self.ctx.conf.get(C.TASK_MAX_EVENT_BACKLOG)) \
            if getattr(self.ctx, "conf", None) is not None else 0
        out = vertex.get_task_events(attempt_id.task_id.id,
                                     session.edge_seqs,
                                     max_events=max_events)
        with self._lock:
            if session.custom_events:
                out.extend(("__custom__", ev) for ev in session.custom_events)
                session.custom_events = []
        return out
