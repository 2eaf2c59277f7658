"""Task and TaskAttempt state machines.

Reference parity: tez-dag/.../dag/impl/TaskImpl.java:114 (retry counting,
commit arbitration, output-failure re-run, speculation hooks) and
TaskAttemptImpl.java:126 (schedule -> container assignment -> RUNNING ->
terminal).  Transition tables are explicit like the reference's
StateMachineFactory declarations, with the container-allocation sub-states
collapsed (the runner pool pulls work, so allocation == queue pop).

The port's copy of tez_tpu.am.task_impl.
"""
from __future__ import annotations

import enum
import logging
from typing import Any, Dict, List, Optional, TYPE_CHECKING

from tez_tpu_torch.common import clock
from tez_tpu_torch.am.events import (SchedulerEvent, SchedulerEventType,
                                     TaskEvent, TaskAttemptEvent,
                                     TaskAttemptEventType, TaskEventType,
                                     VertexEvent, VertexEventType)
from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
from tez_tpu_torch.common.counters import DAGCounter, TezCounters
from tez_tpu_torch.common.ids import TaskAttemptId, TaskId
from tez_tpu_torch.common.statemachine import StateMachineFactory

if TYPE_CHECKING:
    from tez_tpu_torch.am.vertex_impl import VertexImpl

log = logging.getLogger(__name__)


class TaskState(enum.Enum):
    NEW = enum.auto()
    SCHEDULED = enum.auto()
    RUNNING = enum.auto()
    SUCCEEDED = enum.auto()
    FAILED = enum.auto()
    KILLED = enum.auto()


class TaskAttemptState(enum.Enum):
    NEW = enum.auto()
    SUBMITTED = enum.auto()     # queued at the scheduler
    RUNNING = enum.auto()       # runner picked it up
    SUCCEEDED = enum.auto()
    FAILED = enum.auto()
    KILLED = enum.auto()


TERMINAL_ATTEMPT_STATES = frozenset(
    {TaskAttemptState.SUCCEEDED, TaskAttemptState.FAILED, TaskAttemptState.KILLED})
TERMINAL_TASK_STATES = frozenset(
    {TaskState.SUCCEEDED, TaskState.FAILED, TaskState.KILLED})


class TaskAttemptImpl:
    """One execution attempt of a task."""

    _factory: StateMachineFactory = None  # built below

    def __init__(self, attempt_id: TaskAttemptId, vertex: "VertexImpl"):
        self.attempt_id = attempt_id
        self.vertex = vertex
        self.ctx = vertex.ctx
        self.counters = TezCounters()
        self.diagnostics: List[str] = []
        self.container_id: Any = None
        self.node_id: str = ""
        self.progress: float = 0.0
        self.launch_time: float = 0.0
        self.finish_time: float = 0.0
        self.creation_time: float = clock.wall_s()
        self.is_speculative = False
        self.is_rescheduled = False   # re-run after output loss
        self.output_failure_reports: Dict[int, int] = {}  # consumer task -> count
        self.first_output_failure_time = 0.0
        # (edge dest vertex name, event) pairs this attempt produced — journaled
        # on success so AM recovery can re-route them without re-running the
        # task (reference: TaskAttemptFinishedEvent taGeneratedEvents).
        self.generated_events: List[tuple] = []
        self.sm = self._factory.make(self)

    @property
    def state(self) -> TaskAttemptState:
        return self.sm.state

    def handle(self, event: TaskAttemptEvent) -> None:
        if self.state in TERMINAL_ATTEMPT_STATES:
            # Late/racing events against finished attempts are dropped, with
            # one exception: output-failure against a SUCCEEDED attempt.
            if (event.event_type is TaskAttemptEventType.TA_OUTPUT_FAILED
                    and self.state is TaskAttemptState.SUCCEEDED):
                self._on_output_failed(event)
            return
        if not self.sm.can_handle(event.event_type):
            log.debug("attempt %s: ignoring %s in %s", self.attempt_id,
                      event.event_type, self.state)
            return
        self.sm.handle(event)

    # -- transition hooks ----------------------------------------------------
    def _on_schedule(self, event: TaskAttemptEvent) -> None:
        # a reschedule after output loss blocks live consumers: boost it
        # ahead of its vertex's normal work (reference:
        # TEZ_AM_TASK_RESCHEDULE_HIGHER_PRIORITY; lower value = sooner)
        priority = self.vertex.priority
        if self.is_rescheduled and bool(self.vertex.conf.get(
                "tez.am.task.reschedule.higher.priority", True)):
            priority -= 1
        self.ctx.dispatch(SchedulerEvent(
            SchedulerEventType.S_TA_LAUNCH_REQUEST,
            attempt_id=self.attempt_id, task_spec=event.task_spec,
            priority=priority))

    def _on_started(self, event: TaskAttemptEvent) -> None:
        self.container_id = getattr(event, "container_id", None)
        self.node_id = getattr(event, "node_id", "")
        self.launch_time = clock.wall_s()
        self.ctx.history(HistoryEvent(
            HistoryEventType.TASK_ATTEMPT_STARTED,
            dag_id=str(self.attempt_id.dag_id),
            vertex_id=str(self.attempt_id.vertex_id),
            task_id=str(self.attempt_id.task_id),
            attempt_id=str(self.attempt_id),
            container_id=str(self.container_id),
            data={"vertex_name": self.vertex.name,
                  "node_id": self.node_id}))
        self.ctx.dispatch(TaskEvent(TaskEventType.T_ATTEMPT_LAUNCHED,
                                    self.attempt_id.task_id,
                                    attempt_id=self.attempt_id))

    def _on_status_update(self, event: TaskAttemptEvent) -> None:
        self.progress = getattr(event, "progress", self.progress)
        counters = getattr(event, "counters", None)
        if counters is not None:
            self.counters = counters

    def _on_done(self, event: TaskAttemptEvent) -> None:
        self.finish_time = clock.wall_s()
        counters = getattr(event, "counters", None)
        if counters is not None:
            self.counters = counters
        self.progress = 1.0
        self._finish_history("SUCCEEDED")
        self.ctx.dispatch(TaskEvent(TaskEventType.T_ATTEMPT_SUCCEEDED,
                                    self.attempt_id.task_id,
                                    attempt_id=self.attempt_id))
        self._notify_scheduler_ended()

    def _on_failed(self, event: TaskAttemptEvent) -> None:
        self.finish_time = clock.wall_s()
        diag = getattr(event, "diagnostics", "")
        if diag:
            self.diagnostics.append(diag)
        self.failure_fatal = getattr(event, "fatal", False)
        self._finish_history("FAILED")
        self.ctx.dispatch(TaskEvent(TaskEventType.T_ATTEMPT_FAILED,
                                    self.attempt_id.task_id,
                                    attempt_id=self.attempt_id,
                                    fatal=self.failure_fatal))
        self._notify_scheduler_ended(failed=True)

    def _on_killed(self, event: TaskAttemptEvent) -> None:
        self.finish_time = clock.wall_s()
        diag = getattr(event, "diagnostics", "")
        if diag:
            self.diagnostics.append(diag)
        self.ctx.kill_attempt_in_runner(self.attempt_id)
        self._finish_history("KILLED")
        self.ctx.dispatch(TaskEvent(TaskEventType.T_ATTEMPT_KILLED,
                                    self.attempt_id.task_id,
                                    attempt_id=self.attempt_id))
        self._notify_scheduler_ended()

    def _on_output_failed(self, event: TaskAttemptEvent) -> None:
        """A consumer could not read this attempt's output.  Mirrors
        TaskAttemptImpl output-failure accounting: enough distinct failures
        (or a local-fetch/source-disk error) fail the SUCCEEDED attempt so
        the task re-runs (reference: SURVEY.md §3.5 fetch-failure path)."""
        consumer = getattr(event, "consumer_task_index", -1)
        if not self.output_failure_reports:
            self.first_output_failure_time = clock.wall_s()
        self.output_failure_reports[consumer] = \
            self.output_failure_reports.get(consumer, 0) + 1
        max_failures = self.vertex.conf.get("tez.am.max.allowed.output.failures", 10)
        num_consumers = max(1, self.vertex.downstream_consumer_count(
            self.attempt_id.task_id.id))
        fraction = len(self.output_failure_reports) / num_consumers
        max_fraction = self.vertex.conf.get(
            "tez.am.max.allowed.output.failures.fraction", 0.1)
        # reports persisting past this window fail the output regardless of
        # counts — consumers have been stuck on it for too long (reference:
        # TEZ_AM_MAX_ALLOWED_TIME_FOR_TASK_READ_ERROR_SEC)
        max_window = float(self.vertex.conf.get(
            "tez.am.max.allowed.time-sec.for-read-error", 300))
        window_expired = \
            clock.wall_s() - self.first_output_failure_time > max_window
        local_fetch = getattr(event, "is_local_fetch", False)
        disk_error = getattr(event, "is_disk_error_at_source", False)
        total = sum(self.output_failure_reports.values())
        if local_fetch or disk_error or total >= max_failures or \
                fraction > max_fraction or window_expired:
            log.info("attempt %s: output lost (%d reports) -> re-running task",
                     self.attempt_id, total)
            self.sm.force_state(TaskAttemptState.FAILED)
            self.diagnostics.append(
                f"output lost: {total} fetch failures reported")
            self.ctx.dispatch(TaskEvent(TaskEventType.T_ATTEMPT_FAILED,
                                        self.attempt_id.task_id,
                                        attempt_id=self.attempt_id,
                                        was_succeeded=True))

    def _finish_history(self, final_state: str) -> None:
        data = {"state": final_state,
                "vertex_name": self.vertex.name,
                "time_taken": self.finish_time - (self.launch_time or
                                                  self.finish_time),
                "diagnostics": "; ".join(self.diagnostics),
                "counters": self.counters.to_dict()}
        if final_state == "SUCCEEDED" and self.generated_events:
            from tez_tpu_torch.am.recovery import event_to_wire
            data["generated_events"] = [
                [name, event_to_wire(ev)] for name, ev in self.generated_events]
        self.ctx.history(HistoryEvent(
            HistoryEventType.TASK_ATTEMPT_FINISHED,
            dag_id=str(self.attempt_id.dag_id),
            vertex_id=str(self.attempt_id.vertex_id),
            task_id=str(self.attempt_id.task_id),
            attempt_id=str(self.attempt_id),
            data=data))

    def _notify_scheduler_ended(self, failed: bool = False) -> None:
        self.ctx.dispatch(SchedulerEvent(SchedulerEventType.S_TA_ENDED,
                                         attempt_id=self.attempt_id,
                                         failed=failed,
                                         node_id=self.node_id))


def _build_attempt_factory() -> StateMachineFactory:
    S, E = TaskAttemptState, TaskAttemptEventType
    f = StateMachineFactory(S.NEW)
    f.add(S.NEW, S.SUBMITTED, E.TA_SCHEDULE, TaskAttemptImpl._on_schedule)
    f.add(S.NEW, S.KILLED, E.TA_KILL_REQUEST, TaskAttemptImpl._on_killed)
    f.add(S.SUBMITTED, S.RUNNING, E.TA_STARTED_REMOTELY, TaskAttemptImpl._on_started)
    f.add(S.SUBMITTED, S.KILLED, E.TA_KILL_REQUEST, TaskAttemptImpl._on_killed)
    f.add(S.SUBMITTED, S.FAILED, E.TA_FAILED, TaskAttemptImpl._on_failed)
    f.add(S.RUNNING, S.RUNNING, E.TA_STATUS_UPDATE, TaskAttemptImpl._on_status_update)
    f.add(S.RUNNING, S.SUCCEEDED, E.TA_DONE, TaskAttemptImpl._on_done)
    f.add(S.RUNNING, S.FAILED, E.TA_FAILED, TaskAttemptImpl._on_failed)
    f.add(S.RUNNING, S.FAILED, E.TA_TIMED_OUT, TaskAttemptImpl._on_failed)
    f.add(S.RUNNING, S.KILLED, E.TA_KILL_REQUEST, TaskAttemptImpl._on_killed)
    f.add(S.RUNNING, S.FAILED, E.TA_CONTAINER_TERMINATED, TaskAttemptImpl._on_failed)
    return f


TaskAttemptImpl._factory = _build_attempt_factory()


class TaskImpl:
    """Task: a retry/speculation envelope over attempts."""

    _factory: StateMachineFactory = None

    def __init__(self, task_id: TaskId, vertex: "VertexImpl"):
        self.task_id = task_id
        self.vertex = vertex
        self.ctx = vertex.ctx
        self.attempts: Dict[int, TaskAttemptImpl] = {}
        self.next_attempt_number = 0
        self.failed_attempts = 0
        self.killed_attempts = 0
        self.commit_attempt: Optional[TaskAttemptId] = None
        self.successful_attempt: Optional[TaskAttemptId] = None
        self.scheduled_time = 0.0
        self.finish_time = 0.0
        self.sm = self._factory.make(self)

    @property
    def state(self) -> TaskState:
        return self.sm.state

    @property
    def max_failed_attempts(self) -> int:
        return self.vertex.conf.get("tez.am.task.max.failed.attempts", 4)

    def handle(self, event: TaskEvent) -> None:
        if self.state in TERMINAL_TASK_STATES:
            if (event.event_type is TaskEventType.T_ATTEMPT_FAILED
                    and getattr(event, "was_succeeded", False)
                    and self.state is TaskState.SUCCEEDED):
                self._reschedule_after_output_loss(event)
            return
        if not self.sm.can_handle(event.event_type):
            log.debug("task %s: ignoring %s in %s", self.task_id,
                      event.event_type, self.state)
            return
        self.sm.handle(event)

    def attempt(self, attempt_id: TaskAttemptId) -> Optional[TaskAttemptImpl]:
        return self.attempts.get(attempt_id.id)

    # -- commit arbitration (reference: TaskImpl.canCommit) ------------------
    def can_commit(self, attempt_id: TaskAttemptId) -> bool:
        if self.state is TaskState.SUCCEEDED:
            return self.successful_attempt == attempt_id
        if self.commit_attempt is None:
            att = self.attempts.get(attempt_id.id)
            if att is None or att.state is not TaskAttemptState.RUNNING:
                return False
            self.commit_attempt = attempt_id
        return self.commit_attempt == attempt_id

    # -- hooks ---------------------------------------------------------------
    def _spawn_attempt(self, speculative: bool = False,
                       rescheduled: bool = False) -> TaskAttemptImpl:
        n = self.next_attempt_number
        self.next_attempt_number += 1
        att = TaskAttemptImpl(self.task_id.attempt(n), self.vertex)
        att.is_speculative = speculative
        att.is_rescheduled = rescheduled
        self.attempts[n] = att
        spec = self.vertex.build_task_spec(att.attempt_id)
        att.handle(TaskAttemptEvent(TaskAttemptEventType.TA_SCHEDULE,
                                    att.attempt_id, task_spec=spec))
        self.ctx.dag_counters.increment(DAGCounter.TOTAL_LAUNCHED_TASKS)
        if speculative:
            self.ctx.dag_counters.increment(DAGCounter.NUM_SPECULATIONS)
        return att

    def _on_schedule(self, event: TaskEvent) -> None:
        self.scheduled_time = clock.wall_s()
        self.ctx.history(HistoryEvent(
            HistoryEventType.TASK_STARTED,
            dag_id=str(self.task_id.dag_id),
            vertex_id=str(self.task_id.vertex_id),
            task_id=str(self.task_id),
            data={"vertex_name": self.vertex.name}))
        self._spawn_attempt()

    def _on_attempt_launched(self, event: TaskEvent) -> None:
        pass

    def _on_add_spec_attempt(self, event: TaskEvent) -> None:
        if len(self.live_attempts()) < 2:
            self._spawn_attempt(speculative=True)

    def live_attempts(self) -> List[TaskAttemptImpl]:
        return [a for a in self.attempts.values()
                if a.state not in TERMINAL_ATTEMPT_STATES]

    def _on_attempt_succeeded(self, event: TaskEvent) -> None:
        self.successful_attempt = event.attempt_id
        self.finish_time = clock.wall_s()
        # Kill other live attempts (speculation losers).
        for att in self.live_attempts():
            att.handle(TaskAttemptEvent(
                TaskAttemptEventType.TA_KILL_REQUEST, att.attempt_id,
                diagnostics="other attempt succeeded"))
        self.ctx.dag_counters.increment(DAGCounter.NUM_SUCCEEDED_TASKS)
        self._finish_history("SUCCEEDED")
        self.ctx.dispatch(VertexEvent(
            VertexEventType.V_TASK_COMPLETED, self.task_id.vertex_id,
            task_id=self.task_id, final_state=TaskState.SUCCEEDED,
            attempt_id=event.attempt_id))

    def _on_attempt_failed(self, event: TaskEvent) -> "TaskState":
        if self.commit_attempt == event.attempt_id:
            self.commit_attempt = None   # commit right dies with the attempt
        self.failed_attempts += 1
        fatal = getattr(event, "fatal", False)
        if not fatal and self.failed_attempts < self.max_failed_attempts:
            log.info("task %s: attempt %s failed (%d/%d), retrying",
                     self.task_id, event.attempt_id, self.failed_attempts,
                     self.max_failed_attempts)
            self._spawn_attempt()
            return TaskState.RUNNING
        self.finish_time = clock.wall_s()
        self.ctx.dag_counters.increment(DAGCounter.NUM_FAILED_TASKS)
        self._finish_history("FAILED")
        self.ctx.dispatch(VertexEvent(
            VertexEventType.V_TASK_COMPLETED, self.task_id.vertex_id,
            task_id=self.task_id, final_state=TaskState.FAILED,
            attempt_id=event.attempt_id,
            diagnostics=self._attempt_diagnostics(event)))
        return TaskState.FAILED

    def _attempt_diagnostics(self, event: TaskEvent) -> str:
        att = self.attempts.get(event.attempt_id.id)
        return "; ".join(att.diagnostics) if att else ""

    def _on_attempt_killed(self, event: TaskEvent) -> "TaskState":
        if self.commit_attempt == event.attempt_id:
            self.commit_attempt = None
        # Killed attempts don't count against retries (reference semantics);
        # spawn a replacement unless the task itself is terminating.
        if self._terminating:
            if not self.live_attempts():
                self.killed_attempts += 1
                self.finish_time = clock.wall_s()
                self.ctx.dag_counters.increment(DAGCounter.NUM_KILLED_TASKS)
                self._finish_history("KILLED")
                self.ctx.dispatch(VertexEvent(
                    VertexEventType.V_TASK_COMPLETED, self.task_id.vertex_id,
                    task_id=self.task_id, final_state=TaskState.KILLED,
                    attempt_id=event.attempt_id))
                return TaskState.KILLED
            return TaskState.RUNNING
        att = self.attempts.get(event.attempt_id.id)
        if att is not None and att.is_speculative:
            return TaskState.RUNNING
        self._spawn_attempt()
        return TaskState.RUNNING

    _terminating = False

    def _on_terminate(self, event: TaskEvent) -> "TaskState":
        self._terminating = True
        live = self.live_attempts()
        if not live:
            self.ctx.dag_counters.increment(DAGCounter.NUM_KILLED_TASKS)
            self._finish_history("KILLED")
            self.ctx.dispatch(VertexEvent(
                VertexEventType.V_TASK_COMPLETED, self.task_id.vertex_id,
                task_id=self.task_id, final_state=TaskState.KILLED,
                attempt_id=None))
            return TaskState.KILLED
        for att in live:
            att.handle(TaskAttemptEvent(
                TaskAttemptEventType.TA_KILL_REQUEST, att.attempt_id,
                diagnostics=getattr(event, "diagnostics", "task terminated")))
        return TaskState.RUNNING

    def _reschedule_after_output_loss(self, event: TaskEvent) -> None:
        """SUCCEEDED task whose output was lost: re-run (reference:
        TaskImpl output-failure retroactive transition)."""
        log.info("task %s: output lost, rescheduling", self.task_id)
        failed_version = event.attempt_id.id
        self.successful_attempt = None
        self.commit_attempt = None
        self.sm.force_state(TaskState.RUNNING)
        self.ctx.dispatch(VertexEvent(
            VertexEventType.V_TASK_RESCHEDULED, self.task_id.vertex_id,
            task_id=self.task_id, failed_version=failed_version))
        self._spawn_attempt(rescheduled=True)

    def _finish_history(self, final_state: str) -> None:
        data = {"state": final_state, "vertex_name": self.vertex.name,
                "time_taken": self.finish_time - self.scheduled_time}
        if final_state == "SUCCEEDED" and self.successful_attempt is not None:
            data["successful_attempt"] = str(self.successful_attempt)
        self.ctx.history(HistoryEvent(
            HistoryEventType.TASK_FINISHED,
            dag_id=str(self.task_id.dag_id),
            vertex_id=str(self.task_id.vertex_id),
            task_id=str(self.task_id),
            data=data))

    def successful_attempt_impl(self) -> Optional[TaskAttemptImpl]:
        if self.successful_attempt is None:
            return None
        return self.attempts.get(self.successful_attempt.id)


def _build_task_factory() -> StateMachineFactory:
    S, E = TaskState, TaskEventType
    f = StateMachineFactory(S.NEW)
    f.add(S.NEW, S.SCHEDULED, E.T_SCHEDULE, TaskImpl._on_schedule)
    f.add_multi(S.NEW, (S.RUNNING, S.KILLED), E.T_TERMINATE,
                TaskImpl._on_terminate)
    f.add(S.SCHEDULED, S.RUNNING, E.T_ATTEMPT_LAUNCHED, TaskImpl._on_attempt_launched)
    f.add_multi(S.SCHEDULED, (S.RUNNING, S.FAILED), E.T_ATTEMPT_FAILED,
                TaskImpl._on_attempt_failed)
    f.add_multi(S.SCHEDULED, (S.RUNNING, S.KILLED), E.T_ATTEMPT_KILLED,
                TaskImpl._on_attempt_killed)
    f.add_multi(S.SCHEDULED, (S.RUNNING, S.KILLED), E.T_TERMINATE,
                TaskImpl._on_terminate)
    f.add(S.SCHEDULED, S.SUCCEEDED, E.T_ATTEMPT_SUCCEEDED, TaskImpl._on_attempt_succeeded)
    f.add(S.RUNNING, S.RUNNING, E.T_ATTEMPT_LAUNCHED, TaskImpl._on_attempt_launched)
    f.add(S.RUNNING, S.RUNNING, E.T_ADD_SPEC_ATTEMPT, TaskImpl._on_add_spec_attempt)
    f.add(S.RUNNING, S.SUCCEEDED, E.T_ATTEMPT_SUCCEEDED, TaskImpl._on_attempt_succeeded)
    f.add_multi(S.RUNNING, (S.RUNNING, S.FAILED), E.T_ATTEMPT_FAILED,
                TaskImpl._on_attempt_failed)
    f.add_multi(S.RUNNING, (S.RUNNING, S.KILLED), E.T_ATTEMPT_KILLED,
                TaskImpl._on_attempt_killed)
    f.add_multi(S.RUNNING, (S.RUNNING, S.KILLED), E.T_TERMINATE,
                TaskImpl._on_terminate)
    return f


TaskImpl._factory = _build_task_factory()
