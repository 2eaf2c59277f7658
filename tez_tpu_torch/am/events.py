"""Orchestrator-internal events flowing through the central dispatcher.

Reference parity: tez-dag/.../dag/event/ (DAGEvent*, VertexEvent*, TaskEvent*,
TaskAttemptEvent*, AMSchedulerEvent*...).  One enum class per state-machine
family — the dispatcher routes on the enum class (AsyncDispatcher model).

The port's copy of tez_tpu.am.events.
"""
from __future__ import annotations

import enum
from typing import Any

from tez_tpu_torch.common.dispatcher import Event
from tez_tpu_torch.common.ids import (ContainerId, DAGId, TaskAttemptId,
                                      TaskId, VertexId)


# -- DAG ---------------------------------------------------------------------
class DAGEventType(enum.Enum):
    DAG_INIT = enum.auto()
    DAG_START = enum.auto()
    DAG_VERTEX_COMPLETED = enum.auto()
    DAG_VERTEX_RERUNNING = enum.auto()
    DAG_COMPLETED = enum.auto()          # internal: all vertices done
    DAG_KILL = enum.auto()
    DAG_COMMIT_COMPLETED = enum.auto()
    INTERNAL_ERROR = enum.auto()


class DAGEvent(Event):
    def __init__(self, event_type: DAGEventType, dag_id: DAGId, **kw: Any):
        super().__init__(event_type)
        self.dag_id = dag_id
        self.__dict__.update(kw)


# -- Vertex ------------------------------------------------------------------
class VertexEventType(enum.Enum):
    V_INIT = enum.auto()
    V_START = enum.auto()
    V_SOURCE_TASK_ATTEMPT_COMPLETED = enum.auto()
    V_SOURCE_VERTEX_STARTED = enum.auto()
    V_ROOT_INPUT_INITIALIZED = enum.auto()
    V_ROOT_INPUT_FAILED = enum.auto()
    V_TASK_COMPLETED = enum.auto()
    V_TASK_RESCHEDULED = enum.auto()
    V_TASK_ATTEMPT_COMPLETED = enum.auto()
    V_ROUTE_EVENT = enum.auto()
    V_MANAGER_USER_CODE_ERROR = enum.auto()
    V_TERMINATE = enum.auto()
    V_COMPLETED = enum.auto()            # internal bookkeeping check
    V_COMMIT_COMPLETED = enum.auto()     # per-vertex commit mode result
    V_SOURCE_SCHEDULED = enum.auto()     # controlled-mode holdback release
    V_SOURCE_CONFIGURED = enum.auto()    # source parallelism resolved
    V_RECONFIGURE_DONE = enum.auto()


class VertexEvent(Event):
    def __init__(self, event_type: VertexEventType, vertex_id: VertexId, **kw: Any):
        super().__init__(event_type)
        self.vertex_id = vertex_id
        self.__dict__.update(kw)


# -- Task --------------------------------------------------------------------
class TaskEventType(enum.Enum):
    T_SCHEDULE = enum.auto()
    T_ATTEMPT_LAUNCHED = enum.auto()
    T_ATTEMPT_SUCCEEDED = enum.auto()
    T_ATTEMPT_FAILED = enum.auto()
    T_ATTEMPT_KILLED = enum.auto()
    T_ADD_SPEC_ATTEMPT = enum.auto()     # speculation: launch extra attempt
    T_TERMINATE = enum.auto()


class TaskEvent(Event):
    def __init__(self, event_type: TaskEventType, task_id: TaskId, **kw: Any):
        super().__init__(event_type)
        self.task_id = task_id
        self.__dict__.update(kw)


# -- TaskAttempt -------------------------------------------------------------
class TaskAttemptEventType(enum.Enum):
    TA_SCHEDULE = enum.auto()
    TA_SUBMITTED = enum.auto()           # container assigned, launch requested
    TA_STARTED_REMOTELY = enum.auto()    # runner picked the task up
    TA_STATUS_UPDATE = enum.auto()
    TA_DONE = enum.auto()
    TA_FAILED = enum.auto()
    TA_TIMED_OUT = enum.auto()
    TA_KILL_REQUEST = enum.auto()
    TA_CONTAINER_TERMINATED = enum.auto()
    TA_OUTPUT_FAILED = enum.auto()       # consumer reported fetch failure
    TA_TEZ_EVENT_UPDATE = enum.auto()


class TaskAttemptEvent(Event):
    def __init__(self, event_type: TaskAttemptEventType,
                 attempt_id: TaskAttemptId, **kw: Any):
        super().__init__(event_type)
        self.attempt_id = attempt_id
        self.__dict__.update(kw)


# -- Scheduler / launcher ----------------------------------------------------
class SchedulerEventType(enum.Enum):
    S_TA_LAUNCH_REQUEST = enum.auto()
    S_TA_ENDED = enum.auto()
    S_CONTAINER_ALLOCATED = enum.auto()
    S_CONTAINER_COMPLETED = enum.auto()
    S_NODE_BLACKLISTED = enum.auto()


class SchedulerEvent(Event):
    def __init__(self, event_type: SchedulerEventType, **kw: Any):
        super().__init__(event_type)
        self.__dict__.update(kw)


class LauncherEventType(enum.Enum):
    LAUNCH_REQUEST = enum.auto()
    STOP_REQUEST = enum.auto()


class LauncherEvent(Event):
    def __init__(self, event_type: LauncherEventType,
                 container_id: ContainerId, **kw: Any):
        super().__init__(event_type)
        self.container_id = container_id
        self.__dict__.update(kw)


# -- Speculator --------------------------------------------------------------
class SpeculatorEventType(enum.Enum):
    S_ATTEMPT_STATUS_UPDATE = enum.auto()
    S_TASK_SUCCEEDED = enum.auto()


class SpeculatorEvent(Event):
    def __init__(self, event_type: SpeculatorEventType, **kw: Any):
        super().__init__(event_type)
        self.__dict__.update(kw)
