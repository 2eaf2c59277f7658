"""VertexManagerPlugin SPI — the AM-side per-vertex brain.

Reference parity: tez-api/.../dag/api/VertexManagerPlugin.java:41 and
VertexManagerPluginContext.java (reconfigureVertex :203/:228/:253,
scheduleTasks, getVertexStatistics...).

The port's copy of tez_tpu.api.vertex_manager.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from tez_tpu_torch.api.events import (InputDataInformationEvent,
                                      VertexManagerEvent)
from tez_tpu_torch.common.payload import UserPayload
from tez_tpu_torch.dag.edge_property import EdgeProperty


@dataclasses.dataclass(frozen=True)
class ScheduleTaskRequest:
    """Reference: VertexManagerPluginContext.ScheduleTaskRequest."""
    task_index: int
    locality_hint: Any = None


@dataclasses.dataclass(frozen=True)
class VertexLocationHint:
    hints: Sequence[Any] = ()


class VertexManagerPluginContext(abc.ABC):
    @property
    @abc.abstractmethod
    def vertex_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def user_payload(self) -> UserPayload: ...

    @abc.abstractmethod
    def get_vertex_num_tasks(self, vertex_name: str) -> int: ...

    @abc.abstractmethod
    def get_input_vertex_edge_properties(self) -> Dict[str, EdgeProperty]: ...

    @abc.abstractmethod
    def get_output_vertex_edge_properties(self) -> Dict[str, EdgeProperty]: ...

    @abc.abstractmethod
    def get_input_vertex_groups(self) -> Dict[str, Sequence[str]]: ...

    @abc.abstractmethod
    def schedule_tasks(self, requests: Sequence[ScheduleTaskRequest]) -> None: ...

    @abc.abstractmethod
    def reconfigure_vertex(self, parallelism: int,
                           location_hint: Optional[VertexLocationHint] = None,
                           source_edge_properties: Optional[
                               Dict[str, EdgeProperty]] = None,
                           root_input_specs: Optional[Dict[str, Any]] = None
                           ) -> None:
        """Change parallelism / edge routing before tasks run
        (reference: VertexManagerPluginContext.java:203)."""

    @abc.abstractmethod
    def vertex_reconfiguration_planned(self) -> None:
        """Tell the framework to defer task creation visibility until
        doneReconfiguringVertex (reference :287)."""

    @abc.abstractmethod
    def done_reconfiguring_vertex(self) -> None: ...

    def vertex_reconfiguration_restored(self) -> bool:
        """True when a recovering AM already re-applied a journaled
        reconfiguration of this vertex — the manager must NOT re-decide
        parallelism (reference: recovered VertexConfigurationDoneEvent)."""
        return False

    def get_vertex_conf(self) -> Dict[str, Any]:
        """The managed vertex's effective configuration (DAG conf merged
        with the vertex plan conf).  Lets payload-less default managers
        honor runtime knobs — e.g. the shuffle manager's push ingest
        mode.  Default: empty (test/standalone contexts)."""
        return {}

    @abc.abstractmethod
    def send_event_to_processor(self, events: Sequence[Any],
                                task_indices: Sequence[int]) -> None: ...

    @abc.abstractmethod
    def add_root_input_events(
            self, input_name: str,
            events: Sequence[InputDataInformationEvent]) -> None: ...

    @abc.abstractmethod
    def get_total_available_resource(self) -> int:
        """Cluster slots available (for wave sizing)."""

    @abc.abstractmethod
    def register_for_vertex_state_updates(self, vertex_name: str,
                                          states: Sequence[str]) -> None: ...


@dataclasses.dataclass(frozen=True)
class TaskAttemptIdentifier:
    """Reference: tez-api TaskAttemptIdentifier."""
    vertex_name: str
    task_index: int
    attempt_number: int


@dataclasses.dataclass(frozen=True)
class VertexStateUpdate:
    vertex_name: str
    state: str      # CONFIGURED | RUNNING | SUCCEEDED | FAILED | KILLED


class VertexManagerPlugin(abc.ABC):
    """Reference: VertexManagerPlugin.java:41."""

    def __init__(self, context: VertexManagerPluginContext):
        self.context = context

    @abc.abstractmethod
    def initialize(self) -> None: ...

    @abc.abstractmethod
    def on_vertex_started(
            self, completions: Sequence[TaskAttemptIdentifier]) -> None: ...

    @abc.abstractmethod
    def on_source_task_completed(
            self, attempt: TaskAttemptIdentifier) -> None: ...

    @abc.abstractmethod
    def on_vertex_manager_event_received(
            self, event: VertexManagerEvent) -> None: ...

    @abc.abstractmethod
    def on_root_vertex_initialized(
            self, input_name: str, input_descriptor: Any,
            events: List[InputDataInformationEvent]) -> None: ...

    def on_vertex_state_updated(self, update: VertexStateUpdate) -> None:
        pass
