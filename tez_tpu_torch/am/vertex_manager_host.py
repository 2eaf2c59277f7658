"""Hosts a user VertexManagerPlugin inside the AM with error containment.

Reference parity: tez-dag/.../dag/impl/VertexManager.java:93 (serialized
event queue + user-code error funnel) and VertexImpl's default-manager
selection: custom descriptor > ShuffleVertexManager for scatter-gather
inputs > InputReadyVertexManager for one-to-one > RootInputVertexManager for
root inputs > ImmediateStartVertexManager.

The port's copy of tez_tpu.am.vertex_manager_host.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, TYPE_CHECKING

from tez_tpu_torch.api.events import (InputDataInformationEvent,
                                      VertexManagerEvent)
from tez_tpu_torch.api.vertex_manager import (ScheduleTaskRequest,
                                              TaskAttemptIdentifier,
                                              VertexManagerPluginContext,
                                              VertexLocationHint,
                                              VertexStateUpdate)
from tez_tpu_torch.am.events import VertexEvent, VertexEventType
from tez_tpu_torch.common.ids import TaskAttemptId
from tez_tpu_torch.common.payload import (UserPayload,
                                          VertexManagerPluginDescriptor)
from tez_tpu_torch.dag.edge_property import DataMovementType, EdgeProperty

if TYPE_CHECKING:
    from tez_tpu_torch.am.vertex_impl import VertexImpl

log = logging.getLogger(__name__)


def pick_default_manager(vertex: "VertexImpl") -> VertexManagerPluginDescriptor:
    in_types = {e.edge_property.data_movement_type
                for e in vertex.in_edges.values()}
    if DataMovementType.SCATTER_GATHER in in_types or \
            DataMovementType.CUSTOM in in_types:
        return VertexManagerPluginDescriptor.create(
            "tez_tpu_torch.library.vertex_managers:ShuffleVertexManager")
    if DataMovementType.ONE_TO_ONE in in_types:
        return VertexManagerPluginDescriptor.create(
            "tez_tpu_torch.library.vertex_managers:InputReadyVertexManager")
    if vertex.plan.root_inputs:
        return VertexManagerPluginDescriptor.create(
            "tez_tpu_torch.library.vertex_managers:RootInputVertexManager")
    return VertexManagerPluginDescriptor.create(
        "tez_tpu_torch.library.vertex_managers:ImmediateStartVertexManager")


class _VMContext(VertexManagerPluginContext):
    def __init__(self, host: "VertexManagerHost"):
        self.host = host
        self.vertex = host.vertex
        self._reconfig_planned = False

    @property
    def vertex_name(self) -> str:
        return self.vertex.name

    @property
    def user_payload(self) -> UserPayload:
        return self.host.descriptor.payload

    def get_vertex_num_tasks(self, vertex_name: str) -> int:
        if vertex_name == self.vertex.name:
            return self.vertex.num_tasks
        v = self.vertex.dag.vertex_by_name(vertex_name)
        return v.num_tasks if v is not None else -1

    def get_vertex_conf(self) -> Any:
        """Effective vertex configuration (DAG conf merged with the plan
        conf) — payload-less default managers read runtime knobs here
        (e.g. push-shuffle ingest mode)."""
        return self.vertex.conf

    def get_input_vertex_edge_properties(self) -> Dict[str, EdgeProperty]:
        return {name: e.edge_property
                for name, e in self.vertex.in_edges.items()}

    def get_output_vertex_edge_properties(self) -> Dict[str, EdgeProperty]:
        return {name: e.edge_property
                for name, e in self.vertex.out_edges.items()}

    def get_input_vertex_groups(self) -> Dict[str, Sequence[str]]:
        return {g.group_name: g.group_vertices
                for g in self.vertex.group_input_specs}

    def schedule_tasks(self, requests: Sequence[ScheduleTaskRequest]) -> None:
        self.vertex.schedule_tasks([r.task_index for r in requests])

    def reconfigure_vertex(self, parallelism: int,
                           location_hint: Optional[VertexLocationHint] = None,
                           source_edge_properties: Optional[
                               Dict[str, EdgeProperty]] = None,
                           root_input_specs: Optional[Dict[str, Any]] = None
                           ) -> None:
        v = self.vertex
        if parallelism >= 0 and parallelism != v.num_tasks:
            v._recreate_tasks(parallelism)
        edge_journal = {}
        if source_edge_properties:
            from tez_tpu_torch.am.recovery import _payload_to_wire
            for src_name, prop in source_edge_properties.items():
                edge = v.in_edges.get(src_name)
                if edge is None:
                    continue
                edge.edge_property = prop
                if prop.edge_manager_descriptor is not None:
                    edge.set_edge_manager(prop.edge_manager_descriptor)
                    desc = prop.edge_manager_descriptor
                    edge_journal[src_name] = {
                        "class_name": desc.class_name,
                        "payload": _payload_to_wire(desc.payload.load()),
                    }
        # journaled via VERTEX_CONFIGURE_DONE so a recovering AM can RESTORE
        # this decision instead of re-running the vertex from scratch
        # (reference: VertexConfigurationDoneEvent in RecoveryParser.java:658)
        v._reconfig_journal = {"parallelism": v.num_tasks,
                               "edges": edge_journal}

    def vertex_reconfiguration_planned(self) -> None:
        self._reconfig_planned = True

    def vertex_reconfiguration_restored(self) -> bool:
        # only a recovering AM restores a journaled decision; the port's AM
        # does not recover (attempt > 1 raises)
        return False

    def done_reconfiguring_vertex(self) -> None:
        self._reconfig_planned = False
        self.vertex.ctx.history_vertex_configured(self.vertex)

    def send_event_to_processor(self, events: Sequence[Any],
                                task_indices: Sequence[int]) -> None:
        self.vertex.dag.send_custom_events_to_tasks(
            self.vertex, events, task_indices)

    def add_root_input_events(
            self, input_name: str,
            events: Sequence[InputDataInformationEvent]) -> None:
        self.vertex.root_input_events.setdefault(input_name, []).extend(events)

    def get_total_available_resource(self) -> int:
        return self.vertex.ctx.total_slots()

    def register_for_vertex_state_updates(self, vertex_name: str,
                                          states: Sequence[str]) -> None:
        self.vertex.dag.register_state_updates(
            vertex_name, self.host, states)


class VertexManagerHost:
    """Wraps the plugin; catches user-code errors into V_MANAGER_USER_CODE_ERROR."""

    def __init__(self, vertex: "VertexImpl",
                 descriptor: VertexManagerPluginDescriptor):
        self.vertex = vertex
        self.descriptor = descriptor
        self.context = _VMContext(self)
        self.plugin = descriptor.instantiate(self.context)

    def _guard(self, fn, *args: Any) -> None:
        try:
            fn(*args)
        except BaseException as e:  # noqa: BLE001 — user code containment
            log.exception("vertex manager error in %s", self.vertex.name)
            self.vertex.ctx.dispatch(VertexEvent(
                VertexEventType.V_MANAGER_USER_CODE_ERROR,
                self.vertex.vertex_id, diagnostics=repr(e)))

    def initialize(self) -> None:
        self._guard(self.plugin.initialize)

    def on_vertex_started(self, completions: Sequence[TaskAttemptId]) -> None:
        self._guard(self.plugin.on_vertex_started,
                    [self._ident(a) for a in completions])

    def on_source_task_completed(self, attempt_id: TaskAttemptId) -> None:
        self._guard(self.plugin.on_source_task_completed,
                    self._ident(attempt_id))

    def on_vertex_manager_event(self, event: VertexManagerEvent) -> None:
        self._guard(self.plugin.on_vertex_manager_event_received, event)

    def on_root_vertex_initialized(self, input_name: str, descriptor: Any,
                                   events: List[Any]) -> None:
        self._guard(self.plugin.on_root_vertex_initialized,
                    input_name, descriptor, events)

    def on_vertex_state_updated(self, update: VertexStateUpdate) -> None:
        self._guard(self.plugin.on_vertex_state_updated, update)

    def _ident(self, attempt_id: TaskAttemptId) -> TaskAttemptIdentifier:
        v = self.vertex.dag.vertex_by_id(attempt_id.vertex_id)
        return TaskAttemptIdentifier(
            vertex_name=v.name if v else "",
            task_index=attempt_id.task_id.id,
            attempt_number=attempt_id.id)
