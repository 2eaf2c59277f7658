"""AM-side edge: routes producer events to consumer tasks on demand.

Reference parity: tez-dag/.../dag/impl/Edge.java:72 with on-demand (pull)
routing (:151) as the only mode — SURVEY.md §7's event-storm lesson — plus
the stock edge managers ScatterGatherEdgeManager, BroadcastEdgeManager,
OneToOneEdgeManagerOnDemand (tez-dag/.../dag/impl/).

Producers append events (in completion order); each consumer task pulls the
suffix it hasn't seen, and routing metadata is computed per (src,dst) pair at
pull time — O(pulled events), never O(src*dst) materialized up front.

The port's copy of tez_tpu.am.edge.
"""
from __future__ import annotations

import threading
from typing import Any, List, Optional, Tuple

from tez_tpu_torch.api.edge_manager import (CompositeEventRouteMetadata,
                                            EdgeManagerPluginContext,
                                            EdgeManagerPluginOnDemand,
                                            EventRouteMetadata)
from tez_tpu_torch.api.events import (CompositeDataMovementEvent,
                                      CompositeRoutedDataMovementEvent,
                                      DataMovementEvent, InputFailedEvent,
                                      TezAPIEvent)
from tez_tpu_torch.common.payload import UserPayload
from tez_tpu_torch.dag.edge_property import DataMovementType, EdgeProperty


class ScatterGatherEdgeManager(EdgeManagerPluginOnDemand):
    """Source task produces one partition per destination task; destination d
    reads partition d of every source task (reference:
    ScatterGatherEdgeManager.java)."""

    def initialize(self) -> None:
        pass

    def get_num_destination_task_physical_inputs(self, dest_task: int) -> int:
        return self.context.source_vertex_num_tasks

    def get_num_source_task_physical_outputs(self, src_task: int) -> int:
        return self.context.destination_vertex_num_tasks

    def get_num_destination_consumer_tasks(self, src_task: int) -> int:
        return self.context.destination_vertex_num_tasks

    def route_data_movement_event_to_destination(
            self, src_task: int, src_output_index: int, dest_task: int
    ) -> Optional[EventRouteMetadata]:
        if src_output_index != dest_task:
            return None
        return EventRouteMetadata(1, (src_task,), (src_output_index,))

    def route_composite_data_movement_event_to_destination(
            self, src_task: int, dest_task: int
    ) -> Optional[CompositeEventRouteMetadata]:
        # Producer emitted partitions [0, P); partition dest_task lands at
        # input index src_task of the destination.
        return CompositeEventRouteMetadata(1, src_task, dest_task)

    def route_input_source_task_failed_event_to_destination(
            self, src_task: int, dest_task: int) -> Optional[EventRouteMetadata]:
        return EventRouteMetadata(1, (src_task,))

    def route_input_error_event_to_source(self, dest_task: int,
                                          dest_failed_input_index: int) -> int:
        return dest_failed_input_index


class BroadcastEdgeManager(EdgeManagerPluginOnDemand):
    """Every source output goes to all destination tasks (reference:
    BroadcastEdgeManager.java)."""

    def initialize(self) -> None:
        pass

    def get_num_destination_task_physical_inputs(self, dest_task: int) -> int:
        return self.context.source_vertex_num_tasks

    def get_num_source_task_physical_outputs(self, src_task: int) -> int:
        return 1

    def get_num_destination_consumer_tasks(self, src_task: int) -> int:
        return self.context.destination_vertex_num_tasks

    def route_data_movement_event_to_destination(
            self, src_task: int, src_output_index: int, dest_task: int
    ) -> Optional[EventRouteMetadata]:
        return EventRouteMetadata(1, (src_task,), (src_output_index,))

    def route_composite_data_movement_event_to_destination(
            self, src_task: int, dest_task: int
    ) -> Optional[CompositeEventRouteMetadata]:
        return CompositeEventRouteMetadata(1, src_task, 0)

    def route_input_source_task_failed_event_to_destination(
            self, src_task: int, dest_task: int) -> Optional[EventRouteMetadata]:
        return EventRouteMetadata(1, (src_task,))

    def route_input_error_event_to_source(self, dest_task: int,
                                          dest_failed_input_index: int) -> int:
        return dest_failed_input_index


class OneToOneEdgeManager(EdgeManagerPluginOnDemand):
    """Pointwise: src i -> dst i (reference: OneToOneEdgeManagerOnDemand)."""

    def initialize(self) -> None:
        pass

    def get_num_destination_task_physical_inputs(self, dest_task: int) -> int:
        return 1

    def get_num_source_task_physical_outputs(self, src_task: int) -> int:
        return 1

    def get_num_destination_consumer_tasks(self, src_task: int) -> int:
        return 1

    def route_data_movement_event_to_destination(
            self, src_task: int, src_output_index: int, dest_task: int
    ) -> Optional[EventRouteMetadata]:
        if src_task != dest_task:
            return None
        return EventRouteMetadata(1, (0,), (src_output_index,))

    def route_composite_data_movement_event_to_destination(
            self, src_task: int, dest_task: int
    ) -> Optional[CompositeEventRouteMetadata]:
        if src_task != dest_task:
            return None
        return CompositeEventRouteMetadata(1, 0, 0)

    def route_input_source_task_failed_event_to_destination(
            self, src_task: int, dest_task: int) -> Optional[EventRouteMetadata]:
        if src_task != dest_task:
            return None
        return EventRouteMetadata(1, (0,))

    def route_input_error_event_to_source(self, dest_task: int,
                                          dest_failed_input_index: int) -> int:
        return dest_task


class _EdgeManagerContext(EdgeManagerPluginContext):
    def __init__(self, edge: "EdgeImpl", payload: UserPayload):
        self._edge = edge
        self._payload = payload

    @property
    def source_vertex_name(self) -> str:
        return self._edge.source_vertex.name

    @property
    def destination_vertex_name(self) -> str:
        return self._edge.destination_vertex.name

    @property
    def source_vertex_num_tasks(self) -> int:
        return self._edge.source_vertex.num_tasks

    @property
    def destination_vertex_num_tasks(self) -> int:
        return self._edge.destination_vertex.num_tasks

    @property
    def user_payload(self) -> UserPayload:
        return self._payload


class EdgeImpl:
    """One DAG edge at runtime: owns the edge manager and the on-demand event
    log (reference: dag/impl/Edge.java)."""

    def __init__(self, edge_id: str, edge_property: EdgeProperty,
                 source_vertex: Any, destination_vertex: Any):
        self.id = edge_id
        self.edge_property = edge_property
        self.source_vertex = source_vertex
        self.destination_vertex = destination_vertex
        self._lock = threading.Lock()
        # Ordered producer event log: (src_task, attempt_number, event)
        self._events: List[Tuple[int, int, TezAPIEvent]] = []
        self.edge_manager: EdgeManagerPluginOnDemand = None  # type: ignore

    def initialize(self) -> None:
        prop = self.edge_property
        ctx_payload = UserPayload()
        if prop.data_movement_type is DataMovementType.CUSTOM:
            desc = prop.edge_manager_descriptor
            assert desc is not None, f"CUSTOM edge {self.id} without manager"
            ctx_payload = desc.payload
            ctx = _EdgeManagerContext(self, ctx_payload)
            self.edge_manager = desc.instantiate(ctx)
        else:
            cls = {
                DataMovementType.SCATTER_GATHER: ScatterGatherEdgeManager,
                DataMovementType.BROADCAST: BroadcastEdgeManager,
                DataMovementType.ONE_TO_ONE: OneToOneEdgeManager,
            }[prop.data_movement_type]
            self.edge_manager = cls(_EdgeManagerContext(self, ctx_payload))
        self.edge_manager.initialize()

    def set_edge_manager(self, descriptor: Any) -> None:
        """Runtime edge reconfiguration (reference: Edge.setCustomEdgeManager
        used by ShuffleVertexManager auto-parallelism)."""
        ctx = _EdgeManagerContext(self, descriptor.payload)
        self.edge_manager = descriptor.instantiate(ctx)
        self.edge_manager.initialize()

    # -- producer side -------------------------------------------------------
    def add_source_event(self, src_task: int, attempt_number: int,
                         event: TezAPIEvent) -> None:
        with self._lock:
            self._events.append((src_task, attempt_number, event))

    def source_event_count(self) -> int:
        with self._lock:
            return len(self._events)

    # -- consumer side (on-demand pull) --------------------------------------
    def get_events_for_task(self, dest_task: int, from_seq: int,
                            max_events: int = 0
                            ) -> Tuple[List[TezAPIEvent], int]:
        """Route events [from_seq:] for one destination task.  Returns the
        routed events and the new high-water mark.  ``max_events`` > 0
        stops consuming log entries once that many routed events are out
        (tez.task.max-event-backlog); the high-water mark then points at
        the first unconsumed entry so the rest arrive on later pulls."""
        with self._lock:
            snapshot = self._events[from_seq:]
        consumed = 0
        out: List[TezAPIEvent] = []
        em = self.edge_manager
        for src_task, version, ev in snapshot:
            routed: List[TezAPIEvent] = []
            if isinstance(ev, CompositeDataMovementEvent):
                meta = em.route_composite_data_movement_event_to_destination(
                    src_task, dest_task)
                if meta is not None:
                    routed.append(CompositeRoutedDataMovementEvent(
                        source_index=meta.source, target_index_start=meta.target,
                        count=meta.count, user_payload=ev.user_payload,
                        version=version))
            elif isinstance(ev, DataMovementEvent):
                meta = em.route_data_movement_event_to_destination(
                    src_task, ev.source_index, dest_task)
                if meta is not None:
                    for t in meta.target_indices:
                        routed.append(DataMovementEvent(
                            source_index=ev.source_index,
                            user_payload=ev.user_payload,
                            target_index=t, version=version))
            elif isinstance(ev, InputFailedEvent):
                meta = em.route_input_source_task_failed_event_to_destination(
                    src_task, dest_task)
                if meta is not None:
                    for t in meta.target_indices:
                        routed.append(InputFailedEvent(target_index=t,
                                                       version=version))
            else:
                routed.append(ev)
            # strict cap: an entry whose expansion would overshoot is NOT
            # consumed (unless nothing is out yet — progress guarantee for
            # a single entry that expands past the whole cap)
            if max_events and out and len(out) + len(routed) > max_events:
                break
            consumed += 1
            out.extend(routed)
            if max_events and len(out) >= max_events:
                break
        return out, from_seq + consumed

    def route_input_error_to_source(self, dest_task: int,
                                    failed_input_index: int) -> int:
        return self.edge_manager.route_input_error_event_to_source(
            dest_task, failed_input_index)

    def num_dest_physical_inputs(self, dest_task: int) -> int:
        return self.edge_manager.get_num_destination_task_physical_inputs(dest_task)

    def num_source_physical_outputs(self, src_task: int) -> int:
        return self.edge_manager.get_num_source_task_physical_outputs(src_task)
