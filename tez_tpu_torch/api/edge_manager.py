"""EdgeManagerPlugin SPI — custom routing of events/partitions per edge.

Reference parity: tez-api/.../dag/api/EdgeManagerPlugin.java:36 and
EdgeManagerPluginOnDemand.java:41.  The on-demand (pull) variant is the
primary SPI here — SURVEY.md §7 ("adopt on-demand event routing from the
start, not broadcast routing") — the legacy push variant is layered on top.

The port's copy of tez_tpu.api.edge_manager.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from tez_tpu_torch.common.payload import UserPayload


class EdgeManagerPluginContext(abc.ABC):
    @property
    @abc.abstractmethod
    def source_vertex_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def destination_vertex_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def source_vertex_num_tasks(self) -> int: ...

    @property
    @abc.abstractmethod
    def destination_vertex_num_tasks(self) -> int: ...

    @property
    @abc.abstractmethod
    def user_payload(self) -> UserPayload: ...


@dataclasses.dataclass(frozen=True)
class EventRouteMetadata:
    """Where a source event lands at one destination task.

    Reference: EdgeManagerPluginOnDemand.EventRouteMetadata — num_events
    copies delivered at the given target indices; target_index_to_send is the
    source-output index the consumer should fetch.
    """
    num_events: int
    target_indices: Sequence[int]
    target_index_to_send: Sequence[int] = ()


class EdgeManagerPluginOnDemand(abc.ABC):
    """Pull-based routing: the AM asks, per (source task, dest task) pair,
    how events route — avoiding O(src*dst) event materialization."""

    def __init__(self, context: EdgeManagerPluginContext):
        self.context = context

    @abc.abstractmethod
    def initialize(self) -> None: ...

    def prepare_for_routing(self) -> None:
        pass

    # -- sizing -------------------------------------------------------------
    @abc.abstractmethod
    def get_num_destination_task_physical_inputs(self, dest_task: int) -> int: ...

    @abc.abstractmethod
    def get_num_source_task_physical_outputs(self, src_task: int) -> int: ...

    @abc.abstractmethod
    def get_num_destination_consumer_tasks(self, src_task: int) -> int:
        """How many consumers read src_task's output (failure accounting)."""

    # -- routing ------------------------------------------------------------
    @abc.abstractmethod
    def route_data_movement_event_to_destination(
            self, src_task: int, src_output_index: int,
            dest_task: int) -> Optional[EventRouteMetadata]: ...

    @abc.abstractmethod
    def route_composite_data_movement_event_to_destination(
            self, src_task: int, dest_task: int
    ) -> Optional["CompositeEventRouteMetadata"]: ...

    @abc.abstractmethod
    def route_input_source_task_failed_event_to_destination(
            self, src_task: int, dest_task: int) -> Optional[EventRouteMetadata]: ...

    @abc.abstractmethod
    def route_input_error_event_to_source(self, dest_task: int,
                                          dest_failed_input_index: int) -> int:
        """Map a consumer's failed input index back to the producer task."""


@dataclasses.dataclass(frozen=True)
class CompositeEventRouteMetadata:
    count: int
    target: int      # first target input index at the destination
    source: int      # first source partition index


class EdgeManagerPlugin(EdgeManagerPluginOnDemand):
    """Legacy push-style SPI (reference: EdgeManagerPlugin.java:36) expressed
    over the on-demand base: subclasses implement routeDataMovementEvent...
    writing into a target map."""

    @abc.abstractmethod
    def route_data_movement_event_to_destination_map(
            self, event_source_index: int, src_task: int,
            target: Dict[int, List[int]]) -> None:
        """Fill {dest_task: [input indices]} (reference signature)."""

    def route_data_movement_event_to_destination(
            self, src_task: int, src_output_index: int,
            dest_task: int) -> Optional[EventRouteMetadata]:
        target: Dict[int, List[int]] = {}
        self.route_data_movement_event_to_destination_map(
            src_output_index, src_task, target)
        idx = target.get(dest_task)
        if not idx:
            return None
        return EventRouteMetadata(len(idx), idx)
