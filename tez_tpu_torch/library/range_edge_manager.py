"""Edge manager routing a RANGE of source partitions to each consumer task.

Reference parity: the ShuffleVertexManager auto-parallelism edge
reconfiguration (ShuffleEdgeManagerConfigPayloadProto, ShufflePayloads.proto:60
+ ScatterGatherEdgeManager's custom-routing counterpart): after the consumer
vertex shrinks from P tasks to n, new task i reads source partitions
[i*base, min((i+1)*base, P)).

Payload: {"num_source_partitions": P, "base_range": ceil(P/n)}.

The port's copy of tez_tpu.library.range_edge_manager.
"""
from __future__ import annotations

from typing import Optional

from tez_tpu_torch.api.edge_manager import (CompositeEventRouteMetadata,
                                            EdgeManagerPluginOnDemand,
                                            EventRouteMetadata)


class RangeScatterGatherEdgeManager(EdgeManagerPluginOnDemand):
    def initialize(self) -> None:
        payload = self.context.user_payload.load() or {}
        self.num_source_partitions = payload["num_source_partitions"]
        self.base_range = payload["base_range"]

    def _range(self, dest_task: int) -> tuple:
        lo = dest_task * self.base_range
        hi = min(lo + self.base_range, self.num_source_partitions)
        return lo, hi

    def get_num_destination_task_physical_inputs(self, dest_task: int) -> int:
        lo, hi = self._range(dest_task)
        return self.context.source_vertex_num_tasks * (hi - lo)

    def get_num_source_task_physical_outputs(self, src_task: int) -> int:
        return self.num_source_partitions

    def get_num_destination_consumer_tasks(self, src_task: int) -> int:
        return self.context.destination_vertex_num_tasks

    def route_data_movement_event_to_destination(
            self, src_task: int, src_output_index: int, dest_task: int
    ) -> Optional[EventRouteMetadata]:
        lo, hi = self._range(dest_task)
        if not (lo <= src_output_index < hi):
            return None
        # slot layout: src-major, partition-minor
        slot = src_task * (hi - lo) + (src_output_index - lo)
        return EventRouteMetadata(1, (slot,), (src_output_index,))

    def route_composite_data_movement_event_to_destination(
            self, src_task: int, dest_task: int
    ) -> Optional[CompositeEventRouteMetadata]:
        lo, hi = self._range(dest_task)
        if hi <= lo:
            return None
        return CompositeEventRouteMetadata(
            count=hi - lo, target=src_task * (hi - lo), source=lo)

    def route_input_source_task_failed_event_to_destination(
            self, src_task: int, dest_task: int) -> Optional[EventRouteMetadata]:
        lo, hi = self._range(dest_task)
        if hi <= lo:
            return None
        slots = tuple(src_task * (hi - lo) + i for i in range(hi - lo))
        return EventRouteMetadata(len(slots), slots)

    def route_input_error_event_to_source(self, dest_task: int,
                                          dest_failed_input_index: int) -> int:
        lo, hi = self._range(dest_task)
        width = max(1, hi - lo)
        return dest_failed_input_index // width
