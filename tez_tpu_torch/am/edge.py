"""AM-side edge routing: the stock scatter-gather edge manager.

The port's copy of ScatterGatherEdgeManager from tez_tpu.am.edge
(reference: ScatterGatherEdgeManager.java).  EdgeImpl, which owns an
edge's event log and asks this manager how each event routes, comes with
the AM.
"""
from __future__ import annotations

from typing import Optional

from tez_tpu_torch.api.edge_manager import (CompositeEventRouteMetadata,
                                            EdgeManagerPluginOnDemand,
                                            EventRouteMetadata)


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
