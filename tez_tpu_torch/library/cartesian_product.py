"""Cartesian-product edges: first-class CUSTOM edge implementation.

Reference parity: tez-runtime-library/.../cartesianproduct/ (13 files:
CartesianProductVertexManager.java:62, CartesianProductEdgeManager,
CartesianProductCombination) — the fair/unpartitioned variant: the consumer
runs one task per combination of source tasks; each source edge routes
source task s to every combination whose coordinate at that source is s.

Config payload (both manager and edge managers):
  {"sources": ["A", "B", ...]}           # order defines the mixed radix
  edge manager additionally gets {"position": k, "num_tasks": [nA, nB, ..]}

The port's copy of tez_tpu.library.cartesian_product: the vertex manager
rewires each in-edge with the port's edge manager.
"""
from __future__ import annotations

import logging
import math
from typing import Any, List, Optional, Sequence

from tez_tpu_torch.api.edge_manager import (CompositeEventRouteMetadata,
                                            EdgeManagerPluginOnDemand,
                                            EventRouteMetadata)
from tez_tpu_torch.api.events import VertexManagerEvent
from tez_tpu_torch.api.vertex_manager import (ScheduleTaskRequest,
                                              TaskAttemptIdentifier,
                                              VertexManagerPlugin)
from tez_tpu_torch.common.payload import EdgeManagerPluginDescriptor
from tez_tpu_torch.dag.edge_property import EdgeProperty

log = logging.getLogger(__name__)


class CartesianProductCombination:
    """Mixed-radix combination math (reference:
    CartesianProductCombination.java)."""

    def __init__(self, num_tasks: Sequence[int]):
        self.num_tasks = list(num_tasks)
        self.strides = [1] * len(num_tasks)
        for i in range(len(num_tasks) - 2, -1, -1):
            self.strides[i] = self.strides[i + 1] * num_tasks[i + 1]

    @property
    def total(self) -> int:
        return self.strides[0] * self.num_tasks[0] if self.num_tasks else 0

    def coordinate(self, dest_task: int, position: int) -> int:
        return (dest_task // self.strides[position]) % self.num_tasks[position]

    def dests_for(self, position: int, src_task: int) -> List[int]:
        return [d for d in range(self.total)
                if self.coordinate(d, position) == src_task]


class CartesianProductEdgeManager(EdgeManagerPluginOnDemand):
    def initialize(self) -> None:
        # The DAG-construction payload may be empty: the vertex manager
        # swaps in a fully-configured manager before any routing happens.
        payload = self.context.user_payload.load() or {}
        self.position = payload.get("position", 0)
        self.combo = CartesianProductCombination(payload.get("num_tasks", [1]))

    def get_num_destination_task_physical_inputs(self, dest_task: int) -> int:
        return 1

    def get_num_source_task_physical_outputs(self, src_task: int) -> int:
        return 1

    def get_num_destination_consumer_tasks(self, src_task: int) -> int:
        return self.combo.total // max(1, self.combo.num_tasks[self.position])

    def route_data_movement_event_to_destination(
            self, src_task: int, src_output_index: int, dest_task: int
    ) -> Optional[EventRouteMetadata]:
        if self.combo.coordinate(dest_task, self.position) != src_task:
            return None
        return EventRouteMetadata(1, (0,), (src_output_index,))

    def route_composite_data_movement_event_to_destination(
            self, src_task: int, dest_task: int
    ) -> Optional[CompositeEventRouteMetadata]:
        if self.combo.coordinate(dest_task, self.position) != src_task:
            return None
        return CompositeEventRouteMetadata(1, 0, 0)

    def route_input_source_task_failed_event_to_destination(
            self, src_task: int, dest_task: int) -> Optional[EventRouteMetadata]:
        if self.combo.coordinate(dest_task, self.position) != src_task:
            return None
        return EventRouteMetadata(1, (0,))

    def route_input_error_event_to_source(self, dest_task: int,
                                          dest_failed_input_index: int) -> int:
        return self.combo.coordinate(dest_task, self.position)


class CartesianProductVertexManager(VertexManagerPlugin):
    """Sets consumer parallelism = product of source task counts, rewires
    each CUSTOM in-edge with a positioned edge manager, and schedules once
    every source has started producing (all-at-once; the reference adds
    slow-start by completed-combination fraction)."""

    def initialize(self) -> None:
        payload = self.context.user_payload.load() or {}
        self.sources: List[str] = payload["sources"]
        self._configured = False
        self._scheduled = False
        self._started = False
        self._completed_srcs: set = set()

    def _try_configure(self) -> None:
        if self._configured:
            return
        counts = [self.context.get_vertex_num_tasks(s) for s in self.sources]
        if any(c < 0 for c in counts):
            return
        total = math.prod(counts)
        props = self.context.get_input_vertex_edge_properties()
        new_props = {}
        for pos, src in enumerate(self.sources):
            prop = props[src]
            desc = EdgeManagerPluginDescriptor.create(
                "tez_tpu_torch.library.cartesian_product:"
                "CartesianProductEdgeManager",
                payload={"position": pos, "num_tasks": counts})
            new_props[src] = EdgeProperty.create_custom(
                desc, prop.data_source_type, prop.edge_source,
                prop.edge_destination, prop.scheduling_type)
        self.context.reconfigure_vertex(total,
                                        source_edge_properties=new_props)
        self.context.done_reconfiguring_vertex()
        self._configured = True
        log.info("cartesian product: %s -> %d combinations",
                 dict(zip(self.sources, counts)), total)

    def on_vertex_started(self, completions) -> None:
        self._started = True
        self._try_configure()
        for c in completions:
            self._completed_srcs.add((c.vertex_name, c.task_index))
        self._maybe_schedule()

    def on_source_task_completed(self, attempt: TaskAttemptIdentifier) -> None:
        self._try_configure()
        self._completed_srcs.add((attempt.vertex_name, attempt.task_index))
        self._maybe_schedule()

    def _maybe_schedule(self) -> None:
        if self._scheduled or not self._configured or not self._started:
            return
        # schedule everything once at least one task per source completed
        # (outputs are EPHEMERAL-safe only when sources persist; stock
        # usage pairs this with PERSISTED unordered outputs)
        have = {v for v, _ in self._completed_srcs}
        if not all(s in have for s in self.sources):
            return
        n = self.context.get_vertex_num_tasks(self.context.vertex_name)
        self._scheduled = True
        self.context.schedule_tasks([ScheduleTaskRequest(i)
                                     for i in range(n)])

    def on_vertex_manager_event_received(self, event: VertexManagerEvent) -> None:
        pass

    def on_root_vertex_initialized(self, input_name: str, descriptor: Any,
                                   events: List[Any]) -> None:
        pass
