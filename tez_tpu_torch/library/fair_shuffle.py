"""Fair shuffle: skew-splitting vertex + edge managers.

Reference parity: tez-runtime-library FairShuffleVertexManager.java (637 LoC)
+ FairShuffleEdgeManager + FairShufflePayloads.proto — oversized partitions
are SPLIT across several consumer tasks by source-task range, small
partitions are merged; each destination task covers
(partition, [src_lo, src_hi)).

This is the "one logical shuffle bigger than one task" machinery
(SURVEY.md §5.7) — the context-parallel splitting analog.

The port's copy of tez_tpu.library.fair_shuffle, over the port's
ShuffleVertexManager: the slicing is tez_tpu's for the same totals.
"""
from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

from tez_tpu_torch.api.edge_manager import (CompositeEventRouteMetadata,
                                            EdgeManagerPluginOnDemand,
                                            EventRouteMetadata)
from tez_tpu_torch.api.events import VertexManagerEvent
from tez_tpu_torch.common.payload import EdgeManagerPluginDescriptor
from tez_tpu_torch.dag.edge_property import DataMovementType, EdgeProperty
from tez_tpu_torch.library.vertex_managers import ShuffleVertexManager

log = logging.getLogger(__name__)

#: mapping entry: (partition, src_lo, src_hi)
DestMapping = Tuple[int, int, int]


class FairShuffleEdgeManager(EdgeManagerPluginOnDemand):
    """Routes (partition, source-range) slices to destination tasks.
    Payload: {"mappings": [(partition, src_lo, src_hi), ...]} indexed by
    destination task."""

    def initialize(self) -> None:
        payload = self.context.user_payload.load() or {}
        self.mappings: List[DestMapping] = [tuple(m) for m in
                                            payload["mappings"]]
        self.num_source_partitions = payload["num_source_partitions"]

    def _mapping(self, dest_task: int) -> DestMapping:
        return self.mappings[dest_task]

    def get_num_destination_task_physical_inputs(self, dest_task: int) -> int:
        _, lo, hi = self._mapping(dest_task)
        return hi - lo

    def get_num_source_task_physical_outputs(self, src_task: int) -> int:
        return self.num_source_partitions

    def get_num_destination_consumer_tasks(self, src_task: int) -> int:
        return sum(1 for (_, lo, hi) in self.mappings if lo <= src_task < hi)

    def route_data_movement_event_to_destination(
            self, src_task: int, src_output_index: int, dest_task: int
    ) -> Optional[EventRouteMetadata]:
        part, lo, hi = self._mapping(dest_task)
        if src_output_index != part or not (lo <= src_task < hi):
            return None
        return EventRouteMetadata(1, (src_task - lo,), (src_output_index,))

    def route_composite_data_movement_event_to_destination(
            self, src_task: int, dest_task: int
    ) -> Optional[CompositeEventRouteMetadata]:
        part, lo, hi = self._mapping(dest_task)
        if not (lo <= src_task < hi):
            return None
        return CompositeEventRouteMetadata(1, src_task - lo, part)

    def route_input_source_task_failed_event_to_destination(
            self, src_task: int, dest_task: int) -> Optional[EventRouteMetadata]:
        part, lo, hi = self._mapping(dest_task)
        if not (lo <= src_task < hi):
            return None
        return EventRouteMetadata(1, (src_task - lo,))

    def route_input_error_event_to_source(self, dest_task: int,
                                          dest_failed_input_index: int) -> int:
        _, lo, _ = self._mapping(dest_task)
        return lo + dest_failed_input_index


#: abstract slice: (partition, piece index, total pieces of that partition)
FairSlice = Tuple[int, int, int]


def compute_fair_slices(partition_totals: Sequence[float],
                        desired_task_input_size: int, max_tasks: int,
                        max_split: int) -> List[FairSlice]:
    """Split oversized partitions into abstract pieces, keep small ones whole
    (reference: FairShuffleVertexManager routing computation).  Pieces are
    edge-independent — each edge later maps piece i/n onto its OWN source
    range, which is how several scatter-gather sources share one slicing.
    When a task cap is set, the per-task size target is grown until the
    slice count fits — slices are COARSENED, never dropped (every
    (partition, source) pair must keep exactly one destination)."""
    size = max(1, desired_task_input_size)
    while True:
        slices: List[FairSlice] = []
        for p, total in enumerate(partition_totals):
            pieces = max(1, int(math.ceil(total / size)))
            pieces = min(pieces, max(1, max_split))
            for i in range(pieces):
                slices.append((p, i, pieces))
        if max_tasks <= 0 or len(slices) <= max_tasks or \
                len(slices) <= len(partition_totals):
            return slices
        size *= 2
        log.info("fair shuffle: %d slices over cap %d, growing target to %d",
                 len(slices), max_tasks, size)


def source_range(piece: int, pieces: int, num_sources: int) -> Tuple[int, int]:
    """Piece i of n over this edge's source tasks.  Ranges tile
    [0, num_sources) exactly; an edge with fewer sources than pieces yields
    empty ranges for some pieces (that slice just reads nothing here)."""
    return (piece * num_sources // pieces,
            (piece + 1) * num_sources // pieces)


def compute_fair_mappings(partition_totals: Sequence[int], num_sources: int,
                          desired_task_input_size: int,
                          max_tasks: int) -> List[DestMapping]:
    """Single-edge convenience: slices resolved to concrete source ranges."""
    slices = compute_fair_slices(partition_totals, desired_task_input_size,
                                 max_tasks, num_sources)
    return [(p, *source_range(i, pieces, num_sources))
            for p, i, pieces in slices]


class FairShuffleVertexManager(ShuffleVertexManager):
    """ShuffleVertexManager whose parallelism decision both merges small
    partitions AND splits skewed ones by source range."""

    def initialize(self) -> None:
        super().initialize()
        payload = self.context.user_payload.load() or {}
        if not isinstance(payload, dict):
            payload = {}
        self.max_task_parallelism = payload.get("max_task_parallelism", 0)
        # the whole point of this manager is runtime routing — it always
        # decides parallelism itself, auto_parallel flag or not
        self._parallelism_determined = False
        # keyed by (producer vertex, task): dedupes pipelined spills and
        # speculative duplicate attempts (last vector wins)
        self._partition_stats: Dict[Tuple[str, int], Sequence[int]] = {}

    def _sg_source_names(self) -> List[str]:
        return [name for name, p in
                self.context.get_input_vertex_edge_properties().items()
                if p.data_movement_type is DataMovementType.SCATTER_GATHER]

    def on_vertex_manager_event_received(self, event: VertexManagerEvent) -> None:
        payload = event.user_payload
        att = event.producer_attempt
        if isinstance(payload, dict) and "partition_sizes" in payload and \
                att is not None:
            vec = payload["partition_sizes"]
            declared = self.context.get_vertex_num_tasks(
                self.context.vertex_name)
            # only scatter-gather stats match the partition space; e.g. a
            # broadcast side-input reports a 1-element vector — ignore it
            if len(vec) == declared:
                vname = event.producer_vertex_name or \
                    str(getattr(att, "vertex_id", att))
                key = (vname,
                       att.task_id.id if hasattr(att, "task_id") else 0)
                self._partition_stats[key] = vec
        super().on_vertex_manager_event_received(event)

    def _try_determine_parallelism(self) -> bool:
        if self._parallelism_determined:
            return True
        if self.context.vertex_reconfiguration_restored():
            # recovery already re-applied the journaled slicing; a fresh
            # decision could slice differently and orphan restored tasks
            self._parallelism_determined = True
            return True
        sg_sources = self._sg_source_names()
        if not sg_sources:
            self._parallelism_determined = True
            return True
        num_by_src = {s: self.context.get_vertex_num_tasks(s)
                      for s in sg_sources}
        if any(n <= 0 for n in num_by_src.values()):
            return False
        total_sources = sum(num_by_src.values())
        fraction = self._completed_fraction(sg_sources, total_sources)
        if not self._partition_stats:
            if fraction >= 1.0:
                self._parallelism_determined = True
                return True
            return False
        if fraction < self.min_fraction:
            return False
        # Project observed per-partition sizes to full scale, per source
        # vertex where attributable (stats missing a vertex name fall back to
        # a global projection).  An SG source with NO reports yet still
        # contributes: it's projected at the observed per-task average —
        # counting it as zero would hide its skew permanently.
        grouped: Dict[str, List[Sequence[int]]] = {}
        for (vname, _task), vec in self._partition_stats.items():
            grouped.setdefault(vname, []).append(vec)
        num_partitions = len(next(iter(self._partition_stats.values())))
        totals = [0.0] * num_partitions
        reported = len(self._partition_stats)
        avg = [0.0] * num_partitions
        for vec in self._partition_stats.values():
            for p, sz in enumerate(vec):
                avg[p] += sz / reported
        if all(v in num_by_src for v in grouped):
            for vname, vecs in grouped.items():
                scale = num_by_src[vname] / len(vecs)
                for vec in vecs:
                    for p, sz in enumerate(vec):
                        totals[p] += sz * scale
            for vname, n in num_by_src.items():
                if vname not in grouped:
                    for p in range(num_partitions):
                        totals[p] += avg[p] * n
        else:
            for p in range(num_partitions):
                totals[p] = avg[p] * total_sources

        # One edge-independent slicing; each edge resolves pieces onto its
        # own source range (reference: per-edge FairShufflePayloads ranges).
        slices = compute_fair_slices(
            totals, self.desired_task_input_size, self.max_task_parallelism,
            max_split=max(num_by_src.values()))
        current = self.context.get_vertex_num_tasks(self.context.vertex_name)
        if slices and len(slices) != current:
            props = self.context.get_input_vertex_edge_properties()
            new_props = {}
            for name in sg_sources:
                prop = props[name]
                mappings = [(p, *source_range(i, pieces, num_by_src[name]))
                            for p, i, pieces in slices]
                desc = EdgeManagerPluginDescriptor.create(
                    "tez_tpu_torch.library.fair_shuffle:FairShuffleEdgeManager",
                    payload={"mappings": mappings,
                             "num_source_partitions": current})
                new_props[name] = EdgeProperty.create_custom(
                    desc, prop.data_source_type, prop.edge_source,
                    prop.edge_destination, prop.scheduling_type)
            log.info("%s: fair shuffle %d partitions -> %d slices over %d "
                     "source edges", self.context.vertex_name, num_partitions,
                     len(slices), len(sg_sources))
            self.context.reconfigure_vertex(len(slices),
                                            source_edge_properties=new_props)
            self.context.done_reconfiguring_vertex()
        self._parallelism_determined = True
        return True
