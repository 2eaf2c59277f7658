"""Edge semantics: declarative data-movement types.

Reference parity: tez-api/.../dag/api/EdgeProperty.java:35 —
DataMovementType (:44-66), DataSourceType (:71), SchedulingType (:96),
ConcurrentEdgeTriggerType (:114).

TPU mapping (SURVEY.md §2.9): SCATTER_GATHER -> XLA all-to-all over ICI
intra-slice (DCN object fetch inter-slice); BROADCAST -> all-gather /
replicated buffer; ONE_TO_ONE -> pointwise sharding with affinity;
CUSTOM -> EdgeManagerPlugin routing (cartesian product, fair shuffle).

The port's copy of tez_tpu.dag.edge_property.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from tez_tpu_torch.common.payload import (EdgeManagerPluginDescriptor,
                                          InputDescriptor, OutputDescriptor)


class DataMovementType(enum.Enum):
    ONE_TO_ONE = "one_to_one"          # src task i -> dst task i
    BROADCAST = "broadcast"            # every src output -> all dst tasks
    SCATTER_GATHER = "scatter_gather"  # src partitions shard across dst tasks
    CUSTOM = "custom"                  # EdgeManagerPlugin decides


class DataSourceType(enum.Enum):
    PERSISTED = "persisted"            # survives task exit (host-RAM/SSD copy on TPU)
    PERSISTED_RELIABLE = "persisted_reliable"  # survives host loss (object store)
    EPHEMERAL = "ephemeral"            # HBM only; consumer must run concurrently


class SchedulingType(enum.Enum):
    SEQUENTIAL = "sequential"          # dst may start after src starts producing
    CONCURRENT = "concurrent"          # gang-schedule src+dst together


class ConcurrentEdgeTriggerType(enum.Enum):
    SOURCE_VERTEX_CONFIGURED = "source_vertex_configured"
    SOURCE_TASK_STARTED = "source_task_started"


@dataclasses.dataclass(frozen=True)
class EdgeProperty:
    data_movement_type: DataMovementType
    data_source_type: DataSourceType
    scheduling_type: SchedulingType
    edge_source: OutputDescriptor
    edge_destination: InputDescriptor
    edge_manager_descriptor: Optional[EdgeManagerPluginDescriptor] = None
    concurrent_trigger: ConcurrentEdgeTriggerType = (
        ConcurrentEdgeTriggerType.SOURCE_VERTEX_CONFIGURED)

    @staticmethod
    def create(data_movement_type: DataMovementType,
               data_source_type: DataSourceType,
               scheduling_type: SchedulingType,
               edge_source: OutputDescriptor,
               edge_destination: InputDescriptor) -> "EdgeProperty":
        assert data_movement_type is not DataMovementType.CUSTOM, \
            "use create_custom for CUSTOM edges"
        return EdgeProperty(data_movement_type, data_source_type,
                            scheduling_type, edge_source, edge_destination)

    @staticmethod
    def create_custom(edge_manager: EdgeManagerPluginDescriptor,
                      data_source_type: DataSourceType,
                      edge_source: OutputDescriptor,
                      edge_destination: InputDescriptor,
                      scheduling_type: SchedulingType = SchedulingType.SEQUENTIAL
                      ) -> "EdgeProperty":
        return EdgeProperty(DataMovementType.CUSTOM, data_source_type,
                            scheduling_type, edge_source, edge_destination,
                            edge_manager_descriptor=edge_manager)
