"""Typed events routed AM<->task and task->task (logically).

Reference parity: tez-api/.../runtime/api/events/ (12 classes) and
Events.proto:23-79.  The DataMovementEvent payload carries the shuffle
manifest info (ShufflePayloads.proto DataMovementEventPayloadProto):
host/port identify the producer's runner, path_component names the output,
empty_partitions is a bitmap eliding zero-size partitions client-side
(SURVEY.md §5.8).

The port's copy of tez_tpu.api.events.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


class TezAPIEvent:
    """Base for user-visible events (distinct from dispatcher control events)."""


@dataclasses.dataclass
class DataMovementEvent(TezAPIEvent):
    """Producer output ready for one target partition/index.

    Reference: DataMovementEvent.java; source_index = producer's output
    partition number, target_index = consumer input index (filled by the
    AM-side edge manager during routing)."""
    source_index: int
    user_payload: Any = None
    target_index: int = -1
    version: int = 0    # producer attempt number

    def with_target(self, target_index: int) -> "DataMovementEvent":
        return dataclasses.replace(self, target_index=target_index)


@dataclasses.dataclass
class CompositeDataMovementEvent(TezAPIEvent):
    """One event covering a contiguous range of source partitions
    (reference: CompositeDataMovementEvent.java — avoids P events per task)."""
    source_index_start: int
    count: int
    user_payload: Any = None
    version: int = 0

    def expand(self) -> Tuple[DataMovementEvent, ...]:
        return tuple(
            DataMovementEvent(self.source_index_start + i, self.user_payload,
                              version=self.version)
            for i in range(self.count))


@dataclasses.dataclass
class CompositeRoutedDataMovementEvent(TezAPIEvent):
    """Routed composite delivered to a consumer that reads a partition range
    (reference: CompositeRoutedDataMovementEvent.java, on-demand routing)."""
    source_index: int
    target_index_start: int
    count: int
    user_payload: Any = None
    version: int = 0


@dataclasses.dataclass
class InputReadErrorEvent(TezAPIEvent):
    """Consumer failed to fetch a producer output; AM fails the *producer*
    attempt (reference: InputReadErrorEvent.java, Events.proto:38)."""
    diagnostics: str
    index: int            # consumer input index that failed
    version: int          # producer attempt number
    num_failures: int = 1
    is_local_fetch: bool = False
    is_disk_error_at_source: bool = False


@dataclasses.dataclass
class InputFailedEvent(TezAPIEvent):
    """AM -> consumer: a previously announced input is gone (producer being
    re-run); consumer must discard/re-wait (reference: InputFailedEvent.java)."""
    target_index: int
    version: int


@dataclasses.dataclass
class VertexManagerEvent(TezAPIEvent):
    """Task -> its vertex's VertexManagerPlugin (stats for auto-parallelism;
    reference: VertexManagerEvent.java + VertexManagerEventPayloadProto)."""
    target_vertex_name: str
    user_payload: Any
    producer_attempt: Any = None
    producer_vertex_name: str = ""   # filled by the AM during routing


@dataclasses.dataclass
class InputDataInformationEvent(TezAPIEvent):
    """InputInitializer -> root input tasks: one split description each
    (reference: InputDataInformationEvent.java)."""
    source_index: int
    user_payload: Any = None
    target_index: int = -1
    serialized_path: str = ""


@dataclasses.dataclass
class InputInitializerEvent(TezAPIEvent):
    """Running task -> an InputInitializer of another vertex
    (reference: InputInitializerEvent.java)."""
    target_vertex_name: str
    target_input_name: str
    user_payload: Any = None


@dataclasses.dataclass
class CustomProcessorEvent(TezAPIEvent):
    """Processor -> processor free-form event (reference:
    CustomProcessorEvent.java)."""
    user_payload: Any
    version: int = 0


@dataclasses.dataclass
class ErrorEvent(TezAPIEvent):
    """Fatal error reported by a task component."""
    diagnostics: str


@dataclasses.dataclass(frozen=True)
class EventMetaData:
    """Source/destination envelope for a routed event.

    Reference: tez-runtime-internals/.../runtime/api/impl/EventMetaData.java
    (producer_consumer_type, taskVertexName, edgeVertexName, taskAttemptID)."""
    producer_consumer_type: str   # "INPUT"|"PROCESSOR"|"OUTPUT"|"SYSTEM"
    task_vertex_name: str
    edge_vertex_name: str = ""
    task_attempt_id: Any = None


@dataclasses.dataclass
class TezEvent:
    """Wire envelope: user event + routing metadata (reference:
    runtime/api/impl/TezEvent.java:63)."""
    event: TezAPIEvent
    source_info: Optional[EventMetaData] = None
    destination_info: Optional[EventMetaData] = None
    event_received_time: float = 0.0


# ---------------------------------------------------------------------------
# DME payload: the shuffle manifest shipped inside DataMovementEvents.
# Reference: ShufflePayloads.proto DataMovementEventPayloadProto:23 —
# host, port, path_component, run_duration, empty_partitions bitmap,
# + pipelined-shuffle spill bookkeeping (spill_id, last_event).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShufflePayload:
    host: str
    port: int
    path_component: str          # producer attempt's output id
    empty_partitions: Optional[bytes] = None  # packed bitset; None = none empty
    spill_id: int = -1           # >=0 when pipelined shuffle emits per-spill
    last_event: bool = True
    run_duration: int = 0

    def is_empty(self, partition: int) -> bool:
        bm = self.empty_partitions
        if bm is None:
            return False
        byte_i, bit_i = divmod(partition, 8)
        if byte_i >= len(bm):
            return False
        return bool(bm[byte_i] & (1 << bit_i))


def pack_empty_partitions(flags) -> Optional[bytes]:
    """Pack per-partition emptiness into a bitset; None if nothing empty."""
    if not any(flags):
        return None
    out = bytearray((len(flags) + 7) // 8)
    for i, f in enumerate(flags):
        if f:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)
