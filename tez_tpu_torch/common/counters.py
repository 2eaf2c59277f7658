"""Task counters: the port's own copy of tez_tpu.common.counters.

Only the registry surface the data plane uses (TaskCounter, TezCounters);
enum members and their order match tez_tpu so dumps line up name for name.
"""
from __future__ import annotations

import enum
import threading
from typing import Dict, Iterator


class TaskCounter(enum.Enum):
    """Reference: TaskCounter.java:26 (per-IO byte/record/timing counters)."""
    NUM_SPECULATIONS = enum.auto()
    REDUCE_INPUT_GROUPS = enum.auto()
    REDUCE_INPUT_RECORDS = enum.auto()
    REDUCE_OUTPUT_RECORDS = enum.auto()
    INPUT_GROUPS = enum.auto()
    SKIPPED_RECORDS = enum.auto()
    APPROXIMATE_INPUT_RECORDS = enum.auto()
    REDUCE_SKIPPED_GROUPS = enum.auto()
    REDUCE_SKIPPED_RECORDS = enum.auto()
    SPLIT_RAW_BYTES = enum.auto()
    COMBINE_INPUT_RECORDS = enum.auto()
    COMBINE_OUTPUT_RECORDS = enum.auto()
    INPUT_RECORDS_PROCESSED = enum.auto()
    INPUT_SPLIT_LENGTH_BYTES = enum.auto()
    OUTPUT_RECORDS = enum.auto()
    OUTPUT_LARGE_RECORDS = enum.auto()
    OUTPUT_BYTES = enum.auto()
    OUTPUT_BYTES_WITH_OVERHEAD = enum.auto()
    OUTPUT_BYTES_PHYSICAL = enum.auto()
    SPILLED_RECORDS = enum.auto()
    ADDITIONAL_SPILLS_BYTES_WRITTEN = enum.auto()
    ADDITIONAL_SPILLS_BYTES_READ = enum.auto()
    ADDITIONAL_SPILL_COUNT = enum.auto()
    SHUFFLE_CHUNK_COUNT = enum.auto()
    SHUFFLE_BYTES = enum.auto()
    SHUFFLE_PUSH_BYTES = enum.auto()
    SHUFFLE_PUSH_REJECTED = enum.auto()
    SHUFFLE_BYTES_DECOMPRESSED = enum.auto()
    SHUFFLE_BYTES_TO_MEM = enum.auto()
    SHUFFLE_BYTES_TO_DISK = enum.auto()
    SHUFFLE_BYTES_DISK_DIRECT = enum.auto()
    NUM_MEM_TO_DISK_MERGES = enum.auto()
    NUM_DISK_TO_DISK_MERGES = enum.auto()
    SHUFFLE_PHASE_TIME = enum.auto()
    MERGE_PHASE_TIME = enum.auto()
    FIRST_EVENT_RECEIVED = enum.auto()
    LAST_EVENT_RECEIVED = enum.auto()
    NUM_SHUFFLED_INPUTS = enum.auto()
    LOCAL_SHUFFLED_INPUTS = enum.auto()
    NUM_SKIPPED_INPUTS = enum.auto()
    NUM_FAILED_SHUFFLE_INPUTS = enum.auto()
    MERGED_MAP_OUTPUTS = enum.auto()
    GC_TIME_MILLIS = enum.auto()
    CPU_MILLISECONDS = enum.auto()
    WALL_CLOCK_MILLISECONDS = enum.auto()
    PHYSICAL_MEMORY_BYTES = enum.auto()
    VIRTUAL_MEMORY_BYTES = enum.auto()
    COMMITTED_HEAP_BYTES = enum.auto()
    # device data plane profiling
    DEVICE_SORT_MILLIS = enum.auto()
    DEVICE_MERGE_MILLIS = enum.auto()
    DEVICE_EXCHANGE_MILLIS = enum.auto()
    HBM_BYTES_ALLOCATED = enum.auto()
    HOST_SPILL_BYTES = enum.auto()
    H2D_TRANSFER_BYTES = enum.auto()
    D2H_TRANSFER_BYTES = enum.auto()


class TezCounter:
    __slots__ = ("name", "value")

    def __init__(self, name: str, value: int = 0):
        self.name = name
        self.value = value

    def increment(self, n: int = 1) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"{self.name}={self.value}"


class CounterGroup:
    def __init__(self, name: str):
        self.name = name
        self._counters: Dict[str, TezCounter] = {}
        self._lock = threading.Lock()

    def find_counter(self, name: str) -> TezCounter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, TezCounter(name))
        return c

    def __iter__(self) -> Iterator[TezCounter]:
        return iter(self._counters.values())


class TezCounters:
    """Counter registry; enum counters group by enum class name.

    Group/counter creation is thread-safe; increments are plain
    read-modify-writes (one writer per counter, as in tez_tpu)."""

    def __init__(self) -> None:
        self._groups: Dict[str, CounterGroup] = {}
        self._lock = threading.Lock()

    def group(self, name: str) -> CounterGroup:
        with self._lock:
            g = self._groups.get(name)
            if g is None:
                g = self._groups[name] = CounterGroup(name)
            return g

    def find_counter(self, key: "enum.Enum | str",
                     name: str | None = None) -> TezCounter:
        if isinstance(key, enum.Enum):
            return self.group(type(key).__name__).find_counter(key.name)
        assert name is not None
        return self.group(key).find_counter(name)

    def increment(self, key: "enum.Enum | str", n: int = 1) -> None:
        self.find_counter(key).increment(n)

    def to_dict(self) -> Dict[str, Dict[str, int]]:
        return {g.name: {c.name: c.value for c in g}
                for g in self._groups.values()}

    def __repr__(self) -> str:
        return f"TezCounters({self.to_dict()!r})"
