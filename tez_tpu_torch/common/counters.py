"""Hierarchical counters with limits and aggregation.

Reference parity: tez-api/.../common/counters/{TezCounters,TezCounter,
CounterGroup,TaskCounter,DAGCounter,Limits}.java.  Counters aggregate
task -> vertex -> DAG and double as the profiling surface (SURVEY.md §5.1).

The port's copy of tez_tpu.common.counters.
"""
from __future__ import annotations

import enum
import threading
from collections import defaultdict
from typing import Any, Dict, Iterator, Mapping


class CounterLimitExceeded(Exception):
    pass


class Limits:
    """Reference: common/counters/Limits.java (caps configurable via
    tez.counters.max / tez.counters.max.groups, Limits.setConfiguration)."""
    DEFAULT_MAX_COUNTERS = 1200
    DEFAULT_MAX_GROUPS = 500
    DEFAULT_MAX_COUNTER_NAME_LEN = 64
    DEFAULT_MAX_GROUP_NAME_LEN = 256
    MAX_COUNTERS = DEFAULT_MAX_COUNTERS
    MAX_GROUPS = DEFAULT_MAX_GROUPS
    MAX_COUNTER_NAME_LEN = DEFAULT_MAX_COUNTER_NAME_LEN
    MAX_GROUP_NAME_LEN = DEFAULT_MAX_GROUP_NAME_LEN

    @classmethod
    def configure(cls, conf: Any) -> None:
        # always resolve against the pristine defaults so one AM's caps
        # never leak into the next AM in the same process
        try:
            cls.MAX_COUNTERS = int(conf.get("tez.counters.max",
                                            cls.DEFAULT_MAX_COUNTERS))
            cls.MAX_GROUPS = int(conf.get("tez.counters.max.groups",
                                          cls.DEFAULT_MAX_GROUPS))
            cls.MAX_COUNTER_NAME_LEN = int(conf.get(
                "tez.counters.counter-name.max-length",
                cls.DEFAULT_MAX_COUNTER_NAME_LEN))
            cls.MAX_GROUP_NAME_LEN = int(conf.get(
                "tez.counters.group-name.max-length",
                cls.DEFAULT_MAX_GROUP_NAME_LEN))
        except (TypeError, ValueError, AttributeError):
            pass


class TaskCounter(enum.Enum):
    """Reference: TaskCounter.java:26 (the per-IO byte/record/timing counters)."""
    NUM_SPECULATIONS = enum.auto()
    REDUCE_INPUT_GROUPS = enum.auto()
    REDUCE_INPUT_RECORDS = enum.auto()
    REDUCE_OUTPUT_RECORDS = enum.auto()
    # reference-parity entries (TaskCounter.java): INPUT_GROUPS is the
    # deprecated map-side alias, SKIPPED_RECORDS / APPROXIMATE_INPUT_RECORDS
    # exist for analyzer/API compatibility
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
    # push-based pipelined shuffle (shuffle/push.py): bytes eagerly pushed
    # into a reducer-side buffer store, and pushes the admission controller
    # (or a dead transport) turned away — rejected spills stay pull-served
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
    LOCAL_SHUFFLED_INPUTS = enum.auto()   # same-host handoff (DATA_LOCAL analog)
    NUM_SKIPPED_INPUTS = enum.auto()
    NUM_FAILED_SHUFFLE_INPUTS = enum.auto()
    MERGED_MAP_OUTPUTS = enum.auto()
    GC_TIME_MILLIS = enum.auto()
    CPU_MILLISECONDS = enum.auto()
    WALL_CLOCK_MILLISECONDS = enum.auto()
    PHYSICAL_MEMORY_BYTES = enum.auto()
    VIRTUAL_MEMORY_BYTES = enum.auto()
    COMMITTED_HEAP_BYTES = enum.auto()
    # TPU-specific additions (device data plane profiling)
    DEVICE_SORT_MILLIS = enum.auto()
    DEVICE_MERGE_MILLIS = enum.auto()
    DEVICE_EXCHANGE_MILLIS = enum.auto()
    HBM_BYTES_ALLOCATED = enum.auto()
    HOST_SPILL_BYTES = enum.auto()
    H2D_TRANSFER_BYTES = enum.auto()
    D2H_TRANSFER_BYTES = enum.auto()


class FileSystemCounter(enum.Enum):
    """Reference: FileSystemCounterGroup (per-FS bytes/ops)."""
    FILE_BYTES_READ = enum.auto()
    FILE_BYTES_WRITTEN = enum.auto()
    FILE_READ_OPS = enum.auto()
    FILE_WRITE_OPS = enum.auto()


class DAGCounter(enum.Enum):
    """Reference: DAGCounter.java."""
    NUM_FAILED_TASKS = enum.auto()
    NUM_KILLED_TASKS = enum.auto()
    NUM_SUCCEEDED_TASKS = enum.auto()
    TOTAL_LAUNCHED_TASKS = enum.auto()
    OTHER_LOCAL_TASKS = enum.auto()
    DATA_LOCAL_TASKS = enum.auto()
    RACK_LOCAL_TASKS = enum.auto()
    AM_CPU_MILLISECONDS = enum.auto()
    AM_GC_TIME_MILLIS = enum.auto()
    NUM_UBER_SUBTASKS = enum.auto()
    TOTAL_CONTAINERS_USED = enum.auto()
    TOTAL_CONTAINER_ALLOCATION_COUNT = enum.auto()
    TOTAL_CONTAINER_REUSE_COUNT = enum.auto()
    NUM_SPECULATIONS = enum.auto()


class TezCounter:
    __slots__ = ("name", "display_name", "value")

    def __init__(self, name: str, display_name: str | None = None, value: int = 0):
        self.name = name
        self.display_name = display_name or name
        self.value = value

    def increment(self, n: int = 1) -> None:
        self.value += n

    def set_value(self, v: int) -> None:
        self.value = v

    def __repr__(self) -> str:
        return f"{self.name}={self.value}"


class CounterGroup:
    def __init__(self, name: str):
        if len(name) > Limits.MAX_GROUP_NAME_LEN:
            name = name[:Limits.MAX_GROUP_NAME_LEN]
        self.name = name
        self._counters: Dict[str, TezCounter] = {}
        self._lock = threading.Lock()

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        del state["_lock"]   # locks don't cross the umbilical wire
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def find_counter(self, name: str, create: bool = True) -> TezCounter:
        # Truncate BEFORE lookup so the dict key and TezCounter.name always
        # agree (names longer than the limit collapse consistently).
        name = name[:Limits.MAX_COUNTER_NAME_LEN]
        c = self._counters.get(name)
        if c is None and create:
            with self._lock:
                c = self._counters.get(name)
                if c is None:
                    if len(self._counters) >= Limits.MAX_COUNTERS:
                        raise CounterLimitExceeded(
                            f"too many counters in {self.name}")
                    c = self._counters[name] = TezCounter(name)
        return c

    def __iter__(self) -> Iterator[TezCounter]:
        return iter(self._counters.values())

    def __len__(self) -> int:
        return len(self._counters)


class TezCounters:
    """Counter registry; enum counters group by enum class name.

    Group/counter *creation* is thread-safe.  Increments are plain
    read-modify-writes: each counter has a single writer (one task thread, or
    the dispatcher thread for vertex/DAG roll-ups) per the control-plane
    single-event-loop rule — mirror of the reference where counters are
    task-local and aggregated centrally.
    """

    def __init__(self) -> None:
        self._groups: Dict[str, CounterGroup] = {}
        self._lock = threading.Lock()

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def group(self, name: str) -> CounterGroup:
        with self._lock:
            g = self._groups.get(name)
            if g is None:
                if len(self._groups) >= Limits.MAX_GROUPS:
                    raise CounterLimitExceeded("too many counter groups")
                g = self._groups[name] = CounterGroup(name)
            return g

    def find_counter(self, key: "enum.Enum | str", name: str | None = None) -> TezCounter:
        if isinstance(key, enum.Enum):
            return self.group(type(key).__name__).find_counter(key.name)
        assert name is not None
        return self.group(key).find_counter(name)

    def increment(self, key: "enum.Enum | str", n: int = 1) -> None:
        self.find_counter(key).increment(n)

    def aggregate(self, other: "TezCounters") -> None:
        """task->vertex->DAG roll-up (reference: AbstractCounters.incrAllCounters)."""
        for gname, group in other._groups.items():
            mine = self.group(gname)
            for c in group:
                mine.find_counter(c.name).increment(c.value)

    def to_dict(self) -> Dict[str, Dict[str, int]]:
        return {g.name: {c.name: c.value for c in g} for g in self._groups.values()}

    @staticmethod
    def from_dict(d: Mapping[str, Mapping[str, int]]) -> "TezCounters":
        out = TezCounters()
        for gname, counters in d.items():
            g = out.group(gname)
            for cname, v in counters.items():
                g.find_counter(cname).set_value(v)
        return out

    def __iter__(self) -> Iterator[CounterGroup]:
        return iter(self._groups.values())

    def __repr__(self) -> str:
        return f"TezCounters({self.to_dict()!r})"
