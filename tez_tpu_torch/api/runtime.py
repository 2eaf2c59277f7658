"""Task-side runtime SPI: the Input / Processor / Output plugin boundary.

Reference parity: tez-api/.../runtime/api/ — LogicalInput, LogicalOutput,
LogicalIOProcessor, AbstractLogicalInput/Output/Processor, Reader, Writer,
InputContext/OutputContext/ProcessorContext, MergedLogicalInput,
MemoryUpdateCallback, ObjectRegistry.  This is the exact seam the TPU data
plane plugs into (SURVEY.md §2.1 "Runtime SPI").

The port's copy of tez_tpu.api.runtime.
"""
from __future__ import annotations

import abc
from typing import Any, Dict, Iterable, List, Optional, Sequence

from tez_tpu_torch.api.events import TezAPIEvent
from tez_tpu_torch.common.counters import TezCounters
from tez_tpu_torch.common.payload import UserPayload


class Reader(abc.ABC):
    """Reference: Reader.java — marker base for input readers."""


class Writer(abc.ABC):
    """Reference: Writer.java."""


class KeyValueReader(Reader):
    """Iterate (key, value) records (reference: KeyValueReader.java)."""

    @abc.abstractmethod
    def __iter__(self):
        ...


class KeyValuesReader(Reader):
    """Iterate (key, iterable-of-values) groups (reference:
    KeyValuesReader.java, backed by ValuesIterator grouping)."""

    @abc.abstractmethod
    def __iter__(self):
        ...


class KeyValueWriter(Writer):
    @abc.abstractmethod
    def write(self, key: Any, value: Any) -> None:
        ...


class KeyValuesWriter(KeyValueWriter):
    """Also accepts (key, [values]) (reference: KeyValuesWriter.java)."""

    def write_key_values(self, key: Any, values: Iterable[Any]) -> None:
        for v in values:
            self.write(key, v)


class TaskContext(abc.ABC):
    """Shared context surface (reference: TaskContext.java)."""

    @property
    @abc.abstractmethod
    def task_attempt_id(self) -> Any: ...

    @property
    @abc.abstractmethod
    def task_index(self) -> int: ...

    @property
    @abc.abstractmethod
    def task_attempt_number(self) -> int: ...

    @property
    @abc.abstractmethod
    def vertex_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def dag_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def vertex_parallelism(self) -> int: ...

    @property
    @abc.abstractmethod
    def counters(self) -> TezCounters: ...

    @property
    @abc.abstractmethod
    def user_payload(self) -> UserPayload: ...

    @abc.abstractmethod
    def send_events(self, events: Sequence[TezAPIEvent]) -> None: ...

    @abc.abstractmethod
    def request_initial_memory(self, size: int,
                               callback: "MemoryUpdateCallback | None",
                               component_type: str = "OTHER") -> None:
        """Ask for task memory; component_type weights oversubscription
        scaling (see runtime.memory.DEFAULT_WEIGHTS)."""

    @abc.abstractmethod
    def notify_progress(self) -> None: ...

    @abc.abstractmethod
    def set_progress(self, progress: float) -> None: ...

    @abc.abstractmethod
    def fatal_error(self, exc: Optional[BaseException], message: str) -> None: ...

    @property
    @abc.abstractmethod
    def work_dirs(self) -> List[str]: ...

    @abc.abstractmethod
    def get_service_provider_metadata(self, service: str) -> Any: ...

    @property
    @abc.abstractmethod
    def object_registry(self) -> "ObjectRegistry": ...


class InputContext(TaskContext):
    @property
    @abc.abstractmethod
    def source_vertex_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def input_index(self) -> int: ...


class OutputContext(TaskContext):
    @property
    @abc.abstractmethod
    def destination_vertex_name(self) -> str: ...

    @property
    @abc.abstractmethod
    def output_index(self) -> int: ...


class ProcessorContext(TaskContext):
    @abc.abstractmethod
    def can_commit(self) -> bool:
        """Commit arbitration with the AM (reference:
        ProcessorContext.canCommit -> umbilical canCommit)."""


class MemoryUpdateCallback(abc.ABC):
    """Reference: MemoryUpdateCallback.java — grant delivered before start()."""

    @abc.abstractmethod
    def memory_assigned(self, assigned_size: int) -> None: ...


class LogicalInput(abc.ABC):
    """Reference: AbstractLogicalInput.java — lifecycle:
    initialize() -> [start()] -> getReader() -> close()."""

    def __init__(self, context: InputContext, num_physical_inputs: int):
        self.context = context
        self.num_physical_inputs = num_physical_inputs

    @abc.abstractmethod
    def initialize(self) -> List[TezAPIEvent]: ...

    def start(self) -> None:
        """Start fetching; startable inputs are auto-started by the runtime
        task unless the processor opts out."""

    @abc.abstractmethod
    def get_reader(self) -> Reader: ...

    @abc.abstractmethod
    def handle_events(self, events: Sequence[TezAPIEvent]) -> None: ...

    @abc.abstractmethod
    def close(self) -> List[TezAPIEvent]: ...


class LogicalOutput(abc.ABC):
    """Reference: AbstractLogicalOutput.java."""

    def __init__(self, context: OutputContext, num_physical_outputs: int):
        self.context = context
        self.num_physical_outputs = num_physical_outputs

    @abc.abstractmethod
    def initialize(self) -> List[TezAPIEvent]: ...

    def start(self) -> None: ...

    @abc.abstractmethod
    def get_writer(self) -> Writer: ...

    @abc.abstractmethod
    def handle_events(self, events: Sequence[TezAPIEvent]) -> None: ...

    @abc.abstractmethod
    def close(self) -> List[TezAPIEvent]: ...


class LogicalIOProcessor(abc.ABC):
    """Reference: LogicalIOProcessor.java / AbstractLogicalIOProcessor."""

    def __init__(self, context: ProcessorContext):
        self.context = context

    @abc.abstractmethod
    def initialize(self) -> None: ...

    @abc.abstractmethod
    def run(self, inputs: Dict[str, LogicalInput],
            outputs: Dict[str, LogicalOutput]) -> None: ...

    def handle_events(self, events: Sequence[TezAPIEvent]) -> None:
        pass

    @abc.abstractmethod
    def close(self) -> None: ...


class MergedLogicalInput(LogicalInput):
    """Combines several constituent inputs of a vertex-group edge into one
    logical view (reference: MergedLogicalInput.java)."""

    def __init__(self, context: InputContext, inputs: List[LogicalInput]):
        super().__init__(context, len(inputs))
        self.inputs = inputs
        self._ready = 0

    def initialize(self) -> List[TezAPIEvent]:
        return []

    def handle_events(self, events: Sequence[TezAPIEvent]) -> None:
        pass

    def close(self) -> List[TezAPIEvent]:
        return []

    def is_started(self) -> bool:
        return self._ready == len(self.inputs)

    def set_constituent_ready(self) -> None:
        self._ready += 1


class ObjectRegistry:
    """Per-container object cache keyed by lifetime scope.

    Reference: tez-runtime-internals/.../objectregistry/ObjectRegistryImpl —
    cache survives across tasks in a reused container (on TPU: across tasks
    in a runner process, e.g. compiled-kernel caches).
    """
    VERTEX = "vertex"
    DAG = "dag"
    SESSION = "session"

    def __init__(self) -> None:
        self._store: Dict[str, Dict[str, Any]] = {
            self.VERTEX: {}, self.DAG: {}, self.SESSION: {}}

    def add(self, scope: str, key: str, value: Any) -> Any:
        prev = self._store[scope].get(key)
        self._store[scope][key] = value
        return prev

    def get(self, key: str) -> Any:
        for scope in (self.VERTEX, self.DAG, self.SESSION):
            if key in self._store[scope]:
                return self._store[scope][key]
        return None

    def delete(self, key: str) -> bool:
        for scope in (self.VERTEX, self.DAG, self.SESSION):
            if self._store[scope].pop(key, None) is not None:
                return True
        return False

    def clear_scope(self, scope: str) -> None:
        self._store[scope].clear()


class TaskFailureType:
    """Reference: tez-api/.../runtime/api/TaskFailureType.java."""
    NON_FATAL = "NON_FATAL"   # retry up to max attempts
    FATAL = "FATAL"           # fail the task (and DAG) immediately
