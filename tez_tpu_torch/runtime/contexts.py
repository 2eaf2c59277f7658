"""Runtime context implementations handed to Inputs/Outputs/Processors.

Reference parity: tez-runtime-internals/.../api/impl/{TezInputContextImpl,
TezOutputContextImpl,TezProcessorContextImpl}.java — counters, payloads,
event send, memory requests, progress, fatal-error funnel.

The port's copy of tez_tpu.runtime.contexts.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence, TYPE_CHECKING

from tez_tpu_torch.api.events import (EventMetaData, TezAPIEvent, TezEvent)
from tez_tpu_torch.api.runtime import (InputContext, MemoryUpdateCallback,
                                       ObjectRegistry, OutputContext,
                                       ProcessorContext)
from tez_tpu_torch.common.counters import TezCounters
from tez_tpu_torch.common.payload import UserPayload

if TYPE_CHECKING:
    from tez_tpu_torch.runtime.task_runner import TaskRunner


class TaskKilledError(Exception):
    """Raised inside user code when the AM killed this attempt."""


class _BaseContext:
    def __init__(self, runner: "TaskRunner", payload: UserPayload,
                 producer_consumer_type: str, edge_vertex_name: str = ""):
        self._runner = runner
        self._payload = payload
        self._type = producer_consumer_type
        self._edge_vertex_name = edge_vertex_name

    # -- identity ------------------------------------------------------------
    @property
    def task_attempt_id(self):
        return self._runner.spec.attempt_id

    @property
    def task_index(self) -> int:
        return self._runner.spec.task_index

    @property
    def task_attempt_number(self) -> int:
        return self._runner.spec.attempt_number

    @property
    def vertex_name(self) -> str:
        return self._runner.spec.vertex_name

    @property
    def dag_name(self) -> str:
        return self._runner.spec.dag_name

    @property
    def vertex_parallelism(self) -> int:
        return self._runner.spec.vertex_parallelism

    @property
    def am_epoch(self) -> int:
        """AM incarnation that issued this task's spec (0 = unstamped)."""
        return getattr(self._runner.spec, "am_epoch", 0)

    @property
    def app_id(self) -> str:
        """Application the task belongs to (epoch fencing is per-app)."""
        return self._runner.spec.attempt_id.dag_id.app_id

    @property
    def lineage(self) -> str:
        """Vertex lineage hash for store output reuse ("" = off)."""
        return getattr(self._runner.spec, "lineage", "")

    @property
    def tenant(self) -> str:
        """Tenant the owning DAG was submitted under ("" = anonymous);
        store publishes charge this tenant's byte quotas."""
        return getattr(self._runner.spec, "tenant", "")

    @property
    def window_id(self) -> int:
        """Streaming window this attempt computes (0 = batch/unstamped)."""
        return getattr(self._runner.spec, "window_id", 0)

    @property
    def stream(self) -> str:
        """Stream identity for the window fence ("" = not streaming)."""
        return getattr(self._runner.spec, "stream", "")

    @property
    def device(self):
        """torch.device of the task's data plane (the runner's)."""
        return self._runner.device

    @property
    def counters(self) -> TezCounters:
        return self._runner.counters

    @property
    def user_payload(self) -> UserPayload:
        return self._payload

    @property
    def conf(self) -> dict:
        return self._runner.spec.conf

    # -- events --------------------------------------------------------------
    def _source_meta(self) -> EventMetaData:
        return EventMetaData(
            producer_consumer_type=self._type,
            task_vertex_name=self._runner.spec.vertex_name,
            edge_vertex_name=self._edge_vertex_name,
            task_attempt_id=self._runner.spec.attempt_id)

    def send_events(self, events: Sequence[TezAPIEvent]) -> None:
        meta = self._source_meta()
        self._runner.enqueue_events(
            [TezEvent(ev, source_info=meta) for ev in events])

    # -- memory / progress ---------------------------------------------------
    def request_initial_memory(self, size: int,
                               callback: "MemoryUpdateCallback | None",
                               component_type: str = "OTHER") -> None:
        cb = callback.memory_assigned if callback is not None else None
        self._runner.memory.request_memory(size, cb, requester=repr(self),
                                           component_type=component_type)

    def notify_progress(self) -> None:
        self._runner.check_killed()

    def set_progress(self, progress: float) -> None:
        self._runner.progress = max(0.0, min(1.0, progress))
        self._runner.check_killed()

    def fatal_error(self, exc: Optional[BaseException], message: str) -> None:
        self._runner.fatal_error(exc, message)

    def can_commit(self) -> bool:
        """Commit arbitration with the AM.  Available on every context so
        leaf outputs can gate publishing (reference: canCommit flows through
        the processor, but output commit also honors it).  The spec's AM
        epoch rides along so a zombie attempt from a pre-crash incarnation
        is fenced at the arbitration seam; in streaming mode the window id
        rides along too so a straggler from a sealed window is fenced the
        same way."""
        return self._runner.umbilical.can_commit(
            self._runner.spec.attempt_id, epoch=self.am_epoch,
            window_id=self.window_id, stream=self.stream)

    @property
    def work_dirs(self) -> List[str]:
        return [self._runner.work_dir]

    def get_service_provider_metadata(self, service: str) -> Any:
        return self._runner.service_metadata.get(service)

    @property
    def object_registry(self) -> ObjectRegistry:
        return self._runner.registry


class TezInputContext(_BaseContext, InputContext):
    def __init__(self, runner: "TaskRunner", payload: UserPayload,
                 source_vertex: str, input_index: int):
        super().__init__(runner, payload, "INPUT", source_vertex)
        self._input_index = input_index

    @property
    def source_vertex_name(self) -> str:
        return self._edge_vertex_name

    @property
    def input_index(self) -> int:
        return self._input_index


class TezOutputContext(_BaseContext, OutputContext):
    def __init__(self, runner: "TaskRunner", payload: UserPayload,
                 dest_vertex: str, output_index: int):
        super().__init__(runner, payload, "OUTPUT", dest_vertex)
        self._output_index = output_index

    @property
    def destination_vertex_name(self) -> str:
        return self._edge_vertex_name

    @property
    def output_index(self) -> int:
        return self._output_index


class TezProcessorContext(_BaseContext, ProcessorContext):
    def __init__(self, runner: "TaskRunner", payload: UserPayload):
        super().__init__(runner, payload, "PROCESSOR")

    def can_commit(self) -> bool:
        return self._runner.umbilical.can_commit(
            self._runner.spec.attempt_id, epoch=self.am_epoch,
            window_id=self.window_id, stream=self.stream)
