"""Serializable task description shipped AM -> runner.

Reference parity: tez-runtime-internals/.../runtime/api/impl/TaskSpec.java
(272 LoC): processor descriptor + one InputSpec/OutputSpec per connected edge
or root-input/leaf-output, plus task conf.

The port's copy of tez_tpu.runtime.task_spec.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from tez_tpu_torch.common.ids import TaskAttemptId
from tez_tpu_torch.common.payload import (InputDescriptor, OutputDescriptor,
                                          ProcessorDescriptor)


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Reference: InputSpec.java — source vertex (or root input) name +
    descriptor + physical input count."""
    source_vertex_name: str
    input_descriptor: InputDescriptor
    physical_input_count: int
    is_root_input: bool = False


@dataclasses.dataclass(frozen=True)
class OutputSpec:
    destination_vertex_name: str
    output_descriptor: OutputDescriptor
    physical_output_count: int
    is_leaf_output: bool = False


@dataclasses.dataclass(frozen=True)
class GroupInputSpec:
    group_name: str
    group_vertices: Tuple[str, ...]
    merged_input_descriptor: Any


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    attempt_id: TaskAttemptId
    dag_name: str
    vertex_name: str
    vertex_parallelism: int
    processor_descriptor: ProcessorDescriptor
    inputs: Tuple[InputSpec, ...]
    outputs: Tuple[OutputSpec, ...]
    group_inputs: Tuple[GroupInputSpec, ...] = ()
    conf: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: AM incarnation (attempt number) that issued this spec.  Stamped into
    #: umbilical calls and shuffle registrations so a zombie attempt from a
    #: pre-crash AM is rejected at every seam (0 = unstamped/legacy).
    am_epoch: int = 0
    #: W3C-style trace-context carrier ("00-<trace>-<span>-01") linking this
    #: attempt to the DAG's root span when the tracing plane is armed
    #: ("" = tracing disarmed; the runner then starts no spans).
    trace_context: str = ""
    #: Content-addressed lineage hash of this task's vertex (spec + upstream
    #: closure, see tez_tpu.store.lineage).  Outputs publish under
    #: "<hash>/<task_index>/<dest>" so identical recurring DAGs in a session
    #: can reuse sealed store entries ("" = lineage reuse off).
    lineage: str = ""
    #: Tenant id inherited from the DAG plan (multi-tenant session AM):
    #: the task scheduler's deficit round-robin and the buffer store's
    #: byte quotas key on it ("" = the anonymous default tenant).
    tenant: str = ""
    #: Streaming-mode window coordinate: the numbered window this attempt
    #: computes.  Paired with ``am_epoch`` it forms the generalized
    #: ``(attempt_epoch, window_id)`` fence — a straggler from a sealed
    #: window is rejected at every seam a pre-crash zombie would be
    #: (0 = batch/unstamped: never fenced, pre-streaming semantics).
    window_id: int = 0
    #: Stream identity for the window fence registry ("" = not streaming).
    stream: str = ""

    @property
    def task_index(self) -> int:
        return self.attempt_id.task_id.id

    @property
    def attempt_number(self) -> int:
        return self.attempt_id.id
