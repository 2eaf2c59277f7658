"""Typed hierarchical identifiers for every orchestrator entity.

Reference parity: org.apache.tez.dag.records.{TezDAGID,TezVertexID,TezTaskID,
TezTaskAttemptID} (tez-api/src/main/java/org/apache/tez/dag/records/).  The
reference derives IDs from a YARN ApplicationId; here the root is an AppId
string minted by the client/orchestrator.

The port's copy of tez_tpu.common.ids.
"""
from __future__ import annotations

import dataclasses
import itertools
import time

_app_seq = itertools.count(1)


def new_app_id(cluster_ts: int | None = None) -> str:
    ts = cluster_ts if cluster_ts is not None else int(time.time())
    return f"app_{ts}_{next(_app_seq):04d}"


@dataclasses.dataclass(frozen=True, order=True)
class DAGId:
    app_id: str
    id: int

    def __str__(self) -> str:
        return f"dag_{self.app_id[4:]}_{self.id}"

    def vertex(self, vid: int) -> "VertexId":
        return VertexId(self, vid)


@dataclasses.dataclass(frozen=True, order=True)
class VertexId:
    dag_id: DAGId
    id: int

    def __str__(self) -> str:
        return f"vertex_{self.dag_id.app_id[4:]}_{self.dag_id.id}_{self.id:02d}"

    def task(self, tid: int) -> "TaskId":
        return TaskId(self, tid)


@dataclasses.dataclass(frozen=True, order=True)
class TaskId:
    vertex_id: VertexId
    id: int

    def __str__(self) -> str:
        return f"task_{str(self.vertex_id)[7:]}_{self.id:06d}"

    def attempt(self, aid: int) -> "TaskAttemptId":
        return TaskAttemptId(self, aid)

    @property
    def dag_id(self) -> DAGId:
        return self.vertex_id.dag_id


@dataclasses.dataclass(frozen=True, order=True)
class TaskAttemptId:
    task_id: TaskId
    id: int

    def __str__(self) -> str:
        return f"attempt_{str(self.task_id)[5:]}_{self.id}"

    @property
    def vertex_id(self) -> VertexId:
        return self.task_id.vertex_id

    @property
    def dag_id(self) -> DAGId:
        return self.task_id.vertex_id.dag_id


@dataclasses.dataclass(frozen=True, order=True)
class ContainerId:
    """An execution slot.  On TPU deployments a 'container' is one runner
    process bound to a TPU host (or a worker thread in local mode)."""
    app_id: str
    id: int

    def __str__(self) -> str:
        return f"container_{self.app_id[4:]}_{self.id:06d}"
