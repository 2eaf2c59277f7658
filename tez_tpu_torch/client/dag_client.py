"""Client handle to a submitted DAG.

Reference parity: tez-api/.../dag/api/client/{DAGClient,DAGClientImpl,
DAGStatus,VertexStatus,Progress}.java and DAGClientAMProtocol.proto:100-108
(getDAGStatus, tryKillDAG, getVertexStatus).

The port's copy of tez_tpu.client.dag_client.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Dict, List, Optional

from tez_tpu_torch.common.counters import TezCounters
from tez_tpu_torch.common.ids import DAGId


class DAGStatusState(enum.Enum):
    SUBMITTED = "SUBMITTED"
    INITING = "INITING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    KILLED = "KILLED"
    FAILED = "FAILED"
    ERROR = "ERROR"


_STATE_MAP = {
    "NEW": DAGStatusState.SUBMITTED,
    "INITED": DAGStatusState.INITING,
    "RUNNING": DAGStatusState.RUNNING,
    "COMMITTING": DAGStatusState.RUNNING,
    "SUCCEEDED": DAGStatusState.SUCCEEDED,
    "FAILED": DAGStatusState.FAILED,
    "KILLED": DAGStatusState.KILLED,
    "ERROR": DAGStatusState.ERROR,
}

TERMINAL_STATES = frozenset({DAGStatusState.SUCCEEDED, DAGStatusState.FAILED,
                             DAGStatusState.KILLED, DAGStatusState.ERROR})


@dataclasses.dataclass
class Progress:
    total_task_count: int = 0
    succeeded_task_count: int = 0
    running_task_count: int = 0
    failed_task_count: int = 0
    killed_task_count: int = 0


@dataclasses.dataclass
class VertexStatus:
    name: str
    state: str
    progress: Progress
    diagnostics: List[str]


@dataclasses.dataclass
class DAGStatus:
    name: str
    state: DAGStatusState
    progress: float
    vertex_status: Dict[str, VertexStatus]
    diagnostics: List[str]
    counters: Optional[TezCounters] = None

    @property
    def is_completed(self) -> bool:
        return self.state in TERMINAL_STATES


class DAGClient:
    def __init__(self, am: Any, dag_id: DAGId):
        self._am = am
        self.dag_id = dag_id

    def get_dag_status(self, with_counters: bool = False) -> DAGStatus:
        raw = self._am.dag_status(self.dag_id)
        vs = {}
        for name, d in raw.get("vertices", {}).items():
            vs[name] = VertexStatus(
                name=name, state=d["state"],
                progress=Progress(
                    total_task_count=d["total_tasks"],
                    succeeded_task_count=d["succeeded"],
                    running_task_count=d["running"],
                    failed_task_count=d["failed"],
                    killed_task_count=d["killed"]),
                diagnostics=d.get("diagnostics", []))
        counters = None
        if with_counters:
            find = getattr(self._am, "find_dag", None)  # local AM only;
            # remote proxies report counters via history instead
            dag = find(self.dag_id, include_retired=True) \
                if find is not None else None
            if dag is not None and dag.dag_id == self.dag_id:
                counters = dag.counters
        return DAGStatus(
            name=raw["name"], state=_STATE_MAP.get(raw["state"],
                                                   DAGStatusState.SUBMITTED),
            progress=raw.get("progress", 0.0),
            vertex_status=vs, diagnostics=raw.get("diagnostics", []),
            counters=counters)

    def wait_for_completion(self, timeout: Optional[float] = None,
                            poll: float = 0.05) -> DAGStatus:
        deadline = None if timeout is None else time.time() + timeout
        # Prefer the AM's completion condition over polling when available.
        try:
            self._am.wait_for_dag(self.dag_id, timeout)
        except TimeoutError:
            pass
        while True:
            status = self.get_dag_status()
            if status.is_completed:
                # aggregate counters on the final read
                return self.get_dag_status(with_counters=True)
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(f"DAG {self.dag_id} not done")
            time.sleep(poll)

    def try_kill_dag(self, reason: str = "killed by client") -> None:
        self._am.kill_dag(self.dag_id, reason)
