"""DAG state machine: vertex bookkeeping, commit orchestration.

Reference parity: tez-dag/.../dag/impl/DAGImpl.java:161 — states
NEW -> INITED -> RUNNING -> COMMITTING -> SUCCEEDED/FAILED/KILLED/ERROR,
all-or-nothing commit at DAG success (default), vertex rerun pulls a
SUCCEEDED DAG-in-waiting back to RUNNING.

The port's copy of tez_tpu.am.dag_impl.
"""
from __future__ import annotations

import enum
import logging
from typing import Any, Dict, List, Optional, Sequence

from tez_tpu_torch.common import clock
from tez_tpu_torch.am.edge import EdgeImpl
from tez_tpu_torch.am.events import (DAGEvent, DAGEventType, VertexEvent,
                                     VertexEventType)
from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
from tez_tpu_torch.am.vertex_impl import (TERMINAL_VERTEX_STATES, VertexImpl,
                                          VertexState)
from tez_tpu_torch.api.vertex_manager import VertexStateUpdate
from tez_tpu_torch.common.counters import TezCounters
from tez_tpu_torch.common.ids import DAGId, VertexId
from tez_tpu_torch.common.statemachine import StateMachineFactory
from tez_tpu_torch.dag.plan import DAGPlan

log = logging.getLogger(__name__)


class DAGState(enum.Enum):
    NEW = enum.auto()
    INITED = enum.auto()
    RUNNING = enum.auto()
    COMMITTING = enum.auto()
    SUCCEEDED = enum.auto()
    FAILED = enum.auto()
    KILLED = enum.auto()
    ERROR = enum.auto()


TERMINAL_DAG_STATES = frozenset(
    {DAGState.SUCCEEDED, DAGState.FAILED, DAGState.KILLED, DAGState.ERROR})


class DAGImpl:
    _factory: StateMachineFactory = None

    def __init__(self, dag_id: DAGId, plan: DAGPlan, ctx: Any,
                 recovery_data: Any = None):
        self.dag_id = dag_id
        self.plan = plan
        self.name = plan.name
        self.ctx = ctx
        # DAGRecoveryData from a prior AM attempt's journal, or None.
        # Vertices consult this to short-circuit journaled SUCCEEDED tasks.
        self.recovery_data = recovery_data
        self.conf = ctx.conf.merged(plan.dag_conf)
        self.vertices: Dict[str, VertexImpl] = {}
        self.vertices_by_id: Dict[VertexId, VertexImpl] = {}
        self.edges: Dict[str, EdgeImpl] = {}
        self.counters = TezCounters()
        self.diagnostics: List[str] = []
        self.start_time = 0.0
        self.finish_time = 0.0
        self.completed_vertices = 0
        self.succeeded_vertices = 0
        self.failed_vertices = 0
        self.killed_vertices = 0
        self._terminating = False
        self._committed = False
        self._state_update_registry: Dict[str, List[Any]] = {}
        self.sm = self._factory.make(self)

    @property
    def state(self) -> DAGState:
        return self.sm.state

    def handle(self, event: DAGEvent) -> None:
        if self.state in TERMINAL_DAG_STATES:
            return
        if not self.sm.can_handle(event.event_type):
            log.debug("dag %s: ignoring %s in %s", self.name,
                      event.event_type, self.state)
            return
        self.sm.handle(event)

    # -- lookups -------------------------------------------------------------
    def vertex_by_name(self, name: str) -> Optional[VertexImpl]:
        return self.vertices.get(name)

    def vertex_by_id(self, vid: VertexId) -> Optional[VertexImpl]:
        return self.vertices_by_id.get(vid)

    # -- construction (DAG_INIT) ---------------------------------------------
    def _on_init(self, event: DAGEvent) -> None:
        from tez_tpu_torch.am.dag_scheduler import apply_dag_scheduler
        # Per-vertex commit mode cannot drive a vertex-group SHARED sink:
        # the first member to finish would commit an output its siblings are
        # still writing (the reference rejects this combination too).
        if not self.conf.get("tez.am.commit-all-outputs-on-dag-success", True):
            for g in self.plan.vertex_groups:
                if g.outputs:   # the plan records ACTUAL shared sinks
                    raise ValueError(
                        f"vertex group '{g.name}' shares output(s) "
                        f"{sorted(g.outputs)}: commit-on-vertex-success is "
                        "incompatible with group-shared sinks")
        for i, vplan in enumerate(self.plan.vertices):
            vid = self.dag_id.vertex(i)
            v = VertexImpl(vid, vplan, self)
            self.vertices[vplan.name] = v
            self.vertices_by_id[vid] = v
        for eplan in self.plan.edges:
            src = self.vertices[eplan.input_vertex]
            dst = self.vertices[eplan.output_vertex]
            edge = EdgeImpl(eplan.id, eplan.edge_property, src, dst)
            self.edges[eplan.id] = edge
            src.out_edges[dst.name] = edge
            dst.in_edges[src.name] = edge
        # group inputs
        from tez_tpu_torch.runtime.task_spec import GroupInputSpec
        for gplan in self.plan.group_edges:
            v = self.vertices[gplan.output_vertex]
            v.group_input_specs.append(GroupInputSpec(
                gplan.group_name,
                tuple(self._group_members(gplan.group_name)),
                gplan.merged_input))
        apply_dag_scheduler(self)
        for edge in self.edges.values():
            edge.initialize()
        self.ctx.history(HistoryEvent(
            HistoryEventType.DAG_INITIALIZED, dag_id=str(self.dag_id),
            data={"dag_name": self.name,
                  "vertices": [v.name for v in self.vertices.values()]}))
        for v in self.vertices.values():
            self.ctx.dispatch(VertexEvent(VertexEventType.V_INIT, v.vertex_id))

    def _group_members(self, group_name: str) -> Sequence[str]:
        for g in self.plan.vertex_groups:
            if g.name == group_name:
                return g.members
        return ()

    def _on_start(self, event: DAGEvent) -> None:
        self.start_time = clock.wall_s()
        self.ctx.history(HistoryEvent(
            HistoryEventType.DAG_STARTED, dag_id=str(self.dag_id),
            data={"dag_name": self.name}))
        for v in self.vertices.values():
            self.ctx.dispatch(VertexEvent(VertexEventType.V_START, v.vertex_id))

    # -- vertex callbacks (invoked on dispatcher thread) ---------------------
    def on_vertex_inited(self, vertex: VertexImpl) -> None:
        self._notify_state_update(vertex.name, "CONFIGURED")

    def on_vertex_rerunning(self, vertex: VertexImpl) -> None:
        self.completed_vertices -= 1
        self.succeeded_vertices -= 1
        self.ctx.dispatch(DAGEvent(DAGEventType.DAG_VERTEX_RERUNNING,
                                   self.dag_id, vertex_name=vertex.name))

    def on_vertex_completed(self, vertex: VertexImpl,
                            final_state: VertexState) -> None:
        self.completed_vertices += 1
        if final_state is VertexState.SUCCEEDED:
            self.succeeded_vertices += 1
        elif final_state is VertexState.FAILED:
            self.failed_vertices += 1
        else:
            self.killed_vertices += 1
        self._notify_state_update(vertex.name, final_state.name)
        self.ctx.dispatch(DAGEvent(DAGEventType.DAG_VERTEX_COMPLETED,
                                   self.dag_id, vertex_name=vertex.name,
                                   final_state=final_state))

    def _on_vertex_completed(self, event: DAGEvent) -> DAGState:
        final_state: VertexState = event.final_state
        if final_state is VertexState.FAILED and not self._terminating:
            self.diagnostics.append(
                f"vertex {event.vertex_name} failed")
            self._terminate_vertices("DAG failing: vertex failed")
        if self.completed_vertices == len(self.vertices):
            return self._finish()
        return DAGState.RUNNING

    def _on_vertex_rerunning(self, event: DAGEvent) -> DAGState:
        return DAGState.RUNNING

    def _finish(self) -> DAGState:
        if self.succeeded_vertices == len(self.vertices):
            if self.state is DAGState.COMMITTING:
                # vertices count themselves complete before the DAG reads
                # their DAG_VERTEX_COMPLETED, so when the last two finish
                # back to back both events see every vertex done: the
                # commit the first one started decides (a second commit
                # thread would race it for each part file's rename).
                # tez_tpu commits twice here
                return DAGState.COMMITTING
            return self._start_commit()
        self.finish_time = clock.wall_s()
        final = DAGState.FAILED if self.failed_vertices else DAGState.KILLED
        self._finish_history(final)
        return final

    # -- commit (reference: DAGImpl commit orchestration) --------------------
    def _start_commit(self) -> DAGState:
        committers = self._collect_committers()
        if not committers:
            self.finish_time = clock.wall_s()
            self._finish_history(DAGState.SUCCEEDED)
            return DAGState.SUCCEEDED
        # ledger record 1/2: COMMIT_STARTED is fsync'd (summary event,
        # synchronous ctx.history) BEFORE any committer mutates the
        # filesystem — the write-ahead half of the two-phase commit
        self.ctx.history(HistoryEvent(
            HistoryEventType.DAG_COMMIT_STARTED, dag_id=str(self.dag_id),
            data={"dag_name": self.name}))

        def _commit() -> None:
            from tez_tpu_torch.common import epoch as epoch_registry
            from tez_tpu_torch.common import faults
            from tez_tpu_torch.common.epoch import EpochFencedError
            app_id = getattr(self.ctx, "app_id", "")
            my_epoch = int(getattr(self.ctx, "attempt", 0) or 0)
            try:
                for name, committer in committers:
                    # a zombie commit thread (its AM superseded while this
                    # ran, or while a delay fault held it) must stop before
                    # each publish, not after the damage
                    if my_epoch > 0 and \
                            epoch_registry.is_stale(app_id, my_epoch):
                        faults.fire("fence.stale_epoch",
                                    detail=f"dag_commit {name}")
                        raise EpochFencedError(
                            f"AM epoch {my_epoch} superseded by "
                            f"{epoch_registry.current(app_id)} mid-commit")
                    committer.commit_output()
                self.ctx.dispatch(DAGEvent(DAGEventType.DAG_COMMIT_COMPLETED,
                                           self.dag_id, succeeded=True))
            except EpochFencedError as e:
                log.warning("dag %s: commit fenced: %s", self.name, e)
                self.ctx.dispatch(DAGEvent(DAGEventType.DAG_COMMIT_COMPLETED,
                                           self.dag_id, succeeded=False,
                                           fenced=True, diagnostics=repr(e)))
            except BaseException as e:  # noqa: BLE001
                log.exception("dag %s: commit failed", self.name)
                self.ctx.dispatch(DAGEvent(DAGEventType.DAG_COMMIT_COMPLETED,
                                           self.dag_id, succeeded=False,
                                           diagnostics=repr(e)))

        self.ctx.submit_to_executor(_commit)
        return DAGState.COMMITTING

    def _collect_committers(self) -> List[Any]:
        if not self.conf.get("tez.am.commit-all-outputs-on-dag-success", True):
            return []   # per-vertex mode: each vertex committed on success
        out = []
        for v in self.vertices.values():
            for name, committer in getattr(v, "committers", {}).items():
                out.append((f"{v.name}:{name}", committer))
        return out

    def _on_commit_completed(self, event: DAGEvent) -> DAGState:
        self.finish_time = clock.wall_s()
        if getattr(event, "fenced", False):
            # A superseded incarnation owns nothing anymore: it must not
            # journal to the ledger (the live AM writes it), must not abort
            # committers (the live AM may be publishing right now), and must
            # not tear down process-global services the live AM is using.
            self.diagnostics.append(
                f"commit fenced: {getattr(event, 'diagnostics', '')}")
            self.ctx.on_dag_finished(self, DAGState.FAILED, fenced=True)
            return DAGState.FAILED
        if self._kill_requested:
            self._ledger_abort("kill requested during commit")
            self._abort_committers()
            self._finish_history(DAGState.KILLED)
            return DAGState.KILLED
        if event.succeeded:
            # ledger record 2/2: committers are done and durable — fsync'd
            # before the DAG's terminal record so a crash after this point
            # rolls FORWARD to SUCCEEDED, never re-runs or aborts
            self.ctx.history(HistoryEvent(
                HistoryEventType.DAG_COMMIT_FINISHED,
                dag_id=str(self.dag_id), data={"dag_name": self.name}))
            self._finish_history(DAGState.SUCCEEDED)
            return DAGState.SUCCEEDED
        self.diagnostics.append(
            f"commit failed: {getattr(event, 'diagnostics', '')}")
        self._ledger_abort(getattr(event, "diagnostics", ""))
        self._abort_committers()
        self._finish_history(DAGState.FAILED)
        return DAGState.FAILED

    def _ledger_abort(self, reason: str) -> None:
        """COMMIT_ABORTED is written (and fsync'd) BEFORE the rollback runs:
        once durable, recovery never rolls this commit forward — it re-runs
        the idempotent aborts instead."""
        self.ctx.history(HistoryEvent(
            HistoryEventType.DAG_COMMIT_ABORTED, dag_id=str(self.dag_id),
            data={"dag_name": self.name, "reason": reason}))

    def _abort_committers(self) -> None:
        for name, committer in self._collect_committers():
            try:
                committer.abort_output("FAILED")
            except BaseException:  # noqa: BLE001
                log.exception("abort of %s failed", name)

    # -- kill ----------------------------------------------------------------
    def _on_kill(self, event: DAGEvent) -> DAGState:
        self.diagnostics.append(getattr(event, "diagnostics", "DAG killed"))
        self.ctx.history(HistoryEvent(
            HistoryEventType.DAG_KILL_REQUEST, dag_id=str(self.dag_id)))
        if self.state is DAGState.COMMITTING:
            # Let the in-flight commit thread finish; _on_commit_completed
            # aborts and reports KILLED (all-or-nothing commit contract).
            self._kill_requested = True
            return DAGState.COMMITTING
        if not self._any_live_vertices():
            self.finish_time = clock.wall_s()
            self._finish_history(DAGState.KILLED)
            return DAGState.KILLED
        self._terminate_vertices("DAG kill requested")
        return DAGState.RUNNING

    _kill_requested = False

    def _on_internal_error(self, event: DAGEvent) -> DAGState:
        self.diagnostics.append(
            f"internal error: {getattr(event, 'diagnostics', '')}")
        self._terminate_vertices("internal error")
        self.finish_time = clock.wall_s()
        self._finish_history(DAGState.ERROR)
        return DAGState.ERROR

    def _terminate_vertices(self, reason: str) -> None:
        self._terminating = True
        for v in self.vertices.values():
            if v.state not in TERMINAL_VERTEX_STATES:
                self.ctx.dispatch(VertexEvent(
                    VertexEventType.V_TERMINATE, v.vertex_id,
                    diagnostics=reason))

    def _any_live_vertices(self) -> bool:
        return any(v.state not in TERMINAL_VERTEX_STATES
                   for v in self.vertices.values())

    def _finish_history(self, final: DAGState) -> None:
        self.counters = TezCounters()
        for v in self.vertices.values():
            self.counters.aggregate(v.counters)
        self.ctx.history(HistoryEvent(
            HistoryEventType.DAG_FINISHED, dag_id=str(self.dag_id),
            data={"dag_name": self.name, "state": final.name,
                  "time_taken": self.finish_time - (self.start_time or
                                                    self.finish_time),
                  "diagnostics": "; ".join(self.diagnostics),
                  "counters": self.counters.to_dict()}))
        self.ctx.on_dag_finished(self, final)

    # -- misc hooks used by vertices/managers --------------------------------
    def notify_new_edge_events(self, edge: EdgeImpl) -> None:
        """New producer events available; wake any waiting consumers (local
        mode: consumers poll via heartbeat, so this is a no-op hook point)."""

    def send_custom_events_to_tasks(self, vertex: VertexImpl,
                                    events: Sequence[Any],
                                    task_indices: Sequence[int]) -> None:
        self.ctx.deliver_processor_events(vertex, events, task_indices)

    def register_state_updates(self, vertex_name: str, listener: Any,
                               states: Sequence[str]) -> None:
        self._state_update_registry.setdefault(vertex_name, []).append(listener)
        # deliver the latest state immediately if already reached (reference
        # semantics: register delivers the current state)
        v = self.vertex_by_name(vertex_name)
        if v is None or listener is None:
            return
        if v.state is VertexState.INITED:
            self._deliver_state_update(listener, vertex_name, "CONFIGURED")
        elif v.state is VertexState.RUNNING:
            self._deliver_state_update(listener, vertex_name, "CONFIGURED")
            self._deliver_state_update(listener, vertex_name, "RUNNING")
        elif v.state in TERMINAL_VERTEX_STATES:
            self._deliver_state_update(listener, vertex_name, v.state.name)

    def _notify_state_update(self, vertex_name: str, state: str) -> None:
        for listener in self._state_update_registry.get(vertex_name, []):
            self._deliver_state_update(listener, vertex_name, state)

    @staticmethod
    def _deliver_state_update(listener: Any, vertex_name: str,
                              state: str) -> None:
        try:
            listener.on_vertex_state_updated(
                VertexStateUpdate(vertex_name, state))
        except BaseException:  # noqa: BLE001
            log.exception("state update listener failed")

    # -- status --------------------------------------------------------------
    def status_dict(self) -> Dict[str, Any]:
        total = sum(len(v.tasks) for v in self.vertices.values())
        succeeded = sum(v.succeeded_tasks for v in self.vertices.values())
        return {
            "name": self.name, "state": self.state.name,
            "progress": (succeeded / total) if total else 0.0,
            "diagnostics": list(self.diagnostics),
            "vertices": {v.name: v.status_dict()
                         for v in self.vertices.values()},
        }


def _build_dag_factory() -> StateMachineFactory:
    S, E = DAGState, DAGEventType
    f = StateMachineFactory(S.NEW)
    f.add(S.NEW, S.INITED, E.DAG_INIT, DAGImpl._on_init)
    f.add(S.INITED, S.RUNNING, E.DAG_START, DAGImpl._on_start)
    f.add_multi(S.INITED, (S.RUNNING, S.KILLED), E.DAG_KILL, DAGImpl._on_kill)
    # init/start-time failures (e.g. an invalid plan rejected in _on_init)
    # must terminate the DAG, not strand it in NEW forever
    f.add_multi(S.NEW, (S.ERROR,), E.INTERNAL_ERROR,
                DAGImpl._on_internal_error)
    f.add_multi(S.INITED, (S.ERROR,), E.INTERNAL_ERROR,
                DAGImpl._on_internal_error)
    f.add_multi(S.RUNNING,
                (S.RUNNING, S.COMMITTING, S.SUCCEEDED, S.FAILED, S.KILLED),
                E.DAG_VERTEX_COMPLETED, DAGImpl._on_vertex_completed)
    f.add_multi(S.RUNNING, (S.RUNNING,), E.DAG_VERTEX_RERUNNING,
                DAGImpl._on_vertex_rerunning)
    f.add_multi(S.RUNNING, (S.RUNNING, S.KILLED), E.DAG_KILL, DAGImpl._on_kill)
    f.add_multi(S.RUNNING, (S.ERROR,), E.INTERNAL_ERROR,
                DAGImpl._on_internal_error)
    f.add_multi(S.COMMITTING, (S.SUCCEEDED, S.FAILED, S.KILLED),
                E.DAG_COMMIT_COMPLETED, DAGImpl._on_commit_completed)
    f.add_multi(S.COMMITTING, (S.COMMITTING, S.RUNNING, S.KILLED), E.DAG_KILL,
                DAGImpl._on_kill)
    f.add_multi(S.COMMITTING,
                (S.RUNNING, S.COMMITTING, S.SUCCEEDED, S.FAILED, S.KILLED),
                E.DAG_VERTEX_COMPLETED, DAGImpl._on_vertex_completed)
    f.add_multi(S.COMMITTING, (S.ERROR,), E.INTERNAL_ERROR,
                DAGImpl._on_internal_error)
    return f


DAGImpl._factory = _build_dag_factory()
