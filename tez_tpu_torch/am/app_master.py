"""DAGAppMaster: composite service wiring every orchestrator subsystem.

Reference parity: tez-dag/.../app/DAGAppMaster.java:226 (serviceInit:423
registers dispatchers/scheduler/launcher/history; session mode runs multiple
DAGs; shutdown/error funnel) + LocalDAGAppMaster.  Here the AM always runs
in-process ("local mode"); a multi-host deployment wraps this object with
gRPC endpoints for the client and umbilical protocols.

The port's copy of tez_tpu.am.app_master with runner threads
(``tez.runner.mode=threads``) and runner processes (``subprocess``: the
umbilical server, TLS when it is configured): the AM resolves its device
once (``device="cuda"`` unless the caller asks for the CPU) and every
runner, thread or process, runs its tasks on it.  What is not ported yet
raises NotImplementedError when its conf asks for it: runner pods (and the
cluster binding they need), the web UI, the sharded dispatcher,
speculation, streaming, declared SLO targets, the lock-order witness, and
AM recovery (attempt > 1).
"""
from __future__ import annotations

import logging
import os
import threading
import concurrent.futures
from typing import Any, Dict, Optional, Sequence

from tez_tpu_torch.am.dag_impl import DAGImpl, DAGState, TERMINAL_DAG_STATES
from tez_tpu_torch.am.events import (DAGEvent, DAGEventType,
                                     SchedulerEventType, TaskAttemptEvent,
                                     TaskAttemptEventType, TaskEvent,
                                     TaskEventType, VertexEvent,
                                     VertexEventType)
from tez_tpu_torch.am.history import (HistoryEvent, HistoryEventHandler,
                                      HistoryEventType)
from tez_tpu_torch.am.launcher import RunnerPool
from tez_tpu_torch.am.task_comm import TaskCommunicatorManager
from tez_tpu_torch.am.task_scheduler import (TaskSchedulerManager,
                                             create_task_scheduler)
from tez_tpu_torch.common import clock, config as C
from tez_tpu_torch.common.counters import TezCounters
from tez_tpu_torch.common.dispatcher import Dispatcher
from tez_tpu_torch.common.ids import DAGId, TaskAttemptId
from tez_tpu_torch.dag.plan import DAGPlan
from tez_tpu_torch.ops.device import resolve_device

log = logging.getLogger(__name__)


#: conf keys of AM features the port lacks, each with the value that
#: leaves the feature off; a conf asking for another value is refused
_UNPORTED_KEYS = (
    (C.RUNNER_MODE, ("threads", "subprocess", "", None)),
    (C.AM_WEB_ENABLED, (False, None)),
    (C.AM_CONCURRENT_DISPATCHER_SHARDS, (0, 1, None)),
    (C.SPECULATION_ENABLED, (False, None)),
    (C.DEBUG_LOCKORDER, (False, None)),
    (C.STREAM_ID, ("", None)),
    (C.AM_SLO_SUBMIT_P95_MS, (0, 0.0, None)),
    (C.AM_SLO_QUEUE_WAIT_P95_MS, (0, 0.0, None)),
    (C.AM_SLO_SHED_RATE, (0, 0.0, None)),
    (C.AM_SLO_WINDOW_P95_MS, (0, 0.0, None)),
)


def _refuse_unported(conf: Any) -> None:
    """Raise NotImplementedError for a conf (the AM's or a DAG's) that
    asks for an AM feature the port has not ported yet, rather than run
    without it."""
    for key, off in _UNPORTED_KEYS:
        value = conf.get(key)
        if value not in off and str(value) not in ("False", "0", "0.0"):
            raise NotImplementedError(
                f"{key.name}={value!r}: not ported to tez_tpu_torch yet")


class DAGAppMaster:
    """The single-controller orchestrator."""

    def __init__(self, app_id: str, conf: C.TezConfiguration,
                 attempt: int = 1, device: Any = "cuda"):
        if attempt != 1:
            raise NotImplementedError(
                f"AM attempt {attempt}: AM recovery is not ported yet")
        _refuse_unported(conf)
        self.app_id = app_id
        self.attempt = attempt
        self.conf = conf
        #: where every task's data plane runs; resolved here, once, so a
        #: run that asks for a card that is absent fails before any DAG
        self.device = resolve_device(device)
        self.node_id = "local-0"
        self.work_dir = os.path.join(
            conf.get(C.STAGING_DIR), app_id, "work")
        os.makedirs(self.work_dir, exist_ok=True)
        self.dispatcher = Dispatcher(f"am-{app_id}")
        self.dag_counters = TezCounters()
        from tez_tpu_torch.common.counters import Limits
        Limits.configure(conf)
        num_slots = conf.get(C.AM_NUM_CONTAINERS) or max(2, os.cpu_count() or 2)
        self.task_scheduler = create_task_scheduler(self, num_slots)
        self.scheduler_manager = TaskSchedulerManager(self, self.task_scheduler)
        self.task_comm = TaskCommunicatorManager(self)
        from tez_tpu_torch.common.security import JobTokenSecretManager
        token_hex = conf.get("tez.job.token", "")
        self.secrets = JobTokenSecretManager(
            bytes.fromhex(token_hex) if token_hex else None)
        self.umbilical_server = None
        if conf.get(C.RUNNER_MODE) == "subprocess":
            from tez_tpu_torch.am.launcher import SubprocessRunnerPool
            from tez_tpu_torch.am.umbilical_server import UmbilicalServer
            from tez_tpu_torch.common.tls import server_context
            self.umbilical_server = UmbilicalServer(
                self.task_comm, self.secrets,
                host=conf.get(C.UMBILICAL_BIND_HOST),
                ssl_context=server_context(conf))
            self.runner_pool = SubprocessRunnerPool(self, num_slots)
        else:
            self.runner_pool = RunnerPool(self, num_slots)
        logging_service = HistoryEventHandler.create_logging_service(
            conf, app_id=app_id)
        from tez_tpu_torch.am.recovery import RecoveryService
        recovery_enabled = conf.get(C.DAG_RECOVERY_ENABLED)
        self.recovery_service = RecoveryService(self, attempt) \
            if recovery_enabled else None
        from tez_tpu_torch.am.node_map import AMNodeTracker
        self.node_tracker = AMNodeTracker(conf)
        self.node_tracker.on_transition = self._on_node_transition
        from tez_tpu_torch.am.heartbeat import HeartbeatMonitor
        self.heartbeat_monitor = HeartbeatMonitor(self)
        from tez_tpu_torch.runtime.diagnostics import ThreadDumpHelper
        self.thread_dumper = ThreadDumpHelper(
            int(conf.get(C.THREAD_DUMP_INTERVAL_MS) or 0),
            label=f"am-{app_id}")
        self.history_handler = HistoryEventHandler(
            logging_service, self.recovery_service, conf=conf)
        self.logging_service = logging_service
        self.executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix=f"am-exec-{app_id}")
        #: live (non-terminal) DAGs keyed by str(dag_id), in submit order —
        #: the session runs tez.am.session.max-concurrent-dags of them at
        #: once; events route here by the dag_id their id chains carry
        self.live_dags: Dict[str, DAGImpl] = {}
        #: recently finished DAGImpls, bounded — kept so dag_status /
        #: counters stay queryable after completion (events never route
        #: here: a terminal DAG's trailing events are dropped instead)
        self.retired_dags: Dict[str, DAGImpl] = {}
        self.completed_dags: Dict[str, DAGState] = {}
        self.completed_dag_names: Dict[str, str] = {}
        self._dag_seq = 0
        self._dag_done = threading.Condition()
        from tez_tpu_torch.am.admission import AdmissionController
        self.admission = AdmissionController(self)
        from tez_tpu_torch.am.telemetry import TelemetrySampler
        #: the live telemetry plane: the periodic ring sampler
        self.telemetry = TelemetrySampler(self)
        self._register_handlers()
        self._started = False

    @property
    def current_dag(self) -> Optional[DAGImpl]:
        """Most recently started live DAG (single-DAG compat surface; the
        web UI and tests predating multi-tenancy read it)."""
        # lock-free: callers include dispatcher + web threads; a racing
        # registry mutation just means retrying the snapshot.  Falls back
        # to the most recently retired DAG — the historical slot kept the
        # finished DAG visible, and status/counters readers rely on that.
        while True:
            try:
                vals = list(self.live_dags.values())
                if not vals:
                    vals = list(self.retired_dags.values())
                return vals[-1] if vals else None
            except RuntimeError:      # dict mutated during iteration
                continue

    def find_dag(self, dag_id: Any,
                 include_retired: bool = False) -> Optional[DAGImpl]:
        dag = self.live_dags.get(str(dag_id))
        if dag is None and include_retired:
            dag = self.retired_dags.get(str(dag_id))
        return dag

    def _retire_dag_locked(self, dag: DAGImpl) -> None:
        self.live_dags.pop(str(dag.dag_id), None)
        self.retired_dags[str(dag.dag_id)] = dag
        while len(self.retired_dags) > 16:
            self.retired_dags.pop(next(iter(self.retired_dags)))

    # -- service lifecycle ---------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        self.logging_service.start()
        if self.recovery_service is not None:
            self.recovery_service.start()
        self.dispatcher.on_error = self._on_dispatcher_error
        self.dispatcher.start()
        self.heartbeat_monitor.start()
        self.thread_dumper.start()
        if self.umbilical_server is not None:
            self.umbilical_server.start()
        self.telemetry.start()
        self._started = True
        self.history(HistoryEvent(HistoryEventType.AM_STARTED,
                                  data={"app_id": self.app_id,
                                        "attempt": self.attempt}))

    def stop(self) -> None:
        # first: the TELEMETRY_SNAPSHOT summary event needs the history
        # plane still up, and the final accounting should see the session
        # as the scrapers last did
        self.telemetry.stop()
        self.thread_dumper.stop()
        self.heartbeat_monitor.stop()
        self.admission.stop()
        self.task_scheduler.shutdown()
        self.runner_pool.shutdown()
        if self.umbilical_server is not None:
            self.umbilical_server.stop()
        self.dispatcher.stop()
        self.executor.shutdown(wait=False)
        if self.recovery_service is not None:
            self.recovery_service.stop()
        self.logging_service.stop()
        self._started = False

    def _register_handlers(self) -> None:
        d = self.dispatcher
        d.register(DAGEventType, self._handle_dag_event)
        d.register(VertexEventType, self._handle_vertex_event)
        d.register(TaskEventType, self._handle_task_event)
        d.register(TaskAttemptEventType, self._handle_attempt_event)
        d.register(SchedulerEventType, self.scheduler_manager.handle)

    # -- event handlers (dispatcher thread): every event's id chain names
    # its DAG, so concurrent DAGs route without any ambient "current" slot
    def _handle_dag_event(self, event: DAGEvent) -> None:
        dag = self.find_dag(event.dag_id)
        if dag is not None:
            dag.handle(event)

    def _handle_vertex_event(self, event: VertexEvent) -> None:
        dag = self.find_dag(event.vertex_id.dag_id)
        if dag is None:
            return
        v = dag.vertex_by_id(event.vertex_id)
        if v is not None:
            v.handle(event)

    def _handle_task_event(self, event: TaskEvent) -> None:
        dag = self.find_dag(event.task_id.dag_id)
        if dag is None:
            return
        v = dag.vertex_by_id(event.task_id.vertex_id)
        if v is None:
            return
        t = v.tasks.get(event.task_id.id)
        if t is not None:
            t.handle(event)

    def _handle_attempt_event(self, event: TaskAttemptEvent) -> None:
        dag = self.find_dag(event.attempt_id.dag_id)
        if dag is None:
            return
        v = dag.vertex_by_id(event.attempt_id.vertex_id)
        if v is None:
            return
        t = v.tasks.get(event.attempt_id.task_id.id)
        att = t.attempt(event.attempt_id) if t is not None else None
        if att is not None:
            att.handle(event)

    def _on_dispatcher_error(self, exc: BaseException, event: Any) -> None:
        """AM error funnel (reference: DAGAppMaster error handling —
        unhandled dispatcher error fails the DAG(s), not the process)."""
        for dag in list(self.live_dags.values()):
            if dag.state not in TERMINAL_DAG_STATES:
                self.dispatch(DAGEvent(DAGEventType.INTERNAL_ERROR,
                                       dag.dag_id, diagnostics=repr(exc)))

    # -- AMContext surface used by components --------------------------------
    def dispatch(self, event: Any) -> None:
        self.dispatcher.dispatch(event)

    def history(self, event: HistoryEvent) -> None:
        self.history_handler.handle(event)

    def _on_node_transition(self, node_id: str, state: Any,
                            failures: int) -> None:
        """AMNodeTracker observer: make blacklist flaps attributable in the
        history stream (chaos-run forensics + NodeHealthAnalyzer input)."""
        from tez_tpu_torch.am.node_map import NodeState
        kind = {
            NodeState.BLACKLISTED: HistoryEventType.NODE_BLACKLISTED,
            NodeState.FORCED_ACTIVE: HistoryEventType.NODE_FORCED_ACTIVE,
        }.get(state)
        if kind is None:
            return   # ACTIVE reverts carry no dedicated event (yet)
        dag = self.current_dag
        self.history(HistoryEvent(
            kind, dag_id=str(dag.dag_id) if dag is not None else None,
            data={"node_id": node_id, "failures": failures}))

    def history_vertex_configured(self, vertex: Any) -> None:
        data = {"vertex_name": vertex.name, "num_tasks": vertex.num_tasks}
        reconfig = getattr(vertex, "_reconfig_journal", None)
        if reconfig is not None:
            # enough to REPLAY the manager's decision on AM restart
            data["reconfig"] = reconfig
        self.history(HistoryEvent(
            HistoryEventType.VERTEX_CONFIGURE_DONE,
            dag_id=str(vertex.vertex_id.dag_id),
            vertex_id=str(vertex.vertex_id),
            data=data))

    def submit_to_executor(self, fn: Any) -> None:
        self.executor.submit(fn)

    def total_slots(self) -> int:
        return self.task_scheduler.total_slots()

    def prewarm(self) -> None:
        """Spin runners up before the first DAG (reference: TezClient
        preWarm:897 submitting a pre-warm DAG; the runner-pool model just
        needs the pool filled)."""
        self.ensure_runners(self.total_slots())

    def ensure_runners(self, backlog: int) -> None:
        self.runner_pool.ensure_runners(backlog)

    def kill_attempt_in_runner(self, attempt_id: TaskAttemptId) -> None:
        self.task_comm.kill_attempt(attempt_id)

    def deliver_processor_events(self, vertex: Any, events: Sequence[Any],
                                 task_indices: Sequence[int]) -> None:
        for idx in task_indices:
            task = vertex.tasks.get(idx)
            if task is None:
                continue
            for att in task.attempts.values():
                self.task_comm.deliver_custom_events(
                    att.attempt_id, list(events))

    def on_dag_finished(self, dag: DAGImpl, final: DAGState,
                        fenced: bool = False) -> None:
        if fenced:
            # this incarnation was superseded mid-flight: the dag_id (and its
            # shuffle data, mesh edges, fault rules) now belongs to the LIVE
            # AM — tearing any of it down here would sabotage the successor.
            # Only release local waiters.
            log.warning("dag %s: finished FENCED (%s); skipping "
                        "process-global cleanup", dag.dag_id, final.name)
            with self._dag_done:
                self._retire_dag_locked(dag)
                self.completed_dags[str(dag.dag_id)] = final
                self.completed_dag_names[str(dag.dag_id)] = dag.name
                self._dag_done.notify_all()
            self._notify_admission(dag, final)
            return
        # deletion tracking: drop the finished DAG's shuffle data
        # (reference: ContainerLauncherManager DeletionTracker).  A store-
        # backed session seals lineage-tagged outputs FIRST so identical
        # recurring DAGs reuse them after this DAG's keys are released.
        from tez_tpu_torch.shuffle.service import local_shuffle_service
        store = local_shuffle_service().buffer_store()
        if store is not None and final is DAGState.SUCCEEDED:
            sealed = store.seal_lineage(str(dag.dag_id))
            if sealed:
                log.info("dag %s: sealed %d outputs for lineage reuse",
                         dag.dag_id, sealed)
        n = local_shuffle_service().unregister_prefix(str(dag.dag_id))
        if n:
            log.info("dag %s: released %d shuffle outputs", dag.dag_id, n)
        from tez_tpu_torch.parallel.coordinator import mesh_coordinator
        m = mesh_coordinator().cleanup_dag(str(dag.dag_id))
        if m:
            log.info("dag %s: released %d mesh exchange edges", dag.dag_id, m)
        from tez_tpu_torch.common import faults
        faults.clear(str(dag.dag_id))
        from tez_tpu_torch.common import tracing
        sp = getattr(dag, "trace_span", None)
        if sp is not None:
            sp.annotate(final_state=final.name)
            sp.finish()
        tracing.clear(str(dag.dag_id))
        from tez_tpu_torch.obs import flight
        if flight.armed():
            flight.record(flight.MARK, f"dag.finished:{final.name}",
                          str(dag.dag_id))
            if final is not DAGState.SUCCEEDED:
                flight.auto_dump(f"dag.{final.name.lower()}",
                                 scope=str(dag.dag_id))
        flight.clear(str(dag.dag_id))
        with self._dag_done:
            self._retire_dag_locked(dag)
            self.completed_dags[str(dag.dag_id)] = final
            self.completed_dag_names[str(dag.dag_id)] = dag.name
            self._dag_done.notify_all()
        self._notify_admission(dag, final)

    def _notify_admission(self, dag: DAGImpl, final: DAGState) -> None:
        """Release the DAG's admission slot (promotes the queue head) and
        record its per-tenant completion latency.  Outside _dag_done — the
        admission lock never nests inside it."""
        elapsed_s = (clock.mono_s()
                     - getattr(dag, "submit_monotonic", clock.mono_s()))
        self.admission.on_dag_finished(
            getattr(dag, "tenant", ""), final.name, elapsed_s * 1000.0)

    # -- DAG submission (client-facing) --------------------------------------
    def submit_dag(self, plan: DAGPlan) -> DAGId:
        """Admission-controlled submit: ACCEPT starts the DAG now, QUEUE
        blocks until the FIFO consumer promotes it, SHED raises a typed
        DAGRejectedError carrying the RETRY-AFTER hint."""
        assert self._started, "AM not started"
        return self.admission.submit(plan)

    def _start_dag(self, plan: DAGPlan, tenant: str,
                   sub_id: str = "") -> DAGId:
        """Instantiate + start an admitted DAG (AdmissionController only)."""
        # a DAG that asks for what the port lacks is refused before it is
        # journaled
        _refuse_unported(self.conf.merged(plan.dag_conf))
        with self._dag_done:
            self._dag_seq += 1
            dag_id = DAGId(self.app_id, self._dag_seq)
        plan_hex = plan.serialize().hex()
        # per-DAG logging switch must be known before the first dag event
        self.history_handler.set_dag_conf(dag_id, plan.dag_conf)
        submit_data = {"dag_name": plan.name, "tenant": tenant,
                       "plan": plan_hex}
        if sub_id:
            # resolves the DAG_QUEUED / DAG_REQUEUED_ON_RECOVERY admission
            # record: the journal now proves this submission was promoted,
            # so a successor AM must NOT requeue it (and journal_fsck can
            # pair the records like commit-ledger brackets)
            submit_data["sub_id"] = sub_id
        self.history(HistoryEvent(
            HistoryEventType.DAG_SUBMITTED, dag_id=str(dag_id),
            data=submit_data))
        dag = DAGImpl(dag_id, plan, self)
        dag.tenant = tenant
        dag.submit_monotonic = clock.mono_s()
        with self._dag_done:
            self.live_dags[str(dag_id)] = dag
        # DAG-scoped knob: per-DAG conf overrides the AM conf
        if dag.conf.get(C.GENERATE_DEBUG_ARTIFACTS):
            # reference: the AM writes the expanded dag plan text into
            # staging for postmortems (TezUtilsInternal debug artifacts)
            try:
                import json as _json
                path = os.path.join(self.work_dir,
                                    f"{dag_id}-plan-debug.json")
                with open(path, "w") as fh:
                    _json.dump({"name": plan.name,
                                "vertices": sorted(
                                    v.name for v in plan.vertices),
                                "plan_hex": plan_hex},
                               fh, indent=1)
                log.info("debug artifact: %s", path)
            except Exception:  # noqa: BLE001 — diagnostics must not fail
                log.exception("debug artifact write failed")
        # tiered buffer store: created on the first DAG that enables it and
        # shared by the whole session; lineage hashes let recurring DAGs
        # reuse sealed outputs (computed per-submit — they depend only on
        # the plan, not the dag id)
        from tez_tpu_torch.store import ensure_store
        if ensure_store(dag.conf) is not None and \
                dag.conf.get(C.STORE_LINEAGE_REUSE):
            from tez_tpu_torch.store.lineage import vertex_lineage_hashes
            dag.lineage_hashes = vertex_lineage_hashes(plan)
        # fault plane (test/chaos only): rules arm with the DAG and disarm
        # with it in on_dag_finished — per-DAG scoping
        from tez_tpu_torch.common import faults
        faults.install_from_conf(dag.conf, scope=str(dag_id))
        # tracing plane: armed with the DAG like faults; the DAG root span
        # stays open until on_dag_finished and every TaskSpec carries its
        # context so attempt/fetch spans land on the same trace id
        from tez_tpu_torch.common import tracing
        if tracing.install_from_conf(dag.conf, scope=str(dag_id)):
            sp = tracing.start_span(
                f"dag:{plan.name}", cat="dag",
                dag_id=str(dag_id), am_epoch=self.attempt)
            dag.trace_span = sp
            dag.trace_carrier = sp.context.carrier()
        # flight recorder: armed per-DAG like the planes above; the ring
        # survives disarm so tools/doctor.py and GET-time snapshots can
        # read it after the run
        from tez_tpu_torch.obs import flight
        if flight.install_from_conf(dag.conf, scope=str(dag_id)):
            flight.record(flight.MARK, f"dag:{plan.name}", str(dag_id))
        self.dispatch(DAGEvent(DAGEventType.DAG_INIT, dag_id))
        self.dispatch(DAGEvent(DAGEventType.DAG_START, dag_id))
        return dag_id

    def open_stream(self, spec: Any) -> Any:
        """Streaming mode (tez_tpu's resident windowed DAGs)."""
        raise NotImplementedError("streaming mode is not ported yet")

    def recover_and_resume(self) -> Optional[DAGId]:
        """AM recovery from prior attempts' journals."""
        raise NotImplementedError("AM recovery is not ported yet")

    def wait_for_dag(self, dag_id: DAGId,
                     timeout: Optional[float] = None) -> DAGState:
        with self._dag_done:
            ok = self._dag_done.wait_for(
                lambda: str(dag_id) in self.completed_dags, timeout)
            if not ok:
                raise TimeoutError(f"DAG {dag_id} still running")
            return self.completed_dags[str(dag_id)]

    def kill_dag(self, dag_id: DAGId, reason: str = "killed by client") -> None:
        self.dispatch(DAGEvent(DAGEventType.DAG_KILL, dag_id,
                               diagnostics=reason))

    def dag_status(self, dag_id: DAGId) -> Dict[str, Any]:
        dag = self.find_dag(dag_id, include_retired=True)
        if dag is None:
            state = self.completed_dags.get(str(dag_id))
            name = self.completed_dag_names.get(str(dag_id), "?")
            return {"name": name, "state": state.name if state else "UNKNOWN",
                    "progress": 1.0 if state else 0.0, "vertices": {},
                    "diagnostics": []}
        return dag.status_dict()

    def queue_status(self) -> Dict[str, Any]:
        """Admission/queue snapshot (client RPC + GET /queue)."""
        st = self.admission.status()
        st["live_dags"] = {did: d.name for did, d in
                           list(self.live_dags.items())}
        return st
