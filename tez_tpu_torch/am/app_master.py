"""DAGAppMaster: composite service wiring every orchestrator subsystem.

Reference parity: tez-dag/.../app/DAGAppMaster.java:226 (serviceInit:423
registers dispatchers/scheduler/launcher/history; session mode runs multiple
DAGs; shutdown/error funnel) + LocalDAGAppMaster.  Here the AM always runs
in-process ("local mode"); a multi-host deployment wraps this object with
gRPC endpoints for the client and umbilical protocols.

The port's copy of tez_tpu.am.app_master with runner threads
(``tez.runner.mode=threads``), runner processes (``subprocess``) and
runner pods acquired from a pod driver (``pods``, am/cluster_binding.py),
the last two over the umbilical server (TLS when it is configured): the AM
resolves its device once (``device="cuda"`` unless the caller asks for the
CPU) and every runner, thread, process or pod, runs its tasks on it.  AM
recovery is tez_tpu's: ``crash()`` dies without the graceful niceties, a
successor ``DAGAppMaster(attempt=n + 1)`` replays the journal in
``recover_and_resume`` (tasks the journal holds SUCCEEDED are restored,
not re-run; parked submissions are requeued), within the
tez.am.max.app.attempts budget.  The AM's optional services are tez_tpu's:
the sharded dispatcher, speculation, the SLO watchdog, the lock-order
witness and streaming mode (``open_stream``: resident windowed DAGs, each
window a DAG on the AM's device, resumed from the window ledger after a
crash).  The web UI is not ported yet: a conf that enables it is refused
with NotImplementedError.
"""
from __future__ import annotations

import logging
import os
import threading
import concurrent.futures
from typing import Any, Dict, List, Optional, Sequence

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


#: conf keys of AM features the port lacks (the web UI) or modes it does
#: not know, each with the values it accepts; another value is refused
_UNPORTED_KEYS = (
    (C.RUNNER_MODE, ("threads", "subprocess", "pods", "", None)),
    (C.AM_WEB_ENABLED, (False, None)),
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
        _refuse_unported(conf)
        self.app_id = app_id
        self.attempt = attempt
        self.conf = conf
        max_attempts = int(conf.get(C.AM_MAX_APP_ATTEMPTS) or 0)
        if max_attempts > 0 and attempt > max_attempts:
            # the RM-side restart budget (reference: tez.am.max.app.attempts
            # via YARN's ApplicationSubmissionContext): a supervisor looping
            # AM restarts must stop re-running a persistently-crashing app
            raise RuntimeError(
                f"AM attempt {attempt} exceeds tez.am.max.app.attempts="
                f"{max_attempts}; refusing to restart {app_id}")
        #: where every task's data plane runs; resolved here, once, so a
        #: run that asks for a card that is absent fails before any DAG
        self.device = resolve_device(device)
        self.node_id = "local-0"
        self.work_dir = os.path.join(
            conf.get(C.STAGING_DIR), app_id, "work")
        os.makedirs(self.work_dir, exist_ok=True)
        shards = int(conf.get(C.AM_CONCURRENT_DISPATCHER_SHARDS) or 0)
        if shards > 1:
            from tez_tpu_torch.common.dispatcher import ShardedDispatcher
            self.dispatcher = ShardedDispatcher(f"am-{app_id}",
                                                num_shards=shards)
        else:
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
        runner_mode = conf.get(C.RUNNER_MODE)
        if runner_mode in ("subprocess", "pods"):
            from tez_tpu_torch.am.umbilical_server import UmbilicalServer
            from tez_tpu_torch.common.tls import server_context
            self.umbilical_server = UmbilicalServer(
                self.task_comm, self.secrets,
                host=conf.get(C.UMBILICAL_BIND_HOST),
                ssl_context=server_context(conf))
            if runner_mode == "subprocess":
                from tez_tpu_torch.am.launcher import SubprocessRunnerPool
                self.runner_pool = SubprocessRunnerPool(self, num_slots)
            else:
                # external cluster binding: the AM acquires runner pods
                # from a cluster driver (YarnTaskSchedulerService/NMClient
                # analog — am/cluster_binding.py)
                from tez_tpu_torch.am.cluster_binding import create_pod_pool
                self.runner_pool = create_pod_pool(self, num_slots)
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
        #: dag name -> latest dag_id that ran under it (client re-attach
        #: resolves recovered DAGs by name — dag ids are AM-assigned and a
        #: successor incarnation reassigns them deterministically, but the
        #: NAME is the client-stable handle)
        self.dag_ids_by_name: Dict[str, str] = {}
        self._dag_seq = 0
        self._dag_done = threading.Condition()
        from tez_tpu_torch.obs import slo as _slo
        #: None unless some tez.am.slo.* target is declared; the admission
        #: controller ticks it on every completion/shed/queue-promotion
        self.slo_watchdog = _slo.from_conf(conf, journal=self.history)
        from tez_tpu_torch.am.admission import AdmissionController
        self.admission = AdmissionController(self)
        from tez_tpu_torch.am.telemetry import TelemetrySampler
        #: the live telemetry plane: periodic ring sampler + burn-rate SLO
        #: evaluation
        self.telemetry = TelemetrySampler(self)
        #: resident stream drivers keyed by stream name (streaming mode);
        #: populated by open_stream and by recovery
        self.streams: Dict[str, Any] = {}
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

    def find_dag_id_by_name(self, name: str) -> Optional[str]:
        """Latest dag_id that ran (or finished) under `name`; falls back to
        the completed-name registry so recovery roll-forwards — which never
        re-instantiate a DAGImpl — are still re-attachable."""
        dag_id = self.dag_ids_by_name.get(name)
        if dag_id is not None:
            return dag_id
        for did, dag_name in self.completed_dag_names.items():
            if dag_name == name:
                dag_id = did    # latest wins (insertion order)
        return dag_id

    def queued_dag_names(self) -> List[str]:
        """Names currently parked in the admission queue (re-attach probes
        these before declaring a DAG lost)."""
        return self.admission.queued_names()

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
        for driver in list(self.streams.values()):
            driver.crash()   # un-drained streams resume on the successor
        self.admission.stop()
        for dag in list(self.live_dags.values()):
            speculator = getattr(dag, "speculator", None)
            if speculator is not None:
                speculator.stop()
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

    def crash(self) -> None:
        """SIGKILL analog (tests/chaos): die WITHOUT the graceful niceties.

        Unlike stop(), nothing terminal is journaled, queued submissions are
        abandoned with AMCrashedError instead of resolved, and no deletion
        tracking runs — live DAGs' journals stay exactly as the crash left
        them, which is what recover_and_resume on the successor incarnation
        (attempt+1) is built to consume.  The `am.crash` fault point fires
        first so chaos specs can widen the kill window deterministically."""
        from tez_tpu_torch.common import faults
        try:
            faults.fire("am.crash", detail=f"attempt={self.attempt}")
        except BaseException:  # noqa: BLE001 — a fail rule still crashes us
            pass
        self.telemetry.crash()   # no TELEMETRY_SNAPSHOT: SIGKILL analog
        self.thread_dumper.stop()
        self.heartbeat_monitor.stop()
        # abandon — not resolve — the admission queue: parked submitters
        # get AMCrashedError and must re-attach; their DAG_QUEUED records
        # stay unresolved in the journal, which is the replay contract
        for driver in list(self.streams.values()):
            driver.crash()   # window loop dies mid-bracket; ledger decides
        self.admission.crash()
        for dag in list(self.live_dags.values()):
            speculator = getattr(dag, "speculator", None)
            if speculator is not None:   # thread hygiene, not graceful state
                speculator.stop()
        self.task_scheduler.shutdown()
        self.runner_pool.shutdown()
        if self.umbilical_server is not None:
            self.umbilical_server.stop()
        self.dispatcher.stop()
        # runner threads are not joined: a task still running keeps its
        # device memory and may launch kernels, and what it reports is
        # fenced by this incarnation's epoch (task_comm); the outputs it
        # registered stay in the process's shuffle service, as a killed
        # process's served files stay on its host
        self.executor.shutdown(wait=False)
        # the in-process close flushes buffered journal lines — a superset
        # of what a real SIGKILL leaves; recovery only ever depends on the
        # fsync'd summary prefix, so the extra tail is harmless
        if self.recovery_service is not None:
            self.recovery_service.stop()
        self.logging_service.stop()
        self._started = False
        log.warning("AM %s attempt %d: CRASHED (simulated SIGKILL)",
                    self.app_id, self.attempt)

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
        speculator = getattr(dag, "speculator", None)
        if speculator is not None:
            speculator.stop()
        from tez_tpu_torch.common import faults
        faults.clear(str(dag.dag_id))
        from tez_tpu_torch.common import lockorder
        lockorder.disarm(str(dag.dag_id))
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
    def submit_dag(self, plan: DAGPlan, recovery_data: Any = None) -> DAGId:
        """Admission-controlled submit: ACCEPT starts the DAG now, QUEUE
        blocks until the FIFO consumer promotes it, SHED raises a typed
        DAGRejectedError carrying the RETRY-AFTER hint."""
        assert self._started, "AM not started"
        return self.admission.submit(plan, recovery_data)

    def _start_dag(self, plan: DAGPlan, recovery_data: Any,
                   tenant: str, sub_id: str = "") -> DAGId:
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
        dag = DAGImpl(dag_id, plan, self, recovery_data=recovery_data)
        dag.tenant = tenant
        dag.submit_monotonic = clock.mono_s()
        with self._dag_done:
            self.live_dags[str(dag_id)] = dag
            self.dag_ids_by_name[plan.name] = str(dag_id)
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
        if dag.conf.get(C.SPECULATION_ENABLED):
            from tez_tpu_torch.am.speculation import Speculator
            dag.speculator = Speculator(dag)
            dag.speculator.start()
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
        # lock-order witness (tez.debug.lockorder): armed per-DAG like the
        # fault plane; disarmed in on_dag_finished, observations retained
        from tez_tpu_torch.common import lockorder
        lockorder.install_from_conf(dag.conf, scope=str(dag_id))
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

    # -- streaming mode (docs/streaming.md) ----------------------------------
    def open_stream(self, spec: Any) -> Any:
        """Open a resident windowed stream: journal the rebuildable spec
        (STREAM_OPENED, fsync'd — the successor incarnation's resume
        contract), start the driver, hand the ingest surface back."""
        assert self._started, "AM not started"
        from tez_tpu_torch.am.streaming import StreamDriver
        if spec.name in self.streams:
            raise ValueError(f"stream {spec.name!r} already open")
        self.history(HistoryEvent(
            HistoryEventType.STREAM_OPENED, data=spec.journal_data()))
        driver = StreamDriver(self, spec).start()
        self.streams[spec.name] = driver
        return driver

    def _resume_streams(self, parser: Any) -> None:
        """Resume every non-retired journaled stream (recovery): sealed
        windows are served from the ledger, the first uncommitted window
        re-runs from its surviving spool (StreamDriver._resume_from)."""
        from tez_tpu_torch.am.streaming import StreamDriver
        for stream_id, rec in parser.stream_records().items():
            if stream_id in self.streams:
                continue
            driver = StreamDriver.resume(self, rec)
            if driver is not None:
                self.streams[stream_id] = driver
                log.info("stream %s: resumed after AM restart", stream_id)

    @staticmethod
    def _is_window_plan(plan: Optional[DAGPlan]) -> bool:
        """True for a per-window DAG cloned by a StreamDriver — its
        replay belongs to the stream's ledger, never the generic DAG
        recovery path (re-running window N outside the driver would race
        the resumed stream and break exactly-once)."""
        if plan is None:
            return False
        return bool((plan.dag_conf or {}).get("tez.runtime.stream.id"))

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

    # -- AM-crash recovery (reference: DAGAppMaster serviceInit recovery
    # path + RecoveryParser.parseRecoveryData:658) ---------------------------
    def recover_and_resume(self) -> Optional[DAGId]:
        """Parse prior attempts' journals; re-run the last in-progress DAG.

        The commit ledger (DAG_COMMIT_STARTED/FINISHED/ABORTED, all fsync'd)
        decides what happens to a DAG that crashed during commit:

        - FINISHED: the committers completed; only the terminal DAG record
          was lost.  Roll forward to SUCCEEDED — never re-run or abort.
        - ABORTED: the rollback was declared durable.  Re-run the idempotent
          aborts (a crash may have interrupted the cleanup), record FAILED.
        - STARTED with tez.am.commit.recovery.policy=resume (default):
          re-run ONLY the idempotent committers and roll the commit forward
          (_resume_commit).  Resubmitting the whole DAG would be unsafe —
          a TASK_FINISHED record lost in the crash would re-run a task
          whose output the interrupted commit may already have published.
        - STARTED with policy=fail (reference semantics), or per-vertex /
          group commits pending: FAILED — partial commits can't be trusted.

        An in-flight DAG that never reached commit is resubmitted with its
        journaled SUCCEEDED tasks short-circuited — their generated
        DataMovementEvents replay into the edges instead of re-running
        (RecoveryParser.parseRecoveryData:658 semantics; if the restored
        output data died with the runner, the fetch-failure -> producer-rerun
        path recovers, as it does in the reference on node loss).

        A session AM may die with SEVERAL DAGs live plus a parked admission
        queue; every journaled DAG is recovered in submit order and every
        unresolved DAG_QUEUED record is re-parked (admission replay,
        docs/recovery.md).  Returns the last recovered dag_id — the
        single-DAG surface older callers expect.
        """
        from tez_tpu_torch.am.recovery import RecoveryParser
        parser = RecoveryParser(self.conf.get(C.STAGING_DIR), self.app_id)
        last: Optional[DAGId] = None
        for data in parser.parse_all():
            if data.dag_state is not None:
                # finished before the crash: nothing to re-run, but two
                # things must survive into this incarnation.  First the id
                # sequence — a replayed queued submission must never be
                # assigned a dead DAG's id, or its journal records alias.
                try:
                    seq = int(data.dag_id.rsplit("_", 1)[1])
                    self._dag_seq = max(self._dag_seq, seq)
                except (ValueError, IndexError):
                    pass
                # Second the journaled verdict — a client handle re-bound
                # by reattach() resolves against completed_dags, so
                # DAGLostError keeps meaning "never reached a replayable
                # state", not "finished too early"
                try:
                    final = DAGState[data.dag_state]
                except KeyError:
                    continue
                with self._dag_done:
                    self.completed_dags.setdefault(data.dag_id, final)
                    if data.plan is not None:
                        self.completed_dag_names.setdefault(
                            data.dag_id, data.plan.name)
                    self._dag_done.notify_all()
                continue
            if self._is_window_plan(data.plan):
                # a stream's in-flight window DAG: keep the id sequence
                # monotonic but leave the re-run to the resumed driver —
                # the window-commit ledger, not DAG recovery, decides
                # whether window N runs again
                try:
                    seq = int(data.dag_id.rsplit("_", 1)[1])
                    self._dag_seq = max(self._dag_seq, seq)
                except (ValueError, IndexError):
                    pass
                log.info("dag %s: window DAG of stream %s — deferring to "
                         "stream resume", data.dag_id,
                         data.plan.dag_conf.get("tez.runtime.stream.id"))
                continue
            recovered = self._recover_one(data)
            if recovered is not None:
                last = recovered
        self._replay_admission_queue(parser)
        self._resume_streams(parser)
        return last

    def _recover_one(self, data: Any) -> Optional[DAGId]:
        """Recover a single journaled DAG (see recover_and_resume)."""
        try:
            seq = int(data.dag_id.rsplit("_", 1)[1])
        except (ValueError, IndexError):
            seq = self._dag_seq + 1
        dag_id = DAGId(self.app_id, seq)
        if data.commit_state == "FINISHED":
            log.info("dag %s: commit had FINISHED before AM crash; rolling "
                     "forward to SUCCEEDED", data.dag_id)
            self._dag_seq = max(self._dag_seq, seq)
            self._finish_recovered(
                data.dag_id, DAGState.SUCCEEDED,
                "commit finished before AM failure; rolled forward",
                name=data.plan.name if data.plan is not None else "")
            return dag_id
        if data.commit_state == "ABORTED":
            log.warning("dag %s: commit had ABORTED before AM crash; "
                        "re-running aborts -> FAILED", data.dag_id)
            self._dag_seq = max(self._dag_seq, seq)
            self._abort_recovered(data)
            self._finish_recovered(
                data.dag_id, DAGState.FAILED,
                "commit aborted before AM failure",
                name=data.plan.name if data.plan is not None else "")
            return dag_id
        policy = str(self.conf.get(C.AM_COMMIT_RECOVERY_POLICY) or "resume")
        if data.commit_state == "STARTED" and policy == "resume" and \
                data.plan is not None:
            self._dag_seq = max(self._dag_seq, seq)
            return self._resume_commit(data, dag_id)
        if data.commit_in_flight:
            log.warning("dag %s: commit was in flight at AM crash -> FAILED "
                        "(policy=%s)", data.dag_id, policy)
            if data.commit_state == "STARTED":
                # policy=fail (or no plan): declare the abort in the ledger,
                # then roll the partial commit back so no half-published
                # output survives
                self.history(HistoryEvent(
                    HistoryEventType.DAG_COMMIT_ABORTED, dag_id=data.dag_id,
                    data={"reason": "commit in flight during AM failure"}))
                self._abort_recovered(data)
            self._finish_recovered(
                data.dag_id, DAGState.FAILED,
                "commit in flight during AM failure",
                name=data.plan.name if data.plan is not None else "")
            self._dag_seq = max(self._dag_seq, seq)
            return dag_id
        if data.plan is None:
            log.warning("dag %s: no plan in journal, cannot recover",
                        data.dag_id)
            return None
        log.info("recovering dag %s (attempt %d): resubmitting "
                 "(%d vertices finished, %d tasks restorable)", data.dag_id,
                 self.attempt, len(data.completed_vertices),
                 len(data.task_data))
        self._dag_seq = seq - 1
        data.events = []   # only task_data/vertex_num_tasks are consulted;
        # don't pin the whole prior journal in AM memory for the DAG lifetime
        return self.submit_dag(data.plan, recovery_data=data)

    def _replay_admission_queue(self, parser: Any) -> None:
        """Re-park every unresolved admission record from prior attempts.

        The lossless-admission contract (docs/multitenancy.md) journals a
        DAG_QUEUED record — plan included — BEFORE the submitter blocks, and
        the `unresolved()` window covers popped-but-unstarted submissions
        too (the am.queue.delay lever).  Here the successor incarnation
        cashes that contract in: each unresolved record re-enters the queue
        with its ORIGINAL sub_id, tenant, and arrival order, under a
        DAG_REQUEUED_ON_RECOVERY event (docs/recovery.md)."""
        if not bool(self.conf.get(C.AM_RECOVERY_QUEUE_REPLAY)):
            return
        for rec in parser.queued_submissions():
            if rec.get("decode_error"):
                # flagged, not silently dropped: journal_fsck reports the
                # same record, and the submitter's re-attach gets DAGLost
                log.error("queued submission %s (%s): plan undecodable, "
                          "cannot replay: %s", rec["sub_id"],
                          rec.get("dag_name") or "<unnamed>",
                          rec["decode_error"])
                continue
            plan = DAGPlan.deserialize(bytes.fromhex(rec["plan"]))
            if self._is_window_plan(plan):
                # the resumed StreamDriver resubmits its own windows;
                # requeueing here would double-run the window
                log.info("queued submission %s (%s): window DAG, deferring "
                         "to stream resume", rec["sub_id"], plan.name)
                continue
            self.admission.requeue(plan, rec.get("tenant") or "",
                                   rec["sub_id"])

    def _finish_recovered(self, dag_id: str, final: DAGState,
                          diagnostics: str, name: str = "") -> None:
        """Journal the terminal record for a DAG resolved during recovery
        (it never re-instantiates as a DAGImpl), run the same deletion
        tracking a normally-finished DAG gets — the crashed attempt's
        shuffle registrations, mesh edges, and fault rules die with it —
        and release waiters."""
        self.history(HistoryEvent(
            HistoryEventType.DAG_FINISHED, dag_id=dag_id,
            data={"state": final.name, "diagnostics": diagnostics}))
        if name:
            with self._dag_done:
                self.completed_dag_names[dag_id] = name
        from tez_tpu_torch.shuffle.service import local_shuffle_service
        n = local_shuffle_service().unregister_prefix(dag_id)
        if n:
            log.info("dag %s: released %d shuffle outputs", dag_id, n)
        from tez_tpu_torch.parallel.coordinator import mesh_coordinator
        mesh_coordinator().cleanup_dag(dag_id)
        from tez_tpu_torch.common import faults
        faults.clear(dag_id)
        with self._dag_done:
            self.completed_dags[dag_id] = final
            self._dag_done.notify_all()

    def _recovered_committers(self, plan: DAGPlan) -> List[Any]:
        """Rebuild leaf-output committers straight from the plan (mirrors
        VertexImpl._create_committers) for commit roll-forward/rollback.
        setup_output is deliberately NOT called — the output trees already
        exist from the crashed attempt and must be inspected, not reset."""
        from tez_tpu_torch.api.initializer import SimpleCommitterContext
        out: List[Any] = []
        for vplan in plan.vertices:
            for sink in vplan.leaf_outputs:
                if sink.committer_descriptor is None:
                    continue
                ctx = SimpleCommitterContext(
                    sink.name, vplan.name, sink.committer_descriptor.payload,
                    app_id=self.app_id, am_epoch=self.attempt)
                committer = sink.committer_descriptor.instantiate(ctx)
                committer.initialize()
                out.append((f"{vplan.name}:{sink.name}", committer))
        return out

    def _abort_recovered(self, data: Any) -> None:
        if data.plan is None:
            return
        for name, committer in self._recovered_committers(data.plan):
            try:
                committer.abort_output("FAILED")
            except BaseException:  # noqa: BLE001
                log.exception("recovery abort of %s failed", name)

    def _resume_commit(self, data: Any, dag_id: DAGId) -> DAGId:
        """Roll a mid-commit DAG forward (tez.am.commit.recovery.policy=
        resume).  COMMIT_STARTED is only journaled once every vertex has
        succeeded, so the tasks' work is complete — only the committers'
        publish step is in doubt, and they are idempotent/resumable."""
        committers = self._recovered_committers(data.plan)
        log.info("dag %s: resuming interrupted commit (%d committers)",
                 data.dag_id, len(committers))
        try:
            for name, committer in committers:
                committer.commit_output()
        except BaseException as e:  # noqa: BLE001
            log.exception("dag %s: commit resume failed; aborting",
                          data.dag_id)
            self.history(HistoryEvent(
                HistoryEventType.DAG_COMMIT_ABORTED, dag_id=data.dag_id,
                data={"reason": f"commit resume failed: {e!r}"}))
            for name, committer in committers:
                try:
                    committer.abort_output("FAILED")
                except BaseException:  # noqa: BLE001
                    log.exception("recovery abort of %s failed", name)
            self._finish_recovered(data.dag_id, DAGState.FAILED,
                                   f"commit resume failed: {e!r}",
                                   name=data.plan.name)
            return dag_id
        self.history(HistoryEvent(
            HistoryEventType.DAG_COMMIT_FINISHED, dag_id=data.dag_id,
            data={"resumed": True}))
        self._finish_recovered(
            data.dag_id, DAGState.SUCCEEDED,
            "commit resumed and rolled forward after AM restart",
            name=data.plan.name)
        return dag_id

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
