"""Admission control for the resident multi-tenant session AM.

The reference session AM runs one DAG at a time and *rejects* a second
submit outright (DAGAppMaster.submitDAGToAppMaster).  A resident service
needs a real overload policy instead: every ``submit_dag`` gets one of
three verdicts —

ACCEPT
    capacity is available now; the DAG starts immediately.
QUEUE
    the AM is at ``tez.am.session.max-concurrent-dags``; the submission
    parks in a bounded FIFO and the submitter blocks until the queue
    consumer promotes it.  The plan is journaled (``DAG_QUEUED``, a
    summary event) *before* the submitter unblocks, so a crashed
    consumer can never silently lose an accepted submission — the
    lossless-admission contract.
SHED
    the queue is full, the tenant is over its in-flight cap, or the
    buffer store's host tier is beyond the admission watermark even
    after a relief attempt.  The verdict travels to the client as a
    typed :class:`~tez_tpu_torch.client.errors.DAGRejectedError` carrying a
    RETRY-AFTER hint — clients resubmit with full-jitter backoff
    (TezClient.submit_dag_with_retry); nothing server-side remembers
    the submission.

Fairness (deficit round-robin over task-scheduler slots) and store byte
quotas live elsewhere (task_scheduler.py, store/buffer_store.py); this
module only decides *whether and when* a DAG may occupy the AM.  See
docs/multitenancy.md for the full model.

The port's copy of tez_tpu.am.admission: the verdicts, the FIFO consumer,
the tenant caps, the store-pressure gate and the crash path (parked
submitters abandoned with AMCrashedError, ``requeue`` replaying them on a
successor AM) and the SLO watchdog's ticks.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import threading
from typing import Any, Dict, List, Optional

from tez_tpu_torch.client.errors import DAGRejectedError
from tez_tpu_torch.common import clock, config as C
from tez_tpu_torch.common import faults, metrics
from tez_tpu_torch.obs import flight as _flight

log = logging.getLogger(__name__)


@dataclasses.dataclass
class _QueuedSubmission:
    """One parked submit: the submitter blocks on ``done`` until the
    consumer resolves it with either a dag_id or an error."""
    sub_id: str
    plan: Any
    tenant: str
    recovery_data: Any
    enqueued_at: float
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    dag_id: Any = None
    error: Optional[BaseException] = None


class _TenantStats:
    __slots__ = ("running", "queued", "accepted", "shed", "completed",
                 "failed")

    def __init__(self) -> None:
        self.running = 0
        self.queued = 0
        self.accepted = 0
        self.shed = 0
        self.completed = 0
        self.failed = 0

    def inflight(self) -> int:
        return self.running + self.queued

    def to_dict(self) -> Dict[str, int]:
        return {"running": self.running, "queued": self.queued,
                "accepted": self.accepted, "shed": self.shed,
                "completed": self.completed, "failed": self.failed}


class AdmissionController:
    """Accept/queue/shed verdicts + the FIFO queue consumer thread."""

    def __init__(self, am: Any) -> None:
        self._am = am
        conf = am.conf
        self.max_concurrent = max(
            1, int(conf.get(C.AM_SESSION_MAX_CONCURRENT_DAGS) or 1))
        self.queue_size = max(0, int(conf.get(C.AM_SESSION_QUEUE_SIZE) or 0))
        self.tenant_max_inflight = int(
            conf.get(C.AM_SESSION_TENANT_MAX_INFLIGHT) or 0)
        self.retry_after_ms = float(
            conf.get(C.AM_SESSION_SHED_RETRY_AFTER_MS) or 500.0)
        self.admit_watermark = float(
            conf.get(C.AM_SESSION_ADMIT_STORE_WATERMARK) or 0.95)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queue: "collections.deque[_QueuedSubmission]" = \
            collections.deque()
        self._running = 0
        self._tenants: Dict[str, _TenantStats] = {}
        self._sub_seq = itertools.count(1)
        self._draining: Optional[_QueuedSubmission] = None
        self._stopped = False
        self._consumer = threading.Thread(
            target=self._consume, name=f"am-admit-{am.app_id}", daemon=True)
        self._consumer.start()

    # -- submit path (client-server / local-client threads) ------------------
    def submit(self, plan: Any, recovery_data: Any = None) -> Any:
        tenant = str(getattr(plan, "tenant", "") or "")
        with self._lock:
            ts = self._tenants.setdefault(tenant, _TenantStats())
            shed_reason = self._shed_reason_locked(tenant, ts, plan.name)
            if shed_reason is not None:
                ts.shed += 1
                depth, inflight = len(self._queue), ts.inflight()
                _flight.record(_flight.ADMIT, "shed", tenant,
                               a=depth, b=inflight)
            elif self._running < self.max_concurrent and not self._queue \
                    and self._draining is None:
                ts.accepted += 1
                ts.running += 1
                self._running += 1
                sub = None
                _flight.record(_flight.ADMIT, "accept", tenant,
                               a=0, b=self._running)
            else:
                sub = _QueuedSubmission(
                    sub_id=f"{self._am.app_id}-sub{next(self._sub_seq)}",
                    plan=plan, tenant=tenant, recovery_data=recovery_data,
                    enqueued_at=clock.mono_s())
                ts.accepted += 1
                ts.queued += 1
                self._queue.append(sub)
                self._cond.notify_all()
                _flight.record(_flight.ADMIT, "queue", tenant,
                               a=len(self._queue), b=self._running)
            self._publish_gauges_locked()
        if shed_reason is not None:
            self._journal_shed(plan, tenant, shed_reason, depth, inflight)
            self._slo_tick()
            # snapshot AFTER the slo tick so a shed-forced breach lands in
            # the dump the acceptance assertions read
            _flight.auto_dump("am.admit.shed", scope=tenant)
            raise DAGRejectedError(
                shed_reason, retry_after_s=self.retry_after_ms / 1000.0,
                tenant=tenant, queue_depth=depth, tenant_inflight=inflight)
        if sub is None:                       # ACCEPT: start inline
            try:
                return self._am._start_dag(plan, recovery_data, tenant)
            except BaseException:
                self._rollback_start(tenant)
                raise
        # QUEUE: journal the parked plan FIRST (summary event, fsync'd) so
        # a consumer crash cannot silently drop it, then block.
        from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
        try:
            self._am.history(HistoryEvent(
                HistoryEventType.DAG_QUEUED, dag_id=sub.sub_id,
                data={"dag_name": plan.name, "tenant": tenant,
                      "plan": plan.serialize().hex()}))
        except BaseException as e:
            # un-journaled = not accepted: the lossless ledger only covers
            # records that landed, so pull the park back out and surface a
            # typed verdict — AMCrashedError when the AM died under the
            # append (its journal fd closes mid-write), else the original
            with self._lock:
                try:
                    self._queue.remove(sub)
                    ts.queued -= 1
                    ts.accepted -= 1
                except ValueError:
                    pass     # consumer already popped it; it may promote
            if self._stopped:
                from tez_tpu_torch.client.errors import AMCrashedError
                raise AMCrashedError(sub.sub_id,
                                     dag_name=plan.name) from e
            raise
        log.info("dag %s (tenant=%s): QUEUED as %s behind %d running",
                 plan.name, tenant or "<anon>", sub.sub_id, self._running)
        sub.done.wait()
        if sub.error is not None:
            raise sub.error
        return sub.dag_id

    def _shed_reason_locked(self, tenant: str, ts: _TenantStats,
                            dag_name: str) -> Optional[str]:
        try:
            faults.fire("am.admit.shed", f"{tenant or '<anon>'}/{dag_name}")
        except Exception as e:  # noqa: BLE001 — fault-forced verdict
            return f"fault-injected shed: {e!r}"
        if self.tenant_max_inflight > 0 and \
                ts.inflight() >= self.tenant_max_inflight:
            return (f"tenant over tez.am.session.tenant.max-inflight="
                    f"{self.tenant_max_inflight}")
        if self._store_pressure():
            return ("store host tier beyond "
                    "tez.am.session.admit.store-watermark")
        if self._running >= self.max_concurrent and \
                len(self._queue) >= self.queue_size:
            return (f"admission queue full "
                    f"(tez.am.session.queue-size={self.queue_size})")
        return None

    def _store_pressure(self) -> bool:
        """Host-tier occupancy gate, after one relief attempt (the store's
        relieve_* signals double as the admission pressure valve)."""
        from tez_tpu_torch.shuffle.service import local_shuffle_service
        store = local_shuffle_service().buffer_store()
        if store is None:
            return False
        from tez_tpu_torch.store.buffer_store import HOST
        cap = store.capacity(HOST)
        if cap <= 0:
            return False
        used = store.tier_bytes(HOST)
        if used <= cap * self.admit_watermark:
            return False
        store.relieve_host_pressure(int(used - cap * self.admit_watermark))
        return store.tier_bytes(HOST) > cap * self.admit_watermark

    def _rollback_start(self, tenant: str) -> None:
        with self._lock:
            self._running -= 1
            ts = self._tenants.get(tenant)
            if ts is not None:
                ts.running -= 1
                ts.failed += 1
            self._cond.notify_all()
            self._publish_gauges_locked()

    def _journal_shed(self, plan: Any, tenant: str, reason: str,
                      depth: int, inflight: int) -> None:
        from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
        self._am.history(HistoryEvent(
            HistoryEventType.DAG_ADMISSION_SHED,
            data={"dag_name": plan.name, "tenant": tenant, "reason": reason,
                  "queue_depth": depth, "tenant_inflight": inflight,
                  "retry_after_ms": self.retry_after_ms}))
        log.warning("dag %s (tenant=%s): SHED (%s)", plan.name,
                    tenant or "<anon>", reason)

    # -- queue consumer -------------------------------------------------------
    def _consume(self) -> None:
        while True:
            with self._lock:
                self._cond.wait_for(
                    lambda: self._stopped or (
                        self._queue and self._running < self.max_concurrent))
                if self._stopped:
                    return
                sub = self._queue.popleft()
                ts = self._tenants.setdefault(sub.tenant, _TenantStats())
                ts.queued -= 1
                ts.running += 1
                self._running += 1
                self._draining = sub
                self._publish_gauges_locked()
            # fired OUTSIDE the lock and OUTSIDE any try: fail mode kills
            # this thread mid-drain with `sub` popped but not yet started —
            # the lossless-admission regression lever (the DAG_QUEUED ledger
            # record is the submission's only surviving trace, and
            # unresolved() still reports it)
            faults.fire("am.queue.delay", sub.sub_id)
            try:
                sub.dag_id = self._am._start_dag(
                    sub.plan, sub.recovery_data, sub.tenant,
                    sub_id=sub.sub_id)
            except BaseException as e:  # noqa: BLE001 — fail loudly, not drop
                log.exception("queued dag %s failed to start", sub.sub_id)
                sub.error = e
                self._rollback_start(sub.tenant)
            with self._lock:
                self._draining = None
                self._publish_gauges_locked()
            metrics.observe("am.admit.queue_wait",
                            (clock.mono_s() - sub.enqueued_at) * 1000.0)
            self._slo_tick()
            sub.done.set()

    # -- crash recovery -------------------------------------------------------
    def requeue(self, plan: Any, tenant: str, sub_id: str) -> None:
        """Re-park a journaled-but-unpromoted submission from a dead AM
        incarnation (docs/recovery.md).  Non-blocking — the original
        submitter is gone; it re-attaches and waits by dag name.  Keeps
        the ORIGINAL sub_id so the journal's queued/promoted pairing spans
        incarnations, and journals a ``DAG_REQUEUED_ON_RECOVERY`` record
        (plan included) so a second crash replays from THIS record."""
        tenant = str(tenant or "")
        sub = _QueuedSubmission(
            sub_id=sub_id, plan=plan, tenant=tenant, recovery_data=None,
            enqueued_at=clock.mono_s())
        with self._lock:
            # future fresh submissions must never collide with a replayed
            # sub_id: advance the sequence past the replayed number
            tail = sub_id.rsplit("-sub", 1)
            if len(tail) == 2 and tail[1].isdigit():
                nxt = next(self._sub_seq)
                if nxt <= int(tail[1]):
                    self._sub_seq = itertools.count(int(tail[1]) + 1)
                else:
                    self._sub_seq = itertools.count(nxt)
            ts = self._tenants.setdefault(tenant, _TenantStats())
            ts.accepted += 1
            ts.queued += 1
            self._queue.append(sub)
            self._cond.notify_all()
            _flight.record(_flight.ADMIT, "requeue", tenant,
                           a=len(self._queue), b=self._running)
            self._publish_gauges_locked()
        from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
        self._am.history(HistoryEvent(
            HistoryEventType.DAG_REQUEUED_ON_RECOVERY, dag_id=sub_id,
            data={"dag_name": plan.name, "tenant": tenant,
                  "plan": plan.serialize().hex(),
                  "attempt": getattr(self._am, "attempt", 0)}))
        log.info("dag %s (tenant=%s): REQUEUED on recovery as %s",
                 plan.name, tenant or "<anon>", sub_id)

    def crash(self) -> None:
        """SIGKILL analog for tests/chaos: abandon the queue WITHOUT the
        graceful resolution ``stop()`` performs.  Parked submitters get a
        typed :class:`~tez_tpu_torch.client.errors.AMCrashedError` (their
        ``DAG_QUEUED`` records stay unresolved in the journal — the
        successor incarnation replays them); nothing terminal is
        journaled."""
        from tez_tpu_torch.client.errors import AMCrashedError
        with self._lock:
            self._stopped = True
            parked = list(self._queue)
            if self._draining is not None and \
                    not self._draining.done.is_set():
                parked.append(self._draining)
            self._queue.clear()
            self._cond.notify_all()
        for sub in parked:
            sub.error = AMCrashedError(
                sub.sub_id, dag_name=getattr(sub.plan, "name", ""))
            sub.done.set()

    # -- AM lifecycle hooks ---------------------------------------------------
    def on_dag_finished(self, tenant: str, final_name: str,
                        latency_ms: float) -> None:
        tenant = tenant or ""
        with self._lock:
            self._running -= 1
            ts = self._tenants.setdefault(tenant, _TenantStats())
            ts.running -= 1
            if final_name == "SUCCEEDED":
                ts.completed += 1
            else:
                ts.failed += 1
            self._cond.notify_all()
            self._publish_gauges_locked()
        # dynamic per-tenant name: decoded by chaos --tenant-storm and the
        # counter_diff tenant section straight from the registry
        metrics.observe(f"tenant.{tenant or 'default'}.dag.latency",
                        latency_ms)
        self._slo_tick()

    def _slo_tick(self) -> None:
        """Run one SLO watchdog sweep off the AM's own completion/shed
        ticks (pull-based: no timer thread, no new lock ordering)."""
        wd = getattr(self._am, "slo_watchdog", None)
        if wd is None:
            return
        with self._lock:
            stats = {t: ts.to_dict() for t, ts in self._tenants.items()}
        try:
            wd.evaluate(stats)
        except Exception:  # noqa: BLE001 — diagnostics never fail admission
            log.exception("SLO watchdog sweep failed")

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            parked = list(self._queue)
            self._queue.clear()
            self._cond.notify_all()
        for sub in parked:
            sub.error = RuntimeError(
                f"AM stopping; queued submission {sub.sub_id} not started")
            sub.done.set()
        self._consumer.join(timeout=5.0)

    def consumer_alive(self) -> bool:
        return self._consumer.is_alive()

    # -- observability --------------------------------------------------------
    def unresolved(self) -> List[str]:
        """Queued-or-draining submission ids not yet resolved to a dag_id
        or an error — what a crashed consumer leaves behind."""
        with self._lock:
            out = [s.sub_id for s in self._queue]
            if self._draining is not None and \
                    not self._draining.done.is_set():
                out.append(self._draining.sub_id)
            return out

    def queued_names(self) -> List[str]:
        """DAG names parked in the queue, arrival order (client re-attach
        probes these before declaring a DAG lost)."""
        with self._lock:
            out = [getattr(s.plan, "name", "") for s in self._queue]
            if self._draining is not None and \
                    not self._draining.done.is_set():
                out.append(getattr(self._draining.plan, "name", ""))
            return out

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "max_concurrent_dags": self.max_concurrent,
                "queue_size": self.queue_size,
                "queue_depth": len(self._queue),
                "running": self._running,
                "consumer_alive": self._consumer.is_alive(),
                "tenants": {t or "<anon>": ts.to_dict()
                            for t, ts in sorted(self._tenants.items())},
            }

    def _publish_gauges_locked(self) -> None:
        metrics.set_gauge("am.session.queue.depth", float(len(self._queue)))
        metrics.set_gauge("am.session.running_dags", float(self._running))
