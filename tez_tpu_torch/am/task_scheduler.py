"""Task scheduling onto the runner pool.

Reference parity: tez-dag/.../app/rm/ — TaskSchedulerManager.java:99
multiplexing pluggable TaskSchedulers; here the stock scheduler is the
LocalTaskSchedulerService analog: a priority queue of launch requests that
runner "containers" pull from (the pull IS the allocation — mirrors
TezChild.getTask).  Container reuse falls out naturally: a runner keeps
pulling until the idle timeout.

The TaskScheduler SPI seam (schedule/deallocate/total_slots) is what a
TPU-pod or GKE scheduler plugin would implement instead
(reference: tez-api serviceplugins TaskScheduler).

The port's copy of tez_tpu.am.task_scheduler, the DAG-aware preemption
scheduler ("dag-aware") included.
"""
from __future__ import annotations

import heapq
import itertools
import logging
import threading
from typing import Any, Dict, List, Optional, Set, Tuple

from tez_tpu_torch.common import clock
from tez_tpu_torch.am.events import (SchedulerEvent, SchedulerEventType,
                                     TaskAttemptEvent, TaskAttemptEventType)
from tez_tpu_torch.common.ids import ContainerId, TaskAttemptId
from tez_tpu_torch.runtime.task_spec import TaskSpec

log = logging.getLogger(__name__)


class TaskSchedulerService:
    """SPI: how execution slots are acquired (reference:
    serviceplugins/api/TaskScheduler)."""

    def schedule(self, attempt_id: TaskAttemptId, task_spec: TaskSpec,
                 priority: int) -> None:
        raise NotImplementedError

    def deallocate(self, attempt_id: TaskAttemptId,
                   failed: bool = False) -> None:
        """failed=True feeds container-health accounting (blacklisting)."""
        raise NotImplementedError

    def total_slots(self) -> int:
        raise NotImplementedError

    def shutdown(self) -> None:
        pass


class LocalTaskSchedulerService(TaskSchedulerService):
    """Priority queue + pull model (reference: LocalTaskSchedulerService.java:54
    merged with the container-side getTask loop)."""

    #: container failure count that triggers blacklisting (reference:
    #: AMNodeImpl blacklisting via tez.am.maxtaskfailures.per.node)
    MAX_FAILURES_PER_CONTAINER = 3

    def __init__(self, ctx: Any, num_slots: int):
        self.ctx = ctx
        self.num_slots = num_slots
        self._lock = threading.Lock()
        self._available = threading.Condition(self._lock)
        self._heap: List[Any] = []
        self._seq = itertools.count()
        self._queued: Dict[TaskAttemptId, float] = {}   # -> enqueue time
        self._priorities: Dict[TaskAttemptId, int] = {}
        self._running: Dict[TaskAttemptId, ContainerId] = {}
        self._preempting: Set[TaskAttemptId] = set()
        self._last_preempt_round = 0.0
        self._preempt_retry: "threading.Timer | None" = None
        self._vertex_running: Dict[Any, int] = {}   # vertex_id -> count
        self._container_failures: Dict[Any, int] = {}
        self._blacklisted: Set[Any] = set()
        self._shutdown = False
        # -- tenant fair-share (deficit round-robin, docs/multitenancy.md):
        # queued-work counts per tenant, the DRR rotation + credits, and
        # the weights parsed once from tez.am.session.tenant.weights
        from tez_tpu_torch.common import config as C
        conf = getattr(ctx, "conf", None)
        self._fair_share = bool(conf.get(C.AM_SESSION_FAIR_SHARE)) \
            if conf is not None else True
        self._tenant_weights = self._parse_weights(
            str(conf.get(C.AM_SESSION_TENANT_WEIGHTS) or "")
            if conf is not None else "")
        self._queued_tenant: Dict[TaskAttemptId, str] = {}
        self._tenant_queued: Dict[str, int] = {}
        self._rr_order: List[str] = []
        self._rr_idx = 0
        self._tenant_deficit: Dict[str, float] = {}

    @staticmethod
    def _parse_weights(spec: str) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, w = part.partition("=")
            try:
                out[name.strip()] = max(0.001, float(w or 1.0))
            except ValueError:
                log.warning("bad tenant weight %r ignored", part)
        return out

    def _weight(self, tenant: str) -> float:
        return self._tenant_weights.get(tenant, 1.0)

    def schedule(self, attempt_id: TaskAttemptId, task_spec: TaskSpec,
                 priority: int) -> None:
        tenant = getattr(task_spec, "tenant", "") or ""
        with self._lock:
            heapq.heappush(self._heap,
                           (priority, next(self._seq), attempt_id, task_spec))
            self._queued[attempt_id] = clock.wall_s()
            self._priorities[attempt_id] = priority
            self._queued_tenant[attempt_id] = tenant
            self._tenant_queued[tenant] = \
                self._tenant_queued.get(tenant, 0) + 1
            if tenant not in self._rr_order:
                self._rr_order.append(tenant)
            self._available.notify()
        self.ctx.ensure_runners(self.backlog())
        self._maybe_preempt()

    def _drop_queued_tenant_locked(self, attempt_id: TaskAttemptId) -> None:
        tenant = self._queued_tenant.pop(attempt_id, None)
        if tenant is not None:
            n = self._tenant_queued.get(tenant, 0) - 1
            if n > 0:
                self._tenant_queued[tenant] = n
            else:
                self._tenant_queued.pop(tenant, None)

    def _maybe_preempt(self) -> None:
        """Higher-priority work waiting with every slot busy on strictly
        lower-priority attempts: kill the lowest-priority running attempts
        (up to tez.am.preemption.percentage of slots).  Killed attempts
        respawn and re-queue — reference: YarnTaskSchedulerService
        preemption (lower priority VALUE = more important, heap order)."""
        with self._lock:
            # a _preempt_retry Timer can fire after shutdown() cancelled it
            # (cancel() does not stop a Timer already past its wait): never
            # dispatch TA_KILL_REQUEST into a stopping AM
            if self._shutdown:
                return
            # cheap common-path exit BEFORE any heap scan: a free slot (or
            # empty queue) means nothing to preempt — schedule() stays O(1)
            if len(self._running) < self.num_slots or not self._queued:
                return
        from tez_tpu_torch.common import config as C
        conf = getattr(self.ctx, "conf", None)
        pct = int(conf.get(C.AM_PREEMPTION_PERCENTAGE)) \
            if conf is not None else 10
        if pct <= 0:
            return   # preemption disabled
        limit = max(1, self.num_slots * pct // 100)
        with self._lock:
            if self._shutdown or len(self._running) < self.num_slots:
                return
            # best waiting priority from the heap head, lazily discarding
            # entries cancelled while queued
            best_waiting = None
            best_att = None
            while self._heap:
                p, _s, a, _spec = self._heap[0]
                if a in self._queued:
                    best_waiting = p
                    best_att = a
                    break
                heapq.heappop(self._heap)
            if best_waiting is None:
                return
            # pacing (reference: heartbeats-between-preemptions x the AM-RM
            # heartbeat period): preemption rounds keep a minimum spacing so
            # one burst of schedule() calls doesn't serially kill a slot's
            # whole complement — UNLESS the top request has waited past
            # max.wait-time-ms, which forces a round
            now = clock.wall_s()
            hb_between = int(conf.get(C.AM_PREEMPTION_HEARTBEATS_BETWEEN)) \
                if conf is not None else 3
            max_wait_ms = int(conf.get(C.AM_PREEMPTION_MAX_WAIT_MS)) \
                if conf is not None else 60_000
            spacing = hb_between * 0.25   # 250 ms AM heartbeat period analog
            waited = now - self._queued.get(best_att, now)
            if self._last_preempt_round and \
                    now - self._last_preempt_round < spacing and \
                    waited * 1000 < max_wait_ms:
                # paced out — but _maybe_preempt only runs from schedule(),
                # so arm a one-shot retry or the deferred round (and the
                # max-wait force) would never fire without new submissions
                if self._preempt_retry is None:
                    delay = spacing - (now - self._last_preempt_round)

                    def _retry() -> None:
                        with self._lock:
                            self._preempt_retry = None
                        self._maybe_preempt()

                    t = threading.Timer(max(delay, 0.05), _retry)
                    t.daemon = True
                    self._preempt_retry = t
                    t.start()
                return
            self._preempting &= set(self._running)
            budget = limit - len(self._preempting)
            if budget <= 0:
                return
            eligible = self._victim_filter(self._queued)
            victims = sorted(
                ((self._priorities.get(att, 0), att)
                 for att in self._running
                 if self._priorities.get(att, 0) > best_waiting
                 and att not in self._preempting
                 and eligible(att)),
                key=lambda x: -x[0])[:budget]
            self._preempting.update(att for _, att in victims)
            if victims:
                self._last_preempt_round = now
        for prio, att in victims:
            log.info("preempting %s (priority %d) for waiting priority %d",
                     att, prio, best_waiting)
            self.ctx.dispatch(TaskAttemptEvent(
                TaskAttemptEventType.TA_KILL_REQUEST, att,
                diagnostics=f"preempted: priority-{best_waiting} work "
                            "waiting for a slot"))

    def _victim_filter(self, waiting: "Set[TaskAttemptId]"):
        """Hook: which running attempts MAY be preempted, given the set of
        queued attempts.  The stock policy allows any; the DAG-aware
        subclass restricts to descendants of the waiting vertices."""
        return lambda att: True

    def deallocate(self, attempt_id: TaskAttemptId,
                   failed: bool = False) -> None:
        with self._lock:
            if self._queued.pop(attempt_id, None) is not None:
                self._drop_queued_tenant_locked(attempt_id)
            self._preempting.discard(attempt_id)
            self._priorities.pop(attempt_id, None)
            container = self._running.pop(attempt_id, None)
            if container is not None:
                vid = attempt_id.vertex_id
                n = self._vertex_running.get(vid, 0) - 1
                if n > 0:
                    self._vertex_running[vid] = n
                else:
                    self._vertex_running.pop(vid, None)
                # a finished attempt may unblock work deferred by the
                # vertex concurrency cap: wake waiting runners to re-pop
                self._available.notify_all()
            if failed and container is not None:
                n = self._container_failures.get(container, 0) + 1
                self._container_failures[container] = n
                if n >= self.MAX_FAILURES_PER_CONTAINER and \
                        container not in self._blacklisted:
                    self._blacklisted.add(container)
                    log.warning("container %s blacklisted after %d failures",
                                container, n)

    def is_blacklisted(self, container_id: Any) -> bool:
        with self._lock:
            return container_id in self._blacklisted

    def backlog(self) -> int:
        with self._lock:
            return len(self._queued)

    def total_slots(self) -> int:
        return self.num_slots

    def get_task(self, container_id: ContainerId,
                 timeout: float) -> Optional[TaskSpec]:
        """Runner pull (the allocation point).  Returns None on idle timeout,
        shutdown, or when this container is blacklisted (the runner exits
        and the pool replaces it — container loss recovery)."""
        conf = getattr(self.ctx, "conf", None)
        max_conc = int(conf.get("tez.am.vertex.max-task-concurrency", -1)) \
            if conf is not None else -1
        with self._lock:
            if container_id in self._blacklisted:
                return None
            while True:
                # deficit round-robin tenant pick: with >1 tenant queued,
                # prefer the tenant whose credit is due; a tenant with no
                # poppable entry (concurrency cap) falls back to the best
                # other entry — fair, but always work-conserving
                want = self._drr_pick_locked()
                deferred: List[Any] = []
                handout = None
                fallback = None          # first poppable non-want entry
                while self._heap:
                    entry = heapq.heappop(self._heap)
                    prio, seq, attempt_id, spec = entry
                    if attempt_id not in self._queued:
                        continue  # cancelled while queued
                    if max_conc > 0 and self._vertex_running.get(
                            attempt_id.vertex_id, 0) >= max_conc:
                        # vertex at its concurrency cap
                        # (tez.am.vertex.max-task-concurrency): skip, try
                        # the next entry, re-queue the skipped ones
                        deferred.append(entry)
                        continue
                    tenant = self._queued_tenant.get(attempt_id, "")
                    if want is not None and tenant != want:
                        deferred.append(entry)
                        if fallback is None:
                            fallback = entry
                        continue
                    handout = entry
                    break
                if handout is None and fallback is not None:
                    handout = fallback
                    deferred.remove(fallback)
                for entry in deferred:
                    heapq.heappush(self._heap, entry)
                if handout is not None:
                    prio, seq, attempt_id, spec = handout
                    tenant = self._queued_tenant.get(attempt_id, "")
                    self._queued.pop(attempt_id, None)
                    self._drop_queued_tenant_locked(attempt_id)
                    self._running[attempt_id] = container_id
                    self._vertex_running[attempt_id.vertex_id] = \
                        self._vertex_running.get(attempt_id.vertex_id, 0) + 1
                    if want is not None:
                        # charge whichever tenant actually got the slot
                        d = self._tenant_deficit.get(tenant, 0.0)
                        self._tenant_deficit[tenant] = max(0.0, d - 1.0)
                    return spec
                if self._shutdown:
                    return None
                if not self._available.wait(timeout):
                    return None

    def _drr_pick_locked(self) -> Optional[str]:
        """Next tenant owed a slot (deficit round-robin): visiting a tenant
        replenishes its credit by its weight; a tenant is served while its
        credit lasts, then the rotation advances.  None = fair-share off or
        only one tenant has queued work (plain priority order)."""
        if not self._fair_share:
            return None
        eligible = {t for t, n in self._tenant_queued.items() if n > 0}
        if len(eligible) <= 1:
            return None
        order = self._rr_order
        for _ in range(4 * len(order) + 4):
            t = order[self._rr_idx % len(order)]
            if t in eligible and self._tenant_deficit.get(t, 0.0) >= 1.0:
                return t                 # still in service on this turn
            # t's turn is over (no queued work, or credit spent): the
            # rotation advances and the tenant it ARRIVES at earns its
            # quantum.  Replenishing before advancing would hand the
            # current tenant fresh credit every pick — a monopoly, not
            # round-robin.
            if t not in eligible:
                self._tenant_deficit[t] = 0.0   # empty queue loses credit
            self._rr_idx += 1
            nt = order[self._rr_idx % len(order)]
            if nt in eligible:
                # cap the burst a long-idle tenant could otherwise bank
                self._tenant_deficit[nt] = min(
                    self._tenant_deficit.get(nt, 0.0) + self._weight(nt),
                    4.0 * self._weight(nt))
        return next(iter(sorted(eligible)))    # unreachable-in-practice guard


    def shutdown(self) -> None:
        with self._lock:
            self._shutdown = True
            if self._preempt_retry is not None:
                self._preempt_retry.cancel()
                self._preempt_retry = None
            self._available.notify_all()


class DagAwareTaskSchedulerService(LocalTaskSchedulerService):
    """DAG-topology-aware preemption (reference:
    DagAwareYarnTaskScheduler.java:96, maybePreempt:1172).

    The stock scheduler preempts ANY strictly-lower-priority running
    attempt when better work waits.  That can kill unrelated branch work
    whose eviction cannot unblock the waiting request — and whose re-run
    throws away progress.  Here victims must be DESCENDANTS of a vertex
    with requests waiting at the best priority (the reference's
    blocked-set ∩ assigned-vertices rule): preempting a descendant is
    always productive, because the descendant cannot finish before its
    blocked ancestor anyway."""

    def __init__(self, ctx: Any, num_slots: int):
        super().__init__(ctx, num_slots)
        self._descendants_cache: Dict[str, Dict[str, Set[str]]] = {}

    # ----------------------------------------------------------- topology
    def _dag_for(self, attempt_id: TaskAttemptId) -> Any:
        """Resolve the attempt's DAG through the live registry (concurrent
        session DAGs); falls back to current_dag for older contexts."""
        find = getattr(self.ctx, "find_dag", None)
        if find is not None:
            return find(attempt_id.vertex_id.dag_id)
        return getattr(self.ctx, "current_dag", None)

    def _descendants(self, dag: Any) -> Dict[str, Set[str]]:
        """vertex name -> set of (transitive) descendant vertex names for
        one DAG (reference: vertexDescendants BitSets); cached per dag_id
        since several DAGs stay live at once."""
        if dag is None:
            return {}
        key = str(dag.dag_id)
        cached = self._descendants_cache.get(key)
        if cached is not None:
            return cached
        children = {name: [e.destination_vertex.name
                           for e in v.out_edges.values()]
                    for name, v in dag.vertices.items()}
        memo: Dict[str, Set[str]] = {}

        def desc(name: str) -> Set[str]:
            got = memo.get(name)
            if got is not None:
                return got
            memo[name] = out = set()   # pre-seed: DAG => no cycles, but a
            # partially-built entry keeps this robust anyway
            for c in children.get(name, ()):
                out.add(c)
                out |= desc(c)
            return out

        result = {name: desc(name) for name in children}
        if len(self._descendants_cache) > 16:    # bound the session cache
            self._descendants_cache.clear()
        self._descendants_cache[key] = result
        return result

    def _vertex_name(self, attempt_id: TaskAttemptId) -> str:
        dag = self._dag_for(attempt_id)
        if dag is None:
            return ""
        v = dag.vertex_by_id(attempt_id.vertex_id)
        return v.name if v is not None else ""

    def _victim_filter(self, waiting: "Set[TaskAttemptId]"):
        """Victims must be descendants of ANY vertex with queued requests
        (the reference's blocked-set ∩ assigned-vertices rule) — evicting a
        descendant always helps, because it cannot finish before its
        blocked ancestor anyway.  Blocked entries are (dag_id, vertex)
        pairs: vertex names may collide across concurrent DAGs, and
        cross-DAG preemption through a name collision would be unfair."""
        blocked: Set[Tuple[str, str]] = set()
        for a in waiting:
            dag = self._dag_for(a)
            if dag is None:
                continue
            descendants = self._descendants(dag)
            for name in descendants.get(self._vertex_name(a), set()):
                blocked.add((str(dag.dag_id), name))

        def _is_victim(att: TaskAttemptId) -> bool:
            # resolve the victim's DAG through the same registry the
            # blocked set was built from, so both sides agree on the id
            dag = self._dag_for(att)
            if dag is None:
                return False
            return (str(dag.dag_id), self._vertex_name(att)) in blocked

        return _is_victim


def create_task_scheduler(ctx: Any, num_slots: int) -> TaskSchedulerService:
    """tez.am.task.scheduler.class: 'local' | 'dag-aware' | module:Class."""
    from tez_tpu_torch.common import config as C
    name = ctx.conf.get(C.AM_TASK_SCHEDULER_CLASS) if ctx.conf is not None \
        else "local"
    if name in ("", "local", None):
        return LocalTaskSchedulerService(ctx, num_slots)
    if name == "dag-aware":
        return DagAwareTaskSchedulerService(ctx, num_slots)
    from tez_tpu_torch.common.payload import resolve_class
    return resolve_class(name)(ctx, num_slots)


class TaskSchedulerManager:
    """Dispatcher-facing façade (reference: TaskSchedulerManager.java:99)."""

    def __init__(self, ctx: Any, scheduler: TaskSchedulerService):
        self.ctx = ctx
        self.scheduler = scheduler

    def handle(self, event: SchedulerEvent) -> None:
        if event.event_type is SchedulerEventType.S_TA_LAUNCH_REQUEST:
            self.scheduler.schedule(event.attempt_id, event.task_spec,
                                    event.priority)
        elif event.event_type is SchedulerEventType.S_TA_ENDED:
            failed = getattr(event, "failed", False)
            self.scheduler.deallocate(event.attempt_id, failed=failed)
            tracker = getattr(self.ctx, "node_tracker", None)
            node = getattr(event, "node_id", "")
            if tracker is not None and node:
                if failed:
                    tracker.on_attempt_failed(node)
                else:
                    tracker.on_attempt_succeeded(node)
