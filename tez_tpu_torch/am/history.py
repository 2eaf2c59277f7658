"""History subsystem: every lifecycle transition emits a typed HistoryEvent.

Reference parity: tez-dag/.../dag/history/ (~25 event classes,
HistoryEvents.proto), HistoryEventHandler.java:46 fanning out to the recovery
journal and a pluggable HistoryLoggingService; SimpleHistoryLoggingService and
ProtoHistoryLoggingService analogs (here: in-memory and JSONL-file loggers —
the JSONL journal doubles as the analyzer/trace input, SURVEY.md §5.1).

The port's copy of tez_tpu.am.history.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from tez_tpu_torch.common import clock
from tez_tpu_torch.common.payload import resolve_class


class HistoryEventType(enum.Enum):
    APP_LAUNCHED = enum.auto()
    AM_LAUNCHED = enum.auto()
    AM_STARTED = enum.auto()
    DAG_SUBMITTED = enum.auto()
    DAG_INITIALIZED = enum.auto()
    DAG_STARTED = enum.auto()
    DAG_COMMIT_STARTED = enum.auto()
    # commit-ledger terminals: STARTED..FINISHED bracket the window where
    # committers may have mutated the filesystem; ABORTED records that the
    # partial commit was rolled back.  All three are summary events (fsync'd
    # before the next ledger state can be reached).
    DAG_COMMIT_FINISHED = enum.auto()
    DAG_COMMIT_ABORTED = enum.auto()
    DAG_FINISHED = enum.auto()
    DAG_KILL_REQUEST = enum.auto()
    # multi-tenant admission ledger: QUEUED marks a submission parked in
    # the bounded FIFO behind the concurrency cap (its plan rides in
    # data, so a crashed queue consumer never loses an accepted submit);
    # ADMISSION_SHED records the typed RETRY-AFTER verdict returned to
    # the client.  Every QUEUED submission must later reach
    # DAG_SUBMITTED or DAG_ADMISSION_SHED — the lossless-admission
    # contract (docs/multitenancy.md).
    DAG_QUEUED = enum.auto()
    DAG_ADMISSION_SHED = enum.auto()
    # AM crash survival (docs/recovery.md): REQUEUED_ON_RECOVERY marks a
    # journaled-but-unpromoted submission re-entering the admission queue
    # under a successor AM incarnation (it carries the plan again, so a
    # second crash replays from IT); ATTEMPT_FENCED records a zombie task
    # attempt from a superseded incarnation rejected at the umbilical.
    DAG_REQUEUED_ON_RECOVERY = enum.auto()
    ATTEMPT_FENCED = enum.auto()
    VERTEX_INITIALIZED = enum.auto()
    VERTEX_STARTED = enum.auto()
    VERTEX_CONFIGURE_DONE = enum.auto()
    VERTEX_COMMIT_STARTED = enum.auto()
    VERTEX_GROUP_COMMIT_STARTED = enum.auto()
    VERTEX_GROUP_COMMIT_FINISHED = enum.auto()
    VERTEX_FINISHED = enum.auto()
    TASK_STARTED = enum.auto()
    TASK_FINISHED = enum.auto()
    TASK_ATTEMPT_STARTED = enum.auto()
    TASK_ATTEMPT_FINISHED = enum.auto()
    CONTAINER_LAUNCHED = enum.auto()
    CONTAINER_STOPPED = enum.auto()
    # robustness transitions (AMNodeImpl state changes): node_id rides in
    # data — nodes are hosts, not DAG-scoped entities
    NODE_BLACKLISTED = enum.auto()
    NODE_FORCED_ACTIVE = enum.auto()
    # SLO watchdog (obs/slo.py): one event per latched breach episode
    # (tenant, kind, stream, observed, target ride in data) so chaos/soak
    # can assert on breaches straight from the journal
    TENANT_SLO_BREACH = enum.auto()
    # burn-rate alerting (obs/slo.py evaluate_burn, docs/telemetry.md):
    # one event per latched burn episode — a fast-window p95 crossed
    # threshold x target while the cumulative histogram was still under
    # target, i.e. the series is TRENDING toward breach.  Carries the
    # same tenant/kind/stream labels as TENANT_SLO_BREACH so doctor can
    # join alert -> breach per stream.  Summary event: the chaos leg
    # asserts journal ordering (alert strictly before breach), so the
    # alert must be on disk when it fires, not when the buffer drains.
    SLO_BURN_ALERT = enum.auto()
    # live telemetry plane (am/telemetry.py): the sampler's ring/overflow
    # accounting journaled once at AM stop, so counter_diff can flag
    # eviction/scrape-error growth across runs without scraping a live AM
    TELEMETRY_SNAPSHOT = enum.auto()
    # streaming mode (am/streaming.py, docs/streaming.md): STREAM_OPENED
    # journals the resident stream's full spec (so a successor AM can
    # rebuild the window driver after a crash); STREAM_RETIRED seals it —
    # no window commit may ever follow.  WINDOW_COMMIT_STARTED/FINISHED/
    # ABORTED are the per-window exactly-once ledger, the windowed analog
    # of the DAG_COMMIT_* records (stream + window_id ride in data);
    # WINDOW_LAGGING types one backpressure episode (ingest blocked at
    # tez.runtime.stream.max-lag).  All summary events: each must be on
    # disk before the stream advances past it.
    STREAM_OPENED = enum.auto()
    STREAM_RETIRED = enum.auto()
    WINDOW_COMMIT_STARTED = enum.auto()
    WINDOW_COMMIT_FINISHED = enum.auto()
    WINDOW_COMMIT_ABORTED = enum.auto()
    WINDOW_LAGGING = enum.auto()
    # relational query layer (tez_tpu/query, docs/query.md):
    # QUERY_SUBMITTED records one planned query per run — the logical
    # fingerprint, per-join physical strategy, the vertex -> operator
    # attribution map, and the store's lineage cache-hit delta — so
    # counter_diff can count plans/cache hits per session journal.
    # QUERY_REPLANNED types one PlanFeedback decision (strategy flip or
    # reducer bump) with the doctor plane it blamed; summary event so
    # the decision is on disk before the replanned DAG submits — the
    # doctor must be able to blame the planner itself after a crash.
    QUERY_SUBMITTED = enum.auto()
    QUERY_REPLANNED = enum.auto()


#: Events whose loss recovery cannot tolerate — flushed synchronously.
#: Reference: SummaryEvent handling in RecoveryService (hflush :246-250).
SUMMARY_EVENT_TYPES = frozenset({
    HistoryEventType.DAG_SUBMITTED,
    HistoryEventType.DAG_STARTED,
    HistoryEventType.DAG_COMMIT_STARTED,
    HistoryEventType.DAG_COMMIT_FINISHED,
    HistoryEventType.DAG_COMMIT_ABORTED,
    HistoryEventType.VERTEX_COMMIT_STARTED,
    HistoryEventType.VERTEX_GROUP_COMMIT_STARTED,
    HistoryEventType.VERTEX_GROUP_COMMIT_FINISHED,
    HistoryEventType.DAG_FINISHED,
    HistoryEventType.DAG_KILL_REQUEST,
    HistoryEventType.DAG_QUEUED,
    HistoryEventType.DAG_ADMISSION_SHED,
    HistoryEventType.DAG_REQUEUED_ON_RECOVERY,
    HistoryEventType.ATTEMPT_FENCED,
    HistoryEventType.TENANT_SLO_BREACH,
    HistoryEventType.SLO_BURN_ALERT,
    HistoryEventType.TELEMETRY_SNAPSHOT,
    HistoryEventType.STREAM_OPENED,
    HistoryEventType.STREAM_RETIRED,
    HistoryEventType.WINDOW_COMMIT_STARTED,
    HistoryEventType.WINDOW_COMMIT_FINISHED,
    HistoryEventType.WINDOW_COMMIT_ABORTED,
    HistoryEventType.WINDOW_LAGGING,
    HistoryEventType.QUERY_SUBMITTED,
    HistoryEventType.QUERY_REPLANNED,
})


@dataclasses.dataclass
class HistoryEvent:
    event_type: HistoryEventType
    # entity ids as strings for serializability; None where not applicable
    dag_id: Optional[str] = None
    vertex_id: Optional[str] = None
    task_id: Optional[str] = None
    attempt_id: Optional[str] = None
    container_id: Optional[str] = None
    timestamp: float = 0.0
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.timestamp:
            self.timestamp = clock.wall_s()

    @property
    def is_summary(self) -> bool:
        return self.event_type in SUMMARY_EVENT_TYPES

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["event_type"] = self.event_type.name
        return json.dumps(d, default=str)

    @staticmethod
    def from_json(line: str) -> "HistoryEvent":
        d = json.loads(line)
        d["event_type"] = HistoryEventType[d["event_type"]]
        return HistoryEvent(**d)


class HistoryLoggingService:
    """SPI (reference: HistoryLoggingService.java)."""

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def handle(self, event: HistoryEvent) -> None:
        raise NotImplementedError


class InMemoryHistoryLoggingService(HistoryLoggingService):
    def __init__(self, conf: Any = None):
        self.events: List[HistoryEvent] = []
        self._lock = threading.Lock()

    def handle(self, event: HistoryEvent) -> None:
        with self._lock:
            self.events.append(event)

    def of_type(self, t: HistoryEventType) -> List[HistoryEvent]:
        with self._lock:
            return [e for e in self.events if e.event_type is t]


class JsonlHistoryLoggingService(HistoryLoggingService):
    """Date/app-partitioned JSONL store — the ProtoHistoryLoggingService
    analog (reference: ProtoHistoryLoggingService.java:47 writing
    date-partitioned proto files scanned by a manifest reader).

    Layout: `<log-dir>/date=YYYY-MM-DD/app_<app_id>_<pid>.jsonl`.  The
    writer rolls to a new partition when the (UTC) date changes mid-run;
    readers discover journals with `scan_history_store` (optionally
    bounded to a date range, so a long-lived store never needs a full
    directory walk)."""

    def __init__(self, conf: Any = None, log_dir: str = "",
                 app_id: str = ""):
        if not log_dir and conf is not None:
            log_dir = conf.get("tez.history.logging.log-dir") or ""
        self.log_dir = log_dir or "/tmp/tez-tpu-history"
        self.app_id = app_id or \
            ((conf.get("tez.app.id") if conf else "") or
             f"app_{int(clock.wall_s())}")
        self._fh = None
        self._date: Optional[str] = None
        self._lock = threading.Lock()

    def _roll(self) -> None:
        """Under lock: open (or roll to) today's partition file."""
        today = time.strftime("%Y-%m-%d", time.gmtime())
        if self._fh is not None and self._date == today:
            return
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
        part = os.path.join(self.log_dir, f"date={today}")
        os.makedirs(part, exist_ok=True)
        self._fh = open(os.path.join(
            part, f"app_{self.app_id}_{os.getpid()}.jsonl"), "a")
        self._date = today

    def start(self) -> None:
        with self._lock:
            self._roll()

    def handle(self, event: HistoryEvent) -> None:
        with self._lock:
            self._roll()
            self._fh.write(event.to_json() + "\n")
            if event.is_summary:
                self._fh.flush()
                os.fsync(self._fh.fileno())

    def stop(self) -> None:
        with self._lock:
            if self._fh:
                self._fh.flush()
                self._fh.close()
                self._fh = None
                self._date = None


def scan_history_store(log_dir: str, date_from: Optional[str] = None,
                       date_to: Optional[str] = None) -> List[str]:
    """Manifest scan of a history store: every journal file under the
    date-partitioned layout (`date=YYYY-MM-DD/*.jsonl`), optionally
    bounded to [date_from, date_to] (inclusive, `YYYY-MM-DD` strings —
    lexicographic compare IS date order).  Flat legacy `*.jsonl` files
    directly under log_dir are included unless a date bound excludes the
    unknown-date files explicitly (they carry no partition)."""
    if not os.path.isdir(log_dir):
        return []
    out: List[str] = []
    bounded = date_from is not None or date_to is not None
    for name in sorted(os.listdir(log_dir)):
        path = os.path.join(log_dir, name)
        if name.startswith("date=") and os.path.isdir(path):
            day = name[len("date="):]
            if date_from is not None and day < date_from:
                continue
            if date_to is not None and day > date_to:
                continue
            out.extend(sorted(
                os.path.join(path, f) for f in os.listdir(path)
                if f.endswith(".jsonl")))
        elif name.endswith(".jsonl") and not bounded:
            out.append(path)   # legacy flat layout
    return out


class DevNullHistoryLoggingService(HistoryLoggingService):
    def __init__(self, conf: Any = None):
        pass

    def handle(self, event: HistoryEvent) -> None:
        pass


class HistoryEventHandler:
    """Fans history events out to the logging service and recovery journal.

    Reference: HistoryEventHandler.java:46.
    """

    def __init__(self, logging_service: HistoryLoggingService,
                 recovery_service: "Any | None" = None,
                 conf: "Any | None" = None):
        self.logging_service = logging_service
        self.recovery_service = recovery_service
        # master switch + per-DAG switch (reference: HistoryEventHandler
        # .shouldLogEvent — TEZ_AM_HISTORY_LOGGING_ENABLED /
        # TEZ_DAG_HISTORY_LOGGING_ENABLED; recovery journaling is NOT
        # affected, only the logging service)
        self.am_logging_enabled = bool(conf.get(
            "tez.am.history.logging.enabled", True)) if conf else True
        self._dag_logging_disabled: "set[str]" = set()

    def set_dag_conf(self, dag_id: Any, dag_conf: Any) -> None:
        """Record the per-DAG logging switch at submission."""
        if dag_conf is not None and not bool(dag_conf.get(
                "tez.dag.history.logging.enabled", True)):
            self._dag_logging_disabled.add(str(dag_id))

    def handle(self, event: HistoryEvent) -> None:
        if self.recovery_service is not None:
            self.recovery_service.handle(event)
        dag_id = getattr(event, "dag_id", None) or \
            (event.data.get("dag_id") if isinstance(
                getattr(event, "data", None), dict) else None)
        suppressed = dag_id is not None and \
            str(dag_id) in self._dag_logging_disabled
        # DAG over: drop its switch so a session AM serving many DAGs
        # doesn't accumulate entries forever — BEFORE the master-switch
        # early return, which otherwise leaks one entry per DAG when
        # am_logging_enabled is off
        if suppressed and event.event_type is HistoryEventType.DAG_FINISHED:
            self._dag_logging_disabled.discard(str(dag_id))
        if not self.am_logging_enabled or suppressed:
            return
        self.logging_service.handle(event)

    @staticmethod
    def create_logging_service(conf: Any,
                               app_id: str = "") -> HistoryLoggingService:
        cls_name = conf.get("tez.history.logging.service.class") if conf else None
        if not cls_name:
            return InMemoryHistoryLoggingService()
        cls = resolve_class(cls_name)
        try:
            return cls(conf, app_id=app_id)
        except TypeError:
            return cls(conf)   # custom services with a conf-only signature
