"""Event-sourced recovery journal.

Reference parity: tez-dag/.../history/recovery/RecoveryService.java:53 (per-DAG
journal + synchronously-flushed summary events) and app/RecoveryParser.java:89
(replay: completed work short-circuited, in-flight work re-run, commit-in-
flight without completion => DAG failed).

Journal layout: <staging>/<app_id>/recovery/<attempt>/journal.jsonl.

The port's copy of tez_tpu.am.recovery: the journal and its replay.  Every
journaled payload is host data (ShufflePayload fields, bytes, JSON values):
the port's outputs put no tensor into an event, so no CUDA tensor reaches
the journal, and a pickled payload replays only under
tez.dag.recovery.trusted-staging.  ``stream_records`` replays a stream's
window ledger for the AM's stream resume.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Set

from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
from tez_tpu_torch.common import clock, config as C
from tez_tpu_torch.common import faults
from tez_tpu_torch.dag.plan import DAGPlan

log = logging.getLogger(__name__)

#: Commit-ledger records: the write-ahead log of the DAG commit protocol.
#: STARTED is fsync'd BEFORE any committer mutates the filesystem;
#: FINISHED/ABORTED are fsync'd before the DAG reaches its terminal record.
COMMIT_LEDGER_TYPES = frozenset({
    HistoryEventType.DAG_COMMIT_STARTED,
    HistoryEventType.DAG_COMMIT_FINISHED,
    HistoryEventType.DAG_COMMIT_ABORTED,
    # streaming window ledger (am/streaming.py): the per-window analog of
    # the DAG commit WAL — STARTED fsync'd before the committer touches
    # the output dir, FINISHED/ABORTED before the stream advances, so the
    # commit.ledger.fsync fault point crashes streams mid-commit exactly
    # like batch DAGs
    HistoryEventType.WINDOW_COMMIT_STARTED,
    HistoryEventType.WINDOW_COMMIT_FINISHED,
    HistoryEventType.WINDOW_COMMIT_ABORTED,
})


class JournalLineError(ValueError):
    """A journal line failed CRC validation or JSON/event decoding."""


def encode_journal_line(event: HistoryEvent) -> str:
    """`crc32-hex SP json` — the CRC covers the JSON bytes so a torn or
    bit-flipped record is detected instead of silently replayed."""
    payload = event.to_json()
    crc = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    return "%08x %s" % (crc, payload)


def decode_journal_line(line: str) -> HistoryEvent:
    """Inverse of encode_journal_line.  Legacy raw-JSON lines (pre-CRC
    journals) decode too.  Raises JournalLineError on corruption."""
    if line.startswith("{"):
        try:
            return HistoryEvent.from_json(line)
        except Exception as e:  # noqa: BLE001
            raise JournalLineError(f"bad legacy record: {e}") from e
    if len(line) < 10 or line[8] != " ":
        raise JournalLineError("malformed record framing")
    try:
        want = int(line[:8], 16)
    except ValueError as e:
        raise JournalLineError("malformed CRC prefix") from e
    payload = line[9:]
    got = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    if got != want:
        raise JournalLineError(
            f"CRC mismatch (recorded {want:08x}, computed {got:08x})")
    try:
        return HistoryEvent.from_json(payload)
    except Exception as e:  # noqa: BLE001
        raise JournalLineError(f"bad event JSON: {e}") from e


class RecoveryService:
    """Append-only journal of history events (summary events fsync'd)."""

    def __init__(self, ctx: Any, attempt: int = 1):
        self.ctx = ctx
        self.attempt = attempt
        staging = ctx.conf.get(C.STAGING_DIR)
        self.dir = os.path.join(staging, ctx.app_id, "recovery", str(attempt))
        self._fh = None
        #: non-summary events flush at most this often WHILE EVENTS FLOW
        #: (the check runs on each handle(); a quiet journal flushes on the
        #: next event or stop()).  Summary events always fsync immediately.
        #: (reference: tez.dag.recovery.flush.interval.secs,
        #: RecoveryService.java maxUnflushedEvents/flushInterval)
        self.flush_interval = float(
            ctx.conf.get(C.DAG_RECOVERY_FLUSH_INTERVAL_SECS) or 0)
        self._last_flush = 0.0
        # appenders are no longer single-threaded: the dispatcher,
        # admission threads AND every resident stream driver journal
        # through here — unserialized writes interleave records mid-line
        self._write_lock = threading.Lock()

    def start(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        self._fh = open(os.path.join(self.dir, "journal.jsonl"), "a")
        self._last_flush = clock.wall_s()

    def handle(self, event: HistoryEvent) -> None:
        if self._fh is None:
            return
        faults.fire("am.recovery.append", detail=event.event_type.name)
        if event.is_summary and event.event_type in COMMIT_LEDGER_TYPES:
            # fail mode here IS the mid-commit AM crash: the ledger
            # record may or may not have reached disk, and recovery
            # must cope with either
            faults.fire("commit.ledger.fsync",
                        detail=event.event_type.name)
        fd = None
        with self._write_lock:
            if self._fh is None:  # lost a race with stop()
                return
            self._fh.write(encode_journal_line(event) + "\n")
            if event.is_summary:
                # flush under the lock (it drains the shared buffer in
                # write order); the fsync happens OUTSIDE it so bulk task
                # events never queue behind a disk barrier — the kernel
                # syncs everything flushed so far, which includes ours
                self._fh.flush()
                fd = self._fh.fileno()
                self._last_flush = clock.wall_s()
            elif self.flush_interval > 0:
                now = clock.wall_s()
                if now - self._last_flush >= self.flush_interval:
                    self._fh.flush()
                    self._last_flush = now
        if fd is not None:
            faults.fire("am.recovery.fsync", detail=event.event_type.name)
            from tez_tpu_torch.common import metrics, tracing
            t0 = time.perf_counter()
            try:
                os.fsync(fd)
            except OSError:      # raced stop(); the flush already landed
                pass
            fsync_ms = (time.perf_counter() - t0) * 1000.0
            metrics.observe("commit.ledger.fsync", fsync_ms)
            if event.event_type in COMMIT_LEDGER_TYPES:
                tracing.event("commit.ledger.fsync",
                              record=event.event_type.name,
                              dag_id=event.dag_id, ms=round(fsync_ms, 3))

    def stop(self) -> None:
        with self._write_lock:
            if self._fh is not None:
                self._fh.flush()
                self._fh.close()
                self._fh = None


@dataclasses.dataclass
class DAGRecoveryData:
    """What the parser reconstructs for the new AM attempt."""
    dag_id: str
    plan: Optional[DAGPlan]
    dag_state: Optional[str]                  # terminal state if finished
    commit_in_flight: bool
    completed_vertices: Dict[str, Dict[str, Any]]   # vertex name -> finish data
    succeeded_tasks: Set[str]                 # task id strings
    events: List[HistoryEvent]
    # Commit-ledger state at crash time: None (commit never started),
    # "STARTED" (in the mutation window — roll forward or abort per
    # tez.am.commit.recovery.policy), "FINISHED" (committers completed; only
    # the terminal DAG record was lost — roll forward to SUCCEEDED),
    # "ABORTED" (partial commit rolled back — DAG is FAILED).
    commit_state: Optional[str] = None
    # task id string -> {"attempt": attempt id str, "generated_events": wire,
    # "counters": dict} — only for tasks whose final state was SUCCEEDED and
    # whose successful attempt journaled its generated events.
    task_data: Dict[str, Dict[str, Any]] = dataclasses.field(default_factory=dict)
    # vertex name -> num_tasks at crash time (last INITIALIZED/CONFIGURE_DONE);
    # a vertex is only short-circuitable when its new parallelism matches.
    vertex_num_tasks: Dict[str, int] = dataclasses.field(default_factory=dict)
    # vertex names whose per-vertex commit finished before the crash
    # (VERTEX_COMMIT_STARTED followed by that vertex's VERTEX_FINISHED) —
    # recovery must not commit them a second time.
    committed_vertices: Set[str] = dataclasses.field(default_factory=set)
    # vertex name -> journaled reconfiguration ({"parallelism": n, "edges":
    # {src: {"class_name", "payload"}}}) from the last VERTEX_CONFIGURE_DONE
    # that carried one; the recovering AM re-applies it so the vertex's
    # completed tasks stay restorable (RecoveryParser.java:658 semantics).
    vertex_reconfig: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)


# ---------------------------------------------------------------------------
# Wire (de)serialization of task-generated events for the journal.
# Reference: TaskAttemptFinishedEvent carries taGeneratedEvents so a new AM
# attempt can re-route completed producers' DataMovementEvents without
# re-running the tasks (RecoveryParser.parseRecoveryData:658).
# ---------------------------------------------------------------------------

def _payload_to_wire(p: Any) -> Any:
    from tez_tpu_torch.api.events import ShufflePayload
    if p is None:
        return None
    if isinstance(p, ShufflePayload):
        d = dataclasses.asdict(p)
        ep = d.get("empty_partitions")
        d["empty_partitions"] = ep.hex() if ep is not None else None
        return {"__kind__": "shuffle", **d}
    if isinstance(p, (bytes, bytearray)):
        return {"__kind__": "bytes", "hex": bytes(p).hex()}
    if isinstance(p, (dict, list, str, int, float, bool)):
        return {"__kind__": "json", "value": p}
    import pickle
    return {"__kind__": "pickle", "hex": pickle.dumps(p).hex()}


def _payload_from_wire(w: Any, allow_pickle: bool = False) -> Any:
    from tez_tpu_torch.api.events import ShufflePayload
    if w is None:
        return None
    kind = w.get("__kind__")
    if kind == "shuffle":
        d = {k: v for k, v in w.items() if k != "__kind__"}
        ep = d.get("empty_partitions")
        d["empty_partitions"] = bytes.fromhex(ep) if ep else None
        return ShufflePayload(**d)
    if kind == "bytes":
        return bytes.fromhex(w["hex"])
    if kind == "json":
        return w["value"]
    if not allow_pickle:
        # the journal lives in the shared staging dir: unpickling it hands
        # code execution to anyone with write access there.  The framework's
        # own events all use the typed kinds above; arbitrary payloads only
        # replay under the explicit tez.dag.recovery.trusted-staging opt-in.
        raise UntrustedJournalPayload(
            f"journal payload kind {kind!r} requires pickle; set "
            f"tez.dag.recovery.trusted-staging=true to replay it")
    import pickle
    return pickle.loads(bytes.fromhex(w["hex"]))


def event_to_wire(ev: Any) -> Dict[str, Any]:
    from tez_tpu_torch.api.events import (CompositeDataMovementEvent,
                                          DataMovementEvent)
    if isinstance(ev, DataMovementEvent):
        return {"t": "DME", "source_index": ev.source_index,
                "version": ev.version,
                "payload": _payload_to_wire(ev.user_payload)}
    if isinstance(ev, CompositeDataMovementEvent):
        return {"t": "CDME", "source_index_start": ev.source_index_start,
                "count": ev.count, "version": ev.version,
                "payload": _payload_to_wire(ev.user_payload)}
    import pickle
    return {"t": "pickle", "hex": pickle.dumps(ev).hex()}


class UntrustedJournalPayload(RuntimeError):
    """A journaled event/payload needs pickle to decode but the staging dir
    is not trusted (tez.dag.recovery.trusted-staging unset)."""


def event_from_wire(w: Dict[str, Any], allow_pickle: bool = False) -> Any:
    from tez_tpu_torch.api.events import (CompositeDataMovementEvent,
                                    DataMovementEvent)
    t = w["t"]
    if t == "DME":
        return DataMovementEvent(
            source_index=w["source_index"],
            user_payload=_payload_from_wire(w["payload"], allow_pickle),
            version=w["version"])
    if t == "CDME":
        return CompositeDataMovementEvent(
            source_index_start=w["source_index_start"], count=w["count"],
            user_payload=_payload_from_wire(w["payload"], allow_pickle),
            version=w["version"])
    if not allow_pickle:
        raise UntrustedJournalPayload(
            f"journal event kind {t!r} requires pickle; set "
            f"tez.dag.recovery.trusted-staging=true to replay it")
    import pickle
    return pickle.loads(bytes.fromhex(w["hex"]))


class RecoveryParser:
    """Reference: RecoveryParser.parseRecoveryData:658."""

    def __init__(self, staging_dir: str, app_id: str):
        self.base = os.path.join(staging_dir, app_id, "recovery")

    def journal_files(self) -> List[str]:
        if not os.path.isdir(self.base):
            return []
        out = []
        for attempt in sorted(os.listdir(self.base), key=lambda s: int(s)):
            p = os.path.join(self.base, attempt, "journal.jsonl")
            if os.path.exists(p):
                out.append(p)
        return out

    def read_events(self) -> List[HistoryEvent]:
        """Decode every journal record across all attempts.  A corrupt LAST
        line of the LAST journal is a torn tail write (the AM died mid-
        append) — tolerated quietly; corruption anywhere else means the
        journal was damaged at rest and is logged loudly."""
        events: List[HistoryEvent] = []
        files = self.journal_files()
        for fi, path in enumerate(files):
            # lenient decode: a crash can tear the tail mid-byte, and the
            # CRC frame (not the codec) is what rejects mangled records
            with open(path, errors="replace") as fh:
                lines = [ln.strip() for ln in fh]
            while lines and not lines[-1]:
                lines.pop()
            for li, line in enumerate(lines):
                if not line:
                    continue
                try:
                    events.append(decode_journal_line(line))
                except JournalLineError as e:
                    if fi == len(files) - 1 and li == len(lines) - 1:
                        log.info("tolerating torn trailing journal record "
                                 "in %s: %s", path, e)
                    else:
                        log.warning("skipping corrupt journal record "
                                    "(%s line %d): %s", path, li + 1, e)
        return events

    def parse(self) -> Optional[DAGRecoveryData]:
        """Returns recovery data for the last in-progress DAG, or None when
        there is nothing to recover (no DAG, or last DAG finished)."""
        all_dags = self.parse_all()
        return all_dags[-1] if all_dags else None

    def parse_all(self) -> List[DAGRecoveryData]:
        """Recovery data for EVERY submitted DAG, in submit order.  The
        resident session AM recovers all of them: finished DAGs roll
        forward to their terminal record, in-flight ones are resubmitted
        (docs/recovery.md)."""
        events = self.read_events()
        submitted: List[str] = []               # dag ids in submit order
        plans: Dict[str, Optional[DAGPlan]] = {}
        for ev in events:
            if ev.event_type is HistoryEventType.DAG_SUBMITTED:
                if ev.dag_id not in plans:
                    submitted.append(ev.dag_id)
                raw = ev.data.get("plan")
                plans[ev.dag_id] = \
                    DAGPlan.deserialize(bytes.fromhex(raw)) if raw else None
        return [self._parse_dag(dag_id, plans[dag_id], events)
                for dag_id in submitted]

    def queued_submissions(self) -> List[Dict[str, Any]]:
        """Unresolved admission-queue records, in arrival order.

        A ``DAG_QUEUED`` (or a successor attempt's
        ``DAG_REQUEUED_ON_RECOVERY``) record is resolved by a later
        ``DAG_SUBMITTED`` stamped with its ``sub_id`` — the promotion.  A
        record with no promotion is a submission the dead AM accepted but
        never started (parked in the queue OR popped by the consumer and
        lost mid-promote — the ``am.queue.delay`` window); the successor
        incarnation must replay it.  Each entry:
        ``{"sub_id", "dag_name", "tenant", "plan" (hex str or None),
        "decode_error" (str or "")}``.
        """
        events = self.read_events()
        queued: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        for ev in events:
            t = ev.event_type
            if t in (HistoryEventType.DAG_QUEUED,
                     HistoryEventType.DAG_REQUEUED_ON_RECOVERY):
                sub_id = ev.dag_id
                if sub_id not in queued:
                    order.append(sub_id)
                # latest record wins: a requeue carries the plan again, so
                # a second crash replays from it
                queued[sub_id] = {
                    "sub_id": sub_id,
                    "dag_name": ev.data.get("dag_name", ""),
                    "tenant": ev.data.get("tenant", ""),
                    "plan": ev.data.get("plan"),
                    "decode_error": "",
                }
            elif t is HistoryEventType.DAG_SUBMITTED:
                sub_id = ev.data.get("sub_id")
                if sub_id:
                    queued.pop(sub_id, None)
        out = []
        for sub_id in order:
            rec = queued.get(sub_id)
            if rec is None:
                continue
            raw = rec["plan"]
            if raw:
                try:
                    DAGPlan.deserialize(bytes.fromhex(raw))
                except Exception as e:  # noqa: BLE001 — flagged, not fatal
                    rec["decode_error"] = repr(e)
            else:
                rec["decode_error"] = "queued record carries no plan"
            out.append(rec)
        return out

    def stream_records(self) -> Dict[str, Dict[str, Any]]:
        """Streaming recovery state, per stream id (docs/streaming.md).

        Replays the window-commit ledger: a window with a
        ``WINDOW_COMMIT_FINISHED`` record is sealed forever (a successor
        AM serves it from disk, never re-runs it); the first window
        after ``last_committed`` is where the resumed stream picks up.
        Each value::

            {"spec": <STREAM_OPENED data>, "retired": bool,
             "committed": set[int], "aborted": set[int],
             "open_started": set[int],   # STARTED with no FINISHED/ABORTED
             "last_committed": int}
        """
        out: Dict[str, Dict[str, Any]] = {}

        def rec(stream: str) -> Dict[str, Any]:
            if stream not in out:
                out[stream] = {"spec": None, "retired": False,
                               "committed": set(), "aborted": set(),
                               "open_started": set(), "last_committed": 0}
            return out[stream]

        for ev in self.read_events():
            t = ev.event_type
            if t is HistoryEventType.STREAM_OPENED:
                r = rec(ev.data.get("stream", ""))
                r["spec"] = dict(ev.data)
            elif t is HistoryEventType.STREAM_RETIRED:
                rec(ev.data.get("stream", ""))["retired"] = True
            elif t in (HistoryEventType.WINDOW_COMMIT_STARTED,
                       HistoryEventType.WINDOW_COMMIT_FINISHED,
                       HistoryEventType.WINDOW_COMMIT_ABORTED):
                r = rec(ev.data.get("stream", ""))
                w = int(ev.data.get("window_id", 0))
                if t is HistoryEventType.WINDOW_COMMIT_STARTED:
                    r["open_started"].add(w)
                elif t is HistoryEventType.WINDOW_COMMIT_FINISHED:
                    r["open_started"].discard(w)
                    r["committed"].add(w)
                    r["last_committed"] = max(r["last_committed"], w)
                else:
                    r["open_started"].discard(w)
                    r["aborted"].add(w)
        return out

    def _parse_dag(self, dag_id: str, plan: Optional[DAGPlan],
                   events: List[HistoryEvent]) -> DAGRecoveryData:
        dag_events = [e for e in events if e.dag_id == dag_id]
        dag_state = None
        commit_state: Optional[str] = None
        # per-vertex commits are in flight only until that vertex's
        # VERTEX_FINISHED lands — a long-finished vertex commit must not
        # poison recovery of a DAG that crashed hours later
        pending_vertex_commits: Set[str] = set()
        pending_group_commits: Set[str] = set()
        committed_vertices: Set[str] = set()
        vertex_reconfig: Dict[str, Dict[str, Any]] = {}
        completed_vertices: Dict[str, Dict[str, Any]] = {}
        attempt_records: Dict[str, Dict[str, Any]] = {}  # attempt id -> data
        task_last: Dict[str, Dict[str, Any]] = {}        # task id -> last finish
        vertex_num_tasks: Dict[str, int] = {}
        for ev in dag_events:
            t = ev.event_type
            if t is HistoryEventType.DAG_FINISHED:
                dag_state = ev.data.get("state")
            elif t is HistoryEventType.DAG_COMMIT_STARTED:
                commit_state = "STARTED"
            elif t is HistoryEventType.DAG_COMMIT_FINISHED:
                commit_state = "FINISHED"
            elif t is HistoryEventType.DAG_COMMIT_ABORTED:
                commit_state = "ABORTED"
            elif t is HistoryEventType.VERTEX_COMMIT_STARTED:
                pending_vertex_commits.add(ev.vertex_id)
            elif t is HistoryEventType.VERTEX_GROUP_COMMIT_STARTED:
                pending_group_commits.add(ev.data.get("group", ""))
            elif t is HistoryEventType.VERTEX_GROUP_COMMIT_FINISHED:
                pending_group_commits.discard(ev.data.get("group", ""))
            elif t is HistoryEventType.VERTEX_FINISHED:
                if ev.vertex_id in pending_vertex_commits and \
                        ev.data.get("state") == "SUCCEEDED":
                    committed_vertices.add(ev.data.get("vertex_name"))
                pending_vertex_commits.discard(ev.vertex_id)
                if ev.data.get("state") == "SUCCEEDED":
                    completed_vertices[ev.data.get("vertex_name")] = ev.data
            elif t in (HistoryEventType.VERTEX_INITIALIZED,
                       HistoryEventType.VERTEX_CONFIGURE_DONE):
                name = ev.data.get("vertex_name")
                n = ev.data.get("num_tasks")
                if name is not None and n is not None:
                    vertex_num_tasks[name] = n
                if name is not None and ev.data.get("reconfig") is not None:
                    vertex_reconfig[name] = ev.data["reconfig"]
            elif t is HistoryEventType.TASK_ATTEMPT_FINISHED and \
                    ev.data.get("state") == "SUCCEEDED":
                attempt_records[ev.attempt_id] = ev.data
            elif t is HistoryEventType.TASK_FINISHED:
                task_last[ev.task_id] = ev.data    # last record wins: a task
                # re-run after output loss journals a second TASK_FINISHED
        succeeded_tasks: Set[str] = set()
        task_data: Dict[str, Dict[str, Any]] = {}
        for tid, td in task_last.items():
            if td.get("state") != "SUCCEEDED":
                continue
            succeeded_tasks.add(tid)
            att_id = td.get("successful_attempt")
            att = attempt_records.get(att_id) if att_id else None
            if att is None:
                continue
            task_data[tid] = {
                "attempt": att_id,
                "generated_events": att.get("generated_events", []),
                "counters": att.get("counters", {}),
            }
        return DAGRecoveryData(
            dag_id=dag_id, plan=plan, dag_state=dag_state,
            commit_in_flight=(commit_state == "STARTED"
                              or bool(pending_vertex_commits)
                              or bool(pending_group_commits))
            and dag_state is None,
            commit_state=commit_state if dag_state is None else None,
            completed_vertices=completed_vertices,
            succeeded_tasks=succeeded_tasks, events=dag_events,
            task_data=task_data, vertex_num_tasks=vertex_num_tasks,
            committed_vertices=committed_vertices,
            vertex_reconfig=vertex_reconfig)
