"""Event-sourced recovery journal.

Reference parity: tez-dag/.../history/recovery/RecoveryService.java:53 (per-DAG
journal + synchronously-flushed summary events) and app/RecoveryParser.java:89
(replay: completed work short-circuited, in-flight work re-run, commit-in-
flight without completion => DAG failed).

Journal layout: <staging>/<app_id>/recovery/<attempt>/journal.jsonl.

The port's copy of tez_tpu.am.recovery: the journal (RecoveryService, the
line codec, the encoders of task-generated events); replay (RecoveryParser,
AM attempt > 1, and the decoders it needs) raises NotImplementedError until
it is ported.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import zlib
from typing import Any, Dict

from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
from tez_tpu_torch.common import clock, config as C
from tez_tpu_torch.common import faults

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


class RecoveryParser:
    """Replay of a journal for AM attempt > 1 (reference:
    RecoveryParser.parseRecoveryData:658): not ported yet."""

    def __init__(self, staging_dir: str, app_id: str):
        raise NotImplementedError(
            "AM recovery (RecoveryParser, attempt > 1) is not ported yet")
