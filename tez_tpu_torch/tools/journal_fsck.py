"""Recovery-journal fsck: validate a journal's record CRCs, event ordering,
commit-ledger pairing, admission-queue pairing (``DAG_QUEUED`` /
``DAG_REQUEUED_ON_RECOVERY`` records resolved by a promoting
``DAG_SUBMITTED``), and the streaming window-commit ledger
(``WINDOW_COMMIT_STARTED`` brackets closed by FINISHED/ABORTED, window
ids strictly increasing per stream, nothing after ``STREAM_RETIRED``),
and the SLO records (``SLO_BURN_ALERT`` / ``TENANT_SLO_BREACH`` must
carry the tenant/kind labels doctor joins on; ``TELEMETRY_SNAPSHOT``
accounting must be non-negative), then print the terminal state recovery
would infer for each DAG, each still-parked submission, and each stream,
plus the per-(tenant, kind, stream) SLO tally.

Point it at one or more journal files, at an app's ``recovery/`` directory
(all attempts are checked in order), or at a staging dir + app id::

    python -m tez_tpu_torch.tools.journal_fsck <journal.jsonl | recovery-dir> ...
    python -m tez_tpu_torch.tools.journal_fsck --staging /path/staging --app app_x

Exit code 0 means the journal is consistent (a torn trailing record — the
AM died mid-append — is tolerated, exactly as recovery tolerates it);
1 means structural damage or ledger violations; 2 means no journal found.
The chaos harness runs this on every divergent trial so a corrupt-journal
root cause is distinguished from a replay bug.

The port's copy of tez_tpu.tools.journal_fsck, over the port's journal
codec and DAGPlan.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple

from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
from tez_tpu_torch.am.recovery import JournalLineError, decode_journal_line
from tez_tpu_torch.dag.plan import DAGPlan

#: Events whose arrival after a DAG's terminal record is a bug (lifecycle
#: and ledger records; incidental events like NODE_BLACKLISTED may straggle).
_LIFECYCLE = frozenset({
    HistoryEventType.DAG_SUBMITTED, HistoryEventType.DAG_INITIALIZED,
    HistoryEventType.DAG_STARTED, HistoryEventType.DAG_COMMIT_STARTED,
    HistoryEventType.DAG_COMMIT_FINISHED, HistoryEventType.DAG_COMMIT_ABORTED,
    HistoryEventType.DAG_FINISHED,
})

#: Admission-queue records: the ``dag_id`` slot carries the submission id,
#: not a DAG id — they must never materialize a phantom DAG ledger.
_ADMISSION = frozenset({
    HistoryEventType.DAG_QUEUED,
    HistoryEventType.DAG_REQUEUED_ON_RECOVERY,
})

#: Streaming records: keyed by ``data["stream"]``, checked against the
#: per-stream window ledger (a window DAG's own records still flow into
#: its DagLedger like any DAG's — these are the STREAM-level brackets).
_STREAMING = frozenset({
    HistoryEventType.STREAM_OPENED,
    HistoryEventType.STREAM_RETIRED,
    HistoryEventType.WINDOW_COMMIT_STARTED,
    HistoryEventType.WINDOW_COMMIT_FINISHED,
    HistoryEventType.WINDOW_COMMIT_ABORTED,
    HistoryEventType.WINDOW_LAGGING,
})

#: SLO / telemetry records: session-scoped (``dag_id`` is None), keyed by
#: their (tenant, kind, stream) label triple.  The labels are load-bearing:
#: doctor joins a burn alert to the breach that followed it per stream, so
#: a record missing them is a structural error, not cosmetics.
_SLO = frozenset({
    HistoryEventType.TENANT_SLO_BREACH,
    HistoryEventType.SLO_BURN_ALERT,
})


@dataclasses.dataclass
class DagLedger:
    """Per-DAG fsck state."""
    submitted: bool = False
    commit_state: Optional[str] = None      # None/STARTED/FINISHED/ABORTED
    terminal: Optional[str] = None          # DAG_FINISHED state, if journaled
    events: int = 0

    @property
    def inferred_terminal(self) -> str:
        """What recovery would conclude for this DAG."""
        if self.terminal is not None:
            return self.terminal
        if self.commit_state == "FINISHED":
            return "SUCCEEDED (ledger roll-forward)"
        if self.commit_state == "ABORTED":
            return "FAILED (ledger rollback)"
        if self.commit_state == "STARTED":
            return "IN-COMMIT (policy decides: resume or fail)"
        return "IN-FLIGHT (resubmit with task short-circuit)"


@dataclasses.dataclass
class SubLedger:
    """Per-submission admission ledger: a ``DAG_QUEUED`` (and any successor
    ``DAG_REQUEUED_ON_RECOVERY``) record is closed by the ``DAG_SUBMITTED``
    stamped with the same ``sub_id`` — exactly the pairing discipline the
    commit ledger gets."""
    queued: int = 0
    requeued: int = 0
    promoted: bool = False
    dag_name: str = ""
    decode_error: str = ""

    @property
    def inferred(self) -> str:
        """What recovery would conclude for this submission."""
        if self.promoted:
            return "PROMOTED"
        if self.decode_error:
            return f"LOST (plan undecodable: {self.decode_error})"
        return "UNRESOLVED (successor AM must replay)"


@dataclasses.dataclass
class StreamLedger:
    """Per-stream window-commit ledger: every ``WINDOW_COMMIT_STARTED``
    bracket must close (FINISHED or ABORTED), a window is FINISHED at
    most once (exactly-once), committed ids are strictly increasing
    (windows run sequentially), and nothing follows ``STREAM_RETIRED``."""
    opened: bool = False
    retired: bool = False
    open_window: Optional[int] = None       # STARTED with no close yet
    committed: List[int] = dataclasses.field(default_factory=list)
    aborted: List[int] = dataclasses.field(default_factory=list)
    lag_events: int = 0

    @property
    def inferred(self) -> str:
        """What a resuming StreamDriver would conclude."""
        if self.retired:
            return f"RETIRED ({len(self.committed)} window(s) committed)"
        if self.open_window is not None:
            return (f"IN-COMMIT w{self.open_window} (successor rolls the "
                    f"idempotent bracket forward)")
        nxt = (self.committed[-1] + 1) if self.committed else 1
        return f"LIVE (resume from window {nxt})"


@dataclasses.dataclass
class FsckReport:
    files: List[str] = dataclasses.field(default_factory=list)
    records: int = 0
    errors: List[str] = dataclasses.field(default_factory=list)
    warnings: List[str] = dataclasses.field(default_factory=list)
    torn_tail: bool = False
    dags: Dict[str, DagLedger] = dataclasses.field(default_factory=dict)
    subs: Dict[str, SubLedger] = dataclasses.field(default_factory=dict)
    sub_order: List[str] = dataclasses.field(default_factory=list)
    streams: Dict[str, StreamLedger] = dataclasses.field(default_factory=dict)
    #: (tenant, kind, stream) -> {"burn_alerts": n, "breaches": n}
    slo: Dict[Tuple[str, str, str], Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    telemetry_snapshots: int = 0

    @property
    def ok(self) -> bool:
        return not self.errors


def _check_admission(report: FsckReport, ev: HistoryEvent,
                     where: str) -> bool:
    """Admission-queue pairing.  Returns True when the event was a queue
    record (consumed here, never a DAG-ledger record)."""
    t = ev.event_type
    if t in _ADMISSION:
        sub_id = ev.dag_id or ""
        if not sub_id:
            report.errors.append(f"{where}: {t.name} without a sub_id")
            return True
        led = report.subs.get(sub_id)
        if led is None:
            led = report.subs[sub_id] = SubLedger()
            report.sub_order.append(sub_id)
        if t is HistoryEventType.DAG_QUEUED:
            if led.queued:
                report.errors.append(
                    f"{where}: duplicate DAG_QUEUED for {sub_id}")
            if led.requeued:
                report.errors.append(
                    f"{where}: DAG_QUEUED for {sub_id} after a "
                    f"DAG_REQUEUED_ON_RECOVERY (attempt order violated)")
            led.queued += 1
        else:
            if not led.queued:
                report.errors.append(
                    f"{where}: DAG_REQUEUED_ON_RECOVERY for {sub_id} that "
                    f"was never DAG_QUEUED")
            led.requeued += 1
        if led.promoted:
            report.errors.append(
                f"{where}: {t.name} for {sub_id} after its promotion "
                f"(DAG_SUBMITTED already resolved it)")
        led.dag_name = ev.data.get("dag_name", "") or led.dag_name
        raw = ev.data.get("plan")
        if raw:
            try:
                DAGPlan.deserialize(bytes.fromhex(raw))
                led.decode_error = ""
            except Exception as e:  # noqa: BLE001 — flagged, not fatal here
                led.decode_error = repr(e)
        else:
            led.decode_error = "queued record carries no plan"
        return True
    if t is HistoryEventType.DAG_SUBMITTED:
        sub_id = ev.data.get("sub_id")
        if sub_id:
            led = report.subs.get(sub_id)
            if led is None:
                report.errors.append(
                    f"{where}: DAG_SUBMITTED resolves sub_id {sub_id} that "
                    f"was never DAG_QUEUED")
            elif led.promoted:
                report.errors.append(
                    f"{where}: duplicate promotion of {sub_id}")
            else:
                led.promoted = True
    return False


def _check_streaming(report: FsckReport, ev: HistoryEvent,
                     where: str) -> bool:
    """Window-commit ledger pairing.  Returns True when the event was a
    stream-level record (consumed here; a window DAG's OWN lifecycle
    records still flow to its DagLedger)."""
    t = ev.event_type
    if t not in _STREAMING:
        return False
    stream = ev.data.get("stream", "")
    if not stream:
        report.errors.append(f"{where}: {t.name} without a stream id")
        return True
    led = report.streams.setdefault(stream, StreamLedger())
    if led.retired and t is not HistoryEventType.STREAM_OPENED:
        report.errors.append(
            f"{where}: {t.name} for stream {stream} after STREAM_RETIRED")
        return True
    if t is HistoryEventType.STREAM_OPENED:
        if led.opened:
            report.errors.append(
                f"{where}: duplicate STREAM_OPENED for {stream}")
        led.opened = True
        return True
    if not led.opened:
        report.errors.append(
            f"{where}: {t.name} for stream {stream} that was never "
            f"STREAM_OPENED")
    if t is HistoryEventType.STREAM_RETIRED:
        if led.open_window is not None:
            report.errors.append(
                f"{where}: STREAM_RETIRED for {stream} with commit bracket "
                f"w{led.open_window} still open")
        led.retired = True
    elif t is HistoryEventType.WINDOW_LAGGING:
        led.lag_events += 1
    else:
        w = int(ev.data.get("window_id", 0))
        if w <= 0:
            report.errors.append(
                f"{where}: {t.name} for stream {stream} without a window id")
            return True
        if t is HistoryEventType.WINDOW_COMMIT_STARTED:
            if led.open_window == w:
                # the crash-mid-commit replay: the successor re-opens the
                # SAME window's bracket and rolls it forward (idempotent)
                report.warnings.append(
                    f"{where}: commit bracket w{w} of {stream} re-opened "
                    f"(roll-forward after AM crash)")
            elif led.open_window is not None:
                report.errors.append(
                    f"{where}: WINDOW_COMMIT_STARTED w{w} for {stream} with "
                    f"bracket w{led.open_window} still open")
            if w in led.committed:
                report.errors.append(
                    f"{where}: WINDOW_COMMIT_STARTED w{w} for {stream} "
                    f"after that window already committed (exactly-once "
                    f"violated)")
            elif w in led.aborted:
                report.warnings.append(
                    f"{where}: window w{w} of {stream} re-runs after an "
                    f"abort")
            led.open_window = w
        elif t is HistoryEventType.WINDOW_COMMIT_FINISHED:
            if led.open_window != w:
                report.errors.append(
                    f"{where}: WINDOW_COMMIT_FINISHED w{w} for {stream} "
                    f"without its open STARTED (bracket was "
                    f"{'w%d' % led.open_window if led.open_window else 'closed'})")
            if w in led.committed:
                report.errors.append(
                    f"{where}: duplicate WINDOW_COMMIT_FINISHED w{w} for "
                    f"{stream} (exactly-once violated)")
            elif led.committed and w <= led.committed[-1]:
                report.errors.append(
                    f"{where}: {stream} committed w{w} after "
                    f"w{led.committed[-1]} — window ids must be strictly "
                    f"increasing")
            led.committed.append(w)
            led.open_window = None
        else:   # WINDOW_COMMIT_ABORTED
            if led.open_window is not None and led.open_window != w:
                report.errors.append(
                    f"{where}: WINDOW_COMMIT_ABORTED w{w} for {stream} "
                    f"while bracket w{led.open_window} is open")
            led.aborted.append(w)
            led.open_window = None
    return True


def _check_slo(report: FsckReport, ev: HistoryEvent, where: str) -> bool:
    """SLO / telemetry accounting.  Returns True when the event was a
    session-scoped SLO or telemetry record (consumed here)."""
    t = ev.event_type
    if t is HistoryEventType.TELEMETRY_SNAPSHOT:
        report.telemetry_snapshots += 1
        for k in ("evicted", "collector_errors", "scrape_errors"):
            v = ev.data.get(k)
            if v is not None and int(v) < 0:
                report.errors.append(
                    f"{where}: TELEMETRY_SNAPSHOT with negative {k}={v}")
        return True
    if t not in _SLO:
        return False
    tenant = ev.data.get("tenant", "")
    kind = ev.data.get("kind", "")
    if not tenant or not kind:
        report.errors.append(
            f"{where}: {t.name} without tenant/kind labels "
            f"(doctor cannot join it per stream)")
        return True
    key = (tenant, kind, ev.data.get("stream") or "")
    led = report.slo.setdefault(key, {"burn_alerts": 0, "breaches": 0})
    if t is HistoryEventType.SLO_BURN_ALERT:
        led["burn_alerts"] += 1
    else:
        led["breaches"] += 1
    return True


def _check_event(report: FsckReport, ev: HistoryEvent, where: str) -> None:
    report.records += 1
    if _check_admission(report, ev, where):
        return
    if _check_streaming(report, ev, where):
        return
    if _check_slo(report, ev, where):
        return
    dag_id = ev.dag_id
    if dag_id is None:
        return
    led = report.dags.setdefault(dag_id, DagLedger())
    led.events += 1
    t = ev.event_type
    if led.terminal is not None and t in _LIFECYCLE:
        report.errors.append(
            f"{where}: {t.name} for {dag_id} after its terminal "
            f"DAG_FINISHED({led.terminal})")
        return
    if t is HistoryEventType.DAG_SUBMITTED:
        led.submitted = True
    elif not led.submitted and t in _LIFECYCLE:
        report.errors.append(
            f"{where}: {t.name} for {dag_id} before DAG_SUBMITTED")
    if t is HistoryEventType.DAG_COMMIT_STARTED:
        if led.commit_state == "STARTED":
            report.errors.append(
                f"{where}: duplicate DAG_COMMIT_STARTED for {dag_id}")
        elif led.commit_state in ("FINISHED", "ABORTED"):
            report.errors.append(
                f"{where}: DAG_COMMIT_STARTED for {dag_id} after ledger "
                f"already {led.commit_state}")
        led.commit_state = "STARTED"
    elif t is HistoryEventType.DAG_COMMIT_FINISHED:
        if led.commit_state != "STARTED":
            report.errors.append(
                f"{where}: DAG_COMMIT_FINISHED for {dag_id} without an open "
                f"DAG_COMMIT_STARTED (ledger was {led.commit_state})")
        led.commit_state = "FINISHED"
    elif t is HistoryEventType.DAG_COMMIT_ABORTED:
        if led.commit_state != "STARTED":
            report.errors.append(
                f"{where}: DAG_COMMIT_ABORTED for {dag_id} without an open "
                f"DAG_COMMIT_STARTED (ledger was {led.commit_state})")
        led.commit_state = "ABORTED"
    elif t is HistoryEventType.DAG_FINISHED:
        state = ev.data.get("state")
        led.terminal = state
        if state == "SUCCEEDED" and led.commit_state == "STARTED":
            report.errors.append(
                f"{where}: {dag_id} finished SUCCEEDED with commit ledger "
                f"still open (STARTED without FINISHED)")
        if state == "SUCCEEDED" and led.commit_state == "ABORTED":
            report.errors.append(
                f"{where}: {dag_id} finished SUCCEEDED after "
                f"DAG_COMMIT_ABORTED")


def fsck_files(paths: List[str]) -> FsckReport:
    """Validate journals in the given order (attempt order matters: the
    ledger threads across AM incarnations)."""
    report = FsckReport(files=list(paths))
    for fi, path in enumerate(paths):
        # a crash can tear the tail mid-byte, not just mid-line: decode
        # leniently and let the CRC check reject the mangled record
        with open(path, errors="replace") as fh:
            lines = [ln.strip() for ln in fh]
        while lines and not lines[-1]:
            lines.pop()
        for li, line in enumerate(lines):
            if not line:
                continue
            where = f"{os.path.basename(os.path.dirname(path))}/" \
                    f"{os.path.basename(path)}:{li + 1}"
            try:
                ev = decode_journal_line(line)
            except JournalLineError as e:
                # the tail of ANY attempt file is where that incarnation
                # died — a torn final record there is the expected crash
                # signature, not at-rest corruption
                if li == len(lines) - 1:
                    report.torn_tail = True
                    report.warnings.append(
                        f"{where}: torn trailing record (tolerated): {e}")
                else:
                    report.errors.append(f"{where}: corrupt record: {e}")
                continue
            _check_event(report, ev, where)
    # an undecodable plan on a still-parked record is lost work — the
    # successor AM can never replay it; on a promoted record it is merely
    # suspicious (the live plan object made it through)
    for sub_id, led in report.subs.items():
        if not led.decode_error:
            continue
        name = led.dag_name or "<unnamed>"
        if led.promoted:
            report.warnings.append(
                f"queued record {sub_id} ({name}): plan undecodable "
                f"(promoted anyway): {led.decode_error}")
        else:
            report.errors.append(
                f"unresolved queued submission {sub_id} ({name}): plan "
                f"undecodable — replay impossible: {led.decode_error}")
    # a trailing open window bracket is what an AM crash mid-commit
    # leaves; recovery rolls it forward (idempotent renames), so it is a
    # warning — but only on a LIVE stream, never a retired one
    for stream, sled in report.streams.items():
        if sled.open_window is not None and not sled.retired:
            report.warnings.append(
                f"stream {stream}: commit bracket w{sled.open_window} "
                f"still open (AM died mid-commit; successor rolls forward)")
    return report


def discover_journals(target: str) -> List[str]:
    """A journal file itself, or a directory scanned for per-attempt
    ``<n>/journal.jsonl`` children (an app's ``recovery/`` dir), sorted by
    attempt number."""
    if os.path.isfile(target):
        return [target]
    if not os.path.isdir(target):
        return []
    out: List[Tuple[int, str]] = []
    for name in os.listdir(target):
        p = os.path.join(target, name, "journal.jsonl")
        if os.path.isfile(p):
            try:
                out.append((int(name), p))
            except ValueError:
                out.append((1 << 30, p))
    direct = os.path.join(target, "journal.jsonl")
    if os.path.isfile(direct):
        out.append((0, direct))
    return [p for _, p in sorted(out)]


def print_report(report: FsckReport, verbose: bool = False) -> None:
    print(f"checked {len(report.files)} journal file(s), "
          f"{report.records} record(s)")
    for w in report.warnings:
        print(f"warn: {w}")
    for e in report.errors:
        print(f"ERROR: {e}")
    for dag_id, led in sorted(report.dags.items()):
        commit = led.commit_state or "none"
        print(f"dag {dag_id}: {led.events} record(s), commit-ledger={commit}"
              f" -> terminal: {led.inferred_terminal}")
    for sub_id in report.sub_order:
        sub = report.subs[sub_id]
        print(f"sub {sub_id} ({sub.dag_name or '<unnamed>'}): "
              f"queued={sub.queued} requeued={sub.requeued}"
              f" -> {sub.inferred}")
    for stream, sled in sorted(report.streams.items()):
        print(f"stream {stream}: {len(sled.committed)} committed, "
              f"{len(sled.aborted)} aborted, {sled.lag_events} lag "
              f"episode(s) -> {sled.inferred}")
    for (tenant, kind, stream), led in sorted(report.slo.items()):
        where = f" stream={stream}" if stream else ""
        print(f"slo tenant={tenant}{where} {kind}: "
              f"{led['burn_alerts']} burn alert(s), "
              f"{led['breaches']} breach(es)")
    if report.telemetry_snapshots:
        print(f"telemetry: {report.telemetry_snapshots} snapshot(s)")
    print("fsck: " + ("CLEAN" if report.ok else
                      f"{len(report.errors)} error(s)"))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tez_tpu_torch.tools.journal_fsck", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("targets", nargs="*",
                    help="journal.jsonl file(s) or recovery dir(s)")
    ap.add_argument("--staging", default=None,
                    help="staging dir (with --app: checks "
                         "<staging>/<app>/recovery)")
    ap.add_argument("--app", default=None, help="app id under --staging")
    args = ap.parse_args(argv)

    targets = list(args.targets)
    if args.staging and args.app:
        targets.append(os.path.join(args.staging, args.app, "recovery"))
    files: List[str] = []
    for t in targets:
        found = discover_journals(t)
        if not found:
            print(f"no journal found at {t}")
        files.extend(found)
    if not files:
        return 2
    report = fsck_files(files)
    print_report(report)
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
