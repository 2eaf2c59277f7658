"""Streaming execution mode: resident windowed DAGs with exactly-once
window commits (docs/streaming.md).

A stream is a DAG *template* that stays resident under the session AM and
processes unbounded input as numbered windows (micro-batches, Tez-style
"recurring DAG" pushed to its limit).  The client keeps one handle and
calls :meth:`StreamDriver.ingest`; the driver

1. spools records into CRC-framed files under
   ``<staging>/<app_id>/stream/<stream>/`` (one file per window; the same
   ``crc32-hex SP json`` framing as the recovery journal, so a torn tail
   left by a crash is detected, never replayed as data);
2. cuts window boundaries by record count
   (``tez.runtime.stream.window.count``) or punctuation record
   (``tez.runtime.stream.window.punctuation``) and atomically *seals* the
   spool (``wN.spool.open`` -> ``wN.spool`` rename);
3. runs each sealed window as a DAG named ``<stream>@w<N>`` cloned from
   the template with the window coordinate stamped into ``dag_conf``
   (``tez.runtime.stream.{id,window-id,input,output-dir}``) — windows run
   sequentially, admitted through the normal admission controller;
4. commits each window exactly once through a per-window commit ledger:
   ``WINDOW_COMMIT_STARTED`` -> atomic tmp->final renames in the output
   dir -> ``WINDOW_COMMIT_FINISHED`` (all fsync'd summary records,
   reusing the CRC journal).  The renames are idempotent, so a crash
   between STARTED and FINISHED rolls forward on replay without ever
   double-publishing a part file.

Correctness rails:

- **Window fence.**  Before window N's DAG is submitted the driver
  registers N in the epoch registry; because windows run sequentially,
  any straggler attempt still heartbeating/pushing for window N-1 when
  N is live carries a stale ``(attempt_epoch, window_id)`` stamp and is
  rejected at every seam a pre-crash zombie would be (common/epoch.py).
  Window N's zombie can therefore never contaminate window N+1.
- **Window-exact replay.**  Lineage hashes are salted with the window
  coordinate (store/lineage.py), so a task killed mid-window re-runs
  against window N's sealed spool and can reuse window N's own sealed
  store outputs — never a neighbouring window's.
- **Backpressure, never OOM.**  When ``cut - committed`` reaches
  ``tez.runtime.stream.max-lag`` the driver *blocks* ingest (source
  pacing), emits one typed ``WINDOW_LAGGING`` history event per lag
  episode, and feeds the ``stream.window.lag`` histogram.  Input is
  bounded by construction; nothing is silently dropped.
- **AM crash mid-stream.**  ``STREAM_OPENED`` journals a rebuildable
  spec (plan hex + knobs).  The successor incarnation resumes from the
  ledger (RecoveryParser.stream_records): ``WINDOW_COMMIT_FINISHED``
  windows are sealed forever and skipped, the first uncommitted sealed
  window re-runs from its surviving spool, and the ``.open`` spool —
  records that were ingested but not yet cut — becomes the open window
  again.  ``STREAM_RETIRED`` ends the stream's recovery obligation.

The port's copy of tez_tpu.am.streaming.  Each window DAG runs on the AM's
device like any other DAG, so a window whose span crosses the sorter's
device floor sorts and merges on the card.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import logging
import os
import queue
import threading
import zlib
from typing import Any, Dict, List, Optional, Set

from tez_tpu_torch.am.dag_impl import DAGState
from tez_tpu_torch.am.history import HistoryEvent, HistoryEventType
from tez_tpu_torch.common import config as C
from tez_tpu_torch.common import epoch as epoch_registry
from tez_tpu_torch.common import clock, faults, metrics
from tez_tpu_torch.dag.plan import DAGPlan

log = logging.getLogger(__name__)

#: spool filename width — windows sort lexically == numerically
_W = 6


class StreamError(RuntimeError):
    """Typed failure surface for stream operations."""


class StreamFailedError(StreamError):
    """The stream's window loop hit a non-recoverable failure; ingest and
    drain raise this instead of blocking forever."""


class StreamSpoolError(StreamError):
    """A spool record failed CRC validation or JSON decoding."""


# -- spool framing (shared with library/streaming.py readers) ---------------

#: json.dumps(record, sort_keys=True), its C encoder built once rather
#: than on every call (JSONEncoder.iterencode builds one a call); the
#: pure-Python encoder where the interpreter has no C accelerator
_SPOOL_JSON = json.JSONEncoder(sort_keys=True)
if json.encoder.c_make_encoder is not None:
    _SPOOL_C = json.encoder.c_make_encoder(
        {}, _SPOOL_JSON.default, json.encoder.encode_basestring_ascii, None,
        _SPOOL_JSON.key_separator, _SPOOL_JSON.item_separator, True, False,
        True)

    def _spool_json(record: Any) -> str:
        return "".join(_SPOOL_C(record, 0))
else:
    _spool_json = _SPOOL_JSON.encode
#: the C scanner behind json.loads, run on the line itself from the payload
#: on: a value that ends the line is what json.loads(payload) returns
_SPOOL_SCAN = json.JSONDecoder().scan_once


def encode_spool_record(record: Any) -> str:
    """``crc32-hex SP json`` — identical framing to the recovery journal
    so a torn tail (crash mid-append) is detected, not replayed."""
    payload = _spool_json(record)
    crc = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    return "%08x %s" % (crc, payload)


def decode_spool_record(line: str) -> Any:
    if len(line) < 10 or line[8] != " ":
        raise StreamSpoolError("malformed spool framing")
    try:
        want = int(line[:8], 16)
    except ValueError as e:
        raise StreamSpoolError("malformed CRC prefix") from e
    payload = line[9:]
    got = zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF
    if got != want:
        raise StreamSpoolError(
            f"spool CRC mismatch (recorded {want:08x}, computed {got:08x})")
    try:
        record, end = _SPOOL_SCAN(line, 9)
        if end == len(line):
            return record
    except (StopIteration, ValueError):
        pass      # json.loads below gives the verdict and its message
    try:
        return json.loads(payload)
    except ValueError as e:
        raise StreamSpoolError(f"bad spool JSON: {e}") from e


def read_spool(path: str) -> List[Any]:
    """Decode a spool file; a torn FINAL line (crash mid-append) is
    dropped, corruption anywhere else raises."""
    records: List[Any] = []
    if not os.path.exists(path):
        return records
    with open(path, "r") as fh:
        lines = fh.read().splitlines()
    for i, line in enumerate(lines):
        if not line:
            continue
        try:
            records.append(decode_spool_record(line))
        except StreamSpoolError:
            if i == len(lines) - 1:
                log.warning("spool %s: dropping torn final record", path)
                break
            raise
    return records


def stream_dir(staging: str, app_id: str, stream: str) -> str:
    return os.path.join(staging, app_id, "stream", stream)


def spool_name(window_id: int, sealed: bool = True) -> str:
    base = f"w{window_id:0{_W}d}.spool"
    return base if sealed else base + ".open"


# -- the journalable stream spec --------------------------------------------

@dataclasses.dataclass
class StreamSpec:
    """Everything a successor AM needs to rebuild the driver.

    ``plan`` is the window *template*: a normal DAGPlan whose source
    vertex reads ``tez.runtime.stream.input`` and whose sink writes
    window-tagged tmp files into ``output_dir`` (library/streaming.py has
    the stock pair).  The driver clones it per window."""
    name: str
    plan: DAGPlan
    output_dir: str
    #: per-stream conf overrides layered over the AM conf (window count,
    #: punctuation, lag bound ... any tez.runtime.stream.* knob)
    conf: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def journal_data(self) -> Dict[str, Any]:
        return {"stream": self.name,
                "plan": self.plan.serialize().hex(),
                "output_dir": self.output_dir,
                "conf": dict(self.conf)}

    @classmethod
    def from_journal(cls, data: Dict[str, Any]) -> "StreamSpec":
        return cls(name=str(data["stream"]),
                   plan=DAGPlan.deserialize(bytes.fromhex(data["plan"])),
                   output_dir=str(data.get("output_dir", "")),
                   conf=dict(data.get("conf") or {}))


class StreamDriver:
    """AM-side resident driver for ONE stream (built via
    DAGAppMaster.open_stream, or resumed by recovery)."""

    def __init__(self, am: Any, spec: StreamSpec,
                 resume: Optional[Dict[str, Any]] = None):
        # the stream name becomes a metric-name segment
        # (``stream.<name>.window.latency`` et al., split into a
        # stream= label at exposition) — so "window" is reserved for the
        # session-wide aggregate family, and a dot would make the label
        # split ambiguous
        if not spec.name or spec.name == "window" or "." in spec.name:
            raise StreamError(
                f"invalid stream name {spec.name!r}: must be non-empty, "
                f"not the reserved name 'window', and contain no '.'")
        self.am = am
        self.spec = spec
        conf = am.conf.merged(spec.conf)
        self.window_count = max(1, int(conf.get(C.STREAM_WINDOW_COUNT) or 1))
        self.punctuation = str(conf.get(C.STREAM_WINDOW_PUNCTUATION) or "")
        self.max_lag = max(1, int(conf.get(C.STREAM_MAX_LAG) or 1))
        self.poll_s = float(conf.get(C.STREAM_INGEST_POLL_MS) or 10.0) / 1e3
        self.window_timeout = float(
            conf.get(C.STREAM_WINDOW_TIMEOUT_SECS) or 120.0)
        self.dir = stream_dir(str(am.conf.get(C.STAGING_DIR)), am.app_id,
                              spec.name)
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(spec.output_dir, exist_ok=True)
        self._lock = threading.Condition()
        self._queue: "queue.Queue[Optional[int]]" = queue.Queue()
        self._committed: Set[int] = set()
        self._aborted: Set[int] = set()
        self._replayed: Set[int] = set()
        self._cut_monotonic: Dict[int, float] = {}
        self._cut = 0            # highest sealed window id
        self._open_id = 1        # window currently ingesting
        self._open_count = 0
        self._open_fh: Optional[Any] = None
        self._lag_episode = False
        self._lag_events = 0
        self._dead = False
        self._retired = False
        self._error: Optional[str] = None
        self._worker: Optional[threading.Thread] = None
        if resume is not None:
            self._resume_from(resume)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "StreamDriver":
        self._worker = threading.Thread(
            target=self._run, name=f"stream-{self.spec.name}", daemon=True)
        self._worker.start()
        return self

    def crash(self) -> None:
        """Non-graceful teardown (AM crash): stop the loop, journal
        nothing — the successor incarnation resumes from the ledger."""
        with self._lock:
            self._dead = True
            self._lock.notify_all()
        self._queue.put(None)

    # -- ingest (client-facing) ----------------------------------------------
    def ingest(self, records: List[Any]) -> int:
        """Append records to the open window, cutting boundaries as they
        cross.  BLOCKS when the stream is ``max_lag`` windows behind
        (bounded lag: source pacing instead of OOM/drop).  Returns the
        open window id after the append."""
        for record in records:
            self._check_alive()
            self._backpressure_wait()
            # pacing lever for chaos/tests: a delay rule here slows the
            # source exactly like a slow upstream would (the detail is
            # formatted only when some rule is armed)
            if faults.armed():
                faults.fire("stream.ingest",
                            detail=f"{self.spec.name}@w{self._open_id}")
            self._append(record)
            if self._should_cut(record):
                self._cut_window()
        return self._open_id

    def punctuate(self) -> int:
        """Force-cut the open window (empty windows are skipped)."""
        self._check_alive()
        if self._open_count > 0:
            self._cut_window()
        return self._open_id

    def _append(self, record: Any) -> None:
        if self._open_fh is None:
            path = os.path.join(self.dir,
                                spool_name(self._open_id, sealed=False))
            self._open_fh = open(path, "a")
        self._open_fh.write(encode_spool_record(record) + "\n")
        self._open_fh.flush()
        self._open_count += 1

    def _should_cut(self, record: Any) -> bool:
        if self.punctuation and record == self.punctuation:
            return True
        return self._open_count >= self.window_count

    def _cut_window(self) -> None:
        w = self._open_id
        self._open_fh.flush()
        os.fsync(self._open_fh.fileno())
        self._open_fh.close()
        self._open_fh = None
        # atomic seal: the rename IS the cut record (no journal write —
        # a crash before it leaves the records in the open window, after
        # it leaves a sealed window the resume path re-runs)
        os.rename(os.path.join(self.dir, spool_name(w, sealed=False)),
                  os.path.join(self.dir, spool_name(w)))
        with self._lock:
            self._cut = w
            self._cut_monotonic[w] = clock.mono_s()
            self._open_id = w + 1
            self._open_count = 0
        self._queue.put(w)
        metrics.set_gauge(f"stream.{self.spec.name}.cut", float(w))

    def _lag(self) -> int:
        return self._cut - len(self._committed) - len(self._aborted)

    def _backpressure_wait(self) -> None:
        # only this (the ingesting) thread raises the lag, by cutting, so
        # a read without the lock under the bound stays under it
        if self._lag() < self.max_lag:
            return
        announce = None
        with self._lock:
            if self._lag() < self.max_lag:
                return
            if not self._lag_episode:
                # one typed event per episode, not one per blocked record
                self._lag_episode = True
                self._lag_events += 1
                announce = {"stream": self.spec.name, "lag": self._lag(),
                            "max_lag": self.max_lag,
                            "open_window": self._open_id}
        if announce is not None:
            # journal outside the driver lock: the recovery appender has
            # its own write lock, and commit threads journal while this
            # lock is wanted — holding both here is a lock-order cycle
            self.am.history(HistoryEvent(
                HistoryEventType.WINDOW_LAGGING, data=announce))
            log.warning("stream %s: lag %d >= %d, pacing source",
                        self.spec.name, announce["lag"], self.max_lag)
        with self._lock:
            while not self._dead and self._error is None and \
                    self._lag() >= self.max_lag:
                metrics.observe("stream.window.lag", float(self._lag()))
                self._lock.wait(timeout=self.poll_s)
            self._lag_episode = False
        self._check_alive()

    def _check_alive(self) -> None:
        if self._error is not None:
            raise StreamFailedError(
                f"stream {self.spec.name} failed: {self._error}")
        if self._dead or self._retired:
            raise StreamError(f"stream {self.spec.name} is closed")

    # -- window loop (worker thread) ------------------------------------------
    def _run(self) -> None:
        while True:
            try:
                w = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._dead or self._retired:
                    return
                continue
            if w is None:
                return
            try:
                self._run_window(w)
            except BaseException as e:  # noqa: BLE001 — typed to callers
                if self._dead:
                    return
                log.exception("stream %s: window %d failed",
                              self.spec.name, w)
                self._abort_window(w, repr(e))
                with self._lock:
                    self._error = f"window {w}: {e!r}"
                    self._lock.notify_all()
                return

    def _window_plan(self, w: int) -> DAGPlan:
        t = self.spec.plan
        dag_conf = dict(t.dag_conf)
        dag_conf[C.STREAM_ID.name] = self.spec.name
        dag_conf[C.STREAM_WINDOW_ID.name] = w
        dag_conf[C.STREAM_INPUT.name] = os.path.join(self.dir, spool_name(w))
        dag_conf[C.STREAM_OUTPUT_DIR.name] = self.spec.output_dir
        return dataclasses.replace(t, name=f"{self.spec.name}@w{w}",
                                   dag_conf=dag_conf)

    def _run_window(self, w: int) -> None:
        if w in self._committed:       # resume belt-and-braces: sealed
            return                     # forever, never re-run
        # fence registration: from here on, any straggler stamped with an
        # earlier window of this stream is stale at every seam
        epoch_registry.register_window(self.am.app_id, self.spec.name, w)
        replay = w in self._replayed
        plan = self._window_plan(w)
        dag_id = self.am.submit_dag(plan)
        final = self._wait(dag_id)
        if final is not DAGState.SUCCEEDED:
            raise StreamError(f"window DAG {plan.name} finished "
                              f"{getattr(final, 'name', final)}")
        self._commit_window(w, str(dag_id), replay=replay)

    def _wait(self, dag_id: Any) -> Any:
        deadline = clock.mono_s() + self.window_timeout
        while True:
            try:
                return self.am.wait_for_dag(dag_id, timeout=0.5)
            except TimeoutError:
                if self._dead:
                    raise StreamError("AM crashed mid-window") from None
                if clock.mono_s() >= deadline:
                    raise

    def _commit_window(self, w: int, dag_id: str, replay: bool = False) -> None:
        """The exactly-once ledger bracket.  STARTED and FINISHED are
        fsync'd summary records; the renames between them are idempotent,
        so replaying an open bracket after a crash rolls forward without
        double-publishing."""
        self.am.history(HistoryEvent(
            HistoryEventType.WINDOW_COMMIT_STARTED,
            dag_id=dag_id,
            data={"stream": self.spec.name, "window_id": w}))
        # the chaos lever: a fail rule here IS the mid-commit crash window
        faults.fire("stream.window.commit", detail=f"{self.spec.name}@w{w}")
        published = self._publish_window(w)
        self.am.history(HistoryEvent(
            HistoryEventType.WINDOW_COMMIT_FINISHED,
            dag_id=dag_id,
            data={"stream": self.spec.name, "window_id": w,
                  "parts": published, "replayed": replay}))
        with self._lock:
            self._committed.add(w)
            cut_at = self._cut_monotonic.pop(w, None)
            self._lock.notify_all()
        if cut_at is not None:
            ms = (clock.mono_s() - cut_at) * 1000.0
            metrics.observe("stream.window.latency", ms)
            # per-stream twin of the aggregate: the series the SLO
            # watchdog checks (and burn-evaluates) per stream, split into
            # a stream= label at exposition — why "window" is a reserved
            # stream name (__init__ guard)
            metrics.observe(f"stream.{self.spec.name}.window.latency", ms)
        metrics.set_gauge(f"stream.{self.spec.name}.committed", float(w))
        self._tick_slo()

    def _publish_window(self, w: int) -> int:
        """Atomic tmp->final renames; idempotent (a final that already
        exists means a prior bracket published it — drop the tmp)."""
        out = self.spec.output_dir
        published = 0
        for tmp in sorted(glob.glob(
                os.path.join(out, f".w{w:0{_W}d}.part*.tmp"))):
            base = os.path.basename(tmp)
            final = os.path.join(out, base[1:-len(".tmp")])
            if os.path.exists(final):
                os.remove(tmp)
            else:
                os.rename(tmp, final)
            published += 1
        return published

    def _abort_window(self, w: int, reason: str) -> None:
        try:
            self.am.history(HistoryEvent(
                HistoryEventType.WINDOW_COMMIT_ABORTED,
                data={"stream": self.spec.name, "window_id": w,
                      "reason": reason}))
            # roll back: drop this window's unpublished tmp files
            for tmp in glob.glob(os.path.join(
                    self.spec.output_dir, f".w{w:0{_W}d}.part*.tmp")):
                os.remove(tmp)
            with self._lock:
                self._aborted.add(w)
                self._lock.notify_all()
        except Exception:  # noqa: BLE001 — abort is best-effort cleanup
            log.exception("stream %s: abort of window %d failed",
                          self.spec.name, w)

    def _tick_slo(self) -> None:
        # re-sweep AFTER the latency observation lands — the admission
        # tick at DAG-finish ran before the commit bracket closed
        try:
            self.am.admission._slo_tick()
        except Exception:  # noqa: BLE001 — diagnostics never fail commits
            log.exception("stream SLO tick failed")

    # -- drain / retire --------------------------------------------------------
    def drain(self, timeout: float = 120.0) -> Dict[str, Any]:
        """Cut the final partial window, wait for every sealed window to
        commit, journal STREAM_RETIRED.  Returns the final status."""
        self._check_alive()
        if self._open_count > 0:
            self._cut_window()
        deadline = clock.mono_s() + timeout
        with self._lock:
            while len(self._committed) + len(self._aborted) < self._cut:
                if self._error is not None:
                    raise StreamFailedError(
                        f"stream {self.spec.name} failed: {self._error}")
                if self._dead:
                    raise StreamError("AM crashed during drain")
                if not self._lock.wait(timeout=0.2) and \
                        clock.mono_s() >= deadline:
                    raise TimeoutError(
                        f"stream {self.spec.name}: {self._cut - len(self._committed) - len(self._aborted)} "
                        f"window(s) still uncommitted after {timeout}s")
            self._retired = True
        self._queue.put(None)
        self.am.history(HistoryEvent(
            HistoryEventType.STREAM_RETIRED,
            data={"stream": self.spec.name,
                  "windows_committed": len(self._committed),
                  "windows_aborted": len(self._aborted)}))
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        return self.status()

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"stream": self.spec.name,
                    "cut": self._cut,
                    "open_window": self._open_id,
                    "open_records": self._open_count,
                    "committed": sorted(self._committed),
                    "aborted": sorted(self._aborted),
                    "replayed": sorted(self._replayed),
                    "lag": self._lag(),
                    "lag_episodes": self._lag_events,
                    "retired": self._retired,
                    "error": self._error}

    # -- crash recovery --------------------------------------------------------
    def _resume_from(self, rec: Dict[str, Any]) -> None:
        """Rebuild position from the ledger + surviving spools.

        Committed windows are sealed forever.  Every sealed-but-uncommitted
        spool re-enters the run queue in order (window-exact replay: same
        spool, same window id, lineage salted identically — sealed store
        outputs from the crashed incarnation are reusable).  An ``.open``
        spool becomes the open window again, its ingested records intact."""
        self._committed = set(rec.get("committed") or ())
        self._aborted = set(rec.get("aborted") or ())
        sealed = sorted(
            int(os.path.basename(p)[1:1 + _W])
            for p in glob.glob(os.path.join(self.dir, "w" + "[0-9]" * _W
                                            + ".spool")))
        open_spools = glob.glob(
            os.path.join(self.dir, "w" + "[0-9]" * _W + ".spool.open"))
        self._cut = max(sealed) if sealed else 0
        self._open_id = self._cut + 1
        if open_spools:
            path = sorted(open_spools)[-1]
            self._open_id = max(self._open_id,
                                int(os.path.basename(path)[1:1 + _W]))
            self._open_count = len(read_spool(path))
        for w in sealed:
            if w in self._committed or w in self._aborted:
                continue
            self._replayed.add(w)
            self._cut_monotonic[w] = clock.mono_s()
            self._queue.put(w)
        if self._replayed:
            log.info("stream %s: resuming — %d committed, replaying "
                     "window(s) %s, open window %d (%d record(s))",
                     self.spec.name, len(self._committed),
                     sorted(self._replayed), self._open_id,
                     self._open_count)

    @classmethod
    def resume(cls, am: Any, rec: Dict[str, Any]) -> Optional["StreamDriver"]:
        """Build + start a driver from a RecoveryParser.stream_records()
        entry; None when the stream was retired or the spec is missing."""
        if rec.get("retired") or not rec.get("spec"):
            return None
        spec = StreamSpec.from_journal(rec["spec"])
        return cls(am, spec, resume=rec).start()
