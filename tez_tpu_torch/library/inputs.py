"""Stock inputs: the sorted-shuffle consumer side.

Reference parity: tez-runtime-library/.../library/input/
OrderedGroupedKVInput.java:101 (owns Shuffle orchestrator, blocking
waitForInput, KeyValuesReader grouping via ValuesIterator) with the
Shuffle/ShuffleScheduler/MergeManager trio collapsed into a fetch table +
device merge: fetches are local buffer handoffs or TCP fetches from other
runner processes and hosts, the merges run in the ShuffleMergeManager on
the task's device.

The port's copy of tez_tpu.library.inputs (the unordered inputs live in
library/unordered.py).  A payload from another process or host goes to
the TCP fetch pool (shuffle/scheduler.py), which first probes this
process's buffer store; with push shuffle on, the merge manager merges
eagerly and wakes on every push that lands here.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tez_tpu_torch.api.events import (CompositeRoutedDataMovementEvent,
                                      DataMovementEvent, InputFailedEvent,
                                      InputReadErrorEvent, ShufflePayload,
                                      TezAPIEvent)
from tez_tpu_torch.api.runtime import (KeyValueReader, KeyValuesReader,
                                       LogicalInput, MemoryUpdateCallback,
                                       MergedLogicalInput, Reader)
from tez_tpu_torch.common import config as C
from tez_tpu_torch.common import faults, metrics, tracing
from tez_tpu_torch.common.counters import TaskCounter
from tez_tpu_torch.library.util import conf_get as _conf_get
from tez_tpu_torch.ops.runformat import KVBatch, adjacent_equal_rows
from tez_tpu_torch.ops.serde import Serde, get_serde
from tez_tpu_torch.shuffle.service import (ShuffleDataNotFound,
                                           local_shuffle_service)

log = logging.getLogger(__name__)


def _is_checksum_error(e: Exception) -> bool:
    """Run.from_bytes signals payload damage as IOError('checksum mismatch
    in ...' / 'bad run magic in ...') — the only OSErrors that mean the
    bytes (not the transport) are bad."""
    return isinstance(e, IOError) and \
        ("checksum mismatch" in str(e) or "bad run magic" in str(e))


class _SlotState:
    """Fetch bookkeeping for one physical input (one source task)."""
    __slots__ = ("batches", "spills_seen", "complete", "version",
                 "last_spill")

    def __init__(self) -> None:
        self.batches: List[KVBatch] = []
        self.spills_seen: set = set()
        self.complete = False
        self.version = -1
        #: the spill id of the last event (a pipelined producer's final
        #: marker), once it has been committed; None before
        self.last_spill: Optional[int] = None


class ShuffleFetchTable:
    """Tracks per-source fetch state; thread-safe (events arrive on the
    heartbeat thread, the reader blocks on the processor thread).

    This is the ShuffleScheduler+MergeManager seam: local fetches are
    immediate; a fetch from another process or host is enqueued on the
    fetch pool.  With a merge manager attached, fetched batches go through
    bounded-memory admission (MergeManager.reserve semantics) instead of
    accumulating per-slot."""

    def __init__(self, context: Any, num_slots: int, my_partition: int,
                 merge_manager: Optional[Any] = None):
        if num_slots < 0:
            # a negative slot count means this task's spec was built while
            # its source vertex parallelism was still unresolved; wait_all's
            # `completed >= num_slots` would be instantly true and the task
            # would SUCCEED empty — silent data loss.  Fail loudly instead:
            # the AM retries the attempt against a configured source.
            raise ValueError(
                f"shuffle input for partition {my_partition} constructed "
                f"with unresolved physical input count {num_slots}; source "
                f"vertex parallelism was not configured when this task was "
                f"scheduled")
        self.context = context
        self.num_slots = num_slots
        self.my_partition = my_partition
        self.slots = [_SlotState() for _ in range(num_slots)]
        self.completed = 0
        self.lock = threading.Condition()
        self.service = local_shuffle_service()
        self.failed = False
        self.diagnostics = ""
        self.merge_manager = merge_manager
        meta = context.get_service_provider_metadata("shuffle") or {}
        self.local_host = meta.get("host", "local")
        self.local_port = meta.get("port", 0)
        self._secret = meta.get("secret")
        self._scheduler = None   # created on first remote payload
        self._closing = False
        # counters document a single-writer rule; fetch-pool deliveries come
        # from many threads, so the table serializes ITS counter writes
        self._deliver_lock = threading.Lock()
        # Fetch deliveries arrive on heartbeat/fetcher threads where no span
        # is active, so the task's trace context is captured HERE (the table
        # is built on the processor thread inside the attempt span) and every
        # fetch span parents under it explicitly.
        self._trace = tracing.current_context()

    def _is_local(self, payload: ShufflePayload) -> bool:
        return payload.port == 0 or (payload.host, payload.port) == \
            (self.local_host, self.local_port)

    def _scheduler_for_remote(self):
        """Fetches from other processes and hosts go through the bounded
        fetcher pool with per-host queues, coalescing, penalty box and
        speculative refetch (ShuffleScheduler.java:91,179,295 analog; see
        shuffle/scheduler.py).  Created lazily: purely-local shuffles never
        pay for the threads."""
        if self._scheduler is None:
            from tez_tpu_torch.common.payload import resolve_class
            from tez_tpu_torch.shuffle.scheduler import (FetchScheduler,
                                                         TcpFetchSession)
            ctx = self.context

            def _k(key):   # one source of truth: the registered ConfKey
                return _conf_get(ctx, key.name, key.default)

            session_cls = _k(C.SHUFFLE_FETCHER_CLASS)
            if session_cls:
                factory = resolve_class(session_cls)
            else:
                from tez_tpu_torch.common.tls import (client_context,
                                                      resolve_conf)
                ssl_ctx = client_context(resolve_conf(
                    lambda k: _conf_get(ctx, k, None)))
                conn_to = float(_k(C.SHUFFLE_CONNECT_TIMEOUT_MS)) / 1e3
                read_to = float(_k(C.SHUFFLE_READ_TIMEOUT_MS)) / 1e3
                factory = lambda h, p: TcpFetchSession(  # noqa: E731
                    self._secret, h, p, connect_timeout=conn_to,
                    ssl_context=ssl_ctx, read_timeout=read_to,
                    epoch=getattr(ctx, "am_epoch", 0),
                    app_id=getattr(ctx, "app_id", ""))
            self._scheduler = FetchScheduler(
                deliver=self._remote_done,
                session_factory=factory,
                num_fetchers=int(_k(C.SHUFFLE_PARALLEL_COPIES)),
                max_per_fetch=int(_k(C.SHUFFLE_FETCH_MAX_TASK_OUTPUT_AT_ONCE)),
                penalty_base=float(_k(C.SHUFFLE_HOST_PENALTY_BASE_MS)) / 1e3,
                penalty_cap=float(_k(C.SHUFFLE_HOST_PENALTY_CAP_MS)) / 1e3,
                max_attempts=int(_k(C.SHUFFLE_FETCH_ATTEMPTS)),
                stall_timeout=float(
                    _k(C.SHUFFLE_SPECULATIVE_FETCH_WAIT_MS)) / 1e3,
                session_ttl=float(
                    _k(C.SHUFFLE_FETCH_SESSION_TTL_MS)) / 1e3,
                local_probe=self._store_probe
                if self.service.buffer_store() is not None else None)
        return self._scheduler

    def _store_probe(self, path: str, spill: int,
                     partition: int) -> Optional[KVBatch]:
        """Buffer-store short-circuit for the remote pool: a fetch whose
        data this process already holds (store-registered or lineage-
        republished) is served zero-copy instead of over TCP."""
        try:
            batch = self.service.fetch_partition(
                path, spill, partition, counters=self.context.counters,
                app_id=getattr(self.context, "app_id", ""),
                window_id=getattr(self.context, "window_id", 0),
                stream=getattr(self.context, "stream", ""))
        except ShuffleDataNotFound:
            return None
        with self._deliver_lock:
            self.context.counters.find_counter(
                "ShuffleStore", "store.short_circuit").increment(1)
        return batch

    def shutdown(self) -> None:
        self._closing = True
        if self._scheduler is not None:
            self._scheduler.stop()

    def _fetch_local(self, payload: ShufflePayload,
                     partition: int) -> KVBatch:
        """Same-host short-circuit (Fetcher.java:288 local-disk fetch)."""
        t0 = time.perf_counter()
        with tracing.span("shuffle.fetch", cat="shuffle",
                          parent=self._trace, mode="local",
                          src=payload.path_component,
                          spill=payload.spill_id, partition=partition):
            faults.fire("shuffle.fetch.read", detail=payload.path_component)
            batch = self.service.fetch_partition(
                payload.path_component, payload.spill_id, partition,
                app_id=getattr(self.context, "app_id", ""),
                window_id=getattr(self.context, "window_id", 0),
                stream=getattr(self.context, "stream", ""))
        metrics.observe("shuffle.fetch.rtt",
                        (time.perf_counter() - t0) * 1000.0,
                        counters=self.context.counters)
        self.context.counters.increment(TaskCounter.LOCAL_SHUFFLED_INPUTS)
        return batch

    def _fetch_error(self, slot: int, version: int, e: Exception) -> None:
        log.warning("fetch failed for slot %d: %s", slot, e)
        tracing.event("shuffle.fetch.retry_requested", parent=self._trace,
                      slot=slot, version=version,
                      error=f"{type(e).__name__}: {e}")
        if _conf_get(self.context, C.SHUFFLE_NOTIFY_READERROR.name,
                     C.SHUFFLE_NOTIFY_READERROR.default):
            self.context.send_events([InputReadErrorEvent(
                diagnostics=str(e), index=slot, version=version,
                is_local_fetch=isinstance(e, ShuffleDataNotFound))])
        else:
            # producer-blame suppressed (reference knob: fetch faults are
            # presumed environmental) — the CONSUMER attempt must then
            # fail locally; dropping the error would strand wait_all
            # forever with heartbeats still flowing
            with self.lock:
                self.failed = True
                self.diagnostics = (f"fetch failed for slot {slot} and "
                                    f"notify.readerror is off: {e}")
                self.lock.notify_all()
        with self._deliver_lock:
            self.context.counters.increment(
                TaskCounter.NUM_FAILED_SHUFFLE_INPUTS)

    def _remote_done(self, req, batch, error) -> None:
        """Fetch-pool delivery: runs on a fetcher thread."""
        if self._closing:
            return   # input closed mid-fetch: nothing to deliver into
        slot, partition, payload, version, stamp, generation = req.cookie
        if error is not None:
            self._fetch_error(slot, version, error)
            return
        with self._deliver_lock:
            if getattr(req, "rtt_ms", 0.0) > 0.0:
                metrics.observe("shuffle.fetch.rtt", req.rtt_ms,
                                counters=self.context.counters)
            self.context.counters.increment(TaskCounter.SHUFFLE_BYTES,
                                            batch.nbytes)
            self.context.counters.increment(
                TaskCounter.SHUFFLE_BYTES_DISK_DIRECT, batch.nbytes)
            if self.merge_manager is None:
                self.context.counters.increment(
                    TaskCounter.SHUFFLE_BYTES_TO_MEM, batch.nbytes)
            self.context.counters.increment(TaskCounter.NUM_SHUFFLED_INPUTS)
        self._commit_fetch(slot, payload, version, stamp, generation, batch)

    def on_payload(self, slot: int, partition: int, payload: ShufflePayload,
                   version: int = 0) -> None:
        mm = self.merge_manager
        with self.lock:
            s = self.slots[slot]
            if s.complete or \
                    (payload.spill_id >= 0 and payload.spill_id in s.spills_seen):
                return  # duplicate delivery (e.g. after slot reset race)
            s.version = version
            stamp = s   # identity captured: if on_input_failed resets the
            # slot while the (un-locked) fetch below runs, this stale
            # producer version's batch must not land in the fresh slot
        generation = mm.slot_generation(slot) if mm is not None else 0
        if not payload.is_empty(partition) and not self._is_local(payload):
            if self._secret is None:
                # config gap on THIS consumer, not producer data loss: must
                # not masquerade as a local fetch failure (which force-reruns
                # the healthy producer)
                self._fetch_error(slot, version, PermissionError(
                    f"no shuffle secret for remote fetch from "
                    f"{payload.host}:{payload.port}"))
                return
            from tez_tpu_torch.shuffle.scheduler import FetchRequest
            self._scheduler_for_remote().enqueue(FetchRequest(
                payload.host, payload.port, payload.path_component,
                payload.spill_id, partition,
                cookie=(slot, partition, payload, version, stamp,
                        generation),
                trace=self._trace))
            return
        try:
            if payload.is_empty(partition):
                batch = None
            else:
                if mm is not None:
                    # disk-direct short-circuit: a disk-backed producer run
                    # on this host merges straight off its partition-
                    # indexed file — no materialization, no re-spill
                    # (reference: LocalDiskFetchedInput / the
                    # SHUFFLE_BYTES_DISK_DIRECT path)
                    src = self.service.local_file_source(
                        payload.path_component, payload.spill_id, partition)
                    if src is not None:
                        path, nbytes = src
                        if mm.commit_local_file(slot, path, partition,
                                                nbytes, generation):
                            with self._deliver_lock:
                                ctr = self.context.counters
                                ctr.increment(TaskCounter.SHUFFLE_BYTES,
                                              nbytes)
                                ctr.increment(
                                    TaskCounter.SHUFFLE_BYTES_DISK_DIRECT,
                                    nbytes)
                                ctr.increment(
                                    TaskCounter.LOCAL_SHUFFLED_INPUTS)
                                ctr.increment(
                                    TaskCounter.NUM_SHUFFLED_INPUTS)
                            self._commit_fetch(slot, payload, version,
                                               stamp, generation, None)
                        return
                batch = self._fetch_local(payload, partition)
                with self._deliver_lock:
                    self.context.counters.increment(
                        TaskCounter.SHUFFLE_BYTES, batch.nbytes)
                    if mm is None:
                        # with a merge manager the TO_MEM/TO_DISK split is
                        # its admission decision, counted there exactly once
                        self.context.counters.increment(
                            TaskCounter.SHUFFLE_BYTES_TO_MEM, batch.nbytes)
                    self.context.counters.increment(
                        TaskCounter.NUM_SHUFFLED_INPUTS)
        except (ShuffleDataNotFound, OSError, PermissionError) as e:
            # OSError covers both connection faults and the checksum IOError
            # from a corrupted payload — either way the producer output is
            # unusable from here and must be re-fetched or re-produced
            if _is_checksum_error(e):
                # quarantine: drop every registered spill of this producer
                # output so the re-fetch after producer re-run can't serve
                # the damaged copy again (reference: fetch failure discards
                # the MapOutput before reporting)
                self.service.unregister_prefix(payload.path_component)
                log.warning("quarantined corrupt shuffle output %s",
                            payload.path_component)
            self._fetch_error(slot, version, e)
            return
        self._commit_fetch(slot, payload, version, stamp, generation, batch)

    def _commit_fetch(self, slot: int, payload: ShufflePayload, version: int,
                      stamp: "_SlotState", generation: int,
                      batch: Optional[KVBatch]) -> None:
        mm = self.merge_manager
        if mm is not None and batch is not None:
            # bounded-memory admission; may stall while the background
            # merger frees memory (MergeManager.reserve():404 semantics).
            # The captured generation makes a stale commit (slot reset
            # mid-fetch) a silent no-op inside the manager — it can never
            # displace the new attempt's data.
            try:
                if not mm.commit(slot, batch, generation):
                    return
            except RuntimeError as e:
                with self.lock:
                    self.failed = True
                    self.diagnostics = str(e)
                    self.lock.notify_all()
                return
        with self.lock:
            s = self.slots[slot]
            if s is not stamp or s.version != version:
                return   # slot was reset mid-fetch: drop the stale delivery
            if mm is None and batch is not None:
                s.batches.append(batch)
            if payload.spill_id >= 0:
                s.spills_seen.add(payload.spill_id)
            if payload.last_event:
                s.last_spill = payload.spill_id
            # a pipelined producer's spills are complete only when every
            # spill up to its final marker has been committed: from runner
            # processes the final marker (sent at close) can overtake
            # earlier spills' events (sent on the heartbeat).  tez_tpu
            # completes the slot on the final marker and drops the spills
            # that arrive after it.
            if s.last_spill is not None and not s.complete and \
                    all(i in s.spills_seen
                        for i in range(s.last_spill + 1)):
                s.complete = True
                self.completed += 1
            self.lock.notify_all()

    def on_input_failed(self, slot: int, version: int) -> None:
        """Producer re-running: discard and re-wait (reference:
        InputFailedEvent handling in shuffle event handlers)."""
        with self.lock:
            s = self.slots[slot]
            if s.complete:
                self.completed -= 1
            self.slots[slot] = _SlotState()
            self.lock.notify_all()
        if self.merge_manager is not None:
            self.merge_manager.on_slot_reset(slot)

    def wait_all(self, timeout: Optional[float] = None) -> List[KVBatch]:
        deadline = None if timeout is None else time.time() + timeout
        with self.lock:
            while True:
                if self.failed:
                    raise RuntimeError(f"shuffle failed: {self.diagnostics}")
                if self.completed >= self.num_slots:
                    out: List[KVBatch] = []
                    for s in self.slots:
                        out.extend(s.batches)
                    return out
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError(
                        f"shuffle incomplete: {self.completed}/{self.num_slots}")
                self.lock.wait(0.2)
                # raises TaskKilledError if the AM killed this attempt (or
                # the heartbeat died) — never block forever
                self.context.notify_progress()


class OrderedGroupedKVInput(LogicalInput):
    """Sorted, grouped input (reduce side)."""

    def initialize(self) -> List[TezAPIEvent]:
        ctx = self.context
        self.key_serde = get_serde(_conf_get(ctx, "tez.runtime.key.class",
                                             "bytes"))
        self.val_serde = get_serde(_conf_get(ctx, "tez.runtime.value.class",
                                             "bytes"))
        self.key_width = int(_conf_get(ctx, "tez.runtime.tpu.key.width.bytes",
                                       16))
        self._merged: Optional[KVBatch] = None
        self._stream_plan = None
        from tez_tpu_torch.library.comparators import load_comparator
        self._key_normalizer = load_comparator(ctx)   # resolved ONCE
        self._group_starts = None                     # cached across readers

        # Bounded-memory merge (MergeManager.java:83 analog).  The budget
        # comes from an explicit key, or else from the MemoryDistributor
        # grant for buffer.percent x io.sort.mb (reference: shuffle buffer
        # = fetch.buffer.percent of task memory).  0 explicit + 0 grant =
        # unbounded accumulation (grant callback delivers before start()).
        budget_mb = int(_conf_get(ctx, "tez.runtime.shuffle.merge.budget.mb",
                                  0))
        sort_mb = int(_conf_get(ctx, "tez.runtime.io.sort.mb", 256))
        frac = float(_conf_get(ctx,
                               "tez.runtime.shuffle.fetch.buffer.percent",
                               0.9))
        spill_dir = _conf_get(ctx, "tez.runtime.tpu.host.spill.dir", "") or \
            os.path.join(ctx.work_dirs[0], "spill")
        codec = None
        if _conf_get(ctx, "tez.runtime.compress", False):
            codec = _conf_get(ctx, "tez.runtime.compress.codec", "zlib")
        engine = _conf_get(ctx, "tez.runtime.sorter.class", "auto")
        factor = int(_conf_get(ctx, "tez.runtime.io.sort.factor", 64))
        # reduce-side merge plane knobs: engine / min-records default to the
        # sort plane's routing so a plain deployment tunes ONE engine choice
        merge_engine = _conf_get(ctx, "tez.runtime.merge.engine", "") or \
            engine
        merge_min = int(_conf_get(
            ctx, "tez.runtime.merge.engine.min-records", 0)) or \
            int(_conf_get(
                ctx, "tez.runtime.tpu.device.sort.min.records", 1 << 16))

        # push-based shuffle: eager merge overlaps the map wave — the
        # background merger starts once the eager fraction of the budget
        # is committed instead of waiting for admission pressure
        push_on = bool(_conf_get(
            ctx, "tez.runtime.shuffle.push.enabled", False))
        self._push_enabled = push_on
        eager = float(_conf_get(
            ctx, "tez.runtime.shuffle.push.eager-merge-threshold",
            0.5)) if push_on else 0.0
        self._mm_budget = budget_mb << 20
        self._mm_kwargs = dict(
            key_width=self.key_width, engine=merge_engine,
            merge_factor=factor,
            device_min_records=merge_min,
            eager_threshold=eager,
            merge_threshold=float(_conf_get(
                ctx, "tez.runtime.shuffle.merge.percent", 0.9)),
            max_single_fraction=float(_conf_get(
                ctx, "tez.runtime.shuffle.memory.limit.percent", 0.25)),
            key_normalizer=self._key_normalizer, codec=codec,
            async_depth=int(_conf_get(
                ctx, "tez.runtime.merge.async.depth", 2)),
            device=ctx.device)
        self._spill_dir = spill_dir

        class _Granted(MemoryUpdateCallback):
            def memory_assigned(cb_self, assigned_size: int) -> None:
                if self._mm_budget <= 0:
                    self._mm_budget = int(assigned_size)

        ctx.request_initial_memory(int(frac * (sort_mb << 20)), _Granted(),
                                   component_type="SORTED_MERGED_INPUT")
        self.merge_manager = None     # created in start(): grant lands first
        self._push_listener = None    # registered in start() when push on
        self.table = ShuffleFetchTable(ctx, self.num_physical_inputs,
                                       my_partition=ctx.task_index)
        return []

    def start(self) -> None:
        """Memory grants are delivered between initialize() and start():
        build the merge manager with the final budget and attach it before
        any event can deliver a fetch (events replay after start)."""
        from tez_tpu_torch.library.merge_manager import ShuffleMergeManager
        self.merge_manager = ShuffleMergeManager(
            self.context.counters, self._mm_budget, self._spill_dir,
            **self._mm_kwargs)
        self.table.merge_manager = self.merge_manager
        if self._push_enabled:
            # merge-wake seam: a pushed arrival pokes the merger so the
            # async merge lane re-evaluates eager-merge eligibility the
            # moment bytes land, not a poll period later
            mm = self.merge_manager

            def _push_wake(_path: str, _spill: int, _mm=mm) -> None:
                with _mm.lock:
                    _mm.lock.notify_all()

            self._push_listener = _push_wake
            local_shuffle_service().add_push_listener(_push_wake)

    def handle_events(self, events: Sequence[TezAPIEvent]) -> None:
        for ev in events:
            if isinstance(ev, CompositeRoutedDataMovementEvent):
                # source_index = my partition, target_index_start = slot
                payload = ev.user_payload
                assert isinstance(payload, ShufflePayload), payload
                for i in range(ev.count):
                    # expansion advances BOTH indices (reference:
                    # CompositeRoutedDataMovementEvent.expand)
                    self.table.on_payload(ev.target_index_start + i,
                                          ev.source_index + i, payload,
                                          version=ev.version)
            elif isinstance(ev, DataMovementEvent):
                payload = ev.user_payload
                assert isinstance(payload, ShufflePayload), payload
                self.table.on_payload(ev.target_index, ev.source_index,
                                      payload, version=ev.version)
            elif isinstance(ev, InputFailedEvent):
                self.table.on_input_failed(ev.target_index, ev.version)
            else:
                log.warning("OrderedGroupedKVInput: unexpected event %r", ev)

    def _wait_and_merge(self) -> None:
        if self._merged is None and self._stream_plan is None:
            t0 = time.time()
            with tracing.span("shuffle.wait", cat="shuffle"):
                self.table.wait_all()
            self.context.counters.find_counter(TaskCounter.SHUFFLE_PHASE_TIME)\
                .increment(int((time.time() - t0) * 1000))
            t1 = time.time()
            with tracing.span("shuffle.merge", cat="shuffle"):
                result = self.merge_manager.finish()
            metrics.observe("shuffle.merge",
                            (time.time() - t1) * 1000.0,
                            counters=self.context.counters)
            if result.is_streaming:
                # partition exceeds the memory budget: records stream from
                # chunked disk runs with bounded resident memory
                self._stream_plan = result.stream
            else:
                self._merged = result.batch
                self.context.counters.increment(
                    TaskCounter.REDUCE_INPUT_RECORDS,
                    self._merged.num_records)
            self.context.counters.find_counter(TaskCounter.MERGE_PHASE_TIME)\
                .increment(int((time.time() - t1) * 1000))

    def get_reader(self):
        self._wait_and_merge()
        if self._stream_plan is not None:
            return StreamingGroupedKVReader(self._stream_plan, self.key_serde,
                                            self.val_serde, self.context,
                                            key_normalizer=self._key_normalizer)
        batch = self._merged
        if self._group_starts is None:
            # one normalization pass for group detection, cached so repeat
            # readers are free (the merge normalized pre-sort; deriving its
            # arrays post-refinement isn't worth the plumbing)
            self._group_starts = GroupedKVReader._compute_groups(
                batch, self._key_normalizer)
        return GroupedKVReader(batch, self.key_serde,
                               self.val_serde, self.context,
                               group_starts=self._group_starts)

    def close(self) -> List[TezAPIEvent]:
        self._merged = None
        self._group_starts = None
        self._stream_plan = None
        if self._push_listener is not None:
            local_shuffle_service().remove_push_listener(self._push_listener)
            self._push_listener = None
        self.table.shutdown()
        if self.merge_manager is not None:
            self.merge_manager.cleanup()
        return []


class GroupedKVReader(KeyValuesReader):
    """Groups adjacent equal keys (ValuesIterator analog, vectorized group
    boundary detection)."""

    def __init__(self, batch: KVBatch, key_serde: Serde, val_serde: Serde,
                 context: Any, key_normalizer: Any = None,
                 group_starts: Any = None):
        self.batch = batch
        self.key_serde = key_serde
        self.val_serde = val_serde
        self.context = context
        self._group_starts = group_starts if group_starts is not None \
            else self._compute_groups(batch, key_normalizer)

    @staticmethod
    def _compute_groups(batch: KVBatch, key_normalizer: Any = None
                        ) -> np.ndarray:
        n = batch.num_records
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        if key_normalizer is not None:
            # comparator-equality grouping (e.g. case-insensitive): adjacent
            # keys with equal NORMALIZED forms form one group — materialize
            # the normalized keys once, then the same vectorized path
            from tez_tpu_torch.ops.sorter import normalize_batch_keys
            kb, ko = normalize_batch_keys(batch, key_normalizer)
        else:
            kb, ko = batch.key_bytes, batch.key_offsets
        lengths = ko[1:] - ko[:-1]
        same = np.zeros(n, dtype=bool)
        cand = np.flatnonzero(lengths[1:] == lengths[:-1])
        same[cand + 1] = adjacent_equal_rows(kb, ko, cand)
        return np.flatnonzero(~same).astype(np.int64)

    def __iter__(self) -> Iterator[Tuple[Any, Iterator[Any]]]:
        n = self.batch.num_records
        bounds = np.append(self._group_starts, n)
        groups = 0
        for s, e in zip(bounds[:-1], bounds[1:]):
            key = self.key_serde.from_bytes(self.batch.key(int(s)))
            values = (self.val_serde.from_bytes(self.batch.value(i))
                      for i in range(int(s), int(e)))
            groups += 1
            if (groups & 0x3FF) == 0:
                self.context.notify_progress()
            yield key, values
        self.context.counters.increment(TaskCounter.REDUCE_INPUT_GROUPS,
                                        groups)

    def grouped_batch(self) -> Tuple[KVBatch, np.ndarray]:
        """Vectorized view for batch-first consumers: the merged sorted
        KVBatch plus group-start row indices (one per distinct key).  A
        zero-Python-per-record alternative to __iter__.  Increments
        REDUCE_INPUT_GROUPS exactly as a full iteration would
        (REDUCE_INPUT_RECORDS is recorded once at merge time by the input,
        not here); callers that inspect the batch and then fall back to
        __iter__ should use `peek_batch()` instead."""
        self.context.counters.increment(TaskCounter.REDUCE_INPUT_GROUPS,
                                        len(self._group_starts))
        return self.batch, self._group_starts

    def grouped_blocks(self) -> Iterator[Tuple[KVBatch, np.ndarray]]:
        """Block-stream view: yields (sorted KVBatch, group_starts) with
        every group complete within its block.  For the in-RAM reader that
        is a single block; the streaming reader yields many — consumers
        written against this API handle both without branching."""
        yield self.grouped_batch()

    def peek_batch(self) -> KVBatch:
        """The merged batch WITHOUT counter effects — for consumers probing
        whether the vectorized path applies (e.g. uniform value widths)
        before committing to grouped_batch() or __iter__."""
        return self.batch


class StreamingGroupedKVReader(KeyValuesReader):
    """Grouped reader over a streaming merge plan (bounded memory): sorted
    blocks arrive from the vectorized disk-run block merge; adjacent equal
    SORT keys (normalized form when a comparator is configured) form one
    group.  Re-iterable — each iteration re-reads the chunked disk runs."""

    def __init__(self, plan: Any, key_serde: Serde, val_serde: Serde,
                 context: Any, key_normalizer: Any = None):
        self.plan = plan
        self.key_serde = key_serde
        self.val_serde = val_serde
        self.context = context
        self.key_normalizer = key_normalizer

    def grouped_blocks(self) -> Iterator[Tuple[KVBatch, np.ndarray]]:
        """Yields (sorted KVBatch, group_starts) with every group COMPLETE
        within its block: each merged block's trailing group is carried into
        the next block, so batch-first consumers need no cross-block
        bookkeeping.  Each incoming block is group-scanned ONCE; a group
        spanning m blocks accumulates as a piece list (one concat when it
        closes), so total work stays linear in records.  Resident memory is
        one merged block plus the open group (a single key's records — the
        pathological one-giant-key case degrades to holding that key's
        group, which any grouped consumer must materialize anyway).  Counts
        REDUCE_INPUT_GROUPS and — unlike grouped_batch(), whose records
        were counted at merge time — REDUCE_INPUT_RECORDS, since the
        streaming merge never materializes a counted whole."""
        counters = self.context.counters
        norm = self.key_normalizer
        carry: List[KVBatch] = []     # pieces of the one open group
        carry_key: Optional[bytes] = None   # its SORT key (normalized form)

        def sort_key(batch: KVBatch, i: int) -> bytes:
            k = batch.key(i)
            return norm(k) if norm is not None else k

        def close_carry() -> Tuple[KVBatch, np.ndarray]:
            out = carry[0] if len(carry) == 1 else KVBatch.concat(carry)
            return out, np.zeros(1, dtype=np.int64)

        groups = 0
        records = 0
        for block in self.plan.iter_batches():
            n = block.num_records
            if n == 0:
                continue
            starts = GroupedKVReader._compute_groups(block, norm)
            if carry_key is not None and sort_key(block, 0) == carry_key:
                if len(starts) <= 1:
                    carry.append(block)   # whole block continues the group
                    continue
                cut = int(starts[1])      # the open group closes here
                carry.append(block.slice_rows(0, cut))
                groups += 1
                records += sum(p.num_records for p in carry)
                yield close_carry()
                carry = []
                block = block.slice_rows(cut, n)
                n -= cut
                starts = (starts[1:] - cut).astype(np.int64)
            elif carry:
                groups += 1
                records += sum(p.num_records for p in carry)
                yield close_carry()
                carry = []
            # hold the trailing (possibly open) group; emit the rest
            last = int(starts[-1])
            carry = [block.slice_rows(last, n)]
            carry_key = sort_key(block, last)
            if last > 0:
                groups += len(starts) - 1
                records += last
                self.context.notify_progress()
                yield block.slice_rows(0, last), starts[:-1]
        if carry and sum(p.num_records for p in carry) > 0:
            groups += 1
            records += sum(p.num_records for p in carry)
            yield close_carry()
        counters.increment(TaskCounter.REDUCE_INPUT_GROUPS, groups)
        counters.increment(TaskCounter.REDUCE_INPUT_RECORDS, records)

    def __iter__(self) -> Iterator[Tuple[Any, Iterator[Any]]]:
        for batch, starts in self.grouped_blocks():
            bounds = np.append(starts, batch.num_records)
            for s, e in zip(bounds[:-1], bounds[1:]):
                key = self.key_serde.from_bytes(batch.key(int(s)))
                values = (self.val_serde.from_bytes(batch.value(i))
                          for i in range(int(s), int(e)))
                yield key, values


class UnorderedKVReaderAdapter(KeyValueReader):
    """Flat (key, value) iteration over a batch (used by unordered inputs and
    tests)."""

    def __init__(self, batch: KVBatch, key_serde: Serde, val_serde: Serde):
        self.batch = batch
        self.key_serde = key_serde
        self.val_serde = val_serde

    def __iter__(self):
        for k, v in self.batch.iter_pairs():
            yield self.key_serde.from_bytes(k), self.val_serde.from_bytes(v)


class ConcatenatedMergedKVInput(MergedLogicalInput):
    """Merged view over a vertex group's constituent inputs: concatenates
    their readers (reference: tez-runtime-library
    ConcatenatedMergedKeyValueInput / the MergedLogicalInput family)."""

    def get_reader(self) -> Reader:
        merged_self = self

        class _Concat(KeyValueReader):
            def __iter__(self):
                for inp in merged_self.inputs:
                    reader = inp.get_reader()
                    # grouped readers yield (k, values); flat ones (k, v)
                    if isinstance(reader, KeyValuesReader):
                        for k, vs in reader:
                            for v in vs:
                                yield k, v
                    else:
                        for k, v in reader:
                            yield k, v

        return _Concat()
