"""Device sorter: PipelinedSorter semantics on the port's CUDA kernels.

tez_tpu/ops/sorter.py's DeviceSorter: records collect into spans; each
full span is sorted on the device (hash partition + stable (partition,
key) sort); flush merges the spans.  Sorted key columns stay on the device
as ``Run.batch.dev_keys`` so a merge of fresh runs ranks them in place (the
resident merge); runs without them take the generic merge-path merge.
Rows whose keys exceed the lane width get a host tie-break pass, so the
final order is full raw-byte order for any key length.  Spans and merges
under the device floor (``device_min_records``) take the host engine: the
host library's span sort and merges (ops/native.py), full-key compares
with the GIL released.

With ``pipeline_depth > 0`` (the library's default, 2) spans go through
the async span plane (ops/async_stage.py): span k+1's host encode and H2D
copy overlap span k's sort on the card and span k-1's readback, with the
containment ladder (out-of-memory split, host failover, watchdog, circuit
breaker) around every device attempt.  Runs complete out of order and are
put back in spill order at flush, so the result is bit-exact with the
synchronous engine.

With ``spill_dir`` set (the library always sets one), a run that would
take the runs kept in RAM past ``mem_budget_bytes`` (default twice the
span budget) is written to a partition-indexed file instead and drops its
device key columns; flush_run then streams a partition-major block merge
(ops/block_merge.py) of the spilled and the in-RAM runs into one
partition-indexed file and returns it as a FileRun.

With ``key_normalizer`` set (a custom comparator, library/comparators.py),
records sort by their normalized keys while the hash partition keeps the
raw bytes; the resident span and merge paths stay off, since their device
key columns hold raw keys.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from tez_tpu_torch.common import metrics
from tez_tpu_torch.common.counters import TaskCounter, TezCounters
from tez_tpu_torch.ops import device as device_ops
from tez_tpu_torch.ops import kernels, native
from tez_tpu_torch.ops.keycodec import matrix_to_lanes, pad_to_matrix
from tez_tpu_torch.ops.runformat import (FileRun, KVBatch,
                                         PartitionedRunWriter, Run,
                                         adjacent_equal_rows, gather_ragged,
                                         save_run_partitioned)
from tez_tpu_torch.ops.serde import decode_longs_be, encode_longs_be


def _exact_tiebreak(lengths: np.ndarray, partitions: np.ndarray,
                    lanes: np.ndarray, width: int,
                    keyfn: Callable[[int], bytes]) -> Optional[np.ndarray]:
    """Refinement permutation for rows whose sorted (partition, prefix)
    group holds a sort key longer than `width`, or None if exact already.
    `lengths` and `keyfn` describe the sort keys in sorted order (the
    normalized keys when a normalizer is set).  Host cost is proportional
    to colliding rows only."""
    if len(lengths) == 0 or lengths.max(initial=0) <= width:
        return None
    clamped = np.minimum(lengths, width + 1)
    same_as_prev = np.zeros(len(lengths), dtype=bool)
    if len(lengths) > 1:
        same_as_prev[1:] = (partitions[1:] == partitions[:-1]) & \
            (clamped[1:] == clamped[:-1]) & \
            np.all(lanes[1:] == lanes[:-1], axis=1)
    starts = np.flatnonzero(~same_as_prev)
    ends = np.append(starts[1:], len(lengths))
    perm = np.arange(len(lengths), dtype=np.int64)
    changed = False
    for s, e in zip(starts, ends):
        if e - s <= 1:
            continue
        if int(lengths[s:e].max()) <= width:
            continue  # prefix fully determined the order
        keys = [keyfn(i) for i in range(s, e)]
        order = sorted(range(e - s), key=lambda j: keys[j])
        if order != list(range(e - s)):
            perm[s:e] = s + np.asarray(order, dtype=np.int64)
            changed = True
    return perm if changed else None


def _sorted_key_view(sort_bytes: np.ndarray, sort_offsets: np.ndarray,
                     perm: np.ndarray
                     ) -> Tuple[np.ndarray, Callable[[int], bytes]]:
    """(lengths, keyfn) over the sort keys in sorted order."""
    starts = sort_offsets[:-1][perm]
    lengths = (sort_offsets[1:] - sort_offsets[:-1])[perm]

    def keyfn(i: int) -> bytes:
        s = int(starts[i])
        return sort_bytes[s:s + int(lengths[i])].tobytes()

    return lengths, keyfn


def normalize_batch_keys(batch: KVBatch,
                         normalizer: Callable[[bytes], bytes]
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """The normalized sort keys of a batch as ragged (bytes, offsets)
    arrays: one normalizer call a record, paid only when a custom
    comparator is set."""
    raw = batch.key_bytes.tobytes()
    offs = batch.key_offsets.tolist()
    keys = [normalizer(raw[offs[i]:offs[i + 1]])
            for i in range(batch.num_records)]
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in keys], out=offsets[1:])
    return np.frombuffer(b"".join(keys), dtype=np.uint8), offsets


def _sort_keys(batch: KVBatch,
               normalizer: Optional[Callable[[bytes], bytes]]
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(bytes, offsets) of the keys a batch sorts by."""
    if normalizer is None:
        return batch.key_bytes, batch.key_offsets
    return normalize_batch_keys(batch, normalizer)


class SpanBuffer:
    """Collect-side buffer: records accumulated until the span budget."""

    def __init__(self) -> None:
        self.keys: List[bytes] = []
        self.vals: List[bytes] = []
        self.parts: List[int] = []     # only when a custom partitioner runs
        self.nbytes = 0
        self.batches: List[KVBatch] = []
        self._partitioned: Optional[bool] = None   # set by the first add
        self.all_pre_combined = True   # every added batch promised unique keys

    def _set_mode(self, partitioned: bool) -> None:
        if self._partitioned is None:
            self._partitioned = partitioned
        elif self._partitioned != partitioned:
            raise ValueError(
                "cannot mix partitioned and unpartitioned writes in one "
                "span (custom Partitioner output must cover every record)")

    def add(self, key: bytes, value: bytes,
            partition: Optional[int] = None) -> None:
        self._set_mode(partition is not None)
        self.all_pre_combined = False
        self.keys.append(key)
        self.vals.append(value)
        if partition is not None:
            self.parts.append(partition)
        self.nbytes += len(key) + len(value) + 16

    def add_batch(self, batch: KVBatch) -> None:
        self._set_mode(False)
        if not batch.pre_combined:
            self.all_pre_combined = False
        self.batches.append(batch)
        self.nbytes += batch.nbytes

    @property
    def num_records(self) -> int:
        return len(self.keys) + sum(b.num_records for b in self.batches)

    def to_batch(self) -> KVBatch:
        parts = list(self.batches)
        if self.keys:
            parts.append(KVBatch.from_pairs(list(zip(self.keys, self.vals))))
        if not parts:
            return KVBatch.empty()
        return parts[0] if len(parts) == 1 else KVBatch.concat(parts)


Combiner = Callable[[Run], Run]

#: Below this many records a device round trip costs more than the host
#: sort; smaller spans route to the host engine.
DEVICE_SORT_MIN_RECORDS = 1 << 16

#: Auto-engine floor on a span's total key bytes for the device path (only
#: consulted when the engine was requested as `auto`).
ENGINE_MIN_KEY_BYTES = 1 << 20

#: Failure-containment defaults of the async device plane (tez_tpu's, which
#: its library overrides from the tez.runtime.device.* knobs).
DEVICE_WATCHDOG_DISPATCH_MS = 60_000.0
DEVICE_WATCHDOG_READBACK_MS = 60_000.0
DEVICE_BREAKER_FAILURES = 3
DEVICE_BREAKER_COOLDOWN_MS = 5_000.0
DEVICE_SPLIT_MIN_BYTES = 1 << 20


def resolve_engine(engine: str) -> str:
    """`auto` resolves to the device engine: where the device work runs is
    the caller's `device` (device="cpu" runs the kernels' plain versions),
    so the absence of a card never selects the host engine."""
    return "device" if engine == "auto" else engine


def _route_engine(engine: str, n: int, min_records: int,
                  key_nbytes: int = -1, min_key_bytes: int = 0) -> str:
    """Per-span routing: host below the record-count floor and -- when the
    caller opts in by passing key_nbytes >= 0 (auto engines) -- below the
    key-byte floor too."""
    if engine != "device":
        return engine
    if n < min_records:
        return "host"
    if min_key_bytes > 0 and 0 <= key_nbytes < min_key_bytes:
        return "host"
    return engine


def _record_ms(name: str, counters: Optional[TezCounters],
               t0: float) -> None:
    metrics.observe(name, (time.time() - t0) * 1000.0, counters=counters)


class DeviceSorter:
    """The OrderedPartitionedKVOutput engine."""

    def __init__(self, num_partitions: int, key_width: int = 16,
                 span_budget_bytes: int = 256 << 20,
                 spill_dir: Optional[str] = None,
                 counters: Optional[TezCounters] = None,
                 combiner: Optional[Combiner] = None,
                 partitioner: str = "hash",
                 mem_budget_bytes: Optional[int] = None,
                 engine: str = "device",
                 sort_threads: int = 0,
                 merge_factor: int = 64,
                 key_normalizer: Optional[Callable[[bytes], bytes]] = None,
                 spill_codec: Optional[str] = None,
                 resident_keys: bool = True,
                 device_min_records: int = DEVICE_SORT_MIN_RECORDS,
                 engine_min_bytes: int = ENGINE_MIN_KEY_BYTES,
                 pipeline_depth: int = 0,
                 pipeline_coalesce_records: int = -1,
                 watchdog_dispatch_ms: float = DEVICE_WATCHDOG_DISPATCH_MS,
                 watchdog_readback_ms: float = DEVICE_WATCHDOG_READBACK_MS,
                 breaker_failures: int = DEVICE_BREAKER_FAILURES,
                 breaker_cooldown_ms: float = DEVICE_BREAKER_COOLDOWN_MS,
                 split_min_bytes: int = DEVICE_SPLIT_MIN_BYTES,
                 breaker=None,
                 device="cuda"):
        self.device = device_ops.resolve_device(device)
        self.num_partitions = num_partitions
        self.key_width = max(4, key_width)
        self.engine = resolve_engine(engine)   # 'device' | 'host'
        #: width-aware routing applies to engines requested as `auto` only
        self._auto_engine = engine == "auto"
        self.engine_min_bytes = engine_min_bytes
        self.device_min_records = device_min_records
        #: async double-buffered span plane (ops/async_stage.py): span
        #: k+1's host encode/H2D overlaps span k's sort while span k-1's
        #: readback drains; runs complete out of order and are put back in
        #: spill order at flush.  0 = synchronous spans (host engines keep
        #: it off: nothing leaves the host to overlap).
        self.pipeline_depth = pipeline_depth if self.engine == "device" else 0
        #: span-batching budget (records): small adjacent spans coalesce
        #: into one dispatch while their sum fits.  -1 = device_min_records
        #: (the spans too small to be worth a dispatch each), 0 = off.
        self.pipeline_coalesce_records = (
            device_min_records if pipeline_coalesce_records < 0
            else pipeline_coalesce_records)
        self._pipeline = None
        self._streams = None
        self._async_store_ids: List[int] = []
        #: set by abort() under _abort_lock: completions still in flight
        #: are dropped
        self._aborted = False
        self._abort_lock = threading.Lock()
        #: failure containment of the async plane: watchdog deadlines,
        #: host-engine failover through the circuit breaker, the OOM split
        #: floor.  breaker=None = the sticky per-process breaker.
        self.watchdog_dispatch_ms = watchdog_dispatch_ms
        self.watchdog_readback_ms = watchdog_readback_ms
        self.breaker_failures = breaker_failures
        self.breaker_cooldown_ms = breaker_cooldown_ms
        self.split_min_bytes = split_min_bytes
        self._breaker = breaker
        #: keep sorted key lanes on the device for downstream merges
        self.resident_keys = resident_keys
        #: custom comparator as key normalization (library/comparators.py);
        #: None sorts by the raw key bytes
        self.key_normalizer = key_normalizer
        #: host-spill compression (reference: tez.runtime.compress on IFile)
        self.spill_codec = spill_codec
        self.span_budget = span_budget_bytes
        self.spill_dir = spill_dir
        self.counters = counters or TezCounters()
        self._out_records_ctr = self.counters.find_counter(
            TaskCounter.OUTPUT_RECORDS)
        self.combiner = combiner
        self.partitioner = partitioner
        #: host RAM for runs kept until the flush; runs past it spill to
        #: spill_dir (without one, every run stays in RAM)
        self.mem_budget = mem_budget_bytes or (span_budget_bytes * 2)
        #: bounded k-way merge width (reference: io.sort.factor)
        self.merge_factor = merge_factor
        #: background span sorting (the "sortmaster": collection continues
        #: while a full span sorts).  One worker: the collector thread owns
        #: the OUTPUT_* counters, the sortmaster the sort/merge/spill ones,
        #: and on_spill consumers need not be re-entrant.
        self._executor = None
        if sort_threads > 0:
            import concurrent.futures
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="sortmaster")
        self._pending = []
        self._store_lock = threading.Lock()
        self._span = SpanBuffer()
        self._runs: List[Run | str] = []   # Run (in RAM) or path (spilled)
        self._runs_nbytes = 0
        self._closed = False
        self.num_spills = 0
        #: pipelined shuffle: each span's run ships through this hook as
        #: on_spill(run, spill_id) instead of being kept for the merge
        self.on_spill: Optional[Callable[[Run, int], None]] = None

    # -- write side ----------------------------------------------------------
    def write(self, key: bytes, value: bytes,
              partition: Optional[int] = None) -> None:
        """partition: pre-computed by a custom Partitioner; None = device
        hash."""
        if partition is not None and not 0 <= partition < self.num_partitions:
            raise ValueError(
                f"partitioner returned {partition}, valid range is "
                f"[0, {self.num_partitions})")
        self._span.add(key, value, partition)
        self._out_records_ctr.increment()
        if self._span.nbytes >= self.span_budget:
            self._sort_span()

    def write_batch(self, batch: KVBatch) -> None:
        self._span.add_batch(batch)
        self._out_records_ctr.increment(batch.num_records)
        if self._span.nbytes >= self.span_budget:
            self._sort_span()

    # -- span sort -----------------------------------------------------------
    def _precombine(self, batch: KVBatch,
                    custom_parts: Optional[np.ndarray],
                    skip: bool = False) -> KVBatch:
        """Hash-combine before the sort when the combiner allows it: with
        sum_long_combiner and fixed 8-byte long values, equal keys collapse
        to one record (first-occurrence order) so the sort sees each key
        once.  The post-sort combiner still runs (idempotent for sum) and
        covers the spans this step declines."""
        if skip or self.combiner is not sum_long_combiner or \
                custom_parts is not None:
            return batch
        n = batch.num_records
        if n < 2:
            return batch
        if not bool(np.all(np.diff(batch.val_offsets) == 8)):
            return batch   # long-serde fixed-8 values only
        first_idx, sums = native.hash_sum_native(
            batch.key_bytes, batch.key_offsets,
            decode_longs_be(batch.val_bytes, n))
        kb2, ko2 = gather_ragged(batch.key_bytes, batch.key_offsets,
                                 first_idx)
        vb = encode_longs_be(sums)
        vo = np.arange(len(sums) + 1, dtype=np.int64) * 8
        self.counters.increment(TaskCounter.COMBINE_INPUT_RECORDS, n)
        self.counters.increment(TaskCounter.COMBINE_OUTPUT_RECORDS,
                                len(sums))
        return KVBatch(kb2, ko2, vb, vo)

    def _take_span(self):
        """Hand the current span over as (batch, custom partitions, skip
        the precombine) and start a fresh one.  A span made of one
        pre-combined batch has nothing for the hash pass to collapse."""
        span, self._span = self._span, SpanBuffer()
        custom_parts = np.asarray(span.parts, dtype=np.int32) \
            if span.parts else None
        skip_pre = span.all_pre_combined and len(span.batches) == 1
        return span.to_batch(), custom_parts, skip_pre

    def _finalize_span(self) -> Run:
        """Sort + combine the current span."""
        batch, custom_parts, skip_pre = self._take_span()
        batch = self._precombine(batch, custom_parts, skip=skip_pre)
        run = self.sort_batch(batch, custom_partitions=custom_parts)
        if self.combiner is not None:
            run = self.combiner(run)
        self.num_spills += 1
        return run

    # -- async double-buffered span plane ------------------------------------
    def _ensure_pipeline(self):
        if self._pipeline is None:
            from tez_tpu_torch.ops.async_stage import (AsyncSpanPipeline,
                                                       process_breaker)
            breaker = self._breaker
            if breaker is None:
                breaker = process_breaker()
                breaker.configure(failures=self.breaker_failures,
                                  cooldown_ms=self.breaker_cooldown_ms)
            if self.device.type == "cuda":
                # build before any span: a build failure then raises here,
                # never inside a stage's watchdog window or ladder
                kernels.load()
            # one pinned staging slot per span the gate lets past staging
            self._streams = device_ops.SpanStreams(
                self.device, slots=self.pipeline_depth)
            self._pipeline = AsyncSpanPipeline(
                encode_fn=self._async_encode,
                stage_fn=self._async_h2d,
                dispatch_fn=self._async_dispatch,
                readback_fn=self._async_readback,
                coalesce_fn=self._async_coalesce,
                records_fn=lambda p: p["batch"].num_records,
                on_complete=self._async_complete,
                depth=self.pipeline_depth,
                coalesce_records=self.pipeline_coalesce_records,
                counters=self.counters,
                name="sorter-pipeline",
                failover_fn=self._async_failover,
                oom_retry_fn=self._async_oom_retry,
                breaker=breaker,
                watchdog_dispatch_ms=self.watchdog_dispatch_ms,
                watchdog_readback_ms=self.watchdog_readback_ms)
        return self._pipeline

    def _group_batch(self, ids, payloads) -> Tuple[KVBatch,
                                                   Optional[np.ndarray]]:
        """Rebuild one dispatch group's span from its raw payloads (the
        failover and retry paths re-run the precombine: the device
        attempt's encode results died with the attempt)."""
        batches = [self._precombine(p["batch"], p["custom_parts"],
                                    skip=p["skip_pre"]) for p in payloads]
        batch = batches[0] if len(batches) == 1 else KVBatch.concat(batches)
        # coalesced groups never carry custom partitions (_submit_span_async
        # excludes them from coalescing)
        custom_parts = payloads[0]["custom_parts"] if len(payloads) == 1 \
            else None
        return batch, custom_parts

    def _async_failover(self, ids, payloads) -> Run:
        """Host-engine failover for a failed device attempt (watchdog fire,
        device exception, breaker short-circuit): bit-exact with the device
        path."""
        batch, custom_parts = self._group_batch(ids, payloads)
        run = self.sort_batch(batch, custom_partitions=custom_parts,
                              engine="host")
        if self.combiner is not None:
            run = self.combiner(run)
        return run

    def _async_oom_retry(self, ids, payloads) -> Run:
        """Out-of-memory ladder: evict, then split.  Registered pressure
        hooks reclaim device memory first (the buffer store's
        relieve_device_pressure drops the lanes of idle DEVICE-tier runs)
        and the whole span retries on the device; only when nothing was
        evictable, or the whole-span retry runs out of memory again, is the
        span halved (recursively, down to split_min_bytes) before the host
        engine takes over.  Merging the stably sorted halves with run-age
        tie order equals the stable sort of the whole span."""
        from tez_tpu_torch.ops import async_stage
        batch, custom_parts = self._group_batch(ids, payloads)
        if self.device.type == "cuda":
            import torch
            # a real OutOfMemoryError leaves the failed attempt's blocks
            # cached on its streams: hand them back before the retry
            torch.cuda.empty_cache()
        freed = async_stage.relieve_pressure(batch.nbytes, self.counters)
        # the retry runs on a pipeline thread: make the sorter's device
        # current for its kernels' streams
        with device_ops.device_context(self.device):
            if freed > 0:
                try:
                    run = self.sort_batch(batch,
                                          custom_partitions=custom_parts,
                                          engine="device")
                    if self.combiner is not None:
                        run = self.combiner(run)
                    return run
                except BaseException as e:  # noqa: BLE001 -- ladder goes on
                    if not device_ops.is_resource_exhausted(e):
                        raise
            run = self._split_device_sort(batch, custom_parts,
                                          detail=f"span={min(ids)}")
        if self.combiner is not None:
            run = self.combiner(run)
        return run

    def _split_device_sort(self, batch: KVBatch,
                           custom_parts: Optional[np.ndarray],
                           detail: str) -> Run:
        from tez_tpu_torch.common import faults
        n = batch.num_records
        nbytes = int(batch.key_offsets[-1]) + int(batch.val_offsets[-1])
        if n < 2 or nbytes <= self.split_min_bytes:
            # at the floor: decline the retry -- the caller's ladder sends
            # the span to the host engine
            raise MemoryError(
                f"span at OOM-split floor ({nbytes}B <= "
                f"{self.split_min_bytes}B, n={n})")
        h = n // 2
        runs: List[Run] = []
        for lo, hi in ((0, h), (h, n)):
            half = batch.take(np.arange(lo, hi, dtype=np.int64))
            parts_half = custom_parts[lo:hi] if custom_parts is not None \
                else None
            try:
                if faults.armed():
                    faults.fire("device.dispatch.oom",
                                f"{detail}:split[{lo}:{hi})")
                runs.append(self.sort_batch(half,
                                            custom_partitions=parts_half,
                                            engine="device"))
                continue
            except BaseException as e:  # noqa: BLE001 -- recurse on OOM only
                if not device_ops.is_resource_exhausted(e):
                    raise
            # recurse outside the handler: the failed attempt's traceback
            # (and the device memory its frames hold) is gone by now
            runs.append(self._split_device_sort(half, parts_half, detail))
        # run-age tie order makes the merge of the stably sorted halves
        # identical to the stable sort of the concatenated span
        return merge_sorted_runs(runs, self.num_partitions, self.key_width,
                                 counters=self.counters, engine="device",
                                 key_normalizer=self.key_normalizer,
                                 device_min_records=self.device_min_records,
                                 device=self.device)

    def _submit_span_async(self) -> None:
        batch, custom_parts, skip_pre = self._take_span()
        spill_id = self.num_spills
        self.num_spills += 1
        # pipelined mode keeps one span per spill_id (consumers track spill
        # ids); store mode may coalesce -- the joint stable sort of adjacent
        # spans equals the merge of their individual sorts (ties keep
        # arrival order), so the flush merge's output is unchanged
        coalesce = self.on_spill is None and custom_parts is None
        self._ensure_pipeline().submit(
            spill_id,
            {"batch": batch, "custom_parts": custom_parts,
             "skip_pre": skip_pre},
            coalesce=coalesce)

    def _async_encode(self, payload: dict) -> dict:
        """Staging thread: precombine + host ragged->lane encode (the
        resident path's host work), overlapped with in-flight sorts."""
        batch = self._precombine(payload["batch"], payload["custom_parts"],
                                 skip=payload["skip_pre"])
        custom_parts = payload["custom_parts"]
        engine = self._span_engine(batch)
        if custom_parts is None and self.partitioner == "hash" and \
                engine != "host" and self.key_normalizer is None and \
                self.resident_keys and batch.num_records > 0:
            klens = batch.key_offsets[1:] - batch.key_offsets[:-1]
            wmax = int(klens.max(initial=1))
            if wmax <= self.key_width:
                eff = ((max(wmax, 1) + 3) // 4) * 4
                mat, lengths = pad_to_matrix(batch.key_bytes,
                                             batch.key_offsets, eff)
                return {"kind": "resident", "batch": batch,
                        "lanes": matrix_to_lanes(mat), "lengths": lengths}
        return {"kind": "generic", "batch": batch,
                "custom_parts": custom_parts}

    def _async_coalesce(self, staged_list: List[dict]) -> dict:
        batch = KVBatch.concat([s["batch"] for s in staged_list])
        if all(s["kind"] == "resident" for s in staged_list):
            width = max(s["lanes"].shape[1] for s in staged_list)
            # widening narrower views with ZERO lanes preserves order:
            # bytes beyond a key's length are zero in the lane encoding
            lanes = np.concatenate([
                s["lanes"] if s["lanes"].shape[1] == width else
                np.pad(s["lanes"], ((0, 0), (0, width - s["lanes"].shape[1])))
                for s in staged_list])
            lengths = np.concatenate([s["lengths"] for s in staged_list])
            return {"kind": "resident", "batch": batch,
                    "lanes": lanes, "lengths": lengths}
        return {"kind": "generic", "batch": batch, "custom_parts": None}

    def _async_h2d(self, staged: dict) -> dict:
        if staged["kind"] == "resident":
            staged["staged_dev"] = device_ops.stage_resident_span(
                staged["lanes"], staged["lengths"], self._streams)
        return staged

    def _async_dispatch(self, staged: dict) -> dict:
        t0 = time.time()
        if staged["kind"] == "resident":
            # the dict lets go of the staged tensors: after a failed
            # dispatch nothing holds them while the ladder retries
            inflight = device_ops.dispatch_resident_span(
                staged.pop("staged_dev"), self.num_partitions,
                streams=self._streams)
            return {"kind": "resident", "batch": staged["batch"],
                    "inflight": inflight, "t0": t0}
        # generic spans (normalizer / custom partitioner / host-routed /
        # over-width keys): the whole synchronous span sort runs here on
        # the staging thread, still overlapped with other spans' readback,
        # on the sorter's device and its compute stream (a fresh thread's
        # current device is the first card)
        with self._streams.on(self._streams.compute):
            run = self.sort_batch(staged["batch"],
                                  custom_partitions=staged["custom_parts"])
        return {"kind": "generic", "run": run, "t0": t0}

    def _async_readback(self, inflight: dict, ids) -> Run:
        if inflight["kind"] == "resident":
            sp, perm, dev = device_ops.readback_resident_span(
                inflight["inflight"])
            sorted_batch = inflight["batch"].take(perm)
            sorted_batch.dev_keys = dev
            self._record_sort_ms(inflight["t0"])
            run = Run.from_sorted_batch(sorted_batch, sp,
                                        self.num_partitions)
        else:
            run = inflight["run"]
        if self.combiner is not None:
            run = self.combiner(run)
        return run

    def _async_complete(self, ids, run: Run) -> None:
        """Completion callback: fires in completion order (out of order
        under delays); coalesced groups complete under their first spill
        id."""
        sid = min(ids)
        # under abort()'s lock: a completion either ships or stores before
        # the abort (its run is dropped with the others) or finds the
        # sorter aborted; none ships once abort() took the lock
        with self._abort_lock:
            if self._aborted:
                return
            on_spill = self.on_spill
            if on_spill is not None:
                on_spill(run, sid)
            else:
                with self._store_lock:
                    self._store_run(run)
                    self._async_store_ids.append(sid)

    def _drain_async(self) -> None:
        """Block until every submitted span completed, then restore spill-id
        order over the stored runs so the flush merge sees the run sequence
        of the synchronous engine (stable ties = run order)."""
        pipe, self._pipeline = self._pipeline, None
        if pipe is not None:
            pipe.drain()
            self._streams.close()
        if self._async_store_ids:
            order = sorted(range(len(self._async_store_ids)),
                           key=lambda i: self._async_store_ids[i])
            self._runs = [self._runs[i] for i in order]
            self._async_store_ids = []

    def _sort_span(self) -> None:
        if self._span.num_records == 0:
            return
        if self.pipeline_depth > 0:
            self._submit_span_async()
            return
        if self._executor is not None:
            # hand the full span to the sortmaster; keep collecting
            batch, custom_parts, skip_pre = self._take_span()
            spill_id = self.num_spills
            self.num_spills += 1

            def _bg() -> None:
                pre = self._precombine(batch, custom_parts, skip=skip_pre)
                run = self.sort_batch(pre, custom_partitions=custom_parts)
                if self.combiner is not None:
                    run = self.combiner(run)
                if self.on_spill is not None:
                    self.on_spill(run, spill_id)
                else:
                    with self._store_lock:
                        self._store_run(run)

            self._pending.append(self._executor.submit(_bg))
            return
        run = self._finalize_span()
        if self.on_spill is not None:
            # pipelined shuffle: each span ships immediately
            self.on_spill(run, self.num_spills - 1)
        else:
            self._store_run(run)

    def _span_engine(self, batch: KVBatch) -> str:
        key_nbytes = int(batch.key_offsets[-1]) if self._auto_engine else -1
        return _route_engine(self.engine, batch.num_records,
                             self.device_min_records,
                             key_nbytes=key_nbytes,
                             min_key_bytes=self.engine_min_bytes)

    def _record_sort_ms(self, t0: float) -> None:
        ms = (time.time() - t0) * 1000.0
        self.counters.find_counter(TaskCounter.DEVICE_SORT_MILLIS)\
            .increment(int(ms))
        metrics.observe("device.sort", ms, counters=self.counters)

    def sort_batch(self, batch: KVBatch,
                   custom_partitions: Optional[np.ndarray] = None,
                   engine: Optional[str] = None) -> Run:
        """Sort one span into a Run.  engine overrides the per-span routing
        ('host' | 'device'); None = normal routing."""
        t0 = time.time()
        if custom_partitions is not None:
            if len(custom_partitions) != batch.num_records:
                raise ValueError(
                    "custom partitions must cover every record in the span")
            if batch.num_records and (
                    int(custom_partitions.min()) < 0 or
                    int(custom_partitions.max()) >= self.num_partitions):
                raise ValueError(
                    f"partitioner returned ids outside "
                    f"[0, {self.num_partitions})")
        if engine is None:
            engine = self._span_engine(batch)
        klens = batch.key_offsets[1:] - batch.key_offsets[:-1]
        wmax = int(klens.max(initial=1))
        if custom_partitions is None and self.partitioner == "hash" and \
                engine != "host" and self.key_normalizer is None and \
                self.resident_keys and wmax <= self.key_width:
            # resident fast path: lanes sized to the actual max key length,
            # the full keys fit them, so the hash derives from the lanes on
            # the device, prefix order IS byte order (no tie-break), and the
            # sorted key columns stay on the device for the merge
            eff = ((max(wmax, 1) + 3) // 4) * 4
            mat, lengths = pad_to_matrix(batch.key_bytes, batch.key_offsets,
                                         eff)
            t_dev = time.time()
            sorted_partitions, perm, dev = device_ops.hash_sort_span_resident(
                matrix_to_lanes(mat), lengths, self.num_partitions,
                device=self.device)
            _record_ms("device.span", self.counters, t_dev)
            sorted_batch = batch.take(perm)
            sorted_batch.dev_keys = dev
            self._record_sort_ms(t0)
            return Run.from_sorted_batch(sorted_batch, sorted_partitions,
                                         self.num_partitions)
        sort_bytes, sort_offsets = _sort_keys(batch, self.key_normalizer)
        if engine == "host":
            return self._host_sort(batch, sort_bytes, sort_offsets,
                                   custom_partitions, t0)
        mat, lengths = pad_to_matrix(sort_bytes, sort_offsets, self.key_width)
        lanes = matrix_to_lanes(mat)
        t_dev = time.time()
        if custom_partitions is not None or self.partitioner != "hash":
            partitions = custom_partitions if custom_partitions is not None \
                else np.zeros(batch.num_records, dtype=np.int32)
            sorted_partitions, perm = device_ops.sort_run(
                partitions, lanes, lengths, device=self.device)
        else:
            # full-key FNV over a matrix padded to the longest key, so every
            # byte is hashed (host-partitioner parity)
            hash_w = 1 << max(2, (wmax - 1).bit_length())
            hmat, hlens = pad_to_matrix(batch.key_bytes, batch.key_offsets,
                                        hash_w)
            sorted_partitions, perm = device_ops.hash_sort_span(
                hmat, hlens, lanes, lengths, self.num_partitions,
                device=self.device)
        _record_ms("device.span", self.counters, t_dev)
        sorted_batch = batch.take(perm)
        sort_lengths, keyfn = _sorted_key_view(sort_bytes, sort_offsets, perm)
        refinement = _exact_tiebreak(
            sort_lengths, sorted_partitions, lanes[perm], self.key_width,
            keyfn)
        if refinement is not None:
            sorted_batch = sorted_batch.take(refinement)
        self._record_sort_ms(t0)
        return Run.from_sorted_batch(sorted_batch, sorted_partitions,
                                     self.num_partitions)

    def _host_sort(self, batch: KVBatch, sort_bytes: np.ndarray,
                   sort_offsets: np.ndarray,
                   custom_parts: Optional[np.ndarray], t0: float) -> Run:
        """The host engine (tez_tpu's _native_host_sort): the host library
        partitions by the FNV-1a of the full raw key and sorts stably by
        (partition, full sort key), with the GIL released.  Without a
        normalizer one fused call also writes the sorted batch out (the
        dedup path repeats each unique key in place)."""
        if self.key_normalizer is None:
            kb, ko, vb, vo, row_index = native.span_sort_emit_native(
                batch.key_bytes, batch.key_offsets, batch.val_bytes,
                batch.val_offsets, self.num_partitions, custom_parts,
                compute_hash=(custom_parts is None and
                              self.partitioner == "hash"))
            self._record_sort_ms(t0)
            return Run(KVBatch(kb, ko, vb, vo), row_index)
        if custom_parts is not None:
            parts = custom_parts
        elif self.partitioner == "hash" and self.num_partitions > 1:
            parts = native.fnv32_partition_native(
                batch.key_bytes, batch.key_offsets, self.num_partitions)
        else:
            parts = None    # every record in partition 0
        perm = native.sort_partition_keys_native(sort_bytes, sort_offsets,
                                                 parts)
        sorted_partitions = np.zeros(batch.num_records, dtype=np.int32) \
            if parts is None else parts[perm]
        self._record_sort_ms(t0)
        return Run.from_sorted_batch(batch.take(perm), sorted_partitions,
                                     self.num_partitions)

    def _store_run(self, run: Run) -> None:
        self.counters.increment(TaskCounter.SPILLED_RECORDS,
                                run.batch.num_records)
        if self.spill_dir is not None and \
                self._runs_nbytes + run.nbytes > self.mem_budget:
            path = os.path.join(self.spill_dir,
                                f"spill_{uuid.uuid4().hex}.prun")
            save_run_partitioned(run, path, codec=self.spill_codec)
            # a spilled run's key columns would only hold device memory
            run.batch.dev_keys = None
            # bytes actually written: with a codec, the disk I/O
            written = os.path.getsize(path)
            self.counters.increment(
                TaskCounter.ADDITIONAL_SPILLS_BYTES_WRITTEN, written)
            self.counters.increment(TaskCounter.ADDITIONAL_SPILL_COUNT)
            self.counters.increment(TaskCounter.HOST_SPILL_BYTES, written)
            self._runs.append(path)
        else:
            self._runs.append(run)
            self._runs_nbytes += run.nbytes

    def _drain_pending(self) -> None:
        """Join the sortmaster (its workers stored or shipped their runs
        already).  The executor always shuts down; then the first worker
        error re-raises."""
        error: Optional[BaseException] = None
        try:
            for fut in self._pending:
                try:
                    fut.result()
                except BaseException as e:  # noqa: BLE001
                    if error is None:
                        error = e
        finally:
            self._pending = []
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None
        if error is not None:
            raise error

    def abort(self) -> None:
        """A killed attempt's teardown (its task runner calls it; tez_tpu
        leaves the sorter as the kill found it).  Spans already dispatched
        finish on their streams, since a launched kernel cannot be
        recalled; then the async pipeline's threads stop, its stream pair
        goes back to SpanStreams for the next pipeline on this device, and
        every run is dropped with its spill file.  Nothing is shipped or
        published: completions of the spans in flight are discarded."""
        with self._abort_lock:
            self._aborted = True
            self.on_spill = None
        pipe, self._pipeline = self._pipeline, None
        try:
            if pipe is not None:
                pipe.drain()
            self._drain_pending()
        finally:
            if pipe is not None:
                self._streams.close()
            for run in self._runs:
                if isinstance(run, str) and os.path.exists(run):
                    os.remove(run)
            self._runs = []
            self._runs_nbytes = 0
            self._async_store_ids = []

    # -- flush ---------------------------------------------------------------
    def flush(self) -> Optional[Run]:
        """Final merge of all spans into one partition-sorted Run in RAM;
        None in pipelined mode (on_spill set).  A spilled flush's FileRun
        is read back and its file deleted; spill-scale callers want
        flush_run, which leaves the result on disk."""
        result = self.flush_run()
        if isinstance(result, FileRun):
            run = result.to_run()
            result.delete()
            return run
        return result

    def flush_run(self):
        """Final merge of all spans.  Returns None in pipelined mode (spans
        already shipped through on_spill; a trailing partial span ships
        here).

        With every run in RAM the result is a `Run` (the single span as it
        is, or the merge).  Once any span spilled, the merge streams: a
        partition-major block k-way merge (ops/block_merge.py) over the
        span files and the in-RAM runs, written as it goes to one
        partition-indexed file, returned as a `FileRun` (reference: the
        final IFile + TezSpillRecord of PipelinedSorter.java:559 ->
        TezMerger.java:76)."""
        if self._closed:
            raise RuntimeError("DeviceSorter already flushed")
        self._closed = True
        if self.pipeline_depth > 0:
            # async plane: the trailing span submits like any other, then
            # the drain barrier collects out-of-order completions and
            # restores spill-id order
            self._sort_span()
            self._drain_async()
            self._drain_pending()   # no-op unless the sortmaster ran
            if self.on_spill is not None:
                return None
        elif self.on_spill is not None:
            if self._span.num_records > 0:
                self._sort_span()
            self._drain_pending()
            return None
        else:
            if self._span.num_records > 0 and not self._runs and \
                    not self._pending:
                return self._finalize_span()    # everything fit one span
            self._sort_span()
            self._drain_pending()
        runs, self._runs = self._runs, []
        if not runs:
            return Run(KVBatch.empty(),
                       np.zeros(self.num_partitions + 1, dtype=np.int64))
        if any(isinstance(r, str) for r in runs):
            return self._stream_final_merge(runs)
        if len(runs) == 1:
            return runs[0]
        merged = merge_sorted_runs(
            runs, self.num_partitions, self.key_width,
            counters=self.counters, engine=self.engine,
            merge_factor=self.merge_factor,
            key_normalizer=self.key_normalizer,
            device_min_records=self.device_min_records, device=self.device)
        if self.combiner is not None:
            merged = self.combiner(merged)
        return merged

    def _stream_final_merge(self, runs: List["Run | str"]) -> FileRun:
        """Block merge of the spilled and in-RAM runs, partition by
        partition, into one partition-indexed file."""
        from tez_tpu_torch.ops.block_merge import iter_merged_blocks
        sources: List["Run | FileRun"] = []
        for r in runs:
            if isinstance(r, str):
                self.counters.increment(
                    TaskCounter.ADDITIONAL_SPILLS_BYTES_READ,
                    os.path.getsize(r))
                sources.append(FileRun(r))
            else:
                sources.append(r)
        path = os.path.join(self.spill_dir,
                            f"final_{uuid.uuid4().hex}.prun")
        writer = PartitionedRunWriter(path, self.num_partitions,
                                      codec=self.spill_codec)
        self.counters.increment(TaskCounter.MERGED_MAP_OUTPUTS, len(sources))
        try:
            for p in range(self.num_partitions):
                srcs = []
                for s in sources:
                    if s.partition_row_count(p) == 0:
                        continue
                    srcs.append(s.iter_partition_blocks(p)
                                if isinstance(s, FileRun)
                                else iter([s.partition(p)]))
                for block in iter_merged_blocks(
                        srcs, self.key_width, engine=self.engine,
                        key_normalizer=self.key_normalizer,
                        merge_factor=self.merge_factor,
                        device_min_records=self.device_min_records,
                        device=self.device):
                    if self.combiner is not None:
                        # block-local combine, legal for an associative
                        # combiner: a key split across block edges keeps at
                        # most one extra record per edge, which the
                        # consumer's grouped reader unifies
                        block = self.combiner(Run(
                            block, np.array([0, block.num_records],
                                            dtype=np.int64))).batch
                    writer.append(block, p)
            writer.close()
        except BaseException:
            writer.abort()
            raise
        self.counters.increment(TaskCounter.ADDITIONAL_SPILLS_BYTES_WRITTEN,
                                writer.bytes_written)
        # the span files are dead now
        for r in runs:
            if isinstance(r, str):
                try:
                    os.remove(r)
                except OSError:
                    pass
        return FileRun(path)


def _merge_resident_partitioned(live: Sequence[Run], num_partitions: int
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-partition resident merge: each run's device key columns are
    (partition, key)-sorted, so partition p is rows [row_index[p],
    row_index[p+1]) of its view; merge those slices per partition, in run
    order.  Returns (permutation into the concat of live runs' batches,
    row_index)."""
    offs = np.zeros(len(live), dtype=np.int64)
    if len(live) > 1:
        np.cumsum([r.batch.num_records for r in live[:-1]], out=offs[1:])
    pieces: List[np.ndarray] = []
    counts = np.zeros(num_partitions, dtype=np.int64)
    for p in range(num_partitions):
        slices, bases = [], []
        for r, off in zip(live, offs):
            lo, hi = int(r.row_index[p]), int(r.row_index[p + 1])
            if hi > lo:
                lanes_dev, lens_dev, _lo0, _n = r.batch.dev_keys
                slices.append((lanes_dev, lens_dev, lo, hi))
                bases.append(off + lo)
        if not slices:
            continue
        perm = device_ops.merge_resident_slices(slices)
        cnts = np.asarray([hi - lo for (_l, _n, lo, hi) in slices],
                          dtype=np.int64)
        bounds = np.zeros(len(cnts) + 1, dtype=np.int64)
        np.cumsum(cnts, out=bounds[1:])
        sl = np.searchsorted(bounds[1:], perm, side="right")
        pieces.append(np.asarray(bases, dtype=np.int64)[sl] +
                      (perm - bounds[sl]))
        counts[p] = len(perm)
    row_index = np.zeros(num_partitions + 1, dtype=np.int64)
    np.cumsum(counts, out=row_index[1:])
    total = np.concatenate(pieces) if pieces else np.zeros(0, np.int64)
    return total, row_index


def _count_merge(counters: Optional[TezCounters], t0: float,
                 nruns: int) -> None:
    if counters is not None:
        counters.find_counter(TaskCounter.DEVICE_MERGE_MILLIS)\
            .increment(int((time.time() - t0) * 1000))
        counters.increment(TaskCounter.MERGED_MAP_OUTPUTS, nruns)


def merge_sorted_runs(runs: Sequence[Run], num_partitions: int,
                      key_width: int,
                      counters: Optional[TezCounters] = None,
                      engine: str = "device",
                      merge_factor: int = 0,
                      key_normalizer: Optional[Callable[[bytes], bytes]]
                      = None,
                      device_min_records: int = DEVICE_SORT_MIN_RECORDS,
                      device="cuda") -> Run:
    """k-way merge of partition-sorted runs (TezMerger analog); equal keys
    keep run order.

    Runs whose key columns are all device-resident take the resident merge
    (per-partition slices ranked in place); the rest take the generic
    merge-path merge over freshly encoded lanes with the partition as the
    leading lane, then the host tie-break for keys wider than key_width,
    or, on the host engine (below device_min_records), the host library's
    merge (_host_merge).
    With key_normalizer set the runs are sorted by normalized keys, which
    the generic merge encodes (the device key columns hold raw keys).
    merge_factor > 1 bounds how many runs merge per pass (io.sort.factor)."""
    dev = device_ops.resolve_device(device)
    engine = resolve_engine(engine)
    if merge_factor > 1 and len(runs) > merge_factor:
        level = list(runs)
        while len(level) > merge_factor:
            nxt = []
            for i in range(0, len(level), merge_factor):
                chunk = level[i:i + merge_factor]
                # inner passes skip counters: only the final pass reports
                nxt.append(chunk[0] if len(chunk) == 1 else
                           merge_sorted_runs(
                               chunk, num_partitions, key_width, None,
                               engine, key_normalizer=key_normalizer,
                               device_min_records=device_min_records,
                               device=dev))
            level = nxt
        runs = level
    t0 = time.time()
    if engine != "host" and key_normalizer is None:
        live = [r for r in runs if r.batch.num_records > 0]
        if live and all(r.batch.dev_keys is not None for r in live):
            # resident merge: mixed lane widths widen with zero lanes
            if num_partitions == 1:
                perm = device_ops.merge_resident_slices(
                    [r.batch.dev_keys for r in live])
                row_index = None
            else:
                perm, row_index = _merge_resident_partitioned(
                    live, num_partitions)
            _record_ms("device.merge", counters, t0)
            batch = KVBatch.concat([r.batch for r in live])
            sorted_batch = batch.take(perm)
            _count_merge(counters, t0, len(runs))
            if row_index is None:
                row_index = np.array([0, sorted_batch.num_records], np.int64)
            return Run(sorted_batch, row_index)
    # hybrid routing for the generic path only
    engine = _route_engine(engine, sum(r.batch.num_records for r in runs),
                           device_min_records)
    if engine == "host":
        return _host_merge(runs, num_partitions, key_normalizer, counters,
                           t0)
    batch = KVBatch.concat([r.batch for r in runs])
    partitions = _run_partitions(runs)
    sort_bytes, sort_offsets = _sort_keys(batch, key_normalizer)
    mat, lengths = pad_to_matrix(sort_bytes, sort_offsets, key_width)
    lanes = matrix_to_lanes(mat)
    # the inputs are pre-sorted runs: the O(N) merge-path ladder
    run_bounds = _run_bounds(runs)
    cut = [slice(run_bounds[i], run_bounds[i + 1]) for i in range(len(runs))]
    t_dev = time.time()
    perm = device_ops.merge_path_runs([partitions[c] for c in cut],
                                      [lanes[c] for c in cut],
                                      [lengths[c] for c in cut], device=dev)
    _record_ms("device.merge", counters, t_dev)
    sorted_partitions = partitions[perm]
    sorted_batch = batch.take(perm)
    sort_lengths, keyfn = _sorted_key_view(sort_bytes, sort_offsets, perm)
    refinement = _exact_tiebreak(sort_lengths, sorted_partitions,
                                 lanes[perm], key_width, keyfn)
    if refinement is not None:
        sorted_batch = sorted_batch.take(refinement)
    _count_merge(counters, t0, len(runs))
    return Run.from_sorted_batch(sorted_batch, sorted_partitions,
                                 num_partitions)


def _run_partitions(runs: Sequence[Run]) -> np.ndarray:
    """The partition of every row of the runs' concatenation."""
    return np.concatenate([
        np.repeat(np.arange(r.num_partitions, dtype=np.int32),
                  np.diff(r.row_index)) for r in runs]) \
        if runs else np.zeros(0, np.int32)


def _run_bounds(runs: Sequence[Run]) -> np.ndarray:
    run_bounds = np.zeros(len(runs) + 1, dtype=np.int64)
    np.cumsum([r.batch.num_records for r in runs], out=run_bounds[1:])
    return run_bounds


def _host_merge(runs: Sequence[Run], num_partitions: int,
                key_normalizer: Optional[Callable[[bytes], bytes]],
                counters: Optional[TezCounters], t0: float) -> Run:
    """The host engine's merge (tez_tpu's merge_emit_native /
    merge_runs_native): full-key compares in the host library, equal
    (partition, key) rows in the order of `runs` (the merge queue's age
    order), the GIL released."""
    live = [r for r in runs if r.batch.num_records > 0]
    if key_normalizer is None and live and \
            all(r.num_partitions == num_partitions for r in live):
        # group-scan each run, merge the group heads, copy each group out
        # whole: no concatenation and no row gather
        kb, ko, vb, vo, row_index = native.merge_emit_native(
            [(r.batch.key_bytes, r.batch.key_offsets, r.batch.val_bytes,
              r.batch.val_offsets, r.row_index) for r in live],
            num_partitions)
        _count_merge(counters, t0, len(runs))
        return Run(KVBatch(kb, ko, vb, vo), row_index)
    # the runs are already sorted: a ladder of in-place merges of the
    # concatenation replaces a full re-sort
    batch = KVBatch.concat([r.batch for r in runs])
    partitions = _run_partitions(runs)
    sort_bytes, sort_offsets = _sort_keys(batch, key_normalizer)
    perm = native.merge_runs_native(
        sort_bytes, sort_offsets,
        partitions if num_partitions > 1 else None, _run_bounds(runs))
    _count_merge(counters, t0, len(runs))
    return Run.from_sorted_batch(batch.take(perm), partitions[perm],
                                 num_partitions)


# ---------------------------------------------------------------------------
# combiners
# ---------------------------------------------------------------------------
def sum_long_combiner(run: Run) -> Run:
    """Sums 8-byte big-endian-long values of equal (partition, key) groups
    (the WordCount/OrderedWordCount combiner)."""
    batch = run.batch
    n = batch.num_records
    if n == 0:
        return run
    ko, kb = batch.key_offsets, batch.key_bytes
    lengths = ko[1:] - ko[:-1]
    partitions = np.repeat(np.arange(run.num_partitions, dtype=np.int32),
                           np.diff(run.row_index))
    # adjacent-equal detection (sorted within partition): same partition,
    # same length, same bytes
    same = np.zeros(n, dtype=bool)
    if n > 1:
        cand = (partitions[1:] == partitions[:-1]) & \
            (lengths[1:] == lengths[:-1])
        idx = np.flatnonzero(cand)
        same[idx + 1] = adjacent_equal_rows(kb, ko, idx)
    group_starts = np.flatnonzero(~same)
    if not bool(np.all(np.diff(batch.val_offsets) == 8)):
        raise ValueError("sum_long_combiner needs 8-byte long values")
    nums = batch.val_bytes.reshape(n, 8).astype(np.uint64)
    weights = (256 ** np.arange(7, -1, -1)).astype(np.uint64)
    unsigned = (nums * weights).sum(axis=1, dtype=np.uint64)
    # encoding is val + 2^63 (mod 2^64) == top-bit flip of two's complement
    sums = np.add.reduceat((unsigned ^ np.uint64(1 << 63)).view(np.int64),
                           group_starts)
    vb = encode_longs_be(sums)
    vo = np.arange(len(group_starts) + 1, dtype=np.int64) * 8
    kb2, ko2 = gather_ragged(kb, ko, group_starts)
    new_counts = np.bincount(partitions[group_starts],
                             minlength=run.num_partitions).astype(np.int64)
    row_index = np.zeros(run.num_partitions + 1, dtype=np.int64)
    np.cumsum(new_counts, out=row_index[1:])
    return Run(KVBatch(kb2, ko2, vb, vo), row_index)
