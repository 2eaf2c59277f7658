"""Device sorter: PipelinedSorter semantics on the port's CUDA kernels.

The synchronous path of tez_tpu/ops/sorter.py: records collect into spans;
each full span is sorted on the device (hash partition + stable
(partition, key) sort); flush merges the spans.  Sorted key columns stay on
the device as ``Run.batch.dev_keys`` so a merge of fresh runs ranks them in
place (the resident merge); runs without them take the generic merge-path
merge.  Rows whose keys exceed the lane width get a host tie-break pass, so
the final order is full raw-byte order for any key length.

Not ported yet (a caller that asks for them gets NotImplementedError): the
async span plane (pipeline_depth > 0) and its containment ladder, host
spill (spill_dir), and custom key normalizers.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from tez_tpu_torch.common import metrics
from tez_tpu_torch.common.counters import TaskCounter, TezCounters
from tez_tpu_torch.ops import device as device_ops
from tez_tpu_torch.ops.keycodec import matrix_to_lanes, pad_to_matrix
from tez_tpu_torch.ops.runformat import (KVBatch, Run, adjacent_equal_rows,
                                         gather_ragged)
from tez_tpu_torch.ops.serde import encode_longs_be


def _exact_tiebreak(lengths: np.ndarray, partitions: np.ndarray,
                    lanes: np.ndarray, width: int,
                    keyfn: Callable[[int], bytes]) -> Optional[np.ndarray]:
    """Refinement permutation for rows whose sorted (partition, prefix)
    group holds a key longer than `width`, or None if exact already.  Host
    cost is proportional to colliding rows only."""
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


def _sorted_key_view(key_bytes: np.ndarray, key_offsets: np.ndarray,
                     perm: np.ndarray
                     ) -> Tuple[np.ndarray, Callable[[int], bytes]]:
    """(lengths, keyfn) over the keys in sorted order."""
    starts = key_offsets[:-1][perm]
    lengths = (key_offsets[1:] - key_offsets[:-1])[perm]

    def keyfn(i: int) -> bytes:
        s = int(starts[i])
        return key_bytes[s:s + int(lengths[i])].tobytes()

    return lengths, keyfn


class SpanBuffer:
    """Collect-side buffer: records accumulated until the span budget."""

    def __init__(self) -> None:
        self.keys: List[bytes] = []
        self.vals: List[bytes] = []
        self.parts: List[int] = []     # only when a custom partitioner runs
        self.nbytes = 0
        self.batches: List[KVBatch] = []
        self._partitioned: Optional[bool] = None   # set by the first add

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
        self.keys.append(key)
        self.vals.append(value)
        if partition is not None:
            self.parts.append(partition)
        self.nbytes += len(key) + len(value) + 16

    def add_batch(self, batch: KVBatch) -> None:
        self._set_mode(False)
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


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to tez_tpu_torch yet")


def _record_ms(name: str, counters: Optional[TezCounters],
               t0: float) -> None:
    metrics.observe(name, (time.time() - t0) * 1000.0, counters=counters)


class DeviceSorter:
    """The OrderedPartitionedKVOutput engine (synchronous spans)."""

    def __init__(self, num_partitions: int, key_width: int = 16,
                 span_budget_bytes: int = 256 << 20,
                 spill_dir: Optional[str] = None,
                 counters: Optional[TezCounters] = None,
                 combiner: Optional[Combiner] = None,
                 partitioner: str = "hash",
                 engine: str = "device",
                 merge_factor: int = 64,
                 key_normalizer: Optional[Callable[[bytes], bytes]] = None,
                 resident_keys: bool = True,
                 device_min_records: int = DEVICE_SORT_MIN_RECORDS,
                 engine_min_bytes: int = ENGINE_MIN_KEY_BYTES,
                 pipeline_depth: int = 0,
                 device="cuda"):
        if pipeline_depth > 0:
            raise _not_ported("the async span plane (pipeline_depth > 0)")
        if spill_dir is not None:
            raise _not_ported("host spill (spill_dir)")
        if key_normalizer is not None:
            raise _not_ported("custom key normalization (key_normalizer)")
        self.device = device_ops.resolve_device(device)
        self.num_partitions = num_partitions
        self.key_width = max(4, key_width)
        self.engine = resolve_engine(engine)   # 'device' | 'host'
        #: width-aware routing applies to engines requested as `auto` only
        self._auto_engine = engine == "auto"
        self.engine_min_bytes = engine_min_bytes
        self.device_min_records = device_min_records
        #: keep sorted key lanes on the device for downstream merges
        self.resident_keys = resident_keys
        self.span_budget = span_budget_bytes
        self.counters = counters or TezCounters()
        self._out_records_ctr = self.counters.find_counter(
            TaskCounter.OUTPUT_RECORDS)
        self.combiner = combiner
        self.partitioner = partitioner
        #: bounded k-way merge width (reference: io.sort.factor)
        self.merge_factor = merge_factor
        self._span = SpanBuffer()
        self._runs: List[Run] = []
        self._closed = False
        self.num_spills = 0

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
    def _finalize_span(self) -> Run:
        """Sort + combine the current span."""
        batch = self._span.to_batch()
        custom_parts = np.asarray(self._span.parts, dtype=np.int32) \
            if self._span.parts else None
        self._span = SpanBuffer()
        run = self.sort_batch(batch, custom_partitions=custom_parts)
        if self.combiner is not None:
            run = self.combiner(run)
        self.num_spills += 1
        return run

    def _sort_span(self) -> None:
        if self._span.num_records == 0:
            return
        self._store_run(self._finalize_span())

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
                engine != "host" and self.resident_keys and \
                wmax <= self.key_width:
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
        mat, lengths = pad_to_matrix(batch.key_bytes, batch.key_offsets,
                                     self.key_width)
        lanes = matrix_to_lanes(mat)
        from tez_tpu_torch.ops.host_sort import (host_hash_partition,
                                                 host_sort_run)
        t_dev = time.time()
        if custom_partitions is not None or self.partitioner != "hash":
            partitions = custom_partitions if custom_partitions is not None \
                else np.zeros(batch.num_records, dtype=np.int32)
            if engine == "host":
                sorted_partitions, perm = host_sort_run(partitions, lanes,
                                                        lengths)
            else:
                sorted_partitions, perm = device_ops.sort_run(
                    partitions, lanes, lengths, device=self.device)
        else:
            # full-key FNV over a matrix padded to the longest key, so every
            # byte is hashed (host-partitioner parity)
            hash_w = 1 << max(2, (wmax - 1).bit_length())
            hmat, hlens = pad_to_matrix(batch.key_bytes, batch.key_offsets,
                                        hash_w)
            if engine == "host":
                partitions = host_hash_partition(hmat, hlens,
                                                 self.num_partitions)
                sorted_partitions, perm = host_sort_run(partitions, lanes,
                                                        lengths)
            else:
                sorted_partitions, perm = device_ops.hash_sort_span(
                    hmat, hlens, lanes, lengths, self.num_partitions,
                    device=self.device)
        if engine != "host":
            _record_ms("device.span", self.counters, t_dev)
        sorted_batch = batch.take(perm)
        sort_lengths, keyfn = _sorted_key_view(batch.key_bytes,
                                               batch.key_offsets, perm)
        refinement = _exact_tiebreak(
            sort_lengths, sorted_partitions, lanes[perm], self.key_width,
            keyfn)
        if refinement is not None:
            sorted_batch = sorted_batch.take(refinement)
        self._record_sort_ms(t0)
        return Run.from_sorted_batch(sorted_batch, sorted_partitions,
                                     self.num_partitions)

    def _store_run(self, run: Run) -> None:
        self.counters.increment(TaskCounter.SPILLED_RECORDS,
                                run.batch.num_records)
        self._runs.append(run)

    # -- flush ---------------------------------------------------------------
    def flush(self) -> Run:
        """Final merge of all spans into one partition-sorted Run."""
        if self._closed:
            raise RuntimeError("DeviceSorter already flushed")
        self._closed = True
        if self._span.num_records > 0 and not self._runs:
            return self._finalize_span()    # everything fit one span
        self._sort_span()
        runs, self._runs = self._runs, []
        if not runs:
            return Run(KVBatch.empty(),
                       np.zeros(self.num_partitions + 1, dtype=np.int64))
        if len(runs) == 1:
            return runs[0]
        merged = merge_sorted_runs(
            runs, self.num_partitions, self.key_width,
            counters=self.counters, engine=self.engine,
            merge_factor=self.merge_factor,
            device_min_records=self.device_min_records, device=self.device)
        if self.combiner is not None:
            merged = self.combiner(merged)
        return merged


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
    leading lane, then the host tie-break for keys wider than key_width.
    merge_factor > 1 bounds how many runs merge per pass (io.sort.factor)."""
    if key_normalizer is not None:
        raise _not_ported("custom key normalization (key_normalizer)")
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
                               engine, device_min_records=device_min_records,
                               device=dev))
            level = nxt
        runs = level
    t0 = time.time()
    if engine != "host":
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
    batch = KVBatch.concat([r.batch for r in runs])
    partitions = np.concatenate([
        np.repeat(np.arange(r.num_partitions, dtype=np.int32),
                  np.diff(r.row_index)) for r in runs]) \
        if runs else np.zeros(0, np.int32)
    mat, lengths = pad_to_matrix(batch.key_bytes, batch.key_offsets,
                                 key_width)
    lanes = matrix_to_lanes(mat)
    if engine == "host":
        from tez_tpu_torch.ops.host_sort import host_sort_run
        sorted_partitions, perm = host_sort_run(partitions, lanes, lengths)
    else:
        # the inputs are pre-sorted runs: the O(N) merge-path ladder
        run_bounds = np.zeros(len(runs) + 1, dtype=np.int64)
        np.cumsum([r.batch.num_records for r in runs], out=run_bounds[1:])
        cut = [slice(run_bounds[i], run_bounds[i + 1])
               for i in range(len(runs))]
        t_dev = time.time()
        perm = device_ops.merge_path_runs([partitions[c] for c in cut],
                                      [lanes[c] for c in cut],
                                      [lengths[c] for c in cut], device=dev)
        _record_ms("device.merge", counters, t_dev)
        sorted_partitions = partitions[perm]
    sorted_batch = batch.take(perm)
    sort_lengths, keyfn = _sorted_key_view(batch.key_bytes,
                                           batch.key_offsets, perm)
    refinement = _exact_tiebreak(sort_lengths, sorted_partitions,
                                 lanes[perm], key_width, keyfn)
    if refinement is not None:
        sorted_batch = sorted_batch.take(refinement)
    _count_merge(counters, t0, len(runs))
    return Run.from_sorted_batch(sorted_batch, sorted_partitions,
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
