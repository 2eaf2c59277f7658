"""Blockwise vectorized k-way merge over block-sorted KVBatch streams (the
port of tez_tpu/ops/block_merge.py).

The spill-scale analog of TezMerger's record-streaming MergeQueue
(tez-runtime-library/.../common/sort/impl/TezMerger.java:76): sources
advance one *block prefix* at a time and every prefix set merges with the
vectorized run merge (`ops.sorter.merge_sorted_runs`: numpy on the host,
or on the device the resident merge or the merge-path ladder, both over
already sorted slices), so Python cost is O(blocks), not O(records).

Per round, over sources that are iterators of KVBatch blocks, each sorted
and ordered across blocks within the source:
    boundary  = min over sources of (last key of current block)
    emit      = merge of each source's rows strictly below the boundary
    then      = each source's rows equal to the boundary, in source order
The source owning the boundary drains its whole block each round, so each
record is merged once and a round's Python cost is k bisects of
O(log block) byte compares.

Equal keys across sources emerge in source-list order (pass sources in run
age order for the reference's MergeQueue arrival-order semantics); within a
source, producer order is preserved exactly.  With a key normalizer (a
custom comparator) every comparison is on normalized keys, computed once
per block.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from tez_tpu_torch.ops.runformat import KVBatch, Run

__all__ = ["iter_merged_blocks"]


class _Source:
    """One block-sorted input stream with its sort-key view (the normalized
    keys when a normalizer is set)."""

    def __init__(self, blocks: Iterator[KVBatch],
                 normalizer: Optional[Callable[[bytes], bytes]]):
        self.blocks = blocks
        self.normalizer = normalizer
        self.batch: Optional[KVBatch] = None
        self.sort_bytes: Optional[np.ndarray] = None
        self.sort_offsets: Optional[np.ndarray] = None
        self.pos = 0

    def advance(self) -> bool:
        """Load the next non-empty block; False when exhausted."""
        from tez_tpu_torch.ops.sorter import _sort_keys
        for batch in self.blocks:
            if batch.num_records == 0:
                continue
            self.batch = batch
            self.sort_bytes, self.sort_offsets = _sort_keys(batch,
                                                            self.normalizer)
            self.pos = 0
            return True
        self.batch = None
        return False

    def sort_key(self, i: int) -> bytes:
        o = self.sort_offsets
        return self.sort_bytes[int(o[i]):int(o[i + 1])].tobytes()

    def last_key(self) -> bytes:
        return self.sort_key(self.batch.num_records - 1)

    def lower_bound(self, key: bytes) -> int:
        """First row index in [pos, n) whose sort key is >= `key`."""
        lo, hi = self.pos, self.batch.num_records
        while lo < hi:
            mid = (lo + hi) // 2
            if self.sort_key(mid) < key:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def upper_bound(self, key: bytes) -> int:
        """First row index in [pos, n) whose sort key exceeds `key`."""
        lo, hi = self.pos, self.batch.num_records
        while lo < hi:
            mid = (lo + hi) // 2
            if self.sort_key(mid) <= key:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def take_to(self, cut: int) -> Optional[KVBatch]:
        """Consume rows [pos, cut); None when empty."""
        if cut <= self.pos:
            return None
        piece = self.batch.slice_rows(self.pos, cut)
        self.pos = cut
        return piece

    def drain_equal(self, key: bytes) -> Iterator[KVBatch]:
        """Stream this source's whole run of rows == `key`, across block
        boundaries (ties must emit contiguously, source by source), a piece
        at a time so a hot key never materializes whole."""
        while self.batch is not None:
            if self.pos < self.batch.num_records and \
                    self.sort_key(self.pos) != key:
                return
            piece = self.take_to(self.upper_bound(key))
            if piece is not None:
                yield piece
            if self.pos < self.batch.num_records:
                return
            if not self.advance():
                return


def iter_merged_blocks(
        sources: Sequence[Iterator[KVBatch]],
        key_width: int,
        engine: str = "host",
        key_normalizer: Optional[Callable[[bytes], bytes]] = None,
        merge_factor: int = 64,
        device_min_records: Optional[int] = None,
        counters=None,
        device="cuda") -> Iterator[KVBatch]:
    """Yield globally sorted KVBatch blocks merged from k block-sorted
    sources.  Resident memory is one block per source plus one merge
    round's output.  `device` runs the device engine's rounds;
    `key_normalizer` orders the records by their normalized keys."""
    from tez_tpu_torch.ops.sorter import (DEVICE_SORT_MIN_RECORDS,
                                          merge_sorted_runs)
    if device_min_records is None:
        device_min_records = DEVICE_SORT_MIN_RECORDS
    active: List[_Source] = []
    for it in sources:
        s = _Source(iter(it), key_normalizer)
        if s.advance():
            active.append(s)
    while active:
        if len(active) == 1:
            # single remaining source: its blocks are already sorted
            s = active[0]
            if s.pos == 0:
                yield s.batch
            elif s.pos < s.batch.num_records:
                yield s.batch.slice_rows(s.pos, s.batch.num_records)
            while s.advance():
                yield s.batch
            return
        boundary = min(s.last_key() for s in active)
        # rows strictly below the boundary: no source can still hold an
        # unseen row below it, so they merge now
        slices: List[Run] = []
        for s in active:
            piece = s.take_to(s.lower_bound(boundary))
            if piece is not None:
                slices.append(Run(piece, np.array([0, piece.num_records],
                                                  dtype=np.int64)))
        if len(slices) == 1:
            yield slices[0].batch
        elif slices:
            merged = merge_sorted_runs(
                slices, 1, key_width, counters=counters, engine=engine,
                merge_factor=merge_factor, key_normalizer=key_normalizer,
                device_min_records=device_min_records, device=device)
            yield merged.batch
        # rows == boundary, per source in source order and contiguously
        # across each source's blocks: the heap merge's tie order
        for s in active:
            yield from s.drain_equal(boundary)
        active = [s for s in active if s.batch is not None]
