"""Run format: columnar KV batches and partition-sorted runs (the in-RAM half
of tez_tpu.ops.runformat; host spill files are not part of this port yet).

A run is a columnar quad -- key bytes + offsets, value bytes + offsets --
plus a partition row index.  All host work here is numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tez_tpu_torch.ops.device import resolve_device


def _ranges(lengths: np.ndarray) -> np.ndarray:
    """[3,1,2] -> [0,1,2, 0, 0,1] (per-segment aranges)."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.zeros(len(lengths), dtype=np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return np.arange(total, dtype=np.int64) - np.repeat(starts, lengths)


def gather_ragged(data: np.ndarray, offsets: np.ndarray,
                  perm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Permute a ragged array: returns (new_data, new_offsets).

    Fixed-width rows take a reshape-and-index fast path; the generic path
    builds one int64 index per byte, which at span scale costs 8x the data
    in memory."""
    n_src = len(offsets) - 1
    if n_src > 0:
        w = int(offsets[1]) - int(offsets[0])
        if w > 0 and int(offsets[-1]) == n_src * w and \
                not bool((offsets[1:] != offsets[:-1] + w).any()):
            fixed = data[:n_src * w].reshape(n_src, w)[perm]
            return fixed.reshape(-1), np.arange(len(perm) + 1,
                                                dtype=np.int64) * w
    lengths = offsets[1:] - offsets[:-1]
    new_lengths = lengths[perm]
    new_offsets = np.zeros(len(perm) + 1, dtype=np.int64)
    np.cumsum(new_lengths, out=new_offsets[1:])
    idx = np.repeat(offsets[:-1][perm], new_lengths) + _ranges(new_lengths)
    return data[idx], new_offsets


def adjacent_equal_rows(data: np.ndarray, offsets: np.ndarray,
                        cand: np.ndarray) -> np.ndarray:
    """For each candidate row i (rows i and i+1 have equal byte length),
    True where row i's bytes equal row i+1's."""
    m = len(cand)
    if m == 0:
        return np.zeros(0, dtype=bool)
    lengths = (offsets[1:] - offsets[:-1])[cand]
    out = np.ones(m, dtype=bool)          # zero-length pairs are equal
    nz = np.flatnonzero(lengths)
    if len(nz) == 0:
        return out
    nz_cand = cand[nz]
    nz_len = lengths[nz]
    within = _ranges(nz_len)
    idx_a = np.repeat(offsets[nz_cand], nz_len) + within
    idx_b = np.repeat(offsets[nz_cand + 1], nz_len) + within
    neq = data[idx_a] != data[idx_b]
    pair_starts = np.zeros(len(nz), dtype=np.int64)
    np.cumsum(nz_len[:-1], out=pair_starts[1:])
    mismatches = np.add.reduceat(neq.astype(np.int64), pair_starts)
    out[nz] = mismatches == 0
    return out


def concat_ragged(parts: Sequence[Tuple[np.ndarray, np.ndarray]]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate (data, offsets) raggeds."""
    if not parts:
        return np.zeros(0, np.uint8), np.zeros(1, np.int64)
    data = np.concatenate([p[0] for p in parts])
    sizes = [len(p[1]) - 1 for p in parts]
    offsets = np.zeros(sum(sizes) + 1, dtype=np.int64)
    pos, base = 1, 0
    for (d, o), sz in zip(parts, sizes):
        offsets[pos:pos + sz] = o[1:] + base
        base += len(d)
        pos += sz
    return data, offsets


@dataclasses.dataclass
class KVBatch:
    """Columnar record batch: ragged keys + ragged values.

    dev_keys optionally carries a device-resident view of the sort keys --
    (lanes int32[NB, L] holding u32 bits, lengths int32[NB], lo, hi) where
    rows [lo, hi) align with this batch's rows and the tail rows are
    sentinels (lanes 0xFFFFFFFF, length -1).  take() and concat() drop it:
    a reorder invalidates the row alignment."""
    key_bytes: np.ndarray     # uint8[..]
    key_offsets: np.ndarray   # int64[N+1]
    val_bytes: np.ndarray
    val_offsets: np.ndarray
    dev_keys: Optional[tuple] = dataclasses.field(
        default=None, compare=False, repr=False)

    @property
    def num_records(self) -> int:
        return len(self.key_offsets) - 1

    @property
    def nbytes(self) -> int:
        return (self.key_bytes.nbytes + self.val_bytes.nbytes +
                self.key_offsets.nbytes + self.val_offsets.nbytes)

    def key(self, i: int) -> bytes:
        return self.key_bytes[self.key_offsets[i]:self.key_offsets[i + 1]]\
            .tobytes()

    def take(self, perm: np.ndarray) -> "KVBatch":
        kb, ko = gather_ragged(self.key_bytes, self.key_offsets, perm)
        vb, vo = gather_ragged(self.val_bytes, self.val_offsets, perm)
        return KVBatch(kb, ko, vb, vo)

    @staticmethod
    def empty() -> "KVBatch":
        z = np.zeros(0, np.uint8)
        o = np.zeros(1, np.int64)
        return KVBatch(z, o, z.copy(), o.copy())

    @staticmethod
    def concat(batches: Sequence["KVBatch"]) -> "KVBatch":
        kb, ko = concat_ragged([(b.key_bytes, b.key_offsets) for b in batches])
        vb, vo = concat_ragged([(b.val_bytes, b.val_offsets) for b in batches])
        return KVBatch(kb, ko, vb, vo)

    @staticmethod
    def from_pairs(pairs: Sequence[Tuple[bytes, bytes]]) -> "KVBatch":
        ko = np.zeros(len(pairs) + 1, dtype=np.int64)
        vo = np.zeros(len(pairs) + 1, dtype=np.int64)
        for i, (k, v) in enumerate(pairs):
            ko[i + 1] = ko[i] + len(k)
            vo[i + 1] = vo[i] + len(v)
        kb = np.frombuffer(b"".join(k for k, _ in pairs), np.uint8).copy()
        vb = np.frombuffer(b"".join(v for _, v in pairs), np.uint8).copy()
        return KVBatch(kb, ko, vb, vo)


@dataclasses.dataclass
class Run:
    """A partition-sorted KV run + partition row index: rows
    [row_index[p], row_index[p+1]) belong to partition p, key-sorted."""
    batch: KVBatch
    row_index: np.ndarray     # int64[P+1]

    @property
    def num_partitions(self) -> int:
        return len(self.row_index) - 1

    @staticmethod
    def from_sorted_batch(batch: KVBatch, sorted_partitions: np.ndarray,
                          num_partitions: int) -> "Run":
        """Build the row index from the (sorted) per-row partition ids."""
        counts = np.bincount(sorted_partitions, minlength=num_partitions)\
            .astype(np.int64)
        row_index = np.zeros(num_partitions + 1, dtype=np.int64)
        np.cumsum(counts, out=row_index[1:])
        return Run(batch, row_index)

    # -- state carry-over ----------------------------------------------------
    @staticmethod
    def from_arrays(key_bytes: np.ndarray, key_offsets: np.ndarray,
                    val_bytes: np.ndarray, val_offsets: np.ndarray,
                    row_index: np.ndarray,
                    dev_lanes: Optional[np.ndarray] = None,
                    dev_lengths: Optional[np.ndarray] = None,
                    device: str = "cuda") -> "Run":
        """Build a Run from host arrays -- e.g. those of a tez_tpu Run and its
        resident key columns read back as numpy.  dev_lanes (uint32[>=N, L])
        and dev_lengths (int32[>=N]) become the resident view on `device`;
        their rows [0, N) must align with the batch, and any rows beyond N
        must be tail sentinels."""
        batch = KVBatch(np.ascontiguousarray(key_bytes, dtype=np.uint8),
                        np.asarray(key_offsets, dtype=np.int64),
                        np.ascontiguousarray(val_bytes, dtype=np.uint8),
                        np.asarray(val_offsets, dtype=np.int64))
        if (dev_lanes is None) != (dev_lengths is None):
            raise ValueError("dev_lanes and dev_lengths go together")
        if dev_lanes is not None:
            n = batch.num_records
            if dev_lanes.shape[0] < n or dev_lengths.shape[0] != \
                    dev_lanes.shape[0]:
                raise ValueError("resident key columns do not cover the batch")
            dev = resolve_device(device)
            lanes = torch.from_numpy(np.array(
                dev_lanes, dtype=np.uint32).view(np.int32)).to(dev)
            lens = torch.from_numpy(np.array(
                dev_lengths, dtype=np.int32)).to(dev)
            batch.dev_keys = (lanes, lens, 0, n)
        return Run(batch, np.asarray(row_index, dtype=np.int64))

    def to_arrays(self) -> tuple:
        """Inverse of from_arrays: (key_bytes, key_offsets, val_bytes,
        val_offsets, row_index, dev_lanes, dev_lengths) as numpy; the last
        two are the resident rows aligned with the batch (uint32 and int32),
        or None without a resident view."""
        b = self.batch
        dev_lanes = dev_lengths = None
        if b.dev_keys is not None:
            lanes, lens, lo, hi = b.dev_keys
            dev_lanes = lanes[lo:hi].cpu().numpy().view(np.uint32)
            dev_lengths = lens[lo:hi].cpu().numpy()
        return (b.key_bytes, b.key_offsets, b.val_bytes, b.val_offsets,
                self.row_index, dev_lanes, dev_lengths)
