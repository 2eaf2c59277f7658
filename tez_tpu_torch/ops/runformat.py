"""Run format: the IFile analog for sorted runs in device memory, host
RAM or host spill files (tez_tpu.ops.runformat, wire format byte for byte).

A run is a columnar quad -- key bytes + offsets, value bytes + offsets --
plus a partition row index.  Spilled to disk, a run is a checksummed blob
(Run.save / Run.load) or a partition-indexed file of length-prefixed
single-partition blocks (PartitionedRunWriter / FileRun), which a merge
streams block by block.  All host work here is numpy.
"""
from __future__ import annotations

import dataclasses
import io
import os
import struct
import zlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tez_tpu_torch.common import faults
from tez_tpu_torch.ops import native
from tez_tpu_torch.ops.device import resolve_device

MAGIC = b"TPRUN1"
#: MAGIC + pack("<BIQ", flag, crc32(payload), len(payload)).  The CRC covers
#: the payload only, so bytes corrupted below the header surface as the
#: checksum IOError, not as a codec decode error.
RUN_HEADER_NBYTES = len(MAGIC) + 13


def _zstd_codec():
    import zstandard   # imported on first use only
    comp = zstandard.ZstdCompressor(level=1)
    dec = zstandard.ZstdDecompressor()
    return comp.compress, dec.decompress


def _lz4_codec():
    try:
        import lz4.frame
    except ImportError:
        raise ValueError(
            "run codec 'lz4' requires the lz4 module, which is not "
            "available in this environment (supported here: zlib, zstd)"
        ) from None
    return lz4.frame.compress, lz4.frame.decompress


#: codec name -> (wire flag, lazy (compress, decompress) factory).  The flag
#: is stored in the run header, so blobs stay self-describing.
_CODECS = {
    None: (0, lambda: (lambda b: b, lambda b: b)),
    "zlib": (1, lambda: (lambda b: zlib.compress(b, 1), zlib.decompress)),
    "zstd": (2, _zstd_codec),
    "lz4": (3, _lz4_codec),
}
_FLAG_TO_NAME = {flag: name for name, (flag, _) in _CODECS.items()}


def resolve_codec(codec: Optional[str]):
    """-> (wire flag, compress, decompress); an unknown name raises rather
    than write uncompressed."""
    entry = _CODECS.get(codec)
    if entry is None:
        raise ValueError(f"unsupported run codec {codec!r} "
                         f"(supported: zlib, zstd, lz4)")
    flag, factory = entry
    compress, decompress = factory()
    return flag, compress, decompress


def resolve_codec_flag(flag: int):
    if flag not in _FLAG_TO_NAME:
        raise ValueError(f"unknown run codec flag {flag}")
    name = _FLAG_TO_NAME[flag]
    return (name,) + resolve_codec(name)[1:]


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

    From MIN_NATIVE_BYTES of data the host library copies rows on several
    threads (fixed-width rows of up to 64 bytes through gather_fixed_u8,
    others through gather_ragged_u8); smaller arrays take numpy, where a
    thread spawn would cost more than the copy (tez_tpu's routing)."""
    n_src = len(offsets) - 1
    w = int(offsets[1]) - int(offsets[0]) if n_src > 0 else 0
    fixed = w > 0 and int(offsets[-1]) == n_src * w and \
        not bool((offsets[1:] != offsets[:-1] + w).any())
    if data.nbytes >= native.MIN_NATIVE_BYTES:
        if fixed and w <= 64:
            return (native.gather_fixed_native(data, w, perm),
                    np.arange(len(perm) + 1, dtype=np.int64) * w)
        return native.gather_ragged_native(data, offsets, perm)
    if fixed:
        return (data[:n_src * w].reshape(n_src, w)[perm].reshape(-1),
                np.arange(len(perm) + 1, dtype=np.int64) * w)
    return _gather_ragged_numpy(data, offsets, perm)


def _gather_ragged_numpy(data: np.ndarray, offsets: np.ndarray,
                         perm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """gather_ragged in numpy: one int64 index a byte."""
    lengths = offsets[1:] - offsets[:-1]
    new_lengths = lengths[perm]
    new_offsets = np.zeros(len(perm) + 1, dtype=np.int64)
    np.cumsum(new_lengths, out=new_offsets[1:])
    idx = np.repeat(offsets[:-1][perm], new_lengths) + _ranges(new_lengths)
    return data[idx], new_offsets


def adjacent_equal_rows(data: np.ndarray, offsets: np.ndarray,
                        cand: np.ndarray) -> np.ndarray:
    """For each candidate row i (rows i and i+1 have equal byte length),
    True where row i's bytes equal row i+1's.  From MIN_NATIVE_BYTES of
    compared bytes a threaded memcmp in the host library; numpy below."""
    if len(cand) == 0:
        return np.zeros(0, dtype=bool)
    if int((offsets[1:] - offsets[:-1])[cand].sum()) >= \
            native.MIN_NATIVE_BYTES:
        return native.adjacent_equal_native(data, offsets, cand)
    return _adjacent_equal_numpy(data, offsets, cand)


def _adjacent_equal_numpy(data: np.ndarray, offsets: np.ndarray,
                          cand: np.ndarray) -> np.ndarray:
    """adjacent_equal_rows in numpy: one int64 index a compared byte."""
    m = len(cand)
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
    sentinels (lanes 0xFFFFFFFF, length -1).  take(), concat(),
    serialization and pickling drop it: a reorder invalidates the row
    alignment, and device handles never cross processes; slice_rows()
    keeps it as a view."""
    key_bytes: np.ndarray     # uint8[..]
    key_offsets: np.ndarray   # int64[N+1]
    val_bytes: np.ndarray
    val_offsets: np.ndarray
    dev_keys: Optional[tuple] = dataclasses.field(
        default=None, compare=False, repr=False)
    #: producer promise: keys in this batch are already unique (e.g. a
    #: fused tokenize+count aggregator), so the sorter skips its pre-sort
    #: hash combine for spans made only of such batches.  Dropped (False)
    #: by take(), concat() and serialization, like dev_keys.
    pre_combined: bool = dataclasses.field(
        default=False, compare=False, repr=False)

    def __getstate__(self) -> dict:
        state = self.__dict__.copy()
        state["dev_keys"] = None   # device handles never cross processes
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)

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

    def value(self, i: int) -> bytes:
        return self.val_bytes[self.val_offsets[i]:self.val_offsets[i + 1]]\
            .tobytes()

    def take(self, perm: np.ndarray) -> "KVBatch":
        kb, ko = gather_ragged(self.key_bytes, self.key_offsets, perm)
        vb, vo = gather_ragged(self.val_bytes, self.val_offsets, perm)
        return KVBatch(kb, ko, vb, vo)

    def slice_rows(self, start: int, stop: int) -> "KVBatch":
        ko = self.key_offsets[start:stop + 1]
        vo = self.val_offsets[start:stop + 1]
        dev = None
        if self.dev_keys is not None:
            lanes, lens, lo, _hi = self.dev_keys
            dev = (lanes, lens, lo + start, lo + stop)   # view, no copy
        # the subtraction already yields fresh int64 arrays
        return KVBatch(
            self.key_bytes[ko[0]:ko[-1]], ko - ko[0],
            self.val_bytes[vo[0]:vo[-1]], vo - vo[0],
            dev_keys=dev)

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

    def iter_pairs(self) -> Iterator[Tuple[bytes, bytes]]:
        for i in range(self.num_records):
            yield self.key(i), self.value(i)


@dataclasses.dataclass
class Run:
    """A partition-sorted KV run + partition row index: rows
    [row_index[p], row_index[p+1]) belong to partition p, key-sorted."""
    batch: KVBatch
    row_index: np.ndarray     # int64[P+1]

    @property
    def num_partitions(self) -> int:
        return len(self.row_index) - 1

    def partition(self, p: int) -> KVBatch:
        return self.batch.slice_rows(int(self.row_index[p]),
                                     int(self.row_index[p + 1]))

    def partition_row_count(self, p: int) -> int:
        return int(self.row_index[p + 1] - self.row_index[p])

    def partition_nbytes(self, p: int) -> int:
        s, e = int(self.row_index[p]), int(self.row_index[p + 1])
        return int((self.batch.key_offsets[e] - self.batch.key_offsets[s]) +
                   (self.batch.val_offsets[e] - self.batch.val_offsets[s]))

    def empty_partition_flags(self) -> List[bool]:
        return [self.partition_row_count(p) == 0
                for p in range(self.num_partitions)]

    @property
    def nbytes(self) -> int:
        return self.batch.nbytes

    # -- host-spill serialization (checksummed; IFileOutputStream analog) ----
    # Offset arrays travel DELTA-CODED: per-record lengths in the narrowest
    # unsigned dtype that fits (wire chars '1'/'2'/'4' = u8/u16/u32), raw
    # int64 offsets beyond that or for a rebased view.
    _DELTA_CHARS = {b"1": np.uint8, b"2": np.uint16, b"4": np.uint32}

    @staticmethod
    def _encode_offsets(offsets: np.ndarray) -> Tuple[bytes, np.ndarray]:
        if len(offsets) and int(offsets[0]) != 0:
            # delta coding rebuilds from base 0: a rebased view ships raw
            return offsets.dtype.char.encode(), offsets
        lens = np.diff(offsets)
        m = int(lens.max(initial=0))
        if m < (1 << 8):
            return b"1", lens.astype(np.uint8)
        if m < (1 << 16):
            return b"2", lens.astype(np.uint16)
        if m < (1 << 32):
            return b"4", lens.astype(np.uint32)
        return offsets.dtype.char.encode(), offsets

    @staticmethod
    def _decode_offsets(char: bytes, raw: np.ndarray) -> np.ndarray:
        offsets = np.zeros(len(raw) + 1, dtype=np.int64)
        np.cumsum(raw, out=offsets[1:])
        return offsets

    def _wire_arrays(self) -> List[Tuple[bytes, np.ndarray]]:
        kc, ko = self._encode_offsets(self.batch.key_offsets)
        vc, vo = self._encode_offsets(self.batch.val_offsets)
        return [(self.batch.key_bytes.dtype.char.encode(),
                 self.batch.key_bytes),
                (kc, ko),
                (self.batch.val_bytes.dtype.char.encode(),
                 self.batch.val_bytes),
                (vc, vo),
                (self.row_index.dtype.char.encode(), self.row_index)]

    def to_bytes(self, codec: Optional[str] = None) -> bytes:
        flag, compress, _ = resolve_codec(codec)
        buf = io.BytesIO()
        for char, a in self._wire_arrays():
            raw = compress(np.ascontiguousarray(a).tobytes())
            buf.write(struct.pack("<cQ", char, len(raw)))
            buf.write(raw)
        payload = buf.getvalue()
        header = MAGIC + struct.pack(
            "<BIQ", flag, zlib.crc32(payload), len(payload))
        return header + payload

    @staticmethod
    def from_bytes(data: bytes, where: str = "<bytes>") -> "Run":
        if data[:len(MAGIC)] != MAGIC:
            raise IOError(f"bad run magic in {where}")
        off = len(MAGIC)
        flag, crc, size = struct.unpack_from("<BIQ", data, off)
        off += 1 + 4 + 8
        payload = data[off:off + size]
        if zlib.crc32(payload) != crc:
            raise IOError(f"checksum mismatch in {where}")
        try:
            _, _, decompress = resolve_codec_flag(flag)
        except ValueError as e:
            raise IOError(f"{e} in {where}") from None
        buf = io.BytesIO(payload)
        arrays = []
        for _ in range(5):
            dtype_c, length = struct.unpack("<cQ", buf.read(9))
            raw = decompress(buf.read(length))
            dt = Run._DELTA_CHARS.get(dtype_c)
            if dt is not None:
                arrays.append(Run._decode_offsets(
                    dtype_c, np.frombuffer(raw, dtype=dt)))
            else:
                arrays.append(np.frombuffer(raw, dtype=np.dtype(
                    dtype_c.decode())).copy())
        kb, ko, vb, vo, ri = arrays
        return Run(KVBatch(kb, ko, vb, vo), ri)

    def write_to(self, fh, codec: Optional[str] = None) -> int:
        """Stream this run into an open file.  Uncompressed, each wire array
        is written from its own buffer (one checksum pass, one write pass,
        no assembled blob); codecs go through to_bytes.  Returns the bytes
        written."""
        flag, _compress, _ = resolve_codec(codec)
        if flag != 0:
            blob = self.to_bytes(codec)
            fh.write(blob)
            return len(blob)
        pairs = [(c, np.ascontiguousarray(a)) for c, a in
                 self._wire_arrays()]
        headers = [struct.pack("<cQ", c, a.nbytes) for c, a in pairs]
        crc = 0
        for h, (_c, a) in zip(headers, pairs):
            crc = zlib.crc32(h, crc)
            crc = zlib.crc32(memoryview(a).cast("B"), crc)
        size = sum(len(h) + a.nbytes for h, (_c, a) in zip(headers, pairs))
        fh.write(MAGIC + struct.pack("<BIQ", 0, crc, size))
        for h, (_c, a) in zip(headers, pairs):
            fh.write(h)
            fh.write(memoryview(a).cast("B"))
        return len(MAGIC) + 13 + size

    def save(self, path: str, codec: Optional[str] = None) -> None:
        from tez_tpu_torch.common import metrics
        faults.fire("spill.write", detail=path)
        with metrics.timer("spill.write"):
            tmp = path + ".tmp"
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(tmp, "wb") as fh:
                self.write_to(fh, codec)
            os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "Run":
        faults.fire("spill.read", detail=path)
        with open(path, "rb") as fh:
            data = fh.read()
        data = faults.corrupt_bytes("spill.read", path, data,
                                    lo=RUN_HEADER_NBYTES)
        return Run.from_bytes(data, where=path)

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


def _write_block(fh, piece: KVBatch, codec: Optional[str]) -> int:
    """Write one length-prefixed single-partition Run blob (the block format
    of ChunkedRunWriter and PartitionedRunWriter).  Returns the blob size
    without the 8-byte prefix."""
    run = Run(piece, np.array([0, piece.num_records], dtype=np.int64))
    if codec is None:
        # streamed write: the length is backfilled after the pass (the
        # writers' targets are regular seekable files)
        at = fh.tell()
        fh.write(struct.pack("<Q", 0))
        size = run.write_to(fh)
        end = fh.tell()
        fh.seek(at)
        fh.write(struct.pack("<Q", size))
        fh.seek(end)
    else:
        blob = run.to_bytes(codec)
        size = len(blob)
        fh.write(struct.pack("<Q", size))
        fh.write(blob)
    return size


class ChunkedRunWriter:
    """Append-only on-disk run of globally sorted record blocks: a sequence
    of length-prefixed single-partition Run blobs, each sorted and ordered
    after the one before, so a reader streams the run one block at a time
    (the consumer-side spill target, reference MergeManager.java:387)."""

    def __init__(self, path: str, codec: Optional[str] = None,
                 block_records: int = 65536):
        self.path = path
        self.codec = codec
        self.block_records = block_records
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path + ".tmp", "wb")
        self.blocks = 0
        self.records = 0
        self.bytes_written = 0

    def append(self, batch: KVBatch) -> None:
        """Append a sorted batch, split into bounded blocks."""
        for s in range(0, batch.num_records, self.block_records):
            piece = batch.slice_rows(s, min(s + self.block_records,
                                            batch.num_records))
            size = _write_block(self._fh, piece, self.codec)
            self.blocks += 1
            self.records += piece.num_records
            self.bytes_written += size + 8

    def close(self) -> str:
        self._fh.close()
        os.replace(self.path + ".tmp", self.path)
        return self.path


def iter_chunked_run(path: str):
    """Stream the sorted blocks of a ChunkedRunWriter file, one block in
    memory at a time."""
    with open(path, "rb") as fh:
        while True:
            raw = fh.read(8)
            if len(raw) < 8:
                return
            (n,) = struct.unpack("<Q", raw)
            yield Run.from_bytes(fh.read(n), where=path).batch


PR_MAGIC = b"TZPRUN1\n"
PR_FOOTER_MAGIC = b"TZPRIDX1"


class PartitionedRunWriter:
    """On-disk partition-indexed run, the spill-scale twin of `Run` (the
    IFile + TezSpillRecord analog, reference IFile.java:67 and
    TezSpillRecord.java): length-prefixed sorted single-partition Run blobs
    appended partition-major (partition ids non-decreasing), then a footer
    index of per-partition byte ranges, row counts and KV byte sizes.  Each
    partition is one contiguous byte range of whole blocks."""

    def __init__(self, path: str, num_partitions: int,
                 codec: Optional[str] = None, block_records: int = 65536):
        self.path = path
        self.num_partitions = num_partitions
        self.codec = codec
        self.block_records = block_records
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path + ".tmp", "wb")
        self._fh.write(PR_MAGIC)
        self._pos = len(PR_MAGIC)
        self._byte_off = np.full(num_partitions + 1, -1, dtype=np.int64)
        self._byte_off[0] = self._pos
        self._rows = np.zeros(num_partitions, dtype=np.int64)
        self._kv_bytes = np.zeros(num_partitions, dtype=np.int64)
        self._cur = 0
        self.bytes_written = 0

    def _advance_to(self, partition: int) -> None:
        if partition < self._cur:
            raise ValueError(
                f"partition-major order violated: {partition} after "
                f"{self._cur}")
        while self._cur < partition:
            self._cur += 1
            self._byte_off[self._cur] = self._pos

    def append(self, batch: KVBatch, partition: int) -> None:
        """Append a sorted batch of `partition`, split into bounded
        blocks."""
        self._advance_to(partition)
        for s in range(0, batch.num_records, self.block_records):
            piece = batch.slice_rows(
                s, min(s + self.block_records, batch.num_records))
            size = _write_block(self._fh, piece, self.codec)
            self._pos += 8 + size
            self.bytes_written += 8 + size
        self._rows[partition] += batch.num_records
        self._kv_bytes[partition] += int(
            batch.key_offsets[-1] + batch.val_offsets[-1])

    def append_run(self, run: Run) -> None:
        """Append a whole partition-sorted run (the span-spill path)."""
        for p in range(run.num_partitions):
            if run.partition_row_count(p):
                self.append(run.partition(p), p)

    def abort(self) -> None:
        """Failure cleanup: close the handle and remove the temp file."""
        try:
            self._fh.close()
        except OSError:
            pass
        try:
            os.remove(self.path + ".tmp")
        except OSError:
            pass

    def close(self) -> str:
        if self.num_partitions > 0:
            self._advance_to(self.num_partitions - 1)
        self._byte_off[self.num_partitions] = self._pos
        footer = io.BytesIO()
        footer.write(struct.pack("<I", self.num_partitions))
        footer.write(self._byte_off.tobytes())
        footer.write(self._rows.tobytes())
        footer.write(self._kv_bytes.tobytes())
        payload = footer.getvalue()
        self._fh.write(payload)
        self._fh.write(struct.pack("<IQ", zlib.crc32(payload), len(payload)))
        self._fh.write(PR_FOOTER_MAGIC)
        self._fh.close()
        os.replace(self.path + ".tmp", self.path)
        return self.path


class FileRun:
    """Run-shaped view over a PartitionedRunWriter file: `num_partitions`,
    `partition()`, `partition_nbytes()`, `partition_row_count()`,
    `empty_partition_flags()` and `nbytes`, with the records left on disk.
    `partition()` materializes one partition; `iter_partition_blocks()`
    streams it a block at a time for merges."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            end = fh.tell()
            fh.seek(end - len(PR_FOOTER_MAGIC) - 12)
            crc, size = struct.unpack("<IQ", fh.read(12))
            if fh.read(len(PR_FOOTER_MAGIC)) != PR_FOOTER_MAGIC:
                raise IOError(f"bad partitioned-run footer in {path}")
            fh.seek(end - len(PR_FOOTER_MAGIC) - 12 - size)
            payload = fh.read(size)
            if zlib.crc32(payload) != crc:
                raise IOError(f"partitioned-run index checksum in {path}")
            (p,) = struct.unpack_from("<I", payload)
            off = 4
            self.num_partitions = p
            self._byte_off = np.frombuffer(payload, np.int64, p + 1, off)
            off += (p + 1) * 8
            self._rows = np.frombuffer(payload, np.int64, p, off)
            off += p * 8
            self._kv_bytes = np.frombuffer(payload, np.int64, p, off)

    @property
    def nbytes(self) -> int:
        return int(self._kv_bytes.sum())

    def partition_row_count(self, p: int) -> int:
        return int(self._rows[p])

    def partition_nbytes(self, p: int) -> int:
        return int(self._kv_bytes[p])

    def empty_partition_flags(self) -> List[bool]:
        return [int(r) == 0 for r in self._rows]

    def iter_partition_blocks(self, p: int) -> Iterator[KVBatch]:
        """Stream partition p's sorted blocks."""
        lo, hi = int(self._byte_off[p]), int(self._byte_off[p + 1])
        if lo >= hi:
            return
        faults.fire("spill.read", detail=self.path)
        with open(self.path, "rb") as fh:
            fh.seek(lo)
            pos = lo
            while pos < hi:
                (n,) = struct.unpack("<Q", fh.read(8))
                blob = faults.corrupt_bytes("spill.read", self.path,
                                            fh.read(n), lo=RUN_HEADER_NBYTES)
                yield Run.from_bytes(blob, where=self.path).batch
                pos += 8 + n

    def partition(self, p: int) -> KVBatch:
        blocks = list(self.iter_partition_blocks(p))
        if not blocks:
            return KVBatch.empty()
        return blocks[0] if len(blocks) == 1 else KVBatch.concat(blocks)

    def to_run(self) -> Run:
        """Materialize the whole run in RAM."""
        parts = [self.partition(p) for p in range(self.num_partitions)]
        row_index = np.zeros(self.num_partitions + 1, dtype=np.int64)
        np.cumsum(self._rows, out=row_index[1:])
        return Run(KVBatch.concat(parts) if parts else KVBatch.empty(),
                   row_index)

    def delete(self) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass


def save_run_partitioned(run: Run, path: str, codec: Optional[str] = None,
                         block_records: int = 65536) -> str:
    """Write a partition-sorted in-RAM Run as a partition-indexed file."""
    from tez_tpu_torch.common import metrics
    faults.fire("spill.write", detail=path)
    with metrics.timer("spill.write"):
        w = PartitionedRunWriter(path, run.num_partitions, codec=codec,
                                 block_records=block_records)
        w.append_run(run)
        return w.close()
