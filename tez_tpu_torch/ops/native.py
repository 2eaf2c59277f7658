"""ctypes bindings of the host library (``tez_tpu_torch/native``).

The port's counterpart of tez_tpu/ops/native.py: ``native/ragged.cpp``
(the ragged gathers, the precombine, the tokenizer and its word-count
aggregator, the FNV partition) and ``native/spansort.cpp`` (the host
engine's span sort and run merges), built by g++ into one library at first
use (``ops/_build.py``).  tez_tpu answers None where its library is
missing and its callers take numpy; here a missing g++ or a failed build
or load raises ``HostLibraryError``, and a binding never answers None.
Where the C code rejects an input (a non-zero return code) the binding
raises ``ValueError``.

Beside each binding sits its plain numpy version (``*_plain``), from the
numpy branches tez_tpu keeps for a missing library.  Only the tests and
chip_smoke.py call them, to hold the library against them.

``calls`` counts the calls into each C function, as ``kernels.launches``
counts kernel launches.  The threaded functions take
``min(8, os.cpu_count())`` threads, as tez_tpu's do; their results do not
depend on the count (``threads=`` is there for the tests).  ctypes
releases the GIL for the length of every call.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tez_tpu_torch.ops._build import HostLibraryError  # noqa: F401
from tez_tpu_torch.ops._build import host_library

#: Below this many bytes the thread spawn outweighs the copy.
MIN_NATIVE_BYTES = 1 << 20

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
#: (argtypes, restype) of every C function the bindings call
_SIGNATURES = {
    "gather_ragged_u8": ([_P, _P, _P, _I64, _P, _P, _I32], None),
    "gather_fixed_u8": ([_P, _I64, _P, _I64, _P, _I32], None),
    "adjacent_equal_u8": ([_P, _P, _P, _I64, _P, _I32], None),
    "hash_sum_i64": ([_P, _P, _I64, _P, _P, _P], _I64),
    "tz_split_ws": ([_P, _I64, _P, _P], _I64),
    "tz_wc_create": ([], _P),
    "tz_wc_feed": ([_P, _P, _I64], None),
    "tz_wc_stats": ([_P, _P, _P], None),
    "tz_wc_emit": ([_P, _P, _P, _P], None),
    "tz_wc_destroy": ([_P], None),
    "tz_fnv32_partition": ([_P, _P, _I64, _I32, _P, _I32], None),
    "tz_sort_partition_keys": ([_P, _P, _P, _I64, _P, _I32], None),
    "tz_span_sort_emit": ([_P, _P, _P, _P, _I64, _I32, _P, _I32,
                           _P, _P, _P, _P, _P, _P, _I32], _I32),
    "tz_merge_runs": ([_P, _P, _P, _P, _I32, _P, _I32], None),
    "tz_merge_emit": ([_I32, _P, _P, _P, _P, _P, _P, _I32,
                       _P, _P, _P, _P, _P, _P, _I32], _I32),
}

#: calls into each C function; reset with reset_calls()
calls: Dict[str, int] = dict.fromkeys(_SIGNATURES, 0)
_calls_lock = threading.Lock()
_fns: Dict[str, object] = {}


def reset_calls() -> None:
    with _calls_lock:
        for k in calls:
            calls[k] = 0


def load() -> None:
    """Build and load the library now, before any binding is timed."""
    host_library()


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(host_library(), name)
        fn.argtypes, fn.restype = _SIGNATURES[name]
        _fns[name] = fn
    return fn


def _call(name: str, *args):
    out = _fn(name)(*args)
    with _calls_lock:
        calls[name] += 1
    return out


def _threads(threads: Optional[int]) -> int:
    return threads if threads is not None else min(8, os.cpu_count() or 1)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(a, dtype=np.uint8)
                                if isinstance(a, (bytes, bytearray,
                                                  memoryview)) else a)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _check_partitions(partitions: Optional[np.ndarray], n: int,
                      num_partitions: Optional[int] = None
                      ) -> Optional[np.ndarray]:
    """int32 partitions of n rows, each in [0, num_partitions) (or >= 0):
    the C code sizes its buckets by them."""
    if partitions is None:
        return None
    partitions = np.ascontiguousarray(partitions, dtype=np.int32)
    if len(partitions) != n:
        raise ValueError(f"{len(partitions)} partitions for {n} rows")
    if n and (int(partitions.min()) < 0 or (
            num_partitions is not None and
            int(partitions.max()) >= num_partitions)):
        raise ValueError("partition ids outside [0, num_partitions)")
    return partitions


def _check_rows(idx: np.ndarray, n: int) -> None:
    """Row indices the C code dereferences: each in [0, n)."""
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise ValueError(f"row indices outside [0, {n})")


def _row_index(part_counts: np.ndarray) -> np.ndarray:
    row_index = np.zeros(len(part_counts) + 1, dtype=np.int64)
    np.cumsum(part_counts, out=row_index[1:])
    return row_index


# ---------------------------------------------------------------------------
# the gathers
# ---------------------------------------------------------------------------
def gather_ragged_native(data: np.ndarray, offsets: np.ndarray,
                         perm: np.ndarray, threads: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Rows `perm` of a ragged array, by threaded per-row copies: (data,
    offsets)."""
    data, offsets, perm = _u8(data), _i64(offsets), _i64(perm)
    _check_rows(perm, len(offsets) - 1)
    lengths = offsets[1:] - offsets[:-1]
    out_offsets = np.zeros(len(perm) + 1, dtype=np.int64)
    np.cumsum(lengths[perm], out=out_offsets[1:])
    out = np.empty(int(out_offsets[-1]), dtype=np.uint8)
    _call("gather_ragged_u8", _ptr(data), _ptr(offsets), _ptr(perm),
          len(perm), _ptr(out_offsets), _ptr(out), _threads(threads))
    return out, out_offsets


def gather_ragged_plain(data: np.ndarray, offsets: np.ndarray,
                        perm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    from tez_tpu_torch.ops.runformat import _gather_ragged_numpy
    return _gather_ragged_numpy(np.asarray(data), _i64(offsets),
                                _i64(perm))


def gather_fixed_native(data: np.ndarray, row_len: int, perm: np.ndarray,
                        threads: Optional[int] = None) -> np.ndarray:
    """Rows `perm` of fixed `row_len`-byte rows: out[i] =
    data[perm[i] * row_len:][:row_len]."""
    data, perm = _u8(data), _i64(perm)
    if row_len <= 0:
        raise ValueError(f"row_len {row_len} must be positive")
    _check_rows(perm, len(data) // row_len)
    out = np.empty(len(perm) * row_len, dtype=np.uint8)
    _call("gather_fixed_u8", _ptr(data), row_len, _ptr(perm), len(perm),
          _ptr(out), _threads(threads))
    return out


def gather_fixed_plain(data: np.ndarray, row_len: int,
                       perm: np.ndarray) -> np.ndarray:
    n = len(data) // row_len
    return np.asarray(data)[:n * row_len].reshape(n, row_len)[
        _i64(perm)].reshape(-1)


def adjacent_equal_native(data: np.ndarray, offsets: np.ndarray,
                          cand: np.ndarray, threads: Optional[int] = None
                          ) -> np.ndarray:
    """For each candidate row i (rows i and i + 1 of equal length), True
    where their bytes are equal: a threaded memcmp a pair."""
    data, offsets, cand = _u8(data), _i64(offsets), _i64(cand)
    _check_rows(cand, len(offsets) - 2)
    out = np.empty(len(cand), dtype=np.uint8)
    _call("adjacent_equal_u8", _ptr(data), _ptr(offsets), _ptr(cand),
          len(cand), _ptr(out), _threads(threads))
    return out.astype(bool)


def adjacent_equal_plain(data: np.ndarray, offsets: np.ndarray,
                         cand: np.ndarray) -> np.ndarray:
    from tez_tpu_torch.ops.runformat import _adjacent_equal_numpy
    return _adjacent_equal_numpy(np.asarray(data), _i64(offsets),
                                 _i64(cand))


# ---------------------------------------------------------------------------
# the precombine
# ---------------------------------------------------------------------------
def hash_sum_native(key_bytes: np.ndarray, key_offsets: np.ndarray,
                    values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sum the int64 `values` of equal keys, in order of each key's first
    occurrence: (first_idx int64, sums int64); sums wrap modulo 2^64."""
    kb, ko = _u8(key_bytes), _i64(key_offsets)
    values = _i64(values)
    n = len(values)
    if n != len(ko) - 1:
        raise ValueError(f"{n} values for {len(ko) - 1} keys")
    first_idx = np.empty(n, dtype=np.int64)
    sums = np.empty(n, dtype=np.int64)
    u = _call("hash_sum_i64", _ptr(kb), _ptr(ko), n, _ptr(values),
              _ptr(first_idx), _ptr(sums))
    return first_idx[:u].copy(), sums[:u].copy()


_MIX = np.uint64(0x9E3779B97F4A7C15)


def _row_hashes(words: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """A 64-bit hash of each row of (length, key words); equal keys hash
    equal, and unequal keys are told apart by an exact compare after."""
    h = lengths.astype(np.uint64) * _MIX
    for j in range(words.shape[1]):
        h = (h ^ words[:, j]) * _MIX
        h ^= h >> np.uint64(29)
    return h


def _key_words(key_bytes: np.ndarray, key_offsets: np.ndarray,
               lengths: np.ndarray, width: int) -> np.ndarray:
    """uint64[N, width / 8]: each key zero-padded to `width` bytes.  One
    16-byte-row gather from a strided window view of the key bytes, then a
    per-length byte mask; no N x width index matrix."""
    lo, hi = int(key_offsets[0]), int(key_offsets[-1])
    padded = np.zeros(hi - lo + width, dtype=np.uint8)
    padded[:hi - lo] = key_bytes[lo:hi]
    windows = np.lib.stride_tricks.as_strided(
        padded, shape=(hi - lo + 1, width), strides=(1, 1))
    rows = windows[key_offsets[:-1] - lo]
    keep = (np.arange(width)[None, :] < np.arange(width + 1)[:, None])
    masks = (keep.astype(np.uint8) * np.uint8(0xFF)).view(np.uint64)
    return rows.view(np.uint64) & masks[lengths]


def _first_groups(words: np.ndarray, lengths: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(first index of each distinct key in order of its first occurrence,
    group id of every row in that order) over zero-padded key words."""
    n = len(lengths)
    # group on a 64-bit row hash (torch.unique sorts with every core) ...
    _, inv = torch.unique(
        torch.from_numpy(_row_hashes(words, lengths).view(np.int64)),
        return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), n, dtype=torch.int64)
    first.scatter_reduce_(0, inv, torch.arange(n), "amin")
    first, inverse = first.numpy(), inv.numpy()
    rep = first[inverse]
    if not (np.array_equal(lengths, lengths[rep]) and
            np.array_equal(words, words[rep])):
        # ... unless two distinct keys share a hash: then on the exact rows
        rows = np.concatenate([lengths.astype(np.uint64)[:, None], words],
                              axis=1)
        _, first, inverse = np.unique(rows, axis=0, return_index=True,
                                      return_inverse=True)
        inverse = inverse.reshape(-1)
    order = np.argsort(first, kind="stable")
    gid = np.empty(len(first), dtype=np.int64)
    gid[order] = np.arange(len(first), dtype=np.int64)
    return first[order].astype(np.int64), gid[inverse]


def hash_sum_plain(key_bytes: np.ndarray, key_offsets: np.ndarray,
                   values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """hash_sum_native in numpy and torch's CPU ops."""
    n = len(key_offsets) - 1
    values = np.asarray(values, dtype=np.int64)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    key_offsets = np.asarray(key_offsets, dtype=np.int64)
    lengths = key_offsets[1:] - key_offsets[:-1]
    width = max(8, -(-int(lengths.max()) // 8) * 8)
    words = _key_words(np.asarray(key_bytes, dtype=np.uint8), key_offsets,
                       lengths, width)
    first_idx, gid = _first_groups(words, lengths)
    sums = np.zeros(len(first_idx), dtype=np.int64)
    np.add.at(sums, gid, values)
    return first_idx, sums


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------
def split_ws_native(chunk) -> Tuple[np.ndarray, np.ndarray]:
    """Whitespace split of a text chunk (bytes.split()'s set: space, \\t,
    \\n, \\v, \\f, \\r) in one pass: compacted (word_bytes, word_offsets)."""
    data = _u8(chunk)
    n = len(data)
    out_bytes = np.empty(n, dtype=np.uint8)
    out_offsets = np.empty((n + 1) // 2 + 2, dtype=np.int64)
    words = _call("tz_split_ws", _ptr(data), n, _ptr(out_bytes),
                  _ptr(out_offsets))
    offsets = out_offsets[:words + 1].copy()
    return out_bytes[:int(offsets[-1])].copy(), offsets


def split_ws_plain(chunk) -> Tuple[np.ndarray, np.ndarray]:
    data = np.frombuffer(chunk, dtype=np.uint8)
    ws = (data == 32) | ((data >= 9) & (data <= 13))
    sel = ~ws
    if not sel.any():
        return np.zeros(0, np.uint8), np.zeros(1, np.int64)
    key_bytes = data[sel].copy()
    starts_mask = sel & np.concatenate(([True], ws[:-1]))
    run_id = np.cumsum(starts_mask)[sel]    # 1-based word id
    lengths = np.bincount(run_id - 1)
    key_offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=key_offsets[1:])
    return key_bytes, key_offsets


class WordCountAggregator:
    """Fused tokenize and count over byte chunks: the words of every
    `feed`, counted in a hash table, emitted in order of first occurrence.
    Each chunk must be whitespace-complete (the text reader's line-aligned
    chunks), so no word spans two feeds."""

    def __init__(self) -> None:
        self._h = _call("tz_wc_create")

    def feed(self, chunk) -> None:
        data = _u8(chunk)
        _call("tz_wc_feed", self._h, _ptr(data), len(data))

    def emit(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (key_bytes, key_offsets, counts) in first-occurrence order."""
        n_unique, total = ctypes.c_int64(), ctypes.c_int64()
        _call("tz_wc_stats", self._h, ctypes.addressof(n_unique),
              ctypes.addressof(total))
        n = n_unique.value
        key_bytes = np.empty(total.value, dtype=np.uint8)
        key_offsets = np.zeros(n + 1, dtype=np.int64)
        counts = np.empty(n, dtype=np.int64)
        if n:
            _call("tz_wc_emit", self._h, _ptr(key_bytes), _ptr(key_offsets),
                  _ptr(counts))
        return key_bytes, key_offsets, counts

    def close(self) -> None:
        if self._h:
            _call("tz_wc_destroy", self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def word_count_plain(chunks: Sequence) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """WordCountAggregator's emit after feeding `chunks`, in numpy."""
    split = [split_ws_plain(c) for c in chunks]
    kb = np.concatenate([b for b, _ in split]) if split else \
        np.zeros(0, np.uint8)
    lens = np.concatenate([np.diff(o) for _, o in split]) if split else \
        np.zeros(0, np.int64)
    ko = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=ko[1:])
    first, counts = hash_sum_plain(kb, ko, np.ones(len(lens), np.int64))
    key_bytes, key_offsets = gather_ragged_plain(kb, ko, first)
    return key_bytes, key_offsets, counts


# ---------------------------------------------------------------------------
# the host engine: partition, span sort, run merges
# ---------------------------------------------------------------------------
def fnv32_partition_native(key_bytes: np.ndarray, key_offsets: np.ndarray,
                           num_partitions: int,
                           threads: Optional[int] = None) -> np.ndarray:
    """FNV-1a 32 of every full key mod num_partitions (the reducer the
    card's fnv_hash kernel gives the key): int32[N]."""
    if num_partitions <= 0:
        raise ValueError(f"num_partitions {num_partitions} must be positive")
    kb, ko = _u8(key_bytes), _i64(key_offsets)
    parts = np.empty(len(ko) - 1, dtype=np.int32)
    _call("tz_fnv32_partition", _ptr(kb), _ptr(ko), len(parts),
          num_partitions, _ptr(parts), _threads(threads))
    return parts


def fnv32_partition_plain(key_bytes: np.ndarray, key_offsets: np.ndarray,
                          num_partitions: int) -> np.ndarray:
    from tez_tpu_torch.ops.host_sort import host_hash_partition
    from tez_tpu_torch.ops.keycodec import pad_to_matrix
    ko = _i64(key_offsets)
    width = max(1, int(np.diff(ko).max(initial=0)))
    mat, lengths = pad_to_matrix(np.asarray(key_bytes), ko, width)
    return host_hash_partition(mat, lengths, num_partitions)


def sort_partition_keys_native(key_bytes: np.ndarray,
                               key_offsets: np.ndarray,
                               partitions: Optional[np.ndarray],
                               threads: Optional[int] = None) -> np.ndarray:
    """Stable sort permutation of the rows by (partition, full key bytes);
    partitions None puts every row in partition 0.  int64[N]."""
    kb, ko = _u8(key_bytes), _i64(key_offsets)
    n = len(ko) - 1
    parts = _check_partitions(partitions, n)
    perm = np.empty(n, dtype=np.int64)
    _call("tz_sort_partition_keys", _ptr(kb), _ptr(ko),
          None if parts is None else _ptr(parts), n, _ptr(perm),
          _threads(threads))
    return perm


def sort_partition_keys_plain(key_bytes: np.ndarray,
                              key_offsets: np.ndarray,
                              partitions: Optional[np.ndarray]
                              ) -> np.ndarray:
    """np.lexsort by (partition, key lanes, length) over lanes as wide as
    the longest key: full byte order, stable."""
    from tez_tpu_torch.ops.host_sort import host_sort_run
    from tez_tpu_torch.ops.keycodec import matrix_to_lanes, pad_to_matrix
    ko = _i64(key_offsets)
    n = len(ko) - 1
    width = max(4, -(-int(np.diff(ko).max(initial=0)) // 4) * 4)
    mat, lengths = pad_to_matrix(np.asarray(key_bytes), ko, width)
    parts = np.zeros(n, np.int32) if partitions is None else \
        np.asarray(partitions, dtype=np.int32)
    _, perm = host_sort_run(parts, matrix_to_lanes(mat), lengths)
    return perm.astype(np.int64)


def span_sort_emit_native(key_bytes: np.ndarray, key_offsets: np.ndarray,
                          val_bytes: np.ndarray, val_offsets: np.ndarray,
                          num_partitions: int,
                          partitions: Optional[np.ndarray],
                          compute_hash: bool,
                          threads: Optional[int] = None) -> tuple:
    """The host engine's span sort in one call: partition (`partitions`,
    or the FNV-1a 32 of each key when compute_hash, else partition 0),
    stable (partition, key) sort, and the sorted batch written out.
    Returns (key_bytes, key_offsets, val_bytes, val_offsets, row_index)."""
    kb, ko = _u8(key_bytes), _i64(key_offsets)
    vb, vo = _u8(val_bytes), _i64(val_offsets)
    n = len(ko) - 1
    parts = _check_partitions(partitions, n, num_partitions)
    out_kb = np.empty(int(ko[-1]), dtype=np.uint8)
    out_ko = np.empty(n + 1, dtype=np.int64)
    out_vb = np.empty(int(vo[-1]), dtype=np.uint8)
    out_vo = np.empty(n + 1, dtype=np.int64)
    part_counts = np.empty(max(num_partitions, 0), dtype=np.int64)
    rc = _call("tz_span_sort_emit", _ptr(kb), _ptr(ko), _ptr(vb), _ptr(vo),
               n, num_partitions, None if parts is None else _ptr(parts),
               1 if compute_hash else 0, _ptr(out_kb), _ptr(out_ko),
               _ptr(out_vb), _ptr(out_vo), None, _ptr(part_counts),
               _threads(threads))
    if rc != 0:
        raise ValueError(f"tz_span_sort_emit rejected the span (rc {rc}): "
                         f"{n} rows, {num_partitions} partitions")
    return out_kb, out_ko, out_vb, out_vo, _row_index(part_counts)


def span_sort_emit_plain(key_bytes: np.ndarray, key_offsets: np.ndarray,
                         val_bytes: np.ndarray, val_offsets: np.ndarray,
                         num_partitions: int,
                         partitions: Optional[np.ndarray],
                         compute_hash: bool) -> tuple:
    ko = _i64(key_offsets)
    n = len(ko) - 1
    if num_partitions <= 0:
        raise ValueError(f"num_partitions {num_partitions} must be positive")
    parts = _check_partitions(partitions, n, num_partitions)
    if parts is None:
        parts = fnv32_partition_plain(key_bytes, ko, num_partitions) \
            if compute_hash else np.zeros(n, np.int32)
    perm = sort_partition_keys_plain(key_bytes, ko, parts)
    out_kb, out_ko = gather_ragged_plain(key_bytes, ko, perm)
    out_vb, out_vo = gather_ragged_plain(val_bytes, val_offsets, perm)
    return out_kb, out_ko, out_vb, out_vo, _row_index(
        np.bincount(parts, minlength=num_partitions))


def merge_runs_native(key_bytes: np.ndarray, key_offsets: np.ndarray,
                      partitions: Optional[np.ndarray],
                      run_bounds: np.ndarray,
                      threads: Optional[int] = None) -> np.ndarray:
    """Stable merge permutation of the concatenation of k (partition,
    key)-sorted runs (rows run_bounds[r]:run_bounds[r + 1]); equal rows
    keep run order.  int64[N]."""
    kb, ko, bounds = _u8(key_bytes), _i64(key_offsets), _i64(run_bounds)
    n = int(bounds[-1])
    if n != len(ko) - 1 or bool((np.diff(bounds) < 0).any()):
        raise ValueError("run_bounds do not cut the rows into runs")
    parts = _check_partitions(partitions, n)
    perm = np.empty(n, dtype=np.int64)
    _call("tz_merge_runs", _ptr(kb), _ptr(ko),
          None if parts is None else _ptr(parts), _ptr(bounds),
          len(bounds) - 1, _ptr(perm), _threads(threads))
    return perm


def merge_runs_plain(key_bytes: np.ndarray, key_offsets: np.ndarray,
                     partitions: Optional[np.ndarray],
                     run_bounds: np.ndarray) -> np.ndarray:
    """A stable sort of the concatenation keeps equal rows in run order."""
    return sort_partition_keys_plain(key_bytes, key_offsets, partitions)


def merge_emit_native(runs: List[tuple], num_partitions: int,
                      threads: Optional[int] = None) -> tuple:
    """The host engine's k-run merge in one call: each (partition,
    key)-sorted run is scanned into groups of equal (partition, key), the
    group heads are merged, and each winning group is copied out whole;
    equal groups come out in the order of `runs` (the merge queue's age
    order).  `runs` holds (key_bytes, key_offsets, val_bytes, val_offsets,
    row_index) tuples.  Returns the same five arrays for the merge."""
    if num_partitions <= 0:
        raise ValueError(f"num_partitions {num_partitions} must be positive")
    k = len(runs)
    holders = []   # the contiguous arrays, alive across the call
    ptrs = [(ctypes.c_void_p * k)() for _ in range(5)]
    nrows = np.empty(k, dtype=np.int64)
    total_kb = total_vb = 0
    for i, (kb, ko, vb, vo, ri) in enumerate(runs):
        arrays = (_u8(kb), _i64(ko), _u8(vb), _i64(vo), _i64(ri))
        kb, ko, vb, vo, ri = arrays
        if len(ri) != num_partitions + 1 or int(ri[-1]) != len(ko) - 1 or \
                len(vo) != len(ko):
            raise ValueError(f"run {i} does not have {num_partitions} "
                             f"partitions over its rows")
        holders.append(arrays)
        for j, a in enumerate(arrays):
            ptrs[j][i] = _ptr(a)
        nrows[i] = len(ko) - 1
        total_kb += int(ko[-1])
        total_vb += int(vo[-1])
    total_rows = int(nrows.sum())
    out_kb = np.empty(total_kb, dtype=np.uint8)
    out_ko = np.empty(total_rows + 1, dtype=np.int64)
    out_vb = np.empty(total_vb, dtype=np.uint8)
    out_vo = np.empty(total_rows + 1, dtype=np.int64)
    part_counts = np.empty(num_partitions, dtype=np.int64)
    rc = _call("tz_merge_emit", k, ptrs[0], ptrs[1], ptrs[2], ptrs[3],
               _ptr(nrows), ptrs[4], num_partitions, _ptr(out_kb),
               _ptr(out_ko), _ptr(out_vb), _ptr(out_vo), None,
               _ptr(part_counts), _threads(threads))
    del holders
    if rc != 0:
        raise ValueError(f"tz_merge_emit rejected the runs (rc {rc})")
    return out_kb, out_ko, out_vb, out_vo, _row_index(part_counts)


def merge_emit_plain(runs: List[tuple], num_partitions: int) -> tuple:
    """The concatenation of the runs, stably sorted by (partition, key)."""
    from tez_tpu_torch.ops.runformat import concat_ragged
    kb, ko = concat_ragged([(r[0], _i64(r[1])) for r in runs])
    vb, vo = concat_ragged([(r[2], _i64(r[3])) for r in runs])
    parts = np.concatenate(
        [np.repeat(np.arange(num_partitions, dtype=np.int32),
                   np.diff(_i64(r[4]))) for r in runs]) if runs else \
        np.zeros(0, np.int32)
    perm = sort_partition_keys_plain(kb, ko, parts)
    out_kb, out_ko = gather_ragged_plain(kb, ko, perm)
    out_vb, out_vo = gather_ragged_plain(vb, vo, perm)
    return out_kb, out_ko, out_vb, out_vo, _row_index(
        np.bincount(parts, minlength=num_partitions))
