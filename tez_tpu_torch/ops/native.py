"""Host helpers of tez_tpu/ops/native.py, in numpy and torch on the CPU.

tez_tpu binds these to its C++ host library (``native/ragged.cpp``) and
returns None where the library is missing; the port computes them on the
host with numpy and torch's CPU ops and always answers, so the paths that
need them always run, as they do wherever tez_tpu finds its library.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

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


def hash_sum_native(key_bytes: np.ndarray, key_offsets: np.ndarray,
                    values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sum the int64 `values` of equal keys, in order of each key's first
    occurrence: returns (first_idx int64, sums int64); sums wrap modulo
    2^64 as the C++ ``hash_sum_i64`` accumulator does."""
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
