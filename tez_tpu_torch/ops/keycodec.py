"""Normalized fixed-width key encoding (host half of tez_tpu.ops.keycodec).

Variable-length keys travel as (bytes, offsets); for sorting they are
normalized into big-endian uint32 lanes so lane-lexicographic order equals
raw-byte order.  Keys longer than the width sort by their prefix and the
sorter's host tie-break pass makes the final order exact.
"""
from __future__ import annotations

import numpy as np


def pad_to_matrix(key_bytes: np.ndarray, offsets: np.ndarray,
                  width: int) -> tuple[np.ndarray, np.ndarray]:
    """Ragged bytes -> (padded uint8[N, width], lengths int32[N]).

    Pad value 0 sorts below every real byte ("a" < "ab")."""
    n = len(offsets) - 1
    lengths = (offsets[1:] - offsets[:-1]).astype(np.int64)
    mat = np.zeros((n, width), dtype=np.uint8)
    if n == 0 or key_bytes.size == 0:
        return mat, lengths.astype(np.int32)
    step = int(lengths[0])
    if 0 < step <= width and \
            int(offsets[-1]) - int(offsets[0]) == step * n and \
            (lengths == step).all():
        # uniform fixed-width keys: a reshape replaces the fancy gather
        fixed = key_bytes[int(offsets[0]):int(offsets[-1])].reshape(n, step)
        if step == width:
            mat = np.ascontiguousarray(fixed)
        else:
            mat[:, :step] = fixed
        return mat, lengths.astype(np.int32)
    take = np.minimum(lengths, width)
    j = np.arange(width)[None, :]
    idx = offsets[:-1, None] + j
    valid = j < take[:, None]
    idx = np.where(valid, idx, 0)
    vals = key_bytes[idx]
    mat = np.where(valid, vals, 0).astype(np.uint8)
    return mat, lengths.astype(np.int32)


def matrix_to_lanes(mat: np.ndarray) -> np.ndarray:
    """uint8[N, W] -> big-endian uint32[N, ceil(W/4)] lanes."""
    n, w = mat.shape
    pad = (-w) % 4
    if pad:
        mat = np.pad(mat, ((0, 0), (0, pad)))
        w += pad
    if mat.flags.c_contiguous:
        return mat.view(">u4").astype(np.uint32)
    lanes = mat.reshape(n, w // 4, 4).astype(np.uint32)
    return (lanes[..., 0] << 24) | (lanes[..., 1] << 16) | \
        (lanes[..., 2] << 8) | lanes[..., 3]


def encode_keys(key_bytes: np.ndarray, offsets: np.ndarray,
                width: int) -> tuple[np.ndarray, np.ndarray]:
    """Ragged keys -> (uint32 lanes [N, ceil(width/4)], lengths[N])."""
    mat, lengths = pad_to_matrix(key_bytes, offsets, width)
    return matrix_to_lanes(mat), lengths


def lanes_to_matrix(lanes: np.ndarray) -> np.ndarray:
    """Inverse of matrix_to_lanes: big-endian uint32[N, L] -> uint8[N, L*4]."""
    n, num_lanes = lanes.shape
    mat = np.zeros((n, num_lanes * 4), dtype=np.uint8)
    for i in range(4):
        mat[:, i::4] = ((lanes >> (24 - 8 * i)) & 0xFF).astype(np.uint8)
    return mat
