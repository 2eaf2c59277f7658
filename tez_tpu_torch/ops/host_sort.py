"""Host sorting engine (numpy): the port's copy of tez_tpu.ops.host_sort.

These are the host oracles of the device kernels and the engine="host"
path: the same FNV-1a and the same (partition, lanes..., clamped length)
stable order."""
from __future__ import annotations

import numpy as np


def fnv_rows_host(key_mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized FNV-1a over each row's first lengths[i] bytes."""
    h = np.full(key_mat.shape[0], 2166136261, dtype=np.uint64)
    for j in range(key_mat.shape[1]):
        nh = ((h ^ key_mat[:, j].astype(np.uint64)) * np.uint64(16777619)) \
            & np.uint64(0xFFFFFFFF)
        h = np.where(j < lengths, nh, h)
    return h.astype(np.uint32)


def host_hash_partition(key_mat: np.ndarray, lengths: np.ndarray,
                        num_partitions: int) -> np.ndarray:
    return (fnv_rows_host(key_mat, lengths) %
            np.uint32(num_partitions)).astype(np.int32)


def host_sort_run(partitions: np.ndarray, lanes: np.ndarray,
                  lengths: np.ndarray) -> tuple:
    """np.lexsort by (partition, lanes..., clamped length), stable."""
    n = partitions.shape[0]
    if n == 0:
        return partitions, np.zeros(0, dtype=np.int32)
    width_cap = lanes.shape[1] * 4 + 1
    clamped = np.minimum(lengths.astype(np.int64), width_cap)
    # lexsort: LAST key is most significant
    cols = [clamped] + [lanes[:, i] for i in range(lanes.shape[1] - 1, -1, -1)]
    cols.append(partitions)
    perm = np.lexsort(cols).astype(np.int32)
    return partitions[perm], perm
