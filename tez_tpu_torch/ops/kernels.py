"""Kernel wrappers: the counterpart of tez_tpu/ops/pallas_kernels.py.

Two hand-written CUDA kernels replace the repository's two Pallas kernels:

* ``fnv_hash_bytes`` / ``fnv_hash_lanes`` (``csrc/fnv_hash.cu``) replace
  ``fnv_hash_pallas`` (pallas_kernels.py:34): FNV-1a of each row's key
  bytes, reduced to a partition, with pad rows (length < 0) sent to
  partition INT32_MAX.  The byte-matrix layout serves ``hash_partition``,
  ``hash_sort_span`` and the fused pipeline; the big-endian lane layout
  serves the resident span sort (tez_tpu's ``_fnv_rows_from_lanes``).
* ``merge_rank`` (``csrc/merge_rank.cu``) replaces ``merge_rank_pallas``
  (pallas_kernels.py:76): the rank of every query row in a sorted run.

Beside each kernel sits its plain PyTorch version (``_fnv_rows``,
``_fnv_rows_from_lanes``, ``_lex_lt``, ``_rank_search`` keep the names of
the tez_tpu bodies they mirror).  A wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
``launches`` counts kernel launches per wrapper.

u32 columns (key lanes, sort lengths) travel as int32 tensors holding the
u32 bit pattern, which is what the kernels read.  The plain versions order
them by flipping the sign bit (signed order of ``x ^ 0x80000000`` is the
unsigned order of ``x``) and never widen them, so the 0xFFFFFFFF sentinel
(int32 -1) cannot be sign-extended into a small value.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
INT32_MAX = 2 ** 31 - 1
_SIGN_BIT = -2 ** 31

#: kernel launches per wrapper; reset with reset_launches()
launches: Dict[str, int] = {"fnv_hash_bytes": 0, "fnv_hash_lanes": 0,
                            "merge_rank": 0}

_VP = ctypes.c_void_p
_ARGTYPES = {
    "tez_fnv_hash_bytes": [_VP, _VP, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_uint, _VP, _VP],
    "tez_fnv_hash_lanes": [_VP, _VP, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_uint, _VP, _VP],
    "tez_merge_rank": [_VP, _VP, ctypes.c_longlong, _VP, _VP,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP,
                       _VP],
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _entry(lib_name: str, fn_name: str):
    from tez_tpu_torch.ops import _build
    fn = getattr(_build.library(lib_name), fn_name)
    fn.argtypes = _ARGTYPES[fn_name]
    fn.restype = ctypes.c_int
    return fn


def _launch(counter: str, lib_name: str, fn_name: str, *args) -> None:
    rc = _entry(lib_name, fn_name)(
        *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {rc}")
    launches[counter] += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected {dtype} with {ndim} dims, got "
                        f"{t.dtype} with {t.dim()}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check_partitions(num_partitions: int) -> None:
    if not 0 < num_partitions <= INT32_MAX:
        raise ValueError(f"num_partitions out of range: {num_partitions}")


# ---------------------------------------------------------------------------
# FNV-1a hash partition
# ---------------------------------------------------------------------------
def _fnv_rows(key_mat: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain FNV-1a over each row's first lengths[i] bytes of a uint8[N, W]
    matrix; int64 hashes in [0, 2^32) (tez_tpu device._fnv_rows)."""
    h = torch.full((key_mat.shape[0],), FNV_OFFSET, dtype=torch.int64,
                   device=key_mat.device)
    for j in range(key_mat.shape[1]):
        nh = ((h ^ key_mat[:, j].to(torch.int64)) * FNV_PRIME) & 0xFFFFFFFF
        h = torch.where(j < lengths, nh, h)
    return h


def _fnv_rows_from_lanes(lanes: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Plain FNV-1a over the key bytes packed in big-endian u32 lanes
    (tez_tpu device._fnv_rows_from_lanes)."""
    h = torch.full((lanes.shape[0],), FNV_OFFSET, dtype=torch.int64,
                   device=lanes.device)
    for j in range(lanes.shape[1] * 4):
        # arithmetic shift of the int32 bits, then the mask drops the sign
        byte = ((lanes[:, j // 4] >> (24 - 8 * (j % 4))) & 0xFF)\
            .to(torch.int64)
        nh = ((h ^ byte) * FNV_PRIME) & 0xFFFFFFFF
        h = torch.where(j < lengths, nh, h)
    return h


def _to_partitions(h: torch.Tensor, lengths: torch.Tensor,
                   num_partitions: int) -> torch.Tensor:
    """Hash -> partition, pad rows (length < 0) -> INT32_MAX."""
    return torch.where(lengths < 0, INT32_MAX, h % num_partitions)\
        .to(torch.int32)


def fnv_hash_bytes(key_mat: torch.Tensor, lengths: torch.Tensor,
                   num_partitions: int) -> torch.Tensor:
    """Partition of each row of a uint8[N, W] key matrix by FNV-1a over its
    first min(lengths[i], W) bytes; int32[N], INT32_MAX where lengths < 0."""
    dev = key_mat.device
    _check("key_mat", key_mat, torch.uint8, 2, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    _check_partitions(num_partitions)
    n, w = key_mat.shape
    if lengths.shape[0] != n:
        raise ValueError("lengths must have one entry per row")
    if not _on_cuda(key_mat):
        return _to_partitions(_fnv_rows(key_mat, lengths), lengths,
                              num_partitions)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch("fnv_hash_bytes", "fnv_hash", "tez_fnv_hash_bytes",
                key_mat.data_ptr(), lengths.data_ptr(), n, w,
                num_partitions, out.data_ptr())
    return out


def fnv_hash_lanes(lanes: torch.Tensor, lengths: torch.Tensor,
                   num_partitions: int) -> torch.Tensor:
    """Partition of each row of big-endian u32 lanes (int32[N, L] bits) by
    FNV-1a over its first min(lengths[i], 4L) key bytes; int32[N],
    INT32_MAX where lengths < 0."""
    dev = lanes.device
    _check("lanes", lanes, torch.int32, 2, dev)
    _check("lengths", lengths, torch.int32, 1, dev)
    _check_partitions(num_partitions)
    n, nl = lanes.shape
    if lengths.shape[0] != n:
        raise ValueError("lengths must have one entry per row")
    if not _on_cuda(lanes):
        return _to_partitions(_fnv_rows_from_lanes(lanes, lengths), lengths,
                              num_partitions)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch("fnv_hash_lanes", "fnv_hash", "tez_fnv_hash_lanes",
                lanes.data_ptr(), lengths.data_ptr(), n, nl, num_partitions,
                out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# merge-path cross rank
# ---------------------------------------------------------------------------
def u32_order(x: torch.Tensor) -> torch.Tensor:
    """int32 bits of u32 values -> int32 whose signed order is the unsigned
    order of the inputs (sort and compare key)."""
    return x ^ _SIGN_BIT


def _lex_lt(al: torch.Tensor, alen: torch.Tensor,
            bl: torch.Tensor, blen: torch.Tensor) -> torch.Tensor:
    """Row-wise (lanes..., length) less-than, lane 0 most significant --
    the composite comparator of every sort in the port."""
    res = u32_order(alen) < u32_order(blen)
    for i in range(al.shape[1] - 1, -1, -1):
        a, b = u32_order(al[:, i]), u32_order(bl[:, i])
        res = torch.where(a == b, res, a < b)
    return res


def _rank_search(run_lanes: torch.Tensor, run_lens: torch.Tensor,
                 q_lanes: torch.Tensor, q_lens: torch.Tensor,
                 count_equal: bool) -> torch.Tensor:
    """Plain vectorized binary search: rank of every query row in the sorted
    run, counting run rows < query (or <= with count_equal); int32[M]."""
    n, m = run_lanes.shape[0], q_lanes.shape[0]
    lo = torch.zeros(m, dtype=torch.int64, device=q_lanes.device)
    if n == 0:
        return lo.to(torch.int32)
    hi = torch.full((m,), n, dtype=torch.int64, device=q_lanes.device)
    for _ in range(n.bit_length() + 1):
        mid = (lo + hi) >> 1
        probe = mid.clamp(max=n - 1)      # inactive rows may sit at n
        mid_l, mid_n = run_lanes[probe], run_lens[probe]
        if count_equal:   # run[mid] <= q  <=>  not (q < run[mid])
            before = ~_lex_lt(q_lanes, q_lens, mid_l, mid_n)
        else:             # run[mid] < q
            before = _lex_lt(mid_l, mid_n, q_lanes, q_lens)
        active = lo < hi
        lo = torch.where(active & before, mid + 1, lo)
        hi = torch.where(active & ~before, mid, hi)
    return lo.to(torch.int32)


def merge_rank(run_lanes: torch.Tensor, run_lens: torch.Tensor,
               q_lanes: torch.Tensor, q_lens: torch.Tensor,
               count_equal: bool) -> torch.Tensor:
    """Rank of each query row in a run sorted under the composite
    comparator.  Lanes are int32[N, W] / int32[M, W] and lengths int32[N] /
    int32[M], all u32 bits; returns int32[M]."""
    dev = run_lanes.device
    _check("run_lanes", run_lanes, torch.int32, 2, dev)
    _check("run_lens", run_lens, torch.int32, 1, dev)
    _check("q_lanes", q_lanes, torch.int32, 2, dev)
    _check("q_lens", q_lens, torch.int32, 1, dev)
    n, w = run_lanes.shape
    m = q_lanes.shape[0]
    if q_lanes.shape[1] != w or run_lens.shape[0] != n or \
            q_lens.shape[0] != m:
        raise ValueError("run and query shapes disagree")
    if n >= INT32_MAX:
        raise ValueError("run too long for int32 ranks")
    if not _on_cuda(run_lanes):
        return _rank_search(run_lanes, run_lens, q_lanes, q_lens,
                            count_equal)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    if m:
        _launch("merge_rank", "merge_rank", "tez_merge_rank",
                run_lanes.data_ptr(), run_lens.data_ptr(), n,
                q_lanes.data_ptr(), q_lens.data_ptr(), m, w,
                int(bool(count_equal)), out.data_ptr())
    return out
