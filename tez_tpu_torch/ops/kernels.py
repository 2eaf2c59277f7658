"""Kernel wrappers: the counterpart of tez_tpu/ops/pallas_kernels.py.

Three hand-written CUDA kernels stand for the repository's two Pallas
kernels:

* ``fnv_hash_bytes`` / ``fnv_hash_lanes`` (``csrc/fnv_hash.cu``) replace
  ``fnv_hash_pallas`` (pallas_kernels.py:34): FNV-1a of each row's key
  bytes, reduced to a partition, with pad rows (length < 0) sent to
  partition INT32_MAX.  The byte-matrix layout serves ``hash_partition``,
  ``hash_sort_span`` and the fused pipeline; the big-endian lane layout
  serves the resident span sort (tez_tpu's ``_fnv_rows_from_lanes``).
* ``merge_rank`` (``csrc/merge_rank.cu``) is the counterpart of
  ``merge_rank_pallas`` (pallas_kernels.py:76) and its contract: the rank of
  every query row in a sorted run.  The kernel cuts the queries into tiles
  and first finds each tile's window (``merge_rank_windows`` is the plain
  version of that step): a tile in order is ranked inside its window in
  shared memory, any other against a shared-memory splitter table.
* ``merge_path_pair`` (``csrc/merge_path.cu``) replaces what the main path
  did with ``merge_rank_pallas``: two cross ranks and the scatter of
  tez_tpu's ``_merge_path_pair`` (device.py:489), as one merge-path merge.

Beside each kernel sits its plain PyTorch version (``_fnv_rows``,
``_fnv_rows_from_lanes``, ``_lex_lt``, ``_rank_search`` keep the names of
the tez_tpu bodies they mirror; ``_merge_path_plain`` is tez_tpu's
``_merge_path_pair`` body).  A wrapper runs the plain version only for
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
import threading
from typing import Dict

import torch

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
INT32_MAX = 2 ** 31 - 1
_SIGN_BIT = -2 ** 31

#: kernel launches per wrapper; reset with reset_launches()
launches: Dict[str, int] = {"fnv_hash_bytes": 0, "fnv_hash_lanes": 0,
                            "merge_rank": 0, "merge_path_pair": 0}
_launches_lock = threading.Lock()

#: CTA shape of the merge-path tile kernel: threads, and output rows each
#: thread merges (a tile is their product); and the lanes that search one
#: tile boundary together, 0 letting the kernel choose by the number of
#: boundaries (PERF.md records the choice)
MERGE_PATH_THREADS = 128
MERGE_PATH_ROWS_PER_THREAD = 8
MERGE_PATH_GROUP = 0

_VP = ctypes.c_void_p
_ARGTYPES = {
    "tez_fnv_hash_bytes": [_VP, _VP, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_uint, _VP, _VP],
    "tez_fnv_hash_lanes": [_VP, _VP, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_uint, _VP, _VP],
    "tez_merge_rank_tile": [ctypes.c_int],
    "tez_merge_rank": [_VP, _VP, ctypes.c_longlong, _VP, _VP,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _VP,
                       _VP, _VP],
    "tez_merge_path_tile": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "tez_merge_path_pair": [_VP, _VP, _VP, ctypes.c_longlong, _VP, _VP, _VP,
                            ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, _VP, _VP, _VP, _VP,
                            _VP],
}
_RESTYPES = {"tez_merge_path_tile": ctypes.c_longlong,
             "tez_merge_rank_tile": ctypes.c_longlong}


def reset_launches() -> None:
    with _launches_lock:
        for k in launches:
            launches[k] = 0


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch.  This is a broken kernel,
    not a transient device fault: no containment ladder may send its span
    to the host (ops/async_stage.py poisons the pipeline on it)."""


def load(names=("fnv_hash", "merge_path")) -> None:
    """Build and load the named kernel libraries now (default: those of the
    map-side path), so that a pipeline never builds one inside a stage."""
    from tez_tpu_torch.ops import _build
    try:
        _build.load(names)
    except Exception as e:
        raise KernelError(f"kernel build failed: {e}") from e


def _entry(lib_name: str, fn_name: str):
    from tez_tpu_torch.ops import _build
    try:
        fn = getattr(_build.library(lib_name), fn_name)
    except Exception as e:
        raise KernelError(f"{fn_name}: kernel unavailable: {e}") from e
    fn.argtypes = _ARGTYPES[fn_name]
    fn.restype = _RESTYPES.get(fn_name, ctypes.c_int)
    return fn


def _launch(counter: str, lib_name: str, fn_name: str, *args) -> None:
    rc = _entry(lib_name, fn_name)(
        *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise KernelError(f"{fn_name} launch failed: cudaError {rc}")
    # the async span plane launches from its staging thread and from
    # readback workers at once: the count is exact only under the lock
    with _launches_lock:
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


def merge_rank_windows(run_lanes: torch.Tensor, run_lens: torch.Tensor,
                       q_lanes: torch.Tensor, q_lens: torch.Tensor,
                       count_equal: bool, tile: int) -> torch.Tensor:
    """Plain version of the merge-rank kernel's first step: for each tile of
    `tile` consecutive query rows, the rank of its first query (row 0), of
    its last (row 1), and whether its queries are in order, every adjacent
    pair q[i] <= q[i+1] (row 2, 1 or 0).  int32[3, ceil(M / tile)]."""
    m = q_lanes.shape[0]
    dev = q_lanes.device
    first = torch.arange(0, m, tile, device=dev)
    last = (first + tile).clamp(max=m) - 1
    ranks = _rank_search(run_lanes, run_lens,
                         torch.cat([q_lanes[first], q_lanes[last]]),
                         torch.cat([q_lens[first], q_lens[last]]),
                         count_equal)
    # adjacent pairs out of order, counted in the tile of their first row
    out_of_order = _lex_lt(q_lanes[1:], q_lens[1:], q_lanes[:-1],
                           q_lens[:-1])
    pair = torch.arange(max(m - 1, 0), device=dev)
    same_tile = (pair + 1) % tile != 0
    bad = torch.zeros(first.shape[0], dtype=torch.int64, device=dev)
    bad.index_add_(0, pair // tile, (out_of_order & same_tile)
                   .to(torch.int64))
    return torch.stack([ranks[:first.shape[0]], ranks[first.shape[0]:],
                        (bad == 0).to(torch.int32)])


def _merge_rank_launch(run_lanes, run_lens, q_lanes, q_lens, count_equal):
    """Launch the merge-rank kernels on CUDA tensors; returns (ranks,
    windows, tile) -- the windows as ``merge_rank_windows`` gives them, for
    tests."""
    n, w = run_lanes.shape
    m, dev = q_lanes.shape[0], q_lanes.device
    tile = _entry("merge_rank", "tez_merge_rank_tile")(w)
    if tile <= 0:
        raise ValueError(f"no merge-rank tile for rows of {w} lanes")
    windows = torch.empty((3, -(-m // tile)), dtype=torch.int32, device=dev)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    if m:
        _launch("merge_rank", "merge_rank", "tez_merge_rank",
                run_lanes.data_ptr(), run_lens.data_ptr(), n,
                q_lanes.data_ptr(), q_lens.data_ptr(), m, w,
                int(bool(count_equal)), windows.data_ptr(), out.data_ptr())
    return out, windows, tile


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
    return _merge_rank_launch(run_lanes, run_lens, q_lanes, q_lens,
                              count_equal)[0]


# ---------------------------------------------------------------------------
# merge-path pair merge
# ---------------------------------------------------------------------------
def _merge_path_plain(a_lanes, a_lens, a_idx, b_lanes, b_lens, b_idx,
                      rank=_rank_search):
    """Plain merge of two sorted runs as two cross ranks and a scatter
    (tez_tpu device._merge_path_pair): a_i goes to i + |{b < a_i}|, b_j to
    j + |{a <= b_j}|.  `rank` computes the ranks (``merge_rank`` gives the
    composite the slice ran before the merge-path kernel)."""
    na, nb = a_lanes.shape[0], b_lanes.shape[0]
    dev = a_lanes.device
    pos_a = torch.arange(na, device=dev) + \
        rank(b_lanes, b_lens, a_lanes, a_lens, False)
    pos_b = torch.arange(nb, device=dev) + \
        rank(a_lanes, a_lens, b_lanes, b_lens, True)
    out = []
    for a, b in ((a_lanes, b_lanes), (a_lens, b_lens), (a_idx, b_idx)):
        o = torch.empty((na + nb,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=dev)
        o.index_copy_(0, pos_a, a)
        o.index_copy_(0, pos_b, b)
        out.append(o)
    return tuple(out)


def merge_path_splits(a_lanes: torch.Tensor, a_lens: torch.Tensor,
                      b_lanes: torch.Tensor, b_lens: torch.Tensor,
                      diagonals: torch.Tensor) -> torch.Tensor:
    """Plain co-rank search, the partition step of ``merge_path_pair``: for
    each diagonal d, the number of A rows among the first d rows of the
    merge (ties go to A).  int32 of diagonals' shape."""
    na, nb = a_lanes.shape[0], b_lanes.shape[0]
    d = diagonals.to(torch.int64)
    lo = (d - nb).clamp(min=0)
    hi = d.clamp(max=na)
    for _ in range(max(na, 1).bit_length() + 1):
        active = lo < hi
        mid = (lo + hi) >> 1
        ai = mid.clamp(max=max(na - 1, 0))
        bj = (d - 1 - mid).clamp(0, max(nb - 1, 0))
        if na and nb:     # A[mid] <= B[d-1-mid]  <=>  not (B < A)
            take_a = ~_lex_lt(b_lanes[bj], b_lens[bj], a_lanes[ai],
                              a_lens[ai])
        else:             # one side empty: lo == hi from the start
            take_a = torch.zeros_like(active)
        lo = torch.where(active & take_a, mid + 1, lo)
        hi = torch.where(active & ~take_a, mid, hi)
    return lo.to(torch.int32)


def _merge_path_launch(a_lanes, a_lens, a_idx, b_lanes, b_lens, b_idx,
                       threads: int = MERGE_PATH_THREADS,
                       rows_per_thread: int = MERGE_PATH_ROWS_PER_THREAD,
                       group: int = MERGE_PATH_GROUP):
    """Launch the merge-path kernels on CUDA tensors; returns (lanes, lens,
    idx, splits, tile) -- the co-rank of every tile boundary with the tile's
    rows, for tests and tuning."""
    na, nb = a_lanes.shape[0], b_lanes.shape[0]
    w, dev = a_lanes.shape[1], a_lanes.device
    tile = _entry("merge_path", "tez_merge_path_tile")(
        w, threads, rows_per_thread)
    if tile <= 0:
        raise ValueError(f"no merge-path tile of {threads} threads fits "
                         f"rows of {w} lanes in shared memory")
    n = na + nb
    splits = torch.empty(-(-n // tile) + 1, dtype=torch.int32, device=dev)
    out_lanes = torch.empty((n, w), dtype=torch.int32, device=dev)
    out_lens = torch.empty(n, dtype=torch.int32, device=dev)
    out_idx = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _launch("merge_path_pair", "merge_path", "tez_merge_path_pair",
                a_lanes.data_ptr(), a_lens.data_ptr(), a_idx.data_ptr(), na,
                b_lanes.data_ptr(), b_lens.data_ptr(), b_idx.data_ptr(), nb,
                w, threads, rows_per_thread, group, splits.data_ptr(),
                out_lanes.data_ptr(), out_lens.data_ptr(), out_idx.data_ptr())
    return out_lanes, out_lens, out_idx, splits, tile


def merge_path_pair(a_lanes: torch.Tensor, a_lens: torch.Tensor,
                    a_idx: torch.Tensor, b_lanes: torch.Tensor,
                    b_lens: torch.Tensor, b_idx: torch.Tensor):
    """Merge two runs sorted under the composite comparator, equal keys A
    first.  Lanes int32[na, W] / int32[nb, W], sort lengths int32[na] /
    int32[nb] (u32 bits), idx int32[na] / int32[nb]; returns the merged
    (lanes int32[na+nb, W], lengths, idx)."""
    dev = a_lanes.device
    for name, t, ndim in (("a_lanes", a_lanes, 2), ("a_lens", a_lens, 1),
                          ("a_idx", a_idx, 1), ("b_lanes", b_lanes, 2),
                          ("b_lens", b_lens, 1), ("b_idx", b_idx, 1)):
        _check(name, t, torch.int32, ndim, dev)
    na, nb = a_lanes.shape[0], b_lanes.shape[0]
    if b_lanes.shape[1] != a_lanes.shape[1] or \
            a_lens.shape[0] != na or a_idx.shape[0] != na or \
            b_lens.shape[0] != nb or b_idx.shape[0] != nb:
        raise ValueError("run shapes disagree")
    if na + nb >= INT32_MAX:
        raise ValueError("runs too long for int32 positions")
    if not _on_cuda(a_lanes):
        return _merge_path_plain(a_lanes, a_lens, a_idx, b_lanes, b_lens,
                                 b_idx)
    return _merge_path_launch(a_lanes, a_lens, a_idx, b_lanes, b_lens,
                              b_idx)[:3]
