"""Device data plane: hash partition, span sort and merge-path merge.

The PyTorch counterpart of tez_tpu/ops/device.py.  Each function keeps its
tez_tpu name and contract (host numpy in, host numpy out, except where a
device view is returned for a later merge); ``device`` names where the work
runs and defaults to the card.  The two TPU kernels are CUDA kernels here
(ops/kernels.py): tez_tpu's ``_hash_to_partitions`` and the partition step
over ``_fnv_rows_from_lanes`` are ``kernels.fnv_hash_bytes`` and
``kernels.fnv_hash_lanes``; ``_rank_rows`` is ``kernels.merge_rank``.
Stable sorts, gathers, the merge-path scatter and the partition counts are
plain PyTorch calls, as tez_tpu left them to XLA.

Representation: key lanes and sort lengths are u32 values carried as int32
bits (kernels.py).  An int32 length of -1 -- the pad sentinel -- has the
bits of u32 0xFFFFFFFF, the sentinel sort length, so tez_tpu's
``_merge_path_prep`` mapping from lengths to sort lengths is the identity
here and only the row index remains of it.

Shapes keep tez_tpu's power-of-two bucket padding and its tail sentinels:
the permutations that ``_map_bucketed_perm`` and the merge ladder compute
depend on them.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from tez_tpu_torch.ops import kernels
from tez_tpu_torch.ops.kernels import INT32_MAX, u32_order


def accelerator_present() -> bool:
    """True when a CUDA card answers."""
    return torch.cuda.is_available()


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a card raises (the
    port never carries on on the CPU unless asked with device="cpu")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not accelerator_present():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


#: Substrings marking a device failure as out-of-memory (tez_tpu's markers,
#: including the fault plane's injected `device.dispatch.oom`).
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Resource exhausted",
                "out of memory", "OOM", "device.dispatch.oom")


def is_resource_exhausted(exc: BaseException) -> bool:
    """True when a device-attempt failure should take the OOM ladder."""
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def uniform_clamped_lengths(lengths: np.ndarray, width_cap: int):
    """(is_uniform, pad_value) over CLAMPED lengths (clamp first: all-long
    keys compare equal at the cap)."""
    if len(lengths) == 0:
        return False, width_cap
    clamped = np.minimum(lengths.astype(np.int64), width_cap)
    lo, hi = int(clamped.min()), int(clamped.max())
    return lo == hi, (lo if lo == hi else width_cap)


def _bucket(n: int, floor: int = 256) -> int:
    """Round up to the shape bucket (power of two)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Host array -> tensor on `dev`; unsigned 32/64-bit columns travel as
    the signed type of the same width (same bits)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a).to(dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# hash partition
# ---------------------------------------------------------------------------
def hash_partition(key_mat: np.ndarray, lengths: np.ndarray,
                   num_partitions: int, device="cuda") -> np.ndarray:
    """FNV-1a partition of each row's first lengths[i] bytes of
    key_mat[i, :] (uint8[N, W]); int32[N], equal to the host
    HashPartitioner for keys that fit the width."""
    dev = resolve_device(device)
    n = key_mat.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    nb = _bucket(n)
    lengths = lengths.astype(np.int32)
    if nb != n:
        key_mat = np.pad(key_mat, ((0, nb - n), (0, 0)))
        lengths = np.pad(lengths, (0, nb - n))
    out = kernels.fnv_hash_bytes(_upload(key_mat, dev), _upload(lengths, dev),
                                 num_partitions)
    return _host(out[:n])


# ---------------------------------------------------------------------------
# partitioned stable sort
# ---------------------------------------------------------------------------
def _lsd_passes(partitions: torch.Tensor, lanes: torch.Tensor,
                sort_lens: torch.Tensor, skip_length_pass: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable LSD passes by (partition, lanes..., sort length): one stable
    single-key sort per column, least significant first, each carrying the
    permutation.  Returns (sorted partitions int32, perm int64).

    skip_length_pass: every real key has the same clamped length, so the
    length pass would be an identity reorder.  The partition pass always
    runs: pad rows carry partition INT32_MAX and it sweeps them to the
    tail."""
    n = partitions.shape[0]
    perm = torch.arange(n, dtype=torch.int64, device=partitions.device)
    if not skip_length_pass:
        _, perm = torch.sort(u32_order(sort_lens), stable=True)
    for i in range(lanes.shape[1] - 1, -1, -1):
        _, idx = torch.sort(u32_order(lanes[:, i])[perm], stable=True)
        perm = perm[idx]
    sorted_parts, idx = torch.sort(partitions[perm], stable=True)
    return sorted_parts, perm[idx]


def hash_sort_span_resident(lanes: np.ndarray, lengths: np.ndarray,
                            num_partitions: int, device="cuda"):
    """Resident span sort: upload lanes + lengths only, hash the partition
    from the lanes on the device, stable (partition, lanes, length) sort.
    Returns host (sorted partitions, permutation) plus the device view
    (sorted lanes, sorted lengths, 0, n) whose rows >= n are tail
    sentinels.  Caller guarantees every true length fits the lanes."""
    dev = resolve_device(device)
    n = lanes.shape[0]
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64), None)
    uniform, _pad = uniform_clamped_lengths(lengths, lanes.shape[1] * 4 + 1)
    nb = _bucket(n)
    lengths = lengths.astype(np.int32)
    if nb != n:
        lanes = np.pad(lanes, ((0, nb - n), (0, 0)),
                       constant_values=np.uint32(0xFFFFFFFF))
        lengths = np.pad(lengths, (0, nb - n), constant_values=-1)
    lanes_t, lens_t = _upload(lanes, dev), _upload(lengths, dev)
    partitions = kernels.fnv_hash_lanes(lanes_t, lens_t, num_partitions)
    # uniform real lengths make the length pass an identity reorder even
    # with tail sentinels present: the partition pass places those
    sp, perm = _lsd_passes(partitions, lanes_t, lens_t,
                           skip_length_pass=uniform)
    dev_keys = (lanes_t[perm], lens_t[perm], 0, n)
    return _host(sp[:n]), _host(perm[:n]), dev_keys


def _slice_to_bucket(lanes: torch.Tensor, lengths: torch.Tensor, lo: int,
                     count: int, out_rows: int, out_lanes: int):
    """Rows [lo, lo+count) padded to out_rows with tail sentinels and
    widened to out_lanes with ZERO lanes (bytes beyond a key's length are
    zero in the lane encoding, so widening preserves order)."""
    sl = torch.full((out_rows, out_lanes), -1, dtype=torch.int32,
                    device=lanes.device)
    ln = torch.full((out_rows,), -1, dtype=torch.int32, device=lanes.device)
    w = lanes.shape[1]
    sl[:count, :w] = lanes[lo:lo + count]
    sl[:count, w:] = 0
    ln[:count] = lengths[lo:lo + count]
    return sl, ln


def _fused_resident_merge(lanes_list: List[torch.Tensor],
                          lens_list: List[torch.Tensor]) -> torch.Tensor:
    """Single-partition k-way merge as a stable sort of the concatenation
    (equal keys keep run order); sentinel rows sort to the tail."""
    lanes = torch.cat(lanes_list, dim=0)
    lens = torch.cat(lens_list, dim=0)
    parts = torch.where(lens < 0, INT32_MAX, 0).to(torch.int32)
    _, perm = _lsd_passes(parts, lanes, lens)
    return perm


def _map_bucketed_perm(perm: np.ndarray, counts, common: int) -> np.ndarray:
    """Map a permutation over the BUCKETED concatenation (k runs, each
    padded to `common` rows) back to host rows of the real concatenation,
    dropping sentinel positions."""
    bounds = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum([common] * len(counts), out=bounds[1:])
    host_offsets = np.zeros(len(counts), dtype=np.int64)
    np.cumsum(counts[:-1], out=host_offsets[1:])
    run_id = np.searchsorted(bounds[1:], perm, side="right")
    within = perm - bounds[run_id]
    real = within < np.asarray(counts)[run_id]
    return (host_offsets[run_id] + within)[real].astype(np.int64)


def merge_resident_slices(slices, kernel: str = "merge_path") -> np.ndarray:
    """k-way merge over device-resident key views.

    slices: list of (lanes, lens, lo, hi) device tensors.  Returns the merge
    permutation into the HOST concatenation of the real rows (run order
    preserved for equal keys); only the permutation leaves the device.
    kernel="merge_path" runs the log2(k) ladder of rank-and-scatter
    levels; kernel="sort" re-sorts the concatenation."""
    counts = [hi - lo for (_l, _n, lo, hi) in slices]
    common = _bucket(max(counts))
    width = max(l.shape[1] for (l, _n, _lo, _hi) in slices)
    lanes_list, lens_list = [], []
    for (lanes, lens, lo, hi) in slices:
        sl, ln = _slice_to_bucket(lanes, lens, lo, hi - lo, common, width)
        lanes_list.append(sl)
        lens_list.append(ln)
    if kernel == "merge_path":
        perm = _merge_path_ladder([
            (sl, ln, i * common + torch.arange(common, device=sl.device))
            for i, (sl, ln) in enumerate(zip(lanes_list, lens_list))])
    elif kernel == "sort":
        perm = _fused_resident_merge(lanes_list, lens_list)
    else:
        raise ValueError(f"unknown merge kernel {kernel!r}")
    return _map_bucketed_perm(_host(perm), counts, common)


# ---------------------------------------------------------------------------
# merge-path: O(N) two-way merge of pre-sorted runs via cross ranks.
# out_pos(a_i) = i + |{b : b < a_i}| and out_pos(b_j) = j + |{a : a <= b_j}|
# tile [0, na+nb) exactly; the asymmetric </<= pair makes equal keys emit
# in run order.  A k-way merge is a log2(k) ladder of pair merges.
# ---------------------------------------------------------------------------
def _merge_path_pair(a_lanes, a_lens, a_idx, b_lanes, b_lens, b_idx):
    """One merge level: rank each run in the other, scatter both runs to
    their output positions.  Sentinel rows take part, so the output is again
    a sorted run with every real row in the prefix."""
    na, nb = a_lanes.shape[0], b_lanes.shape[0]
    dev = a_lanes.device
    ra = kernels.merge_rank(b_lanes, b_lens, a_lanes, a_lens,
                            count_equal=False)
    rb = kernels.merge_rank(a_lanes, a_lens, b_lanes, b_lens,
                            count_equal=True)
    pos_a = torch.arange(na, device=dev) + ra
    pos_b = torch.arange(nb, device=dev) + rb
    out = []
    for a, b in ((a_lanes, b_lanes), (a_lens, b_lens), (a_idx, b_idx)):
        o = torch.empty((na + nb,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=dev)
        o.index_copy_(0, pos_a, a)
        o.index_copy_(0, pos_b, b)
        out.append(o)
    return tuple(out)


def _merge_path_ladder(runs):
    """log2(k) ladder over (lanes, sort_lens, idx) triples: pair adjacent
    runs left to right (an odd last run carries up), so equal keys meet in
    run order at every level.  Returns the final idx column."""
    while len(runs) > 1:
        nxt = [_merge_path_pair(*runs[i], *runs[i + 1])
               for i in range(0, len(runs) - 1, 2)]
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0][2]


def merge_path_runs(parts_list: Sequence[np.ndarray],
                    lanes_list: Sequence[np.ndarray],
                    lengths_list: Sequence[np.ndarray],
                    device="cuda") -> np.ndarray:
    """Generic (non-resident) k-way merge-path merge of pre-sorted runs.

    Each run is sorted by (partition, key lanes, clamped length); the
    partition is prepended as the most significant lane.  Returns the merge
    permutation into the host concatenation of the runs (equal keys in run
    order).  Prefix-equal keys beyond the lanes compare equal here and are
    ordered by the caller's host tie-break pass."""
    dev = resolve_device(device)
    counts = [l.shape[0] for l in lanes_list]
    live = [i for i, c in enumerate(counts) if c > 0]
    if not live:
        return np.zeros(0, dtype=np.int64)
    width = max(lanes_list[i].shape[1] for i in live)
    width_cap = width * 4 + 1
    common = _bucket(max(counts[i] for i in live))
    runs = []
    for j, i in enumerate(live):
        n = counts[i]
        comp = np.empty((common, width + 1), dtype=np.uint32)
        comp[:n, 0] = parts_list[i].astype(np.uint32)
        comp[:n, 1:1 + lanes_list[i].shape[1]] = lanes_list[i]
        comp[:n, 1 + lanes_list[i].shape[1]:] = 0
        comp[n:] = np.uint32(0xFFFFFFFF)
        lens = np.full(common, -1, dtype=np.int32)
        lens[:n] = np.minimum(lengths_list[i].astype(np.int64), width_cap)
        runs.append((_upload(comp, dev), _upload(lens, dev),
                     j * common + torch.arange(common, device=dev)))
    perm = _host(_merge_path_ladder(runs))
    mapped = _map_bucketed_perm(perm, [counts[i] for i in live], common)
    if len(live) != len(counts):   # re-offset into the FULL concatenation
        all_offsets = np.zeros(len(counts), dtype=np.int64)
        np.cumsum(counts[:-1], out=all_offsets[1:])
        live_offsets = np.zeros(len(live), dtype=np.int64)
        np.cumsum([counts[i] for i in live[:-1]], out=live_offsets[1:])
        run_id = np.searchsorted(live_offsets[1:], mapped, side="right")
        mapped = mapped - live_offsets[run_id] + \
            all_offsets[np.asarray(live)[run_id]]
    return mapped


def hash_sort_span(key_mat: np.ndarray, hash_lengths: np.ndarray,
                   lanes: np.ndarray, lengths: np.ndarray,
                   num_partitions: int, device="cuda"
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Span sort for keys wider than the lanes: full-key FNV partition over
    the byte matrix + stable (partition, key) sort.  Returns (sorted
    partitions, permutation)."""
    dev = resolve_device(device)
    n = key_mat.shape[0]
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int64)
    width_cap = lanes.shape[1] * 4 + 1
    slen = np.minimum(lengths.astype(np.int64), width_cap)
    # pad rows only matter to the final partition pass, so they take the
    # uniform length and the length pass can still be skipped
    uniform, pad_len = uniform_clamped_lengths(slen, width_cap)
    nb = _bucket(n)
    hash_lengths = hash_lengths.astype(np.int32)
    if nb != n:
        pad = nb - n
        key_mat = np.pad(key_mat, ((0, pad), (0, 0)), constant_values=255)
        hash_lengths = np.pad(hash_lengths, (0, pad), constant_values=-1)
        lanes = np.pad(lanes, ((0, pad), (0, 0)),
                       constant_values=np.uint32(0xFFFFFFFF))
        slen = np.pad(slen, (0, pad), constant_values=pad_len)
    partitions = kernels.fnv_hash_bytes(_upload(key_mat, dev),
                                        _upload(hash_lengths, dev),
                                        num_partitions)
    sp, perm = _lsd_passes(partitions, _upload(lanes, dev),
                           _upload(slen.astype(np.int32), dev),
                           skip_length_pass=uniform)
    sp, perm = _host(sp), _host(perm)
    if nb != n:
        keep = perm < n
        sp, perm = sp[keep], perm[keep]
    return sp, perm


def sort_run(partitions: np.ndarray, lanes: np.ndarray,
             lengths: np.ndarray, device="cuda"
             ) -> tuple[np.ndarray, np.ndarray]:
    """Stable sort by (partition, key lanes, clamped length) of a span whose
    partitions are already known.  The clamped length orders keys whose zero
    padding collides; beyond-prefix keys compare equal and are resolved by
    the host tie-break pass.  Returns (sorted partition ids, permutation)."""
    dev = resolve_device(device)
    n = partitions.shape[0]
    if n == 0:
        return partitions, np.zeros(0, dtype=np.int64)
    width_cap = lanes.shape[1] * 4 + 1
    lengths = np.minimum(lengths.astype(np.int64), width_cap)
    nb = _bucket(n)
    if nb != n:
        partitions = np.pad(partitions, (0, nb - n),
                            constant_values=np.iinfo(np.int32).max)
        lanes = np.pad(lanes, ((0, nb - n), (0, 0)))
        lengths = np.pad(lengths, (0, nb - n))
    sp, perm = _lsd_passes(_upload(partitions.astype(np.int32), dev),
                           _upload(lanes, dev),
                           _upload(lengths.astype(np.int32), dev))
    return _host(sp[:n]), _host(perm[:n])


def merge_runs(lanes_list: List[np.ndarray], lengths_list: List[np.ndarray],
               device="cuda") -> np.ndarray:
    """k-way merge of sorted key-lane arrays -> permutation into the
    concatenation (stable: equal keys keep run order)."""
    if not lanes_list:
        return np.zeros(0, dtype=np.int64)
    lanes = np.concatenate(lanes_list, axis=0)
    lengths = np.concatenate(lengths_list, axis=0)
    zeros = np.zeros(lanes.shape[0], dtype=np.int32)
    _, perm = sort_run(zeros, lanes, lengths, device=device)
    return perm


def partition_counts(partitions: np.ndarray, num_partitions: int,
                     device="cuda") -> np.ndarray:
    """Rows per partition id in [0, num_partitions); int64[P]."""
    dev = resolve_device(device)
    if partitions.shape[0] == 0:
        return np.zeros(num_partitions, dtype=np.int64)
    p = _upload(partitions.astype(np.int64), dev)
    p = p[(p >= 0) & (p < num_partitions)]
    return _host(torch.bincount(p, minlength=num_partitions))\
        .astype(np.int64)
