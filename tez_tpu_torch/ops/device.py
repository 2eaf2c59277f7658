"""Device data plane: hash partition, span sort and merge-path merge.

The PyTorch counterpart of tez_tpu/ops/device.py.  Each function keeps its
tez_tpu name and contract (host numpy in, host numpy out, except where a
device view is returned for a later merge); ``device`` names where the work
runs and defaults to the card.  The TPU kernels are CUDA kernels here
(ops/kernels.py): tez_tpu's ``_hash_to_partitions`` and the partition step
over ``_fnv_rows_from_lanes`` are ``kernels.fnv_hash_bytes`` and
``kernels.fnv_hash_lanes``; ``_merge_path_pair``, two ``_rank_rows`` and a
scatter in tez_tpu, is one ``kernels.merge_path_pair``.  Stable sorts,
gathers and the partition counts are plain PyTorch calls, as tez_tpu left
them to XLA.

Representation: key lanes and sort lengths are u32 values carried as int32
bits (kernels.py).  An int32 length of -1 -- the pad sentinel -- has the
bits of u32 0xFFFFFFFF, the sentinel sort length, so tez_tpu's
``_merge_path_prep`` mapping from lengths to sort lengths is the identity
here and only the int32 row index remains of it.

Shapes keep tez_tpu's power-of-two bucket padding and its tail sentinels:
the permutations that ``_map_bucketed_perm`` and the merge ladder compute
depend on them.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Sequence, Tuple

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


def device_context(dev: torch.device):
    """Context that makes `dev` the current CUDA device (a pipeline thread
    never chose one); nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def stream_context(dev: torch.device, stream):
    """Context that makes `dev` and its CUDA `stream` current; nothing on
    the CPU."""
    if dev.type == "cuda":
        return _device_and_stream(dev, stream)
    return contextlib.nullcontext()


def is_resource_exhausted(exc: BaseException) -> bool:
    """True when a device-attempt failure should take the OOM ladder."""
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


#: Substrings of the CUDA runtime's error reports, which torch raises as
#: RuntimeError (AcceleratorError in newer releases).
_CUDA_ERROR_MARKERS = ("CUDA error", "CUDA driver error", "cudaError")


def is_kernel_fault(exc: BaseException) -> bool:
    """True when a device-attempt failure is a broken kernel (build, load
    or launch) or a CUDA error other than out-of-memory, such as an
    illegal address surfacing at an event's synchronize.  The containment
    ladder never fails such a span over to the host: it would hide the
    fault."""
    if isinstance(exc, kernels.KernelError):
        return True
    if is_resource_exhausted(exc):
        return False
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and \
        any(m in str(exc) for m in _CUDA_ERROR_MARKERS)


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
    return torch.from_numpy(_signed_view(np.ascontiguousarray(a))).to(dev)


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


# ---------------------------------------------------------------------------
# the resident span sort as three stages (ops/async_stage.py pipeline):
# stage (host bucket-pad + H2D), dispatch (kernels enqueued, no host
# synchronisation), readback (wait on the span's own event).
# hash_sort_span_resident runs them back to back on a one-slot
# SpanStreams; the async plane runs them on different threads over one
# SpanStreams of `depth` slots, so span k+1's staging overlaps span k's
# sort.
# ---------------------------------------------------------------------------
#: byte alignment of the arrays carved out of one pinned staging slot
_SLOT_ALIGN = 256
#: numpy dtype -> the torch dtype of the same bits
_TORCH_BITS = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32,
               np.dtype(np.uint32): torch.int32, np.dtype(np.int64): torch.int64,
               np.dtype(np.uint64): torch.int64}


#: (copy, compute) stream pairs that closed SpanStreams gave back, per
#: device.  torch.cuda.Stream() hands out torch's pooled streams round
#: robin, and the caching allocator keeps freed device blocks per stream:
#: a pipeline on a stream no earlier span used grows the pool (cudaMalloc,
#: a host call of widely varying cost) inside its first dispatches.  A
#: pair taken back here still has the blocks its earlier spans freed.
_IDLE_PAIRS: Dict[torch.device, List[tuple]] = {}
_IDLE_LOCK = threading.Lock()
#: stream pairs held by open SpanStreams (taken and not given back yet)
_HELD_PAIRS = 0


def held_stream_pairs() -> int:
    """How many SpanStreams hold a pair now: 0 once every pipeline closed,
    a killed attempt's included."""
    with _IDLE_LOCK:
        return _HELD_PAIRS


class SpanStreams:
    """The CUDA streams and page-locked staging slots of one async pipeline.

    H2D copies run on ``copy`` and the span sorts on ``compute``.  ``slots``
    pinned host buffers are filled round robin, so pinning is paid once per
    slot and not per span; a slot is never refilled before the copy that
    last read it has completed (its event), and the pipeline's gate (at
    most ``depth`` = ``slots`` spans past staging) means that wait is
    normally already over.  The streams come from the idle pairs of this
    device when there is one (_IDLE_PAIRS) and go back there at close();
    two open SpanStreams never share a pair.  On the CPU there are no
    streams and no slots: staging hands numpy memory to torch as is."""

    def __init__(self, device="cuda", slots: int = 2) -> None:
        global _HELD_PAIRS
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.copy = self.compute = None
        self._slots: List[list] = []
        self._closed = False
        if self.cuda:
            with _IDLE_LOCK:
                idle = _IDLE_PAIRS.get(self.device)
                pair = idle.pop() if idle else None
                _HELD_PAIRS += 1
            if pair is None:
                with torch.cuda.device(self.device):
                    pair = (torch.cuda.Stream(), torch.cuda.Stream())
            self.copy, self.compute = pair
            self._slots = [[None, None] for _ in range(max(1, slots))]
        self._next = 0

    def close(self) -> None:
        """Give the streams back for a later SpanStreams on this device;
        the owner enqueues nothing more on them (work already enqueued
        stays ordered before the next owner's).  Idempotent."""
        global _HELD_PAIRS
        if not self.cuda or self._closed:
            return
        self._closed = True
        with _IDLE_LOCK:
            _IDLE_PAIRS.setdefault(self.device, []).append(
                (self.copy, self.compute))
            _HELD_PAIRS -= 1

    def on(self, stream):
        """Context: this pipeline's device and `stream` current."""
        if not self.cuda:
            return contextlib.nullcontext()
        return _device_and_stream(self.device, stream)

    def stage(self, specs, fill):
        """Stage one span: `fill` writes the numpy views of one host buffer
        per (shape, numpy dtype) of `specs`, which are then copied to the
        device on the copy stream.  Returns (device tensors, ready event);
        the compute stream waits on the event before it reads them.  On
        the card the buffers are carved from the next pinned slot (u32/u64
        as the signed torch type of the same width); on the CPU they are
        fresh host memory, the result is their torch view and there is no
        event.  Called by one thread at a time (the staging thread)."""
        if not self.cuda:
            host = [np.empty(shape, dtype=dtype) for shape, dtype in specs]
            fill(*host)
            return [torch.from_numpy(_signed_view(a)) for a in host], None
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot[1] is not None:
            slot[1].synchronize()      # the copy that last read this slot
        sizes = [-(-int(np.prod(shape)) * np.dtype(dt).itemsize //
                   _SLOT_ALIGN) * _SLOT_ALIGN for shape, dt in specs]
        if slot[0] is None or slot[0].numel() < sum(sizes):
            slot[0] = torch.empty(sum(sizes), dtype=torch.uint8,
                                  pin_memory=True)
        host, off = [], 0
        for (shape, dt), size in zip(specs, sizes):
            nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
            host.append(slot[0][off:off + nbytes]
                        .view(_TORCH_BITS[np.dtype(dt)]).view(shape))
            off += size
        fill(*[t.numpy().view(dt) for t, (_s, dt) in zip(host, specs)])
        with self.on(self.copy):
            dev = []
            for h in host:
                d = h.to(self.device, non_blocking=True)
                # allocated on the copy stream, read on the compute stream:
                # without this the caching allocator could hand the block
                # out again while a kernel still reads it
                d.record_stream(self.compute)
                dev.append(d)
            ready = torch.cuda.Event()
            ready.record(self.copy)
        slot[1] = ready
        return dev, ready


@contextlib.contextmanager
def _device_and_stream(dev: torch.device, stream):
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def _signed_view(a: np.ndarray) -> np.ndarray:
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype == np.uint64:
        return a.view(np.int64)
    return a


def _pinned_like(t: torch.Tensor) -> torch.Tensor:
    """Page-locked host tensor shaped as device tensor `t` (a readback
    target; the caching host allocator recycles it once freed)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _read_async(tensors: Sequence[torch.Tensor], into=None):
    """Enqueue D2H copies of `tensors` into page-locked host tensors on the
    current stream and record an event after them: (host tensors, event).
    `into`, when given, holds those host tensors, allocated earlier; else
    they are allocated here.  On the CPU the tensors themselves and no
    event."""
    if not tensors or tensors[0].device.type != "cuda":
        return list(tensors), None
    out = []
    for i, t in enumerate(tensors):
        h = _pinned_like(t) if into is None else into[i]
        h.copy_(t, non_blocking=True)
        out.append(h)
    done = torch.cuda.Event()
    done.record()
    return out, done


def stage_resident_span(lanes: np.ndarray, lengths: np.ndarray,
                        streams: SpanStreams):
    """Host bucket-pad + H2D upload of a resident span (n > 0 rows): the
    rows are padded straight into the next pinned slot of `streams` and
    copied on its copy stream.  The page-locked readback targets of the
    span's dispatch are allocated here too, on the staging thread: a miss
    of torch's caching host allocator pins fresh pages in cudaHostAlloc, a
    blocking host call whose cost grows with the span, and the dispatch
    stage only enqueues.  Returns (lanes, lengths, n, skip_length_pass,
    ready event, readback targets)."""
    n = lanes.shape[0]
    uniform, _pad = uniform_clamped_lengths(lengths, lanes.shape[1] * 4 + 1)
    nb = _bucket(n)

    def fill(hl, hn):
        hl[:n] = lanes
        hl[n:] = 0xFFFFFFFF
        hn[:n] = lengths
        hn[n:] = -1

    (lanes_t, lens_t), ready = streams.stage(
        [((nb, lanes.shape[1]), np.uint32), ((nb,), np.int32)], fill)
    targets = None
    if streams.cuda:
        # (sorted partitions, permutation): _lsd_passes's dtypes
        targets = (torch.empty(n, dtype=torch.int32, pin_memory=True),
                   torch.empty(n, dtype=torch.int64, pin_memory=True))
    return lanes_t, lens_t, n, uniform, ready, targets


def dispatch_resident_span(staged, num_partitions: int,
                           streams: SpanStreams):
    """Enqueue the resident sort of a staged span (see _dispatch_resident).
    Out of device memory, it raises a fresh OutOfMemoryError: the failed
    attempt's traceback would otherwise keep its frames' intermediates
    (and the staged span) allocated while the out-of-memory ladder retries
    the span in halves on the device."""
    try:
        return _dispatch_resident(staged, num_partitions, streams)
    except torch.cuda.OutOfMemoryError as e:
        msg = str(e)
    del staged
    raise torch.cuda.OutOfMemoryError(msg)


def _dispatch_resident(staged, num_partitions: int, streams: SpanStreams):
    """Enqueue the resident sort of a staged span: the lane hash kernel,
    the stable LSD passes, the gathers of the sorted key columns and the
    D2H copies of (sorted partitions, permutation) into the pinned targets
    that staging allocated, on the compute stream of `streams`.  Nothing
    here waits on the card: no .cpu()/.item(), no data-dependent shape.
    Returns (host partitions, host perm, sorted lanes, sorted lengths, n,
    done event); readback_resident_span waits on the event."""
    lanes_t, lens_t, n, uniform, ready, targets = staged
    with streams.on(streams.compute):
        if ready is not None:
            torch.cuda.current_stream().wait_event(ready)
        partitions = kernels.fnv_hash_lanes(lanes_t, lens_t, num_partitions)
        # uniform real lengths make the length pass an identity reorder even
        # with tail sentinels present: the partition pass places those
        sp, perm = _lsd_passes(partitions, lanes_t, lens_t,
                               skip_length_pass=uniform)
        out_lanes, out_lens = lanes_t[perm], lens_t[perm]
        (sp_h, perm_h), done = _read_async([sp[:n], perm[:n]],
                                           into=targets)
    return sp_h, perm_h, out_lanes, out_lens, n, done


def readback_resident_span(inflight):
    """Wait for one dispatched span (its own event, never the whole card)
    and return host (sorted partitions, permutation) plus the device view
    (sorted lanes, sorted lengths, 0, n), as hash_sort_span_resident."""
    sp_h, perm_h, out_lanes, out_lens, n, done = inflight
    if done is not None:
        done.synchronize()
    return sp_h.numpy(), perm_h.numpy(), (out_lanes, out_lens, 0, n)


def hash_sort_span_resident(lanes: np.ndarray, lengths: np.ndarray,
                            num_partitions: int, device="cuda"):
    """Resident span sort: upload lanes + lengths only, hash the partition
    from the lanes on the device, stable (partition, lanes, length) sort.
    Returns host (sorted partitions, permutation) plus the device view
    (sorted lanes, sorted lengths, 0, n) whose rows >= n are tail
    sentinels.  Caller guarantees every true length fits the lanes.  The
    three stages back to back, through a one-slot SpanStreams: the pinned
    slot comes from torch's caching host allocator, so pinning is paid
    once per span size, not per call."""
    if lanes.shape[0] == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64), None)
    streams = SpanStreams(device, slots=1)
    try:
        return readback_resident_span(dispatch_resident_span(
            stage_resident_span(lanes, lengths, streams), num_partitions,
            streams))
    finally:
        streams.close()


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
        if lanes.is_cuda:
            # An async span's key columns were made on its pipeline's
            # compute stream (their readback waited on that stream's event,
            # so they are complete).  Record this stream's use of them:
            # otherwise the caching allocator could recycle their blocks
            # for the compute stream while this merge still reads them.
            cur = torch.cuda.current_stream(lanes.device)
            lanes.record_stream(cur)
            lens.record_stream(cur)
        sl, ln = _slice_to_bucket(lanes, lens, lo, hi - lo, common, width)
        lanes_list.append(sl)
        lens_list.append(ln)
    if kernel == "merge_path":
        perm = _merge_path_ladder([
            (sl, ln, _run_index(i, common, sl.device))
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
def _run_index(i: int, common: int, dev: torch.device) -> torch.Tensor:
    """int32 positions of run i's rows in the bucketed concatenation."""
    return torch.arange(i * common, (i + 1) * common, dtype=torch.int32,
                        device=dev)


def _merge_path_pair(a_lanes, a_lens, a_idx, b_lanes, b_lens, b_idx):
    """One merge level, one merge-path kernel: both runs land at their
    output positions.  Sentinel rows take part, so the output is again a
    sorted run with every real row in the prefix."""
    return kernels.merge_path_pair(a_lanes, a_lens, a_idx, b_lanes, b_lens,
                                   b_idx)


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
                     _run_index(j, common, dev)))
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
