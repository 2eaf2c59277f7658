"""Device-resident shuffle+sort pipeline for fixed-width records: the
port of tez_tpu/ops/device_pipeline.py.

Records whose keys are normalized to u32 lanes and whose values are
fixed-width words flow hash -> sort -> gather on the device; the host sees
only the per-partition counts and whatever it reads back.

* :func:`device_shuffle_sort`: one synchronous span.
* :class:`DeviceSpanScheduler`: the asynchronous double-buffered plane
  (ops/async_stage.py): spans submit as raw host arrays; the staging
  thread encodes and bucket-pads span k+1 into a pinned slot and copies it
  on a copy stream while span k's fused pipeline runs on the compute
  stream and span k-1's readback drains on worker threads.  Small spans
  coalesce into one bucketed dispatch.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from tez_tpu_torch.ops import kernels
from tez_tpu_torch.ops.device import (SpanStreams, _bucket, _lsd_passes,
                                      _read_async, _upload, resolve_device,
                                      uniform_clamped_lengths)


def _fused_pipeline_impl(key_mat: torch.Tensor, hash_lengths: torch.Tensor,
                         lanes: torch.Tensor, sort_lengths: torch.Tensor,
                         vals: torch.Tensor, num_partitions: int,
                         skip_length_pass: bool = False):
    """FNV partition + stable (partition, lanes, length) sort + payload
    gather + per-partition counts, all on the tensors' device."""
    partitions = kernels.fnv_hash_bytes(key_mat, hash_lengths,
                                        num_partitions)
    sorted_parts, perm = _lsd_passes(partitions, lanes, sort_lengths,
                                     skip_length_pass)
    # sorted_parts is sorted: P+1 binary searches give the counts (pad rows
    # carry partition INT32_MAX and fall past the last boundary)
    bounds = torch.searchsorted(
        sorted_parts, torch.arange(num_partitions + 1, dtype=torch.int32,
                                   device=sorted_parts.device))
    counts = (bounds[1:] - bounds[:-1]).to(torch.int32)
    return sorted_parts, lanes[perm], vals[perm], perm, counts


def _as_tensor(x, dev: torch.device) -> torch.Tensor:
    return x.to(dev) if isinstance(x, torch.Tensor) else _upload(x, dev)


def device_shuffle_sort(lanes, lengths, vals, key_mat, hash_lengths,
                        num_partitions: int, uniform_length=None,
                        device="cuda"):
    """Device pipeline over host arrays or tensors: lanes u32[N, L], lengths
    [N], vals [N, ...], key_mat uint8[N, W] (the hash matrix) and
    hash_lengths [N].  Returns device tensors (sorted partitions int32[NB],
    lanes int32[NB, L] (u32 bits), vals[NB, ...] (u32 as int32 bits), perm
    int64[NB], counts int32[P]); rows past N are tail sentinels.

    uniform_length: True/False when the caller already knows whether all
    clamped lengths are equal; None detects it from a host array."""
    dev = resolve_device(device)
    n = int(lanes.shape[0])
    nb = _bucket(n)
    width_cap = lanes.shape[1] * 4 + 1
    if uniform_length is None:
        uniform = isinstance(lengths, np.ndarray) and \
            uniform_clamped_lengths(lengths, width_cap)[0]
    else:
        uniform = bool(uniform_length)
    key_mat = _as_tensor(key_mat, dev)
    hash_lengths = _as_tensor(hash_lengths, dev).to(torch.int32)
    lanes = _as_tensor(lanes, dev)
    lengths = _as_tensor(lengths, dev).to(torch.int64)
    vals = _as_tensor(vals, dev)
    if nb != n:
        pad = nb - n
        key_mat = torch.nn.functional.pad(key_mat, (0, 0, 0, pad), value=255)
        hash_lengths = torch.nn.functional.pad(hash_lengths, (0, pad),
                                               value=-1)
        lanes = torch.nn.functional.pad(lanes, (0, 0, 0, pad), value=-1)
        lengths = torch.nn.functional.pad(lengths, (0, pad), value=width_cap)
        vals = torch.cat([vals, vals.new_zeros((pad,) + vals.shape[1:])])
    slen = lengths.clamp(max=width_cap).to(torch.int32)
    return _fused_pipeline_impl(key_mat.contiguous(), hash_lengths, lanes,
                                slen, vals, num_partitions,
                                skip_length_pass=uniform)


class DeviceSpanScheduler:
    """Async double-buffered plane over fixed-width spans.

    submit() takes host arrays (lanes, lengths, vals, key_mat, hash_lengths)
    for one span; results() blocks until everything drained and returns
    {span_id: (sorted_partitions, out_lanes, out_vals, perm, counts, n)} as
    host arrays (int32, uint32 lanes, the values' own dtype, int32, int32;
    n = real rows, bucketed rows beyond n are tail sentinels), as tez_tpu's.
    Coalesced spans share one result tuple whose rows are the stable sort
    of the concatenated spans, identical to merging the individually
    sorted spans since stable ties keep arrival order.
    """

    def __init__(self, num_partitions: int, depth: int = 2,
                 coalesce_records: int = 0, readback_workers: int = 2,
                 key_width: int = 0, counters: Any = None,
                 clock: Callable[[], float] = time.perf_counter,
                 instrument: bool = False, paused: bool = False,
                 contain_failures: bool = False,
                 watchdog_dispatch_ms: float = 0.0,
                 watchdog_readback_ms: float = 0.0,
                 breaker: Any = None, device="cuda") -> None:
        from tez_tpu_torch.ops.async_stage import AsyncSpanPipeline
        self.num_partitions = num_partitions
        # key_width only matters for submit_ragged(); every ragged key must
        # fit in it (the hash matrix is built at the next power-of-two
        # width, so a longer key would hash truncated)
        self.key_width = key_width
        self.streams = SpanStreams(device, slots=depth)
        if self.streams.cuda:
            # built here, never inside the dispatch stage's watchdog window
            kernels.load(("fnv_hash",))
        self.pipeline = AsyncSpanPipeline(
            encode_fn=self._encode,
            stage_fn=self._h2d,
            dispatch_fn=self._dispatch,
            readback_fn=self._readback,
            coalesce_fn=self._coalesce,
            records_fn=self._records,
            depth=depth,
            coalesce_records=coalesce_records,
            readback_workers=readback_workers,
            counters=counters, clock=clock, instrument=instrument,
            paused=paused, name="device-span",
            # failure containment: a failed or hung device attempt re-sorts
            # through the numpy twin of the fused pipeline (bit-exact)
            failover_fn=self._host_failover if contain_failures else None,
            breaker=breaker,
            watchdog_dispatch_ms=watchdog_dispatch_ms,
            watchdog_readback_ms=watchdog_readback_ms)

    def submit(self, span_id, lanes, lengths, vals, key_mat, hash_lengths,
               coalesce: bool = True) -> None:
        self.pipeline.submit(span_id, {
            "lanes": lanes, "lengths": lengths, "vals": vals,
            "key_mat": key_mat, "hash_lengths": hash_lengths,
        }, coalesce=coalesce)

    def submit_ragged(self, span_id, key_bytes, key_offsets, val_bytes,
                      val_width: int, coalesce: bool = True) -> None:
        """Submit one span of ragged key bytes + fixed-width values.  The
        lane/hash-matrix encode runs on the staging thread (the overlapped
        host-encode stage); needs key_width > 0 at construction and every
        key to fit in it."""
        if self.key_width <= 0:
            raise ValueError("submit_ragged requires key_width > 0")
        self.pipeline.submit(span_id, {
            "key_bytes": key_bytes, "key_offsets": key_offsets,
            "val_bytes": val_bytes, "val_width": val_width,
        }, coalesce=coalesce)

    def resume(self) -> None:
        self.pipeline.resume()

    def results(self) -> Dict[Any, Tuple]:
        return self.pipeline.drain()

    # -- stages (staging thread / readback workers) -------------------------
    @staticmethod
    def _records(p: Dict) -> int:
        if "lanes" in p:
            return int(p["lanes"].shape[0])
        return len(p["key_offsets"]) - 1

    def _encode(self, p: Dict) -> Dict:
        if "key_bytes" in p:
            return self._encode_ragged(p)
        # raw-array producers arrive lane-encoded already; the encode stage
        # normalizes dtypes so coalesce and pad are pure concatenation
        return {
            "lanes": np.ascontiguousarray(p["lanes"], dtype=np.uint32),
            "lengths": np.asarray(p["lengths"], dtype=np.int64),
            "vals": np.ascontiguousarray(p["vals"]),
            "key_mat": np.ascontiguousarray(p["key_mat"], dtype=np.uint8),
            "hash_lengths": np.asarray(p["hash_lengths"], dtype=np.int32),
        }

    def _encode_ragged(self, p: Dict) -> Dict:
        from tez_tpu_torch.ops.keycodec import matrix_to_lanes, pad_to_matrix
        kb, ko = p["key_bytes"], p["key_offsets"]
        n = len(ko) - 1
        mat, lengths = pad_to_matrix(kb, ko, self.key_width)
        lanes = matrix_to_lanes(mat)
        hash_w = 1 << max(2, (self.key_width - 1).bit_length())
        hmat, hlens = pad_to_matrix(kb, ko, hash_w)
        vals = np.ascontiguousarray(
            p["val_bytes"].reshape(n, p["val_width"])).view(np.uint32)
        return {
            "lanes": lanes, "lengths": lengths.astype(np.int64),
            "vals": vals, "key_mat": hmat,
            "hash_lengths": hlens.astype(np.int32),
        }

    def _coalesce(self, staged: List[Dict]) -> Dict:
        # defer the merge: _bucketize writes every span straight into the
        # bucketed staging buffers, one copy instead of concat-then-pad.
        # Coalesced spans must share lane/hash/value widths (the ragged
        # path guarantees it; mismatched pre-encoded spans fail loudly on
        # assignment)
        return {"_spans": staged}

    def _bucketize(self, s: Dict, alloc) -> Dict:
        """Merge the (possibly coalesced) spans into bucket-padded buffers
        with the kernels' tail sentinels; alloc(specs, fill) provides the
        buffers.  Shared by the device upload (_h2d: pinned staging slots)
        and the host failover twin (numpy), so padding semantics can never
        diverge."""
        spans = s["_spans"] if "_spans" in s else [s]
        first = spans[0]
        nlanes = first["lanes"].shape[1]
        width_cap = nlanes * 4 + 1
        n = sum(int(sp["lanes"].shape[0]) for sp in spans)
        nb = _bucket(n)
        lengths = np.full(nb, width_cap, dtype=np.int64)
        off = 0
        for sp in spans:
            m = int(sp["lanes"].shape[0])
            lengths[off:off + m] = sp["lengths"]
            off += m
        uniform = n == 0 or \
            uniform_clamped_lengths(lengths[:n], width_cap)[0]
        vdt = first["vals"].dtype

        def fill(key_mat, hash_lengths, lanes, sort_lengths, vals):
            # pad rows: the kernels' tail sentinels
            key_mat[n:], hash_lengths[n:] = 255, -1
            lanes[n:], vals[n:] = np.uint32(0xFFFFFFFF), 0
            o = 0
            for sp in spans:
                m = int(sp["lanes"].shape[0])
                lanes[o:o + m] = sp["lanes"]
                key_mat[o:o + m] = sp["key_mat"]
                hash_lengths[o:o + m] = sp["hash_lengths"]
                vals[o:o + m] = sp["vals"]
                o += m
            sort_lengths[:] = np.minimum(lengths, width_cap)

        bufs = alloc([((nb, first["key_mat"].shape[1]), np.uint8),
                      ((nb,), np.int32), ((nb, nlanes), np.uint32),
                      ((nb,), np.uint32),
                      ((nb,) + first["vals"].shape[1:], vdt)], fill)
        return {"bufs": bufs, "uniform": uniform, "n": n, "vals_dtype": vdt}

    def _h2d(self, s: Dict) -> Dict:
        h = self._bucketize(s, self.streams.stage)
        (tensors, ready) = h.pop("bufs")
        h["tensors"], h["ready"] = tensors, ready
        return h

    def _dispatch(self, s: Dict):
        """The fused pipeline (FNV kernel, LSD passes, gathers, counts) and
        the D2H copies of its outputs into pinned memory, enqueued on the
        compute stream; nothing here waits on the card."""
        key_mat, hash_lengths, lanes, slen, vals = s["tensors"]
        with self.streams.on(self.streams.compute):
            if s["ready"] is not None:
                torch.cuda.current_stream().wait_event(s["ready"])
            sp, out_lanes, out_vals, perm, counts = _fused_pipeline_impl(
                key_mat, hash_lengths, lanes, slen, vals,
                self.num_partitions, skip_length_pass=s["uniform"])
            host, done = _read_async([sp, out_lanes, out_vals,
                                      perm.to(torch.int32), counts])
        return host, done, s["n"], s["vals_dtype"]

    def _readback(self, inflight, ids):
        host, done, n, vdt = inflight
        if done is not None:
            done.synchronize()
        sp, out_lanes, out_vals, perm, counts = [t.numpy() for t in host]
        return (sp, out_lanes.view(np.uint32), out_vals.view(vdt), perm,
                counts, n)

    # -- failure containment -------------------------------------------------
    def _host_failover(self, ids, payloads) -> Tuple:
        """Numpy twin of the fused pipeline over the raw payloads: the same
        bucketed staging buffers, FNV hash partition (pad rows carry
        partition INT32_MAX like the kernel's), stable (partition, lanes,
        length) sort, gather and searchsorted counts; bit-exact with the
        device result, never touches the device."""
        from tez_tpu_torch.ops.host_sort import (host_hash_partition,
                                                 host_sort_run)
        staged = [self._encode(p) for p in payloads]
        one = staged[0] if len(staged) == 1 else self._coalesce(staged)

        def alloc(specs, fill):
            bufs = [np.empty(shape, dtype=dt) for shape, dt in specs]
            fill(*bufs)
            return bufs

        s = self._bucketize(one, alloc)
        key_mat, hash_lengths, lanes, slen, vals = s["bufs"]
        n = s["n"]
        parts = np.full(key_mat.shape[0], np.iinfo(np.int32).max,
                        dtype=np.int32)
        if n > 0:
            parts[:n] = host_hash_partition(key_mat[:n], hash_lengths[:n],
                                            self.num_partitions)
        sp, perm = host_sort_run(parts, lanes, slen)
        sp32 = sp.astype(np.int32)
        bounds = np.searchsorted(
            sp32, np.arange(self.num_partitions + 1, dtype=np.int32))
        counts = (bounds[1:] - bounds[:-1]).astype(np.int32)
        return (sp32, lanes[perm], vals[perm], perm.astype(np.int32), counts,
                n)
