"""Device-resident shuffle+sort pipeline for fixed-width records: the
synchronous half of tez_tpu/ops/device_pipeline.py.

Records whose keys are normalized to u32 lanes and whose values are
fixed-width words flow hash -> sort -> gather on the device; the host sees
only the per-partition counts and whatever it reads back.  (The async
``DeviceSpanScheduler`` needs the async stage plane and is not ported yet.)
"""
from __future__ import annotations

import numpy as np
import torch

from tez_tpu_torch.ops import kernels
from tez_tpu_torch.ops.device import (_bucket, _lsd_passes, _upload,
                                      resolve_device, uniform_clamped_lengths)


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
