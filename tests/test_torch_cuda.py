"""tez_tpu_torch on the card: each CUDA kernel against its plain PyTorch
version at every load flavour the kernels compile, and the slice's entry
points on device="cuda" against the same calls on device="cpu", bit for
bit.  Every test needs a card and skips without one.

This file imports neither JAX nor tez_tpu, so it runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from tez_tpu_torch.ops import device, kernels
from tez_tpu_torch.ops.device_pipeline import device_shuffle_sort
from tez_tpu_torch.ops.runformat import KVBatch
from tez_tpu_torch.ops.sorter import (DeviceSorter, merge_sorted_runs,
                                      sum_long_combiner)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no host mode")
    return torch.device("cuda")


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("w", [3, 4, 12, 16, 32])
def test_fnv_bytes_kernel(cuda, w):
    """W = 3 takes byte loads, 4 and 12 word loads, 16 and 32 uint4."""
    rng = np.random.default_rng(w)
    mat = rng.integers(0, 256, (5001, w)).astype(np.uint8)
    lengths = rng.integers(-1, w + 3, 5001).astype(np.int32)
    for p in (1, 7, 2 ** 31 - 1):
        got = kernels.fnv_hash_bytes(_t(mat).to(cuda), _t(lengths).to(cuda), p)
        assert torch.equal(got.cpu(), kernels.fnv_hash_bytes(
            _t(mat), _t(lengths), p))


@pytest.mark.parametrize("num_lanes", [1, 3, 4])
def test_fnv_lanes_kernel(cuda, num_lanes):
    rng = np.random.default_rng(num_lanes)
    lanes = rng.integers(0, 2 ** 32, (4097, num_lanes), dtype=np.uint64)\
        .astype(np.uint32)
    lengths = rng.integers(-1, 4 * num_lanes + 1, 4097).astype(np.int32)
    got = kernels.fnv_hash_lanes(_t(lanes).to(cuda), _t(lengths).to(cuda), 5)
    assert torch.equal(got.cpu(), kernels.fnv_hash_lanes(
        _t(lanes), _t(lengths), 5))


@pytest.mark.parametrize("w", [1, 3, 4, 8, 9])
def test_merge_rank_kernel(cuda, w):
    """W <= 8 uses the register flavours, W = 9 the generic one."""
    rng = np.random.default_rng(w)
    run = rng.integers(0, 4, (3000, w)).astype(np.uint32)
    run_len = rng.integers(1, 9, 3000).astype(np.uint32)
    run[-7:] = 0xFFFFFFFF
    run_len[-7:] = 0xFFFFFFFF
    order = np.lexsort((run_len,) + tuple(run[:, i]
                                          for i in range(w - 1, -1, -1)))
    run, run_len = run[order], run_len[order]
    q = rng.integers(0, 4, (2001, w)).astype(np.uint32)
    q_len = rng.integers(1, 9, 2001).astype(np.uint32)
    q[:500], q_len[:500] = run[:500], run_len[:500]
    host = [_t(a) for a in (run, run_len, q, q_len)]
    for count_equal in (False, True):
        got = kernels.merge_rank(*[a.to(cuda) for a in host], count_equal)
        assert torch.equal(got.cpu(), kernels.merge_rank(*host, count_equal))


def _batches(seed, n_batches, n, max_key):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        lens = rng.integers(1, max_key + 1, n)
        ko = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=ko[1:])
        kb = rng.integers(97, 100, int(ko[-1])).astype(np.uint8)
        vals = np.frombuffer(b"".join(
            (int(v) + (1 << 63)).to_bytes(8, "big")
            for v in rng.integers(0, 5, n)), np.uint8).copy()
        out.append(KVBatch(kb, ko, vals, np.arange(n + 1) * 8))
    return out


def _same(a, b):
    for x, y in ((a.batch.key_bytes, b.batch.key_bytes),
                 (a.batch.val_bytes, b.batch.val_bytes),
                 (a.row_index, b.row_index)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("max_key,key_width,combine", [
    (12, 12, False), (9, 16, True), (30, 8, False)])
def test_sorter_and_merges_match_host(cuda, max_key, key_width, combine):
    """Resident span sorts, the resident and generic merges, and the
    over-width hash path: card and host give the same bytes."""
    runs = {}
    for dev in ("cuda", "cpu"):
        producers = []
        for p in range(3):
            s = DeviceSorter(num_partitions=4, key_width=key_width,
                             span_budget_bytes=40000, device_min_records=0,
                             combiner=sum_long_combiner if combine else None,
                             device=dev)
            for b in _batches(p, 3, 1200, max_key):
                s.write_batch(b)
            producers.append(s.flush())
        runs[dev] = (producers, merge_sorted_runs(
            producers, 4, key_width, device_min_records=0, device=dev))
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        _same(a, b)
    _same(runs["cuda"][1], runs["cpu"][1])


def test_device_functions_match_host(cuda):
    rng = np.random.default_rng(1)
    n = 3000
    mat = rng.integers(97, 100, (n, 12)).astype(np.uint8)
    lengths = rng.integers(1, 13, n).astype(np.int32)
    lanes = mat.view(">u4").astype(np.uint32)
    hmat = np.zeros((n, 16), np.uint8)
    hmat[:, :12] = mat
    vals = rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    for fn in (lambda d: device.hash_partition(mat, lengths, 5, device=d),
               lambda d: device.hash_sort_span(hmat, lengths, lanes, lengths,
                                               5, device=d),
               lambda d: device.sort_run(lengths % 3, lanes, lengths,
                                         device=d),
               lambda d: device.hash_sort_span_resident(lanes, lengths, 5,
                                                        device=d)[:2],
               lambda d: [t.cpu() for t in device_shuffle_sort(
                   lanes, lengths, vals, hmat, lengths, 5, device=d)]):
        got, want = fn("cuda"), fn("cpu")
        for g, w in zip(got if isinstance(got, (tuple, list)) else [got],
                        want if isinstance(want, (tuple, list)) else [want]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
