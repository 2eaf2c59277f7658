"""tez_tpu_torch on the card: each CUDA kernel against its plain PyTorch
version at every load flavour and lane width the kernels compile, and the
slice's entry points on device="cuda" against the same calls on
device="cpu", bit for bit.  Every test needs a card and skips without one.

This file imports neither JAX nor tez_tpu, so it runs on a machine that
has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import gc
import os
import time

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


@pytest.mark.parametrize("n", [1, 1023, 1025, 5001, (1 << 20) + 7])
@pytest.mark.parametrize("w", [1, 3, 4, 8, 12, 16, 32, 64, 100])
def test_fnv_bytes_kernel(cuda, w, n):
    """Every flavour (W = 4, 8, 16, 32 and 64 templated, any other width
    read at run time) against the plain version: one row, a tile and a
    short tail, many tiles; lengths -1, 0, W and past W; P a power of two
    or not; each base 16-byte aligned or not (a view one element in)."""
    rng = np.random.default_rng(1000 * w + n % 1000)
    mat = rng.integers(0, 256, (n, w)).astype(np.uint8)
    lengths = rng.integers(-1, w + 3, n).astype(np.int32)
    lengths[:4] = np.array([-1, 0, w, w + 5], dtype=np.int32)[:n]
    h = kernels._fnv_rows(_t(mat), _t(lengths))
    dm, dl = _t(mat).to(cuda), _t(lengths).to(cuda)
    mbuf = torch.empty(n * w + 1, dtype=torch.uint8, device=cuda)
    mbuf[1:] = dm.flatten()
    lbuf = torch.empty(n + 1, dtype=torch.int32, device=cuda)
    lbuf[1:] = dl
    um, ul = mbuf[1:].view(n, w), lbuf[1:]
    for p in (1, 2, 7, 8, 2 ** 31 - 1):
        want = kernels._to_partitions(h, _t(lengths), p)
        for km, kl in ((dm, dl), (um, dl), (dm, ul), (um, ul)):
            assert torch.equal(kernels.fnv_hash_bytes(km, kl, p).cpu(), want)


@pytest.mark.parametrize("num_lanes", [1, 3, 4])
def test_fnv_lanes_kernel(cuda, num_lanes):
    rng = np.random.default_rng(num_lanes)
    lanes = rng.integers(0, 2 ** 32, (4097, num_lanes), dtype=np.uint64)\
        .astype(np.uint32)
    lengths = rng.integers(-1, 4 * num_lanes + 1, 4097).astype(np.int32)
    got = kernels.fnv_hash_lanes(_t(lanes).to(cuda), _t(lengths).to(cuda), 5)
    assert torch.equal(got.cpu(), kernels.fnv_hash_lanes(
        _t(lanes), _t(lengths), 5))


def _rank_inputs(seed, n, m, w, kind, vals=4, offset=0):
    """Host int32 tensors (run lanes, run lengths, query lanes, query
    lengths): a sorted run with a sentinel tail and m queries, a third of
    them copies of run rows.  kind: "sorted", "unsorted" (shuffled) or
    "mixed" (sorted, with a shuffled stretch whose ends fall inside tiles).
    offset > 0 starts every tensor `offset` rows into a larger one (off a
    16-byte boundary)."""
    rng = np.random.default_rng(seed)

    def sorted_rows(k):
        lanes = rng.integers(0, vals, (k, w)).astype(np.uint32)
        lens = rng.integers(1, 9, k).astype(np.uint32)
        order = np.lexsort((lens,) + tuple(lanes[:, i]
                                           for i in range(w - 1, -1, -1)))
        return lanes[order], lens[order]

    run, run_len = sorted_rows(n)
    run[n - n // 100:], run_len[n - n // 100:] = 0xFFFFFFFF, 0xFFFFFFFF
    q, q_len = sorted_rows(m)
    if n:
        pick = np.sort(rng.integers(0, n, m // 3))
        q[:m // 3], q_len[:m // 3] = run[pick], run_len[pick]
    order = np.lexsort((q_len,) + tuple(q[:, i] for i in range(w - 1, -1, -1)))
    q, q_len = q[order], q_len[order]
    if kind == "unsorted":
        perm = rng.permutation(m)
        q, q_len = q[perm], q_len[perm]
    elif kind == "mixed":
        lo, hi = m // 5 + 3, (3 * m) // 5 + 1
        perm = lo + rng.permutation(hi - lo)
        q[lo:hi], q_len[lo:hi] = q[perm], q_len[perm]
    out = []
    for a in (run, run_len, q, q_len):
        pad = np.zeros((offset,) + a.shape[1:], a.dtype)
        out.append(_t(np.concatenate([pad, a]))[offset:])
    return out


def _check_merge_rank(cuda, host):
    """The wrapper's ranks on the card == the plain version's (on the CPU)
    for both flavours, and the kernel's windows == merge_rank_windows."""
    dev = [t.to(cuda) for t in host]
    for count_equal in (False, True):
        want = kernels.merge_rank(*host, count_equal)
        assert torch.equal(kernels.merge_rank(*dev, count_equal).cpu(), want)
        got, windows, tile = kernels._merge_rank_launch(*dev, count_equal)
        assert torch.equal(got.cpu(), want)
        assert torch.equal(windows.cpu(), kernels.merge_rank_windows(
            *host, count_equal, tile))
    return windows, tile


@pytest.mark.parametrize("kind", ["random", "sorted", "mixed"])
@pytest.mark.parametrize("w", [1, 3, 4, 8, 9])
def test_merge_rank_kernel(cuda, w, kind):
    """W <= 8 uses the register flavours, W = 9 the generic one; sorted
    tiles rank in their shared-memory window, the others against the
    splitter table."""
    host = _rank_inputs(w, 3000, 5001, w,
                        "unsorted" if kind == "random" else kind)
    windows, _ = _check_merge_rank(cuda, host)
    assert windows[2].all() == (kind == "sorted")
    kernels.reset_launches()
    got = kernels.merge_rank(*[t.to(cuda) for t in host], True)
    assert kernels.launches["merge_rank"] == 1
    assert torch.equal(got.cpu(), kernels._rank_search(*host, True))


@pytest.mark.parametrize("w", [3, 9])
def test_merge_rank_kernel_windows_wider_than_shared_memory(cuda, w):
    """Sorted queries whose windows do not fit the shared-memory region:
    an all-equal run (rows below, at and above its key) and a run 256
    times longer than the queries.  Both go through the splitter table
    narrowed to [lo, hi]."""
    run, run_len, q, q_len = _rank_inputs(w, 300000, 4000, w, "sorted",
                                          vals=3)
    run[:] = 1
    run_len[:] = 4
    # no query equals the run's key: the tile that crosses it has a window
    # of the whole run
    q_len[(q == 1).all(dim=1) & (q_len == 4)] = 5
    windows, _ = _check_merge_rank(cuda, (run, run_len, q, q_len))
    assert windows[2].all()
    assert int((windows[1] - windows[0]).max()) > 50000
    windows, _ = _check_merge_rank(
        cuda, _rank_inputs(w + 1, 1 << 20, 4096, w, "sorted", vals=16))
    assert int((windows[1] - windows[0]).min()) > 50000


def test_merge_rank_kernel_tiles_straddle_order_boundary(cuda):
    """A shuffled stretch starting and ending inside tiles: the tiles
    around each end are out of order, the rest in order.  Then stretches
    of 3,589 rows, sorted and shuffled by turns, over more tiles than the
    grid has CTAs, so the tiles one CTA walks take the splitter table and
    the staged window by turns (a window staged over the table drops it;
    the table is staged again after it)."""
    host = _rank_inputs(5, 20000, 40000, 3, "mixed")
    windows, tile = _check_merge_rank(cuda, host)
    flags = windows[2].tolist()
    assert 0 in flags and 1 in flags
    assert 40000 % tile and (40000 // 5 + 3) % tile
    m, stripe = (1 << 20) - 333, 3589
    run, run_len, q, q_len = _rank_inputs(6, 20000, m, 3, "sorted")
    rng = np.random.default_rng(6)
    for lo in range(stripe, m, 2 * stripe):
        hi = min(lo + stripe, m)
        perm = torch.from_numpy(lo + rng.permutation(hi - lo))
        q[lo:hi], q_len[lo:hi] = q[perm], q_len[perm]
    windows, tile = _check_merge_rank(cuda, (run, run_len, q, q_len))
    sorted_tiles = int(windows[2].sum())
    props = torch.cuda.get_device_properties(cuda)
    assert windows.shape[1] > 4 * props.multi_processor_count
    assert 0.2 < sorted_tiles / windows.shape[1] < 0.8


@pytest.mark.parametrize("w", [3, 4, 9])
def test_merge_rank_kernel_unaligned_inputs(cuda, w):
    """Every input starts 3 rows into its buffer: off a 16-byte boundary."""
    for kind in ("sorted", "unsorted"):
        host = _rank_inputs(w, 7001, 6003, w, kind, offset=3)
        assert host[1].data_ptr() % 16 and host[3].data_ptr() % 16
        _check_merge_rank(cuda, host)


def test_merge_rank_kernel_wide_rows_cut_the_tile(cuda):
    """Rows of 200 lanes: the shared-memory region holds ~100 rows, so
    the tile shrinks to keep windows fitting twice, and the ranks are
    still exact."""
    host = _rank_inputs(200, 3000, 2500, 200, "mixed", vals=2)
    _, tile = _check_merge_rank(cuda, host)
    assert tile < 1024


def test_merge_rank_kernel_million_rows(cuda):
    """2^20 rows and queries, sorted and random; the plain version runs
    on the card (the host would take minutes)."""
    for kind in ("sorted", "unsorted"):
        dev = [t.to(cuda) for t in _rank_inputs(
            11, 1 << 20, 1 << 20, 3, kind, vals=8)]
        for count_equal in (False, True):
            got, windows, tile = kernels._merge_rank_launch(*dev,
                                                            count_equal)
            assert torch.equal(got, kernels._rank_search(*dev, count_equal))
            assert torch.equal(windows, kernels.merge_rank_windows(
                *dev, count_equal, tile))


def test_merge_rank_kernel_run_above_2_30_rows(cuda):
    """A run of 5 * 2^28 rows (W = 1, 10.7 GB on the card) with queries
    that rank in its top eighth, above 2^30, where the sum of two search
    bounds passes INT32_MAX: shuffled queries (splitter table, then device
    memory), sorted queries ~2,560 rows apart (windows too wide for shared
    memory, searched in device memory) and sorted neighbours (staged
    windows), each with sentinel queries; both flavours against the plain
    version and the closed form of this run's ranks."""
    n = 5 << 28
    if torch.cuda.get_device_properties(cuda).total_memory < (24 << 30):
        pytest.skip("needs 24 GB of device memory")
    row = torch.arange(n, dtype=torch.int32, device=cuda)
    run = (row >> 1).view(n, 1)    # run row 2i + j = (lane i, length j)
    run_len = row & 1
    del row
    m, top = 1 << 16, n // 2
    g = torch.Generator(device=cuda).manual_seed(0)
    spread = top - 1 - torch.randint(0, top // 8, (m,), generator=g,
                                     device=cuda, dtype=torch.int32)
    lens = torch.randint(0, 3, (m,), generator=g, device=cuda,
                         dtype=torch.int32)
    key = torch.sort(spread.to(torch.int64) * 4 + lens).values
    near = torch.arange(m, device=cuda, dtype=torch.int32)
    sentinel = torch.full((64,), -1, dtype=torch.int32, device=cuda)
    cases = {
        "shuffled": (spread, lens),
        "sparse sorted": ((key // 4).to(torch.int32),
                          (key % 4).to(torch.int32)),
        "dense sorted": (top - m // 2 + near // 2, (near % 2) * 2),
    }
    try:
        for kind, (q, q_len) in cases.items():
            q = torch.cat([q, sentinel]).view(-1, 1)
            q_len = torch.cat([q_len, sentinel])
            for count_equal in (False, True):
                got = kernels.merge_rank(run, run_len, q, q_len, count_equal)
                want = kernels._rank_search(run, run_len, q, q_len,
                                            count_equal)
                assert torch.equal(got, want), kind
                closed = 2 * q[:-64, 0].to(torch.int64) + \
                    (q_len[:-64] + int(count_equal)).clamp(max=2)
                assert torch.equal(want[:-64].to(torch.int64), closed), kind
                assert bool((want[-64:] == n).all())
                assert int(want[:-64].min()) > 1 << 30
                _, windows, tile = kernels._merge_rank_launch(
                    run, run_len, q, q_len, count_equal)
                assert torch.equal(windows, kernels.merge_rank_windows(
                    run, run_len, q, q_len, count_equal, tile))
                wn = windows[1, :-1] - windows[0, :-1]
                if kind == "shuffled":
                    assert not bool(windows[2, :-1].any())
                elif kind == "sparse sorted":
                    assert bool(windows[2].all()) and int(wn.min()) > 1 << 20
                else:
                    assert bool(windows[2].all()) and int(wn.max()) < 4096
    finally:
        del run, run_len
        torch.cuda.empty_cache()


def test_merge_rank_kernel_empty_sides(cuda):
    """An empty run ranks every query 0; no queries launch nothing."""
    run, run_len, q, q_len = _rank_inputs(1, 0, 777, 3, "unsorted")
    _check_merge_rank(cuda, (run, run_len, q, q_len))
    kernels.reset_launches()
    out = kernels.merge_rank(run.to(cuda), run_len.to(cuda),
                             q[:0].to(cuda), q_len[:0].to(cuda), False)
    assert out.shape == (0,) and kernels.launches["merge_rank"] == 0


def _merge_pair(seed, na, nb, w, ties=3, sentinels=(0, 0), offset=0):
    """Host int32 tensors (a_lanes, a_lens, a_idx, b_lanes, b_lens, b_idx)
    of two runs sorted under the composite comparator; `sentinels` pad rows
    end each run.  offset > 0 makes each column a contiguous slice that
    starts `offset` rows into a larger tensor (unaligned starts)."""
    rng = np.random.default_rng(seed)
    out = []
    for n, sent, base in ((na, sentinels[0], 0), (nb, sentinels[1], na)):
        lanes = rng.integers(0, ties, (n + offset, w)).astype(np.uint32)
        lens = rng.integers(1, 9, n + offset).astype(np.uint32) if ties > 1 \
            else np.full(n + offset, 4, np.uint32)
        order = np.lexsort((lens[offset:],) + tuple(
            lanes[offset:, i] for i in range(w - 1, -1, -1)))
        lanes[offset:], lens[offset:] = lanes[offset:][order], \
            lens[offset:][order]
        if sent:
            lanes[n + offset - sent:] = 0xFFFFFFFF
            lens[n + offset - sent:] = 0xFFFFFFFF
        idx = np.arange(base - offset, base + n, dtype=np.int32)
        out += [_t(lanes)[offset:], _t(lens)[offset:], _t(idx)[offset:]]
    return out


def _check_merge_path(cuda, host, **launch):
    """Kernel == plain version (on the CPU) on all three outputs, and the
    kernel's tile splits == merge_path_splits at the tile boundaries."""
    dev = [t.to(cuda) for t in host]
    got = kernels._merge_path_launch(*dev, **launch)
    want = kernels.merge_path_pair(*host)
    for g, w in zip(got[:3], want):
        assert torch.equal(g.cpu(), w)
    n, tile = got[0].shape[0], got[4]
    diagonals = (torch.arange(got[3].shape[0]) * tile).clamp(max=n)
    assert torch.equal(got[3].cpu(), kernels.merge_path_splits(
        host[0], host[1], host[3], host[4], diagonals))


@pytest.mark.parametrize("na,nb", [(3001, 2999), (4100, 2050), (0, 1777),
                                   (1777, 0), (1, 1), (5, 4096)])
@pytest.mark.parametrize("w", [1, 3, 4, 8, 9])
def test_merge_path_pair_kernel(cuda, w, na, nb):
    """Ragged sizes (not tile multiples), the odd carry na = 2 nb, empty
    sides; sentinel tails on both runs.  W <= 8 takes the register
    flavours, W = 9 the generic one."""
    host = _merge_pair(w * 1000 + na, na, nb, w,
                       sentinels=(na // 64, nb // 32))
    _check_merge_path(cuda, host)
    kernels.reset_launches()
    out = kernels.merge_path_pair(*[t.to(cuda) for t in host])
    assert kernels.launches["merge_path_pair"] == 1
    assert out[2].dtype == torch.int32


@pytest.mark.parametrize("w", [1, 4, 9])
def test_merge_path_pair_kernel_all_equal_and_all_sentinel(cuda, w):
    """Every row equal (every A row must precede every B row); both runs
    all pad sentinels; one run all sentinels against real rows."""
    _check_merge_path(cuda, _merge_pair(w, 5000, 3000, w, ties=1))
    _check_merge_path(cuda, _merge_pair(w, 2500, 2500, w,
                                        sentinels=(2500, 2500)))
    _check_merge_path(cuda, _merge_pair(w, 2100, 4000, w,
                                        sentinels=(2100, 0)))


@pytest.mark.parametrize("threads,rows_per_thread,group", [
    (32, 1, 1), (64, 4, 2), (128, 8, 32), (128, 16, 1), (256, 8, 8),
    (1024, 2, 4), (128, 4, 16), (128, 15, 0), (96, 3, 0)])
def test_merge_path_pair_kernel_tile_shapes(cuda, threads, rows_per_thread,
                                            group):
    """Other CTA shapes and boundary-search groups, and inputs that start
    off a 16-byte boundary."""
    for w in (3, 4, 9):
        _check_merge_path(cuda, _merge_pair(w, 7001, 6003, w,
                                            sentinels=(30, 5), offset=3),
                          threads=threads, rows_per_thread=rows_per_thread,
                          group=group)


def test_merge_path_pair_kernel_wide_rows_cut_the_tile(cuda):
    """Rows of W = 40 lanes do not fit a 2048-row tile (128 threads x 16
    rows) in shared memory: the tile is cut to fit, and the merge is still
    exact."""
    host = _merge_pair(40, 3000, 2000, 40, ties=2, sentinels=(10, 10))
    dev = [t.to(cuda) for t in host]
    shape = dict(threads=128, rows_per_thread=16)
    assert kernels._merge_path_launch(*dev, **shape)[4] < 2048
    _check_merge_path(cuda, host, **shape)


def test_merge_path_pair_kernel_thousands_of_tiles(cuda):
    """2^22 rows a side: a partition array of thousands of entries.  The
    plain version runs on the card here (the host would take minutes)."""
    host = _merge_pair(7, 1 << 22, 1 << 22, 3, ties=8,
                       sentinels=(1 << 16, 1 << 16))
    dev = [t.to(cuda) for t in host]
    got = kernels._merge_path_launch(*dev)
    assert got[3].shape[0] > 2000
    want = kernels._merge_path_plain(*dev)
    for g, w in zip(got[:3], want):
        assert torch.equal(g, w)
    n, tile = got[0].shape[0], got[4]
    diagonals = (torch.arange(got[3].shape[0], device=cuda) * tile)\
        .clamp(max=n)
    assert torch.equal(got[3], kernels.merge_path_splits(
        dev[0], dev[1], dev[3], dev[4], diagonals))


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


# -- the async span plane on the card ------------------------------------------
def _bench_batches(seed, n_batches, n):
    """Bench-style records: 12-byte keys "w" + 11 digits over a Zipf(1.3)
    50k vocabulary, random 8-byte values; one batch per span."""
    rng = np.random.default_rng(seed)
    digits = np.arange(50_000)
    vocab = np.zeros((50_000, 12), np.uint8)
    vocab[:, 0] = ord("w")
    for i in range(11, 0, -1):
        vocab[:, i] = ord("0") + digits % 10
        digits = digits // 10
    out = []
    for _ in range(n_batches):
        ids = rng.zipf(1.3, n) % 50_000
        out.append(KVBatch(vocab[ids].reshape(-1),
                           np.arange(n + 1, dtype=np.int64) * 12,
                           rng.integers(0, 256, n * 8).astype(np.uint8),
                           np.arange(n + 1, dtype=np.int64) * 8))
    return out


def _flush_producer(batches, device, **kw):
    s = DeviceSorter(num_partitions=4, key_width=12,
                     span_budget_bytes=batches[0].nbytes, engine="device",
                     device=device, **kw)
    for b in batches:
        s.write_batch(b)
    assert s.num_spills == len(batches)
    return s.flush(), s


def _failovers(counters):
    from tez_tpu_torch.ops.async_stage import COUNTER_GROUP
    return {k: v for k, v in
            counters.to_dict().get(COUNTER_GROUP, {}).items() if v}


def test_async_sorter_matches_sync_on_the_card(cuda):
    """2 producers x 4 spans of 16 MB: pipeline_depth=2 flushes the bytes
    of pipeline_depth=0, with no containment counter moved; their merge
    matches too."""
    from tez_tpu_torch.ops.async_stage import reset_process_breaker
    reset_process_breaker()
    n = (16 << 20) // 36
    sync, runs = [], []
    for p in range(2):
        batches = _bench_batches(p, 4, n)
        sync.append(_flush_producer(batches, "cuda")[0])
        run, s = _flush_producer(batches, "cuda", pipeline_depth=2)
        assert not _failovers(s.counters)
        _same(run, sync[-1])
        runs.append(run)
    _same(merge_sorted_runs(runs, 4, 12, device="cuda"),
          merge_sorted_runs(sync, 4, 12, device="cuda"))


def _spy_placement(sorter) -> list:
    """(spill id, kept in RAM) of each run the async plane stores, in
    completion order."""
    placed = []
    store = sorter._async_complete

    def spy(ids, run):
        store(ids, run)
        placed.append((min(ids), not isinstance(sorter._runs[-1], str)))
    sorter._async_complete = spy
    return placed


def _records(file_run) -> tuple:
    run = file_run.to_run()
    return (run.row_index.tolist(), run.batch.key_bytes.tobytes(),
            run.batch.key_offsets.tolist(), run.batch.val_bytes.tobytes(),
            run.batch.val_offsets.tolist())


@pytest.mark.parametrize("device_min_records", [0, None])
def test_async_spilling_sorter_matches_host(cuda, tmp_path,
                                            device_min_records):
    """DeviceSorter(pipeline_depth=2) with a spill directory on the card:
    8 spans of 8 MB, 2 kept in RAM, 6 spilled; flush_run's FileRun is the
    same file, byte for byte, as the same sorter's on device="cpu", and
    the streamed merge's rounds ran the merge-path kernel (every round
    with device_min_records=0; the big ones with the default floor).

    A spy records which spill ids each run kept in RAM: should the files
    differ, the failure names both splits and says whether the decoded
    records still agree."""
    from tez_tpu_torch.ops.async_stage import reset_process_breaker
    from tez_tpu_torch.ops.runformat import FileRun
    reset_process_breaker()
    batches = _bench_batches(5, 8, (8 << 20) // 36)
    files, launches, placed, runs = {}, {}, {}, {}
    for dev in ("cuda", "cpu"):
        spill_dir = tmp_path / dev
        kw = {} if device_min_records is None else \
            {"device_min_records": device_min_records}
        s = DeviceSorter(num_partitions=4, key_width=12,
                         span_budget_bytes=batches[0].nbytes,
                         spill_dir=str(spill_dir), engine="device",
                         pipeline_depth=2, device=dev, **kw)
        placed[dev] = _spy_placement(s)
        kernels.reset_launches()
        for b in batches:
            s.write_batch(b)
        fr = s.flush_run()
        launches[dev] = dict(kernels.launches)
        assert isinstance(fr, FileRun) and not _failovers(s.counters)
        assert os.listdir(spill_dir) == [os.path.basename(fr.path)]
        files[dev] = open(fr.path, "rb").read()
        runs[dev] = fr
    if files["cuda"] != files["cpu"]:
        a, b = files["cuda"], files["cpu"]
        first = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                     min(len(a), len(b)))
        in_ram = {dev: sorted(sid for sid, ram in placed[dev] if ram)
                  for dev in placed}
        same = _records(runs["cuda"]) == _records(runs["cpu"])
        pytest.fail(f"files differ at byte {first} ({len(a)} / {len(b)} "
                    f"bytes); spill ids kept in RAM: card {in_ram['cuda']}, "
                    f"cpu {in_ram['cpu']}; completion order: card "
                    f"{[sid for sid, _r in placed['cuda']]}, cpu "
                    f"{[sid for sid, _r in placed['cpu']]}; decoded records "
                    f"{'equal' if same else 'DIFFER'}")
    assert launches["cuda"]["merge_path_pair"] > 0
    assert launches["cuda"]["fnv_hash_lanes"] == 8
    assert launches["cuda"]["merge_rank"] == 0


def test_async_dispatch_never_waits_on_the_card(cuda):
    """The dispatch stage enqueues and returns: with the compute stream
    held busy ~0.3 s (torch.cuda._sleep) just before each span's
    dispatch, the dispatch call still returns in a fraction of that, and
    only the readback waits it out."""
    from tez_tpu_torch.ops.async_stage import reset_process_breaker
    reset_process_breaker()
    batches = _bench_batches(9, 4, (16 << 20) // 36)
    cycles = 600_000_000     # about 0.3 s at the H100's 1.98 GHz boost
    s = DeviceSorter(num_partitions=4, key_width=12,
                     span_budget_bytes=batches[0].nbytes, device="cuda",
                     pipeline_depth=2)
    pipe = s._ensure_pipeline()
    dispatch, times = pipe._dispatch_fn, []

    def busy_then_dispatch(staged):
        with torch.cuda.stream(s._streams.compute):
            torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        out = dispatch(staged)
        times.append(time.perf_counter() - t0)
        return out

    pipe._dispatch_fn = busy_then_dispatch
    pipe._instrument = True
    for b in batches:
        s.write_batch(b)
    got = s.flush()
    _same(got, _flush_producer(batches, "cuda")[0])
    assert len(times) == 4 and max(times) < 0.1, times
    t = {(ids, stage, edge): v for ids, stage, edge, v in pipe.events}
    for sid in range(4):
        wait = t[((sid,), "device.d2h", "end")] - \
            t[((sid,), "device.dispatch", "start")]
        assert wait > 0.2, (sid, wait)
    assert pipe.stats.max_in_flight == 2


def test_async_stream_race_probe(cuda):
    """64 spans of 70k records, coalescing off, depth 2, then the resident
    flush merge over 64 runs made on the pipeline's streams, against the
    synchronous result, 5 times: a missing stream wait or record_stream
    shows up here as wrong bytes."""
    from tez_tpu_torch.ops.async_stage import reset_process_breaker
    reset_process_breaker()
    batches = _bench_batches(3, 64, 70_000)
    want, _ = _flush_producer(batches, "cuda")
    for _ in range(5):
        got, s = _flush_producer(batches, "cuda", pipeline_depth=2,
                                 pipeline_coalesce_records=0)
        assert not _failovers(s.counters)
        _same(got, want)
        del got
        torch.cuda.synchronize()


def test_span_streams_pairs_come_back(cuda):
    """A closed SpanStreams gives its (copy, compute) pair to the next one
    on the device, with the device blocks the caching allocator keeps for
    those streams; two open ones never share a pair; a sorter's pipeline
    gives its pair back at the drain, and its flush equals the
    synchronous one."""
    def pair(st):
        return st.copy.cuda_stream, st.compute.cuda_stream

    a, b = device.SpanStreams("cuda"), device.SpanStreams("cuda")
    assert pair(a) != pair(b)
    a.close()
    a.close()
    c = device.SpanStreams("cuda")
    assert pair(c) == pair(a)
    b.close()
    c.close()
    batches = _bench_batches(9, 2, 50_000)
    want, _ = _flush_producer(batches, "cuda")
    got, s = _flush_producer(batches, "cuda", pipeline_depth=2)
    _same(got, want)
    assert pair(s._streams) == pair(c)
    d = device.SpanStreams("cuda")
    assert pair(d) == pair(c)
    d.close()


def test_span_scheduler_on_the_card(cuda):
    """DeviceSpanScheduler on the card: the card and host schedulers agree
    span by span, uncoalesced (depth 2) and coalesced, and span 0 alone
    equals device_shuffle_sort of that span."""
    from tez_tpu_torch.ops.device_pipeline import DeviceSpanScheduler
    from tez_tpu_torch.ops.keycodec import pad_to_matrix
    batches = _bench_batches(5, 3, 200_000)
    res = {}
    for coalesce in (0, 600_000):
        for dev in ("cuda", "cpu"):
            sched = DeviceSpanScheduler(4, key_width=12,
                                        coalesce_records=coalesce,
                                        paused=True, device=dev)
            for sid, b in enumerate(batches):
                sched.submit_ragged(sid, b.key_bytes, b.key_offsets,
                                    b.val_bytes, 8)
            sched.resume()
            res[dev, coalesce] = sched.results()
        for sid in range(3):
            for g, w in zip(res["cuda", coalesce][sid],
                            res["cpu", coalesce][sid]):
                np.testing.assert_array_equal(g, w)
    assert res["cuda", 600_000][0][5] == 600_000
    b = batches[0]
    lanes, lengths = _lanes12(b)
    hmat, hlens = pad_to_matrix(b.key_bytes, b.key_offsets, 16)
    want = [t.cpu().numpy() for t in device_shuffle_sort(
        lanes, lengths.astype(np.int64),
        b.val_bytes.reshape(-1, 8).view(np.uint32), hmat, hlens, 4,
        device="cuda")]
    got = res["cuda", 0][0]
    assert got[5] == 200_000
    # the scheduler returns u32 lanes and values and an int32 perm, the
    # sync pipeline int32 bits and an int64 perm
    for g, w in zip(got[:5], want):
        np.testing.assert_array_equal(g.astype(np.int64),
                                      w.view(g.dtype).astype(np.int64)
                                      if w.dtype.itemsize == g.dtype.itemsize
                                      else w)


#: the device-memory cap of the real out-of-memory test, as a fraction of
#: one whole span's sort peak (allocated bytes) above the memory already in
#: use: just above the lowest cap at which the span's halves still sort on
#: the card when the test runs after the rest of this file (0.80; 0.75 in
#: a fresh process), while the whole span runs out up to 1.0.  PERF.md
#: records the oom_cap_sweep() readings.
OOM_CAP = 0.82


def _oom_split_run(batch, want, frac):
    """Flush one span through DeviceSorter(pipeline_depth=2) with the
    process's device memory capped at `frac` of the span's sort peak above
    what is in use.  Returns (counters moved, split calls, bytes equal to
    `want`, peak, base, retry errors); the cap is lifted afterwards."""
    from tez_tpu_torch.ops.async_stage import (CircuitBreaker,
                                               reset_process_breaker)
    reset_process_breaker()
    mat, lengths = _lanes12(batch)
    gc.collect()   # earlier failures' tracebacks may still hold tensors
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = device.hash_sort_span_resident(mat, lengths, 4, device="cuda")
    torch.cuda.synchronize()
    peak_full = torch.cuda.max_memory_allocated() - base
    del out
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.set_per_process_memory_fraction(
        (base + int(peak_full * frac)) / total)
    errors, calls = [], []
    try:
        s = DeviceSorter(num_partitions=4, key_width=12,
                         span_budget_bytes=batch.nbytes, device="cuda",
                         pipeline_depth=2, split_min_bytes=1 << 16,
                         breaker=CircuitBreaker(failures=100))
        pipe = s._ensure_pipeline()
        retry, split = pipe._oom_retry_fn, s._split_device_sort

        def traced_retry(ids, payloads):
            try:
                return retry(ids, payloads)
            except BaseException as e:
                errors.append(repr(e)[:400])
                raise

        def counted_split(*a, **k):
            calls.append(1)      # the split recurses through this too
            return split(*a, **k)

        pipe._oom_retry_fn = traced_retry
        s._split_device_sort = counted_split
        s.write_batch(batch)
        got = s.flush()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    same = all(np.array_equal(x, y) for x, y in (
        (got.batch.key_bytes, want.batch.key_bytes),
        (got.batch.val_bytes, want.batch.val_bytes),
        (got.row_index, want.row_index)))
    return _failovers(s.counters), len(calls), same, peak_full, base, errors


def oom_cap_sweep(fracs=(0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95,
                         1.0, 1.2)):
    """The real out-of-memory case at each cap of `fracs`, each in a fresh
    interpreter (no cap inherits another's cached blocks), one line each:
    whether the whole span ran out (split_attempts), how deep the split
    went (1 = its halves fit), whether it fell back to the host, and
    whether the bytes match.  Run on the card, from the repository root:

        python -c "import sys; sys.path.insert(0, 'tests');
                   import test_torch_cuda as t; t.oom_cap_sweep()"
    """
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    for frac in fracs:
        subprocess.run([sys.executable, "-c",
                        f"import sys; sys.path.insert(0, {here!r}); "
                        f"import test_torch_cuda as t; t._oom_cap_once({frac})"],
                       check=True)


def _oom_cap_once(frac):
    batch = _bench_batches(11, 1, 1 << 22)[0]
    want, _ = _flush_producer([batch], "cuda")
    fo, calls, same, peak, base, errors = _oom_split_run(batch, want, frac)
    print(f"oom cap {frac:.2f} x {peak} B above {base} B: split calls "
          f"{calls}, bytes equal {same}, {fo}"
          + (f", retry errors {[e[:160] for e in errors]}" if errors else ""),
          flush=True)


def test_real_out_of_memory_takes_the_split_ladder(cuda):
    """A real torch.cuda.OutOfMemoryError: the process's device memory is
    capped (set_per_process_memory_fraction) below what one whole span's
    sort needs but above what its halves need, so the dispatch runs out of
    memory and the span sorts in two halves on the card (one split, no
    deeper), bit-exact, with no host failover.  The cap is lifted
    afterwards."""
    batch = _bench_batches(11, 1, 1 << 22)[0]
    want, _ = _flush_producer([batch], "cuda")
    fo, calls, same, peak, base, errors = _oom_split_run(batch, want, OOM_CAP)
    print(f"peak of one span's sort {peak} B, cap {OOM_CAP} x that above "
          f"{base} B; split calls {calls}; {fo}")
    assert same
    assert fo.get("device.oom.split_attempts") == 1, fo
    assert fo.get("device.oom.split_success") == 1, (fo, errors)
    assert calls == 1, (calls, fo)
    assert "device.failover.spans" not in fo, fo


@pytest.mark.parametrize("kind", ["over_width", "custom_partitioner"])
def test_async_generic_spans_run_on_the_pipeline_stream(cuda, monkeypatch,
                                                        kind):
    """Generic spans at pipeline_depth=2 (keys wider than key_width, or a
    custom partitioner) sort whole on the staging thread: there the
    sorter's device and its pipeline's compute stream are current at every
    device call, the flush equals pipeline_depth=0's, and nothing fails
    over."""
    import threading
    from tez_tpu_torch.ops.async_stage import reset_process_breaker
    reset_process_breaker()
    over = kind == "over_width"
    batches = _batches(31, 4, 20_000, max_key=30 if over else 12)

    def flush(depth):
        s = DeviceSorter(num_partitions=4, key_width=8 if over else 12,
                         span_budget_bytes=batches[0].nbytes if over
                         else 1 << 19, device_min_records=0,
                         pipeline_depth=depth, device="cuda")
        for b in batches:
            if over:
                s.write_batch(b)
                continue
            for i in range(b.num_records):
                key = b.key_bytes[b.key_offsets[i]:b.key_offsets[i + 1]]
                s.write(key.tobytes(), b.val_bytes[8 * i:8 * i + 8].tobytes(),
                        partition=int(key[-1]) % 4)
        return s.flush(), s

    want, _ = flush(0)
    seen = []

    def recording(fn):
        def wrapped(*a, **k):
            if threading.current_thread() is not threading.main_thread():
                seen.append((torch.cuda.current_device(),
                             torch.cuda.current_stream()))
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(kernels, "fnv_hash_bytes",
                        recording(kernels.fnv_hash_bytes))
    monkeypatch.setattr(device, "sort_run", recording(device.sort_run))
    got, s = flush(2)
    _same(got, want)
    assert not _failovers(s.counters)
    assert s.num_spills >= 3 and len(seen) >= s.num_spills, (s.num_spills,
                                                            seen)
    assert all(d == torch.cuda.current_device() and st == s._streams.compute
               for d, st in seen), seen


def _lanes12(batch):
    """(u32 lanes, lengths) of a batch's keys at a 12-byte width."""
    from tez_tpu_torch.ops.keycodec import matrix_to_lanes, pad_to_matrix
    mat, lengths = pad_to_matrix(batch.key_bytes, batch.key_offsets, 12)
    return matrix_to_lanes(mat), lengths


# -- the reduce side's bounded-memory merge (library/merge_manager.py) --------
def _word_segments(seed, n_segments, n, vocab=200_000, unique=False):
    """Sorted segments of 1-16 byte words whose values name (segment,
    index).  unique=True draws every key once across all segments, so the
    merged order does not depend on which segment arrives first."""
    rng = np.random.default_rng(seed)
    lens_v = rng.integers(1, 17, vocab)
    mat = rng.integers(97, 123, (vocab, 16)).astype(np.uint8)
    mat[np.arange(16)[None, :] >= lens_v[:, None]] = 0
    _, first = np.unique(mat.view(np.dtype((np.void, 16))).ravel(),
                         return_index=True)
    mat, lens_v = mat[np.sort(first)], lens_v[np.sort(first)]
    order = np.lexsort((lens_v,) + tuple(
        mat.view(">u4")[:, i] for i in range(3, -1, -1)))
    rank = np.empty(len(mat), np.int64)
    rank[order] = np.arange(len(mat))
    pool = rng.permutation(len(mat))
    out = []
    for s in range(n_segments):
        m = n[s] if isinstance(n, (list, tuple)) else n
        ids = pool[s * m:(s + 1) * m] if unique else \
            rng.zipf(1.3, m) % len(mat)
        ids = ids[np.argsort(rank[ids], kind="stable")]
        klen = lens_v[ids]
        ko = np.zeros(m + 1, np.int64)
        np.cumsum(klen, out=ko[1:])
        vals = ((np.uint64(s) << np.uint64(32)) |
                np.arange(m, dtype=np.uint64)).astype(">u8").view(np.uint8)
        out.append(KVBatch(mat[ids][np.arange(16)[None, :] < klen[:, None]],
                           ko, vals, np.arange(m + 1, dtype=np.int64) * 8))
    return out


def _manager_run(batches, device, tmp_path, tag, budget, async_depth=2,
                 locals_=(), **kw):
    """Paced commits (the merger idle after each) into a manager on
    `device`, then the final merge: (merged arrays, counters, digests of
    the files left, manager)."""
    import hashlib
    from tez_tpu_torch.common.counters import TezCounters
    from tez_tpu_torch.library.merge_manager import ShuffleMergeManager
    from tez_tpu_torch.ops.runformat import PartitionedRunWriter
    spill = tmp_path / f"spill_{tag}"
    spill.mkdir()
    counters = TezCounters()
    mm = ShuffleMergeManager(counters, budget, str(spill),
                             async_depth=async_depth, device=device, **kw)
    for slot, b in enumerate(batches):
        if slot in locals_:
            path = str(tmp_path / f"producer_{tag}_{slot}.prun")
            w = PartitionedRunWriter(path, 2)
            w.append(b, 1)
            w.close()
            assert mm.commit_local_file(slot, path, 1, b.nbytes)
        else:
            assert mm.commit(slot, b)
        assert mm.quiesce(timeout=600)
    result = mm.finish()
    blocks = list(result.stream.iter_batches()) if result.is_streaming \
        else [result.batch]
    merged = KVBatch.concat(blocks)
    files = sorted(hashlib.sha256(open(os.path.join(spill, f), "rb").read())
                   .hexdigest() for f in os.listdir(spill))
    c = {g: {k: v for k, v in cs.items() if "MILLI" not in k}
         for g, cs in counters.to_dict().items()
         if not g.startswith("LatencyHistogram")}
    mm.cleanup()
    return (merged.key_bytes, merged.key_offsets, merged.val_bytes), c, \
        files, mm


def _same_arrays(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_merge_manager_matches_host(cuda, tmp_path):
    """ShuffleMergeManager on the card, mem->disk merges, a DISK
    admission, disk-direct sources and the streamed final merge, against
    the same paced commits on the host (the kernels' plain versions):
    merged bytes, counters and the files left equal."""
    batches = _word_segments(41, 24, 60_000)
    batches[7] = _word_segments(42, 1, 400_000)[0]        # over max_single
    budget = sum(b.nbytes for b in batches) // 4
    runs = {dev: _manager_run(batches, dev, tmp_path, dev, budget,
                              locals_=(20, 21)) for dev in ("cuda", "cpu")}
    _same_arrays(runs["cuda"][0], runs["cpu"][0])
    assert runs["cuda"][1:3] == runs["cpu"][1:3]
    c = runs["cuda"][1]["TaskCounter"]
    assert c["NUM_MEM_TO_DISK_MERGES"] >= 2 and c["SHUFFLE_BYTES_TO_DISK"] > 0
    assert not _failovers(runs["cuda"][3].counters)


def test_merge_manager_async_matches_sync_on_the_card(cuda, tmp_path):
    """The async merge lane (depth 2) and the synchronous merger (depth 0)
    merge the same bytes with the same counters, including disk cascades
    (merge factor 4)."""
    from tez_tpu_torch.ops import kernels
    batches = _word_segments(43, 40, 70_000)
    budget = sum(b.nbytes for b in batches) // 6
    kernels.reset_launches()
    runs = {d: _manager_run(batches, "cuda", tmp_path, f"d{d}", budget,
                            async_depth=d, merge_factor=4) for d in (2, 0)}
    _same_arrays(runs[2][0], runs[0][0])
    assert runs[2][1:3] == runs[0][1:3]
    assert runs[2][1]["TaskCounter"]["NUM_DISK_TO_DISK_MERGES"] >= 1
    assert kernels.launches["merge_path_pair"] > 0
    assert kernels.launches["merge_rank"] == 0


def test_merge_real_out_of_memory_takes_the_split(cuda, tmp_path):
    """A real torch.cuda.OutOfMemoryError in a merge on the async lane:
    one long batch and seven short ones, so the whole merge pads every run
    to the long run's bucket while each half, and the merge of the halves,
    needs about half of it.  With device memory capped between the two
    peaks (measured here), the merge runs out, the split ladder merges the
    halves on the card (no host failover), and the bytes equal the
    uncapped merge's."""
    from tez_tpu_torch.common.counters import TezCounters
    from tez_tpu_torch.library.merge_manager import ShuffleMergeManager
    from tez_tpu_torch.ops.async_stage import CircuitBreaker
    sizes = [(1 << 18) + 1] + [3000] * 7
    batches = _word_segments(44, 8, sizes)
    total = sum(b.nbytes for b in batches)
    items = [(s, s, b) for s, b in enumerate(batches)]
    probe = ShuffleMergeManager(TezCounters(), 0, str(tmp_path),
                                device="cuda", device_min_records=0)

    def peak(fn):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base, base

    want, whole, base = peak(lambda: probe._merge_mem_items(items))
    _h, half0, _b = peak(lambda: probe._merge_mem_items(items[:4]))
    _h, half1, _b = peak(lambda: probe._merge_mem_items(items[4:]))
    halves = [probe._merge_mem_items(items[:4]),
              probe._merge_mem_items(items[4:])]
    _h, joined, _b = peak(lambda: probe._merge_runs(halves, "device"))
    split = max(half0, half1, joined)
    print(f"merge peaks: whole {whole} B, halves {half0} / {half1} B, "
          f"their merge {joined} B")
    assert split < 0.8 * whole, (split, whole)
    frac = (split + whole) / 2
    counters = TezCounters()
    errors = []
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    torch.cuda.set_per_process_memory_fraction(
        (base + int(frac)) / torch.cuda.get_device_properties(0)
        .total_memory)
    try:
        mm = ShuffleMergeManager(
            counters, total, str(tmp_path), device="cuda",
            device_min_records=0, merge_threshold=1.0,
            max_single_fraction=1.0, async_depth=2,
            breaker=CircuitBreaker(failures=100))
        retry = mm._pipeline._oom_retry_fn

        def traced(ids, payloads):
            try:
                return retry(ids, payloads)
            except BaseException as e:
                errors.append(repr(e)[:300])
                raise
        mm._pipeline._oom_retry_fn = traced
        for s, b in enumerate(batches):
            assert mm.commit(s, b)
        assert mm.quiesce(timeout=600)
        result = mm.finish()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    got = KVBatch.concat(list(result.stream.iter_batches())) \
        if result.is_streaming else result.batch
    fo = _failovers(counters)
    assert fo.get("device.oom.split_attempts") == 1, (fo, errors)
    assert fo.get("device.oom.split_success") == 1, (fo, errors)
    assert "device.failover.spans" not in fo, fo
    _same_arrays((got.key_bytes, got.val_bytes),
                 (want.batch.key_bytes, want.batch.val_bytes))
    mm.cleanup()


def test_merge_manager_fetch_race_probe(cuda, tmp_path):
    """8 fetch threads commit while the async lane merges on its stream,
    5 times: the keys are unique, so every run must merge to the one
    sorted order whatever the arrival order; a missing stream wait or
    record_stream shows up as wrong bytes."""
    import queue
    import threading
    from tez_tpu_torch.common.counters import TezCounters
    from tez_tpu_torch.library.merge_manager import ShuffleMergeManager
    batches = _word_segments(45, 32, 50_000, vocab=3_000_000, unique=True)
    allk = KVBatch.concat(batches)
    klen = np.diff(allk.key_offsets)
    mat = np.zeros((allk.num_records, 16), np.uint8)
    mat[np.arange(16)[None, :] < klen[:, None]] = allk.key_bytes
    order = np.lexsort((klen,) + tuple(mat.view(">u4")[:, i]
                                       for i in range(3, -1, -1)))
    want = allk.take(order)
    budget = sum(b.nbytes for b in batches) // 5
    for rep in range(5):
        counters = TezCounters()
        spill = tmp_path / f"race{rep}"
        spill.mkdir()
        mm = ShuffleMergeManager(counters, budget, str(spill), device="cuda",
                                 async_depth=2)
        q = queue.Queue()
        for s in np.random.default_rng(rep).permutation(len(batches)):
            q.put(int(s))
        errors = []

        def fetch():
            try:
                while True:
                    try:
                        s = q.get_nowait()
                    except queue.Empty:
                        return
                    assert mm.commit(s, batches[s])
            except BaseException as e:
                errors.append(e)

        threads = [threading.Thread(target=fetch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        result = mm.finish()
        got = KVBatch.concat(list(result.stream.iter_batches())) \
            if result.is_streaming else result.batch
        np.testing.assert_array_equal(got.key_bytes, want.key_bytes)
        np.testing.assert_array_equal(got.val_bytes, want.val_bytes)
        assert not _failovers(counters)
        assert counters.to_dict()["TaskCounter"][
            "NUM_MEM_TO_DISK_MERGES"] >= 2
        mm.cleanup()
        torch.cuda.synchronize()


# -- tasks: the runtime and the ordered shuffle IO on the card ---------------
def _edge_batches(seed, maps, n, vocab=2000):
    """Each map's records: n Zipf words of 1-16 letters, each value 1, in
    batches of 50,000."""
    import chip_smoke
    rng = np.random.default_rng(seed)
    mat, lens = chip_smoke.bulk_word_vocab(rng, vocab)
    out = []
    for _m in range(maps):
        ids = rng.zipf(1.3, n) % vocab
        batches = []
        for s in range(0, n, 50_000):
            part = ids[s:s + 50_000]
            kb, ko = chip_smoke.ragged_keys(mat[part], lens[part])
            batches.append(KVBatch(kb, ko, np.tile(chip_smoke.ONE_LONG,
                                                   len(part)),
                                   np.arange(len(part) + 1,
                                             dtype=np.int64) * 8))
        out.append(batches)
    return out


def _untimed(counters):
    skip = ("MILLI", "_TIME", "MEMORY", "HEAP")
    return {g: {c: v for c, v in cs.items() if not any(s in c for s in skip)}
            for g, cs in counters.to_dict().items()
            if not g.startswith("LatencyHistogram")}


#: io.sort.mb 8: two spans a map and each reducer over its 7.2 MiB merge
#: budget, every span and merge on the device engine
_TASK_CONF = {"tez.runtime.io.sort.mb": 8,
              "tez.runtime.tpu.device.sort.min.records": 0}


def test_task_edge_matches_host(cuda, tmp_path, monkeypatch):
    """A 2 x 2 edge of TaskRunners on the card and on the host (the
    kernels' plain versions), one readback worker and paced commits: the
    events, every counter but the times, and the reducers' grouped
    streams are equal, and the card run launched the kernels."""
    import chip_smoke
    from tez_tpu_torch.library import merge_manager as mm
    from tez_tpu_torch.ops import async_stage
    real_init = async_stage.AsyncSpanPipeline.__init__
    monkeypatch.setattr(async_stage.AsyncSpanPipeline, "__init__",
                        lambda self, *a, **kw: real_init(
                            self, *a, **dict(kw, readback_workers=1)))
    real_commit = mm.ShuffleMergeManager.commit

    def paced(self, *a, **kw):
        out = real_commit(self, *a, **kw)
        assert self.quiesce(timeout=600)
        return out
    monkeypatch.setattr(mm.ShuffleMergeManager, "commit", paced)
    conf = dict(chip_smoke.TASK_CONF, **_TASK_CONF)
    runs = {}
    for dev in ("cuda", "cpu"):
        api = chip_smoke.task_api(device=dev)
        kernels.reset_launches()
        run = chip_smoke.run_edge(api, conf, _edge_batches(51, 2, 400_000),
                                  2, str(tmp_path / dev),
                                  reduce_payload={"mode": "blocks"},
                                  concurrent=False)
        assert set(run.umbilical.states.values()) == {"SUCCEEDED"}, \
            run.umbilical.diagnostics
        launches = dict(kernels.launches)
        runs[dev] = (
            [(s, v, e.user_payload) for s, v, e in run.umbilical.log],
            run.umbilical.vm_payloads,
            [_untimed(c) for c in run.counters("maps") +
             run.counters("reducers")],
            [[tuple(a.tobytes() for a in blk) for blk in res]
             for res in run.results()])
        if dev == "cuda":
            assert launches["fnv_hash_lanes"] > 0
            assert launches["merge_path_pair"] > 0
            assert launches["merge_rank"] == 0
    for a, b in zip(runs["cuda"], runs["cpu"]):
        assert a == b


def test_task_reducers_on_the_card_are_deterministic(cuda, tmp_path):
    """4 maps and 4 concurrent reducers on the card, five times, with the
    library's two readback workers and free-running commits: the
    reducers' outputs are the same bytes every time."""
    import chip_smoke
    api = chip_smoke.task_api(device="cuda")
    conf = dict(chip_smoke.TASK_CONF, **_TASK_CONF)
    data = _edge_batches(52, 4, 300_000)
    outs = []
    for rep in range(5):
        run = chip_smoke.run_edge(api, conf, data, 4,
                                  str(tmp_path / f"r{rep}"))
        assert set(run.umbilical.states.values()) == {"SUCCEEDED"}, \
            run.umbilical.diagnostics
        outs.append([tuple(a.tobytes() for a in res)
                     for res in run.results()])
    assert all(o == outs[0] for o in outs[1:])


def test_task_runner_defaults_to_the_card(cuda, tmp_path):
    """A TaskRunner built without a device runs its task on the card: the
    contexts, the output's sorter and the input's merge manager hold the
    CUDA device, and the kernels launched."""
    import chip_smoke
    api = chip_smoke.task_api()          # the runner's default device
    assert api.runner_kw == {}
    kernels.reset_launches()
    run = chip_smoke.run_edge(api, dict(chip_smoke.TASK_CONF, **_TASK_CONF),
                              _edge_batches(53, 1, 200_000), 1,
                              str(tmp_path))
    assert set(run.umbilical.states.values()) == {"SUCCEEDED"}
    (mrunner, _g, _s), = run.maps
    (rrunner, _g, _s), = run.reducers
    assert mrunner.device.type == rrunner.device.type == "cuda"
    assert mrunner.outputs["reduce"].sorter.device.type == "cuda"
    assert rrunner.inputs["map"].merge_manager.device.type == "cuda"
    assert kernels.launches["fnv_hash_lanes"] > 0


def _dag_corpus(tmp_path, seed):
    """An 8 MiB corpus in bench.py's layout over 20,000 words."""
    import chip_smoke
    rng = np.random.default_rng(seed)
    mat, lens = chip_smoke.bulk_word_vocab(rng, 20_000)
    path = str(tmp_path / "in.txt")
    chip_smoke.write_corpus(path, rng, mat, lens, 8 << 20,
                            words_per_line=512, chunk_lines=64)
    return path


def _wordcount(tmp_path, corpus, name, device, combine=True, conf=None):
    """Phase 11's DAG through the port's TezClient at io.sort.mb 4, every
    span and merge on the device engine (conf adds to that); the part
    files' bytes."""
    import chip_smoke
    out = str(tmp_path / name)
    desc = chip_smoke.wordcount_description(
        [corpus], out, combine=combine, **chip_smoke.DAG_SHAPE)
    conf = dict(chip_smoke.DAG_CONF, **chip_smoke.TINY_DAG["conf"],
                **{"tez.staging-dir": str(tmp_path / f"{name}_stg"),
                   "tez.runtime.tpu.device.sort.min.records": 0},
                **(conf or {}))
    run = chip_smoke.run_dag(chip_smoke.dag_api(device=device), desc, conf)
    assert run.state == "SUCCEEDED"
    assert os.path.exists(os.path.join(out, "_SUCCESS"))
    return chip_smoke.read_wordcount(out)[0]


@pytest.mark.parametrize("combine", [True, False])
def test_dag_wordcount_on_the_card_matches_host(cuda, tmp_path, combine):
    """OrderedWordCount through the port's own TezClient and AM on the
    card and on the host: the same part file, and the card run launched
    both kernels (and not the general merge rank)."""
    corpus = _dag_corpus(tmp_path, 61)
    kernels.reset_launches()
    card = _wordcount(tmp_path, corpus, "card", "cuda", combine)
    launches = dict(kernels.launches)
    host = _wordcount(tmp_path, corpus, "host", "cpu", combine)
    assert card == host and card
    assert launches["fnv_hash_lanes"] > 0
    assert launches["merge_path_pair"] > 0
    assert launches["merge_rank"] == 0


def test_dag_wordcount_on_the_card_is_deterministic(cuda, tmp_path):
    """Two runs on the card at the library's defaults (two readback
    workers, paced by nothing; a runner thread a core): one through the
    client on its default device, one through ordered_wordcount.run; the
    same bytes."""
    from tez_tpu_torch.examples import ordered_wordcount
    import chip_smoke
    corpus = _dag_corpus(tmp_path, 62)
    first = _wordcount(tmp_path, corpus, "first", None, combine=False)
    out = str(tmp_path / "second")
    state = ordered_wordcount.run(
        [corpus], out, conf=dict(
            chip_smoke.DAG_CONF, **chip_smoke.TINY_DAG["conf"],
            **{"tez.staging-dir": str(tmp_path / "second_stg")}),
        combine=False, **chip_smoke.DAG_SHAPE)
    assert state == "SUCCEEDED"
    assert chip_smoke.read_wordcount(out)[0] == first and first


@pytest.mark.parametrize("server", ["python", "native"])
def test_dag_wordcount_in_runner_processes_matches_threads(cuda, tmp_path,
                                                           server):
    """OrderedWordCount with tez.runner.mode=subprocess on the card: 4
    runner processes, each on the card (--device cuda), serving through
    the Python or the native server; the part file equals the thread run's,
    fetches crossed processes, and the runners launched both kernels."""
    import json
    corpus = _dag_corpus(tmp_path, 63)
    threads = _wordcount(tmp_path, corpus, "threads", "cuda", combine=False)
    stats = tmp_path / "stats"
    stats.mkdir()
    env = {"TEZ_TPU_RUNNER_STATS_DIR": str(stats)}
    if server == "native":
        env["TEZ_TPU_NATIVE_SHUFFLE_DIR"] = str(tmp_path / "native")
    procs = _wordcount(tmp_path, corpus, "procs", "cuda", combine=False,
                       conf={"tez.runner.mode": "subprocess",
                             "tez.am.local.num-containers": 4,
                             "tez.am.container.idle.release-timeout-min"
                             ".millis": 600_000,
                             "tez.am.runner.env": env})
    assert procs == threads and procs
    reports = [json.loads((stats / f).read_text())
               for f in os.listdir(stats)]
    assert reports
    assert {r["device"] for r in reports} == {"cuda"}
    assert {r["device_name"] for r in reports} == \
        {torch.cuda.get_device_name(0)}
    assert {r["server"] for r in reports} == \
        {"NativeShuffleServer" if server == "native" else "ShuffleServer"}
    assert sum(r["bytes_served"] for r in reports) > 0
    assert sum(r["launches"]["fnv_hash_lanes"] for r in reports) > 0
    assert sum(r["launches"]["merge_path_pair"] for r in reports) > 0
    assert sum(r["launches"]["merge_rank"] for r in reports) == 0


@pytest.mark.parametrize("mode", ["store", "push", "push_processes"])
def test_dag_wordcount_with_the_store_on_the_card_matches_host(
        cuda, tmp_path, mode):
    """OrderedWordCount with the buffer store (twice in one process, the
    second served from sealed lineage) or with push into it, on the card:
    the part files equal the host run's, and the card runs launched both
    kernels.  The store is the process's: reset between runs."""
    from tez_tpu_torch.store import local_buffer_store, reset_store
    corpus = _dag_corpus(tmp_path, 64)
    conf = {"tez.runtime.store.enabled": True}
    if mode != "store":
        conf["tez.runtime.shuffle.push.enabled"] = True
    if mode == "push_processes":
        conf.update({"tez.runner.mode": "subprocess",
                     "tez.am.local.num-containers": 4,
                     "tez.am.container.idle.release-timeout-min.millis":
                         600_000})
    try:
        reset_store()
        host = _wordcount(tmp_path, corpus, "host", "cpu", combine=False)
        reset_store()
        kernels.reset_launches()
        card = _wordcount(tmp_path, corpus, "card", "cuda", combine=False,
                          conf=conf)
        if mode == "store":
            again = _wordcount(tmp_path, corpus, "again", "cuda",
                               combine=False, conf=conf)
            assert again == card
            counters = local_buffer_store().stats()["counters"]
            assert counters["store.lineage.hits"] >= 8
        assert card == host and card
        if mode != "push_processes":
            assert kernels.launches["fnv_hash_lanes"] > 0
            assert kernels.launches["merge_path_pair"] > 0
        assert kernels.launches["merge_rank"] == 0
    finally:
        reset_store()


def test_store_relief_frees_card_memory(cuda):
    """The store's device relief, through the out-of-memory ladder's hook:
    the lanes of an idle DEVICE-tier run on the card leave
    torch.cuda.memory_allocated before the hook returns."""
    from tez_tpu_torch.ops import async_stage
    from tez_tpu_torch.ops.runformat import KVBatch, Run
    from tez_tpu_torch.store import ensure_store, reset_store
    reset_store()
    try:
        store = ensure_store({"tez.runtime.store.enabled": True})
        n = 1 << 20
        batch = KVBatch(np.zeros(n, np.uint8),
                        np.arange(n + 1, dtype=np.int64),
                        np.zeros(0, np.uint8), np.zeros(n + 1, np.int64))
        batch.dev_keys = (torch.zeros((n, 4), dtype=torch.int32,
                                      device="cuda"),
                          torch.zeros(n, dtype=torch.int32, device="cuda"),
                          0, n)
        store.publish("dagC/a0/c", -1, Run(batch, np.array([0, n])))
        del batch
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        assert async_stage.relieve_pressure(1) == 20 * n
        assert before - torch.cuda.memory_allocated() >= 20 * n
    finally:
        reset_store()


def test_native_server_serves_a_card_sorters_run(cuda, tmp_path):
    """A run sorted on the card, written through the file store and
    fetched from the native server, partition by partition and as a
    range: batch for batch the run's partitions."""
    from tez_tpu_torch.common.security import JobTokenSecretManager
    from tez_tpu_torch.ops.sorter import DeviceSorter
    from tez_tpu_torch.shuffle.native_server import (FileShuffleStore,
                                                     NativeShuffleServer)
    from tez_tpu_torch.shuffle.server import FetchSession
    rng = np.random.default_rng(64)
    sorter = DeviceSorter(num_partitions=4, key_width=12, device="cuda",
                          device_min_records=0)
    n = 200_000
    words = rng.integers(97, 123, (n, 8)).astype(np.uint8)
    kernels.reset_launches()
    sorter.write_batch(KVBatch(words.reshape(-1),
                               np.arange(n + 1, dtype=np.int64) * 8,
                               np.ones(n, np.uint8),
                               np.arange(n + 1, dtype=np.int64)))
    run = sorter.flush()
    assert kernels.launches["fnv_hash_bytes"] + \
        kernels.launches["fnv_hash_lanes"] > 0
    secrets = JobTokenSecretManager()
    store = FileShuffleStore(str(tmp_path / "store"))
    store.register("dag_1/attempt_1/out", -1, run)
    server = NativeShuffleServer(secrets, str(tmp_path / "store"))
    try:
        session = FetchSession(secrets, "127.0.0.1", server.port)
        try:
            ranged = session.fetch_range("dag_1/attempt_1/out", -1, 0, 4)
            for p in range(4):
                got = session.fetch("dag_1/attempt_1/out", -1, p)
                want = run.partition(p)
                for a, b in ((got, want), (ranged[p], want)):
                    np.testing.assert_array_equal(a.key_bytes, b.key_bytes)
                    np.testing.assert_array_equal(a.key_offsets,
                                                  b.key_offsets)
                    np.testing.assert_array_equal(a.val_bytes, b.val_bytes)
        finally:
            session.close()
        assert server.bytes_served > 0
    finally:
        server.stop()


# -- slice 11: the unordered writer's hash and the mesh exchange ------------
@pytest.mark.parametrize("partitions,budget", [(2, 1 << 20), (7, 1 << 16)])
def test_unordered_writer_on_the_card(cuda, partitions, budget):
    """The unordered writer's spans hash-partitioned on the card: the runs
    equal device="cpu"'s byte for byte, one fnv_hash_bytes launch a span."""
    from tez_tpu_torch.common.counters import TezCounters
    from tez_tpu_torch.library.unordered import UnorderedPartitionedWriter
    rng = np.random.default_rng(partitions)
    pairs = [(rng.bytes(int(rng.integers(1, 40))), rng.bytes(8))
             for _ in range(40_000)]
    runs = {}
    for dev in ("cuda", "cpu"):
        w = UnorderedPartitionedWriter(partitions, budget, TezCounters(),
                                       device=dev)
        kernels.reset_launches()
        for k, v in pairs:
            w.write(k, v)
        run = w.flush()
        runs[dev] = (run.row_index.tolist(), run.batch.key_bytes.tobytes(),
                     run.batch.val_bytes.tobytes())
        if dev == "cuda":
            assert kernels.launches["fnv_hash_bytes"] == w.num_spills > 0
    assert runs["cuda"] == runs["cpu"]


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("explicit", [False, True])
def test_exchange_on_the_card(cuda, ragged, explicit):
    """The exchange step on the card's own mesh against the same step on
    CPU workers, bit for bit; the hashed route launches fnv_hash_lanes."""
    from tez_tpu_torch.parallel import exchange, mesh
    card = mesh.make_mesh()
    w = len(card)
    rng = np.random.default_rng(int(ragged) * 2 + int(explicit))
    n = 3001 * w
    lengths = rng.integers(1, 13, n).astype(np.uint32)
    mat = rng.integers(0, 256, (n, 12), dtype=np.uint8)
    mat[np.arange(12)[None, :] >= lengths[:, None]] = 0
    lanes = np.ascontiguousarray(mat).view(">u4").astype(np.uint32)
    values = rng.integers(0, 1 << 30, (n, 2)).astype(np.uint32)
    valid = rng.random(n) < 0.9
    args = [lanes, lengths, values, valid]
    if explicit:
        args.append((rng.integers(0, w, n)).astype(np.uint32))
    kw = dict(value_words=2, ragged=ragged, explicit_dests=explicit)
    kernels.reset_launches()
    got = [o.host() for o in exchange.build_distributed_shuffle(
        card, 3, n // w, n // w, **kw)(*args)]
    assert (kernels.launches["fnv_hash_lanes"] > 0) == (not explicit)
    want = [o.host() for o in exchange.build_distributed_shuffle(
        mesh.make_mesh(devices=["cpu"] * w), 3, n // w, n // w, **kw)(*args)]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert int(got[4].sum()) == 0


def test_mesh_wordcount_on_the_card(cuda, tmp_path):
    """OrderedWordCount with exchange="mesh" on the card: part file
    byte-identical to the host exchange's."""
    from tez_tpu_torch.examples import ordered_wordcount
    from tez_tpu_torch.parallel import coordinator
    rng = np.random.default_rng(0)
    words = [f"w{int(i)}" for i in rng.zipf(1.3, 60_000) % 3000]
    corpus = tmp_path / "in.txt"
    corpus.write_text(" ".join(words))
    coordinator.reset_coordinator()
    parts = {}
    for exchange in ("host", "mesh"):
        out = tmp_path / f"out_{exchange}"
        assert ordered_wordcount.run(
            [str(corpus)], str(out),
            conf={"tez.staging-dir": str(tmp_path / f"stg_{exchange}")},
            tokenizer_parallelism=2, summation_parallelism=2,
            exchange=exchange) == "SUCCEEDED"
        parts[exchange] = (out / "part-00000").read_bytes()
    assert parts["host"] == parts["mesh"]
    assert coordinator.mesh_coordinator().exchanges_run == 1


def test_recovered_am_on_the_card(cuda, tmp_path):
    """chip_smoke's phase 17 leg B at 16 MiB on the card: the AM crashes
    once the tokenizers succeeded, attempt 2 restores them from the
    journal, launches only the summation and sorter tasks (merge_path_pair
    among its kernels) and writes the uncrashed run's part file."""
    import types
    import chip_smoke
    from tez_tpu_torch.examples import ordered_wordcount
    args = types.SimpleNamespace(seed=0)
    corpus = chip_smoke.DagCorpus(str(tmp_path), args, marks_mb=(16,),
                                  corpus_mb=16, vocab_size=20_000)
    path, nbytes, golden = corpus.slice_file("in16.txt", 0, 16)
    sz = dict(chip_smoke.STANDALONE_SIZES, sa_mb=16,
              conf={"tez.runtime.io.sort.mb": 16,
                    "tez.runtime.tpu.device.sort.min.records": 0},
              hold_ms=300_000)
    out = str(tmp_path / "uncrashed")
    dag = ordered_wordcount.build_dag([path], out, **chip_smoke.DAG_SHAPE)
    status, _wall = chip_smoke.submit_dag(dag, dict(
        chip_smoke.DAG_CONF, **sz["conf"],
        **{"tez.staging-dir": str(tmp_path / "stg")}), "cuda")
    assert status.state.name == "SUCCEEDED"
    host_part = chip_smoke.check_wordcount("uncrashed", out, corpus.mat,
                                           corpus.lens, golden)
    launches = chip_smoke.recovery_leg(args, corpus, host_part, "cuda", sz,
                                       path, nbytes, golden)
    assert launches["merge_path_pair"] > 0 and launches["merge_rank"] == 0


def test_joins_and_supply_chain_on_the_card_match_host(cuda, tmp_path):
    """SortMergeJoinExample over two Zipf word files of 500,000 words and
    the corpus's supply_chain query at scale 60 through QuerySession, each
    on the card and on the host: the same part files byte for byte, and
    the card runs launched both kernels (and not the general merge rank).
    A span takes the card from 65,536 records and 1 MiB of keys: a side
    task's 250,000 six-byte words, a lineitem scan task's 180,000 eight-byte
    order keys."""
    from tez_tpu_torch.examples import sort_merge_join
    from tez_tpu_torch.ops.async_stage import reset_process_breaker
    from tez_tpu_torch.query import QuerySession
    from tez_tpu_torch.tools import query_corpus
    reset_process_breaker()
    rng = np.random.default_rng(14)
    sides = []
    for name in ("left", "right"):
        ids = rng.zipf(1.3, 500_000) % 50_000
        path = tmp_path / f"{name}.txt"
        path.write_text("\n".join(" ".join(f"w{i:05d}" for i in ids[j::40])
                                  for j in range(40)) + "\n")
        sides.append([str(path)])
    corpus = query_corpus.generate(str(tmp_path / "corpus"), scale=60,
                                   seed=3)
    q = next(q for q in query_corpus.CORPUS_QUERIES
             if q.name == "supply_chain")

    def parts(out):
        return {f: open(os.path.join(out, f), "rb").read()
                for f in sorted(os.listdir(out)) if f.startswith("part-")}

    got = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launches()
        conf = {"tez.staging-dir": str(tmp_path / dev / "smj")}
        out = str(tmp_path / dev / "smj_out")
        assert sort_merge_join.run(*sides, out, conf=conf,
                                   device=dev) == "SUCCEEDED"
        smj = parts(out)
        with QuerySession("q", {"tez.staging-dir": str(tmp_path / dev / "q"),
                                "tez.am.local.num-containers": 4},
                          device=dev) as s:
            r = s.run(q.build(corpus), str(tmp_path / dev / "q_out"),
                      query_name=q.name, sink=q.sink)
        assert r.state == "SUCCEEDED" and r.read_output() == q.oracle(corpus)
        got[dev] = (smj, parts(r.output_path), dict(kernels.launches))
    assert got["cuda"][:2] == got["cpu"][:2] and got["cuda"][0]
    launches = got["cuda"][2]
    assert launches["fnv_hash_lanes"] > 0
    assert launches["merge_path_pair"] > 0
    assert launches["merge_rank"] == 0


def test_floor_queries_on_the_card_match_host(cuda, tmp_path):
    """Phase 18's aggregate, repartition join and window
    (chip_smoke.FLOOR_QUERIES) at scale 10 through QuerySession with the
    sorter's device floor at one record (chip_smoke.FLOOR_CONF), on the
    card and on the host: the same part files byte for byte, each the
    oracle's records, and each card run launched both kernels (and not
    the general merge rank)."""
    import chip_smoke
    from tez_tpu_torch.ops.async_stage import reset_process_breaker
    from tez_tpu_torch.query import QuerySession
    from tez_tpu_torch.tools import query_corpus
    reset_process_breaker()
    corpus = query_corpus.generate(str(tmp_path / "corpus"), scale=10,
                                   seed=3)
    queries = {q.name: q for q in query_corpus.CORPUS_QUERIES}
    got = {}
    for dev in ("cuda", "cpu"):
        conf = {"tez.staging-dir": str(tmp_path / dev / "q"),
                **chip_smoke.FLOOR_CONF}
        with QuerySession("q", conf, device=dev) as s:
            for name in chip_smoke.FLOOR_QUERIES:
                q = queries[name]
                kernels.reset_launches()
                r = s.run(q.build(corpus), str(tmp_path / dev / name),
                          query_name=name, sink=q.sink)
                assert r.state == "SUCCEEDED"
                assert r.read_output() == q.oracle(corpus)
                got[dev, name] = (
                    {f: open(os.path.join(r.output_path, f), "rb").read()
                     for f in sorted(os.listdir(r.output_path))
                     if f.startswith("part-")}, dict(kernels.launches))
    for name in chip_smoke.FLOOR_QUERIES:
        assert got["cuda", name][0] == got["cpu", name][0], name
        launches = got["cuda", name][1]
        assert launches["fnv_hash_lanes"] > 0, name
        assert launches["merge_path_pair"] > 0, name
        assert launches["merge_rank"] == 0, name


def test_stream_windows_on_the_card_match_host(cuda, tmp_path):
    """Phase 19 A's stream at a small size with the sorter's device floor
    at one record (chip_smoke.FLOOR_CONF): each window DAG on the card
    writes the host run's part file byte for byte and launches
    fnv_hash_lanes and merge_path_pair (and not the general merge
    rank)."""
    import chip_smoke
    from tez_tpu_torch.ops.async_stage import reset_process_breaker
    reset_process_breaker()
    rng = np.random.default_rng(19)
    words = [f"w{i}" for i in rng.zipf(1.3, 3 * 4096) % 5000]
    records = [{"k": w, "v": 1} for w in words]
    got = {}
    for dev in ("cuda", "cpu"):
        am = chip_smoke.stream_am(
            "tez_tpu_torch", f"app_1_cs_{dev}", str(tmp_path / dev / "st"),
            dev, **chip_smoke.FLOOR_CONF)
        launches = []
        try:
            driver = am.open_stream(chip_smoke.stream_spec(
                "tez_tpu_torch", "s", str(tmp_path / dev / "out"), **{
                    "tez.runtime.stream.window.count": 4096}))
            for w in range(3):
                kernels.reset_launches()
                driver.ingest(records[w * 4096:(w + 1) * 4096])
                chip_smoke.wait_for(
                    lambda: chip_smoke.finished_windows(am) > w,
                    f"window {w + 1}", timeout=300)
                launches.append(dict(kernels.launches))
            final = driver.drain(timeout=300)
        finally:
            am.stop()
        assert final["committed"] == [1, 2, 3]
        got[dev] = (chip_smoke.stream_parts(str(tmp_path / dev / "out" /
                                                "s")), launches)
    assert got["cuda"][0] == got["cpu"][0] == {
        f"w{i:06d}.part0": g for i, g in
        enumerate(chip_smoke.window_parts(records, 4096), 1)}
    for launches in got["cuda"][1]:
        assert launches["fnv_hash_lanes"] > 0
        assert launches["merge_path_pair"] > 0
        assert launches["merge_rank"] == 0


def test_speculative_dag_on_the_card(cuda, tmp_path):
    """Phase 19 C at a small size on the card with the sorter's device
    floor at one record: the sibling of a tokenizer attempt held after
    its sorter dispatched a span on the card wins, the DAG's counts are
    the golden's, both kernels launch, the witness finds no inversion,
    and the loser, killed with its span plane open, holds no stream pair
    more than before the DAG and registers nothing; then the abort with
    a span in flight (every check of chip_smoke.speculation_leg and
    abort_leg)."""
    import collections
    import types
    import chip_smoke
    # built before the DAG, as the script builds them: a build inside
    # the tokenizers would set the speculator's runtime estimates
    kernels.load()
    args = types.SimpleNamespace(seed=0)
    corpus = chip_smoke.DagCorpus(str(tmp_path), args, corpus_mb=2,
                                  vocab_size=20_000, marks_mb=(2,))
    sz = dict(chip_smoke.TINY_STREAM, spec_mb=2, conf=chip_smoke.FLOOR_CONF)
    totals = collections.Counter()
    chip_smoke.speculation_leg(corpus, str(tmp_path), "cuda", sz, totals)
    assert totals["fnv_hash_lanes"] > 0 and totals["merge_path_pair"] > 0
    held = chip_smoke.HELD_ATTEMPTS
    assert len(held) == 1 and held[0]["dispatched"] >= 1


def test_sorter_abort_with_a_span_in_flight_on_the_card(cuda):
    """chip_smoke.abort_leg on the card: an async sorter's span 1 is held
    in its completion while the sorter aborts; abort() waits for it,
    nothing ships after it began, the stream pair goes back, no run is
    left, and the three spans launched fnv_hash_lanes."""
    import collections
    import chip_smoke
    totals = collections.Counter()
    chip_smoke.abort_leg("cuda", chip_smoke.TINY_STREAM, totals)
    assert totals["fnv_hash_lanes"] >= 3


@pytest.mark.parametrize("width", [4, 16, 31])
def test_encode_keys_device_on_the_card(cuda, width):
    """keycodec.encode_keys_device on the card: the lanes bit for bit the
    host encode's, the lengths the raw lengths, both on the card."""
    from tez_tpu_torch.ops.keycodec import encode_keys, encode_keys_device
    rng = np.random.default_rng(width)
    lens = rng.integers(0, 41, 20_000)
    ko = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=ko[1:])
    kb = rng.integers(0, 256, int(ko[-1]), dtype=np.int64).astype(np.uint8)
    lanes, got_lens = encode_keys_device(kb, ko, width, device=cuda)
    assert lanes.device.type == "cuda" and got_lens.device.type == "cuda"
    want, want_lens = encode_keys(kb, ko, width)
    np.testing.assert_array_equal(lanes.cpu().numpy().view(np.uint32), want)
    np.testing.assert_array_equal(got_lens.cpu().numpy(), want_lens)


def test_profile_kernels_on_the_card(cuda):
    """tools/profile_kernels: the kernel leg is there, launched through
    hash_partition, and both pairs agreed before their times."""
    from tez_tpu_torch.tools import profile_kernels
    kernels.reset_launches()
    rec = profile_kernels.profile(1 << 16, device=cuda, reps=2)
    assert rec["device"] == torch.cuda.get_device_name(0)
    for key in ("hash_plain_s", "hash_kernel_s", "encode_host_s",
                "encode_device_s"):
        assert rec[key] > 0
    assert kernels.launches["fnv_hash_bytes"] > 0


def test_span_scheduler_gives_its_stream_pair_back_on_the_card(cuda):
    """DeviceSpanScheduler takes a SpanStreams pair; results() gives it
    back, so held_stream_pairs() returns to its value before."""
    from tez_tpu_torch.ops.device_pipeline import DeviceSpanScheduler
    held0 = device.held_stream_pairs()
    batches = _bench_batches(7, 2, 100_000)
    sched = DeviceSpanScheduler(4, key_width=12, device=cuda)
    assert device.held_stream_pairs() == held0 + 1
    for sid, b in enumerate(batches):
        sched.submit_ragged(sid, b.key_bytes, b.key_offsets, b.val_bytes, 8)
    assert len(sched.results()) == 2
    assert device.held_stream_pairs() == held0


def test_sorter_whose_drain_raises_gives_its_pair_back_on_the_card(
        cuda, tmp_path):
    """An async DeviceSorter whose first span's completion fails under a
    spill.write fault rule (the sorter fails a readback over to the host,
    a spill it cannot): the drain raises with later spans still on the
    streams, the flush fails and the pair goes back.  Span 0's dispatch
    is held until every span was submitted, so no write meets the failed
    pipeline."""
    from tez_tpu_torch.common import faults
    from tez_tpu_torch.common.faults import parse_spec
    held0 = device.held_stream_pairs()
    kernels.reset_launches()
    s = DeviceSorter(num_partitions=4, key_width=12, engine="device",
                     span_budget_bytes=2 << 20, pipeline_depth=2,
                     spill_dir=str(tmp_path), mem_budget_bytes=1,
                     device=cuda)
    faults.install("t", parse_spec(
        "device.dispatch.hang:delay:ms=1000,match=span=0;"
        "spill.write:fail:n=1,exc=io"))
    try:
        for b in _bench_batches(9, 4, 150_000):
            s.write_batch(b)
        assert device.held_stream_pairs() == held0 + 1
        with pytest.raises(OSError, match="injected fault at spill.write"):
            s.flush()
    finally:
        faults.clear_all()
    assert kernels.launches["merge_path_pair"] + \
        kernels.launches["fnv_hash_lanes"] > 0
    assert device.held_stream_pairs() == held0
