"""tez_tpu_torch on the card: each CUDA kernel against its plain PyTorch
version at every load flavour and lane width the kernels compile, and the
slice's entry points on device="cuda" against the same calls on
device="cpu", bit for bit.  Every test needs a card and skips without one.

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
