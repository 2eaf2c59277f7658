"""Port parity of tez_tpu_torch/ops/device.py and device_pipeline.py
against tez_tpu's: the same seeded numpy inputs through both, integer
outputs bit-exact.  The port runs with device="cpu" (the kernels' plain
versions); tez_tpu runs on JAX's CPU backend, whose span sort is one
unstable variadic sort -- the port's chained stable passes must give the
same order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tez_tpu.ops import device as jdevice
from tez_tpu.ops import device_pipeline as jpipe
from tez_tpu.ops.keycodec import matrix_to_lanes, pad_to_matrix
from tez_tpu_torch.ops import device as tdevice
from tez_tpu_torch.ops import device_pipeline as tpipe


def _keys(rng, n, max_len, alphabet=4, width=None):
    """Ragged seeded keys (small alphabet: many ties) -> (bytes, offsets)."""
    lens = rng.integers(1, max_len + 1, n)
    data = rng.integers(0, alphabet, int(lens.sum())).astype(np.uint8)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    return data, offs


def _lanes(rng, n, max_len, all_ff_rows=0):
    data, offs = _keys(rng, n, max_len)
    width = ((max_len + 3) // 4) * 4
    mat, lengths = pad_to_matrix(data, offs, width)
    mat[:all_ff_rows] = 0xFF
    lengths[:all_ff_rows] = width
    return matrix_to_lanes(mat), lengths


def test_helpers_match():
    for lens in (np.array([], np.int32), np.array([3, 3, 9]),
                 np.array([5, 5])):
        assert tdevice.uniform_clamped_lengths(lens, 8) == \
            jdevice.uniform_clamped_lengths(lens, 8)
    for n in (0, 1, 256, 257, 5000):
        assert tdevice._bucket(n) == jdevice._bucket(n)
    for exc in (MemoryError(), RuntimeError("RESOURCE_EXHAUSTED: hbm"),
                RuntimeError("device.dispatch.oom"), ValueError("x")):
        assert tdevice.is_resource_exhausted(exc) == \
            jdevice.is_resource_exhausted(exc)
    assert tdevice.is_resource_exhausted(torch.cuda.OutOfMemoryError("x"))
    perm = np.array([3, 0, 256, 9, 257, 1])
    np.testing.assert_array_equal(
        tdevice._map_bucketed_perm(perm, [4, 2], 256),
        jdevice._map_bucketed_perm(perm, [4, 2], 256))


@pytest.mark.parametrize("skip", [False, True])
def test_lsd_passes_match_variadic_sort(skip):
    """Chained stable passes == tez_tpu's CPU variadic sort with perm as the
    final key, including pad rows (partition INT32_MAX, sentinel length)."""
    rng = np.random.default_rng(5)
    n = 1024
    parts = rng.integers(0, 3, n).astype(np.int32)
    parts[-100:] = np.iinfo(np.int32).max
    lanes = rng.integers(0, 3, (n, 3)).astype(np.uint32)
    lanes[::7] = 0xFFFFFFFF
    lens = rng.integers(0, 13, n).astype(np.uint32)
    lens[-100:] = 0xFFFFFFFF
    jsp, jperm = jdevice._lsd_passes(jnp.asarray(parts), jnp.asarray(lanes),
                                     jnp.asarray(lens), skip)
    tsp, tperm = tdevice._lsd_passes(
        torch.from_numpy(parts), torch.from_numpy(lanes.view(np.int32)),
        torch.from_numpy(lens.view(np.int32)), skip)
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(jsp))
    np.testing.assert_array_equal(tperm.numpy(), np.asarray(jperm))


@pytest.mark.parametrize("n,max_len,parts", [(0, 4, 3), (1, 8, 3),
                                             (700, 12, 4), (256, 5, 1),
                                             (1500, 16, 7)])
def test_hash_sort_span_resident(n, max_len, parts):
    rng = np.random.default_rng(n + parts)
    lanes, lengths = _lanes(rng, n, max_len, all_ff_rows=min(n, 9))
    jsp, jperm, jdev = jdevice.hash_sort_span_resident(lanes, lengths, parts)
    tsp, tperm, tdev = tdevice.hash_sort_span_resident(lanes, lengths, parts,
                                                       device="cpu")
    np.testing.assert_array_equal(tsp, jsp)
    np.testing.assert_array_equal(tperm, jperm)
    if n == 0:
        assert jdev is None and tdev is None
        return
    # resident views: the whole bucket, tail sentinels included
    assert tdev[2:] == jdev[2:] == (0, n)
    np.testing.assert_array_equal(tdev[0].numpy().view(np.uint32),
                                  np.asarray(jdev[0]))
    np.testing.assert_array_equal(tdev[1].numpy(), np.asarray(jdev[1]))


@pytest.mark.parametrize("n,max_len,width", [(900, 24, 8), (300, 6, 4),
                                             (1, 3, 4)])
def test_hash_sort_span_and_sort_run(n, max_len, width):
    """Keys wider than the lanes: byte-matrix hash + sort; and the sort of a
    span whose partitions are given."""
    rng = np.random.default_rng(n)
    data, offs = _keys(rng, n, max_len)
    mat, lengths = pad_to_matrix(data, offs, width)
    lanes = matrix_to_lanes(mat)
    hash_w = 1 << max(2, (max_len - 1).bit_length())
    hmat, hlens = pad_to_matrix(data, offs, hash_w)
    for p in (1, 5):
        j = jdevice.hash_sort_span(hmat, hlens, lanes, lengths, p)
        t = tdevice.hash_sort_span(hmat, hlens, lanes, lengths, p,
                                   device="cpu")
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    custom = rng.integers(0, 3, n).astype(np.int32)
    j = jdevice.sort_run(custom, lanes, lengths)
    t = tdevice.sort_run(custom, lanes, lengths, device="cpu")
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_merge_runs_and_partition_counts():
    rng = np.random.default_rng(9)
    runs = []
    for n in (40, 0, 300):
        lanes, lengths = _lanes(rng, n, 8)
        order = np.lexsort((lengths, lanes[:, 1], lanes[:, 0]))
        runs.append((lanes[order], lengths[order]))
    np.testing.assert_array_equal(
        tdevice.merge_runs([r[0] for r in runs], [r[1] for r in runs],
                           device="cpu"),
        jdevice.merge_runs([r[0] for r in runs], [r[1] for r in runs]))
    parts = rng.integers(-1, 6, 777).astype(np.int32)
    np.testing.assert_array_equal(
        tdevice.partition_counts(parts, 5, device="cpu"),
        jdevice.partition_counts(parts, 5))
    np.testing.assert_array_equal(
        tdevice.partition_counts(parts[:0], 5, device="cpu"),
        jdevice.partition_counts(parts[:0], 5))


def _resident_views(rng, sizes, max_len):
    """Sorted single-partition runs as bucketed, sentinel-tailed device
    views, for both packages (same bits)."""
    jviews, tviews = [], []
    for n in sizes:
        lanes, lengths = _lanes(rng, n, max_len, all_ff_rows=min(n, 2))
        order = np.lexsort((lengths,) + tuple(
            lanes[:, i] for i in range(lanes.shape[1] - 1, -1, -1)))
        lanes, lengths = lanes[order], lengths[order].astype(np.int32)
        nb = jdevice._bucket(n)
        lanes = np.pad(lanes, ((0, nb - n), (0, 0)),
                       constant_values=np.uint32(0xFFFFFFFF))
        lengths = np.pad(lengths, (0, nb - n), constant_values=-1)
        lo = int(rng.integers(0, max(1, n // 3)))
        jviews.append((jnp.asarray(lanes), jnp.asarray(lengths), lo, n))
        tviews.append((torch.from_numpy(lanes.view(np.int32)),
                       torch.from_numpy(lengths), lo, n))
    return jviews, tviews


@pytest.mark.parametrize("kernel", ["merge_path", "sort"])
@pytest.mark.parametrize("seed", range(3))
def test_merge_resident_slices(kernel, seed):
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(1, 400)) for _ in range(int(rng.integers(2, 6)))]
    jviews, tviews = _resident_views(rng, sizes, 4 * int(rng.integers(1, 4)))
    np.testing.assert_array_equal(
        tdevice.merge_resident_slices(tviews, kernel=kernel),
        jdevice.merge_resident_slices(jviews, kernel=kernel))


def test_merge_resident_slices_mixed_widths():
    rng = np.random.default_rng(4)
    j1, t1 = _resident_views(rng, [50], 4)
    j2, t2 = _resident_views(rng, [70], 12)
    np.testing.assert_array_equal(
        tdevice.merge_resident_slices(t1 + t2),
        jdevice.merge_resident_slices(j1 + j2))


@pytest.mark.parametrize("sizes", [[300, 0, 41, 0, 7], [0, 0], [5],
                                   [256, 256, 1]])
def test_merge_path_runs(sizes):
    """Empty runs in the middle, wide and all-0xFF keys, mixed lane widths:
    each run is sorted by (partition, lanes, clamped length)."""
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    parts_l, lanes_l, lens_l = [], [], []
    for i, n in enumerate(sizes):
        lanes, lengths = _lanes(rng, n, 8 if i % 2 else 12,
                                all_ff_rows=min(n, 3))
        parts = rng.integers(0, 3, n).astype(np.int32)
        cap = lanes.shape[1] * 4 + 1
        order = np.lexsort((np.minimum(lengths, cap),) + tuple(
            lanes[:, k] for k in range(lanes.shape[1] - 1, -1, -1)) +
            (parts,))
        parts_l.append(parts[order])
        lanes_l.append(lanes[order])
        lens_l.append(lengths[order])
    np.testing.assert_array_equal(
        tdevice.merge_path_runs(parts_l, lanes_l, lens_l, device="cpu"),
        jdevice.merge_path_runs(parts_l, lanes_l, lens_l))


@pytest.mark.parametrize("n", [1000, 256])
def test_device_shuffle_sort(n):
    rng = np.random.default_rng(n)
    data, offs = _keys(rng, n, 12, alphabet=5)
    mat, lengths = pad_to_matrix(data, offs, 12)
    lanes = matrix_to_lanes(mat)
    hmat, hlens = pad_to_matrix(data, offs, 16)
    vals = rng.integers(0, 2 ** 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    want = jpipe.device_shuffle_sort(lanes, lengths.astype(np.int64), vals,
                                     hmat, hlens, 5)
    got = tpipe.device_shuffle_sort(lanes, lengths.astype(np.int64), vals,
                                    hmat, hlens, 5, device="cpu")
    for g, w in zip(got, want):
        g = g.numpy()
        w = np.asarray(w)
        np.testing.assert_array_equal(g.view(w.dtype) if g.dtype.itemsize ==
                                      w.dtype.itemsize else g, w)


def test_entry_points_default_to_the_card():
    """Without device="cpu" nothing runs on the host: on a machine without a
    card the entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    lanes = np.zeros((4, 1), np.uint32)
    lengths = np.ones(4, np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.hash_sort_span_resident(lanes, lengths, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.hash_partition(np.zeros((4, 4), np.uint8), lengths, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.merge_path_runs([np.zeros(4, np.int32)], [lanes], [lengths])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.device_shuffle_sort(lanes, lengths, lanes, lanes.view(np.uint8),
                                  lengths, 2)
