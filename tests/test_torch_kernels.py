"""Port parity: the plain PyTorch versions of tez_tpu_torch's two CUDA
kernels against the JAX package's Pallas kernels (interpret mode) and their
XLA bodies, bit for bit; and the wrappers' input checks.  The CUDA kernels
against their plain versions are in test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tez_tpu.ops import device as jdevice
from tez_tpu.ops.host_sort import fnv_rows_host
from tez_tpu.ops.keycodec import pad_to_matrix
from tez_tpu.ops.pallas_kernels import (MERGE_ROW_BLOCK, hash_partition_pallas,
                                        merge_rank_pallas)
from tez_tpu.ops.runformat import KVBatch
from tez_tpu_torch.ops import _build, kernels
from tez_tpu_torch.ops import device as tdevice

from test_ops import random_pairs

INT32_MAX = np.iinfo(np.int32).max


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; u32 columns as int32 bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _key_matrix(n, seed, max_key):
    b = KVBatch.from_pairs(random_pairs(n, seed=seed, max_key=max_key))
    klens = b.key_offsets[1:] - b.key_offsets[:-1]
    w = 1 << max(2, (int(klens.max()) - 1).bit_length())
    return pad_to_matrix(b.key_bytes, b.key_offsets, w)


@pytest.mark.parametrize("num_partitions", [1, 5, 7919])
@pytest.mark.parametrize("n,max_key", [(700, 24), (1024, 5), (1, 3)])
def test_fnv_bytes_plain_matches_pallas_and_xla(n, max_key, num_partitions):
    mat, lengths = _key_matrix(n, 31 + n, max_key)
    pallas = hash_partition_pallas(mat, lengths, num_partitions,
                                   interpret=True)
    xla = jdevice.hash_partition(mat, lengths, num_partitions)
    got = kernels.fnv_hash_bytes(_t(mat), _t(lengths), num_partitions)
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), xla)
    np.testing.assert_array_equal(
        tdevice.hash_partition(mat, lengths, num_partitions, device="cpu"),
        xla)
    np.testing.assert_array_equal(
        got.numpy(), fnv_rows_host(mat, lengths) % num_partitions)


def test_fnv_bytes_pad_rows_and_lengths_past_width():
    """length < 0 marks a pad row (partition INT32_MAX, as
    _hash_to_partitions); a length past W hashes the whole row."""
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 256, (300, 8)).astype(np.uint8)
    lengths = rng.integers(-1, 12, 300).astype(np.int32)
    want = np.asarray(jdevice._hash_to_partitions(
        jnp.asarray(mat), jnp.asarray(lengths), 6))
    got = kernels.fnv_hash_bytes(_t(mat), _t(lengths), 6).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[lengths < 0] == INT32_MAX).all()


@pytest.mark.parametrize("num_lanes", [1, 3, 4])
def test_fnv_lanes_plain_matches_xla_lane_hash(num_lanes):
    """Lanes hash == tez_tpu's _fnv_rows_from_lanes + partition epilogue,
    with pad rows, all-0xFF keys and every length up to the lane bytes."""
    rng = np.random.default_rng(num_lanes)
    n = 513
    lanes = rng.integers(0, 2 ** 32, (n, num_lanes), dtype=np.uint64)\
        .astype(np.uint32)
    lanes[:20] = 0xFFFFFFFF
    lengths = rng.integers(0, num_lanes * 4 + 1, n).astype(np.int32)
    lengths[5:9] = -1
    lengths[:4] = num_lanes * 4
    h = jdevice._fnv_rows_from_lanes(jnp.asarray(lanes), jnp.asarray(lengths))
    want = np.where(lengths < 0, INT32_MAX,
                    (np.asarray(h) % np.uint32(11)).astype(np.int64))
    got = kernels.fnv_hash_lanes(_t(lanes), _t(lengths), 11).numpy()
    np.testing.assert_array_equal(got, want)


def _sorted_run(rng, n, w, vals=4):
    run = rng.integers(0, vals, (n, w)).astype(np.uint32)
    run_len = rng.integers(1, 9, n).astype(np.uint32)
    run[:3] = 0xFFFFFFFF            # all-0xFF real keys ...
    run[-5:] = 0xFFFFFFFF           # ... and pad sentinels at the tail
    run_len[-5:] = 0xFFFFFFFF
    order = np.lexsort((run_len,) + tuple(run[:, i]
                                          for i in range(w - 1, -1, -1)))
    return run[order], run_len[order]


@pytest.mark.parametrize("count_equal", [False, True])
@pytest.mark.parametrize("w", [1, 3, 4])
def test_merge_rank_plain_matches_pallas(w, count_equal):
    rng = np.random.default_rng(7 + w)
    n, m = 173, 2 * MERGE_ROW_BLOCK          # m a block multiple: grid path
    run, run_len = _sorted_run(rng, n, w)
    q = rng.integers(0, 4, (m, w)).astype(np.uint32)
    q_len = rng.integers(1, 9, m).astype(np.uint32)
    q[:40], q_len[:40] = run[:40], run_len[:40]     # exact ties
    q[40:45] = 0xFFFFFFFF
    q_len[40:45] = 0xFFFFFFFF
    want = merge_rank_pallas(jnp.asarray(run), jnp.asarray(run_len),
                             jnp.asarray(q), jnp.asarray(q_len),
                             count_equal=count_equal, interpret=True)
    got = kernels.merge_rank(_t(run), _t(run_len), _t(q), _t(q_len),
                             count_equal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,m", [(0, 7), (1, 1), (300, 131)])
def test_merge_rank_plain_matches_rank_search_any_shape(n, m):
    """Shapes off the Pallas grid (m not a multiple of 256, empty runs) go
    through tez_tpu's _rank_search; the port takes any shape."""
    rng = np.random.default_rng(n + m)
    run, run_len = _sorted_run(rng, max(n, 8), 2)
    run, run_len = run[:n], run_len[:n]
    q = rng.integers(0, 4, (m, 2)).astype(np.uint32)
    q_len = rng.integers(1, 9, m).astype(np.uint32)
    for count_equal in (False, True):
        got = kernels.merge_rank(_t(run), _t(run_len), _t(q), _t(q_len),
                                 count_equal)
        if n == 0:
            want = np.zeros(m, np.int32)
        else:
            want = np.asarray(jdevice._rank_search(
                jnp.asarray(run), jnp.asarray(run_len), jnp.asarray(q),
                jnp.asarray(q_len), count_equal))
        np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_check_inputs():
    mat = torch.zeros((4, 8), dtype=torch.uint8)
    lens = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernels.fnv_hash_bytes(mat.to(torch.int32), lens, 3)
    with pytest.raises(ValueError):
        kernels.fnv_hash_bytes(mat, torch.zeros(5, dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        kernels.fnv_hash_bytes(mat, lens, 0)
    with pytest.raises(ValueError):
        kernels.fnv_hash_lanes(torch.zeros((8, 4), dtype=torch.int32).t(),
                               lens, 3)
    lanes = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.merge_rank(lanes, lens, torch.zeros((4, 3), dtype=torch.int32),
                           lens, False)
    with pytest.raises(TypeError):
        kernels.merge_rank(lanes, lens.to(torch.int64), lanes, lens, False)


def test_launch_counts_stay_zero_for_plain_versions():
    kernels.reset_launches()
    kernels.fnv_hash_bytes(torch.zeros((4, 8), dtype=torch.uint8),
                           torch.ones(4, dtype=torch.int32), 3)
    assert kernels.launches == {"fnv_hash_bytes": 0, "fnv_hash_lanes": 0,
                                "merge_rank": 0}


def test_build_targets_are_content_addressed():
    for name in _build.KERNELS:
        src, lib = _build._target(name)
        assert src.endswith(f"csrc/{name}.cu")
        assert lib.startswith(_build.BUILD_DIR)
        assert _build._target(name) == (src, lib)
