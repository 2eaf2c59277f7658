"""Port parity: the plain PyTorch versions of tez_tpu_torch's CUDA kernels
against the JAX package's Pallas kernels (interpret mode) and their XLA
bodies, bit for bit; and the wrappers' input checks.  The CUDA kernels
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


def _queries(rng, kind, run, run_len, m, w, vals=4):
    """m query rows: "sorted" (a sorted draw, with run copies and sentinel
    tails), "unsorted" (the same rows shuffled) or "mixed" (sorted, with
    a shuffled stretch whose ends fall inside tiles)."""
    q = rng.integers(0, vals, (m, w)).astype(np.uint32)
    q_len = rng.integers(1, 9, m).astype(np.uint32)
    if run.shape[0]:
        pick = rng.integers(0, run.shape[0], m // 3)
        q[:m // 3], q_len[:m // 3] = run[pick], run_len[pick]
    q[-3:], q_len[-3:] = 0xFFFFFFFF, 0xFFFFFFFF
    order = np.lexsort((q_len,) + tuple(q[:, i] for i in range(w - 1, -1, -1)))
    q, q_len = q[order], q_len[order]
    if kind == "unsorted":
        perm = rng.permutation(m)
        q, q_len = q[perm], q_len[perm]
    elif kind == "mixed":
        lo, hi = m // 5 + 3, (3 * m) // 5 + 1
        perm = lo + rng.permutation(hi - lo)
        q[lo:hi], q_len[lo:hi] = q[perm], q_len[perm]
    return q, q_len


def _in_order(q, q_len, tile):
    """Per tile: every adjacent pair q[i] <= q[i+1] (numpy)."""
    m = q.shape[0]
    keys = [tuple(r) + (l,) for r, l in zip(q.tolist(), q_len.tolist())]
    return np.array([all(keys[i] <= keys[i + 1]
                         for i in range(t, min(t + tile, m) - 1))
                     for t in range(0, m, tile)], dtype=np.int32)


@pytest.mark.parametrize("count_equal", [False, True])
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "mixed"])
@pytest.mark.parametrize("w", [1, 3, 4, 9])
def test_merge_rank_windows_match_tez_tpu(w, kind, count_equal):
    """merge_rank_windows: lo and hi are the ranks of each tile's first and
    last query under merge_rank_pallas (interpret mode) and tez_tpu's
    _rank_search; the in-order flag agrees with a numpy check."""
    rng = np.random.default_rng(w * 10 + len(kind))
    n, m, tile = 301, 2 * MERGE_ROW_BLOCK, 64
    run, run_len = _sorted_run(rng, n, w)
    q, q_len = _queries(rng, kind, run, run_len, m, w)
    ranks = np.asarray(merge_rank_pallas(
        jnp.asarray(run), jnp.asarray(run_len), jnp.asarray(q),
        jnp.asarray(q_len), count_equal=count_equal, interpret=True))
    firsts = np.arange(0, m, tile)
    lasts = np.minimum(firsts + tile, m) - 1
    xla = np.asarray(jdevice._rank_search(
        jnp.asarray(run), jnp.asarray(run_len),
        jnp.asarray(np.concatenate([q[firsts], q[lasts]])),
        jnp.asarray(np.concatenate([q_len[firsts], q_len[lasts]])),
        count_equal))
    got = kernels.merge_rank_windows(_t(run), _t(run_len), _t(q), _t(q_len),
                                     count_equal, tile).numpy()
    np.testing.assert_array_equal(got[0], ranks[firsts])
    np.testing.assert_array_equal(got[1], ranks[lasts])
    np.testing.assert_array_equal(np.concatenate([got[0], got[1]]), xla)
    np.testing.assert_array_equal(got[2], _in_order(q, q_len, tile))
    if kind == "sorted":
        assert got[2].all()
    else:
        assert not got[2].all() and got[2].any() == (kind == "mixed")


#: (run rows, query rows, tile, lane values of the run): an empty run, M not
#: a multiple of the tile, M below one tile, one-row tiles, all-equal runs
_WINDOW_EDGES = {
    "empty_run": (0, 100, 32, 4),
    "ragged_last_tile": (150, 333, 64, 4),
    "one_partial_tile": (80, 20, 64, 4),
    "tile_of_one": (40, 17, 1, 4),
    "all_equal_run": (200, 256, 32, 1),
}


@pytest.mark.parametrize("case", sorted(_WINDOW_EDGES))
@pytest.mark.parametrize("w", [1, 3, 4, 9])
def test_merge_rank_windows_edges(w, case):
    """Edge shapes against tez_tpu's _rank_search at each tile's first and
    last query, sentinel tails in run and queries."""
    n, m, tile, vals = _WINDOW_EDGES[case]
    rng = np.random.default_rng(n + m + w)
    run, run_len = _sorted_run(rng, max(n, 8), w, vals)
    run, run_len = run[:n], run_len[:n]
    if vals == 1:                       # every row the same key
        run[:], run_len[:] = 0, 4
    q, q_len = _queries(rng, "mixed", run, run_len, m, w, vals=2)
    firsts = np.arange(0, m, tile)
    lasts = np.minimum(firsts + tile, m) - 1
    for count_equal in (False, True):
        got = kernels.merge_rank_windows(_t(run), _t(run_len), _t(q),
                                         _t(q_len), count_equal, tile)
        assert got.dtype == torch.int32 and got.shape == (3, len(firsts))
        if n == 0:
            want = np.zeros(2 * len(firsts), np.int32)
        else:
            want = np.asarray(jdevice._rank_search(
                jnp.asarray(run), jnp.asarray(run_len),
                jnp.asarray(np.concatenate([q[firsts], q[lasts]])),
                jnp.asarray(np.concatenate([q_len[firsts], q_len[lasts]])),
                count_equal))
        np.testing.assert_array_equal(got[:2].numpy().reshape(-1), want)
        np.testing.assert_array_equal(got[2].numpy(),
                                      _in_order(q, q_len, tile))


def test_merge_rank_windows_empty_queries():
    z = torch.zeros((0, 3), dtype=torch.int32)
    run = torch.zeros((5, 3), dtype=torch.int32)
    got = kernels.merge_rank_windows(run, torch.zeros(5, dtype=torch.int32),
                                     z, torch.zeros(0, dtype=torch.int32),
                                     True, 64)
    assert got.shape == (3, 0) and got.dtype == torch.int32


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
    z = torch.zeros((4, 2), dtype=torch.int32)
    n = torch.zeros(4, dtype=torch.int32)
    kernels.merge_path_pair(z, n, n, z, n, n)
    assert kernels.launches == {"fnv_hash_bytes": 0, "fnv_hash_lanes": 0,
                                "merge_rank": 0, "merge_path_pair": 0}


def test_build_targets_are_content_addressed():
    for name in _build.KERNELS:
        src, lib = _build._target(name)
        assert src.endswith(f"csrc/{name}.cu")
        assert lib.startswith(_build.BUILD_DIR)
        assert _build._target(name) == (src, lib)


def test_build_targets_follow_shared_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header gives every kernel a new library name,
    so a stale build is never loaded."""
    import shutil
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", str(src))
    headers = sorted(src.glob("*.cuh"))
    assert headers, "the kernels share at least one header"
    before = {name: _build._target(name)[1] for name in _build.KERNELS}
    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {name: _build._target(name)[1] for name in _build.KERNELS}
    assert all(before[k] != after[k] for k in _build.KERNELS)


# ---------------------------------------------------------------------------
# merge-path pair merge
# ---------------------------------------------------------------------------
def _merge_run(rng, n, w, ties, sentinels=0):
    """A run sorted under the composite comparator: lanes from `ties`
    values (few values: many equal keys), lengths 1..8, the last
    `sentinels` rows pad sentinels (lanes and length 0xFFFFFFFF)."""
    run = rng.integers(0, ties, (n, w)).astype(np.uint32)
    run_len = rng.integers(1, 9, n).astype(np.uint32) if ties > 1 else \
        np.full(n, 4, np.uint32)
    order = np.lexsort((run_len,) + tuple(run[:, i]
                                          for i in range(w - 1, -1, -1)))
    run, run_len = run[order], run_len[order]
    if sentinels:
        run[-sentinels:] = 0xFFFFFFFF
        run_len[-sentinels:] = 0xFFFFFFFF
    return run, run_len


#: (na, nb, lane values, sentinel rows of A, of B)
_PAIR_CASES = {
    "na_eq_nb": (300, 300, 3, 0, 0),
    "na_2nb": (512, 256, 3, 0, 0),
    "all_equal": (200, 150, 1, 0, 0),
    "sentinel_tails": (260, 260, 2, 9, 33),
    "na_2nb_sentinels": (600, 300, 4, 20, 7),
}


def _pair_inputs(w, case, seed):
    rng = np.random.default_rng(seed)
    na, nb, ties, sa, sb = _PAIR_CASES[case] if isinstance(case, str) \
        else case
    a, a_len = _merge_run(rng, na, w, ties, sa)
    b, b_len = _merge_run(rng, nb, w, ties, sb)
    a_idx = np.arange(na, dtype=np.int32)
    b_idx = np.arange(na, na + nb, dtype=np.int32)
    return a, a_len, a_idx, b, b_len, b_idx


@pytest.mark.parametrize("case", sorted(_PAIR_CASES))
@pytest.mark.parametrize("w", [1, 3, 4, 9])
def test_merge_path_pair_plain_matches_tez_tpu(w, case):
    """kernels.merge_path_pair on CPU tensors == tez_tpu's _merge_path_pair
    (two cross ranks + scatter) on lanes, lengths and idx."""
    arrays = _pair_inputs(w, case, seed=w * 101 + len(case))
    want = jdevice._merge_path_pair(*[jnp.asarray(x) for x in arrays])
    got = kernels.merge_path_pair(*[_t(x) for x in arrays])
    for g, x in zip(got, want):
        x = np.asarray(x)
        np.testing.assert_array_equal(g.numpy(), x.view(np.int32))


def _oracle_merge(a, a_len, a_idx, b, b_len, b_idx):
    """Stable lexsort of the concatenation (A before B on equal keys)."""
    lanes = np.concatenate([a, b])
    lens = np.concatenate([a_len, b_len])
    order = np.lexsort((lens,) + tuple(lanes[:, i] for i in
                                       range(lanes.shape[1] - 1, -1, -1)))
    return lanes[order], lens[order], np.concatenate([a_idx, b_idx])[order]


@pytest.mark.parametrize("empty", ["a", "b", "both"])
@pytest.mark.parametrize("w", [1, 3, 4, 9])
def test_merge_path_pair_plain_empty_side(w, empty):
    """An empty run, which tez_tpu's _merge_path_pair never receives (its
    runs are buckets of >= 256 rows; its search cannot index an empty run),
    against a stable lexsort of the concatenation."""
    na = 0 if empty in ("a", "both") else 70
    nb = 0 if empty in ("b", "both") else 70
    arrays = _pair_inputs(w, (na, nb, 3, 0, 5 if nb else 0), seed=w)
    got = kernels.merge_path_pair(*[_t(x) for x in arrays])
    for g, x in zip(got, _oracle_merge(*arrays)):
        np.testing.assert_array_equal(g.numpy(), x.view(np.int32))


@pytest.mark.parametrize("na,nb", [(40, 40), (80, 40), (0, 25), (25, 0),
                                   (1, 60)])
def test_merge_path_splits_match_ranks(na, nb):
    """The co-rank i(d) at every diagonal d == the number of A rows whose
    merged position (i + rank of a_i in B, tez_tpu's _rank_search) is < d.
    Two lane values and two lengths: long runs of equal keys."""
    rng = np.random.default_rng(na * 7 + nb)
    a = rng.integers(0, 2, (na, 2)).astype(np.uint32)
    b = rng.integers(0, 2, (nb, 2)).astype(np.uint32)
    a_len = rng.integers(1, 3, na).astype(np.uint32)
    b_len = rng.integers(1, 3, nb).astype(np.uint32)
    (a, a_len), (b, b_len) = [
        (x[o], xl[o]) for x, xl in ((a, a_len), (b, b_len))
        for o in [np.lexsort((xl, x[:, 1], x[:, 0]))]]
    if nb:
        rank_a = np.asarray(jdevice._rank_search(
            jnp.asarray(b), jnp.asarray(b_len), jnp.asarray(a),
            jnp.asarray(a_len), False)) if na else np.zeros(0, np.int64)
    else:
        rank_a = np.zeros(na, np.int64)
    pos_a = np.arange(na) + rank_a
    diagonals = np.arange(na + nb + 1)
    want = np.searchsorted(pos_a, diagonals, side="left")
    got = kernels.merge_path_splits(_t(a), _t(a_len), _t(b), _t(b_len),
                                    torch.from_numpy(diagonals))
    np.testing.assert_array_equal(got.numpy(), want)


def test_merge_path_pair_checks_inputs():
    lanes = torch.zeros((4, 2), dtype=torch.int32)
    n = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.merge_path_pair(lanes, n, n, torch.zeros((4, 3),
                                                         dtype=torch.int32),
                                n, n)
    with pytest.raises(ValueError):
        kernels.merge_path_pair(lanes, n, torch.zeros(5, dtype=torch.int32),
                                lanes, n, n)
    with pytest.raises(TypeError):
        kernels.merge_path_pair(lanes, n, n.to(torch.int64), lanes, n, n)
    with pytest.raises(ValueError):
        kernels.merge_path_pair(lanes, n, n, torch.zeros((8, 2),
                                dtype=torch.int32)[::2], n, n)
