"""Port parity of the host library (tez_tpu_torch/native, ops/native.py).

Every binding of the port is held, byte for byte, against tez_tpu's
binding of its own library (built by tez_tpu's loader, as its tier-1
tests build it) and against the port's plain numpy version, on seeded
inputs: empty input, zero-length keys, keys longer than 64 bytes, one
partition, dedup-heavy Zipf keys, fixed-width rows, with 1 and with 8
threads.  Also: the callers' routing (gathers, precombine, the host
engine's span sort and merges), the rejected inputs, the host engine
against the device engine's partitions, and the loader's refusal to
answer without its library.
"""
import collections
import os

import numpy as np
import pytest

from tez_tpu.ops import native as jnative
from tez_tpu.ops import runformat as jrunformat
from tez_tpu.ops import sorter as jsorter
from tez_tpu_torch.ops import _build
from tez_tpu_torch.ops import native
from tez_tpu_torch.ops import runformat
from tez_tpu_torch.ops import sorter

THREADS = (1, 8)
SYMBOLS = ("gather_ragged_u8", "gather_fixed_u8", "concat_ragged_u8",
           "adjacent_equal_u8", "hash_sum_i64", "tz_split_ws",
           "tz_wc_create", "tz_wc_feed", "tz_wc_stats", "tz_wc_emit",
           "tz_wc_destroy", "tz_fnv32_partition", "tz_sort_partition_keys",
           "tz_span_sort_emit", "tz_merge_runs", "tz_merge_emit")


@pytest.fixture(scope="module", autouse=True)
def _tez_tpu_library():
    assert jnative.native_available(), "tez_tpu's libtezhost.so must load"


def ragged(keys):
    ko = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in keys], out=ko[1:])
    return np.frombuffer(b"".join(keys), np.uint8).copy(), ko


def rows(data, offsets):
    return [data[offsets[i]:offsets[i + 1]].tobytes()
            for i in range(len(offsets) - 1)]


def _vocab(rng, size, lo, hi, prefix=b""):
    return [prefix + bytes(rng.integers(97, 123, int(rng.integers(lo, hi)))
                           .astype(np.uint8)) for _ in range(size)]


def make_keys(case, rng):
    """The seeded key sets every binding is held on."""
    if case == "empty":
        return []
    if case == "zero_length":
        return [b"" if r < 0.3 else bytes([97 + int(r * 10) % 3]) * int(r * 4)
                for r in rng.random(6000)]
    if case == "long":
        # longer than 64 bytes, sharing long prefixes, some repeated
        vocab = _vocab(rng, 300, 0, 120, prefix=b"p" * 60)
        return [vocab[i] for i in rng.integers(0, 300, 5000)]
    if case == "zipf":
        vocab = _vocab(rng, 5000, 1, 17)
        return [vocab[i % 5000] for i in rng.zipf(1.3, 40000)]
    if case == "fixed":
        return [b"%012d" % i for i in rng.integers(0, 3000, 20000)]
    raise ValueError(case)


CASES = ("empty", "zero_length", "long", "zipf", "fixed")


def kv(case, seed=0):
    rng = np.random.default_rng(seed)
    keys = make_keys(case, rng)
    vals = [bytes(rng.integers(0, 256, 8).astype(np.uint8)) if i % 3 else
            bytes(rng.integers(0, 256, int(rng.integers(0, 20)))
                  .astype(np.uint8)) for i in range(len(keys))]
    return keys, vals


def assert_same(*results):
    first = results[0]
    for other in results[1:]:
        assert len(other) == len(first)
        for a, b in zip(first, other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the build ---------------------------------------------------------------
def test_library_builds_from_the_port_sources_with_every_symbol():
    native.load()
    lib = _build.host_library()
    path = lib._name
    assert os.path.dirname(path) == _build.BUILD_DIR
    assert os.path.basename(path).startswith("libtezhost-")
    assert _build.HOST_DIR == os.path.join(os.path.dirname(
        os.path.dirname(native.__file__)), "native")
    for sym in SYMBOLS:
        assert hasattr(lib, sym), sym
    assert native.MIN_NATIVE_BYTES == jnative.MIN_NATIVE_BYTES


# -- the gathers -------------------------------------------------------------
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", CASES)
def test_gather_ragged(case, threads):
    keys, _ = kv(case)
    kb, ko = ragged(keys)
    perm = np.random.default_rng(1).permutation(len(keys))
    perm = np.concatenate([perm, perm[:len(perm) // 3]])   # repeats
    assert_same(native.gather_ragged_native(kb, ko, perm, threads=threads),
                jnative.gather_ragged_native(kb, ko, perm),
                native.gather_ragged_plain(kb, ko, perm))


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("width", (1, 8, 12, 64))
def test_gather_fixed(width, threads):
    rng = np.random.default_rng(width)
    n = 5000
    data = rng.integers(0, 256, n * width).astype(np.uint8)
    perm = rng.integers(0, n, 7000)
    assert_same([native.gather_fixed_native(data, width, perm,
                                            threads=threads)],
                [jnative.gather_fixed_native(data, width, perm)],
                [native.gather_fixed_plain(data, width, perm)])


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", CASES)
def test_adjacent_equal(case, threads):
    keys, _ = kv(case)
    kb, ko = ragged(sorted(keys))
    lens = np.diff(ko)
    cand = np.flatnonzero(lens[1:] == lens[:-1]) if len(keys) > 1 else \
        np.zeros(0, np.int64)
    assert_same([native.adjacent_equal_native(kb, ko, cand,
                                              threads=threads)],
                [jnative.adjacent_equal_native(kb, ko, cand)],
                [native.adjacent_equal_plain(kb, ko, cand)])


@pytest.mark.parametrize("case", ("fixed", "zipf"))
def test_run_gathers_route_as_tez_tpu(case):
    """gather_ragged and adjacent_equal_rows call the library from
    MIN_NATIVE_BYTES on (fixed rows through gather_fixed_u8) and numpy
    below it, with tez_tpu's results."""
    keys, _ = kv(case)
    reps = -(-native.MIN_NATIVE_BYTES // len(b"".join(keys)))
    for keys_n in (keys[:100], keys * reps):
        kb, ko = ragged(keys_n)
        perm = np.random.default_rng(2).permutation(len(keys_n))
        native.reset_calls()
        assert_same(runformat.gather_ragged(kb, ko, perm),
                    jrunformat.gather_ragged(kb, ko, perm))
        big = kb.nbytes >= native.MIN_NATIVE_BYTES
        assert native.calls["gather_fixed_u8"] == int(big and case == "fixed")
        assert native.calls["gather_ragged_u8"] == int(big and case != "fixed")
        skb, sko = runformat.gather_ragged(kb, ko, np.argsort(
            np.array(keys_n, dtype=object), kind="stable"))
        lens = np.diff(sko)
        cand = np.flatnonzero(lens[1:] == lens[:-1])
        native.reset_calls()
        assert_same([runformat.adjacent_equal_rows(skb, sko, cand)],
                    [jrunformat.adjacent_equal_rows(skb, sko, cand)])
        assert native.calls["adjacent_equal_u8"] == int(
            int(lens[cand].sum()) >= native.MIN_NATIVE_BYTES)


# -- the precombine ----------------------------------------------------------
@pytest.mark.parametrize("case", CASES)
def test_hash_sum(case):
    keys, _ = kv(case)
    kb, ko = ragged(keys)
    vals = np.random.default_rng(3).integers(-2 ** 62, 2 ** 62,
                                             len(keys)) * 3
    assert_same(native.hash_sum_native(kb, ko, vals),
                jnative.hash_sum_native(kb, ko, vals),
                native.hash_sum_plain(kb, ko, vals))


# -- the tokenizer -----------------------------------------------------------
def text_chunks(seed=0):
    """Line-aligned chunks of words over every whitespace byte of
    bytes.split(), an empty chunk and one of whitespace only."""
    rng = np.random.default_rng(seed)
    vocab = _vocab(rng, 400, 1, 20) + [b"x" * 90]
    seps = [b" ", b"\t", b"\n", b"\v", b"\f", b"\r", b"  \t "]
    chunks = []
    for _ in range(6):
        words = [vocab[i % len(vocab)] for i in rng.zipf(1.2, 3000)]
        body = b"".join(w + seps[int(s)] for w, s in
                        zip(words, rng.integers(0, len(seps), len(words))))
        chunks.append(b"\r\n " + body + b"\n")
    return chunks + [b"", b" \t\n\v\f\r\n"]


@pytest.mark.parametrize("i", range(8))
def test_split_ws(i):
    chunk = text_chunks()[i]
    got = native.split_ws_native(chunk)
    assert_same(got, jnative.split_ws_native(chunk),
                native.split_ws_plain(chunk))
    assert rows(*got) == chunk.split()


def test_word_count_aggregator():
    chunks = text_chunks()
    agg = native.WordCountAggregator()
    jagg = jnative.WordCountAggregator.create()
    try:
        for chunk in chunks:
            agg.feed(chunk)
            jagg.feed(chunk)
        got = agg.emit()
        want = jagg.emit()
    finally:
        agg.close()
        jagg.close()
    assert_same(got, want, native.word_count_plain(chunks))
    kb, ko, counts = got
    words = [w for c in chunks for w in c.split()]
    assert rows(kb, ko) == list(dict.fromkeys(words))    # first occurrence
    assert dict(zip(rows(kb, ko), counts.tolist())) == \
        collections.Counter(words)


def test_word_count_aggregator_empty():
    agg = native.WordCountAggregator()
    agg.feed(b" \n")
    kb, ko, counts = agg.emit()
    agg.close()
    assert len(kb) == len(counts) == 0 and ko.tolist() == [0]
    assert_same(native.word_count_plain([b" \n"]), (kb, ko, counts))


# -- the host engine ---------------------------------------------------------
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("parts", (1, 4))
@pytest.mark.parametrize("case", CASES)
def test_fnv32_partition(case, parts, threads):
    from tez_tpu_torch.ops import kernels
    import torch
    keys, _ = kv(case)
    kb, ko = ragged(keys)
    got = native.fnv32_partition_native(kb, ko, parts, threads=threads)
    assert_same([got], [jnative.fnv32_partition_native(kb, ko, parts)],
                [native.fnv32_partition_plain(kb, ko, parts)])
    if keys:
        # the card's kernel (its plain version on the CPU) agrees
        from tez_tpu_torch.ops.keycodec import pad_to_matrix
        mat, lens = pad_to_matrix(kb, ko, max(1, int(np.diff(ko).max())))
        dev = kernels.fnv_hash_bytes(torch.from_numpy(mat),
                                     torch.from_numpy(lens), parts)
        np.testing.assert_array_equal(dev.numpy(), got)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("given", (False, True))
@pytest.mark.parametrize("case", CASES)
def test_sort_partition_keys(case, given, threads):
    keys, _ = kv(case)
    kb, ko = ragged(keys)
    parts = np.random.default_rng(4).integers(0, 5, len(keys)).astype(
        np.int32) if given else None
    assert_same([native.sort_partition_keys_native(kb, ko, parts,
                                                   threads=threads)],
                [jnative.sort_partition_keys_native(kb, ko, parts)],
                [native.sort_partition_keys_plain(kb, ko, parts)])


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("mode", ("derive", "given", "none"))
@pytest.mark.parametrize("parts", (1, 4))
@pytest.mark.parametrize("case", CASES)
def test_span_sort_emit(case, parts, mode, threads):
    keys, vals = kv(case)
    kb, ko = ragged(keys)
    vb, vo = ragged(vals)
    given = np.random.default_rng(5).integers(0, parts, len(keys)).astype(
        np.int32) if mode == "given" else None
    args = (kb, ko, vb, vo, parts, given, mode == "derive")
    got = native.span_sort_emit_native(*args, threads=threads)
    assert_same(got, jnative.span_sort_emit_native(*args),
                native.span_sort_emit_plain(*args))


def sorted_runs(case, k, parts, seed=0):
    """k (partition, key)-sorted runs of one key set, as the producers'
    span sorts leave them."""
    keys, vals = kv(case, seed)
    cuts = np.linspace(0, len(keys), k + 1).astype(int)
    runs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        kb, ko = ragged(keys[a:b])
        vb, vo = ragged(vals[a:b])
        runs.append(native.span_sort_emit_plain(kb, ko, vb, vo, parts, None,
                                                True))
    return runs


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("k", (1, 5))
@pytest.mark.parametrize("parts", (1, 4))
@pytest.mark.parametrize("case", CASES)
def test_merge_emit(case, parts, k, threads):
    runs = sorted_runs(case, k, parts)
    assert_same(native.merge_emit_native(runs, parts, threads=threads),
                jnative.merge_emit_native(runs, parts),
                native.merge_emit_plain(runs, parts))


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("k", (1, 5))
@pytest.mark.parametrize("parts", (1, 4))
@pytest.mark.parametrize("case", CASES)
def test_merge_runs(case, parts, k, threads):
    runs = sorted_runs(case, k, parts)
    kb, ko = runformat.concat_ragged([(r[0], r[1]) for r in runs])
    p = np.concatenate([np.repeat(np.arange(parts, dtype=np.int32),
                                  np.diff(r[4])) for r in runs])
    bounds = np.zeros(k + 1, np.int64)
    np.cumsum([len(r[1]) - 1 for r in runs], out=bounds[1:])
    p = p if parts > 1 else None
    assert_same([native.merge_runs_native(kb, ko, p, bounds,
                                          threads=threads)],
                [jnative.merge_runs_native(kb, ko, p, bounds)],
                [native.merge_runs_plain(kb, ko, p, bounds)])


# -- rejected inputs ---------------------------------------------------------
def test_rejected_inputs_raise_value_error():
    keys, vals = kv("zipf")
    kb, ko = ragged(keys[:8192])
    vb, vo = ragged(vals[:8192])
    bad = np.full(8192, 7, dtype=np.int32)
    with pytest.raises(ValueError):
        native.span_sort_emit_native(kb, ko, vb, vo, 4, bad, False)
    with pytest.raises(ValueError):
        native.span_sort_emit_native(kb, ko, vb, vo, 4, -bad, False)
    for nparts in (0, -1):
        with pytest.raises(ValueError):
            native.span_sort_emit_native(kb, ko, vb, vo, nparts, None, True)
        with pytest.raises(ValueError):
            native.fnv32_partition_native(kb, ko, nparts)
        with pytest.raises(ValueError):
            native.merge_emit_native([], nparts)
    with pytest.raises(ValueError):
        native.sort_partition_keys_native(kb, ko, -bad)
    with pytest.raises(ValueError):
        native.merge_runs_native(kb, ko, None, np.array([0, 5], np.int64))
    with pytest.raises(ValueError):
        native.gather_fixed_native(kb, 0, np.zeros(3, np.int64))
    rows_n = len(ko) - 1
    for bad_row in (-1, rows_n):
        with pytest.raises(ValueError):
            native.gather_ragged_native(kb, ko, np.array([0, bad_row]))
        with pytest.raises(ValueError):
            native.adjacent_equal_native(kb, ko, np.array([0, bad_row - 1]))
    for bad_row in (-1, len(kb)):
        with pytest.raises(ValueError):
            native.gather_fixed_native(kb, 1, np.array([0, bad_row]))
    with pytest.raises(ValueError):
        native.hash_sum_native(kb, ko, np.zeros(rows_n - 1, np.int64))
    run = native.span_sort_emit_plain(kb, ko, vb, vo, 4, None, True)
    with pytest.raises(ValueError):
        native.merge_emit_native([run], 3)


# -- the callers -------------------------------------------------------------
def host_sorters(**kw):
    return (sorter.DeviceSorter(engine="host", device="cpu", **kw),
            jsorter.DeviceSorter(engine="host", **kw))


@pytest.mark.parametrize("normalized", (False, True))
@pytest.mark.parametrize("case", ("zipf", "long", "zero_length"))
def test_host_engine_span_sort_matches_tez_tpu(case, normalized):
    """The sorter's host engine: one fused tz_span_sort_emit without a
    normalizer, tz_fnv32_partition + tz_sort_partition_keys with one;
    runs equal to tez_tpu's, keys longer than key_width included."""
    keys, vals = kv(case)
    kb, ko = ragged(keys)
    vb, vo = ragged(vals)
    kw = dict(num_partitions=4, key_width=8)
    if normalized:
        kw["key_normalizer"] = lambda k: k.upper()[::-1]
    t, j = host_sorters(**kw)
    native.reset_calls()
    trun = t.sort_batch(runformat.KVBatch(kb, ko, vb, vo))
    jrun = j.sort_batch(jrunformat.KVBatch(kb, ko, vb, vo))
    assert_same([trun.batch.key_bytes, trun.batch.key_offsets,
                 trun.batch.val_bytes, trun.batch.val_offsets,
                 trun.row_index],
                [jrun.batch.key_bytes, jrun.batch.key_offsets,
                 jrun.batch.val_bytes, jrun.batch.val_offsets,
                 jrun.row_index])
    assert native.calls["tz_span_sort_emit"] == int(not normalized)
    assert native.calls["tz_sort_partition_keys"] == int(normalized)
    assert native.calls["tz_fnv32_partition"] == int(normalized)


@pytest.mark.parametrize("normalized", (False, True))
@pytest.mark.parametrize("case", ("zipf", "long"))
def test_host_merge_matches_tez_tpu(case, normalized):
    """merge_sorted_runs on the host engine: tz_merge_emit without a
    normalizer, tz_merge_runs with one; ties in run order, as tez_tpu."""
    norm = (lambda k: k[::-1]) if normalized else None
    runs = {}
    for pkg, rf, srt in (("t", runformat, sorter),
                         ("j", jrunformat, jsorter)):
        made = []
        for seed in range(4):
            keys, vals = kv(case, seed)
            kb, ko = ragged(keys[:3000])
            vb, vo = ragged([b"%d:" % seed + v for v in vals[:3000]])
            s = srt.DeviceSorter(num_partitions=3, key_width=8,
                                 engine="host", key_normalizer=norm,
                                 **({"device": "cpu"} if pkg == "t" else {}))
            made.append(s.sort_batch(rf.KVBatch(kb, ko, vb, vo)))
        runs[pkg] = made
    native.reset_calls()
    tm = sorter.merge_sorted_runs(runs["t"], 3, 8, engine="host",
                                  key_normalizer=norm, device="cpu")
    jm = jsorter.merge_sorted_runs(runs["j"], 3, 8, engine="host",
                                   key_normalizer=norm)
    assert_same([tm.batch.key_bytes, tm.batch.key_offsets,
                 tm.batch.val_bytes, tm.batch.val_offsets, tm.row_index],
                [jm.batch.key_bytes, jm.batch.key_offsets,
                 jm.batch.val_bytes, jm.batch.val_offsets, jm.row_index])
    assert native.calls["tz_merge_emit"] == int(not normalized)
    assert native.calls["tz_merge_runs"] == int(normalized)


def test_precombine_calls_hash_sum():
    keys, _ = kv("zipf")
    kb, ko = ragged(keys)
    one = np.frombuffer((1 + (1 << 63)).to_bytes(8, "big"), np.uint8)
    vb = np.tile(one, len(keys))
    vo = np.arange(len(keys) + 1, dtype=np.int64) * 8
    s = sorter.DeviceSorter(num_partitions=2, device="cpu",
                            combiner=sorter.sum_long_combiner)
    native.reset_calls()
    out = s._precombine(runformat.KVBatch(kb, ko, vb, vo), None)
    assert native.calls["hash_sum_i64"] == 1
    assert out.num_records == len(set(keys))


@pytest.mark.parametrize("case", ("zipf", "long"))
def test_host_and_device_spans_of_one_task_agree_on_partitions(case):
    """A span under the device floor goes to the host engine, the next
    span of the same sorter to the device engine (its kernels' plain
    versions here): every record lands in the same partition either way,
    the FNV-1a of its raw key bytes."""
    keys, vals = kv(case)
    s = sorter.DeviceSorter(num_partitions=5, key_width=12, device="cpu",
                            device_min_records=2000)
    kb, ko = ragged(keys)
    vb, vo = ragged(vals)
    want = dict(zip(keys, native.fnv32_partition_native(kb, ko, 5)))
    native.reset_calls()
    seen = collections.defaultdict(set)
    for lo, hi in ((0, 1500), (1500, 5000)):     # host, then device
        skb, sko = ragged(keys[lo:hi])
        svb, svo = ragged(vals[lo:hi])
        run = s.sort_batch(runformat.KVBatch(skb, sko, svb, svo))
        for p in range(5):
            a, b = run.row_index[p], run.row_index[p + 1]
            for key in rows(run.batch.key_bytes,
                            run.batch.key_offsets[a:b + 1]):
                seen[key].add(p)
    assert native.calls["tz_span_sort_emit"] == 1
    assert all(ps == {want[k]} for k, ps in seen.items())


# -- no fallback -------------------------------------------------------------
@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded in this process."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delitem(_build._loaded, "tezhost", raising=False)
    monkeypatch.setattr(native, "_fns", {})
    return tmp_path


def test_no_gxx_raises_and_never_answers_from_numpy(fresh_build,
                                                    monkeypatch):
    empty = fresh_build / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    kb, ko = ragged([b"w%05d" % i for i in range(200_000)])
    perm = np.arange(200_000)[::-1].copy()
    with pytest.raises(_build.HostLibraryError, match="g\\+\\+"):
        native.split_ws_native(b"a b")
    with pytest.raises(_build.HostLibraryError):
        runformat.gather_ragged(kb, ko, perm)          # 1.2 MB: native
    s = sorter.DeviceSorter(num_partitions=2, engine="host", device="cpu")
    with pytest.raises(_build.HostLibraryError):
        s.sort_batch(runformat.KVBatch(kb, ko, kb, ko))
    assert not os.path.exists(_build.BUILD_DIR) or \
        not os.listdir(_build.BUILD_DIR)


def test_failed_build_and_failed_load_raise(fresh_build, monkeypatch):
    fake = fresh_build / "bin"
    fake.mkdir()
    gxx = fake / "g++"
    gxx.write_text("#!/bin/sh\necho broken compiler >&2\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake))
    with pytest.raises(_build.HostLibraryError, match="broken compiler"):
        native.load()
    _srcs, lib = _build._host_target()
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    with open(lib, "wb") as fh:
        fh.write(b"not a shared library")
    with pytest.raises(_build.HostLibraryError, match="cannot load"):
        native.load()
