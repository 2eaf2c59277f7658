"""Port parity of host spill and the streamed final merge: the run blobs,
the partition-indexed and chunked run files, iter_merged_blocks and
DeviceSorter's spill path (spill_dir, flush_run -> FileRun) against
tez_tpu's on the same seeded inputs.  The data plane is all integer, so
every comparison is byte for byte: no tolerance.  The port runs on
device="cpu" (the kernels' plain versions); tez_tpu's device engine runs
on JAX's CPU backend."""
import os
import types

import numpy as np
import pytest

import chip_smoke
from tez_tpu.common import faults as jfaults
from tez_tpu.common.counters import TaskCounter as JCounter
from tez_tpu.ops import block_merge as jblock
from tez_tpu.ops import runformat as jrf
from tez_tpu.ops import sorter as jsorter
from tez_tpu_torch.common import faults as tfaults
from tez_tpu_torch.common.counters import TaskCounter as TCounter
from tez_tpu_torch.ops import block_merge as tblock
from tez_tpu_torch.ops import runformat as trf
from tez_tpu_torch.ops import sorter as tsorter


@pytest.fixture(autouse=True)
def _clean_fault_planes():
    """tests/conftest.py clears tez_tpu's fault plane only."""
    tfaults.clear_all()
    yield
    tfaults.clear_all()
    jfaults.clear_all()


PKGS = {"port": (trf, tfaults), "tez_tpu": (jrf, jfaults)}


def _pairs(seed, n, max_key=8, alphabet=4, max_val=12):
    rng = np.random.default_rng(seed)
    return [(bytes(rng.integers(97, 97 + alphabet,
                                int(rng.integers(1, max_key + 1)))
                   .astype(np.uint8)),
             bytes(rng.integers(0, 256, int(rng.integers(0, max_val + 1)))
                   .astype(np.uint8)))
            for _ in range(n)]


def _batch(rf, pairs):
    return rf.KVBatch.from_pairs(pairs)


def _sorted_run(rf, pairs, num_partitions, seed=0):
    """A partition-sorted Run: random partitions, keys sorted in each."""
    parts = np.random.default_rng(seed).integers(0, num_partitions,
                                                 len(pairs))
    order = sorted(range(len(pairs)), key=lambda i: (parts[i], pairs[i][0]))
    row_index = np.zeros(num_partitions + 1, dtype=np.int64)
    np.cumsum(np.bincount(parts, minlength=num_partitions),
              out=row_index[1:])
    return rf.Run(_batch(rf, [pairs[i] for i in order]), row_index)


def _run_arrays(run):
    b = run.batch
    return [b.key_bytes, b.key_offsets, b.val_bytes, b.val_offsets,
            run.row_index]


def _same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# -- run blobs ----------------------------------------------------------------
def _offsets_case(rf, kind):
    """Runs whose offsets take each wire coding: u8, u16 (a 300-byte key),
    u32 (a 70,000-byte value), raw int64 (a rebased view), none (empty)."""
    if kind == "empty":
        return rf.Run(rf.KVBatch.empty(), np.zeros(3, dtype=np.int64))
    pairs = _pairs(7, 200)
    if kind == "u16":
        pairs[5] = (b"k" * 300, b"v")
    elif kind == "u32":
        pairs[9] = (b"k", bytes(70_000))
    run = _sorted_run(rf, pairs, 2)
    if kind == "rebased":
        b = run.batch
        run = rf.Run(rf.KVBatch(b.key_bytes, b.key_offsets + 5,
                                b.val_bytes, b.val_offsets), run.row_index)
    return run


@pytest.mark.parametrize("codec", [None, "zlib", "zstd"])
@pytest.mark.parametrize("kind", ["u8", "u16", "u32", "rebased", "empty"])
def test_run_blob_matches_tez_tpu(codec, kind):
    if codec == "zstd":
        pytest.importorskip("zstandard")
    t, j = _offsets_case(trf, kind), _offsets_case(jrf, kind)
    tb, jb = t.to_bytes(codec), j.to_bytes(codec)
    assert tb == jb
    _same_arrays(_run_arrays(trf.Run.from_bytes(jb)),
                 _run_arrays(jrf.Run.from_bytes(jb)))
    _same_arrays(_run_arrays(trf.Run.from_bytes(tb)),
                 _run_arrays(jrf.Run.from_bytes(tb)))


def test_run_codec_table_matches_tez_tpu():
    for codec in (None, "zlib"):
        assert trf.resolve_codec(codec)[0] == jrf.resolve_codec(codec)[0]
    for rf in (trf, jrf):
        with pytest.raises(ValueError, match="lz4"):
            rf.resolve_codec("lz4")
        with pytest.raises(ValueError, match="unsupported run codec"):
            rf.resolve_codec("snappy")
    assert trf.MAGIC == jrf.MAGIC
    assert trf.RUN_HEADER_NBYTES == jrf.RUN_HEADER_NBYTES


@pytest.mark.parametrize("pkg", list(PKGS))
def test_run_save_load_and_corruption(tmp_path, pkg):
    """Run.save writes tez_tpu's bytes; each package loads the other's
    file; a payload byte corrupted at spill.read raises the checksum
    IOError in both."""
    rf, faults = PKGS[pkg]
    run = _offsets_case(rf, "u8")
    path = str(tmp_path / "r.run")
    run.save(path, codec="zlib")
    assert open(path, "rb").read() == _offsets_case(jrf, "u8").to_bytes(
        "zlib")
    for other in (trf, jrf):
        _same_arrays(_run_arrays(other.Run.load(path)), _run_arrays(run))
    faults.install("t", faults.parse_spec("spill.read:corrupt:n=1"))
    with pytest.raises(IOError, match="checksum mismatch"):
        rf.Run.load(path)


def test_kvbatch_rows_values_and_pickling():
    import pickle
    import torch
    pairs = _pairs(3, 50)
    t, j = _batch(trf, pairs), _batch(jrf, pairs)
    assert list(t.iter_pairs()) == list(j.iter_pairs()) == pairs
    assert [t.value(i) for i in range(50)] == [v for _k, v in pairs]
    lanes, lens = torch.zeros(64, 2, dtype=torch.int32), torch.zeros(64)
    t.dev_keys = (lanes, lens, 3, 53)
    piece = t.slice_rows(10, 20)
    assert piece.dev_keys[0] is lanes and piece.dev_keys[2:] == (13, 23)
    assert list(piece.iter_pairs()) == list(j.slice_rows(10, 20)
                                            .iter_pairs())
    back = pickle.loads(pickle.dumps(t))
    assert back.dev_keys is None and list(back.iter_pairs()) == pairs
    assert t.dev_keys is not None


def test_run_partition_accessors_match_tez_tpu():
    t = _sorted_run(trf, _pairs(4, 300), 5)
    j = _sorted_run(jrf, _pairs(4, 300), 5)
    assert t.empty_partition_flags() == j.empty_partition_flags()
    assert t.nbytes == j.nbytes
    for p in range(5):
        assert t.partition_row_count(p) == j.partition_row_count(p)
        assert t.partition_nbytes(p) == j.partition_nbytes(p)
        assert list(t.partition(p).iter_pairs()) == \
            list(j.partition(p).iter_pairs())


# -- partition-indexed and chunked files --------------------------------------
def _file_cases(rf, case):
    """(run, block_records) of a file case: several blocks a partition, or
    empty partitions between full ones."""
    if case == "blocks":
        return _sorted_run(rf, _pairs(11, 1500), 5), 100
    batch = rf.KVBatch.from_pairs([(b"k1", b"v1"), (b"k2", b"v2")])
    return rf.Run(batch, np.array([0, 0, 2, 2, 2], dtype=np.int64)), 65536


@pytest.mark.parametrize("codec", [None, "zlib"])
@pytest.mark.parametrize("case", ["blocks", "empty partitions"])
def test_partitioned_file_matches_tez_tpu(tmp_path, codec, case):
    paths = {}
    for name, (rf, _f) in PKGS.items():
        run, block = _file_cases(rf, case)
        paths[name] = rf.save_run_partitioned(
            run, str(tmp_path / f"{name}.prun"), codec=codec,
            block_records=block)
    assert open(paths["port"], "rb").read() == \
        open(paths["tez_tpu"], "rb").read()
    # each package's FileRun reads the other's file
    for path in paths.values():
        t, j = trf.FileRun(path), jrf.FileRun(path)
        assert t.num_partitions == j.num_partitions
        assert t.nbytes == j.nbytes
        assert t.empty_partition_flags() == j.empty_partition_flags()
        for p in range(t.num_partitions):
            assert t.partition_row_count(p) == j.partition_row_count(p)
            assert t.partition_nbytes(p) == j.partition_nbytes(p)
            assert [b.num_records for b in t.iter_partition_blocks(p)] == \
                [b.num_records for b in j.iter_partition_blocks(p)]
            assert list(t.partition(p).iter_pairs()) == \
                list(j.partition(p).iter_pairs())
        _same_arrays(_run_arrays(t.to_run()), _run_arrays(j.to_run()))


@pytest.mark.parametrize("pkg", list(PKGS))
def test_partitioned_writer_order_error_and_abort(tmp_path, pkg):
    rf, _f = PKGS[pkg]
    w = rf.PartitionedRunWriter(str(tmp_path / "x.prun"), 3)
    w.append(rf.KVBatch.from_pairs([(b"a", b"1")]), 2)
    with pytest.raises(ValueError,
                       match="partition-major order violated: 1 after 2"):
        w.append(rf.KVBatch.from_pairs([(b"b", b"2")]), 1)
    w.abort()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("codec", [None, "zlib"])
def test_chunked_run_matches_tez_tpu(tmp_path, codec):
    pairs = sorted(_pairs(12, 700))
    paths = {}
    for name, (rf, _f) in PKGS.items():
        w = rf.ChunkedRunWriter(str(tmp_path / f"{name}.crun"), codec=codec,
                                block_records=64)
        w.append(_batch(rf, pairs[:300]))
        w.append(_batch(rf, pairs[300:]))
        paths[name] = w.close()
        assert (w.blocks, w.records) == (12, 700)
    assert open(paths["port"], "rb").read() == \
        open(paths["tez_tpu"], "rb").read()
    for path in paths.values():
        t = list(trf.iter_chunked_run(path))
        j = list(jrf.iter_chunked_run(path))
        assert [b.num_records for b in t] == [b.num_records for b in j]
        assert [kv for b in t for kv in b.iter_pairs()] == pairs


# -- iter_merged_blocks -------------------------------------------------------
def _merge_sources(case):
    """Sorted pair lists of tests/test_block_merge.py's cases."""
    if case == "random":
        rng = np.random.default_rng(0)
        sources = []
        for s in range(5):
            n = int(rng.integers(50, 400))
            keys = sorted(f"k{rng.integers(0, 120):04d}" for _ in range(n))
            sources.append([(k.encode(), f"s{s}r{i}".encode())
                            for i, k in enumerate(keys)])
        return sources, 37
    if case == "tie across blocks":
        s0 = [(b"kAA", f"a{i}".encode()) for i in range(3)] + \
             [(b"kEQ", f"x{i}".encode()) for i in range(10)]
        s1 = [(b"kEQ", f"y{i}".encode()) for i in range(4)] + [(b"kZZ", b"z")]
        return [s0, s1], 4
    if case == "single":
        return [[(f"k{i:03d}".encode(), b"v") for i in range(100)]], 7
    if case == "empty":
        return [], 4
    return [[], [(b"a", b"1")], []], 4      # tiny


def _merged(block_merge, rf, sources, block, **kw):
    """(concatenated pairs, block sizes) of one merge."""
    blocks = list(block_merge.iter_merged_blocks(
        [iter([_batch(rf, src[i:i + block])
               for i in range(0, len(src), block)]) for src in sources],
        key_width=16, **kw))
    return ([kv for b in blocks for kv in b.iter_pairs()],
            [b.num_records for b in blocks])


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("case", ["random", "tie across blocks", "single",
                                  "empty", "tiny"])
def test_block_merge_matches_tez_tpu(case, engine):
    sources, block = _merge_sources(case)
    got = _merged(tblock, trf, sources, block, engine=engine,
                  device_min_records=0, device="cpu")
    want = _merged(jblock, jrf, sources, block, engine=engine,
                   device_min_records=0)
    assert got == want
    assert got[0] == list(__import__("heapq").merge(
        *sources, key=lambda kv: kv[0]))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_block_merge_refuses_a_key_normalizer(engine):
    """The key normalizer is ported (the name is kept): the block merge
    orders by normalized keys, across blocks, as tez_tpu's does."""
    assert list(tblock.iter_merged_blocks([iter([])], 16,
                                          key_normalizer=bytes.upper,
                                          device="cpu")) == []
    sources, block = _merge_sources("random")
    # the same keys in mixed case, sorted by their upper-case form
    sources = [sorted(((k.upper() if (i + s) % 2 else k, v)
                       for i, (k, v) in enumerate(src)),
                      key=lambda kv: kv[0].upper())
               for s, src in enumerate(sources)]
    got = _merged(tblock, trf, sources, block, engine=engine,
                  key_normalizer=bytes.upper, device_min_records=0,
                  device="cpu")
    want = _merged(jblock, jrf, sources, block, engine=engine,
                   key_normalizer=bytes.upper, device_min_records=0)
    assert got == want
    assert got[0] == list(__import__("heapq").merge(
        *sources, key=lambda kv: kv[0].upper()))


def _resident_runs(pkg_sorter, rf, pairs_list, **kw):
    """One flushed single-span run a producer, device-sorted so it keeps
    its resident key columns."""
    runs = []
    for pairs in pairs_list:
        s = pkg_sorter.DeviceSorter(num_partitions=2, key_width=16,
                                    engine="device", device_min_records=0,
                                    **kw)
        s.write_batch(_batch(rf, pairs))
        runs.append(s.flush())
    return runs


@pytest.mark.parametrize("mix", ["resident and file", "all resident"])
def test_block_merge_of_resident_and_file_sources(tmp_path, monkeypatch, mix):
    """Sources as the streamed final merge makes them: a resident run's
    partition (one block, a view of its device key columns at an offset)
    beside a spilled run's blocks, or resident runs only; the port's
    rounds take the resident merge exactly when every piece is resident,
    and the bytes equal tez_tpu's."""
    from tez_tpu_torch.ops import device as dev_ops
    pairs_list = [_pairs(20 + i, 900, max_key=6) for i in range(3)]
    truns = _resident_runs(tsorter, trf, pairs_list, device="cpu")
    jruns = _resident_runs(jsorter, jrf, pairs_list)
    assert all(r.batch.dev_keys is not None for r in truns + jruns)
    seen = []
    real = dev_ops.merge_resident_slices

    def spy(slices, *a, **kw):
        seen.append([lo for (_l, _n, lo, _hi) in slices])
        return real(slices, *a, **kw)

    monkeypatch.setattr(dev_ops, "merge_resident_slices", spy)
    for p in range(2):
        srcs = {}
        for name, (rf, _f), runs in (("port", PKGS["port"], truns),
                                     ("tez_tpu", PKGS["tez_tpu"], jruns)):
            srcs[name] = [iter([r.partition(p)]) for r in runs]
            if mix == "resident and file":
                path = rf.save_run_partitioned(
                    runs[1], str(tmp_path / f"{name}{p}.prun"),
                    block_records=50)
                srcs[name][1] = rf.FileRun(path).iter_partition_blocks(p)
        got = [b for b in tblock.iter_merged_blocks(
            srcs["port"], 16, engine="device", device_min_records=0,
            device="cpu")]
        want = [b for b in jblock.iter_merged_blocks(
            srcs["tez_tpu"], 16, engine="device", device_min_records=0)]
        assert [b.num_records for b in got] == [b.num_records for b in want]
        _same_arrays(_run_arrays(trf.Run(trf.KVBatch.concat(got),
                                         np.zeros(2, np.int64))),
                     _run_arrays(jrf.Run(jrf.KVBatch.concat(want),
                                         np.zeros(2, np.int64))))
    if mix == "all resident":
        # partition 1's views start past partition 0's rows
        assert seen and any(lo > 0 for los in seen for lo in los)
    else:
        assert seen == []


# -- DeviceSorter's spill path ------------------------------------------------
SPILL_SETUPS = {
    "sync": {},
    "sortmaster": {"sort_threads": 1},
    "async": {"pipeline_depth": 2},
    "async combiner": {"pipeline_depth": 2, "combiner": "sum"},
    "zlib": {"spill_codec": "zlib"},
}
SPILL_COUNTERS = ("SPILLED_RECORDS", "ADDITIONAL_SPILL_COUNT",
                  "ADDITIONAL_SPILLS_BYTES_WRITTEN",
                  "ADDITIONAL_SPILLS_BYTES_READ", "HOST_SPILL_BYTES",
                  "MERGED_MAP_OUTPUTS")


def _spill_batches(rf, seed=30, spans=8):
    """Spans of 1-6 byte keys over a small alphabet (ties across spans)
    with 8-byte long values, so sum_long_combiner applies."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(spans):
        n = 700
        pairs = [(bytes(rng.integers(97, 101, int(rng.integers(1, 7)))
                        .astype(np.uint8)),
                  (int(rng.integers(-5, 50)) + (1 << 63)).to_bytes(8, "big"))
                 for _ in range(n)]
        out.append(_batch(rf, pairs))
    return out


def _spilling_sorters(tmp_path, setup, **extra):
    """The same batches through both packages' spilling sorters; returns
    {package: (sorter, spill dir, span files written)}."""
    opts = dict(SPILL_SETUPS[setup])
    comb = opts.pop("combiner", None)
    out = {}
    for name, pkg, rf in (("port", tsorter, trf), ("tez_tpu", jsorter, jrf)):
        spill_dir = str(tmp_path / name)
        os.makedirs(spill_dir)
        kw = dict(opts, **extra)
        if name == "port":
            kw["device"] = "cpu"
        s = pkg.DeviceSorter(
            num_partitions=3, key_width=16, span_budget_bytes=20_000,
            spill_dir=spill_dir, mem_budget_bytes=45_000, engine="device",
            device_min_records=0,
            combiner=pkg.sum_long_combiner if comb else None, **kw)
        for b in _spill_batches(rf):
            s.write_batch(b)
        out[name] = (s, spill_dir)
    return out


def _counter_values(name, s):
    enum = TCounter if name == "port" else JCounter
    return {c: s.counters.find_counter(getattr(enum, c)).value
            for c in SPILL_COUNTERS}


@pytest.mark.parametrize("setup", list(SPILL_SETUPS))
def test_spilling_sorter_matches_tez_tpu(tmp_path, monkeypatch, setup):
    """flush_run returns a FileRun whose file, partitions and spill
    counters equal tez_tpu's; the span files are byte-identical too.

    Runs are stored as they complete, so which spans spill follows the
    completion order; on the async plane, where two readback workers may
    finish spans out of order, both packages get one readback worker, so
    spans complete in spill order in both.  (The merged result does not
    depend on the order: test_spilling_sorter_flush_matches_tez_tpu keeps
    two workers.)"""
    from tez_tpu.ops import async_stage as jasync
    from tez_tpu_torch.ops import async_stage as tasync
    for mod in (tasync, jasync):
        def one_readback_worker(self, *a, _real=mod.AsyncSpanPipeline.__init__,
                                **kw):
            _real(self, *a, **dict(kw, readback_workers=1))

        monkeypatch.setattr(mod.AsyncSpanPipeline, "__init__",
                            one_readback_worker)
    written = {"port": [], "tez_tpu": []}
    for name, mod in (("port", tsorter), ("tez_tpu", jsorter)):
        real = mod.save_run_partitioned

        def saving(run, path, _real=real, _name=name, **kw):
            out = _real(run, path, **kw)
            written[_name].append(open(path, "rb").read())
            return out

        monkeypatch.setattr(mod, "save_run_partitioned", saving)
    sorters = _spilling_sorters(tmp_path, setup)
    results = {name: s.flush_run() for name, (s, _d) in sorters.items()}
    t, j = results["port"], results["tez_tpu"]
    assert isinstance(t, trf.FileRun) and isinstance(j, jrf.FileRun)
    assert sorted(written["port"]) == sorted(written["tez_tpu"])
    assert len(written["port"]) >= 2
    assert open(t.path, "rb").read() == open(j.path, "rb").read()
    for p in range(3):
        assert list(t.partition(p).iter_pairs()) == \
            list(j.partition(p).iter_pairs())
    counts = {name: _counter_values(name, s)
              for name, (s, _d) in sorters.items()}
    assert counts["port"] == counts["tez_tpu"]
    assert counts["port"]["ADDITIONAL_SPILL_COUNT"] == len(written["port"])
    # only the final file is left
    for name, (_s, spill_dir) in sorters.items():
        assert os.listdir(spill_dir) == [os.path.basename(results[name].path)]


@pytest.mark.parametrize("setup", ["sync", "async"])
def test_spilling_sorter_flush_matches_tez_tpu(tmp_path, setup):
    """flush() reads the FileRun back into one Run equal to tez_tpu's
    flush() and leaves no file behind."""
    sorters = _spilling_sorters(tmp_path, setup)
    runs = {name: s.flush() for name, (s, _d) in sorters.items()}
    _same_arrays(_run_arrays(runs["port"]), _run_arrays(runs["tez_tpu"]))
    for _s, spill_dir in sorters.values():
        assert os.listdir(spill_dir) == []


def test_spilled_runs_drop_their_device_columns(tmp_path, monkeypatch):
    """A run that goes to disk lets go of its resident key columns at
    once; the runs kept in RAM keep theirs."""
    stored = []
    real = tsorter.DeviceSorter._store_run

    def store(self, run):
        real(self, run)
        stored.append((isinstance(self._runs[-1], str),
                       run.batch.dev_keys is not None))

    monkeypatch.setattr(tsorter.DeviceSorter, "_store_run", store)
    s = _spilling_sorters(tmp_path, "async")["port"][0]
    s.flush_run()
    assert {spilled for spilled, _dev in stored} == {False, True}
    assert all(spilled != dev for spilled, dev in stored), stored


@pytest.mark.parametrize("pkg", ["port", "tez_tpu"])
@pytest.mark.parametrize("fault", ["write fail", "read fail",
                                   "read corrupt"])
def test_spill_faults(tmp_path, pkg, fault):
    """A spill.write failure at the flush's spill fails the flush; a
    spill.read failure or corruption fails the streamed merge with an
    IOError.  No temporary file is left behind, in either package."""
    spec = {"write fail": "spill.write:fail:n=1,exc=io",
            "read fail": "spill.read:fail:n=1,exc=io",
            "read corrupt": "spill.read:corrupt:n=1"}[fault]
    rf, faults = PKGS[pkg]
    s, spill_dir = _spilling_sorters(tmp_path, "sync")[pkg]
    # the trailing partial span spills inside the flush
    s.write_batch(_spill_batches(rf, seed=31, spans=1)[0].slice_rows(0, 400))
    faults.install("t", faults.parse_spec(spec))
    match = "checksum mismatch" if fault == "read corrupt" else "injected"
    with pytest.raises(IOError, match=match):
        s.flush_run()
    assert not [f for f in os.listdir(spill_dir) if f.endswith(".tmp")]
    assert not [f for f in os.listdir(spill_dir) if f.startswith("final_")]


# -- chip_smoke's phase 8 -----------------------------------------------------
def test_spill_phase_on_the_host():
    """chip_smoke's phase 8 at a small size with the plain versions: both
    producers' FileRuns equal their goldens, the spill counters equal the
    files, and the zlib leg equals its uncompressed twin."""
    launches = chip_smoke.spill_phase(
        types.SimpleNamespace(seed=1), device="cpu", producers=2,
        producer_mb=2, span_mb=1, vocab_size=5000, zlib_span_mb=0.5)
    assert launches == {"fnv_hash_bytes": 0, "fnv_hash_lanes": 0,
                        "merge_rank": 0, "merge_path_pair": 0}
