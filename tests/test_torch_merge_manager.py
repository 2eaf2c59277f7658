"""Port parity of the reduce side's bounded-memory merge
(tez_tpu_torch/library/merge_manager.py, ShuffleMergeManager) and of the
custom key normalizers it takes (library/comparators.py, and the
normalized-key paths of DeviceSorter, merge_sorted_runs and
iter_merged_blocks) against tez_tpu's, on the CPU.

Every case of tests/test_merge_manager.py and tests/test_merge_manager_
async.py runs here on both packages, the port on device="cpu": each keeps
its own assertions, and the two packages' merged records, counters (less
the millisecond ones), the files left in the spill directory and, where
the case has one, the overlap witness must be equal.  Where the original
commits race the background merger, a "paced" run waits for the merger to
go idle after each commit (ShuffleMergeManager.quiesce), so which batches
each merge takes is fixed and the counters and files compare exactly; the
unpaced run keeps the race and compares the records.  One case is left
out: test_e2e_wordcount_with_tiny_merge_budget runs an OrderedWordCount
DAG, which the port cannot run until it has inputs, outputs and an AM.
"""
import hashlib
import os
import threading
import time
import types

import numpy as np
import pytest

import chip_smoke
from tez_tpu.common import faults as jfaults
from tez_tpu.common.counters import TezCounters as JCounters
from tez_tpu.library import comparators as jcmp
from tez_tpu.library import merge_manager as jmm
from tez_tpu.ops import async_stage as jasync
from tez_tpu.ops import block_merge as jblock
from tez_tpu.ops import runformat as jrf
from tez_tpu.ops import sorter as jsorter
from tez_tpu_torch.common import faults as tfaults
from tez_tpu_torch.common.counters import TezCounters as TCounters
from tez_tpu_torch.library import comparators as tcmp
from tez_tpu_torch.library import merge_manager as tmm
from tez_tpu_torch.ops import async_stage as tasync
from tez_tpu_torch.ops import block_merge as tblock
from tez_tpu_torch.ops import runformat as trf
from tez_tpu_torch.ops import sorter as tsorter

PKGS = {
    "port": types.SimpleNamespace(mm=tmm, rf=trf, faults=tfaults,
                                  asyncs=tasync, counters=TCounters,
                                  sorter=tsorter, block=tblock, cmp=tcmp,
                                  kw={"device": "cpu"}),
    "tez_tpu": types.SimpleNamespace(mm=jmm, rf=jrf, faults=jfaults,
                                     asyncs=jasync, counters=JCounters,
                                     sorter=jsorter, block=jblock, cmp=jcmp,
                                     kw={}),
}


@pytest.fixture(autouse=True)
def _isolated_planes():
    """tests/conftest.py resets tez_tpu's fault plane and breaker only."""
    for pkg in PKGS.values():
        pkg.faults.clear_all()
        pkg.asyncs.reset_process_breaker()
    yield
    for pkg in PKGS.values():
        pkg.faults.clear_all()
        pkg.asyncs.reset_process_breaker()


# -- helpers ------------------------------------------------------------------
def sorted_pairs(seed, n, vlen=32):
    """tests/test_merge_manager.py's sorted_batch, as pairs."""
    rng = np.random.default_rng(seed)
    keys = sorted(f"k{rng.integers(0, 50_000):08d}".encode()
                  for _ in range(n))
    vals = [rng.integers(0, 256, vlen, dtype=np.uint8).tobytes()
            for _ in range(n)]
    return list(zip(keys, vals))


def reference_merge(pair_lists, key=None):
    """Golden: a stable sort of the slot-ordered concatenation."""
    pairs = [kv for pl in pair_lists for kv in pl]
    return sorted(pairs, key=lambda kv: kv[0] if key is None
                  else key(kv[0]))


def drain(mm):
    result = mm.finish()
    if result.is_streaming:
        return [(k, v) for _, k, v in result.stream.iter_records()]
    return list(result.batch.iter_pairs())


def manager(pkg, counters, budget, spill_dir, **kw):
    return pkg.mm.ShuffleMergeManager(counters, budget, str(spill_dir),
                                      **dict(kw, **pkg.kw))


def commit_all(mm, batches, paced, first_slot=0):
    for slot, b in enumerate(batches, first_slot):
        mm.commit(slot, b)
        if paced:
            assert mm.quiesce(timeout=120), "merger never went idle"


def counter_values(counters):
    """Every counter but the wall-time ones (milliseconds, latency
    histograms)."""
    return {g: {c: v for c, v in cs.items() if "MILLI" not in c}
            for g, cs in counters.to_dict().items()
            if not g.startswith("LatencyHistogram")}


def files_left(spill_dir):
    """Digests of the files in a spill directory (names are random)."""
    return sorted(hashlib.sha256(open(os.path.join(spill_dir, f), "rb")
                                 .read()).hexdigest()
                  for f in os.listdir(spill_dir))


def both(tmp_path, case, **kw):
    """Run `case(pkg, tmp_dir, **kw)` on both packages; returns
    {package: outcome}, each in its own directory."""
    out = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        out[name] = case(pkg, d, **kw)
    return out


def assert_same(out):
    assert out["port"] == out["tez_tpu"]


def wait_for(pred, what, timeout=30.0):
    deadline = time.time() + timeout
    while not pred():
        assert time.time() < deadline, what
        time.sleep(0.005)


# -- tests/test_merge_manager.py ----------------------------------------------
def _unbounded(pkg, d):
    counters = pkg.counters()
    mm = manager(pkg, counters, 0, d, engine="host")
    pls = [sorted_pairs(i, 500) for i in range(4)]
    commit_all(mm, [pkg.rf.KVBatch.from_pairs(p) for p in pls], False)
    got = drain(mm)
    assert got == reference_merge(pls)
    assert mm._mem_to_disk == 0
    return got, counter_values(counters), files_left(d)


def test_unbounded_budget_passthrough(tmp_path):
    assert_same(both(tmp_path, _unbounded))


def _forced_disk(pkg, d, paced):
    counters = pkg.counters()
    pls = [sorted_pairs(i, 2000) for i in range(8)]
    batches = [pkg.rf.KVBatch.from_pairs(p) for p in pls]
    budget = sum(b.nbytes for b in batches) // 5
    mm = manager(pkg, counters, budget, d, engine="host",
                 merge_threshold=0.5, max_single_fraction=2.0,
                 block_records=256)
    commit_all(mm, batches, paced)
    got = drain(mm)
    assert got == reference_merge(pls)
    assert mm.peak_mem_bytes <= budget
    assert mm._mem_to_disk >= 1
    c = counters.to_dict()["TaskCounter"]
    assert c["NUM_MEM_TO_DISK_MERGES"] >= 1 and c["SHUFFLE_BYTES_TO_MEM"] > 0
    if not paced:
        return got
    return got, counter_values(counters), files_left(d), mm.peak_mem_bytes


@pytest.mark.parametrize("paced", [False, True])
def test_budget_forces_disk_merges_and_bounds_memory(tmp_path, paced):
    assert_same(both(tmp_path, _forced_disk, paced=paced))


def _oversized(pkg, d):
    counters = pkg.counters()
    pairs = sorted_pairs(1, 4000)
    big = pkg.rf.KVBatch.from_pairs(pairs)
    mm = manager(pkg, counters, big.nbytes * 2, d, engine="host",
                 max_single_fraction=0.25, block_records=512)
    mm.commit(0, big)
    c = counters.to_dict()["TaskCounter"]
    assert c["SHUFFLE_BYTES_TO_DISK"] == big.nbytes
    got = drain(mm)
    assert got == reference_merge([pairs])
    return got, counter_values(counters), files_left(d)


def test_oversized_batch_goes_straight_to_disk(tmp_path):
    out = both(tmp_path, _oversized)
    assert_same(out)
    assert len(out["port"][2]) == 1        # the DISK run, until cleanup


def _cascade(pkg, d, paced):
    counters = pkg.counters()
    pls = [sorted_pairs(i, 800) for i in range(6)]
    mm = manager(pkg, counters, 10 * 1024 * 1024, d, engine="host",
                 merge_factor=2, max_single_fraction=0.0001,
                 block_records=128)
    commit_all(mm, [pkg.rf.KVBatch.from_pairs(p) for p in pls], paced)
    assert mm.quiesce(timeout=120), "background merger never quiesced"
    assert mm._disk_to_disk >= 1
    assert counters.to_dict()["TaskCounter"]["NUM_DISK_TO_DISK_MERGES"] >= 1
    got = drain(mm)
    assert got == reference_merge(pls)
    if not paced:
        return got
    return got, counter_values(counters), files_left(d)


@pytest.mark.parametrize("paced", [False, True])
def test_disk_to_disk_cascade(tmp_path, paced):
    assert_same(both(tmp_path, _cascade, paced=paced))


def _slot_reset_in_memory(pkg, d):
    counters = pkg.counters()
    keep, drop = sorted_pairs(0, 300), sorted_pairs(1, 300)
    mm = manager(pkg, counters, 0, d, engine="host")
    mm.commit(0, pkg.rf.KVBatch.from_pairs(keep))
    dropped_batch = pkg.rf.KVBatch.from_pairs(drop)
    mm.commit(1, dropped_batch)
    dropped = mm.on_slot_reset(1)
    assert dropped and dropped[0] is dropped_batch
    got = drain(mm)
    assert got == reference_merge([keep])
    return got, counter_values(counters)


def test_slot_reset_in_memory_discards(tmp_path):
    assert_same(both(tmp_path, _slot_reset_in_memory))


def _slot_reset_poisons(pkg, d):
    counters = pkg.counters()
    big = pkg.rf.KVBatch.from_pairs(sorted_pairs(0, 2000))
    mm = manager(pkg, counters, big.nbytes * 2, d, engine="host",
                 max_single_fraction=0.1)
    mm.commit(3, big)          # oversized -> disk
    mm.on_slot_reset(3)        # data already on disk: unrecoverable
    with pytest.raises(RuntimeError, match="merge state lost") as e:
        mm.commit(0, pkg.rf.KVBatch.from_pairs(sorted_pairs(1, 10)))
    mm.cleanup()
    return str(e.value), counter_values(counters), files_left(d)


def test_slot_reset_after_disk_merge_poisons(tmp_path):
    assert_same(both(tmp_path, _slot_reset_poisons))


def _reiterable(pkg, d):
    counters = pkg.counters()
    pls = [sorted_pairs(i, 1000) for i in range(4)]
    mm = manager(pkg, counters, 10 * 1024 * 1024, d, engine="host",
                 max_single_fraction=0.0001, block_records=128)
    commit_all(mm, [pkg.rf.KVBatch.from_pairs(p) for p in pls], False)
    result = mm.finish()
    assert result.is_streaming
    first = [(k, v) for _, k, v in result.stream.iter_records()]
    second = [(k, v) for _, k, v in result.stream.iter_records()]
    assert first == second == reference_merge(pls)
    blocks = [b.num_records for b in result.stream.iter_batches()]
    return first, blocks, counter_values(counters), files_left(d)


def test_streaming_plan_is_reiterable(tmp_path):
    assert_same(both(tmp_path, _reiterable))


def _below_threshold(pkg, d):
    counters = pkg.counters()
    p0, p1 = sorted_pairs(0, 900), sorted_pairs(1, 500)
    b0 = pkg.rf.KVBatch.from_pairs(p0)
    mm = manager(pkg, counters, int(b0.nbytes * 1.25), d, engine="host",
                 merge_threshold=0.9, max_single_fraction=0.5,
                 block_records=128)
    mm.commit(0, b0)                       # ~80% of budget: below threshold
    done = threading.Event()
    t = threading.Thread(
        target=lambda: (mm.commit(1, pkg.rf.KVBatch.from_pairs(p1)),
                        done.set()), daemon=True)
    t.start()
    assert done.wait(20), "commit deadlocked below merge threshold"
    got = drain(mm)
    assert got == reference_merge([p0, p1])
    return got, counter_values(counters), files_left(d)


def test_commit_below_threshold_does_not_deadlock(tmp_path):
    assert_same(both(tmp_path, _below_threshold))


def _stale_generation(pkg, d):
    counters = pkg.counters()
    mm = manager(pkg, counters, 0, d, engine="host")
    stale = pkg.rf.KVBatch.from_pairs(sorted_pairs(0, 200))
    fresh_pairs = sorted_pairs(1, 200)
    gen = mm.slot_generation(2)
    mm.on_slot_reset(2)                      # producer re-ran mid-fetch
    assert mm.commit(2, pkg.rf.KVBatch.from_pairs(fresh_pairs),
                     mm.slot_generation(2)) is True
    assert mm.commit(2, stale, gen) is False   # late stale commit dropped
    got = drain(mm)
    assert got == reference_merge([fresh_pairs])
    return got, counter_values(counters)


def test_stale_generation_commit_dropped(tmp_path):
    assert_same(both(tmp_path, _stale_generation))


def _file_source_run(pkg, d, name, pair_lists):
    """One partition-indexed file, partition p = pair_lists[p]."""
    w = pkg.rf.PartitionedRunWriter(os.path.join(str(d), name),
                                    len(pair_lists), block_records=64)
    for p, pl in enumerate(pair_lists):
        w.append(pkg.rf.KVBatch.from_pairs(pl), p)
    return w.close()


def _disk_direct(pkg, d):
    counters = pkg.counters()
    spill = d / "consumer"
    spill.mkdir()
    mm = manager(pkg, counters, 1, spill, engine="host", merge_threshold=1.0,
                 block_records=64)
    p0 = _file_source_run(pkg, d, "prod0.prun",
                          [sorted_pairs(0, 700), sorted_pairs(1, 10)])
    p1 = _file_source_run(pkg, d, "prod1.prun",
                          [sorted_pairs(2, 650), sorted_pairs(3, 10)])
    for slot, p in enumerate((p0, p1)):
        assert mm.commit_local_file(slot, p, 0,
                                    pkg.rf.FileRun(p).partition_nbytes(0))
    golden = reference_merge([sorted_pairs(0, 700), sorted_pairs(2, 650)])
    result = mm.finish()
    assert result.is_streaming
    got = [(k, v) for _, k, v in result.stream.iter_records()]
    assert got == golden
    assert [(k, v) for _, k, v in result.stream.iter_records()] == golden
    assert not any(f.endswith(".crun") for f in os.listdir(spill))
    mm.cleanup()
    assert os.path.exists(p0) and os.path.exists(p1)
    return got, counter_values(counters), files_left(spill)


def test_disk_direct_sources_stream_without_copy(tmp_path):
    assert_same(both(tmp_path, _disk_direct))


def _disk_direct_small(pkg, d):
    counters = pkg.counters()
    mm = manager(pkg, counters, 64 << 20, d, engine="host")
    path = _file_source_run(pkg, d, "prod.prun", [sorted_pairs(5, 300)])
    mem = sorted_pairs(6, 300)
    mm.commit(1, pkg.rf.KVBatch.from_pairs(mem))
    assert mm.commit_local_file(0, path, 0,
                                pkg.rf.FileRun(path).partition_nbytes(0))
    result = mm.finish()
    assert not result.is_streaming
    got = list(result.batch.iter_pairs())
    assert got == reference_merge([sorted_pairs(5, 300), mem])
    return got, counter_values(counters)


def test_disk_direct_small_inputs_materialize(tmp_path):
    assert_same(both(tmp_path, _disk_direct_small))


def _disk_direct_reset(pkg, d):
    counters = pkg.counters()
    mm = manager(pkg, counters, 0, d, engine="host")
    stale = _file_source_run(pkg, d, "stale.prun", [sorted_pairs(7, 100)])
    fresh = sorted_pairs(8, 100)
    gen = mm.slot_generation(0)
    assert mm.commit_local_file(0, stale, 0, 4096, gen)
    mm.on_slot_reset(0)
    assert mm.commit_local_file(0, stale, 0, 4096, gen) is False
    mm.commit(0, pkg.rf.KVBatch.from_pairs(fresh), mm.slot_generation(0))
    got = drain(mm)
    assert got == reference_merge([fresh])
    return got, counter_values(counters)


def test_disk_direct_slot_reset_drops_source(tmp_path):
    assert_same(both(tmp_path, _disk_direct_reset))


# -- tests/test_merge_manager_async.py ----------------------------------------
def _run_manager(pkg, d, pls, async_depth, paced, engine="host",
                 budget=None, merge_threshold=0.5, **kw):
    counters = pkg.counters()
    batches = [pkg.rf.KVBatch.from_pairs(p) for p in pls]
    total = sum(b.nbytes for b in batches)
    spill = d / f"spill_{async_depth}"
    spill.mkdir()
    mm = manager(pkg, counters, total // 4 if budget is None else budget,
                 spill, engine=engine, merge_threshold=merge_threshold,
                 max_single_fraction=2.0, block_records=256,
                 async_depth=async_depth, device_min_records=0, **kw)
    commit_all(mm, batches, paced)
    got = drain(mm)
    if mm._pipeline is not None:
        # a dispatch abandoned by the watchdog sleeps out its hang: no
        # thread outlives the case
        mm._pipeline._staging.join(timeout=60)
    return mm, got, counter_values(counters), files_left(spill)


def _async_vs_sync(pkg, d, engine, paced):
    pls = [sorted_pairs(i, 1500) for i in range(8)]
    _, sync, sc, sf = _run_manager(pkg, d, pls, 0, paced, engine=engine)
    mm, got, ac, af = _run_manager(pkg, d, pls, 2, paced, engine=engine)
    assert mm._mem_to_disk >= 1        # the async lane actually merged
    assert got == sync == reference_merge(pls)
    if not paced:
        return got
    assert (ac, af) == (sc, sf)        # paced: the lanes merge the same
    return got, ac, af


@pytest.mark.parametrize("paced", [False, True])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_async_matches_sync_bit_exact(tmp_path, engine, paced):
    assert_same(both(tmp_path, _async_vs_sync, engine=engine, paced=paced))


def _async_cascade(pkg, d, paced):
    pls = [sorted_pairs(i, 600) for i in range(6)]

    def run(tag, depth):
        spill = d / f"spill_{tag}"
        spill.mkdir()
        counters = pkg.counters()
        mm = manager(pkg, counters, 10 << 20, spill, engine="host",
                     merge_factor=2, max_single_fraction=0.0001,
                     block_records=128, async_depth=depth)
        commit_all(mm, [pkg.rf.KVBatch.from_pairs(p) for p in pls], paced)
        wait_for(lambda: mm._disk_to_disk >= 1,
                 f"{tag}: disk cascade never ran")
        return mm, drain(mm), counter_values(counters), files_left(spill)

    _, sync, sc, sf = run("sync", 0)
    mm, got, ac, af = run("async", 2)
    assert mm._disk_to_disk >= 1
    assert got == sync == reference_merge(pls)
    if not paced:
        return got
    assert (ac, af) == (sc, sf)
    return got, ac, af


@pytest.mark.parametrize("paced", [False, True])
def test_async_disk_cascade_matches_sync(tmp_path, paced):
    assert_same(both(tmp_path, _async_cascade, paced=paced))


def _gated_manager_cls(pkg):
    """tests/test_merge_manager_async.py's _GatedManager over `pkg`: merge
    0's disk write (readback stage) waits until a later merge's dispatch
    has started."""
    class Gated(pkg.mm.ShuffleMergeManager):
        def __init__(self, *a, **kw):
            self.later_dispatched = threading.Event()
            self.dispatch_count = 0
            super().__init__(*a, **kw)

        def _pipe_dispatch(self, payload):
            out = super()._pipe_dispatch(payload)
            self.dispatch_count += 1
            if self.dispatch_count >= 2:
                self.later_dispatched.set()
            return out

        def _pipe_readback(self, inflight, ids):
            if ids == (0,):
                assert self.later_dispatched.wait(timeout=30.0), \
                    "merge 1 never dispatched while merge 0's write was held"
            return super()._pipe_readback(inflight, ids)
    return Gated


def _overlap(pkg, d):
    pls = [sorted_pairs(i, 1200) for i in range(10)]
    batches = [pkg.rf.KVBatch.from_pairs(p) for p in pls]
    total = sum(b.nbytes for b in batches)
    counters = pkg.counters()
    mm = _gated_manager_cls(pkg)(
        counters, total * 4, str(d), engine="host", merge_threshold=0.02,
        max_single_fraction=2.0, block_records=256, async_depth=2,
        device_min_records=0, instrument=True, **pkg.kw)
    commit_all(mm, batches[:5], False)
    wait_for(lambda: mm.dispatch_count >= 1, "merge 0 never dispatched")
    commit_all(mm, batches[5:], False, first_slot=5)
    wait_for(lambda: mm.dispatch_count >= 2, "merge 1 never dispatched")
    got = drain(mm)
    assert mm.dispatch_count >= 2
    assert got == reference_merge(pls)
    pairs = pkg.asyncs.overlap_pairs(mm.pipeline_events())
    witnessed = any(a == (0,) for a, _b in pairs)
    assert witnessed, f"no overlap witnessed: {mm.pipeline_events()}"
    return got, witnessed


def test_async_overlap_witness(tmp_path):
    assert_same(both(tmp_path, _overlap))


def _chaos(pkg, d, spec, paced, budget_div=4, breaker_kw=None, **kw):
    pls = [sorted_pairs(i, 1500) for i in range(8)]
    sync_run = _run_manager(pkg, d / "sync", pls, 0, paced,
                            engine="device",
                            budget=None if budget_div == 4 else
                            sum(pkg.rf.KVBatch.from_pairs(p).nbytes
                                for p in pls) // budget_div)
    br = pkg.asyncs.CircuitBreaker(**(breaker_kw or {"failures": 100}))
    pkg.faults.install("t", pkg.faults.parse_spec(spec))
    try:
        mm, got, counters, files = _run_manager(
            pkg, d / "fault", pls, 2, paced, engine="device",
            budget=sync_run[0].budget, breaker=br, **kw)
    finally:
        pkg.faults.install("t", [])
    assert got == sync_run[1] == reference_merge(pls)
    fo = counters.get(pkg.asyncs.COUNTER_GROUP, {})
    if paced:
        assert (counters["TaskCounter"], files) == \
            (sync_run[2]["TaskCounter"], sync_run[3])
    return got, fo, br.trips


@pytest.mark.parametrize("paced", [False, True])
def test_async_oom_split_ladder_bit_exact(tmp_path, paced):
    for name in PKGS:
        (tmp_path / name / "sync").mkdir(parents=True)
        (tmp_path / name / "fault").mkdir()
    out = {name: _chaos(pkg, tmp_path / name,
                        "device.dispatch.oom:fail:n=1,exc=runtime,"
                        "match=span=0", paced, budget_div=2)
           for name, pkg in PKGS.items()}
    assert_same(out)
    _got, fo, trips = out["port"]
    assert fo.get("device.oom.split_attempts") == 1
    assert fo.get("device.oom.split_success") == 1
    assert trips == 0


@pytest.mark.parametrize("paced", [False, True])
def test_async_hang_watchdog_failover_bit_exact(tmp_path, paced):
    for name in PKGS:
        (tmp_path / name / "sync").mkdir(parents=True)
        (tmp_path / name / "fault").mkdir()
    out = {name: _chaos(pkg, tmp_path / name,
                        "device.dispatch.hang:delay:ms=1500,n=1,"
                        "match=span=0", paced,
                        watchdog_dispatch_ms=200, watchdog_readback_ms=200)
           for name, pkg in PKGS.items()}
    for name in PKGS:
        _got, fo, trips = out[name]
        assert fo.get("device.watchdog.fires", 0) >= 1
        assert fo.get("device.failover.spans", 0) >= 1
        assert trips == 0
    assert out["port"][0] == out["tez_tpu"][0]
    if paced:
        assert_same(out)


def _breaker_storm(pkg, d):
    pls = [sorted_pairs(i, 900) for i in range(4)]
    _, sync, _sc, _sf = _run_manager(pkg, d, pls, 0, True, engine="device")
    br = pkg.asyncs.CircuitBreaker(failures=1, cooldown_ms=60_000)
    pkg.faults.install("t", pkg.faults.parse_spec(
        "device.dispatch.oom:fail:n=99,exc=runtime"))
    try:
        spill = d / "spill_storm"
        spill.mkdir()
        counters = pkg.counters()
        batches = [pkg.rf.KVBatch.from_pairs(p) for p in pls]
        total = sum(b.nbytes for b in batches)
        mm = manager(pkg, counters, total * 4, spill, engine="device",
                     device_min_records=0, merge_threshold=0.02,
                     max_single_fraction=2.0, block_records=256,
                     async_depth=2, breaker=br)
        for slot, b in enumerate(batches):
            mm.commit(slot, b)
            wait_for(lambda: mm._pipe_seq >= slot + 1,
                     f"merge {slot} never claimed")
            # one merge at a time: the next claim holds one batch again
            assert mm.quiesce(timeout=120)
        got = drain(mm)
    finally:
        pkg.faults.install("t", [])
    assert got == sync == reference_merge(pls)
    assert br.trips >= 1
    fo = counter_values(counters)[pkg.asyncs.COUNTER_GROUP]
    assert fo["device.breaker.short_circuits"] >= 1
    assert fo["device.failover.spans"] >= 2
    return got, fo, br.trips, files_left(spill)


def test_async_breaker_short_circuit_bit_exact(tmp_path):
    assert_same(both(tmp_path, _breaker_storm))


def _depth_zero(pkg, d):
    counters = pkg.counters()
    mm = manager(pkg, counters, 1 << 20, d, engine="host", async_depth=0)
    assert mm._pipeline is None
    assert mm.pipeline_events() == []
    pairs = sorted_pairs(0, 50)
    mm.commit(0, pkg.rf.KVBatch.from_pairs(pairs))
    got = drain(mm)
    assert got == reference_merge([pairs])
    return got, counter_values(counters)


def test_async_depth_zero_has_no_pipeline(tmp_path):
    assert_same(both(tmp_path, _depth_zero))


def test_stalled_fetchers_wake_the_merger_once(tmp_path, monkeypatch):
    """16 fetch threads (more than cores) against a budget of three
    batches while each merge takes 0.3 s, the interpreter switching
    threads every 10 us: every commit lands, the output is the golden,
    memory stays within the budget plus one batch, and the stalled
    fetchers do not wake each other without end (tez_tpu's commit
    notifies every waiter on each wake-up: thousands of notifications in
    such a stall, against about one a stall here)."""
    import sys
    notified = []

    class Counting:
        """The manager's condition, counting notify_all by thread."""

        def __init__(self):
            self._cv = threading.Condition()

        def __enter__(self):
            return self._cv.__enter__()

        def __exit__(self, *exc):
            return self._cv.__exit__(*exc)

        def __getattr__(self, name):
            return getattr(self._cv, name)

        def notify_all(self):
            notified.append(threading.current_thread().name)
            self._cv.notify_all()

    monkeypatch.setattr(tmm, "threading", types.SimpleNamespace(
        Condition=Counting, Thread=threading.Thread))
    pls = [sorted_pairs(100 + i, 300) for i in range(48)]
    batches = [trf.KVBatch.from_pairs(p) for p in pls]
    counters = TCounters()
    mm = manager(PKGS["port"], counters, 3 * max(b.nbytes for b in batches),
                 tmp_path, engine="host", merge_threshold=0.9,
                 max_single_fraction=1.0, block_records=128)
    monkeypatch.setattr(tmm, "threading", threading)
    slow = mm._merge_mem_items

    def slow_merge(items, engine=None):
        time.sleep(0.3)
        return slow(items, engine)

    mm._merge_mem_items = slow_merge
    work = list(enumerate(batches))
    lock = threading.Lock()

    def fetch():
        while True:
            with lock:
                if not work:
                    return
                slot, b = work.pop()
            assert mm.commit(slot, b)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=fetch, name=f"fetch-{i}")
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not work
    stalls_notified = sum(n.startswith("fetch-") for n in notified)
    merges = mm._mem_to_disk
    got = drain(mm)
    assert sorted(got) == sorted(reference_merge(pls))
    assert [k for k, _v in got] == sorted(k for k, _v in got)
    assert mm.peak_mem_bytes <= mm.budget + max(b.nbytes for b in batches)
    assert merges >= 5
    # a fetcher notifies when it stalls and when its commit crosses the
    # merge threshold: a few a merge, never a storm
    assert stalls_notified <= 4 * 16 * (merges + 1), (stalls_notified,
                                                      merges)


def test_manager_signature_matches_tez_tpu():
    """tez_tpu's parameters in tez_tpu's order, then the port's device."""
    import inspect
    j = list(inspect.signature(jmm.ShuffleMergeManager.__init__)
             .parameters.values())
    t = list(inspect.signature(tmm.ShuffleMergeManager.__init__)
             .parameters.values())
    assert [(p.name, p.kind, p.default) for p in t[:-1]] == \
        [(p.name, p.kind, p.default) for p in j]
    assert (t[-1].name, t[-1].default) == ("device", "cuda")


# -- custom key normalizers ---------------------------------------------------
def _mixed_case_pairs(seed, n, max_key=6, value=None):
    """Keys over a few letters in both cases (so normalized keys collide)
    with 8-byte long values (record index by default)."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcABC", np.uint8)
    out = []
    for i in range(n):
        k = letters[rng.integers(0, 6, int(rng.integers(1, max_key + 1)))]
        v = i if value is None else value
        out.append((k.tobytes(), (v + (1 << 63)).to_bytes(8, "big")))
    return out


NORMALIZERS = {"case-insensitive": "CaseInsensitiveKeyComparator",
               "reverse-byte": "ReverseByteKeyComparator"}


def _norm(pkg, which):
    return getattr(pkg.cmp, NORMALIZERS[which])().normalize


def _run_tuple(run):
    b = run.batch
    return (b.key_bytes.tobytes(), b.key_offsets.tobytes(),
            b.val_bytes.tobytes(), b.val_offsets.tobytes(),
            run.row_index.tobytes())


@pytest.mark.parametrize("conf,payload,want", [
    ({}, None, None),
    ({"tez.runtime.key.comparator.class":
      "{pkg}.library.comparators:CaseInsensitiveKeyComparator"}, None,
     "case-insensitive"),
    ({"tez.runtime.key.comparator.class":
      "{pkg}.library.comparators:CaseInsensitiveKeyComparator"},
     {"tez.runtime.key.comparator.class":
      "{pkg}.library.comparators:ReverseByteKeyComparator"},
     "reverse-byte"),
])
def test_load_comparator_matches_tez_tpu(conf, payload, want):
    """The comparator class from the task conf, the IO payload overriding
    it, or none; each package resolves its own class names."""
    keys = [b"", b"a", b"B", b"ab", b"Ab", b"\x00\xff", b"zZ"]
    got = {}
    for name, pkg in PKGS.items():
        mod = "tez_tpu_torch" if name == "port" else "tez_tpu"

        def fill(d):
            return None if d is None else \
                {k: v.format(pkg=mod) for k, v in d.items()}
        ctx = types.SimpleNamespace(
            conf=fill(conf), user_payload=types.SimpleNamespace(
                load=lambda p=fill(payload): p))
        norm = pkg.cmp.load_comparator(ctx)
        got[name] = None if norm is None else [norm(k) for k in keys]
        if want is not None:
            assert norm.__self__.__class__.__module__ == \
                f"{mod}.library.comparators"
    assert got["port"] == got["tez_tpu"]
    if want is None:
        assert got["port"] is None
    else:
        assert got["port"] == [_norm(PKGS["tez_tpu"], want)(k) for k in keys]


def test_key_comparator_spi_raises():
    with pytest.raises(NotImplementedError):
        tcmp.KeyComparator().normalize(b"a")


@pytest.mark.parametrize("which", list(NORMALIZERS))
def test_normalize_batch_keys_matches_tez_tpu(which):
    pairs = _mixed_case_pairs(3, 500, max_key=9) + [(b"", b"v")]
    t = tsorter.normalize_batch_keys(trf.KVBatch.from_pairs(pairs),
                                     _norm(PKGS["port"], which))
    j = jsorter.normalize_batch_keys(jrf.KVBatch.from_pairs(pairs),
                                     _norm(PKGS["tez_tpu"], which))
    for x, y in zip(t, j):
        np.testing.assert_array_equal(x, y)
    # a normalizer may lengthen keys
    t = tsorter.normalize_batch_keys(trf.KVBatch.from_pairs(pairs),
                                     lambda k: k * 3)
    assert t[1][-1] == 3 * sum(len(k) for k, _v in pairs)


SORTER_SETUPS = {
    "sync": {},
    "sync host": {"engine": "host"},
    "async": {"pipeline_depth": 2},
    "sortmaster": {"sort_threads": 1},
    "spilling": {"spill": True},
    "async spilling": {"pipeline_depth": 2, "spill": True},
    "async spilling combiner": {"pipeline_depth": 2, "spill": True,
                                "combiner": True},
}


def _normalized_sorter(pkg, d, which, setup, key_width, max_key,
                       partitions=3):
    opts = dict(SORTER_SETUPS[setup])
    spill, comb = opts.pop("spill", False), opts.pop("combiner", False)
    kw = dict(opts, **pkg.kw)
    if spill:
        kw.update(spill_dir=str(d), mem_budget_bytes=9_000)
    s = pkg.sorter.DeviceSorter(
        num_partitions=partitions, key_width=key_width,
        span_budget_bytes=4_000, device_min_records=0,
        key_normalizer=_norm(pkg, which),
        combiner=pkg.sorter.sum_long_combiner if comb else None,
        **dict({"engine": "device"}, **kw))
    pairs = _mixed_case_pairs(5, 1500, max_key=max_key,
                              value=1 if comb else None)
    for i in range(0, len(pairs), 250):
        s.write_batch(pkg.rf.KVBatch.from_pairs(pairs[i:i + 250]))
    return s, pairs


@pytest.mark.parametrize("which", list(NORMALIZERS))
@pytest.mark.parametrize("setup", list(SORTER_SETUPS))
@pytest.mark.parametrize("key_width,max_key", [(16, 6), (4, 11)])
def test_sorter_normalizer_matches_tez_tpu(tmp_path, monkeypatch, setup,
                                           which, key_width, max_key):
    """DeviceSorter with a key normalizer, synchronous, on the async plane
    and spilling (flush_run's FileRun): the flushed bytes equal tez_tpu's,
    records sort by (partition of the RAW key, normalized key) stably, and
    keys longer than the lanes take the tie-break on normalized bytes."""
    for mod in (tasync, jasync):   # spans complete in spill order in both
        def one_worker(self, *a, _real=mod.AsyncSpanPipeline.__init__, **kw):
            _real(self, *a, **dict(kw, readback_workers=1))
        monkeypatch.setattr(mod.AsyncSpanPipeline, "__init__", one_worker)
    got = {}
    for name, pkg in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        s, pairs = _normalized_sorter(pkg, d, which, setup, key_width,
                                      max_key)
        assert s.num_spills > 1
        if SORTER_SETUPS[setup].get("spill"):
            fr = s.flush_run()
            assert isinstance(fr, pkg.rf.FileRun)
            got[name] = (open(fr.path, "rb").read(),
                         sorted(os.listdir(d)) == [os.path.basename(fr.path)])
            run = fr.to_run()
        else:
            run = s.flush()
            got[name] = _run_tuple(run)
        got[name] += (counter_values(s.counters)["TaskCounter"],)
    assert got["port"] == got["tez_tpu"]
    # the golden: partition by FNV of the raw key, stable normalized order
    from tez_tpu.library.partitioners import HashPartitioner
    norm = _norm(PKGS["tez_tpu"], which)
    part = HashPartitioner().get_partition
    if SORTER_SETUPS[setup].get("combiner"):
        return
    want = sorted(pairs, key=lambda kv: (part(kv[0], None, 3), norm(kv[0])))
    assert list(run.batch.iter_pairs()) == want


def test_normalizer_oracles_of_tez_tpu():
    """tests/test_ops.py's comparator cases on the port: descending order
    under ReverseByteKeyComparator through a sort and a merge, keys past
    the lanes, and a multi-span flush."""
    norm = tcmp.ReverseByteKeyComparator().normalize
    keys = [b"aaaa", b"zzzz", b"mmmm", b"bbbb", b"yyyy"]
    s = tsorter.DeviceSorter(num_partitions=1, key_normalizer=norm,
                             device="cpu")
    for k in keys:
        s.write(k, b"v")
    run = s.flush()
    assert [k for k, _v in run.batch.iter_pairs()] == \
        sorted(keys, reverse=True)
    s2 = tsorter.DeviceSorter(num_partitions=1, key_normalizer=norm,
                              device="cpu")
    for k in (b"cccc", b"xxxx"):
        s2.write(k, b"v")
    merged = tsorter.merge_sorted_runs([run, s2.flush()], 1, 16,
                                       key_normalizer=norm, device="cpu")
    assert [k for k, _v in merged.batch.iter_pairs()] == \
        sorted(keys + [b"cccc", b"xxxx"], reverse=True)
    base = b"p" * 20
    long_keys = [base + suf for suf in (b"a", b"c", b"b", b"e", b"d")]
    s = tsorter.DeviceSorter(num_partitions=1, key_width=16,
                             key_normalizer=norm, device="cpu")
    for k in long_keys:
        s.write(k, b"v")
    assert [k for k, _v in s.flush().batch.iter_pairs()] == \
        sorted(long_keys, reverse=True)
    keys = [f"k{i:03d}".encode() for i in range(16)]
    s = tsorter.DeviceSorter(num_partitions=1, key_normalizer=norm,
                             span_budget_bytes=64, device="cpu")
    for k in keys:
        s.write(k, b"v")
    assert s.num_spills > 1
    assert [k for k, _v in s.flush().batch.iter_pairs()] == \
        sorted(keys, reverse=True)


def _normalized_runs(pkg, which, partitions, nruns=5):
    norm = _norm(pkg, which)
    runs = []
    for r in range(nruns):
        pairs = _mixed_case_pairs(40 + r, 300 + 50 * r, max_key=7)
        parts = np.random.default_rng(r).integers(0, partitions, len(pairs))
        order = sorted(range(len(pairs)),
                       key=lambda i: (parts[i], norm(pairs[i][0])))
        row_index = np.zeros(partitions + 1, dtype=np.int64)
        np.cumsum(np.bincount(parts, minlength=partitions),
                  out=row_index[1:])
        runs.append(pkg.rf.Run(pkg.rf.KVBatch.from_pairs(
            [pairs[i] for i in order]), row_index))
    return runs


@pytest.mark.parametrize("which", list(NORMALIZERS))
@pytest.mark.parametrize("engine,merge_factor", [("host", 0), ("device", 0),
                                                 ("device", 2)])
@pytest.mark.parametrize("partitions,key_width", [(1, 16), (3, 4)])
def test_merge_sorted_runs_normalizer_matches_tez_tpu(which, engine,
                                                      merge_factor,
                                                      partitions, key_width):
    got = {}
    for name, pkg in PKGS.items():
        counters = pkg.counters()
        run = pkg.sorter.merge_sorted_runs(
            _normalized_runs(pkg, which, partitions), partitions, key_width,
            counters=counters, engine=engine, merge_factor=merge_factor,
            key_normalizer=_norm(pkg, which), device_min_records=0,
            **pkg.kw)
        got[name] = _run_tuple(run), counter_values(counters)
    assert got["port"] == got["tez_tpu"]
    norm = _norm(PKGS["tez_tpu"], which)
    runs = _normalized_runs(PKGS["tez_tpu"], which, partitions)
    want = []
    for p in range(partitions):
        want += sorted((kv for r in runs for kv in r.partition(p)
                        .iter_pairs()), key=lambda kv: norm(kv[0]))
    out = trf.Run(trf.KVBatch(*[np.frombuffer(got["port"][0][i], dt)
                                for i, dt in enumerate(
                                    (np.uint8, np.int64, np.uint8,
                                     np.int64))]),
                  np.frombuffer(got["port"][0][4], np.int64))
    assert list(out.batch.iter_pairs()) == want


def test_merge_sorted_runs_normalizer_skips_the_resident_merge(monkeypatch):
    """Runs whose key columns are on the device still take the generic
    merge under a normalizer: their columns hold raw keys.  (Lower-case
    keys, so the raw order of the runs is also the normalized order.)"""
    from tez_tpu_torch.ops import device as dev_ops
    runs = []
    for seed in (1, 2):
        s = tsorter.DeviceSorter(num_partitions=1, key_width=16,
                                 device_min_records=0, device="cpu")
        s.write_batch(trf.KVBatch.from_pairs(
            [(k.lower(), v) for k, v in _mixed_case_pairs(seed, 400)]))
        runs.append(s.flush())
    assert all(r.batch.dev_keys is not None for r in runs)

    def refuse(*a, **k):
        raise AssertionError("resident merge under a normalizer")
    monkeypatch.setattr(dev_ops, "merge_resident_slices", refuse)
    norm = tcmp.CaseInsensitiveKeyComparator().normalize
    got = tsorter.merge_sorted_runs(runs, 1, 16, key_normalizer=norm,
                                    device_min_records=0, device="cpu")
    keys = [norm(k) for k, _v in got.batch.iter_pairs()]
    assert keys == sorted(keys) and len(keys) == 800


@pytest.mark.parametrize("which", list(NORMALIZERS) + ["upper"])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_iter_merged_blocks_normalizer_matches_tez_tpu(which, engine):
    """Block-sorted sources under a normalizer (blocks cut inside runs of
    normalized-equal keys): the blocks equal tez_tpu's; tests/
    test_block_merge.py's tie case keeps source order."""
    got = {}
    for name, pkg in PKGS.items():
        norm = bytes.upper if which == "upper" else _norm(pkg, which)
        sources = []
        for s in range(4):
            pairs = sorted(_mixed_case_pairs(60 + s, 200 + 40 * s),
                           key=lambda kv: norm(kv[0]))
            sources.append([pkg.rf.KVBatch.from_pairs(pairs[i:i + 23])
                            for i in range(0, len(pairs), 23)])
        blocks = list(pkg.block.iter_merged_blocks(
            [iter(src) for src in sources], 16, engine=engine,
            key_normalizer=norm, device_min_records=0, **pkg.kw))
        got[name] = [(b.num_records, list(b.iter_pairs())) for b in blocks]
        ties = list(pkg.block.iter_merged_blocks(
            [iter([pkg.rf.KVBatch.from_pairs([(b"A", b"s0")])]),
             iter([pkg.rf.KVBatch.from_pairs([(b"a", b"s1"),
                                              (b"b", b"s1b")])])],
            16, key_normalizer=bytes.upper, **pkg.kw))
        assert [kv for b in ties for kv in b.iter_pairs()] == \
            [(b"A", b"s0"), (b"a", b"s1"), (b"b", b"s1b")]
    assert got["port"] == got["tez_tpu"]
    flat = [kv for _n, kvs in got["port"] for kv in kvs]
    norm = bytes.upper if which == "upper" else _norm(PKGS["tez_tpu"], which)
    assert [norm(k) for k, _v in flat] == sorted(norm(k) for k, _v in flat)


def _normalized_manager(pkg, d, which, async_depth):
    """Mixed-case sorted batches through a small budget: mem->disk merges,
    DISK admissions, disk-direct sources and a streamed final merge, all
    under the normalizer."""
    norm = _norm(pkg, which)
    counters = pkg.counters()
    spill = d / f"spill_{async_depth}"
    spill.mkdir()
    pls = [sorted(_mixed_case_pairs(80 + i, 400 + 100 * (i % 3)),
                  key=lambda kv: norm(kv[0])) for i in range(10)]
    batches = [pkg.rf.KVBatch.from_pairs(p) for p in pls]
    mm = manager(pkg, counters, 40_000, spill, engine="device",
                 device_min_records=0, key_normalizer=norm,
                 max_single_fraction=0.35, block_records=100,
                 async_depth=async_depth)
    commit_all(mm, batches[:8], True)
    path = _file_source_run(pkg, d, f"prod{async_depth}.prun",
                            [[], pls[8], pls[9]])
    fr = pkg.rf.FileRun(path)
    for slot, p in ((8, 1), (9, 2)):
        assert mm.commit_local_file(slot, path, p, fr.partition_nbytes(p))
    result = mm.finish()
    assert result.is_streaming
    recs = list(result.stream.iter_records())
    assert [k for k, _raw, _v in recs] == sorted(k for k, _raw, _v in recs)
    assert all(k == norm(raw) for k, raw, _v in recs)
    return recs, counter_values(counters), files_left(spill)


@pytest.mark.parametrize("which", list(NORMALIZERS))
@pytest.mark.parametrize("async_depth", [0, 2])
def test_manager_normalizer_matches_tez_tpu(tmp_path, which, async_depth):
    out = both(tmp_path, _normalized_manager, which=which,
               async_depth=async_depth)
    assert_same(out)
    c = out["port"][1]["TaskCounter"]
    assert c["NUM_MEM_TO_DISK_MERGES"] >= 1 and c["SHUFFLE_BYTES_TO_DISK"] > 0


def _mixed_case_groups(pkg, d):
    """tests/test_ordered_shuffle_e2e.py's comparator oracle without a
    DAG: two map tasks emit the same mixed-case words under the
    case-insensitive comparator; one consumer merges their outputs and
    groups comparator-equal keys."""
    name = ("tez_tpu_torch" if pkg is PKGS["port"] else "tez_tpu") + \
        ".library.comparators:CaseInsensitiveKeyComparator"
    ctx = types.SimpleNamespace(
        conf={"tez.runtime.key.comparator.class": name},
        user_payload=types.SimpleNamespace(load=lambda: None))
    norm = pkg.cmp.load_comparator(ctx)
    counters = pkg.counters()
    mm = manager(pkg, counters, 1 << 20, d, engine="device",
                 device_min_records=0, key_normalizer=norm)
    one = (1 + (1 << 63)).to_bytes(8, "big")
    for task in range(2):
        s = pkg.sorter.DeviceSorter(num_partitions=1, key_normalizer=norm,
                                    engine="device", device_min_records=0,
                                    **pkg.kw)
        for word in (b"Apple", b"banana", b"APPLE", b"Banana", b"apple",
                     b"cherry"):
            s.write(word, one)
        mm.commit(task, s.flush().partition(0))
    groups = []
    for k, _raw, v in _records(mm):
        n = int.from_bytes(v, "big") - (1 << 63)
        if groups and groups[-1][0] == k:
            groups[-1][1] += n
        else:
            groups.append([k, n])
    assert [(k.decode(), n) for k, n in groups] == \
        [("apple", 6), ("banana", 4), ("cherry", 2)]
    return groups


def _records(mm):
    """(sort key, key, value) of a finished manager, in RAM or streamed."""
    result = mm.finish()
    if result.is_streaming:
        return list(result.stream.iter_records())
    norm = mm.key_normalizer
    return [(norm(k), k, v) for k, v in result.batch.iter_pairs()]


def test_comparator_groups_match_tez_tpu(tmp_path):
    assert_same(both(tmp_path, _mixed_case_groups))


# -- chip_smoke's phase 9 -----------------------------------------------------
def test_merge_phase_on_the_host():
    """chip_smoke's phase 9 at a small size with the plain versions: every
    leg's checks pass (leg A's order and multisets, B's determinism across
    async depths, C's cascade, D's normalizers, E's faults)."""
    launches = chip_smoke.merge_phase(
        types.SimpleNamespace(seed=2), device="cpu", **chip_smoke.TINY_MERGE)
    assert launches == {"fnv_hash_bytes": 0, "fnv_hash_lanes": 0,
                        "merge_rank": 0, "merge_path_pair": 0}
