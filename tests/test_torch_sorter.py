"""Port parity of tez_tpu_torch's DeviceSorter, merge_sorted_runs and
sum_long_combiner against tez_tpu's: the same seeded records through both
sorters (engine="device", device_min_records=0; the port on device="cpu"),
flushed runs byte-identical -- keys, values and row_index."""
import numpy as np
import pytest
import torch

from tez_tpu.ops import sorter as jsorter
from tez_tpu.ops.runformat import KVBatch as JBatch
from tez_tpu_torch.common.counters import TaskCounter
from tez_tpu_torch.ops import sorter as tsorter
from tez_tpu_torch.ops.runformat import KVBatch as TBatch
from tez_tpu_torch.ops.runformat import Run as TRun
from tez_tpu_torch.ops.serde import (VarLongSerde, decode_longs_be,
                                     encode_longs_be)


def _pairs(seed, n, max_key, alphabet=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = bytes(rng.integers(0, alphabet, int(rng.integers(1, max_key + 1)))
                  .astype(np.uint8) + 97)
        out.append((k, VarLongSerde().to_bytes(int(rng.integers(-3, 9)))))
    return out


def _assert_same_run(t, j):
    np.testing.assert_array_equal(t.batch.key_bytes, j.batch.key_bytes)
    np.testing.assert_array_equal(t.batch.key_offsets, j.batch.key_offsets)
    np.testing.assert_array_equal(t.batch.val_bytes, j.batch.val_bytes)
    np.testing.assert_array_equal(t.batch.val_offsets, j.batch.val_offsets)
    np.testing.assert_array_equal(t.row_index, j.row_index)


def _both(kw, batches=None, pairs=None, parts=None):
    """Feed the same records to both sorters; return (port, tez_tpu)
    sorters after their flush, and the two flushed runs."""
    jopts = dict(kw)
    if jopts.get("combiner") is tsorter.sum_long_combiner:
        jopts["combiner"] = jsorter.sum_long_combiner
    js = jsorter.DeviceSorter(**jopts)
    ts = tsorter.DeviceSorter(device="cpu", **kw)
    for b in batches or []:
        js.write_batch(JBatch(b.key_bytes, b.key_offsets, b.val_bytes,
                              b.val_offsets))
        ts.write_batch(b)
    for i, (k, v) in enumerate(pairs or []):
        p = None if parts is None else int(parts[i])
        js.write(k, v, p)
        ts.write(k, v, p)
    return ts, js, ts.flush(), js.flush()


@pytest.mark.parametrize("combine", [False, True])
@pytest.mark.parametrize("max_key,key_width", [(8, 16), (12, 12), (30, 8),
                                               (5, 4)])
def test_flush_matches_tez_tpu(max_key, key_width, combine):
    """Resident path (keys fit the lanes) and the generic hash path with the
    host tie-break (keys past key_width); several spans, so flush merges."""
    pairs = _pairs(max_key + key_width, 2400, max_key)
    batches = [TBatch.from_pairs(pairs[i:i + 400])
               for i in range(0, len(pairs), 400)]
    kw = dict(num_partitions=3, key_width=key_width, span_budget_bytes=20000,
              engine="device", device_min_records=0,
              combiner=tsorter.sum_long_combiner if combine else None)
    ts, js, t, j = _both(kw, batches=batches)
    assert ts.num_spills == js.num_spills > 2
    _assert_same_run(t, j)
    for c in (TaskCounter.OUTPUT_RECORDS, TaskCounter.SPILLED_RECORDS,
              TaskCounter.MERGED_MAP_OUTPUTS):
        assert ts.counters.find_counter(c).value == \
            js.counters.find_counter(c).value


def test_custom_partitions_and_single_partition_paths():
    pairs = _pairs(3, 900, 6)
    parts = np.random.default_rng(3).integers(0, 4, len(pairs))
    kw = dict(num_partitions=4, key_width=8, span_budget_bytes=9000,
              engine="device", device_min_records=0)
    *_, t, j = _both(kw, pairs=pairs, parts=parts)
    _assert_same_run(t, j)
    kw = dict(num_partitions=1, key_width=8, span_budget_bytes=9000,
              engine="device", device_min_records=0, partitioner="none")
    *_, t, j = _both(kw, pairs=pairs)
    _assert_same_run(t, j)


def test_merge_factor_cascade_and_host_engine():
    pairs = _pairs(8, 1500, 10)
    batches = [TBatch.from_pairs(pairs[i:i + 150])
               for i in range(0, len(pairs), 150)]
    kw = dict(num_partitions=5, key_width=8, span_budget_bytes=5000,
              engine="device", device_min_records=0, merge_factor=3)
    ts, js, t, j = _both(kw, batches=batches)
    assert ts.num_spills > 3
    _assert_same_run(t, j)
    kw = dict(num_partitions=5, key_width=8, span_budget_bytes=5000,
              engine="host")
    *_, t, j = _both(kw, batches=batches)
    _assert_same_run(t, j)


def test_small_spans_route_to_host_below_the_record_floor():
    pairs = _pairs(2, 300, 6)
    kw = dict(num_partitions=2, key_width=8, span_budget_bytes=3000)
    ts, _js, t, j = _both(kw, batches=[TBatch.from_pairs(pairs)])
    assert tsorter._route_engine("device", 300, ts.device_min_records) == \
        "host"
    _assert_same_run(t, j)
    assert tsorter.resolve_engine("auto") == "device"
    assert tsorter.resolve_engine("host") == "host"


def test_merge_sorted_runs_carried_from_tez_tpu():
    """Runs sorted by tez_tpu, carried over with Run.from_arrays (resident
    key columns included), merge to tez_tpu's bytes on both routes."""
    spans = []
    for seed in range(4):
        s = jsorter.DeviceSorter(num_partitions=3, key_width=12,
                                 engine="device", device_min_records=0)
        spans.append(s.sort_batch(JBatch.from_pairs(_pairs(seed, 500, 12))))
    want = jsorter.merge_sorted_runs(spans, 3, 12, device_min_records=0)
    resident, generic = [], []
    for r in spans:
        lanes, lens, lo, hi = r.batch.dev_keys
        arrays = (r.batch.key_bytes, r.batch.key_offsets, r.batch.val_bytes,
                  r.batch.val_offsets, r.row_index)
        resident.append(TRun.from_arrays(
            *arrays, dev_lanes=np.asarray(lanes)[lo:hi],
            dev_lengths=np.asarray(lens)[lo:hi], device="cpu"))
        generic.append(TRun.from_arrays(*arrays, device="cpu"))
        back = resident[-1].to_arrays()
        np.testing.assert_array_equal(back[5], np.asarray(lanes)[lo:hi])
        np.testing.assert_array_equal(back[6], np.asarray(lens)[lo:hi])
        assert generic[-1].to_arrays()[5:] == (None, None)
    for runs in (resident, generic):
        got = tsorter.merge_sorted_runs(runs, 3, 12, device_min_records=0,
                                        device="cpu")
        _assert_same_run(got, want)


def test_sum_long_combiner_matches():
    pairs = _pairs(5, 800, 4, alphabet=2)
    s = jsorter.DeviceSorter(num_partitions=2, key_width=8,
                             engine="device", device_min_records=0)
    run = s.sort_batch(JBatch.from_pairs(pairs))
    trun = TRun.from_arrays(run.batch.key_bytes, run.batch.key_offsets,
                            run.batch.val_bytes, run.batch.val_offsets,
                            run.row_index, device="cpu")
    _assert_same_run(tsorter.sum_long_combiner(trun),
                     jsorter.sum_long_combiner(run))
    vals = np.array([-5, 0, 7, 2 ** 40], dtype=np.int64)
    np.testing.assert_array_equal(decode_longs_be(encode_longs_be(vals), 4),
                                  vals)


def test_deferred_features_raise():
    with pytest.raises(NotImplementedError):
        tsorter.DeviceSorter(2, pipeline_depth=2, device="cpu")
    with pytest.raises(NotImplementedError):
        tsorter.DeviceSorter(2, spill_dir="/nonexistent", device="cpu")
    with pytest.raises(NotImplementedError):
        tsorter.DeviceSorter(2, key_normalizer=lambda k: k, device="cpu")
    with pytest.raises(NotImplementedError):
        tsorter.merge_sorted_runs([], 2, 8, key_normalizer=lambda k: k,
                                  device="cpu")


def test_sorter_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsorter.DeviceSorter(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsorter.merge_sorted_runs([], 4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TRun.from_arrays(np.zeros(4, np.uint8), np.array([0, 4]),
                         np.zeros(0, np.uint8), np.array([0, 0]),
                         np.array([0, 1]), dev_lanes=np.zeros((1, 1),
                                                              np.uint32),
                         dev_lengths=np.array([4], np.int32))


def test_host_helpers_match_tez_tpu():
    """The port's own copies of tez_tpu's host helpers: key codec, ragged
    gathers, host sort engine, scalar partitioner, metrics histograms."""
    from tez_tpu.common import metrics as jmetrics
    from tez_tpu.library.partitioners import _stable_hash as jhash
    from tez_tpu.ops import host_sort as jhost
    from tez_tpu.ops import keycodec as jkc
    from tez_tpu.ops import runformat as jrf
    from tez_tpu_torch.common import metrics as tmetrics
    from tez_tpu_torch.common.counters import TezCounters
    from tez_tpu_torch.library.partitioners import (HashPartitioner,
                                                    _stable_hash)
    from tez_tpu_torch.ops import host_sort as thost
    from tez_tpu_torch.ops import keycodec as tkc
    from tez_tpu_torch.ops import runformat as trf
    b = TBatch.from_pairs(_pairs(12, 600, 14, alphabet=200))
    kb, ko = b.key_bytes, b.key_offsets
    for width in (4, 7, 16):
        for a, j in zip(tkc.pad_to_matrix(kb, ko, width),
                        jkc.pad_to_matrix(kb, ko, width)):
            np.testing.assert_array_equal(a, j)
        for a, j in zip(tkc.encode_keys(kb, ko, width),
                        jkc.encode_keys(kb, ko, width)):
            np.testing.assert_array_equal(a, j)
    lanes, lengths = tkc.encode_keys(kb, ko, 12)
    np.testing.assert_array_equal(tkc.lanes_to_matrix(lanes),
                                  jkc.lanes_to_matrix(lanes))
    perm = np.random.default_rng(1).permutation(b.num_records)
    fixed = TBatch.from_pairs([(bytes(8), bytes(3))] * 5)
    for data, offs in ((kb, ko), (b.val_bytes, b.val_offsets),
                       (fixed.key_bytes, fixed.key_offsets)):
        p = perm[:len(offs) - 1] % (len(offs) - 1)
        for a, j in zip(trf.gather_ragged(data, offs, p),
                        jrf.gather_ragged(data, offs, p)):
            np.testing.assert_array_equal(a, j)
    cand = np.arange(b.num_records - 1)
    np.testing.assert_array_equal(trf.adjacent_equal_rows(kb, ko, cand),
                                  jrf.adjacent_equal_rows(kb, ko, cand))
    parts = [(kb, ko), (b.val_bytes, b.val_offsets)]
    for a, j in zip(trf.concat_ragged(parts), jrf.concat_ragged(parts)):
        np.testing.assert_array_equal(a, j)
    mat, lens = tkc.pad_to_matrix(kb, ko, 16)
    np.testing.assert_array_equal(thost.host_hash_partition(mat, lens, 7),
                                  jhost.host_hash_partition(mat, lens, 7))
    for a, j in zip(thost.host_sort_run(lens % 3, lanes, lengths),
                    jhost.host_sort_run(lens % 3, lanes, lengths)):
        np.testing.assert_array_equal(a, j)
    for key in (b"", b"abc", "word", 12345, -7, (1, 2)):
        assert _stable_hash(key) == jhash(key)
    assert HashPartitioner().get_partition(b"abc", None, 5) == \
        jhash(b"abc") % 5
    tc, jc = TezCounters(), jmetrics
    for ms in (0.2, 1.0, 3.5, 700.0, 1e9):
        assert tmetrics.bucket_index(ms) == jc.bucket_index(ms)
        tmetrics.observe("port.test", ms, counters=tc)
    group = tc.to_dict()[tmetrics.HIST_GROUP_PREFIX + "port.test"]
    assert group["COUNT"] == 5 and group["LE_1"] == 2 and group["LE_INF"] == 1
    assert tmetrics.registry().histogram("port.test").count >= 5
