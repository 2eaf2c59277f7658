#!/usr/bin/env python3
"""Drive the tez_tpu_torch data plane once on one CUDA card.

Run from the root of the repository, on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed N] [--producers N] [--span-mb N]

Phases, each checked, none allowed to fail:

1. the card's name and power limit (nvidia-smi), then an nvcc build of
   every kernel under tez_tpu_torch/csrc, all sources at once;
2. each kernel against its plain PyTorch version on the card, bit-exact,
   at the slice's shapes, with its time, the plain version's time, its
   memory-bound time and a yardstick computing the same function on these
   inputs, its answer checked before it is timed: torch.searchsorted over
   an exact int64 packing of the rows for merge rank (random queries,
   sorted queries at the map pair and the reduce rung with the slice's own
   keys too, an all-equal run, sparse sorted queries), a stable torch.sort
   of the same packing for the merge-path pair, which is also timed
   against the composite it replaced on the main path (two merge-rank
   launches and a scatter);
3. map side: 4 producers, each a DeviceSorter(num_partitions=4,
   key_width=12, 256 MB spans) fed two full spans of bench-style records
   (12-byte Zipf(1.3) keys "w" + 11 digits over a 50k vocabulary, 8-byte
   values) and flushed, synchronous spans;
3b. the same batches through DeviceSorter(pipeline_depth=2), the async
   span plane with the library's containment defaults: every flushed run
   byte-identical to phase 3's, no failover, the breaker closed, two
   spans in flight, each span's dispatch stage far shorter than its
   dispatch -> readback wait; the stage histograms, PipelineStats and the
   peak device memory are printed;
4. reduce side: merge_sorted_runs over phase 3b's runs, checked byte for
   byte against a numpy golden (FNV partition + stable lexsort);
5. device_shuffle_sort over one producer's records, against the same
   golden; 5b. the same records submitted in two spans to
   DeviceSpanScheduler, coalesced into one dispatch, equal to phase 5;
6. the combiner leg of OrderedWordCount: ragged 1-16 byte Zipf words with
   value 1, the same producers with sum_long_combiner on the async plane
   (the precombine counted: COMBINE_INPUT_RECORDS = the records,
   COMBINE_OUTPUT_RECORDS = the distinct words of each span), the merge, a
   last combine, every count checked against a collections.Counter golden;
7. the containment ladder: 1 producer x 6 spans of 16 MB at
   pipeline_depth=2, fault-free and under device.dispatch.delay,
   device.dispatch.oom, device.readback.fail, device.dispatch.hang (a 60 s
   hang against a 500 ms watchdog) and a breaker of 2 failures tripped by
   two readback failures; every flush byte-identical to the fault-free
   one, each with its DeviceFailover counters moved;
8. the spilling map side at the repo's spill-benchmark scale
   (tez_tpu/tools/spill_bench.py, SPILL_r05.json): 4 producers, each
   writing 512 MB of KV (1-16 byte Zipf(1.3) words over a 2,000,000-word
   vocabulary, each value the record's index as a big-endian long, no
   combiner) into DeviceSorter(num_partitions=4, key_width=16, 64 MB
   spans, pipeline_depth=2) with the default memory budget and a spill
   directory, so most spans go to disk and flush_run streams the block
   merge into one partition-indexed file: each FileRun equal to a numpy
   golden (stable order by partition and key), the spill counters equal
   to the files written and read, only the final file left, no failover;
   a zlib leg flushes the same records as its uncompressed twin from
   smaller files;
9. the reduce side's bounded-memory merge, ShuffleMergeManager with
   tez_tpu's defaults for an ordered input (a 230.4 MiB budget, merge
   threshold 0.9, single-batch limit 0.25, merge factor 64, the device
   engine from 65,536 records, async depth 2), over sorted map segments
   of 1-16 byte Zipf(1.3) words of phase 8's vocabulary whose values name
   their source and index: A, one reducer's 672 MiB committed by 8 fetch
   threads (64 segments of 8 MiB, 2 skewed segments of 64 MiB that take
   the DISK target, 4 disk-direct sources), its streamed final merge in
   key order with each source's records in their order; B, one paced
   fetch thread over 32 segments and one skewed one, byte-identical at
   async depth 2 and 0; C, merge factor 4 and a 16 MiB budget over 48
   segments of 1 MiB, disk-to-disk cascades on the async lane,
   byte-identical at depth 0; D, two spilling sorters and one manager
   under CaseInsensitiveKeyComparator and ReverseByteKeyComparator (the
   partition of every record the FNV of its raw bytes, the merged
   records in normalized order); E, B's input under the merge lane's
   faults (an out-of-memory split, a hang against a 500 ms watchdog, a
   tripped breaker), each byte-identical to B.

Kernel launch counts are zeroed before each path of phases 3-6, 8 and 9
and read after it: each TPU kernel's counterpart on the path must have
been launched, and the general-query merge rank, which the main path no
longer calls, not at all; the JSON line reports their sum over phases
3-6, 8 and 9.  The
last two lines are one JSON object of per-kernel numbers and {"ok": true,
"device": {...}}.  Without a card the script exits non-zero before
printing any result.  --tile-sweep also times the merge-path kernel at
other CTA shapes and splits both kernels' time by launch.
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

FNV_OFFSET, FNV_PRIME = 2166136261, 16777619
NUM_PARTITIONS = 4
BENCH_VOCAB = 50_000
WORD_VOCAB = 100_000
#: phase 8's scale: spill_bench's 2,000,000-word vocabulary and
#: io.sort.mb=64, about 0.5 GB of map output a producer (SPILL_r05.json)
SPILL_VOCAB = 2_000_000
SPILL_SPAN_MB = 64
SPILL_PRODUCER_MB = 512
ZIPF_A = 1.3
#: the value of every word in the combiner leg: the long 1 (VarLongSerde)
ONE_LONG = np.frombuffer((1 + (1 << 63)).to_bytes(8, "big"), np.uint8)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# card and timing
# ---------------------------------------------------------------------------
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def memory_tb_s(name: str) -> float:
    """Published HBM rate of the H100 part named by the card."""
    if "NVL" in name:
        return 3.9
    if "PCIe" in name:
        return 2.0
    return 3.35


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# independent numpy goldens
# ---------------------------------------------------------------------------
def fnv_np(mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    h = np.full(mat.shape[0], FNV_OFFSET, dtype=np.uint64)
    for j in range(mat.shape[1]):
        nh = ((h ^ mat[:, j].astype(np.uint64)) * np.uint64(FNV_PRIME)) \
            & np.uint64(0xFFFFFFFF)
        h = np.where(j < lengths, nh, h)
    return h


def be_lanes(mat: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(mat).view(">u4").astype(np.uint32)


def bench_vocab() -> np.ndarray:
    """uint8[50k, 12]: "w" + the id as 11 decimal digits (bench.py's keys)."""
    ids = np.arange(BENCH_VOCAB, dtype=np.int64)
    vocab = np.zeros((BENCH_VOCAB, 12), dtype=np.uint8)
    vocab[:, 0] = ord("w")
    for i in range(11, 0, -1):
        vocab[:, i] = ord("0") + ids % 10
        ids //= 10
    return vocab


def vocab_rank(vocab: np.ndarray, lengths: np.ndarray) -> tuple:
    """(partition, rank) of every vocabulary entry under the sort order
    (partition, big-endian lanes, length)."""
    part = (fnv_np(vocab, lengths) % NUM_PARTITIONS).astype(np.int64)
    lanes = be_lanes(vocab)
    keys = (lengths,) + tuple(lanes[:, i] for i in
                              range(lanes.shape[1] - 1, -1, -1)) + (part,)
    order = np.lexsort(keys)
    rank = np.empty(len(vocab), dtype=np.int64)
    rank[order] = np.arange(len(vocab))
    return part, rank


def stable_order(rank_of_record: np.ndarray) -> np.ndarray:
    """Stable argsort; ranks below 2^16 take numpy's radix sort."""
    if rank_of_record.max(initial=0) < (1 << 16):
        rank_of_record = rank_of_record.astype(np.uint16)
    return np.argsort(rank_of_record, kind="stable")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
#: TPU kernel -> its counterparts that the slice's main path launches
MAIN_PATH_COUNTERPARTS = (
    ("fnv_hash_pallas", "tez_tpu/ops/pallas_kernels.py:34",
     ("fnv_hash_bytes", "fnv_hash_lanes")),
    ("merge_rank_pallas", "tez_tpu/ops/pallas_kernels.py:76",
     ("merge_path_pair",)),
)
#: (threads, rows per thread, boundary search group) of the merge-path
#: kernels tried by --tile-sweep
TILE_SHAPES = ((128, 4, 0), (128, 8, 0), (128, 16, 0), (128, 15, 0),
               (256, 4, 0), (256, 8, 0), (64, 16, 0), (128, 16, 1),
               (128, 16, 8), (128, 8, 1), (128, 8, 8))
#: the exact key of a pad sentinel row (lanes and length 0xFFFFFFFF)
SENTINEL_KEY = np.iinfo(np.int64).max


# Rows of phase 2's merge inputs come as (lanes uint32[n, W], lengths
# uint32[n], exact key int64[n]): the key orders the rows as the
# comparator does, so a library call on it computes the kernel's function.
def small_key(lanes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """3 bits a lane and 5 for the length (rows of sorted_run), the
    sentinel mapped to the top."""
    key = lens.astype(np.int64)
    for i in range(lanes.shape[1]):
        key |= lanes[:, i].astype(np.int64) << \
            (5 + 3 * (lanes.shape[1] - 1 - i))
    return np.where(lens == 0xFFFFFFFF, SENTINEL_KEY, key)


def sorted_run(rng, m: int, width: int, lane_values: int = 8) -> tuple:
    """m sorted rows whose lanes draw from lane_values values, so equal
    keys are common, ending in pad sentinels as a bucketed run does."""
    run = rng.integers(0, lane_values, (m, width)).astype(np.uint32)
    run_len = rng.integers(0, 17, m).astype(np.uint32)
    order = np.argsort(small_key(run, run_len), kind="stable")
    run, run_len = run[order], run_len[order]
    run[-(m // 64):] = 0xFFFFFFFF
    run_len[-(m // 64):] = 0xFFFFFFFF
    return run, run_len, small_key(run, run_len)


def bench_run(rng, m: int, partition_lane: bool) -> tuple:
    """m sorted rows of the slice's own keys: bench records' 12-byte keys
    as 3 big-endian lanes, length 12, optionally behind the partition lane
    of the generic merge; their exact key is (partition, rank in the
    vocabulary)."""
    vocab = bench_vocab()
    vlanes = be_lanes(vocab)
    vpart, _ = vocab_rank(vocab, np.full(BENCH_VOCAB, 12))
    vrank = np.empty(BENCH_VOCAB, np.int64)
    vrank[np.lexsort(tuple(vlanes[:, i] for i in range(2, -1, -1)))] = \
        np.arange(BENCH_VOCAB)
    ids = rng.zipf(ZIPF_A, m) % BENCH_VOCAB
    key = (vpart[ids] << 20 if partition_lane else 0) | vrank[ids]
    order = np.argsort(key, kind="stable")
    ids, key = ids[order], key[order]
    lanes = vlanes[ids]
    if partition_lane:
        lanes = np.concatenate(
            [vpart[ids].astype(np.uint32)[:, None], lanes], axis=1)
    lens = np.full(m, 12, np.uint32)
    lanes[-(m // 64):] = 0xFFFFFFFF
    lens[-(m // 64):] = 0xFFFFFFFF
    key[-(m // 64):] = SENTINEL_KEY
    return lanes, lens, key


def random_queries(rng, run: tuple, m: int, width: int) -> tuple:
    """Random rows, half of them copies of run rows (sentinels too)."""
    q = rng.integers(0, 8, (m, width)).astype(np.uint32)
    q_len = rng.integers(0, 17, m).astype(np.uint32)
    pick = rng.integers(0, run[0].shape[0], m // 2)
    q[:m // 2], q_len[:m // 2] = run[0][pick], run[1][pick]
    return q, q_len, small_key(q, q_len)


def merge_rank_inputs(rng):
    """Phase 2's merge-rank cases, one at a time: (label, run, queries,
    main_row); main_row marks the JSON row's case."""
    # random queries (the JSON row: W = 3, count_equal False)
    for width in (3, 4):
        run = sorted_run(rng, 1 << 21, width)
        yield ("random", run, random_queries(rng, run, 1 << 21, width),
               width == 3)
    # sorted queries, as tez_tpu's only caller passes them: the map-side
    # resident pair (2^21 a side, W = 3) and a reduce rung (2^24, W = 4,
    # the partition lane first for the slice's keys)
    yield ("sorted map pair", sorted_run(rng, 1 << 21, 3),
           sorted_run(rng, 1 << 21, 3), False)
    yield ("sorted map pair bench keys", bench_run(rng, 1 << 21, False),
           bench_run(rng, 1 << 21, False), False)
    yield ("sorted reduce rung", sorted_run(rng, 1 << 24, 4),
           sorted_run(rng, 1 << 24, 4), False)
    yield ("sorted reduce rung bench keys", bench_run(rng, 1 << 24, True),
           bench_run(rng, 1 << 24, True), False)
    # windows too wide for shared memory: an all-equal run against sorted
    # queries around its key, and sorted queries 64 times sparser than the
    # run
    eq = np.full(((1 << 21) - (1 << 15), 3), 3, np.uint32)
    eq_run = (np.concatenate([eq, np.full((1 << 15, 3), 0xFFFFFFFF,
                                          np.uint32)]),
              np.concatenate([np.full(eq.shape[0], 8, np.uint32),
                              np.full(1 << 15, 0xFFFFFFFF, np.uint32)]))
    yield ("all-equal run", eq_run + (small_key(*eq_run),),
           sorted_run(rng, 1 << 21, 3, 5), False)
    yield ("sparse sorted queries", sorted_run(rng, 1 << 24, 4),
           sorted_run(rng, 1 << 18, 4), False)


def rank_tensors(run: tuple, query: tuple, dev) -> tuple:
    """A merge-rank case on the card: the kernel's four int32 inputs (u32
    bits), and the run's and the queries' exact keys."""
    import torch
    t = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
         for a in (run[0], run[1], query[0], query[1])]
    return (t, torch.from_numpy(run[2]).to(dev),
            torch.from_numpy(query[2]).to(dev))


def kernel_phase(seed: int, bw_tb_s: float, tile_sweep: bool = False) -> dict:
    import torch
    from tez_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rows: dict = {}

    def profile_launches(label, fn):
        """Device time of each kernel a call launches (profiler)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                log(f"tile sweep {label}: device op {e.key[:60]} "
                    f"count={e.count} ms_each="
                    f"{e.self_device_time_total / e.count / 1e3:.4f}")

    def bound_ms(nbytes: int) -> float:
        return nbytes / (bw_tb_s * 1e12) * 1e3

    def max_err(got, want) -> int:
        return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                   for g, w in zip(got, want))

    def record(name, source, replaces, got, want, ms, plain_ms, nbytes,
               library_ms=None, shape=""):
        err = max_err(*((got, want) if isinstance(got, tuple)
                        else ((got,), (want,))))
        check(err == 0, f"{name} {shape}: kernel disagrees with its plain "
                        f"version (max abs err {err})")
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": 0, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms(nbytes),
               "bound_by": "bytes", "library_ms": library_ms}
        log(f"kernel {name} {shape}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={row['bound_ms']:.4f} library_ms={library_ms} "
            f"max_abs_err={err} tolerance=0 (bit-exact)")
        return row

    # FNV over a byte matrix, N = 2^23, W = 16, 1% pad rows
    n, w = 1 << 23, 16
    mat = torch.randint(0, 256, (n, w), generator=g, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    lens = torch.randint(0, w + 1, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[torch.randint(0, n, (n // 100,), generator=g, device=dev)] = -1
    got = kernels.fnv_hash_bytes(mat, lens, NUM_PARTITIONS)
    want = kernels._to_partitions(kernels._fnv_rows(mat, lens), lens,
                                  NUM_PARTITIONS)
    rows["fnv_hash_bytes"] = record(
        "fnv_hash_bytes", "tez_tpu_torch/csrc/fnv_hash.cu",
        "tez_tpu/ops/pallas_kernels.py:34", got, want,
        cuda_ms(lambda: kernels.fnv_hash_bytes(mat, lens, NUM_PARTITIONS),
                50),
        cuda_ms(lambda: kernels._to_partitions(
            kernels._fnv_rows(mat, lens), lens, NUM_PARTITIONS), 3),
        n * w + 4 * n + 4 * n, shape=f"N={n} W={w}")
    del mat

    # FNV over 3 big-endian lanes, lengths 1..12, 1% pad rows
    lanes = torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 3), generator=g,
                          device=dev, dtype=torch.int32)
    lens = torch.randint(1, 13, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[torch.randint(0, n, (n // 100,), generator=g, device=dev)] = -1
    got = kernels.fnv_hash_lanes(lanes, lens, NUM_PARTITIONS)
    want = kernels._to_partitions(kernels._fnv_rows_from_lanes(lanes, lens),
                                  lens, NUM_PARTITIONS)
    rows["fnv_hash_lanes"] = record(
        "fnv_hash_lanes", "tez_tpu_torch/csrc/fnv_hash.cu",
        "tez_tpu/ops/pallas_kernels.py:34", got, want,
        cuda_ms(lambda: kernels.fnv_hash_lanes(lanes, lens, NUM_PARTITIONS),
                50),
        cuda_ms(lambda: kernels._to_partitions(
            kernels._fnv_rows_from_lanes(lanes, lens), lens,
            NUM_PARTITIONS), 3),
        n * 12 + 4 * n + 4 * n, shape=f"N={n} L=3")
    del lanes

    # merge rank, each case against the plain version and the exact key's
    # torch.searchsorted
    rng = np.random.default_rng(seed)

    def merge_rank_case(label, run, query, main_row):
        t, packed_run, packed_q = rank_tensors(run, query, dev)
        n, width, m = t[0].shape[0], t[0].shape[1], t[2].shape[0]
        check(bool((packed_run[1:] >= packed_run[:-1]).all()),
              f"merge_rank {label}: run not sorted")
        # run rows the bound counts: all N when M = N; fewer queries need
        # only about M log2(N / M + 1) of them (the comparisons a merge of
        # M sorted rows into N needs)
        run_rows = min(n, math.ceil(m * math.log2(n / m + 1))) if m else 0
        for count_equal in (False, True):
            shape = f"{label} N={n} M={m} W={width} count_equal={count_equal}"
            got = kernels.merge_rank(*t, count_equal)
            want = kernels._rank_search(*t, count_equal)
            _, windows, tile = kernels._merge_rank_launch(*t, count_equal)
            check(torch.equal(windows, kernels.merge_rank_windows(
                *t, count_equal, tile)),
                f"merge_rank {shape}: windows differ from merge_rank_windows")
            # the yardstick computes the same function: checked before timing
            lib = torch.searchsorted(packed_run, packed_q, right=count_equal)
            check(torch.equal(lib, want.to(torch.int64)),
                  f"merge_rank {shape}: exact searchsorted disagrees")
            row = record(
                "merge_rank", "tez_tpu_torch/csrc/merge_rank.cu",
                "tez_tpu/ops/pallas_kernels.py:76", got, want,
                cuda_ms(lambda: kernels.merge_rank(*t, count_equal), 20),
                cuda_ms(lambda: kernels._rank_search(*t, count_equal), 3),
                (run_rows + m) * (width + 1) * 4 + 4 * m,
                library_ms=cuda_ms(lambda: torch.searchsorted(
                    packed_run, packed_q, right=count_equal), 20),
                shape=shape)
            log(f"kernel merge_rank {shape}: tiles={windows.shape[1]} "
                f"sorted_tiles={int(windows[2].sum())} "
                f"window_rows_max={int((windows[1] - windows[0]).max())} "
                f"library=exact 64-bit packing, torch.searchsorted")
            if tile_sweep:
                profile_launches(f"merge_rank {label} count_equal="
                                 f"{count_equal}", lambda: kernels.merge_rank(
                                     *t, count_equal))
            if main_row and not count_equal:
                rows["merge_rank"] = row

    for label, run, query, main_row in merge_rank_inputs(rng):
        merge_rank_case(label, run, query, main_row)

    # merge-path pair: the map side's resident pair (2^21 a side, W = 3),
    # one rung of the reduce ladder (2^24 a side, W = 4), the ladder's odd
    # carry (na = 2 nb), a pair of phase 8's streamed-merge rounds (2^17 a
    # side, the partition lane and four key lanes) and a row wider than
    # the templated flavours (W = 9).  idx is the int32 row index of the
    # concatenation.
    def merge_path_case(na, nb, width, label, main_row):
        a, a_len, a_key = sorted_run(rng, na, width)
        b, b_len, b_key = sorted_run(rng, nb, width)
        t = [torch.from_numpy(x.view(np.int32)).to(dev)
             for x in (a, a_len, np.arange(na, dtype=np.uint32),
                       b, b_len, np.arange(na, na + nb, dtype=np.uint32))]
        got = kernels.merge_path_pair(*t)
        want = kernels._merge_path_plain(*t)
        # the composite the main path ran before: two merge_rank launches,
        # arange + rank, six index_copy_
        before = kernels._merge_path_plain(*t, rank=kernels.merge_rank)
        check(max_err(before, want) == 0, f"merge-path composite {label}")
        # yardstick: one stable sort of the concatenation under the exact
        # int64 key; its permutation must be the merge's idx column
        packed = torch.from_numpy(np.concatenate([a_key, b_key])).to(dev)
        check(torch.equal(torch.sort(packed, stable=True).indices,
                          got[2].to(torch.int64)),
              f"merge_path_pair {label}: exact stable sort disagrees")
        row = record(
            "merge_path_pair", "tez_tpu_torch/csrc/merge_path.cu",
            "tez_tpu/ops/pallas_kernels.py:76", got, want,
            cuda_ms(lambda: kernels.merge_path_pair(*t), 20),
            cuda_ms(lambda: kernels._merge_path_plain(*t), 3),
            2 * (na + nb) * (4 * width + 8),
            library_ms=cuda_ms(lambda: torch.sort(packed, stable=True), 10),
            shape=f"na={na} nb={nb} W={width} {label}")
        row["pr1_composite_ms"] = cuda_ms(
            lambda: kernels._merge_path_plain(*t, rank=kernels.merge_rank),
            10)
        log(f"kernel merge_path_pair {label}: pr1_composite_ms="
            f"{row['pr1_composite_ms']:.4f} (two merge_rank + scatter)")
        if tile_sweep:
            for threads, per_thread, group in TILE_SHAPES:
                shape = dict(threads=threads, rows_per_thread=per_thread,
                             group=group)
                out = kernels._merge_path_launch(*t, **shape)
                check(max_err(out[:3], want) == 0,
                      f"merge_path_pair tile {shape}")
                ms = cuda_ms(lambda: kernels._merge_path_launch(*t, **shape),
                             20)
                log(f"tile sweep {label}: threads={threads} rows_per_thread="
                    f"{per_thread} group={group} tile={out[4]} ms={ms:.4f}")
            profile_launches(label, lambda: kernels.merge_path_pair(*t))
        if main_row:
            rows["merge_path_pair"] = row

    merge_path_case(1 << 21, 1 << 21, 3, "map pair", False)
    merge_path_case(1 << 24, 1 << 24, 4, "reduce rung", True)
    merge_path_case(1 << 21, 1 << 20, 4, "odd carry", False)
    merge_path_case(1 << 17, 1 << 17, 5, "spill round", False)
    merge_path_case(1 << 20, 1 << 20, 9, "generic W", False)
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# phases 3-6: the slice
# ---------------------------------------------------------------------------
def span_records(span_bytes: int) -> int:
    """Records of 12-byte keys and 8-byte values that fill one span: the
    sorter accounts key + value + 16 B of offsets per record (+16 B per
    batch) and sorts once a span reaches its budget."""
    return -(-(span_bytes - 16) // (12 + 8 + 16))


def device_ms() -> float:
    from tez_tpu_torch.common import metrics
    reg = metrics.registry()
    return reg.histogram("device.span").sum_ms + \
        reg.histogram("device.merge").sum_ms


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Phase:
    """Wall time of a phase, and the part spent in device-layer calls
    (upload, kernels and sorts, readback; each call ends synchronised).
    split=False prints the wall time only: on the async plane the stages
    overlap, so wall minus device-layer time means nothing."""

    def __init__(self, name: str, nbytes: int, device, split: bool = True):
        self.name, self.nbytes, self.device = name, nbytes, device
        self.split = split
        self.extra_device_s = 0.0

    def __enter__(self):
        sync(self.device)
        self.t0, self.d0 = time.perf_counter(), device_ms()
        return self

    def __exit__(self, exc_type, *_):
        sync(self.device)
        if exc_type is None:
            wall = time.perf_counter() - self.t0
            rate = (f"MB={self.nbytes / 1e6:.1f} "
                    f"MB_per_s={self.nbytes / 1e6 / wall:.1f}")
            if not self.split:
                log(f"phase {self.name}: wall_s={wall:.3f} {rate}")
                return False
            dev = (device_ms() - self.d0) / 1e3 + self.extra_device_s
            log(f"phase {self.name}: wall_s={wall:.3f} device_s={dev:.3f} "
                f"host_s={wall - dev:.3f} {rate}")
        return False


class Launches:
    """Kernel launches of one path: the counts are zeroed just before it
    runs and read just after; `totals` sums the paths of the slice."""

    def __init__(self, name: str, totals: collections.Counter):
        self.name, self.totals = name, totals

    def __enter__(self):
        from tez_tpu_torch.ops import kernels
        kernels.reset_launches()
        return self

    def __exit__(self, exc_type, *_):
        from tez_tpu_torch.ops import kernels
        self.counts = dict(kernels.launches)
        if exc_type is None:
            self.totals.update(self.counts)
            log(f"launches {self.name}: {json.dumps(self.counts)}")
        return False

    def require(self, device, *names) -> None:
        """On the card, each named kernel ran on this path and the general
        merge rank did not."""
        if not is_cuda(device):
            return
        for kname in names:
            check(self.counts[kname] > 0,
                  f"{self.name}: {kname} was never launched")
        check(self.counts["merge_rank"] == 0,
              f"{self.name}: launched merge_rank")


def is_cuda(device) -> bool:
    import torch
    return torch.device(device).type == "cuda"


def bench_batch(rng, vocab: np.ndarray, n: int):
    """n bench-style records: Zipf(1.3) ids over the 50k vocabulary, random
    8-byte values.  Returns (KVBatch, ids, uint8[n, 8] values)."""
    from tez_tpu_torch.ops.runformat import KVBatch
    ids = rng.zipf(ZIPF_A, n) % BENCH_VOCAB
    vals = rng.integers(0, 256, (n, 8), dtype=np.uint8)
    batch = KVBatch(vocab[ids].reshape(-1),
                    np.arange(n + 1, dtype=np.int64) * 12,
                    vals.reshape(-1), np.arange(n + 1, dtype=np.int64) * 8)
    return batch, ids, vals


def word_vocab(rng, size: int = WORD_VOCAB) -> tuple:
    """`size` distinct lowercase words of 1-16 bytes as (list of bytes,
    uint8[size, 16] zero padded, lengths)."""
    seen, words = set(), []
    while len(words) < size:
        w = bytes(rng.integers(97, 123, int(rng.integers(1, 17)))
                  .astype(np.uint8))
        if w not in seen:
            seen.add(w)
            words.append(w)
    mat = np.zeros((size, 16), dtype=np.uint8)
    lens = np.zeros(size, dtype=np.int64)
    for i, w in enumerate(words):
        mat[i, :len(w)] = np.frombuffer(w, np.uint8)
        lens[i] = len(w)
    return words, mat, lens


def word_batch(rng, mat: np.ndarray, lens: np.ndarray, span_bytes: int):
    """Zipf(1.3) words with the value 1, just enough to fill one span.
    Returns (KVBatch, ids)."""
    from tez_tpu_torch.ops.runformat import KVBatch
    est = span_bytes // 24 + 1
    ids = rng.zipf(ZIPF_A, est) % len(mat)
    acct = np.cumsum(lens[ids] + 8 + 16) + 16
    n = int(np.searchsorted(acct, span_bytes)) + 1
    check(n <= est, "word span estimate too small")
    ids = ids[:n]
    klen = lens[ids]
    key_bytes = mat[ids][np.arange(16)[None, :] < klen[:, None]]
    ko = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(klen, out=ko[1:])
    return KVBatch(key_bytes, ko, np.tile(ONE_LONG, n),
                   np.arange(n + 1, dtype=np.int64) * 8), ids


def produce(producer_batches, key_width: int, span_bytes: int,
            combiner=None, device="cuda", pipelines=None,
            **sorter_kw) -> list:
    """Map side of the ordered edge: one DeviceSorter per producer, fed its
    batches (each fills a span) and flushed.  Returns the producers' runs.
    With pipeline_depth > 0 in sorter_kw, each sorter's async pipeline is
    instrumented and appended to `pipelines`."""
    from tez_tpu_torch.ops.sorter import DeviceSorter
    runs = []
    for batches in producer_batches:
        s = DeviceSorter(num_partitions=NUM_PARTITIONS, key_width=key_width,
                         span_budget_bytes=span_bytes, engine="device",
                         combiner=combiner, device=device, **sorter_kw)
        if s.pipeline_depth > 0 and pipelines is not None:
            pipe = s._ensure_pipeline()
            pipe._instrument = True
            pipelines.append(pipe)
        for batch in batches:
            s.write_batch(batch)
        check(s.num_spills == len(batches),
              f"expected {len(batches)} span sorts, got {s.num_spills}")
        runs.append(s.flush())
    return runs


def run_bytes(run) -> tuple:
    b = run.batch
    return (b.key_bytes.tobytes(), b.key_offsets.tobytes(),
            b.val_bytes.tobytes(), b.val_offsets.tobytes(),
            run.row_index.tobytes())


STAGE_HISTOGRAMS = ("device.encode", "device.h2d", "device.dispatch_wait",
                    "device.d2h")


def histogram_totals() -> dict:
    from tez_tpu_torch.common import metrics
    hists = metrics.registry().histograms()
    return {h: (hists[h].count, hists[h].sum_ms) if h in hists else (0, 0.0)
            for h in STAGE_HISTOGRAMS}


def failover_counters(counters) -> dict:
    from tez_tpu_torch.ops.async_stage import COUNTER_GROUP
    return dict(counters.to_dict().get(COUNTER_GROUP, {}))


def check_fault_free(label: str, pipelines, counters_list) -> None:
    """No hidden fallback: a fault-free async run took no failover, kept
    the breaker closed and moved no containment counter."""
    from tez_tpu_torch.ops.async_stage import process_breaker
    for pipe in pipelines:
        check(pipe.stats.failovers == 0 and pipe.stats.watchdog_fires == 0
              and pipe.stats.oom_splits == 0,
              f"{label}: fault-free run took the containment ladder "
              f"{pipe.stats.to_dict()}")
    for counters in counters_list:
        moved = {k: v for k, v in failover_counters(counters).items() if v}
        check(not moved, f"{label}: DeviceFailover counters moved {moved}")
    check(process_breaker().state == "closed",
          f"{label}: breaker {process_breaker().state}")


def report_pipelines(label: str, pipelines, hist0: dict, device) -> None:
    """Stage histograms (count, sum) of the phase, PipelineStats, and each
    span's dispatch interval against its dispatch -> readback wait, from
    the instrumented events: the dispatch stage enqueues and never waits
    on the card, so it must be far shorter."""
    hist1 = histogram_totals()
    for h in STAGE_HISTOGRAMS:
        log(f"{label}: histogram {h} count={hist1[h][0] - hist0[h][0]} "
            f"sum_ms={hist1[h][1] - hist0[h][1]:.3f}")
    for i, pipe in enumerate(pipelines):
        st = pipe.stats
        edges = {}
        for ids, stage, edge, t in pipe.events:
            edges[(ids, stage, edge)] = t
        disp, waits = [], []
        for ids in {e[0] for e in edges}:
            d0 = edges.get((ids, "device.dispatch", "start"))
            d1 = edges.get((ids, "device.dispatch", "end"))
            r1 = edges.get((ids, "device.d2h", "end"))
            if None not in (d0, d1, r1):
                disp.append(d1 - d0)
                waits.append(r1 - d0)
        log(f"{label} producer {i}: max_in_flight={st.max_in_flight} "
            f"coalesced_groups={st.coalesced_groups} dispatched="
            f"{st.dispatched} dispatch_ms={[round(d * 1e3, 3) for d in disp]}"
            f" dispatch_wait_ms={[round(w * 1e3, 3) for w in waits]}")
        check(len(disp) == st.dispatched, f"{label}: missing stage events")
        check(not is_cuda(device) or max(disp) < min(waits) / 4,
              f"{label}: the dispatch stage is not far below the dispatch "
              f"wait ({max(disp):.4f} s vs {min(waits):.4f} s)")


def slice_phases(args, device="cuda") -> dict:
    """Phases 3-6; returns the kernel launch counts of the slice."""
    import torch
    from tez_tpu_torch.common.counters import TaskCounter, TezCounters
    from tez_tpu_torch.ops.device_pipeline import (DeviceSpanScheduler,
                                                   device_shuffle_sort)
    from tez_tpu_torch.ops.sorter import merge_sorted_runs, sum_long_combiner
    span_bytes = int(args.span_mb * (1 << 20))
    rng = np.random.default_rng(args.seed)
    vocab = bench_vocab()
    part, rank = vocab_rank(vocab, np.full(BENCH_VOCAB, 12))
    rec = span_records(span_bytes)
    producer_batches, ids_list, vals_list = [], [], []
    for _p in range(args.producers):
        spans = [bench_batch(rng, vocab, rec) for _span in range(2)]
        producer_batches.append([b for b, _i, _v in spans])
        ids_list += [i for _b, i, _v in spans]
        vals_list += [v for _b, _i, v in spans]
    totals: collections.Counter = collections.Counter()

    # -- phase 3: map side, synchronous spans --------------------------------
    kv_bytes = args.producers * 2 * rec * 20
    with Launches("map", totals) as ln, Phase("map", kv_bytes, device):
        sync_runs = produce(producer_batches, 12, span_bytes, device=device)
    ln.require(device, "fnv_hash_lanes", "merge_path_pair")
    log(f"map: {args.producers} producers x 2 spans x {rec} records")

    # -- phase 3b: map side on the async span plane (the library default) ----
    if is_cuda(device):
        torch.cuda.reset_peak_memory_stats()
    pipelines, counters = [], TezCounters()
    hist0 = histogram_totals()
    with Launches("map_async", totals) as ln, \
            Phase("map_async", kv_bytes, device, split=False):
        runs = produce(producer_batches, 12, span_bytes, device=device,
                       pipelines=pipelines, counters=counters,
                       pipeline_depth=2)
    ln.require(device, "fnv_hash_lanes", "merge_path_pair")
    del producer_batches
    for i, (a, s) in enumerate(zip(runs, sync_runs)):
        check(run_bytes(a) == run_bytes(s),
              f"map_async: producer {i}'s run differs from the sync run")
    del sync_runs
    report_pipelines("map_async", pipelines, hist0, device)
    check(not is_cuda(device) or
          all(p.stats.max_in_flight == 2 for p in pipelines),
          "map_async: max_in_flight is not 2")
    check_fault_free("map_async", pipelines, [counters])
    if is_cuda(device):
        log(f"map_async: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"map_async: {args.producers} runs byte-identical to the sync "
        f"runs, 0 failovers, breaker closed")

    # -- phase 4: reduce side, over the async runs ---------------------------
    with Launches("reduce", totals) as ln, Phase("reduce", kv_bytes, device):
        merged = merge_sorted_runs(runs, NUM_PARTITIONS, 12, device=device)
    ln.require(device, "merge_path_pair")
    t0 = time.perf_counter()
    ids = np.concatenate(ids_list)
    vals = np.concatenate(vals_list)
    order = stable_order(rank[ids])
    check(np.array_equal(merged.batch.key_bytes,
                         vocab[ids[order]].reshape(-1)), "reduce: key bytes")
    check(np.array_equal(merged.batch.key_offsets,
                         np.arange(len(ids) + 1) * 12), "reduce: key offsets")
    check(np.array_equal(merged.batch.val_bytes, vals[order].reshape(-1)),
          "reduce: value bytes")
    row_index = np.zeros(NUM_PARTITIONS + 1, dtype=np.int64)
    np.cumsum(np.bincount(part[ids], minlength=NUM_PARTITIONS),
              out=row_index[1:])
    check(np.array_equal(merged.row_index, row_index), "reduce: row_index")
    log(f"reduce: {len(ids)} records byte-identical to the golden "
        f"(golden_s={time.perf_counter() - t0:.3f})")
    del merged, runs, order, ids, vals

    # -- phase 5: fused device pipeline over one producer's records ----------
    span_ids, span_vals = ids_list[:2], vals_list[:2]
    ids = np.concatenate(span_ids)
    vals = np.concatenate(span_vals)
    del ids_list, vals_list
    n = len(ids)
    keys = vocab[ids]
    lanes = be_lanes(keys)
    hmat = np.zeros((n, 16), dtype=np.uint8)
    hmat[:, :12] = keys
    with Launches("fused_pipeline", totals) as ln, \
            Phase("fused_pipeline", n * 20, device) as ph:
        t_dev = time.perf_counter()
        sp, out_lanes, out_vals, perm, counts = device_shuffle_sort(
            lanes, np.full(n, 12, np.int64), vals.view(np.uint32),
            hmat, np.full(n, 12, np.int32), NUM_PARTITIONS, device=device)
        sync(device)
        ph.extra_device_s = time.perf_counter() - t_dev
    ln.require(device, "fnv_hash_bytes")
    golden = [t[:n].cpu().numpy() for t in (sp, out_lanes, out_vals, perm)] \
        + [counts.cpu().numpy()]
    order = stable_order(rank[ids])
    check(np.array_equal(golden[3], order), "pipeline: perm")
    check(np.array_equal(golden[1].view(np.uint32), lanes[order]),
          "pipeline: sorted lanes")
    check(np.array_equal(golden[2].view(np.uint8), vals[order]),
          "pipeline: sorted values")
    check(np.array_equal(golden[0], part[ids[order]]),
          "pipeline: sorted partitions")
    check(np.array_equal(golden[4],
                         np.bincount(part[ids], minlength=NUM_PARTITIONS)),
          "pipeline: partition counts")
    log(f"fused_pipeline: {n} records identical to the golden")
    del sp, out_lanes, out_vals, perm, counts, lanes, hmat

    # -- phase 5b: the same records through DeviceSpanScheduler --------------
    # submit_ragged in the producer's two spans, coalesced into one
    # dispatch: its result is the stable sort of the concatenation, which
    # must equal device_shuffle_sort's above
    sched = DeviceSpanScheduler(NUM_PARTITIONS, key_width=12,
                                coalesce_records=n, paused=True,
                                device=device)
    with Launches("span_scheduler", totals) as ln, \
            Phase("span_scheduler", n * 20, device, split=False):
        for sid, (sids, svals) in enumerate(zip(span_ids, span_vals)):
            sched.submit_ragged(sid, vocab[sids].reshape(-1),
                                np.arange(len(sids) + 1, dtype=np.int64) * 12,
                                svals.reshape(-1), 8)
        sched.resume()
        res = sched.results()
    ln.require(device, "fnv_hash_bytes")
    check(res[0] is res[1] and res[0][5] == n,
          "span_scheduler: the spans did not coalesce")
    got = res[0]
    for label, g, w in (("sorted partitions", got[0][:n], golden[0]),
                        ("sorted lanes", got[1][:n], golden[1]),
                        ("sorted values", got[2][:n], golden[2]),
                        ("perm", got[3][:n], golden[3]),
                        ("counts", got[4], golden[4])):
        check(np.array_equal(g.view(w.dtype) if g.dtype.itemsize ==
                             w.dtype.itemsize else g, w),
              f"span_scheduler: {label} differ from device_shuffle_sort")
    log(f"span_scheduler: {n} records in 2 spans identical to "
        f"device_shuffle_sort")
    del sched, res, got, golden, keys

    # -- phase 6: combiner leg, on the async plane with the precombine -------
    words, wmat, wlens = word_vocab(rng)
    word_part = fnv_np(wmat, wlens) % NUM_PARTITIONS
    totals_w = np.zeros(len(words), dtype=np.int64)
    producer_batches, records, nbytes, distinct = [], 0, 0, 0
    for _p in range(args.producers):
        spans = [word_batch(rng, wmat, wlens, span_bytes) for _s in range(2)]
        for batch, ids in spans:
            totals_w += np.bincount(ids, minlength=len(words))
            records += batch.num_records
            distinct += len(np.unique(ids))
            nbytes += int(batch.key_offsets[-1]) + int(batch.val_offsets[-1])
        producer_batches.append([b for b, _i in spans])
    pipelines, counters = [], TezCounters()
    with Launches("combiner", totals) as ln, \
            Phase("combiner", nbytes, device, split=False):
        runs = produce(producer_batches, 16, span_bytes,
                       combiner=sum_long_combiner, device=device,
                       pipelines=pipelines, counters=counters,
                       pipeline_depth=2)
        del producer_batches
        final = sum_long_combiner(merge_sorted_runs(
            runs, NUM_PARTITIONS, 16, device=device))
    ln.require(device, "fnv_hash_lanes", "merge_path_pair")
    check_fault_free("combiner", pipelines, [counters])
    cin = counters.find_counter(TaskCounter.COMBINE_INPUT_RECORDS).value
    cout = counters.find_counter(TaskCounter.COMBINE_OUTPUT_RECORDS).value
    check(cin == records, f"combiner: COMBINE_INPUT_RECORDS {cin} != "
                          f"{records} records")
    check(cout == distinct, f"combiner: COMBINE_OUTPUT_RECORDS {cout} != "
                            f"{distinct} distinct words per span")
    golden = collections.Counter(
        {words[i]: int(c) for i, c in enumerate(totals_w) if c})
    index = {w: i for i, w in enumerate(words)}
    b = final.batch
    counts = (np.frombuffer(b.val_bytes.tobytes(), ">u8").astype(np.uint64)
              ^ np.uint64(1 << 63)).astype(np.int64)
    got = collections.Counter()
    for p in range(NUM_PARTITIONS):
        prev = None
        for i in range(int(final.row_index[p]), int(final.row_index[p + 1])):
            k = b.key(i)
            check(prev is None or prev < k,
                  "combiner: keys not strictly increasing in a partition")
            check(word_part[index[k]] == p,
                  "combiner: key in the wrong partition")
            got[k] = int(counts[i])
            prev = k
    check(got == golden, "combiner: counts differ from the Counter golden")
    log(f"combiner: {records} records -> precombined to {cout} -> "
        f"{len(got)} words, COMBINE_INPUT_RECORDS={cin} "
        f"COMBINE_OUTPUT_RECORDS={cout}, counts equal to the Counter golden")
    return dict(totals)


# ---------------------------------------------------------------------------
# phase 7: the containment ladder on the card
# ---------------------------------------------------------------------------
def containment_phase(args, device="cuda", hang_ms: int = 60_000,
                      span_mb: float = 16) -> dict:
    """One producer x 6 spans through DeviceSorter(pipeline_depth=2), once
    fault-free and once under each fault spec; every flush must be byte
    for byte the fault-free one and the named counters must move.  Returns
    the kernel launches of the phase."""
    from tez_tpu_torch.common import faults
    from tez_tpu_torch.common.counters import TezCounters
    from tez_tpu_torch.ops import kernels
    from tez_tpu_torch.ops.async_stage import (CircuitBreaker,
                                               reset_process_breaker)
    from tez_tpu_torch.ops.sorter import DeviceSorter
    span_bytes = int(span_mb * (1 << 20))
    rng = np.random.default_rng(args.seed + 7)
    vocab = bench_vocab()
    batches = [bench_batch(rng, vocab, span_records(span_bytes))[0]
               for _ in range(6)]
    clock = SettableClock()
    phase_launches: collections.Counter = collections.Counter()

    def run(label, spec, breaker=None, before=None, **kw):
        faults.clear_all()
        reset_process_breaker()
        if spec:
            faults.install("smoke", faults.parse_spec(spec))
        counters = TezCounters()
        kernels.reset_launches()
        t0 = time.perf_counter()
        s = DeviceSorter(num_partitions=NUM_PARTITIONS, key_width=12,
                         span_budget_bytes=span_bytes, engine="device",
                         pipeline_depth=2, counters=counters, device=device,
                         breaker=breaker, **kw)
        pipe = s._ensure_pipeline()
        for i, batch in enumerate(batches):
            if before and i in before:
                before[i](pipe)
            s.write_batch(batch)
        out = s.flush()
        wall = time.perf_counter() - t0
        faults.clear_all()
        phase_launches.update(kernels.launches)
        fo = failover_counters(counters)
        log(f"containment {label}: wall_s={wall:.3f} spec={spec!r} "
            f"stats={json.dumps(pipe.stats.to_dict())} "
            f"DeviceFailover={json.dumps(fo)} "
            f"completion_order={pipe.completion_order}")
        return out, pipe, fo, wall

    base, pipe, fo, _ = run("fault-free", "")
    check_fault_free("containment fault-free", [pipe], [])
    check(not any(fo.values()), f"containment fault-free: counters {fo}")
    check(not is_cuda(device) or (kernels.launches["fnv_hash_lanes"] > 0
                                  and kernels.launches["merge_path_pair"] > 0),
          f"containment fault-free: launches {kernels.launches}")
    want = run_bytes(base)

    def same(label, out):
        check(run_bytes(out) == want,
              f"containment {label}: flush differs from the fault-free one")

    out, pipe, fo, _ = run(
        "delay", "device.dispatch.delay:delay:ms=1500,n=1,match=span=0")
    same("delay", out)
    check(pipe.completion_order[0] != 0,
          f"containment delay: completion order not perturbed "
          f"{pipe.completion_order}")
    check(pipe.stats.failovers == 0, "containment delay: failover")

    out, pipe, fo, _ = run(
        "oom", "device.dispatch.oom:fail:n=1,exc=runtime,match=span=1")
    same("oom", out)
    check(fo.get("device.oom.split_attempts") == 1 and
          fo.get("device.oom.split_success") == 1 and
          pipe.stats.oom_splits == 1 and pipe.stats.failovers == 0 and
          not fo.get("device.failover.spans"),
          f"containment oom: split ladder counters {fo}")

    out, pipe, fo, _ = run(
        "readback", "device.readback.fail:fail:n=1,exc=io,match=span=2")
    same("readback", out)
    check(fo.get("device.failover.spans") == 1,
          f"containment readback: failover counters {fo}")

    out, pipe, fo, wall = run(
        "hang", f"device.dispatch.hang:delay:ms={hang_ms},n=1,match=span=1",
        watchdog_dispatch_ms=500)
    same("hang", out)
    check(fo.get("device.watchdog.fires") == 1 and
          fo.get("device.watchdog.dispatch_fires") == 1,
          f"containment hang: watchdog counters {fo}")
    check(wall < hang_ms / 1e3 / 2,
          f"containment hang: flush took {wall:.1f} s, not bounded by the "
          f"watchdog")

    def completed(pipe, n):
        deadline = time.monotonic() + 300
        while pipe.stats.completed < n:
            check(pipe.error is None and time.monotonic() < deadline,
                  f"containment breaker: spans 0-{n - 1} did not complete")
            time.sleep(0.01)

    def cool_down(pipe):
        # spans 2-3 short-circuited to the host while the breaker's clock
        # stood still; now let the cooldown pass: span 4 is the half-open
        # probe
        completed(pipe, 4)
        clock.advance(10.0)

    # spans 0-1 fail their readback and trip the breaker before span 2 is
    # written, so no device success can close it early
    br = CircuitBreaker(failures=2, cooldown_ms=1000, clock=clock)
    out, pipe, fo, _ = run(
        "breaker", "device.readback.fail:fail:n=2,exc=io", breaker=br,
        before={2: lambda pipe: completed(pipe, 2), 4: cool_down})
    same("breaker", out)
    check(fo.get("device.breaker.trips") == 1 and
          fo.get("device.breaker.short_circuits", 0) >= 2 and
          fo.get("device.breaker.recoveries") == 1 and br.probes == 1 and
          br.state == "closed",
          f"containment breaker: counters {fo}, probes {br.probes}, "
          f"state {br.state}")
    reset_process_breaker()
    log("containment: 5 fault runs byte-identical to the fault-free flush, "
        "each with its counters moved")
    return dict(phase_launches)


# ---------------------------------------------------------------------------
# phase 8: the spilling map side and the streamed final merge
# ---------------------------------------------------------------------------
def bulk_word_vocab(rng, size: int) -> tuple:
    """`size` distinct lowercase words of 1-16 bytes, drawn in bulk and
    deduplicated in draw order: (uint8[size, 16] zero padded, lengths)."""
    mat = np.zeros((0, 16), dtype=np.uint8)
    while len(mat) < size:
        m = size - len(mat) + size // 50 + 16
        lens = rng.integers(1, 17, m)
        draw = rng.integers(97, 123, (m, 16), dtype=np.uint8)
        draw[np.arange(16)[None, :] >= lens[:, None]] = 0
        mat = np.concatenate([mat, draw])
        _, first = np.unique(mat.view(np.dtype((np.void, 16))).ravel(),
                             return_index=True)
        mat = mat[np.sort(first)]
    mat = np.ascontiguousarray(mat[:size])
    return mat, (mat != 0).sum(axis=1).astype(np.int64)


def indexed_word_batches(rng, mat, lens, span_bytes: int, kv_bytes: int = 0,
                         spans: int = 0):
    """Span-filling batches of Zipf(1.3) words whose values are each
    record's index in the stream as a big-endian long, until the stream
    holds kv_bytes of keys and values and at least `spans` batches.
    Returns (batches, ids)."""
    batches, ids, start, kv = [], [], 0, 0
    while kv < kv_bytes or len(batches) < spans:
        batch, bids = word_batch(rng, mat, lens, span_bytes)
        n = batch.num_records
        batch.val_bytes = np.arange(start, start + n, dtype=">u8")\
            .view(np.uint8)
        batches.append(batch)
        ids.append(bids)
        start += n
        kv += int(batch.key_offsets[-1]) + 8 * n
    return batches, np.concatenate(ids)


class SpillProbe:
    """Phase 8's witnesses, installed around the sorter module's spill
    write and merge calls: the path and size of every span file written,
    each block-merge round's records and engine (a round is on the card
    when the device.merge histogram moved during it), and the seconds of
    the streamed final merge."""

    def __init__(self):
        self.files, self.rounds = [], collections.Counter()
        self.merge_s = 0.0

    def __enter__(self):
        from tez_tpu_torch.common import metrics
        from tez_tpu_torch.ops import sorter
        save, merge = sorter.save_run_partitioned, sorter.merge_sorted_runs
        final = sorter.DeviceSorter._stream_final_merge
        self._saved = save, merge, final
        hist = metrics.registry().histogram

        def streaming(sorter_self, runs):
            t0 = time.perf_counter()
            try:
                return final(sorter_self, runs)
            finally:
                self.merge_s += time.perf_counter() - t0

        def saving(run, path, **kw):
            out = save(run, path, **kw)
            self.files.append((path, os.path.getsize(path)))
            return out

        def merging(runs, *a, **kw):
            c0 = hist("device.merge").count
            out = merge(runs, *a, **kw)
            where = "device" if hist("device.merge").count > c0 else "host"
            self.rounds[where] += 1
            self.rounds[where + "_records"] += out.batch.num_records
            return out

        sorter.save_run_partitioned, sorter.merge_sorted_runs = \
            saving, merging
        sorter.DeviceSorter._stream_final_merge = streaming
        return self

    def __exit__(self, *_):
        from tez_tpu_torch.ops import sorter
        (sorter.save_run_partitioned, sorter.merge_sorted_runs,
         sorter.DeviceSorter._stream_final_merge) = self._saved
        return False


def spill_producer(batches, span_bytes: int, device, root: str, codec=None,
                   mem_budget=None, label="spill") -> tuple:
    """One producer through DeviceSorter(pipeline_depth=2) with a fresh
    spill directory under `root`, flushed with flush_run.  Returns
    (FileRun, counters, spill directory, probe, seconds)."""
    from tez_tpu_torch.common.counters import TezCounters
    from tez_tpu_torch.ops.runformat import FileRun
    from tez_tpu_torch.ops.sorter import DeviceSorter
    spill_dir = tempfile.mkdtemp(dir=root)
    counters = TezCounters()
    s = DeviceSorter(num_partitions=NUM_PARTITIONS, key_width=16,
                     span_budget_bytes=span_bytes, spill_dir=spill_dir,
                     counters=counters, mem_budget_bytes=mem_budget,
                     engine="device", spill_codec=codec, pipeline_depth=2,
                     device=device)
    pipe = s._ensure_pipeline()
    with SpillProbe() as probe:
        t0 = time.perf_counter()
        for batch in batches:
            s.write_batch(batch)
        fr = s.flush_run()
        sync(device)
        wall = time.perf_counter() - t0
    check(isinstance(fr, FileRun),
          f"{label}: flush_run returned {type(fr).__name__}, not a FileRun")
    check(s.num_spills == len(batches),
          f"{label}: {s.num_spills} span sorts for {len(batches)} spans")
    check_fault_free(label, [pipe], [counters])
    return fr, counters, spill_dir, probe, wall


def check_spill_counters(label, fr, counters, spill_dir, probe,
                         records: int) -> dict:
    """The spill counters against the files: SPILLED_RECORDS = the
    records, one ADDITIONAL_SPILL_COUNT per span file, bytes read = the
    span files, bytes written = the span files + the final file's blocks
    (tez_tpu counts the final file less its magic and its partition
    index), and only the final file left."""
    from tez_tpu_torch.common.counters import TaskCounter
    from tez_tpu_torch.ops.runformat import PR_FOOTER_MAGIC, PR_MAGIC

    def value(c):
        return counters.find_counter(c).value
    span_bytes = sum(size for _p, size in probe.files)
    p = fr.num_partitions
    index_bytes = 4 + 8 * (p + 1) + 16 * p + 12 + len(PR_FOOTER_MAGIC)
    final_bytes = os.path.getsize(fr.path) - len(PR_MAGIC) - index_bytes
    got = {c.name: value(c) for c in (
        TaskCounter.SPILLED_RECORDS, TaskCounter.ADDITIONAL_SPILL_COUNT,
        TaskCounter.ADDITIONAL_SPILLS_BYTES_READ,
        TaskCounter.ADDITIONAL_SPILLS_BYTES_WRITTEN,
        TaskCounter.HOST_SPILL_BYTES)}
    want = {"SPILLED_RECORDS": records,
            "ADDITIONAL_SPILL_COUNT": len(probe.files),
            "ADDITIONAL_SPILLS_BYTES_READ": span_bytes,
            "ADDITIONAL_SPILLS_BYTES_WRITTEN": span_bytes + final_bytes,
            "HOST_SPILL_BYTES": span_bytes}
    check(got == want, f"{label}: counters {got} != {want}")
    check(len(probe.files) >= 1, f"{label}: no span spilled")
    left = os.listdir(spill_dir)
    check(left == [os.path.basename(fr.path)],
          f"{label}: spill directory holds {left}")
    return got


def file_run_partitions(fr) -> list:
    """Each partition of a FileRun as (key bytes, key offsets, value
    bytes)."""
    out = []
    for p in range(fr.num_partitions):
        b = fr.partition(p)
        out.append((b.key_bytes, b.key_offsets, b.val_bytes))
    return out


def spill_phase(args, device="cuda", producers: int = 4,
                producer_mb: float = SPILL_PRODUCER_MB,
                span_mb: float = SPILL_SPAN_MB,
                vocab_size: int = SPILL_VOCAB,
                zlib_span_mb: float = 16) -> dict:
    """Phase 8; returns the kernel launches of its spilling path."""
    import torch
    from tez_tpu_torch.common import metrics
    span_bytes = int(span_mb * (1 << 20))
    rng = np.random.default_rng(args.seed + 8)
    t0 = time.perf_counter()
    mat, lens = bulk_word_vocab(rng, vocab_size)
    part, rank = vocab_rank(mat, lens)
    log(f"spill: vocabulary of {vocab_size} words in "
        f"{time.perf_counter() - t0:.3f} s")
    # every spill directory lives under one temporary root, removed
    # whatever happens
    with tempfile.TemporaryDirectory(prefix="tez_spill_") as root:
        totals: collections.Counter = collections.Counter()
        hist = metrics.registry().histogram
        if is_cuda(device):
            torch.cuda.reset_peak_memory_stats()
        for i in range(producers):
            batches, ids = indexed_word_batches(
                rng, mat, lens, span_bytes, int(producer_mb * (1 << 20)))
            n, spans = len(ids), len(batches)
            kv = int(lens[ids].sum()) + 8 * n
            h0 = {h: (hist(h).count, hist(h).sum_ms)
                  for h in ("spill.write", "device.merge")}
            label = f"spill producer {i}"
            with Launches(label, totals) as ln:
                fr, counters, spill_dir, probe, wall = \
                    spill_producer(batches, span_bytes, device, root,
                               label=label)
            ln.require(device, "fnv_hash_lanes", "merge_path_pair")
            del batches
            got = check_spill_counters(label, fr, counters, spill_dir,
                                       probe, n)
            dh = {h: (hist(h).count - c, hist(h).sum_ms - m)
                  for h, (c, m) in h0.items()}
            log(f"phase {label}: wall_s={wall:.3f} "
                f"merge_s={probe.merge_s:.3f} spans={spans} records={n} "
                f"MB={kv / 1e6:.1f} MB_per_s={kv / 1e6 / wall:.1f}")
            log(f"{label}: disk bytes written "
                f"{got['ADDITIONAL_SPILLS_BYTES_WRITTEN']} read "
                f"{got['ADDITIONAL_SPILLS_BYTES_READ']} span files "
                f"{got['ADDITIONAL_SPILL_COUNT']} final file "
                f"{os.path.getsize(fr.path)}; histogram spill.write count="
                f"{dh['spill.write'][0]} sum_ms={dh['spill.write'][1]:.3f}; "
                f"device.merge count={dh['device.merge'][0]} sum_ms="
                f"{dh['device.merge'][1]:.3f} of merge_ms="
                f"{probe.merge_s * 1e3:.3f}; "
                f"merge rounds on the card {probe.rounds['device']} "
                f"({probe.rounds['device_records']} records), on the host "
                f"{probe.rounds['host']} ({probe.rounds['host_records']} "
                f"records); merge_path_pair launches "
                f"{ln.counts['merge_path_pair']}")
            # golden: a stable order by (partition, key) over vocabulary ranks
            t0 = time.perf_counter()
            order = np.argsort(rank[ids].astype(np.int32), kind="stable")
            counts = np.bincount(part[ids], minlength=NUM_PARTITIONS)
            at = 0
            for p, (kb, ko, vb) in enumerate(file_run_partitions(fr)):
                sel = order[at:at + counts[p]]
                at += counts[p]
                check(fr.partition_row_count(p) == counts[p],
                      f"{label}: partition {p} holds "
                      f"{fr.partition_row_count(p)} rows, golden {counts[p]}")
                check(np.array_equal(vb.view(">u8"), sel),
                      f"{label}: partition {p} record order differs from "
                      f"the golden")
                klen = lens[ids[sel]]
                check(np.array_equal(np.diff(ko), klen),
                      f"{label}: partition {p} key lengths")
                check(np.array_equal(kb, mat[ids[sel]][
                    np.arange(16)[None, :] < klen[:, None]]),
                      f"{label}: partition {p} key bytes")
            log(f"{label}: {n} records equal to the golden "
                f"(golden_s={time.perf_counter() - t0:.3f})")
            fr.delete()
            shutil.rmtree(spill_dir)
            del ids, order
        if is_cuda(device):
            log(f"spill: peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

        # zlib leg: the same records through a compressing twin
        zspan = int(zlib_span_mb * (1 << 20))
        batches, ids = indexed_word_batches(rng, mat, lens, zspan, spans=6)
        legs = {}
        for codec in (None, "zlib"):
            with Launches(f"spill {codec}", totals):
                fr, counters, spill_dir, probe, wall = spill_producer(
                    batches, zspan, device, root, codec=codec,
                    mem_budget=2 * zspan, label=f"spill {codec}")
            got = check_spill_counters(f"spill {codec}", fr, counters,
                                       spill_dir, probe, len(ids))
            legs[codec] = (file_run_partitions(fr),
                           got["ADDITIONAL_SPILLS_BYTES_WRITTEN"])
            log(f"spill {codec}: 6 spans of {zlib_span_mb} MB, wall_s="
                f"{wall:.3f}, disk bytes written "
                f"{got['ADDITIONAL_SPILLS_BYTES_WRITTEN']}")
            fr.delete()
            shutil.rmtree(spill_dir)
        for p, (a, b) in enumerate(zip(legs[None][0], legs["zlib"][0])):
            check(all(np.array_equal(x, y) for x, y in zip(a, b)),
                  f"spill zlib: partition {p} differs from the uncompressed")
        check(legs["zlib"][1] < legs[None][1],
              f"spill zlib: {legs['zlib'][1]} bytes written, not below "
              f"{legs[None][1]}")
    log(f"spill: {producers} producers equal to their goldens; zlib leg "
        f"equal to its twin in {legs['zlib'][1]} of {legs[None][1]} bytes")
    return dict(totals)


# ---------------------------------------------------------------------------
# phase 9: the reduce side's bounded-memory merge (ShuffleMergeManager)
# ---------------------------------------------------------------------------
#: tez_tpu's defaults for an ordered input (tez_tpu/library/inputs.py,
#: common/config.py): key width 16, engine auto (the device), the device
#: floor of 65,536 records, io.sort.factor 64, shuffle.merge.percent 0.9,
#: memory.limit.percent 0.25 and merge.async.depth 2; the budget is
#: fetch.buffer.percent 0.9 of io.sort.mb 256, and 8 fetch threads
#: commit (shuffle.parallel.copies)
MERGE_KNOBS = dict(key_width=16, engine="auto", merge_factor=64,
                   merge_threshold=0.9, max_single_fraction=0.25,
                   async_depth=2)
MERGE_FETCHERS = 8
#: phase 9's sizes.  Leg A is one reducer's input: 64 map segments of 8
#: MiB of keys and values, 2 skewed segments of 64 MiB (over the 0.25 x
#: budget single-batch limit, so they take the DISK target) and 4
#: disk-direct sources of 8 MiB, 672 MiB in all.  Leg B: 32 segments and
#: one skewed segment, committed in slot order (24 segments would cross
#: the merge threshold once: 13 segments of ~16.2 MiB with their offsets
#: pass 0.9 x 230.4 MiB, the other 11 do not).  Leg C: 48 segments of 1
#: MiB against a 16 MiB budget at merge factor 4.  Leg D: two sorters of
#: 4 spans of 16 MB each, a 16 MiB merge budget.
MERGE_SIZES = dict(vocab_size=SPILL_VOCAB, budget=int(256 * (1 << 20) * 0.9),
                   device_min_records=1 << 16, seg_mb=8, segments_a=64,
                   skew_mb=64, skews_a=2, locals_a=4, segments_b=32,
                   c_seg_mb=1, c_segments=48, c_budget_mb=16, d_vocab=100_000,
                   d_span_mb=16, d_spans=4, d_budget_mb=16, hang_ms=10_000)
#: the same legs at a size the plain versions run in seconds: every size
#: and the budgets cut 640 times, so each leg crosses its thresholds as
#: at full size, and a lower device floor keeps the merges on the device
#: engine
TINY_MERGE = dict(vocab_size=5000, budget=int(256 * (1 << 20) * 0.9) // 640,
                  device_min_records=512, seg_mb=8 / 640, segments_a=64,
                  skew_mb=64 / 640, skews_a=2, locals_a=4, segments_b=32,
                  c_seg_mb=1 / 640, c_segments=48, c_budget_mb=16 / 640,
                  d_vocab=2000, d_span_mb=1 / 32, d_spans=4,
                  d_budget_mb=1 / 48, hang_ms=2000)
MERGE_HISTOGRAMS = ("device.encode", "device.h2d", "device.d2h",
                    "device.merge", "device.failover.host_sort")


def key_rank(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Rank of every vocabulary word in raw byte order (big-endian lanes,
    then length)."""
    lanes = be_lanes(mat)
    order = np.lexsort((lens,) + tuple(lanes[:, i] for i in
                                       range(lanes.shape[1] - 1, -1, -1)))
    rank = np.empty(len(mat), dtype=np.int64)
    rank[order] = np.arange(len(mat))
    return rank


def ragged_keys(mat: np.ndarray, lens: np.ndarray):
    """(key bytes, key offsets) of rows of a zero-padded key matrix."""
    ko = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=ko[1:])
    return mat[np.arange(mat.shape[1])[None, :] < lens[:, None]], ko


def key_matrix(kb: np.ndarray, ko: np.ndarray) -> tuple:
    """Zero-padded uint8[n, 16] matrix and lengths of ragged keys."""
    klen = np.diff(ko)
    mat = np.zeros((len(klen), 16), dtype=np.uint8)
    mat[np.arange(16)[None, :] < klen[:, None]] = kb
    return mat, klen


def sorted_segment(rng, mat, lens, rank, kv_bytes: int, source: int):
    """One map segment: Zipf(1.3) words up to kv_bytes of keys and 8-byte
    values, sorted by key on the host (numpy, stable), each value the
    record's (source << 32 | index in the segment), big-endian.  Returns
    (KVBatch, word ids in segment order)."""
    from tez_tpu_torch.ops.runformat import KVBatch
    est = kv_bytes // 9 + 1          # a record holds at least 9 bytes
    ids = rng.zipf(ZIPF_A, est) % len(mat)
    n = int(np.searchsorted(np.cumsum(lens[ids] + 8), kv_bytes,
                            side="right"))
    ids = ids[:n]
    ids = ids[stable_order(rank[ids])]
    kb, ko = ragged_keys(mat[ids], lens[ids])
    vals = ((np.uint64(source) << np.uint64(32)) |
            np.arange(n, dtype=np.uint64)).astype(">u8").view(np.uint8)
    return KVBatch(kb, ko, vals, np.arange(n + 1, dtype=np.int64) * 8), ids


class MergeProbe:
    """Phase 9's witnesses, installed around one leg: each merge pass's
    engine and records (the sorter module's routing decision), the device
    part of the device merges (merge_path_runs: upload, kernels,
    readback), and the bytes the manager reads back from disk (its
    chunked runs whole, a disk-direct source's partition)."""

    def __init__(self):
        import threading
        self.lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.rounds = collections.Counter()
        self.read_bytes = 0
        self.device_calls, self.device_s = 0, 0.0

    def __enter__(self):
        from tez_tpu_torch.library import merge_manager as mm
        from tez_tpu_torch.ops import device as dev_ops
        from tez_tpu_torch.ops import sorter
        from tez_tpu_torch.ops.runformat import FileRun
        route, merge = sorter._route_engine, dev_ops.merge_path_runs
        blocks = mm.ShuffleMergeManager._block_iter
        self._saved = route, merge, blocks

        def routing(engine, n, *a, **kw):
            out = route(engine, n, *a, **kw)
            with self.lock:
                self.rounds[out] += 1
                self.rounds[out + "_records"] += n
            return out

        def merging(*a, **kw):
            t0 = time.perf_counter()
            try:
                return merge(*a, **kw)
            finally:
                with self.lock:
                    self.device_calls += 1
                    self.device_s += time.perf_counter() - t0

        def reading(mm_self, source):
            if isinstance(source, str):
                nbytes = os.path.getsize(source)
            elif isinstance(source, mm._FileSource):
                off = FileRun(source.path)._byte_off
                nbytes = int(off[source.partition + 1] -
                             off[source.partition])
            else:
                nbytes = 0
            with self.lock:
                self.read_bytes += nbytes
            return blocks(mm_self, source)

        sorter._route_engine = routing
        dev_ops.merge_path_runs = merging
        mm.ShuffleMergeManager._block_iter = reading
        return self

    def __exit__(self, *_):
        from tez_tpu_torch.library import merge_manager as mm
        from tez_tpu_torch.ops import device as dev_ops
        from tez_tpu_torch.ops import sorter
        (sorter._route_engine, dev_ops.merge_path_runs,
         mm.ShuffleMergeManager._block_iter) = self._saved
        return False


class MergeLeg:
    """One run of a phase-9 leg: zeroes the kernel launch counts, the peak
    device memory and the histograms' baseline before it, and prints after
    it the wall seconds and MB/s of KV, the merges on the card and on the
    host, the histograms of the merge lane, disk written and read, peak
    device memory and the launches; requires merge_path_pair > 0 and no
    merge_rank on the card."""

    def __init__(self, label, kv_bytes, device, totals, counters,
                 require=("merge_path_pair",)):
        self.label, self.kv, self.device = label, kv_bytes, device
        self.totals, self.counters, self.names = totals, counters, require

    def __enter__(self):
        import torch
        from tez_tpu_torch.common import metrics
        hist = metrics.registry().histogram
        self.h0 = {h: (hist(h).count, hist(h).sum_ms)
                   for h in MERGE_HISTOGRAMS}
        if is_cuda(self.device):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.launches = Launches(self.label, self.totals).__enter__()
        self.probe = MergeProbe().__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        import torch
        from tez_tpu_torch.common import metrics
        from tez_tpu_torch.common.counters import TaskCounter
        sync(self.device)
        wall = time.perf_counter() - self.t0
        self.probe.__exit__(exc_type, *exc)
        self.launches.__exit__(exc_type, *exc)
        if exc_type is not None:
            return False
        self.wall = wall
        hist = metrics.registry().histogram
        dh = {h: (hist(h).count - c, hist(h).sum_ms - m)
              for h, (c, m) in self.h0.items()}
        p = self.probe
        peak = torch.cuda.max_memory_allocated() / 2**30 \
            if is_cuda(self.device) else float("nan")
        written = self.counters.find_counter(
            TaskCounter.ADDITIONAL_SPILLS_BYTES_WRITTEN).value
        log(f"phase merge {self.label}: wall_s={wall:.3f} "
            f"MB={self.kv / 1e6:.1f} MB_per_s={self.kv / 1e6 / wall:.1f}")
        log(f"merge {self.label}: merge passes on the card "
            f"{p.rounds['device']} ({p.rounds['device_records']} records), "
            f"on the host {p.rounds['host']} ({p.rounds['host_records']} "
            f"records); merge_path_runs count={p.device_calls} "
            f"sum_ms={p.device_s * 1e3:.3f}; disk bytes written {written} "
            f"read {p.read_bytes}; peak device memory {peak:.3f} GiB; "
            + "; ".join(f"histogram {h} count={c} sum_ms={m:.3f}"
                        for h, (c, m) in dh.items()))
        self.launches.require(self.device, *self.names)
        return False


def merged_stream_digest(blocks, on_block=None) -> tuple:
    """sha256 of a merged stream's key bytes, key lengths and value bytes
    (each independent of where the blocks are cut), and its record count;
    on_block(batch) sees every block."""
    import hashlib
    hk, hl, hv, n = hashlib.sha256(), hashlib.sha256(), hashlib.sha256(), 0
    for b in blocks:
        hk.update(b.key_bytes.tobytes())
        hl.update(np.diff(b.key_offsets).astype(np.int64).tobytes())
        hv.update(b.val_bytes.tobytes())
        n += b.num_records
        if on_block is not None:
            on_block(b)
    return hk.hexdigest(), hl.hexdigest(), hv.hexdigest(), n


def merge_counters(counters) -> dict:
    """The manager's counters that do not measure time."""
    return {g: {c: v for c, v in cs.items() if "MILLI" not in c}
            for g, cs in counters.to_dict().items()
            if not g.startswith("LatencyHistogram")}


def check_merge_fault_free(label, mm, counters, breaker) -> None:
    from tez_tpu_torch.ops.async_stage import COUNTER_GROUP
    if mm._pipeline is not None:
        st = mm._pipeline.stats
        check(st.failovers == 0 and st.watchdog_fires == 0 and
              st.oom_splits == 0,
              f"{label}: fault-free run took the containment ladder "
              f"{st.to_dict()}")
    moved = {k: v for k, v in counters.to_dict().get(COUNTER_GROUP,
                                                      {}).items() if v}
    check(not moved, f"{label}: DeviceFailover counters moved {moved}")
    check(breaker.state == "closed" and breaker.trips == 0,
          f"{label}: breaker {breaker.state}, {breaker.trips} trips")


def merge_manager_for(counters, budget, spill_dir, device, breaker,
                      **kw):
    from tez_tpu_torch.library.merge_manager import ShuffleMergeManager
    return ShuffleMergeManager(counters, budget, spill_dir, breaker=breaker,
                               device=device, **dict(MERGE_KNOBS, **kw))


def fresh_breaker():
    """A breaker with the library's defaults, one a run: a fault-free run
    must leave it closed with no trips."""
    from tez_tpu_torch.ops import sorter
    from tez_tpu_torch.ops.async_stage import CircuitBreaker
    return CircuitBreaker(failures=sorter.DEVICE_BREAKER_FAILURES,
                          cooldown_ms=sorter.DEVICE_BREAKER_COOLDOWN_MS)


def paced_commits(mm, batches) -> None:
    """One fetch thread commits in slot order and waits after each commit
    until the merger is idle, so which batches each merge takes does not
    depend on thread timing."""
    for slot, b in enumerate(batches):
        check(mm.commit(slot, b), f"commit {slot} dropped")
        check(mm.quiesce(timeout=600), "merger never went idle")


def merge_leg_a(sz, rng, vocab, device, root, totals) -> None:
    """Leg A: one reducer's input through 8 fetch threads."""
    import queue
    import threading
    from tez_tpu_torch.common.counters import TezCounters
    from tez_tpu_torch.ops.runformat import PartitionedRunWriter
    mat, lens, rank = vocab
    mib = 1 << 20
    segs, ids = [], []
    t0 = time.perf_counter()
    for s in range(sz["segments_a"] + sz["skews_a"] + sz["locals_a"]):
        mb = sz["skew_mb"] if sz["segments_a"] <= s < \
            sz["segments_a"] + sz["skews_a"] else sz["seg_mb"]
        batch, sids = sorted_segment(rng, mat, lens, rank, int(mb * mib), s)
        segs.append(batch)
        ids.append(sids)
    skews = range(sz["segments_a"], sz["segments_a"] + sz["skews_a"])
    locals_ = range(sz["segments_a"] + sz["skews_a"], len(segs))
    # each disk-direct source is partition s % 4 of a producer's
    # partition-indexed file (the other partitions belong to other
    # reducers; empty here)
    work = []
    for s in range(len(segs)):
        if s in locals_:
            path = os.path.join(root, f"producer_{s}.prun")
            w = PartitionedRunWriter(path, NUM_PARTITIONS)
            w.append(segs[s], s % NUM_PARTITIONS)
            w.close()
            work.append(("file", s, path, segs[s].nbytes))
            segs[s] = None
        else:
            work.append(("mem", s, segs[s], segs[s].nbytes))
    order = rng.permutation(len(work))
    counts = np.array([len(i) for i in ids], dtype=np.int64)
    base = np.zeros(len(ids) + 1, dtype=np.int64)
    np.cumsum(counts, out=base[1:])
    all_ids = np.concatenate(ids)
    total = int(base[-1])
    kv = int(lens[all_ids].sum()) + 8 * total
    skew_bytes = sum(work[s][3] for s in skews)
    log(f"merge A: {len(work)} sources, {total} records, {kv} bytes of KV "
        f"({kv / mib:.1f} MiB), made in {time.perf_counter() - t0:.3f} s")
    q: "queue.Queue" = queue.Queue()
    for i in order:
        q.put(work[i])
    del work, segs
    spill_dir = tempfile.mkdtemp(dir=root)
    counters, breaker = TezCounters(), fresh_breaker()
    errors = []

    def fetcher():
        try:
            while True:
                try:
                    kind, slot, obj, nbytes = q.get_nowait()
                except queue.Empty:
                    return
                ok = mm.commit(slot, obj) if kind == "mem" else \
                    mm.commit_local_file(slot, obj, slot % NUM_PARTITIONS,
                                         nbytes)
                check(ok, f"merge A: commit of source {slot} dropped")
        except BaseException as e:   # noqa: BLE001 -- re-raised below
            errors.append(e)

    # each record's position in the merged stream, by its index in the
    # input; the rank of the last key seen; blocks whose checks failed
    pos = np.full(total, -1, dtype=np.int64)
    at, last_rank, bad = [0], [0], []

    def on_block(b):
        v = b.val_bytes.view(">u8")
        src = (v >> np.uint64(32)).astype(np.int64)
        g = base[src] + (v & np.uint64(0xFFFFFFFF)).astype(np.int64)
        out_ids = all_ids[g]
        kb, ko = ragged_keys(mat[out_ids], lens[out_ids])
        if not (np.array_equal(b.key_offsets - b.key_offsets[0], ko) and
                np.array_equal(b.key_bytes[:len(kb)], kb)):
            bad.append(at[0])
        pos[g] = np.arange(at[0], at[0] + len(g))
        r = rank[out_ids]
        if len(r) and (r[0] < last_rank[0] or bool((np.diff(r) < 0).any())):
            bad.append(at[0])
        if len(r):
            last_rank[0] = r[-1]
        at[0] += len(g)

    with MergeLeg("A", kv, device, totals, counters) as leg:
        mm = merge_manager_for(counters, sz["budget"], spill_dir, device,
                               breaker, instrument=True,
                               device_min_records=sz["device_min_records"])
        threads = [threading.Thread(target=fetcher, name=f"fetch-{i}")
                   for i in range(MERGE_FETCHERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        t_fin = time.perf_counter()
        result = mm.finish()
        check(result.is_streaming, "merge A: the final merge is not "
                                   "streamed")
        digest = merged_stream_digest(result.stream.iter_batches(),
                                      on_block)
        log(f"merge A: commits {t_fin - leg.t0:.3f} s, finish and the "
            f"streamed final merge {time.perf_counter() - t_fin:.3f} s")
    c = merge_counters(counters)["TaskCounter"]
    log(f"merge A: counters {json.dumps(c)}")
    check(digest[3] == total, f"merge A: {digest[3]} records of {total}")
    check(not bad, f"merge A: keys or order wrong in blocks at {bad[:5]}")
    # every record once, and each source's records in the source's order
    check(bool((pos >= 0).all()), "merge A: records missing")
    inner = np.ones(total - 1, dtype=bool)
    inner[base[1:-1] - 1] = False
    check(bool((np.diff(pos)[inner] > 0).all()),
          "merge A: a source's records left their order")
    check(c.get("NUM_MEM_TO_DISK_MERGES", 0) >= 3,
          f"merge A: {c.get('NUM_MEM_TO_DISK_MERGES')} mem->disk merges")
    check(c.get("SHUFFLE_BYTES_TO_DISK") == skew_bytes,
          f"merge A: SHUFFLE_BYTES_TO_DISK {c.get('SHUFFLE_BYTES_TO_DISK')}"
          f" != {skew_bytes}")
    check_merge_fault_free("merge A", mm, counters, breaker)
    # the lane runs each whole merge in its dispatch stage: far inside the
    # dispatch watchdog (the sorter's default, 60 s)
    edges = {(ids, stage, edge): t
             for ids, stage, edge, t in mm.pipeline_events()}
    dispatch_s = sorted(edges[(ids, st, "end")] - t
                        for (ids, st, edge), t in edges.items()
                        if st == "device.dispatch" and edge == "start")
    log(f"merge A: the lane's dispatch stage per merge, seconds: "
        f"{[round(d, 3) for d in dispatch_s]}")
    check(len(dispatch_s) == c["NUM_MEM_TO_DISK_MERGES"] and
          (not is_cuda(device) or max(dispatch_s) < 15.0),
          f"merge A: dispatch stages {dispatch_s} (a quarter of the 60 s "
          f"watchdog is 15 s)")
    log(f"merge A: {total} records in key order, each source in its own "
        f"order, {c['NUM_MEM_TO_DISK_MERGES']} mem->disk merges, "
        f"{sz['skews_a']} DISK admissions, peak host batches "
        f"{mm.peak_mem_bytes} of a {sz['budget']} byte budget")
    mm.cleanup()
    shutil.rmtree(spill_dir)


def merge_leg_b_c_e(sz, rng, vocab, device, root, totals) -> None:
    """Legs B, C and E: paced commits, async_depth 2 against 0, and B's
    input under the merge lane's faults."""
    from tez_tpu_torch.common import faults
    from tez_tpu_torch.common.counters import TezCounters
    from tez_tpu_torch.ops.async_stage import CircuitBreaker, COUNTER_GROUP
    mat, lens, rank = vocab
    mib = 1 << 20

    def segments(n, mb, skew_at=None):
        out = []
        for s in range(n + (skew_at is not None)):
            big = skew_at is not None and s == skew_at
            out.append(sorted_segment(rng, mat, lens, rank,
                                      int((sz["skew_mb"] if big else mb)
                                          * mib), s)[0])
        return out

    def run(label, batches, budget, breaker=None, spec=None, **kw):
        faults.clear_all()
        if spec:
            faults.install("smoke", faults.parse_spec(spec))
        spill_dir = tempfile.mkdtemp(dir=root)
        counters = TezCounters()
        breaker = breaker or fresh_breaker()
        kv = sum(int(b.key_offsets[-1] + b.val_offsets[-1]) for b in batches)
        try:
            with MergeLeg(label, kv, device, totals, counters):
                mm = merge_manager_for(
                    counters, budget, spill_dir, device, breaker,
                    device_min_records=sz["device_min_records"], **kw)
                paced_commits(mm, batches)
                result = mm.finish()
                digest = merged_stream_digest(
                    result.stream.iter_batches() if result.is_streaming
                    else [result.batch])
        finally:
            faults.clear_all()
        mm.cleanup()
        shutil.rmtree(spill_dir)
        return digest, mm, counters, breaker

    # -- B: determinism across async depths ---------------------------------
    b_in = segments(sz["segments_b"], sz["seg_mb"],
                    skew_at=sz["segments_b"] // 2)
    outs = {}
    for depth in (2, 0):
        outs[depth] = run(f"B depth {depth}", b_in, sz["budget"],
                          async_depth=depth)
        check_merge_fault_free(f"merge B depth {depth}", outs[depth][1],
                               outs[depth][2], outs[depth][3])
    (d2, mm2, c2, _), (d0, _mm0, c0, _) = outs[2], outs[0]
    check(d2 == d0, "merge B: depth 2 and depth 0 merged different bytes")
    check(merge_counters(c2) == merge_counters(c0),
          f"merge B: counters differ {merge_counters(c2)} vs "
          f"{merge_counters(c0)}")
    cb = merge_counters(c2)["TaskCounter"]
    check(cb.get("NUM_MEM_TO_DISK_MERGES", 0) >= 2 and
          cb.get("SHUFFLE_BYTES_TO_DISK") == b_in[sz["segments_b"] // 2]
          .nbytes, f"merge B: counters {cb}")
    check(d2[3] == sum(b.num_records for b in b_in), "merge B: records")
    log(f"merge B: depth 2 and depth 0 byte-identical ({d2[3]} records), "
        f"counters identical {json.dumps(cb)}")

    # -- E: B's input under the merge lane's faults --------------------------
    d, mm, c, _br = run("E oom", b_in, sz["budget"],
                        spec="device.dispatch.oom:fail:n=1,exc=runtime,"
                             "match=span=0",
                        breaker=CircuitBreaker(failures=100))
    fo = c.to_dict().get(COUNTER_GROUP, {})
    check(d == d2, "merge E oom: output differs from leg B's")
    check(fo.get("device.oom.split_attempts") == 1 and
          fo.get("device.oom.split_success") == 1 and
          not fo.get("device.failover.spans") and
          mm._pipeline.stats.failovers == 0,
          f"merge E oom: split ladder counters {fo}")
    log(f"merge E oom: split on the card, no failover, byte-identical "
        f"{json.dumps(fo)}")
    t0 = time.perf_counter()
    d, mm, c, _br = run("E hang", b_in, sz["budget"],
                        spec=f"device.dispatch.hang:delay:ms="
                             f"{sz['hang_ms']},n=1,match=span=0",
                        breaker=CircuitBreaker(failures=100),
                        watchdog_dispatch_ms=500)
    fo = c.to_dict().get(COUNTER_GROUP, {})
    # the abandoned dispatch sleeps out its hang on the lane's staging
    # thread: wait for it, so that no thread of the phase outlives it
    staging = mm._pipeline._staging
    staging.join(timeout=sz["hang_ms"] / 1e3 + 60)
    check(not staging.is_alive(), "merge E hang: the staging thread never "
                                  "came back from the hang")
    check(d == d2, "merge E hang: output differs from leg B's")
    check(fo.get("device.watchdog.dispatch_fires") == 1 and
          fo.get("device.failover.spans", 0) >= 1,
          f"merge E hang: watchdog counters {fo}")
    log(f"merge E hang: {sz['hang_ms']} ms hang against a 500 ms watchdog, "
        f"host failover, byte-identical, {time.perf_counter() - t0:.3f} s "
        f"with the wait for the hang to end {json.dumps(fo)}")
    br = CircuitBreaker(failures=1, cooldown_ms=3_600_000)
    d, mm, c, _br = run("E breaker", b_in, sz["budget"], breaker=br,
                        spec="device.readback.fail:fail:n=1,exc=io,"
                             "match=span=0")
    fo = c.to_dict().get(COUNTER_GROUP, {})
    check(d == d2, "merge E breaker: output differs from leg B's")
    check(br.trips == 1 and br.state == "open" and
          fo.get("device.breaker.short_circuits", 0) >= 1 and
          fo.get("device.failover.spans", 0) >= 2,
          f"merge E breaker: {br.trips} trips, state {br.state}, {fo}")
    log(f"merge E breaker: tripped once, later merges short-circuited to "
        f"the host, byte-identical {json.dumps(fo)}")
    del b_in

    # -- C: the disk cascade --------------------------------------------------
    c_in = segments(sz["c_segments"], sz["c_seg_mb"])
    budget = int(sz["c_budget_mb"] * mib)
    outs = {depth: run(f"C depth {depth}", c_in, budget, merge_factor=4,
                       async_depth=depth) for depth in (2, 0)}
    for depth, (_d, mm, c, br) in outs.items():
        check_merge_fault_free(f"merge C depth {depth}", mm, c, br)
    check(outs[2][0] == outs[0][0],
          "merge C: depth 2 and depth 0 merged different bytes")
    cc = merge_counters(outs[2][2])["TaskCounter"]
    check(cc.get("NUM_DISK_TO_DISK_MERGES", 0) >= 1,
          f"merge C: no disk cascade on the async lane {cc}")
    log(f"merge C: depth 2 and depth 0 byte-identical "
        f"({outs[2][0][3]} records), counters {json.dumps(cc)}")


def normalized_nondecreasing(kb, ko, which: str) -> bool:
    """True when ragged keys are in order under the normalizer `which`
    ("case": ASCII lower case; "reverse": complemented bytes, shorter
    first among prefixes)."""
    mat, klen = key_matrix(kb, ko)
    if which == "case":
        mat = mat + ((mat >= 65) & (mat <= 90)).astype(np.uint8) * 32
    else:
        mat = np.where(np.arange(16)[None, :] < klen[:, None], 255 - mat, 0)\
            .astype(np.uint8)
    w = mat.view(">u8").astype(np.uint64)
    hi, lo = w[:, 0], w[:, 1]
    le = (hi[:-1] < hi[1:]) | ((hi[:-1] == hi[1:]) & (
        (lo[:-1] < lo[1:]) | ((lo[:-1] == lo[1:]) &
                              (klen[:-1] <= klen[1:]))))
    return bool(le.all())


def merge_leg_d(sz, rng, device, root, totals) -> None:
    """Leg D: two spilling sorters and one manager under each comparator."""
    from tez_tpu_torch.common.counters import TezCounters
    from tez_tpu_torch.library.comparators import (
        CaseInsensitiveKeyComparator, ReverseByteKeyComparator)
    from tez_tpu_torch.ops.runformat import FileRun, KVBatch
    from tez_tpu_torch.ops.sorter import DeviceSorter
    mat, lens = bulk_word_vocab(rng, sz["d_vocab"])
    span_bytes = int(sz["d_span_mb"] * (1 << 20))
    inputs = []
    for sorter_id in range(2):
        keys, spans = [], []
        start = 0
        for _span in range(sz["d_spans"]):
            est = span_bytes // 25 + 1
            ids = rng.zipf(ZIPF_A, est) % len(mat)
            acct = np.cumsum(lens[ids] + 8 + 16) + 16
            n = int(np.searchsorted(acct, span_bytes)) + 1
            check(n <= est, "merge D: span estimate too small")
            ids = ids[:n]
            # mixed case: each letter upper case with probability 1/4
            m = mat[ids] - (rng.random((n, 16)) < 0.25).astype(np.uint8) * \
                (mat[ids] > 0) * np.uint8(32)
            kb, ko = ragged_keys(m, lens[ids])
            vals = ((np.uint64(sorter_id) << np.uint64(32)) |
                    np.arange(start, start + n, dtype=np.uint64))\
                .astype(">u8").view(np.uint8)
            spans.append(KVBatch(kb, ko, vals,
                                 np.arange(n + 1, dtype=np.int64) * 8))
            keys.append(m)
            start += n
        inputs.append((spans, np.concatenate(keys)))
    for which, cmp in (("case", CaseInsensitiveKeyComparator),
                       ("reverse", ReverseByteKeyComparator)):
        norm = cmp().normalize
        counters = TezCounters()
        kv = sum(int(b.key_offsets[-1] + b.val_offsets[-1])
                 for spans, _k in inputs for b in spans)
        with MergeLeg(f"D {which}", kv, device, totals, counters,
                      require=("merge_path_pair", "fnv_hash_bytes")) as leg:
            files = []
            for spans, _k in inputs:
                s = DeviceSorter(num_partitions=NUM_PARTITIONS, key_width=16,
                                 span_budget_bytes=span_bytes,
                                 spill_dir=tempfile.mkdtemp(dir=root),
                                 engine="device", pipeline_depth=2,
                                 key_normalizer=norm, device=device)
                for b in spans:
                    s.write_batch(b)
                fr = s.flush_run()
                check(isinstance(fr, FileRun) and
                      s.num_spills == sz["d_spans"],
                      f"merge D {which}: {s.num_spills} spans, "
                      f"{type(fr).__name__}")
                files.append(fr)
            t_map = time.perf_counter() - leg.t0
            leg.probe.reset()         # the merges below are the manager's
            spill_dir = tempfile.mkdtemp(dir=root)
            breaker = fresh_breaker()
            mm = merge_manager_for(
                counters, int(sz["d_budget_mb"] * (1 << 20)), spill_dir,
                device, breaker, key_normalizer=norm,
                device_min_records=sz["device_min_records"])
            slot = 0
            for p in range(NUM_PARTITIONS):       # producer 0: fetched
                for block in files[0].iter_partition_blocks(p):
                    check(mm.commit(slot, block), "merge D: commit dropped")
                    slot += 1
            for p in range(NUM_PARTITIONS):       # producer 1: disk-direct
                check(mm.commit_local_file(slot, files[1].path, p,
                                           files[1].partition_nbytes(p)),
                      "merge D: disk-direct source dropped")
                slot += 1
            result = mm.finish()
            out = [b for b in (result.stream.iter_batches()
                               if result.is_streaming else [result.batch])]
        log(f"merge D {which}: map side (two sorters) {t_map:.3f} s (the "
            f"merge passes printed are the manager's), "
            f"streamed={result.is_streaming}, counters "
            f"{json.dumps(merge_counters(counters)['TaskCounter'])}")
        check_merge_fault_free(f"merge D {which}", mm, counters, breaker)
        # the map side: every record in the partition of its raw bytes'
        # FNV, each partition in normalized order
        for i, fr in enumerate(files):
            for p in range(NUM_PARTITIONS):
                b = fr.partition(p)
                m, klen = key_matrix(b.key_bytes, b.key_offsets)
                check(bool((fnv_np(m, klen) % NUM_PARTITIONS == p).all()),
                      f"merge D {which}: sorter {i} partition {p} holds "
                      f"keys of another partition")
                check(normalized_nondecreasing(b.key_bytes, b.key_offsets,
                                               which),
                      f"merge D {which}: sorter {i} partition {p} order")
        # the reduce side: normalized order over all, the input multiset
        batch = KVBatch.concat(out)
        check(normalized_nondecreasing(batch.key_bytes, batch.key_offsets,
                                       which),
              f"merge D {which}: merged records out of normalized order")
        v = batch.val_bytes.view(">u8")
        src = (v >> np.uint64(32)).astype(np.int64)
        idx = (v & np.uint64(0xFFFFFFFF)).astype(np.int64)
        n0 = len(inputs[0][1])
        g = np.where(src == 0, idx, n0 + idx)
        total = n0 + len(inputs[1][1])
        seen = np.zeros(total, dtype=bool)
        seen[g] = True
        check(len(g) == total and bool(seen.all()),
              f"merge D {which}: {len(g)} records of {total}")
        m, klen = key_matrix(batch.key_bytes, batch.key_offsets)
        want = np.concatenate([k for _s, k in inputs])[g]
        check(np.array_equal(m, want),
              f"merge D {which}: a record's key changed")
        log(f"merge D {which}: {total} records, partitions by raw-byte FNV, "
            f"in normalized order, the input multiset")
        mm.cleanup()
        for fr in files:
            fr.delete()


def merge_phase(args, device="cuda", **sizes) -> dict:
    """Phase 9; returns the kernel launches of its legs."""
    sz = dict(MERGE_SIZES, **sizes)
    rng = np.random.default_rng(args.seed + 9)
    t0 = time.perf_counter()
    mat, lens = bulk_word_vocab(rng, sz["vocab_size"])
    vocab = (mat, lens, key_rank(mat, lens))
    log(f"merge: vocabulary of {sz['vocab_size']} words in "
        f"{time.perf_counter() - t0:.3f} s")
    totals: collections.Counter = collections.Counter()
    with tempfile.TemporaryDirectory(prefix="tez_merge_") as root:
        merge_leg_a(sz, rng, vocab, device, root, totals)
        merge_leg_b_c_e(sz, rng, vocab, device, root, totals)
        merge_leg_d(sz, rng, device, root, totals)
    log("merge: legs A-E passed")
    return dict(totals)


class SettableClock:
    """A clock that stands still until advanced: the breaker's cooldown
    in phase 7 elapses when the script says so, not by wall time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def report_profile(prof, wall_s: float) -> None:
    """Device busy time (kernels and copies) over the traced wall time, and
    the operations that took it."""
    from torch.autograd import DeviceType
    events = prof.key_averages()
    # device-side rows only (kernels, copies): an operator's row repeats
    # the device time of the kernels it launched
    busy_s = sum(e.self_device_time_total for e in events
                 if e.device_type == DeviceType.CUDA) / 1e6
    log(f"profile: device busy {busy_s:.3f} s of {wall_s:.3f} s wall, "
        f"idle share {1 - busy_s / wall_s:.4f}")
    log(events.table(sort_by="self_device_time_total", row_limit=15))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--producers", type=int, default=4)
    ap.add_argument("--span-mb", type=float, default=256)
    ap.add_argument("--profile", action="store_true",
                    help="trace phases 3-6 with torch.profiler and print "
                         "the device's busy time by operation")
    ap.add_argument("--tile-sweep", action="store_true",
                    help="time the merge-path kernel at each CTA shape of "
                         "TILE_SHAPES in phase 2")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tez_tpu_torch.ops import _build

    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.3f} s for {sorted(built)}")
    for kname, info in sorted(built.items()):
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {kname}: {line.strip()}")

    rows = kernel_phase(args.seed, memory_tb_s(name), args.tile_sweep)
    t0 = time.perf_counter()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            launches = slice_phases(args)
        report_profile(prof, time.perf_counter() - t0)
    else:
        launches = slice_phases(args)
    log(f"slice: {time.perf_counter() - t0:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    fault_launches = containment_phase(args)
    log(f"containment: {time.perf_counter() - t0:.3f} s, launches "
        f"{json.dumps(fault_launches)}")
    t0 = time.perf_counter()
    spill_launches = spill_phase(args)
    log(f"spill: {time.perf_counter() - t0:.3f} s, launches "
        f"{json.dumps(spill_launches)}")
    t0 = time.perf_counter()
    log(f"merge phase on {card}")
    merge_launches = merge_phase(args)
    log(f"merge: {time.perf_counter() - t0:.3f} s, launches "
        f"{json.dumps(merge_launches)}")
    launches = collections.Counter(launches)
    launches.update(spill_launches)
    launches.update(merge_launches)
    for kname, row in rows.items():
        row["launches"] = launches[kname]
    for tpu_kernel, where, names in MAIN_PATH_COUNTERPARTS:
        for kname in names:
            log(f"launch check: {tpu_kernel} ({where}) -> {kname}: "
                f"{launches[kname]} launches on the slice, the spill "
                f"path and the merge legs")
            check(launches[kname] > 0, f"{kname} was never launched on the "
                                       f"slice's main path")
    log(f"launch check: merge_rank (merge_rank_pallas's general-query "
        f"counterpart, held in phase 2): {launches['merge_rank']} launches "
        f"on the slice, the spill path and the merge legs")
    check(launches["merge_rank"] == 0, "the slice launched merge_rank; its "
                                       "merges should run merge_path_pair")
    log(card)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
