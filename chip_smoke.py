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
   smaller files.

Kernel launch counts are zeroed before each path of phases 3-6 and 8 and
read after it: each TPU kernel's counterpart on the path must have been
launched, and the general-query merge rank, which the main path no longer
calls, not at all; the JSON line reports their sum over phases 3-6 and 8.  The
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
    launches = collections.Counter(launches)
    launches.update(spill_launches)
    for kname, row in rows.items():
        row["launches"] = launches[kname]
    for tpu_kernel, where, names in MAIN_PATH_COUNTERPARTS:
        for kname in names:
            log(f"launch check: {tpu_kernel} ({where}) -> {kname}: "
                f"{launches[kname]} launches on the slice and the spill "
                f"path")
            check(launches[kname] > 0, f"{kname} was never launched on the "
                                       f"slice's main path")
    log(f"launch check: merge_rank (merge_rank_pallas's general-query "
        f"counterpart, held in phase 2): {launches['merge_rank']} launches "
        f"on the slice and the spill path")
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
