#!/usr/bin/env python3
"""Drive the tez_tpu_torch data plane once on one CUDA card.

Run from the root of the repository, on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed N] [--producers N] [--span-mb N]

Phases, each checked, none allowed to fail:

1. the card's name and power limit (nvidia-smi), then an nvcc build of
   every kernel under tez_tpu_torch/csrc, all sources at once;
2. each kernel against its plain PyTorch version on the card, bit-exact,
   at the slice's shapes, with its time, the plain version's time, its
   memory-bound time and (merge rank) a torch.searchsorted yardstick;
3. map side: 4 producers, each a DeviceSorter(num_partitions=4,
   key_width=12, 256 MB spans) fed two full spans of bench-style records
   (12-byte Zipf(1.3) keys "w" + 11 digits over a 50k vocabulary, 8-byte
   values) and flushed;
4. reduce side: merge_sorted_runs over the producers' runs, checked byte
   for byte against a numpy golden (FNV partition + stable lexsort);
5. device_shuffle_sort over one producer's records, against the same
   golden;
6. the combiner leg of OrderedWordCount: ragged 1-16 byte Zipf words with
   value 1, the same producers with sum_long_combiner, the merge, a last
   combine, every count checked against a collections.Counter golden.

Kernel launch counts are zeroed before phase 3 and read after phase 6.
The last two lines are one JSON object of per-kernel numbers and
{"ok": true, "device": {...}}.  Without a card the script exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

FNV_OFFSET, FNV_PRIME = 2166136261, 16777619
NUM_PARTITIONS = 4
BENCH_VOCAB = 50_000
WORD_VOCAB = 100_000
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
def kernel_phase(seed: int, bw_tb_s: float) -> dict:
    import torch
    from tez_tpu_torch.ops import kernels
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    rows: dict = {}

    def bound_ms(nbytes: int) -> float:
        return nbytes / (bw_tb_s * 1e12) * 1e3

    def record(name, source, replaces, got, want, ms, plain_ms, nbytes,
               library_ms=None, shape=""):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
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

    # merge rank: W = 3 and 4 at 2^21 rows with random queries, both
    # flavours, then one rung of the reduce-side ladder (2^24 rows each
    # side, W = 4, the queries a second sorted run).  Lanes draw from 8
    # values so equal keys are common; each run ends in pad sentinels
    # (lanes and length 0xFFFFFFFF) as a bucketed run does.
    rng = np.random.default_rng(seed)

    def sorted_run(m, width):
        run = rng.integers(0, 8, (m, width)).astype(np.uint32)
        run_len = rng.integers(0, 17, m).astype(np.uint32)
        # 3 bits a lane and 5 for the length: one composite key orders the
        # rows as the comparator does
        key = run_len.astype(np.int64)
        for i in range(width):
            key |= run[:, i].astype(np.int64) << (5 + 3 * (width - 1 - i))
        order = np.argsort(key)
        run, run_len = run[order], run_len[order]
        run[-(m // 64):] = 0xFFFFFFFF
        run_len[-(m // 64):] = 0xFFFFFFFF
        return run, run_len

    for m, width, sorted_queries in ((1 << 21, 3, False), (1 << 21, 4, False),
                                     (1 << 24, 4, True)):
        run, run_len = sorted_run(m, width)
        if sorted_queries:
            q, q_len = sorted_run(m, width)
        else:
            q = rng.integers(0, 8, (m, width)).astype(np.uint32)
            q_len = rng.integers(0, 17, m).astype(np.uint32)
            half = m // 2          # half the queries are copies of run rows
            pick = rng.integers(0, m, half)
            q[:half], q_len[:half] = run[pick], run_len[pick]
        t = [torch.from_numpy(a.view(np.int32)).to(dev)
             for a in (run, run_len, q, q_len)]
        # yardstick: one searchsorted over one lane packed with the length
        packed_run = torch.sort((t[0][:, 0].to(torch.int64) & 0xFFFFFFFF)
                                << 32 | (t[1].to(torch.int64) & 0xFFFFFFFF)
                                ).values
        packed_q = (t[2][:, 0].to(torch.int64) & 0xFFFFFFFF) << 32 | \
            (t[3].to(torch.int64) & 0xFFFFFFFF)
        for count_equal in ((False,) if sorted_queries else (False, True)):
            got = kernels.merge_rank(*t, count_equal)
            want = kernels._rank_search(*t, count_equal)
            lib_ms = cuda_ms(lambda: torch.searchsorted(
                packed_run, packed_q, right=count_equal), 20)
            row = record(
                "merge_rank", "tez_tpu_torch/csrc/merge_rank.cu",
                "tez_tpu/ops/pallas_kernels.py:76", got, want,
                cuda_ms(lambda: kernels.merge_rank(*t, count_equal), 20),
                cuda_ms(lambda: kernels._rank_search(*t, count_equal), 3),
                2 * m * (width + 1) * 4 + 4 * m, library_ms=lib_ms,
                shape=f"N=M={m} W={width} count_equal={count_equal} "
                      f"{'sorted' if sorted_queries else 'random'} queries")
            # the resident merge ranks W=3 lanes in 2^21-row buckets
            if width == 3 and not count_equal:
                rows["merge_rank"] = row
        del t, packed_run, packed_q
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
    (upload, kernels and sorts, readback; each call ends synchronised)."""

    def __init__(self, name: str, nbytes: int, device):
        self.name, self.nbytes, self.device = name, nbytes, device
        self.extra_device_s = 0.0

    def __enter__(self):
        sync(self.device)
        self.t0, self.d0 = time.perf_counter(), device_ms()
        return self

    def __exit__(self, exc_type, *_):
        sync(self.device)
        if exc_type is None:
            wall = time.perf_counter() - self.t0
            dev = (device_ms() - self.d0) / 1e3 + self.extra_device_s
            log(f"phase {self.name}: wall_s={wall:.3f} device_s={dev:.3f} "
                f"host_s={wall - dev:.3f} MB={self.nbytes / 1e6:.1f} "
                f"MB_per_s={self.nbytes / 1e6 / wall:.1f}")
        return False


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
            combiner=None, device="cuda", **sorter_kw) -> list:
    """Map side of the ordered edge: one DeviceSorter per producer, fed its
    batches (each fills a span) and flushed.  Returns the producers' runs."""
    from tez_tpu_torch.ops.sorter import DeviceSorter
    runs = []
    for batches in producer_batches:
        s = DeviceSorter(num_partitions=NUM_PARTITIONS, key_width=key_width,
                         span_budget_bytes=span_bytes, engine="device",
                         combiner=combiner, device=device, **sorter_kw)
        for batch in batches:
            s.write_batch(batch)
        check(s.num_spills == len(batches),
              f"expected {len(batches)} span sorts, got {s.num_spills}")
        runs.append(s.flush())
    return runs


def slice_phases(args, device="cuda") -> dict:
    """Phases 3-6; returns the kernel launch counts of the run."""
    from tez_tpu_torch.ops import kernels
    from tez_tpu_torch.ops.device_pipeline import device_shuffle_sort
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
    kernels.reset_launches()

    # -- phase 3: map side ---------------------------------------------------
    kv_bytes = args.producers * 2 * rec * 20
    with Phase("map", kv_bytes, device):
        runs = produce(producer_batches, 12, span_bytes, device=device)
    del producer_batches
    log(f"map: {args.producers} producers x 2 spans x {rec} records")

    # -- phase 4: reduce side ------------------------------------------------
    with Phase("reduce", kv_bytes, device):
        merged = merge_sorted_runs(runs, NUM_PARTITIONS, 12, device=device)
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
    ids = np.concatenate(ids_list[:2])
    vals = np.concatenate(vals_list[:2])
    del ids_list, vals_list
    n = len(ids)
    keys = vocab[ids]
    lanes = be_lanes(keys)
    hmat = np.zeros((n, 16), dtype=np.uint8)
    hmat[:, :12] = keys
    with Phase("fused_pipeline", n * 20, device) as ph:
        t_dev = time.perf_counter()
        sp, out_lanes, out_vals, perm, counts = device_shuffle_sort(
            lanes, np.full(n, 12, np.int64), vals.view(np.uint32),
            hmat, np.full(n, 12, np.int32), NUM_PARTITIONS, device=device)
        sync(device)
        ph.extra_device_s = time.perf_counter() - t_dev
    order = stable_order(rank[ids])
    check(np.array_equal(perm[:n].cpu().numpy(), order), "pipeline: perm")
    check(np.array_equal(out_lanes[:n].cpu().numpy().view(np.uint32),
                         lanes[order]), "pipeline: sorted lanes")
    check(np.array_equal(out_vals[:n].cpu().numpy().view(np.uint8),
                         vals[order]), "pipeline: sorted values")
    check(np.array_equal(sp[:n].cpu().numpy(), part[ids[order]]),
          "pipeline: sorted partitions")
    check(np.array_equal(counts.cpu().numpy(),
                         np.bincount(part[ids], minlength=NUM_PARTITIONS)),
          "pipeline: partition counts")
    log(f"fused_pipeline: {n} records identical to the golden")
    del sp, out_lanes, out_vals, perm, counts, keys, lanes, hmat

    # -- phase 6: combiner leg -----------------------------------------------
    words, wmat, wlens = word_vocab(rng)
    word_part = fnv_np(wmat, wlens) % NUM_PARTITIONS
    totals = np.zeros(len(words), dtype=np.int64)
    producer_batches, records, nbytes = [], 0, 0
    for _p in range(args.producers):
        spans = [word_batch(rng, wmat, wlens, span_bytes) for _s in range(2)]
        for batch, ids in spans:
            totals += np.bincount(ids, minlength=len(words))
            records += batch.num_records
            nbytes += int(batch.key_offsets[-1]) + int(batch.val_offsets[-1])
        producer_batches.append([b for b, _i in spans])
    with Phase("combiner", nbytes, device):
        runs = produce(producer_batches, 16, span_bytes,
                       combiner=sum_long_combiner, device=device)
        del producer_batches
        final = sum_long_combiner(merge_sorted_runs(
            runs, NUM_PARTITIONS, 16, device=device))
    golden = collections.Counter(
        {words[i]: int(c) for i, c in enumerate(totals) if c})
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
    log(f"combiner: {records} records -> {len(got)} words, counts equal "
        f"to the Counter golden")
    return dict(kernels.launches)


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

    rows = kernel_phase(args.seed, memory_tb_s(name))
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
    for kname, row in rows.items():
        row["launches"] = launches[kname]
        check(row["launches"] > 0, f"{kname} was never launched on the "
                                   f"slice's main path")
    log(card)
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
