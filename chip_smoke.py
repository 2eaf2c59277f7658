#!/usr/bin/env python3
"""Drive the tez_tpu_torch data plane and DAG runtime on one CUDA card.

Run from the root of the repository, on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed N] [--producers N] [--span-mb N]

Phases, each checked, none allowed to fail:

1. the card's name and power limit (nvidia-smi), then an nvcc build of
   every kernel under tez_tpu_torch/csrc, all sources at once, and the
   g++ build of the host library (tez_tpu_torch/native); the host's CPU
   count and model;
2. each kernel against its plain PyTorch version on the card, bit-exact,
   at the slice's shapes, with its time, the plain version's time, its
   memory-bound time and a yardstick computing the same function on these
   inputs, its answer checked before it is timed: torch.searchsorted over
   an exact int64 packing of the rows for merge rank (random queries,
   sorted queries at the map pair and the reduce rung with the slice's own
   keys too, an all-equal run, sparse sorted queries), a stable torch.sort
   of the same packing for the merge-path pair, which is also timed
   against the composite it replaced on the main path (two merge-rank
   launches and a scatter); and fnv_hash_bytes over FNV_SWEEP (other
   widths, partition counts, a short last tile, unaligned bases, one
   row), each case bit-exact, its time beside its bound;
2b. each binding of the host library (ops/native.py) timed on the card's
   host at the main path's sizes (an 80 MiB tokenizer chunk of phase 11's
   corpus, 64 MB gathers, phase 8's 64 MB span and four of its runs) and
   held byte for byte against its plain numpy version on a cut of that
   input (PLAIN_CUT: a sixteenth; half the runs for the merges), both times
   printed;
3. map side: 2 producers, each a DeviceSorter(num_partitions=4,
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
8. the spilling map side at the repo's spill-benchmark shape
   (tez_tpu/tools/spill_bench.py, SPILL_r05.json; half its 512 MB a
   producer, 1 producer of its 4): each writing 256 MB of KV (1-16 byte
   Zipf(1.3) words over a 2,000,000-word
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
   byte-identical at depth 0; D, two spilling sorters of 2 spans and one
   manager under CaseInsensitiveKeyComparator and ReverseByteKeyComparator
   (the partition of every record the FNV of its raw bytes, the merged
   records in normalized order); E, half of B's input (16 segments and
   the skewed one) at half its budget, a fault-free reference run and
   then the merge lane's faults (an out-of-memory split, a hang against
   a 500 ms watchdog, a tripped breaker), each byte-identical to the
   reference;
10. map and reduce tasks: 4 map and 4 reduce TaskRunners in one process,
   each wave concurrent, over one scatter-gather edge at tez_tpu's library
   defaults (io.sort.mb 256, key width 16, engine auto, pipeline depth 2,
   a 230.4 MiB merge budget, spill directories under $TMPDIR), the
   harness's in-process umbilical routing the maps' events with the
   port's ScatterGatherEdgeManager: each map writes 256 MiB of phase 8's
   words (value the long 1) through write_batch, each reducer sums its
   groups through grouped_blocks; leg A without a combiner, B with the
   sum combiner, C pipelined; every reducer's output equal to a numpy
   Counter golden in strictly increasing key order, B's and C's equal to
   A's, every task SUCCEEDED without a failover, and the counters
   consistent with the records and the partitions;
11. OrderedWordCount through the port's own TezClient and DAGAppMaster
   (local thread runners, the tasks on the card), bench.py's DAG
   (_run_wordcount: 4 tokenizers in vector mode, 4 summations, 1 sorter,
   io.sort.mb 512, the device sorter) over a 512 MiB corpus in bench.py's
   layout (8,192 words a line) of Zipf(1.3) words of phase 8's
   vocabulary, its staging directory under $TMPDIR: leg A with the sum
   combiner, leg B without, so every word crosses the first edge; each
   leg SUCCEEDED with _SUCCESS written, its output equal to the drawn
   words' counts in non-decreasing count order, no failover and the
   breaker closed, and B's part file byte-identical to A's; the DAG wall,
   each vertex's span from the AM's history, the AM's share of the wall
   and bench.py's four counters are printed;
12. the same DAG over phase 11's corpus with tez.runner.mode=subprocess:
   4 runner processes on the one card, each launched by the AM's
   SubprocessRunnerPool with --device cuda, taking its tasks over the
   umbilical and serving its outputs over TCP; leg A with the sum
   combiner and the Python ShuffleServer, leg B without the combiner and
   the native sendfile server (TEZ_TPU_NATIVE_SHUFFLE_DIR under $TMPDIR);
   each leg SUCCEEDED with _SUCCESS written, its part file byte-identical
   to phase 11's, fetches across processes above zero, the final
   OUTPUT_RECORDS phase 11's, no failover, and every runner on the card
   (each rewrites a stats file after every task: its device, the card's
   name, its kernel launches and host-library calls, its start-up); the
   DAG wall beside phase 11's, the vertex spans, the AM's share, the
   runners' start-up and the bytes they served are printed.
13. the unordered edge: examples/wordcount.py through the port's
   TezClient over prefixes of phase 11's corpus (whole 1M-word chunks,
   words as bytes keys, pickled longs as values): A, the example's
   defaults (a 100 MB output buffer, final merge on) over the first 16
   MiB; B, final merge off and an 8 MB buffer, so each tokenizer ships
   its spills as events of their own, over the first 16 MiB; C,
   examples/simple_session.py over three 8 MiB slices in one pre-warmed
   session that holds its runners (the idle release at 20 min); every
   part file equal to a Counter golden restricted to its
   FNV partition, B's inputs fetched above one a partition, C's runners
   reused across its DAGs (its recovery journal), no failover, and
   fnv_hash_bytes launched on each leg;
14. examples/mrr.py (maps from the splits, r1 2, r2 1) over 128 MiB of
   TeraSort-width lines (a 10-byte printable key drawn Zipf(1.3) from a
   seeded vocabulary of 2^20, a TAB, an 88-byte printable value): the
   totals non-decreasing and the (key, total) rows a numpy golden's; the
   merge-path pair and lane-hash launches printed;
15. the mesh exchange: (a) parallel/exchange.py build_distributed_shuffle
   over the card's one-worker mesh with 2^22 rows of 4 key lanes and 2
   value words, both engines, hashed and explicit routes, each bit for
   bit against the same step on the CPU (the plain versions), its ms per
   call printed; (b) OrderedWordCount with exchange="mesh" (vector
   tokenizers, 4 / 4 / 1, no combine) over the first 256 MiB of phase
   11's corpus, its part file byte-identical to the host exchange's run
   of the same DAG and equal to the golden; the DAG walls, the rounds,
   the rows exchanged, the engine, the coordinator's _execute seconds
   (host planning, device step, readback, assembly), the MeshExchange
   counters and the peak device memory printed.
16. the tiered buffer store and push shuffle, each leg over phase 15(b)'s
   256 MiB prefix with phase 11's DAG and its part file byte-identical to
   15(b)'s host exchange: A, two identical DAGs with the sum combiner in
   one client with the store on (thread runners): the first publishes its
   runs (the DEVICE tier's peak bytes above zero, polled while it runs),
   the second reuses all 8 tokenizer and summation outputs from sealed
   lineage and launches fewer kernels; then a run with 64 MiB of lanes on
   the card, published and relieved through the out-of-memory ladder's
   hook, must show its bytes gone from torch.cuda.memory_allocated; B,
   push into the store without the combiner through a 256 MB host tier
   (STORE_PUSH_CONF): pushed bytes above zero, host-to-disk demotions
   above zero, no failover; C, B in 4 runner processes with the Python
   server, each runner with its own process store: every spill's push
   abandoned to the pull backstop as tez_tpu's are (no job-token secret
   reaches the pusher), fetches across processes, every runner on the
   card.  Each leg prints its wall, store counters, peak tier bytes, push
   counters, merges, peak device memory and kernel launches.
17. the AM's remote modes and AM recovery, each leg over phase 15(b)'s
   256 MiB prefix with phase 11's DAG (examples/ordered_wordcount.py
   build_dag, DAG_SHAPE and DAG_CONF) and its part file byte-identical
   to 15(b)'s host exchange: A, a standalone AM process (python -m
   tez_tpu_torch.am.client_server --runner-mode pods --num-containers 2
   --device cuda, a job token in its environment) reached only through a
   remote TezClient (tez.framework.mode=remote), which pre-warms and runs
   a warm-up DAG of one barrier task a pod, so both pods are up before
   the DAG; the DAG SUCCEEDED, its attempts ran on pod-0 and pod-1 (the
   AM's journal), fetches crossed pods, every pod reports the card and
   the pods launched fnv_hash_lanes and merge_path_pair (their stats
   files), and client.stop() ends the session with the AM process
   exiting 0; B, a session TezClient in runner threads
   (tez.am.max.app.attempts 2) whose AM crashes (am.crash()) once the
   tokenizer vertex SUCCEEDED, a task.run delay rule holding the
   summation attempts so the crash lands before any of them ran (checked
   in attempt 1's journal, no retry), then client.reattach(): attempt
   2's recover_and_resume restores every tokenizer task from the journal
   and launches only the summation and sorter tasks
   (TOTAL_LAUNCHED_TASKS), the live DAGClient re-binds to it, the DAG
   SUCCEEDED and attempt 2 launched merge_path_pair; both attempts'
   walls, launches and peak device memory, the journal lines replayed
   and the zombie attempt-1 actors fenced (fence.stale_epoch) are
   printed.
18. the query layer, the joins and the custom edges: A,
   examples/sort_merge_join.py with its defaults (2 joiners, a side
   parallelism of 2), left the first 8 MiB of phase 11's corpus and right
   the next 8 MiB (line-exact), the output exactly the distinct words on
   both sides, fnv_hash_lanes and merge_path_pair launched; B,
   examples/hash_join.py over 2^20 stream lines of one Zipf word each
   and 16,384 distinct words drawn Zipf from the same vocabulary over
   the broadcast edge, one (word, "1") record for each stream occurrence
   whose word is on the hash side (a Counter golden); C, CORPUS_QUERIES
   through one QuerySession on the card (the store on, replanning off)
   over tools/query_corpus.generate(scale=100, seed=3), TPC-H SF 0.1's
   row counts, each query's records its numpy oracle's, its wall and
   join decisions printed, then nation_revenue again served from sealed
   lineage (cache hits, the same records), QUERY_LAUNCHES' queries each
   launching its kernels, then the aggregate pricing_summary, the
   repartition join hot_parts and the window top_orders again in a
   second session with the sorter's device floor at one record
   (FLOOR_CONF), each launching fnv_hash_lanes and merge_path_pair and
   its records the oracle's; D, the cartesian-product
   example over 256 x 512 tokens (every pair), and OrderedWordCount
   without the combiner (4 tokenizers, 4 summations) with
   FairShuffleVertexManager on the summation over 8 MiB of lines whose
   words are half one hot word, the desired task input scaled from
   tests/test_custom_edges.py's, the counts a Counter golden's and more
   summation tasks than the 4 configured.  Each leg's wall and launches
   are printed.
19. streaming, the SLO watchdog and exposition, speculation and the AM's
   services: A and B on one stream, DAGAppMaster(device="cuda").
   open_stream with tests/test_streaming.py's window template (2
   StreamWindowSourceProcessor tasks, 1 StreamWindowSinkProcessor, the
   ordered edge) over 3 windows of 2^19 records {"k": word, "v": 1}, the
   words drawn Zipf(1.3) from phase 11's vocabulary: attempt 1 ingests
   windows 1 and 2 and the start of 3 and crashes while window 2's
   commit bracket is open (a stream.window.commit delay rule holds it),
   then DAGAppMaster(attempt=2).recover_and_resume(): window 1 stays
   sealed, window 2 is replayed and rolled forward, the open spool's
   records reach window 3, drain() commits [1, 2, 3], exactly one
   WINDOW_COMMIT_FINISHED per window across both journals, each window's
   w<N>.part0 a Counter golden's byte for byte, and each window DAG
   (window 2's replay too) launching fnv_hash_lanes and merge_path_pair;
   then a stream of 2 small windows on an AM with
   tez.am.slo.window.p95-ms 1: exactly one TENANT_SLO_BREACH under the
   stream's name (beside the session aggregate's), its series in
   render_prometheus and in obs.exposition.render_text (stream= label),
   the line counts printed; C, OrderedWordCount (4 tokenizers, 4
   summations, no combiner, io.sort.mb 4) over the first 16 MiB of phase
   11's corpus with speculation, the dag-aware scheduler, 4 dispatcher
   shards, the lock-order witness and a generous submit SLO target,
   tokenizer 0's first attempt (HeldTokenProcessor) writing its split,
   then holding for up to 20 s once its sorter dispatched a span on the
   card: the DAG SUCCEEDED well inside the hold, NUM_SPECULATIONS >= 1
   with the sibling _1 the winner, the counts the golden's, both
   kernels launched, no lock-order violation, no SLO breach; the loser,
   killed with its span plane open (a span sorted on the card, its stream
   pair held, its run kept for the flush), aborts its output:
   it holds no stream pair more than before the DAG, leaves the breaker
   closed, registers and publishes nothing.  Then the abort with a span
   in flight: an async DeviceSorter shipping each span as it completes
   writes 3 spans, span 1's completion held by a device.dispatch.delay
   rule, and abort() runs inside the hold: it returns only once that
   span completed, nothing ships after it began, the pair goes back, no
   run is left.  C runs first, then A and B.  Before phase 19 the stream
   pairs held must be back at their count before phase 1 (both printed).
20. the bench harnesses (tez_tpu_torch/tools) at tez_tpu's shapes, their
   scale cut (BENCH_SIZES): A, profile_kernels over 2^20 rows, the plain
   FNV version against the kernel through hash_partition and the host
   encode plus upload against encode_keys_device, each pair equal first;
   B, owc_proxy_counts (the C++ OrderedWordCount proxy, 4 x 4) over the
   first 256 MiB of phase 11's corpus (15(b)'s slice; cut from all 512
   MiB), equal to its golden, its seconds a byte beside 11 A's (phase 4 ran
   the PipelinedSorter proxy over its records in 2 x producers spans: its
   partition counts, key order and values the merged run's); C,
   bench_exchange's four legs on a mesh of 8 logical workers of the card,
   bit-identical; D, bench_sort (4 x 4 tasks, io.sort.mb 48 / 512) push
   against pull over 256 MB, both spilled, push pushed, the outputs
   bit-identical; E, spill_bench.run over 128 MB of a 2M-word Zipf
   vocabulary at io.sort.mb 64, verified against its golden and its
   proxy, spilled; F, bench_query (skew 0.0 / 1.1, scale 2.0) with the
   sorter's device floor at one record (FLOOR_CONF), the replan journaled
   and rendered by doctor; G, bench_diff over the card legs of A (the
   kernel hash and the device encode, as Mrows/s records) and of a
   second run of A, exit code 0.  A, D, E, F and G's second run of A
   each require their kernels launched; B's proxies run on the host, and
   C's exchange routes its rows on the host (the coordinator's
   fnv32_partition_native) and moves them with copies, so C launches no
   hand-written kernel on one card.

Kernel launch counts and the host library's call counts are zeroed
before each path of phases 3-20 and read after it (phase 12's, 16 C's
and 17 A's are summed from their runners' stats files; phase 15(a)'s
checks are left out): each TPU kernel's
counterpart on the path must have been launched, and the general-query
merge rank, which the main path no longer calls, not at all; the
precombine of phase 6 must call hash_sum_i64, every host merge pass of
phases 8-10 tz_merge_emit or tz_merge_runs, phase 11's combining leg the
word-count aggregator (tz_wc_feed) and its other leg tz_split_ws, and
the same of phase 12's legs in their runners.  The kernels' JSON line
reports their launches over phases 3-6 and 8-20; the
line before it, {"native": ...}, the library's calls by phase and phase
2b's times.  The last line is {"ok": true, "device": {...}}.  Without a card the script exits non-zero before
printing any result.  --tile-sweep also times the merge-path kernel at
other CTA shapes and splits both kernels' time by launch.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

FNV_OFFSET, FNV_PRIME = 2166136261, 16777619
NUM_PARTITIONS = 4
BENCH_VOCAB = 50_000
WORD_VOCAB = 100_000
#: phase 8's scale: spill_bench's 2,000,000-word vocabulary and
#: io.sort.mb=64 (SPILL_r05.json), with 256 MB of map output a producer
#: (cut from spill_bench's 512 MB to keep the script within its time
#: limit; most spans still spill), and 1 producer (cut from 4 for the
#: same reason: each producer sorts, spills and merges on its own)
SPILL_VOCAB = 2_000_000
SPILL_SPAN_MB = 64
SPILL_PRODUCER_MB = 256
SPILL_PRODUCERS = 1
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


#: phase 2's sweep of fnv_hash_bytes beside its main row (N = 2^23, W = 16,
#: P = NUM_PARTITIONS): (case, rows, width, partitions, view).  The
#: widths the kernel templates and one it reads at run time (12), the
#: modulo as a mask (8), by its magic (7, 2^31 - 1), a short last tile,
#: bases off 16-byte alignment (view: the rows from row 1 of a W = 12
#: matrix, lengths likewise) and a single row
FNV_SWEEP = tuple((f"W={w}", 1 << 23, w, NUM_PARTITIONS, False)
                  for w in (4, 8, 12, 32, 64)) + (
    ("P=8", 1 << 23, 16, 8, False),
    ("P=7", 1 << 23, 16, 7, False),
    ("P=2^31-1", 1 << 23, 16, 2 ** 31 - 1, False),
    ("tail", (1 << 23) + 333, 16, NUM_PARTITIONS, False),
    ("view", 1 << 23, 12, NUM_PARTITIONS, True),
    ("N=1", 1, 16, NUM_PARTITIONS, False))


def fnv_timing_calls(n: int) -> int:
    """Calls a FNV sweep case is timed over: a small N times the wrapper's
    host path, which needs more calls to settle."""
    return 20 if n >= 1 << 20 else 200


def fnv_inputs(g, n: int, w: int, dev, view: bool = False) -> tuple:
    """uint8[N, W] random key bytes and int32[N] lengths uniform in 0..W,
    1% of them -1 (pad rows), drawn from generator `g` on `dev`; with
    `view`, drawn one row longer and returned from row 1."""
    import torch
    m = n + view
    mat = torch.randint(0, 256, (m, w), generator=g, device=dev,
                        dtype=torch.int32).to(torch.uint8)
    lens = torch.randint(0, w + 1, (m,), generator=g, device=dev,
                         dtype=torch.int32)
    lens[torch.randint(0, m, (m // 100,), generator=g, device=dev)] = -1
    return (mat[1:], lens[1:]) if view else (mat, lens)


def fnv_sweep_case(kernels, g, dev, bound_ms, case: str, n: int, w: int,
                   p: int, view: bool) -> dict:
    """One FNV_SWEEP case: fnv_hash_bytes bit-exact against its plain
    version, then timed; its time, bound and share of the bound."""
    import torch
    mat, lens = fnv_inputs(g, n, w, dev, view)
    want = kernels.fnv_hash_bytes_plain(mat, lens, p)
    check(torch.equal(kernels.fnv_hash_bytes(mat, lens, p), want),
          f"fnv_hash_bytes sweep {case}: kernel disagrees with its plain "
          f"version")
    ms = cuda_ms(lambda: kernels.fnv_hash_bytes(mat, lens, p),
                 fnv_timing_calls(n))
    bound = bound_ms(n * w + 8 * n)
    log(f"kernel fnv_hash_bytes sweep {case} N={n} W={w} P={p}: ms={ms:.4f} "
        f"bound_ms={bound:.4f} share={bound / ms:.3f} max_abs_err=0 "
        f"(bit-exact)")
    return {"case": case, "n": n, "w": w, "p": p, "ms": ms,
            "bound_ms": bound}


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
    mat, lens = fnv_inputs(g, n, w, dev)
    got = kernels.fnv_hash_bytes(mat, lens, NUM_PARTITIONS)
    want = kernels.fnv_hash_bytes_plain(mat, lens, NUM_PARTITIONS)
    rows["fnv_hash_bytes"] = record(
        "fnv_hash_bytes", "tez_tpu_torch/csrc/fnv_hash.cu",
        "tez_tpu/ops/pallas_kernels.py:34", got, want,
        cuda_ms(lambda: kernels.fnv_hash_bytes(mat, lens, NUM_PARTITIONS),
                50),
        cuda_ms(lambda: kernels.fnv_hash_bytes_plain(mat, lens,
                                                     NUM_PARTITIONS), 3),
        n * w + 4 * n + 4 * n, shape=f"N={n} W={w}")
    del mat, lens
    t0 = time.perf_counter()
    rows["fnv_hash_bytes"]["sweep"] = [
        fnv_sweep_case(kernels, g, dev, bound_ms, *case)
        for case in FNV_SWEEP]
    log(f"kernel fnv_hash_bytes sweep: {len(FNV_SWEEP)} cases in "
        f"{time.perf_counter() - t0:.3f} s")

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
# phase 2b: the host library against its plain versions
# ---------------------------------------------------------------------------
#: phase 2b's sizes: an 80 MiB chunk of text, phase 8's 64 MB span and
#: four of its runs, 64 MB gathers (the chunk and the gathers cut from 160
#: MiB, a tokenizer's share of phase 11's corpus when it was 640 MiB, and
#: 256 MB when phase 19 came)
NATIVE_SIZES = dict(chunk_mb=80, span_mb=SPILL_SPAN_MB, runs=4,
                    gather_mb=64, vocab_size=SPILL_VOCAB)
TINY_NATIVE = dict(chunk_mb=2, span_mb=1, runs=3, gather_mb=2,
                   vocab_size=20_000)
#: the plain versions run on 1/PLAIN_CUT of each binding's input (the
#: first sixteenth of the text, rows, records or pairs; the first half of
#: the runs), the library on all of it and on the same cut, so the cut
#: holds the library to its plain version byte for byte while the script
#: keeps within its time limit
PLAIN_CUT = 16


def cpu_model() -> str:
    """The host CPU as lscpu names it: model name, family and model
    numbers, architecture."""
    import platform
    fields = {}
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=10).stdout
        fields = dict(line.split(":", 1) for line in out.splitlines()
                      if ":" in line)
    except (OSError, subprocess.SubprocessError):
        pass
    get = {k.strip(): v.strip() for k, v in fields.items()}.get
    return (f"{get('Model name', 'model name not reported')}, family "
            f"{get('CPU family', '?')} model {get('Model', '?')}, "
            f"{platform.machine()}")


def same_arrays(a, b) -> bool:
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(same_arrays, a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def native_phase(args, **sizes) -> list:
    """Phase 2b: every binding of the host library against its plain numpy
    version on this host, byte for byte, on a cut of the main path's
    sizes (PLAIN_CUT); the plain version timed once on the cut, the
    library's median of three calls on the whole input.  Returns one row a
    binding."""
    from tez_tpu_torch.ops import native
    sz = dict(NATIVE_SIZES, **sizes)
    rng = np.random.default_rng(args.seed + 12)
    mat, lens = bulk_word_vocab(rng, sz["vocab_size"])
    with tempfile.TemporaryDirectory(prefix="tez_native_") as root:
        path = os.path.join(root, "chunk.txt")
        write_corpus(path, rng, mat, lens, int(sz["chunk_mb"] * (1 << 20)))
        with open(path, "rb") as fh:
            chunk = fh.read()
    rows = []

    def hold(name: str, shape: str, run, plain, cut: str):
        """run(k) / plain(k): the binding and its plain version on the
        input's first 1/k; cut names that part."""
        t0 = time.perf_counter()
        want = plain(PLAIN_CUT)
        plain_ms = (time.perf_counter() - t0) * 1e3
        check(same_arrays(run(PLAIN_CUT), want),
              f"host library {name}: differs from its plain version")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = run(1)
            times.append((time.perf_counter() - t0) * 1e3)
        row = {"name": name, "shape": shape,
               "native_ms": round(sorted(times)[1], 3),
               "plain_ms": round(plain_ms, 3), "plain_on": cut}
        log(f"host library {name} ({shape}): {row['native_ms']} ms; plain "
            f"{row['plain_ms']} ms on {cut}, equal to the library's there")
        rows.append(row)
        return got

    def head(n: int, k: int) -> int:
        return -(-n // k)

    def text_head(k: int) -> bytes:
        """The chunk's first 1/k, cut after a newline."""
        end = chunk.rfind(b"\n", 0, head(len(chunk), k)) + 1
        return chunk[:end or len(chunk)]

    def ragged_head(kb, ko, k: int):
        n = head(len(ko) - 1, k)
        return kb[:int(ko[n])], ko[:n + 1]

    def word_count(k: int):
        agg = native.WordCountAggregator()
        try:
            agg.feed(text_head(k))
            return agg.emit()
        finally:
            agg.close()

    text = f"{len(chunk)} bytes of text"
    lines = "the text's first sixteenth (whole lines)"
    wb, wo = hold("split_ws", text,
                  lambda k: native.split_ws_native(text_head(k)),
                  lambda k: native.split_ws_plain(text_head(k)), lines)
    n = len(wo) - 1
    hold("word_count", text, word_count,
         lambda k: native.word_count_plain([text_head(k)]), lines)
    ones = np.ones(n, np.int64)
    hold("hash_sum", f"{n} words",
         lambda k: native.hash_sum_native(*ragged_head(wb, wo, k),
                                          ones[:head(n, k)]),
         lambda k: native.hash_sum_plain(*ragged_head(wb, wo, k),
                                         ones[:head(n, k)]),
         "the first sixteenth of the words")
    # gather_mb gathers: ragged words, and fixed 8-byte rows
    g = int(sz["gather_mb"] * 1e6)
    cut = int(np.searchsorted(wo, min(g, int(wo[-1]))))
    gb, go = wb[:int(wo[cut])], wo[:cut + 1]
    perm = rng.permutation(cut)
    hold("gather_ragged", f"{cut} rows, {len(gb)} bytes",
         lambda k: native.gather_ragged_native(gb, go,
                                               perm[:head(cut, k)]),
         lambda k: native.gather_ragged_plain(gb, go, perm[:head(cut, k)]),
         "the first sixteenth of the permutation")
    fixed = rng.integers(0, 256, g // 8 * 8, dtype=np.uint8)
    fperm = rng.permutation(g // 8)
    hold("gather_fixed", f"{g // 8} rows of 8 bytes",
         lambda k: native.gather_fixed_native(fixed, 8,
                                              fperm[:head(g // 8, k)]),
         lambda k: native.gather_fixed_plain(fixed, 8,
                                             fperm[:head(g // 8, k)]),
         "the first sixteenth of the permutation")
    del wb, wo, ones, gb, go, perm, fixed, fperm, chunk
    # phase 8's spans: the host engine's partition, sort and fused sort
    span_bytes = int(sz["span_mb"] * (1 << 20))
    spans, _ids = indexed_word_batches(rng, mat, lens, span_bytes,
                                       spans=sz["runs"])
    b = spans[0]
    kb, ko, vb, vo = b.key_bytes, b.key_offsets, b.val_bytes, b.val_offsets
    shape = f"{b.num_records} records, {len(kb) + len(vb)} bytes of KV"
    records = "the span's first sixteenth of records"
    parts = hold("fnv32_partition", shape,
                 lambda k: native.fnv32_partition_native(
                     *ragged_head(kb, ko, k), NUM_PARTITIONS),
                 lambda k: native.fnv32_partition_plain(
                     *ragged_head(kb, ko, k), NUM_PARTITIONS), records)
    hold("sort_partition_keys", shape,
         lambda k: native.sort_partition_keys_native(
             *ragged_head(kb, ko, k), parts[:head(len(parts), k)]),
         lambda k: native.sort_partition_keys_plain(
             *ragged_head(kb, ko, k), parts[:head(len(parts), k)]), records)
    skb, sko, *_ = hold(
        "span_sort_emit", shape,
        lambda k: native.span_sort_emit_native(
            *ragged_head(kb, ko, k), *ragged_head(vb, vo, k),
            NUM_PARTITIONS, None, True),
        lambda k: native.span_sort_emit_plain(
            *ragged_head(kb, ko, k), *ragged_head(vb, vo, k),
            NUM_PARTITIONS, None, True), records)
    slen = np.diff(sko)
    cand = np.flatnonzero(slen[1:] == slen[:-1])
    hold("adjacent_equal", f"{len(cand)} pairs",
         lambda k: native.adjacent_equal_native(skb, sko,
                                                cand[:head(len(cand), k)]),
         lambda k: native.adjacent_equal_plain(skb, sko,
                                               cand[:head(len(cand), k)]),
         "the first sixteenth of the pairs")
    # phase 8's runs: the host engine's merges
    runs = [native.span_sort_emit_native(
        s.key_bytes, s.key_offsets, s.val_bytes, s.val_offsets,
        NUM_PARTITIONS, None, True) for s in spans]
    del spans
    records = sum(len(r[1]) - 1 for r in runs)
    shape = f"{len(runs)} runs, {records} records"

    def first_runs(k: int) -> list:
        # whole runs keep their sort: the first half of them, or all
        return runs if k == 1 else runs[:max(2, len(runs) // 2)]
    hold("merge_emit", shape,
         lambda k: native.merge_emit_native(first_runs(k), NUM_PARTITIONS),
         lambda k: native.merge_emit_plain(first_runs(k), NUM_PARTITIONS),
         "the first half of the runs")
    from tez_tpu_torch.ops.runformat import concat_ragged

    def merge_args(k: int) -> tuple:
        rs = first_runs(k)
        ckb, cko = concat_ragged([(r[0], r[1]) for r in rs])
        cparts = np.concatenate([np.repeat(np.arange(NUM_PARTITIONS,
                                                     dtype=np.int32),
                                           np.diff(r[4])) for r in rs])
        bounds = np.zeros(len(rs) + 1, np.int64)
        np.cumsum([len(r[1]) - 1 for r in rs], out=bounds[1:])
        return ckb, cko, cparts, bounds
    full, half = merge_args(1), merge_args(PLAIN_CUT)
    hold("merge_runs", shape,
         lambda k: native.merge_runs_native(*(full if k == 1 else half)),
         lambda k: native.merge_runs_plain(*half),
         "the first half of the runs")
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


#: calls into the host library, summed over the paths since main() last
#: cleared it (a phase's share)
NATIVE_TOTALS: collections.Counter = collections.Counter()


class Launches:
    """Kernel launches and host-library calls of one path: the counts are
    zeroed just before it runs and read just after; `totals` sums the
    kernel launches of the phase's paths, NATIVE_TOTALS their calls into
    the host library."""

    def __init__(self, name: str, totals: collections.Counter):
        self.name, self.totals = name, totals

    def __enter__(self):
        from tez_tpu_torch.ops import kernels, native
        kernels.reset_launches()
        native.reset_calls()
        return self

    def __exit__(self, exc_type, *_):
        from tez_tpu_torch.ops import kernels, native
        self.counts = dict(kernels.launches)
        self.native = {k: v for k, v in native.calls.items() if v}
        if exc_type is None:
            self.totals.update(self.counts)
            NATIVE_TOTALS.update(self.native)
            log(f"launches {self.name}: {json.dumps(self.counts)} "
                f"host library {json.dumps(self.native)}")
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

    def require_native(self, *names) -> None:
        """The path called at least one of the named host-library
        functions (on any device: the library runs on the host)."""
        check(sum(self.native.get(n, 0) for n in names) > 0,
              f"{self.name}: the host library's {' / '.join(names)} never "
              f"ran")

    def require_host_merges(self, host_rounds: int) -> None:
        """Merge passes routed to the host engine ran in the host
        library."""
        if host_rounds:
            self.require_native("tz_merge_emit", "tz_merge_runs")


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
            watch_reserved(pipe, device)
            pipelines.append(pipe)
        for batch in batches:
            s.write_batch(batch)
        check(s.num_spills == len(batches),
              f"expected {len(batches)} span sorts, got {s.num_spills}")
        runs.append(s.flush())
    return runs


def watch_reserved(pipe, device) -> None:
    """Record the caching allocator's reserved bytes and the dispatching
    thread's CPU time at each edge of each span's dispatch stage, in
    pipe.reserved and pipe.dispatch_cpu ({(ids, edge): value}): a first
    allocation on a fresh compute stream would show as growth across a
    dispatch, and a dispatch whose CPU time is far below its wall time
    waited (on the GIL or in a blocking driver call) rather than worked."""
    import torch
    pipe.reserved, pipe.dispatch_cpu = {}, {}
    if not is_cuda(device):
        return
    real = pipe._mark

    def mark(ids, stage, edge):
        if stage == "device.dispatch":
            pipe.reserved[(ids, edge)] = torch.cuda.memory_reserved(device)
            pipe.dispatch_cpu[(ids, edge)] = time.thread_time()
        return real(ids, stage, edge)
    pipe._mark = mark


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
        disp, waits, reserved, cpu = [], [], [], []
        for ids in sorted({e[0] for e in edges}, key=repr):
            d0 = edges.get((ids, "device.dispatch", "start"))
            d1 = edges.get((ids, "device.dispatch", "end"))
            r1 = edges.get((ids, "device.d2h", "end"))
            if None not in (d0, d1, r1):
                disp.append(d1 - d0)
                waits.append(r1 - d0)
                reserved.append(tuple(
                    pipe.reserved.get((ids, e), 0) >> 20
                    for e in ("start", "end")))
                c0, c1 = (pipe.dispatch_cpu.get((ids, e), 0.0)
                          for e in ("start", "end"))
                cpu.append(round((c1 - c0) * 1e3, 3))
        log(f"{label} producer {i}: max_in_flight={st.max_in_flight} "
            f"coalesced_groups={st.coalesced_groups} dispatched="
            f"{st.dispatched} dispatch_ms={[round(d * 1e3, 3) for d in disp]}"
            f" dispatch_wait_ms={[round(w * 1e3, 3) for w in waits]}"
            f" reserved_mib_before_after_dispatch={reserved}"
            f" dispatch_thread_cpu_ms={cpu}")
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
    # phase 20 B's PipelinedSorter proxy over these records, one producer
    # span a map span (cheaper here than a second map side there)
    PROXY_RUNS["sorter"] = sorter_proxy_check(
        vocab[ids], vals, 2 * args.producers, merged)
    log(f"reduce: the PipelinedSorter proxy over the same records in "
        f"{2 * args.producers} spans took "
        f"{PROXY_RUNS['sorter']['proxy_s']:.3f} s; its counts, keys and "
        f"values are the merged run's")
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
    ln.require_native("hash_sum_i64")
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
    from tez_tpu_torch.ops import kernels, native
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
        native.reset_calls()
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
        NATIVE_TOTALS.update({k: v for k, v in native.calls.items() if v})
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


def spill_phase(args, device="cuda", producers: int = SPILL_PRODUCERS,
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
            ln.require_host_merges(probe.rounds["host"])
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
                f"{ln.counts['merge_path_pair']}; host library merges "
                f"tz_merge_emit {ln.native.get('tz_merge_emit', 0)} "
                f"tz_merge_runs {ln.native.get('tz_merge_runs', 0)}")
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
#: disk-direct sources of 8 MiB, 672 MiB in all: at half the segments
#: the fetchers' race with the merger decides between 2 and 3 mem->disk
#: merges, and the leg wants at least 3.  Leg B: 32 segments and one
#: skewed segment, committed in slot order (24 segments would cross the
#: merge threshold once: 13 segments of ~16.2 MiB with their offsets pass
#: 0.9 x 230.4 MiB, the other 11 do not).  Leg C: 48 segments of 1 MiB
#: against a 16 MiB budget at merge factor 4.  Leg D: two sorters of 2
#: spans of 8 MB each (cut from 4 spans, then from 16 MB spans when
#: phase 19 came), a 16 MiB merge budget; leg E half of B's input at half
#: its budget (cut from B's whole input to fit phase 20; it crosses the
#: merge threshold as B does), its hang 3 s (10 s until phase 19 came)
#: against the same 500 ms watchdog.
MERGE_SIZES = dict(vocab_size=SPILL_VOCAB, budget=int(256 * (1 << 20) * 0.9),
                   device_min_records=1 << 16, seg_mb=8, segments_a=64,
                   skew_mb=64, skews_a=2, locals_a=4, segments_b=32,
                   c_seg_mb=1, c_segments=48, c_budget_mb=16, d_vocab=100_000,
                   d_span_mb=8, d_spans=2, d_budget_mb=16, hang_ms=3_000)
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
    chunked runs whole, a disk-direct source's partition).  A pass is a
    merge_sorted_runs call: the sorters' span sorts, routed alike, are
    not counted."""

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
            if sys._getframe(1).f_code.co_name != "merge_sorted_runs":
                return out
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
        self.launches.require_host_merges(p.rounds["host"])
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

    # -- E: half of B's input, skew segment included, at half its budget,
    # under the merge lane's faults; each against E's fault-free run -----
    q = sz["segments_b"] // 4
    e_in, e_budget = b_in[q:3 * q + 1], sz["budget"] // 2
    del b_in
    d2, mm, c, br = run("E reference", e_in, e_budget)
    check_merge_fault_free("merge E reference", mm, c, br)
    d, mm, c, _br = run("E oom", e_in, e_budget,
                        spec="device.dispatch.oom:fail:n=1,exc=runtime,"
                             "match=span=0",
                        breaker=CircuitBreaker(failures=100))
    fo = c.to_dict().get(COUNTER_GROUP, {})
    check(d == d2, "merge E oom: output differs from E's reference")
    check(fo.get("device.oom.split_attempts") == 1 and
          fo.get("device.oom.split_success") == 1 and
          not fo.get("device.failover.spans") and
          mm._pipeline.stats.failovers == 0,
          f"merge E oom: split ladder counters {fo}")
    log(f"merge E oom: split on the card, no failover, byte-identical "
        f"{json.dumps(fo)}")
    t0 = time.perf_counter()
    d, mm, c, _br = run("E hang", e_in, e_budget,
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
    check(d == d2, "merge E hang: output differs from E's reference")
    check(fo.get("device.watchdog.dispatch_fires") == 1 and
          fo.get("device.failover.spans", 0) >= 1,
          f"merge E hang: watchdog counters {fo}")
    log(f"merge E hang: {sz['hang_ms']} ms hang against a 500 ms watchdog, "
        f"host failover, byte-identical, {time.perf_counter() - t0:.3f} s "
        f"with the wait for the hang to end {json.dumps(fo)}")
    br = CircuitBreaker(failures=1, cooldown_ms=3_600_000)
    d, mm, c, _br = run("E breaker", e_in, e_budget, breaker=br,
                        spec="device.readback.fail:fail:n=1,exc=io,"
                             "match=span=0")
    fo = c.to_dict().get(COUNTER_GROUP, {})
    check(d == d2, "merge E breaker: output differs from E's reference")
    check(br.trips == 1 and br.state == "open" and
          fo.get("device.breaker.short_circuits", 0) >= 1 and
          fo.get("device.failover.spans", 0) >= 2,
          f"merge E breaker: {br.trips} trips, state {br.state}, {fo}")
    log(f"merge E breaker: tripped once, later merges short-circuited to "
        f"the host, byte-identical {json.dumps(fo)}")
    del e_in

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


# ---------------------------------------------------------------------------
# phase 10: map and reduce tasks through the task runtime and the ordered
# shuffle IO
# ---------------------------------------------------------------------------
#: the edge's vertices: task attempt ids carry the vertex's index
MAP_VERTEX, REDUCE_VERTEX = 0, 1
#: tez_tpu's library defaults for one ordered shuffle edge
#: (tez_tpu/library/outputs.py, inputs.py): io.sort.mb 256, key width 16,
#: the engine `auto`, pipeline depth 2; words as bytes, counts as longs
TASK_CONF = {"tez.runtime.io.sort.mb": 256,
             "tez.runtime.tpu.key.width.bytes": 16,
             "tez.runtime.sorter.class": "auto",
             "tez.runtime.sort.pipeline.depth": 2,
             "tez.runtime.key.class": "bytes",
             "tez.runtime.value.class": "long"}
#: phase 10's legs: A no combiner, B the sum combiner, C pipelined shuffle
TASK_LEGS = {"A": {},
             "B": {"tez.runtime.combiner.class": "sum_long"},
             "C": {"tez.runtime.pipelined-shuffle.enabled": True}}
#: phase 10's size: 4 maps x 4 reducers, each map 256 MiB of keys and
#: values (so each reducer's ~256 MiB passes its 230.4 MiB merge budget)
TASK_SIZES = dict(maps=4, reducers=4, map_mb=256, vocab_size=SPILL_VOCAB,
                  conf={})
#: a size the plain versions run in seconds: at io.sort.mb 4 each map's 4
#: MiB takes two spans of over 65,536 records (the device floor) and each
#: reducer's ~4 MiB passes its 3.6 MiB merge budget
TINY_TASKS = dict(maps=4, reducers=4, map_mb=4, vocab_size=20_000,
                  conf={"tez.runtime.io.sort.mb": 4})


def task_api(root: str = "tez_tpu_torch", device=None):
    """The task-level API of a package as one namespace: the port's, or
    (root="tez_tpu") the reference's, which the parity tests drive through
    the same harness.  device is the port's runner device (tez_tpu's runner
    takes none)."""
    import importlib
    import types

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    spec, rf = mod("runtime.task_spec"), mod("ops.runformat")
    return types.SimpleNamespace(
        root=root, TaskRunner=mod("runtime.task_runner").TaskRunner,
        TaskSpec=spec.TaskSpec, InputSpec=spec.InputSpec,
        OutputSpec=spec.OutputSpec, ids=mod("common.ids"),
        payload=mod("common.payload"), events=mod("api.events"),
        HeartbeatResponse=mod("am.task_comm").HeartbeatResponse,
        ScatterGatherEdgeManager=mod("am.edge").ScatterGatherEdgeManager,
        EdgeManagerPluginContext=mod(
            "api.edge_manager").EdgeManagerPluginContext,
        ObjectRegistry=mod("api.runtime").ObjectRegistry,
        KVBatch=rf.KVBatch, TaskCounter=mod("common.counters").TaskCounter,
        service=mod("shuffle.service").local_shuffle_service(),
        runner_kw={} if device is None else {"device": device})


class LocalUmbilical:
    """The AM's side of the umbilical for one scatter-gather edge from
    vertex "map" to vertex "reduce", in the process.  It keeps each map
    attempt's events and, once the map wave is released, routes its
    CompositeDataMovementEvents through the package's
    ScatterGatherEdgeManager to each reducer's heartbeats as
    CompositeRoutedDataMovementEvents, as tez_tpu's EdgeImpl does
    (tez_tpu/am/edge.py get_events_for_task): map by map in task order,
    each map's events in the order it sent them.  `rewrite(dest, events)`
    may change what one delivery carries (a test's injected events)."""

    def __init__(self, api, num_maps: int, num_reducers: int,
                 rewrite=None):
        import threading

        class _EdgeContext(api.EdgeManagerPluginContext):
            source_vertex_name = "map"
            destination_vertex_name = "reduce"
            source_vertex_num_tasks = num_maps
            destination_vertex_num_tasks = num_reducers
            user_payload = api.payload.UserPayload()

        self.api, self.rewrite = api, rewrite
        self.edge = api.ScatterGatherEdgeManager(_EdgeContext())
        self.edge.initialize()
        self.lock = threading.Lock()
        self.log = []          # (map task, attempt number, event)
        self.vm_payloads = []  # (map task, VertexManagerEvent payload)
        self.routed = {}       # reducer -> log entries routed to it
        self.released = False
        #: per attempt (str): "SUCCEEDED" | "FAILED" | "KILLED", and the
        #: diagnostics, fatal flag and counters it reported
        self.states, self.diagnostics, self.counters = {}, {}, {}
        self.fatal = {}

    def _collect(self, attempt_id, tez_events) -> None:
        src = attempt_id.task_id.id
        with self.lock:
            for te in tez_events:
                ev = te.event
                if isinstance(ev, self.api.events.VertexManagerEvent):
                    self.vm_payloads.append((src, ev.user_payload))
                else:
                    self.log.append((src, attempt_id.id, ev))

    def release(self) -> None:
        """The map wave is done: route its events from now on."""
        with self.lock:
            self.log.sort(key=lambda entry: entry[0])
            self.released = True

    def _route(self, dest: int) -> list:
        ev = self.api.events
        out = []
        with self.lock:
            if not self.released:
                return out
            for src, version, e in self.log[self.routed.get(dest, 0):]:
                if not isinstance(e, ev.CompositeDataMovementEvent):
                    continue
                meta = self.edge.\
                    route_composite_data_movement_event_to_destination(
                        src, dest)
                if meta is not None:
                    out.append(ev.CompositeRoutedDataMovementEvent(
                        source_index=meta.source,
                        target_index_start=meta.target, count=meta.count,
                        user_payload=e.user_payload, version=version))
            self.routed[dest] = len(self.log)
        if out and self.rewrite is not None:
            out = self.rewrite(dest, out)
        return out

    def heartbeat(self, req):
        aid = req.attempt_id
        if aid.task_id.vertex_id.id == MAP_VERTEX:
            self._collect(aid, req.events)
            return self.api.HeartbeatResponse([])
        return self.api.HeartbeatResponse(
            [("map", e) for e in self._route(aid.task_id.id)])

    def task_done(self, attempt_id, events, counters, **_stamps) -> None:
        if attempt_id.task_id.vertex_id.id == MAP_VERTEX:
            self._collect(attempt_id, events)
        with self.lock:
            self.states[str(attempt_id)] = "SUCCEEDED"
            self.counters[str(attempt_id)] = counters

    def task_failed(self, attempt_id, diagnostics, fatal=False,
                    counters=None) -> None:
        with self.lock:
            self.states[str(attempt_id)] = "FAILED"
            self.diagnostics[str(attempt_id)] = diagnostics
            self.fatal[str(attempt_id)] = fatal
            self.counters[str(attempt_id)] = counters

    def task_killed(self, attempt_id, diagnostics) -> None:
        with self.lock:
            self.states[str(attempt_id)] = "KILLED"
            self.diagnostics[str(attempt_id)] = diagnostics

    def can_commit(self, *_a, **_kw) -> bool:
        return True


class EdgeMapProcessor:
    """Map task of the edge harness: writes the records in its object
    registry ("records") to its one output, batch by batch through
    write_batch, or pair by pair through write when its payload says
    {"mode": "records"} (each pair a logical key and value)."""

    def __init__(self, context):
        self.context = context

    def initialize(self) -> None:
        pass

    def handle_events(self, events) -> None:
        pass

    def run(self, inputs, outputs) -> None:
        payload = self.context.user_payload.load() or {}
        writer = outputs["reduce"].get_writer()
        records = self.context.object_registry.get("records")
        if payload.get("mode") == "records":
            for key, value in records:
                writer.write(key, value)
        else:
            for batch in records:
                writer.write_batch(batch)

    def close(self) -> None:
        pass


class EdgeReduceProcessor:
    """Reduce task of the edge harness; what it reads into its object
    registry ("result") depends on its payload's mode:
    "sum" (the default): OrderedWordCount's SumProcessor through
    grouped_blocks, each group's key and the sum of its long values, as
    (key bytes, key lengths, sums); "blocks": every (block, group starts)
    of grouped_blocks as arrays; "groups": the (key, [values]) pairs of
    the reader's __iter__."""

    def __init__(self, context):
        self.context = context

    def initialize(self) -> None:
        pass

    def handle_events(self, events) -> None:
        pass

    def run(self, inputs, outputs) -> None:
        mode = (self.context.user_payload.load() or {}).get("mode", "sum")
        reader = inputs["map"].get_reader()
        if mode == "groups":
            result = [(k, list(vs)) for k, vs in reader]
        elif mode == "blocks":
            result = [(b.key_bytes.copy(), b.key_offsets.copy(),
                       b.val_bytes.copy(), b.val_offsets.copy(),
                       np.asarray(s).copy())
                      for b, s in reader.grouped_blocks()]
        else:
            from tez_tpu_torch.ops.serde import decode_longs_be
            keys, lens, sums = [], [], []
            for b, starts in reader.grouped_blocks():
                if b.num_records == 0:
                    continue
                firsts = b.take(starts)
                keys.append(firsts.key_bytes)
                lens.append(np.diff(firsts.key_offsets))
                sums.append(np.add.reduceat(
                    decode_longs_be(b.val_bytes, b.num_records), starts))
            cat = (lambda xs, dt: np.concatenate(xs) if xs
                   else np.zeros(0, dt))
            result = (cat(keys, np.uint8), cat(lens, np.int64),
                      cat(sums, np.int64))
        self.context.object_registry.add("session", "result", result)

    def close(self) -> None:
        pass


class EdgeRun:
    """One run of the edge: the umbilical, each wave's runners (with their
    object registries) and states, and the waves' wall seconds."""

    def __init__(self, umbilical, maps, reducers, map_wall, reduce_wall):
        self.umbilical, self.maps, self.reducers = umbilical, maps, reducers
        self.map_wall, self.reduce_wall = map_wall, reduce_wall

    def results(self) -> list:
        return [reg.get("result") for _r, reg, _s in self.reducers]

    def counters(self, wave: str) -> list:
        return [r.counters for r, _reg, _s in getattr(self, wave)]


def run_edge(api, conf: dict, map_records: list, num_reducers: int,
             work_root: str, map_payload=None, reduce_payload=None,
             processors=("chip_smoke:EdgeMapProcessor",
                         "chip_smoke:EdgeReduceProcessor"),
             concurrent: bool = True, rewrite=None,
             on_maps_done=None) -> EdgeRun:
    """Runs one scatter-gather edge through a package's TaskRunner: a map
    task per entry of map_records (what its processor writes), then, once
    every map succeeded, num_reducers reduce tasks, each wave concurrently
    (or task by task).  Each task gets a work directory of its own under
    work_root (its spill directory).  on_maps_done(umbilical) runs between
    the waves.  Returns the EdgeRun; the shuffle service's registrations
    of the run are dropped after it."""
    import threading
    ids, pl = api.ids, api.payload
    dag = ids.DAGId("app_1700000000_0001", 1)
    umb = LocalUmbilical(api, len(map_records), num_reducers,
                         rewrite=rewrite)
    out_cls = f"{api.root}.library.outputs:OrderedPartitionedKVOutput"
    in_cls = f"{api.root}.library.inputs:OrderedGroupedKVInput"

    def runner(vertex, name, task, parallelism, processor, payload, ins,
               outs, registry):
        spec = api.TaskSpec(
            attempt_id=dag.vertex(vertex).task(task).attempt(0),
            dag_name="edge", vertex_name=name,
            vertex_parallelism=parallelism,
            processor_descriptor=pl.ProcessorDescriptor.create(processor,
                                                               payload),
            inputs=ins, outputs=outs, conf=dict(conf))
        work_dir = os.path.join(work_root, f"{name}_{task}")
        os.makedirs(work_dir, exist_ok=True)
        return api.TaskRunner(spec, umb, registry=registry,
                              work_dir=work_dir, **api.runner_kw)

    def wave(runners) -> float:
        states = [None] * len(runners)

        def one(i):
            states[i] = runners[i][0].run()
        t0 = time.perf_counter()
        if concurrent:
            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(len(runners))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            for i in range(len(runners)):
                one(i)
        wall = time.perf_counter() - t0
        for i, (r, reg, _s) in enumerate(runners):
            runners[i] = (r, reg, states[i])
        return wall

    out_spec = api.OutputSpec("reduce", pl.OutputDescriptor.create(out_cls),
                              num_reducers)
    in_spec = api.InputSpec("map", pl.InputDescriptor.create(in_cls),
                            len(map_records))
    maps = []
    for m, records in enumerate(map_records):
        reg = api.ObjectRegistry()
        reg.add(reg.SESSION, "records", records)
        maps.append((runner(MAP_VERTEX, "map", m, len(map_records),
                            processors[0], map_payload, (), (out_spec,),
                            reg), reg, None))
    try:
        map_wall = wave(maps)
        reducers, reduce_wall = [], 0.0
        if all(s == "SUCCEEDED" for _r, _g, s in maps):
            umb.release()
            if on_maps_done is not None:
                on_maps_done(umb)
            for d in range(num_reducers):
                reg = api.ObjectRegistry()
                reducers.append((runner(REDUCE_VERTEX, "reduce", d,
                                        num_reducers, processors[1],
                                        reduce_payload, (in_spec,), (),
                                        reg), reg, None))
            reduce_wall = wave(reducers)
    finally:
        api.service.unregister_prefix(str(dag))
    return EdgeRun(umb, maps, reducers, map_wall, reduce_wall)


def task_batches(rng, mat, lens, kv_bytes: int) -> tuple:
    """Batches of Zipf(1.3) words with the value 1 (8 bytes), until they
    hold kv_bytes of keys and values.  Returns (batches, word ids)."""
    chunk = max(1 << 20, min(64 << 20, kv_bytes // 4))
    batches, ids, kv = [], [], 0
    while kv < kv_bytes:
        batch, bids = word_batch(rng, mat, lens, chunk)
        batches.append(batch)
        ids.append(bids)
        kv += int(batch.key_offsets[-1]) + 8 * batch.num_records
    return batches, np.concatenate(ids)


def strictly_increasing(kb: np.ndarray, klen: np.ndarray) -> bool:
    """Keys (1-16 bytes, no zero byte) in strictly increasing byte order."""
    if len(klen) < 2:
        return True
    ko = np.zeros(len(klen) + 1, dtype=np.int64)
    np.cumsum(klen, out=ko[1:])
    lanes = be_lanes(key_matrix(kb, ko)[0]).astype(np.uint64)
    hi = (lanes[:, 0] << np.uint64(32)) | lanes[:, 1]
    lo = (lanes[:, 2] << np.uint64(32)) | lanes[:, 3]
    a, b = slice(None, -1), slice(1, None)
    up = (hi[b] > hi[a]) | ((hi[b] == hi[a]) & (
        (lo[b] > lo[a]) | ((lo[b] == lo[a]) & (klen[b] > klen[a]))))
    return bool(up.all())


def task_goldens(mat, lens, ids, reducers: int) -> list:
    """Each reducer's expected output: the words of its partition (FNV-1a
    of the word mod reducers) that occur, in byte order, with their
    counts, as (key bytes, key lengths, counts)."""
    counts = np.bincount(ids, minlength=len(mat))
    part = (fnv_np(mat, lens) % np.uint64(reducers)).astype(np.int64)
    rank = key_rank(mat, lens)
    out = []
    for r in range(reducers):
        vs = np.flatnonzero((counts > 0) & (part == r))
        vs = vs[np.argsort(rank[vs])]
        kb, _ko = ragged_keys(mat[vs], lens[vs])
        out.append((kb, lens[vs], counts[vs]))
    return out


def check_edge(label: str, api, run: EdgeRun, goldens: list,
               records_per_map: list) -> None:
    """Phase 10's gates on one leg: every task SUCCEEDED without a
    failover, each reducer's output its golden, strictly increasing, and
    the counters consistent with the records and the partitions."""
    from tez_tpu_torch.ops.async_stage import (COUNTER_GROUP,
                                               process_breaker)
    TC = api.TaskCounter
    umb = run.umbilical
    states = dict(umb.states)
    check(len(states) == len(run.maps) + len(run.reducers) and
          set(states.values()) == {"SUCCEEDED"},
          f"{label}: task states {states} {umb.diagnostics}")
    for c in run.counters("maps") + run.counters("reducers"):
        moved = {k: v for k, v in c.to_dict().get(COUNTER_GROUP, {}).items()
                 if v}
        check(not moved, f"{label}: DeviceFailover counters moved {moved}")
    br = process_breaker()
    check(br.state == "closed" and br.trips == 0,
          f"{label}: breaker {br.state}, {br.trips} trips")
    for m, c in enumerate(run.counters("maps")):
        got = c.find_counter(TC.OUTPUT_RECORDS).value
        check(got == records_per_map[m],
              f"{label}: map {m} OUTPUT_RECORDS {got} != "
              f"{records_per_map[m]}")
    for r, ((kb, kl, sums), (gk, gl, gs), c) in enumerate(zip(
            run.results(), goldens, run.counters("reducers"))):
        check(np.array_equal(kl, gl) and np.array_equal(kb, gk) and
              np.array_equal(sums, gs),
              f"{label}: reducer {r} differs from the golden "
              f"({len(kl)} groups against {len(gl)})")
        check(strictly_increasing(kb, kl),
              f"{label}: reducer {r} keys not strictly increasing")
        groups = c.find_counter(TC.REDUCE_INPUT_GROUPS).value
        check(groups == len(gl), f"{label}: reducer {r} "
                                 f"REDUCE_INPUT_GROUPS {groups} != "
                                 f"{len(gl)}")


def task_phase(args, device="cuda", **sizes) -> dict:
    """Phase 10; returns the kernel launches of its legs."""
    import torch
    from tez_tpu_torch.common.counters import TaskCounter as TC
    from tez_tpu_torch.ops import async_stage
    sz = dict(TASK_SIZES, **sizes)
    api = task_api(device=device)
    rng = np.random.default_rng(args.seed + 10)
    t0 = time.perf_counter()
    mat, lens = bulk_word_vocab(rng, sz["vocab_size"])
    maps = [task_batches(rng, mat, lens, int(sz["map_mb"] * (1 << 20)))
            for _ in range(sz["maps"])]
    ids = np.concatenate([i for _b, i in maps])
    goldens = task_goldens(mat, lens, ids, sz["reducers"])
    kv = sum(int(b.key_offsets[-1]) + 8 * b.num_records
             for bs, _i in maps for b in bs)
    log(f"tasks: {sz['maps']} maps x {sz['reducers']} reducers, "
        f"{len(ids)} records, {kv} bytes of KV, data and goldens in "
        f"{time.perf_counter() - t0:.3f} s")
    totals: collections.Counter = collections.Counter()
    digests = {}
    async_stage.reset_process_breaker()
    with tempfile.TemporaryDirectory(prefix="tez_tasks_") as root:
        for leg, extra in TASK_LEGS.items():
            conf = dict(TASK_CONF, **sz["conf"], **extra)
            label = f"tasks {leg}"
            if is_cuda(device):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            with Launches(label, totals) as launches, \
                    MergeProbe() as probe:
                t0 = time.perf_counter()
                run = run_edge(api, conf, [bs for bs, _i in maps],
                               sz["reducers"], os.path.join(root, leg))
                sync(device)
                wall = time.perf_counter() - t0
            check_edge(label, api, run, goldens,
                       [len(i) for _b, i in maps])
            mc, rc = run.counters("maps"), run.counters("reducers")

            def total(cs, c):
                return sum(x.find_counter(c).value for x in cs)
            if leg == "A":
                parts = sum(sum(p["partition_sizes"])
                            for _m, p in run.umbilical.vm_payloads)
                got = total(rc, TC.SHUFFLE_BYTES)
                check(got == parts, f"{label}: SHUFFLE_BYTES {got} != the "
                                    f"maps' partition bytes {parts}")
            digests[leg] = [tuple(a.tobytes() for a in res)
                            for res in run.results()]
            written = total(mc + rc, TC.ADDITIONAL_SPILLS_BYTES_WRITTEN)
            read = total(mc, TC.ADDITIONAL_SPILLS_BYTES_READ) + \
                probe.read_bytes
            peak = torch.cuda.max_memory_allocated() / 2**30 \
                if is_cuda(device) else float("nan")
            per = [(c.find_counter(TC.SHUFFLE_PHASE_TIME).value,
                    c.find_counter(TC.MERGE_PHASE_TIME).value) for c in rc]
            log(f"phase {label}: wall_s={wall:.3f} "
                f"map_wave_s={run.map_wall:.3f} "
                f"reduce_wave_s={run.reduce_wall:.3f} MB={kv / 1e6:.1f} "
                f"MB_per_s={kv / 1e6 / wall:.1f}")
            log(f"{label}: SHUFFLE_PHASE_TIME / MERGE_PHASE_TIME ms by "
                f"reducer {per}; merge passes on the card "
                f"{probe.rounds['device']} "
                f"({probe.rounds['device_records']} records), on the host "
                f"{probe.rounds['host']} ({probe.rounds['host_records']} "
                f"records); merge_path_runs count={probe.device_calls} "
                f"sum_ms={probe.device_s * 1e3:.3f}; disk bytes written "
                f"{written} read {read}; peak device memory {peak:.3f} GiB; "
                f"shuffle bytes {total(rc, TC.SHUFFLE_BYTES)} (disk-direct "
                f"{total(rc, TC.SHUFFLE_BYTES_DISK_DIRECT)}); mem-to-disk "
                f"merges {total(rc, TC.NUM_MEM_TO_DISK_MERGES)}")
            launches.require(device, "fnv_hash_lanes", "merge_path_pair")
            launches.require_host_merges(probe.rounds["host"])
    for leg in ("B", "C"):
        check(digests[leg] == digests["A"],
              f"tasks {leg}: reducer output differs from leg A's")
    log("tasks: legs A-C passed")
    return dict(totals)


# ---------------------------------------------------------------------------
# phase 11: OrderedWordCount through the port's TezClient and AM
# ---------------------------------------------------------------------------
#: phase 11's DAG: bench.py's _run_wordcount (tez_tpu's bench) at a corpus
#: of 512 MiB (cut from BASELINE config 2's 1 GiB, to 640 MiB and then to
#: 512 when phase 20 came, to keep the script within its time limit; each
#: tokenizer's span of ~750 MB with its offsets still overflows one
#: io.sort.mb span of 512 MiB and spills); leg A combines on the first
#: edge, leg B ships every word
DAG_CONF = {"tez.runtime.io.sort.mb": 512,
            "tez.runtime.sorter.class": "device"}
DAG_SHAPE = dict(tokenizer_parallelism=4, summation_parallelism=4,
                 sorter_parallelism=1, tokenizer_mode="vector")
DAG_LEGS = {"A": {"combine": True}, "B": {"combine": False}}
DAG_SIZES = dict(corpus_mb=512, vocab_size=SPILL_VOCAB, conf={})
#: a size the plain versions run in seconds: each tokenizer's span still
#: clears the 65,536-record device floor at io.sort.mb 4
TINY_DAG = dict(corpus_mb=4, vocab_size=20_000,
                conf={"tez.runtime.io.sort.mb": 4})
WORDS_PER_LINE = 8192
#: untimed history: the events of one run that each entity emits, in order
ENTITY_FIELDS = ("attempt_id", "task_id", "vertex_id", "dag_id")


def dag_api(root: str = "tez_tpu_torch", device=None):
    """The DAG-level API of a package as one namespace: the port's, or
    (root="tez_tpu") the reference's, which the parity tests drive through
    the same helpers.  device is the port's AM device (tez_tpu's client
    takes none)."""
    import importlib
    import types

    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        root=root, dag=mod("dag.dag"), payload=mod("common.payload"),
        edge_config=mod("library.conf").OrderedPartitionedKVEdgeConfig,
        TezClient=mod("client.tez_client").TezClient,
        recovery=mod("am.recovery"),
        client_kw={} if device is None else {"device": device})


def wordcount_description(inputs, output: str, tokenizer_parallelism=-1,
                          summation_parallelism=2, sorter_parallelism=1,
                          combine=True, pipelined=False,
                          tokenizer_mode="simple") -> dict:
    """OrderedWordCount (examples/ordered_wordcount.py build_dag) as one
    description both packages build from; "{root}" names the package."""
    owc = "{root}.examples.ordered_wordcount:"
    e1 = {"tez.runtime.combiner.class": "sum_long"} if combine else {}
    if pipelined:
        e1["tez.runtime.pipelined-shuffle.enabled"] = True
    tok = "VectorTokenProcessor" if tokenizer_mode == "vector" \
        else "TokenProcessor"
    return {
        "name": "OrderedWordCount",
        "vertices": [
            {"name": "tokenizer", "processor": owc + tok,
             "parallelism": tokenizer_parallelism,
             "sources": [("input", "{root}.io.text:TextInput",
                          "{root}.io.text:TextSplitGenerator",
                          {"paths": list(inputs),
                           "desired_splits": tokenizer_parallelism})]},
            {"name": "summation", "processor": owc + "SumProcessor",
             "parallelism": summation_parallelism},
            {"name": "sorter", "processor": owc + "NoOpSorterProcessor",
             "parallelism": sorter_parallelism,
             "sinks": [("output", "{root}.io.file_output:FileOutput",
                        "{root}.io.file_output:FileOutputCommitter",
                        {"path": output, "key_serde": "text",
                         "value_serde": "text"}, {"path": output})]}],
        "edges": [("tokenizer", "summation", "bytes", "long", e1),
                  ("summation", "sorter", "long", "bytes", {})]}


def build_dag(api, desc: dict):
    """desc built with api's DSL: vertices (name, processor, parallelism,
    payload, conf, data sources and sinks) added in order, then ordered
    scatter-gather edges (key serde, value serde, edge conf); an edge end
    that names no vertex of desc is a vertex outside the DAG.  Raises
    what the DSL raises."""
    d, p = api.dag, api.payload

    def cls(name: str) -> str:
        return name.format(root=api.root)
    dag = d.DAG.create(desc["name"])
    for k, v in desc.get("conf", {}).items():
        dag.set_conf(k, v)
    vertices = {}
    for v in desc["vertices"]:
        vx = d.Vertex.create(v["name"], p.ProcessorDescriptor.create(
            cls(v["processor"]), payload=v.get("payload")), v["parallelism"])
        for k, val in v.get("conf", {}).items():
            vx.set_conf(k, val)
        for name, inp, init, payload in v.get("sources", ()):
            vx.add_data_source(name, d.DataSourceDescriptor.create(
                p.InputDescriptor.create(cls(inp)),
                p.InputInitializerDescriptor.create(cls(init),
                                                    payload=payload)))
        for name, out, committer, payload, cpayload in v.get("sinks", ()):
            vx.add_data_sink(name, d.DataSinkDescriptor.create(
                p.OutputDescriptor.create(cls(out), payload=payload),
                p.OutputCommitterDescriptor.create(cls(committer),
                                                   payload=cpayload)))
        vertices.setdefault(v["name"], vx)
        dag.add_vertex(vx)
    for src, dst, key, value, conf in desc["edges"]:
        ends = [vertices.get(n) or d.Vertex.create(
                    n, p.ProcessorDescriptor.create(
                        cls("{root}.library.processors:SimpleProcessor")), 1)
                for n in (src, dst)]
        builder = api.edge_config.new_builder(key, value)
        for k, val in conf.items():
            builder.set_conf(k, val)
        dag.add_edge(d.Edge.create(
            *ends, builder.build().create_default_edge_property()))
    return dag


class DagRun:
    """One DAG's run through a package's TezClient: the final state, the
    wall time from submit to completion, the DAG's counters, the AM's
    history events and the recovery journal's lines."""

    def __init__(self, state, wall, counters, events, journal):
        self.state, self.wall, self.counters = state, wall, counters
        self.events, self.journal = events, journal

    def vertex_spans(self) -> dict:
        """vertex name -> (first task start, last task finish), wall-clock
        seconds, from the history's task events."""
        from tez_tpu_torch.am.history import HistoryEventType as H
        names, spans = {}, {}
        for ev in self.events:
            if ev.event_type.name == H.TASK_STARTED.name:
                names[ev.vertex_id] = ev.data["vertex_name"]
        for ev in self.events:
            kind = ev.event_type.name
            if kind not in (H.TASK_STARTED.name, H.TASK_FINISHED.name):
                continue
            lo, hi = spans.get(names[ev.vertex_id], (math.inf, -math.inf))
            spans[names[ev.vertex_id]] = (
                min(lo, ev.timestamp) if kind == H.TASK_STARTED.name else lo,
                max(hi, ev.timestamp) if kind == H.TASK_FINISHED.name
                else hi)
        return spans

    def entity_sequences(self, events=None) -> dict:
        """Each DAG entity's history event types in order, keyed by its id
        with the application id cut out (the ids of two runs differ only
        there)."""
        out: dict = collections.defaultdict(list)
        for ev in self.events if events is None else events:
            for field in ENTITY_FIELDS:
                ident = getattr(ev, field)
                if ident:
                    key = ident.split("_", 3)[-1] if field != "dag_id" \
                        else "dag"
                    out[(field, key)].append(ev.event_type.name)
                    break
        return dict(out)


class StorePeaks:
    """Polls a package's process store while a DAG runs: the peak bytes of
    each tier (stats() every `period` seconds, once more at stop).  With
    `enabled` false it starts no thread and the peaks stay 0."""

    def __init__(self, root: str, period: float = 0.02,
                 enabled: bool = True):
        import importlib
        self._store_mod = importlib.import_module(f"{root}.store")
        self.period = period
        self.enabled = enabled
        self.peak = {"device": 0, "host": 0, "disk": 0}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True,
                                        name="store-peaks")

    def _sample(self) -> None:
        store = self._store_mod.local_buffer_store()
        if store is not None:
            for tier, b in store.stats()["bytes"].items():
                self.peak[tier] = max(self.peak[tier], int(b))

    def _poll(self) -> None:
        while not self._stop.wait(self.period):
            self._sample()

    def __enter__(self) -> "StorePeaks":
        if self.enabled:
            self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        if self.enabled:
            self._stop.set()
            self._thread.join()
            self._sample()


class SessionRun:
    """Several DAGs through one client: each DagRun, the process store's
    counters after each DAG and each DAG's peak tier bytes."""

    def __init__(self):
        self.app_id = ""
        self.runs: list = []
        self.store_counters: list = []
        self.peaks: list = []

    @property
    def peak_device_bytes(self) -> list:
        return [p["device"] for p in self.peaks]


def run_session(api, descs: list, conf: dict, timeout: float = 3600,
                between=None) -> SessionRun:
    """descs through ONE of api's TezClients (conf must name the staging
    directory), one DAG after another (a session: the AM, its runners and
    the process's buffer store live across them); between() runs after
    each DAG.  Each DagRun holds the AM's history events since the one
    before it (the first from the AM's start).  When conf enables the
    store, its tiers are polled while each DAG runs."""
    import importlib
    store_mod = importlib.import_module(f"{api.root}.store")
    polled = str(conf.get("tez.runtime.store.enabled", "")).lower() in (
        "1", "true", "yes")
    out = SessionRun()
    client = api.TezClient.create(descs[0]["name"], conf, **api.client_kw)
    client.start()
    try:
        am = client.framework_client.am
        out.app_id = am.app_id
        n0 = 0
        for desc in descs:
            dag = build_dag(api, desc)
            with StorePeaks(api.root, enabled=polled) as peaks:
                t0 = time.perf_counter()
                handle = client.submit_dag(dag)
                status = handle.wait_for_completion(timeout=timeout)
                wall = time.perf_counter() - t0
            store = store_mod.local_buffer_store()
            out.store_counters.append(
                dict(store.stats()["counters"]) if store is not None else {})
            out.peaks.append(dict(peaks.peak))
            events = list(am.logging_service.events)
            out.runs.append(DagRun(
                status.state.name, wall,
                status.counters.to_dict() if status.counters else {},
                events[n0:], []))
            n0 = len(events)
            if between is not None:
                between()
    finally:
        client.stop()
    return out


def run_dag(api, desc: dict, conf: dict, timeout: float = 3600) -> DagRun:
    """desc through api's TezClient and AM (conf must name the staging
    directory): the DAG is built, submitted and waited for; the history
    is the AM's in-memory logging service, the journal the recovery
    journal's lines."""
    sess = run_session(api, [desc], conf, timeout)
    (run,) = sess.runs
    path = os.path.join(conf["tez.staging-dir"], sess.app_id, "recovery",
                        "1", "journal.jsonl")
    if os.path.exists(path):
        with open(path) as fh:
            run.journal = [line.rstrip("\n") for line in fh if line.strip()]
    return run


def write_corpus(path: str, rng, mat, lens, nbytes: int,
                 words_per_line: int = WORDS_PER_LINE,
                 chunk_lines: int = 128, marks=(), prefixes=None
                 ) -> np.ndarray:
    """bench.py's corpus layout (_make_corpus: Zipf(1.3) word ids,
    words_per_line words a line joined by spaces) over the words of (mat,
    lens), drawn chunk_lines lines at a time until the file holds nbytes;
    returns the count of each word (the golden).  For each byte count in
    `marks`, prefixes[mark] becomes (length, counts) of the longest prefix
    of whole lines that fits in it."""
    vocab = len(lens)
    # the vocabulary as one ragged pool, each word followed by a space
    pool_lens = lens + 1
    pool_offs = np.zeros(vocab + 1, np.int64)
    np.cumsum(pool_lens, out=pool_offs[1:])
    pool = np.full(int(pool_offs[-1]), 32, np.uint8)
    keep = np.arange(16)[None, :] < lens[:, None]
    pool[(pool_offs[:-1, None] + np.arange(16)[None, :])[keep]] = mat[keep]
    counts = np.zeros(vocab, np.int64)
    written = 0
    chunk_words = words_per_line * chunk_lines
    with open(path, "wb") as fh:
        while written < nbytes:
            ids = rng.zipf(ZIPF_A, chunk_words).astype(np.int64) % vocab
            counts += np.bincount(ids, minlength=vocab)
            ends = np.cumsum(pool_lens[ids])
            starts = ends - pool_lens[ids]
            total = int(ends[-1])
            rows = np.repeat(pool_offs[ids] - starts, pool_lens[ids])
            text = pool[rows + np.arange(total)]
            text[ends[words_per_line - 1::words_per_line] - 1] = 10
            for mark in marks:
                if prefixes is not None and mark not in prefixes and \
                        written + total >= mark:
                    # the lines of this chunk that end by the mark
                    line_ends = ends[words_per_line - 1::words_per_line]
                    k = int(np.searchsorted(line_ends, mark - written,
                                            side="right"))
                    prefixes[mark] = (
                        written + (int(line_ends[k - 1]) if k else 0),
                        counts - np.bincount(ids[k * words_per_line:],
                                             minlength=vocab))
            fh.write(text.tobytes())
            written += total
    return counts


def part_bytes(out_dir: str) -> bytes:
    """A FileOutput directory's part files, their bytes in name order."""
    return b"".join(
        open(os.path.join(out_dir, f), "rb").read()
        for f in sorted(os.listdir(out_dir)) if f.startswith("part-"))


def part_lines(label: str, out_dir: str) -> list:
    """The lines of a FileOutput directory's part files, _SUCCESS
    required."""
    check(os.path.exists(os.path.join(out_dir, "_SUCCESS")),
          f"{label}: no _SUCCESS in {out_dir}")
    return [line for line in part_bytes(out_dir).split(b"\n") if line]


def word_bytes(mat, lens, ids) -> list:
    """The vocabulary's words `ids` (rows of `mat`, `lens` bytes long)."""
    return [mat[i, :lens[i]].tobytes() for i in ids]


def read_wordcount(out_dir: str) -> tuple:
    """The part files of OrderedWordCount's output: their bytes in name
    order, and the (word, count) rows they hold."""
    data = part_bytes(out_dir)
    rows = [line.rsplit(b"\t", 1) for line in data.split(b"\n") if line]
    return data, [(w, int(c)) for w, c in rows]


def check_wordcount(label: str, out_dir: str, mat, lens,
                    golden: np.ndarray) -> bytes:
    """OrderedWordCount's output against the golden: _SUCCESS written,
    each drawn word's count exact, no other word, counts non-decreasing.
    Returns the part files' bytes."""
    check(os.path.exists(os.path.join(out_dir, "_SUCCESS")),
          f"{label}: no _SUCCESS in {out_dir}")
    data, rows = read_wordcount(out_dir)
    drawn = np.flatnonzero(golden)
    want = dict(zip(word_bytes(mat, lens, drawn), golden[drawn].tolist()))
    got = dict(rows)
    check(len(got) == len(rows), f"{label}: a word appears twice")
    check(got == want, f"{label}: output differs from the golden "
                       f"({len(got)} words against {len(want)})")
    counts = np.array([c for _w, c in rows], np.int64)
    check(bool(np.all(np.diff(counts) >= 0)),
          f"{label}: counts are not non-decreasing")
    return data


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, -math.inf
    for lo, hi in sorted(intervals):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total


#: the DAG counters bench.py reports
BENCH_COUNTERS = ("SHUFFLE_BYTES", "SPILLED_RECORDS", "OUTPUT_RECORDS",
                  "REDUCE_INPUT_RECORDS")


def bench_counters(counters: dict) -> dict:
    out = dict.fromkeys(BENCH_COUNTERS, 0)
    for group in counters.values():
        for name in BENCH_COUNTERS:
            out[name] += group.get(name, 0)
    return out


class DagCorpus:
    """Phase 11's corpus in a directory: its path and size, the
    vocabulary it was drawn from and each word's count (the golden)."""

    def __init__(self, root: str, args, marks_mb=(), **sizes):
        sz = dict(DAG_SIZES, **sizes)
        rng = np.random.default_rng(args.seed + 11)
        t0 = time.perf_counter()
        self.root = root
        self.mat, self.lens = bulk_word_vocab(rng, sz["vocab_size"])
        self.path = os.path.join(root, "corpus.txt")
        #: byte count -> (prefix length, each word's count in the prefix)
        self.prefixes: dict = {}
        self.golden = write_corpus(
            self.path, rng, self.mat, self.lens,
            int(sz["corpus_mb"] * (1 << 20)),
            chunk_lines=sz.get("chunk_lines", 128),
            marks=[int(mb * (1 << 20)) for mb in marks_mb],
            prefixes=self.prefixes)
        self.nbytes = os.path.getsize(self.path)
        log(f"dag: corpus {self.nbytes} bytes, {int(self.golden.sum())} "
            f"words, {int(np.count_nonzero(self.golden))} distinct, made in "
            f"{time.perf_counter() - t0:.3f} s")

    def slice_file(self, name: str, lo_mb: float, hi_mb: float) -> tuple:
        """The corpus's whole lines between its prefixes of lo_mb and hi_mb
        MiB (marks given at construction; lo_mb 0 is the start) as a file
        of its own: (path, its size, each word's count in it)."""
        hi, hi_counts = self.prefixes[int(hi_mb * (1 << 20))]
        lo, lo_counts = (0, 0) if not lo_mb else \
            self.prefixes[int(lo_mb * (1 << 20))]
        path = os.path.join(self.root, name)
        with open(self.path, "rb") as src, open(path, "wb") as dst:
            src.seek(lo)
            left = hi - lo
            while left:
                buf = src.read(min(64 << 20, left))
                dst.write(buf)
                left -= len(buf)
        return path, hi - lo, hi_counts - lo_counts


def check_no_failover(label: str, counters: dict) -> None:
    from tez_tpu_torch.ops.async_stage import COUNTER_GROUP
    moved = {k: v for k, v in counters.get(COUNTER_GROUP, {}).items() if v}
    check(not moved, f"{label}: DeviceFailover counters moved {moved}")


def report_dag(label: str, run: DagRun, nbytes: int) -> dict:
    """Print a DAG leg's wall and rate, its vertices' spans and the AM's
    share; returns bench.py's counters of the run."""
    spans = run.vertex_spans()
    in_vertices = union_length(spans.values())
    log(f"phase {label}: wall_s={run.wall:.3f} "
        f"MB={nbytes / 1e6:.1f} "
        f"MB_per_s={nbytes / 1e6 / run.wall:.1f}")
    log(f"{label}: vertex walls s "
        f"{json.dumps({v: round(hi - lo, 3) for v, (lo, hi) in spans.items()})}; "
        f"AM share s {run.wall - in_vertices:.3f} (the DAG wall "
        f"less the union of the vertices' spans)")
    return bench_counters(run.counters)


def dag_phase(args, device="cuda", corpus=None, legs_out=None,
              **sizes) -> dict:
    """Phase 11 over `corpus` (made here, in a directory of its own, when
    None); returns the kernel launches of its legs, and fills legs_out
    with each leg's part file, wall and counters."""
    if corpus is None:
        with tempfile.TemporaryDirectory(prefix="tez_dag_") as root:
            return dag_phase(args, device, DagCorpus(root, args, **sizes),
                             legs_out, **sizes)
    import torch
    from tez_tpu_torch.ops import async_stage
    from tez_tpu_torch.ops.async_stage import process_breaker
    sz = dict(DAG_SIZES, **sizes)
    api = dag_api(device=device)
    totals: collections.Counter = collections.Counter()
    parts = {}
    async_stage.reset_process_breaker()
    root, nbytes = corpus.root, corpus.nbytes
    mat, lens, golden = corpus.mat, corpus.lens, corpus.golden
    for leg, shape in DAG_LEGS.items():
        label = f"dag {leg}"
        out_dir = os.path.join(root, f"out_{leg}")
        conf = dict(DAG_CONF, **sz["conf"], **{
            "tez.staging-dir": os.path.join(root, f"staging_{leg}")})
        desc = wordcount_description([corpus.path], out_dir,
                                     **DAG_SHAPE, **shape)
        if is_cuda(device):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with Launches(label, totals) as launches:
            run = run_dag(api, desc, conf)
            sync(device)
        check(run.state == "SUCCEEDED", f"{label}: state {run.state}")
        parts[leg] = check_wordcount(label, out_dir, mat, lens, golden)
        check_no_failover(label, run.counters)
        br = process_breaker()
        check(br.state == "closed" and br.trips == 0,
              f"{label}: breaker {br.state}, {br.trips} trips")
        peak = torch.cuda.max_memory_allocated() / 2**30 \
            if is_cuda(device) else float("nan")
        disk = {k: sum(g.get(k, 0) for g in run.counters.values())
                for k in ("FILE_BYTES_WRITTEN", "FILE_BYTES_READ",
                          "ADDITIONAL_SPILLS_BYTES_WRITTEN",
                          "ADDITIONAL_SPILLS_BYTES_READ")}
        counters = report_dag(label, run, nbytes)
        log(f"{label}: counters {json.dumps(counters)}; "
            f"disk bytes {json.dumps(disk)}; peak device memory "
            f"{peak:.3f} GiB")
        if legs_out is not None:
            legs_out[leg] = {"part": parts[leg], "wall": run.wall,
                             "counters": counters}
        launches.require(device, "fnv_hash_lanes", "merge_path_pair")
        # tez_tpu's defaults: the combining tokenizer counts words in
        # the library's aggregator, the other splits in the library
        launches.require_native("tz_wc_feed" if shape["combine"]
                                else "tz_split_ws")
        check(launches.native.get("tz_wc_feed", 0) == 0
              or shape["combine"], f"{label}: the aggregator ran "
                                   f"without the combiner")
    check(parts["A"] == parts["B"], "dag B: part file differs from leg A's")
    log("dag: legs A-B passed")
    return dict(totals)


# ---------------------------------------------------------------------------
# phase 12: the same DAG in runner processes, the shuffle over TCP
# ---------------------------------------------------------------------------
#: runner processes a leg's AM launches (each with a CUDA context of its own)
REMOTE_RUNNERS = 4
#: how long an idle runner waits for a task before it exits (taking the
#: outputs its shuffle server holds with it): longer than a leg
REMOTE_HOLD_MS = 1_200_000
#: the server each leg's runners serve their outputs through
REMOTE_SERVERS = {"A": "ShuffleServer", "B": "NativeShuffleServer"}


def runner_reports(stats_dir: str) -> list:
    """The stats files the runner processes of one leg left (each rewrites
    its own after every task)."""
    return [json.load(open(os.path.join(stats_dir, f)))
            for f in sorted(os.listdir(stats_dir)) if f.endswith(".json")]


def remote_phase(args, corpus: DagCorpus, phase11: dict, device="cuda",
                 **sizes) -> dict:
    """Phase 12's legs over phase 11's corpus; phase11 holds its legs
    (part file, wall, counters).  Returns the kernel launches of the
    runners."""
    import torch
    sz = dict(DAG_SIZES, **sizes)
    api = dag_api(device=device)
    card = torch.cuda.get_device_name(0) if is_cuda(device) else "cpu"
    totals: collections.Counter = collections.Counter()
    root, nbytes = corpus.root, corpus.nbytes
    for leg, shape in DAG_LEGS.items():
        label = f"remote {leg}"
        stats_dir = os.path.join(root, f"runner_stats_{leg}")
        os.makedirs(stats_dir)
        env = {"TEZ_TPU_RUNNER_STATS_DIR": stats_dir, "TEZ_TPU_LOG": "WARNING"}
        native_dir = os.path.join(root, f"native_{leg}")
        if REMOTE_SERVERS[leg] == "NativeShuffleServer":
            env["TEZ_TPU_NATIVE_SHUFFLE_DIR"] = native_dir
        out_dir = os.path.join(root, f"out_remote_{leg}")
        conf = dict(DAG_CONF, **sz["conf"], **{
            "tez.staging-dir": os.path.join(root, f"staging_remote_{leg}"),
            "tez.runner.mode": "subprocess",
            "tez.am.local.num-containers": REMOTE_RUNNERS,
            # a runner holds its outputs: it stays for the DAG's length
            "tez.am.container.idle.release-timeout-min.millis":
                REMOTE_HOLD_MS,
            "tez.am.runner.env": env})
        desc = wordcount_description([corpus.path], out_dir, **DAG_SHAPE,
                                     **shape)
        run = run_dag(api, desc, conf)
        check(run.state == "SUCCEEDED", f"{label}: state {run.state}")
        part = check_wordcount(label, out_dir, corpus.mat, corpus.lens,
                               corpus.golden)
        check(part == phase11[leg]["part"],
              f"{label}: part file differs from phase 11's")
        check_no_failover(label, run.counters)
        counters = report_dag(label, run, nbytes)
        before = phase11[leg]["counters"]
        check(counters["OUTPUT_RECORDS"] == before["OUTPUT_RECORDS"],
              f"{label}: OUTPUT_RECORDS {counters['OUTPUT_RECORDS']} against "
              f"phase 11's {before['OUTPUT_RECORDS']}")
        task = run.counters.get("TaskCounter", {})
        remote = task.get("NUM_SHUFFLED_INPUTS", 0) - \
            task.get("LOCAL_SHUFFLED_INPUTS", 0)
        check(remote > 0, f"{label}: no fetch crossed processes")
        check(task.get("NUM_FAILED_SHUFFLE_INPUTS", 0) == 0,
              f"{label}: {task.get('NUM_FAILED_SHUFFLE_INPUTS')} fetches "
              f"failed")
        log(f"{label}: counters {json.dumps(counters)} (phase 11: "
            f"{json.dumps(before)}); inputs fetched across processes "
            f"{remote} of {task.get('NUM_SHUFFLED_INPUTS', 0)}")
        reports = runner_reports(stats_dir)
        check(len(reports) > 0, f"{label}: no runner reported")
        for r in reports:
            check(r["device"] == torch.device(device).type
                  and r["device_name"] == card,
                  f"{label}: runner {r['pid']} on {r['device']} "
                  f"({r['device_name']})")
            check(r["server"] == REMOTE_SERVERS[leg],
                  f"{label}: runner {r['pid']} served through {r['server']}")
        launched = {ev.container_id: ev.timestamp for ev in run.events
                    if ev.event_type.name == "CONTAINER_LAUNCHED"}
        startup = [(round(r["first_get_task_s"] - launched[r["container_id"]],
                          3),
                    round(r["imported_s"] - launched[r["container_id"]], 3),
                    round(r["modules_s"] - r["imported_s"], 3),
                    round(r["warm_s"], 3)) for r in reports]
        served = sum(r["bytes_served"] for r in reports)
        log(f"{label}: {len(reports)} runners ran "
            f"{sum(r['tasks'] for r in reports)} tasks on "
            f"{sorted({r['device_name'] for r in reports})}; start-up s "
            f"(launch to first get_task; of which to the runner module's "
            f"import, the port's modules and torch, the host library, "
            f"CUDA context and kernels) {startup}; bytes served "
            f"across processes {served} "
            f"({served / 1e6 / run.wall:.1f} MB/s of the DAG wall)")
        log(f"{label}: wall_s={run.wall:.3f} beside phase 11's "
            f"{phase11[leg]['wall']:.3f}")
        launches = collections.Counter()
        native: collections.Counter = collections.Counter()
        for r in reports:
            launches.update(r["launches"])
            native.update(r["native"])
        log(f"launches {label}: {json.dumps(dict(launches))} host library "
            f"{json.dumps(dict(native))} (summed over the runners)")
        if is_cuda(device):
            for kname in ("fnv_hash_lanes", "merge_path_pair"):
                check(launches[kname] > 0,
                      f"{label}: no runner launched {kname}")
            check(launches["merge_rank"] == 0,
                  f"{label}: a runner launched merge_rank")
        want = "tz_wc_feed" if shape["combine"] else "tz_split_ws"
        check(native[want] > 0, f"{label}: no runner called {want}")
        totals.update(launches)
        NATIVE_TOTALS.update(native)
        shutil.rmtree(native_dir, ignore_errors=True)
    log("remote: legs A-B passed")
    return dict(totals)


# ---------------------------------------------------------------------------
# phase 13: the unordered edge (WordCount, SimpleSession)
# ---------------------------------------------------------------------------
#: phase 13's legs over prefixes of phase 11's corpus (MiB): A the
#: example's defaults over the first a_mb, B per-spill events (final merge
#: off, a b_buffer_mb output buffer) over the first b_mb, C three c_mb
#: slices in one pre-warmed session (A and B cut from 64 and 32 MiB to
#: keep the script within its time limit: ~6 us a word of per-record
#: Python, and B still ships several spills a tokenizer)
UNORDERED_SIZES = dict(a_mb=16, b_mb=16, c_mb=8, b_buffer_mb=8)
TINY_UNORDERED = dict(a_mb=0.5, b_mb=1, c_mb=0.25, b_buffer_mb=1,
                      corpus_mb=2, vocab_size=20_000, chunk_lines=4)
#: WordCount's summation parallelism (the example's default)
WC_PARTITIONS = 2


def submit_dag(dag, conf: dict, device) -> tuple:
    """One DAG through the port's TezClient: (final status, wall s from
    submit to completion)."""
    from tez_tpu_torch.client.tez_client import TezClient
    with TezClient.create(dag.name, conf, device=device) as client:
        t0 = time.perf_counter()
        status = client.submit_dag(dag).wait_for_completion(timeout=3600)
        return status, time.perf_counter() - t0


def corpus_sizes(sz: dict) -> dict:
    return {k: sz[k] for k in ("corpus_mb", "vocab_size", "chunk_lines")
            if k in sz}


def check_wordcount_parts(label: str, out_dir: str, corpus, golden,
                          partitions: int = WC_PARTITIONS) -> int:
    """WordCount's part files against the golden: _SUCCESS written, part p
    holding exactly the drawn words whose FNV partition is p, each with its
    count.  Returns the rows."""
    check(os.path.exists(os.path.join(out_dir, "_SUCCESS")),
          f"{label}: no _SUCCESS in {out_dir}")
    part_of = (fnv_np(corpus.mat, corpus.lens) % partitions).astype(np.int64)
    names = sorted(f for f in os.listdir(out_dir) if f.startswith("part-"))
    check(len(names) == partitions, f"{label}: part files {names}")
    rows = 0
    for name in names:
        p = int(name.split("-")[1])
        got, n = {}, 0
        with open(os.path.join(out_dir, name), "rb") as fh:
            for line in fh.read().split(b"\n"):
                if line:
                    w, c = line.rsplit(b"\t", 1)
                    got[w] = int(c)
                    n += 1
        check(n == len(got), f"{label}: a word appears twice in {name}")
        sel = np.flatnonzero((golden > 0) & (part_of == p))
        want = dict(zip(word_bytes(corpus.mat, corpus.lens, sel),
                        golden[sel].tolist()))
        check(got == want, f"{label}: {name} differs from its partition's "
                           f"golden ({len(got)} words against {len(want)})")
        rows += n
    return rows


def session_runners(staging: str) -> tuple:
    """From a session's recovery journal: (DAGs finished, runners
    launched, runners that ran attempts of more than one DAG)."""
    events = read_journal(staging)
    kinds = collections.Counter(ev.event_type.name for ev in events)
    dags = collections.defaultdict(set)
    for ev in events:
        if ev.event_type.name == "TASK_ATTEMPT_STARTED":
            dags[ev.container_id].add(ev.dag_id)
    return (kinds["DAG_FINISHED"], kinds["CONTAINER_LAUNCHED"],
            sum(len(d) > 1 for d in dags.values()))


def unordered_phase(args, device="cuda", corpus=None, **sizes) -> dict:
    """Phase 13 over prefixes of `corpus` (phase 11's; made here when
    None).  Returns {"launches": ..., "legs": {leg: wall s}}."""
    sz = dict(UNORDERED_SIZES, **sizes)
    if corpus is None:
        marks = (sz["a_mb"], sz["b_mb"], sz["c_mb"], 2 * sz["c_mb"],
                 3 * sz["c_mb"])
        with tempfile.TemporaryDirectory(prefix="tez_unordered_") as root:
            return unordered_phase(args, device, DagCorpus(
                root, args, marks_mb=marks, **dict(
                    {"corpus_mb": max(marks)}, **corpus_sizes(sz))),
                **sizes)
    from tez_tpu_torch.examples import simple_session, wordcount
    from tez_tpu_torch.ops import async_stage
    from tez_tpu_torch.ops.async_stage import process_breaker
    totals: collections.Counter = collections.Counter()
    root = corpus.root
    async_stage.reset_process_breaker()
    legs = {}

    # A: the example's defaults through its run()
    path, nbytes, golden = corpus.slice_file("wc_a.txt", 0, sz["a_mb"])
    out = os.path.join(root, "wc_out_A")
    with Launches("unordered A", totals) as launches:
        t0 = time.perf_counter()
        state = wordcount.run([path], out, conf={
            "tez.staging-dir": os.path.join(root, "wc_stg_A")},
            device=device)
        legs["A"] = time.perf_counter() - t0
        sync(device)
    check(state == "SUCCEEDED", f"unordered A: state {state}")
    rows = check_wordcount_parts("unordered A", out, corpus, golden)
    launches.require(device, "fnv_hash_bytes")
    log(f"phase unordered A: wall_s={legs['A']:.3f} MB={nbytes / 1e6:.1f} "
        f"words={int(golden.sum())} rows={rows} "
        f"words_per_s={golden.sum() / legs['A']:.0f}")

    # B: no final merge, a small buffer: each tokenizer ships its spills
    path, nbytes, golden = corpus.slice_file("wc_b.txt", 0, sz["b_mb"])
    out = os.path.join(root, "wc_out_B")
    dag = wordcount.build_dag([path], out)
    for v in dag.vertices.values():
        v.set_conf("tez.runtime.enable.final-merge.in.output", False)
        v.set_conf("tez.runtime.unordered.output.buffer.size-mb",
                   sz["b_buffer_mb"])
    with Launches("unordered B", totals) as launches:
        status, legs["B"] = submit_dag(dag, {
            "tez.staging-dir": os.path.join(root, "wc_stg_B")}, device)
        sync(device)
    check(status.state.name == "SUCCEEDED",
          f"unordered B: state {status.state.name}")
    rows = check_wordcount_parts("unordered B", out, corpus, golden)
    counters = status.counters.to_dict()
    check_no_failover("unordered B", counters)
    fetched = counters.get("TaskCounter", {}).get("NUM_SHUFFLED_INPUTS", 0)
    check(fetched > WC_PARTITIONS, f"unordered B: {fetched} inputs fetched, "
                                   f"no tokenizer shipped several spills")
    launches.require(device, "fnv_hash_bytes")
    log(f"phase unordered B: wall_s={legs['B']:.3f} MB={nbytes / 1e6:.1f} "
        f"words={int(golden.sum())} rows={rows} inputs fetched {fetched} "
        f"(per-spill events)")

    # C: three slices, one pre-warmed session
    slices = [corpus.slice_file(f"wc_c{i}.txt", i * sz["c_mb"],
                                (i + 1) * sz["c_mb"]) for i in range(3)]
    out = os.path.join(root, "wc_out_C")
    staging = os.path.join(root, "wc_stg_C")
    with Launches("unordered C", totals) as launches:
        t0 = time.perf_counter()
        # the session's runners stay for its three DAGs, as phase 12's
        # do for one: reuse must not ride on the 5 s idle release
        state = simple_session.run(
            [p for p, _n, _g in slices], out,
            conf={"tez.staging-dir": staging,
                  "tez.am.container.idle.release-timeout-min.millis":
                      REMOTE_HOLD_MS},
            device=device)
        legs["C"] = time.perf_counter() - t0
        sync(device)
    check(state == "SUCCEEDED", f"unordered C: state {state}")
    for i, (_p, _n, golden) in enumerate(slices):
        check_wordcount_parts(f"unordered C dag{i}",
                              os.path.join(out, f"dag{i}"), corpus, golden)
    finished, launched, reused = session_runners(staging)
    check(finished == 3, f"unordered C: {finished} DAGs in the journal")
    check(reused > 0, f"unordered C: no runner ran tasks of two DAGs "
                      f"({launched} launched)")
    launches.require(device, "fnv_hash_bytes")
    br = process_breaker()
    check(br.state == "closed" and br.trips == 0,
          f"unordered: breaker {br.state}, {br.trips} trips")
    log(f"phase unordered C: wall_s={legs['C']:.3f} for 3 DAGs of "
        f"{sum(n for _p, n, _g in slices) / 1e6:.1f} MB; runners launched "
        f"{launched}, {reused} of them ran tasks of more than one DAG")
    log("unordered: legs A-C passed")
    return {"launches": dict(totals), "legs": legs}


# ---------------------------------------------------------------------------
# phase 14: MRR over TeraSort-width records
# ---------------------------------------------------------------------------
#: phase 14: 128 MiB of 100-byte lines (10-byte key, TAB, 88-byte value,
#: newline), keys Zipf(1.3) over a seeded vocabulary of 2^20; at this size
#: the reduce merges take the card (64 MiB stays under its floor)
MRR_SIZES = dict(mrr_mb=128, key_vocab=1 << 20)
TINY_MRR = dict(mrr_mb=1, key_vocab=1 << 12)
MRR_KEY, MRR_VALUE = 10, 88


def mrr_corpus(path: str, rng, nbytes: int, key_vocab: int) -> dict:
    """TeraSort-width lines into `path`: printable keys drawn Zipf(1.3)
    from a seeded vocabulary, printable values.  Returns the golden, each
    distinct key's total value length."""
    n = nbytes // (MRR_KEY + MRR_VALUE + 2)
    vocab = rng.integers(33, 127, (key_vocab, MRR_KEY), dtype=np.uint8)
    ids = rng.zipf(ZIPF_A, n).astype(np.int64) % key_vocab
    lines = np.empty((n, MRR_KEY + MRR_VALUE + 2), np.uint8)
    lines[:, :MRR_KEY] = vocab[ids]
    lines[:, MRR_KEY] = 9
    lines[:, MRR_KEY + 1:-1] = rng.integers(33, 127, (n, MRR_VALUE),
                                            dtype=np.uint8)
    lines[:, -1] = 10
    with open(path, "wb") as fh:
        fh.write(lines.tobytes())
    keys, counts = np.unique(
        np.ascontiguousarray(vocab[ids]).view(
            np.dtype((np.void, MRR_KEY))).ravel(), return_counts=True)
    return {k.tobytes(): int(c) * MRR_VALUE for k, c in zip(keys, counts)}


def mrr_phase(args, device="cuda", **sizes) -> dict:
    """Phase 14: examples/mrr.py run() with its defaults (maps from the
    splits, r1 2, r2 1).  Returns {"launches": ..., "records": lines}."""
    from tez_tpu_torch.examples import mrr
    sz = dict(MRR_SIZES, **sizes)
    totals: collections.Counter = collections.Counter()
    with tempfile.TemporaryDirectory(prefix="tez_mrr_") as root:
        rng = np.random.default_rng(args.seed + 14)
        path = os.path.join(root, "mrr.txt")
        t0 = time.perf_counter()
        golden = mrr_corpus(path, rng, int(sz["mrr_mb"] * (1 << 20)),
                            sz["key_vocab"])
        records = os.path.getsize(path) // (MRR_KEY + MRR_VALUE + 2)
        log(f"mrr: {records} lines, {len(golden)} distinct keys, made in "
            f"{time.perf_counter() - t0:.3f} s")
        out = os.path.join(root, "out")
        with Launches("mrr", totals) as launches:
            t0 = time.perf_counter()
            state = mrr.run([path], out, conf={
                "tez.staging-dir": os.path.join(root, "stg")}, device=device)
            wall = time.perf_counter() - t0
            sync(device)
        check(state == "SUCCEEDED", f"mrr: state {state}")
        rows = [line.split(b"\t") for line in part_lines("mrr", out)]
        totals_out = np.array([int(t) for _k, t in rows], np.int64)
        check(bool(np.all(np.diff(totals_out) >= 0)),
              "mrr: totals are not non-decreasing")
        got = {k: int(t) for k, t in rows}
        check(len(got) == len(rows), "mrr: a key appears twice")
        check(got == golden, f"mrr: output differs from the golden "
                             f"({len(got)} keys against {len(golden)})")
        launches.require(device, "fnv_hash_lanes", "merge_path_pair")
        log(f"phase mrr: wall_s={wall:.3f} MB={records * 100 / 1e6:.1f} "
            f"records={records} keys={len(golden)}; launches "
            f"merge_path_pair {launches.counts['merge_path_pair']} "
            f"fnv_hash_lanes {launches.counts['fnv_hash_lanes']}")
    return {"launches": dict(totals), "records": records}


# ---------------------------------------------------------------------------
# phase 15: the mesh exchange
# ---------------------------------------------------------------------------
#: phase 15: (a) the exchange step alone, rows x lanes x value words, each
#: engine and routing timed over `iters` calls; (b) OrderedWordCount with
#: exchange="mesh" against the host exchange, no combine, over the first
#: mesh_mb of phase 11's corpus
MESH_SIZES = dict(rows=1 << 22, lanes=4, value_words=2, iters=5,
                  mesh_mb=256, conf={})
TINY_MESH = dict(rows=1 << 12, lanes=4, value_words=2, iters=1, mesh_mb=2,
                 corpus_mb=2, vocab_size=20_000, chunk_lines=4,
                 conf={"tez.runtime.io.sort.mb": 4,
                       "tez.runtime.tpu.mesh.max-rows-per-round": 1 << 16})


def exchange_inputs(rng, n: int, num_lanes: int, value_words: int) -> tuple:
    """Random rows: canonical big-endian lanes (bytes past each key's
    1..4L length zero), values, 95% valid, explicit destination 0."""
    lengths = rng.integers(1, 4 * num_lanes + 1, n).astype(np.uint32)
    mat = rng.integers(0, 256, (n, 4 * num_lanes), dtype=np.uint8)
    mat[np.arange(4 * num_lanes)[None, :] >= lengths[:, None]] = 0
    lanes = be_lanes(mat)
    values = rng.integers(0, 1 << 32, (n, value_words),
                          dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) < 0.95
    return lanes, lengths, values, valid


def exchange_alone(sz: dict, device, rng) -> dict:
    """Phase 15(a): build_distributed_shuffle over the device's own mesh
    (one card: one worker), both engines, hashed and explicit routes, each
    held bit for bit against the same step on CPU workers (the plain
    versions); ms per call on the card.  Its fnv_hash_lanes launches are
    checks, kept out of the main path's counts."""
    import torch
    from tez_tpu_torch.ops import kernels
    from tez_tpu_torch.parallel import exchange, mesh
    dev = torch.device(device)
    card = mesh.make_mesh(device_type=dev.type)
    workers = len(card)
    n = sz["rows"] - sz["rows"] % workers
    lanes, lengths, values, valid = exchange_inputs(
        rng, n, sz["lanes"], sz["value_words"])
    dests = (np.arange(n) % workers).astype(np.uint32)
    host_in = (lanes, lengths, values, valid, dests)
    dev_in = tuple(torch.from_numpy(
        a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)
        for a in host_in[:4]) + (torch.from_numpy(
            dests.astype(np.int64)).to(dev),)
    plain = mesh.make_mesh(devices=["cpu"] * workers)
    timings = {}
    kernels.reset_launches()
    for ragged in (False, True):
        for explicit in (False, True):
            name = f"{'ragged' if ragged else 'padded'}/" \
                   f"{'explicit' if explicit else 'hashed'}"
            build = (sz["lanes"], n // workers, n // workers)
            kw = dict(value_words=sz["value_words"], ragged=ragged,
                      explicit_dests=explicit)
            k = 5 if explicit else 4
            fn = exchange.build_distributed_shuffle(card, *build, **kw)
            got = [o.host() for o in fn(*dev_in[:k])]
            want = [o.host() for o in exchange.build_distributed_shuffle(
                plain, *build, **kw)(*host_in[:k])]
            for part, a, b in zip(("lanes", "lengths", "values", "valid",
                                   "dropped"), got, want):
                check(np.array_equal(a, b), f"mesh (a) {name}: {part} "
                                            f"differs from the plain step")
            check(int(got[4].sum()) == 0, f"mesh (a) {name}: rows dropped")
            check(int(got[3].sum()) == int(valid.sum()),
                  f"mesh (a) {name}: valid rows lost")
            if is_cuda(device):
                timings[name] = cuda_ms(lambda: fn(*dev_in[:k]), sz["iters"])
            else:
                t0 = time.perf_counter()
                fn(*dev_in[:k])
                timings[name] = (time.perf_counter() - t0) * 1000
    hashed = kernels.launches["fnv_hash_lanes"]
    if is_cuda(device):
        check(hashed > 0, "mesh (a): the hashed step launched no "
                          "fnv_hash_lanes")
    log(f"phase mesh (a): {n} rows x {sz['lanes']} lanes x "
        f"{sz['value_words']} value words on {workers} worker(s) of "
        f"{dev.type}, each bit-identical to the plain step on the CPU; ms "
        f"per call {json.dumps({k: round(v, 4) for k, v in timings.items()})}"
        f"; fnv_hash_lanes launches in the checks {hashed} (not counted "
        f"on the main path)")
    return timings


def mesh_phase(args, device="cuda", corpus=None, **sizes) -> dict:
    """Phase 15 (module docstring).  Returns {"launches": ..., "rounds":
    rounds of the mesh leg, "rows": rows it exchanged, "ms": (a)'s ms}."""
    sz = dict(MESH_SIZES, **sizes)
    if corpus is None:
        with tempfile.TemporaryDirectory(prefix="tez_mesh_") as root:
            return mesh_phase(args, device, DagCorpus(
                root, args, marks_mb=(sz["mesh_mb"],), **dict(
                    {"corpus_mb": sz["mesh_mb"]}, **corpus_sizes(sz))),
                **sizes)
    import torch
    from tez_tpu_torch.common.counters import MESH_EXCHANGE_GROUP
    from tez_tpu_torch.examples import ordered_wordcount
    from tez_tpu_torch.parallel.coordinator import mesh_coordinator
    ms = exchange_alone(sz, device, np.random.default_rng(args.seed + 15))
    totals: collections.Counter = collections.Counter()
    root = corpus.root
    path, nbytes, golden = corpus.slice_file("owc_mesh.txt", 0,
                                             sz["mesh_mb"])
    parts, out = {}, {}
    for leg in ("host", "mesh"):
        label = f"mesh (b) {leg}"
        out_dir = os.path.join(root, f"owc_out_{leg}")
        dag = ordered_wordcount.build_dag(
            [path], out_dir, **dict(DAG_SHAPE, combine=False, exchange=leg))
        conf = dict(DAG_CONF, **sz["conf"], **{
            "tez.staging-dir": os.path.join(root, f"owc_stg_{leg}")})
        coord = mesh_coordinator()
        before = (dict(coord.seconds), coord.rows_exchanged)
        if is_cuda(device):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with Launches(label, totals) as launches:
            status, wall = submit_dag(dag, conf, device)
            sync(device)
        check(status.state.name == "SUCCEEDED",
              f"{label}: state {status.state.name}")
        parts[leg] = check_wordcount(label, out_dir, corpus.mat, corpus.lens,
                                     golden)
        counters = status.counters.to_dict()
        check_no_failover(label, counters)
        launches.require(device, "fnv_hash_lanes")
        peak = torch.cuda.max_memory_allocated() / 2**30 \
            if is_cuda(device) else float("nan")
        log(f"phase {label}: wall_s={wall:.3f} MB={nbytes / 1e6:.1f} "
            f"MB_per_s={nbytes / 1e6 / wall:.1f} peak device memory "
            f"{peak:.3f} GiB")
        if leg == "mesh":
            group = counters.get(MESH_EXCHANGE_GROUP, {})
            split = {k: round(coord.seconds[k] - before[0].get(k, 0.0), 3)
                     for k in ("plan", "step", "readback", "assemble")}
            out = {"rounds": group.get("exchange.rounds", 0),
                   "rows": coord.rows_exchanged - before[1]}
            check(out["rows"] == int(golden.sum()),
                  f"{label}: {out['rows']} rows exchanged against "
                  f"{int(golden.sum())} words")
            log(f"{label}: rounds {out['rounds']}, rows exchanged "
                f"{out['rows']}, engine {coord.last_engine}, _execute s "
                f"{json.dumps(split)} (host planning, device step, "
                f"readback, assembly); counters {json.dumps(group)}")
    check(parts["host"] == parts["mesh"],
          "mesh (b): the mesh part file differs from the host exchange's")
    log("mesh: (a) and (b) passed")
    return dict(out, launches=dict(totals), ms=ms, host_part=parts["host"])


# ---------------------------------------------------------------------------
# phase 16: the tiered buffer store and push shuffle
# ---------------------------------------------------------------------------
#: phase 16's input: phase 15(b)'s prefix of phase 11's corpus
STORE_SIZES = dict(store_mb=MESH_SIZES["mesh_mb"], conf={},
                   host_mb=256, pressure_mb=64)
#: a size the plain versions run in seconds (TINY_MESH's corpus): each
#: tokenizer's ~1.9 MB spill fits under the push admission of a 2.5 MB
#: host tier and demotes it; every span takes the device engine, so runs
#: keep their lanes as they do at full size
TINY_STORE = dict(store_mb=TINY_MESH["mesh_mb"],
                  conf={"tez.runtime.io.sort.mb": 4,
                        "tez.runtime.tpu.device.sort.min.records": 0},
                  host_mb=2.5, pressure_mb=1)
#: leg B's and C's store and push knobs beside the 256 MB host tier.  A
#: tokenizer's one spill of this input is ~243 MB; at tez_tpu's default
#: admission watermark (0.85 of the tier) it would always be refused, and
#: since that watermark sits below the demotion watermark (0.9) admitted
#: pushes alone never demote.  So admission may fill 0.95 of the tier and
#: demotion starts at half of it.
STORE_PUSH_CONF = {"tez.runtime.store.enabled": True,
                   "tez.runtime.shuffle.push.enabled": True,
                   "tez.runtime.shuffle.push.admit-watermark": 0.95,
                   "tez.runtime.store.watermark.high": 0.5,
                   "tez.runtime.store.watermark.low": 0.25}
#: the DAG counters phase 16 prints for each leg
STORE_TASK_COUNTERS = ("SHUFFLE_PUSH_BYTES", "SHUFFLE_PUSH_REJECTED",
                       "SHUFFLE_CHUNK_COUNT", "NUM_MEM_TO_DISK_MERGES",
                       "NUM_DISK_TO_DISK_MERGES", "MERGED_MAP_OUTPUTS",
                       "NUM_SHUFFLED_INPUTS", "LOCAL_SHUFFLED_INPUTS")
#: the store counters phase 16 prints for each leg
STORE_COUNTERS = ("store.published", "store.hits", "store.misses",
                  "store.lineage.sealed", "store.lineage.hits",
                  "store.lineage.misses", "store.demotions.device_to_host",
                  "store.demotions.host_to_disk")


def store_counters(counters: dict) -> dict:
    return {k: counters.get(k, 0) for k in STORE_COUNTERS}


def task_counters(run: DagRun) -> dict:
    task = run.counters.get("TaskCounter", {})
    return {k: task.get(k, 0) for k in STORE_TASK_COUNTERS}


def pressure_check(store, sz: dict, device) -> None:
    """A run whose lanes live on the card, published into the process
    store and relieved through the out-of-memory ladder's hook
    (async_stage.relieve_pressure): the store drops its references before
    the hook returns, so the lanes' bytes are gone from
    torch.cuda.memory_allocated before a retry could allocate."""
    import torch
    from tez_tpu_torch.ops import async_stage
    from tez_tpu_torch.ops.runformat import KVBatch, Run
    if not is_cuda(device):
        return
    n = int(sz["pressure_mb"] * (1 << 20)) // 20     # 4 lanes + a length
    batch = KVBatch(np.zeros(n, np.uint8), np.arange(n + 1, dtype=np.int64),
                    np.zeros(0, np.uint8), np.zeros(n + 1, np.int64))
    batch.dev_keys = (torch.zeros((n, 4), dtype=torch.int32, device=device),
                      torch.zeros(n, dtype=torch.int32, device=device), 0, n)
    lanes = batch.dev_keys[0].nbytes + batch.dev_keys[1].nbytes
    store.publish("phase16/pressure", -1,
                  Run(batch, np.array([0, n], np.int64)))
    del batch
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    held = store.tier_bytes("device")
    freed = async_stage.relieve_pressure(held)
    after = torch.cuda.memory_allocated()
    log(f"store A: the ladder's hook freed {freed} lane bytes of {held} "
        f"held; memory_allocated {before} -> {after} "
        f"({before - after} bytes back, {lanes} of them the test run's)")
    check(freed == held and store.tier_bytes("device") == 0,
          f"store A: the hook freed {freed} of {held} device bytes")
    check(before - after >= lanes,
          f"store A: memory_allocated fell by {before - after} bytes, not "
          f"the {lanes} bytes of lanes the store let go")
    store.unregister_prefix("phase16/")


def store_phase(args, corpus: DagCorpus, host_part: bytes, device="cuda",
                **sizes) -> dict:
    """Phase 16 (module docstring) over phase 15(b)'s prefix of `corpus`;
    host_part is 15(b)'s host-exchange part file.  Returns the kernel
    launches of its legs."""
    import torch
    from tez_tpu_torch.ops.async_stage import process_breaker
    from tez_tpu_torch.store import local_buffer_store, reset_store
    sz = dict(STORE_SIZES, **sizes)
    api = dag_api(device=device)
    card = torch.cuda.get_device_name(0) if is_cuda(device) else "cpu"
    totals: collections.Counter = collections.Counter()
    root = corpus.root
    path, nbytes, golden = corpus.slice_file("owc_store.txt", 0,
                                             sz["store_mb"])

    def peak_gib() -> float:
        return torch.cuda.max_memory_allocated() / 2**30 \
            if is_cuda(device) else float("nan")

    def start(label: str) -> None:
        reset_store()
        if is_cuda(device):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def check_part(label: str, out_dir: str) -> None:
        part = check_wordcount(label, out_dir, corpus.mat, corpus.lens,
                               golden)
        check(part == host_part,
              f"{label}: part file differs from phase 15(b)'s")

    def report(label: str, run: DagRun, store: dict, peaks: dict,
               launches: dict) -> None:
        log(f"phase {label}: wall_s={run.wall:.3f} MB={nbytes / 1e6:.1f} "
            f"MB_per_s={nbytes / 1e6 / run.wall:.1f}; store "
            f"{json.dumps(store_counters(store))}; peak tier bytes "
            f"{json.dumps(peaks)}; counters "
            f"{json.dumps(task_counters(run))}; peak device memory "
            f"{peak_gib():.3f} GiB; launches {json.dumps(launches)}")

    # -- A: the store and cross-DAG reuse, two DAGs in one session ---------
    label = "store A"
    start(label)
    outs = [os.path.join(root, f"store_out_A{i}") for i in range(2)]
    descs = [wordcount_description([path], out, **DAG_SHAPE, combine=True)
             for out in outs]
    conf = dict(DAG_CONF, **sz["conf"], **{
        "tez.runtime.store.enabled": True,
        "tez.staging-dir": os.path.join(root, "store_staging_A")})
    from tez_tpu_torch.ops import kernels
    marks = []
    with Launches(label, totals) as ln:
        sess = run_session(api, descs, conf,
                           between=lambda: marks.append(
                               dict(kernels.launches)))
        sync(device)
    ln.require(device, "fnv_hash_lanes", "merge_path_pair")
    dag_launches = [marks[0], {k: v - marks[0].get(k, 0)
                               for k, v in marks[1].items()}]
    for i, (run, out) in enumerate(zip(sess.runs, outs)):
        check(run.state == "SUCCEEDED", f"{label}: DAG {i + 1} {run.state}")
        check_part(f"{label} DAG {i + 1}", out)
        check_no_failover(label, run.counters)
        report(f"{label} DAG {i + 1}", run, sess.store_counters[i],
               sess.peaks[i], dag_launches[i])
    c1, c2 = sess.store_counters
    hits = c2["store.lineage.hits"] - c1["store.lineage.hits"]
    reused = sess.runs[1].counters.get("ShuffleStore", {}).get(
        "store.reuse.outputs", 0)
    log(f"{label}: DAG 2 lineage hits {hits}, outputs reused {reused}, "
        f"launches {sum(dag_launches[1].values())} against DAG 1's "
        f"{sum(dag_launches[0].values())}")
    check(c1["store.published"] > 0, f"{label}: DAG 1 published nothing")
    check(sess.peaks[0]["device"] > 0,
          f"{label}: the DEVICE tier held nothing while DAG 1 ran")
    check(hits >= 8, f"{label}: DAG 2 hit sealed lineage {hits} times")
    check(reused >= 8, f"{label}: DAG 2 reused {reused} outputs")
    check(not is_cuda(device) or
          sum(dag_launches[1].values()) < sum(dag_launches[0].values()),
          f"{label}: DAG 2 launched no fewer kernels than DAG 1")
    pressure_check(local_buffer_store(), sz, device)

    # -- B: push into the store through a small host tier -------------------
    label = "store B"
    start(label)
    out = os.path.join(root, "store_out_B")
    conf = dict(DAG_CONF, **sz["conf"], **STORE_PUSH_CONF, **{
        "tez.runtime.store.host.capacity-mb": sz["host_mb"],
        "tez.staging-dir": os.path.join(root, "store_staging_B")})
    desc = wordcount_description([path], out, **DAG_SHAPE, combine=False)
    with Launches(label, totals) as ln:
        sess = run_session(api, [desc], conf)
        sync(device)
    (run,) = sess.runs
    report(label, run, sess.store_counters[0], sess.peaks[0], ln.counts)
    check(run.state == "SUCCEEDED", f"{label}: state {run.state}")
    check_part(label, out)
    check_no_failover(label, run.counters)
    br = process_breaker()
    check(br.state == "closed" and br.trips == 0,
          f"{label}: breaker {br.state}, {br.trips} trips")
    tc, sc = task_counters(run), sess.store_counters[0]
    check(tc["SHUFFLE_PUSH_BYTES"] > 0, f"{label}: nothing was pushed")
    check(sc["store.demotions.host_to_disk"] > 0,
          f"{label}: the host tier never demoted to disk")
    ln.require(device, "fnv_hash_lanes", "merge_path_pair")

    # -- C: B in runner processes, each with its own process store ----------
    label = "store C"
    start(label)
    stats_dir = os.path.join(root, "store_runner_stats")
    os.makedirs(stats_dir)
    out = os.path.join(root, "store_out_C")
    conf = dict(DAG_CONF, **sz["conf"], **STORE_PUSH_CONF, **{
        "tez.runtime.store.host.capacity-mb": sz["host_mb"],
        "tez.staging-dir": os.path.join(root, "store_staging_C"),
        "tez.runner.mode": "subprocess",
        "tez.am.local.num-containers": REMOTE_RUNNERS,
        "tez.am.container.idle.release-timeout-min.millis": REMOTE_HOLD_MS,
        "tez.am.runner.env": {"TEZ_TPU_RUNNER_STATS_DIR": stats_dir,
                              "TEZ_TPU_LOG": "WARNING"}})
    desc = wordcount_description([path], out, **DAG_SHAPE, combine=False)
    run = run_dag(api, desc, conf)
    reports = runner_reports(stats_dir)
    launches: collections.Counter = collections.Counter()
    runner_store: collections.Counter = collections.Counter()
    for r in reports:
        launches.update(r["launches"])
        runner_store.update(r["store"])
    peaks = {"runners' peak device bytes": [r.get("peak_device_bytes")
                                            for r in reports]}
    report(label, run, dict(runner_store), peaks, dict(launches))
    check(run.state == "SUCCEEDED", f"{label}: state {run.state}")
    check_part(label, out)
    check_no_failover(label, run.counters)
    tc = task_counters(run)
    remote = tc["NUM_SHUFFLED_INPUTS"] - tc["LOCAL_SHUFFLED_INPUTS"]
    log(f"{label}: inputs fetched across processes {remote} of "
        f"{tc['NUM_SHUFFLED_INPUTS']}; {len(reports)} runners ran "
        f"{sum(r['tasks'] for r in reports)} tasks; bytes pushed into the "
        f"runners' servers {sum(r['bytes_pushed'] for r in reports)}")
    # tez_tpu's OrderedPartitionedKVOutput hands its SpillPusher no
    # job-token secret, and a runner's destination has a port: every push
    # is abandoned to the pull backstop (tests/test_torch_push.py holds
    # both packages' counters equal)
    check(tc["SHUFFLE_PUSH_BYTES"] == 0,
          f"{label}: {tc['SHUFFLE_PUSH_BYTES']} bytes pushed")
    check(tc["SHUFFLE_PUSH_REJECTED"] == tc["SHUFFLE_CHUNK_COUNT"] > 0,
          f"{label}: {tc['SHUFFLE_PUSH_REJECTED']} pushes abandoned of "
          f"{tc['SHUFFLE_CHUNK_COUNT']} spills")
    check(remote > 0, f"{label}: no fetch crossed processes")
    check(len(reports) > 0, f"{label}: no runner reported")
    for r in reports:
        check(r["device"] == torch.device(device).type
              and r["device_name"] == card,
              f"{label}: runner {r['pid']} on {r['device']} "
              f"({r['device_name']})")
    if is_cuda(device):
        for kname in ("fnv_hash_lanes", "merge_path_pair"):
            check(launches[kname] > 0, f"{label}: no runner launched {kname}")
        check(launches["merge_rank"] == 0,
              f"{label}: a runner launched merge_rank")
    totals.update(launches)
    reset_store()
    log("store: legs A-C passed")
    return dict(totals)


# ---------------------------------------------------------------------------
# phase 17: a standalone AM with runner pods, and AM recovery
# ---------------------------------------------------------------------------
#: phase 17's legs over phase 15(b)'s prefix (MiB of phase 11's corpus)
#: hold_ms is how long leg B holds attempt 1's summation attempts in
#: task.run: the crash lands after the tokenizers succeeded and before any
#: summation ran.  The rule is cleared before attempt 2 starts; the held
#: attempt-1 threads (zombies) sleep past attempt 2's end, are fenced on
#: their heartbeats meanwhile, and never run a summation beside it (when
#: they wake, their DAG's outputs are gone and their attempts fail).
STANDALONE_SIZES = dict(sa_mb=MESH_SIZES["mesh_mb"], conf={},
                        hold_ms=600_000)
#: a size the plain versions run in seconds (TINY_MESH's corpus)
TINY_STANDALONE = dict(sa_mb=TINY_MESH["mesh_mb"],
                       conf={"tez.runtime.io.sort.mb": 4}, hold_ms=120_000)
#: runner pods leg A's standalone AM acquires, one per simulated host
STANDALONE_PODS = 2


def __getattr__(name: str):
    """PodBarrierProcessor, built on first use: runner pods resolve it by
    name ("chip_smoke:PodBarrierProcessor"), and the port's processor base
    class is imported only then."""
    if name != "PodBarrierProcessor":
        raise AttributeError(name)
    from tez_tpu_torch.library.processors import SimpleProcessor

    class PodBarrierProcessor(SimpleProcessor):
        """Leg A's warm-up: each task leaves a file named after its
        process in payload["dir"] and waits until payload["parties"] files
        are there.  A runner runs one task at a time, so the warm-up DAG
        (parties tasks) finishes only once that many runners are up, each
        having taken one task."""

        def run(self, inputs, outputs):
            payload = self.context.user_payload.load()
            with open(os.path.join(payload["dir"], str(os.getpid())), "w"):
                pass
            deadline = time.time() + payload["timeout_s"]
            while len(os.listdir(payload["dir"])) < payload["parties"]:
                if time.time() > deadline:
                    raise TimeoutError("not every runner came up")
                time.sleep(0.02)

    PodBarrierProcessor.__module__ = __name__
    globals()[name] = PodBarrierProcessor
    return PodBarrierProcessor


def read_journal(staging: str, attempt: int = 0) -> list:
    """The history events of the recovery journals under staging, in file
    order (attempt 0: every attempt's)."""
    from tez_tpu_torch.am.recovery import decode_journal_line
    events = []
    for dirpath, _dirs, files in sorted(os.walk(staging)):
        if "journal.jsonl" in files and (
                not attempt or os.path.basename(dirpath) == str(attempt)):
            with open(os.path.join(dirpath, "journal.jsonl")) as fh:
                events += [decode_journal_line(line.rstrip("\n"))
                           for line in fh if line.strip()]
    return events


def pod_attempts(staging: str, dag_id) -> collections.Counter:
    """node id -> attempts of the DAG started there, from the journal (a
    DAG's summary records flush every line before them)."""
    return collections.Counter(
        ev.data["node_id"] for ev in read_journal(staging)
        if ev.event_type.name == "TASK_ATTEMPT_STARTED"
        and ev.dag_id == str(dag_id))


def vertex_finished(events) -> dict:
    """vertex name -> final state, from VERTEX_FINISHED records."""
    return {ev.data["vertex_name"]: ev.data["state"] for ev in events
            if ev.event_type.name == "VERTEX_FINISHED"}


def start_standalone_am(root: str, stats_dir: str, device, hold_ms: int):
    """`python -m tez_tpu_torch.am.client_server` with runner pods on
    `device`: (process, client port, job token, seconds to READY)."""
    from tez_tpu_torch.common.security import JobTokenSecretManager
    token = JobTokenSecretManager().secret.hex()
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TEZ_TPU_JOB_TOKEN=token, TEZ_TPU_LOG="WARNING")
    env["PYTHONPATH"] = here + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    runner_env = {"TEZ_TPU_RUNNER_STATS_DIR": stats_dir,
                  "TEZ_TPU_LOG": "WARNING"}
    cmd = [sys.executable, "-m", "tez_tpu_torch.am.client_server",
           "--runner-mode", "pods",
           "--num-containers", str(STANDALONE_PODS),
           "--staging-dir", os.path.join(root, "sa_staging_A"),
           "--device", str(device),
           "--conf", f"tez.am.pod-pool.max-pods={STANDALONE_PODS}",
           # a pod holds its outputs: it stays for the leg's length
           "--conf", "tez.am.container.idle.release-timeout-min.millis="
                     f"{hold_ms}",
           "--conf", f"tez.am.runner.env={json.dumps(runner_env)}"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, text=True)
    line = proc.stdout.readline().strip()
    if not line.startswith("READY "):
        proc.kill()
        proc.wait()
        raise SmokeFailure(f"standalone A: the AM printed {line!r}, not "
                           f"READY (exit code {proc.returncode})")
    return proc, int(line.split()[1]), token, time.perf_counter() - t0


def pods_leg(args, corpus: DagCorpus, host_part: bytes, device, sz: dict,
             path: str, nbytes: int, golden) -> dict:
    """Leg A (module docstring); returns the pods' kernel launches."""
    import torch
    from tez_tpu_torch.client.tez_client import TezClient
    from tez_tpu_torch.common.payload import ProcessorDescriptor
    from tez_tpu_torch.dag.dag import DAG, Vertex
    from tez_tpu_torch.examples import ordered_wordcount
    label = "standalone A"
    root = corpus.root
    card = torch.cuda.get_device_name(0) if is_cuda(device) else "cpu"
    stats_dir = os.path.join(root, "sa_pod_stats")
    barrier_dir = os.path.join(root, "sa_barrier")
    os.makedirs(stats_dir)
    os.makedirs(barrier_dir)
    proc, port, token, up_s = start_standalone_am(root, stats_dir, device,
                                                  REMOTE_HOLD_MS)
    staging = os.path.join(root, "sa_staging_A")
    try:
        # reached only through the remote client, which names no device
        conf = dict(DAG_CONF, **sz["conf"], **{
            "tez.framework.mode": "remote",
            "tez.am.address": f"127.0.0.1:{port}",
            "tez.job.token": token,
            "tez.session.mode": True,
            "tez.client.asynchronous-stop": False})
        client = TezClient.create("standalone", conf)
        client.start()
        try:
            # both pods up before the DAG: pre-warm, then a warm-up DAG of
            # one barrier task a pod
            t0 = time.perf_counter()
            client.pre_warm()
            warm = DAG.create("pod-warm-up").add_vertex(Vertex.create(
                "barrier", ProcessorDescriptor.create(
                    "chip_smoke:PodBarrierProcessor",
                    payload={"dir": barrier_dir,
                             "parties": STANDALONE_PODS,
                             "timeout_s": 600}), STANDALONE_PODS))
            warm_handle = client.submit_dag(warm)
            state = warm_handle.wait_for_completion(timeout=900).state.name
            warm_s = time.perf_counter() - t0
            check(state == "SUCCEEDED", f"{label}: warm-up DAG {state}")
            up = sorted(pod_attempts(staging, warm_handle.dag_id))
            check(up == [f"pod-{i}" for i in range(STANDALONE_PODS)],
                  f"{label}: pods up before the DAG {up}")
            out = os.path.join(root, "sa_out_A")
            dag = ordered_wordcount.build_dag([path], out, **DAG_SHAPE)
            t0 = time.perf_counter()
            handle = client.submit_dag(dag)
            status = handle.wait_for_completion(timeout=3600)
            wall = time.perf_counter() - t0
            check(status.state.name == "SUCCEEDED",
                  f"{label}: state {status.state.name}")
            # a pod rewrites its stats file just after it reports a task
            # done: wait for the last ones before the session ends
            nodes = pod_attempts(staging, handle.dag_id)
            want = STANDALONE_PODS + sum(nodes.values())
            deadline = time.time() + 60
            while sum(r["tasks"] for r in runner_reports(stats_dir)) < want:
                check(time.time() < deadline, f"{label}: the pods reported "
                                              f"fewer than {want} tasks")
                time.sleep(0.05)
        finally:
            # a session client's synchronous stop ends the AM, which stops
            # its pods; a pod whose AM is gone exits on its own
            client.stop()
        rc = proc.wait(timeout=120)
        check(rc == 0, f"{label}: the standalone AM exited with {rc} after "
                       f"client.stop()")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    part = check_wordcount(label, out, corpus.mat, corpus.lens, golden)
    check(part == host_part, f"{label}: part file differs from phase "
                             f"15(b)'s")
    dag_id = str(handle.dag_id)
    (finished,) = [ev for ev in read_journal(staging)
                   if ev.event_type.name == "DAG_FINISHED"
                   and ev.dag_id == dag_id]
    check(finished.data["state"] == "SUCCEEDED",
          f"{label}: journaled {finished.data['state']}")
    counters = finished.data["counters"]
    check_no_failover(label, counters)
    task = counters.get("TaskCounter", {})
    remote = task.get("NUM_SHUFFLED_INPUTS", 0) - \
        task.get("LOCAL_SHUFFLED_INPUTS", 0)
    reports = runner_reports(stats_dir)
    launches: collections.Counter = collections.Counter()
    native: collections.Counter = collections.Counter()
    for r in reports:
        launches.update(r["launches"])
        native.update(r["native"])
    log(f"phase {label}: wall_s={wall:.3f} MB={nbytes / 1e6:.1f} "
        f"MB_per_s={nbytes / 1e6 / wall:.1f}; AM up in "
        f"{up_s:.3f} s, pods up (pre-warm and warm-up DAG) in "
        f"{warm_s:.3f} s; attempts by pod {json.dumps(dict(nodes))}; "
        f"inputs fetched across pods {remote} of "
        f"{task.get('NUM_SHUFFLED_INPUTS', 0)}; pods "
        f"{[(r['node_id'], r['tasks'], r['device_name']) for r in reports]}"
        f"; peak device memory of the pods GiB "
        f"{[round(r.get('peak_device_bytes', 0) / 2**30, 3) for r in reports]}"
        f"; AM exit code {rc}")
    log(f"launches {label}: {json.dumps(dict(launches))} host library "
        f"{json.dumps(dict(native))} (summed over the pods)")
    check(sorted(nodes) == [f"pod-{i}" for i in range(STANDALONE_PODS)],
          f"{label}: the DAG's attempts ran on {dict(nodes)}")
    check(remote > 0, f"{label}: no fetch crossed pods")
    check(task.get("NUM_FAILED_SHUFFLE_INPUTS", 0) == 0,
          f"{label}: {task.get('NUM_FAILED_SHUFFLE_INPUTS')} fetches failed")
    check(len(reports) == STANDALONE_PODS,
          f"{label}: {len(reports)} pods reported")
    for r in reports:
        check(r["device"] == torch.device(device).type
              and r["device_name"] == card,
              f"{label}: pod {r['node_id']} on {r['device']} "
              f"({r['device_name']})")
    if is_cuda(device):
        for kname in ("fnv_hash_lanes", "merge_path_pair"):
            check(launches[kname] > 0, f"{label}: no pod launched {kname}")
        check(launches["merge_rank"] == 0,
              f"{label}: a pod launched merge_rank")
    NATIVE_TOTALS.update(native)
    return dict(launches)


def recovery_leg(args, corpus: DagCorpus, host_part: bytes, device,
                 sz: dict, path: str, nbytes: int, golden) -> dict:
    """Leg B (module docstring); returns the kernel launches of both AM
    attempts."""
    import torch
    from tez_tpu_torch.client.tez_client import TezClient
    from tez_tpu_torch.common import faults
    from tez_tpu_torch.common.ids import DAGId
    from tez_tpu_torch.examples import ordered_wordcount
    label = "standalone B"
    root = corpus.root
    totals: collections.Counter = collections.Counter()
    staging = os.path.join(root, "sa_staging_B")
    out = os.path.join(root, "sa_out_B")
    conf = dict(DAG_CONF, **sz["conf"], **{
        "tez.staging-dir": staging, "tez.am.max.app.attempts": 2})
    dag = ordered_wordcount.build_dag([path], out, **DAG_SHAPE)
    tokenizers = DAG_SHAPE["tokenizer_parallelism"]
    later = DAG_SHAPE["summation_parallelism"] + \
        DAG_SHAPE["sorter_parallelism"]

    def peak_gib() -> float:
        return torch.cuda.max_memory_allocated() / 2**30 \
            if is_cuda(device) else float("nan")

    def fresh_peak() -> None:
        if is_cuda(device):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    client = TezClient.create("recovery", conf, session=True,
                              device=device)
    client.start()
    try:
        am1 = client.framework_client.am
        summation = DAGId(am1.app_id, 1).vertex(1)
        hold = str(summation).replace("vertex", "attempt", 1) + "_"
        faults.install("phase17-window", faults.parse_spec(
            f"task.run:delay:ms={sz['hold_ms']},match={hold}"))
        # every fence of a stale-epoch actor, at any seam, lands in the
        # plane's journal
        faults.install("phase17-fences",
                       faults.parse_spec("fence.stale_epoch:delay:ms=0"))
        fences0 = len(faults.plane().journal)
        try:
            fresh_peak()
            with Launches(f"{label} attempt 1", totals) as ln1:
                t0 = time.perf_counter()
                handle = client.submit_dag(dag)
                live = am1.find_dag(handle.dag_id)
                deadline = time.time() + 3600
                while "tokenizer" not in live.vertices or \
                        live.vertices["tokenizer"].state.name != "SUCCEEDED":
                    check(time.time() < deadline,
                          f"{label}: the tokenizers never succeeded")
                    time.sleep(0.005)
                check(str(live.vertices["summation"].vertex_id) ==
                      str(summation), f"{label}: the window's rule names "
                                      f"{summation}")
                t_crash = time.perf_counter()
                am1.crash()
                wall1 = time.perf_counter() - t0
                crash_s = time.perf_counter() - t_crash
                sync(device)
            peak1 = peak_gib()
        finally:
            # attempt 2's summations must not be held
            faults.clear("phase17-window")
        journal1 = read_journal(staging, attempt=1)
        seen = vertex_finished(journal1)
        check(seen.get("tokenizer") == "SUCCEEDED"
              and "summation" not in seen,
              f"{label}: the crash missed the window (attempt 1 journaled "
              f"{seen})")
        fresh_peak()
        with Launches(f"{label} attempt 2", totals) as ln2:
            t0 = time.perf_counter()
            client.reattach()
            am2 = client.framework_client.am
            check(handle._am is am2 and am2.attempt == 2,
                  f"{label}: the live handle did not re-bind to attempt 2")
            status = handle.wait_for_completion(timeout=3600)
            wall2 = time.perf_counter() - t0
            sync(device)
        peak2 = peak_gib()
        fences = [detail for point, detail, _m in
                  faults.plane().journal[fences0:]
                  if point == "fence.stale_epoch"]
        check(status.state.name == "SUCCEEDED",
              f"{label}: state {status.state.name}")
        events = list(am2.logging_service.events)
        started = collections.Counter(
            ev.data["vertex_name"] for ev in events
            if ev.event_type.name == "TASK_ATTEMPT_STARTED")
        done = collections.Counter(
            ev.data["vertex_name"] for ev in events
            if ev.event_type.name == "TASK_FINISHED"
            and ev.data["state"] == "SUCCEEDED")
        restored = done["tokenizer"] - started["tokenizer"]
        dag_counters = am2.dag_counters.to_dict().get("DAGCounter", {})
        counters = status.counters.to_dict() if status.counters else {}
    finally:
        faults.clear("phase17-window")
        faults.clear("phase17-fences")
        client.stop()
    part = check_wordcount(label, out, corpus.mat, corpus.lens, golden)
    check(part == host_part, f"{label}: part file differs from phase "
                             f"15(b)'s")
    check_no_failover(label, counters)
    log(f"phase {label}: MB={nbytes / 1e6:.1f}; attempt 1 "
        f"wall_s={wall1:.3f} (of which crash() "
        f"{crash_s:.3f} s) launches {json.dumps(ln1.counts)} peak device "
        f"memory {peak1:.3f} GiB; attempt 2 wall_s={wall2:.3f} launches "
        f"{json.dumps(ln2.counts)} peak device memory {peak2:.3f} GiB; "
        f"journal lines replayed {len(journal1)}; zombie attempt-1 actors "
        f"fenced (fence.stale_epoch) {len(set(fences))} in {len(fences)} "
        f"rejections; attempt 2 restored "
        f"{restored} tokenizer tasks, started {dict(started)}, DAG "
        f"counters {json.dumps(dag_counters)}")
    check(restored == tokenizers and started["tokenizer"] == 0,
          f"{label}: attempt 2 restored {restored} of {tokenizers} "
          f"tokenizers and re-ran {started['tokenizer']}")
    check(dag_counters.get("TOTAL_LAUNCHED_TASKS") == later,
          f"{label}: attempt 2 launched "
          f"{dag_counters.get('TOTAL_LAUNCHED_TASKS')} tasks, not the "
          f"{later} summation and sorter tasks")
    check(dag_counters.get("NUM_SUCCEEDED_TASKS") == tokenizers + later,
          f"{label}: attempt 2 counts "
          f"{dag_counters.get('NUM_SUCCEEDED_TASKS')} succeeded tasks")
    ln2.require(device, "merge_path_pair")
    return dict(totals)


def standalone_phase(args, corpus: DagCorpus, host_part: bytes,
                     device="cuda", **sizes) -> dict:
    """Phase 17 (module docstring) over phase 15(b)'s prefix of `corpus`;
    host_part is 15(b)'s host-exchange part file.  Returns the kernel
    launches of its legs."""
    sz = dict(STANDALONE_SIZES, **sizes)
    path, nbytes, golden = corpus.slice_file("owc_standalone.txt", 0,
                                             sz["sa_mb"])
    totals: collections.Counter = collections.Counter()
    totals.update(pods_leg(args, corpus, host_part, device, sz, path,
                           nbytes, golden))
    totals.update(recovery_leg(args, corpus, host_part, device, sz, path,
                               nbytes, golden))
    log("standalone: legs A-B passed")
    return dict(totals)


# ---------------------------------------------------------------------------
# phase 18: the query layer, the joins and the custom edges
# ---------------------------------------------------------------------------
#: phase 18: A SortMergeJoinExample, left the first smj_mb MiB of phase 11's
#: corpus and right the next smj_mb (line-exact); B HashJoinExample over
#: hash_lines stream lines of one Zipf word each against hash_words distinct
#: words; C CORPUS_QUERIES over the corpus at query_scale (TPC-H's row counts
#: at SF query_scale / 1000); D the cartesian product of cp_left x cp_right
#: tokens, and OrderedWordCount with the fair shuffle over fair_mb MiB whose
#: words are half one hot word
QUERY_SIZES = dict(smj_mb=8, hash_lines=1 << 20, hash_words=16_384,
                   query_scale=100, query_seed=3, cp_left=256, cp_right=512,
                   fair_mb=8)
TINY_QUERY = dict(smj_mb=1, hash_lines=1 << 14, hash_words=1024,
                  query_scale=1, cp_left=16, cp_right=32, fair_mb=1,
                  corpus_mb=2, vocab_size=20_000, chunk_lines=4)
#: leg C's queries and the kernels each must launch on the card at the
#: sorter's default floor (a span takes the card from 65,536 records and
#: 1 MiB of keys) and query_scale 100: supply_chain's lineitem side and
#: joiners, the window's and the limit's reduce merges
QUERY_LAUNCHES = {"supply_chain": ("fnv_hash_lanes", "merge_path_pair"),
                  "top_orders": ("merge_path_pair",),
                  "flagged_sample": ("merge_path_pair",)}
#: leg C's aggregate, repartition join and window run again with the
#: device floor at one record and the key-byte floor off (the sorter's
#: own knobs), each launching both kernels: under the default floor an
#: aggregate's exchange carries one partial row a group a scan task (3
#: for pricing_summary at any scale) and hot_parts' sides ~36,000 rows a
#: task at scale 100, so they sort and merge on the host engine
FLOOR_QUERIES = ("pricing_summary", "hot_parts", "top_orders")
FLOOR_CONF = {"tez.runtime.tpu.device.sort.min.records": 1,
              "tez.runtime.sort.engine.min-bytes": 0}
#: tests/test_custom_edges.py's fair-shuffle DAG: 3,000 lines of
#: "hotkey fillerN" (15 bytes a line) against a desired task input of
#: 4,096; leg D keeps that ratio of text bytes to the desired size
FAIR_TEST_BYTES, FAIR_TEST_DESIRED = 3000 * 15, 4096
#: leg D's fair-shuffle corpus: words a line, every other one the hot word
FAIR_WORDS_PER_LINE = 64


def write_word_lines(path: str, corpus: DagCorpus, ids: np.ndarray,
                     per_line: int) -> int:
    """The corpus vocabulary's words `ids` into `path`, per_line words a
    line joined by spaces (the last line may be short); returns the bytes
    written."""
    lens = corpus.lens[ids]
    ends = np.cumsum(lens + 1)
    text = np.full(int(ends[-1]), 32, np.uint8)
    keep = np.arange(16)[None, :] < lens[:, None]
    text[((ends - lens - 1)[:, None] + np.arange(16)[None, :])[keep]] = \
        corpus.mat[ids][keep]
    text[ends[per_line - 1::per_line] - 1] = 10
    text[-1] = 10
    with open(path, "wb") as fh:
        fh.write(text.tobytes())
    return len(text)


def smj_leg(corpus: DagCorpus, root: str, device, sz: dict,
            totals: collections.Counter) -> None:
    """Leg A: SortMergeJoinExample with its defaults (2 joiners, a side
    parallelism of 2); the output is the distinct words on both sides."""
    from tez_tpu_torch.examples import sort_merge_join
    label = "query A"
    left, lbytes, lgold = corpus.slice_file("smj_left.txt", 0, sz["smj_mb"])
    right, rbytes, rgold = corpus.slice_file("smj_right.txt", sz["smj_mb"],
                                             2 * sz["smj_mb"])
    out = os.path.join(root, "smj_out")
    dag = sort_merge_join.build_dag([left], [right], out)
    with Launches(label, totals) as launches:
        status, wall = submit_dag(dag, {"tez.staging-dir": os.path.join(
            root, "smj_stg")}, device)
        sync(device)
    check(status.state.name == "SUCCEEDED",
          f"{label}: state {status.state.name}")
    rows = [line.split(b"\t") for line in part_lines(label, out)]
    check(all(v == b"1" for _w, v in rows), f"{label}: a value is not 1")
    want = sorted(word_bytes(corpus.mat, corpus.lens,
                             np.flatnonzero((lgold > 0) & (rgold > 0))))
    check(sorted(w for w, _v in rows) == want,
          f"{label}: {len(rows)} rows against {len(want)} words on both "
          f"sides")
    check_no_failover(label, status.counters.to_dict())
    launches.require(device, "fnv_hash_lanes", "merge_path_pair")
    log(f"phase {label}: wall_s={wall:.3f} MB={(lbytes + rbytes) / 1e6:.1f} "
        f"words={int(lgold.sum())} + {int(rgold.sum())} rows={len(rows)} "
        f"launches {json.dumps(launches.counts)}")


def hash_leg(corpus: DagCorpus, root: str, device, sz: dict, rng,
             totals: collections.Counter) -> None:
    """Leg B: HashJoinExample, hash_lines stream lines of one Zipf word
    each against hash_words distinct words drawn Zipf from the same
    vocabulary; one (word, "1") record per matching stream occurrence."""
    from tez_tpu_torch.examples import hash_join
    label = "query B"
    vocab = len(corpus.lens)
    ids = rng.zipf(ZIPF_A, sz["hash_lines"]).astype(np.int64) % vocab
    side = np.zeros(0, np.int64)
    while len(side) < sz["hash_words"]:
        draw = np.concatenate([side, rng.zipf(ZIPF_A, 16 * sz["hash_words"])
                               .astype(np.int64) % vocab])
        _, first = np.unique(draw, return_index=True)
        side = draw[np.sort(first)]
    side = side[:sz["hash_words"]]
    stream_path = os.path.join(root, "hj_stream.txt")
    hash_path = os.path.join(root, "hj_hash.txt")
    write_word_lines(stream_path, corpus, ids, 1)
    write_word_lines(hash_path, corpus, side, 1)
    counts = np.bincount(ids, minlength=vocab)
    hit = side[counts[side] > 0]
    golden = collections.Counter(dict(zip(
        word_bytes(corpus.mat, corpus.lens, hit), counts[hit].tolist())))
    out = os.path.join(root, "hj_out")
    dag = hash_join.build_dag([stream_path], [hash_path], out)
    with Launches(label, totals) as launches:
        status, wall = submit_dag(dag, {"tez.staging-dir": os.path.join(
            root, "hj_stg")}, device)
        sync(device)
    check(status.state.name == "SUCCEEDED",
          f"{label}: state {status.state.name}")
    rows = [line.split(b"\t") for line in part_lines(label, out)]
    check(all(v == b"1" for _w, v in rows), f"{label}: a value is not 1")
    got = collections.Counter(w for w, _v in rows)
    check(got == golden, f"{label}: {len(rows)} records of {len(got)} "
                         f"words against {sum(golden.values())} of "
                         f"{len(golden)}")
    check_no_failover(label, status.counters.to_dict())
    log(f"phase {label}: wall_s={wall:.3f} stream lines={len(ids)} hash "
        f"words={len(side)} records={len(rows)} launches "
        f"{json.dumps(launches.counts)} (the broadcast edge is unordered)")


def run_query(s, q, c, root: str, device, oracle: list, label: str,
              leg: collections.Counter, need=()):
    """One corpus query through QuerySession `s`: SUCCEEDED, its records
    the oracle's, its wall, join decisions and launches printed, and on
    the card each kernel in `need` launched (merge_rank never)."""
    with Launches(label, leg) as launches:
        r = s.run(q.build(c), os.path.join(root, label.replace(" ", "_")),
                  query_name=q.name, sink=q.sink, timeout=1200)
        sync(device)
    check(r.state == "SUCCEEDED", f"{label}: state {r.state}")
    got = r.read_output()
    check(got == oracle, f"{label}: {len(got)} records against the "
                         f"oracle's {len(oracle)}")
    joins = [(d["choice"], d["basis"]) for d in r.decisions
             if d["kind"] == "join_strategy"]
    log(f"phase {label}: wall_s={r.wall_s:.3f} records={len(got)} joins "
        f"{json.dumps(joins)} cache_hits={r.cache_hits} launches "
        f"{json.dumps(launches.counts)}")
    launches.require(device, *need)
    return r


def corpus_leg(root: str, device, sz: dict,
               totals: collections.Counter) -> None:
    """Leg C: every CORPUS_QUERIES query through one QuerySession on
    `device` (the store on, replanning off so a rerun plans the same
    DAG), each equal to its numpy oracle and QUERY_LAUNCHES' queries
    launching their kernels; then nation_revenue again, served from the
    store's sealed lineage; then FLOOR_QUERIES in a second session at
    FLOOR_CONF, each launching both kernels."""
    from tez_tpu_torch.query import QuerySession
    from tez_tpu_torch.store import reset_store
    from tez_tpu_torch.tools import query_corpus
    t0 = time.perf_counter()
    c = query_corpus.generate(os.path.join(root, "tpch"),
                              scale=sz["query_scale"], seed=sz["query_seed"])
    rows = {t: len(c.columns(t)[query_corpus.SCHEMAS[t][0]])
            for t in query_corpus.SCHEMAS}
    log(f"query C: corpus at scale {sz['query_scale']} {json.dumps(rows)} "
        f"rows, {sum(map(os.path.getsize, c.paths.values()))} bytes, made "
        f"in {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    queries = {q.name: q for q in query_corpus.CORPUS_QUERIES}
    oracles = {name: q.oracle(c) for name, q in queries.items()}
    log(f"query C: oracles in {time.perf_counter() - t0:.3f} s")
    reset_store()
    conf = {"tez.staging-dir": os.path.join(root, "q_stg"),
            "tez.runtime.store.enabled": True,
            "tez.query.replan.enabled": False}
    leg: collections.Counter = collections.Counter()
    with QuerySession("phase18", conf, device=device) as s:
        for name, q in queries.items():
            run_query(s, q, c, root, device, oracles[name],
                      f"query C {name}", leg, QUERY_LAUNCHES.get(name, ()))
        name = "nation_revenue"
        r = run_query(s, queries[name], c, root, device, oracles[name],
                      f"query C rerun {name}", leg)
        check(r.cache_hits > 0, f"query C rerun {name}: no cache hit")
    reset_store()
    conf = {"tez.staging-dir": os.path.join(root, "q_floor_stg"),
            "tez.query.replan.enabled": False, **FLOOR_CONF}
    with QuerySession("phase18-floor", conf, device=device) as s:
        for name in FLOOR_QUERIES:
            run_query(s, queries[name], c, root, device, oracles[name],
                      f"query C floor {name}", leg,
                      ("fnv_hash_lanes", "merge_path_pair"))
    totals.update(leg)
    log(f"query C: launches over the leg {json.dumps(dict(leg))}")


def custom_edge_leg(corpus: DagCorpus, root: str, device, sz: dict, rng,
                    totals: collections.Counter) -> None:
    """Leg D: the cartesian-product example (every pair of the two token
    files), then OrderedWordCount without the combiner and with
    FairShuffleVertexManager on the summation over text whose words are
    half one hot word: the hot partition split, the counts exact."""
    from tez_tpu_torch.common.payload import VertexManagerPluginDescriptor
    from tez_tpu_torch.examples import cartesian_product, ordered_wordcount
    label = "query D cartesian"
    n_left, n_right = sz["cp_left"], sz["cp_right"]
    tokens = word_bytes(corpus.mat, corpus.lens, range(n_left + n_right))
    paths = []
    for name, toks in (("left", tokens[:n_left]), ("right", tokens[n_left:])):
        paths.append(os.path.join(root, f"cp_{name}.txt"))
        with open(paths[-1], "wb") as fh:
            fh.write(b"\n".join(b" ".join(toks[i:i + 16])
                                for i in range(0, len(toks), 16)) + b"\n")
    out = os.path.join(root, "cp_out")
    with Launches(label, totals):
        t0 = time.perf_counter()
        state = cartesian_product.run(
            paths[0], paths[1], out, conf={"tez.staging-dir": os.path.join(
                root, "cp_stg")}, device=device)
        wall = time.perf_counter() - t0
        sync(device)
    check(state == "SUCCEEDED", f"{label}: state {state}")
    pairs = sorted(line.split(b"\t")[0] for line in part_lines(label, out))
    check(pairs == sorted(a + b"|" + b for a in tokens[:n_left]
                          for b in tokens[n_left:]),
          f"{label}: {len(pairs)} pairs against {n_left * n_right}")
    log(f"phase {label}: wall_s={wall:.3f} pairs={len(pairs)}")

    label = "query D fair shuffle"
    vocab = len(corpus.lens)
    hot = 0
    # about fair_mb of text: each other word the hot one, the rest Zipf
    per_pair = float(corpus.lens[hot] + 1 + np.mean(corpus.lens) + 1)
    n = int(sz["fair_mb"] * (1 << 20) / per_pair) // \
        FAIR_WORDS_PER_LINE * FAIR_WORDS_PER_LINE
    ids = np.zeros(2 * n, np.int64)
    ids[1::2] = 1 + rng.zipf(ZIPF_A, n).astype(np.int64) % (vocab - 1)
    counts = np.bincount(ids, minlength=vocab)
    path = os.path.join(root, "fair.txt")
    written = write_word_lines(path, corpus, ids, FAIR_WORDS_PER_LINE)
    desired = int(FAIR_TEST_DESIRED * written / FAIR_TEST_BYTES)
    out = os.path.join(root, "fair_out")
    dag = ordered_wordcount.build_dag([path], out, tokenizer_parallelism=4,
                                      summation_parallelism=4,
                                      combine=False)
    dag.vertices["summation"].set_vertex_manager_plugin(
        VertexManagerPluginDescriptor.create(
            "tez_tpu_torch.library.fair_shuffle:FairShuffleVertexManager",
            payload={"desired_task_input_size": desired,
                     "min_fraction": 0.9, "max_fraction": 0.9}))
    with Launches(label, totals) as launches:
        status, wall = submit_dag(dag, {"tez.staging-dir": os.path.join(
            root, "fair_stg")}, device)
        sync(device)
    check(status.state.name == "SUCCEEDED",
          f"{label}: state {status.state.name}")
    rows = [line.rsplit(b"\t", 1) for line in part_lines(label, out)]
    got: collections.Counter = collections.Counter()
    for w, c in rows:
        got[w] += int(c)
    drawn = np.flatnonzero(counts)
    want = collections.Counter(dict(zip(
        word_bytes(corpus.mat, corpus.lens, drawn), counts[drawn].tolist())))
    check(got == want, f"{label}: {len(got)} words against {len(want)}")
    tasks = status.vertex_status["summation"].progress.total_task_count
    check(tasks > 4, f"{label}: {tasks} summation tasks, the hot partition "
                     f"was not split")
    check_no_failover(label, status.counters.to_dict())
    launches.require(device, "fnv_hash_lanes")
    log(f"phase {label}: wall_s={wall:.3f} MB={written / 1e6:.1f} "
        f"words={int(counts.sum())} hot={int(counts[hot])} desired task "
        f"input {desired} B, summation tasks {tasks} (4 configured), "
        f"{len(rows)} rows for {len(want)} words; launches "
        f"{json.dumps(launches.counts)}")


def query_phase(args, device="cuda", corpus=None, **sizes) -> dict:
    """Phase 18 (module docstring): legs A-D, A over prefixes of `corpus`
    (phase 11's; made here when None).  Returns {"launches": ...,
    "legs": {leg: wall s}}."""
    sz = dict(QUERY_SIZES, **sizes)
    if corpus is None:
        marks = (sz["smj_mb"], 2 * sz["smj_mb"])
        with tempfile.TemporaryDirectory(prefix="tez_query_") as root:
            return query_phase(args, device, DagCorpus(
                root, args, marks_mb=marks, **dict(
                    {"corpus_mb": max(marks)}, **corpus_sizes(sz))),
                **sizes)
    from tez_tpu_torch.ops import async_stage
    from tez_tpu_torch.ops.async_stage import process_breaker
    totals: collections.Counter = collections.Counter()
    rng = np.random.default_rng(args.seed + 18)
    root = os.path.join(corpus.root, "query")
    os.makedirs(root, exist_ok=True)
    async_stage.reset_process_breaker()
    legs = {}
    for leg, run in (
            ("A", lambda: smj_leg(corpus, root, device, sz, totals)),
            ("B", lambda: hash_leg(corpus, root, device, sz, rng, totals)),
            ("C", lambda: corpus_leg(root, device, sz, totals)),
            ("D", lambda: custom_edge_leg(corpus, root, device, sz, rng,
                                          totals))):
        before = collections.Counter(totals)
        t0 = time.perf_counter()
        run()
        legs[leg] = time.perf_counter() - t0
        log(f"query {leg}: leg wall_s={legs[leg]:.3f} launches "
            f"{json.dumps(dict(totals - before))}")
    br = process_breaker()
    check(br.state == "closed" and br.trips == 0,
          f"query: breaker {br.state}, {br.trips} trips")
    log("query: legs A-D passed")
    return {"launches": dict(totals), "legs": legs}


# ---------------------------------------------------------------------------
# phase 19: streaming, the SLO watchdog and exposition, speculation and the
# AM's services
# ---------------------------------------------------------------------------
#: phase 19: A and B `windows` windows of `window` records ({"k": word,
#: "v": 1}, the words drawn Zipf(1.3) from phase 11's vocabulary) through
#: an AM crash inside window 2's commit bracket (the commit held
#: `hold_ms`), then a stream of `slo_windows` windows of `slo_window`
#: records on an AM with a 1 ms window p95 target; C OrderedWordCount over
#: the first spec_mb MiB of phase 11's corpus at io.sort.mb spec_sort_mb
#: (each tokenizer dispatches a span while it writes, over the device
#: floor) with tokenizer 0's first attempt held up to spec_delay_ms once
#: its sorter dispatched a span, then 3 spans of abort_span_mb through an
#: async sorter whose span 1 is held abort_hold_ms in its completion while
#: the sorter aborts
STREAM_SIZES = dict(window=1 << 19, windows=3, slo_window=4096,
                    slo_windows=2, hold_ms=2_000, spec_mb=16,
                    spec_sort_mb=4, spec_delay_ms=20_000, abort_span_mb=16,
                    abort_hold_ms=1_500, conf={})
#: a size the plain versions run in seconds (the CPU rehearsal); its
#: windows cross the device floor only with FLOOR_CONF in `conf` (the
#: abort's spans of 3 MB clear it as they are); each tokenizer's 0.5 MiB
#: of lines fills one span of 1 MB while it writes
TINY_STREAM = dict(window=1 << 11, windows=3, slo_window=64, slo_windows=2,
                   hold_ms=500, spec_mb=2, spec_sort_mb=1,
                   spec_delay_ms=20_000, abort_span_mb=3, abort_hold_ms=500,
                   conf={})
#: the stream AMs: tests/test_streaming.py's session
STREAM_AM_CONF = {"tez.am.local.num-containers": 4,
                  "tez.am.session.max-concurrent-dags": 2,
                  "tez.am.session.queue-size": 8}
#: leg C: the AM's services and tests/test_speculation_estimators.py's
#: race settings
SPEC_CONF = {"tez.am.speculation.enabled": True,
             "tez.am.legacy.speculative.slowtask.threshold": 1.0,
             "tez.am.soonest.retry.after.no.speculate": 200,
             "tez.am.task.scheduler.class": "dag-aware",
             "tez.am.concurrent.dispatcher.shards": 4,
             "tez.debug.lockorder": True,
             "tez.am.slo.submit.p95-ms": 600_000.0}
WINDOW_LEDGER = ("WINDOW_COMMIT_STARTED", "WINDOW_COMMIT_FINISHED",
                 "WINDOW_COMMIT_ABORTED")


def stream_plan(root: str, name: str, parallelism: int = 2):
    """tests/test_streaming.py's window template in `root`'s classes:
    `parallelism` StreamWindowSourceProcessor tasks, one
    StreamWindowSinkProcessor, the ordered scatter-gather edge."""
    api = dag_api(root)
    d, p = api.dag, api.payload
    from_pkg = f"{root}.library."
    source = d.Vertex.create("source", p.ProcessorDescriptor.create(
        from_pkg + "streaming:StreamWindowSourceProcessor"), parallelism)
    sink = d.Vertex.create("sink", p.ProcessorDescriptor.create(
        from_pkg + "streaming:StreamWindowSinkProcessor"), 1)
    edge = api.edge_config.new_builder("bytes", "long").build()
    dag = d.DAG.create(name).add_vertex(source).add_vertex(sink)
    dag.add_edge(d.Edge.create(source, sink,
                               edge.create_default_edge_property()))
    return dag.create_dag_plan()


def stream_spec(root: str, name: str, out_root: str, **conf):
    return importlib.import_module(f"{root}.am.streaming").StreamSpec(
        name=name, plan=stream_plan(root, f"{name}-template"),
        output_dir=os.path.join(out_root, name), conf=conf)


def stream_am(root: str, app_id: str, staging: str, device, attempt=1,
              **conf):
    """A started DAGAppMaster of `root` for streams (device is the port's;
    tez_tpu's AM takes none)."""
    C = importlib.import_module(f"{root}.common.config")
    kw = {} if root == "tez_tpu" else {"device": device}
    am = importlib.import_module(f"{root}.am.app_master").DAGAppMaster(
        app_id, C.TezConfiguration(dict(
            STREAM_AM_CONF, **conf, **{"tez.staging-dir": staging})),
        attempt=attempt, **kw)
    am.start()
    return am


def window_parts(records: list, window: int) -> list:
    """Each window's expected part file: the records cut every `window`,
    the last window the rest, each "key total" line in key byte order."""
    out = []
    for lo in range(0, len(records), window):
        totals = collections.Counter()
        for r in records[lo:lo + window]:
            if isinstance(r, dict) and "k" in r:
                totals[r["k"].encode()] += r.get("v", 1)
        out.append("".join(f"{k.decode()} {v}\n"
                           for k, v in sorted(totals.items())).encode())
    return out


def stream_parts(out_dir: str) -> dict:
    """The committed (final-named) part files of a stream's output."""
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if not name.startswith("."):
            with open(os.path.join(out_dir, name), "rb") as fh:
                out[name] = fh.read()
    return out


def window_ledger(events) -> list:
    """(record type, window id, replayed) of each window commit record."""
    return [(ev.event_type.name, ev.data["window_id"],
             ev.data.get("replayed", False)) for ev in events
            if ev.event_type.name in WINDOW_LEDGER]


def wait_for(pred, what: str, timeout: float = 600.0) -> None:
    deadline = time.time() + timeout
    while not pred():
        check(time.time() < deadline, f"{what} never happened")
        time.sleep(0.005)


def finished_windows(am) -> int:
    return sum(1 for ev in list(am.logging_service.events)
               if ev.event_type.name == "WINDOW_COMMIT_FINISHED")


def window_records(corpus: DagCorpus, rng, n: int) -> list:
    """n records {"k": word, "v": 1}, the words drawn Zipf(1.3) from
    phase 11's vocabulary."""
    ids = rng.zipf(ZIPF_A, n) % len(corpus.lens)
    uniq, inv = np.unique(ids, return_inverse=True)
    words = [bytes(corpus.mat[i, :corpus.lens[i]]).decode() for i in uniq]
    return [{"k": words[j], "v": 1} for j in inv.tolist()]


def check_parts(label: str, out_dir: str, goldens: list) -> None:
    parts = stream_parts(out_dir)
    want = {f"w{i:06d}.part0": g for i, g in enumerate(goldens, 1)}
    check(sorted(parts) == sorted(want),
          f"{label}: committed {sorted(parts)}, expected {sorted(want)}")
    for name, data in want.items():
        check(parts[name] == data, f"{label}: {name} differs from its "
                                   f"golden")


def count_windows(driver) -> dict:
    """Wrap the driver's window runner (its worker thread runs one window
    DAG at a time, from submit to commit): window id -> (the kernel
    launches during it, its seconds from submit to commit)."""
    from tez_tpu_torch.ops import kernels
    seen: dict = {}
    run_window = driver._run_window

    def counted(w):
        before = dict(kernels.launches)
        t0 = time.perf_counter()
        run_window(w)
        seen[w] = ({k: v - before.get(k, 0)
                    for k, v in kernels.launches.items()},
                   time.perf_counter() - t0)
    driver._run_window = counted
    return seen


def require_windows(label: str, device, seen: dict, windows) -> None:
    """On the card, each window DAG launched both kernels (and not the
    general merge rank)."""
    check(sorted(seen) == list(windows),
          f"{label}: windows run {sorted(seen)}, expected {list(windows)}")
    if not is_cuda(device):
        return
    for w in windows:
        counts = seen[w][0]
        check(counts.get("fnv_hash_lanes", 0) > 0
              and counts.get("merge_path_pair", 0) > 0
              and counts.get("merge_rank", 0) == 0,
              f"{label}: window {w} launched {counts}")


def stream_leg(corpus, root, device, sz, rng, totals) -> None:
    """Legs A and B on one stream of 3 windows: attempt 1 ingests
    windows 1-2 and the start of 3 and crashes while window 2's commit
    bracket is open (a stream.window.commit delay rule holds it); attempt
    2 (recover_and_resume) keeps window 1 sealed, replays window 2 and
    rolls it forward, keeps the open spool's records, takes the rest of
    window 3 and drains.  Each window DAG's launches are read around it:
    in the driver's worker thread in attempt 1, around the replay and
    window 3 in attempt 2."""
    from tez_tpu_torch.common import faults
    label = "stream A-B"
    w = sz["window"]
    records = window_records(corpus, rng, sz["windows"] * w)
    goldens = window_parts(records, w)
    staging = os.path.join(root, "staging_a")
    out_root = os.path.join(root, "out_a")
    app_id = "app_1_stream_a"
    faults.install("phase19-commit", faults.parse_spec(
        f"stream.window.commit:delay:ms={sz['hold_ms']},n=1,match=@w2"))
    faults.install("phase19-fences",
                   faults.parse_spec("fence.stale_window:delay:ms=0"))
    fences0 = len(faults.plane().journal)
    try:
        am1 = stream_am("tez_tpu_torch", app_id, staging, device,
                        **sz["conf"])
        with Launches(f"{label} attempt 1", totals):
            t0 = time.perf_counter()
            driver1 = am1.open_stream(stream_spec(
                "tez_tpu_torch", "words", out_root, **{
                    "tez.runtime.stream.window.count": w}))
            seen = count_windows(driver1)
            ended = []

            def ingest() -> None:
                # windows 1-2 and the start of 3, unless the crash ends it
                try:
                    driver1.ingest(records[:2 * w + w // 16])
                except Exception as e:  # noqa: BLE001 — the crash ends it
                    ended.append(type(e).__name__)
            source = threading.Thread(target=ingest, name="phase19-source")
            source.start()
            wait_for(lambda: any(
                ev.event_type.name == "WINDOW_COMMIT_STARTED"
                and ev.data["window_id"] == 2
                for ev in list(am1.logging_service.events)),
                f"{label}: window 2's commit")
            am1.crash()
            wall1 = time.perf_counter() - t0
            source.join(timeout=60)
            # the crashed driver's commit thread wakes from the rule into
            # a dead AM: whatever it does lands in no journal
            driver1._worker.join(timeout=sz["hold_ms"] / 1e3 + 60)
            sync(device)
        check(ended in ([], ["StreamError"]) and not source.is_alive(),
              f"{label}: the source ended {ended} at the crash")
        journal1 = read_journal(staging, attempt=1)
        t0 = time.perf_counter()
        am2 = stream_am("tez_tpu_torch", app_id, staging, device,
                        attempt=2, **sz["conf"])
        try:
            # window 2 replays alone: window 3 is cut only once the rest
            # of its records arrive
            with Launches(f"{label} attempt 2 window 2", totals) as ln2:
                am2.recover_and_resume()
                check("words" in am2.streams,
                      f"{label}: attempt 2 resumed no stream")
                driver2 = am2.streams["words"]
                kept = driver2.status()["open_records"]
                wait_for(lambda: finished_windows(am2) >= 1
                         or driver2.status()["error"],
                         f"{label}: window 2's replay")
                check(driver2.status()["error"] is None,
                      f"{label}: {driver2.status()['error']}")
                resume_s = time.perf_counter() - t0
                sync(device)
            with Launches(f"{label} attempt 2 window 3", totals) as ln3:
                driver2.ingest(records[2 * w + kept:])
                final = driver2.drain(timeout=600)
                sync(device)
            wall2 = time.perf_counter() - t0
        finally:
            am2.stop()
    finally:
        faults.clear("phase19-commit")
        fences = [d for point, d, _m in faults.plane().journal[fences0:]
                  if point == "fence.stale_window"]
        faults.clear("phase19-fences")
    ledger1 = window_ledger(journal1)
    ledger2 = window_ledger(read_journal(staging, attempt=2))
    check(ledger1 == [("WINDOW_COMMIT_STARTED", 1, False),
                      ("WINDOW_COMMIT_FINISHED", 1, False),
                      ("WINDOW_COMMIT_STARTED", 2, False)],
          f"{label}: attempt 1's window ledger {ledger1}")
    check(ledger2 == [("WINDOW_COMMIT_STARTED", 2, False),
                      ("WINDOW_COMMIT_FINISHED", 2, True),
                      ("WINDOW_COMMIT_STARTED", 3, False),
                      ("WINDOW_COMMIT_FINISHED", 3, False)],
          f"{label}: attempt 2's window ledger {ledger2}")
    check(final["committed"] == [1, 2, 3] and final["replayed"] == [2]
          and final["retired"] and not final["aborted"],
          f"{label}: drain reported {final}")
    check(kept > 0, f"{label}: the open spool kept no record")
    check_parts(label, os.path.join(out_root, "words"), goldens)
    require_windows(label, device, seen, (1, 2))
    ln2.require(device, "fnv_hash_lanes", "merge_path_pair")
    ln3.require(device, "fnv_hash_lanes", "merge_path_pair")
    log(f"phase {label}: {sz['windows']} windows of {w} records; attempt "
        f"1 wall_s={wall1:.3f} (crash inside window 2's bracket, {kept} "
        f"records of window 3 in the open spool), its windows submit to "
        f"commit s and launches "
        f"{json.dumps({v: [round(t, 3), c] for v, (c, t) in sorted(seen.items())})}; "
        f"attempt 2 wall_s={wall2:.3f}, window 2 replayed {resume_s:.3f} s "
        f"after its start (launches {json.dumps(ln2.counts)}), window 3 "
        f"launches {json.dumps(ln3.counts)}; journal lines replayed "
        f"{len(journal1)}; zombie rejections (fence.stale_window) "
        f"{len(fences)}; drain {json.dumps(final)}")


def slo_leg(corpus, root, device, sz, rng) -> dict:
    """Leg A's SLO stream on an AM whose window p95 target is 1 ms: one
    breach latched under the stream's name; both renderings carry its
    series."""
    from tez_tpu_torch.common import metrics
    from tez_tpu_torch.obs import exposition
    label = "stream A slo"
    name = "slo"
    metrics.registry().reset()
    n = sz["slo_window"] * sz["slo_windows"]
    records = window_records(corpus, rng, n)
    am = stream_am("tez_tpu_torch", "app_1_stream_slo",
                   os.path.join(root, "staging_slo"), device, **dict(
                       sz["conf"], **{"tez.am.slo.window.p95-ms": 1.0,
                                      "tez.am.slo.min-count": 1}))
    try:
        driver = am.open_stream(stream_spec(
            "tez_tpu_torch", name, os.path.join(root, "out_slo"), **{
                "tez.runtime.stream.window.count": sz["slo_window"]}))
        driver.ingest(records)
        final = driver.drain(timeout=600)
        breaches = [ev.data for ev in list(am.logging_service.events)
                    if ev.event_type.name == "TENANT_SLO_BREACH"]
        status = am.slo_watchdog.status()
    finally:
        am.stop()
    check(final["committed"] == list(range(1, sz["slo_windows"] + 1)),
          f"{label}: drain reported {final}")
    check_parts(label, os.path.join(root, "out_slo", name),
                window_parts(records, sz["slo_window"]))
    mine = [b for b in breaches if b["stream"] == name]
    check(len(mine) == 1 and mine[0]["kind"] == "window_p95_ms"
          and status["total_breaches"] == len(breaches),
          f"{label}: breaches {breaches}, watchdog {status['active']}")
    reg = metrics.registry()
    hists, gauges = reg.histograms(), reg.gauges()
    prom = metrics.render_prometheus(hists, gauges)
    text = exposition.render_text(hists, gauges)
    fams = exposition.parse_exposition(text)
    series = f"tez_latency_stream_{name}_window_latency_ms_count"
    check(series in prom, f"{label}: render_prometheus has no {series}")
    check(f'stream="{name}"' in text
          and "tez_latency_stream_window_latency_ms" in fams,
          f"{label}: render_text carries no stream={name} series")
    log(f"phase {label}: {sz['slo_windows']} windows of "
        f"{sz['slo_window']} records; breaches "
        f"{json.dumps([{k: b[k] for k in ('kind', 'stream', 'observed')} for b in breaches])}; "
        f"render_prometheus {len(prom.splitlines())} lines, render_text "
        f"{len(text.splitlines())} lines ({len(fams)} families)")
    return status


#: what each held attempt's sorter had done when its kill reached it
#: (HeldTokenProcessor appends, speculation_leg reads)
HELD_ATTEMPTS: list = []


class HeldTokenProcessor:
    """Phase 19 C's tokenizer: OrderedWordCount's vector tokenizer, except
    in the attempt its payload's "held" ends (tokenizer 0's first).  That
    attempt writes its split, waits until its sorter dispatched a span on
    the device, then reports no progress for up to "hold_ms": a straggler
    with its span plane open (its pipeline up, its stream pair held, its
    runs kept for a flush that never comes).  When its kill arrives, what
    its sorter had done goes into HELD_ATTEMPTS and the kill goes on to
    the task runner, which aborts the output."""

    def __init__(self, context):
        from tez_tpu_torch.examples.ordered_wordcount import \
            VectorTokenProcessor
        self.context = context
        self._inner = VectorTokenProcessor(context)

    def initialize(self) -> None:
        self._inner.initialize()

    def handle_events(self, events) -> None:
        self._inner.handle_events(events)

    def close(self) -> None:
        self._inner.close()

    def run(self, inputs, outputs) -> None:
        from tez_tpu_torch.runtime.contexts import TaskKilledError
        payload = self.context.user_payload.load() or {}
        attempt = str(self.context.task_attempt_id)
        if not attempt.endswith(payload["held"]):
            self._inner.run(inputs, outputs)
            return
        sorter = outputs["summation"].sorter
        deadline = time.monotonic() + payload["hold_ms"] / 1e3

        def stats() -> dict:
            pipe = sorter._pipeline
            return {"submitted": pipe.stats.submitted if pipe else 0,
                    "dispatched": pipe.stats.dispatched if pipe else 0,
                    "completed": pipe.stats.completed if pipe else 0,
                    "spans": sorter.num_spills,
                    "buffered": sorter._span.num_records}
        self._inner.run(inputs, outputs)
        held = None
        try:
            while time.monotonic() < deadline:
                if held is None and stats()["dispatched"] > 0:
                    held = stats()
                time.sleep(0.005)
                self.context.notify_progress()
        except TaskKilledError:
            HELD_ATTEMPTS.append(dict(stats(), attempt=attempt,
                                      at_hold=held))
            raise


def abort_leg(device, sz, totals) -> None:
    """Phase 19 C's abort with a span in flight: an async DeviceSorter
    shipping each span as it completes (on_spill, the pipelined output's
    hook) writes 3 spans of abort_span_mb; a device.dispatch.delay rule
    holds span 1's completion abort_hold_ms, and abort() runs inside the
    hold.  It returns only once that span completed, nothing ships after
    it began, the sorter keeps no run, the stream pair goes back and the
    breaker stays closed."""
    from tez_tpu_torch.common import faults
    from tez_tpu_torch.common.counters import TezCounters
    from tez_tpu_torch.ops import device as device_ops
    from tez_tpu_torch.ops.async_stage import process_breaker
    from tez_tpu_torch.ops.sorter import DeviceSorter
    label = "speculation C abort"
    span_bytes = int(sz["abort_span_mb"] * (1 << 20))
    rec = span_records(span_bytes)
    rng = np.random.default_rng(19)
    vocab = bench_vocab()
    batches = [bench_batch(rng, vocab, rec)[0] for _span in range(3)]
    hold_s = sz["abort_hold_ms"] / 1e3
    shipped = []
    held0 = device_ops.held_stream_pairs()
    counters = TezCounters()
    faults.install("phase19-abort", faults.parse_spec(
        f"device.dispatch.delay:delay:ms={sz['abort_hold_ms']},n=1,"
        f"match=span=1"))
    fired0 = len(faults.plane().journal)

    def fired() -> bool:
        return any(point == "device.dispatch.delay" for point, _d, _m in
                   faults.plane().journal[fired0:])
    try:
        with Launches(label, totals) as ln:
            s = DeviceSorter(num_partitions=NUM_PARTITIONS, key_width=12,
                             span_budget_bytes=span_bytes, engine="device",
                             device=device, pipeline_depth=2,
                             counters=counters)
            s.on_spill = lambda run, sid: shipped.append(
                (sid, time.perf_counter()))
            for batch in batches:
                s.write_batch(batch)
            wait_for(fired, f"{label}: span 1's held completion",
                     timeout=120)
            t_fire = time.perf_counter()
            pipe = s._pipeline
            in_flight = pipe.stats.submitted - pipe.stats.completed
            held = device_ops.held_stream_pairs()
            t_abort = time.perf_counter()
            s.abort()
            t_end = time.perf_counter()
            sync(device)
    finally:
        faults.clear("phase19-abort")
    br = process_breaker()
    sids = [sid for sid, _t in shipped]
    late = [sid for sid, t in shipped if t >= t_abort]
    check(s.num_spills == 3 and in_flight >= 1 and 1 not in sids
          and not late,
          f"{label}: {s.num_spills} spans, {in_flight} in flight at the "
          f"abort, shipped {sids} ({late} after the abort began)")
    check(t_end - t_fire >= 0.9 * hold_s,
          f"{label}: abort() returned {t_end - t_fire:.3f} s after the "
          f"hold began, inside the {hold_s:.1f} s hold")
    check(not is_cuda(device) or held == held0 + 1,
          f"{label}: {held} stream pairs held in the hold ({held0} before)")
    check(device_ops.held_stream_pairs() == held0 and not s._runs
          and s._pipeline is None and br.state == "closed"
          and br.trips == 0,
          f"{label}: after the abort {device_ops.held_stream_pairs()} "
          f"stream pairs held ({held0} before), {len(s._runs)} runs kept, "
          f"breaker {br.state} {br.trips} trips")
    check_fault_free(label, [pipe], [counters])
    ln.require(device, "fnv_hash_lanes")
    log(f"phase {label}: 3 spans of {rec} records, {in_flight} in flight "
        f"when abort() began; it returned {t_end - t_abort:.3f} s later "
        f"(span 1's completion held {hold_s:.1f} s), spans shipped before "
        f"it {sorted(sids)}, none after; stream pairs held {held} in the "
        f"hold, {held0} after; launches {json.dumps(ln.counts)}")


def speculation_leg(corpus, root, device, sz, totals) -> None:
    """Leg C: OrderedWordCount with speculation, the dag-aware scheduler,
    the sharded dispatcher, the lock-order witness and an SLO target;
    tokenizer 0's first attempt holds once its sorter dispatched a span
    (HeldTokenProcessor), a sibling overtakes it, and the loser's kill
    aborts its output: it gave its span plane back and registered nothing
    (nor published into a store, where one is on).  Then abort_leg."""
    from tez_tpu_torch.client.tez_client import TezClient
    from tez_tpu_torch.common import lockorder
    from tez_tpu_torch.common.dispatcher import ShardedDispatcher
    from tez_tpu_torch.common.payload import ProcessorDescriptor
    from tez_tpu_torch.examples import ordered_wordcount
    from tez_tpu_torch.ops import device as device_ops
    from tez_tpu_torch.ops.async_stage import process_breaker
    from tez_tpu_torch.shuffle.service import local_shuffle_service
    from tez_tpu_torch.store import local_buffer_store, reset_store
    label = "speculation C"
    # the runners resolve the processor by name: this module where it is
    # imported, its second copy where it runs as the script
    held_log = importlib.import_module("chip_smoke").HELD_ATTEMPTS
    held_log.clear()
    path, nbytes, golden = corpus.slice_file("spec.txt", 0, sz["spec_mb"])
    out = os.path.join(root, "out_c")
    delay_s = sz["spec_delay_ms"] / 1e3
    conf = dict(DAG_CONF, **SPEC_CONF, **sz["conf"], **{
        "tez.runtime.io.sort.mb": sz["spec_sort_mb"],
        "tez.staging-dir": os.path.join(root, "staging_c")})
    dag = ordered_wordcount.build_dag([path], out, **dict(
        DAG_SHAPE, combine=False))
    dag.vertices["tokenizer"].processor = ProcessorDescriptor.create(
        "chip_smoke:HeldTokenProcessor", payload={
            "held": "_00_000000_0", "hold_ms": sz["spec_delay_ms"]})

    def published() -> int:
        store = local_buffer_store()
        return -1 if store is None else \
            store.stats()["counters"].get("store.published", 0)
    reset_store()
    lockorder.clear_all()
    # pipelines of earlier paths that ended in an error keep their pair
    held0 = device_ops.held_stream_pairs()
    client = TezClient.create("speculation", conf, device=device)
    client.start()
    try:
        am = client.framework_client.am
        check(isinstance(am.dispatcher, ShardedDispatcher)
              and type(am.task_scheduler).__name__ ==
              "DagAwareTaskSchedulerService",
              f"{label}: dispatcher {type(am.dispatcher).__name__}, "
              f"scheduler {type(am.task_scheduler).__name__}")
        with Launches(label, totals) as ln:
            t0 = time.perf_counter()
            status = client.submit_dag(dag).wait_for_completion(
                timeout=3600)
            wall = time.perf_counter() - t0
            sync(device)
        published_at_end = published()
        events = list(am.logging_service.events)
        loser = next(ev.attempt_id for ev in events
                     if ev.event_type.name == "TASK_ATTEMPT_STARTED"
                     and ev.attempt_id.endswith("_00_000000_0"))
        attempts = {ev.attempt_id: ev.data.get("state", "") for ev in events
                    if ev.event_type.name == "TASK_ATTEMPT_FINISHED"
                    and "_00_000000_" in ev.attempt_id}
        counters = status.counters.to_dict() if status.counters else {}
        dag_counters = am.dag_counters.to_dict().get("DAGCounter", {})
        slo = am.slo_watchdog.status()
        violations = lockorder.check()
        witnessed = (len(lockorder.witness().lock_names()),
                     len(lockorder.witness().edges()))
        depths = am.dispatcher.peak_depths()
        log(f"phase {label}: wall_s={wall:.3f} MB={nbytes / 1e6:.1f} "
            f"against a {delay_s:.0f} s hold; tokenizer 0's attempts "
            f"{json.dumps(attempts)}; DAG counters "
            f"{json.dumps(dag_counters)}; witness {witnessed[0]} locks, "
            f"{witnessed[1]} edges; dispatcher shard peak depths {depths}; "
            f"SLO evaluations {slo['evaluations']}, breaches "
            f"{slo['total_breaches']}")
        check(status.state.name == "SUCCEEDED",
              f"{label}: state {status.state.name}")
        check(wall < 0.75 * delay_s, f"{label}: the DAG took {wall:.3f} s "
                                     f"against the {delay_s:.0f} s hold")
        check(dag_counters.get("NUM_SPECULATIONS", 0) >= 1,
              f"{label}: DAG counters {dag_counters}")
        check(any(a.endswith("_1") and s == "SUCCEEDED"
                  for a, s in attempts.items()),
              f"{label}: tokenizer 0's attempts {attempts}")
        check_wordcount(label, out, corpus.mat, corpus.lens, golden)
        check_no_failover(label, counters)
        ln.require(device, "fnv_hash_lanes", "merge_path_pair")
        check(not violations, f"{label}: lock-order witness {violations}")
        check(witnessed[0] > 0, f"{label}: the witness saw no lock")
        check(slo["total_breaches"] == 0 and not slo["burn"]["active"],
              f"{label}: SLO {slo['active']} {slo['burn']['active']}")
        # the kill reaches the loser in its hold: wait for its runner's
        # reporter thread to end (after the abort)
        t0 = time.perf_counter()
        wait_for(lambda: not any(t.name == f"reporter-{loser}"
                                 for t in threading.enumerate()),
                 f"{label}: the loser's teardown", timeout=delay_s + 120)
        sync(device)
        waited = time.perf_counter() - t0
        final = {ev.attempt_id: ev.data.get("state", "")
                 for ev in list(am.logging_service.events)
                 if ev.event_type.name == "TASK_ATTEMPT_FINISHED"
                 and ev.attempt_id == loser}
        registered = [key for key in list(local_shuffle_service()._runs)
                      if loser in key[0]]
        published_after = published()
    finally:
        client.stop()
        lockorder.clear_all()
        reset_store()
    held = device_ops.held_stream_pairs()
    br = process_breaker()
    check(len(held_log) == 1 and held_log[0]["attempt"] == str(loser),
          f"{label}: the held attempts' kills {held_log}")
    at_kill = held_log[0]
    # on the card each span the loser's sorter dispatched launched
    # fnv_hash_lanes once
    check(at_kill["at_hold"] is not None and at_kill["dispatched"] >= 1,
          f"{label}: the loser's sorter at its kill {at_kill}")
    check(final.get(loser) == "KILLED" and not registered
          and published_after == published_at_end,
          f"{label}: the loser ended {final}, registered {registered}, "
          f"store.published {published_at_end} -> {published_after}")
    check(held == held0 and br.state == "closed" and br.trips == 0,
          f"{label}: {held} stream pairs held ({held0} before the DAG), "
          f"breaker {br.state} {br.trips} trips after the loser's teardown")
    log(f"phase {label}: the loser {loser} KILLED after its sorter "
        f"dispatched {at_kill['dispatched']} span(s) on {device} (at the "
        f"kill: {json.dumps({k: v for k, v in at_kill.items() if k != 'attempt'})}); "
        f"its teardown ended {waited:.3f} s after the DAG; stream pairs "
        f"held {held} as before the DAG, the breaker closed, nothing "
        f"registered"
        + ("" if published_after < 0 else
           f", store.published {published_after} before and after"))
    abort_leg(device, sz, totals)


def stream_phase(args, corpus: DagCorpus, device="cuda", **sizes) -> dict:
    """Phase 19 (module docstring) over phase 11's vocabulary and corpus:
    C (the speculative DAG, its loser's abort, the abort with a span in
    flight), then A and B, then A's SLO stream.  Returns {"launches":
    ..., "legs": {leg: wall s}}."""
    from tez_tpu_torch.ops import async_stage
    sz = dict(STREAM_SIZES, **sizes)
    totals: collections.Counter = collections.Counter()
    rng = np.random.default_rng(args.seed + 19)
    root = os.path.join(corpus.root, "stream")
    os.makedirs(root, exist_ok=True)
    async_stage.reset_process_breaker()
    legs = {}

    def timed(leg, run) -> None:
        before = collections.Counter(totals)
        t0 = time.perf_counter()
        run()
        legs[leg] = time.perf_counter() - t0
        log(f"stream {leg}: leg wall_s={legs[leg]:.3f} launches "
            f"{json.dumps(dict(totals - before))}")

    timed("C", lambda: speculation_leg(corpus, root, device, sz, totals))
    timed("A-B", lambda: stream_leg(corpus, root, device, sz, rng, totals))
    timed("A slo", lambda: slo_leg(corpus, root, device, sz, rng))
    log("stream: legs A-C passed")
    return {"launches": dict(totals), "legs": legs}


# ---------------------------------------------------------------------------
# phase 20: the bench harnesses (tez_tpu_torch/tools) and the C++ proxies
# ---------------------------------------------------------------------------
#: phase 20's sizes: tez_tpu's shapes (widths, 4 x 4 tasks, io.sort.mb 48 /
#: 512, a 2M-word Zipf vocabulary at io.sort.mb 64, query skew 0.0 / 1.1,
#: a 30% hot partition), scale cut to fit the script's limit (PERF.md §4);
#: owc_mb: B's proxy over that prefix of phase 11's corpus, one of its
#: marks
BENCH_SIZES = dict(profile_rows=1 << 20, exchange_workers=8, sort_mb=256,
                   owc_mb=MESH_SIZES["mesh_mb"],
                   sort_env={}, spill_mb=128, spill_vocab=SPILL_VOCAB,
                   spill_sort_mb=64, query_scale=None,
                   diff_threshold=0.20)
TINY_BENCH = dict(profile_rows=1 << 12, exchange_workers=8, sort_mb=16,
                  owc_mb=TINY_MESH["mesh_mb"],
                  sort_env={"TEZ_BENCH_SORT_IOSORT_MB": "1",
                            "TEZ_BENCH_SORT_MERGE_MB": "16"},
                  spill_mb=6, spill_vocab=60_000, spill_sort_mb=1,
                  query_scale=1.0,
                  # a rehearsal's millisecond timings on shared CPUs: G
                  # checks the path there, the card run checks the times
                  diff_threshold=0.9)
#: phase 4's run of the PipelinedSorter proxy (phase 20 B reports it)
PROXY_RUNS: dict = {}


def sorter_proxy_check(keys, vals, spans: int, merged) -> dict:
    """bench.py's byte identity (bench.py:808-820): the PipelinedSorter /
    TezMerger proxy over the records (keys uint8[n, w], vals uint8[n, v])
    in `spans` producer spans, its partition counts, key order and values
    those of the port's merged run."""
    from tez_tpu_torch.ops import native
    secs, pk, pv, pc = native.pipelined_sorter_proxy(keys, vals, spans,
                                                     NUM_PARTITIONS)
    check(np.array_equal(pc, np.diff(merged.row_index)),
          "sorter proxy: partition counts diverge from the port's")
    check(np.array_equal(pk.reshape(-1), merged.batch.key_bytes),
          "sorter proxy: key order diverges from the port's")
    check(np.array_equal(pv.reshape(-1), merged.batch.val_bytes),
          "sorter proxy: values diverge from the port's")
    return {"records": int(keys.shape[0]), "spans": spans,
            "proxy_s": secs}


def bench_records(label: str, recs: list) -> None:
    for rec in recs:
        log(f"{label}: {json.dumps(rec)}")


#: repetitions of each profile_kernels leg (the tool's default is 5): G
#: compares two means of host-paced legs, which 5 or 20 reps leave noisy
#: (PERF.md §7)
PROFILE_REPS = 50


def profile_records(rec: dict) -> list:
    """Part A's card legs as bench_diff records: rows a second (higher is
    better), one record a leg.  The plain hash (an elementwise launch a
    key byte) and the host encode are bound by the host's CPU, which the
    parts before share, so G does not gate them (PERF.md §7)."""
    n = rec["rows"]
    return [{"metric": f"profile_kernels {what} ({n} rows on "
                       f"{rec['device']})",
             "value": round(n / rec[key] / 1e6, 3), "unit": "Mrows/s"}
            for key, what in (("hash_kernel_s", "FNV partition, kernel"),
                              ("encode_device_s", "key encode, device"))
            if key in rec]


@contextlib.contextmanager
def scoped_env(**kv):
    """os.environ with `kv` set for the block, then as it was."""
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bench_phase(args, corpus: DagCorpus, phase11: dict, device="cuda",
                **sizes) -> dict:
    """Phase 20 (module docstring): A profile_kernels, B the OrderedWordCount
    proxy over phase 11's corpus (and phase 4's PipelinedSorter proxy), C
    bench_exchange, D bench_sort, E spill_bench.run, F bench_query with the
    replan and doctor, G bench_diff over two runs of A.  Returns
    {"launches": ..., "legs": {part: wall s}}."""
    import torch

    from tez_tpu_torch.ops import async_stage, native
    from tez_tpu_torch.store import reset_store
    from tez_tpu_torch.tools import (bench_diff, exchange_bench,
                                     profile_kernels, query_bench,
                                     sort_bench, spill_bench)
    sz = dict(BENCH_SIZES, **sizes)
    totals: collections.Counter = collections.Counter()
    root = os.path.join(corpus.root, "bench")
    os.makedirs(root, exist_ok=True)
    async_stage.reset_process_breaker()
    legs, parts = {}, {}

    def part(name, run, *kernels):
        """One part: its launches zeroed before and read after, each of
        `kernels` required above zero on the card."""
        t0 = time.perf_counter()
        with Launches(f"bench {name}", totals) as ln:
            out = run()
            sync(device)
        legs[name] = time.perf_counter() - t0
        ln.require(device, *kernels)
        parts[name] = dict(ln.counts)
        log(f"bench {name}: wall_s={legs[name]:.3f}")
        return out

    # A: the plain FNV version against the kernel through hash_partition,
    # the host encode and its upload against the device encode
    def profile():
        return profile_kernels.profile(sz["profile_rows"], device=device,
                                       reps=PROFILE_REPS)
    runs_a = [part("A", profile, "fnv_hash_bytes")]
    log(f"bench A: {json.dumps(runs_a[0])}")
    # G: bench_diff between A's records and a second run of A, back to
    # back (a later run would meet the host's writeback of D and E)
    runs_a.append(part("G", profile, "fnv_hash_bytes"))
    log(f"bench G: {json.dumps(runs_a[1])}")
    paths = []
    for i, run in enumerate(runs_a):
        recs = profile_records(run)
        paths.append(os.path.join(root, f"profile_{i}.jsonl"))
        with open(paths[-1], "w") as fh:
            fh.write("".join(json.dumps(r) + "\n" for r in recs))
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_diff.main(paths + ["--threshold",
                                      str(sz["diff_threshold"])])
    legs["G"] += time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(f"bench G: {line}")
    check(rc == 0, f"bench G: bench_diff exited {rc}")

    # B: the OrderedWordCount proxy over the first owc_mb MiB of phase 11's
    # corpus, its counts the golden's; the sorter proxy ran in phase 4 over
    # its records
    owc_path, owc_bytes, owc_golden = corpus.slice_file(
        "owc_bench.txt", 0, sz["owc_mb"])

    def owc():
        secs, counts = native.owc_proxy_counts(owc_path, 4, 4)
        drawn = np.flatnonzero(owc_golden)
        want = dict(zip((w.decode() for w in word_bytes(
            corpus.mat, corpus.lens, drawn)), owc_golden[drawn].tolist()))
        check(counts == want, f"bench B: owc_proxy_counts differs from "
                              f"phase 11's golden ({len(counts)} words "
                              f"against {len(want)})")
        return secs
    proxy_s = part("B", owc)
    wall_a = phase11.get("A", {}).get("wall")
    # seconds a byte, the proxy's over 11 A's (over the whole corpus)
    ratio = proxy_s / owc_bytes / (wall_a / corpus.nbytes) if wall_a \
        else float("nan")
    log(f"bench B: owc proxy {proxy_s:.3f} s over {owc_bytes} bytes, "
        f"equal to the golden; phase 11 A {wall_a if wall_a else 'n/a'} s "
        f"over {corpus.nbytes} bytes; proxy s a byte / 11 A's s a byte "
        f"{ratio:.3f}; sorter proxy (phase 4) "
        f"{json.dumps(PROXY_RUNS.get('sorter'))}")

    # C: the four exchange legs on a mesh of logical workers of the device;
    # the coordinator routes on the host, so no kernel launch is required
    mesh = ["cuda:0" if is_cuda(device) else "cpu"] * sz["exchange_workers"]
    recs = part("C", lambda: exchange_bench.bench_exchange(
        device=device, mesh=mesh))
    bench_records("bench C", recs)
    check(len(recs) == 4 and all(r["value"] > 0 for r in recs),
          "bench C: an exchange leg is missing")
    log(f"bench C: skew-aware {recs[-1]['vs_baseline']} x padded-maxcap "
        f"(tez_tpu's floor {recs[-1]['min_vs_baseline']} x, "
        f"bench_diff's ratio gate)")

    # D: push against pull through the port's client, AM, store and push
    def sort():
        with scoped_env(TEZ_BENCH_SORT_MB=str(sz["sort_mb"]),
                        **sz["sort_env"]):
            reset_store()
            try:
                return sort_bench.bench_sort(device=device)
            finally:
                reset_store()
    rec = part("D", sort, "fnv_hash_lanes", "merge_path_pair")
    bench_records("bench D", [rec])

    # E: the spill benchmark's DAG, verified against its golden and proxy
    rec = part("E", lambda: spill_bench.run(
        sz["spill_mb"], sz["spill_vocab"], sz["spill_sort_mb"], "auto", 4,
        device=device), "fnv_hash_lanes", "merge_path_pair")
    bench_records("bench E", [rec])
    c = rec["counters"]
    check(c.get("SPILLED_RECORDS", 0) > 0 and
          c.get("ADDITIONAL_SPILLS_BYTES_WRITTEN", 0) > 0,
          f"bench E: the spill benchmark did not spill ({c})")

    # F: the strategy legs and the replan, doctor rendering it; the
    # sorter's device floor at one record, so the queries' edges launch
    def query():
        reset_store()
        try:
            return query_bench.bench_query(device=device, conf=FLOOR_CONF,
                                           scale=sz["query_scale"])
        finally:
            reset_store()
    recs = part("F", query, "fnv_hash_lanes", "merge_path_pair")
    bench_records("bench F", recs)
    check("QUERY_REPLANNED" in recs[-1]["metric"],
          "bench F: the replan leg did not journal QUERY_REPLANNED")

    if is_cuda(device):
        log(f"bench: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    log(f"bench: launches by part {json.dumps(parts)}")
    log("bench: parts A-G passed")
    return {"launches": dict(totals), "legs": legs}


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
    ap.add_argument("--producers", type=int, default=2)
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
    from tez_tpu_torch.ops import device as device_ops
    held_start = device_ops.held_stream_pairs()
    host = _build.build_host()
    log(f"build: {host['seconds']:.3f} s for the host library "
        f"{os.path.basename(host['path'])} (g++)")
    nproc = os.cpu_count()
    log(f"host: {nproc} CPUs (nproc), {cpu_model()}")
    rows = kernel_phase(args.seed, memory_tb_s(name), args.tile_sweep)
    t0 = time.perf_counter()
    native_rows = native_phase(args)
    log(f"host library: {time.perf_counter() - t0:.3f} s")
    native_calls = {}

    def phase_native(phase: str) -> str:
        """Take the phase's host-library calls out of NATIVE_TOTALS."""
        native_calls[phase] = dict(NATIVE_TOTALS)
        NATIVE_TOTALS.clear()
        return json.dumps(native_calls[phase])

    NATIVE_TOTALS.clear()
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
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, host "
        f"library {phase_native('slice')}")
    t0 = time.perf_counter()
    fault_launches = containment_phase(args)
    log(f"containment: {time.perf_counter() - t0:.3f} s, launches "
        f"{json.dumps(fault_launches)}, host library "
        f"{phase_native('containment')}")
    t0 = time.perf_counter()
    spill_launches = spill_phase(args)
    log(f"spill: {time.perf_counter() - t0:.3f} s, launches "
        f"{json.dumps(spill_launches)}, host library "
        f"{phase_native('spill')}")
    t0 = time.perf_counter()
    log(f"merge phase on {card}")
    merge_launches = merge_phase(args)
    log(f"merge: {time.perf_counter() - t0:.3f} s, launches "
        f"{json.dumps(merge_launches)}, host library "
        f"{phase_native('merge')}")
    t0 = time.perf_counter()
    log(f"task phase on {card}")
    task_launches = task_phase(args)
    log(f"tasks: {time.perf_counter() - t0:.3f} s, launches "
        f"{json.dumps(task_launches)}, host library "
        f"{phase_native('tasks')}")
    t0 = time.perf_counter()
    log(f"dag phase on {card}")
    with tempfile.TemporaryDirectory(prefix="tez_dag_") as dag_root:
        # phases 11-13, 15 and 18 run over one corpus
        sz = UNORDERED_SIZES
        corpus = DagCorpus(dag_root, args, marks_mb=(
            sz["a_mb"], sz["b_mb"], sz["c_mb"], 2 * sz["c_mb"],
            3 * sz["c_mb"], MESH_SIZES["mesh_mb"], QUERY_SIZES["smj_mb"],
            2 * QUERY_SIZES["smj_mb"]))
        phase11: dict = {}
        dag_launches = dag_phase(args, corpus=corpus, legs_out=phase11)
        log(f"dag: {time.perf_counter() - t0:.3f} s, launches "
            f"{json.dumps(dag_launches)}, host library "
            f"{phase_native('dag')}")
        t0 = time.perf_counter()
        log(f"remote phase on {card}")
        remote_launches = remote_phase(args, corpus, phase11)
        log(f"remote: {time.perf_counter() - t0:.3f} s, launches "
            f"{json.dumps(remote_launches)}, host library "
            f"{phase_native('remote')}")
        t0 = time.perf_counter()
        log(f"unordered phase on {card}")
        unordered = unordered_phase(args, corpus=corpus)
        log(f"unordered: {time.perf_counter() - t0:.3f} s, launches "
            f"{json.dumps(unordered['launches'])}, host library "
            f"{phase_native('unordered')}")
        t0 = time.perf_counter()
        log(f"mrr phase on {card}")
        mrr = mrr_phase(args)
        log(f"mrr: {time.perf_counter() - t0:.3f} s, launches "
            f"{json.dumps(mrr['launches'])}, host library "
            f"{phase_native('mrr')}")
        t0 = time.perf_counter()
        log(f"mesh phase on {card}")
        mesh = mesh_phase(args, corpus=corpus)
        log(f"mesh: {time.perf_counter() - t0:.3f} s, launches "
            f"{json.dumps(mesh['launches'])}, host library "
            f"{phase_native('mesh')}")
        t0 = time.perf_counter()
        log(f"store phase on {card}")
        store_launches = store_phase(args, corpus, mesh["host_part"])
        log(f"store: {time.perf_counter() - t0:.3f} s, launches "
            f"{json.dumps(store_launches)}, host library "
            f"{phase_native('store')}")
        t0 = time.perf_counter()
        log(f"standalone phase on {card}")
        standalone_launches = standalone_phase(args, corpus,
                                               mesh["host_part"])
        log(f"standalone: {time.perf_counter() - t0:.3f} s, launches "
            f"{json.dumps(standalone_launches)}, host library "
            f"{phase_native('standalone')}")
        t0 = time.perf_counter()
        log(f"query phase on {card}")
        query = query_phase(args, corpus=corpus)
        log(f"query: {time.perf_counter() - t0:.3f} s, launches "
            f"{json.dumps(query['launches'])}, legs s "
            f"{json.dumps({k: round(v, 3) for k, v in query['legs'].items()})}"
            f", host library {phase_native('query')}")
        held = device_ops.held_stream_pairs()
        log(f"stream pairs held: {held} after phases 1-18, {held_start} "
            f"before phase 1")
        check(held == held_start, f"{held - held_start} stream pairs are "
                                  f"still held after phases 1-18")
        t0 = time.perf_counter()
        log(f"stream phase on {card}")
        stream = stream_phase(args, corpus)
        log(f"stream: {time.perf_counter() - t0:.3f} s, launches "
            f"{json.dumps(stream['launches'])}, legs s "
            f"{json.dumps({k: round(v, 3) for k, v in stream['legs'].items()})}"
            f", host library {phase_native('stream')}")
        t0 = time.perf_counter()
        log(f"bench phase on {card}")
        bench = bench_phase(args, corpus, phase11)
        log(f"bench: {time.perf_counter() - t0:.3f} s, launches "
            f"{json.dumps(bench['launches'])}, parts s "
            f"{json.dumps({k: round(v, 3) for k, v in bench['legs'].items()})}"
            f", host library {phase_native('bench')}")
    launches = collections.Counter(launches)
    launches.update(spill_launches)
    launches.update(merge_launches)
    launches.update(task_launches)
    launches.update(dag_launches)
    launches.update(remote_launches)
    for later in (unordered, mrr, mesh, query, stream, bench):
        launches.update(later["launches"])
    launches.update(store_launches)
    launches.update(standalone_launches)
    for kname, row in rows.items():
        row["launches"] = launches[kname]
    for tpu_kernel, where, names in MAIN_PATH_COUNTERPARTS:
        for kname in names:
            log(f"launch check: {tpu_kernel} ({where}) -> {kname}: "
                f"{launches[kname]} launches on the slice, the spill "
                f"path, the merge legs, the tasks, the DAG, its runner "
                f"processes, the unordered edge, MRR, the mesh DAGs, "
                f"the store and push DAGs, the standalone AM's pods and "
                f"recovered AM, the query phase's joins, corpus "
                f"queries and custom edges, the streams and the "
                f"speculative DAG, and the bench harnesses")
            check(launches[kname] > 0, f"{kname} was never launched on the "
                                       f"slice's main path")
    log(f"launch check: merge_rank (merge_rank_pallas's general-query "
        f"counterpart, held in phase 2): {launches['merge_rank']} launches "
        f"on the slice, the spill path, the merge legs, the tasks, the DAG, "
        f"its runner processes, the unordered edge, MRR, the mesh DAGs, "
        f"the store and push DAGs, the standalone AM's pods and "
        f"recovered AM, the query phase's joins, corpus queries and "
        f"custom edges, the streams and the speculative DAG, and the "
        f"bench harnesses")
    check(launches["merge_rank"] == 0, "the slice launched merge_rank; its "
                                       "merges should run merge_path_pair")
    log(card)
    log(json.dumps({"native": {"nproc": nproc, "cpu": cpu_model(),
                               "calls": native_calls,
                               "bindings": native_rows}}))
    log(json.dumps({"kernels": list(rows.values())}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
