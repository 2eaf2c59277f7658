"""The port's async span plane (tez_tpu_torch/ops/async_stage.py,
DeviceSpanScheduler, DeviceSorter's pipeline_depth > 0) on the CPU.

Every case of tests/test_async_pipeline.py runs here against the port's
modules: the scheduler's contract is asserted against a fake clock and
thread events, never wall time.  Beside them, parity with tez_tpu on
seeded inputs, bit-exact: the async DeviceSorter's flushed Run and
counters, DeviceSpanScheduler's results, and the precombine's
hash_sum_native.  Waits are bounded (fake clocks, short watchdogs, joins
with timeouts), so no case can hang the run.
"""
import threading
import time

import numpy as np
import pytest
import torch

from tez_tpu_torch.common import faults
from tez_tpu_torch.common.counters import TaskCounter, TezCounters
from tez_tpu_torch.common.faults import parse_spec
from tez_tpu_torch.ops.async_stage import (COUNTER_GROUP, AsyncSpanPipeline,
                                           CircuitBreaker, overlap_pairs,
                                           reset_process_breaker)


@pytest.fixture(autouse=True)
def _isolated_planes():
    """tests/conftest.py resets tez_tpu's breaker only: reset the port's
    process breaker and fault plane around every case."""
    reset_process_breaker()
    faults.clear_all()
    yield
    faults.clear_all()
    reset_process_breaker()


class LogicalClock:
    """Thread-safe monotone counter: every _mark gets a unique tick, so
    event ordering is exact and wall-time free."""

    def __init__(self):
        self._t = 0
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            self._t += 1
            return self._t


class SettableClock:
    """Manually advanced fake clock: watchdog deadlines are compared on the
    pipeline's injectable clock, so a test blows a deadline by advancing
    it, never by sleeping it out."""

    def __init__(self):
        self._t = 0.0
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            return self._t

    def advance(self, dt):
        with self._lock:
            self._t += dt


# -- the scheduler ------------------------------------------------------------
def test_overlap_witness_fake_clock():
    """span 1's encode must start while span 0 is still in flight: span 0's
    readback is held on an event that only span 1's encode sets."""
    span1_encoding = threading.Event()

    def encode(p):
        if p == 1:
            span1_encoding.set()
        return p

    def readback(inflight, ids):
        if ids == (0,):
            assert span1_encoding.wait(timeout=10.0), \
                "span 1 never started encoding while span 0 was in flight"
        return inflight

    pipe = AsyncSpanPipeline(
        dispatch_fn=lambda s: s, readback_fn=readback, encode_fn=encode,
        depth=2, readback_workers=2, clock=LogicalClock(), instrument=True)
    for i in range(3):
        pipe.submit(i, i)
    res = pipe.drain()
    assert res == {0: 0, 1: 1, 2: 2}
    pairs = overlap_pairs(pipe.events)
    assert ((0,), (1,)) in pairs, f"no overlap witnessed: {pipe.events}"
    assert pipe.stats.max_in_flight <= 2


def test_depth_bound_never_exceeded():
    """depth=1 serializes groups: in-flight never exceeds the bound and no
    encode starts while an earlier group is in flight."""
    release = threading.Event()
    seen = []

    def readback(inflight, ids):
        seen.append(ids)
        if len(seen) == 1:
            release.wait(timeout=10.0)
        return inflight

    pipe = AsyncSpanPipeline(
        dispatch_fn=lambda s: s, readback_fn=readback,
        depth=1, readback_workers=2, clock=LogicalClock(), instrument=True)
    for i in range(4):
        pipe.submit(i, i)
    release.set()
    pipe.drain()
    assert pipe.stats.max_in_flight == 1
    assert overlap_pairs(pipe.events) == []   # depth=1: no overlap possible


def test_paused_coalesce_deterministic():
    dispatched = []

    def dispatch(staged):
        dispatched.append(staged)
        return staged

    pipe = AsyncSpanPipeline(
        dispatch_fn=dispatch, readback_fn=lambda s, ids: sum(s),
        coalesce_fn=lambda staged: [x for s in staged for x in s],
        records_fn=len, coalesce_records=100, paused=True)
    for i in range(4):
        pipe.submit(i, [i] * 10, coalesce=True)
    pipe.resume()
    res = pipe.drain()
    assert len(dispatched) == 1          # every span in ONE dispatch
    assert pipe.stats.coalesced_groups == 1
    assert res == {i: sum([0] * 10 + [1] * 10 + [2] * 10 + [3] * 10)
                   for i in range(4)}


def test_coalesce_budget_respected():
    pipe = AsyncSpanPipeline(
        dispatch_fn=lambda s: s, readback_fn=lambda s, ids: len(ids),
        coalesce_fn=lambda staged: staged, records_fn=len,
        coalesce_records=20, paused=True)
    for i in range(4):
        pipe.submit(i, [i] * 10, coalesce=True)
    pipe.resume()
    pipe.drain()
    assert pipe.stats.dispatched == 2    # 4 x 10 records under a 20 budget
    assert pipe.stats.coalesced_groups == 2


def test_stage_error_propagates_and_poisons():
    def dispatch(staged):
        raise ValueError("boom at dispatch")

    pipe = AsyncSpanPipeline(dispatch_fn=dispatch,
                             readback_fn=lambda s, ids: s)
    pipe.submit(0, 0)
    with pytest.raises(ValueError, match="boom at dispatch"):
        pipe.drain()
    with pytest.raises(RuntimeError, match="pipeline failed"):
        pipe.submit(1, 1)


# -- the device span scheduler -------------------------------------------------
def _mk_ragged(n, key_len, seed):
    rng = np.random.default_rng(seed)
    kb = rng.integers(0, 256, n * key_len, dtype=np.int64).astype(np.uint8)
    ko = np.arange(n + 1, dtype=np.int64) * key_len
    vb = rng.integers(0, 256, n * 8, dtype=np.int64).astype(np.uint8)
    return kb, ko, vb


def test_scheduler_matches_sync_kernel():
    """submit_ragged through the async plane == the sync device_shuffle_sort
    over the concatenated spans (stable concat-sort == merge of span sorts)."""
    from tez_tpu_torch.ops.device_pipeline import (DeviceSpanScheduler,
                                                   device_shuffle_sort)
    from tez_tpu_torch.ops.keycodec import matrix_to_lanes, pad_to_matrix
    key_len, nspans, per = 8, 3, 400
    spans = [_mk_ragged(per, key_len, s) for s in range(nspans)]
    sched = DeviceSpanScheduler(num_partitions=3, key_width=key_len,
                                coalesce_records=nspans * per,
                                paused=True, device="cpu")
    for sid, (kb, ko, vb) in enumerate(spans):
        sched.submit_ragged(sid, kb, ko, vb, 8)
    sched.resume()
    res = sched.results()
    assert all(res[i] is res[0] for i in range(nspans))
    sp_a, lanes_a, vals_a, perm_a, counts_a, n_a = res[0]

    kb = np.concatenate([s[0] for s in spans])
    ko = np.arange(nspans * per + 1, dtype=np.int64) * key_len
    vb = np.concatenate([s[2] for s in spans])
    n = nspans * per
    mat, lengths = pad_to_matrix(kb, ko, key_len)
    lanes = matrix_to_lanes(mat)
    hash_w = 1 << max(2, (key_len - 1).bit_length())
    hmat, hlens = pad_to_matrix(kb, ko, hash_w)
    vals = np.ascontiguousarray(vb.reshape(n, 8)).view(np.uint32)
    out = device_shuffle_sort(lanes, lengths.astype(np.int64), vals, hmat,
                              hlens.astype(np.int32), 3, device="cpu")
    sp_s, lanes_s, vals_s, perm_s, counts_s = [x.numpy() for x in out]
    assert n_a == n
    np.testing.assert_array_equal(counts_a, counts_s)
    np.testing.assert_array_equal(perm_a[:n], perm_s[:n])
    np.testing.assert_array_equal(lanes_a[:n], lanes_s[:n].view(np.uint32))
    np.testing.assert_array_equal(vals_a[:n], vals_s[:n].view(np.uint32))


def test_same_bucket_spans_share_one_staged_shape():
    """Span sizes inside one padding bucket stage and dispatch at ONE shape
    (tez_tpu: one compiled program; here: one kernel configuration and one
    pinned slot size), and each result still equals the sync pipeline."""
    from tez_tpu_torch.ops.device_pipeline import DeviceSpanScheduler
    key_len = 8
    shapes = set()

    def run(n, seed):
        kb, ko, vb = _mk_ragged(n, key_len, seed)
        sched = DeviceSpanScheduler(num_partitions=2, key_width=key_len,
                                    device="cpu")
        dispatch = sched._dispatch

        def spy(s):
            shapes.add(tuple(tuple(t.shape) for t in s["tensors"]))
            return dispatch(s)

        sched.pipeline._dispatch_fn = spy
        sched.submit_ragged(0, kb, ko, vb, 8)
        res = sched.results()[0]
        assert res[5] == n and res[0].shape[0] == 1024
        assert res[4].sum() == n
        return res

    for i, n in enumerate((600, 520, 700, 1000, 1024)):  # one bucket: 1024
        run(n, i)
    assert len(shapes) == 1, shapes


def _mk_batch(n, seed):
    from tez_tpu_torch.ops.runformat import KVBatch
    rng = np.random.default_rng(seed)
    keys = [b"k%08d" % i for i in rng.integers(0, 500, n)]
    vals = [b"v%06d" % i for i in rng.integers(0, 999999, n)]
    kb = np.frombuffer(b"".join(keys), dtype=np.uint8)
    ko = np.cumsum([0] + [len(k) for k in keys]).astype(np.int64)
    vb = np.frombuffer(b"".join(vals), dtype=np.uint8)
    vo = np.cumsum([0] + [len(v) for v in vals]).astype(np.int64)
    return KVBatch(kb, ko, vb, vo)


def _spill_sorter(depth):
    from tez_tpu_torch.ops.sorter import DeviceSorter
    spills = {}
    s = DeviceSorter(num_partitions=4, engine="device",
                     device_min_records=0, key_width=16,
                     span_budget_bytes=20_000, pipeline_depth=depth,
                     device="cpu")
    s.on_spill = lambda run, sid: spills.update(
        {sid: (run.batch.key_bytes.tobytes(), run.batch.val_bytes.tobytes(),
               run.row_index.tobytes())})
    return s, spills


def test_out_of_order_completion_spills_bit_exact():
    """device.dispatch.delay holds span 0's completion while later spans
    drain past it: completion is out of order, yet every spill carries its
    correct spill id and payload, bit-exact vs the fault-free sync engine."""
    sync, sync_spills = _spill_sorter(depth=0)
    for i in range(4):
        sync.write_batch(_mk_batch(1000, i))
    assert sync.flush_run() is None
    assert sorted(sync_spills) == [0, 1, 2, 3]

    faults.install("t", parse_spec(
        "device.dispatch.delay:delay:ms=400,n=1,match=span=0"))
    try:
        apipe, aspills = _spill_sorter(depth=2)
        for i in range(4):
            apipe.write_batch(_mk_batch(1000, i))
        assert apipe.flush_run() is None
        # on_spill fires in completion order; dict insertion order keeps it
        order = list(aspills)
    finally:
        faults.install("t", [])
    assert order[-1] == 0, f"span 0 was not delayed past the rest: {order}"
    assert aspills == sync_spills


def test_flush_reassembles_async_runs_in_spill_order():
    """Non-pipelined flush: runs complete out of order under the delay
    fault but the final merged output is bit-exact vs the sync engine."""
    from tez_tpu_torch.ops.sorter import DeviceSorter

    def flush(depth, with_fault):
        if with_fault:
            faults.install("t", parse_spec(
                "device.dispatch.delay:delay:ms=400,n=1,match=span=0"))
        try:
            s = DeviceSorter(num_partitions=4, engine="device",
                             device_min_records=0, key_width=16,
                             span_budget_bytes=20_000, pipeline_depth=depth,
                             pipeline_coalesce_records=0, device="cpu")
            for i in range(4):
                s.write_batch(_mk_batch(1000, i))
            r = s.flush_run()
        finally:
            if with_fault:
                faults.install("t", [])
        return (r.batch.key_bytes.tobytes(), r.batch.val_bytes.tobytes(),
                r.row_index.tobytes())

    assert flush(2, True) == flush(0, False)


# -- failure containment: watchdog / failover / breaker / OOM ladder ----------
def test_failover_on_device_exception():
    """A device exception mid-dispatch re-routes JUST that group through
    failover_fn; the other spans stay on the device path and the pipeline
    never poisons."""
    def dispatch(staged):
        if staged == 1:
            raise ValueError("chip fault on span 1")
        return staged

    counters = TezCounters()
    pipe = AsyncSpanPipeline(
        dispatch_fn=dispatch, readback_fn=lambda s, ids: ("device", s),
        failover_fn=lambda ids, payloads: ("host", payloads[0]),
        breaker=CircuitBreaker(failures=100), counters=counters)
    for i in range(3):
        pipe.submit(i, i)
    res = pipe.drain()
    assert res == {0: ("device", 0), 1: ("host", 1), 2: ("device", 2)}
    assert pipe.stats.failovers == 1
    fo = counters.group(COUNTER_GROUP)
    assert fo.find_counter("device.failover.spans").value == 1
    assert fo.find_counter("device.failover.groups").value == 1


def test_watchdog_abandons_hung_readback_fake_clock():
    """A readback that never returns: the watchdog (deadline on the FAKE
    clock) abandons the attempt, fails the span over, and drain() returns
    in bounded wall time with every result present."""
    clock = SettableClock()
    hang = threading.Event()
    in_hang = threading.Event()
    failed_over = threading.Event()

    def readback(inflight, ids):
        if ids == (0,):
            in_hang.set()
            hang.wait(timeout=30.0)   # a hung D2H nobody will release
        return ("device", inflight)

    def failover(ids, payloads):
        failed_over.set()
        return ("host", payloads[0])

    pipe = AsyncSpanPipeline(
        dispatch_fn=lambda s: s, readback_fn=readback,
        failover_fn=failover, breaker=CircuitBreaker(failures=100),
        clock=clock, watchdog_readback_ms=1000)
    t_wall = time.monotonic()
    pipe.submit(0, 0)
    assert in_hang.wait(timeout=10.0)
    clock.advance(2.0)                # blow the 1000ms readback deadline
    assert failed_over.wait(timeout=10.0), "watchdog never fired"
    pipe.submit(1, 1)
    pipe.submit(2, 2)
    res = pipe.drain()
    wall = time.monotonic() - t_wall
    try:
        assert res == {0: ("host", 0), 1: ("device", 1), 2: ("device", 2)}
        assert pipe.stats.watchdog_fires == 1
        assert wall < 15.0, f"flush() not bounded by the watchdog: {wall:.1f}s"
    finally:
        hang.set()                    # release the abandoned daemon worker


def test_watchdog_abandons_hung_dispatch_and_drains_pending():
    """A dispatch that never returns wedges the staging thread itself: the
    watchdog must claim the hung group AND take over the queue, draining
    every not-yet-staged span through failover; drain() stays bounded."""
    clock = SettableClock()
    hang = threading.Event()
    in_hang = threading.Event()

    def dispatch(staged):
        if staged == 0:
            in_hang.set()
            hang.wait(timeout=30.0)   # staging thread stuck in a dispatch
        return staged

    counters = TezCounters()
    pipe = AsyncSpanPipeline(
        dispatch_fn=dispatch, readback_fn=lambda s, ids: ("device", s),
        failover_fn=lambda ids, payloads: ("host", payloads[0]),
        breaker=CircuitBreaker(failures=100), counters=counters,
        clock=clock, watchdog_dispatch_ms=1000, paused=True)
    t_wall = time.monotonic()
    for i in range(4):
        pipe.submit(i, i)
    pipe.resume()
    assert in_hang.wait(timeout=10.0)
    clock.advance(2.0)                # blow the 1000ms dispatch deadline
    res = pipe.drain()
    wall = time.monotonic() - t_wall
    try:
        assert res == {i: ("host", i) for i in range(4)}
        assert pipe.stats.watchdog_fires == 1
        fo = counters.group(COUNTER_GROUP)
        assert fo.find_counter("device.watchdog.dispatch_fires").value == 1
        assert fo.find_counter("device.failover.drained").value == 3
        assert wall < 15.0, f"flush() not bounded when wedged: {wall:.1f}s"
    finally:
        hang.set()                    # release the abandoned staging thread


def test_breaker_trips_and_half_open_recovers_fake_clock():
    from tez_tpu_torch.common import metrics
    clock = SettableClock()
    br = CircuitBreaker(failures=2, cooldown_ms=1000, clock=clock)
    assert br.allow_device() and br.state == "closed"
    br.record_failure()
    assert br.state == "closed"       # below the consecutive threshold
    br.record_failure()
    assert br.state == "open" and br.trips == 1
    assert metrics.registry().gauges()["device.breaker.state"] == 2.0
    assert not br.allow_device()      # cooldown not elapsed
    clock.advance(1.1)
    assert br.allow_device()          # the half-open probe slot
    assert br.state == "half-open"
    assert not br.allow_device()      # only ONE probe at a time
    br.record_success()
    assert br.state == "closed" and br.recoveries == 1
    # a probe FAILURE re-opens immediately for another full cooldown
    br.record_failure()
    br.record_failure()
    assert br.state == "open" and br.trips == 2
    clock.advance(1.1)
    assert br.allow_device()
    br.record_failure()
    assert br.state == "open" and br.trips == 3
    assert not br.allow_device()


def test_breaker_open_short_circuits_before_device():
    """With the breaker open every group routes straight to the host
    engine: the dispatch fn (the card) is never touched."""
    br = CircuitBreaker(failures=1, cooldown_ms=10_000,
                        clock=SettableClock())
    br.record_failure()               # open; fake clock never elapses it
    dispatched = []
    counters = TezCounters()
    pipe = AsyncSpanPipeline(
        dispatch_fn=lambda s: dispatched.append(s) or s,
        readback_fn=lambda s, ids: ("device", s),
        failover_fn=lambda ids, payloads: ("host", payloads[0]),
        breaker=br, counters=counters)
    for i in range(3):
        pipe.submit(i, i)
    res = pipe.drain()
    assert dispatched == []
    assert res == {i: ("host", i) for i in range(3)}
    assert counters.group(COUNTER_GROUP).find_counter(
        "device.breaker.short_circuits").value == 3


def test_oom_split_retry_before_host_failover():
    """Out of memory takes the split ladder FIRST: oom_retry_fn's
    (on-device) result completes the group, failover_fn is never called,
    and the split success re-arms the breaker.  A torch OutOfMemoryError
    is classified like tez_tpu's RESOURCE_EXHAUSTED."""
    failover_calls = []

    def dispatch(staged):
        if staged == 0:
            raise MemoryError("RESOURCE_EXHAUSTED: span too large")
        if staged == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return staged

    br = CircuitBreaker(failures=3)
    counters = TezCounters()
    pipe = AsyncSpanPipeline(
        dispatch_fn=dispatch, readback_fn=lambda s, ids: ("device", s),
        failover_fn=lambda ids, payloads:
            failover_calls.append(ids) or ("host", payloads[0]),
        oom_retry_fn=lambda ids, payloads: ("split", payloads[0]),
        breaker=br, counters=counters)
    for i in range(3):
        pipe.submit(i, i)
    res = pipe.drain()
    assert res == {0: ("split", 0), 1: ("device", 1), 2: ("split", 2)}
    assert failover_calls == []       # the ladder stopped on-device
    assert pipe.stats.oom_splits == 2
    fo = counters.group(COUNTER_GROUP)
    assert fo.find_counter("device.oom.split_attempts").value == 2
    assert fo.find_counter("device.oom.split_success").value == 2
    assert br.state == "closed" and br.trips == 0


def test_oom_split_floor_falls_back_to_host():
    """When the split retry declines (floor reached: it raises), the
    group continues down the ladder to host failover."""
    def retry(ids, payloads):
        raise MemoryError("split floor reached")

    counters = TezCounters()
    pipe = AsyncSpanPipeline(
        dispatch_fn=lambda s: (_ for _ in ()).throw(
            MemoryError("RESOURCE_EXHAUSTED")),
        readback_fn=lambda s, ids: s,
        failover_fn=lambda ids, payloads: ("host", payloads[0]),
        oom_retry_fn=retry, breaker=CircuitBreaker(failures=100),
        counters=counters)
    pipe.submit(0, 0)
    res = pipe.drain()
    assert res == {0: ("host", 0)}
    fo = counters.group(COUNTER_GROUP)
    assert fo.find_counter("device.oom.split_attempts").value == 1
    assert fo.find_counter("device.oom.split_success").value == 0
    assert fo.find_counter("device.failover.spans").value == 1


def _flush_merged(depth, spec, **sorter_kw):
    """flush_run() a 4-span DeviceSorter under an optional fault spec;
    returns (merged-run bytes, counters)."""
    from tez_tpu_torch.ops.sorter import DeviceSorter
    if spec:
        faults.install("t", parse_spec(spec))
    try:
        s = DeviceSorter(num_partitions=4, engine="device",
                         device_min_records=0, key_width=16,
                         span_budget_bytes=20_000, pipeline_depth=depth,
                         pipeline_coalesce_records=0, device="cpu",
                         **sorter_kw)
        for i in range(4):
            s.write_batch(_mk_batch(1000, i))
        r = s.flush_run()
    finally:
        if spec:
            faults.install("t", [])
    return (r.batch.key_bytes.tobytes(), r.batch.val_bytes.tobytes(),
            r.row_index.tobytes()), s.counters


def test_sorter_oom_split_on_device_bit_exact():
    """One injected out-of-memory dispatch (budget n=1): the span retries
    split in half on the device (the budget is spent, so the halves sort
    clean), the stable split-merge is bit-exact vs the fault-free sync
    engine, and host failover is never taken."""
    base, _ = _flush_merged(0, "")
    br = CircuitBreaker(failures=100)
    got, counters = _flush_merged(
        2, "device.dispatch.oom:fail:n=1,exc=runtime,match=span=0",
        split_min_bytes=1_000, breaker=br)
    assert got == base
    fo = counters.group(COUNTER_GROUP)
    assert fo.find_counter("device.oom.split_attempts").value == 1
    assert fo.find_counter("device.oom.split_success").value == 1
    assert fo.find_counter("device.failover.spans").value == 0
    assert br.trips == 0


def test_sorter_readback_failure_fails_over_bit_exact():
    """An injected readback crash re-sorts that span through the host
    engine; the merged flush stays bit-exact vs the sync engine."""
    base, _ = _flush_merged(0, "")
    br = CircuitBreaker(failures=100)
    got, counters = _flush_merged(
        2, "device.readback.fail:fail:n=1,exc=io,match=span=0", breaker=br)
    assert got == base
    fo = counters.group(COUNTER_GROUP)
    assert fo.find_counter("device.failover.spans").value == 1
    assert br.trips == 0


# -- broken kernels are never contained --------------------------------------
_ILLEGAL_ADDRESS = "CUDA error: an illegal memory access was encountered"


@pytest.mark.parametrize("stage, exc", [
    ("dispatch", "launch"), ("dispatch", "build"), ("readback", "cuda")])
def test_kernel_fault_poisons_instead_of_failing_over(stage, exc):
    """A broken kernel (build, load or launch) or a CUDA error that is not
    out-of-memory fails drain() with that very error even with a failover
    hook, which would hide it: no failover, and the breaker sees no
    failure."""
    from tez_tpu_torch.ops.kernels import KernelError
    err = {"launch": KernelError("tez_fnv_hash_lanes launch failed: "
                                 "cudaError 98"),
           "build": KernelError("kernel build failed: nvcc exited 1"),
           "cuda": RuntimeError(_ILLEGAL_ADDRESS)}[exc]

    def dispatch(staged):
        if stage == "dispatch" and staged == 1:
            raise err
        return staged

    def readback(inflight, ids):
        if stage == "readback" and inflight == 1:
            raise err
        return ("device", inflight)

    failed_over = []
    br = CircuitBreaker(failures=100)
    pipe = AsyncSpanPipeline(
        dispatch_fn=dispatch, readback_fn=readback,
        failover_fn=lambda ids, p: failed_over.append(ids) or ("host", p[0]),
        breaker=br, counters=TezCounters())
    for i in range(3):
        pipe.submit(i, i)
    with pytest.raises(type(err)) as info:
        pipe.drain()
    assert info.value is err
    assert failed_over == [] and pipe.stats.failovers == 0
    assert br.state == "closed" and br.trips == 0


def test_kernel_fault_in_the_oom_split_retry_poisons():
    """Out of memory takes the split ladder; a kernel fault inside the split
    retry poisons the pipeline instead of sending the span to the host."""
    from tez_tpu_torch.ops.kernels import KernelError
    err = KernelError("tez_merge_path_pair launch failed: cudaError 700")

    def dispatch(staged):
        if staged == 0:
            raise MemoryError("RESOURCE_EXHAUSTED: out of memory")
        return staged

    def oom_retry(ids, payloads):
        raise err

    failed_over = []
    pipe = AsyncSpanPipeline(
        dispatch_fn=dispatch, readback_fn=lambda s, ids: s,
        failover_fn=lambda ids, p: failed_over.append(ids),
        oom_retry_fn=oom_retry, breaker=CircuitBreaker(failures=100),
        counters=TezCounters())
    for i in range(2):
        pipe.submit(i, i)
    with pytest.raises(KernelError) as info:
        pipe.drain()
    assert info.value is err
    assert failed_over == [] and pipe.stats.oom_splits == 1


def test_sorter_kernel_fault_fails_the_flush(monkeypatch):
    """DeviceSorter(pipeline_depth=2): a KernelError raised from the resident
    dispatch poisons the pipeline, with no host failover and no breaker
    failure.  Where it surfaces depends on timing: from the flush itself,
    or from a later write_batch, whose submit raises "pipeline failed"
    from the KernelError.  Either way the KernelError is in the chain."""
    from tez_tpu_torch.ops import device as dev_ops
    from tez_tpu_torch.ops.kernels import KernelError

    def broken(staged, num_partitions, streams):
        raise KernelError("tez_fnv_hash_lanes launch failed: cudaError 98")

    monkeypatch.setattr(dev_ops, "dispatch_resident_span", broken)
    br = CircuitBreaker(failures=100)
    counters = TezCounters()
    with pytest.raises(Exception) as info:
        _flush_merged(2, "", breaker=br, counters=counters)
    chain, exc = [], info.value
    while exc is not None:
        chain.append(exc)
        exc = exc.__cause__
    assert any(isinstance(e, KernelError) for e in chain), chain
    fo = counters.group(COUNTER_GROUP)
    assert fo.find_counter("device.failover.spans").value == 0
    assert br.trips == 0 and br.state == "closed"


@pytest.mark.parametrize("exc, fatal", [
    ("kernel", True), ("illegal address", True), ("cuda oom", False),
    ("torch oom", False), ("value", False), ("injected readback", False),
    ("injected oom", False)])
def test_kernel_fault_classification(exc, fatal):
    """Which device-attempt failures the ladder may contain: out-of-memory,
    ordinary exceptions and injected faults are contained; a KernelError
    and any other CUDA error are not."""
    from tez_tpu_torch.ops.device import is_kernel_fault
    from tez_tpu_torch.ops.kernels import KernelError
    e = {"kernel": KernelError("x"),
         "illegal address": RuntimeError(_ILLEGAL_ADDRESS),
         "cuda oom": RuntimeError("CUDA error: out of memory"),
         "torch oom": torch.cuda.OutOfMemoryError("CUDA out of memory."),
         "value": ValueError("chip fault on span 1"),
         "injected readback": None, "injected oom": None}[exc]
    if e is None:
        point = "device.readback.fail" if exc == "injected readback" \
            else "device.dispatch.oom"
        faults.install("t", parse_spec(f"{point}:fail:n=1,exc=runtime"))
        with pytest.raises(Exception) as info:
            faults.fire(point, "span=0")
        e = info.value
    assert is_kernel_fault(e) is fatal


def test_kernel_build_and_launch_failures_raise_kernel_error(monkeypatch):
    """nvcc missing or failing, and a launch returning a CUDA error code,
    surface as KernelError; a failed launch is not counted."""
    from tez_tpu_torch.ops import _build, kernels

    def no_nvcc(*a, **k):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "library", no_nvcc)
    monkeypatch.setattr(_build, "load", no_nvcc)
    with pytest.raises(kernels.KernelError, match="nvcc not found"):
        kernels._entry("fnv_hash", "tez_fnv_hash_lanes")
    with pytest.raises(kernels.KernelError, match="nvcc not found"):
        kernels.load()
    monkeypatch.setattr(kernels, "_entry", lambda lib, fn: lambda *a: 700)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    kernels.reset_launches()
    with pytest.raises(kernels.KernelError, match="cudaError 700"):
        kernels._launch("fnv_hash_lanes", "fnv_hash", "tez_fnv_hash_lanes")
    assert kernels.launches["fnv_hash_lanes"] == 0


def test_engine_auto_width_routing():
    from tez_tpu_torch.ops.sorter import _route_engine
    # narrow spans fall back to host ONLY when the caller opted in by
    # passing key bytes (auto engines)
    assert _route_engine("device", 10_000, 0, key_nbytes=100,
                         min_key_bytes=1 << 20) == "host"
    assert _route_engine("device", 10_000, 0, key_nbytes=1 << 21,
                         min_key_bytes=1 << 20) == "device"
    # explicit device engine never passes key_nbytes: no width rerouting
    assert _route_engine("device", 10_000, 0, key_nbytes=-1,
                         min_key_bytes=1 << 20) == "device"
    # record floor still applies first
    assert _route_engine("device", 10, 100, key_nbytes=1 << 21,
                         min_key_bytes=1 << 20) == "host"
    assert _route_engine("host", 10_000, 0) == "host"


# -- parity with tez_tpu -------------------------------------------------------
def _long(v: int) -> bytes:
    return ((v + (1 << 63)) % (1 << 64)).to_bytes(8, "big")


def _word_batches(seed, nspans, per, vocab, max_len=12):
    """Ragged word keys (1..max_len bytes over `vocab` words) with 8-byte
    long values: the combiner leg's shape."""
    from tez_tpu_torch.ops.runformat import KVBatch
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, int(rng.integers(1, max_len + 1)))
                   .astype(np.uint8)) for _ in range(vocab)]
    out = []
    for _ in range(nspans):
        ids = rng.zipf(1.3, per) % vocab
        vals = rng.integers(-3, 9, per)
        out.append(KVBatch.from_pairs([(words[i], _long(int(v)))
                                       for i, v in zip(ids, vals)]))
    return out


def _comparable(counters) -> dict:
    """Every counter but the *MILLIS timings and the histogram groups."""
    return {g: {k: v for k, v in d.items() if not k.endswith("MILLIS")}
            for g, d in counters.to_dict().items()
            if not g.startswith("LatencyHistogram.")}


def _both_async(batches, **kw):
    from tez_tpu.ops import sorter as jsorter
    from tez_tpu.ops.runformat import KVBatch as JBatch
    from tez_tpu_torch.ops import sorter as tsorter
    jkw = dict(kw)
    if kw.get("combiner") is tsorter.sum_long_combiner:
        jkw["combiner"] = jsorter.sum_long_combiner
    ts = tsorter.DeviceSorter(device="cpu", **kw)
    js = jsorter.DeviceSorter(**jkw)
    for b in batches:
        ts.write_batch(b)
        js.write_batch(JBatch(b.key_bytes, b.key_offsets, b.val_bytes,
                              b.val_offsets))
    return ts, js, ts.flush(), js.flush()


def _assert_same_run(t, j):
    for a, b in ((t.batch.key_bytes, j.batch.key_bytes),
                 (t.batch.key_offsets, j.batch.key_offsets),
                 (t.batch.val_bytes, j.batch.val_bytes),
                 (t.batch.val_offsets, j.batch.val_offsets),
                 (t.row_index, j.row_index)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("coalesce", [-1, 0])
@pytest.mark.parametrize("combine", [False, True])
def test_async_sorter_matches_tez_tpu(combine, coalesce):
    """DeviceSorter(pipeline_depth=2) in both packages over the same seeded
    spans: the flushed Run and every counter (COMBINE_* and the
    DeviceFailover group included) are identical."""
    from tez_tpu_torch.ops import sorter as tsorter
    batches = _word_batches(7 + combine, 6, 700, 400)
    ts, js, t, j = _both_async(
        batches, num_partitions=4, key_width=16, span_budget_bytes=9000,
        engine="device", device_min_records=0, pipeline_depth=2,
        pipeline_coalesce_records=coalesce,
        combiner=tsorter.sum_long_combiner if combine else None)
    assert ts.num_spills == js.num_spills == 6
    _assert_same_run(t, j)
    assert _comparable(ts.counters) == _comparable(js.counters)
    if combine:
        assert ts.counters.find_counter(
            TaskCounter.COMBINE_INPUT_RECORDS).value == 6 * 700


@pytest.mark.parametrize("max_key,key_width", [(30, 8), (12, 12)])
def test_async_sorter_generic_spans_match_tez_tpu(max_key, key_width):
    """Keys wider than the lanes take the generic span sort on the staging
    thread (host tie-break included); custom partitions never coalesce."""
    rng = np.random.default_rng(max_key)
    from tez_tpu_torch.ops.runformat import KVBatch
    pairs = [(bytes(rng.integers(97, 100, int(rng.integers(1, max_key + 1)))
                    .astype(np.uint8)), _long(int(rng.integers(0, 5))))
             for _ in range(3000)]
    batches = [KVBatch.from_pairs(pairs[i:i + 500])
               for i in range(0, 3000, 500)]
    ts, js, t, j = _both_async(
        batches, num_partitions=3, key_width=key_width,
        span_budget_bytes=12000, engine="device", device_min_records=0,
        pipeline_depth=2)
    _assert_same_run(t, j)
    assert _comparable(ts.counters) == _comparable(js.counters)


def test_sortmaster_thread_matches_tez_tpu():
    """sort_threads=1 (the one-worker sortmaster of the synchronous plane)
    against tez_tpu's, with the precombine on the worker."""
    from tez_tpu_torch.ops import sorter as tsorter
    batches = _word_batches(3, 4, 600, 200)
    ts, js, t, j = _both_async(
        batches, num_partitions=3, key_width=16, span_budget_bytes=8000,
        engine="device", device_min_records=0, sort_threads=1,
        combiner=tsorter.sum_long_combiner)
    _assert_same_run(t, j)
    assert _comparable(ts.counters) == _comparable(js.counters)


@pytest.mark.parametrize("coalesce", [0, 1200])
def test_span_scheduler_matches_tez_tpu(coalesce):
    """DeviceSpanScheduler in both packages: the same results, dtypes
    included, span by span (coalesced spans share one result)."""
    from tez_tpu.ops.device_pipeline import DeviceSpanScheduler as JSched
    from tez_tpu_torch.ops.device_pipeline import DeviceSpanScheduler
    res = []
    for sched in (JSched(num_partitions=3, key_width=8,
                         coalesce_records=coalesce, paused=True),
                  DeviceSpanScheduler(num_partitions=3, key_width=8,
                                      coalesce_records=coalesce, paused=True,
                                      device="cpu")):
        for sid in range(3):
            kb, ko, vb = _mk_ragged(400, 8, sid)
            sched.submit_ragged(sid, kb, ko, vb, 8)
        sched.resume()
        res.append(sched.results())
    for sid in range(3):
        want, got = res[0][sid], res[1][sid]
        assert got[5] == want[5]
        for g, w in zip(got[:5], want[:5]):
            w = np.asarray(w)
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_span_scheduler_host_failover_matches_device_path():
    """contain_failures: a readback failure re-sorts the span through the
    numpy twin, identical to the fault-free result."""
    from tez_tpu_torch.ops.device_pipeline import DeviceSpanScheduler
    out = []
    for spec in ("", "device.readback.fail:fail:n=1,exc=io,match=span=1"):
        if spec:
            faults.install("t", parse_spec(spec))
        counters = TezCounters()
        sched = DeviceSpanScheduler(num_partitions=4, key_width=8,
                                    contain_failures=True,
                                    breaker=CircuitBreaker(failures=100),
                                    counters=counters, device="cpu")
        for sid in range(3):
            kb, ko, vb = _mk_ragged(500, 8, sid + 10)
            sched.submit_ragged(sid, kb, ko, vb, 8)
        out.append(sched.results())
        spans = counters.group(COUNTER_GROUP).find_counter(
            "device.failover.spans").value
        assert spans == (1 if spec else 0)
        faults.clear_all()
    for sid in range(3):
        for g, w in zip(out[1][sid], out[0][sid]):
            np.testing.assert_array_equal(g, w)


def _ragged(keys):
    ko = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum([len(k) for k in keys], out=ko[1:])
    return np.frombuffer(b"".join(keys), np.uint8).copy(), ko


def _hash_sum_cases():
    rng = np.random.default_rng(40)
    ragged = [bytes(rng.integers(97, 100, int(rng.integers(0, 41)))
                    .astype(np.uint8)) for _ in range(5000)]
    yield "ragged up to 40 bytes", ragged, rng.integers(-9, 9, 5000)
    yield "single key", [b"only"], np.array([5])
    distinct = [b"%07d" % i for i in rng.permutation(3000)]
    yield "all distinct", distinct, rng.integers(-9, 9, 3000)
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    yield "near the int64 bounds", [b"a", b"b", b"a", b"a", b"b", b"c"], \
        np.array([hi, lo, hi - 1, 3, -1, lo + 2], dtype=np.int64)


@pytest.mark.parametrize("case", [c[0] for c in _hash_sum_cases()])
def test_hash_sum_native_matches_tez_tpu(case):
    """The port's numpy hash_sum_native against tez_tpu's C++ one:
    first-occurrence order, int64 sums that wrap, bit for bit."""
    from tez_tpu.ops.native import hash_sum_native as jsum
    from tez_tpu_torch.ops.native import hash_sum_native
    _name, keys, vals = next(c for c in _hash_sum_cases() if c[0] == case)
    kb, ko = _ragged(keys)
    vals = np.asarray(vals, dtype=np.int64)
    got = hash_sum_native(kb, ko, vals)
    want = jsum(kb, ko, vals)
    if want is None:
        pytest.skip("tez_tpu's native library is missing; the dict "
                    "reference case covers the port alone")
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def test_hash_sum_native_exact_when_hashes_collide(monkeypatch):
    """Distinct keys that share a row hash are still told apart (the exact
    regrouping), against a dict reference with wrapping int64 sums."""
    from tez_tpu_torch.ops import native
    monkeypatch.setattr(native, "_row_hashes",
                        lambda words, lengths: np.zeros(len(lengths),
                                                        np.uint64))
    rng = np.random.default_rng(2)
    keys = [bytes(rng.integers(97, 99, int(rng.integers(0, 12)))
                  .astype(np.uint8)) for _ in range(800)]
    vals = rng.integers(-2 ** 62, 2 ** 62, 800) * 3
    first, sums = native.hash_sum_native(*_ragged(keys), vals)
    ref = {}
    for i, (k, v) in enumerate(zip(keys, vals)):
        f, s = ref.get(k, (i, 0))
        ref[k] = (f, (s + int(v) + 2 ** 63) % 2 ** 64 - 2 ** 63)
    want = sorted(ref.values())
    np.testing.assert_array_equal(first, [f for f, _ in want])
    np.testing.assert_array_equal(sums, [s for _, s in want])


def test_precombine_counters_match_tez_tpu():
    """One 70,000-record span of 500 distinct 6-byte keys with value 1
    through DeviceSorter(num_partitions=4, key_width=16,
    combiner=sum_long_combiner): the port counts COMBINE_INPUT_RECORDS and
    COMBINE_OUTPUT_RECORDS as tez_tpu does (70000 and 500) and flushes the
    same Run."""
    from tez_tpu_torch.ops import sorter as tsorter
    from tez_tpu_torch.ops.runformat import KVBatch
    rng = np.random.default_rng(0)
    vocab = np.array([b"%06d" % i for i in rng.permutation(1_000_000)[:500]])
    ids = rng.integers(0, 500, 70_000)
    kb = np.frombuffer(b"".join(vocab[ids]), np.uint8).copy()
    ko = np.arange(70_001, dtype=np.int64) * 6
    vb = np.tile(np.frombuffer(_long(1), np.uint8), 70_000)
    vo = np.arange(70_001, dtype=np.int64) * 8
    for depth in (0, 2):
        ts, js, t, j = _both_async(
            [KVBatch(kb, ko, vb, vo)], num_partitions=4, key_width=16,
            combiner=tsorter.sum_long_combiner, pipeline_depth=depth)
        _assert_same_run(t, j)
        for c, want in ((TaskCounter.COMBINE_INPUT_RECORDS, 70_000),
                        (TaskCounter.COMBINE_OUTPUT_RECORDS, 500)):
            assert ts.counters.find_counter(c).value == want
            assert js.counters.find_counter(c).value == want


def test_pre_combined_batch_skips_the_precombine():
    """A span made of one batch that promises unique keys skips the hash
    pass (no COMBINE_* counts), as in tez_tpu."""
    from tez_tpu_torch.ops import sorter as tsorter
    batch = _word_batches(5, 1, 900, 300)[0]
    batch.pre_combined = True
    s = tsorter.DeviceSorter(4, combiner=tsorter.sum_long_combiner,
                             device="cpu")
    s.write_batch(batch)
    s.flush()
    assert s.counters.find_counter(
        TaskCounter.COMBINE_INPUT_RECORDS).value == 0
    assert batch.take(np.arange(3)).pre_combined is False


def test_async_entry_points_default_to_the_card():
    """The async DeviceSorter and DeviceSpanScheduler run on "cuda" unless
    given device="cpu": without a card they raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    from tez_tpu_torch.ops.device_pipeline import DeviceSpanScheduler
    from tez_tpu_torch.ops.sorter import DeviceSorter
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSorter(4, pipeline_depth=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSpanScheduler(4, key_width=8)
    assert DeviceSorter(4, pipeline_depth=2, device="cpu").device.type == \
        "cpu"
    sched = DeviceSpanScheduler(4, key_width=8, device="cpu")
    assert sched.streams.device.type == "cpu"
    assert sched.results() == {}


def test_instrumented_stages_and_histograms():
    """An instrumented async sorter records every stage edge and fills the
    device.encode / h2d / dispatch_wait / d2h histograms; its dispatch
    interval lies inside the span's dispatch -> readback window."""
    from tez_tpu_torch.common import metrics
    from tez_tpu_torch.ops.async_stage import (STAGE_D2H, STAGE_DISPATCH,
                                               STAGE_ENCODE, STAGE_H2D)
    from tez_tpu_torch.ops.sorter import DeviceSorter
    before = {h: metrics.registry().histograms().get(h) for h in
              ("device.encode", "device.h2d", "device.dispatch_wait",
               "device.d2h")}
    s = DeviceSorter(num_partitions=4, engine="device", device_min_records=0,
                     key_width=16, span_budget_bytes=20_000, pipeline_depth=2,
                     pipeline_coalesce_records=0, device="cpu")
    pipe = s._ensure_pipeline()
    pipe._instrument = True
    for i in range(3):
        s.write_batch(_mk_batch(1000, i))
    s.flush()
    edges = {(ids, stage, edge) for ids, stage, edge, _t in pipe.events}
    for sid in range(3):
        for stage in (STAGE_ENCODE, STAGE_H2D, STAGE_DISPATCH, STAGE_D2H):
            assert ((sid,), stage, "start") in edges
            assert ((sid,), stage, "end") in edges
    after = metrics.registry().histograms()
    for name, h in before.items():
        assert after[name].count - (h.count if h else 0) == 3
    assert pipe.stats.dispatched == 3 and pipe.stats.max_in_flight <= 2
