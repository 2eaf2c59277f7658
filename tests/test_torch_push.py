"""Port parity of push shuffle (shuffle/push.py, the push landing zone of
shuffle/service.py, the push verb of shuffle/server.py) against
tez_tpu's, on the CPU.

Every case of tests/test_push_shuffle.py and the replica failover of
tests/test_recovery_ha.py runs on both packages inside one test, the port
with device="cpu": each package's run keeps the original assertions and
returns what it saw (records served, counters, admission and store
state), and the two packages' observations must be equal.  Wire parity:
each package's SpillPusher pushes into the other package's server.

At the DAG level, OrderedWordCount with push and the store on runs in
runner threads and in 2 runner processes on both packages: equal part
files, and equal push and store counters.  In runner processes every
push goes to a destination with a port, so it needs a job-token secret
that tez_tpu's OrderedPartitionedKVOutput never hands its SpillPusher
(tez_tpu/library/outputs.py:201): both packages abandon every push to
the pull backstop (SHUFFLE_PUSH_REJECTED equals the spills, no push
bytes).  An autouse fixture resets both packages' stores.
"""
import collections
import importlib
import os
import time
import types

import pytest

import chip_smoke

ROOTS = ("tez_tpu_torch", "tez_tpu")


def pkg(root: str) -> types.SimpleNamespace:
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    ns = types.SimpleNamespace(root=root, store=mod("store"))
    for name in ("common.epoch", "common.counters", "common.faults",
                 "common.security", "ops.sorter", "ops.async_stage",
                 "store.buffer_store", "shuffle.service", "shuffle.push",
                 "shuffle.server"):
        setattr(ns, name.rsplit(".", 1)[1], mod(name))
    return ns


@pytest.fixture(autouse=True)
def _fresh_planes():
    for root in ROOTS:
        p = pkg(root)
        p.store.reset_store()
        p.epoch.reset()
        p.faults.clear_all()
    yield
    for root in ROOTS:
        p = pkg(root)
        p.store.reset_store()
        p.epoch.reset()
        p.faults.clear_all()


def both(case, tmp_path, *args):
    out = []
    for root in ROOTS:
        tmp = tmp_path / root
        tmp.mkdir()
        out.append(case(pkg(root), tmp, *args))
    assert out[0] == out[1]
    return out[0]


def _make_run(p, partitions=3, records=60, tag="k"):
    kw = {"device": "cpu"} if p.root == ROOTS[0] else {}
    sorter = p.sorter.DeviceSorter(num_partitions=partitions, **kw)
    for i in range(records):
        sorter.write(f"{tag}{i:04d}".encode(), f"v{i}".encode())
    return sorter.flush()


def _pairs(batch):
    return list(batch.iter_pairs())


def _landing(p, tmp):
    """Consumer-side landing zone: service + buffer store + admission."""
    service = p.service.ShuffleService()
    store = p.buffer_store.ShuffleBufferStore(
        device_capacity=0, host_capacity=8 << 20,
        disk_dir=str(tmp / "spill"))
    service.attach_buffer_store(store)
    admission = p.push.PushAdmissionController(
        lambda: store, source_quota_bytes=4 << 20, retry_after_ms=1.0)
    service.attach_push_admission(admission)
    return service, store, admission


def _counter(p, counters, name):
    return counters.find_counter(getattr(p.counters.TaskCounter, name)).value


class _FakeStore:
    host_capacity = 0           # watermark rule off

    def tier_bytes(self, tier):
        return 0


# -- admission ----------------------------------------------------------------
def _watermark(p, tmp):
    store = p.buffer_store.ShuffleBufferStore(
        device_capacity=0, host_capacity=1000, disk_dir=str(tmp))
    adm = p.push.PushAdmissionController(lambda: store, admit_watermark=0.5,
                                         retry_after_ms=7.0)
    adm.admit("src_a", 100)
    with pytest.raises(p.push.PushRejected) as ei:
        adm.admit("src_a", 600)     # 0 in tier yet, but 600 > 1000 * 0.5
    assert ei.value.retry_after_ms == 7.0
    assert "watermark" in ei.value.reason
    assert adm.admitted == 1 and adm.rejected == 1
    store.close()
    return ei.value.reason, adm.held("src_a")


def test_admission_watermark_rejects_above_host_capacity(tmp_path):
    both(_watermark, tmp_path)


def _source_quota(p, tmp):
    adm = p.push.PushAdmissionController(lambda: None,
                                         source_quota_bytes=100)
    # no store: everything is rejected outright (push has no landing zone)
    with pytest.raises(p.push.PushRejected) as ei:
        adm.admit("src", 10)
    assert "landing zone" in ei.value.reason
    adm2 = p.push.PushAdmissionController(lambda: _FakeStore(),
                                          source_quota_bytes=100)
    adm2.admit("hot", 5000)         # oversize while holding nothing: allowed
    assert adm2.held("hot") == 5000
    with pytest.raises(p.push.PushRejected):
        adm2.admit("hot", 1)        # quota exhausted once holding
    adm2.admit("cold", 50)
    adm2.admit("cold", 50)
    with pytest.raises(p.push.PushRejected):
        adm2.admit("cold", 1)
    assert adm2.release_prefix("hot") == 5000
    adm2.admit("hot", 60)           # quota returned
    assert adm2.held("hot") == 60
    return ei.value.reason, adm2.admitted, adm2.rejected


def test_admission_source_quota_first_oversize_admitted(tmp_path):
    both(_source_quota, tmp_path)


def _admit_fault(p, tmp):
    adm = p.push.PushAdmissionController(lambda: _FakeStore())
    p.faults.install("t", p.faults.parse_spec(
        "shuffle.push.admit:fail:n=1,exc=io"), seed=1)
    try:
        with pytest.raises(p.push.PushRejected) as ei:
            adm.admit("src", 10)
        assert "fault-injected" in ei.value.reason
        adm.admit("src", 10)        # n=1: the next decision is clean
    finally:
        p.faults.clear_all()
    assert adm.rejected == 1 and adm.admitted == 1
    return adm.held("src")


def test_admission_fault_point_turns_decision_into_rejection(tmp_path):
    both(_admit_fault, tmp_path)


def test_push_fault_points_keep_tez_tpu_texts():
    for point in ("shuffle.push.send", "shuffle.push.admit"):
        assert pkg(ROOTS[0]).faults.KNOWN_POINTS[point] == \
            pkg(ROOTS[1]).faults.KNOWN_POINTS[point]


# -- same-host push publish ---------------------------------------------------
def _zero_copy(p, tmp):
    service, store, _ = _landing(p, tmp)
    run = _make_run(p)
    service.register("dagP/a_1/c", 0, run, use_store=False)  # pull backstop
    service.push_publish("dagP/a_1/c", 0, run)
    # the store entry IS the registered run object — no copy, no
    # double-count between the pull registry and the push landing zone
    assert store.get("dagP/a_1/c", 0) is run
    got = service.fetch_partition("dagP/a_1/c", 0, 1)
    assert _pairs(got) == _pairs(run.partition(1))
    return _pairs(got), store.stats()


def test_push_publish_same_host_is_zero_copy_alias(tmp_path):
    both(_zero_copy, tmp_path)


def _stale_push(p, tmp):
    service, store, _ = _landing(p, tmp)
    p.epoch.register("app_push", 3)
    run = _make_run(p)
    with pytest.raises(p.epoch.EpochFencedError):
        service.push_publish("dagF/a_1/c", 0, run, epoch=2,
                             app_id="app_push")
    assert store.get("dagF/a_1/c", 0) is None
    # the live epoch pushes fine
    service.push_publish("dagF/a_1/c", 0, run, epoch=3, app_id="app_push")
    assert store.get("dagF/a_1/c", 0) is run
    return store.stats()


def test_push_publish_stale_epoch_fenced(tmp_path):
    both(_stale_push, tmp_path)


def _no_admission(p, tmp):
    service = p.service.ShuffleService()
    store = p.buffer_store.ShuffleBufferStore(
        device_capacity=0, host_capacity=1 << 20, disk_dir=str(tmp))
    service.attach_buffer_store(store)      # store but NO admission
    with pytest.raises(p.push.PushRejected) as ei:
        service.push_publish("dagN/a_1/c", 0, _make_run(p))
    return ei.value.reason, ei.value.retry_after_ms


def test_push_publish_without_admission_rejects(tmp_path):
    both(_no_admission, tmp_path)


def _listeners(p, tmp):
    service, _, _ = _landing(p, tmp)
    seen = []

    def broken(path, spill):
        raise RuntimeError("consumer merge-wake exploded")

    service.add_push_listener(broken)
    service.add_push_listener(lambda path, spill: seen.append((path, spill)))
    service.push_publish("dagL/a_1/c", 2, _make_run(p))   # no raise
    assert seen == [("dagL/a_1/c", 2)]
    service.remove_push_listener(broken)
    return seen


def test_push_listener_notified_and_errors_swallowed(tmp_path):
    both(_listeners, tmp_path)


def _sweep(p, tmp):
    service, store, admission = _landing(p, tmp)
    run = _make_run(p)
    service.register("dagU/a_1/c", 0, run, use_store=False)
    service.push_publish("dagU/a_1/c", 0, run)
    # a remotely-landed partition under the same DAG prefix
    service.push_publish("dagU/a_1/c", 1, _make_run(p, partitions=1),
                         partition=2)
    held = admission.held("dagU/a_1/c")
    assert held > 0
    n = service.unregister_prefix("dagU")
    assert store.get("dagU/a_1/c", 0) is None
    assert store.get(p.push.push_key("dagU/a_1/c", 2), 1) is None
    assert admission.held("dagU/a_1/c") == 0
    with pytest.raises(p.service.ShuffleDataNotFound):
        service.fetch_partition("dagU/a_1/c", 0, 0)
    return held, n, store.stats()


def test_unregister_prefix_sweeps_pushed_keys_and_quota(tmp_path):
    both(_sweep, tmp_path)


# -- SpillPusher --------------------------------------------------------------
def _local_drain(p, tmp):
    service, store, _ = _landing(p, tmp)
    counters = p.counters.TezCounters()
    pusher = p.push.SpillPusher(service, threads=2, counters=counters)
    runs = [_make_run(p, tag=f"t{i}") for i in range(4)]
    for i, run in enumerate(runs):
        service.register("dagS/a_1/c", i, run, use_store=False)
        assert pusher.submit("dagS/a_1/c", i, run)
    pusher.close()                  # close drains: counters are settled
    assert pusher.pushes_sent == 4 and pusher.pushes_rejected == 0
    assert _counter(p, counters, "SHUFFLE_PUSH_BYTES") == \
        sum(r.nbytes for r in runs)
    assert not pusher.submit("dagS/a_1/c", 99, runs[0])   # closed
    for i, run in enumerate(runs):
        assert store.get("dagS/a_1/c", i) is run
    return _counter(p, counters, "SHUFFLE_PUSH_BYTES"), store.stats()


def test_spill_pusher_local_counters_and_close_drain(tmp_path):
    both(_local_drain, tmp_path)


def _send_storm(p, tmp):
    service, store, _ = _landing(p, tmp)
    counters = p.counters.TezCounters()
    run = _make_run(p)
    service.register("dagK/a_1/c", 0, run, use_store=False)
    p.faults.install("t", p.faults.parse_spec(
        "shuffle.push.send:fail:exc=io"), seed=1)
    try:
        pusher = p.push.SpillPusher(service, retries=2, counters=counters,
                                    backoff_base=0.001)
        pusher.submit("dagK/a_1/c", 0, run)
        pusher.close()
    finally:
        p.faults.clear_all()
    assert pusher.pushes_rejected == 1 and pusher.pushes_sent == 0
    assert _counter(p, counters, "SHUFFLE_PUSH_REJECTED") == 1
    assert store.get("dagK/a_1/c", 0) is None         # push never landed
    got = service.fetch_partition("dagK/a_1/c", 0, 0)  # pull backstop
    assert _pairs(got) == _pairs(run.partition(0))
    return _pairs(got), store.stats()


def test_spill_pusher_send_fault_storm_pull_backstop(tmp_path):
    both(_send_storm, tmp_path)


def _admit_storm(p, tmp):
    service, store, admission = _landing(p, tmp)
    run = _make_run(p)
    service.register("dagR/a_1/c", 0, run, use_store=False)
    p.faults.install("t", p.faults.parse_spec(
        "shuffle.push.admit:fail:exc=io"), seed=1)
    try:
        pusher = p.push.SpillPusher(service, retries=3, backoff_base=0.001)
        t0 = time.perf_counter()
        pusher.submit("dagR/a_1/c", 0, run)
        pusher.close()
        waited = time.perf_counter() - t0
    finally:
        p.faults.clear_all()
    assert pusher.pushes_rejected == 1
    assert admission.rejected == 3            # one per retry attempt
    # each rejection honored the RETRY-AFTER hint (1 ms x 3) before retrying
    assert waited >= 0.003
    assert store.get("dagR/a_1/c", 0) is None
    return pusher.pushes_rejected, admission.rejected


def test_spill_pusher_admission_storm_retries_then_abandons(tmp_path):
    both(_admit_storm, tmp_path)


def _inflight_cap(p, tmp):
    service, _, _ = _landing(p, tmp)
    run = _make_run(p, records=200)
    limit = run.nbytes + 1          # second submit must wait for the first
    order = []
    orig = service.push_publish

    def slow_publish(path, spill_id, r, **kw):
        order.append(("start", spill_id))
        time.sleep(0.05)
        orig(path, spill_id, r, **kw)
        order.append(("done", spill_id))

    service.push_publish = slow_publish
    pusher = p.push.SpillPusher(service, threads=2,
                                inflight_limit_bytes=limit)
    for i in range(3):
        service.register("dagI/a_1/c", i, run, use_store=False)
        assert pusher.submit("dagI/a_1/c", i, run)
    pusher.close()
    assert pusher.pushes_sent == 3
    # the cap serialized the pushes: no spill started before the previous
    # one finished, despite the 2-thread pool
    for i in range(len(order) - 1):
        if order[i][0] == "start":
            assert order[i + 1] == ("done", order[i][1])
    return order


def test_spill_pusher_inflight_cap_blocks_then_releases(tmp_path):
    both(_inflight_cap, tmp_path)


# -- remote push --------------------------------------------------------------
def _remote(case):
    """case(p, server, secrets, service, store) with p's landing zone
    behind p's own ShuffleServer."""
    def run(p, tmp, *args):
        service, store, _ = _landing(p, tmp)
        secrets = p.security.JobTokenSecretManager()
        server = p.server.ShuffleServer(secrets, service).start()
        try:
            return case(p, server, secrets, service, store, *args)
        finally:
            server.stop()
    return run


@_remote
def _remote_roundtrip(p, server, secrets, service, store):
    producer_service = p.service.ShuffleService()   # mapper: no store
    counters = p.counters.TezCounters()
    run = _make_run(p)
    pusher = p.push.SpillPusher(producer_service, counters=counters,
                                secrets=secrets)
    assert pusher.submit("dagW/a_1/c", 0, run, host="127.0.0.1",
                         port=server.port)
    pusher.close()
    assert pusher.pushes_sent == 1
    assert _counter(p, counters, "SHUFFLE_PUSH_BYTES") == run.nbytes
    # landed per-partition under push_key; the consumer-side service probe
    # (plain key -> bare registry -> push key) serves them transparently
    got = []
    for part in range(3):
        assert store.get(p.push.push_key("dagW/a_1/c", part), 0) is not None
        batch = service.fetch_partition("dagW/a_1/c", 0, part)
        assert _pairs(batch) == _pairs(run.partition(part))
        got.append(_pairs(batch))
    # (server.bytes_pushed moves after the reply: not read here)
    return got, store.stats()


def test_remote_push_roundtrip(tmp_path):
    both(_remote_roundtrip, tmp_path)


@_remote
def _remote_bad_hmac(p, server, secrets, service, store):
    wrong = p.security.JobTokenSecretManager(b"not-the-secret" * 2)
    counters = p.counters.TezCounters()
    pusher = p.push.SpillPusher(p.service.ShuffleService(), retries=3,
                                counters=counters, secrets=wrong,
                                backoff_base=0.001)
    pusher.submit("dagH/a_1/c", 0, _make_run(p), host="127.0.0.1",
                  port=server.port)
    pusher.close()
    assert pusher.pushes_rejected == 1
    assert _counter(p, counters, "SHUFFLE_PUSH_REJECTED") == 1
    # PermissionError is fatal: exactly ONE wire attempt, not three
    assert server.auth_failures == 1
    assert store.get(p.push.push_key("dagH/a_1/c", 0), 0) is None
    return server.auth_failures, server.bytes_pushed


def test_remote_push_bad_hmac_fatal_no_retry(tmp_path):
    both(_remote_bad_hmac, tmp_path)


@_remote
def _remote_stale(p, server, secrets, service, store):
    p.epoch.register("app_rp", 5)
    pusher = p.push.SpillPusher(p.service.ShuffleService(), retries=3,
                                secrets=secrets, epoch=4, app_id="app_rp",
                                backoff_base=0.001)
    pusher.submit("dagZ/a_1/c", 0, _make_run(p), host="127.0.0.1",
                  port=server.port)
    pusher.close()
    assert pusher.pushes_rejected == 1
    assert store.get(p.push.push_key("dagZ/a_1/c", 0), 0) is None
    return pusher.pushes_rejected, server.bytes_pushed


def test_remote_push_stale_epoch_fenced_no_retry(tmp_path):
    both(_remote_stale, tmp_path)


@_remote
def _remote_retry(p, server, secrets, service, store):
    """A RETRY-AFTER reply is retryable: the first attempt is rejected by
    an injected admission fault, the retry lands."""
    p.faults.install("t", p.faults.parse_spec(
        "shuffle.push.admit:fail:n=1,exc=io"), seed=1)
    try:
        pusher = p.push.SpillPusher(p.service.ShuffleService(), retries=3,
                                    secrets=secrets, backoff_base=0.001)
        run = _make_run(p, partitions=1)
        pusher.submit("dagA/a_1/c", 0, run, host="127.0.0.1",
                      port=server.port)
        pusher.close()
    finally:
        p.faults.clear_all()
    assert pusher.pushes_sent == 1
    assert store.get(p.push.push_key("dagA/a_1/c", 0), 0) is not None
    return pusher.pushes_sent, store.stats()["counters"]


def test_remote_push_admission_retry_then_success(tmp_path):
    both(_remote_retry, tmp_path)


@pytest.mark.parametrize("pusher_root,server_root",
                         [(ROOTS[0], ROOTS[1]), (ROOTS[1], ROOTS[0])])
def test_remote_push_wire_parity(tmp_path, pusher_root, server_root):
    """Each package's SpillPusher pushes into the other package's server:
    the blobs land and serve the same records; a push under a wrong token
    is forbidden."""
    ps, pp = pkg(server_root), pkg(pusher_root)
    service, store, _ = _landing(ps, tmp_path)
    key = os.urandom(16)
    server = ps.server.ShuffleServer(
        ps.security.JobTokenSecretManager(key), service).start()
    try:
        run = _make_run(pp)
        for token, sent in ((key, 1), (b"x" * 16, 0)):
            pusher = pp.push.SpillPusher(
                pp.service.ShuffleService(),
                secrets=pp.security.JobTokenSecretManager(token),
                backoff_base=0.001)
            pusher.submit("dagX/a_1/c", 0, run, host="127.0.0.1",
                          port=server.port)
            pusher.close()
            assert pusher.pushes_sent == sent
        assert server.auth_failures == 1
        for part in range(3):
            got = service.fetch_partition("dagX/a_1/c", 0, part)
            assert _pairs(got) == _pairs(run.partition(part))
    finally:
        server.stop()


def test_push_request_without_landing_zone_replies_retry(tmp_path):
    """A push to a process without a buffer store is answered "retry"
    (push_publish has no landing zone) by both packages' servers; the
    connection stays framed."""
    def case(p, tmp):
        service = p.service.ShuffleService()
        secrets = p.security.JobTokenSecretManager()
        server = p.server.ShuffleServer(secrets, service).start()
        try:
            pusher = p.push.SpillPusher(p.service.ShuffleService(),
                                        retries=2, secrets=secrets,
                                        backoff_base=0.001)
            pusher.submit("dagN/a_1/c", 0, _make_run(p), host="127.0.0.1",
                          port=server.port)
            pusher.close()
            return pusher.pushes_sent, pusher.pushes_rejected, \
                server.bytes_pushed
        finally:
            server.stop()
    assert both(case, tmp_path) == (0, 1, 0)


# -- tests/test_recovery_ha.py: replica failover ------------------------------
def _failover(p, tmp):
    def make_service(subdir):
        service = p.service.ShuffleService()
        store = p.buffer_store.ShuffleBufferStore(
            device_capacity=0, host_capacity=8 << 20,
            disk_dir=str(tmp / subdir))
        service.attach_buffer_store(store)
        service.attach_push_admission(p.push.PushAdmissionController(
            lambda: store, source_quota_bytes=4 << 20))
        return service

    run = _make_run(p)
    service = make_service("repl")
    counters = p.counters.TezCounters()
    service.register("dagHA/a_1/c", 0, run, use_store=False)
    service.push_publish("dagHA/a_1/c", 0, run, replicas=2,
                         counters=counters)
    group = counters.to_dict().get("ShuffleStore", {})
    assert group.get("store.replica.bytes", 0) >= run.nbytes
    p.faults.install("t", p.faults.parse_spec(
        "store.replica.lost:fail:n=1"), seed=1)
    try:
        got = service.fetch_partition("dagHA/a_1/c", 0, 1,
                                      counters=counters)
    finally:
        p.faults.clear_all()
    assert _pairs(got) == _pairs(run.partition(1))
    group = counters.to_dict().get("ShuffleStore", {})
    assert group.get("store.replica.failover", 0) == 1
    # contrast: without the replica the same loss is fatal — the replica
    # is what stands between a dead store and a producer re-run
    bare = make_service("bare")
    bare.register("dagHA/a_1/c", 0, run, use_store=False)
    bare.push_publish("dagHA/a_1/c", 0, run)   # replicas=1 (default)
    p.faults.install("t", p.faults.parse_spec(
        "store.replica.lost:fail:n=1"), seed=1)
    try:
        with pytest.raises(p.service.ShuffleDataNotFound):
            bare.fetch_partition("dagHA/a_1/c", 0, 1)
    finally:
        p.faults.clear_all()
    return _pairs(got), group


def test_push_replica_failover_serves_without_producer(tmp_path):
    both(_failover, tmp_path)


# -- OrderedWordCount with push, in runner threads and runner processes ------
#: push forces pipelined output; io.sort.mb 1 makes several spills a
#: tokenizer, each pushed on its own; synchronous spans (depth 0) as in
#: tests/test_torch_dag.py's pipelined case
PUSH_CONF = {"tez.runtime.store.enabled": True,
             "tez.runtime.shuffle.push.enabled": True,
             "tez.runtime.io.sort.mb": 1,
             "tez.runtime.sort.pipeline.depth": 0}
#: the DAG counters push decides
PUSH_COUNTERS = ("SHUFFLE_PUSH_BYTES", "SHUFFLE_PUSH_REJECTED",
                 "SHUFFLE_CHUNK_COUNT", "NUM_SHUFFLED_INPUTS",
                 "OUTPUT_RECORDS", "REDUCE_INPUT_RECORDS")


def push_counters(counters: dict) -> dict:
    task = counters.get("TaskCounter", {})
    return {c: task.get(c, 0) for c in PUSH_COUNTERS}


@pytest.fixture()
def paced(monkeypatch):
    """tests/test_torch_dag.py's deterministic planes on both packages."""
    from test_torch_dag import pace_both, unpace_both
    pace_both(monkeypatch)
    yield
    unpace_both()


def test_push_wordcount_in_runner_threads_matches_tez_tpu(tmp_path, paced):
    """OrderedWordCount with push and the store in 2 runner threads on
    both packages: equal part files, untimed DAG counters, push counters
    (every spill pushed, none rejected) and store counters."""
    from test_torch_dag import corpus, run_case, untimed
    paths = corpus(tmp_path, 1, 200_000)
    results = []
    for root in ROOTS:
        pkg(root).store.reset_store()
        run, parts, ok = run_case(tmp_path, root, dict(combine=False),
                                  PUSH_CONF, paths)
        store = pkg(root).store.local_buffer_store()
        results.append((run, parts, ok, store.stats()["counters"]))
    (t, t_parts, t_ok, t_store), (j, j_parts, j_ok, j_store) = results
    assert t.state == j.state == "SUCCEEDED" and t_ok and j_ok
    assert t_parts == j_parts and t_parts
    assert untimed(t.counters) == untimed(j.counters)
    assert t_store == j_store
    pc = push_counters(t.counters)
    assert pc["SHUFFLE_PUSH_BYTES"] > 0 and pc["SHUFFLE_PUSH_REJECTED"] == 0
    assert pc["SHUFFLE_CHUNK_COUNT"] > 2
    assert t_store["store.published"] >= pc["SHUFFLE_CHUNK_COUNT"]


def test_push_wordcount_in_runner_processes_matches_tez_tpu(tmp_path):
    """OrderedWordCount with push and the store in 2 runner processes on
    both packages.  Every push goes to a destination with a port and no
    pusher has a secret, so both packages abandon every spill to the pull
    backstop: in both, SHUFFLE_PUSH_REJECTED equals the spills shipped
    (SHUFFLE_CHUNK_COUNT) and no byte is pushed.  The port's part file
    equals its run in runner threads, and its rows equal a plain
    collections.Counter of the corpus's words; tez_tpu's may miss
    records (its fetch table completes a source on the final marker,
    which from a runner process can overtake earlier spills: see
    test_pipelined_final_marker_waits_for_earlier_spills)."""
    from test_torch_dag import corpus
    from test_torch_remote_dag import RUNNER_ENV, proc_conf
    paths = corpus(tmp_path, 1, 60_000)
    results = {}
    for label, root, mode in (("port", ROOTS[0], "subprocess"),
                              ("tez_tpu", ROOTS[1], "subprocess"),
                              ("port_threads", ROOTS[0], "threads")):
        pkg(root).store.reset_store()
        api = chip_smoke.dag_api(root, device="cpu" if root == ROOTS[0]
                                 else None)
        out = str(tmp_path / label / "out")
        desc = chip_smoke.wordcount_description(paths, out, combine=False,
                                                summation_parallelism=2)
        conf = proc_conf(tmp_path / label, **PUSH_CONF, **{
            "tez.runner.mode": mode,
            "tez.runtime.sorter.class": "device",
            "tez.runtime.tpu.device.sort.min.records": 0,
            "tez.am.runner.env": RUNNER_ENV[root],
            "tez.am.container.idle.release-timeout-min.millis": 60_000})
        run = chip_smoke.run_dag(api, desc, conf, timeout=600)
        assert run.state == "SUCCEEDED", label
        results[label] = (run, chip_smoke.read_wordcount(out))
    (port, (data, rows)) = results["port"]
    assert data and data == results["port_threads"][1][0]
    golden = collections.Counter()
    for path in paths:
        with open(path, "rb") as fh:
            golden.update(fh.read().split())
    assert len(rows) == len(golden) and dict(rows) == dict(golden)
    assert sum(c for _w, c in rows) == \
        port.counters["TaskCounter"]["REDUCE_INPUT_RECORDS"] - len(rows)
    # (tez_tpu's chunk count follows the records its summations lost)
    for label in ("port", "tez_tpu"):
        task = results[label][0].counters["TaskCounter"]
        assert task.get("SHUFFLE_PUSH_BYTES", 0) == 0, label
        assert task["SHUFFLE_PUSH_REJECTED"] == \
            task["SHUFFLE_CHUNK_COUNT"] > 0, label


def test_pipelined_final_marker_waits_for_earlier_spills():
    """A kept divergence: a pipelined producer's final marker (spill 2,
    last) delivered before its spills 0 and 1.  tez_tpu's fetch table
    completes the source on the marker and drops the two spills; the
    port's completes it once every spill up to the marker is in."""
    import numpy as np
    out = {}
    for root in ROOTS:
        inputs = importlib.import_module(f"{root}.library.inputs")
        events = importlib.import_module(f"{root}.api.events")
        rf = importlib.import_module(f"{root}.ops.runformat")
        counters = importlib.import_module(f"{root}.common.counters")

        class _Ctx:
            def __init__(self):
                self.counters = counters.TezCounters()
                self.conf: dict = {}
                self.events: list = []

            def get_service_provider_metadata(self, name):
                return {"host": "local", "port": 0}

            def send_events(self, evs):
                self.events.extend(evs)

            def notify_progress(self):
                pass

        svc = pkg(root).service.local_shuffle_service()
        for spill, n in ((0, 5), (1, 3), (2, 0)):
            batch = rf.KVBatch.from_pairs([(f"k{spill}{j}".encode(), b"v")
                                           for j in range(n)])
            svc.register("dagM/a_1/c", spill,
                         rf.Run(batch, np.array([0, n], dtype=np.int64)))
        table = inputs.ShuffleFetchTable(_Ctx(), 1, my_partition=0)
        try:
            for spill in (2, 0, 1):
                table.on_payload(0, 0, events.ShufflePayload(
                    host="local", port=0, path_component="dagM/a_1/c",
                    spill_id=spill, last_event=spill == 2))
            got = table.wait_all(timeout=10)
            out[root] = sum(b.num_records for b in got)
        finally:
            table.shutdown()
            svc.unregister_prefix("dagM")
    assert out == {ROOTS[0]: 8, ROOTS[1]: 0}
