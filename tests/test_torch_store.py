"""Port parity of the tiered shuffle buffer store (store/buffer_store.py,
store/__init__.py) and cross-DAG output reuse against tez_tpu's, on the CPU.

Every case of tests/test_store.py (but the chaos scenario, which waits for
the port's tools/chaos) and of tests/test_multitenancy.py's store quotas
and result cache runs on both packages inside one test, the port with
device="cpu": each package's run keeps the original assertions and
returns what it saw (fetched records, tier bytes, the store's counters),
and the two packages' observations must be equal.  The device-lane stand-
ins are numpy arrays for tez_tpu and torch tensors for the port; their
nbytes are equal.

At the DAG level, OrderedWordCount runs twice in one client session with
the store on: part files, untimed DAG counters and the store's counters
equal tez_tpu's; the second DAG reuses every tokenizer and summation
output.  The sorter's out-of-memory ladder evicts the store's lanes before
it halves a span.  An autouse fixture resets both packages' stores
(tests/conftest.py resets only tez_tpu's).
"""
import importlib
import random
import threading
import types

import numpy as np
import pytest
import torch

import chip_smoke
from test_store import _read_out, _write_corpus

ROOTS = ("tez_tpu_torch", "tez_tpu")


def pkg(root: str) -> types.SimpleNamespace:
    """The modules of one package that these cases use, by tez_tpu's
    module names."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    ns = types.SimpleNamespace(root=root, store=mod("store"))
    for name in ("common.epoch", "common.counters", "common.faults",
                 "ops.runformat", "ops.sorter", "ops.async_stage",
                 "store.buffer_store", "store.lineage", "shuffle.service",
                 "examples.ordered_wordcount", "client.tez_client",
                 "client.dag_client"):
        setattr(ns, name.rsplit(".", 1)[1], mod(name))
    return ns


@pytest.fixture(autouse=True)
def _fresh_planes():
    for root in ROOTS:
        p = pkg(root)
        p.store.reset_store()
        p.epoch.reset()
        p.faults.clear_all()
        p.async_stage.reset_process_breaker()
    yield
    for root in ROOTS:
        p = pkg(root)
        p.store.reset_store()
        p.epoch.reset()
        p.faults.clear_all()
        p.async_stage.reset_process_breaker()


def both(case, tmp_path, *args):
    """case(p, tmp) on each package; the port's observation equals
    tez_tpu's."""
    out = []
    for root in ROOTS:
        tmp = tmp_path / root
        tmp.mkdir()
        out.append(case(pkg(root), tmp, *args))
    assert out[0] == out[1]
    return out[0]


def _run(p, n: int = 64, parts: int = 2, seed: int = 0,
         dev_lanes: bool = False):
    rng = random.Random(seed)
    pairs = [(b"k%06d" % rng.randrange(10_000), b"v%04d" % (i % 97))
             for i in range(n)]
    batch = p.runformat.KVBatch.from_pairs(sorted(pairs))
    if dev_lanes:
        # store accounting only needs .nbytes on each lane array: numpy
        # arrays stand in for tez_tpu's device buffers, CPU tensors for
        # the port's
        if p.root == ROOTS[0]:
            batch.dev_keys = (torch.zeros((n, 4), dtype=torch.int32),
                              torch.zeros(n, dtype=torch.int32), 0, n)
        else:
            batch.dev_keys = (np.zeros((n, 4), np.uint32),
                              np.zeros(n, np.int32), 0, n)
    bounds = np.linspace(0, n, parts + 1).astype(np.int64)
    return p.runformat.Run(batch, bounds)


def _pairs(batch):
    return list(batch.iter_pairs())


def _store(p, tmp, **kw):
    kw.setdefault("device_capacity", 0)
    kw.setdefault("disk_dir", str(tmp / "store"))
    return p.buffer_store.ShuffleBufferStore(**kw)


def _seen(s, *extra):
    """A store's observable state: tier bytes, entries and counters."""
    st = s.stats()
    return (st["bytes"], st["entries"], st["counters"]) + extra


# -- tests/test_store.py: basic tiers ----------------------------------------
def _roundtrip(p, tmp):
    s = _store(p, tmp, host_capacity=1 << 20)
    try:
        run = _run(p)
        s.publish("dag1/a0/cons", -1, run)
        got = []
        for part in range(run.num_partitions):
            batch = s.fetch_partition("dag1/a0/cons", -1, part)
            assert _pairs(batch) == _pairs(run.partition(part))
            got.append(_pairs(batch))
        assert s.counters["store.hits"] == run.num_partitions
        assert s.tier_bytes(p.buffer_store.HOST) == run.nbytes
        with pytest.raises(p.buffer_store.StoreKeyNotFound):
            s.fetch_partition("dag1/a0/cons", 0, 0)
        assert s.counters["store.misses"] == 1
        mid = _seen(s)
        assert s.unregister_prefix("dag1") == 1
        assert s.tier_bytes(p.buffer_store.HOST) == 0
        assert s.stats()["entries"] == 0
        return got, mid, _seen(s)
    finally:
        s.close()


def test_publish_fetch_roundtrip(tmp_path):
    both(_roundtrip, tmp_path)


def _device_tier(p, tmp):
    bs = p.buffer_store
    s = _store(p, tmp, device_capacity=1 << 20, host_capacity=1 << 30)
    try:
        run = _run(p, dev_lanes=True)
        lanes_nbytes = sum(a.nbytes for a in run.batch.dev_keys
                           if hasattr(a, "nbytes"))
        s.publish("dag1/a0/cons", -1, run)
        assert s.tier_bytes(bs.DEVICE) == lanes_nbytes
        assert s.tier_bytes(bs.HOST) == run.nbytes   # host arrays ride along
        freed = s.relieve_device_pressure(1 << 30)
        assert freed == lanes_nbytes
        assert s.tier_bytes(bs.DEVICE) == 0
        assert s.counters["store.demotions.device_to_host"] == 1
        # demotion dropped the lanes but data stays fetchable bit-exact
        got = s.fetch_partition("dag1/a0/cons", -1, 0)
        assert got.dev_keys is None
        assert _pairs(got) == _pairs(run.partition(0))
        return lanes_nbytes, freed, _pairs(got), _seen(s)
    finally:
        s.close()


def test_device_tier_accounts_lane_bytes_and_demotes(tmp_path):
    both(_device_tier, tmp_path)


def _no_device_capacity(p, tmp):
    s = _store(p, tmp, host_capacity=1 << 20)
    try:
        s.publish("dag1/a0/cons", -1, _run(p, dev_lanes=True))
        assert s.tier_bytes(p.buffer_store.DEVICE) == 0
        assert s.get("dag1/a0/cons", -1).batch.dev_keys is None
        return _seen(s)
    finally:
        s.close()


def test_no_device_capacity_drops_lanes_at_publish(tmp_path):
    both(_no_device_capacity, tmp_path)


# -- watermarks and leases ----------------------------------------------------
def _cascade(p, tmp):
    bs = p.buffer_store
    cap = _run(p, seed=0).nbytes * 3
    s = _store(p, tmp, host_capacity=cap, high_watermark=0.8,
               low_watermark=0.4)
    try:
        runs = [_run(p, seed=i) for i in range(8)]
        for i, r in enumerate(runs):
            s.publish(f"dag1/a{i}/cons", -1, r)
        assert s.counters["store.demotions.host_to_disk"] >= 4
        assert s.tier_bytes(bs.HOST) <= cap * 0.8
        assert s.tier_bytes(bs.DISK) > 0
        # every run still fetchable bit-exact, whichever tier it landed in
        got = []
        for i, r in enumerate(runs):
            for part in range(r.num_partitions):
                batch = s.fetch_partition(f"dag1/a{i}/cons", -1, part)
                assert _pairs(batch) == _pairs(r.partition(part))
                got.append(_pairs(batch))
        return got, _seen(s)
    finally:
        s.close()


def test_watermark_demotion_cascade_host_to_disk(tmp_path):
    both(_cascade, tmp_path)


def _lease_blocks(p, tmp):
    bs = p.buffer_store
    run = _run(p, seed=1)
    s = _store(p, tmp, host_capacity=run.nbytes * 2, high_watermark=0.5,
               low_watermark=0.1)
    try:
        s.publish("dag1/a0/cons", -1, run)
        with s.lease("dag1/a0/cons", -1) as leased:
            view = leased.partition(0)        # zero-copy view under lease
            # pressure that would otherwise demote everything: the leased
            # entry must be skipped even though it is the only candidate
            assert s.relieve_host_pressure(1 << 30) == 0
            s.publish("dag1/a1/cons", -1, _run(p, seed=2))  # breach
            assert s.tier_bytes(bs.HOST) >= run.nbytes     # still resident
            assert _pairs(view) == _pairs(run.partition(0))
            leased_seen = _seen(s)
        # lease released: the same pressure now demotes it
        freed = s.relieve_host_pressure(1 << 30)
        assert freed > 0
        assert s.counters["store.demotions.host_to_disk"] >= 1
        got = s.fetch_partition("dag1/a0/cons", -1, 1)
        assert _pairs(got) == _pairs(run.partition(1))
        return leased_seen, freed, _pairs(got), _seen(s)
    finally:
        s.close()


def test_lease_blocks_demotion_and_eviction(tmp_path):
    both(_lease_blocks, tmp_path)


def _leased_survives(p, tmp):
    s = _store(p, tmp, host_capacity=1 << 20)
    try:
        run = _run(p)
        s.publish("dag1/a0/cons", -1, run)
        with s.lease("dag1/a0/cons", -1) as leased:
            assert s.unregister_prefix("dag1") == 1
            # the alias is gone but the reader's run stays whole until
            # release
            assert not s.contains("dag1/a0/cons", -1)
            assert _pairs(leased.partition(0)) == _pairs(run.partition(0))
        assert s.stats()["entries"] == 0
        assert s.tier_bytes(p.buffer_store.HOST) == 0
        return _seen(s)
    finally:
        s.close()


def test_leased_entry_survives_unregister(tmp_path):
    both(_leased_survives, tmp_path)


def _disk_eviction(p, tmp):
    bs = p.buffer_store
    run = _run(p, seed=3)
    s = _store(p, tmp, host_capacity=run.nbytes,
               disk_capacity=run.nbytes * 2, high_watermark=0.5,
               low_watermark=0.1)
    try:
        # live DAG outputs demoted to disk are never evicted, no matter
        # how far over the disk watermark the tier goes
        for i in range(4):
            s.publish(f"dag1/a{i}/cons", -1, _run(p, seed=10 + i),
                      lineage=f"lin{i}/0/cons")
        assert s.tier_bytes(bs.DISK) > s.disk_capacity * 0.5
        assert s.counters["store.evictions.disk"] == 0
        # sealed lineage-only entries ARE evictable once the DAG aliases go
        assert s.seal_lineage("dag1") == 4
        s.unregister_prefix("dag1")
        s.publish("dag2/a0/cons", -1, _run(p, seed=20))   # enforcement
        assert s.counters["store.evictions.disk"] >= 1
        return _seen(s)
    finally:
        s.close()


def test_disk_eviction_only_touches_sealed_lineage(tmp_path):
    both(_disk_eviction, tmp_path)


# -- byte accounting ----------------------------------------------------------
def _concurrency(p, tmp):
    bs = p.buffer_store
    s = _store(p, tmp, host_capacity=_run(p, seed=0).nbytes * 4,
               high_watermark=0.8, low_watermark=0.4)
    errors = []

    def worker(w: int) -> None:
        try:
            for i in range(12):
                path = f"dag1/w{w}_{i}/cons"
                r = _run(p, seed=w * 100 + i)
                s.publish(path, -1, r)
                got = s.fetch_partition(path, -1, i % r.num_partitions)
                assert got.num_records >= 0
                if i % 3 == 0:
                    s.unregister_prefix(path)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errors, errors
        # invariant: with no leases held, dropping every alias must return
        # every tier to EXACTLY zero — any drift means an accounting bug
        s.unregister_prefix("dag1")
        assert s.stats()["entries"] == 0
        for tier in bs.TIERS:
            assert s.tier_bytes(tier) == 0
        # the interleaving decides which entries demote: the published
        # count and the hit count are the parts both packages must share
        return (s.stats()["bytes"], s.counters["store.published"],
                s.counters["store.hits"])
    finally:
        s.close()


def test_exact_byte_accounting_under_concurrency(tmp_path):
    both(_concurrency, tmp_path)


# -- epoch fencing ------------------------------------------------------------
def _stale_publish(p, tmp):
    s = _store(p, tmp, host_capacity=1 << 20)
    try:
        p.epoch.register("app_x", 3)
        with pytest.raises(p.epoch.EpochFencedError):
            s.publish("dag1/a0/cons", -1, _run(p), epoch=2, app_id="app_x")
        s.publish("dag1/a0/cons", -1, _run(p), epoch=3, app_id="app_x")
        assert s.contains("dag1/a0/cons", -1)
        return _seen(s)
    finally:
        s.close()


def test_stale_epoch_publish_fenced(tmp_path):
    both(_stale_publish, tmp_path)


def _stale_lineage(p, tmp):
    s = _store(p, tmp, host_capacity=1 << 20)
    try:
        p.epoch.register("app_y", 1)
        s.publish("dag1/a0/cons", -1, _run(p), epoch=1, app_id="app_y",
                  lineage="lin1/0/cons")
        assert s.seal_lineage("dag1") == 1
        assert s.lineage_spills("lin1/0/cons") == [-1]
        # AM restarts: entries sealed by the superseded epoch are fenced out
        p.epoch.register("app_y", 2)
        assert s.lineage_spills("lin1/0/cons") == []
        with pytest.raises(p.epoch.EpochFencedError):
            s.republish_lineage("lin1/0/cons", "dag2/a0/cons",
                                epoch=1, app_id="app_y")
        return _seen(s)
    finally:
        s.close()


def test_stale_epoch_sealed_lineage_misses(tmp_path):
    both(_stale_lineage, tmp_path)


# -- lineage lifecycle --------------------------------------------------------
def _seal_republish(p, tmp):
    s = _store(p, tmp, host_capacity=1 << 20)
    try:
        run = _run(p, seed=5)
        s.publish("dag1/a0/cons", -1, run, lineage="linA/0/cons")
        s.publish("dag1/a0/cons", 0, _run(p, seed=6), lineage="linA/0/cons")
        s.publish("dag1/a1/cons", -1, _run(p, seed=7))   # untagged: no seal
        assert s.seal_lineage("dag1") == 2
        assert s.counters["store.lineage.sealed"] == 2
        # the DAG commits and its aliases drop; sealed entries survive
        s.unregister_prefix("dag1")
        assert s.lineage_spills("linA/0/cons") == [-1, 0]
        assert s.lineage_spills("nope") == []
        assert s.counters["store.lineage.misses"] == 1
        # a recurring DAG aliases them under its own path, zero copy
        assert s.republish_lineage("linA/0/cons",
                                   "dag2/a9/cons") == [-1, 0]
        got = s.fetch_partition("dag2/a9/cons", -1, 1)
        assert _pairs(got) == _pairs(run.partition(1))
        # dropping the new DAG still leaves the sealed copy for the next hit
        s.unregister_prefix("dag2")
        assert s.lineage_spills("linA/0/cons") == [-1, 0]
        return _pairs(got), _seen(s)
    finally:
        s.close()


def test_seal_republish_roundtrip(tmp_path):
    both(_seal_republish, tmp_path)


# -- singleton lifecycle ------------------------------------------------------
def _disabled(p, tmp):
    assert p.store.ensure_store({}) is None
    assert p.store.local_buffer_store() is None
    return True


def test_ensure_store_disabled_by_default(tmp_path):
    both(_disabled, tmp_path)


def _knobs(p, tmp):
    svc = p.service.local_shuffle_service()
    conf = {"tez.runtime.store.enabled": "true",
            "tez.runtime.store.device.capacity-mb": 2,
            "tez.runtime.store.host.capacity-mb": 0.5,
            "tez.runtime.store.dir": str(tmp / "s")}
    s = p.store.ensure_store(conf)
    try:
        assert s is not None
        assert s is p.store.local_buffer_store()
        assert p.store.ensure_store(conf) is s             # idempotent
        assert s.device_capacity == 2 << 20
        assert s.host_capacity == (1 << 20) // 2           # fractional MB
        assert svc.buffer_store() is s
        # registrations route through the store via the service seam
        run = _run(p)
        svc.register("dagZ/a0/cons", -1, run)
        assert s.contains("dagZ/a0/cons", -1)
        got = svc.fetch_partition("dagZ/a0/cons", -1, 0)
        assert _pairs(got) == _pairs(run.partition(0))
        assert s.counters["store.hits"] == 1
        seen = _seen(s, _pairs(got))
    finally:
        p.store.reset_store()
    assert p.store.local_buffer_store() is None
    assert svc.buffer_store() is None
    return seen


def test_ensure_store_conf_knobs_and_reset(tmp_path):
    both(_knobs, tmp_path)


def _push_admission(p, tmp):
    svc = p.service.local_shuffle_service()
    conf = {"tez.runtime.store.enabled": "true",
            "tez.runtime.store.dir": str(tmp / "s"),
            "tez.runtime.shuffle.push.enabled": "true",
            "tez.runtime.shuffle.push.source-quota-mb": 3}
    try:
        s = p.store.ensure_store(conf)
        assert s is not None
        adm = svc.push_admission()
        assert adm is not None
        assert adm.source_quota == 3 << 20
        assert p.store.ensure_store(conf) is s             # idempotent
        assert svc.push_admission() is adm
        seen = (adm.source_quota, adm.admit_watermark, adm.retry_after_ms)
    finally:
        p.store.reset_store()
    # reset detaches the landing zone along with the store
    assert svc.push_admission() is None
    return seen


def test_ensure_store_attaches_push_admission(tmp_path):
    both(_push_admission, tmp_path)


def _push_off(p, tmp):
    conf = {"tez.runtime.store.enabled": "true",
            "tez.runtime.store.dir": str(tmp / "s")}
    try:
        assert p.store.ensure_store(conf) is not None
        assert p.service.local_shuffle_service().push_admission() is None
    finally:
        p.store.reset_store()
    return True


def test_ensure_store_push_off_no_admission(tmp_path):
    both(_push_off, tmp_path)


def test_ensure_store_registers_device_pressure_relief(tmp_path):
    """The port's ensure_store makes the store's device relief the out-of-
    memory ladder's hook, as tez_tpu's does: relieve_pressure frees the
    lanes of an idle DEVICE-tier run."""
    def case(p, tmp):
        s = p.store.ensure_store({"tez.runtime.store.enabled": True,
                                  "tez.runtime.store.dir": str(tmp / "s")})
        run = _run(p, dev_lanes=True)
        s.publish("dagD/a0/cons", -1, run)
        freed = p.async_stage.relieve_pressure(1)
        assert freed == run.batch.dev_keys[0].nbytes + \
            run.batch.dev_keys[1].nbytes
        return freed, _seen(s)
    both(case, tmp_path)


# -- tests/test_multitenancy.py: store quotas and the result cache -----------
def _tenant_quota(p, tmp):
    bs = p.buffer_store
    run = _run(p)
    s = _store(p, tmp, host_capacity=1 << 30,
               tenant_host_quota=int(run.nbytes))
    try:
        s.publish("dagA/a0/c", -1, run, tenant="acme")
        with pytest.raises(bs.StoreQuotaExceeded) as ei:
            s.publish("dagA/a1/c", -1, _run(p, seed=1), tenant="acme")
        assert ei.value.tenant == "acme" and ei.value.tier == bs.HOST
        assert s.counters["store.quota.rejected.host"] == 1
        # the quota is per tenant, not global: beta still publishes
        s.publish("dagB/b0/c", -1, _run(p, seed=2), tenant="beta")
        tb = s.tenant_bytes()
        assert set(tb) == {"acme", "beta"}
        assert tb["acme"][bs.HOST] == run.nbytes
        return tb, str(ei.value), _seen(s)
    finally:
        s.close()


def test_tenant_host_quota_rejects_and_isolates(tmp_path):
    both(_tenant_quota, tmp_path)


def _ttl(p, tmp):
    now = [1000.0]
    s = _store(p, tmp, host_capacity=1 << 30, clock=lambda: now[0],
               result_cache_ttl=10.0)
    try:
        s.publish("dagA/a0/c", 0, _run(p), lineage="L1", tenant="acme")
        assert s.seal_lineage("dagA") == 1
        assert s.lineage_spills("L1") == [0]
        now[0] += 11.0
        assert s.lineage_spills("L1") == []
        assert s.counters["store.result_cache.expired"] == 1
        return _seen(s)
    finally:
        s.close()


def test_result_cache_ttl_expires_sealed_entries(tmp_path):
    both(_ttl, tmp_path)


def _second_use(p, tmp):
    s = _store(p, tmp, host_capacity=1 << 30,
               result_cache_admit="second-use")
    try:
        s.publish("dagA/a0/c", 0, _run(p), lineage="L2", tenant="acme")
        # first seal defers: the tag has never been probed (scan resistance)
        assert s.seal_lineage("dagA") == 0
        assert s.counters["store.result_cache.deferred"] == 1
        assert s.lineage_spills("L2") == []       # miss records the tag
        assert s.seal_lineage("dagA") == 1        # second use admits
        assert s.lineage_spills("L2") == [0]
        return _seen(s)
    finally:
        s.close()


def test_result_cache_second_use_admission(tmp_path):
    both(_second_use, tmp_path)


def _tenant_cap(p, tmp):
    run = _run(p)
    s = _store(p, tmp, host_capacity=1 << 30,
               result_cache_bytes=int(run.nbytes))
    try:
        s.publish("dagA/x/c", 0, run, lineage="La", tenant="acme")
        s.publish("dagA/y/c", 0, _run(p, seed=1), lineage="Lb",
                  tenant="acme")
        assert s.seal_lineage("dagA") == 2
        # only one seal fits under the per-tenant cap: the LRU one (La,
        # sealed first, never hit) was evicted to admit Lb
        assert s.counters["store.result_cache.evicted"] == 1
        assert s.lineage_spills("La") == []
        assert s.lineage_spills("Lb") == [0]
        return _seen(s)
    finally:
        s.close()


def test_result_cache_tenant_cap_evicts_lru(tmp_path):
    both(_tenant_cap, tmp_path)


def test_tenant_lineage_eviction_sizes_before_unlink(tmp_path):
    """A kept divergence: tez_tpu's _evict_tenant_lineage reads the run of
    an entry its unlink has just disposed of and raises AttributeError;
    the port sizes the entry first and evicts it."""
    def case(p, tmp):
        s = _store(p, tmp, host_capacity=1)       # every publish demotes
        try:
            s.publish("dag1/a/c", -1, _run(p), lineage="L", tenant="t")
            assert s.seal_lineage("dag1") == 1
            s.unregister_prefix("dag1")
            try:
                s._evict_tenant_lineage("t", 1 << 30, None)
            except AttributeError:
                return "raised", _seen(s)
            return "evicted", _seen(s)
        finally:
            s.close()
    out = [case(pkg(root), tmp_path / root) for root in ROOTS]
    assert out[1][0] == "raised" and out[0][0] == "evicted"
    assert out[0][1][2]["store.evictions.disk"] == 1
    assert out[0][1][1] == 0 and out[0][1][0]["disk"] == 0


# -- session-mode cross-DAG reuse ---------------------------------------------
def _session_reuse(p, tmp):
    corpus = tmp / "in.txt"
    counts = _write_corpus(str(corpus))
    conf = {"tez.staging-dir": str(tmp / "staging"),
            "tez.am.local.num-containers": 4,
            "tez.runtime.store.enabled": True,
            "tez.runtime.store.host.capacity-mb": 64}
    kw = {"device": "cpu"} if p.root == ROOTS[0] else {}
    outs, stats = [], []
    for i, name in enumerate(("sess_run1", "sess_run2")):
        out = str(tmp / f"out{i}")
        dag = p.ordered_wordcount.build_dag(
            [str(corpus)], out, tokenizer_parallelism=3,
            summation_parallelism=2, sorter_parallelism=1)
        with p.tez_client.TezClient.create(name, conf, **kw) as client:
            status = client.submit_dag(dag).wait_for_completion(timeout=90)
        assert status.state is p.dag_client.DAGStatusState.SUCCEEDED
        outs.append(_read_out(out))
        stats.append(p.store.local_buffer_store().stats())
    c = stats[-1]["counters"]
    # run 1 sealed its tokenizer+summation outputs (3 + 2 tasks); run 2
    # hit them — 5 probes (one per task) plus republishes count as hits
    assert c["store.lineage.sealed"] >= 5
    assert c["store.lineage.hits"] >= 5
    assert outs[0] == outs[1]
    total = sum(counts.values())
    assert outs[0].count(b"\n") == len(counts) and total == 1200
    return outs, [s["counters"] for s in stats], stats[-1]["entries"]


def test_session_cross_dag_output_reuse(tmp_path):
    both(_session_reuse, tmp_path)


def _lineage_hashes(p, tmp):
    def plan(extra=None):
        dag = p.ordered_wordcount.build_dag(
            [str(tmp / "in.txt")], str(tmp / "out"),
            tokenizer_parallelism=2, summation_parallelism=2,
            sorter_parallelism=1)
        if extra:
            dag.vertices["summation"].set_conf("x.knob", extra)
        return dag.create_dag_plan()

    lin = p.lineage
    h1, h2 = lin.vertex_lineage_hashes(plan()), \
        lin.vertex_lineage_hashes(plan())
    assert h1 == h2 and set(h1) == {"tokenizer", "summation", "sorter"}
    h3 = lin.vertex_lineage_hashes(plan(extra="v2"))
    assert h3["tokenizer"] == h1["tokenizer"]       # upstream untouched
    assert h3["summation"] != h1["summation"]       # changed vertex
    assert h3["sorter"] != h1["sorter"]             # downstream closure
    assert lin.task_lineage(h1["summation"], 1, "sorter") == \
        f"{h1['summation']}/1/sorter"
    assert lin.task_lineage("", 1, "sorter") == ""  # lineage off
    # the hashes hold the plan's descriptor names, which differ by package
    return sorted(h1), sorted(h3)


def test_lineage_hashes_stable_and_conf_sensitive(tmp_path):
    both(_lineage_hashes, tmp_path)


# -- OrderedWordCount with the store, two DAGs in one client session ---------
#: phase 16 leg A's DAG at TINY_DAG: vector tokenizers, the sum combiner,
#: the device sorter; the chip_smoke harness runs both packages
SESSION_SHAPE = dict(tokenizer_parallelism=4, summation_parallelism=4,
                     sorter_parallelism=1, tokenizer_mode="vector",
                     combine=True)


def test_store_session_matches_tez_tpu(tmp_path, monkeypatch):
    """chip_smoke.run_session: two identical OrderedWordCount DAGs in one
    client with the store on, on both packages: equal part files, untimed
    DAG counters and store counters; the second DAG reuses all 8 tokenizer
    and summation outputs and sorts nothing on the map side."""
    from test_torch_dag import KernelSpy, api_of, corpus, untimed
    paths = corpus(tmp_path, 1, 6000)
    spy = KernelSpy(monkeypatch)
    runs = {}
    for root in ROOTS:
        pkg(root).store.reset_store()
        outs = [str(tmp_path / root / f"out{i}") for i in range(2)]
        descs = [chip_smoke.wordcount_description(paths, o, **SESSION_SHAPE)
                 for o in outs]
        conf = dict(chip_smoke.DAG_CONF, **{
            "tez.am.local.num-containers": 2,
            "tez.runtime.tpu.device.sort.min.records": 0,
            "tez.runtime.store.enabled": True,
            "tez.staging-dir": str(tmp_path / root)})
        calls = []
        sess = chip_smoke.run_session(
            api_of(root), descs, conf,
            between=lambda: calls.append(dict(spy.calls)))
        runs[root] = (sess, [chip_smoke.read_wordcount(o)[0] for o in outs],
                      calls + [dict(spy.calls)])
        for k in spy.calls:
            spy.calls[k] = 0
    (t, t_parts, t_calls), (j, j_parts, _) = runs[ROOTS[0]], runs[ROOTS[1]]
    assert [r.state for r in t.runs] == ["SUCCEEDED"] * 2
    assert [r.state for r in j.runs] == ["SUCCEEDED"] * 2
    assert t_parts[0] == t_parts[1] == j_parts[0] == j_parts[1]
    for a, b in zip(t.runs, j.runs):
        assert untimed(a.counters) == untimed(b.counters)
    assert t.store_counters == j.store_counters
    c1, c2 = t.store_counters
    assert c1["store.published"] > 0 and t.peak_device_bytes[0] > 0
    assert c2["store.lineage.hits"] - c1["store.lineage.hits"] >= 8
    assert t.runs[1].counters["ShuffleStore"]["store.reuse.outputs"] >= 8
    first, second = t_calls[0], {k: t_calls[1][k] - t_calls[0][k]
                                 for k in t_calls[0]}
    assert first["fnv_hash_lanes"] > 0 and first["merge_path_pair"] > 0
    assert sum(second.values()) < sum(first.values())
    assert second["fnv_hash_lanes"] < first["fnv_hash_lanes"]


# -- the out-of-memory ladder evicts store lanes before it splits ------------
def _oom_ladder(p, tmp, monkeypatch, with_store):
    """An injected device.dispatch.oom on the first span of an async
    sorter.  With a DEVICE-tier run in the store, the ladder's relief
    demotes the run's lanes and the whole span retries on the device: no
    halving.  Without a store nothing is evictable and the span is
    halved.  Either way the run equals the fault-free one."""
    splits = []
    real = p.sorter.DeviceSorter._split_device_sort

    def spy(self, *a, **kw):
        splits.append(1)
        return real(self, *a, **kw)
    monkeypatch.setattr(p.sorter.DeviceSorter, "_split_device_sort", spy)
    lanes = 0
    if with_store:
        s = p.store.ensure_store({"tez.runtime.store.enabled": True,
                                  "tez.runtime.store.dir": str(tmp / "s")})
        resident = _run(p, n=4096, dev_lanes=True)
        s.publish("dagO/a0/cons", -1, resident)
        lanes = sum(a.nbytes for a in resident.batch.dev_keys
                    if hasattr(a, "nbytes"))

    def flush(spec):
        counters = p.counters.TezCounters()
        kw = {"device": "cpu"} if p.root == ROOTS[0] else {}
        sorter = p.sorter.DeviceSorter(
            num_partitions=3, engine="device", pipeline_depth=2,
            span_budget_bytes=64 << 10, device_min_records=0,
            split_min_bytes=1 << 10, counters=counters, **kw)
        if spec:
            p.faults.install("t", p.faults.parse_spec(spec), seed=1)
        try:
            rng = np.random.default_rng(7)
            for i in rng.integers(0, 50_000, 12_000):
                sorter.write(b"w%05d" % i, b"\x00" * 8)
            run = sorter.flush()
        finally:
            p.faults.clear_all()
        return run, counters.to_dict().get("DeviceFailover", {})

    clean, _ = flush("")
    run, failover = flush("device.dispatch.oom:fail:n=1,match=span=0")
    assert chip_smoke.run_bytes(run) == chip_smoke.run_bytes(clean)
    assert failover.get("device.oom.split_attempts", 0) == 1
    if with_store:
        st = p.store.local_buffer_store().stats()
        assert st["counters"]["store.demotions.device_to_host"] == 1
        assert st["bytes"]["device"] == 0
        assert failover.get("device.oom.evict_relief", 0) == 1
        assert failover.get("device.oom.evicted_bytes", 0) == lanes
        assert splits == []
        return chip_smoke.run_bytes(run), st, failover
    assert failover.get("device.oom.evict_relief", 0) == 0
    assert len(splits) >= 1
    return chip_smoke.run_bytes(run), failover, len(splits)


@pytest.mark.parametrize("with_store", [True, False],
                         ids=["store", "no_store"])
def test_oom_ladder_drops_store_lanes_before_splitting(tmp_path, monkeypatch,
                                                       with_store):
    both(_oom_ladder, tmp_path, monkeypatch, with_store)


def test_store_phase_on_the_host():
    """chip_smoke's phase 16 at TINY_STORE on the CPU, over phase 15(b)'s
    tiny corpus and its host-exchange part file: the session with reuse,
    push through a small host tier with demotions, and push in runner
    processes abandoned to the pull backstop, every part file 15(b)'s."""
    from tez_tpu_torch.parallel import coordinator
    args = types.SimpleNamespace(seed=0)
    coordinator.reset_coordinator()
    import tempfile
    with tempfile.TemporaryDirectory(prefix="tez_store_") as root:
        tiny = chip_smoke.TINY_MESH
        corpus = chip_smoke.DagCorpus(
            root, args, marks_mb=(tiny["mesh_mb"],),
            **chip_smoke.corpus_sizes(tiny))
        mesh = chip_smoke.mesh_phase(args, device="cpu", corpus=corpus,
                                     **tiny)
        chip_smoke.store_phase(args, corpus, mesh["host_part"],
                               device="cpu", **chip_smoke.TINY_STORE)


def test_admission_store_pressure_matches_tez_tpu(tmp_path):
    """The AM's store-watermark gate (am/admission.py _store_pressure) on
    both packages: a host tier past tez.am.session.admit.store-watermark
    is relieved to disk and admits; with the only entry leased, relief
    cannot help and the gate sheds."""
    def case(p, tmp):
        config = importlib.import_module(f"{p.root}.common.config")
        admission = importlib.import_module(f"{p.root}.am.admission")
        am = types.SimpleNamespace(
            app_id="app_press", conf=config.TezConfiguration(
                {"tez.am.session.admit.store-watermark": 0.5}))
        ctl = admission.AdmissionController(am)
        try:
            run = _run(p, n=256)
            s = p.store.ensure_store({
                "tez.runtime.store.enabled": True,
                "tez.runtime.store.dir": str(tmp / "s"),
                "tez.runtime.store.host.capacity-mb":
                    run.nbytes * 1.5 / (1 << 20)})
            assert ctl._store_pressure() is False        # empty tier
            s.publish("dagP/a0/c", -1, run)
            over = s.tier_bytes(p.buffer_store.HOST)
            assert ctl._store_pressure() is False        # relieved to disk
            relieved = _seen(s)
            s.publish("dagP/a1/c", -1, _run(p, n=256, seed=1))
            with s.lease("dagP/a1/c", -1):
                assert ctl._store_pressure() is True     # leased: sheds
            return over, relieved, _seen(s)
        finally:
            ctl.stop()
            p.store.reset_store()
    both(case, tmp_path)
