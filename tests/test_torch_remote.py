"""Port parity of the TCP shuffle (shuffle/server.py, scheduler.py,
native_server.py with native/shuffle_server.cpp), its security
(common/security.py, common/tls.py) and the umbilical handshake
(am/umbilical_server.py) against tez_tpu's, on the CPU.

Every case of tests/test_shuffle_server.py, test_fetch_scheduler.py,
test_native_shuffle_server.py and test_secure_shuffle.py (their DAG cases
are in tests/test_torch_remote_dag.py) runs on both packages as one
parametrised test, the port with device="cpu".  One change to a case: the
plaintext client of the TLS round trip waits 2 s for the server's nonce,
not its default 30 s; the TLS server answers it with nothing either way.

Wire parity: each package's FetchSession fetches from the other package's
Python and native servers, batch for batch, and each server refuses the
other's fetch under a wrong job token.  File parity: both packages'
FileShuffleStore write the same blob and index bytes for the same runs.
No fallback: a runner asked for a card that is absent, or whose native
server cannot start, exits non-zero with the reason on stderr; with
shuffle TLS on, the native directory is ignored with a warning.
"""
import datetime
import importlib
import json
import os
import socket
import ssl
import struct
import subprocess
import sys
import threading
import time
import types
from typing import Dict, List, Optional, Tuple

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOTS = ("tez_tpu_torch", "tez_tpu")


def pkg(root: str) -> types.SimpleNamespace:
    """The modules of one package that these cases use, by tez_tpu's
    module names."""
    def mod(name):
        return importlib.import_module(f"{root}.{name}")
    ns = types.SimpleNamespace(root=root)
    for name in ("common.security", "common.tls", "common.epoch",
                 "common.counters", "api.events", "ops.runformat",
                 "ops.sorter", "shuffle.server", "shuffle.scheduler",
                 "shuffle.service", "shuffle.native_server",
                 "library.inputs", "library.test_components",
                 "am.umbilical_server"):
        setattr(ns, name.rsplit(".", 1)[1], mod(name))
    return ns


def sorter_of(p, **kw):
    if p.root == ROOTS[0]:
        kw["device"] = "cpu"
    return p.sorter.DeviceSorter(**kw)


@pytest.fixture(params=ROOTS)
def p(request):
    return pkg(request.param)


@pytest.fixture(autouse=True)
def _fresh_epochs():
    for root in ROOTS:
        pkg(root).epoch.reset()
    yield
    for root in ROOTS:
        pkg(root).epoch.reset()


# -- tests/test_shuffle_server.py, on both packages ---------------------------
@pytest.fixture()
def served_run(p):
    service = p.service.ShuffleService()
    sorter = sorter_of(p, num_partitions=3)
    for i in range(100):
        sorter.write(f"k{i:03d}".encode(), f"v{i}".encode())
    run = sorter.flush()
    service.register("dagX/attempt_1/cons", -1, run)
    secrets = p.security.JobTokenSecretManager()
    server = p.server.ShuffleServer(secrets, service).start()
    yield server, secrets, run
    server.stop()


def test_fetch_roundtrip(p, served_run):
    server, secrets, run = served_run
    fetcher = p.server.ShuffleFetcher(secrets)
    for part in range(3):
        got = fetcher.fetch("127.0.0.1", server.port, "dagX/attempt_1/cons",
                            -1, part)[0]
        assert list(got.iter_pairs()) == list(run.partition(part).iter_pairs())


def test_fetch_partition_range_keepalive(p, served_run):
    server, secrets, run = served_run
    fetcher = p.server.ShuffleFetcher(secrets)
    got = fetcher.fetch("127.0.0.1", server.port, "dagX/attempt_1/cons",
                        -1, 0, 3)
    assert len(got) == 3
    assert sum(b.num_records for b in got) == run.batch.num_records


def test_bad_hmac_rejected(p, served_run):
    server, secrets, _ = served_run
    wrong = p.security.JobTokenSecretManager(b"not-the-secret" * 2)
    fetcher = p.server.ShuffleFetcher(wrong, retries=1)
    with pytest.raises(PermissionError):
        fetcher.fetch("127.0.0.1", server.port, "dagX/attempt_1/cons", -1, 0)
    assert server.auth_failures >= 1


def test_missing_data_not_found(p, served_run):
    server, secrets, _ = served_run
    fetcher = p.server.ShuffleFetcher(secrets)
    with pytest.raises(p.service.ShuffleDataNotFound):
        fetcher.fetch("127.0.0.1", server.port, "nope/nope", -1, 0)


def test_stale_epoch_fetch_fenced(p, served_run):
    server, secrets, run = served_run
    p.epoch.register("app_1_zfetch", 2)   # AM restarted: epoch 2 live
    stale = p.server.ShuffleFetcher(secrets, retries=1, epoch=1,
                                    app_id="app_1_zfetch")
    with pytest.raises(PermissionError, match="fenced"):
        stale.fetch("127.0.0.1", server.port, "dagX/attempt_1/cons", -1, 0)
    for fetcher in (p.server.ShuffleFetcher(secrets),
                    p.server.ShuffleFetcher(secrets, epoch=2,
                                            app_id="app_1_zfetch")):
        got = fetcher.fetch("127.0.0.1", server.port, "dagX/attempt_1/cons",
                            -1, 0)[0]
        assert list(got.iter_pairs()) == list(run.partition(0).iter_pairs())


def test_connection_refused_retries_then_raises(p):
    fetcher = p.server.ShuffleFetcher(p.security.JobTokenSecretManager(),
                                      retries=2, backoff=0.01)
    with pytest.raises(ConnectionError, match="after 2 tries"):
        fetcher.fetch("127.0.0.1", 1, "x", -1, 0)  # port 1: refused


def test_acl_manager(p):
    s = p.security
    acls = s.ACLManager("owner", s.DAGAccessControls(view_users=("alice",),
                                                     modify_users=()))
    assert acls.check_view_access("owner")
    assert acls.check_view_access("alice")
    assert not acls.check_view_access("mallory")
    assert not acls.check_modify_access("alice")
    open_acls = s.ACLManager("owner")
    assert open_acls.check_view_access("anyone")
    assert not open_acls.check_modify_access("anyone")
    off = s.ACLManager("owner", s.DAGAccessControls(view_users=()),
                       enabled=False)
    assert off.check_view_access("x") and off.check_modify_access("x")
    assert s.ACLManager("o", s.DAGAccessControls(modify_users=("*",))
                        ).check_modify_access("x")


def test_token_hash_roundtrip(p):
    s = p.security.JobTokenSecretManager()
    h = s.compute_hash(b"msg")
    assert s.verify_hash(h, b"msg")
    assert not s.verify_hash(h, b"other")
    assert not p.security.JobTokenSecretManager().verify_hash(h, b"msg")


def test_request_hmac_matches_tez_tpu():
    """The canonical request bytes and their HMAC are tez_tpu's."""
    t, j = pkg(ROOTS[0]).security, pkg(ROOTS[1]).security
    nonce = bytes(range(16))
    for args in (("dag_1/a/r", -1, 0, 1), ("p/é/x", 7, 2, 9)):
        assert t.shuffle_request_msg(*args, nonce) == \
            j.shuffle_request_msg(*args, nonce)
        assert t.hash_from_request(t.JobTokenSecretManager(b"k" * 32), *args,
                                   nonce) == \
            j.hash_from_request(j.JobTokenSecretManager(b"k" * 32), *args,
                                nonce)


def _signed_request(p, secrets, nonce, lo, hi, signed_hi=None):
    return json.dumps({
        "path": "dagX/attempt_1/cons", "spill": -1,
        "partition_lo": lo, "partition_hi": hi,
        "hmac": p.security.hash_from_request(
            secrets, "dagX/attempt_1/cons", -1, lo,
            hi if signed_hi is None else signed_hi, nonce).hex(),
    }).encode()


def _exchange(port: int, build) -> dict:
    """One request on a fresh connection: build(nonce) -> request bytes;
    returns the reply header."""
    with socket.create_connection(("127.0.0.1", port)) as sk:
        fh = sk.makefile("rb")
        nonce = fh.read(16)
        assert len(nonce) == 16
        req = build(nonce)
        sk.sendall(struct.pack("<I", len(req)) + req)
        (hdr_len,) = struct.unpack("<I", fh.read(4))
        return json.loads(fh.read(hdr_len))


def test_request_replay_on_new_connection_rejected(p, served_run):
    server, secrets, _ = served_run
    captured = []

    def capture(nonce):
        captured.append(_signed_request(p, secrets, nonce, 0, 1))
        return captured[0]
    assert _exchange(server.port, capture)["status"] == "ok"
    assert _exchange(server.port, lambda _n: captured[0])["status"] == \
        "forbidden"
    assert server.auth_failures >= 1


def test_hmac_covers_partition_range(p, served_run):
    server, secrets, _ = served_run
    header = _exchange(server.port, lambda n: _signed_request(
        p, secrets, n, 0, 3, signed_hi=1))    # widened after signing
    assert header["status"] == "forbidden"


def _pipe_pair():
    """A blocking in-memory byte pipe exposing (reader, writer) file-likes;
    the writer also records everything written (for capture tests)."""
    class _Chan:
        def __init__(self):
            self.buf = bytearray()
            self.captured = bytearray()
            self.cond = threading.Condition()

        def read(self, n):
            with self.cond:
                while len(self.buf) < n:
                    if not self.cond.wait(5.0):
                        return bytes(self.buf)   # timeout: short read
                out = bytes(self.buf[:n])
                del self.buf[:n]
                return out

        def write(self, b):
            with self.cond:
                self.buf.extend(b)
                self.captured.extend(b)
                self.cond.notify_all()

        def flush(self):
            pass

    ch = _Chan()
    return ch, ch


def test_umbilical_handshake_not_replayable(p):
    u = p.umbilical_server
    secrets = p.security.JobTokenSecretManager()
    s2c_r, s2c_w = _pipe_pair()
    c2s_r, c2s_w = _pipe_pair()
    ok = {}
    t = threading.Thread(target=lambda: ok.__setitem__(
        "server", u.authenticate_stream(c2s_r, s2c_w, secrets,
                                        b"umbilical-hello")))
    t.start()
    u.client_handshake(s2c_r, c2s_w, secrets, b"umbilical-hello")
    t.join()
    assert ok["server"] is True
    captured = bytes(c2s_w.captured)
    s2c_r2, s2c_w2 = _pipe_pair()
    c2s_r2, c2s_w2 = _pipe_pair()
    c2s_w2.write(captured[:32])   # replayed signature, ignores new nonce
    assert u.authenticate_stream(c2s_r2, s2c_w2, secrets,
                                 b"umbilical-hello") is False


def test_fetch_session_many_fetches_one_connection(p, served_run):
    server, secrets, run = served_run
    s = p.server.FetchSession(secrets, "127.0.0.1", server.port)
    try:
        for part in range(3):
            got = s.fetch("dagX/attempt_1/cons", -1, part)
            assert list(got.iter_pairs()) == \
                list(run.partition(part).iter_pairs())
        with pytest.raises(p.service.ShuffleDataNotFound):
            s.fetch("no/such/output", -1, 0)
        got = s.fetch("dagX/attempt_1/cons", -1, 1)
        assert got.num_records == run.partition(1).num_records
    finally:
        s.close()


def test_push_request_refused_by_the_port():
    """A push to a process whose service has no landing zone (no buffer
    store, no push admission) is drained and refused with "retry", as
    tez_tpu's server answers it, and the connection keeps serving fetches;
    a push under a wrong token is forbidden.  tests/test_torch_push.py
    holds the push that lands against tez_tpu's."""
    p = pkg(ROOTS[0])
    service = p.service.ShuffleService()
    run = p.runformat.Run(p.runformat.KVBatch.from_pairs([(b"k", b"v")]),
                          np.array([0, 1], dtype=np.int64))
    service.register("src", -1, run)
    secrets = p.security.JobTokenSecretManager()
    server = p.server.ShuffleServer(secrets, service).start()
    blob = run.to_bytes()
    try:
        for token, status in ((secrets, "retry"),
                              (p.security.JobTokenSecretManager(),
                               "forbidden")):
            with socket.create_connection(("127.0.0.1", server.port)) as sk:
                fh = sk.makefile("rb")
                nonce = fh.read(16)
                req = json.dumps({
                    "op": "push", "path": "dst", "spill": 0,
                    "partition_lo": 0, "partition_hi": 1,
                    "sizes": [len(blob)],
                    "hmac": p.security.hash_from_request(
                        token, "dst", 0, 0, 1, nonce).hex()}).encode()
                sk.sendall(struct.pack("<I", len(req)) + req + blob)
                (n,) = struct.unpack("<I", fh.read(4))
                assert json.loads(fh.read(n))["status"] == status
                # still framed: a fetch on the same connection is served
                req = json.dumps({
                    "path": "src", "spill": -1, "partition_lo": 0,
                    "partition_hi": 1,
                    "hmac": p.security.hash_from_request(
                        secrets, "src", -1, 0, 1, nonce).hex()}).encode()
                sk.sendall(struct.pack("<I", len(req)) + req)
                (n,) = struct.unpack("<I", fh.read(4))
                assert json.loads(fh.read(n))["status"] == "ok"
    finally:
        server.stop()


# -- tests/test_fetch_scheduler.py, on both packages --------------------------
class FakeSession:
    def __init__(self, hub: "FakeHub", host: str, port: int):
        self.hub = hub
        self.host = host
        self.port = port
        self.closed = False

    def fetch(self, path: str, spill: int, partition: int):
        return self.hub.serve(self, path, spill, partition)

    def close(self) -> None:
        self.closed = True


class FakeHub:
    """Injectable fetcher backend: scripted failures per host."""

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.sessions: List[FakeSession] = []
        self.fetches: List[Tuple[str, str, int, int]] = []
        self.fail_hosts: Dict[str, int] = {}
        self.hang_hosts: set = set()
        self.concurrent = 0
        self.max_concurrent = 0
        self.per_session_fetches: Dict[int, int] = {}

    def factory(self, host: str, port: int):
        s = FakeSession(self, host, port)
        with self.lock:
            self.sessions.append(s)
            self.concurrent += 1
            self.max_concurrent = max(self.max_concurrent, self.concurrent)
        real_close = s.close

        def close():
            with self.lock:
                self.concurrent -= 1
            real_close()
        s.close = close
        return s

    def serve(self, session: FakeSession, path: str, spill: int,
              partition: int):
        with self.lock:
            self.fetches.append((session.host, path, spill, partition))
            self.per_session_fetches[id(session)] = \
                self.per_session_fetches.get(id(session), 0) + 1
            if self.fail_hosts.get(session.host, 0) > 0:
                self.fail_hosts[session.host] -= 1
                raise ConnectionError(f"scripted failure on {session.host}")
        if session.host in self.hang_hosts:
            time.sleep(10.0)
        return f"data:{path}:{spill}:{partition}"


class Collector:
    def __init__(self) -> None:
        self.lock = threading.Condition()
        self.ok: List[Tuple] = []
        self.errors: List[Tuple] = []

    def deliver(self, req, batch, error: Optional[Exception]):
        with self.lock:
            if error is None:
                self.ok.append((req.key, batch))
            else:
                self.errors.append((req.key, error))
            self.lock.notify_all()

    def wait(self, n: int, timeout: float = 10.0) -> None:
        with self.lock:
            assert self.lock.wait_for(
                lambda: len(self.ok) + len(self.errors) >= n, timeout), \
                (self.ok, self.errors)


def _mk(p, hub, collector, **kw):
    defaults = dict(num_fetchers=4, max_per_fetch=8, penalty_base=0.05,
                    penalty_cap=0.4, max_attempts=3, stall_timeout=30.0)
    defaults.update(kw)
    return p.scheduler.FetchScheduler(collector.deliver, hub.factory,
                                      **defaults)


def test_coalesces_one_host_into_few_sessions(p):
    hub, col = FakeHub(), Collector()
    sched = _mk(p, hub, col)
    try:
        for i in range(16):
            sched.enqueue(p.scheduler.FetchRequest("h1", 1, f"out{i}", -1, 0))
        col.wait(16)
        assert len(col.ok) == 16 and not col.errors
        assert len(hub.sessions) <= 4
        assert max(hub.per_session_fetches.values()) >= 4
    finally:
        sched.stop()


def test_bounded_fetcher_pool(p):
    hub, col = FakeHub(), Collector()
    sched = _mk(p, hub, col, num_fetchers=3)
    try:
        for i in range(32):
            sched.enqueue(p.scheduler.FetchRequest(f"h{i % 16}", 1,
                                                   f"out{i}", -1, 0))
        col.wait(32)
        assert len(col.ok) == 32
        assert hub.max_concurrent <= 3
    finally:
        sched.stop()


def test_penalty_box_backoff_then_recovery(p):
    hub, col = FakeHub(), Collector()
    hub.fail_hosts["bad"] = 2

    class MaxDraw:
        @staticmethod
        def uniform(a, b):
            return b

    sched = _mk(p, hub, col, num_fetchers=2, penalty_rng=MaxDraw())
    try:
        t0 = time.time()
        for i in range(4):
            sched.enqueue(p.scheduler.FetchRequest("bad", 1, f"out{i}", -1,
                                                   0))
        col.wait(4, timeout=15)
        elapsed = time.time() - t0
        assert len(col.ok) == 4 and not col.errors
        assert elapsed >= 0.1
        assert sched.hosts[("bad", 1)].failures == 0
    finally:
        sched.stop()


def test_retry_budget_exhaustion_delivers_error(p):
    hub, col = FakeHub(), Collector()
    hub.fail_hosts["dead"] = 10_000
    sched = _mk(p, hub, col, max_attempts=3)
    try:
        sched.enqueue(p.scheduler.FetchRequest("dead", 1, "out0", -1, 0))
        col.wait(1, timeout=15)
        assert not col.ok and len(col.errors) == 1
        key, err = col.errors[0]
        assert key == ("out0", -1, 0)
        assert isinstance(err, ConnectionError)
    finally:
        sched.stop()


def test_definitive_miss_no_retry(p):
    hub, col = FakeHub(), Collector()
    miss = p.service.ShuffleDataNotFound

    class MissSession(FakeSession):
        def fetch(self, path, spill, partition):
            self.hub.fetches.append((self.host, path, spill, partition))
            raise miss(path)

    sched = p.scheduler.FetchScheduler(
        col.deliver, lambda h, port: MissSession(hub, h, port),
        num_fetchers=1, penalty_base=0.05, max_attempts=3)
    try:
        sched.enqueue(p.scheduler.FetchRequest("h", 1, "gone", -1, 0))
        col.wait(1)
        assert len(col.errors) == 1
        assert isinstance(col.errors[0][1], miss)
        assert len(hub.fetches) == 1
        assert not sched.penalties
    finally:
        sched.stop()


def test_speculative_refetch_rescues_stalled_connection(p):
    hub, col = FakeHub(), Collector()
    hub.hang_hosts.add("slow")
    sched = _mk(p, hub, col, num_fetchers=2, stall_timeout=0.3)
    try:
        sched.enqueue(p.scheduler.FetchRequest("slow", 1, "out0", -1, 0))
        time.sleep(0.5)
        hub.hang_hosts.discard("slow")
        col.wait(1, timeout=10)
        assert len(col.ok) == 1 and not col.errors
        assert len(hub.sessions) >= 2
    finally:
        sched.stop()


def test_duplicate_enqueue_same_key_delivered_once(p):
    hub, col = FakeHub(), Collector()
    sched = _mk(p, hub, col)
    try:
        sched.enqueue(p.scheduler.FetchRequest("h", 1, "o", 0, 2))
        col.wait(1)
        sched.enqueue(p.scheduler.FetchRequest("h", 1, "o", 0, 2))
        time.sleep(0.2)
        assert len(col.ok) == 1
    finally:
        sched.stop()


def test_table_injectable_fetcher_conf_seam(p):
    """tez.runtime.shuffle.fetcher.class: a ShuffleFetchTable with remote
    payloads routes fetches through the injected session class, retries
    scripted failures via the penalty box, and completes; each remote
    fetch counts in NUM_SHUFFLED_INPUTS and not in LOCAL_SHUFFLED_INPUTS."""
    rf = p.runformat
    scripted = p.test_components.ScriptedFetchSession

    class _Payload:
        def load(self):
            return {}

    class _Ctx:
        def __init__(self):
            self.counters = p.counters.TezCounters()
            self.conf = {
                "tez.runtime.shuffle.fetcher.class":
                    f"{p.root}.library.test_components:ScriptedFetchSession",
                "tez.runtime.shuffle.host.penalty.base-ms": 20,
                "tez.runtime.shuffle.fetch.attempts": 5,
            }
            self.user_payload = _Payload()
            self.events = []

        def get_service_provider_metadata(self, name):
            return {"host": "local", "port": 0, "secret": b"s"}

        def send_events(self, evs):
            self.events.extend(evs)

        def notify_progress(self):
            pass

    svc = p.service.local_shuffle_service()
    golden = []
    for i in range(4):
        batch = rf.KVBatch.from_pairs([(f"k{i}{j}".encode(), b"v")
                                       for j in range(5)])
        golden.append(list(batch.iter_pairs()))
        svc.register(f"prod{i}", -1,
                     rf.Run(batch, np.array([0, 5], dtype=np.int64)))
    scripted.reset(fail_remaining=2)
    ctx = _Ctx()
    table = p.inputs.ShuffleFetchTable(ctx, num_slots=4, my_partition=0)
    try:
        for i in range(4):
            table.on_payload(i, 0, p.events.ShufflePayload(
                host="far-host", port=9, path_component=f"prod{i}"))
        batches = table.wait_all(timeout=20)
        got = sorted(pair for b in batches for pair in b.iter_pairs())
        assert got == sorted(pair for g in golden for pair in g)
        assert len(scripted.fetch_log) >= 4 + 2
        task = ctx.counters.to_dict()["TaskCounter"]
        assert task["NUM_SHUFFLED_INPUTS"] == 4
        assert "LOCAL_SHUFFLED_INPUTS" not in task
        assert task["SHUFFLE_BYTES"] == sum(
            b.nbytes for b in batches)
    finally:
        table.shutdown()
        for i in range(4):
            svc.unregister_prefix(f"prod{i}")


def test_remote_payload_without_a_secret_reports_a_read_error(p):
    """A consumer with no job token reports an InputReadErrorEvent (not a
    local fetch failure) for a payload from another process."""
    class _Payload:
        def load(self):
            return {}

    class _Ctx:
        counters = p.counters.TezCounters()
        conf: dict = {}
        user_payload = _Payload()
        events: list = []

        def get_service_provider_metadata(self, name):
            return {"host": "here", "port": 7}

        def send_events(self, evs):
            self.events.extend(evs)

    ctx = _Ctx()
    table = p.inputs.ShuffleFetchTable(ctx, 1, my_partition=0)
    table.on_payload(0, 0, p.events.ShufflePayload("there", 13562,
                                                   "dag_1/a/r"))
    (ev,) = ctx.events
    assert type(ev).__name__ == "InputReadErrorEvent"
    assert not ev.is_local_fetch and "no shuffle secret" in ev.diagnostics


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _wait_cached(sched, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with sched.lock:
            if sched._session_cache:
                return
        time.sleep(0.005)
    raise AssertionError("session never cached")


def test_stale_cached_session_discarded_at_checkout(p):
    hub, col = FakeHub(), Collector()
    clk = FakeClock()
    sched = _mk(p, hub, col, session_ttl=5.0, clock=clk, stall_timeout=1e9)
    try:
        sched.enqueue(p.scheduler.FetchRequest("h1", 1, "a", -1, 0))
        col.wait(1)
        _wait_cached(sched)
        clk.advance(10.0)
        sched.enqueue(p.scheduler.FetchRequest("h1", 1, "b", -1, 0))
        col.wait(2)
        assert len(col.ok) == 2 and not col.errors
        assert len(hub.sessions) == 2
        assert hub.sessions[0].closed
        _wait_cached(sched)
        assert not hub.sessions[1].closed
        with sched.lock:
            assert sched._open_sessions == 1
    finally:
        sched.stop()


class GateHub(FakeHub):
    def __init__(self) -> None:
        super().__init__()
        self.gate = threading.Event()
        self.entered = threading.Event()

    def serve(self, session, path, spill, partition):
        if path == "slow":
            self.entered.set()
            assert self.gate.wait(10)
        return super().serve(session, path, spill, partition)


def test_ttl_sweep_never_closes_checked_out_session(p):
    hub, col = GateHub(), Collector()
    clk = FakeClock()
    sched = _mk(p, hub, col, session_ttl=5.0, clock=clk, stall_timeout=1e9)
    try:
        sched.enqueue(p.scheduler.FetchRequest("h1", 1, "fast", -1, 0))
        col.wait(1)
        _wait_cached(sched)
        sched.enqueue(p.scheduler.FetchRequest("h1", 1, "slow", -1, 0))
        assert hub.entered.wait(5)
        assert len(hub.sessions) == 1
        clk.advance(50.0)
        with sched.lock:
            sched.lock.notify_all()
        time.sleep(0.1)
        assert not hub.sessions[0].closed
        hub.gate.set()
        col.wait(2)
        assert len(col.ok) == 2 and not col.errors
        assert len(hub.sessions) == 1
    finally:
        sched.stop()


def test_local_probe_short_circuits_store_hits(p):
    hub, col = FakeHub(), Collector()

    def probe(path, spill, partition):
        if path.startswith("here"):
            return f"store:{path}:{spill}:{partition}"
        return None

    sched = _mk(p, hub, col, local_probe=probe)
    try:
        for i in range(4):
            sched.enqueue(p.scheduler.FetchRequest("h1", 1, f"here{i}", -1,
                                                   0))
            sched.enqueue(p.scheduler.FetchRequest("h1", 1, f"far{i}", -1, 0))
        col.wait(8)
        assert len(col.ok) == 8 and not col.errors
        store_served = {k[0] for k, b in col.ok
                        if str(b).startswith("store:")}
        assert store_served == {f"here{i}" for i in range(4)}
        assert all(path.startswith("far") for (_, path, _, _) in hub.fetches)
        assert len(hub.fetches) == 4
    finally:
        sched.stop()


def test_local_probe_all_hits_opens_no_connection(p):
    hub, col = FakeHub(), Collector()
    sched = _mk(p, hub, col,
                local_probe=lambda path, s, pt: f"store:{path}:{s}:{pt}")
    try:
        for i in range(6):
            sched.enqueue(p.scheduler.FetchRequest("h1", 1, f"here{i}", -1,
                                                   i))
        col.wait(6)
        assert len(col.ok) == 6 and not col.errors
        assert hub.sessions == [] and hub.fetches == []
    finally:
        sched.stop()


# -- tests/test_native_shuffle_server.py, on both packages --------------------
def _make_run(p, num_partitions=3, rows_per=4, seed=0):
    rng = np.random.default_rng(seed)
    n = num_partitions * rows_per
    keys = [f"k{seed}_{i:03d}".encode() for i in range(n)]
    vals = [rng.integers(0, 256, 8, dtype=np.int64).astype(np.uint8)
            .tobytes() for i in range(n)]
    kb = np.frombuffer(b"".join(keys), dtype=np.uint8)
    ko = np.cumsum([0] + [len(k) for k in keys]).astype(np.int64)
    vb = np.frombuffer(b"".join(vals), dtype=np.uint8)
    vo = np.cumsum([0] + [len(v) for v in vals]).astype(np.int64)
    row_index = (np.arange(num_partitions + 1) * rows_per).astype(np.int64)
    return p.runformat.Run(p.runformat.KVBatch(kb, ko, vb, vo), row_index)


@pytest.fixture()
def native(p, tmp_path):
    if not p.native_server.native_available():
        pytest.skip(f"{p.root}'s host library is unavailable (no C++ "
                    f"toolchain)")
    secrets = p.security.JobTokenSecretManager()
    store = p.native_server.FileShuffleStore(str(tmp_path / "store"))
    srv = p.native_server.NativeShuffleServer(secrets,
                                              str(tmp_path / "store"))
    yield secrets, store, srv
    srv.stop()


def _batches_equal(a, b) -> bool:
    return (a.num_records == b.num_records and
            np.array_equal(a.key_bytes, b.key_bytes) and
            np.array_equal(a.key_offsets, b.key_offsets) and
            np.array_equal(a.val_bytes, b.val_bytes) and
            np.array_equal(a.val_offsets, b.val_offsets))


def test_fetch_parity_with_python_client(p, native):
    secrets, store, srv = native
    run = _make_run(p)
    store.register("v/task0/out", 0, run)
    fetcher = p.server.ShuffleFetcher(secrets)
    for part in range(3):
        got = fetcher.fetch("127.0.0.1", srv.port, "v/task0/out", 0, part)
        assert len(got) == 1
        assert _batches_equal(got[0], run.partition(part))
    assert srv.bytes_served > 0


def test_range_fetch_and_keepalive(p, native):
    secrets, store, srv = native
    store.register("v/t/out", 2, _make_run(p, seed=1))
    sess = p.server.FetchSession(secrets, "127.0.0.1", srv.port)
    try:
        got = sess.fetch_range("v/t/out", 2, 0, 3)
        assert [b.num_records for b in got] == [4, 4, 4]
        again = sess.fetch_range("v/t/out", 2, 1, 2)
        assert _batches_equal(again[0], got[1])
    finally:
        sess.close()


def test_auth_rejected(p, native):
    secrets, store, srv = native
    store.register("v/x/out", 0, _make_run(p, seed=2))
    wrong = p.server.ShuffleFetcher(p.security.JobTokenSecretManager())
    with pytest.raises(PermissionError):
        wrong.fetch("127.0.0.1", srv.port, "v/x/out", 0, 0)
    assert srv.auth_failures >= 1


def test_missing_and_out_of_range(p, native):
    secrets, store, srv = native
    store.register("v/y/out", 0, _make_run(p, seed=3))
    fetcher = p.server.ShuffleFetcher(secrets)
    with pytest.raises(p.service.ShuffleDataNotFound):
        fetcher.fetch("127.0.0.1", srv.port, "v/NOPE/out", 0, 0)
    with pytest.raises(p.service.ShuffleDataNotFound):
        fetcher.fetch("127.0.0.1", srv.port, "v/y/out", 0, 7)


def test_store_deletion_tracker(p, tmp_path):
    store = p.native_server.FileShuffleStore(str(tmp_path))
    store.register("dagA/v1/t0", 0, _make_run(p))
    store.register("dagA/v2/t0", 0, _make_run(p))
    store.register("dagB/v1/t0", 0, _make_run(p))
    assert store.unregister_prefix("dagA/") == 2
    names = os.listdir(str(tmp_path))
    assert len([n for n in names if n.endswith(".data")]) == 1


def test_service_writes_through_to_the_store(p, tmp_path):
    """attach_store: a registered run lands on disk as the native server
    serves it, and unregister_prefix removes its files with it."""
    svc = p.service.ShuffleService()
    assert not svc.has_store()
    store = p.native_server.FileShuffleStore(str(tmp_path))
    svc.attach_store(store)
    assert svc.has_store()
    svc.register("dagA/v1/t0", 0, _make_run(p))
    svc.register("dagB/v1/t0", -1, _make_run(p, seed=1))
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".data")]) == 2
    assert svc.unregister_prefix("dagA/") == 1
    assert sorted(os.listdir(tmp_path)) == sorted(
        p.native_server._base_name("dagB/v1/t0", -1) + s
        for s in (".data", ".index"))


# -- wire and file parity across the packages ---------------------------------
def _served(root, tmp_path, run_pairs, native_server: bool, secret: bytes):
    """A server of `root` holding one run (from run_pairs) under
    "dag_1/attempt/out" spill 0: the Python server over a service, or the
    native server over a file store."""
    q = pkg(root)
    rf = q.runformat
    batches = [rf.KVBatch.from_pairs(pairs) for pairs in run_pairs]
    run = rf.Run(rf.KVBatch.concat(batches), np.cumsum(
        [0] + [b.num_records for b in batches]).astype(np.int64))
    secrets = q.security.JobTokenSecretManager(secret)
    if native_server:
        d = str(tmp_path / f"{root}_native")
        q.native_server.FileShuffleStore(d).register("dag_1/attempt/out", 0,
                                                     run)
        return q.native_server.NativeShuffleServer(secrets, d)
    svc = q.service.ShuffleService()
    svc.register("dag_1/attempt/out", 0, run)
    return q.server.ShuffleServer(secrets, svc).start()


def _wire_pairs(seed=4):
    rng = np.random.default_rng(seed)
    return [[(bytes(rng.integers(97, 123, int(k)).astype(np.uint8)),
              bytes(rng.integers(0, 256, int(v)).astype(np.uint8)))
             for k, v in zip(rng.integers(0, 20, n), rng.integers(0, 9, n))]
            for n in (50, 0, 1, 300)]


@pytest.mark.parametrize("native_server", [False, True],
                         ids=["python_server", "native_server"])
@pytest.mark.parametrize("server_root,client_root",
                         [(ROOTS[0], ROOTS[1]), (ROOTS[1], ROOTS[0])],
                         ids=["tez_tpu_client", "port_client"])
def test_wire_parity_across_packages(tmp_path, server_root, client_root,
                                     native_server):
    """One package's FetchSession against the other package's server:
    every partition and a partition range arrive batch for batch as the
    registered run holds them; a wrong token is refused."""
    secret = b"job-token" * 4
    pairs = _wire_pairs()
    server = _served(server_root, tmp_path, pairs, native_server, secret)
    c = pkg(client_root)
    try:
        session = c.server.FetchSession(
            c.security.JobTokenSecretManager(secret), "127.0.0.1",
            server.port)
        try:
            got = [session.fetch("dag_1/attempt/out", 0, part)
                   for part in range(len(pairs))]
            ranged = session.fetch_range("dag_1/attempt/out", 0, 0,
                                         len(pairs))
        finally:
            session.close()
        for b, r, want in zip(got, ranged, pairs):
            assert type(b).__module__ == f"{client_root}.ops.runformat"
            assert list(b.iter_pairs()) == want
            assert _batches_equal(b, r)
        wrong = c.server.ShuffleFetcher(
            c.security.JobTokenSecretManager(b"x" * 32), retries=1)
        with pytest.raises(PermissionError, match="forbidden"):
            wrong.fetch("127.0.0.1", server.port, "dag_1/attempt/out", 0, 0)
        assert server.auth_failures == 1
    finally:
        server.stop()


def test_file_store_bytes_match_tez_tpu(tmp_path):
    """Both FileShuffleStores write the same blob and TZIX index bytes for
    the same runs (in RAM and disk-backed), under the same file names."""
    pairs = _wire_pairs(seed=9)
    for root in ROOTS:
        q = pkg(root)
        rf = q.runformat
        batches = [rf.KVBatch.from_pairs(x) for x in pairs]
        run = rf.Run(rf.KVBatch.concat(batches), np.cumsum(
            [0] + [b.num_records for b in batches]).astype(np.int64))
        store = q.native_server.FileShuffleStore(str(tmp_path / root))
        store.register("dag_1/attempt_1/out", -1, run)
        store.register("dag_1/attempt_2/é", 3, _make_run(q, seed=5))
        s = sorter_of(q, num_partitions=5,
                      spill_dir=str(tmp_path / f"{root}_spill"),
                      mem_budget_bytes=1 << 12, span_budget_bytes=1 << 11)
        for k, v in (x for part in pairs for x in part):
            s.write(k, v)
        store.register("dag_1/attempt_3/out", 0, s.flush())
    names = sorted(os.listdir(tmp_path / ROOTS[0]))
    assert names == sorted(os.listdir(tmp_path / ROOTS[1]))
    assert len(names) == 6
    for name in names:
        assert (tmp_path / ROOTS[0] / name).read_bytes() == \
            (tmp_path / ROOTS[1] / name).read_bytes(), name


# -- tests/test_secure_shuffle.py, on both packages (DAG case apart) ----------
@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """Self-signed CA signing one endpoint cert (mutual TLS)."""
    pytest.importorskip(
        "cryptography", reason="cert-fixture generation needs cryptography")
    import ipaddress
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import rsa
    from cryptography.x509.oid import NameOID

    d = tmp_path_factory.mktemp("certs")

    def _key():
        return rsa.generate_private_key(public_exponent=65537, key_size=2048)

    now = datetime.datetime.now(datetime.timezone.utc)
    ca_key = _key()
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                            "tez-test-ca")])
    ca_cert = (x509.CertificateBuilder()
               .subject_name(ca_name).issuer_name(ca_name)
               .public_key(ca_key.public_key())
               .serial_number(x509.random_serial_number())
               .not_valid_before(now - datetime.timedelta(minutes=5))
               .not_valid_after(now + datetime.timedelta(days=1))
               .add_extension(x509.BasicConstraints(ca=True,
                                                    path_length=None),
                              critical=True)
               .sign(ca_key, hashes.SHA256()))
    node_key = _key()
    node_cert = (x509.CertificateBuilder()
                 .subject_name(x509.Name([x509.NameAttribute(
                     NameOID.COMMON_NAME, "tez-node")]))
                 .issuer_name(ca_name)
                 .public_key(node_key.public_key())
                 .serial_number(x509.random_serial_number())
                 .not_valid_before(now - datetime.timedelta(minutes=5))
                 .not_valid_after(now + datetime.timedelta(days=1))
                 .add_extension(x509.SubjectAlternativeName(
                     [x509.DNSName("localhost"),
                      x509.IPAddress(ipaddress.ip_address("127.0.0.1"))]),
                     critical=False)
                 .sign(ca_key, hashes.SHA256()))
    (d / "ca.pem").write_bytes(ca_cert.public_bytes(
        serialization.Encoding.PEM))
    (d / "node.pem").write_bytes(node_cert.public_bytes(
        serialization.Encoding.PEM))
    (d / "node.key").write_bytes(node_key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption()))
    return {"ca": str(d / "ca.pem"), "cert": str(d / "node.pem"),
            "key": str(d / "node.key")}


def tls_conf(certs, extra=None):
    conf = {"tez.runtime.shuffle.ssl.enable": True,
            "tez.shuffle.ssl.cert.path": certs["cert"],
            "tez.shuffle.ssl.key.path": certs["key"],
            "tez.shuffle.ssl.ca.path": certs["ca"]}
    conf.update(extra or {})
    return conf


def test_secure_fetch_roundtrip_and_plaintext_rejected(p, certs):
    conf = tls_conf(certs)
    secrets = p.security.JobTokenSecretManager(b"tok" * 8)
    service = p.service.ShuffleService()
    batch = p.runformat.KVBatch.from_pairs([(f"k{i:03d}".encode(), b"v" * 8)
                                            for i in range(50)])
    run = p.runformat.Run(batch, np.array([0, 25, 50], dtype=np.int64))
    service.register("attempt_x", -1, run)
    server = p.server.ShuffleServer(
        secrets, service, ssl_context=p.tls.server_context(conf)).start()
    try:
        session = p.server.FetchSession(
            secrets, "127.0.0.1", server.port,
            ssl_context=p.tls.client_context(conf))
        got = session.fetch("attempt_x", -1, 0)
        session.close()
        assert list(got.iter_pairs()) == list(run.partition(0).iter_pairs())
        with pytest.raises((ConnectionError, OSError)):
            p.server.FetchSession(secrets, "127.0.0.1", server.port,
                                  read_timeout=2.0)
    finally:
        server.stop()


def test_tls_client_rejects_untrusted_server(p, certs, tmp_path):
    other = tmp_path / "other"
    other.mkdir()
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(other / "k.pem"), "-out", str(other / "c.pem"),
         "-days", "1", "-subj", "/CN=rogue"],
        check=True, capture_output=True)
    rogue_conf = tls_conf(certs, {
        "tez.shuffle.ssl.cert.path": str(other / "c.pem"),
        "tez.shuffle.ssl.key.path": str(other / "k.pem")})
    secrets = p.security.JobTokenSecretManager(b"tok" * 8)
    server = p.server.ShuffleServer(
        secrets, p.service.ShuffleService(),
        ssl_context=p.tls.server_context(rogue_conf)).start()
    try:
        with pytest.raises((ssl.SSLError, ConnectionError, OSError)):
            p.server.FetchSession(
                secrets, "127.0.0.1", server.port,
                ssl_context=p.tls.client_context(tls_conf(certs)))
    finally:
        server.stop()


def test_tls_config_validation(p, certs):
    tls = p.tls
    assert tls.tls_config({}) is None
    assert tls.tls_config({"tez.runtime.shuffle.ssl.enable": False}) is None
    with pytest.raises(ValueError, match="not configured"):
        tls.tls_config({"tez.runtime.shuffle.ssl.enable": True})
    with pytest.raises(ValueError, match="not found"):
        tls.tls_config(tls_conf(certs,
                                {"tez.shuffle.ssl.ca.path": "/nope.pem"}))
    assert tls.export_env(tls_conf(certs)) == {
        "TEZ_TPU_SSL_ENABLE": "1", "TEZ_TPU_SSL_CERT": certs["cert"],
        "TEZ_TPU_SSL_KEY": certs["key"], "TEZ_TPU_SSL_CA": certs["ca"]}
    assert tls.export_env({}) == {}
    assert tls.resolve_conf(tls_conf(certs).get) == tls_conf(certs)


def test_tls_across_packages(certs):
    """Each package's TLS FetchSession reads the other's TLS server."""
    conf = tls_conf(certs)
    pairs = [[(b"a", b"1"), (b"b", b"2")], [(b"c", b"3")]]
    for server_root, client_root in ((ROOTS[0], ROOTS[1]),
                                     (ROOTS[1], ROOTS[0])):
        s, c = pkg(server_root), pkg(client_root)
        rf = s.runformat
        batches = [rf.KVBatch.from_pairs(x) for x in pairs]
        svc = s.service.ShuffleService()
        svc.register("out", -1, rf.Run(rf.KVBatch.concat(batches),
                                       np.array([0, 2, 3], np.int64)))
        server = s.server.ShuffleServer(
            s.security.JobTokenSecretManager(b"t" * 32), svc,
            ssl_context=s.tls.server_context(conf)).start()
        try:
            session = c.server.FetchSession(
                c.security.JobTokenSecretManager(b"t" * 32), "127.0.0.1",
                server.port, ssl_context=c.tls.client_context(conf))
            got = [list(b.iter_pairs())
                   for b in session.fetch_range("out", -1, 0, 2)]
            session.close()
            assert got == pairs
        finally:
            server.stop()


# -- no fallback: the runner process ------------------------------------------
class _IdleComm:
    """An AM's task communicator that never has a task."""

    def __init__(self):
        self.calls = []

    def get_task(self, container_id, timeout=1.0, node_id=""):
        self.calls.append(container_id)
        return None


def _runner(am_port: int, env_extra: dict, device: str = "cpu",
            token: bytes = b"k" * 32, timeout: float = 60):
    env = dict(os.environ, TEZ_TPU_JOB_TOKEN=token.hex(), **env_extra)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "tez_tpu_torch.runtime.remote_runner",
         "--am-port", str(am_port), "--device", device,
         "--container-id", "container_test_1", "--idle-timeout", "0.1"],
        env=env, capture_output=True, text=True, timeout=timeout)


@pytest.fixture()
def idle_am():
    from tez_tpu_torch.am.umbilical_server import UmbilicalServer
    from tez_tpu_torch.common.security import JobTokenSecretManager
    comm = _IdleComm()
    server = UmbilicalServer(comm, JobTokenSecretManager(b"k" * 32)).start()
    yield server, comm
    server.stop()


def test_runner_asked_for_the_card_exits_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _runner(1, {}, device="cuda")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_runner_serves_and_releases_when_idle(idle_am, tmp_path):
    """A runner on the CPU with the Python server connects, asks for a
    task, gets none and exits 0, leaving its stats file."""
    server, comm = idle_am
    out = _runner(server.port, {"TEZ_TPU_RUNNER_STATS_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert comm.calls == ["container_test_1"]
    assert os.listdir(tmp_path) == []   # no task ran: nothing to report


def test_runner_whose_native_server_cannot_start_exits(idle_am, tmp_path):
    """TEZ_TPU_NATIVE_SHUFFLE_DIR under a regular file: the native server
    cannot start, and the runner exits non-zero with the reason on stderr
    instead of serving through the Python server."""
    server, comm = idle_am
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    out = _runner(server.port,
                  {"TEZ_TPU_NATIVE_SHUFFLE_DIR": str(blocker / "native")})
    assert out.returncode != 0
    assert str(blocker) in out.stderr
    assert comm.calls == []   # never asked for a task


def test_runner_native_server_taken_raises(tmp_path, idle_am, monkeypatch):
    """In process: the C++ server is one a process, so a second one cannot
    bind, and run_loop raises rather than serve through the Python
    server; nothing is attached to the shuffle service."""
    from tez_tpu_torch.runtime import remote_runner
    p = pkg(ROOTS[0])
    server, comm = idle_am
    holder = p.native_server.NativeShuffleServer(
        p.security.JobTokenSecretManager(b"k" * 32), str(tmp_path / "held"))
    try:
        monkeypatch.setenv("TEZ_TPU_NATIVE_SHUFFLE_DIR",
                           str(tmp_path / "native"))
        with pytest.raises(RuntimeError, match="failed to bind"):
            remote_runner.run_loop("127.0.0.1", server.port, "n0",
                                   (b"k" * 32).hex(), idle_timeout=0.1,
                                   container_id="c0", device="cpu")
        assert comm.calls == []
        assert not p.service.local_shuffle_service().has_store()
    finally:
        holder.stop()


def test_native_dir_ignored_under_tls(certs, tmp_path):
    """With shuffle TLS on, a runner ignores TEZ_TPU_NATIVE_SHUFFLE_DIR
    with a warning and serves through the Python TLS server (the native
    server speaks plaintext): it dials the TLS umbilical, asks for a task
    and exits 0, and the native directory is never made."""
    from tez_tpu_torch.am.umbilical_server import UmbilicalServer
    from tez_tpu_torch.common.security import JobTokenSecretManager
    from tez_tpu_torch.common.tls import export_env, server_context
    conf = tls_conf(certs)
    comm = _IdleComm()
    server = UmbilicalServer(comm, JobTokenSecretManager(b"k" * 32),
                             ssl_context=server_context(conf)).start()
    try:
        out = _runner(server.port, dict(
            export_env(conf),
            TEZ_TPU_NATIVE_SHUFFLE_DIR=str(tmp_path / "native")))
    finally:
        server.stop()
    assert out.returncode == 0, out.stderr
    assert "TEZ_TPU_NATIVE_SHUFFLE_DIR ignored" in out.stderr
    assert comm.calls == ["container_test_1"]
    assert not (tmp_path / "native").exists()
