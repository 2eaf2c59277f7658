"""Deterministic fault-injection plane: the port's copy of
tez_tpu/common/faults.py.

A process-global registry of *named fault points* compiled into the
infrastructure seams.  The cost when disarmed is one module-flag check per
point (`if not _armed: return`); nothing else runs unless a test or a
smoke run installs rules.

Every rule owns a `random.Random` seeded from the install seed and the
rule's own text, so a given (spec, seed) pair produces the same fault
schedule on every run.

Modes per rule:
  fail     raise an exception the first `n` matching fires (n=-1: always)
  pfail    raise with probability `p` per fire (seeded RNG, budget `n`)
  delay    sleep `ms` milliseconds (budget `n`)
  corrupt  flip one payload byte via :func:`corrupt_bytes` (budget `n`)

Rules are installed under a *scope* token, so concurrent users in one
process don't interfere: each scope's rules come and go atomically and
`clear(scope)` removes exactly its own; the AM arms a DAG's rules from
its conf (``install_from_conf``).

Spec grammar (``tez.test.fault.spec``)::

    point:mode[:k=v[,k=v...]][;point:mode:...]

    device.readback.fail:fail:n=1,exc=io,match=span=0;device.dispatch.hang:delay:ms=60000

Params: ``n`` (budget, -1 unlimited), ``p`` (pfail probability), ``ms``
(delay), ``exc`` (conn|io|os|timeout|runtime|perm), ``match`` (substring
the fire's detail must contain).
"""
from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

#: The fault points the port instruments (tez_tpu's table names the rest).
#: fire() accepts any name: a new seam needs no central edit.
KNOWN_POINTS: Dict[str, str] = {
    "device.dispatch.delay":
        "ops/async_stage.py readback completion (detail = span=<id>); delay "
        "mode holds one span's completion while later spans drain past it — "
        "the deterministic out-of-order-completion lever for the async "
        "device pipeline",
    "device.dispatch.hang":
        "ops/async_stage.py device dispatch entry (detail = span=<id>); "
        "delay mode simulates a hung dispatch so the watchdog abandons the "
        "attempt and the span fails over to the host engine",
    "device.dispatch.oom":
        "ops/async_stage.py device dispatch entry and ops/sorter.py split "
        "retries (detail = span=<id>[:split[lo:hi)]); fail mode raises an "
        "out-of-memory-classified error driving the split-then-fallback "
        "ladder and the circuit breaker",
    "device.readback.fail":
        "ops/async_stage.py D2H readback entry (detail = span=<id>); fail "
        "mode crashes the readback worker's attempt so the span re-sorts "
        "through the host engine",
    "spill.write":
        "ops/runformat.py + ops/sorter.py spill writes (Run.save, "
        "save_run_partitioned, DeviceSorter._store_run)",
    "spill.read":
        "ops/runformat.py spill reads (Run.load, FileRun block reads); "
        "corrupt mode flips stored bytes so the CRC path must catch it",
    "shuffle.fetch.connect":
        "shuffle/server.py FetchSession connect (TCP dial + nonce)",
    "shuffle.fetch.read":
        "shuffle fetch read: FetchSession.fetch_range and the in-process "
        "local-fetch short circuit (library/inputs.py)",
    "shuffle.serve":
        "shuffle/server.py request serving (server side of a fetch)",
    "shuffle.data":
        "shuffle/service.py payload integrity: corrupt mode round-trips the "
        "served partition through the checksummed Run wire blob",
    "mesh.exchange":
        "parallel/coordinator.py host-level mesh exchange entry (detail = "
        "the edge id)",
    "mesh.exchange.delay":
        "parallel/coordinator.py per-device shard readback (detail = "
        "<edge>:round=<r>:device=<d>); delay mode turns one device into a "
        "readback straggler, the lever that shows coded r2 masking it via "
        "the buddy copy; fail mode fails that device's copy",
    "task.run":
        "runtime/task_runner.py processor invocation (detail = attempt id; "
        "delay mode makes an attempt a straggler, fail mode crashes it)",
    "fence.stale_epoch":
        "observability point fired wherever a stale-epoch actor is rejected "
        "(task_comm, shuffle service/server, committer publish fence)",
    "fence.stale_window":
        "observability point fired wherever a stale-WINDOW actor is "
        "rejected — the streaming generalization of fence.stale_epoch "
        "(umbilical, shuffle register/push/fetch, store publish)",
    "stream.window.commit":
        "am/streaming.py exactly-once window committer, fired between the "
        "WINDOW_COMMIT_STARTED and WINDOW_COMMIT_FINISHED ledger records "
        "(detail = <stream>@w<window>); fail mode crashes the stream "
        "mid-commit",
    "stream.ingest":
        "am/streaming.py StreamDriver.ingest (detail = <stream>@w<window>); "
        "delay mode paces the source, fail mode drops the ingest call with "
        "a typed error",
    "am.heartbeat":
        "am/task_comm.py heartbeat delivery (shared by local and umbilical "
        "paths)",
    "am.heartbeat.monitor":
        "am/heartbeat.py liveness sweep (delay stalls failure detection)",
    "am.umbilical":
        "am/umbilical_server.py method dispatch (detail = method name)",
    "am.container.launch":
        "am/launcher.py runner/container startup",
    "am.recovery.append":
        "am/recovery.py journal append (before the write)",
    "am.recovery.fsync":
        "am/recovery.py journal fsync of summary events",
    "commit.ledger.fsync":
        "am/recovery.py fsync of a commit-ledger record (DAG_COMMIT_STARTED/"
        "FINISHED/ABORTED) — fail mode crashes the AM between ledger states",
    "commit.publish":
        "io/file_output.py per-part-file publish inside commit_output "
        "(detail = part filename; delay mode holds the commit mid-publish)",
    "shuffle.push.send":
        "shuffle/push.py SpillPusher send attempt (detail = "
        "path/spill -> dest); fail mode kills the eager push so the "
        "consumer must recover through the pull path — the push-storm "
        "chaos lever",
    "shuffle.push.admit":
        "shuffle/push.py PushAdmissionController decision (detail = "
        "source path + nbytes); fail mode turns the decision into a "
        "RETRY-AFTER rejection, delay mode stretches admit_wait",
    "am.admit.shed":
        "am/admission.py AdmissionController decision (detail = "
        "tenant/dag name); fail mode forces the verdict to SHED with "
        "RETRY-AFTER regardless of load — the tenant-storm chaos lever "
        "for exercising client resubmit paths",
    "am.queue.delay":
        "am/admission.py queue consumer drain step (detail = queued "
        "submission id); delay mode holds a parked submission before it "
        "is promoted to submit, stretching queue latency; fail mode "
        "crashes the consumer thread mid-drain (the lossless-admission "
        "ledger regression lever)",
    "am.crash":
        "am/app_master.py DAGAppMaster.crash() entry (detail = "
        "attempt=<n>); fires as the simulated SIGKILL begins — delay mode "
        "widens the kill window deterministically, any raise is swallowed "
        "(the AM is dying regardless)",
    "store.replica.lost":
        "shuffle/service.py consumer-side fetch chain (detail = "
        "path/spill); fail mode declares the PRIMARY copies lost — store "
        "entry and local registration both — so the fetch must "
        "reconstruct from the coded push replica (store.replica.failover "
        "proves no producer re-ran)",
}

_EXC_KINDS = {
    "conn": ConnectionError,
    "io": IOError,
    "os": OSError,
    "timeout": TimeoutError,
    "runtime": RuntimeError,
    "perm": PermissionError,
}

_MODES = ("fail", "pfail", "delay", "corrupt")


class FaultInjected(Exception):
    """Marker mixin never raised directly; see _make_exc."""


@dataclasses.dataclass
class FaultRule:
    point: str
    mode: str                 # fail | pfail | delay | corrupt
    times: int = -1           # fire budget; -1 = unlimited
    prob: float = 1.0         # pfail draw threshold
    delay_ms: float = 0.0
    exc: str = "conn"
    match: str = ""           # substring filter on the fire's detail
    scope: str = ""           # installer token (set by install())
    fired: int = 0
    rng: Optional[random.Random] = None

    def spec(self) -> str:
        parts = [f"{self.point}:{self.mode}"]
        kv = []
        if self.times != -1:
            kv.append(f"n={self.times}")
        if self.mode == "pfail":
            kv.append(f"p={self.prob}")
        if self.mode == "delay":
            kv.append(f"ms={self.delay_ms:g}")
        if self.mode in ("fail", "pfail") and self.exc != "conn":
            kv.append(f"exc={self.exc}")
        if self.match:
            kv.append(f"match={self.match}")
        if kv:
            parts.append(",".join(kv))
        return ":".join(parts)


def parse_spec(spec: str) -> List[FaultRule]:
    """Parse the ``tez.test.fault.spec`` grammar into rules (unseeded)."""
    rules: List[FaultRule] = []
    for chunk in spec.split(";"):
        chunk = chunk.strip()
        if not chunk:
            continue
        fields = chunk.split(":", 2)
        if len(fields) < 2:
            raise ValueError(f"fault rule {chunk!r}: want point:mode[:k=v..]")
        point, mode = fields[0].strip(), fields[1].strip()
        if mode not in _MODES:
            raise ValueError(f"fault rule {chunk!r}: unknown mode {mode!r} "
                             f"(want one of {_MODES})")
        rule = FaultRule(point=point, mode=mode)
        if len(fields) == 3 and fields[2].strip():
            for kv in fields[2].split(","):
                k, _, v = kv.partition("=")
                k, v = k.strip(), v.strip()
                if k == "n":
                    rule.times = int(v)
                elif k == "p":
                    rule.prob = float(v)
                elif k == "ms":
                    rule.delay_ms = float(v)
                elif k == "exc":
                    if v not in _EXC_KINDS:
                        raise ValueError(
                            f"fault rule {chunk!r}: unknown exc {v!r} "
                            f"(want one of {sorted(_EXC_KINDS)})")
                    rule.exc = v
                elif k == "match":
                    rule.match = v
                else:
                    raise ValueError(f"fault rule {chunk!r}: unknown "
                                     f"param {k!r}")
        if rule.mode in ("fail", "pfail", "corrupt", "delay") and \
                rule.times == 0:
            raise ValueError(f"fault rule {chunk!r}: n=0 never fires")
        rules.append(rule)
    return rules


def format_spec(rules: List[FaultRule]) -> str:
    return ";".join(r.spec() for r in rules)


def _seed_rule(rule: FaultRule, seed: int) -> None:
    # derive the per-rule stream from the install seed + the rule's own
    # text via crc32 (never hash(): it is salted per process, which would
    # break cross-run reproducibility)
    h = zlib.crc32(rule.spec().encode("utf-8"))
    rule.rng = random.Random((seed & 0xFFFFFFFF) * 0x9E3779B1 + h)


class FaultPlane:
    """Process-global rule registry; all state mutations are locked.
    Sleeps happen outside the lock."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._scopes: Dict[str, List[FaultRule]] = {}
        #: repro/assertion trail: (point, detail, action) in fire order
        self.journal: List[Tuple[str, str, str]] = []

    # -- installation --------------------------------------------------------
    def install(self, scope: str, rules: List[FaultRule],
                seed: int = 0) -> None:
        global _armed
        for r in rules:
            r.scope = scope
            r.fired = 0
            _seed_rule(r, seed)
        with self._lock:
            self._scopes[scope] = list(rules)
            _armed = True
        log.info("fault plane: scope %s armed with %d rule(s), seed=%d: %s",
                 scope, len(rules), seed, format_spec(rules))

    def clear(self, scope: str) -> None:
        global _armed
        with self._lock:
            self._scopes.pop(scope, None)
            if not self._scopes:
                _armed = False

    def clear_all(self) -> None:
        global _armed
        with self._lock:
            self._scopes.clear()
            self.journal.clear()
            _armed = False

    def rules_snapshot(self) -> List[FaultRule]:
        with self._lock:
            return [r for rules in self._scopes.values() for r in rules]

    # -- firing --------------------------------------------------------------
    def _claim(self, point: str, detail: str,
               modes: Tuple[str, ...]) -> Optional[FaultRule]:
        """Find the first matching rule with budget and consume one fire."""
        with self._lock:
            for rules in self._scopes.values():
                for r in rules:
                    if r.point != point or r.mode not in modes:
                        continue
                    if r.match and r.match not in detail:
                        continue
                    if r.times >= 0 and r.fired >= r.times:
                        continue
                    if r.mode == "pfail":
                        assert r.rng is not None
                        if r.rng.random() >= r.prob:
                            continue
                    r.fired += 1
                    self.journal.append((point, detail, r.mode))
                    return r
        return None

    def fire(self, point: str, detail: str = "") -> None:
        """Raise or sleep according to the first matching armed rule."""
        rule = self._claim(point, detail, ("fail", "pfail", "delay"))
        if rule is None:
            return
        if rule.mode == "delay":
            log.info("fault plane: delaying %s (%s) %.0fms",
                     point, detail, rule.delay_ms)
            time.sleep(rule.delay_ms / 1000.0)
            return
        exc_type = _EXC_KINDS[rule.exc]
        log.info("fault plane: failing %s (%s) with %s",
                 point, detail, exc_type.__name__)
        raise exc_type(f"injected fault at {point} ({detail})")

    def should_corrupt(self, point: str, detail: str = "") -> bool:
        return self._claim(point, detail, ("corrupt",)) is not None

    def corrupt_bytes(self, point: str, detail: str, data: bytes,
                      lo: int = 0) -> bytes:
        """Flip one byte at/after `lo` when a corrupt rule fires; the
        caller's checksum layer must detect the damage."""
        if len(data) <= lo:
            return data
        rule = self._claim(point, detail, ("corrupt",))
        if rule is None:
            return data
        assert rule.rng is not None
        pos = lo + rule.rng.randrange(len(data) - lo)
        log.info("fault plane: corrupting %s (%s) byte %d of %d",
                 point, detail, pos, len(data))
        out = bytearray(data)
        out[pos] ^= 0xFF
        return bytes(out)


_PLANE = FaultPlane()
_armed = False     # module-level fast path: production cost is this check


def plane() -> FaultPlane:
    return _PLANE


def armed() -> bool:
    return _armed


def install(scope: str, rules: List[FaultRule], seed: int = 0) -> None:
    _PLANE.install(scope, rules, seed)


def clear(scope: str) -> None:
    _PLANE.clear(scope)


def clear_all() -> None:
    _PLANE.clear_all()


def install_from_conf(conf, scope: str) -> bool:
    """Arm the plane from ``tez.test.fault.*`` conf keys (AM submit path).
    Returns True when rules were installed."""
    from tez_tpu_torch.common import config as C
    spec = conf.get(C.TEST_FAULT_SPEC)
    if not spec:
        return False
    seed = int(conf.get(C.TEST_FAULT_SEED))
    install(scope, parse_spec(spec), seed=seed)
    return True


def fire(point: str, detail: str = "") -> None:
    if not _armed:
        return
    _PLANE.fire(point, detail)


def should_corrupt(point: str, detail: str = "") -> bool:
    if not _armed:
        return False
    return _PLANE.should_corrupt(point, detail)


def corrupt_bytes(point: str, detail: str, data: bytes,
                  lo: int = 0) -> bytes:
    if not _armed:
        return data
    return _PLANE.corrupt_bytes(point, detail, data, lo=lo)
