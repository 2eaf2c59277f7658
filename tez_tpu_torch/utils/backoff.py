"""Retry/backoff policy shared by DCN-facing clients.

Reference role: the exponential penalty schedule the shuffle clients apply
between attempts (ShuffleScheduler's Penalty DelayQueue,
tez-runtime-library .../orderedgrouped/ShuffleScheduler.java:179, and the
fetcher retry loops in Fetcher.java:79).

Full jitter: the plain `base * 2^attempt` schedule keeps every client
penalized by one bad host in lockstep — when the penalty expires they all
reconnect in the same instant and knock the host over again (thundering
herd).  With ``jitter=True`` each delay is drawn uniformly from
``[0, min(cap, base * 2^attempt)]`` (the AWS "full jitter" scheme), which
decorrelates the herd while keeping the same expected envelope.  The RNG is
injectable so tests can pin the draw.

The port's copy of tez_tpu.utils.backoff.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

_module_rng = random.Random()


class ExponentialBackoff:
    """base * 2^attempt, capped; attempt counter owned by the caller.

    With ``jitter=True``, draws uniformly from [0, that envelope] per call
    (full jitter).  ``rng`` pins the stream for deterministic tests."""

    def __init__(self, base: float = 0.2, cap: float = 10.0,
                 jitter: bool = False,
                 rng: Optional[random.Random] = None):
        self.base = base
        self.cap = cap
        self.jitter = jitter
        self.rng = rng

    def delay(self, attempt: int) -> float:
        d = min(self.cap, self.base * (2 ** attempt))
        if not self.jitter:
            return d
        return (self.rng or _module_rng).uniform(0.0, d)

    def sleep(self, attempt: int) -> None:
        time.sleep(self.delay(attempt))


def retry_call(fn: Callable, retries: int,
               retryable: Tuple[Type[BaseException], ...],
               backoff: Optional[ExponentialBackoff] = None,
               fatal: Tuple[Type[BaseException], ...] = ()):
    """Run fn() up to `retries` times, sleeping the policy's delay between
    retryable failures.  `fatal` exception types propagate immediately
    (definitive misses must not be retried — e.g. ShuffleDataNotFound
    drives the InputReadErrorEvent path instead)."""
    if retries < 1:
        raise ValueError(f"retries must be >= 1, got {retries}")
    policy = backoff or ExponentialBackoff(jitter=True)
    last: Optional[BaseException] = None
    for attempt in range(retries):
        try:
            return fn()
        except fatal:
            raise
        except retryable as e:
            last = e
            if attempt < retries - 1:
                policy.sleep(attempt)
    assert last is not None
    raise last
