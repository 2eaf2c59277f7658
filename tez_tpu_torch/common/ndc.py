"""Nested diagnostic context: tag log lines with the entity being worked on.

Reference parity: tez-common CallableWithNdc/RunnableWithNdc + the log4j NDC
the reference pushes task-attempt ids through so every log line in a shared
JVM names its attempt.  Python shape: a contextvar stack + a logging.Filter
that exposes it as %(ndc)s, and wrappers that carry the caller's stack onto
executor threads (the CallableWithNdc behavior).

The port's copy of tez_tpu.common.ndc.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import logging
from typing import Any, Callable, Iterator, Tuple

_stack: contextvars.ContextVar[Tuple[str, ...]] = contextvars.ContextVar(
    "tez_ndc", default=())


def push(tag: str) -> contextvars.Token:
    return _stack.set(_stack.get() + (tag,))


def pop(token: contextvars.Token) -> None:
    _stack.reset(token)


def current() -> str:
    return ":".join(_stack.get())


@contextlib.contextmanager
def context(tag: str) -> Iterator[None]:
    token = push(tag)
    try:
        yield
    finally:
        pop(token)


def with_current_ndc(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Capture the caller's NDC stack and re-apply it wherever the callable
    runs (reference: CallableWithNdc.callInternal wraps NDC.inherit)."""
    captured = _stack.get()

    @functools.wraps(fn)
    def wrapper(*args: Any, **kwargs: Any) -> Any:
        token = _stack.set(captured)
        try:
            return fn(*args, **kwargs)
        finally:
            _stack.reset(token)

    return wrapper


class NdcFilter(logging.Filter):
    """Makes %(ndc)s available to formatters; '' outside any context."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.ndc = current()
        return True


def install(fmt: str = "%(asctime)s %(levelname)s [%(ndc)s] "
                       "%(name)s: %(message)s") -> None:
    """Attach the NDC filter (and an NDC-aware format) to root handlers."""
    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig()
    for h in root.handlers:
        if not any(isinstance(f, NdcFilter) for f in h.filters):
            h.addFilter(NdcFilter())
            h.setFormatter(logging.Formatter(fmt))
