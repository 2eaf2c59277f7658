"""Runtime lock-order witness: record actual nested lock acquisitions and
catch order inversions, cross-validating the static lock graph.

Mirrors the :mod:`tez_tpu_torch.common.faults` arm/disarm shape: a process-global
plane, scope tokens so concurrent arms compose, a module-level ``_armed``
flag as the production fast path, and ``install_from_conf`` reading the
``tez.debug.lockorder`` knob on the AM submit path.

While armed, the ``threading.Lock`` / ``RLock`` / ``Condition``
constructors are patched with factories that wrap locks *created from
source files inside the tez_tpu_torch package* (stdlib-internal locks —
e.g. the Condition threading.Event builds — and locks created by tests or
by this module stay raw, which is what keeps the observed edge set a
subset of a static lock graph of the package).  Each wrapped lock is named from its creation site using the *same scheme the
static analyzer uses*: ``{module}.{Class}.{attr}`` for ``self.X =
threading.Lock()`` inside a method, ``{module}.{var}`` at module level —
so static vs. dynamic comparison is plain set algebra.
``threading.Condition(self.X)`` on an already-wrapped lock is an alias:
the condition acquires under the wrapped lock's own name.

On every acquire with locks already held, the witness records the
held->new edges and checks reverse reachability in the edges observed so
far: acquiring B while holding A after some thread ever ordered B before
A (directly or transitively) is an order violation — the runtime shadow
of the static checker's cycle report.

Limits (by design): locks created *before* arming — import-time module
singletons — are invisible; the witness sees order among locks born
during the armed window (in tests: everything test bodies construct).
Wrappers survive disarm and simply stop recording.

The port's copy of tez_tpu.common.lockorder, with one difference that lets
both packages' witnesses live in one process: arming saves the
constructors in place at that moment and disarming restores them, where
tez_tpu restores the ones it saw at import.  Another plane's patch (such
as tez_tpu's own witness, armed for a whole test session) therefore
survives this one's arm and disarm, as long as the two nest: arm one, arm
the other, disarm in the reverse order.
"""
from __future__ import annotations

import dataclasses
import linecache
import logging
import os
import re
import sys
import threading
import _thread
from typing import Dict, List, Optional, Set, Tuple

log = logging.getLogger(__name__)

#: The raw constructors, whatever is patched over ``threading``: the
#: witness's own lock is one, so it never observes itself.
_ORIG_LOCK = _thread.allocate_lock
_ORIG_RLOCK = _thread.RLock
#: The constructors in place when the first scope armed (at import until
#: then): the factories build their inner locks with them, and the last
#: disarm puts them back.
_saved = (threading.Lock, threading.RLock, threading.Condition)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF_FILE = os.path.abspath(__file__)

#: ``self.attr = ...`` / ``attr = ...`` on a lock-constructing line; the
#: creation frame plus this names the lock like the static analyzer does.
_ASSIGN_RE = re.compile(r"^\s*(?:self\.(\w+)|(\w+))\s*(?::[^=]+)?=\s")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One observed inversion: ``acquired`` taken while ``held`` was held,
    after earlier observations ordered ``acquired`` before ``held``."""
    held: str
    acquired: str
    thread: str
    where: str          # file:line of the inverting acquire

    def render(self) -> str:
        return (f"lock-order inversion: acquired {self.acquired} while "
                f"holding {self.held} (thread {self.thread}, {self.where}); "
                f"prior observations order {self.acquired} before "
                f"{self.held}")


def _defining_class(frame) -> Optional[type]:
    """The class whose method the frame is executing — py3.10 has no
    ``co_qualname``, so scan the receiver's MRO for the class that owns
    this exact code object."""
    self_obj = frame.f_locals.get("self")
    if self_obj is None:
        return None
    code = frame.f_code
    for klass in type(self_obj).__mro__:
        fn = klass.__dict__.get(code.co_name)
        fn = getattr(fn, "__func__", fn)
        if getattr(fn, "__code__", None) is code:
            return klass
    return type(self_obj)


def _creation_name(frame) -> str:
    """Lock name from its creation frame, in static-analyzer notation."""
    fname = os.path.abspath(frame.f_code.co_filename)
    rel = os.path.relpath(fname, _PKG_DIR).replace(os.sep, "/")
    module = rel[:-3] if rel.endswith(".py") else rel
    if module.endswith("/__init__"):
        module = module[: -len("/__init__")]
    module = module.replace("/", ".")
    line = linecache.getline(fname, frame.f_lineno)
    m = _ASSIGN_RE.match(line)
    self_attr = m.group(1) if m else None
    var = m.group(2) if m else None
    if self_attr is not None:
        klass = _defining_class(frame)
        if klass is not None:
            return f"{module}.{klass.__qualname__}.{self_attr}"
        return f"{module}.{self_attr}"
    if var is not None:
        return f"{module}.{var}"
    return f"{module}.<anon@{frame.f_code.co_name}:{frame.f_lineno}>"


def _site_of(frame) -> str:
    # skip the wrapper's own frames (__enter__ -> acquire) so the
    # reported site is the caller's ``with`` statement
    while frame is not None and \
            os.path.abspath(frame.f_code.co_filename) == _SELF_FILE:
        frame = frame.f_back
    if frame is None:
        return "<unknown>"
    return f"{frame.f_code.co_filename}:{frame.f_lineno}"


class LockWitness:
    """Edge/violation accumulator.  A process singleton backs the armed
    plane; tests provoke inversions on private instances (via
    :meth:`wrap`) so deliberate violations never pollute the global
    record a test session asserts on."""

    def __init__(self) -> None:
        self._lock = _ORIG_LOCK()
        #: (held, acquired) -> first-observed site
        self._edges: Dict[Tuple[str, str], str] = {}
        self._violations: List[Violation] = []
        self._names: Set[str] = set()
        self._tls = threading.local()

    # -- recording -----------------------------------------------------------
    def note_created(self, name: str) -> None:
        with self._lock:
            self._names.add(name)

    def on_acquired(self, name: str) -> None:
        """Called *after* the real acquire succeeds.  The acquire site is
        resolved — and reachability searched — only when a *new* edge is
        recorded: a cycle is always flagged when its closing edge first
        appears, so re-walking known edges would find nothing new and
        the steady-state nested hot path stays one dict probe per held
        lock."""
        try:
            stack = self._tls.stack
        except AttributeError:
            stack = self._tls.stack = []
        if not stack:                  # common case: no nesting
            stack.append([name, 1])
            return
        for entry in stack:
            if entry[0] == name:       # reentrant (RLock): no new edges
                entry[1] += 1
                return
        held = [entry[0] for entry in stack]
        stack.append([name, 1])
        where = None
        with self._lock:
            for h in held:
                key = (h, name)
                if key in self._edges:
                    continue
                if where is None:      # lazy: only for genuinely new edges
                    where = _site_of(sys._getframe(1))
                if self._reachable(name, h):
                    self._violations.append(Violation(
                        h, name, threading.current_thread().name, where))
                self._edges[key] = where

    def on_released(self, name: str) -> None:
        stack = getattr(self._tls, "stack", None)
        if not stack:
            return
        top = stack[-1]
        if top[0] == name:             # common case: LIFO release
            if top[1] == 1:
                stack.pop()
            else:
                top[1] -= 1
            return
        for i in range(len(stack) - 2, -1, -1):
            if stack[i][0] == name:
                stack[i][1] -= 1
                if stack[i][1] == 0:
                    del stack[i]
                return

    def _reachable(self, src: str, dst: str) -> bool:
        """dst reachable from src over observed edges (caller holds lock)."""
        seen = {src}
        frontier = [src]
        while frontier:
            node = frontier.pop()
            for (a, b) in self._edges:
                if a == node and b not in seen:
                    if b == dst:
                        return True
                    seen.add(b)
                    frontier.append(b)
        return False

    # -- wrapping ------------------------------------------------------------
    def wrap(self, inner, name: str) -> "_WitnessLock":
        self.note_created(name)
        return _WitnessLock(inner, name, self)

    # -- inspection ----------------------------------------------------------
    def edges(self) -> Set[Tuple[str, str]]:
        with self._lock:
            return set(self._edges)

    def edge_sites(self) -> Dict[Tuple[str, str], str]:
        with self._lock:
            return dict(self._edges)

    def violations(self) -> List[Violation]:
        with self._lock:
            return list(self._violations)

    def lock_names(self) -> Set[str]:
        with self._lock:
            return set(self._names)

    def reset(self) -> None:
        with self._lock:
            self._edges.clear()
            self._violations.clear()
            self._names.clear()


class _WitnessLock:
    """Wrapper around a real Lock/RLock recording acquisition order.

    Implements the private Condition hooks (``_release_save`` /
    ``_acquire_restore`` / ``_is_owned``) so ``threading.Condition(self.X)``
    over a wrapped lock keeps the witness held-stack exact across
    ``wait()``'s release/reacquire cycle.
    """

    __slots__ = ("_inner", "_witness_name", "_witness")

    def __init__(self, inner, name: str, witness: LockWitness) -> None:
        self._inner = inner
        self._witness_name = name
        self._witness = witness

    def __repr__(self) -> str:
        return f"<witnessed {self._inner!r} as {self._witness_name}>"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got and _armed:
            self._witness.on_acquired(self._witness_name)
        return got

    def release(self) -> None:
        self._inner.release()
        if _armed:
            self._witness.on_released(self._witness_name)

    # inlined acquire/release: with-blocks are the package idiom and the
    # wrapper tax is paid on every one of them
    def __enter__(self):
        self._inner.acquire()
        if _armed:
            self._witness.on_acquired(self._witness_name)
        return self

    def __exit__(self, *exc) -> None:
        self._inner.release()
        if _armed:
            self._witness.on_released(self._witness_name)

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition integration ----------------------------------------------
    def _release_save(self):
        if _armed:
            self._witness.on_released(self._witness_name)
        inner = self._inner
        if hasattr(inner, "_release_save"):
            return inner._release_save()
        inner.release()
        return None

    def _acquire_restore(self, state) -> None:
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        if _armed:
            self._witness.on_acquired(self._witness_name)

    def _is_owned(self) -> bool:
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True


# --------------------------------------------------------------------------
# Constructor patching
# --------------------------------------------------------------------------

def _should_wrap(frame) -> bool:
    fname = os.path.abspath(frame.f_code.co_filename)
    if fname == _SELF_FILE:
        return False
    return fname.startswith(_PKG_DIR + os.sep)


def _lock_factory(*args, **kwargs):
    frame = sys._getframe(1)
    inner = _saved[0](*args, **kwargs)
    if not _armed or not _should_wrap(frame):
        return inner
    return _WITNESS.wrap(inner, _creation_name(frame))


def _rlock_factory(*args, **kwargs):
    frame = sys._getframe(1)
    inner = _saved[1](*args, **kwargs)
    if not _armed or not _should_wrap(frame):
        return inner
    return _WITNESS.wrap(inner, _creation_name(frame))


def _condition_factory(lock=None):
    frame = sys._getframe(1)
    if lock is None and _armed and _should_wrap(frame):
        # an anonymous Condition owns its lock: name the hidden RLock
        # after the condition attribute itself, exactly as the static
        # analyzer names ``self.cv = threading.Condition()``
        lock = _WITNESS.wrap(_saved[1](), _creation_name(frame))
    # a wrapped ``lock`` argument needs no new name — the condition
    # acquires through the wrapper, aliasing to the inner lock's name
    return _saved[2](lock)


# --------------------------------------------------------------------------
# Plane arm / disarm (faults.py shape)
# --------------------------------------------------------------------------

_WITNESS = LockWitness()
_armed = False     # module-level fast path, same convention as faults._armed
_scopes: Set[str] = set()
_plane_lock = _ORIG_LOCK()


def witness() -> LockWitness:
    return _WITNESS


def armed() -> bool:
    return _armed


def arm(scope: str = "default") -> None:
    """Arm the witness for ``scope``; the constructor patch installs on
    the first live scope."""
    global _armed, _saved
    with _plane_lock:
        first = not _scopes
        _scopes.add(scope)
        if first:
            _saved = (threading.Lock, threading.RLock, threading.Condition)
            threading.Lock = _lock_factory
            threading.RLock = _rlock_factory
            threading.Condition = _condition_factory
            _armed = True
            log.info("lock-order witness armed (scope %s)", scope)


def _restore() -> None:
    """Put back the constructors that were in place when the first scope
    armed (caller holds _plane_lock)."""
    threading.Lock, threading.RLock, threading.Condition = _saved


def disarm(scope: str = "default") -> None:
    global _armed
    with _plane_lock:
        _scopes.discard(scope)
        if not _scopes and _armed:
            _restore()
            _armed = False
            log.info("lock-order witness disarmed")


def clear_all() -> None:
    """Disarm every scope and drop accumulated observations."""
    global _armed
    with _plane_lock:
        _scopes.clear()
        if _armed:
            _restore()
            _armed = False
    _WITNESS.reset()


def install_from_conf(conf, scope: str) -> bool:
    """Arm from the ``tez.debug.lockorder`` knob (AM submit path, the
    exact seam faults.install_from_conf uses).  Returns True when armed."""
    from tez_tpu_torch.common import config as C
    if not bool(conf.get(C.DEBUG_LOCKORDER)):
        return False
    arm(scope)
    return True


# -- convenience assertions used by tests and chip_smoke.py ----------------

def check(static_edges: Optional[Set[Tuple[str, str]]] = None,
          static_locks: Optional[Set[str]] = None) -> List[str]:
    """Problems found so far, rendered; empty list = clean.

    With ``static_edges``/``static_locks`` (a static lock graph of the
    package, as tez_tpu's analysis.lockorder builds for tez_tpu), also
    verifies the cross-validation contract: every observed edge between locks the
    static pass discovered must appear in the static graph.
    """
    problems = [v.render() for v in _WITNESS.violations()]
    if static_edges is not None and static_locks is not None:
        sites = _WITNESS.edge_sites()
        for (a, b) in sorted(_WITNESS.edges()):
            if a in static_locks and b in static_locks and \
                    (a, b) not in static_edges:
                problems.append(
                    f"witnessed edge missing from static graph: {a} -> {b} "
                    f"(first at {sites[(a, b)]})")
    return problems
