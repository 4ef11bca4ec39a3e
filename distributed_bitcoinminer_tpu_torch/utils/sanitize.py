"""The runtime sanitizer: an event-loop stall watchdog and thread
ownership.

Counterpart of the JAX package's ``utils/sanitize.py``. Opt-in through
``DBMT_SANITIZE=1``, it

- installs an **asyncio slow-callback watchdog**: every loop callback is
  timed (a wrapped ``Handle._run``), and one that holds the loop longer
  than ``DBMT_SANITIZE_SLOW_S`` seconds (default 0.1) is named in a
  ``dbmt.sanitize`` warning and counted in ``sanitize.slow_callbacks``,
  the worst stall kept in ``sanitize.slow_callback_worst_s``;
- provides **thread-ownership assertions**: :class:`ThreadOwner` pins a
  set of structures to the first thread that touches them (the
  scheduler's tables are asyncio-actor state), and
  :func:`assert_off_loop` asserts that a compute entry point is NOT on
  an event-loop thread (the miner's searcher resolution, launches and
  blocking search stay on worker threads).

Violations warn and count; they never raise. ``DBMT_SANITIZE`` unset
(the default) costs one boolean check per guarded site.
"""

from __future__ import annotations

import asyncio
import functools
import logging
import threading
import time
from typing import Optional

from ._env import float_env as _float_env, int_env as _int_env
from .metrics import registry as _registry

_log = logging.getLogger("dbmt.sanitize")


def _flight_dump(event: str, **detail) -> None:
    """Mirror a sanitizer warning into the flight recorder and dump the
    ring, when the tracing plane is on."""
    from . import trace as _trace
    if not _trace.enabled():
        return
    _trace.flight(event, **detail)
    _trace.flight_dump(f"sanitizer: {event}")


def enabled() -> bool:
    """True when the sanitizer is on (``DBMT_SANITIZE=1``), read at each
    call."""
    return _int_env("DBMT_SANITIZE", 0) != 0


def slow_threshold_s() -> float:
    """The watchdog's bound: callbacks holding the loop longer warn."""
    return _float_env("DBMT_SANITIZE_SLOW_S", 0.1)


# --------------------------------------------------------------- watchdog

_install_lock = threading.Lock()
_orig_handle_run = None          # asyncio.events.Handle._run before patch
_threshold_s: float = 0.1


def _describe_callback(handle) -> str:
    """Best-effort name of a Handle's callback: for a Task's step, its
    coroutine's qualified name (which ``async def`` held the loop)."""
    cb = getattr(handle, "_callback", None)
    while isinstance(cb, functools.partial):
        cb = cb.func
    owner = getattr(cb, "__self__", None)
    if isinstance(owner, asyncio.Task):
        coro = owner.get_coro()
        name = getattr(coro, "__qualname__", None)
        if name:
            return f"coroutine {name}"
    for attr in ("__qualname__", "__name__"):
        name = getattr(cb, attr, None)
        if name:
            mod = getattr(cb, "__module__", None)
            return f"{mod}.{name}" if mod else name
    return repr(cb)


def install_watchdog(threshold_s: Optional[float] = None) -> None:
    """Wrap ``asyncio.events.Handle._run`` with a stall timer (once per
    process; a later call only moves the threshold). Covers every loop
    callback, coroutine steps included."""
    global _orig_handle_run, _threshold_s
    with _install_lock:
        _threshold_s = threshold_s if threshold_s is not None \
            else slow_threshold_s()
        if _orig_handle_run is not None:
            return
        _orig_handle_run = asyncio.events.Handle._run
        slow = _registry().counter("sanitize.slow_callbacks")
        worst = _registry().gauge("sanitize.slow_callback_worst_s")
        orig = _orig_handle_run

        def _timed_run(self):
            t0 = time.monotonic()
            try:
                return orig(self)
            finally:
                dt = time.monotonic() - t0
                if dt >= _threshold_s:
                    slow.inc()
                    if dt > worst.value:
                        worst.set(dt)
                    who = _describe_callback(self)
                    _log.warning(
                        "event-loop stall: %s held the loop %.3fs "
                        "(bound %.3fs) — move the blocking work to a "
                        "worker thread (asyncio.to_thread)",
                        who, dt, _threshold_s)
                    _flight_dump("slow_callback", callback=who,
                                 held_s=round(dt, 4))

        asyncio.events.Handle._run = _timed_run


def uninstall_watchdog() -> None:
    """Restore the stock ``Handle._run``."""
    global _orig_handle_run
    with _install_lock:
        if _orig_handle_run is not None:
            asyncio.events.Handle._run = _orig_handle_run
            _orig_handle_run = None


def ensure_sanitizer() -> bool:
    """Install the watchdog iff ``DBMT_SANITIZE=1``; returns
    :func:`enabled`. The scheduler and the miner call it at
    construction."""
    if not enabled():
        return False
    install_watchdog()
    return True


# --------------------------------------------------------- thread ownership

class ThreadOwner:
    """Asserts a set of structures is touched only from its owning
    thread, the FIRST thread that calls :meth:`assert_here`. A violation
    warns with both threads' names and counts
    ``sanitize.ownership_violations``."""

    __slots__ = ("what", "_ident", "_name")

    def __init__(self, what: str):
        self.what = what
        self._ident: Optional[int] = None
        self._name = ""

    def assert_here(self) -> bool:
        me = threading.get_ident()
        if self._ident is None:
            self._ident = me
            self._name = threading.current_thread().name
            return True
        if me == self._ident:
            return True
        _registry().counter("sanitize.ownership_violations").inc()
        _log.warning(
            "thread-ownership violation: %s touched from thread %r "
            "(owner: %r)", self.what, threading.current_thread().name,
            self._name)
        _flight_dump("ownership_violation", what=self.what,
                     thread=threading.current_thread().name)
        return False


def assert_off_loop(what: str) -> bool:
    """Assert the caller is NOT on an event-loop thread; warns and counts
    ``sanitize.loop_blocking`` when it is."""
    try:
        asyncio.get_running_loop()
    except RuntimeError:
        return True
    _registry().counter("sanitize.loop_blocking").inc()
    _log.warning(
        "%s ran ON the event loop; expected a worker thread "
        "(asyncio.to_thread)", what)
    _flight_dump("loop_blocking", what=what)
    return False
