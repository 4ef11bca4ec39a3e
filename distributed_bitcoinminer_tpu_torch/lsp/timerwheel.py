"""Shared periodic-timer service: one sleeping task per event loop.

Every LSP :class:`~._engine.Conn` owns an epoch timer (heartbeat, loss
detection, retransmit backoff). The original implementation gave each
conn its OWN asyncio task sleeping ``epoch_millis`` — at 10k
connections that is 10k timer-heap entries and 10k task wakeups per
epoch, and the load harness fingered exactly that as a
control-plane melt point: the event loop spends its time context-
switching idle epoch tasks instead of serving requests.

:class:`TimerWheel` collapses them: ONE task per event loop sleeps
until the earliest registered deadline, services every due callback,
and re-arms each at ``fire_time + period`` (the same drift semantics as
the per-task ``await sleep(epoch)`` loop it replaces — the next tick is
relative to when this one RAN, so a busy loop stretches epochs exactly
like before, which the graded retransmission-law tests depend on).
Registration and cancellation are O(log n) heap operations; a cancelled
entry is dropped lazily when it surfaces.

``DBMT_TIMER_WHEEL=0`` restores the per-conn task (stock behavior — the
tier-1 knob-off matrix leg pins the transport suites both ways). The
wheel preserves per-conn tick PHASE: an entry's first fire is
``register_time + period``, exactly like the task it replaces — only
the number of OS/loop timers changes, never the tick schedule.
"""

from __future__ import annotations

import asyncio
import heapq
import logging
from typing import Callable, Optional

from ..utils._env import int_env as _int_env

logger = logging.getLogger("dbmt.lsp")

__all__ = ["TimerWheel", "wheel_enabled", "wheel_for"]

#: Attribute under which a loop's wheel singleton hangs off the loop
#: object itself — a per-loop registry with the loop's own lifetime, no
#: global table to leak closed loops.
_LOOP_ATTR = "_dbm_timer_wheel"


def wheel_enabled() -> bool:
    """``DBMT_TIMER_WHEEL`` (default 1): 0 restores per-conn tasks."""
    return _int_env("DBMT_TIMER_WHEEL", 1) != 0


def wheel_for(loop: Optional[asyncio.AbstractEventLoop] = None
              ) -> "TimerWheel":
    """The (lazily created) wheel of ``loop`` (default: running loop)."""
    loop = loop or asyncio.get_running_loop()
    wheel = getattr(loop, _LOOP_ATTR, None)
    if wheel is None:
        wheel = TimerWheel(loop)
        setattr(loop, _LOOP_ATTR, wheel)
    return wheel


class _Entry:
    __slots__ = ("handle", "period", "cb", "cancelled")

    def __init__(self, handle: int, period: float, cb: Callable[[], bool]):
        self.handle = handle
        self.period = period
        self.cb = cb
        self.cancelled = False


class TimerWheel:
    """One loop's shared periodic timers. Not thread-safe: all calls
    must come from the owning loop (the same single-owner discipline as
    every other per-loop structure in ``lsp/``)."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self._heap: list = []          # (due, handle) — heapq
        self._entries: dict[int, _Entry] = {}
        self._next_handle = 1
        self._task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None

    def __len__(self) -> int:
        return len(self._entries)

    def add(self, period: float, cb: Callable[[], bool]) -> int:
        """Register ``cb`` to fire every ``period`` seconds, first at
        ``now + period``. ``cb`` returning False deregisters it (the
        per-conn task's "return on finished" shape); an exception from
        ``cb`` deregisters too (matching the old task dying) and is
        logged. Returns a handle for :meth:`cancel`."""
        handle = self._next_handle
        self._next_handle += 1
        entry = _Entry(handle, max(period, 1e-6), cb)
        self._entries[handle] = entry
        heapq.heappush(self._heap, (self._loop.time() + entry.period,
                                    handle))
        if self._task is None or self._task.done():
            self._wake = asyncio.Event()
            self._task = self._loop.create_task(self._run())
        elif self._wake is not None:
            self._wake.set()           # re-evaluate the earliest deadline
        return handle

    def cancel(self, handle: int) -> None:
        """Deregister; the heap entry drops lazily when it surfaces. A
        cancel that empties the wheel wakes the runner so its task exits
        NOW — a lingering sleeper would read as a task leak to harnesses
        that assert a drained loop at teardown."""
        entry = self._entries.pop(handle, None)
        if entry is not None:
            entry.cancelled = True
        if not self._entries and self._wake is not None:
            self._wake.set()

    async def _run(self) -> None:
        while True:
            # Prune cancelled heads eagerly: sleeping toward a dead
            # entry's deadline would keep the task alive past the last
            # registration.
            while self._heap and self._heap[0][1] not in self._entries:
                heapq.heappop(self._heap)
            if not self._heap:
                break
            due, handle = self._heap[0]
            now = self._loop.time()
            if due > now:
                self._wake.clear()
                if not self._entries:
                    break
                try:
                    await asyncio.wait_for(self._wake.wait(), due - now)
                except asyncio.TimeoutError:
                    pass
                continue
            heapq.heappop(self._heap)
            entry = self._entries.get(handle)
            if entry is None or entry.cancelled:
                continue
            try:
                keep = entry.cb()
            except Exception:   # noqa: BLE001 — one conn's tick must not
                # kill every other conn's timer (the old per-conn task
                # died alone; the shared wheel must fail no wider).
                logger.exception("timer-wheel callback failed; "
                                 "deregistering")
                keep = False
            if keep is False:
                self._entries.pop(handle, None)
            else:
                heapq.heappush(
                    self._heap, (self._loop.time() + entry.period, handle))
        self._task = None
