"""Deterministic asyncio event loop + virtual clock (dbmcheck).

The control plane — scheduler, QoS plane, miner pipeline — is one
asyncio process whose correctness depends on the ORDER its task steps,
timer firings, and ``to_thread`` hops land in. Normal asyncio picks that
order by wall-clock accident, so a chaos test samples a handful of
interleavings out of millions and calls it a day. :class:`DetLoop`
removes the accident: every runnable callback goes through ONE hook —
a :class:`Picker` — that decides which step executes next, and the clock
is virtual (``loop.time()`` and a patched ``time.monotonic`` advance
only when every runnable step has been consumed and the next timer is
due). An explored schedule is therefore a pure function of (scenario,
picker decisions): record the decisions and you can replay the schedule
bit-for-bit; enumerate them and you have loom/Shuttle-style bounded
model checking for the asyncio actor.

Design notes:

- ``DetLoop`` is a from-scratch ``AbstractEventLoop`` — not a patched
  ``BaseEventLoop`` — because the stock ``_run_once`` owns exactly the
  two decisions we need to own (which ready handle runs; when time
  advances). Real ``asyncio.Task`` / ``Future`` / ``Queue`` / ``sleep``
  machinery runs unmodified on top: they only need ``call_soon`` /
  ``call_at`` / ``create_future`` / ``time`` and the running-loop slot,
  all of which this class provides.
- ``run_in_executor`` (the ``asyncio.to_thread`` underbelly — the
  miner's searcher resolution/dispatch/finalize hops) executes the
  function on ONE dedicated worker thread while the loop thread blocks:
  the hop in and the hop back are schedulable steps the picker orders,
  the function body itself is atomic. Running it on a real non-loop
  thread (instead of inline) keeps ``utils.sanitize`` honest —
  ``assert_off_loop`` still distinguishes loop from worker, and a
  ``ThreadOwner`` violation is still a real cross-thread touch.
- The virtual clock must also serve ``time.monotonic`` because the
  control plane stamps leases/deadlines through it directly:
  :func:`virtual_time` patches it for the duration of a run. Code that
  captured ``time.monotonic`` at import (default args — e.g.
  ``QosPlane(clock=...)``) keeps wall time; scenarios inject
  ``loop.time`` there explicitly.
"""

from __future__ import annotations

import asyncio
import functools
import heapq
import queue
import threading
import time as _time_mod
from asyncio import events as _events
from typing import Callable, List, Optional

__all__ = ["DetLoop", "Picker", "RandomPicker", "TracePicker",
           "virtual_time", "step_label"]


class Picker:
    """The scheduler hook: ``choose(labels)`` returns the index of the
    ready step to run next. Called ONLY when there are >= 2 runnable
    steps (a forced step is not a choice point); implementations record
    their decisions so a failing schedule can be replayed and shrunk."""

    #: (n_alternatives, chosen_index) per choice point, in order.
    def __init__(self) -> None:
        self.trace: List[tuple] = []

    def choose(self, labels: List[str]) -> int:
        raise NotImplementedError


class RandomPicker(Picker):
    """Seed-driven random walk over the schedule space."""

    def __init__(self, rng) -> None:
        super().__init__()
        self.rng = rng

    def choose(self, labels: List[str]) -> int:
        idx = self.rng.randrange(len(labels))
        self.trace.append((len(labels), idx))
        return idx


class TracePicker(Picker):
    """Replay a recorded choice trace; beyond its end (or on an
    alternative-count mismatch after shrinking) falls back to index 0 —
    the deterministic FIFO default, which is exactly what makes
    truncation a valid shrinking move."""

    def __init__(self, choices) -> None:
        super().__init__()
        self._choices = list(choices)
        self._pos = 0

    def choose(self, labels: List[str]) -> int:
        idx = 0
        if self._pos < len(self._choices):
            idx = self._choices[self._pos]
            if idx >= len(labels):
                idx = 0
        self._pos += 1
        self.trace.append((len(labels), idx))
        return idx


def step_label(handle) -> str:
    """Stable human-readable label of one ready handle.

    Task steps name their coroutine (``task:Scheduler.run``); timers and
    plain callbacks name the function. Labels are what the golden-replay
    test compares bit-for-bit, so they must be a pure function of the
    callback — no ids, no addresses."""
    cb = getattr(handle, "_callback", None)
    while isinstance(cb, functools.partial):
        cb = cb.func
    owner = getattr(cb, "__self__", None)
    if isinstance(owner, asyncio.Task):
        coro = owner.get_coro()
        name = getattr(coro, "__qualname__", None)
        if name:
            return f"task:{name}"
    for attr in ("__qualname__", "__name__"):
        name = getattr(cb, attr, None)
        if name:
            return f"cb:{name}"
    return "cb:?"


class _Patch:
    """Context manager: ``time.monotonic`` -> the loop's virtual clock."""

    def __init__(self, loop: "DetLoop"):
        self._loop = loop
        self._orig = None

    def __enter__(self):
        self._orig = _time_mod.monotonic
        _time_mod.monotonic = self._loop.time
        return self

    def __exit__(self, *exc):
        _time_mod.monotonic = self._orig
        return False


def virtual_time(loop: "DetLoop") -> _Patch:
    """Patch ``time.monotonic`` to ``loop.time`` for a ``with`` scope."""
    return _Patch(loop)


class _LabeledHandle(asyncio.Handle):
    """A Handle carrying an explicit step label (Handle is __slots__)."""

    __slots__ = ("_det_label",)


class DetLoop(asyncio.AbstractEventLoop):
    """Deterministic, picker-driven, virtual-clock event loop."""

    def __init__(self, picker: Optional[Picker] = None):
        self._picker = picker if picker is not None else TracePicker([])
        self._now = 0.0
        self._ready: List[asyncio.Handle] = []
        self._timers: list = []          # heap of (when, seq, TimerHandle)
        self._seq = 0
        self._closed = False
        self._debug = False
        self.steps: List[str] = []       # executed step labels, in order
        self.tasks: List[asyncio.Task] = []
        self.exceptions: List[dict] = []  # unhandled callback/task errors
        self._worker: Optional[threading.Thread] = None
        self._jobs: "queue.Queue" = queue.Queue()

    # ------------------------------------------------------------ clock

    def time(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        """Jump the virtual clock mid-step (fake compute cost: a searcher
        that 'takes' 50ms advances here instead of sleeping)."""
        if dt > 0:
            self._now += dt

    # -------------------------------------------------------- scheduling

    def call_soon(self, callback, *args, context=None):
        handle = asyncio.Handle(callback, args, self, context)
        self._ready.append(handle)
        return handle

    # The worker thread never races the loop thread (it only runs while
    # the loop thread blocks in _run_job), so threadsafe == soon.
    call_soon_threadsafe = call_soon

    def call_later(self, delay, callback, *args, context=None):
        return self.call_at(self._now + max(0.0, delay), callback, *args,
                            context=context)

    def call_at(self, when, callback, *args, context=None):
        timer = asyncio.TimerHandle(when, callback, args, self, context)
        self._seq += 1
        heapq.heappush(self._timers, (when, self._seq, timer))
        return timer

    def _timer_handle_cancelled(self, handle) -> None:
        pass   # cancelled timers are skipped at pop time

    # ------------------------------------------------- futures and tasks

    def create_future(self) -> asyncio.Future:
        return asyncio.Future(loop=self)

    def create_task(self, coro, *, name=None, context=None):
        task = asyncio.Task(coro, loop=self, name=name)
        self.tasks.append(task)
        return task

    def run_in_executor(self, executor, func, *args):
        """One serialized worker thread; the job runs as ONE schedulable
        step (the loop thread blocks while the worker executes), so
        thread hops are explored but job bodies stay atomic."""
        fut = self.create_future()
        handle = _LabeledHandle(self._run_job, (func, args, fut), self)
        # Label the step after the innermost function so schedules read
        # "executor:MinerWorker._resolve_and_dispatch" (asyncio.to_thread
        # wraps the target as partial(ctx.run, func, *args)).
        inner = func
        while isinstance(inner, functools.partial):
            if inner.args and callable(inner.args[0]):
                inner = inner.args[0]
            else:
                inner = inner.func
        handle._det_label = "executor:" + (
            getattr(inner, "__qualname__", None)
            or getattr(inner, "__name__", None) or "?")
        self._ready.append(handle)
        return fut

    def _run_job(self, func, args, fut: asyncio.Future) -> None:
        if self._worker is None:
            self._worker = threading.Thread(
                target=self._worker_main, name="detloop-exec", daemon=True)
            self._worker.start()
        box: dict = {}
        done = threading.Event()
        self._jobs.put((func, args, box, done))
        done.wait()
        if fut.cancelled():
            return
        if "error" in box:
            fut.set_exception(box["error"])
        else:
            fut.set_result(box.get("result"))

    def _worker_main(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            func, args, box, done = job
            try:
                box["result"] = func(*args)
            except BaseException as exc:  # noqa: BLE001 — relayed to fut
                box["error"] = exc
            finally:
                done.set()

    # -------------------------------------------------------- exceptions

    def default_exception_handler(self, context) -> None:
        self.exceptions.append(dict(context))

    def call_exception_handler(self, context) -> None:
        # CancelledError fallout from teardown is routine, not a finding.
        exc = context.get("exception")
        if isinstance(exc, asyncio.CancelledError):
            return
        self.exceptions.append(dict(context))

    # ---------------------------------------------------------- stepping

    def _due_timers(self) -> None:
        while self._timers and self._timers[0][0] <= self._now:
            _, _, timer = heapq.heappop(self._timers)
            if not timer.cancelled():
                self._ready.append(timer)

    def _prune(self) -> None:
        self._ready = [h for h in self._ready if not h.cancelled()]

    def step(self) -> bool:
        """Run ONE step (advancing virtual time if needed); False when
        nothing is runnable now or ever (quiescence/deadlock)."""
        self._due_timers()
        self._prune()
        while not self._ready:
            if not self._timers:
                return False
            # Advance to the next timer deadline; several timers sharing
            # it become simultaneous alternatives for the picker.
            self._now = max(self._now, self._timers[0][0])
            self._due_timers()
            self._prune()
        if len(self._ready) == 1:
            handle = self._ready.pop(0)
        else:
            labels = [self._label(h) for h in self._ready]
            idx = self._picker.choose(labels)
            handle = self._ready.pop(idx)
        self.steps.append(self._label(handle))
        handle._run()
        return True

    @staticmethod
    def _label(handle) -> str:
        return getattr(handle, "_det_label", None) or step_label(handle)

    def run_until(self, done: Callable[[], bool], max_steps: int,
                  max_vtime: float) -> str:
        """Drive steps until ``done()``; returns "done", "deadlock"
        (nothing runnable), "steps" or "vtime" on budget exhaustion.
        Must be called inside :meth:`running` / :func:`virtual_time`."""
        while not done():
            if len(self.steps) >= max_steps:
                return "steps"
            if self._now > max_vtime:
                return "vtime"
            if not self.step():
                return "deadlock"
        return "done"

    def drain(self, max_steps: int = 2000) -> None:
        """Teardown: cancel every known task and step (deterministically
        — cancellations leave at most bookkeeping steps) until all are
        finished, retrieving exceptions so no __del__ fires later."""
        for task in self.tasks:
            if not task.done():
                task.cancel()
        budget = max_steps
        while any(not t.done() for t in self.tasks) and budget > 0:
            if not self.step():
                break
            budget -= 1
        for task in self.tasks:
            if task.done() and not task.cancelled():
                exc = task.exception()
                if exc is not None:
                    self.exceptions.append(
                        {"message": "task raised", "exception": exc,
                         "task": repr(task)})

    class _Running:
        def __init__(self, loop): self._loop = loop

        def __enter__(self):
            _events._set_running_loop(self._loop)
            return self._loop

        def __exit__(self, *exc):
            _events._set_running_loop(None)
            return False

    def running(self) -> "_Running":
        """Context manager installing this loop as the running loop (so
        ``get_running_loop`` / ``Queue`` / ``sleep`` bind to it)."""
        return DetLoop._Running(self)

    # ------------------------------------------------------ housekeeping

    def get_debug(self) -> bool:
        return self._debug

    def set_debug(self, enabled: bool) -> None:
        self._debug = enabled

    def is_running(self) -> bool:
        return _events._get_running_loop() is self

    def is_closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        if self._worker is not None:
            self._jobs.put(None)
            self._worker.join(timeout=5.0)
            self._worker = None
        self._closed = True
