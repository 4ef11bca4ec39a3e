"""Asyncio shell around the sans-io LSP core (:mod:`.core`).

The protocol state machine — window/backoff/reorder/epoch/close semantics
— lives entirely in :class:`~.core.ConnCore`; see its module docstring
for the contract. This module adapts it to an event loop: every core
input runs on the loop (race-free by construction, the equivalent of the
reference's one-goroutine-owns-the-state design), the core's ``outbox``
is flushed to the owner's ``send_raw`` after each input (the flush is
one syscall burst under ``sendmmsg``), the core's one timer request is
serviced by the shared per-loop timer wheel (or a per-conn task under
``DBMT_TIMER_WHEEL=0``), and the core's app-event callbacks are mapped to
the asyncio surface endpoints await (``connected`` future,
``closed_event``).

:class:`Conn`'s public surface is unchanged from when it WAS the state
machine — ``write`` / ``on_message`` / ``resume_delivery`` /
``begin_close`` / ``abort`` / ``flushed`` / ``state`` / ``conn_id`` /
``connected`` / ``closed_event`` — so ``server.py``/``client.py`` drive
it exactly as before. ``ConnState`` and ``integrity_check`` re-export
from :mod:`.core` for the same reason.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Optional

from .core import ConnCore, ConnState, integrity_check
from .message import Message
from .params import Params
from .timerwheel import wheel_enabled, wheel_for

__all__ = ["Conn", "ConnState", "integrity_check"]


class Conn:
    """One LSP connection on an event loop. Owner provides I/O + delivery
    callbacks; protocol logic is the sans-io core's."""

    __slots__ = ("_core", "_send_raw", "connected", "closed_event",
                 "_epoch_task", "_wheel", "_wheel_handle")

    def __init__(
        self,
        params: Params,
        conn_id: int,
        send_raw: Callable[[bytes], None],
        deliver: Callable[[bytes], None],
        broken: Callable[[Exception], None],
        connect_msg: Optional[Message] = None,
        deliver_ready: Optional[Callable[[], bool]] = None,
    ):
        self._send_raw = send_raw
        loop = asyncio.get_running_loop()
        self.connected: asyncio.Future = loop.create_future()
        self.closed_event = asyncio.Event()

        self._core = ConnCore(
            params, conn_id,
            connect=connect_msg is not None,
            deliver=deliver,
            broken=broken,
            on_connected=self._when_connected,
            on_connect_failed=self._when_connect_failed,
            on_closed=self._when_closed,
            deliver_ready=deliver_ready,
        )
        if connect_msg is None:
            self.connected.set_result(conn_id)

        # Epoch timer: the shared per-loop timer wheel by default (one
        # sleeping task services every conn on this loop — 10k conns is
        # 10k heap entries, not 10k tasks), or the stock
        # per-conn task under DBMT_TIMER_WHEEL=0. Tick schedule and
        # semantics are identical either way (first tick at +epoch,
        # next relative to when this one ran).
        self._epoch_task: Optional[asyncio.Task] = None
        self._wheel = None
        self._wheel_handle = None
        if wheel_enabled():
            self._wheel = wheel_for(loop)
            self._wheel_handle = self._wheel.add(
                self._core.epoch_interval_s, self._tick)
        else:
            self._epoch_task = loop.create_task(self._epoch_loop())

        self._flush()

    # ------------------------------------------------------- core adaptation

    @property
    def params(self) -> Params:
        return self._core.params

    @property
    def conn_id(self) -> int:
        return self._core.conn_id

    @property
    def state(self) -> ConnState:
        return self._core.state

    @property
    def flushed(self) -> bool:
        return self._core.flushed

    def _flush(self) -> None:
        """Drain the core's outbound burst to the socket layer. A batching
        endpoint turns the whole burst into one ``sendmmsg`` at pump exit."""
        outbox = self._core.outbox
        if outbox:
            send = self._send_raw
            for raw in outbox:
                send(raw)
            outbox.clear()

    def _when_connected(self, conn_id: int) -> None:
        if not self.connected.done():
            self.connected.set_result(conn_id)

    def _when_connect_failed(self, exc: Exception) -> None:
        if not self.connected.done():
            self.connected.set_exception(exc)

    def _when_closed(self) -> None:
        self.closed_event.set()
        task = self._epoch_task
        if task is not None and task is not asyncio.current_task():
            task.cancel()
        self._epoch_task = None
        if self._wheel is not None and self._wheel_handle is not None:
            self._wheel.cancel(self._wheel_handle)
            self._wheel_handle = None

    # --------------------------------------------------------- input surface

    def write(self, payload: bytes) -> None:
        self._core.write(payload)
        self._flush()

    def on_message(self, msg: Message) -> None:
        """Handle one integrity-checked inbound message."""
        self._core.on_message(msg)
        self._flush()

    def resume_delivery(self) -> None:
        """Owner hook: app read freed queue room; deliver stranded backlog."""
        self._core.resume_delivery()
        self._flush()

    # ------------------------------------------------------------ epoch loop

    async def _epoch_loop(self) -> None:
        epoch = self._core.epoch_interval_s
        while True:
            await asyncio.sleep(epoch)
            if not self._tick():
                return

    def _tick(self) -> bool:
        """One epoch. Returns False when the connection is finished."""
        alive = self._core.on_epoch()
        self._flush()
        return alive

    # ----------------------------------------------------------- termination

    def begin_close(self) -> None:
        """Graceful close: flush window + buffer, then finish (ref: §3.5)."""
        self._core.begin_close()
        self._flush()

    def abort(self) -> None:
        """Immediate teardown with no flush (endpoint shutdown path)."""
        self._core.abort()
