"""A socket-free transport over the real LSP core.

Counterpart of the JAX package's ``lspnet/detnet.py``. Each conn is a pair
of :class:`~..lsp.core.ConnCore` state machines (the engine the UDP
endpoints drive) pumped synchronously inside the caller's ``write``:

    chan.write(payload)
      └ client core .write  → wire frame in its outbox
          └ wire.decode + integrity_check      (the real parse path)
              └ server core .on_message → deliver → read_queue   + ack
                  └ wire.decode → client core .on_ack  (window slides)

The link is lossless and ordered, so a pump always drains (data, ack,
done). The cores get a zero clock and their epoch timer is never driven:
no retransmits, heartbeats or loss detection. The load harness runs its
storms over it, and a scheduler cannot tell it from the UDP server.

What the scheduler relies on:

- ``read()`` yields ``(conn_id, payload)`` in delivery order, and
  ``(conn_id, exc)`` exactly once when a peer's endpoint closes (the drop
  event ``Scheduler._on_drop`` consumes);
- ``read_nowait()`` is ``AsyncServer.read_nowait``: the next delivered
  item without an event-loop hop, or None (the scheduler's batched
  receive);
- ``write(conn_id, ...)`` raises :class:`~..lsp.errors.ConnectionClosed`
  on a closed or unknown conn;
- ``close_conn(conn_id)`` (a QoS shed) kills the peer's endpoint, whose
  pending and later ``read()`` raise; the server's read stream gets NO
  drop event for a close it made (``AsyncServer.close_conn`` posts none
  either); a peer's own ``close()`` posts one.

Any number of servers can share one loop: there is no module state, and
conn ids are per server. Every operation is O(1) a conn. The ``writes``,
``_read_log`` and ``sent`` logs grow with the messages, so the load
harness builds ``DetServer(record=False)``.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional, Tuple, Union

from ..lsp import wire
from ..lsp.core import ConnCore, integrity_check
from ..lsp.errors import ConnectionClosed
from ..lsp.params import Params

__all__ = ["DetServer", "DetChannel"]

ReadItem = Tuple[int, Union[bytes, Exception]]


def _zero_clock() -> float:
    return 0.0


class DetChannel:
    """One peer's endpoint (a miner's or a client's side of a conn), with
    its own :class:`ConnCore`: async ``read()``, ``write(payload)`` and
    async ``close()``, the part of ``AsyncClient`` the apps use."""

    def __init__(self, server: "DetServer", conn_id: int):
        self._server = server
        self.conn_id = conn_id
        self._inbox: asyncio.Queue = asyncio.Queue()
        self.closed = False
        #: Every payload this endpoint wrote, in order (empty when the
        #: server was built ``record=False``).
        self.sent: list = []
        # Both cores of a pair start UP with the conn id (the handshake is
        # the server demux's job, not the conn engine's).
        self.core = ConnCore(
            server._params, conn_id,
            deliver=self._inbox.put_nowait,
            clock=_zero_clock,
        )

    async def read(self) -> bytes:
        if self.closed and self._inbox.empty():
            raise ConnectionClosed(f"conn {self.conn_id} closed")
        item = await self._inbox.get()
        if isinstance(item, Exception):
            # Leave the poison pill for any later read.
            self._inbox.put_nowait(item)
            raise item
        return item

    def write(self, payload: bytes) -> None:
        if self.closed:
            raise ConnectionClosed(f"conn {self.conn_id} closed")
        if self._server._record:
            self.sent.append(payload)
        self.core.write(payload)
        self._server._pump(self.conn_id)

    async def close(self) -> None:
        """The peer closes: the server side sees a drop."""
        if not self.closed:
            self._kill()
            self._server._on_peer_closed(self.conn_id)

    def _kill(self) -> None:
        self.closed = True
        self.core.abort()
        self._server._abort_server_core(self.conn_id)
        self._inbox.put_nowait(
            ConnectionClosed(f"conn {self.conn_id} closed"))


class DetServer:
    """The ``AsyncServer`` surface (``read``, ``read_nowait``, ``write``,
    ``close_conn``) over conns that are live :class:`ConnCore` pairs.

    ``record=False`` keeps no ``writes``, ``_read_log`` or ``sent`` log;
    delivery is the same."""

    def __init__(self, record: bool = True) -> None:
        self._read_queue: asyncio.Queue = asyncio.Queue()
        self._chans: Dict[int, DetChannel] = {}
        self._cores: Dict[int, ConnCore] = {}
        self._next_conn_id = 1
        self._record = record
        self._params = Params()
        #: (conn_id, payload) of every server-side write, in order.
        self.writes: list = []
        #: (conn_id, payload) of every peer write, in delivery order.
        self._read_log: list = []

    def connect(self) -> DetChannel:
        """A new peer conn (miner or client); returns its endpoint."""
        conn_id = self._next_conn_id
        self._next_conn_id += 1
        chan = DetChannel(self, conn_id)
        self._chans[conn_id] = chan
        self._cores[conn_id] = ConnCore(
            self._params, conn_id,
            deliver=lambda payload, cid=conn_id: self._deliver(cid, payload),
            clock=_zero_clock,
        )
        return chan

    def _pump(self, conn_id: int) -> None:
        """Move wire frames between the conn's two cores until both
        outboxes are empty, each frame through the real parse and
        integrity check."""
        chan_core = self._chans[conn_id].core
        server_core = self._cores[conn_id]
        progress = True
        while progress:
            progress = False
            for src, dst in ((chan_core, server_core),
                             (server_core, chan_core)):
                outbox = src.outbox
                if not outbox:
                    continue
                progress = True
                frames = outbox[:]
                outbox.clear()
                for raw in frames:
                    msg = wire.decode(raw)
                    if integrity_check(msg):
                        dst.on_message(msg)

    def _deliver(self, conn_id: int, payload: bytes) -> None:
        if self._record:
            self._read_log.append((conn_id, payload))
        self._read_queue.put_nowait((conn_id, payload))

    def _on_peer_closed(self, conn_id: int) -> None:
        if conn_id in self._chans:
            self._read_queue.put_nowait(
                (conn_id, ConnectionClosed(f"conn {conn_id} dropped")))

    def _abort_server_core(self, conn_id: int) -> None:
        core = self._cores.get(conn_id)
        if core is not None:
            core.abort()

    async def read(self) -> ReadItem:
        return await self._read_queue.get()

    def read_nowait(self) -> Optional[ReadItem]:
        """The next delivered item, or None, without a loop hop."""
        try:
            return self._read_queue.get_nowait()
        except asyncio.QueueEmpty:
            return None

    def write(self, conn_id: int, payload: bytes) -> None:
        chan = self._chans.get(conn_id)
        if chan is None or chan.closed:
            raise ConnectionClosed(
                f"conn {conn_id} does not exist or is closed")
        if self._record:
            self.writes.append((conn_id, payload))
        self._cores[conn_id].write(payload)
        self._pump(conn_id)

    def close_conn(self, conn_id: int) -> None:
        chan = self._chans.get(conn_id)
        if chan is None:
            raise ConnectionClosed(f"conn {conn_id} does not exist")
        if not chan.closed:
            chan._kill()

    def sent_to(self, conn_id: int) -> list:
        """The payloads written to one conn, in order (a scan of
        ``writes``)."""
        return [p for c, p in self.writes if c == conn_id]
