"""Asyncio UDP endpoints with fault injection on the send and receive paths.

Equivalent of the reference's ``UDPConn`` wrapper (ref: lspnet/conn.go,
lspnet/net.go): endpoints opened with :func:`listen_udp` are the "server"
side and those opened with :func:`dial_udp` are the "client" side, which
selects which drop knobs apply. Fault behavior matches the reference:

- read drop: inbound datagram silently discarded before the protocol sees it;
- write drop: outbound datagram discarded but reported as sent;
- delay: outbound datagram delivered 500 ms late;
- shorten/lengthen/corrupt: applied to Data messages only, mutating the
  payload while leaving Size/Checksum stale so the receiver's integrity gate
  must catch it;
- sniffer: counts sent/dropped Data/Ack packets at write time.

Batched syscalls: with ``DBMT_MMSG`` on (the default) and
``recvmmsg``/``sendmmsg`` present, :func:`listen_udp`/:func:`dial_udp`
return a :class:`MmsgEndpoint` — a raw nonblocking socket on the loop's
readable callback instead of an asyncio datagram transport. One readable
callback is ONE ``recvmmsg`` of up to ``DBMT_MMSG_BATCH`` datagrams;
outbound frames queue and flush in ONE ``sendmmsg`` per loop iteration
(``call_soon`` runs the flush after the pump that produced the burst —
the "flush at pump-exit" point, like the engine's batched receive
drain). The fault pipeline is shared code either way: both endpoints
funnel inbound datagrams through :meth:`UDPEndpoint._ingress` and
outbound through the same ``send -> _send_now`` chain, so drop/delay/
mutate/sniff semantics are byte-identical. Fallback is graceful and
per-endpoint: non-Linux, missing libc symbols, or a non-IPv4 address
just uses the stock transport (``net.syscalls`` then counts one per
datagram, which is what it truly costs).
"""

from __future__ import annotations

import asyncio
import base64
import json
import socket as _socket

from .faults import DELAY_MILLIS, knobs, log, sometimes
from . import sniff
from ..lsp import _mmsg
from ..utils._env import int_env as _int_env
from ..utils.metrics import registry as _registry

# Transport fault metrics (utils/metrics.py), module-scope handles for the
# per-packet paths. These RIDE ALONGSIDE the sniff counters — the sniffer's
# start/stop/result contract (graded by the backoff tests) is untouched.
_M = _registry()
_MET_DROPS = {
    (True, "read"): _M.counter("net.drops", point="server_read"),
    (False, "read"): _M.counter("net.drops", point="client_read"),
    (True, "write"): _M.counter("net.drops", point="server_write"),
    (False, "write"): _M.counter("net.drops", point="client_write"),
}
_MET_PARTITION = {"read": _M.counter("net.partition_drops", dir="read"),
                  "write": _M.counter("net.partition_drops", dir="write")}
_MET_DELAYS = _M.counter("net.delays")
# Syscall economics: syscalls and datagrams per direction, so
# syscalls/msg is computable from counters alone (the bench probe's
# contract). The stock path truly is 1:1; the mmsg path counts one
# syscall per recvmmsg/sendmmsg burst.
_MET_SYSCALLS = {"recv": _M.counter("net.syscalls", dir="recv"),
                 "send": _M.counter("net.syscalls", dir="send")}
_MET_DATAGRAMS = {"recv": _M.counter("net.datagrams", dir="recv"),
                  "send": _M.counter("net.datagrams", dir="send")}
_MET_BYTES = {"recv": _M.counter("net.bytes", dir="recv"),
              "send": _M.counter("net.bytes", dir="send")}


def join_host_port(host: str, port: str | int) -> str:
    """Go ``net.JoinHostPort`` semantics (ref: lspnet/net.go:81-84): a
    host containing a colon (IPv6 literal) is bracketed."""
    if ":" in host:
        return f"[{host}]:{port}"
    return f"{host}:{port}"


def split_host_port(hostport: str) -> tuple[str, str]:
    """Go ``net.SplitHostPort`` semantics (ref: lspnet/net.go:86-89):
    ``host:port`` / ``[ipv6]:port`` -> (host, port); malformed input
    raises ValueError with Go's diagnostic phrasing. An empty host is
    allowed (``:6060`` means all interfaces / localhost by context),
    exactly as in Go.
    """
    if hostport.startswith("["):
        end = hostport.find("]")
        if end < 0:
            raise ValueError(f"address {hostport}: missing ']' in address")
        host = hostport[1:end]
        rest = hostport[end + 1:]
        if not rest.startswith(":"):
            raise ValueError(f"address {hostport}: missing port in address")
        port = rest[1:]
        if ":" in port:
            raise ValueError(
                f"address {hostport}: too many colons in address")
    else:
        host, sep, port = hostport.partition(":")
        if not sep:
            raise ValueError(f"address {hostport}: missing port in address")
        if ":" in host or ":" in port:
            raise ValueError(
                f"address {hostport}: too many colons in address")
    for ch, msg in (("[", "unexpected '[' in address"),
                    ("]", "unexpected ']' in address")):
        if ch in host or ch in port:
            raise ValueError(f"address {hostport}: {msg}")
    return host, port


def _mutate_data_packet(data: bytes, obj: dict) -> bytes:
    """Apply shorten/lengthen/corrupt to a Data message (ref: lspnet/conn.go:143-175).

    ``obj`` is the already-parsed JSON of ``data`` (parsed once by the caller).
    """
    shorten = sometimes(knobs.shorten_percent)
    lengthen = sometimes(knobs.lengthen_percent)
    corrupt = knobs.corrupted
    if not (shorten or lengthen or corrupt):
        return data
    try:
        payload = bytearray(base64.b64decode(obj["Payload"]) if obj.get("Payload") else b"")
    except Exception:  # noqa: BLE001 — non-LSP traffic passes through untouched
        return data
    if shorten:
        payload = payload[: len(payload) // 2]
    elif lengthen:
        payload += bytes([2, 3, 4])
    elif corrupt:
        if len(payload) == 0:
            payload = bytearray([0xFF])
        else:
            payload[0] = payload[0] ^ 0xFF
    obj["Payload"] = base64.b64encode(bytes(payload)).decode("ascii")
    return json.dumps(obj, separators=(",", ":")).encode("utf-8")


def _parse_packet(data: bytes) -> tuple[int, dict | None]:
    try:
        obj = json.loads(data)
        return int(obj.get("Type", -1)), obj
    except Exception:  # noqa: BLE001
        return -1, None


def _packet_conn_id(data: bytes) -> int | None:
    """ConnID of an LSP packet, or None for non-LSP traffic."""
    obj = _parse_packet(data)[1]
    try:
        return int(obj["ConnID"]) if obj is not None else None
    except (KeyError, TypeError, ValueError):
        return None


class _Protocol(asyncio.DatagramProtocol):
    """Binds to its UDPEndpoint after construction (the endpoint wraps the
    transport, which only exists once the protocol has been created)."""

    def __init__(self):
        self._ep: UDPEndpoint | None = None
        self._pending: list[tuple[bytes, tuple]] = []
        self._lost = False

    def bind(self, ep: "UDPEndpoint") -> None:
        self._ep = ep
        for data, addr in self._pending:
            ep._ingress(data, addr)
        self._pending.clear()
        if self._lost:
            ep._recv_queue.put_nowait(None)

    def datagram_received(self, data: bytes, addr) -> None:
        # Stock path: asyncio made one recvfrom syscall for this datagram.
        _MET_SYSCALLS["recv"].inc()
        if self._ep is None:
            self._pending.append((data, addr))
        else:
            self._ep._ingress(data, addr)

    def connection_lost(self, exc) -> None:
        if self._ep is None:
            self._lost = True
        else:
            self._ep._recv_queue.put_nowait(None)


class UDPEndpoint:
    """One UDP socket with fault injection. Not thread-safe; owned by one loop."""

    def __init__(self, transport: asyncio.DatagramTransport | None,
                 is_server: bool):
        self._transport = transport
        self.is_server = is_server
        self._recv_queue: asyncio.Queue = asyncio.Queue()
        self._closed = False
        self._delay_tasks: set[asyncio.Task] = set()

    @property
    def sockname(self):
        return self._transport.get_extra_info("sockname")

    def _ingress(self, data: bytes, addr) -> None:
        """Read-side fault pipeline, shared by the stock protocol callback
        and the mmsg readable callback (ref: lspnet/conn.go read faults)."""
        _MET_DATAGRAMS["recv"].inc()
        _MET_BYTES["recv"].inc(len(data))
        if self.is_server and knobs.partition_read and \
                _packet_conn_id(data) in knobs.partition_read:
            if knobs.debug:
                log.info("PARTITION dropping read packet of length %d",
                         len(data))
            _MET_PARTITION["read"].inc()
            return
        drop = knobs.server_read_drop if self.is_server else knobs.client_read_drop
        if sometimes(drop):
            if knobs.debug:
                log.info("DROPPING read packet of length %d", len(data))
            _MET_DROPS[(self.is_server, "read")].inc()
            return
        self._recv_queue.put_nowait((data, addr))

    async def recv(self) -> tuple[bytes, tuple] | None:
        """Next surviving inbound datagram, or None once the socket is closed."""
        if self._closed and self._recv_queue.empty():
            return None
        item = await self._recv_queue.get()
        return item

    def recv_nowait(self) -> tuple[bytes, tuple] | None:
        """An already-queued inbound datagram without awaiting, or None.

        The burst-drain idiom: one ``recvmmsg`` enqueues up to
        a whole batch at once, so the engines' receive loops pay ONE
        awaited ``recv()`` (a loop round-trip) per burst and drain the
        rest synchronously. The closed sentinel is left in place for the
        next awaited ``recv()`` to consume — popping it here would eat
        the only close notification."""
        try:
            item = self._recv_queue.get_nowait()
        except asyncio.QueueEmpty:
            return None
        if item is None:
            self._recv_queue.put_nowait(None)
            return None
        return item

    def send(self, data: bytes, addr=None) -> None:
        """Send one datagram through the fault pipeline (ref: lspnet/conn.go:104-190)."""
        if self._closed:
            return
        if sometimes(knobs.delay_percent):
            if knobs.debug:
                log.info("DELAYING written packet of length %d", len(data))
            _MET_DELAYS.inc()
            task = asyncio.get_running_loop().create_task(self._send_later(data, addr))
            self._delay_tasks.add(task)
            task.add_done_callback(self._delay_tasks.discard)
            return
        self._send_now(data, addr)

    async def _send_later(self, data: bytes, addr) -> None:
        await asyncio.sleep(DELAY_MILLIS / 1000.0)
        if not self._closed:
            self._send_now(data, addr)

    def _send_now(self, data: bytes, addr) -> None:
        if self.is_server and knobs.partition_write and \
                _packet_conn_id(data) in knobs.partition_write:
            if knobs.debug:
                log.info("PARTITION dropping written packet of length %d",
                         len(data))
            _MET_PARTITION["write"].inc()
            return
        # Only pay the JSON parse when a knob or the sniffer needs the type.
        inspect = (sniff.is_sniffing() or knobs.shorten_percent
                   or knobs.lengthen_percent or knobs.corrupted)
        mtype, obj = _parse_packet(data) if inspect else (-1, None)
        drop = knobs.server_write_drop if self.is_server else knobs.client_write_drop
        if sometimes(drop):
            if knobs.debug:
                log.info("DROPPING written packet of length %d", len(data))
            _MET_DROPS[(self.is_server, "write")].inc()
            if sniff.is_sniffing():
                sniff.record(mtype, sent=False)
            return
        if sniff.is_sniffing():
            sniff.record(mtype, sent=True)
        if inspect and mtype == 1 and obj is not None:
            data = _mutate_data_packet(data, obj)
        self._raw_send(data, addr)

    def _raw_send(self, data: bytes, addr) -> None:
        """Post-fault-pipeline transmission: stock = one sendto syscall."""
        _MET_SYSCALLS["send"].inc()
        _MET_DATAGRAMS["send"].inc()
        _MET_BYTES["send"].inc(len(data))
        self._transport.sendto(data, addr)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for task in list(self._delay_tasks):
            task.cancel()
        self._transport.close()


class MmsgEndpoint(UDPEndpoint):
    """The batched-syscall endpoint: a raw nonblocking UDP
    socket driven by ``loop.add_reader``, recv and send both one syscall
    per burst via :mod:`..lsp._mmsg`. Same fault pipeline, same
    ``recv()``/``send()`` surface as the stock endpoint."""

    def __init__(self, sock: _socket.socket, is_server: bool, batch: int):
        super().__init__(None, is_server)
        self._sock = sock
        self._mm = _mmsg.MmsgSocket(sock.fileno(), batch)
        self._batch = batch
        self._loop = asyncio.get_running_loop()
        self._send_pending: list[tuple[bytes, tuple | None]] = []
        self._flush_scheduled = False
        self._writer_armed = False
        # Cached: the stock transport answers sockname after close too
        # (the fenced-replica exit path reads .port post-shutdown).
        self._sockname = sock.getsockname()
        self._loop.add_reader(sock.fileno(), self._on_readable)

    @property
    def sockname(self):
        return self._sockname

    def _on_readable(self) -> None:
        # One recvmmsg per readable callback. More queued than one batch
        # holds? The level-triggered selector re-fires the callback, each
        # firing one syscall — the burst size IS the amortization.
        if self._closed:
            return
        try:
            got = self._mm.recv_burst()
        except OSError:
            # e.g. ECONNREFUSED surfaced by ICMP on a connected socket
            # after peer death — the stock path routes this to
            # error_received and drops it; so do we.
            return
        if not got:
            return
        _MET_SYSCALLS["recv"].inc()
        for data, addr in got:
            self._ingress(data, addr)

    def _raw_send(self, data: bytes, addr) -> None:
        # Queue, and flush ONCE per loop iteration: call_soon runs after
        # the currently-draining pump, so every frame the pump produced
        # (acks for a whole recv burst, a window's worth of data) goes
        # out in one sendmmsg.
        self._send_pending.append((data, addr))
        if not self._flush_scheduled:
            self._flush_scheduled = True
            self._loop.call_soon(self._flush_send)

    def _flush_send(self) -> None:
        self._flush_scheduled = False
        if self._closed:
            self._send_pending.clear()
            return
        pending = self._send_pending
        while pending:
            try:
                sent = self._mm.send_burst(pending)
            except BlockingIOError:
                # Kernel send buffer full: resume when writable.
                _MET_SYSCALLS["send"].inc()
                self._arm_writer()
                return
            except OSError:
                # Async ICMP error (dead peer) charged to the head
                # datagram; drop it like error_received and move on.
                _MET_SYSCALLS["send"].inc()
                del pending[:1]
                continue
            _MET_SYSCALLS["send"].inc()
            _MET_DATAGRAMS["send"].inc(sent)
            _MET_BYTES["send"].inc(sum(len(d) for d, _ in pending[:sent]))
            del pending[:sent]

    def _arm_writer(self) -> None:
        if not self._writer_armed:
            self._writer_armed = True
            self._loop.add_writer(self._sock.fileno(), self._on_writable)

    def _on_writable(self) -> None:
        self._loop.remove_writer(self._sock.fileno())
        self._writer_armed = False
        self._flush_send()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for task in list(self._delay_tasks):
            task.cancel()
        fd = self._sock.fileno()
        if fd >= 0:
            self._loop.remove_reader(fd)
            if self._writer_armed:
                self._loop.remove_writer(fd)
        self._send_pending.clear()
        self._sock.close()
        # The stock path posts this sentinel from connection_lost.
        self._recv_queue.put_nowait(None)


def _try_mmsg_endpoint(local: tuple | None, remote: tuple | None,
                       is_server: bool) -> MmsgEndpoint | None:
    """A batched endpoint when the knob, platform, and address allow;
    None means the caller takes the stock transport."""
    if _int_env("DBMT_MMSG", 1) == 0 or not _mmsg.available():
        return None
    sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
    try:
        sock.setblocking(False)
        if local is not None:
            sock.bind(local)
        if remote is not None:
            sock.connect(remote)
        batch = max(1, _int_env("DBMT_MMSG_BATCH", 32))
        return MmsgEndpoint(sock, is_server, batch)
    except OSError:
        sock.close()
        return None


async def listen_udp(host: str = "127.0.0.1", port: int = 0) -> UDPEndpoint:
    """Open a server-side endpoint (ref: lspnet/net.go ListenUDP)."""
    ep = _try_mmsg_endpoint((host, port), None, is_server=True)
    if ep is not None:
        return ep
    loop = asyncio.get_running_loop()
    transport, protocol = await loop.create_datagram_endpoint(
        _Protocol, local_addr=(host, port))
    ep = UDPEndpoint(transport, is_server=True)
    protocol.bind(ep)
    return ep


async def dial_udp(host: str, port: int) -> UDPEndpoint:
    """Open a client-side endpoint connected to (host, port) (ref: lspnet/net.go DialUDP)."""
    ep = _try_mmsg_endpoint(None, (host, port), is_server=False)
    if ep is not None:
        return ep
    loop = asyncio.get_running_loop()
    transport, protocol = await loop.create_datagram_endpoint(
        _Protocol, remote_addr=(host, port))
    ep = UDPEndpoint(transport, is_server=False)
    protocol.bind(ep)
    return ep
