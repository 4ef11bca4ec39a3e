"""``recvmmsg``/``sendmmsg`` via ctypes: one syscall per burst.

The stock asyncio datagram path costs one ``recvfrom`` and one ``sendto``
syscall per packet. Under an echo storm the datapath handles bursts —
the recv pump drains what arrived, and every inbound Data produces an
Ack at pump exit — so Linux's batched datagram syscalls amortize the
kernel crossing over up to ``DBMT_MMSG_BATCH`` packets in each direction.

This module is the raw syscall wrapper only: :class:`MmsgSocket` owns
the preallocated receive buffers and the ctypes header arrays (iovec /
msghdr / mmsghdr / sockaddr_in), built ONCE and reused for every call —
the per-burst Python work is slicing received bytes out of the reused
buffers and pointing iovecs at outgoing frames. Event-loop integration
(readable callbacks, send-flush scheduling, fault pipeline, metrics)
lives in ``lspnet/net.py``'s ``MmsgEndpoint``; availability gating and
graceful fallback to one-per-syscall live there too, keyed on
:func:`available` (Linux + libc symbols + AF_INET). No new
dependencies: ``ctypes`` against the already-loaded libc.

IPv4 only — the sockaddr storage is ``sockaddr_in``. Non-IPv4 binds
fall back to the stock endpoint at the caller.
"""

from __future__ import annotations

import ctypes
import errno
import os
import socket
import sys
from typing import List, Optional, Tuple

__all__ = ["available", "MmsgSocket", "RECV_BUF_SIZE"]

#: Max UDP datagram; each preallocated recv buffer is this large, so no
#: inbound datagram is ever truncated.
RECV_BUF_SIZE = 65535


class _iovec(ctypes.Structure):
    # iov_base as c_char_p (same pointer ABI as void*): the send path
    # assigns a frame's ``bytes`` object straight to the field — no
    # per-frame c_char_p()/cast() pair — and ctypes' _objects tracking
    # keeps the frame alive for the call.
    _fields_ = [("iov_base", ctypes.c_char_p),
                ("iov_len", ctypes.c_size_t)]


class _sockaddr_in(ctypes.Structure):
    _fields_ = [("sin_family", ctypes.c_uint16),
                ("sin_port", ctypes.c_uint16),      # network byte order
                ("sin_addr", ctypes.c_uint8 * 4),   # network byte order
                ("sin_zero", ctypes.c_uint8 * 8)]


class _msghdr(ctypes.Structure):
    # Field types per glibc's struct msghdr on Linux; ctypes inserts the
    # same alignment padding the C ABI does (namelen u32 -> pad -> ptr).
    _fields_ = [("msg_name", ctypes.c_void_p),
                ("msg_namelen", ctypes.c_uint32),
                ("msg_iov", ctypes.POINTER(_iovec)),
                ("msg_iovlen", ctypes.c_size_t),
                ("msg_control", ctypes.c_void_p),
                ("msg_controllen", ctypes.c_size_t),
                ("msg_flags", ctypes.c_int)]


class _mmsghdr(ctypes.Structure):
    _fields_ = [("msg_hdr", _msghdr),
                ("msg_len", ctypes.c_uint)]


def _load_libc():
    if not sys.platform.startswith("linux"):
        return None
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.recvmmsg  # noqa: B018 — symbol probe; AttributeError = absent
        libc.sendmmsg  # noqa: B018
    except (OSError, AttributeError):
        return None
    libc.recvmmsg.restype = ctypes.c_int
    libc.sendmmsg.restype = ctypes.c_int
    return libc


_LIBC = _load_libc()


def available() -> bool:
    """True when batched datagram syscalls exist on this platform."""
    return _LIBC is not None


class MmsgSocket:
    """Preallocated recv/send header arrays over one UDP socket fd.

    Not thread-safe; one owner (the event loop) calls
    :meth:`recv_burst` / :meth:`send_burst`, each exactly one syscall.
    """

    def __init__(self, fd: int, batch: int):
        if _LIBC is None:
            raise OSError("recvmmsg/sendmmsg unavailable on this platform")
        self._fd = fd
        self._batch = batch

        # Receive side: buffers + headers wired once, reused every call.
        self._r_bufs = [ctypes.create_string_buffer(RECV_BUF_SIZE)
                        for _ in range(batch)]
        self._r_iovs = (_iovec * batch)()
        self._r_names = (_sockaddr_in * batch)()
        self._r_hdrs = (_mmsghdr * batch)()
        for i in range(batch):
            self._r_iovs[i].iov_base = ctypes.cast(self._r_bufs[i],
                                                   ctypes.c_char_p)
            self._r_iovs[i].iov_len = RECV_BUF_SIZE
            hdr = self._r_hdrs[i].msg_hdr
            hdr.msg_name = ctypes.cast(ctypes.byref(self._r_names[i]),
                                       ctypes.c_void_p)
            hdr.msg_namelen = ctypes.sizeof(_sockaddr_in)
            hdr.msg_iov = ctypes.pointer(self._r_iovs[i])
            hdr.msg_iovlen = 1

        # Send side: headers reused; iov_base is pointed at each outgoing
        # frame's bytes per call (the caller keeps the frames referenced
        # for the duration of send_burst).
        self._s_iovs = (_iovec * batch)()
        self._s_hdrs = (_mmsghdr * batch)()
        for i in range(batch):
            hdr = self._s_hdrs[i].msg_hdr
            hdr.msg_iov = ctypes.pointer(self._s_iovs[i])
            hdr.msg_iovlen = 1

        # Peer-address caches, both directions: the
        # peer set is small and stable (one address per live client), so
        # the per-packet inet_ntoa/ntohs decode and the per-frame
        # sockaddr_in pack are paid once per PEER, not once per packet.
        # Entries are tiny and live for the socket's lifetime.
        self._raddr_cache: dict = {}
        self._saddr_cache: dict = {}

    # -------------------------------------------------------------- receive

    def recv_burst(self) -> List[Tuple[bytes, Tuple[str, int]]]:
        """One ``recvmmsg``: every datagram already queued, up to the
        batch size. Returns [] when the socket has nothing (EAGAIN)."""
        n = _LIBC.recvmmsg(self._fd, self._r_hdrs, self._batch, 0, None)
        if n <= 0:
            if n == 0:
                return []
            err = ctypes.get_errno()
            if err in (errno.EAGAIN, errno.EWOULDBLOCK, errno.EINTR):
                return []
            raise OSError(err, os.strerror(err))
        out = []
        cache = self._raddr_cache
        for i in range(n):
            length = self._r_hdrs[i].msg_len
            name = self._r_names[i]
            key = (bytes(name.sin_addr), name.sin_port)
            addr = cache.get(key)
            if addr is None:
                addr = (socket.inet_ntoa(key[0]), socket.ntohs(key[1]))
                cache[key] = addr
            # string_at copies exactly `length` bytes out of the reused
            # buffer (the .raw property would materialize all 64 KiB
            # first — measured at ~60% of recv_burst's cost).
            out.append((ctypes.string_at(self._r_bufs[i], length), addr))
            # The kernel overwrote namelen with the actual address size;
            # restore the storage size for the next call.
            self._r_hdrs[i].msg_hdr.msg_namelen = ctypes.sizeof(_sockaddr_in)
        return out

    # ----------------------------------------------------------------- send

    def send_burst(self,
                   items: List[Tuple[bytes, Optional[Tuple[str, int]]]]) -> int:
        """One ``sendmmsg`` over up to ``batch`` (frame, addr) pairs; an
        addr of None sends on the connected socket's peer. Returns how
        many datagrams the kernel accepted (possibly fewer than offered);
        raises BlockingIOError when not even the first would go out."""
        count = min(len(items), self._batch)
        cache = self._saddr_cache
        for i in range(count):
            data, addr = items[i]
            iov = self._s_iovs[i]
            iov.iov_base = data
            iov.iov_len = len(data)
            hdr = self._s_hdrs[i].msg_hdr
            if addr is None:
                hdr.msg_name = None
                hdr.msg_namelen = 0
            else:
                entry = cache.get(addr)
                if entry is None:
                    name = _sockaddr_in()
                    name.sin_family = socket.AF_INET
                    name.sin_port = socket.htons(addr[1])
                    packed = socket.inet_aton(addr[0])
                    for j in range(4):
                        name.sin_addr[j] = packed[j]
                    # The struct is kept alive by the cache entry; the
                    # pointer is therefore stable and reusable.
                    entry = (name, ctypes.cast(ctypes.byref(name),
                                               ctypes.c_void_p))
                    cache[addr] = entry
                hdr.msg_name = entry[1]
                hdr.msg_namelen = ctypes.sizeof(_sockaddr_in)
        n = _LIBC.sendmmsg(self._fd, self._s_hdrs, count, 0)
        if n < 0:
            err = ctypes.get_errno()
            if err in (errno.EAGAIN, errno.EWOULDBLOCK, errno.EINTR):
                raise BlockingIOError(err, os.strerror(err))
            raise OSError(err, os.strerror(err))
        return n
