"""Allocation-lean LSP wire codec: the per-packet fast path.

``Message.to_json``/``from_json`` are the REFERENCE codec — Go
``encoding/json`` field order, standard base64, ``null`` payload — and
every byte they emit is pinned by the Go-replay goldens. They are also
the per-message cost the datapath pays millions of times: an f-string
build plus two str/bytes round-trips on encode, a ``json.loads`` dict
plus ``base64.b64decode`` on decode.

This module provides byte-for-byte-identical fast paths:

- :func:`encode_data` / :func:`encode_ack` / :func:`encode_connect`:
  the three hot message kinds, assembled in ONE C-level template
  substitution over precompiled byte templates plus ``binascii``
  base64 — no intermediate str objects, no dict, no json module.
  (A reused-bytearray assembly variant measured ~1.6x stock against
  the template's ~2.5x: the frame must be returned as immutable bytes
  anyway — ``_Pending`` retains it for retransmit — so buffer reuse
  only added copies. The measurement lives with the fuzz leg in
  ``tests/test_transport_fast.py``.) Output is bit-identical to
  ``to_json`` of the equivalent :class:`~.message.Message` — the fuzz
  round-trip leg and the Go-replay goldens pin it.
- :func:`decode`: strict scanner for the canonical frame layout the
  encoders (ours and Go's) emit. Anything non-canonical — reordered
  keys, whitespace, floats, unknown fields — falls back to
  ``Message.from_json``, so the ACCEPTED language and every error path
  are exactly the stock codec's. Corrupt base64 is re-validated with
  the same alphabet rule ``b64decode(validate=True)`` applies.
- :func:`checksum`: the wire checksum via one big-int ``int.from_bytes``
  + modular fold instead of a per-byte-pair Python loop. Exact for any
  payload a UDP datagram can carry (< 64 KiB, where the reference's
  32-bit masking is a no-op); larger payloads take the stock loop.

``DBMT_WIRE_FAST=0`` routes every call back to the stock codec — the
knob-off matrix leg runs the transport suites that way, so stock parity
stays covered both as an equality assertion AND as live wire traffic.
"""

from __future__ import annotations

import re
from binascii import Error as _B64Error, a2b_base64, b2a_base64

from ..utils._env import int_env as _int_env
from .checksum import int2checksum, make_checksum
from .message import Message, MsgType

__all__ = ["encode_data", "encode_ack", "encode_connect", "encode",
           "decode", "checksum", "fast_enabled"]

#: Read once at import (endpoints are constructed after env is set; the
#: tier-1 matrix leg flips it per process). ``refresh()`` re-reads for
#: tests that monkeypatch the environment mid-process.
_FAST = _int_env("DBMT_WIRE_FAST", 1) != 0


def fast_enabled() -> bool:
    return _FAST


def refresh() -> None:
    """Re-read ``DBMT_WIRE_FAST`` (test hook; endpoints read per call)."""
    global _FAST
    _FAST = _int_env("DBMT_WIRE_FAST", 1) != 0


# ------------------------------------------------------------------ encode

#: Canonical frame templates (Go struct field order — ref: lsp/message.go).
_FMT_DATA = b'{"Type":1,"ConnID":%d,"SeqNum":%d,"Size":%d,"Checksum":%d,"Payload":"%s"}'
_TAIL_DATA = b'"}'
#: Acks/Connects carry no payload: the whole frame is one format.
_FMT_ACK = b'{"Type":2,"ConnID":%d,"SeqNum":%d,"Size":0,"Checksum":0,"Payload":null}'
_FRAME_CONNECT = b'{"Type":0,"ConnID":0,"SeqNum":0,"Size":0,"Checksum":0,"Payload":null}'


# dbmlint: hotpath
def encode_data(conn_id: int, seq_num: int, size: int, cksum: int,
                payload: bytes) -> bytes:
    """Wire bytes of ``new_data(...).to_json()``, one template pass."""
    if not _FAST:
        return Message(MsgType.DATA, conn_id, seq_num, size, cksum,
                       payload).to_json()
    return _FMT_DATA % (conn_id, seq_num, size, cksum,
                        b2a_base64(payload, newline=False))


# dbmlint: hotpath
def encode_ack(conn_id: int, seq_num: int) -> bytes:
    """Wire bytes of ``new_ack(conn_id, seq_num).to_json()``."""
    if not _FAST:
        return Message(MsgType.ACK, conn_id, seq_num).to_json()
    return _FMT_ACK % (conn_id, seq_num)


def encode_connect() -> bytes:
    """Wire bytes of ``new_connect().to_json()`` (cold path: once/conn)."""
    if not _FAST:
        return Message(MsgType.CONNECT).to_json()
    return _FRAME_CONNECT


def encode(msg: Message) -> bytes:
    """Fast-encode an arbitrary :class:`Message`; non-canonical shapes
    (a payload-carrying Ack, a sized Connect) take ``to_json`` so output
    is identical for EVERY message, not just the hot kinds."""
    if _FAST and msg.type == MsgType.DATA and msg.payload is not None:
        return encode_data(msg.conn_id, msg.seq_num, msg.size,
                           msg.checksum, msg.payload)
    if _FAST and msg.type == MsgType.ACK and msg.size == 0 \
            and msg.checksum == 0 and msg.payload is None:
        return encode_ack(msg.conn_id, msg.seq_num)
    return msg.to_json()


# ------------------------------------------------------------------ decode

_P_TYPE = b'{"Type":'
_P_CONN = b',"ConnID":'
_P_SEQ = b',"SeqNum":'
_P_SIZE = b',"Size":'
_P_CK = b',"Checksum":'
_P_PAY = b',"Payload":'
#: The exact alphabet rule ``base64.b64decode(validate=True)`` enforces
#: (CPython checks this regex, then lets binascii do padding checks):
#: the fast path must DROP the same corrupt frames the stock path drops.
_B64_RE = re.compile(rb"[A-Za-z0-9+/]*={0,2}")
_MSGTYPE = (MsgType.CONNECT, MsgType.DATA, MsgType.ACK)


def _field_int(raw: bytes, start: int, sep: bytes) -> "tuple[int, int] | None":
    """Parse the decimal between ``start`` and the next ``sep``; returns
    (value, index_after_sep) or None when the frame is non-canonical."""
    end = raw.find(sep, start)
    if end < 0:
        return None
    digits = raw[start:end]
    if not (digits.isdigit()
            or (digits[:1] == b"-" and digits[1:].isdigit())):
        return None
    return int(digits), end + len(sep)


# dbmlint: hotpath
def _decode_fast(raw: bytes) -> "Message | None":
    """Canonical-layout scanner; None means "not canonical, fall back"."""
    if not raw.startswith(_P_TYPE):
        return None
    got = _field_int(raw, 8, _P_CONN)
    if got is None:
        return None
    mtype, i = got
    if not 0 <= mtype <= 2:
        return None
    got = _field_int(raw, i, _P_SEQ)
    if got is None:
        return None
    conn_id, i = got
    got = _field_int(raw, i, _P_SIZE)
    if got is None:
        return None
    seq_num, i = got
    got = _field_int(raw, i, _P_CK)
    if got is None:
        return None
    size, i = got
    got = _field_int(raw, i, _P_PAY)
    if got is None:
        return None
    cksum, i = got
    tail = raw[i:]
    if tail == b"null}":
        payload = None
    elif tail[:1] == b'"' and tail[-2:] == _TAIL_DATA:
        b64 = tail[1:-2]
        if _B64_RE.fullmatch(b64) is None:
            return None     # stock path raises on this frame: fall back
        try:
            payload = a2b_base64(b64)
        except _B64Error:
            return None     # bad padding: fall back to the stock error
    else:
        return None
    return Message(_MSGTYPE[mtype], conn_id, seq_num, size, cksum, payload)


def decode(raw: bytes) -> Message:
    """Parse one wire frame. Raises ValueError on malformed input with
    the stock codec's exact semantics (the caller drops the packet)."""
    if _FAST:
        msg = _decode_fast(raw)
        if msg is not None:
            return msg
    return Message.from_json(raw)


# ---------------------------------------------------------------- checksum

#: Above this payload length the reference's 32-bit masking inside
#: ``bytearray2checksum``/``make_checksum`` can bite (word-sum >= 2^32
#: needs ~128 KiB); UDP tops out below 64 KiB, so the guard only routes
#: pathological non-datagram inputs to the stock loop.
_MOD_EXACT_LIMIT = 65536


# dbmlint: hotpath
def checksum(conn_id: int, seq_num: int, size: int, payload: bytes) -> int:
    """``make_checksum`` equivalence via modular arithmetic.

    The wire checksum is a base-2^16 digit sum with end-around carry,
    i.e. arithmetic mod 65535 (with the fold mapping nonzero multiples
    to 0xFFFF, never 0). ``int.from_bytes(payload, "little")`` is that
    digit string as ONE number, so the payload's word-sum is congruent
    to it mod 65535 — one C call replaces the per-byte-pair loop.
    """
    if not _FAST or len(payload) >= _MOD_EXACT_LIMIT:
        return make_checksum(conn_id, seq_num, size, payload)
    total = (int2checksum(conn_id) + int2checksum(seq_num)
             + int2checksum(size))
    n = int.from_bytes(payload, "little") if payload else 0
    if total == 0 and n == 0:
        return 0
    return (total + n % 0xFFFF - 1) % 0xFFFF + 1
