"""Join / Request / Result application messages.

JSON layout matches Go ``encoding/json`` of the reference struct
(ref: bitcoin/message.go:18-49): all fields always present, in struct order,
``Lower``/``Upper``/``Hash``/``Nonce`` are uint64 numbers.

Difficulty extension (this framework only): a Request may carry a
``Target`` field — "stop at the first nonce whose hash is strictly below
this". It is appended AFTER the reference fields and
only when set, so a target-less message is byte-identical to the stock
encoding, and a stock Go endpoint parsing a target-ful one simply drops
the unknown key (``encoding/json`` ignores fields with no struct match)
and performs a full arg-min scan — a valid, if slower, answer to the same
Request. ``target == 0`` means "no target": no uint64 hash is ``< 0``, so
zero could never qualify a nonce anyway.

Trace extension: a miner→server
Result may carry a ``Span`` object — the chunk's device-timing span
(utils/trace.py phase vocabulary) that the scheduler stitches into the
request's trace. Appended only when set (``DBMT_TRACE=1``) so a span-less
message keeps stock bytes bit-for-bit; a stock endpoint drops the
unknown key. Parsing tolerates ANY malformed value by dropping it to
None — an observability field must never kill a message that carries a
valid answer.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass


def _go_json_string(s: str) -> str:
    """Encode a string exactly like Go ``encoding/json`` (HTML-escaping on,
    non-ASCII emitted as raw UTF-8, U+2028/U+2029 escaped)."""
    out = json.dumps(s, ensure_ascii=False)
    out = out.replace("<", "\\u003c").replace(">", "\\u003e").replace("&", "\\u0026")
    out = out.replace("\u2028", "\\u2028").replace("\u2029", "\\u2029")
    return out


class MsgType(enum.IntEnum):
    JOIN = 0     # miner -> server: register for work
    REQUEST = 1  # client -> server and server -> miner: search [lower, upper]
    RESULT = 2   # miner -> server and server -> client: (min hash, argmin nonce)


@dataclass
class Message:
    type: MsgType = MsgType.JOIN
    data: str = ""
    lower: int = 0
    upper: int = 0
    hash: int = 0
    nonce: int = 0
    target: int = 0   # extension; 0 = absent (stock bytes)
    span: dict = None  # trace extension; None = absent (stock bytes)
    rate: int = 0     # JOIN rate-hint extension; 0 = absent (stock bytes)

    def to_json(self) -> bytes:
        tail = f',"Target":{self.target}' if self.target else ""
        if self.span:
            tail += ',"Span":%s' % json.dumps(
                self.span, sort_keys=True, separators=(",", ":"))
        if self.rate:
            tail += f',"Rate":{self.rate}'
        return (
            '{"Type":%d,"Data":%s,"Lower":%d,"Upper":%d,"Hash":%d,"Nonce":%d%s}'
            % (int(self.type), _go_json_string(self.data), self.lower, self.upper,
               self.hash, self.nonce, tail)
        ).encode("utf-8")

    @classmethod
    def from_json(cls, raw: bytes) -> "Message":
        obj = json.loads(raw)
        # Valid JSON that isn't an object ([1,2], "x", 5) or carries a
        # non-string Data must raise ValueError like malformed bytes do:
        # an AttributeError here escapes the recv loops' `except
        # ValueError: continue` and kills the whole endpoint, not one
        # message.
        if not isinstance(obj, dict) or not isinstance(obj.get("Data", ""),
                                                       str):
            raise ValueError("not a message object")

        def u64(key: str) -> int:
            # Go json.Unmarshal into uint64 errors on out-of-range,
            # fractional, or non-numeric values and the reference endpoints
            # skip unparsable messages; raising ValueError here reaches the
            # same `except ValueError: continue` in every caller. The
            # isinstance check must come before any int() conversion:
            # int(None)/int([1]) raise TypeError and int(float('inf'))
            # OverflowError, which would escape those guards and kill the
            # endpoint, not the message; and without the range check a
            # poison Request (e.g. Target = 2^64) would crash each miner's
            # c_uint64/uint32 conversion in turn and drain the whole pool
            #.
            value = obj.get(key, 0)
            if isinstance(value, bool) or not isinstance(value, int) \
                    or not 0 <= value < (1 << 64):
                raise ValueError(f"{key} is not a uint64")
            return value

        type_value = obj.get("Type", 0)
        if isinstance(type_value, bool) or not isinstance(type_value, int):
            raise ValueError("Type is not an integer")
        # Span is observability-only: a malformed value (non-dict, junk
        # from a hostile peer) is dropped, never an error — the message
        # still carries a valid answer the merge must not lose.
        span = obj.get("Span")
        if not isinstance(span, dict):
            span = None
        # Rate is a scheduling HINT: like Span,
        # a malformed value from a hostile or buggy peer drops to 0 (no
        # hint) rather than killing a JOIN that is otherwise valid — the
        # scheduler treats an unhinted miner exactly like a stock one.
        rate = obj.get("Rate", 0)
        if isinstance(rate, bool) or not isinstance(rate, int) \
                or not 0 <= rate < (1 << 64):
            rate = 0
        return cls(
            type=MsgType(type_value),
            data=obj.get("Data", ""),
            lower=u64("Lower"),
            upper=u64("Upper"),
            hash=u64("Hash"),
            nonce=u64("Nonce"),
            target=u64("Target"),
            span=span,
            rate=rate,
        )

    def __str__(self) -> str:
        # Same pretty-print as the reference (ref: bitcoin/message.go:52-62).
        if self.type == MsgType.REQUEST:
            return f"[Request {self.data} {self.lower} {self.upper}]"
        if self.type == MsgType.RESULT:
            return f"[Result {self.hash} {self.nonce}]"
        return "[Join]"


def new_join(rate: int = 0) -> Message:
    """``rate``: measured throughput hint in nonces/s — a cold 1B-nps pod announces its width at JOIN so the
    scheduler's rate EWMA starts warm instead of feeding it mouse-sized
    chunks. 0 (the default, and every stock miner) serializes to
    reference-identical bytes; the hint is advisory and bounded/decayed
    scheduler-side until real Results confirm it."""
    return Message(type=MsgType.JOIN, rate=rate)


def new_request(data: str, lower: int, upper: int, target: int = 0) -> Message:
    return Message(type=MsgType.REQUEST, data=data, lower=lower, upper=upper,
                   target=target)


def new_result(hash_value: int, nonce: int, target: int = 0,
               span: dict = None) -> Message:
    """``target``: until-speaking miners echo the Request's target so the
    scheduler can tell which responders honored the extension (a stock
    miner drops the key; 0 serializes to reference-identical bytes).
    ``span``: the chunk's device-timing span (``DBMT_TRACE=1`` miners;
    None serializes to reference-identical bytes)."""
    return Message(type=MsgType.RESULT, hash=hash_value, nonce=nonce,
                   target=target, span=span)
