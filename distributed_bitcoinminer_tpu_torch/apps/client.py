"""The request client: submit one nonce range, await the merged Result.

Same contract as the reference submitter (ref: bitcoin/client/client.go):
write Request(message, 0, maxNonce), block on Read, report
``Result <hash> <nonce>`` or ``Disconnected`` when the connection is lost.
An optional target selects difficulty mode: the Result is then the first
nonce whose hash is below the target, or the exact arg-min when none is.

Usage: ``python -m distributed_bitcoinminer_tpu_torch.apps.client
<host:port> <message> <maxNonce> [target]``. With ``DBMT_RETRY_ATTEMPTS``
above 1, or a ``ring:<statedir>`` target (the process tier of
``apps.procs``), the CLI submits through :func:`submit_with_retry`.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional, Tuple

from ..bitcoin.hash import MAX_U64
from ..bitcoin.message import Message, MsgType, new_request
from ..lsp.client import new_async_client
from ..lsp.errors import LspError
from ..lsp.params import Params
from ..utils._env import int_env
from ..utils.config import (RetryParams, lsp_params_from_env,
                            retry_from_env)
from ..utils.metrics import registry as _registry

logger = logging.getLogger("dbmt.client")

# How often the retry plane fires, and how its submits end.
_M = _registry()
_MET_ATTEMPTS = _M.counter("client.retry_attempts")
_MET_OUTCOME = {k: _M.counter("client.retry_outcomes", outcome=k)
                for k in ("ok", "exhausted")}
_MET_RESULT_S = _M.histogram("client.result_latency_s")


async def submit(hostport: str, message: str, max_nonce: int,
                 params: Optional[Params] = None) -> Optional[Tuple[int, int]]:
    """Submit and await one request; None means the connection was lost.

    The stock exact-arg-min mode is the target-0 case of
    :func:`submit_until` (target 0 serializes to reference-identical
    bytes, bitcoin/message.py)."""
    result = await submit_until(hostport, message, max_nonce, 0, params)
    return None if result is None else result[:2]


async def submit_until(hostport: str, message: str, max_nonce: int,
                       target: int, params: Optional[Params] = None,
                       ) -> Optional[Tuple[int, int, bool]]:
    """Difficulty-target mode: one Request carrying ``Target`` (the wire
    extension of bitcoin/message.py).

    The scheduler fans the target out with every chunk and miners stop
    early at their chunk's first qualifying nonce
    (``models.NonceSearcher.search_until``), so a loose target completes
    far ahead of the full arg-min scan. Returns ``(hash, nonce, found)``:
    found means ``hash < target`` and, when every miner speaks the
    extension, ``nonce`` is the FIRST qualifying nonce of the scanned
    range; found=False hands back the exact arg-min. None = connection
    lost. Against a scheduler that drops the Target key, use
    :func:`stream_until`, which needs nothing beyond the reference wire.
    """
    client = await new_async_client(hostport, params)
    client.write(new_request(message, 0, max_nonce, target).to_json())
    try:
        payload = await client.read()
    except LspError:
        return None
    finally:
        await client.close()
    try:
        msg = Message.from_json(payload)
    except ValueError:
        return None
    if msg.type != MsgType.RESULT:
        return None
    return msg.hash, msg.nonce, msg.hash < target


async def stream_until(hostport: str, message: str, target: int,
                       span: int = 1 << 24, start: int = 0,
                       max_nonce: Optional[int] = None,
                       params: Optional[Params] = None,
                       ) -> Optional[Tuple[int, int, int]]:
    """Difficulty-target mode over the stock wire: stream Requests span by
    span until a merged Result beats ``target``.

    Each span rides a reference-shaped Request, so it works against ANY
    scheduler, but miners run a full arg-min per span (the early exit is
    only span-granular). Returns (hash, nonce, spans_scanned), or None on
    disconnect or once ``max_nonce`` is passed (default: the end of the
    uint64 nonce space, so an unreachable target cannot loop forever).
    """
    if max_nonce is None:
        max_nonce = MAX_U64
    client = await new_async_client(hostport, params)
    spans = 0
    lower = start
    try:
        while lower <= max_nonce:
            upper = min(lower + span - 1, max_nonce)
            client.write(new_request(message, lower, upper).to_json())
            try:
                payload = await client.read()
            except LspError:
                return None
            try:
                msg = Message.from_json(payload)
            except ValueError:
                return None
            if msg.type != MsgType.RESULT:
                return None
            spans += 1
            if msg.hash < target:
                return msg.hash, msg.nonce, spans
            lower = upper + 1
        return None
    finally:
        await client.close()


async def submit_with_retry(hostport: str, message: str, max_nonce: int,
                            target: int = 0,
                            params: Optional[Params] = None,
                            retry: Optional[RetryParams] = None,
                            tenant_key=None,
                            ) -> Optional[Tuple[int, int, bool]]:
    """Idempotent submit: a per-attempt timeout, exponential back-off and
    a fresh connection for each attempt.

    Each attempt is a NEW LSP connection carrying the same Request. On a
    dead connection or an expired ``timeout_s`` the attempt's connection
    is closed (the scheduler drops it and cancels its work, so a
    resubmission cannot be answered twice) and the next attempt
    reconnects after the back-off. The search is a pure function of
    ``(message, range, target)``, so re-running it is harmless, and at
    most one Result reaches the caller.

    ``hostport`` may be ``ring:<statedir>``, the process tier of
    ``apps.procs``: each attempt then resolves its replica anew, hashing
    ``tenant_key`` (default: the message) over the ring the router
    publishes (``procs.resolve_owner``). A replica killed or fenced
    mid-request shows as a dead connection or an expired attempt; the
    next attempt reads the membership again (the router's missed-beat
    detection has re-ringed by then) and goes to the new owner, where the
    request replays from the spool-replicated cache or is computed again.
    While no membership is readable the attempt spends its back-off and
    tries again.

    Returns ``(hash, nonce, found)`` as :func:`submit_until` does, or
    None once every attempt is spent.
    """
    retry = retry if retry is not None else RetryParams()
    delay = retry.backoff_s
    t0 = asyncio.get_running_loop().time()
    ring_dir: Optional[str] = None
    if hostport.startswith("ring:"):
        ring_dir = hostport[len("ring:"):]
        if tenant_key is None:
            tenant_key = message
    for attempt in range(max(1, retry.attempts)):
        _MET_ATTEMPTS.inc()
        if attempt:
            await asyncio.sleep(delay)
            delay = min(delay * 2, retry.backoff_cap_s)
        target_hostport = hostport
        if ring_dir is not None:
            from .procs import resolve_owner
            owner = resolve_owner(ring_dir, tenant_key)
            if owner is None:
                logger.info("attempt %d: no ring published yet; backing "
                            "off", attempt + 1)
                continue
            _rid, target_hostport = owner
        try:
            client = await new_async_client(target_hostport, params)
        except LspError as exc:
            logger.info("attempt %d: connect failed (%s); will retry",
                        attempt + 1, exc)
            continue
        try:
            client.write(
                new_request(message, 0, max_nonce, target).to_json())
            if retry.timeout_s > 0:
                payload = await asyncio.wait_for(client.read(),
                                                 retry.timeout_s)
            else:
                payload = await client.read()
        except (LspError, asyncio.TimeoutError) as exc:
            logger.info("attempt %d: no Result (%r); will retry",
                        attempt + 1, exc)
            continue
        finally:
            # Closed on every exit, cancellation included. LSP has no
            # close handshake: the scheduler learns of the death from its
            # epoch timer, so a resubmission arriving sooner queues behind
            # the abandoned request (latency, never a doubled answer).
            await client.close()
        try:
            msg = Message.from_json(payload)
        except ValueError:
            continue
        if msg.type != MsgType.RESULT:
            continue
        _MET_OUTCOME["ok"].inc()
        _MET_RESULT_S.observe(asyncio.get_running_loop().time() - t0)
        return msg.hash, msg.nonce, bool(target) and msg.hash < target
    _MET_OUTCOME["exhausted"].inc()
    return None


def printable_result(result: Optional[Tuple[int, int]]) -> str:
    """Exact stdout contract of the reference (client.go:61-68)."""
    if result is None:
        return "Disconnected"
    return f"Result {result[0]} {result[1]}"


def parse_u64(arg: str) -> Optional[int]:
    """Go's strconv.ParseUint(s, 10, 64) in the reference client: ASCII
    decimal digits only (bare int() would also take '+5', ' 5 ', '1_0'
    and Unicode digits), bounded to uint64, the same diagnostic on
    failure (then None)."""
    if arg.isascii() and arg.isdigit() and int(arg) < (1 << 64):
        return int(arg)
    print(f"{arg} is not a number.")
    return None


def main(argv=None) -> int:
    """CLI contract of the reference binary (ref: client.go:24-58):
    ``client <hostport> <message> <maxNonce>``, with an optional trailing
    ``[target]`` selecting difficulty mode (:func:`submit_until`; the
    stdout contract is unchanged). Target 0 means no target, the same as
    leaving it out."""
    import sys
    argv = sys.argv if argv is None else argv
    if len(argv) not in (4, 5):
        print(f"Usage: ./{argv[0]} <hostport> <message> <maxNonce>", end="")
        return 1
    max_nonce = parse_u64(argv[3])
    if max_nonce is None:
        return 1
    target = 0
    if len(argv) == 5:
        target = parse_u64(argv[4])
        if target is None:
            return 1
    # The retry plane is an explicit opt-in (it changes the reference's
    # contract: a dead connection is resubmitted, and a failed connect
    # prints "Disconnected"); a ring target resolves its owner per
    # attempt, so it always goes through it.
    want_retry = int_env("DBMT_RETRY_ATTEMPTS", 0) > 1 \
        or argv[1].startswith("ring:")
    params = lsp_params_from_env()
    try:
        if want_retry:
            result = asyncio.run(submit_with_retry(
                argv[1], argv[2], max_nonce, target, params,
                retry_from_env()))
        else:
            result = asyncio.run(submit_until(argv[1], argv[2], max_nonce,
                                              target, params))
    except LspError as exc:
        print("Failed to connect to server:", exc)
        return 1
    print(printable_result(None if result is None else result[:2]))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
