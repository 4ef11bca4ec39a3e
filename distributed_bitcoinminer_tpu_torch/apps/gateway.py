"""Scheduler federation: the GatewayMiner.

Counterpart of the JAX package's ``apps/gateway.py``. A whole cluster
joins a PARENT scheduler as ONE miner: the :class:`GatewayMiner` JOINs
with the summed rate of its inner pool as its hint and resubmits every
chunk the parent grants it to a stock INNER
:class:`~.scheduler.Scheduler` (or the replicas of one), whose child
miners (stock port miners: on a card they run the port's kernels) do the
search. A chunk is already a contiguous nonce window with exactly-once
lease semantics, so the parent sees leases, stripes, QoS, claim checks,
audits and spans as it sees any miner's, with no change on the wire::

    tenants -> parent Scheduler -> GatewayMiner (JOIN rate = pool sum)
                    |                  |   ^
                    v                  v   |  (bridge: one tenant conn)
              other miners       inner Scheduler
                                       |
                                       v
                                 child miners

- **No hashing here.** The gateway brokers messages; the inner tier's
  miners own the search.
- **Grant translation.** Each parent Request (a chunk grant, arg-min or
  difficulty) is resubmitted with the same message, range and target as
  a tenant request on ONE long-lived bridge conn into the inner tier,
  whose merge (the arg-min's strict-less rule, the difficulty prefix
  release) answers for exactly that window. A grant's upper bound is
  EXCLUSIVE but scanned inclusively by miners (the reference's quirk,
  miner.go:51-52), while a tenant's upper is scanned one past: the bridge
  request carries ``upper - 1`` so the inner tier scans exactly the
  granted set.
- **In-order forwarding.** The inner tier answers one tenant conn in
  request order, and the bridge requests go out in grant order, so each
  bridge reply answers the oldest pending grant and goes up as the k-th
  Result for the k-th grant. If the bridge dies, the gateway reconnects
  and resubmits every unanswered grant in order (the inner result cache
  replays finished windows).
- **Difficulty echo.** The forwarded Result echoes the grant's target, as
  a stock miner's does after an until search.
- **Liveness.** The gateway joins once ``min_pool`` inner miners exist,
  re-sends its JOIN with the pool's new sum at most every ``hint_s`` when
  the sum moved by a tenth (the parent refreshes its roster entry in
  place under ``DBMT_GATEWAY``), and its orphan watchdog drops the parent
  conn when the inner pool has been empty for ``orphan_s`` with grants
  pending: the parent sees one dropped miner and re-issues its chunks.

Usage: ``python -m distributed_bitcoinminer_tpu_torch.apps.gateway
<parent host:port> [inner_port]``; it prints ``Gateway inner tier
listening on port N``, child miners join that port as they would a
plain server, and it logs to ``log.txt`` in its working directory. Under
``DBMT_GATEWAY=0`` it refuses to start.
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from typing import Awaitable, Callable, Deque, Optional

from ..bitcoin.message import (Message, MsgType, new_join, new_request,
                               new_result)
from ..lsp.params import Params
from ..utils.config import GatewayParams, gateway_from_env
from .miner_plane import MinerPlane

logger = logging.getLogger("dbmt.gateway")

__all__ = ["GatewayMiner", "aggregate_rate_hint", "serve", "main"]


def aggregate_rate_hint(scheds) -> float:
    """The inner pool's rate hint (nonces/s): the rate EWMAs of every
    miner of ``scheds`` that is not quarantined (hinted ones count; cold
    ones, with no EWMA yet, add 0, so a wholly cold pool sends no hint),
    clamped to ``MinerPlane.RATE_HINT_CAP`` as the parent clamps it."""
    total = 0.0
    for sched in scheds:
        for m in sched.miner_plane.miners:
            if not m.quarantined:
                total += m.rate_ewma or 0.0
    return min(total, MinerPlane.RATE_HINT_CAP)


class GatewayMiner:
    """One federated miner: the parent-facing conn and the inner-tier
    bridge.

    ``parent_connect`` and ``bridge_connect`` are async callables that
    return an ``AsyncClient``-shaped channel (async ``read()``, ``write``,
    async ``close()``); ``inner_scheds`` are the inner schedulers whose
    pool the gateway advertises. :meth:`run` is one parent-conn lifetime
    (it returns when the parent conn dies or the orphan watchdog fires,
    and closes the bridge, so the inner tier cancels the gateway's
    requests); :meth:`run_forever` rejoins after each.
    """

    def __init__(self, parent_connect: Callable[[], Awaitable],
                 bridge_connect: Callable[[], Awaitable],
                 inner_scheds, *,
                 params: Optional[GatewayParams] = None,
                 poll_s: float = 0.05, backoff_s: float = 0.5,
                 name: str = "gateway"):
        self.parent_connect = parent_connect
        self.bridge_connect = bridge_connect
        self.inner_scheds = list(inner_scheds)
        self.params = params if params is not None else gateway_from_env()
        self.poll_s = poll_s
        self.backoff_s = backoff_s
        self.name = name
        self._pending: Deque[Message] = deque()   # grants, oldest first
        self._parent = None
        self._bridge = None
        self._last_hint = 0.0
        self.grants_taken = 0
        self.results_forwarded = 0
        self.hint_refreshes = 0
        self.orphan_drops = 0

    def pool_size(self) -> int:
        """Inner miners that can take grants (not quarantined)."""
        return sum(1 for sched in self.inner_scheds
                   for m in sched.miner_plane.miners if not m.quarantined)

    def rate_hint(self) -> float:
        return aggregate_rate_hint(self.inner_scheds)

    async def run(self) -> None:
        """One parent-conn lifetime (the class docstring)."""
        while self.pool_size() < self.params.min_pool:
            await asyncio.sleep(self.poll_s)
        self._pending.clear()
        self._parent = await self.parent_connect()
        tasks = []
        try:
            self._bridge = await self.bridge_connect()
            self._last_hint = self.rate_hint()
            self._parent.write(
                new_join(rate=int(self._last_hint)).to_json())
            logger.info("%s joined the parent as one miner (pool %d, hint "
                        "%.6g nonces/s)", self.name, self.pool_size(),
                        self._last_hint)
            tasks = [asyncio.ensure_future(c) for c in (
                self._parent_loop(), self._bridge_loop(),
                self._hint_loop(), self._orphan_loop())]
            done, _ = await asyncio.wait(
                tasks, return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                exc = t.exception()
                if exc is not None:
                    # A dead parent or bridge: tearing the conns down is
                    # the recovery (the parent re-issues the chunks).
                    logger.info("%s conn ended: %r", self.name, exc)
        finally:
            for t in tasks:
                t.cancel()
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            await self._close_all()

    async def run_forever(self) -> None:
        """Rejoin after every parent death or orphan drop, ``backoff_s``
        later, as a new miner conn."""
        while True:
            try:
                await self.run()
            except asyncio.CancelledError:
                raise
            except Exception:   # noqa: BLE001 — the rejoin loop survives
                logger.exception("%s run() failed; rejoining", self.name)
            await asyncio.sleep(self.backoff_s)

    async def _close_all(self) -> None:
        # The bridge first: its close cancels the gateway's requests in
        # the inner tier.
        for chan in (self._bridge, self._parent):
            if chan is None:
                continue
            try:
                await chan.close()
            except Exception:  # noqa: BLE001 — already dead
                pass
        self._bridge = None
        self._parent = None
        self._pending.clear()

    def _submit(self, grant: Message) -> None:
        # The bound translation of the module docstring (a one-nonce
        # grant, upper == lower, stays at lower: the inner tier then scans
        # one extra nonce).
        self._bridge.write(new_request(
            grant.data, grant.lower, max(grant.lower, grant.upper - 1),
            grant.target).to_json())

    async def _parent_loop(self) -> None:
        """Parent grants -> the pending FIFO -> inner-tier requests."""
        while True:
            payload = await self._parent.read()
            try:
                msg = Message.from_json(payload)
            except ValueError:
                continue
            if msg.type != MsgType.REQUEST:
                continue
            self._pending.append(msg)
            self.grants_taken += 1
            try:
                self._submit(msg)
            except Exception:  # noqa: BLE001 — the bridge is dying
                # Left pending: the bridge loop's failed read reconnects
                # and resubmits the FIFO.
                pass

    async def _bridge_loop(self) -> None:
        """Inner Results -> the oldest pending grant -> the parent."""
        while True:
            try:
                payload = await self._bridge.read()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — shed, closed or dead
                await self._bridge_reconnect()
                continue
            try:
                msg = Message.from_json(payload)
            except ValueError:
                continue
            if msg.type != MsgType.RESULT or not self._pending:
                continue
            grant = self._pending.popleft()
            self._parent.write(new_result(msg.hash, msg.nonce,
                                          grant.target).to_json())
            self.results_forwarded += 1

    async def _bridge_reconnect(self) -> None:
        """A new bridge conn, then every unanswered grant resubmitted in
        order: the old conn's requests died with it in the inner tier, and
        the new conn's FIFO restarts the k-th-reply-answers-k-th-grant
        order."""
        old, self._bridge = self._bridge, None
        if old is not None:
            try:
                await old.close()
            except Exception:  # noqa: BLE001 — already dead
                pass
        while True:
            try:
                self._bridge = await self.bridge_connect()
                break
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the inner tier restarts
                await asyncio.sleep(self.backoff_s)
        if self._pending:
            logger.info("%s bridge reconnected; resubmitting %d "
                        "unanswered grant(s) in order", self.name,
                        len(self._pending))
        for grant in self._pending:
            try:
                self._submit(grant)
            except Exception:  # noqa: BLE001 — died again already
                break   # the next failed read reconnects once more

    async def _hint_loop(self) -> None:
        """Every ``hint_s``: a repeat JOIN with the pool's sum when it
        moved by at least a tenth (or between zero and not zero)."""
        while True:
            await asyncio.sleep(self.params.hint_s)
            hint, last = self.rate_hint(), self._last_hint
            moved = ((hint <= 0) != (last <= 0)
                     or (last > 0 and abs(hint - last) / last >= 0.10))
            if not moved:
                continue
            self._last_hint = hint
            self._parent.write(new_join(rate=int(hint)).to_json())
            self.hint_refreshes += 1
            logger.info("%s refreshed its hint: %.6g nonces/s", self.name,
                        hint)

    async def _orphan_loop(self) -> None:
        """The orphan watchdog: an EMPTY inner pool holding pending grants
        for ``orphan_s`` ends :meth:`run`; the parent sees a dropped miner
        and re-grants its chunks at once rather than at lease expiry."""
        loop = asyncio.get_running_loop()
        empty_since: Optional[float] = None
        while True:
            await asyncio.sleep(self.poll_s)
            if self.pool_size() > 0 or not self._pending:
                empty_since = None
                continue
            now = loop.time()
            if empty_since is None:
                empty_since = now
            elif now - empty_since >= self.params.orphan_s:
                self.orphan_drops += 1
                logger.warning(
                    "%s: inner pool empty for %.1fs with %d grant(s) "
                    "pending; dropping the parent conn", self.name,
                    now - empty_since, len(self._pending))
                return


async def serve(parent_hostport: str, inner_port: int = 0,
                params: Optional[Params] = None,
                gateway: Optional[GatewayParams] = None) -> None:
    """An inner LSP server, a scheduler with the environment's settings,
    and one :class:`GatewayMiner` bridging to it over localhost. Raises
    under ``DBMT_GATEWAY=0``."""
    from ..lsp.client import new_async_client
    from ..lsp.server import new_async_server
    from .scheduler import Scheduler

    gw_params = gateway if gateway is not None else gateway_from_env()
    if not gw_params.enabled:
        raise RuntimeError("DBMT_GATEWAY=0: the gateway role is disabled "
                           "(the flat topology)")
    lsp = params or Params()
    server = await new_async_server(inner_port, lsp)
    print("Gateway inner tier listening on port", server.port, flush=True)
    sched = Scheduler(server)
    inner_hostport = f"127.0.0.1:{server.port}"
    gw = GatewayMiner(
        parent_connect=lambda: new_async_client(parent_hostport, lsp),
        bridge_connect=lambda: new_async_client(inner_hostport, lsp),
        inner_scheds=[sched], params=gw_params)
    try:
        await asyncio.gather(sched.run(), gw.run_forever())
    finally:
        await server.close()


def main(argv: Optional[list] = None) -> int:
    import sys

    from ..utils.config import lsp_params_from_env
    from ..utils.logging import configure_logging
    from ..utils.metrics import ensure_emitter
    argv = sys.argv if argv is None else argv
    if len(argv) not in (2, 3):
        print(f"Usage: ./{argv[0]} <parent_hostport> [inner_port]")
        return 1
    inner_port = 0
    if len(argv) == 3:
        try:
            inner_port = int(argv[2])
        except ValueError as exc:
            print("Inner port must be a number:", exc)
            return 1
    configure_logging(logging.INFO, logfile="log.txt")
    ensure_emitter()
    try:
        asyncio.run(serve(argv[1], inner_port, lsp_params_from_env()))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
