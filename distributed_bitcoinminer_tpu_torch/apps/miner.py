"""The GPU miner worker: an LSP client wrapped around the device search.

Counterpart of the serial path of the JAX package's
``apps/miner.py::MinerWorker`` (the reference worker's loop, ref:
bitcoin/miner/miner.go): Join, then serve Requests one at a time — read, search, write
the Result — and exit silently on transport errors like the reference
(miner.go:40-44, 63-66). A Request carrying a difficulty ``Target`` runs
the early-exiting ``NonceSearcher.search_until`` and echoes the target.

The search runs in a worker thread so the asyncio loop keeps serving LSP
heartbeats and acks while the card is busy.

Bound parity: the received ``Upper`` is treated as INCLUSIVE even though the
scheduler computed it as an exclusive end — the reference miner does the same
(miner.go:51-52), so each chunk scans one extra nonce.

A search that fails (a kernel that does not build or launch, a device
error) ends the miner: the scheduler sees the connection die and gives
the chunk to another miner. It never answers from another device.

Usage: ``python -m distributed_bitcoinminer_tpu_torch.apps.miner
<host:port> [--device cuda|cpu]`` (default ``cuda``).
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from collections import OrderedDict
from typing import Callable, Optional

from ..bitcoin.hash import MAX_U64
from ..bitcoin.message import Message, MsgType, new_join, new_result
from ..lsp.client import AsyncClient, new_async_client
from ..lsp.errors import LspError
from ..lsp.params import Params
from ..ops import sha256_cuda

logger = logging.getLogger("dbmt.miner")


def default_searcher_factory(data: str, device="cuda"):
    """The port's :class:`NonceSearcher` for ``data`` on ``device``."""
    from ..models import NonceSearcher
    return NonceSearcher(data, device=device)


class MinerWorker:
    """One miner process: joins the scheduler and serves search requests."""

    # Searchers kept per message string; LRU-bounded so a stream of distinct
    # messages can't grow midstate caches without bound.
    SEARCHER_CACHE_SIZE = 4

    def __init__(self, hostport: str, params: Optional[Params] = None,
                 searcher_factory: Callable = default_searcher_factory):
        self.hostport = hostport
        self.params = params
        self.searcher_factory = searcher_factory
        self._searchers: OrderedDict[str, object] = OrderedDict()
        self.client: Optional[AsyncClient] = None
        self.jobs_done = 0

    async def join(self) -> None:
        """Connect and send Join (ref: miner.go:24-34)."""
        self.client = await new_async_client(self.hostport, self.params)
        self.client.write(new_join().to_json())

    async def run(self) -> None:
        """Serve Requests until the connection dies (silent exit, like
        ref)."""
        if self.client is None:
            await self.join()
        await self._run_serial()

    async def _run_serial(self) -> None:
        """The stock loop: read Request -> blocking search -> write
        Result."""
        while True:
            try:
                payload = await self.client.read()
            except LspError:
                return
            try:
                msg = Message.from_json(payload)
            except ValueError:
                continue
            if msg.type != MsgType.REQUEST:
                continue
            if not await self._serve_blocking(msg):
                return

    async def _serve_blocking(self, msg) -> bool:
        """One chunk through the blocking search; False ends the serve
        loop."""
        t0 = time.monotonic()
        try:
            best_hash, best_nonce, echo_target = await asyncio.to_thread(
                self._search, msg.data, msg.lower, msg.upper, msg.target)
        except Exception:
            # A broken worker must LEAVE the pool — exit so the
            # scheduler declares the connection lost and reassigns
            # this exact chunk (ref: the Go miner exits silently on
            # any failure, miner.go:44-50).
            await self._exit_broken(msg)
            return False
        return self._reply(msg, best_hash, best_nonce, echo_target, t0)

    async def _exit_broken(self, msg) -> None:
        """Compute-failure exit path (must be called from an except
        block: it logs the active exception)."""
        logger.exception("search failed for %r [%d, %d]; exiting",
                         msg.data, msg.lower, msg.upper)
        await self.client.close()

    def counts(self) -> dict:
        """Chunks served and CUDA kernel launches made by this process, by
        the TPU kernel each replaces (K1 arg-min search, K2 difficulty
        search, K6 the folds of the device-resident chain)."""
        return {"chunks": self.jobs_done,
                "kernel_launches": dict(sha256_cuda.launches)}

    def _reply(self, msg, best_hash: int, best_nonce: int,
               echo_target: int, t0: float) -> bool:
        """Write the Result; False on transport death."""
        try:
            self.client.write(
                new_result(best_hash, best_nonce, echo_target).to_json())
        except LspError:
            return False
        self.jobs_done += 1
        logger.info("served %r [%d, %d] in %.3fs", msg.data, msg.lower,
                    msg.upper, time.monotonic() - t0)
        logger.info("miner counts %s", json.dumps(self.counts()))
        return True

    def _get_searcher(self, data: str):
        """Per-message searcher from the LRU cache (builds on miss)."""
        searcher = self._searchers.get(data)
        if searcher is None:
            searcher = self.searcher_factory(data)
            self._searchers[data] = searcher
            while len(self._searchers) > self.SEARCHER_CACHE_SIZE:
                self._searchers.popitem(last=False)
        else:
            self._searchers.move_to_end(data)
        return searcher

    def _search(self, data: str, lower: int, upper: int,
                target: int = 0) -> tuple[int, int, int]:
        """(hash, nonce, echo_target). A Request with a target runs the
        early-exiting ``search_until`` and echoes the target: the Result
        then reports the chunk's FIRST qualifying nonce, or its exact
        arg-min when none qualifies. A searcher without ``search_until``
        answers with the full-scan arg-min and echoes 0, exactly like a
        stock Go miner that dropped the unknown Target key; the scheduler
        reads the echo to grade its merge."""
        if lower > upper:
            # The Go miner's loop body never runs for an inverted range and
            # it reports (maxUint, 0) (ref: miner.go:46-59).
            return (MAX_U64, 0, 0)
        searcher = self._get_searcher(data)
        if target:
            until = getattr(searcher, "search_until", None)
            if until is not None:
                best_hash, best_nonce, _found = until(lower, upper, target)
                return best_hash, best_nonce, target
        return (*searcher.search(lower, upper), 0)

    async def close(self) -> None:
        if self.client is not None:
            await self.client.close()


async def _run_miner(hostport: str, device: str) -> int:
    worker = MinerWorker(
        hostport, params=Params(),
        searcher_factory=lambda data: default_searcher_factory(data, device))
    try:
        try:
            await worker.join()
        except LspError as exc:
            print("Failed to join with server:", exc)
            return 1
        logger.info("joined %s on %s", hostport, device)
        await worker.run()
        return 0
    finally:
        await worker.close()


def main(argv=None) -> int:
    """CLI contract of the reference binary (ref: miner.go:70-77):
    ``miner <hostport>``, plus ``--device cuda|cpu``; exits silently when
    the connection dies. Asking for ``cuda`` where there is none raises
    before joining."""
    import sys

    from ..models.miner_model import resolve_device
    argv = sys.argv if argv is None else argv
    args, device = list(argv[1:]), "cuda"
    if len(args) == 3 and args[1] == "--device":
        device = args.pop(2)
        args.pop(1)
    if len(args) != 1:
        print(f"Usage: ./{argv[0]} <hostport> [--device cuda|cpu]", end="")
        return 1
    device = resolve_device(device)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if device.type == "cuda":
        warm_up(device)
    return asyncio.run(_run_miner(args[0], device))


def warm_up(device) -> None:
    """Create the CUDA context, build (if needed) and load the kernels, and
    run both chains (arg-min and difficulty) once over the 6 blocks of
    [0, 10^5) before joining, so the first request does not pay for any
    of it. The launch counters restart at 0 afterwards: they count the
    launches made serving requests."""
    import torch

    from ..models import NonceSearcher
    t0 = time.monotonic()
    torch.zeros(1, device=device)
    s = NonceSearcher("warm-up", device=device)
    s.search(0, 10 ** 5 - 1)
    s.search_until(0, 10 ** 5 - 1, 1)
    sha256_cuda.reset_launches()
    logger.info("device %s ready in %.3fs (%s)", device,
                time.monotonic() - t0, torch.cuda.get_device_name(device))


if __name__ == "__main__":
    import sys
    sys.exit(main())
