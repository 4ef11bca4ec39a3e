"""The GPU miner worker: an LSP client wrapped around the device search.

Counterpart of the JAX package's ``apps/miner.py::MinerWorker`` (the
reference worker's loop, ref: bitcoin/miner/miner.go): Join, then serve
Requests — read, search, write the Result — and exit silently on
transport errors like the reference (miner.go:40-44, 63-66). A Request
carrying a difficulty ``Target`` runs the early-exiting
``NonceSearcher.search_until`` and echoes the target.

Two loops:

- the pipelined executor (default): a reader task lands Requests in a
  bounded queue; the loop starts chunk k+1's launches (``dispatch``, on a
  worker thread) BEFORE forcing chunk k's result (``finalize``, on
  another), and writes Results strictly in request order. With
  coalescing on, consecutive small argmin chunks already queued (up to
  ``coalesce_lanes``, each at most ``coalesce_max`` nonces) are drained
  into ONE batched launch (``dispatch_batch``, the segment-min kernel)
  and ONE fetch (``finalize_batch``), their Results written in drain
  order. Difficulty chunks, empty ranges and searchers without the
  two-phase API run blocking, in order;
- the serial loop (``pipeline=False``): one blocking search per Request.

Compute runs in worker threads so the asyncio loop keeps serving LSP
heartbeats and acks while the card is busy.

Bound parity: the received ``Upper`` is treated as INCLUSIVE even though the
scheduler computed it as an exclusive end — the reference miner does the same
(miner.go:51-52), so each chunk scans one extra nonce.

A search that fails (a kernel that does not build or launch, a device
error) ends the miner: the scheduler sees the connection die and gives
the chunk to another miner. It never answers from another device or
through another kernel.

The JOIN may carry a rate hint (nonces/s) that warms the scheduler's
view of this miner before its first answer (``DBMT_RATE_HINT``: unset or
0 sends none, a number sends it, ``probe`` measures it with
:func:`measure_rate_hint` on the miner's own searcher and device; a probe
that raises ends the miner before it joins). The probe's 2^17 nonces
(the JAX package's size) are too few to fill a large card: there the
hint is a launch-bound figure, many times below the steady rate, and a
cold pool seeded from it estimates requests that much longer, so more
of them are chunked by the QoS plane instead of dispatched wholesale.

Usage: ``python -m distributed_bitcoinminer_tpu_torch.apps.miner
<host:port> [--device cuda|cpu]`` (default ``cuda``; ``DBMT_COALESCE=0``
turns coalescing off). On a box with more than one card, or with
``DBMT_MESH_DEVICES`` naming at least two devices, the miner searches over
that mesh (``MeshNonceSearcher``), which then takes the place of
``--device``.
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
from ..utils._env import str_env
from ..utils.config import (CoalesceParams, PeelParams, coalesce_from_env,
                            mesh_from_env, peel_from_env)

logger = logging.getLogger("dbmt.miner")


def default_searcher_factory(data: str, device="cuda",
                             body: PeelParams = PeelParams(),
                             mesh: tuple = ()):
    """The port's searcher for ``data`` with the lane body ``body``
    (``DBMT_PEEL``, ``DBMT_HOIST``): a :class:`MeshNonceSearcher` over
    ``mesh`` when it names at least two devices (``DBMT_MESH_DEVICES``,
    :func:`~..utils.config.mesh_from_env`), else a :class:`NonceSearcher`
    on ``device``."""
    from ..models import MeshNonceSearcher, NonceSearcher
    if len(mesh) >= 2:
        return MeshNonceSearcher(data, devices=mesh, peel=body.peel,
                                 hoist=body.hoist)
    return NonceSearcher(data, device=device, peel=body.peel,
                         hoist=body.hoist)


class MinerWorker:
    """One miner process: joins the scheduler and serves search requests.

    ``pipeline`` selects the overlapped executor (default) over the serial
    loop, ``pipeline_depth`` bounds its Request queue; ``coalesce``,
    ``coalesce_lanes`` and ``coalesce_max`` set the drain into batched
    launches (defaults: the JAX package's, ``CoalesceParams``);
    ``rate_hint`` (nonces/s, 0 = none) rides the JOIN.
    """

    # Searchers kept per message string; LRU-bounded so a stream of distinct
    # messages can't grow midstate caches without bound.
    SEARCHER_CACHE_SIZE = 4

    def __init__(self, hostport: str, params: Optional[Params] = None,
                 searcher_factory: Callable = default_searcher_factory,
                 pipeline: bool = True, pipeline_depth: int = 8,
                 coalesce: bool = True,
                 coalesce_lanes: int = CoalesceParams.lanes,
                 coalesce_max: int = CoalesceParams.max_nonces,
                 rate_hint: float = 0.0):
        self.hostport = hostport
        self.rate_hint = rate_hint
        self.params = params
        self.searcher_factory = searcher_factory
        self._searchers: OrderedDict[str, object] = OrderedDict()
        self.client: Optional[AsyncClient] = None
        self.jobs_done = 0
        self.pipeline = pipeline
        self.pipeline_depth = max(1, pipeline_depth)
        self.coalesce = coalesce and coalesce_max > 0
        self.coalesce_lanes = max(2, coalesce_lanes)
        self.coalesce_max = coalesce_max
        self.coalesced_dispatches = 0
        self.coalesced_chunks = 0

    async def join(self) -> None:
        """Connect and send Join (ref: miner.go:24-34), with the rate hint
        when there is one (a hint-less Join keeps the reference's
        bytes)."""
        self.client = await new_async_client(self.hostport, self.params)
        self.client.write(new_join(rate=int(self.rate_hint)).to_json())

    async def run(self) -> None:
        """Serve Requests until the connection dies (silent exit, like
        ref)."""
        if self.client is None:
            await self.join()
        if self.pipeline:
            await self._run_pipelined()
        else:
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

    async def _run_pipelined(self) -> None:
        """The overlapped executor (see the module docstring). Each turn
        takes the next Request (without waiting while a chunk is in
        flight), drains the coalescible ones queued behind it, STARTS the
        new launches on a worker thread, then forces the in-flight chunk
        and writes its Result(s) before the new chunk can be forced, so
        Results leave in request order."""
        queue: asyncio.Queue = asyncio.Queue(maxsize=self.pipeline_depth)
        stop, idle = object(), object()
        client = self.client

        async def reader():
            while True:
                try:
                    payload = await client.read()
                except LspError:
                    await queue.put(stop)
                    return
                try:
                    msg = Message.from_json(payload)
                except ValueError:
                    continue
                if msg.type == MsgType.REQUEST:
                    await queue.put(msg)

        reader_task = asyncio.create_task(reader())
        inflight = None   # (msg or [msgs], searcher, handle, t0, dispatch_s)
        carry = None      # a drained Request that did not coalesce (or stop)
        try:
            while True:
                if carry is not None:
                    msg, carry = carry, None
                elif inflight is None:
                    msg = await queue.get()
                else:
                    try:
                        msg = queue.get_nowait()
                    except asyncio.QueueEmpty:
                        msg = idle
                if msg is stop:
                    return   # transport died; nothing can be written
                msgs = None
                if self.coalesce and msg is not idle \
                        and self._coalescible(msg):
                    msgs = [msg]
                    while len(msgs) < self.coalesce_lanes:
                        try:
                            nxt = queue.get_nowait()
                        except asyncio.QueueEmpty:
                            break
                        if nxt is stop or not self._coalescible(nxt):
                            carry = nxt
                            break
                        msgs.append(nxt)
                    if len(msgs) == 1:
                        msgs = None      # solo: the single-chunk path
                dtask = t0 = None
                if msgs is not None:
                    t0 = time.monotonic()
                    dtask = asyncio.create_task(asyncio.to_thread(
                        self._resolve_and_dispatch_batch, msgs))
                elif msg is not idle and msg.target == 0 \
                        and msg.lower <= msg.upper:
                    t0 = time.monotonic()
                    dtask = asyncio.create_task(asyncio.to_thread(
                        self._resolve_and_dispatch, msg))
                if inflight is not None:
                    fin = (self._finalize_and_reply_batch
                           if isinstance(inflight[0], list)
                           else self._finalize_and_reply)
                    if not await fin(*inflight):
                        if dtask is not None:
                            # Reap the dispatch thread quietly (it cannot
                            # be interrupted).
                            dtask.cancel()
                            dtask.add_done_callback(
                                lambda t: t.cancelled() or t.exception())
                        return
                    inflight = None
                if msg is idle:
                    continue
                if dtask is None:
                    if not await self._serve_blocking(msg):
                        return
                    continue
                try:
                    searcher, handle, dispatch_s = await dtask
                except Exception:
                    await self._exit_broken(msgs[0] if msgs else msg)
                    return
                if handle is not None:
                    inflight = (msgs or msg, searcher, handle, t0,
                                dispatch_s)
                elif msgs is not None:
                    # The searchers cannot share a launch (decided before
                    # any launch): serve the drained chunks one by one,
                    # in drain order.
                    for m in msgs:
                        if not await self._serve_two_phase(m):
                            return
                elif not await self._serve_blocking(msg):
                    return   # no two-phase API: blocking, in order
        finally:
            reader_task.cancel()

    def _coalescible(self, msg) -> bool:
        """May this Request share a batched launch? Argmin mode,
        non-empty range, at most ``coalesce_max`` nonces."""
        return (msg.target == 0 and msg.lower <= msg.upper
                and msg.upper - msg.lower + 1 <= self.coalesce_max)

    def _resolve_and_dispatch(self, msg):
        """Worker-thread half of a two-phase chunk: resolve the searcher
        and start its launches. Returns ``(searcher, handle,
        dispatch_s)``; ``handle`` is None when the searcher has no
        two-phase API."""
        t0 = time.monotonic()
        searcher = self._get_searcher(msg.data)
        if hasattr(searcher, "dispatch") and hasattr(searcher, "finalize"):
            handle = searcher.dispatch(msg.lower, msg.upper)
            return searcher, handle, time.monotonic() - t0
        return searcher, None, 0.0

    async def _finalize_and_reply(self, msg, searcher, handle, t0: float,
                                  dispatch_s: float) -> bool:
        """Force a dispatched chunk's result and write its Result; False
        ends the serve loop (transport death or broken compute)."""
        t2 = time.monotonic()
        try:
            best_hash, best_nonce = await asyncio.to_thread(
                searcher.finalize, handle, msg.lower)
        except Exception:
            await self._exit_broken(msg)
            return False
        busy_s = dispatch_s + (time.monotonic() - t2)
        return self._reply(msg, best_hash, best_nonce, 0, t0, busy_s=busy_s)

    def _resolve_and_dispatch_batch(self, msgs: list):
        """Worker-thread half of a coalesced chunk set: resolve every
        chunk's searcher and start ONE batched dispatch through the first
        one's ``dispatch_batch``. Returns ``(searcher, handle,
        dispatch_s)``; ``handle`` is None when the searchers cannot serve
        a batch (no batch API, or they cannot share a launch)."""
        t0 = time.monotonic()
        searchers = [self._get_searcher(m.data) for m in msgs]
        s0 = searchers[0]
        if hasattr(s0, "dispatch_batch") and hasattr(s0, "finalize_batch"):
            handle = s0.dispatch_batch(
                [(s, m.lower, m.upper) for s, m in zip(searchers, msgs)])
            if handle is not None:
                return s0, handle, time.monotonic() - t0
        return s0, None, 0.0

    async def _finalize_and_reply_batch(self, msgs: list, searcher, handle,
                                        t0: float, dispatch_s: float
                                        ) -> bool:
        """Force a coalesced dispatch with ONE fetch and write the
        Results in request order; False ends the serve loop."""
        t2 = time.monotonic()
        try:
            results = await asyncio.to_thread(searcher.finalize_batch,
                                              handle)
        except Exception:
            await self._exit_broken(msgs[0])
            return False
        busy_s = dispatch_s + (time.monotonic() - t2)
        return self._reply_batch(msgs, results, t0, busy_s)

    def _reply_batch(self, msgs: list, results: list, t0: float,
                     busy_s: float) -> bool:
        """Write a shared launch's Results in request order; its busy
        time is logged once for the whole launch."""
        t1 = time.monotonic()
        self.coalesced_dispatches += 1
        self.coalesced_chunks += len(msgs)
        for msg, (best_hash, best_nonce) in zip(msgs, results):
            try:
                self.client.write(
                    new_result(best_hash, best_nonce, 0).to_json())
            except LspError:
                return False
            self.jobs_done += 1
        logger.info("served %d coalesced chunks (%s) in %.3fs, busy %.3fs",
                    len(msgs), ", ".join(f"{m.data!r} [{m.lower}, "
                                         f"{m.upper}]" for m in msgs),
                    t1 - t0, busy_s)
        logger.info("miner counts %s", json.dumps(self.counts()))
        return True

    async def _serve_two_phase(self, msg) -> bool:
        """One chunk through the single-chunk two-phase path (blocking
        when the searcher has no split); used for drained chunks whose
        searchers could not share a launch."""
        t0 = time.monotonic()
        try:
            searcher, handle, dispatch_s = await asyncio.to_thread(
                self._resolve_and_dispatch, msg)
        except Exception:
            await self._exit_broken(msg)
            return False
        if handle is None:
            return await self._serve_blocking(msg)
        return await self._finalize_and_reply(msg, searcher, handle, t0,
                                              dispatch_s)

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
        """Chunks served, batched launches and the chunks they served,
        and CUDA kernel launches made by this process, by the
        TPU kernel each replaces (K1 arg-min search, K2 difficulty
        search, K3 and K4 the peeled bodies' searches, K5 the batched
        segment-min, K6 the folds of the device-resident chain)."""
        return {"chunks": self.jobs_done,
                "coalesced_dispatches": self.coalesced_dispatches,
                "coalesced_chunks": self.coalesced_chunks,
                "kernel_launches": dict(sha256_cuda.launches)}

    def _reply(self, msg, best_hash: int, best_nonce: int,
               echo_target: int, t0: float,
               busy_s: Optional[float] = None) -> bool:
        """Write the Result; False on transport death. ``busy_s`` (a
        pipelined chunk's dispatch and finalize time, without its wait
        behind the previous chunk) defaults to the wall time since
        ``t0``."""
        t1 = time.monotonic()
        try:
            self.client.write(
                new_result(best_hash, best_nonce, echo_target).to_json())
        except LspError:
            return False
        self.jobs_done += 1
        logger.info("served %r [%d, %d] in %.3fs, busy %.3fs", msg.data,
                    msg.lower, msg.upper, t1 - t0,
                    t1 - t0 if busy_s is None else busy_s)
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


def measure_rate_hint(searcher, probe_nonces: int = 1 << 17) -> float:
    """The rate-hint probe (nonces/s): one warm pass, then one timed pass
    over the adjacent window of ``probe_nonces``, both inside one aligned
    10^9 block, through ``searcher.search``. A search that raises is not
    caught: a miner joins with a measured hint or not at all."""
    base = 100_000_000
    searcher.search(base, base + probe_nonces - 1)
    t0 = time.monotonic()
    searcher.search(base + probe_nonces, base + 2 * probe_nonces - 1)
    return probe_nonces / max(time.monotonic() - t0, 1e-6)


def _resolve_rate_hint(factory) -> float:
    """``DBMT_RATE_HINT``: unset or 0 sends no hint, a number sends it,
    ``probe`` measures it with :func:`measure_rate_hint` on
    ``factory``'s searcher."""
    raw = str_env("DBMT_RATE_HINT", "0")
    if raw.strip().lower() == "probe":
        hint = measure_rate_hint(factory("dbmt rate probe"))
        sha256_cuda.reset_launches()   # the counts are of requests served
        return hint
    try:
        return max(0.0, float(raw))
    except ValueError:
        return 0.0


async def _run_miner(hostport: str, device: str,
                     body: PeelParams = PeelParams(),
                     mesh: tuple = (), rate_hint: float = 0.0) -> int:
    worker = MinerWorker(
        hostport, params=Params(),
        searcher_factory=lambda data: default_searcher_factory(
            data, device, body, mesh),
        coalesce=coalesce_from_env().enabled, rate_hint=rate_hint)
    try:
        try:
            await worker.join()
        except LspError as exc:
            print("Failed to join with server:", exc)
            return 1
        logger.info("joined %s on %s", hostport,
                    f"the mesh {','.join(mesh)}" if len(mesh) >= 2
                    else device)
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
    body = peel_from_env()
    mesh = mesh_from_env(device)
    if len(mesh) < 2:
        mesh = ()
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if any(resolve_device(d).type == "cuda" for d in mesh or (device,)):
        warm_up(device, body, mesh)
    rate_hint = _resolve_rate_hint(
        lambda data: default_searcher_factory(data, device, body, mesh))
    if rate_hint > 0:
        logger.info("rate hint %.6g nonces/s", rate_hint)
    return asyncio.run(_run_miner(args[0], device, body, mesh, rate_hint))


def warm_up(device, body: PeelParams = PeelParams(),
            mesh: tuple = ()) -> None:
    """Create the CUDA context (on every distinct device of a ``mesh`` of
    at least two entries), build (if needed) and load the kernels of the
    miner's lane body ``body``, and run both chains (arg-min and
    difficulty; over the mesh, its chains) once over the 6 blocks of
    [0, 10^5) and one batched launch before joining, so the first request
    does not pay for any of it. The launch counters restart at 0
    afterwards: they count the launches made serving requests."""
    import torch

    from ..parallel.mesh_search import distinct, make_mesh
    t0 = time.monotonic()
    devices = distinct(make_mesh(devices=mesh)) if len(mesh) >= 2 \
        else (device,)
    for d in devices:
        torch.zeros(1, device=d)
    s = default_searcher_factory("warm-up", device, body, mesh)
    s.search(0, 10 ** 5 - 1)
    s.search_until(0, 10 ** 5 - 1, 1)
    # A batch with a 1-block and a 2-block tail: both K5 search kernels.
    t = default_searcher_factory("w" * 60, device, body, mesh)
    s.finalize_batch(s.dispatch_batch([(s, 0, 999), (t, 10 ** 4, 10 ** 5)]))
    sha256_cuda.reset_launches()
    logger.info("device %s ready in %.3fs (%s; %s)",
                ",".join(str(d) for d in devices), time.monotonic() - t0,
                torch.cuda.get_device_name(devices[0]), body)


if __name__ == "__main__":
    import sys
    sys.exit(main())
