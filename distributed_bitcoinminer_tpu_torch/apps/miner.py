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
heartbeats and acks while the card is busy (``DBMT_SANITIZE=1`` warns
when a searcher is resolved, launched or run on the loop's thread).

Tracing (``DBMT_TRACE``, default on): each served chunk's SPAN rides its
Result (the ``Span`` wire extension): ``queue_s`` (the Request's wait in
the reader's queue), ``dispatch_s`` (resolving the searcher and starting
its launches), ``wait_s`` (from the launches' start returning to the
force), ``force_s`` (the fetch and host merge), ``gap_s`` (the
executor's idle time since the previous chunk), ``subs`` (the chain's
launches, one a block), ``compiles`` (fresh launch signatures met in the
dispatch) and, for a coalesced window, the shared launch's id
(``launch``) and its ``lanes``; a blocking chunk's whole search is one
``force_s`` with ``serial``. With ``DBMT_TRACE=0`` every Result's bytes
are the stock ones.

Metrics (the process registry, the JAX package's families): the
``miner.chunk_seconds`` histogram of each chunk's busy time (a pipelined
chunk's dispatch and finalize, without its wait behind the previous
chunk; a coalesced window's once for the shared launch),
``miner.nonces_scanned`` and ``miner.chunks_served`` as each Result is
written, ``miner.search_failures`` before a broken miner exits,
``miner.dispatch_queue_depth`` (the Requests left queued at each pickup),
``miner.chunks_two_phase`` (chunks served through ``dispatch`` and
``finalize``), ``miner.coalesced_dispatches``, ``miner.chunks_coalesced``
and the ``miner.coalesce_width`` histogram of the batched launches, and
the ``miner.nonces_per_s`` EWMA over the union of the chunks' busy
intervals (:class:`_ThroughputWindow`) with the pipeline's occupancy and
overlap.

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
<host:port> [--device cuda|cpu]`` (default ``cuda``; ``DBMT_COMPUTE=host``
runs the host tier, :class:`HostSearcher`, instead; ``DBMT_COALESCE=0``
turns coalescing off, ``DBMT_COALESCE_LANES`` and ``DBMT_COALESCE_MAX``
size it, ``DBMT_PIPELINE_DEPTH`` bounds the Request queue, and the LSP
``Params`` come from ``DBMT_EPOCH_LIMIT``, ``DBMT_EPOCH_MILLIS``,
``DBMT_WINDOW`` and ``DBMT_MAX_BACKOFF``). On a box with more than one
card, or with ``DBMT_MESH_DEVICES`` naming at least two devices, the
miner searches over that mesh (``MeshNonceSearcher``), which then takes
the place of ``--device``.

Pods (``parallel.multihost``): with ``DBMT_COORDINATOR`` (rank 0's
``host:port``), ``DBMT_NUM_PROCS`` and ``DBMT_PROC_ID`` set, each of
several miner processes is one rank of ONE miner. Every rank searches
its local mesh (``DBMT_MESH_DEVICES``, else every visible card, else
``--device``) as its part of the pod's global mesh; rank 0 alone joins
the scheduler and serves through ``PodSearcher``, and the other ranks
never touch LSP (:func:`run_pod_rank`). ``DBMT_POD_TIMEOUT_S`` bounds one
pod job and ``DBMT_POD_IDLE_TIMEOUT_S`` a follower's wait between jobs;
past either, or when a collective fails because a peer died, the rank
exits with code 17.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import time
from collections import OrderedDict
from typing import Callable, Optional

from ..bitcoin.hash import MAX_U64
from ..bitcoin.message import Message, MsgType, new_join, new_result
from ..lsp.client import AsyncClient, new_async_client
from ..lsp.errors import LspError
from ..lsp.params import Params
from ..ops import sha256_cuda
from ..parallel import multihost
from ..utils import sanitize as _sanitize
from ..utils import trace as _trace
from ..utils._env import str_env
from ..utils.config import (CoalesceParams, PeelParams, PodParams,
                            coalesce_from_env, compute_from_env,
                            lsp_params_from_env,
                            mesh_from_env, peel_from_env,
                            pipeline_depth_from_env, pod_from_env)
from ..utils.metrics import (OCCUPANCY_BUCKETS, ensure_emitter,
                             registry as _registry)

logger = logging.getLogger("dbmt.miner")

# The miner's process metrics (module docstring).
_M = _registry()
_MET_CHUNK_S = _M.histogram("miner.chunk_seconds")
_MET_NONCES = _M.counter("miner.nonces_scanned")
_MET_CHUNKS = _M.counter("miner.chunks_served")
_MET_RATE = _M.ewma("miner.nonces_per_s", tau_s=30.0)
_MET_FAILURES = _M.counter("miner.search_failures")
_MET_QDEPTH = _M.histogram("miner.dispatch_queue_depth", OCCUPANCY_BUCKETS)
_MET_OCCUPANCY = _M.gauge("miner.pipeline_occupancy")
_MET_OVERLAP = _M.gauge("miner.pipeline_overlap_ratio")
_MET_TWO_PHASE = _M.counter("miner.chunks_two_phase")
_MET_COAL_DISPATCHES = _M.counter("miner.coalesced_dispatches")
_MET_COAL_CHUNKS = _M.counter("miner.chunks_coalesced")
_MET_COAL_WIDTH = _M.histogram("miner.coalesce_width", OCCUPANCY_BUCKETS)
# The launch observer's count of fresh signatures (utils/trace.py), read
# around each dispatch so a span reports the ones it met.
_MET_FRESH = _M.counter("trace.fresh_launches")


class _ThroughputWindow:
    """Windowed nonces/s over the UNION of the chunks' busy intervals
    ``[t0, t1]`` (completions arrive in FIFO order with nondecreasing
    ``t0``, so the union is one frontier sweep): under the pipeline,
    chunk k+1's interval overlaps chunk k's, and per-chunk rates would
    sum to more than the wall clock delivered. One sample of ``nonces /
    busy`` is observed each ``min_window_s`` of busy time. Difficulty
    chunks are left out (their early exit scans an unknown share)."""

    def __init__(self, ewma=_MET_RATE, min_window_s: float = 0.5):
        self._ewma = ewma
        self._min_window_s = min_window_s
        self._born: Optional[float] = None   # first chunk's t0
        self._frontier = 0.0                 # union sweep frontier
        self._busy_s = 0.0                   # lifetime union of intervals
        self._sum_s = 0.0                    # lifetime sum of durations
        self._win_busy = 0.0
        self._win_nonces = 0

    def observe(self, t0: float, t1: float, scanned: int) -> None:
        if self._born is None:
            self._born = t0
            self._frontier = t0
        busy = max(0.0, t1 - max(t0, self._frontier))
        self._frontier = max(self._frontier, t1)
        self._busy_s += busy
        self._sum_s += max(0.0, t1 - t0)
        if self._sum_s > 0.0:
            _MET_OVERLAP.set(1.0 - self._busy_s / self._sum_s)
        _MET_OCCUPANCY.set(
            self._busy_s / max(time.monotonic() - self._born, 1e-9))
        self._win_busy += busy
        self._win_nonces += scanned
        if self._win_busy >= self._min_window_s:
            self._ewma.observe(self._win_nonces / self._win_busy)
            self._win_busy, self._win_nonces = 0.0, 0


class HostSearcher:
    """The host compute tier: the native C++ scan of
    ``ops.sha256_native`` (SHA-NI where the CPU has it, every core for
    large ranges), for miners without a card. Asked for only explicitly
    (``DBMT_COMPUTE=host``); where ``g++`` is missing every search raises,
    as a kernel that does not build does (the JAX package's answers from
    its pure-Python oracle there). ``threads``: 0 every core for large
    ranges, 1 one, N that many.

    It has the device searchers' two-phase shape: ``dispatch`` starts the
    scan on a worker thread of its own and returns, ``finalize`` joins
    it, so the pipelined miner overlaps chunk k+1's scan with chunk k's
    reply; ``dispatch_batch``/``finalize_batch`` serve a coalesced window
    the same way, one scan per entry."""

    def __init__(self, data: str, threads: int = 0):
        self.data = data
        self.threads = threads
        self._pool = None

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            # Two workers: one scan finishing while the next starts.
            self._pool = ThreadPoolExecutor(max_workers=2,
                                            thread_name_prefix="host-scan")
        return self._pool

    def search(self, lower: int, upper: int):
        from ..ops.sha256_native import scan_min_native
        return scan_min_native(self.data, lower, upper,
                               threads=self.threads)

    def search_until(self, lower: int, upper: int, target: int):
        from ..ops.sha256_native import scan_until_native
        return scan_until_native(self.data, lower, upper, target,
                                 threads=self.threads)

    def dispatch(self, lower: int, upper: int):
        """Start the scan; returns a handle for :meth:`finalize`."""
        if lower > upper:
            raise ValueError("empty range")
        return self._executor().submit(self.search, lower, upper)

    def finalize(self, handle, lower: int):
        """Join a dispatched scan: the exact ``(min_hash, argmin_nonce)``."""
        return handle.result()

    def dispatch_batch(self, entries: list):
        """Start every entry's scan (``(searcher, lower, upper)``, each
        searcher a HostSearcher) on its searcher's workers; None when an
        entry's searcher is of another tier."""
        if not all(isinstance(s, HostSearcher) for s, _lo, _up in entries):
            return None
        return [s.dispatch(lower, upper) for s, lower, upper in entries]

    def finalize_batch(self, handle) -> list:
        """One ``(hash, nonce)`` pair per entry of the batch."""
        return [f.result() for f in handle]


def default_searcher_factory(data: str, device="cuda",
                             body: PeelParams = PeelParams(),
                             mesh: tuple = ()):
    """The port's searcher for ``data`` with the lane body ``body``
    (``DBMT_PEEL``, ``DBMT_HOIST``): a :class:`HostSearcher` under
    ``DBMT_COMPUTE=host`` alone; else a :class:`MeshNonceSearcher` over
    ``mesh`` when it names at least two devices (``DBMT_MESH_DEVICES``,
    :func:`~..utils.config.mesh_from_env`), else a :class:`NonceSearcher`
    on ``device``. There is no automatic choice of the host tier."""
    if compute_from_env() == "host":
        return HostSearcher(data)
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

    #: Cross-thread ownership table (dbmlint: thread-state). Attributes
    #: listed here are touched from worker threads (``asyncio.to_thread``)
    #: and may be touched from the event loop, with the serialization
    #: argument on record; the analyzer fails any cross-thread attribute
    #: that is neither declared here nor mutated under a lock.
    THREAD_SHARED = {
        "_searchers": "executor-serialized: the LRU is touched only inside "
                      "_get_searcher, which runs on a to_thread worker "
                      "(_resolve_and_dispatch, _resolve_and_dispatch_batch, "
                      "_search). The pipelined executor has at most one "
                      "dispatch task in flight and awaits it before a "
                      "two-phase or blocking serve starts; the finalize "
                      "hop that overlaps a dispatch task calls only the "
                      "searcher's finalize. The serial loop awaits every "
                      "search. So one worker touches the LRU at a time, "
                      "though the thread may change per chunk.",
    }

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
        self._window = _ThroughputWindow()
        ensure_emitter()   # DBMT_METRICS_INTERVAL_S; 0 = none
        self._sanitize = _sanitize.ensure_sanitizer()
        self._trace = _trace.ensure_tracer()
        self._trace_launch = 0        # this miner's shared-launch ids
        self._trace_last_done = 0.0   # the previous chunk's finish stamp

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
                    if self._trace:
                        # The span's reader-queue phase starts here.
                        msg._recv_t = time.monotonic()
                    await queue.put(msg)

        reader_task = asyncio.create_task(reader())
        # (msg or [msgs], searcher, handle, t0, dispatch_s, span or spans)
        inflight = None
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
                if msg is not idle:
                    _MET_QDEPTH.observe(queue.qsize())
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
                    searcher, handle, dispatch_s, span = await dtask
                except Exception:
                    await self._exit_broken(msgs[0] if msgs else msg)
                    return
                if handle is not None:
                    inflight = (msgs or msg, searcher, handle, t0,
                                dispatch_s, span)
                    _MET_TWO_PHASE.inc(len(msgs) if msgs else 1)
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

    # ------------------------------------------------------------- spans

    def _span_open(self, msg) -> Optional[dict]:
        """A chunk's span at the dispatch worker's entry: the reader-queue
        phase closes here, and the fresh-signature count is stamped. None
        when tracing is off."""
        if not self._trace:
            return None
        now = time.monotonic()
        return {"queue_s": round(max(0.0, now - getattr(
            msg, "_recv_t", now)), 6), "_c0": _MET_FRESH.value}

    @staticmethod
    def _span_dispatched(span: Optional[dict], dispatch_s: float,
                         subs: Optional[int] = None) -> None:
        """Close the dispatch phase (on the worker thread, once the
        launches have started); ``subs`` is the chain's launches."""
        if span is None:
            return
        span["dispatch_s"] = round(dispatch_s, 6)
        span["_d_end"] = time.monotonic()
        fresh = _MET_FRESH.value - span.pop("_c0", 0)
        if fresh:
            span["compiles"] = fresh
        if subs is not None:
            span["subs"] = subs

    def _span_close(self, span: Optional[dict], t0: float, t2: float,
                    t3: float) -> Optional[dict]:
        """Finish a span at reply time: the pipeline wait (the launches
        started, to the force), the force, and the executor's idle gap
        before this chunk (since the previous chunk's finish). Returns
        exactly what rides the wire."""
        if span is None:
            return None
        d_end = span.pop("_d_end", t2)
        span.pop("_c0", None)
        span["wait_s"] = round(max(0.0, t2 - d_end), 6)
        span["force_s"] = round(max(0.0, t3 - t2), 6)
        if self._trace_last_done:
            span["gap_s"] = round(max(0.0, t0 - self._trace_last_done), 6)
        return span

    # ------------------------------------------------------------ serving

    def _resolve_and_dispatch(self, msg):
        """Worker-thread half of a two-phase chunk: resolve the searcher
        and start its launches. Returns ``(searcher, handle, dispatch_s,
        span)``; ``handle`` is None when the searcher has no two-phase
        API."""
        if self._sanitize:
            _sanitize.assert_off_loop("miner searcher resolution/dispatch")
        span = self._span_open(msg)
        t0 = time.monotonic()
        searcher = self._get_searcher(msg.data)
        if hasattr(searcher, "dispatch") and hasattr(searcher, "finalize"):
            handle = searcher.dispatch(msg.lower, msg.upper)
            dispatch_s = time.monotonic() - t0
            self._span_dispatched(span, dispatch_s,
                                  getattr(searcher, "last_dispatch_subs",
                                          None))
            return searcher, handle, dispatch_s, span
        return searcher, None, 0.0, span

    async def _finalize_and_reply(self, msg, searcher, handle, t0: float,
                                  dispatch_s: float,
                                  span: Optional[dict] = None) -> bool:
        """Force a dispatched chunk's result and write its Result; False
        ends the serve loop (transport death or broken compute)."""
        t2 = time.monotonic()
        try:
            best_hash, best_nonce = await asyncio.to_thread(
                searcher.finalize, handle, msg.lower)
        except Exception:
            await self._exit_broken(msg)
            return False
        t3 = time.monotonic()
        return self._reply(msg, best_hash, best_nonce, 0, t0,
                           busy_s=dispatch_s + (t3 - t2),
                           span=self._span_close(span, t0, t2, t3))

    def _resolve_and_dispatch_batch(self, msgs: list):
        """Worker-thread half of a coalesced chunk set: resolve every
        chunk's searcher and start ONE batched dispatch through the first
        one's ``dispatch_batch``. Returns ``(searcher, handle,
        dispatch_s, spans)``, a span a chunk (each with its own queue
        wait; the dispatch is the shared launch's); ``handle`` is None
        when the searchers cannot serve a batch (no batch API, or they
        cannot share a launch)."""
        if self._sanitize:
            _sanitize.assert_off_loop("miner batched resolution/dispatch")
        spans = [self._span_open(m) for m in msgs]
        t0 = time.monotonic()
        searchers = [self._get_searcher(m.data) for m in msgs]
        s0 = searchers[0]
        if hasattr(s0, "dispatch_batch") and hasattr(s0, "finalize_batch"):
            handle = s0.dispatch_batch(
                [(s, m.lower, m.upper) for s, m in zip(searchers, msgs)])
            if handle is not None:
                dispatch_s = time.monotonic() - t0
                for span in spans:
                    self._span_dispatched(span, dispatch_s)
                return s0, handle, dispatch_s, spans
        return s0, None, 0.0, spans

    async def _finalize_and_reply_batch(self, msgs: list, searcher, handle,
                                        t0: float, dispatch_s: float,
                                        spans: Optional[list] = None
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
        t3 = time.monotonic()
        if spans is not None:
            spans = [self._span_close(s, t0, t2, t3) for s in spans]
        return self._reply_batch(msgs, results, t0, dispatch_s + (t3 - t2),
                                 spans=spans)

    def _reply_batch(self, msgs: list, results: list, t0: float,
                     busy_s: float, spans: Optional[list] = None) -> bool:
        """Write a shared launch's Results in request order; its busy
        time is logged once for the whole launch, and its nonces feed the
        throughput window once. Every lane's span carries the launch's id
        and lane count."""
        t1 = time.monotonic()
        _MET_CHUNK_S.observe(max(busy_s, 1e-9))
        self.coalesced_dispatches += 1
        self.coalesced_chunks += len(msgs)
        _MET_COAL_DISPATCHES.inc()
        _MET_COAL_CHUNKS.inc(len(msgs))
        _MET_COAL_WIDTH.observe(len(msgs))
        total = sum(m.upper - m.lower + 1 for m in msgs
                    if m.upper >= m.lower)
        if total:
            self._window.observe(t0, t1, total)
        launch_id = None
        if spans is not None and any(s is not None for s in spans):
            self._trace_launch += 1
            launch_id = self._trace_launch
        for i, (msg, (best_hash, best_nonce)) in enumerate(
                zip(msgs, results)):
            _MET_CHUNKS.inc()
            if msg.upper >= msg.lower:
                _MET_NONCES.inc(msg.upper - msg.lower + 1)
            span = spans[i] if spans is not None else None
            if span is not None:
                span["launch"] = launch_id
                span["lanes"] = len(msgs)
            try:
                self.client.write(new_result(best_hash, best_nonce, 0,
                                             span=span).to_json())
            except LspError:
                return False
            self.jobs_done += 1
        if self._trace:
            self._trace_last_done = t1
            _trace.flight("chunk_batch_done", lanes=len(msgs),
                          busy_s=round(busy_s, 6), launch=launch_id)
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
            searcher, handle, dispatch_s, span = await asyncio.to_thread(
                self._resolve_and_dispatch, msg)
        except Exception:
            await self._exit_broken(msg)
            return False
        if handle is None:
            return await self._serve_blocking(msg)
        _MET_TWO_PHASE.inc()
        return await self._finalize_and_reply(msg, searcher, handle, t0,
                                              dispatch_s, span)

    async def _serve_blocking(self, msg) -> bool:
        """One chunk through the blocking search; False ends the serve
        loop. Its span's whole search is one ``force_s`` (``serial``)."""
        span = self._span_open(msg)
        if span is not None:
            span["serial"] = 1
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
        return self._reply(msg, best_hash, best_nonce, echo_target, t0,
                           span=self._span_close(span, t0, t0,
                                                 time.monotonic()))

    async def _exit_broken(self, msg) -> None:
        """Compute-failure exit path (must be called from an except
        block: it logs the active exception), counted in
        ``miner.search_failures``."""
        _MET_FAILURES.inc()
        logger.exception("search failed for %r [%d, %d]; exiting",
                         msg.data, msg.lower, msg.upper)
        await self.client.close()

    def counts(self) -> dict:
        """Chunks served, batched launches and the chunks they served,
        and CUDA kernel launches made by this process, by the
        TPU kernel each replaces (K1 arg-min search, K2 difficulty
        search, K3 and K4 the peeled bodies' searches, K5 the batched
        segment-min, K6 the folds of the device-resident chain); on a
        pod's owner also its row gathers (one a block)."""
        counts = {"chunks": self.jobs_done,
                  "coalesced_dispatches": self.coalesced_dispatches,
                  "coalesced_chunks": self.coalesced_chunks,
                  "kernel_launches": dict(sha256_cuda.launches)}
        pod = multihost.active_pod()
        if pod is not None:
            counts["row_gathers"] = pod.gathers
        return counts

    def _reply(self, msg, best_hash: int, best_nonce: int,
               echo_target: int, t0: float,
               busy_s: Optional[float] = None,
               span: Optional[dict] = None) -> bool:
        """Write the Result, with ``span`` on it; False on transport
        death. ``busy_s`` (a pipelined chunk's dispatch and finalize
        time, without its wait behind the previous chunk) defaults to the
        wall time since ``t0``. An argmin chunk's nonces feed the
        throughput window."""
        t1 = time.monotonic()
        _MET_CHUNK_S.observe(max(busy_s if busy_s is not None
                                 else t1 - t0, 1e-9))
        _MET_CHUNKS.inc()
        if msg.upper >= msg.lower:
            # A difficulty chunk's early exit may scan less: it is left
            # out of the throughput window, not of the scanned count.
            scanned = msg.upper - msg.lower + 1
            _MET_NONCES.inc(scanned)
            if not msg.target:
                self._window.observe(t0, t1, scanned)
        try:
            self.client.write(new_result(best_hash, best_nonce, echo_target,
                                         span=span).to_json())
        except LspError:
            return False
        self.jobs_done += 1
        if self._trace:
            self._trace_last_done = t1
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
        if self._sanitize:
            _sanitize.assert_off_loop("miner blocking search")
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


def _restart_launch_counts() -> None:
    """Restart the kernel launch counts at 0 (they count the launches
    made serving requests) and log the model's counters at that point
    (the process registry's count from the process's start), so a
    reader can take their deltas over the same window."""
    sha256_cuda.reset_launches()
    counters = _M.snapshot()["counters"]
    logger.info("model counts at the launch counts' restart %s", json.dumps(
        {k: v for k, v in counters.items() if k.startswith("model.")}))


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
        _restart_launch_counts()   # the counts are of requests served
        return hint
    try:
        return max(0.0, float(raw))
    except ValueError:
        return 0.0


def _final_snapshot_on_sigterm() -> None:
    """SIGTERM still ends the miner at once, as its default action does,
    but the metrics emitter first writes its final snapshot, which the
    exit hooks write on a normal exit and a signal skips."""
    def handler(signum, _frame):
        emitter = ensure_emitter()
        if emitter is not None:
            emitter.stop()
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)
    signal.signal(signal.SIGTERM, handler)


async def _run_miner(hostport: str, factory: Callable, where: str,
                     rate_hint: float = 0.0) -> int:
    _final_snapshot_on_sigterm()
    coalesce = coalesce_from_env()
    worker = MinerWorker(
        hostport, params=lsp_params_from_env(), searcher_factory=factory,
        pipeline_depth=pipeline_depth_from_env(),
        coalesce=coalesce.enabled, coalesce_lanes=coalesce.lanes,
        coalesce_max=coalesce.max_nonces, rate_hint=rate_hint)
    try:
        try:
            await worker.join()
        except LspError as exc:
            print("Failed to join with server:", exc)
            return 1
        logger.info("joined %s on %s", hostport, where)
        await worker.run()
        return 0
    finally:
        await worker.close()


def main(argv=None) -> int:
    """CLI contract of the reference binary (ref: miner.go:70-77):
    ``miner <hostport>``, plus ``--device cuda|cpu``; exits silently when
    the connection dies. Asking for ``cuda`` where there is none raises
    before joining. With ``DBMT_COORDINATOR`` set the process is one rank
    of a pod (:func:`run_pod_rank`)."""
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
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if compute_from_env() == "host":
        return asyncio.run(_run_miner(args[0], default_searcher_factory,
                                      "the host tier",
                                      _resolve_rate_hint(
                                          default_searcher_factory)))
    device = resolve_device(device)
    body = peel_from_env()
    pod = pod_from_env()
    if pod.coordinator is not None:
        return run_pod_rank(args[0], device, body, pod)
    mesh = mesh_from_env(device)
    if len(mesh) < 2:
        mesh = ()
    if any(resolve_device(d).type == "cuda" for d in mesh or (device,)):
        warm_up(device, body, mesh)

    def factory(data):
        return default_searcher_factory(data, device, body, mesh)
    rate_hint = _resolve_rate_hint(factory)
    if rate_hint > 0:
        logger.info("rate hint %.6g nonces/s", rate_hint)
    return asyncio.run(_run_miner(
        args[0], factory, f"the mesh {','.join(mesh)}" if mesh
        else str(device), rate_hint))


def run_pod_rank(hostport: str, device, body: PeelParams,
                 params: PodParams) -> int:
    """One rank of a pod (``parallel.multihost``): join the pod over this
    rank's local mesh (``DBMT_MESH_DEVICES``, else every visible card on
    ``cuda``, else ``device``), warm its mesh up with no collective, then
    on rank 0 serve LSP through :class:`~..parallel.multihost.PodSearcher`
    (the rate probe too, which every rank runs; the counters restart at 0
    on every rank afterwards) and broadcast the stop frame on every exit
    path; on the other ranks run the broadcast jobs until it comes. A
    rank whose pod job fails because a peer died exits with code 17."""
    local = mesh_from_env(device) or (str(device),)
    pod = multihost.initialize_multihost(local, params)
    if any(d.type == "cuda" for d in pod.devices):
        warm_up_mesh(pod.devices, body)
    try:
        if not multihost.is_lsp_owner():
            logger.info("follower rank %d ready", pod.rank)
            jobs = multihost.run_follower(body)
            logger.info("follower done after %d jobs", jobs)
            return 0
        try:
            def factory(data):
                return multihost.PodSearcher(data, body)
            rate_hint = _resolve_rate_hint(factory)
            multihost.bounded_pod_call(multihost.broadcast_reset)
            pod.gathers = 0
            if rate_hint > 0:
                logger.info("rate hint %.6g nonces/s", rate_hint)
            return asyncio.run(_run_miner(
                hostport, factory, f"the pod of {pod.world} ranks, "
                f"{pod.world * pod.n_local} shards", rate_hint))
        finally:
            multihost.bounded_pod_call(multihost.broadcast_stop)
    finally:
        multihost.shutdown()


def warm_up_mesh(devices: tuple, body: PeelParams = PeelParams()) -> None:
    """A pod rank's warm-up: its local mesh's chains (arg-min and
    difficulty) once over [0, 10^5), with no collective, then the launch
    counters restart at 0."""
    import torch

    from ..models import MeshNonceSearcher
    from ..parallel.mesh_search import distinct
    t0 = time.monotonic()
    for d in distinct(devices):
        torch.zeros(1, device=d)
    s = MeshNonceSearcher("warm-up", devices=devices, peel=body.peel,
                          hoist=body.hoist)
    s.search(0, 10 ** 5 - 1)
    s.search_until(0, 10 ** 5 - 1, 1)
    _restart_launch_counts()
    logger.info("mesh %s ready in %.3fs (%s)",
                ",".join(str(d) for d in devices), time.monotonic() - t0,
                body)


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
    _restart_launch_counts()
    logger.info("device %s ready in %.3fs (%s; %s)",
                ",".join(str(d) for d in devices), time.monotonic() - t0,
                torch.cuda.get_device_name(devices[0]), body)


if __name__ == "__main__":
    import sys
    sys.exit(main())
