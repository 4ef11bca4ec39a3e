"""The scheduler: shard nonce ranges over an elastic miner pool, merge argmins.

The request state machine of the JAX package's ``apps/scheduler.py``
(itself the state machine of the reference coordinator, ref: bitcoin/
server/server.go:19-403), with the reference's method names. The pool
roster, pending FIFOs, leases, trust, rate hints, the stripe planner and
coalescing windows live in :mod:`.miner_plane`; the per-tenant queue
index, admission, shedding, weights and the age alarms in
:mod:`.tenant_plane`; the deficit-round-robin state and the admission
buckets in :mod:`.qos`.

- Stock FIFO dispatch (``QosParams(enabled=False)``): ONE request in
  flight at a time. ``_load_balance`` makes bounds exclusive (``upper +=
  1``) and splits ``total // num_miners`` with the remainder to the FIRST
  miner; with more miners than nonces, only ``total`` miners get 1-nonce
  chunks (ref: server.go:165-205).
- Bound quirk preserved for bit parity: chunks are sent with EXCLUSIVE upper
  bounds but the miner treats ``Upper`` as inclusive (ref: miner.go:51-52),
  so each chunk scans one extra nonce and the system as a whole scans
  ``[0, maxNonce+1]``.
- Striping (default on, ``StripeParams``): each miner's even-split share
  of a wholesale request is cut into up to ``depth`` contiguous chunks of
  ``chunk_s`` seconds at its rate (:meth:`MinerPlane.stripe_chunks`), so
  the pipelined miner's FIFO stays full. The whole plan is built first,
  with chunk indices ascending with the nonces across miners (the
  difficulty merge's prefix release reads them in that order); a cold
  pool gives the stock one chunk a miner. A miner may JOIN with a rate
  hint, which warms its rate (and an empty pool's) until a measured
  window replaces it.
- Result cache (default on, ``CacheParams``): an LRU of finished answers
  keyed on ``(data, lower, upper, target)``. A repeated request is
  answered at arrival, or, when it queued behind its original, at
  dispatch, without touching the pool. Weak merges are not stored.
- Fair-share QoS dispatch (default on): tenants are client conn ids. A
  request estimated to scan longer than ``wholesale_s`` at the pool's
  throughput, or one that starts while chunked work is in flight, is
  CHUNKED and its chunks are granted one at a time by deficit-round-robin
  across tenants, each miner holding at most ``depth`` live chunks. A
  small request on an idle pool (and every request on a cold pool)
  dispatches wholesale, exactly like the stock path, so single-tenant
  traffic is bit-identical to it. Within one pump pass, small argmin
  chunks of different requests may be granted into one miner's
  COALESCING WINDOW: they share a ``coalesce_id``, count as one live
  chunk, and the miner runs them as one batched launch. The lazy pump
  (``QosParams(lazy=True)``, the JAX package's default; the port's is
  the eager pump) walks the DRR ring and prices each visited tenant's
  head on demand from per-tenant indexes, instead of rebuilding every
  head before each grant (the eager pump).
- Admission and shedding (QoS): a request that finds its tenant's token
  bucket empty is shed at arrival (a cache replay spends no token); with
  more than ``max_queued`` requests queued, the oldest is shed. A shed
  closes the tenant's conn (classic LSP has no reject message) and takes
  its other queued requests with it. Per-tenant DRR weights come from
  ``QosParams.weights`` or :meth:`Scheduler.set_tenant_weight`.
- Result merge: strict ``<`` on the uint64 hash; the barrier releases the
  Result to the client when every chunk of the request has been answered
  (ref: server.go:257-325).
- Miner drop: its unanswered chunks go to available miners, else they
  park; a parked chunk is re-issued when a miner joins or frees up
  (ref: server.go:326-376, 222-244, 285-304).
- Client drop: its queued requests are purged and its in-flight requests
  are cancelled at once — miners are freed, parked chunks cleared, the
  next queued work starts.
- Lease plane: a miner whose card hangs inside a kernel keeps its
  connection (and its heartbeats) alive, so a drop never comes. Every
  assigned chunk carries a LEASE; the sweep (:meth:`Scheduler.sweep`,
  every ``tick_s``) blows an expired one and speculatively RE-ISSUES the
  chunk to another eligible miner (the first Result wins, the other pops
  as a duplicate); ``quarantine_after`` consecutive blown leases
  QUARANTINE a miner until it answers again; a pool that is wholly
  quarantined or distrusted serves through DESPERATION dispatch to its
  least-bad miner. Leases change latency under faults, never the answer.
  The sweep also expires audits and raises the queue-age and in-flight
  alarms; a dispatch pass that finds queued work and no eligible miner
  logs once per starvation episode.
- Verification tier: every Result is a CLAIM. The claim check recomputes
  its hash on the host (``hash_op``), and its nonce must lie in the
  chunk; a failed claim decays the miner's trust, is not merged, and its
  range runs again on another miner. A true pair need not be the
  minimum: with probability ``audit_p`` a random subwindow of an
  answered arg-min chunk is AUDITED (re-run on a disjoint miner under a
  job id of its own, :class:`AuditRecord`), and the request's reply
  waits for its audits. An auditor that finds a better hash convicts the
  claimant and its pair repairs the answer; an auditor that misses the
  claimed winner inside its window is convicted itself and the window is
  audited again elsewhere. Below the trust bar a miner gets no grants.
- ``stats`` holds the JAX package's counters (:data:`STAT_COUNTERS`),
  logged as one ``scheduler counts`` JSON line after each answer (and,
  with the adapt plane mounted, its values as a ``scheduler adapt``
  line, which is also logged whenever a controller moves). Each chunked
  activation logs its plan: the chunk count and size, and the chunk
  seconds and pool rate it was planned from.
- Tracing (``DBMT_TRACE``, default on): every request carries a
  :class:`~..utils.metrics.RequestTrace` (enqueue, dispatch, assign,
  result, merge, reply and every fault edge), registered by job id in
  the tenant plane's buffer; each Result's ``Span`` (the miner's chunk
  phases) is folded into it as a ``miner_span`` event naming its
  dominant phase (:meth:`Scheduler._fold_span`), and
  :meth:`Scheduler.export_trace` writes every retained trace as Chrome
  trace-event JSON. Control-plane edges go to the flight recorder.
- The adapt plane (``DBMT_ADAPT``, default on, ``apps.adapt``): its
  controllers, fed by the lease stamps, the spans and the queue, move
  the QoS and stripe chunk seconds (one value), the coalescing window's
  ``small_s`` and, with ``AdaptParams.admit`` (off by default in the
  port), a scheduler-wide admission bucket and queue bound, applied by
  the sweep (:meth:`Scheduler._apply_adapt`). The controllers read the
  scheduler's clock, ``time.monotonic`` through this module at each
  call.

Difficulty merge: a Request carrying a ``Target`` is forwarded with the
target on every chunk. Chunks cover ascending disjoint sub-ranges and each
until-speaking miner answers its chunk's FIRST qualifying (``hash <
target``) nonce, echoing the target; so the lowest-index qualifying chunk
holds the request's first qualifying nonce, final as soon as every earlier
chunk has answered (prefix release), whatever is still in flight. When no
chunk qualifies, the barrier answers the exact arg-min. A miner that
answers without echoing the target (a stock miner) makes the merge weak:
the answer is still qualifying when one exists, but not guaranteed first,
and the scheduler logs it. Difficulty chunks are never audited: an early
exit leaves the rest of a window unscanned.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import time
from dataclasses import dataclass, field
from dataclasses import replace as _replace
from typing import Optional

from ..bitcoin.hash import MAX_U64, hash_op
from ..bitcoin.message import Message, MsgType, new_result
from ..lsp.errors import LspError
from ..lsp.server import AsyncServer
from ..utils import sanitize as _sanitize
from ..utils import trace as _tracing
from ..utils.config import (AdaptParams, CacheParams, CoalesceParams,
                            LeaseParams, QosParams, StripeParams,
                            VerifyParams, adapt_from_env, cache_from_env,
                            coalesce_from_env, gateway_from_env,
                            lease_from_env, qos_from_env,
                            recv_batch_from_env, stripe_from_env,
                            verify_from_env)
from ..utils.metrics import Registry, RequestTrace
from ..utils.metrics import registry as process_registry
from . import capture as _capture
from .adapt import AdaptPlane
from .miner_plane import Chunk, MinerPlane, MinerState
from .qos import LAZY_REMOVE
from .tenant_plane import TenantPlane

logger = logging.getLogger("dbmt.scheduler")

__all__ = ["AuditRecord", "Chunk", "MinerState", "Request", "ResultCache",
           "Scheduler", "STAT_COUNTERS"]

#: Every counter in ``Scheduler.stats``, by the JAX package's names.
STAT_COUNTERS = (
    "results_sent", "dup_results", "leases_blown", "leases_blown_spurious",
    "reissues", "quarantines", "cache_hits", "cache_misses", "cache_stores",
    "desperation_dispatch", "no_eligible_miner", "chunks_striped",
    "queue_alarms", "inflight_alarms", "qos_grants", "qos_shed",
    "qos_window_grants", "claims_checked", "claims_failed", "audits_issued",
    "audits_passed", "audits_failed", "audits_inconclusive",
    "trust_decays_claim", "trust_decays_audit", "rate_hints_refreshed")


class ResultCache:
    """An LRU of ``size`` finished answers ``(hash, nonce)``, keyed on the
    request ``(data, lower, upper, target)``. An answer is a function of
    its key (the arg-min, or the first qualifying nonce, of a fixed
    range), except a weak difficulty merge's, which is never stored."""

    def __init__(self, size: int):
        self.size = size
        self._d: dict = {}     # insertion order is recency order

    def get(self, key):
        hit = self._d.pop(key, None)
        if hit is not None:
            self._d[key] = hit          # refresh its recency
        return hit

    def put(self, key, value) -> None:
        self._d.pop(key, None)
        self._d[key] = value
        while len(self._d) > self.size:
            self._d.pop(next(iter(self._d)))

    def __len__(self):
        return len(self._d)


async def receive(server, handle, recv_batch: int) -> None:
    """Feed every transport item to ``handle(conn_id, payload)`` until the
    server closes: one awaited read, then up to ``recv_batch - 1`` items
    already delivered (``read_nowait``), in order, without a loop hop a
    message. ``recv_batch=1`` reads one item an await."""
    while True:
        try:
            conn_id, payload = await server.read()
        except LspError:
            return
        handle(conn_id, payload)
        for _ in range(recv_batch - 1):
            item = server.read_nowait()
            if item is None:
                break
            handle(item[0], item[1])


@dataclass
class Request:
    conn_id: int
    data: str
    lower: int
    upper: int              # inclusive on arrival; +1 at dispatch
    target: int = 0
    job_id: int = 0
    num_chunks: int = 0
    min_hash: int = MAX_U64
    min_nonce: int = 0
    answered: list = field(default_factory=list)   # bool per chunk idx
    # Difficulty merge: each qualifying chunk's (nonce, hash) by chunk idx,
    # and whether a responder answered a target chunk without echoing the
    # target (then the answer is qualifying, not guaranteed first).
    chunk_q: dict = field(default_factory=dict)
    weak: bool = False
    started: float = 0.0           # at dispatch
    queued_at: float = 0.0         # at arrival
    cache_key: Optional[tuple] = None  # (data, lower, upper, target)
    # The age alarms' last warnings, queued and in flight apart.
    last_alarm: float = 0.0
    last_inflight_alarm: float = 0.0
    qkey: int = 0                  # tenant-queue index stamp
    # QoS: "wholesale" (every chunk assigned at dispatch) or "chunked"
    # (chunk plan held here, granted one chunk at a time).
    qos_mode: str = ""
    chunk_bounds: list = field(default_factory=list)  # chunked: [(lo, up)]
    next_chunk: int = 0            # chunked: first ungranted idx
    granted_chunks: int = 0
    # Outstanding audits of this request's chunks: the reply waits for
    # them (an audit after the reply could only detect a lie, not stop it).
    audit_holds: int = 0
    trace: object = None           # RequestTrace (NULL_TRACE: unsampled)

    def __post_init__(self):
        # Every Request carries a trace from birth; arrivals get the
        # tenant plane's (possibly sampled) one.
        if self.trace is None:
            self.trace = RequestTrace(data=self.data, lower=self.lower,
                                      upper=self.upper, target=self.target,
                                      client=self.conn_id)


@dataclass
class AuditRecord:
    """One outstanding audit: a subwindow of an answered arg-min chunk,
    re-run on a DISJOINT miner under a fresh job id that never enters
    the in-flight map. Its Result routes here instead of the merge (so
    an audit outlives its request, and the lease sweep and recovery,
    which skip jobs not in flight, never touch it); the sweep expires it
    at ``deadline`` instead."""
    job_id: int          # the job whose chunk is audited
    idx: int             # that chunk's idx
    suspect: int         # conn id of the miner whose claim is audited
    auditor: int         # conn id of the miner re-running the window
    lower: int           # the window, bounds inclusive (the miner reads
    upper: int           # ``Upper`` inclusive)
    claimed_hash: int    # the suspect's claim for the whole chunk
    claimed_nonce: int
    deadline: float = float("inf")


def _monotonic() -> float:
    """The scheduler's clock: ``time.monotonic`` read through this module
    at each call (the adapt controllers are handed it)."""
    return time.monotonic()


class Scheduler:
    """Single-actor scheduler over an :class:`AsyncServer`. ``qos``,
    ``coalesce``, ``stripe``, ``cache``, ``lease``, ``verify`` and
    ``adapt`` default to the environment's (``DBMT_*`` knobs);
    ``audit_rng`` draws the audits (a seeded ``random.Random`` makes them
    reproducible); ``trace_sample`` overrides ``DBMT_TRACE_SAMPLE``."""

    def __init__(self, server: AsyncServer, qos: Optional[QosParams] = None,
                 coalesce: Optional[CoalesceParams] = None,
                 lease: Optional[LeaseParams] = None,
                 verify: Optional[VerifyParams] = None,
                 audit_rng: Optional[random.Random] = None,
                 stripe: Optional[StripeParams] = None,
                 cache: Optional[CacheParams] = None,
                 adapt: Optional[AdaptParams] = None,
                 trace_sample: Optional[float] = None,
                 result_cache: Optional[ResultCache] = None,
                 capture=None, metrics_prefix: str = "sched",
                 recv_batch: Optional[int] = None):
        self.server = server
        # The batched receive: after each awaited read, up to
        # ``recv_batch - 1`` more delivered messages are handled without
        # a loop hop (``DBMT_RECV_BATCH``; 1: one message an await).
        self._recv_batch = max(1, recv_batch) if recv_batch is not None \
            else recv_batch_from_env()
        # The federation (``DBMT_GATEWAY``, default 1, read once here): a
        # repeat JOIN from a live miner's conn refreshes its rate hint in
        # place (the GatewayMiner's pool sum); 0 registers a new miner
        # for every JOIN, as the reference does.
        self._gateway = gateway_from_env().enabled
        qos = qos if qos is not None else qos_from_env()
        coalesce = coalesce if coalesce is not None else coalesce_from_env()
        stripe = stripe if stripe is not None else stripe_from_env()
        cache = cache if cache is not None else cache_from_env()
        self.lease = lease if lease is not None else lease_from_env()
        self.verify = verify if verify is not None else verify_from_env()
        # ``result_cache`` is a SHARED cache (the replica tier's replay
        # tier); otherwise each scheduler owns one.
        self.results: Optional[ResultCache] = result_cache \
            if result_cache is not None \
            else ResultCache(cache.size) if cache.enabled else None
        self._audit_rng = audit_rng if audit_rng is not None \
            else random.Random()
        # Outstanding audits by audit job id (off the job id counter, so
        # never a live request's).
        self._audits: dict[int, AuditRecord] = {}
        # In-flight requests by job id, oldest first. The stock FIFO path
        # keeps at most one; the QoS plane runs several.
        self._inflight: dict[int, Request] = {}
        self._chunked_inflight = 0
        # The lazy pump's per-tenant indexes: each tenant's chunked
        # in-flight requests with ungranted chunks (activation order) and
        # its count of in-flight requests.
        self._qos_chunked_reqs: dict = {}     # tenant -> {job_id: Request}
        self._tenant_inflight: dict = {}      # tenant -> requests in flight
        # The counters (read as :attr:`stats`; the replica tier's rollup
        # merges them) and the adapt plane's gauges, mounted in the
        # process registry under ``metrics_prefix`` (each replica of the
        # replica tier under its own).
        self.metrics = Registry()
        process_registry().mount(metrics_prefix, self.metrics)
        self._counters = {n: self.metrics.counter(n) for n in STAT_COUNTERS}
        # What the queue-wait SLO reads (``apps.slo``): each request's
        # seconds in the queue. The tenant plane keeps the queue's depth,
        # the miner plane the pool's series, the QoS plane the tenants'.
        self._queue_wait = self.metrics.histogram("queue_wait_s")
        # Hits over lookups, after each lookup (:meth:`_cache_lookup`).
        self._cache_hit_ratio = self.metrics.gauge("cache_hit_ratio")
        # DBMT_SANITIZE=1: the loop watchdog, and the hot tables pinned to
        # the thread that runs the event handlers.
        self._owner = (_sanitize.ThreadOwner(
            "Scheduler hot state (miners/queue/_inflight)")
            if _sanitize.ensure_sanitizer() else None)
        self._trace_on = _tracing.ensure_tracer()
        # The capture plane (DBMT_CAPTURE, off by default): with it off
        # (and no instance given) this is None and every hook is one
        # attribute test. ``capture=False`` refuses the environment's (a
        # replay must not truncate the capture it reads).
        self.capture = None if capture is False else capture \
            if capture is not None else _capture.ensure_from_env()
        self.tenant_plane = TenantPlane(
            self.metrics, qos, self._count,
            close_conn=getattr(server, "close_conn", None),
            trace_on=self._trace_on, trace_sample=trace_sample,
            capture=self.capture)
        if self.capture is not None:
            # The workload-shape knobs a replay reproduces, and the
            # transport a replay's latencies compare against.
            self.capture.config(max_queued=qos.max_queued,
                                wholesale_s=qos.wholesale_s,
                                qos=bool(qos.enabled),
                                transport=type(server).__name__)
        self.miner_plane = MinerPlane(
            self.metrics, self.lease, coalesce, write=self._write,
            inflight=self._inflight, lease_event=self._on_lease_event,
            dispatch=self._maybe_dispatch, count=self._count,
            verify=self.verify, stripe=stripe,
            trace_get=self.tenant_plane.traces.get, trace_on=self._trace_on)
        # The adapt plane mounts only the controllers whose knobs are
        # live: the chunk seconds and the admission gate need the QoS
        # plane, the window bound its coalescing windows. It starts at
        # the static values and departs from them only on evidence.
        adapt = adapt if adapt is not None else adapt_from_env()
        self.adapt_plane: Optional[AdaptPlane] = None
        if adapt.enabled:
            self.adapt_plane = AdaptPlane(
                _replace(adapt, admit=adapt.admit and qos.enabled),
                self.metrics, _monotonic,
                chunk_s=qos.chunk_s if qos.enabled else 0.0,
                small_s=coalesce.small_s
                if (qos.enabled and coalesce.enabled) else 0.0,
                trace_on=self._trace_on)
        # Job ids count up from here; the replica tier gives each replica a
        # disjoint range, so an adopted miner's late Result of a dead
        # replica's job never names a live job of its adopter.
        self._next_job_id = 0
        self._dispatching = False
        self._starved = False          # the no-eligible-miner latch

    @property
    def qos(self) -> QosParams:
        return self.tenant_plane.qos

    @property
    def qos_plane(self):
        return self.tenant_plane.qos_plane

    @property
    def queue(self) -> list:
        """Arrival-ordered copy of the queued requests (a read-only view:
        the interleaving explorer's accounting invariant reads it)."""
        return self.tenant_plane.requests()

    @property
    def current(self) -> Optional[Request]:
        """The oldest in-flight request, or None."""
        return next(iter(self._inflight.values()), None)

    @property
    def inflight(self) -> dict:
        return dict(self._inflight)

    @property
    def miners(self) -> list:
        return self.miner_plane.miners

    @property
    def stats(self) -> dict:
        """Every counter of :data:`STAT_COUNTERS` by name (a copy)."""
        return {n: c.value for n, c in self._counters.items()}

    def _count(self, name: str, n: int = 1) -> None:
        self._counters[name].inc(n)

    def _log_counts(self) -> None:
        logger.info("scheduler counts %s", json.dumps(self.stats))
        if self.adapt_plane is not None:
            logger.info("scheduler adapt %s",
                        json.dumps(self.adapt_plane.state()))

    def _fold_span(self, trace, conn_id: int, chunk: Chunk,
                   span: Optional[dict]) -> None:
        """Stitch one miner's chunk span (the Result's ``Span``) into the
        request's trace as a ``miner_span`` event: only the span
        vocabulary's numeric keys, with the dominant phase named, and the
        miner's export track registered. Unsampled requests skip it."""
        if span is not None and self.capture is not None:
            # The capture sees every span, whatever the trace sampling.
            self.capture.span(span)
        if span is None or trace is None or trace.null \
                or not self._trace_on:
            return
        clean = {}
        for key in _tracing.SPAN_PHASES + _tracing.SPAN_EXTRAS:
            v = span.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                clean[key] = v
        if not clean:
            return
        self.tenant_plane.track_miner(conn_id)
        slow = _tracing.slow_phase(clean)
        if slow is not None:
            clean["slow"] = slow
        trace.event("miner_span", miner=conn_id, idx=chunk.idx, **clean)

    def export_trace(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (loadable in ui.perfetto.dev) of every
        retained request trace: one track per tenant and per miner, the
        requests' slices, the fault events as instants and the stitched
        miner-side phases. Returns the document; ``path`` also writes it
        (``tools/dbmtrace.py`` converts a dump the same way)."""
        dicts = []
        for _key, t in self.tenant_plane.traces.items():
            d = t.to_dict()
            d["t0"] = t.t0
            dicts.append(d)
        tenant_tracks, miner_tracks = {}, {}
        for labels, tid in self.tenant_plane.tracks.items("trace_track"):
            labels = dict(labels)
            if "tenant" in labels:
                tenant_tracks[labels["tenant"]] = tid
            if "miner" in labels:
                miner_tracks[labels["miner"]] = tid
        doc = _tracing.to_chrome_trace(dicts, tenant_tracks=tenant_tracks,
                                       miner_tracks=miner_tracks)
        if path:
            with open(path, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, sort_keys=True)
        return doc

    @property
    def traces(self):
        """The request traces (the tenant plane's buffer)."""
        return self.tenant_plane.traces

    def set_tenant_weight(self, tenant, weight: float) -> None:
        """Override one tenant's DRR weight (the environment's path is
        ``DBMT_QOS_WEIGHTS``)."""
        self.tenant_plane.set_weight(tenant, weight)

    async def run(self) -> None:
        """Serve until the LSP server is closed; the sweep runs beside."""
        sweeper = asyncio.get_running_loop().create_task(self._lease_loop())
        try:
            await receive(self.server, self.handle, self._recv_batch)
        finally:
            sweeper.cancel()

    def handle(self, conn_id: int, payload) -> None:
        """Handle ONE transport item — a payload or a conn-death
        exception."""
        if isinstance(payload, Exception):
            self._on_drop(conn_id)
            return
        try:
            msg = Message.from_json(payload)
        except ValueError:
            return
        if msg.type == MsgType.JOIN:
            self._on_join(conn_id, msg)
        elif msg.type == MsgType.REQUEST:
            self._on_request(conn_id, msg)
        elif msg.type == MsgType.RESULT:
            self._on_result(conn_id, msg)

    async def _lease_loop(self) -> None:
        """The scheduler's one timer: a sweep every ``tick_s``."""
        while True:
            await asyncio.sleep(self.lease.tick_s)
            try:
                self.sweep()
            except Exception:   # noqa: BLE001 — the sweep must never die
                logger.exception("lease sweep failed; continuing")

    def sweep(self) -> None:
        """One tick: lease checks (when leases are on), audit expiry, the
        rate hints' decay, the queue-age and in-flight alarms, and under
        QoS the idle-tenant GC."""
        mp = self.miner_plane
        tp = self.tenant_plane
        if self.lease.enabled:
            mp.check_leases()
        if self._audits:
            self._expire_audits()
        mp.decay_rate_hints()
        tp.check_queue_age(
            self._inflight, self.lease.queue_alarm_s,
            self.qos_plane.grant_share, self._count, len(mp.miners),
            len(mp.eligible()),
            distrusted_n=sum(1 for m in mp.miners if mp.distrusted(m)),
            current=self.current)
        if self.capture is not None:
            self.capture.maybe_snapshot(
                miners=len(mp.miners),
                rates=[m.rate_ewma for m in mp.miners if m.rate_ewma],
                queued=len(tp), inflight=len(self._inflight))
        if self.adapt_plane is not None:
            self._apply_adapt()
        if self.qos.enabled:
            tp.gc(set(tp.backlog_tenants())
                  | {r.conn_id for r in self._inflight.values()})

    def _apply_adapt(self) -> None:
        """One adapt tick (run by the sweep): the controllers see the
        oldest queued request's age, the requests answered so far and,
        in per-miner mode, the spread of the miners' measured rates;
        then the values they moved are applied. The chunk and stripe
        seconds take one value; the window bound replaces ``small_s``;
        the admission rate lives in the plane's own bucket; per-miner
        values land on the miner plane's overrides. Chunk plans already
        made keep their bounds."""
        head = self.tenant_plane.head()
        age = (time.monotonic() - head.queued_at) if head is not None \
            else 0.0
        # The per-miner gate reads measured rates only: an unconfirmed
        # JOIN hint must not fork the pool.
        ratio = None
        chunk_ctl = self.adapt_plane.chunk
        if chunk_ctl is not None and chunk_ctl.per_miner:
            ewmas = [m.rate_ewma for m in self.miner_plane.miners
                     if m.rate_ewma and not m.rate_hinted]
            if len(ewmas) >= 2:
                ratio = max(ewmas) / max(min(ewmas), 1e-9)
        sent = self._counters["results_sent"].value
        changes = self.adapt_plane.tick(age, sent, rate_ratio=ratio)
        if not changes:
            return
        logger.info("scheduler adapt %s",
                    json.dumps(self.adapt_plane.state()))
        mp = self.miner_plane
        if changes.get("chunk_s_miner_clear"):
            mp.clear_chunk_s_overrides()
        for conn, v in (changes.get("chunk_s_miner") or {}).items():
            if mp.find_miner(conn) is not None:
                mp.set_chunk_s_override(conn, v)
        v = changes.get("chunk_s")
        if v is not None:
            self.tenant_plane.qos = _replace(self.qos, chunk_s=v)
            mp.stripe = _replace(mp.stripe, chunk_s=v)
        v = changes.get("small_s")
        if v is not None:
            mp.coalesce = _replace(mp.coalesce, small_s=v)

    # ---------------------------------------------------------------- events

    def _on_request(self, conn_id: int, msg: Message) -> None:
        """A cache hit is answered at once; under QoS the adapt plane's
        admission bucket (capacity) and then the tenant's bucket
        (fairness) admit the request or shed it; then it queues."""
        if self._owner is not None:
            self._owner.assert_here()
        if self.capture is not None:
            # Before admission: a shed arrival is part of the workload.
            self.capture.request(conn_id, len(msg.data),
                                 msg.upper - msg.lower + 1,
                                 bool(msg.target))
        request = self._build_request(conn_id, msg)
        if request is None:
            return
        if self.qos.enabled:
            if self.adapt_plane is not None:
                if self.adapt_plane.window is not None:
                    cold, bound = self._qos_small_bound()
                    self.adapt_plane.observe_arrival(self._qos_is_small(
                        request.upper - request.lower + 1, cold, bound))
                if not self.adapt_plane.admit():
                    self._shed(request, "admission")
                    return
            if not self.tenant_plane.admit(conn_id):
                self._shed(request, "admission")
                return
        self._intake(request)

    def reserve_request(self, conn_id: int, msg: Message) -> None:
        """The replica tier's re-serve of a dead replica's request: as
        :meth:`_on_request`, but no admission bucket is charged and no
        overload shed runs (the request was admitted once already; the
        queue bound holds again at the next arrival)."""
        if self._owner is not None:
            self._owner.assert_here()
        request = self._build_request(conn_id, msg)
        if request is None:
            return
        if self.qos.enabled:
            self.tenant_plane.tenant(conn_id)
        self._intake(request, bound_queue=False)

    def _build_request(self, conn_id: int, msg: Message):
        """The arriving request, or None when the result cache answered
        it."""
        key = (msg.data, msg.lower, msg.upper, msg.target)
        if self.results is not None:
            hit = self._cache_lookup(key)
            if hit is not None:
                self._write(conn_id, new_result(*hit))
                self._count("results_sent")
                if self.capture is not None:
                    self.capture.reply(conn_id, 0.0, cached=True)
                self.tenant_plane.cache_replay_trace(conn_id, key, *hit)
                logger.info("request %r [%d, %d] target=%d answered from "
                            "the result cache", msg.data, msg.lower,
                            msg.upper, msg.target)
                self._log_counts()
                return None
        return Request(conn_id=conn_id, data=msg.data, lower=msg.lower,
                       upper=msg.upper, target=msg.target, cache_key=key,
                       queued_at=time.monotonic(),
                       trace=self.tenant_plane.new_trace(
                           data=msg.data, lower=msg.lower, upper=msg.upper,
                           target=msg.target, client=conn_id))

    def _cache_lookup(self, key, count_miss: bool = True):
        """The cached answer, counted as a hit or a miss, and the hit
        ratio set (``count_miss`` off for the dispatch-time check of a key
        that missed at arrival: a request dispatched normally is one
        miss, not two)."""
        hit = self.results.get(key)
        if hit is not None:
            self._count("cache_hits")
        elif count_miss:
            self._count("cache_misses")
        hits = self._counters["cache_hits"].value
        total = hits + self._counters["cache_misses"].value
        self._cache_hit_ratio.set(hits / total if total else 0.0)
        return hit

    def _intake(self, request: Request, bound_queue: bool = True) -> None:
        """Queue the request; under QoS (and ``bound_queue``), past
        ``max_queued`` the oldest queued request is shed; then pump."""
        tp = self.tenant_plane
        request.trace.event("enqueue", queue_depth=len(tp))
        tp.enqueue(request)
        if bound_queue and self.qos.enabled:
            bound = self.qos.max_queued
            if self.adapt_plane is not None:
                # The congestion depth: the tighter of the static bound
                # and the measured service rate times the age knee.
                bound = self.adapt_plane.effective_max_queued(bound)
            while bound > 0 and len(tp) > bound:
                self._shed(tp.pop_head(), "overload")
        self._maybe_dispatch()

    def _shed(self, req: Request, reason: str) -> None:
        self.tenant_plane.shed(req, reason)
        self._log_counts()

    def _on_join(self, conn_id: int, msg: Optional[Message] = None) -> None:
        """``msg.rate`` is the miner's rate hint (0: none). A repeat JOIN
        from a conn already in the roster (under ``DBMT_GATEWAY``) is a
        GatewayMiner's rate-hint refresh: the entry is updated in place
        (:meth:`MinerPlane.refresh_rate_hint`), never duplicated, since a
        second entry would be capacity the stripe planner counts forever
        and no conn serves."""
        if self._owner is not None:
            self._owner.assert_here()
        rate_hint = float(msg.rate) if msg is not None else 0.0
        if self._gateway:
            miner = self.miner_plane.find_miner(conn_id)
            if miner is not None:
                self.miner_plane.refresh_rate_hint(miner, rate_hint)
                logger.info("miner %d refreshed rate hint %.3g nonces/s",
                            conn_id, rate_hint)
                self._maybe_dispatch()
                return
        self.miner_plane.on_join(conn_id, rate_hint=rate_hint)
        if rate_hint > 0:
            logger.info("miner %d joined with rate hint %.3g nonces/s",
                        conn_id, rate_hint)
        else:
            logger.info("miner %d joined", conn_id)
        self._maybe_dispatch()

    def _on_result(self, conn_id: int, msg: Message) -> None:
        if self._owner is not None:
            self._owner.assert_here()
        popped = self.miner_plane.pop_result(conn_id)
        if popped is None:
            return
        miner, chunk = popped
        if self._audits:
            rec = self._audits.pop(chunk.job_id, None)
            if rec is not None:
                self._on_audit_result(rec, miner, chunk, msg)
                return
        curr = self._inflight.get(chunk.job_id)
        if self.adapt_plane is not None:
            # The chunk-size signal: the lease stamps and the span; only
            # chunked-mode grants were sized by the controlled value.
            service_s, margin = self.miner_plane.service_sample(chunk)
            self.adapt_plane.observe_chunk(
                service_s, margin, span=msg.span,
                sized=curr is not None and curr.qos_mode == "chunked",
                miner=conn_id)
        if curr is None:
            # Stale Result of a retired request (a late span names what
            # stalled); under QoS it freed a slot.
            stale = self.tenant_plane.traces.get(chunk.job_id)
            if stale is not None:
                stale.event("stale_result", miner=conn_id, idx=chunk.idx)
                self._fold_span(stale, conn_id, chunk, msg.span)
            if self.qos.enabled:
                self._maybe_dispatch()
            return
        if curr.answered[chunk.idx]:
            # The loser of a re-issue race: the copy scanned the same
            # range and has merged already.
            self._count("dup_results")
            self._fold_span(curr.trace, conn_id, chunk, msg.span)
            curr.trace.event("result", miner=conn_id, idx=chunk.idx,
                             duplicate=True)
            logger.info("duplicate Result for job %d chunk %d from miner %d "
                        "(speculation loser)", curr.job_id, chunk.idx,
                        conn_id)
            if self.qos.enabled:
                self._maybe_dispatch()
            return
        if self.verify.enabled and not self._claim_ok(curr, chunk, miner,
                                                      msg):
            return
        if msg.hash < curr.min_hash:
            curr.min_hash = msg.hash
            curr.min_nonce = msg.nonce
        curr.answered[chunk.idx] = True
        if self.qos.enabled:
            self.qos_plane.on_chunk_answered(curr.conn_id)
        self._fold_span(curr.trace, conn_id, chunk, msg.span)
        curr.trace.event("result", miner=conn_id, idx=chunk.idx)
        curr.trace.event("merge", idx=chunk.idx,
                         answered=sum(curr.answered))
        if self.verify.audit_p > 0 and not curr.target:
            self._maybe_audit(curr, chunk, miner, msg)
        if curr.target and msg.target != curr.target and not curr.weak:
            curr.weak = True
            logger.info(
                "difficulty request %d: miner %d answered without the "
                "target extension; the merged result is guaranteed "
                "qualifying, not guaranteed globally first",
                curr.job_id, miner.conn_id)
        if curr.target and msg.hash < curr.target:
            curr.chunk_q[chunk.idx] = (msg.nonce, msg.hash)
        # Prefix release (difficulty only): the lowest-index qualifying
        # chunk is final once every earlier chunk has answered clean —
        # later chunks cover strictly higher nonces and cannot beat it.
        if curr.chunk_q:
            c = min(curr.chunk_q)
            if all(curr.answered[:c]):
                nonce, q_hash = curr.chunk_q[c]
                self._finish(curr, q_hash, nonce, early=True)
                return
        if curr.answered and all(curr.answered) and not curr.audit_holds:
            # Full barrier: an arg-min request, or a target missed
            # everywhere (the exact arg-min). Outstanding audits hold it;
            # the last one to resolve finishes the request.
            self._finish(curr, curr.min_hash, curr.min_nonce)
        elif self.qos.enabled:
            # The answering miner freed a slot: grant the next chunk.
            self._maybe_dispatch()

    def _on_drop(self, conn_id: int) -> None:
        if self._owner is not None:
            self._owner.assert_here()
        miner = self.miner_plane.drop_miner(conn_id)
        if miner is not None:
            logger.info("miner %d dropped", conn_id)
            if self._audits:
                # A dead auditor's audits hold their requests' replies:
                # audit the windows again elsewhere, or release them.
                for c in miner.pending:
                    rec = self._audits.pop(c.job_id, None)
                    if rec is not None:
                        self._reaudit_or_release(rec)
            if self.adapt_plane is not None:
                self.adapt_plane.forget_miner(conn_id)
            self.tenant_plane.retire_miner_track(conn_id)
            _tracing.flight("miner_drop", miner=conn_id)
            if self._inflight:
                for req in self._inflight.values():
                    req.trace.event("miner_drop", miner=conn_id)
                self.miner_plane.recover(miner)
            return
        logger.info("client %d dropped", conn_id)
        purged = self.tenant_plane.purge_tenant(conn_id)
        for req in purged:
            req.trace.event("cancel", reason="client_drop")
        self.tenant_plane.retire_tenant_track(conn_id)
        if self.qos.enabled:
            self.qos_plane.forget(conn_id)
        cancelled = len(purged)
        for req in [r for r in self._inflight.values()
                    if r.conn_id == conn_id]:
            req.trace.event("cancel", reason="client_drop")
            cancelled += 1
            self._retire(req)
        if self.capture is not None and cancelled:
            self.capture.cancel(conn_id, cancelled)

    def _on_lease_event(self, kind: str, chunk: Chunk, miner_conn: int,
                        **info) -> None:
        """The miner plane's lease transitions, and the verification
        tier's verdicts, as trace events of the owning request, flight
        events and log lines (the JAX package's words)."""
        curr = self._inflight.get(chunk.job_id)
        if kind == "blown":
            if curr is not None:
                curr.trace.event("lease_blown", miner=miner_conn,
                                 idx=chunk.idx, streak=info["streak"],
                                 spurious=info.get("spurious", False))
            if self._trace_on:
                _tracing.flight("lease_blown", job=chunk.job_id,
                                idx=chunk.idx, miner=miner_conn,
                                streak=info["streak"])
            logger.warning(
                "miner %d blew the lease on job %d chunk %d "
                "[%d, %d) after %.2fs (streak %d)%s",
                miner_conn, chunk.job_id, chunk.idx,
                chunk.lower, chunk.upper, info.get("overdue_s", 0.0),
                info["streak"],
                " [spurious: miner had not reached this chunk]"
                if info.get("spurious", False) else "")
        elif kind == "quarantine":
            if curr is not None:
                curr.trace.event("quarantine", miner=miner_conn)
            logger.warning(
                "miner %d quarantined after %d consecutive "
                "blown leases; no new assignments until it "
                "answers", miner_conn, info["streak"])
        elif kind == "reissue":
            if curr is not None:
                curr.trace.event("reissue", idx=chunk.idx,
                                 from_miner=miner_conn,
                                 to_miner=info["to_miner"])
            if self._trace_on:
                _tracing.flight("reissue", job=chunk.job_id,
                                idx=chunk.idx, from_miner=miner_conn,
                                to_miner=info["to_miner"])
            if self.capture is not None:
                self.capture.reissue()
            logger.warning(
                "speculatively re-issuing job %d chunk %d [%d, %d) "
                "from miner %d to miner %d",
                chunk.job_id, chunk.idx, chunk.lower, chunk.upper,
                miner_conn, info["to_miner"])
        elif kind == "quarantine_lifted":
            logger.info("miner %d answered; quarantine lifted", miner_conn)
        elif kind == "park":
            if curr is not None:
                curr.trace.event("park", idx=chunk.idx)
        elif kind == "claim_failed":
            if curr is not None:
                curr.trace.event("claim_failed", miner=miner_conn,
                                 idx=chunk.idx, nonce=info.get("nonce"),
                                 claimed=info.get("claimed"),
                                 actual=info.get("actual"))
            if self._trace_on:
                _tracing.flight("claim_failed", job=chunk.job_id,
                                idx=chunk.idx, miner=miner_conn,
                                trust=info.get("trust"))
            logger.warning(
                "miner %d FAILED the claim check on job %d chunk %d: "
                "claimed hash %s for nonce %s, recomputed %s "
                "(trust -> %.3g)%s",
                miner_conn, chunk.job_id, chunk.idx,
                info.get("claimed"), info.get("nonce"),
                info.get("actual"), info.get("trust", 0.0),
                " [audit re-execution]" if info.get("audit") else "")
        elif kind == "audit_failed":
            job = info.get("job", chunk.job_id)
            trace = self.tenant_plane.traces.get(job)
            if trace is not None:
                trace.event("audit_failed", miner=miner_conn,
                            idx=info.get("idx"),
                            lower=chunk.lower, upper=chunk.upper)
            if self._trace_on:
                _tracing.flight("audit_failed", job=job,
                                idx=info.get("idx"), miner=miner_conn,
                                auditor=info.get("auditor"),
                                trust=info.get("trust"))
            logger.warning(
                "miner %d FAILED an audit on job %s chunk %s: claimed "
                "argmin hash %s, but auditor %s found %s at nonce %s "
                "inside [%d, %d] (trust -> %s)",
                miner_conn, info.get("job", chunk.job_id), info.get("idx"),
                info.get("claimed"), info.get("auditor"), info.get("found"),
                info.get("found_nonce"), chunk.lower, chunk.upper,
                info.get("trust"))

    # ----------------------------------------------------- verification

    def _claim_ok(self, curr: Request, chunk: Chunk, miner: MinerState,
                  msg: Message) -> bool:
        """Claim check: the nonce lies in the chunk (``Upper`` read
        inclusive), the hash equals the host recompute, and a difficulty
        claim entering the qualifying set satisfies the target bound on
        the RECOMPUTED hash (never the claimed one). A failed claim decays
        the miner's trust and leaves ``answered[idx]`` False; unless a
        re-issued copy is in flight, the range goes to another eligible
        miner, or parks; then the queue is pumped (the liar's popped chunk
        freed a slot)."""
        self._count("claims_checked")
        actual = hash_op(curr.data, msg.nonce)
        if chunk.lower <= msg.nonce <= chunk.upper \
                and actual == msg.hash \
                and not (curr.target and msg.hash < curr.target
                         and not actual < curr.target):
            return True
        self._count("claims_failed")
        mp = self.miner_plane
        trust = mp.trust_fail(miner, "claim")
        self._on_lease_event("claim_failed", chunk, miner.conn_id,
                             nonce=msg.nonce, claimed=msg.hash,
                             actual=actual, trust=trust)
        if not chunk.reissued:
            copy = Chunk(chunk.job_id, chunk.data, chunk.lower, chunk.upper,
                         target=chunk.target, idx=chunk.idx)
            takeover = next((m for m in mp.eligible() if m is not miner),
                            None)
            if takeover is not None:
                mp.assign_chunk(takeover, copy, kind="claim_retry")
            else:
                mp.parked.append(copy)
                self._on_lease_event("park", copy, miner.conn_id)
        self._maybe_dispatch()
        return False

    def _maybe_audit(self, curr: Request, chunk: Chunk, miner: MinerState,
                     msg: Message) -> None:
        """With probability ``audit_p``, audit a random subwindow (at most
        ``audit_max_nonces``) of the chunk just merged on a disjoint miner
        and hold the request's reply. No auditor, no audit."""
        v = self.verify
        if self._audit_rng.random() >= v.audit_p:
            return
        auditor = self.miner_plane.pick_auditor(miner.conn_id)
        if auditor is None:
            return
        span = min(v.audit_max_nonces, chunk.size)
        lo = chunk.lower + self._audit_rng.randrange(chunk.size - span + 1)
        self._issue_audit(AuditRecord(
            job_id=chunk.job_id, idx=chunk.idx, suspect=miner.conn_id,
            auditor=auditor.conn_id, lower=lo, upper=lo + span - 1,
            claimed_hash=msg.hash, claimed_nonce=msg.nonce),
            curr.data, auditor)
        curr.audit_holds += 1

    def _issue_audit(self, rec: AuditRecord, data: str,
                     auditor: MinerState) -> None:
        """Grant one audit window to ``auditor`` under a fresh job id,
        expiring after its lease times the chunks ahead of it plus one.
        The caller owns the hold."""
        self._next_job_id += 1
        aid = self._next_job_id
        ac = Chunk(aid, data, rec.lower, rec.upper)
        rec.auditor = auditor.conn_id
        rec.deadline = time.monotonic() + \
            self.miner_plane.lease_for(auditor, ac) \
            * (1 + len(auditor.pending))
        self._audits[aid] = rec
        self._count("audits_issued")
        trace = self.tenant_plane.traces.get(rec.job_id)
        if trace is not None:
            trace.event("audit", idx=rec.idx, auditor=auditor.conn_id,
                        lower=rec.lower, upper=rec.upper)
        if self._trace_on:
            _tracing.flight("audit", job=rec.job_id, idx=rec.idx,
                            suspect=rec.suspect, auditor=auditor.conn_id)
        self.miner_plane.assign_chunk(auditor, ac, kind="audit")

    def _resolve_audit(self, rec: AuditRecord) -> None:
        """Release one hold of the audited request (whatever the verdict)
        and finish it if nothing else holds it."""
        curr = self._inflight.get(rec.job_id)
        if curr is None:
            return
        if curr.audit_holds:
            curr.audit_holds -= 1
        if not curr.audit_holds and curr.answered and all(curr.answered):
            self._finish(curr, curr.min_hash, curr.min_nonce)

    def _reaudit_or_release(self, rec: AuditRecord) -> None:
        """An audit lost its auditor (drop, expiry, or conviction):
        re-issue the window to another disjoint miner, else count it
        inconclusive and release the hold."""
        curr = self._inflight.get(rec.job_id)
        if curr is None:
            return
        auditor = self.miner_plane.pick_auditor(rec.suspect, rec.auditor)
        if auditor is not None:
            self._issue_audit(rec, curr.data, auditor)
            return
        self._count("audits_inconclusive")
        self._resolve_audit(rec)

    def _expire_audits(self) -> None:
        now = time.monotonic()
        for aid, rec in [(a, r) for a, r in self._audits.items()
                         if now >= r.deadline]:
            del self._audits[aid]
            logger.warning(
                "audit of job %d chunk %d expired on auditor %d; "
                "re-issuing", rec.job_id, rec.idx, rec.auditor)
            self._reaudit_or_release(rec)

    def _on_audit_result(self, rec: AuditRecord, miner: MinerState,
                         chunk: Chunk, msg: Message) -> None:
        """Cross-check an audit Result against the audited claim. The
        auditor's Result is claim-checked first (a lying auditor is
        convicted and the window audited again). Then a better real hash
        inside the window convicts the suspect (it claimed the whole
        chunk's minimum) and merges into the held request; an auditor
        that misses a claimed winner lying inside its window is convicted
        and the window audited again; else the audit passes."""
        mp = self.miner_plane
        curr = self._inflight.get(rec.job_id)
        self._count("claims_checked")
        actual = hash_op(chunk.data, msg.nonce)
        if msg.nonce < rec.lower or msg.nonce > rec.upper \
                or actual != msg.hash:
            self._count("claims_failed")
            trust = mp.trust_fail(miner, "claim")
            self._on_lease_event("claim_failed", chunk, miner.conn_id,
                                 nonce=msg.nonce, claimed=msg.hash,
                                 actual=actual, trust=trust, audit=True)
            self._reaudit_or_release(rec)
            self._maybe_dispatch()
            return
        if msg.hash < rec.claimed_hash:
            self._count("audits_failed")
            suspect = mp.find_miner(rec.suspect)
            trust = (mp.trust_fail(suspect, "audit")
                     if suspect is not None else None)
            self._on_lease_event("audit_failed", chunk, rec.suspect,
                                 job=rec.job_id, idx=rec.idx,
                                 claimed=rec.claimed_hash,
                                 found=msg.hash, found_nonce=msg.nonce,
                                 auditor=miner.conn_id, trust=trust)
            if curr is not None and msg.hash < curr.min_hash:
                curr.min_hash = msg.hash
                curr.min_nonce = msg.nonce
                curr.trace.event("merge", idx=rec.idx, audit_repair=True)
        elif rec.lower <= rec.claimed_nonce <= rec.upper \
                and msg.hash != rec.claimed_hash:
            trust = mp.trust_fail(miner, "audit")
            self._on_lease_event("audit_failed", chunk, miner.conn_id,
                                 job=rec.job_id, idx=rec.idx,
                                 claimed=rec.claimed_hash,
                                 found=msg.hash, found_nonce=msg.nonce,
                                 auditor=miner.conn_id, trust=trust)
            self._reaudit_or_release(rec)
            self._maybe_dispatch()
            return
        else:
            self._count("audits_passed")
            trace = self.tenant_plane.traces.get(rec.job_id)
            if trace is not None:
                trace.event("audit_passed", idx=rec.idx,
                            auditor=miner.conn_id)
        self._resolve_audit(rec)
        self._maybe_dispatch()

    # --------------------------------------------------------------- dispatch

    def _finish(self, curr: Request, h: int, nonce: int,
                early: bool = False) -> None:
        """Answer the client and retire the request. ``early`` = prefix
        release: the job's other chunks are still in flight."""
        self._write(curr.conn_id, new_result(h, nonce))
        self._count("results_sent")
        if self.results is not None and curr.cache_key is not None \
                and not curr.weak:
            # A weak merge's answer is a qualifying nonce, not a function
            # of the key.
            self.results.put(curr.cache_key, (h, nonce))
            self._count("cache_stores")
        elapsed = time.monotonic() - curr.started
        if self.capture is not None:
            # Arrival to reply (a replay measures submit to reply).
            self.capture.reply(curr.conn_id,
                               time.monotonic() - curr.queued_at)
        curr.trace.event("reply", hash=h, nonce=nonce, early=early,
                         weak=curr.weak, elapsed_s=round(elapsed, 6))
        if self._trace_on:
            _tracing.flight("reply", job=curr.job_id, tenant=curr.conn_id,
                            elapsed_s=round(elapsed, 6))
        logger.info("request %d served in %.3fs: [%d, %d) over %d chunks%s%s",
                    curr.job_id, elapsed,
                    curr.lower, curr.upper, curr.num_chunks,
                    " (prefix release)" if early else "",
                    " (weak merge)" if curr.weak else "")
        self._log_counts()
        self._retire(curr)

    def _retire(self, curr: Request) -> None:
        """Retire an in-flight request: its pending chunks are marked
        cancelled (their late Results pop as stale), its parked chunks
        are dropped, under QoS its tenant's granted-unanswered slots are
        released (ungranted chunks simply evaporate), and the queue is
        pumped."""
        self.miner_plane.cancel_job(curr.job_id)
        if self._inflight.pop(curr.job_id, None) is not None:
            if curr.qos_mode == "chunked":
                self._chunked_inflight -= 1
            n = self._tenant_inflight.get(curr.conn_id, 0)
            if n <= 1:
                self._tenant_inflight.pop(curr.conn_id, None)
            else:
                self._tenant_inflight[curr.conn_id] = n - 1
            d = self._qos_chunked_reqs.get(curr.conn_id)
            if d is not None:
                d.pop(curr.job_id, None)
                if not d:
                    del self._qos_chunked_reqs[curr.conn_id]
        if self.qos.enabled:
            self.qos_plane.release(
                curr.conn_id, curr.granted_chunks - sum(curr.answered))
        if not self._inflight:
            self.miner_plane.clear_lease_gauges()
        self._maybe_dispatch()

    def _maybe_dispatch(self) -> None:
        """Start queued work when the pool can take it: the stock FIFO
        pump, or the QoS grant pump (lazy or eager). Re-entrancy guard:
        an empty-range request finishes inside its own dispatch, and the
        outer pump loop then drains the queue iteratively. Queued work
        with nothing in flight and no eligible miner logs once per
        starvation episode."""
        if self._dispatching:
            return
        self._dispatching = True
        try:
            if not self.qos.enabled:
                self._fifo_pump()
            elif self.qos.lazy:
                self._qos_pump_lazy()
            else:
                self._qos_pump()
        finally:
            self._dispatching = False
        if not self._inflight and len(self.tenant_plane) \
                and not self.miner_plane.eligible():
            if not self._starved:
                self._starved = True
                self._count("no_eligible_miner")
                miners = self.miner_plane.miners
                logger.warning(
                    "no eligible miner for %d queued request(s): pool=%d "
                    "quarantined=%d busy=%d — queue is stalled until a "
                    "miner joins, frees, or answers",
                    len(self.tenant_plane), len(miners),
                    sum(1 for m in miners if m.quarantined),
                    sum(1 for m in miners
                        if not m.available and not m.quarantined))
        elif not len(self.tenant_plane):
            self._starved = False

    def _fifo_pump(self) -> None:
        """Pop the queue head whenever nothing is in flight; a wholly
        quarantined or distrusted pool serves through desperation."""
        while not self._inflight and len(self.tenant_plane):
            pool = self.miner_plane.eligible()
            desperate = False
            if not pool:
                pool = self.miner_plane.desperation_pool()
                if not pool:
                    break
                desperate = True
            req = self.tenant_plane.pop_head()
            if self._replay_at_dispatch(req):
                continue
            self._load_balance(req, pool, desperate=desperate)
            self._starved = False

    def _replay_at_dispatch(self, req: Request) -> bool:
        """A duplicate that queued behind its original is answered from
        the cache when it reaches dispatch. True = answered (the caller
        drops it)."""
        if self.results is None or req.cache_key is None:
            return False
        hit = self._cache_lookup(req.cache_key, count_miss=False)
        if hit is None:
            return False
        self._write(req.conn_id, new_result(*hit))
        self._count("results_sent")
        if self.capture is not None:
            self.capture.reply(req.conn_id,
                               time.monotonic() - req.queued_at,
                               cached=True)
        self._queue_wait.observe(time.monotonic() - req.queued_at)
        req.trace.event("cache_hit", at="dispatch")
        req.trace.event("reply", hash=hit[0], nonce=hit[1], cached=True)
        self.tenant_plane.register_replay(req)
        logger.info("queued request %r [%d, %d] answered from the result "
                    "cache at dispatch", req.data, req.lower, req.upper)
        self._log_counts()
        return True

    def _start(self, req: Request, mode: str, pool: list,
               desperate: bool = False) -> None:
        """Put a dequeued request in flight under a fresh job id: its
        queue wait to the adapt plane, its trace registered by job id
        with a ``dispatch`` event naming ``pool``."""
        self._next_job_id += 1
        req.job_id = self._next_job_id
        req.qos_mode = mode
        req.started = time.monotonic()
        self._queue_wait.observe(req.started - req.queued_at)
        if self.adapt_plane is not None:
            self.adapt_plane.observe_wait(req.started - req.queued_at)
        self.tenant_plane.traces.register(req.job_id, req.trace)
        if not req.trace.null:
            self.tenant_plane.track_tenant(req.conn_id)
        self._inflight[req.job_id] = req
        self._tenant_inflight[req.conn_id] = \
            self._tenant_inflight.get(req.conn_id, 0) + 1
        req.upper += 1  # inclusive -> exclusive
        miners = [m.conn_id for m in pool]
        if mode == "chunked":
            req.trace.event("dispatch", job=req.job_id, mode="chunked",
                            miners=miners)
        else:
            req.trace.event("dispatch", job=req.job_id, miners=miners,
                            desperate=desperate)
        if self._trace_on:
            _tracing.flight("dispatch", job=req.job_id, mode=mode,
                            tenant=req.conn_id)

    def _load_balance(self, request: Request, pool: list[MinerState],
                      desperate: bool = False) -> None:
        """Wholesale dispatch: split the range evenly over ``pool`` (the
        eligible miners, or the one-miner desperation pool), each share
        striped (:meth:`MinerPlane.stripe_chunks`)."""
        mp = self.miner_plane
        self._start(request, "wholesale", pool, desperate)
        if desperate:
            self._count("desperation_dispatch")
            m = pool[0]
            logger.warning(
                "DESPERATION dispatch: entire pool (%d miner(s)) is "
                "quarantined; assigning request %r [%d, %d] to least-bad "
                "miner %d (blown streak %d, rate %s) as a last resort",
                len(mp.miners), request.data, request.lower,
                request.upper - 1, m.conn_id, m.blown_streak,
                f"{m.rate_ewma:.0f}/s" if m.rate_ewma else "unknown")
        num = len(pool)
        total = request.upper - request.lower
        if total <= 0:
            # Empty/inverted range: answer like an empty scan.
            self._finish(request, MAX_U64, 0)
            return
        individual = total // num
        leftover = total - individual * num
        if individual == 0:  # more miners than nonces
            individual, leftover, num = 1, 0, total
        # The whole plan first: chunk indices ascend with the nonces
        # across miners (the prefix release reads them in that order).
        plan: list[tuple[MinerState, int, int]] = []
        start = request.lower
        for i in range(num):
            end = start + individual + (leftover if i == 0 else 0)
            share = end - start
            n_i = mp.stripe_chunks(pool[i], share)
            mp.observe_stripe(n_i)
            base = start
            for j in range(n_i):
                size = share // n_i + (1 if j < share % n_i else 0)
                plan.append((pool[i], base, base + size))
                base += size
            start = end
        if len(plan) > num:
            self._count("chunks_striped", len(plan) - num)
        request.num_chunks = request.granted_chunks = len(plan)
        request.answered = [False] * len(plan)
        if self.qos.enabled:
            # Wholesale chunks count against the tenant's share like
            # granted ones, so later contended rounds stay fair.
            self.tenant_plane.tenant(request.conn_id)
            for _, lo, up in plan:
                self.qos_plane.on_grant(request.conn_id, up - lo)
        for idx, (miner, lo, up) in enumerate(plan):
            mp.assign_chunk(miner, Chunk(request.job_id, request.data, lo,
                                         up, target=request.target,
                                         idx=idx))

    # ------------------------------------------------------------ QoS plane

    @staticmethod
    def _qos_is_small(total: int, cold: bool, bound: float) -> bool:
        """THE wholesale-smallness predicate, shared by head pricing, pump
        candidacy and the dispatch decision: empty ranges and cold pools
        are small; otherwise one comparison against the hoisted bound."""
        return total <= 0 or cold or total <= bound

    def _qos_small_bound(self):
        """``(cold, bound_nonces)``: the pool is cold until a throughput
        sample exists; otherwise a request is small when it fits
        ``wholesale_s`` at the pool rate times the miners it would use."""
        mp = self.miner_plane
        rate = mp.pool_rate
        if rate is None or rate <= 0:
            return True, 0.0
        n = max(1, len(mp.eligible()) or len(mp.miners) or 1)
        return False, self.qos.wholesale_s * rate * n

    def _qos_chunk_plan(self, total: int, pool_n: int) -> tuple[int, int]:
        """``(n_chunks, first_chunk_size)`` for a chunked activation of
        ``total`` nonces: chunks of ``chunk_s`` seconds at the pool rate,
        at most ``max_chunks``; an even split over ``pool_n`` when cold.
        Shared by the activation and the DRR head cost, which must agree."""
        rate = self.miner_plane.pool_rate or 0.0
        if rate > 0:
            n = -(-total // max(1, int(rate * self.qos.chunk_s)))
        else:
            n = max(1, pool_n)
        n = max(1, min(self.qos.max_chunks, n, total))
        return n, total // n + (1 if total % n else 0)

    def _qos_heads(self) -> dict:
        """Each tenant's next grantable item: ``{tenant: (kind, request,
        cost_nonces)}``. ``"chunk"``: the next ungranted chunk of the
        tenant's oldest chunked in-flight request. ``"start"``: the
        tenant's oldest queued request (tenants serve their own requests
        FIFO), withheld while a WHOLESALE request is in flight (the stock
        one-at-a-time order) or while the tenant has a request in flight.
        Tenants at their ``max_inflight`` cap are skipped."""
        heads: dict = {}
        cap = self.qos.max_inflight
        tenants = self.qos_plane.tenants
        for req in self._inflight.values():     # oldest first
            if req.qos_mode != "chunked" or req.next_chunk >= req.num_chunks:
                continue
            t = req.conn_id
            if t in heads:
                continue
            if cap > 0 and self.qos_plane.tenant(t).inflight >= cap:
                continue
            lo, up = req.chunk_bounds[req.next_chunk]
            heads[t] = ("chunk", req, up - lo)
        if self._inflight and not self._chunked_inflight:
            return heads        # wholesale in flight: stock FIFO wait
        cold, small_bound = self._qos_small_bound()
        none_inflight = not self._inflight
        pool_n = len(self.miner_plane.miners) or 1
        busy = {r.conn_id for r in self._inflight.values()}
        for t, req in self.tenant_plane.tenant_heads():
            if t in heads or t in busy:
                continue
            st = tenants.get(t)
            if cap > 0 and st is not None and st.inflight >= cap:
                continue
            # The cost is what granting it will debit: the whole range
            # for a wholesale start, the first planned chunk for a
            # chunked one.
            total = req.upper - req.lower + 1
            if none_inflight and self._qos_is_small(total, cold,
                                                    small_bound):
                cost = max(1, total)
            else:
                _, cost = self._qos_chunk_plan(max(1, total), pool_n)
            heads[t] = ("start", req, cost)
        return heads

    def _qos_pump(self) -> None:
        """The QoS grant loop: while grantable work and capacity exist,
        pick the next tenant by DRR and execute ONE grant — a chunk, a
        chunked activation, or a stock wholesale dispatch (through
        desperation when the whole pool is quarantined or distrusted).

        The pass carries a coalescing-window map (miner conn id ->
        ``[coalesce_id, lanes_used, {job_ids}]``): a small grant may land
        in an open window even when the capacity pool is empty (the
        window counts as one live slot however many lanes it holds),
        which is what batches several tenants' mice onto one miner in one
        pass. Windows live for ONE pass."""
        mp = self.miner_plane
        if self._inflight and not self._chunked_inflight:
            return      # wholesale in flight: no start may flow
        if not len(self.tenant_plane) and not self._chunked_inflight:
            return
        backlogged = list(dict.fromkeys(
            self.tenant_plane.backlog_tenants()
            + [r.conn_id for r in self._inflight.values()
               if r.qos_mode == "chunked" and r.next_chunk < r.num_chunks]))
        self.qos_plane.sync_backlog(backlogged)
        if not backlogged:
            return
        if not mp.capacity_pool(self.qos.depth) and \
                (self._inflight or not (mp.eligible()
                                        or mp.desperation_pool())):
            return     # saturated: nothing grantable this event
        window: dict = {}
        while True:
            heads = self._qos_heads()
            if not heads:
                break
            cap_pool = mp.capacity_pool(self.qos.depth)
            cold, small_bound = self._qos_small_bound()
            none_inflight = not self._inflight
            can_start = bool(mp.eligible()) or bool(mp.desperation_pool())
            candidates = {}
            for t, (kind, req, cost) in heads.items():
                joinable = (mp.window_room(window, req.job_id)
                            and mp.coalescible_cost(req.target, cost))
                if kind == "start" and none_inflight and self._qos_is_small(
                        req.upper - req.lower + 1, cold, small_bound):
                    if can_start:      # wholesale: the stock eligibility
                        candidates[t] = cost
                elif cap_pool or joinable:
                    candidates[t] = cost
            if not candidates:
                break
            kind, req, cost = heads[self.qos_plane.pick(candidates)]
            if kind == "chunk":
                self._qos_grant(req, cap_pool, window)
                continue
            self.tenant_plane.dequeue(req)
            if self._replay_at_dispatch(req):
                continue
            self._qos_dispatch(req, cap_pool, window, cold, small_bound)

    def _qos_dispatch(self, req: Request, cap_pool: list, window: dict,
                      cold: bool, small_bound: float) -> None:
        """A dequeued start: wholesale (through desperation when the whole
        pool is quarantined or distrusted) when nothing is in flight and
        it is small, by the same predicate that priced it; else chunked."""
        mp = self.miner_plane
        if not self._inflight and self._qos_is_small(
                req.upper - req.lower + 1, cold, small_bound):
            pool, desperate = mp.eligible(), False
            if not pool:
                pool, desperate = mp.desperation_pool(), True
            self._load_balance(req, pool, desperate=desperate)
        else:
            self._qos_activate(req, cap_pool, window)
        self._starved = False

    def _qos_pump_lazy(self) -> None:
        """The lazy QoS grant loop: the grants of :meth:`_qos_pump`
        (chunk heads, starts, the wholesale or chunked dispatch, windows,
        DRR), but the DRR ring itself is walked (:meth:`QosPlane.
        pick_lazy`) and each visited tenant's head is priced on demand
        from ``_qos_chunked_reqs`` and the tenant's queue head. Ring
        entry comes at the edges (the enqueue hook, a chunked
        activation); a tenant with no backlog leaves on the walk. The
        grant order may differ from the eager pump's; its guarantees do
        not."""
        mp = self.miner_plane
        tp = self.tenant_plane
        if self._inflight and not self._chunked_inflight:
            return
        if not len(tp) and not self._chunked_inflight:
            return
        if not mp.capacity_pool(self.qos.depth) and \
                (self._inflight or not (mp.eligible()
                                        or mp.desperation_pool())):
            return     # saturated: nothing grantable this event
        window: dict = {}
        cap = self.qos.max_inflight
        tenants = self.qos_plane.tenants
        while True:
            # A wholesale dispatch of this pass withholds further starts.
            if self._inflight and not self._chunked_inflight:
                break
            cap_pool = mp.capacity_pool(self.qos.depth)
            cold, small_bound = self._qos_small_bound()
            none_inflight = not self._inflight
            can_start = bool(mp.eligible()) or bool(mp.desperation_pool())
            pool_n = len(mp.miners) or 1
            heads: dict = {}     # the tenants priced by this pick's walk

            def head_for(tenant):
                # The chunk head: the tenant's oldest chunked in-flight
                # request with ungranted chunks (retired or exhausted
                # entries pruned as they surface).
                reqs = self._qos_chunked_reqs.get(tenant)
                creq = None
                while reqs:
                    cand = next(iter(reqs.values()))
                    if cand.job_id not in self._inflight or \
                            cand.next_chunk >= cand.num_chunks:
                        reqs.pop(cand.job_id, None)
                        if not reqs:
                            self._qos_chunked_reqs.pop(tenant, None)
                        continue
                    creq = cand
                    break
                st = tenants.get(tenant)
                at_cap = cap > 0 and st is not None and st.inflight >= cap
                if creq is not None:
                    if at_cap:
                        return None
                    lo, up = creq.chunk_bounds[creq.next_chunk]
                    cost = up - lo
                    joinable = (mp.window_room(window, creq.job_id)
                                and mp.coalescible_cost(creq.target, cost))
                    if not (cap_pool or joinable):
                        return None
                    heads[tenant] = ("chunk", creq, cost)
                    return cost
                # The start head: the tenant's oldest queued request.
                sreq = tp.tenant_head(tenant)
                if sreq is None:
                    return LAZY_REMOVE
                if self._tenant_inflight.get(tenant) or at_cap:
                    return None
                total = sreq.upper - sreq.lower + 1
                if none_inflight and self._qos_is_small(total, cold,
                                                        small_bound):
                    if not can_start:
                        return None
                    cost = max(1, total)
                else:
                    _, cost = self._qos_chunk_plan(max(1, total), pool_n)
                    joinable = (mp.window_room(window, sreq.job_id)
                                and mp.coalescible_cost(sreq.target, cost))
                    if not (cap_pool or joinable):
                        return None
                heads[tenant] = ("start", sreq, cost)
                return cost

            t = self.qos_plane.pick_lazy(head_for)
            if t is None:
                break
            kind, req, _cost = heads[t]
            if kind == "chunk":
                self._qos_grant(req, cap_pool, window)
                if req.next_chunk >= req.num_chunks:
                    d = self._qos_chunked_reqs.get(t)
                    if d is not None:
                        d.pop(req.job_id, None)
                        if not d:
                            self._qos_chunked_reqs.pop(t, None)
                continue
            tp.dequeue(req)
            if self._replay_at_dispatch(req):
                continue
            self._qos_dispatch(req, cap_pool, window, cold, small_bound)

    def _qos_activate(self, req: Request, pool: list[MinerState],
                      window: dict) -> None:
        """Activate a request in CHUNKED mode: plan contiguous ascending
        chunks (:meth:`_qos_chunk_plan`, cold fallback over the whole
        pool) and grant the first; later pump turns grant the rest, so
        concurrent tenants' chunks interleave."""
        self._start(req, "chunked", pool)
        self._chunked_inflight += 1
        total = req.upper - req.lower
        if total <= 0:
            self._finish(req, MAX_U64, 0)
            return
        n, _ = self._qos_chunk_plan(total, len(self.miner_plane.miners) or 1)
        size, rem = divmod(total, n)
        logger.info("request %d %r [%d, %d] chunked: %d chunks of %d "
                    "nonces at chunk_s %r, pool rate %r", req.job_id,
                    req.data, req.lower, req.upper, n, size,
                    self.qos.chunk_s, self.miner_plane.pool_rate)
        base = req.lower
        for i in range(n):
            step = size + (1 if i < rem else 0)
            req.chunk_bounds.append((base, base + step))
            base += step
        req.num_chunks = n
        req.answered = [False] * n
        self._qos_chunked_reqs.setdefault(req.conn_id, {})[req.job_id] = req
        if self.tenant_plane.lazy:
            self.qos_plane.backlog_enter(req.conn_id)
        self._qos_grant(req, pool, window)

    def _qos_grant(self, req: Request, pool: list[MinerState],
                   window: dict) -> None:
        """Hand the request's next planned chunk to a miner and account
        it with the DRR plane. A small chunk first joins an open window
        (sharing its coalesce id); else it goes to the least-loaded
        capacity miner and, still small, opens a window there for later
        grants of this pass. Large or difficulty chunks never touch
        windows."""
        mp = self.miner_plane
        idx = req.next_chunk
        lo, up = req.chunk_bounds[idx]
        miner = cid = None
        small = mp.coalescible_cost(req.target, up - lo)
        if small and window:
            miner, slot = mp.window_slot(window, req.job_id)
            if miner is not None:
                cid = slot[0]
                slot[1] += 1
                slot[2].add(req.job_id)
                self._count("qos_window_grants")
        if miner is None:
            if not pool:
                return    # window gone and no capacity: next pump turn
            miner = pool[0]
            if small and miner.conn_id not in window:
                cid = mp.open_window(window, miner, req.job_id)
        req.next_chunk += 1
        req.granted_chunks += 1
        self._count("qos_grants")
        self.qos_plane.on_grant(req.conn_id, up - lo)
        mp.assign_chunk(miner, Chunk(req.job_id, req.data, lo, up,
                                     target=req.target, idx=idx,
                                     coalesce_id=cid), kind="qos")

    # ---------------------------------------------------------------- helpers

    def _write(self, conn_id: int, msg: Message) -> None:
        try:
            self.server.write(conn_id, msg.to_json())
        except LspError:
            # The drop event for this connection is already in flight; the
            # drop handler will repair the assignment.
            logger.info("write to %d failed; awaiting drop event", conn_id)
