"""Parameter blocks of the fair-share QoS plane, striping, the result
cache, cross-request coalescing, the lease plane and the verification
tier, with the JAX package's defaults (its ``utils/config.py``
``QosParams``, ``StripeParams``, ``CacheParams``, ``CoalesceParams``,
``LeaseParams`` and ``VerifyParams``), cut to the fields the port reads.

Constructor arguments carry the settings; the server and miner CLIs read
them from the environment through the ``*_from_env`` readers (knobs
documented in the port's README), each knob the twin of a knob
of the JAX package, parsed and clamped the same way:

- :func:`qos_from_env`: ``DBMT_QOS_CHUNK_S`` (default 1.0, seconds of one
  miner's work per chunk of a chunked request), ``DBMT_QOS_MAX_CHUNKS``,
  ``DBMT_QOS_DEPTH``, ``DBMT_QOS_WHOLESALE_S`` (default 5.0: requests
  estimated below it dispatch wholesale), ``DBMT_QOS_MAX_QUEUED`` (the
  overload bound), ``DBMT_QOS_MAX_INFLIGHT``, ``DBMT_QOS_RATE`` and
  ``DBMT_QOS_BURST`` (the admission buckets; rate 0 admits everything),
  ``DBMT_QOS_WEIGHT_DEFAULT`` and ``DBMT_QOS_WEIGHTS`` (``conn:weight``
  pairs, comma-separated; malformed pairs are ignored);
- :func:`stripe_from_env`: ``DBMT_STRIPE_CHUNK_S`` (0 turns striping
  off), ``DBMT_STRIPE_DEPTH``;
- :func:`cache_from_env`: ``DBMT_CACHE`` (default 1), ``DBMT_CACHE_SIZE``;
- :func:`coalesce_from_env`: ``DBMT_COALESCE`` (default 1): 0 turns off
  the scheduler's coalescing windows and the miner's drain into one
  batched launch; ``DBMT_COALESCE_LANES`` (default 8, at least 2),
  ``DBMT_COALESCE_MAX`` (default 2^20 nonces; 0 turns coalescing off),
  ``DBMT_COALESCE_SMALL_S`` (default 0.25 s);
- :func:`adapt_from_env`: ``DBMT_ADAPT`` (default 1: the scheduler mounts
  the self-tuning controllers of ``apps.adapt``), ``DBMT_ADAPT_TICK_S``,
  ``DBMT_ADAPT_BAND``, ``DBMT_ADAPT_FORCE_S``, ``DBMT_ADAPT_RATE0``,
  ``DBMT_ADAPT_CHUNK``, ``DBMT_ADAPT_COALESCE``, ``DBMT_ADAPT_ADMIT``
  (default 0, where the JAX package's is 1: ``AdaptParams``),
  ``DBMT_ADAPT_PER_MINER`` (default 0);
- :func:`lsp_params_from_env`: the LSP ``Params`` of the server and the
  miner, ``DBMT_EPOCH_LIMIT``, ``DBMT_EPOCH_MILLIS``, ``DBMT_WINDOW`` and
  ``DBMT_MAX_BACKOFF`` (defaults: the reference's);
- :func:`pipeline_depth_from_env`: ``DBMT_PIPELINE_DEPTH`` (default 8),
  the miner's queue of received Requests;
- ``DBMT_PEEL`` (default 0, as the JAX package's peel knob): 1 runs
  every search launch of the miner with the peeled lane body;
- ``DBMT_HOIST`` (default 1, as its hoist knob): under ``DBMT_PEEL=1``,
  feed the peeled body the host hoist (K4); 0 runs it without (K3);
- ``DBMT_MESH_DEVICES`` (default: every visible CUDA device): the miner's
  mesh, a comma list of devices such as ``cuda:0,cuda:1``; a device may
  repeat (``cuda:0,cuda:0,cuda:0,cuda:0`` puts four shards on one card).
  A miner with at least two entries searches over the mesh
  (``MeshNonceSearcher``), as the JAX package's factory takes its mesh
  searcher on a box with more than one device.

- :func:`pod_from_env`: ``DBMT_COORDINATOR`` (rank 0's ``host:port``;
  unset, no pod), ``DBMT_NUM_PROCS``, ``DBMT_PROC_ID``,
  ``DBMT_POD_TIMEOUT_S`` (600), ``DBMT_POD_IDLE_TIMEOUT_S`` (0: a
  follower waits for the next job without a bound);
- :func:`capture_from_env`: ``DBMT_CAPTURE`` (default 0),
  ``DBMT_CAPTURE_PATH``, ``DBMT_CAPTURE_LINES``, ``DBMT_CAPTURE_SNAP_S``;
- :func:`replicas_from_env`: ``DBMT_REPLICAS`` (default 1);
- :func:`retry_from_env`: the client's retry plane,
  ``DBMT_RETRY_ATTEMPTS`` (3; the CLI retries only above 1 or for a
  ``ring:`` target), ``DBMT_RETRY_TIMEOUT_S``, ``DBMT_RETRY_BACKOFF_S``,
  ``DBMT_RETRY_BACKOFF_CAP_S``;
- :func:`gateway_from_env`: the federation, ``DBMT_GATEWAY`` (default 1:
  a repeat JOIN refreshes the miner's rate hint in place; 0 registers a
  new miner, and the gateway role refuses to start),
  ``DBMT_GATEWAY_HINT_S``, ``DBMT_GATEWAY_MIN_POOL``,
  ``DBMT_GATEWAY_ORPHAN_S``;
- :func:`compute_from_env`: ``DBMT_COMPUTE`` (unset: the card; ``host``
  the native C++ scan of ``ops.sha256_native``, which raises without
  ``g++``).

The server also reads the lease plane's and the verification tier's
knobs (:func:`lease_from_env`, :func:`verify_from_env`):
``DBMT_LEASE_GRACE_S``, ``DBMT_LEASE_FACTOR``, ``DBMT_LEASE_FLOOR_S``,
``DBMT_LEASE_TICK_S``, ``DBMT_LEASE_QUARANTINE``, ``DBMT_QUEUE_ALARM_S``;
``DBMT_AUDIT_P`` (default 0.02 from the environment, 0.0 in
``VerifyParams()``), ``DBMT_AUDIT_MAX``, ``DBMT_TRUST_DECAY``,
``DBMT_TRUST_RECOVER``, ``DBMT_TRUST_FLOOR``, ``DBMT_TRUST_BAR``. Their
on/off switches (``QosParams.enabled`` and ``lazy``,
``StripeParams.enabled``, ``LeaseParams.enabled``, ``fifo_aware``,
``desperation``, ``VerifyParams.enabled``) are constructor fields only.

Knobs read in other modules, each through ``utils/_env.py`` where it is
used (the lint's knob catalogue: every knob the port reads is named in
this docstring and in the package README):

- the miner's JOIN hint ``DBMT_RATE_HINT`` (0: no hint; a number of
  nonces/s, or ``probe``); the scheduler's batched receive
  ``DBMT_RECV_BATCH`` (64, :func:`recv_batch_from_env`);
- the tracing plane: ``DBMT_TRACE`` (1), ``DBMT_TRACE_SAMPLE`` (1.0),
  ``DBMT_TRACE_FLIGHT`` (512), ``DBMT_TRACE_STORM_N`` (12),
  ``DBMT_TRACE_STORM_S`` (30.0), ``DBMT_TRACE_EXPORT`` (the server's
  trace file; unset: none);
- metrics and the sanitizer: ``DBMT_METRICS_INTERVAL_S`` (30.0; 0: no
  emitter thread), ``DBMT_METRICS_MAX_SERIES`` (64),
  ``DBMT_METRICS_TRACE_CAP`` (256), ``DBMT_SANITIZE`` (0),
  ``DBMT_SANITIZE_SLOW_S`` (0.1);
- the transport: ``DBMT_TIMER_WHEEL`` (1), ``DBMT_WIRE_FAST`` (1),
  ``DBMT_MMSG`` (1), ``DBMT_MMSG_BATCH`` (32);
- the process tier and its rollup: ``DBMT_HEALTH_BEAT_S`` (0.5),
  ``DBMT_HEALTH_MISS_K`` (3), ``DBMT_PROC_CACHE`` (1), ``DBMT_ROLLUP``
  (1), ``DBMT_ROLLUP_STALE_K``; the SLOs ``DBMT_SLO_AVAIL`` (0.99),
  ``DBMT_SLO_P99_S`` (60.0), ``DBMT_SLO_SHED`` (0.25),
  ``DBMT_SLO_WINDOW_S`` (300.0), ``DBMT_SLO_BURN`` (4.0);
- capture replay: ``DBMT_REPLAY_SPEED`` (1.0);
- the transport bench: ``DBMT_BENCH_TRANSPORT_CONNS`` (32),
  ``DBMT_BENCH_TRANSPORT_INFLIGHT`` (8),
  ``DBMT_BENCH_TRANSPORT_PAYLOAD`` (128),
  ``DBMT_BENCH_TRANSPORT_SECS`` (1.0),
  ``DBMT_BENCH_TRANSPORT_WARMUP_S`` (0.3),
  ``DBMT_BENCH_TRANSPORT_ROUNDS`` (3);
- the interleaving explorer (``tools/dbmcheck.py``):
  ``DBMT_CHECK_SEEDS`` (200 random-walk seeds a scenario),
  ``DBMT_CHECK_BUDGET_S`` (75.0 s for the whole run),
  ``DBMT_CHECK_DFS`` (64 bounded-DFS schedules a scenario; 0: none),
  ``DBMT_CHECK_SCENARIOS`` (a comma list; unset: the whole catalogue),
  ``DBMT_CHECK_CAPTURE`` (the capture ``replayed_storm`` replays;
  unset: its checked-in fixture).
"""

from __future__ import annotations

import hashlib
import platform
from dataclasses import dataclass

from ._env import float_env, int_env, str_env


@dataclass(frozen=True)
class QosParams:
    """Deficit-round-robin dispatch across tenants (client connections).

    A request estimated (at the pool's throughput EWMA) to scan longer
    than ``wholesale_s``, or one that arrives while chunked work is in
    flight, is split into ``chunk_s``-second chunks (at most
    ``max_chunks``) granted one at a time; each miner holds at most
    ``depth`` live QoS chunks. Smaller requests, and every request on a
    cold pool, dispatch wholesale through the stock path, which keeps
    single-tenant traffic bit-identical to the stock FIFO scheduler.
    ``max_inflight`` caps a tenant's granted-unanswered chunks (0 = no
    cap); ``weights`` maps tenant id strings to DRR weights, the others
    get ``default_weight``. Admission: a token bucket per tenant of
    ``burst`` tokens refilled at ``rate`` a second (0 = no admission
    control) sheds a request that finds it empty; with more than
    ``max_queued`` requests queued (0 = no bound) the oldest is shed.
    ``lazy`` picks the lazy grant pump (the DRR ring walked, each
    tenant's head priced on demand) over the eager one. The JAX package
    defaults to the lazy pump; the port keeps the eager one, which
    serves mice beside an elephant sooner (the lazy pump's quantum
    keeps the largest cost priced since its ring last drained).
    """
    enabled: bool = True
    chunk_s: float = 1.0
    max_chunks: int = 4096
    depth: int = 2
    wholesale_s: float = 5.0
    max_queued: int = 1024         # queued bound (0 = unbounded)
    max_inflight: int = 256
    rate: float = 0.0              # admission tokens a second (0 = off)
    burst: float = 8.0             # admission bucket capacity
    default_weight: float = 1.0
    weights: tuple = ()            # ((tenant_id_str, weight), ...)
    lazy: bool = False             # the lazy grant pump

    def __post_init__(self):
        # chunk_s <= 0 pins the wholesale path (the 0-disables convention).
        if self.chunk_s <= 0:
            object.__setattr__(self, "wholesale_s", float("inf"))

    def weight_for(self, tenant) -> float:
        for key, w in self.weights:
            if key == str(tenant):
                return max(w, 1e-3)
        return max(self.default_weight, 1e-3)


@dataclass(frozen=True)
class CoalesceParams:
    """Cross-request batched dispatch.

    Scheduler side: within one QoS pump pass, small argmin chunks of
    different requests may be granted into one miner's coalescing window
    (up to ``lanes`` chunks), which counts as ONE live chunk against the
    QoS depth. Miner side: the pipelined miner drains up to ``lanes``
    queued small argmin chunks (at most ``max_nonces`` each) into one
    batched launch. A chunk is small when it holds at most ``max_nonces``
    nonces and, on a warm pool, at most ``small_s`` seconds of work.
    ``enabled=False`` (or ``max_nonces``/``small_s`` <= 0) is the stock
    one-chunk-one-launch path.
    """
    enabled: bool = True
    lanes: int = 8
    max_nonces: int = 1 << 20
    small_s: float = 0.25

    def __post_init__(self):
        if self.max_nonces <= 0 or self.small_s <= 0:
            object.__setattr__(self, "enabled", False)


@dataclass(frozen=True)
class StripeParams:
    """Request striping: each miner's even-split share of a wholesale
    request is cut into up to ``depth`` contiguous chunks of ``chunk_s``
    seconds of work at that miner's throughput EWMA (the pool's when it
    has none), so its pending FIFO keeps the pipelined miner busy. A cold
    rate gives one chunk a miner (the stock split); ``enabled=False``
    always does. Chunk indices still ascend with the nonce range.
    """
    enabled: bool = True
    chunk_s: float = 1.0
    depth: int = 8

    def __post_init__(self):
        # chunk_s <= 0 disables striping (the 0-disables convention).
        if self.chunk_s <= 0:
            object.__setattr__(self, "enabled", False)


@dataclass(frozen=True)
class CacheParams:
    """The scheduler's result cache: an LRU of ``size`` answers keyed on
    ``(data, lower, upper, target)``; a repeated request is answered
    from it without touching the pool. Weak difficulty merges are never
    stored."""
    enabled: bool = True
    size: int = 256


def _weights(raw: str) -> tuple:
    """``conn:weight`` pairs, comma-separated; a malformed pair is
    skipped."""
    weights = []
    for part in raw.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        tenant, _, raw = part.partition(":")
        try:
            weights.append((tenant.strip(), float(raw)))
        except ValueError:
            continue
    return tuple(weights)


def qos_from_env() -> QosParams:
    d = QosParams()
    return QosParams(
        chunk_s=float_env("DBMT_QOS_CHUNK_S", d.chunk_s),
        max_chunks=max(1, int_env("DBMT_QOS_MAX_CHUNKS", d.max_chunks)),
        depth=max(1, int_env("DBMT_QOS_DEPTH", d.depth)),
        wholesale_s=float_env("DBMT_QOS_WHOLESALE_S", d.wholesale_s),
        max_queued=max(0, int_env("DBMT_QOS_MAX_QUEUED", d.max_queued)),
        max_inflight=max(0, int_env("DBMT_QOS_MAX_INFLIGHT",
                                    d.max_inflight)),
        rate=max(0.0, float_env("DBMT_QOS_RATE", d.rate)),
        burst=max(1.0, float_env("DBMT_QOS_BURST", d.burst)),
        default_weight=float_env("DBMT_QOS_WEIGHT_DEFAULT",
                                 d.default_weight),
        weights=_weights(str_env("DBMT_QOS_WEIGHTS", "")))


def stripe_from_env() -> StripeParams:
    d = StripeParams()
    return StripeParams(
        chunk_s=float_env("DBMT_STRIPE_CHUNK_S", d.chunk_s),
        depth=max(1, int_env("DBMT_STRIPE_DEPTH", d.depth)))


def cache_from_env() -> CacheParams:
    d = CacheParams()
    return CacheParams(enabled=int_env("DBMT_CACHE", 1) != 0,
                       size=max(1, int_env("DBMT_CACHE_SIZE", d.size)))


def coalesce_from_env() -> CoalesceParams:
    d = CoalesceParams()
    return CoalesceParams(
        enabled=int_env("DBMT_COALESCE", 1) != 0,
        lanes=max(2, int_env("DBMT_COALESCE_LANES", d.lanes)),
        max_nonces=int_env("DBMT_COALESCE_MAX", d.max_nonces),
        small_s=float_env("DBMT_COALESCE_SMALL_S", d.small_s))


@dataclass(frozen=True)
class AdaptParams:
    """The self-tuning control plane (``apps.adapt``).

    With ``enabled`` the scheduler mounts an :class:`~..apps.adapt.
    AdaptPlane`: an AIMD controller of the chunk and stripe seconds
    driving a chunk's force latency toward ``force_s``, a controller of
    the coalescing window (widened under a flood of mice, collapsed on
    pipeline bubbles), and a scheduler-wide admission bucket controlled
    on the slope of the queue's age. ``band`` is the dead band (a
    fraction of the setpoint), ``tick_s`` the least time between
    adjustments, ``rate0`` the admission rate to start at (0: open, at
    the controller's ceiling). ``chunk``, ``coalesce`` and ``admit``
    mount each controller; ``per_miner`` forks per-miner chunk
    setpoints once the miners' rates diverge more than 4x. The
    controllers' floors and ceilings are class constants.

    ``admit`` defaults to False, where the JAX package's is True. Its
    congestion bound trims the queue to the service rate measured so far
    times 0.3 s (at least 8 requests). On an NVIDIA H100 (700 W), a
    burst of 64 mice from 8 tenants, which the pool serves in about half
    a second with the controller off, was cut to 8 queued and 7 of the 8
    tenants were shed: after a one-request warm-up in two runs of four,
    and on a warm pool (the burst after an elephant had been served for
    a few sweeps) in two runs of two, where the controller off shed no
    one (the repo's PERF.md, PR 11). The controller is held to the JAX
    one in the tests; ``DBMT_ADAPT_ADMIT=1`` mounts it.
    """
    enabled: bool = True
    tick_s: float = 1.0
    band: float = 0.35
    force_s: float = 1.0
    rate0: float = 0.0
    chunk: bool = True
    coalesce: bool = True
    admit: bool = False
    per_miner: bool = False


def adapt_from_env() -> AdaptParams:
    d = AdaptParams()
    return AdaptParams(
        enabled=int_env("DBMT_ADAPT", 1) != 0,
        tick_s=max(0.01, float_env("DBMT_ADAPT_TICK_S", d.tick_s)),
        band=min(0.9, max(0.0, float_env("DBMT_ADAPT_BAND", d.band))),
        force_s=max(0.01, float_env("DBMT_ADAPT_FORCE_S", d.force_s)),
        rate0=max(0.0, float_env("DBMT_ADAPT_RATE0", d.rate0)),
        chunk=int_env("DBMT_ADAPT_CHUNK", 1) != 0,
        coalesce=int_env("DBMT_ADAPT_COALESCE", 1) != 0,
        admit=int_env("DBMT_ADAPT_ADMIT", 0) != 0,
        per_miner=int_env("DBMT_ADAPT_PER_MINER", 0) != 0)


def lsp_params_from_env():
    """The LSP ``Params`` of the server and the miner: the reference's
    defaults, each overridden by its knob."""
    from ..lsp.params import Params
    d = Params()
    return Params(
        epoch_limit=int_env("DBMT_EPOCH_LIMIT", d.epoch_limit),
        epoch_millis=int_env("DBMT_EPOCH_MILLIS", d.epoch_millis),
        window_size=int_env("DBMT_WINDOW", d.window_size),
        max_backoff_interval=int_env("DBMT_MAX_BACKOFF",
                                     d.max_backoff_interval))


def pipeline_depth_from_env() -> int:
    """The pipelined miner's Request queue bound (at least 1)."""
    return max(1, int_env("DBMT_PIPELINE_DEPTH", 8))


@dataclass(frozen=True)
class PeelParams:
    """The miner's lane body: ``peel`` runs the peeled body, K4 with the
    host ``hoist`` or K3 without (``NonceSearcher``'s ``peel`` and
    ``hoist``)."""
    peel: bool = False
    hoist: bool = True


def peel_from_env() -> PeelParams:
    return PeelParams(peel=int_env("DBMT_PEEL", 0) == 1,
                      hoist=int_env("DBMT_HOIST", 1) != 0)


def mesh_from_env(device="cuda") -> tuple:
    """The miner's mesh, as device names: ``DBMT_MESH_DEVICES`` split at
    its commas; unset or empty, every visible CUDA device when the miner
    runs on ``device`` of type ``cuda``, and none on the CPU. A miner
    takes the mesh when it has at least two entries."""
    names = tuple(x.strip() for x in str_env("DBMT_MESH_DEVICES", "")
                  .split(",") if x.strip())
    if names:
        return names
    import torch
    if torch.device(device).type != "cuda":
        return ()
    return tuple(f"cuda:{i}" for i in range(torch.cuda.device_count()))


@dataclass(frozen=True)
class LeaseParams:
    """Chunk leases (the scheduler's lease plane).

    A chunk's lease is ``max(floor_s, factor * size / rate)``, ``rate``
    the assigned miner's throughput EWMA, else the pool's, else the flat
    ``grace_s`` on a cold pool. An expired lease re-issues the chunk to
    another eligible miner (the first Result wins); ``quarantine_after``
    consecutive blown leases bar a miner from new work until it answers
    again; ``desperation`` lets a wholly quarantined or distrusted pool
    still serve through its least-bad miner. ``fifo_aware`` starts a
    chunk's clock when it reaches the head of its miner's FIFO (until
    then its deadline budgets the chunks ahead of it). ``tick_s`` is the
    sweep's period; ``queue_alarm_s`` bounds a request's age queued or
    in flight before the sweep warns.
    """
    enabled: bool = True
    grace_s: float = 30.0
    factor: float = 4.0
    floor_s: float = 2.0
    tick_s: float = 1.0
    quarantine_after: int = 3
    ewma_alpha: float = 0.3        # weight of the newest throughput sample
    queue_alarm_s: float = 30.0
    fifo_aware: bool = True
    desperation: bool = True


@dataclass(frozen=True)
class VerifyParams:
    """The verification tier: claim checks, audits and trust.

    With ``enabled`` every Result's ``(hash, nonce)`` is recomputed on the
    host before it merges; a false claim is re-run on another miner. With
    probability ``audit_p`` a random subwindow (at most
    ``audit_max_nonces``) of an answered arg-min chunk is re-run on a
    disjoint miner and the request's reply waits for it: a better hash
    found there convicts the miner that claimed the chunk and repairs the
    answer. A miner's trust starts at 1.0, multiplies by ``trust_decay``
    per failure, steps back by ``trust_recover`` per answer (clamped to
    ``[trust_floor, 1.0]``); below ``trust_bar`` it gets no new grants.
    """
    enabled: bool = True
    audit_p: float = 0.0
    audit_max_nonces: int = 1 << 16
    trust_decay: float = 0.25
    trust_recover: float = 0.05
    trust_floor: float = 0.01
    trust_bar: float = 0.2


def lease_from_env() -> LeaseParams:
    d = LeaseParams()
    return LeaseParams(
        grace_s=float_env("DBMT_LEASE_GRACE_S", d.grace_s),
        factor=float_env("DBMT_LEASE_FACTOR", d.factor),
        floor_s=float_env("DBMT_LEASE_FLOOR_S", d.floor_s),
        tick_s=float_env("DBMT_LEASE_TICK_S", d.tick_s),
        quarantine_after=int_env("DBMT_LEASE_QUARANTINE",
                                 d.quarantine_after),
        queue_alarm_s=float_env("DBMT_QUEUE_ALARM_S", d.queue_alarm_s))


def verify_from_env() -> VerifyParams:
    """The tier from the environment; audits default to 0.02 here (the
    JAX package's env default), while ``VerifyParams()`` keeps 0.0."""
    d = VerifyParams()
    return VerifyParams(
        audit_p=min(1.0, max(0.0, float_env("DBMT_AUDIT_P", 0.02))),
        audit_max_nonces=max(1, int_env("DBMT_AUDIT_MAX",
                                        d.audit_max_nonces)),
        trust_decay=min(0.99, max(0.01, float_env("DBMT_TRUST_DECAY",
                                                  d.trust_decay))),
        trust_recover=min(0.99, max(0.001, float_env("DBMT_TRUST_RECOVER",
                                                     d.trust_recover))),
        trust_floor=min(1.0, max(0.0, float_env("DBMT_TRUST_FLOOR",
                                                d.trust_floor))),
        trust_bar=min(1.0, max(0.0, float_env("DBMT_TRUST_BAR",
                                              d.trust_bar))))


@dataclass(frozen=True)
class PodParams:
    """A pod: several processes that join the scheduler as ONE miner
    (``parallel.multihost``). ``coordinator`` is the ``host:port`` of rank
    0's TCP rendezvous (None: no pod), ``num_procs`` the ranks, ``proc_id``
    this process's rank; ``timeout_s`` bounds one pod job and
    ``idle_timeout_s`` (0: no bound) a follower's wait between jobs: past
    either the process exits with code 17."""
    coordinator: str | None = None
    num_procs: int = 1
    proc_id: int = 0
    timeout_s: float = 600.0
    idle_timeout_s: float = 0.0


def pod_from_env() -> PodParams:
    """``DBMT_COORDINATOR``, ``DBMT_NUM_PROCS``, ``DBMT_PROC_ID``,
    ``DBMT_POD_TIMEOUT_S`` (600), ``DBMT_POD_IDLE_TIMEOUT_S`` (0)."""
    d = PodParams()
    return PodParams(
        coordinator=str_env("DBMT_COORDINATOR") or None,
        num_procs=int_env("DBMT_NUM_PROCS", d.num_procs),
        proc_id=int_env("DBMT_PROC_ID", d.proc_id),
        timeout_s=float_env("DBMT_POD_TIMEOUT_S", d.timeout_s),
        idle_timeout_s=float_env("DBMT_POD_IDLE_TIMEOUT_S",
                                 d.idle_timeout_s))


@dataclass(frozen=True)
class CaptureParams:
    """The workload capture plane (``apps.capture``): ``enabled``
    (``DBMT_CAPTURE``, default 0) arms it; records go to ``path``, which
    rotates to ``path + ".1"`` past ``max_lines`` lines (at least 1024); a
    pool snapshot rides the sweep at most every ``snap_s`` seconds."""
    enabled: bool = False
    path: str = "dbmt_capture.jsonl"
    max_lines: int = 200_000
    snap_s: float = 5.0


def capture_from_env() -> CaptureParams:
    """``DBMT_CAPTURE``, ``DBMT_CAPTURE_PATH``, ``DBMT_CAPTURE_LINES``,
    ``DBMT_CAPTURE_SNAP_S`` (read at each call, so
    a knob set around a construction takes effect)."""
    d = CaptureParams()
    return CaptureParams(
        enabled=int_env("DBMT_CAPTURE", 0) != 0,
        path=str_env("DBMT_CAPTURE_PATH", d.path),
        max_lines=max(1024, int_env("DBMT_CAPTURE_LINES", d.max_lines)),
        snap_s=float_env("DBMT_CAPTURE_SNAP_S", d.snap_s))


def replicas_from_env() -> int:
    """``DBMT_REPLICAS`` (default 1: the plain single scheduler)."""
    return max(1, int_env("DBMT_REPLICAS", 1))


def recv_batch_from_env() -> int:
    """``DBMT_RECV_BATCH`` (default 64, at least 1): the messages a
    scheduler's (or ``ReplicaSet``'s) read loop handles for one awaited
    read, the rest drained without a loop hop; 1 is one message an
    await."""
    return max(1, int_env("DBMT_RECV_BATCH", 64))


@dataclass(frozen=True)
class RetryParams:
    """The client's ``submit_with_retry``: ``attempts`` tries in all (1 is
    the reference's one-shot submit); ``timeout_s`` the deadline of one
    attempt's Result (0: none; a dead connection still retries); the
    back-off between attempts doubles from ``backoff_s`` up to
    ``backoff_cap_s``. A closed LSP connection is only a local flush, so
    the scheduler cancels an abandoned attempt's request once its epoch
    timer declares the conn lost; a faster resubmission queues behind it
    (latency, never a wrong or doubled answer)."""
    attempts: int = 3
    timeout_s: float = 0.0
    backoff_s: float = 0.5
    backoff_cap_s: float = 8.0


def retry_from_env() -> RetryParams:
    """``DBMT_RETRY_ATTEMPTS`` (at least 1), ``DBMT_RETRY_TIMEOUT_S``,
    ``DBMT_RETRY_BACKOFF_S``, ``DBMT_RETRY_BACKOFF_CAP_S``."""
    d = RetryParams()
    return RetryParams(
        attempts=max(1, int_env("DBMT_RETRY_ATTEMPTS", d.attempts)),
        timeout_s=float_env("DBMT_RETRY_TIMEOUT_S", d.timeout_s),
        backoff_s=float_env("DBMT_RETRY_BACKOFF_S", d.backoff_s),
        backoff_cap_s=float_env("DBMT_RETRY_BACKOFF_CAP_S",
                                d.backoff_cap_s))


@dataclass(frozen=True)
class GatewayParams:
    """The federation (``apps.gateway``): a ``GatewayMiner`` joins a
    parent scheduler as ONE miner whose rate hint is its inner pool's
    summed rate, refreshed by a repeat JOIN at most every ``hint_s`` when
    the sum moved by a tenth; it joins once ``min_pool`` inner miners
    exist, and drops the parent conn when the inner pool has been empty
    for ``orphan_s`` with grants pending. ``enabled=False`` is the flat
    topology: a repeat JOIN registers a new miner, as the reference's
    scheduler does."""
    enabled: bool = True
    hint_s: float = 2.0
    min_pool: int = 1
    orphan_s: float = 10.0


def gateway_from_env() -> GatewayParams:
    """``DBMT_GATEWAY`` (default 1), ``DBMT_GATEWAY_HINT_S`` (at least
    0.05), ``DBMT_GATEWAY_MIN_POOL`` (at least 1),
    ``DBMT_GATEWAY_ORPHAN_S`` (at least 0.1)."""
    d = GatewayParams()
    return GatewayParams(
        enabled=int_env("DBMT_GATEWAY", 1) != 0,
        hint_s=max(0.05, float_env("DBMT_GATEWAY_HINT_S", d.hint_s)),
        min_pool=max(1, int_env("DBMT_GATEWAY_MIN_POOL", d.min_pool)),
        orphan_s=max(0.1, float_env("DBMT_GATEWAY_ORPHAN_S", d.orphan_s)))


def compute_from_env() -> str:
    """``DBMT_COMPUTE``, lower-cased: ``host`` asks for the host tier (the
    native C++ scan); anything else, or unset, leaves the miner on its
    device. There is no automatic choice of tier."""
    return str_env("DBMT_COMPUTE", "").strip().lower()


def host_fingerprint() -> str:
    """12 hex digits of this host's CPU feature flags: the key of a build
    compiled with ``-march=native``, so a library built on one machine is
    never loaded on another with fewer instruction-set extensions."""
    try:
        with open("/proc/cpuinfo") as f:
            sig = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        sig = ""
    sig = sig or platform.processor() or platform.machine()
    return hashlib.sha256(sig.encode()).hexdigest()[:12]
