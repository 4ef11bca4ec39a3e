"""In-process metrics registry + request traces for every framework layer.

The reference system's only visibility is per-packet stderr debug lines and
a microsecond file logger; this build's robustness plane (leases,
quarantine, speculative re-issue, result cache) and compute plane (hoisted
kernels, tier degradation) need first-class numbers. This module is that
plane: a lightweight, thread-safe registry of

- **counters** — monotonic event counts;
- **gauges** — last-write-wins scalars;
- **histograms** — fixed-bucket latency/occupancy distributions
  (cumulative-``le`` buckets, Prometheus-style, plus count and sum);
- **EWMAs** — irregular-series exponentially-weighted moving averages
  (``alpha = 1 - exp(-dt/tau)``), for rates like nonces/s;

with named-label support (``registry.counter("lsp.retransmits",
backoff="2")``). Label cardinality is bounded per metric family: past
``max_series`` distinct label sets, further sets collapse into one
``{overflow="true"}`` series, so a conn-id label can never grow memory
without bound. ``series_overflow`` counts LOOKUPS routed to an overflow
series (not distinct collapsed sets — tracking those would itself need
unbounded memory): zero means the bound never bit; a growing value means
real traffic is being aggregated away and ``max_series`` is too small.

Design constraints, in order:

1. **Near-zero overhead when idle.** No background work exists unless an
   emitter is started; an update is one short critical section on the
   registry lock (plain attribute arithmetic — no allocation on the hot
   path); fetching a labeled child is a dict lookup callers can (and the
   per-packet LSP call sites do) hoist out of their loops.
2. **Thread-safe.** The miner computes in worker threads while the asyncio
   loop serves LSP; a shared ``RLock`` per registry makes every update and
   ``snapshot()`` atomic. Cross-registry lock order is strictly
   parent->mounted (only ``snapshot`` crosses), so no cycles.
3. **JSON-stable snapshots.** ``snapshot()`` returns only JSON-native
   types with deterministically ordered keys (sections sorted, series keys
   sorted, buckets fixed at construction) so two snapshots of the same
   process diff cleanly — the property ``BENCH_*.json`` comparisons rely
   on (guarded by tests/test_metrics.py).

Process wiring: :func:`registry` returns the process-default registry that
the LSP engine, lspnet transport, miner worker, and model layer all write
to. Subsystems with per-instance stats (the scheduler) keep their own
:class:`Registry` and ``mount()`` it into the default one under a prefix,
so one ``snapshot()`` still covers the whole process. :func:`ensure_emitter`
starts (once per process) a daemon thread that logs one JSON line per
``DBMT_METRICS_INTERVAL_S`` seconds through the existing ``dbmt`` logger tree
(``dbmt.metrics``), plus an atexit final dump — 0 disables the emitter.

Request traces (:class:`RequestTrace` / :class:`TraceBuffer`) are the
per-request complement of the aggregate registry: an ordered, timestamped
span record (enqueue -> dispatch -> result -> merge -> reply) keyed by the
scheduler's existing ``job_id`` — no wire-format change — retrievable via
``Scheduler.trace(request_id)`` and dumped wholesale on a queue-age alarm
so a stalled request explains itself.
"""

from __future__ import annotations

import atexit
import json
import logging
import math
import threading
import time
from bisect import bisect_left
from typing import Callable, Dict, Optional, Tuple

from ._env import float_env as _float_env, int_env as _int_env

_log = logging.getLogger("dbmt.metrics")

#: Default histogram buckets (seconds): spans sub-ms LSP RTTs through
#: multi-minute wedged-chunk latencies. Cumulative ``le`` semantics; an
#: implicit +Inf bucket is the final count.
LATENCY_BUCKETS_S = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                     0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

#: Occupancy buckets (counts): sliding windows, FIFO depths, queue lengths.
OCCUPANCY_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0,
                     256.0, 512.0)

_LabelKey = Tuple[Tuple[str, str], ...]
_OVERFLOW_KEY: _LabelKey = (("overflow", "true"),)


class Counter:
    """Monotonic event counter."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def _snap(self):
        return self._value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def _snap(self):
        return round(self._value, 6)


class Histogram:
    """Fixed-bucket histogram (cumulative ``le`` buckets + count + sum).

    Buckets are frozen at construction so every snapshot of a series has
    the identical shape — the stable-key property BENCH diffs rely on.
    """

    __slots__ = ("_lock", "buckets", "_counts", "_count", "_sum")

    def __init__(self, lock: threading.RLock,
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS_S):
        self._lock = lock
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self._count = 0
        self._sum = 0.0

    def observe(self, v: float) -> None:
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _snap(self):
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        # Cumulative counts, one per finite bound; `count` is the +Inf one.
        cum, acc = [], 0
        for c in counts[:-1]:
            acc += c
            cum.append(acc)
        return {"le": list(self.buckets), "counts": cum,
                "count": total, "sum": round(s, 6)}


class Ewma:
    """Irregular-series EWMA: ``alpha = 1 - exp(-dt / tau)`` per sample.

    ``observe(x)`` folds a new sample in, weighted by the wall-clock gap
    since the previous one — the standard way to EWMA rate samples that
    arrive at uneven intervals (a per-chunk nonces/s sample every few
    hundred ms under load, minutes apart when idle).
    """

    __slots__ = ("_lock", "tau_s", "_value", "_t", "_clock", "_n")

    def __init__(self, lock: threading.RLock, tau_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self._lock = lock
        self.tau_s = tau_s
        self._value: Optional[float] = None
        self._t = 0.0
        self._n = 0
        self._clock = clock

    def observe(self, x: float) -> None:
        now = self._clock()
        with self._lock:
            if self._value is None:
                self._value = float(x)
            else:
                dt = max(now - self._t, 1e-9)
                alpha = 1.0 - math.exp(-dt / self.tau_s)
                self._value += alpha * (x - self._value)
            self._t = now
            self._n += 1

    @property
    def value(self) -> Optional[float]:
        return self._value

    def _snap(self):
        with self._lock:
            v = self._value
            n = self._n
        return {"value": round(v, 6) if v is not None else None,
                "samples": n}


_KINDS = ("counters", "gauges", "histograms", "ewmas")


class Registry:
    """One metric namespace: families of labeled series, snapshot-able.

    ``max_series`` bounds distinct label sets per family (overflow
    collapses into one ``{overflow="true"}`` series). Registries can be
    ``mount()``-ed into each other so a per-instance registry (the
    scheduler's) shows up, prefixed, in the process snapshot.
    """

    def __init__(self, max_series: Optional[int] = None):
        self._lock = threading.RLock()
        self.max_series = (max_series if max_series is not None
                           else _int_env("DBMT_METRICS_MAX_SERIES", 64))
        # kind -> name -> labelkey -> metric
        self._families: Dict[str, Dict[str, Dict[_LabelKey, object]]] = {
            k: {} for k in _KINDS}
        self._mounts: Dict[str, "Registry"] = {}
        self._overflows = 0

    # ------------------------------------------------------------- factories

    def _series(self, kind: str, name: str, labels: dict, factory):
        key: _LabelKey = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            family = self._families[kind].setdefault(name, {})
            metric = family.get(key)
            if metric is None:
                if key and len(family) >= self.max_series \
                        and key != _OVERFLOW_KEY:
                    # Cardinality bound: collapse, never grow unbounded.
                    # Counted per LOOKUP routed here (module docstring) —
                    # the original key is deliberately not remembered.
                    self._overflows += 1
                    key = _OVERFLOW_KEY
                    metric = family.get(key)
                if metric is None:
                    metric = factory(self._lock)
                    family[key] = metric
            return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._series("counters", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._series("gauges", name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = LATENCY_BUCKETS_S,
                  **labels) -> Histogram:
        return self._series("histograms", name, labels,
                            lambda lock: Histogram(lock, buckets))

    def ewma(self, name: str, tau_s: float = 30.0, **labels) -> Ewma:
        return self._series("ewmas", name, labels,
                            lambda lock: Ewma(lock, tau_s))

    def remove(self, name: str, **labels) -> None:
        """Delete one labeled series (every kind; no-op when absent).

        Frees the family's cardinality slot. Call when the labeled entity
        is gone for good — e.g. the scheduler drops a miner's rate/lease
        gauges on disconnect, so miner churn neither leaves dead conn-ids
        in snapshots nor exhausts ``max_series`` over a long process life.
        """
        key: _LabelKey = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            for kind in _KINDS:
                family = self._families[kind].get(name)
                if family is not None:
                    family.pop(key, None)

    # --------------------------------------------------------------- mounts

    def mount(self, prefix: str, other: "Registry") -> None:
        """Include ``other``'s snapshot under ``prefix.`` in this one.

        Re-mounting the same prefix replaces the previous registry (a new
        scheduler instance supersedes the old one's series).
        """
        if other is self:
            raise ValueError("a registry cannot mount itself")
        with self._lock:
            self._mounts[prefix] = other

    # ------------------------------------------------------------- snapshot

    @staticmethod
    def _series_key(name: str, key: _LabelKey) -> str:
        if not key:
            return name
        return name + "{" + ",".join(f"{k}={v}" for k, v in key) + "}"

    def snapshot(self) -> dict:
        """JSON-native, stable-keyed view of every series (incl. mounts).

        Shape: ``{"counters": {...}, "gauges": {...}, "histograms": {...},
        "ewmas": {...}, "series_overflow": N}`` with all series keys
        sorted. Safe to ``json.dumps`` as-is.
        """
        with self._lock:
            out: dict = {}
            overflow = self._overflows
            for kind in _KINDS:
                section: Dict[str, object] = {}
                for name, family in self._families[kind].items():
                    for key, metric in family.items():
                        section[self._series_key(name, key)] = metric._snap()
                out[kind] = dict(sorted(section.items()))
            mounts = dict(self._mounts)
        for prefix, other in sorted(mounts.items()):
            sub = other.snapshot()
            overflow += sub.get("series_overflow", 0)
            for kind in _KINDS:
                merged = out[kind]
                for k, v in sub[kind].items():
                    merged[f"{prefix}.{k}"] = v
                out[kind] = dict(sorted(merged.items()))
        out["series_overflow"] = overflow
        return out


# ------------------------------------------------------------------ emitter


class Emitter(threading.Thread):
    """Daemon thread logging one JSON snapshot line per interval.

    Rides the existing ``dbmt`` logger tree (``dbmt.metrics``) so the line
    lands wherever ``configure_logging`` pointed the process — the same
    sink as every other structured log. ``stop()`` emits one final line.
    """

    def __init__(self, reg: Registry, interval_s: float,
                 logger: Optional[logging.Logger] = None):
        super().__init__(name="dbmt-metrics-emitter", daemon=True)
        self.registry = reg
        self.interval_s = interval_s
        self.logger = logger if logger is not None else _log
        self._stop = threading.Event()
        self._t0 = time.monotonic()

    def emit(self, final: bool = False) -> None:
        doc = {"event": "metrics", "final": final,
               "interval_s": self.interval_s,
               "uptime_s": round(time.monotonic() - self._t0, 3),
               "snapshot": self.registry.snapshot()}
        # Crash/exit artifacts name the active workload capture
        #: the final atexit dump is often the only line an
        # operator has after an incident, and "which traffic produced
        # this" should be on it.
        info = capture_info()
        if info is not None:
            doc["capture"] = info
        # Interleaved --procs logs attribute without pid cross-referencing
        #: a multi-process run funnels N emitters into one
        # stream, and "whose snapshot is this" must be on the line itself.
        ident = proc_identity()
        if ident is not None:
            doc["identity"] = ident
        self.logger.info("%s", json.dumps(doc, sort_keys=True))

    def run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.emit()
            except Exception:  # noqa: BLE001 — the emitter must never die
                self.logger.exception("metrics emit failed; continuing")

    def stop(self, final_dump: bool = True) -> None:
        if not self._stop.is_set():
            self._stop.set()
            if final_dump:
                self.emit(final=True)


_default_registry = Registry()
_emitter: Optional[Emitter] = None
_emitter_lock = threading.Lock()

# Active workload capture: the capture plane registers a
# zero-argument info callable here so CRASH ARTIFACTS name the workload
# that produced them — the flight-recorder dump (utils/trace.py) and
# the emitter's snapshot lines (incl. the atexit final dump) both embed
# it. Lives in this module because it is the bottom layer both sides
# already import (trace.py cannot be imported from here, and the apps
# layer cannot be imported from either).
_capture_info = None
_capture_info_lock = threading.Lock()


def set_capture_info(fn) -> None:
    """Register the active capture's info callable (or None to clear)."""
    global _capture_info
    with _capture_info_lock:
        _capture_info = fn


def clear_capture_info(fn) -> None:
    """Clear the slot iff ``fn`` still owns it (a test's short-lived
    capture must not clobber the process capture's registration)."""
    global _capture_info
    with _capture_info_lock:
        if _capture_info is fn:
            _capture_info = None


def capture_info() -> Optional[dict]:
    """The active capture's ``{"path", "lines", ...}``, or None.

    Never raises: a capture mid-close returning garbage must not take
    down the alarm path embedding this."""
    with _capture_info_lock:
        fn = _capture_info
    if fn is None:
        return None
    try:
        info = fn()
    except Exception:   # noqa: BLE001 — crash-artifact path, best effort
        return None
    return info if isinstance(info, dict) else None


# Process identity: an env-armed process (router / replica /
# miner agent) registers its role/rid/incarnation here so every emitter
# snapshot line and flight-recorder dump self-attributes — the same
# triple the rollup plane stamps onto published metric blobs. Same slot
# discipline as the capture info above, and in this module for the same
# layering reason.
_proc_identity: Optional[dict] = None
_proc_identity_lock = threading.Lock()


def set_proc_identity(role: Optional[str], rid=None,
                      incarnation: Optional[str] = None) -> None:
    """Register this process's identity triple (``role=None`` clears)."""
    global _proc_identity
    with _proc_identity_lock:
        if role is None:
            _proc_identity = None
        else:
            _proc_identity = {"role": str(role), "rid": rid,
                              "inc": incarnation}


def proc_identity() -> Optional[dict]:
    """A copy of the registered identity dict, or None (never raises)."""
    with _proc_identity_lock:
        ident = _proc_identity
    return dict(ident) if ident is not None else None


def registry() -> Registry:
    """The process-default registry every built-in layer writes to."""
    return _default_registry


def ensure_emitter(interval_s: Optional[float] = None) -> Optional[Emitter]:
    """Start the process emitter once; later calls return the running one.

    ``interval_s=None`` reads ``DBMT_METRICS_INTERVAL_S`` (default 30.0);
    ``<= 0`` disables (returns None without starting anything — the
    "near-zero overhead when idle" contract). The final atexit dump is
    registered with the first started emitter.
    """
    if interval_s is None:
        interval_s = _float_env("DBMT_METRICS_INTERVAL_S", 30.0)
    if interval_s <= 0:
        return None
    global _emitter
    with _emitter_lock:
        if _emitter is None or not _emitter.is_alive():
            _emitter = Emitter(_default_registry, interval_s)
            _emitter.start()
            atexit.register(_final_dump)
        return _emitter


def _final_dump() -> None:
    with _emitter_lock:
        em = _emitter
    if em is not None:
        em.stop(final_dump=True)


# ------------------------------------------------------------------- traces


class RequestTrace:
    """Ordered, timestamped span record for one request.

    Events are ``{"t": seconds-since-trace-start, "event": name, ...}``
    dicts; the record is *closed* once a terminal event (``reply`` or
    ``cancel``) lands. Event count is capped so a pathological request
    (thousands of sweeps) cannot grow one trace without bound — overflow
    is counted, not silently dropped.
    """

    MAX_EVENTS = 512

    #: Real traces are sampled-in; :class:`NullRequestTrace` overrides.
    null = False

    __slots__ = ("key", "meta", "events", "dropped", "_t0", "_lock")

    def __init__(self, **meta):
        self.key = None            # set by TraceBuffer.register
        self.meta = meta
        self.events: list = []
        self.dropped = 0
        self._t0 = time.monotonic()
        self._lock = threading.Lock()

    def event(self, name: str, **detail) -> None:
        ev = {"t": round(time.monotonic() - self._t0, 6), "event": name}
        ev.update(detail)
        with self._lock:
            if len(self.events) >= self.MAX_EVENTS \
                    and name not in ("reply", "cancel"):
                # Terminal events bypass the cap: a trace that filled up
                # with sweep noise must still CLOSE when the request
                # finally replies — the operator contract reads "last
                # event is reply" as completed, and the buffer's eviction
                # preference keys on closure.
                self.dropped += 1
                return
            self.events.append(ev)

    @property
    def closed(self) -> bool:
        with self._lock:
            return any(e["event"] in ("reply", "cancel")
                       for e in reversed(self.events))

    @property
    def t0(self) -> float:
        """Monotonic birth stamp (event ``t`` values are relative to it;
        the Perfetto exporter uses it to place traces on one timeline)."""
        return self._t0

    def to_dict(self) -> dict:
        """JSON-native dump (the queue-age alarm logs this wholesale)."""
        with self._lock:
            events = [dict(e) for e in self.events]
            dropped = self.dropped
        out = {"key": self.key, "meta": dict(self.meta), "events": events}
        if dropped:
            out["events_dropped"] = dropped
        return out


class NullRequestTrace:
    """Shared no-op stand-in for an UNSAMPLED request's trace
    (``DBMT_TRACE_SAMPLE``).

    At 10k tenants the per-request :class:`RequestTrace` allocation —
    object + lock + an event dict per lifecycle edge — is itself a
    control-plane melt point. An unsampled request carries this
    singleton instead: every ``event()`` is one no-op method call, it
    never registers in a :class:`TraceBuffer` (``register`` drops it),
    and it reports ``closed`` so span-completeness checks skip it.
    ``DBMT_TRACE_SAMPLE=1.0`` (the default) never constructs it — today's
    behavior bit-for-bit.
    """

    __slots__ = ()

    null = True
    key = None
    meta: dict = {}
    events: tuple = ()
    dropped = 0
    closed = True
    t0 = 0.0

    def event(self, name: str, **detail) -> None:
        pass

    def to_dict(self) -> dict:
        return {"key": None, "meta": {}, "events": [], "sampled": False}


#: The one shared unsampled-trace instance (it is stateless).
NULL_TRACE = NullRequestTrace()


class TraceBuffer:
    """Bounded LRU store of traces, keyed by request id.

    Eviction prefers CLOSED traces: a burst of short-lived entries (e.g.
    cache-replay traces during a retry storm) must not evict the live
    in-flight request's still-open trace — the one record the alarm dump
    exists to preserve. Reads refresh recency, so an actively-updated
    trace stays resident.
    """

    def __init__(self, cap: Optional[int] = None):
        self.cap = cap if cap is not None else _int_env(
            "DBMT_METRICS_TRACE_CAP", 256)
        self._d: Dict[object, RequestTrace] = {}
        self._lock = threading.Lock()

    def new(self, **meta) -> RequestTrace:
        """A fresh, not-yet-registered trace (queued requests have no
        job_id yet; they register at dispatch)."""
        return RequestTrace(**meta)

    def register(self, key, trace: RequestTrace) -> None:
        if trace.null:
            return     # unsampled (DBMT_TRACE_SAMPLE): nothing to retain
        trace.key = key
        with self._lock:
            self._d.pop(key, None)
            self._d[key] = trace
            while len(self._d) > self.cap:
                victim = next((k for k, t in self._d.items() if t.closed),
                              None)
                if victim is None:      # everything open: oldest goes
                    victim = next(iter(self._d))
                self._d.pop(victim)

    def get(self, key) -> Optional[RequestTrace]:
        with self._lock:
            trace = self._d.pop(key, None)
            if trace is not None:
                self._d[key] = trace    # LRU refresh
            return trace

    def items(self):
        with self._lock:
            return list(self._d.items())

    def __len__(self) -> int:
        return len(self._d)
