"""Request tracing across processes, the launch observer and the flight
recorder.

Counterpart of the JAX package's ``utils/trace.py``. The apps wire it up:

- **Chunk spans** (``apps/miner.py``): the miner records one span per
  served chunk (reader-queue wait, dispatch, pipeline wait, force, the
  executor's idle gap before the chunk, and for a coalesced batch the
  shared launch's id and lane count) and ships it back on the Result as
  the ``Span`` wire extension (``bitcoin/message.py``; appended only
  when tracing is on, so ``DBMT_TRACE=0`` keeps the stock bytes). LSP is
  in-order and exactly-once, so the k-th Result of a miner answers its
  k-th pending chunk: the scheduler's ``(job_id, chunk idx)`` pop is the
  stitch key.
- **Stitching** (``apps/scheduler.py``): the span is folded into the
  request's :class:`~.metrics.RequestTrace` as a ``miner_span`` event
  that names the DOMINANT phase (:func:`slow_phase`).
- **The launch observer** (:class:`LaunchObserver`, hooked at the model
  layer's launch sites): every kernel launch carries a static SIGNATURE
  (entry, kernel instantiation, grid, lane body). On the card the first
  launch of a fresh signature carries the kernel library's load and
  CUDA's lazy load of that kernel; its host time is recorded per
  signature, and a burst of fresh signatures inside a short window fires
  a structured alarm (``trace.launch_storms``) and a flight-recorder
  dump.
- **Flight recorder** (:class:`FlightRecorder`): a bounded ring of
  control-plane events in both processes, dumped as one JSON line on the
  age alarms, sanitizer warnings and an unhandled-exception exit.
- **Perfetto export** (:func:`to_chrome_trace`,
  ``Scheduler.export_trace``, ``tools/dbmtrace.py``): stitched traces
  as Chrome trace-event JSON, one track per tenant and per miner.

Knobs (through ``utils._env``; the port's README lists them):
``DBMT_TRACE`` (default 1; 0 restores the stock behaviour bit for bit),
``DBMT_TRACE_SAMPLE`` (the share of requests traced, default 1.0),
``DBMT_TRACE_FLIGHT`` (ring capacity; 0 disables the recorder),
``DBMT_TRACE_STORM_N`` / ``DBMT_TRACE_STORM_S`` (the storm alarm: N
fresh signatures within S seconds). The device profiler
(``utils/profiling.py``) is orthogonal: this plane is request-scoped,
that one kernel-scoped.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from collections import deque
from typing import Dict, Optional, Tuple

from ._env import float_env as _float_env, int_env as _int_env
from .metrics import (capture_info as _capture_info,
                      proc_identity as _proc_identity,
                      registry as _registry)

_log = logging.getLogger("dbmt.trace")

#: Span phase keys a miner's chunk span may carry, in pipeline order (all
#: seconds). ``launch``/``lanes`` (a shared coalesced launch),
#: ``compiles`` (fresh launch signatures met during this chunk's
#: dispatch), ``serial`` (a blocking-path chunk) and ``subs`` are the
#: extras. The wire dict draws from exactly these keys (the JAX
#: package's vocabulary).
SPAN_PHASES = ("queue_s", "dispatch_s", "wait_s", "force_s", "gap_s")
SPAN_EXTRAS = ("launch", "lanes", "compiles", "serial", "subs")


def enabled() -> bool:
    """True when the tracing plane is on (``DBMT_TRACE``, default 1).
    Read at each call, so a test can switch it around one construction;
    with it off every hook of the apps is this one check."""
    return _int_env("DBMT_TRACE", 1) != 0


def sample_rate() -> float:
    """``DBMT_TRACE_SAMPLE`` (default 1.0): the share of requests that
    get a real :class:`~.metrics.RequestTrace`, clamped to [0, 1]."""
    return min(1.0, max(0.0, _float_env("DBMT_TRACE_SAMPLE", 1.0)))


def sample_hit(seq: int, rate: float) -> bool:
    """The deterministic sampling decision for the ``seq``-th request: a
    Knuth multiplicative hash of the sequence number against the rate
    (the same storm samples the same requests on every run)."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return ((seq * 0x9E3779B1) & 0xFFFFFFFF) < rate * 4294967296.0


def slow_phase(span: dict) -> Optional[str]:
    """The dominant PHASE of a span dict without its ``_s`` suffix
    (``force``, ``queue``, ...), or None when the span has none."""
    best, best_v = None, 0.0
    for key in SPAN_PHASES:
        v = span.get(key)
        if isinstance(v, (int, float)) and v > best_v:
            best, best_v = key[:-2], float(v)
    return best


# ------------------------------------------------------------ flight recorder


class FlightRecorder:
    """Bounded ring of control-plane events, dumped on demand.

    ``record()`` is one deque append under a lock; ``dump(why)`` logs the
    whole ring, oldest first, as ONE JSON line through ``dbmt.trace`` and
    counts ``trace.flight_dumps``. ``cap=0`` disables it.
    """

    def __init__(self, cap: Optional[int] = None):
        self.cap = cap if cap is not None else _int_env(
            "DBMT_TRACE_FLIGHT", 512)
        self._d: deque = deque(maxlen=max(1, self.cap))
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._dumps = _registry().counter("trace.flight_dumps")

    def record(self, event: str, **detail) -> None:
        if self.cap <= 0:
            return
        ev = {"t": round(time.monotonic() - self._t0, 6), "event": event}
        if detail:
            ev.update(detail)
        with self._lock:
            self._d.append(ev)

    def events(self) -> list:
        with self._lock:
            return list(self._d)

    def __len__(self) -> int:
        return len(self._d)

    def dump(self, why: str) -> None:
        """One JSON line: the reason, the ring, and the process's
        identity and active capture when there are any."""
        if self.cap <= 0:
            return
        self._dumps.inc()
        doc = {"why": why, "events": self.events()}
        info = _capture_info()
        if info is not None:
            doc["capture"] = info
        ident = _proc_identity()
        if ident is not None:
            doc["identity"] = ident
        _log.warning("flight recorder dump (%s): %s", why,
                     json.dumps(doc, sort_keys=True, default=str))


_flight: Optional[FlightRecorder] = None
_flight_lock = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process flight recorder (constructed on first use)."""
    global _flight
    with _flight_lock:
        if _flight is None:
            _flight = FlightRecorder()
        return _flight


def flight(event: str, **detail) -> None:
    """Record one control-plane event into the process ring (a no-op
    when the plane or the ring is off)."""
    if not enabled():
        return
    flight_recorder().record(event, **detail)


def flight_dump(why: str) -> None:
    """Dump the process ring (a no-op when the plane or ring is off)."""
    if not enabled():
        return
    flight_recorder().dump(why)


_excepthook_installed = False


def _install_excepthook() -> None:
    """Chain-wrap ``sys.excepthook`` so an unhandled-exception exit dumps
    the flight recorder first. Idempotent."""
    global _excepthook_installed
    if _excepthook_installed:
        return
    _excepthook_installed = True
    prev = sys.excepthook

    def _hook(exc_type, exc, tb):
        try:
            flight_recorder().record("unhandled_exception",
                                     exception=repr(exc)[:200])
            flight_recorder().dump("unhandled-exception exit")
        except Exception:   # noqa: BLE001 — never mask the real crash
            pass
        prev(exc_type, exc, tb)

    sys.excepthook = _hook


def ensure_tracer() -> bool:
    """Arm the process-level pieces iff ``DBMT_TRACE=1`` (the flight
    recorder and its crash-exit dump); returns :func:`enabled`. The
    scheduler and the miner call it at construction."""
    if not enabled():
        return False
    flight_recorder()
    _install_excepthook()
    return True


# ----------------------------------------------------------- launch observer


class LaunchObserver:
    """Per-signature kernel-launch bookkeeping and the storm alarm.

    ``launch(sig, seconds)`` is called (through :class:`observe_launch`)
    around every kernel launch of the model layer with the launch's
    static signature. The first launch of a signature carries, on the
    card, the kernel library's load and CUDA's lazy module load on the
    calling thread: its host seconds are recorded; later launches only
    count. ``storm_n`` fresh signatures within ``storm_s`` seconds is a
    STORM (a runtime value reaching a launch's static shape), which fires
    a warning, ``trace.launch_storms`` and a flight dump, once per
    episode.
    """

    def __init__(self, storm_n: Optional[int] = None,
                 storm_s: Optional[float] = None):
        # 12 clears a cold miner's first burst of shapes (three entries
        # over a few tail shapes) while a signature minted per request
        # blows past any constant.
        self.storm_n = storm_n if storm_n is not None else _int_env(
            "DBMT_TRACE_STORM_N", 12)
        self.storm_s = storm_s if storm_s is not None else _float_env(
            "DBMT_TRACE_STORM_S", 30.0)
        self._lock = threading.Lock()
        self.sigs: Dict[tuple, dict] = {}      # sig -> {n, first_s}
        self._fresh: deque = deque()           # stamps of fresh signatures
        self._storming = False
        self._first = _registry().counter("trace.fresh_launches")
        self._launches = _registry().counter("trace.observed_launches")
        self._storms = _registry().counter("trace.launch_storms")
        self._worst = _registry().gauge("trace.fresh_launch_worst_s")

    def launch(self, sig: tuple, seconds: float) -> Optional[float]:
        """Record one launch of ``sig`` that took ``seconds`` on the
        launching thread. Returns the seconds when this was the
        signature's first launch, else None."""
        now = time.monotonic()
        storm = None
        with self._lock:
            self._launches.inc()
            rec = self.sigs.get(sig)
            if rec is not None:
                rec["n"] += 1
                return None
            self.sigs[sig] = {"n": 1, "first_s": seconds}
            self._first.inc()
            if seconds > self._worst.value:
                self._worst.set(seconds)
            self._fresh.append(now)
            while self._fresh and now - self._fresh[0] > self.storm_s:
                self._fresh.popleft()
            if len(self._fresh) >= self.storm_n:
                if not self._storming:
                    self._storming = True
                    self._storms.inc()
                    storm = len(self._fresh)
            else:
                self._storming = False
        if storm is not None:
            _log.warning(
                "launch storm: %d fresh launch signatures within %.0fs "
                "(bound %d) — a runtime value is reaching a launch's "
                "static shape (latest: %r)", storm, self.storm_s,
                self.storm_n, sig)
            flight("launch_storm", fresh=storm, sig=repr(sig)[:120])
            flight_dump("launch storm")
        return seconds

    def snapshot(self) -> dict:
        """JSON-native per-signature view, the costliest first launch
        first."""
        with self._lock:
            items = [(repr(sig), dict(rec))
                     for sig, rec in self.sigs.items()]
        items.sort(key=lambda kv: -kv[1].get("first_s", 0.0))
        return {sig: {"n": rec["n"], "first_s": round(rec["first_s"], 6)}
                for sig, rec in items}


_observer: Optional[LaunchObserver] = None
_observer_lock = threading.Lock()


def launch_observer() -> LaunchObserver:
    """The process launch observer (constructed on first use)."""
    global _observer
    with _observer_lock:
        if _observer is None:
            _observer = LaunchObserver()
        return _observer


class observe_launch:
    """Context manager around each kernel launch of the model layer::

        with observe_launch(("devloop_span", variant, grid, body)) as ob:
            carry = devloop_span(...)
        # ob.first_s is set when this was the signature's first launch

    With the plane off this is one boolean check and no bookkeeping.
    """

    __slots__ = ("sig", "first_s", "_t0", "_on")

    def __init__(self, sig: tuple):
        self.sig = sig
        self.first_s: Optional[float] = None
        self._on = enabled()
        self._t0 = 0.0

    def __enter__(self) -> "observe_launch":
        if self._on:
            self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if self._on and exc_type is None:
            self.first_s = launch_observer().launch(
                self.sig, time.monotonic() - self._t0)


# ----------------------------------------------------------------- trackset


class TrackSet:
    """Export-track registry under the metrics cardinality bound.

    One track per miner and per tenant, identified by a labelled name
    like a metric series; past ``DBMT_METRICS_MAX_SERIES`` tracks a
    family collapses into one ``{overflow=true}`` track, and a track is
    retired where its entity dies (miner drop, tenant GC).
    """

    _OVERFLOW: Tuple[Tuple[str, str], ...] = (("overflow", "true"),)

    def __init__(self, max_tracks: Optional[int] = None):
        self.max_tracks = (max_tracks if max_tracks is not None
                           else _int_env("DBMT_METRICS_MAX_SERIES", 64))
        self._lock = threading.Lock()
        self._d: Dict[str, Dict[tuple, int]] = {}
        self._next_tid = 0
        self._overflows = 0

    @staticmethod
    def _key(labels: dict) -> tuple:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def track(self, name: str, **labels) -> int:
        """Stable integer track id for one labelled entity (registered on
        first sight; the overflow track past the bound)."""
        key = self._key(labels)
        with self._lock:
            family = self._d.setdefault(name, {})
            tid = family.get(key)
            if tid is None:
                if key and len(family) >= self.max_tracks \
                        and key != self._OVERFLOW:
                    self._overflows += 1
                    key = self._OVERFLOW
                    tid = family.get(key)
                if tid is None:
                    self._next_tid += 1
                    tid = family[key] = self._next_tid
            return tid

    def retire(self, name: str, **labels) -> None:
        """Free one entity's track slot (a no-op when absent)."""
        with self._lock:
            family = self._d.get(name)
            if family is not None:
                family.pop(self._key(labels), None)

    def items(self, name: str) -> list:
        """``[(labels_tuple, tid), ...]`` of one family's live tracks."""
        with self._lock:
            return list(self._d.get(name, {}).items())

    def __len__(self) -> int:
        with self._lock:
            return sum(len(f) for f in self._d.values())


# ------------------------------------------------------------- chrome export

#: Request events drawn as INSTANT markers on the owning tenant's track.
_INSTANT_EVENTS = ("lease_blown", "reissue", "quarantine", "park",
                   "queue_alarm", "inflight_alarm", "miner_drop",
                   "stale_result", "cache_hit")

#: Synthetic pids, one "process" per role: the scheduler (a thread per
#: tenant) and the miners (a thread per miner conn).
_PID_SCHED = 1
_PID_MINERS = 2


def _span_events(trace_dict: dict, base_us: int, t0_us: int,
                 tenant_tid: int, miner_tids: dict) -> list:
    """Chrome events of ONE stitched RequestTrace dict. The scheduler's
    timeline anchors everything: the request's slices on the tenant's
    track, and each ``miner_span`` laid out backwards from its fold
    stamp on the miner's track (a miner's clock is another process's; the
    span ships durations, the scheduler's stamp places them)."""
    events = trace_dict.get("events", [])
    meta = trace_dict.get("meta", {})
    key = trace_dict.get("key")
    out = []

    def at(ev) -> int:
        return t0_us + int(ev["t"] * 1e6) - base_us

    by_name: dict = {}
    for ev in events:
        by_name.setdefault(ev["event"], []).append(ev)
    enq = by_name.get("enqueue", [None])[0]
    disp = by_name.get("dispatch", [None])[0]
    done = (by_name.get("reply", []) or by_name.get("cancel", [None]))[0]
    args = {"key": str(key), "range": [meta.get("lower"),
                                       meta.get("upper")]}
    if meta.get("target"):
        args["target"] = meta["target"]
    if enq is not None and disp is not None:
        out.append({"name": "queued", "ph": "X", "pid": _PID_SCHED,
                    "tid": tenant_tid, "ts": at(enq),
                    "dur": max(0, at(disp) - at(enq)), "args": args})
    start = disp if disp is not None else enq
    if start is not None and done is not None:
        out.append({"name": f"request {key}", "ph": "X",
                    "pid": _PID_SCHED, "tid": tenant_tid, "ts": at(start),
                    "dur": max(0, at(done) - at(start)), "args": args})
    for name in _INSTANT_EVENTS:
        for ev in by_name.get(name, []):
            out.append({"name": name, "ph": "i", "s": "t",
                        "pid": _PID_SCHED, "tid": tenant_tid,
                        "ts": at(ev),
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("t", "event")}})
    for ev in by_name.get("miner_span", []):
        miner = str(ev.get("miner"))
        tid = miner_tids.get(miner)
        if tid is None:
            tid = miner_tids[miner] = \
                max(miner_tids.values(), default=0) + 1
        total_us = sum(int(float(ev.get(k, 0.0) or 0.0) * 1e6)
                       for k in SPAN_PHASES)
        ts = at(ev) - total_us
        sargs = {"job": str(key), "idx": ev.get("idx")}
        if ev.get("launch") is not None:
            sargs["launch"] = ev["launch"]
            sargs["lanes"] = ev.get("lanes")
        if ev.get("subs") is not None:
            sargs["subs"] = ev["subs"]
        if ev.get("slow"):
            sargs["slow"] = ev["slow"]
        # gap_s is the executor's idle time BEFORE the chunk: it renders
        # first, so the force slice ends at the fold stamp.
        for phase in ("gap_s",) + tuple(k for k in SPAN_PHASES
                                        if k != "gap_s"):
            dur = int(float(ev.get(phase, 0.0) or 0.0) * 1e6)
            if dur <= 0:
                continue
            out.append({"name": phase[:-2], "ph": "X", "pid": _PID_MINERS,
                        "tid": tid, "ts": ts, "dur": dur, "args": sargs})
            ts += dur
    return out


def to_chrome_trace(trace_dicts: list, tenant_tracks: Optional[dict] = None,
                    miner_tracks: Optional[dict] = None) -> dict:
    """Chrome trace-event JSON (loadable in ui.perfetto.dev) from
    stitched trace dicts (``RequestTrace.to_dict()`` plus an optional
    ``t0`` monotonic stamp; without one, traces are laid out in list
    order). ``tenant_tracks`` / ``miner_tracks`` map entity ids to track
    ids; unknown entities get tracks after the known ones. Events are
    sorted by (pid, tid, ts), so each track's timeline is monotonic."""
    tenant_tids = dict(tenant_tracks or {})
    miner_tids = dict(miner_tracks or {})
    t0s = [d.get("t0") for d in trace_dicts]
    known = [t for t in t0s if isinstance(t, (int, float))]
    base = min(known) if known else 0.0
    base_us = int(base * 1e6)
    events: list = []
    for i, d in enumerate(trace_dicts):
        t0 = d.get("t0")
        t0_us = int(t0 * 1e6) if isinstance(t0, (int, float)) \
            else base_us + i
        tenant = str(d.get("meta", {}).get("client"))
        tid = tenant_tids.get(tenant)
        if tid is None:
            tid = tenant_tids[tenant] = \
                max(tenant_tids.values(), default=0) + 1
        events.extend(_span_events(d, base_us, t0_us, tid, miner_tids))
    meta = [
        {"name": "process_name", "ph": "M", "pid": _PID_SCHED, "tid": 0,
         "args": {"name": "scheduler"}},
        {"name": "process_name", "ph": "M", "pid": _PID_MINERS, "tid": 0,
         "args": {"name": "miners"}},
    ]
    for tenant, tid in sorted(tenant_tids.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": _PID_SCHED,
                     "tid": tid, "args": {"name": f"tenant {tenant}"}})
    for miner, tid in sorted(miner_tids.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": _PID_MINERS,
                     "tid": tid, "args": {"name": f"miner {miner}"}})
    events.sort(key=lambda e: (e["pid"], e["tid"], e["ts"],
                               -e.get("dur", 0)))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}
