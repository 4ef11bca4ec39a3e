"""Workload capture and replay: the traffic the system served, as a workload.

Counterpart of the JAX package's ``apps/capture.py``; the file format is
the same (:data:`CAPTURE_VERSION` 1), so a capture written by either
package loads in the other.

- **Capture** (``DBMT_CAPTURE``, default 0: with the knob off no capture
  object exists anywhere and every scheduler hook is one attribute test):
  the scheduler's arrival, reply, shed, cancel, re-issue and span hooks
  append one compact JSON line each to a versioned *workload trace*: per
  request its arrival stamp (relative to the capture's epoch), a HASHED
  tenant key (salted SHA-256: tenants stay distinct within a capture and
  cannot be recovered from it), its geometry (range size, arg-min or
  difficulty, the data's pow2 size class); shed, cancel and re-issue
  events; and a pool snapshot (miner count, rate EWMAs, queue depth)
  riding the sweep. The file is bounded: past ``DBMT_CAPTURE_LINES``
  lines it is renamed to ``<path>.1`` (the previous ``.1`` goes) and a new
  file starts with its own header, so every window loads alone.
- **Replay** (:func:`load_capture`, :func:`replay_plan`): a capture
  becomes a deterministic schedule of tenants and requests that keeps
  each hashed tenant's inter-arrival process and the geometry mix;
  ``apps.loadharness.run_replay`` (detnet) and ``run_replay_procs`` (the
  process tier over UDP) re-send it, warped by ``DBMT_REPLAY_SPEED``
  (:func:`replay_speed`).
- **Fidelity** (:func:`capture_baseline`, :func:`fidelity`): a replay's
  report beside the capture's own numbers (admitted/s, shed rate,
  p50/p99, the span phases' medians), within the stated
  :data:`FIDELITY_BOUNDS`.

Records (one JSON object a line; short keys):

- ``{"k": "hdr", "v": 1, "t0": <epoch seconds>, "snap_s": ...}`` starts
  every file, rotated ones too; readers refuse other versions;
- ``{"k": "cfg", ...}``: the scheduler's workload-shape knobs;
- ``{"k": "req", "t": ..., "ten": "<hash>", "n": <range size>,
  "mode": "argmin"|"diff", "dc": <pow2 data-size class>}``;
- ``{"k": "rep", "t": ..., "ten": ..., "el": <reply latency>}``
  (``"cached": true`` for a result-cache replay);
- ``{"k": "shed", "t": ..., "ten": ..., "why": ...}``,
  ``{"k": "cancel", "t": ..., "ten": ..., "n": ...}``,
  ``{"k": "reissue", "t": ...}``;
- ``{"k": "span", "t": ..., "queue_s": ..., "force_s": ..., ...}``: a
  miner's chunk span as it folds at the scheduler;
- ``{"k": "pool", "t": ..., "miners": N, "rates": [...],
  "queued": ..., "inflight": ...}``: the pool snapshot.

Knobs (``utils.config.capture_from_env``): ``DBMT_CAPTURE``,
``DBMT_CAPTURE_PATH`` (default ``dbmt_capture.jsonl``),
``DBMT_CAPTURE_LINES``, ``DBMT_CAPTURE_SNAP_S``; :func:`replay_speed`:
``DBMT_REPLAY_SPEED``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from statistics import median
from typing import Dict, List, Optional

from ..utils import metrics as _metrics
from ..utils._env import float_env
from ..utils.config import capture_from_env
from ..utils.trace import SPAN_PHASES

__all__ = ["WorkloadCapture", "Capture", "enabled", "ensure_from_env",
           "close_active", "load_capture", "capture_baseline",
           "replay_plan", "fidelity", "replay_speed",
           "CAPTURE_VERSION", "FIDELITY_BOUNDS"]

#: Capture record-schema version; bumped on any incompatible change.
#: :func:`load_capture` refuses files whose header carries a different
#: version — a replay of a misread geometry would "pass" fidelity on
#: the wrong workload, which is worse than failing loudly.
CAPTURE_VERSION = 1

#: Stated fidelity bounds (the ``within`` gate): a replay on the same
#: harness must land inside these against the capture's own numbers.
#: Generous on purpose: the gate catches a failure of SHAPE (half the
#: arrivals missing, a shed storm that did not come back, a latency off by
#: an order of magnitude), not the scheduler's jitter.
#: ``admitted_ratio`` and ``p99_ratio`` are replay over capture (admitted
#: rescaled by the replay speed); ``shed_delta`` is an absolute shed-rate
#: difference.
FIDELITY_BOUNDS = {
    "admitted_ratio": (0.4, 2.5),
    "p99_ratio": (0.2, 5.0),
    "shed_delta": 0.25,
}


def enabled() -> bool:
    """True when the capture plane is on (``DBMT_CAPTURE``, default 0),
    read at each call. Off by default: capture writes a line a request,
    and an operator arms it for an incident or a soak."""
    return capture_from_env().enabled


def replay_speed() -> float:
    """``DBMT_REPLAY_SPEED`` (default 1.0; not above 0 reads as 1.0): the
    replay's time warp. The captured gaps are divided by it, so 4.0
    re-sends an hour in fifteen minutes; the rate-limited miners the
    replay models run that much faster too. Read at each call."""
    v = float_env("DBMT_REPLAY_SPEED", 1.0)
    return v if v > 0 else 1.0


def _pow2_class(n: int) -> int:
    """pow2 size class of a byte/char count (0 for empty)."""
    return max(0, int(n)).bit_length()


class WorkloadCapture:
    """The writing side of the capture plane (held by the scheduler).

    One instance per capture file; :func:`ensure_from_env` hands every
    scheduler of the process the same one (the in-process replica tier
    writes ONE trace with one epoch). A record costs one ``json.dumps``
    and one line-buffered write under a lock. ``path``, ``max_lines`` and
    ``snap_s`` default to the environment's (``DBMT_CAPTURE_PATH``,
    ``DBMT_CAPTURE_LINES``, ``DBMT_CAPTURE_SNAP_S``).
    """

    def __init__(self, path: Optional[str] = None,
                 max_lines: Optional[int] = None,
                 snap_s: Optional[float] = None):
        env = capture_from_env()
        self.path = path if path is not None else env.path
        self.max_lines = max_lines if max_lines is not None \
            else env.max_lines
        self.snap_s = snap_s if snap_s is not None else env.snap_s
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        # Tenant keys are salted per capture: identities stay DISTINCT
        # inside one trace (the replay needs the per-tenant arrival
        # process) but unlinkable across captures and unrecoverable
        # from the file.
        self._salt = os.urandom(8).hex()
        self._keys: Dict[object, str] = {}     # conn -> hashed tenant key
        self._cfg: dict = {}     # last attach config, re-emitted on rotation
        self._lines = 0          # lines in the CURRENT file
        self._total = 0          # lines over the capture's lifetime
        self._rotations = 0
        self.closed = False
        self._last_snap = float("-inf")
        reg = _metrics.registry()
        self._rec_counter = reg.counter("capture.records")
        self._rot_counter = reg.counter("capture.rotations")
        self._drop_counter = reg.counter("capture.write_errors")
        # Line-buffered: every record reaches the OS as it is written,
        # so a process killed by a signal (atexit does not run on
        # SIGTERM) loses nothing.
        self._fh = open(self.path, "w", encoding="utf-8", buffering=1)
        self._write_header()
        # Crash artifacts name the active workload: flight-recorder dumps
        # and the metrics snapshots read this slot. The bound method is
        # pinned once (clear_capture_info compares by identity).
        self._info_fn = self.info
        _metrics.set_capture_info(self._info_fn)

    # ------------------------------------------------------------- writing

    def _write_header(self) -> None:
        self._fh.write(json.dumps(
            {"k": "hdr", "v": CAPTURE_VERSION,
             "t0": round(time.time(), 3), "snap_s": self.snap_s},
            sort_keys=True) + "\n")
        self._lines += 1
        self._total += 1

    def _rotate_locked(self) -> None:
        """The disk bound: the current file becomes ``.1`` (the previous
        ``.1`` goes) and a new one starts with its own header, so at most
        about two windows are on disk and each loads alone. The attach
        config is written again too: a window replayed alone keeps the
        workload-shape knobs and the transport tag."""
        self._fh.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass
        self._fh = open(self.path, "w", encoding="utf-8", buffering=1)
        self._lines = 0
        self._rotations += 1
        self._rot_counter.inc()
        self._write_header()
        if self._cfg:
            rec = {"k": "cfg", "t": self._t()}
            rec.update(self._cfg)
            self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
            self._lines += 1
            self._total += 1

    def _w(self, rec: dict) -> None:
        if self.closed:
            return
        line = json.dumps(rec, sort_keys=True)
        with self._lock:
            if self.closed:
                return
            try:
                self._fh.write(line + "\n")
                self._lines += 1
                self._total += 1
                if self._lines >= self.max_lines:
                    self._rotate_locked()
            except (OSError, ValueError):
                # A full disk / closed handle must never take the
                # scheduler down — capture is observability-only.
                self._drop_counter.inc()
                return
        self._rec_counter.inc()

    def _t(self) -> float:
        return round(time.monotonic() - self._t0, 6)

    def info(self) -> dict:
        """``{"path", "lines", "rotations"}`` — what crash artifacts
        embed so they name the workload that produced them."""
        return {"path": self.path, "lines": self._lines,
                "rotations": self._rotations}

    def tenant_key(self, conn_id) -> str:
        """The salted tenant hash, memoized per conn (a request looks it
        up at arrival and at reply). The memo is bounded by a clear, not
        an LRU: dropping it only costs re-hashing."""
        key = self._keys.get(conn_id)
        if key is None:
            if len(self._keys) >= 65536:
                self._keys.clear()
            key = self._keys[conn_id] = hashlib.sha256(
                f"{self._salt}:{conn_id}".encode()).hexdigest()[:10]
        return key

    # ------------------------------------------------------------ the hooks

    def config(self, **kw) -> None:
        """Scheduler attach: workload-shape knobs a replay reproduces
        (kept for re-emission into every rotated-in window)."""
        self._cfg.update(kw)
        rec = {"k": "cfg", "t": self._t()}
        rec.update(kw)
        self._w(rec)

    def request(self, conn_id, data_len: int, nonces: int,
                difficulty: bool) -> None:
        self._w({"k": "req", "t": self._t(),
                 "ten": self.tenant_key(conn_id), "n": int(nonces),
                 "mode": "diff" if difficulty else "argmin",
                 "dc": _pow2_class(data_len)})

    def reply(self, conn_id, elapsed_s: float,
              cached: bool = False) -> None:
        rec = {"k": "rep", "t": self._t(),
               "ten": self.tenant_key(conn_id),
               "el": round(elapsed_s, 6)}
        if cached:
            rec["cached"] = True
        self._w(rec)

    def shed(self, conn_id, reason: str) -> None:
        self._w({"k": "shed", "t": self._t(),
                 "ten": self.tenant_key(conn_id), "why": reason})

    def cancel(self, conn_id, n: int = 1) -> None:
        self._w({"k": "cancel", "t": self._t(),
                 "ten": self.tenant_key(conn_id), "n": int(n)})

    def reissue(self) -> None:
        self._w({"k": "reissue", "t": self._t()})

    def span(self, span: dict) -> None:
        """One miner-side chunk span as it folds at the scheduler —
        only the fixed phase vocabulary survives (same whitelist rule
        as the trace fold: a hostile peer cannot inject keys)."""
        rec = {"k": "span", "t": self._t()}
        for key in SPAN_PHASES:
            v = span.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                rec[key] = round(float(v), 6)
        if len(rec) > 2:
            self._w(rec)

    def maybe_snapshot(self, miners: int, rates: List[float],
                       queued: int, inflight: int) -> None:
        """Pool-composition snapshot, at most once per ``snap_s``
        (rides the scheduler sweep). Doubles as the flush cadence."""
        now = time.monotonic()
        if now - self._last_snap < self.snap_s:
            return
        self._last_snap = now
        self._w({"k": "pool", "t": self._t(), "miners": int(miners),
                 "rates": [round(float(r), 1) for r in rates],
                 "queued": int(queued), "inflight": int(inflight)})
        self.flush()

    # ----------------------------------------------------------- lifecycle

    def flush(self) -> None:
        with self._lock:
            if not self.closed:
                try:
                    self._fh.flush()
                except (OSError, ValueError):
                    self._drop_counter.inc()

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            try:
                self._fh.close()
            except OSError:
                pass
        _metrics.clear_capture_info(self._info_fn)


_active: Optional[WorkloadCapture] = None
_active_lock = threading.Lock()
_atexit_registered = False


def ensure_from_env() -> Optional[WorkloadCapture]:
    """The process capture, or None when ``DBMT_CAPTURE=0`` (default).

    Every scheduler calls this at construction; with the knob off it
    returns None and no capture state exists anywhere. With it on,
    every scheduler of the process shares ONE capture (the in-process
    replica tier writes one trace with one epoch), closed (flushed) at
    interpreter exit."""
    if not enabled():
        return None
    global _active, _atexit_registered
    with _active_lock:
        if _active is None or _active.closed:
            _active = WorkloadCapture()
            if not _atexit_registered:
                import atexit
                atexit.register(close_active)
                _atexit_registered = True
        return _active


def close_active() -> None:
    """Flush + close the process capture (tests, CLI teardown)."""
    global _active
    with _active_lock:
        cap, _active = _active, None
    if cap is not None:
        cap.close()


# ------------------------------------------------------------------ reading


class Capture:
    """Parsed view of one capture file (the replay side's input)."""

    def __init__(self, header: dict):
        self.header = header
        self.cfg: dict = {}
        self.reqs: List[dict] = []
        self.reps: List[dict] = []
        self.sheds: List[dict] = []
        self.cancels: List[dict] = []
        self.reissues: int = 0
        self.spans: List[dict] = []
        self.pools: List[dict] = []

    def pool_rates(self) -> List[float]:
        """Per-miner rate EWMAs from the LAST pool snapshot (newest
        composition wins — that is the pool a replay should model)."""
        for rec in reversed(self.pools):
            rates = [float(r) for r in rec.get("rates", ())
                     if isinstance(r, (int, float)) and r > 0]
            if rates:
                return rates
        return []


def load_capture(path: str) -> Capture:
    """Parse one capture file; raises ``ValueError`` on a missing or
    unknown-version header. A torn tail line (a crash mid-write) is
    skipped; a rotated capture's ``.1`` window is not read with it (each
    file stands alone)."""
    cap: Optional[Capture] = None
    with open(path, encoding="utf-8") as fh:
        for raw in fh:
            raw = raw.strip()
            if not raw:
                continue
            try:
                rec = json.loads(raw)
            except ValueError:
                continue       # torn tail / foreign line
            if not isinstance(rec, dict):
                continue
            kind = rec.get("k")
            if cap is None:
                if kind != "hdr":
                    raise ValueError(
                        f"{path}: not a workload capture (first record "
                        f"is {kind!r}, expected a 'hdr' header)")
                if rec.get("v") != CAPTURE_VERSION:
                    raise ValueError(
                        f"{path}: unsupported capture version "
                        f"{rec.get('v')!r} (this reader speaks "
                        f"{CAPTURE_VERSION}); refusing to replay a "
                        f"schema it might misread")
                cap = Capture(rec)
                continue
            if kind == "hdr":
                # A rotation boundary inside one file cannot happen
                # (rotation renames); a concatenation of windows is
                # fine as long as versions agree.
                if rec.get("v") != CAPTURE_VERSION:
                    raise ValueError(
                        f"{path}: mixed capture versions "
                        f"({rec.get('v')!r} after {CAPTURE_VERSION})")
            elif kind == "cfg":
                cap.cfg.update({k: v for k, v in rec.items()
                                if k not in ("k", "t")})
            elif kind == "req":
                cap.reqs.append(rec)
            elif kind == "rep":
                cap.reps.append(rec)
            elif kind == "shed":
                cap.sheds.append(rec)
            elif kind == "cancel":
                cap.cancels.append(rec)
            elif kind == "reissue":
                cap.reissues += 1
            elif kind == "span":
                cap.spans.append(rec)
            elif kind == "pool":
                cap.pools.append(rec)
            # Unknown SAME-version record kinds are skipped (forward-
            # compatible additions); unknown versions were refused.
    if cap is None:
        raise ValueError(f"{path}: empty capture (no header)")
    return cap


def capture_baseline(cap: Capture,
                     tenants: Optional[set] = None) -> dict:
    """The capture's OWN numbers — the fidelity report's left column.

    Same shape as a harness leg: requests/completed/shed counts,
    admitted/s over the capture's active window, reply p50/p99, and
    per-phase span medians. ``tenants`` restricts the tenant-keyed
    records to one hashed-key subset: a replay cut to ``max_tenants``
    compares against the same tenants' baseline (spans carry no tenant
    key and always feed the phase medians)."""
    if tenants is not None:
        cap = _restrict(cap, tenants)
    # Cache replays (el 0.0) stay out of the latency percentiles: a
    # replay runs with the result cache off and recomputes every request,
    # so they would deflate the baseline's p50/p99. They still count as
    # completed: the replay answers those arrivals too.
    lats = sorted(float(r.get("el", 0.0)) for r in cap.reps
                  if not r.get("cached"))
    stamps = ([r["t"] for r in cap.reqs]
              + [r["t"] for r in cap.reps] + [r["t"] for r in cap.sheds])
    makespan = (max(stamps) - min(stamps)) if stamps else 0.0
    completed = len(cap.reps)
    total = len(cap.reqs)

    def pct(q: float):
        if not lats:
            return None
        return round(lats[min(len(lats) - 1, int(q * len(lats)))], 6)

    out = {
        "requests": total,
        "completed": completed,
        "shed_requests": len(cap.sheds),
        "shed_rate": round(len(cap.sheds) / total, 4) if total else 0.0,
        "makespan_s": round(makespan, 3),
        "admitted_per_s": round(completed / makespan, 1)
        if makespan > 0 else None,
        "p50_s": pct(0.50),
        "p99_s": pct(0.99),
    }
    phases: Dict[str, list] = {}
    for rec in cap.spans:
        for ph in SPAN_PHASES:
            v = rec.get(ph)
            if isinstance(v, (int, float)):
                phases.setdefault(ph, []).append(float(v))
    trace = {"spans": len(cap.spans)}
    for ph, xs in sorted(phases.items()):
        trace[f"miner_{ph}_p50"] = round(median(xs), 6)
    out["trace"] = trace
    return out


def _restrict(cap: Capture, tenants: set) -> Capture:
    """A view of ``cap`` with tenant-keyed records filtered to
    ``tenants`` (hashed keys); spans/pools/cfg pass through."""
    out = Capture(cap.header)
    out.cfg = cap.cfg
    out.reqs = [r for r in cap.reqs if str(r.get("ten")) in tenants]
    out.reps = [r for r in cap.reps if str(r.get("ten")) in tenants]
    out.sheds = [r for r in cap.sheds if str(r.get("ten")) in tenants]
    out.cancels = [r for r in cap.cancels
                   if str(r.get("ten")) in tenants]
    out.reissues = cap.reissues
    out.spans = cap.spans
    out.pools = cap.pools
    return out


def replay_plan(cap: Capture, max_tenants: Optional[int] = None) -> list:
    """Deterministic tenant/request schedule from a capture.

    ``[{"name", "start", "reqs": [(offset_s, nonces, mode, dc), ...]},
    ...]`` — tenants in first-arrival order (``r0``, ``r1``, ...),
    ``start`` relative to the first captured arrival, per-request
    offsets relative to the tenant's own start. The same capture always
    yields the same plan (the round-trip determinism contract); the
    replayer owns the speed warp and the transport."""
    by_tenant: Dict[str, List[dict]] = {}
    order: List[str] = []
    for rec in cap.reqs:
        ten = str(rec.get("ten"))
        if ten not in by_tenant:
            by_tenant[ten] = []
            order.append(ten)
        by_tenant[ten].append(rec)
    if max_tenants is not None:
        order = order[:max_tenants]
    t_first = min((r["t"] for r in cap.reqs), default=0.0)
    plan = []
    for i, ten in enumerate(order):
        recs = by_tenant[ten]
        start = recs[0]["t"] - t_first
        plan.append({
            "name": f"r{i}",
            "ten": ten,        # source hashed key (baseline restriction)
            "start": round(start, 6),
            "reqs": [(round(r["t"] - recs[0]["t"], 6),
                      max(1, int(r.get("n", 1))),
                      str(r.get("mode", "argmin")),
                      int(r.get("dc", 3))) for r in recs],
        })
    return plan


def fidelity(base: dict, rep: dict, speed: float = 1.0,
             bounds: Optional[dict] = None) -> dict:
    """Side-by-side fidelity verdict: replay ``rep`` vs capture
    ``base`` (both the harness measurement shape). ``admitted_ratio``
    is rescaled by ``speed`` (a 4x time-warp legitimately admits 4x/s);
    the p99 bound only applies at speed 1.0 (service latency does not
    follow the arrival clock)."""
    bounds = dict(FIDELITY_BOUNDS, **(bounds or {}))
    out: dict = {"speed": speed}
    violations: List[str] = []
    # Only a missing or zero baseline (nothing to divide by) skips a
    # ratio: a near-dead replay's admitted/s of 0.0 must still gate.
    b_adm, r_adm = base.get("admitted_per_s"), rep.get("admitted_per_s")
    if b_adm and r_adm is not None:
        ratio = (r_adm / speed) / b_adm
        out["admitted_ratio"] = round(ratio, 3)
        # A bound of None reports the ratio without gating it (a replay
        # over another transport, whose service latency differs).
        if bounds["admitted_ratio"] is not None:
            lo, hi = bounds["admitted_ratio"]
            if not lo <= ratio <= hi:
                violations.append(
                    f"admitted/s ratio {ratio:.3f} outside [{lo}, {hi}]")
    b_p99, r_p99 = base.get("p99_s"), rep.get("p99_s")
    if b_p99 and r_p99 is not None:
        ratio = r_p99 / b_p99
        out["p99_ratio"] = round(ratio, 3)
        if bounds["p99_ratio"] is not None and speed == 1.0:
            lo, hi = bounds["p99_ratio"]
            if not lo <= ratio <= hi:
                violations.append(
                    f"p99 ratio {ratio:.3f} outside [{lo}, {hi}]")
    b_shed = base.get("shed_rate") or 0.0
    r_shed = rep.get("shed_rate") or 0.0
    delta = abs(r_shed - b_shed)
    out["shed_delta"] = round(delta, 4)
    if bounds["shed_delta"] is not None and delta > bounds["shed_delta"]:
        violations.append(
            f"shed-rate delta {delta:.3f} over {bounds['shed_delta']}")
    if base.get("requests") and rep.get("requests") is not None \
            and rep["requests"] != base["requests"]:
        violations.append(
            f"replay drove {rep['requests']} requests for "
            f"{base['requests']} captured arrivals")
    out["within"] = not violations
    out["violations"] = violations
    return out
