"""The self-tuning control plane: setpoint controllers of the dispatch
knobs (``DBMT_ADAPT``, default 1).

Counterpart of the JAX package's ``apps/adapt.py``. Three small
controllers, each fed only by signals the scheduler already collects
(the lease plane's stamps, the Results' spans, the queue's stamps):

- :class:`ChunkSizeController` drives the QoS grant-chunk seconds AND the
  stripe-chunk seconds (one value: both mean "seconds of work a dispatch
  unit") toward a FORCE-LATENCY setpoint a chunk (``force_s``), from the
  miner's ``force_s`` span when one rides the Result, else the service
  time the lease plane stamps. AIMD with a dead band: additive increase
  below the band, multiplicative decrease above it, and a decrease
  whatever the latency when a chunk finishes with under a quarter of its
  lease left. Per-miner mode forks a value a miner once the pool's rates
  diverge (``MinerPlane.chunk_s_overrides``).
- :class:`CoalesceWindowController` widens the coalescing window's
  smallness bound (``small_s``) when mice arrive fast enough to stack
  rows in a wider window while queue wait is not trivial, and collapses
  it when the miners' ``gap_s`` spans show pipeline bubbles.
- :class:`AdmissionController`: a scheduler-wide token bucket whose rate
  is AIMD-controlled on the slope of the oldest queued request's age
  (open at its ceiling until congestion is seen), floored at a share of
  the measured service rate, with a queue bound of the depth that costs
  ``MIN_AGE_S`` of wait at that rate.

Each value has hard floors and ceilings (class constants), a gauge
(``adapt_chunk_s``, ``adapt_small_s``, ``adapt_admit_rate``), adjustment
counters, flight-recorder events and a bounded history that
:func:`oscillation_ratios` audits. ``DBMT_ADAPT=0`` mounts nothing: every
hook of the scheduler is one ``is None`` test. The controllers read the
clock they are given at each call (the scheduler hands them its own), so
a test's fake clock reaches them.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..utils import trace as _tracing
from ..utils.config import AdaptParams
from ..utils.metrics import Registry
from .qos import TokenBucket



def _monotonic() -> float:
    """``time.monotonic`` read through this module at each call."""
    return time.monotonic()


__all__ = ["AdaptPlane", "AimdValue", "ChunkSizeController",
           "CoalesceWindowController", "AdmissionController",
           "oscillation_ratio", "oscillation_ratios"]

#: Bounded per-controller value history (old entries roll off).
HISTORY = 512


def oscillation_ratios(history) -> List[float]:
    """Peak/trough ratios of the POST-TRANSIENT swings of one
    controller's ``[(t, value), ...]`` history.

    The initial monotone run (e.g. the admission controller descending
    from its open ceiling to the observed capacity) is a transient, not
    an oscillation — it is skipped up to and including the FIRST
    direction reversal. After that, every adjacent local-extremum
    pair's ``hi / lo`` ratio is one swing's amplitude (the history's
    final value closes the last swing). For a healthy AIMD loop each
    swing is bounded by ~``(1/mul) * (1 + band)`` — one multiplicative
    step plus the dead-band the capped probe crosses.

    A stability audit tolerates ONE
    swing over its amplitude bound per history — a congestion episode
    is exactly that shape (an anchored multiplicative descent, then
    the recovery ramp back toward open, which this function's endpoint
    rule counts as the episode's second half) — and fails on TWO: a
    loop that repeatedly swings wide is fighting its own measurement
    (limit cycle), not riding out one load change.
    """
    values = [v for _t, v in history]
    if len(values) < 3:
        return []
    # Local extrema of the piecewise-monotone value series.
    extrema: List[float] = []
    direction = 0
    for prev, curr in zip(values, values[1:]):
        if curr == prev:
            continue
        d = 1 if curr > prev else -1
        if direction and d != direction:
            extrema.append(prev)
        direction = d
    extrema.append(values[-1])
    if len(extrema) < 3:
        return []           # at most the transient + its end: no swing
    # extrema[0] ends the initial transient; ratios start after it.
    out: List[float] = []
    for a, b in zip(extrema[1:], extrema[2:]):
        hi, lo = max(a, b), max(min(a, b), 1e-12)
        out.append(hi / lo)
    return out


def oscillation_ratio(history) -> float:
    """Worst single post-transient swing amplitude (1.0 when the
    history has no closed swing) — see :func:`oscillation_ratios`."""
    return max(oscillation_ratios(history), default=1.0)


class _Ewma:
    """Tiny fixed-alpha EWMA (the metrics registry's EWMA is
    wall-clock-aware; controllers want a plain sample smoother)."""

    __slots__ = ("alpha", "value")

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.value: Optional[float] = None

    def observe(self, x: float) -> float:
        self.value = x if self.value is None else \
            self.alpha * x + (1 - self.alpha) * self.value
        return self.value


class AimdValue:
    """One AIMD-governed value with hard floor/ceiling clamps and a
    bounded ``(t, value)`` history.

    ``increase()`` adds ``max(add, add_frac * value)`` (a bounded
    proportional probe — pure constant-additive would take minutes to
    recover a rate that was halved from 10^4) CAPPED at a 2x growth
    ratio per step: near the floor a constant step is a huge RELATIVE
    move (0.05 -> 0.30 is 6x, an oscillation-amplitude violation), and
    the cap is what keeps the sawtooth's peak/trough ratio bounded at
    every value scale.
    ``decrease()`` multiplies by ``mul``. Both clamp and both record
    history only when the value actually moved — the clamps are HARD:
    no sequence of observations can push the value outside
    ``[floor, ceil]``, which is the no-launch-storm /
    no-starvation safety argument.
    """

    __slots__ = ("value", "floor", "ceil", "add", "add_frac", "mul",
                 "history", "adjustments", "_clock")

    def __init__(self, value: float, floor: float, ceil: float,
                 add: float, mul: float = 0.5, add_frac: float = 0.0,
                 clock: Callable[[], float] = _monotonic):
        self.floor = floor
        self.ceil = ceil
        self.add = add
        self.add_frac = add_frac
        self.mul = mul
        self._clock = clock
        self.value = min(ceil, max(floor, value))
        self.adjustments = 0
        self.history: deque = deque([(clock(), self.value)],
                                    maxlen=HISTORY)

    def _set(self, v: float) -> bool:
        v = min(self.ceil, max(self.floor, v))
        if v == self.value:
            return False
        self.value = v
        self.adjustments += 1
        self.history.append((self._clock(), v))
        return True

    def increase(self) -> bool:
        step = max(self.add, self.add_frac * self.value)
        return self._set(min(self.value + step, 2.0 * self.value))

    def decrease(self) -> bool:
        return self._set(self.value * self.mul)

    def decrease_floored(self, floor: Optional[float]) -> bool:
        """Multiplicative decrease that never lands below ``floor`` —
        and HOLDS (no change) when the value already sits at or under
        it: a decrease signal at a value the anchor says is sustainable
        is backlog drain, not fresh congestion."""
        if floor is not None and self.value <= floor:
            return False
        v = self.value * self.mul
        if floor is not None:
            v = max(v, floor)
        return self._set(v)


class ChunkSizeController:
    """Drive the chunk/stripe seconds-of-work knob toward a per-chunk
    force-latency setpoint (module docstring, controller 1).

    Per-miner mode (``DBMT_ADAPT_PER_MINER``, default off): in a
    HETEROGENEOUS pool a 100x rate skew means one pool-wide seconds-of-work
    value cannot hit both tiers' setpoints —
    the mesh miner's chunks force in milliseconds while the host tier's
    force in seconds, and the blended EWMA tunes for neither. With
    ``per_miner`` the controller ALSO keys force-latency samples by
    miner conn, and once the pool's rate EWMAs diverge past
    ``PER_MINER_RATIO`` (:meth:`note_rate_ratio` — fed from the miner
    plane's own EWMAs each tick) it forks a per-miner AIMD value
    (seeded from the pool-wide value) per sampled miner and runs the
    identical setpoint/settle logic per miner
    (:meth:`tick_miners`). The per-miner values drive the STRIPE
    planner through ``MinerPlane.chunk_s_overrides``; the pool-wide
    value keeps driving the (miner-agnostic) QoS chunk plan. While the
    pool is NOT diverged the per-miner state only accumulates samples
    — one knob is enough, and forking it would just add noise."""

    #: Rate-EWMA max/min ratio past which per-miner setpoints fork.
    PER_MINER_RATIO = 4.0

    #: Hard clamps on seconds-of-work per chunk. The floor keeps a
    #: mispriced pool from shattering requests into confetti (and the
    #: resulting fresh launch signatures from storming the observer);
    #: the ceiling bounds how much work one lease can put at risk.
    FLOOR_S = 0.05
    CEIL_S = 10.0
    #: Additive step per adjustment interval, seconds.
    ADD_S = 0.25
    #: Observed lease-margin fraction below which the controller
    #: decreases REGARDLESS of the latency error: chunks finishing with
    #: <25% of their lease left are one stall away from a blow.
    MARGIN_FLOOR = 0.25

    def __init__(self, value: float, setpoint_s: float, band: float,
                 clock: Callable[[], float] = _monotonic,
                 per_miner: bool = False):
        self.setpoint_s = setpoint_s
        self.band = band
        self._clock = clock
        self.per_miner = per_miner
        self.aimd = AimdValue(value, self.FLOOR_S, self.CEIL_S,
                              self.ADD_S, clock=clock)
        self._latency = _Ewma()
        self._min_margin: Optional[float] = None
        self._samples = 0
        self._settle = False
        self._miners: Dict[int, dict] = {}
        self._diverged = False
        self._unfork_pending = False

    def observe(self, service_s: Optional[float],
                margin_frac: Optional[float],
                force_s: Optional[float] = None,
                miner: Optional[int] = None) -> None:
        """One answered chunk: miner-side ``force_s`` span when it rode
        the Result, else the scheduler-side service time the lease plane
        stamped; plus the chunk's remaining-lease fraction. ``miner``
        (the answering conn id) keys the per-miner sample stream when
        per-miner mode is on."""
        lat = force_s if force_s is not None else service_s
        if lat is not None and lat >= 0:
            self._latency.observe(lat)
            self._samples += 1
        if margin_frac is not None:
            self._min_margin = margin_frac if self._min_margin is None \
                else min(self._min_margin, margin_frac)
        if self.per_miner and miner is not None:
            st = self._miners.get(miner)
            if st is None:
                st = self._miners[miner] = {
                    "lat": _Ewma(), "n": 0, "margin": None,
                    "aimd": None, "settle": False}
            if lat is not None and lat >= 0:
                st["lat"].observe(lat)
                st["n"] += 1
            if margin_frac is not None:
                st["margin"] = margin_frac if st["margin"] is None \
                    else min(st["margin"], margin_frac)

    def note_rate_ratio(self, ratio: Optional[float]) -> None:
        """Current pool rate-EWMA max/min ratio (None when fewer than
        two measured miners): the divergence gate for per-miner
        forking."""
        if self.per_miner:
            self._diverged = (ratio is not None
                              and ratio > self.PER_MINER_RATIO)

    def forget_miner(self, miner: int) -> None:
        """Retire a dropped miner's sample stream + forked value (conn
        churn must not grow the map without bound)."""
        self._miners.pop(miner, None)

    def unfork_pending(self) -> bool:
        """True ONCE after the pool re-converges with forked values
        live: the caller must clear its per-miner overrides so the
        pool-wide knob governs again (a stale fork would shadow it
        forever)."""
        out = self._unfork_pending
        self._unfork_pending = False
        return out

    def tick_miners(self) -> Dict[int, float]:
        """Per-miner adjustment pass: ``{conn: new_chunk_s}`` for every
        miner whose forked value moved this tick; empty while the pool
        is not diverged (pool-wide value governs alone). Same AIMD +
        hysteresis + margin guard + SETTLE-tick logic as the pool-wide
        :meth:`tick`, per miner. While NOT diverged, each tick DRAINS
        the per-miner sample accumulators (a later fork must decide
        from fresh post-divergence samples, not latency/margin history
        taken under long-gone chunk sizes — the same stale-sample rule
        the pool-wide settle tick enforces) and retires any forked
        values (flagging :meth:`unfork_pending`)."""
        if not (self.per_miner and self._diverged):
            for st in self._miners.values():
                if st["n"] or st["margin"] is not None:
                    st["lat"] = _Ewma()
                    st["n"] = 0
                    st["margin"] = None
                if st["aimd"] is not None:
                    st["aimd"] = None
                    st["settle"] = False
                    self._unfork_pending = True
            return {}
        out: Dict[int, float] = {}
        for conn, st in self._miners.items():
            if not st["n"]:
                continue
            lat = st["lat"].value
            margin = st["margin"]
            st["n"] = 0
            st["margin"] = None
            if st["settle"]:
                st["settle"] = False
                st["lat"] = _Ewma()
                continue
            if st["aimd"] is None:
                # Forked at first divergence, seeded from the pool-wide
                # value so the per-miner walk starts where the pool is.
                st["aimd"] = AimdValue(self.aimd.value, self.FLOOR_S,
                                       self.CEIL_S, self.ADD_S,
                                       clock=self._clock)
            changed = None
            if (margin is not None and margin < self.MARGIN_FLOOR) or \
                    lat > self.setpoint_s * (1 + self.band):
                if st["aimd"].decrease():
                    changed = st["aimd"].value
            elif lat < self.setpoint_s * (1 - self.band):
                if st["aimd"].increase():
                    changed = st["aimd"].value
            if changed is not None:
                st["settle"] = True
                st["lat"] = _Ewma()
                out[conn] = changed
        return out

    def tick(self) -> Optional[float]:
        """One adjustment interval; returns the new value or None.

        After every adjustment the controller takes one SETTLE tick —
        it drains (and discards) the samples still arriving from
        chunks granted at the OLD size, and resets the latency EWMA so
        the next decision measures only post-change chunks. Without
        this, measurement lag turns one honest decrease into a
        multiplicative cascade (stale large-chunk samples keep the
        EWMA above the band for several ticks) followed by the mirror
        overshoot on the way back up (a bounded-amplitude violation).
        """
        if not self._samples:
            return None
        lat = self._latency.value
        margin = self._min_margin
        self._samples = 0
        self._min_margin = None
        if self._settle:
            self._settle = False
            self._latency = _Ewma()
            return None
        changed = None
        if (margin is not None and margin < self.MARGIN_FLOOR) or \
                lat > self.setpoint_s * (1 + self.band):
            if self.aimd.decrease():
                changed = self.aimd.value
        elif lat < self.setpoint_s * (1 - self.band):
            if self.aimd.increase():
                changed = self.aimd.value
        if changed is not None:
            self._settle = True
            self._latency = _Ewma()
        return changed


class CoalesceWindowController:
    """Widen/collapse the coalescing-window smallness bound (module
    docstring, controller 2)."""

    FLOOR_S = 0.05
    CEIL_S = 2.0
    ADD_S = 0.05
    #: A wider window only helps when it would actually stack rows:
    #: small arrivals per window >= this many.
    FLOOD_ROWS = 2.0
    #: Queue wait (EWMA) below this is an unloaded system — no widening.
    WAIT_MIN_S = 0.05
    #: Executor bubbles: a gap EWMA above this fraction of the window
    #: means batching is starving the device — collapse.
    GAP_FRAC = 0.5

    def __init__(self, value: float, band: float,
                 clock: Callable[[], float] = _monotonic):
        self.band = band
        self.aimd = AimdValue(value, self.FLOOR_S, self.CEIL_S,
                              self.ADD_S, clock=clock)
        self._clock = clock
        self._small_arrivals = 0
        self._last_tick = clock()
        self._wait = _Ewma()
        self._gap = _Ewma()
        self._gap_samples = 0

    def observe_arrival(self, small: bool) -> None:
        if small:
            self._small_arrivals += 1

    def observe_wait(self, wait_s: float) -> None:
        if wait_s >= 0:
            self._wait.observe(wait_s)

    def observe_gap(self, gap_s: float) -> None:
        # gap_s is "idle executor time before this chunk", UNBOUNDED:
        # the first chunk after a traffic lull carries the whole lull.
        # A gap larger than any possible window is a lull, not a
        # pipeline bubble — batching cannot have caused it, so it must
        # not feed the collapse signal (one 60s lull would seed the
        # EWMA at 60 and pin the window to its floor).
        if 0 <= gap_s <= self.CEIL_S:
            self._gap.observe(gap_s)
            self._gap_samples += 1

    def tick(self) -> Optional[float]:
        now = self._clock()
        dt = max(1e-9, now - self._last_tick)
        self._last_tick = now
        rate = self._small_arrivals / dt
        self._small_arrivals = 0
        gap_fresh = self._gap_samples > 0
        self._gap_samples = 0
        gap = self._gap.value or 0.0
        changed = None
        if gap_fresh and gap > self.GAP_FRAC * self.aimd.value:
            # Collapse only on FRESH bubble evidence — a stale EWMA
            # with zero new samples this interval is yesterday's
            # traffic, and repeatedly acting on it would walk the
            # window to its floor during exactly the lull before the
            # next flood.
            if self.aimd.decrease():
                changed = self.aimd.value
        elif (rate * self.aimd.value >= self.FLOOD_ROWS
                and (self._wait.value or 0.0) >= self.WAIT_MIN_S):
            if self.aimd.increase():
                changed = self.aimd.value
        if changed is not None:
            self._gap = _Ewma()     # measure the NEW window fresh
        return changed


class AdmissionController:
    """Congestion-style admission on the queue-age slope (module
    docstring, controller 3). Owns the scheduler-wide token bucket."""

    RATE_FLOOR = 1.0
    RATE_CEIL = 1e5
    #: Additive step (requests/s) and bounded proportional term — see
    #: AimdValue docstring for why the probe is not purely constant.
    ADD_RATE = 8.0
    ADD_FRAC = 0.1
    #: Multiplicative decrease: gentler than the 0.5 the latency
    #: controllers use — the feedback here (queue-age jitter) is far
    #: noisier than a latency EWMA, and halving on every wiggle parked
    #: the rate ~25% under capacity in the JAX package's runs,
    #: shedding work an honest controller would have served.
    MUL = 0.7
    #: Age-slope dead zone (seconds of age change per tick), and the
    #: HEALTHY-QUEUE age floor: below it the system is underloaded
    #: whatever the slope says — keep probing up; only a queue already
    #: older than this with a RISING age is congestion. The floor is
    #: also the knee the equilibrium queue age oscillates around, i.e.
    #: the latency the controller trades for full utilization.
    SLOPE_EPS = 0.02
    MIN_AGE_S = 0.3
    #: Bucket burst as seconds of the controlled rate (an arrival burst
    #: shorter than this rides through without shedding).
    BURST_S = 0.25

    #: Service-rate anchors (the capacity signal is the scheduler's own
    #: ``results_sent`` counter — already collected). The MD result is
    #: floored at ``SRV_FLOOR_FRAC x`` the measured service rate: under
    #: sustained overload the HEAD AGE keeps rising through the whole
    #: drain of an old backlog (its entries arrived faster than the
    #: pool serves), and an unanchored MD cascade parked (JAX package)
    #: the rate at ~20% of capacity. The congestion QUEUE BOUND is the
    #: depth at which the backlog itself costs ~``MIN_AGE_S`` of wait
    #: (``srv_rate x MIN_AGE_S``, floored at ``QUEUE_MIN``): beyond it
    #: the OLDEST requests shed through the stock overload path, so a
    #: descent transient's backlog cannot dominate every later
    #: request's latency — this depth-at-capacity trim is exactly how
    #: "shed rate tracks actual service capacity".
    SRV_FLOOR_FRAC = 0.7
    QUEUE_MIN = 8

    def __init__(self, rate0: float,
                 clock: Callable[[], float] = _monotonic):
        start = rate0 if rate0 > 0 else self.RATE_CEIL
        self.aimd = AimdValue(start, self.RATE_FLOOR, self.RATE_CEIL,
                              self.ADD_RATE, mul=self.MUL,
                              add_frac=self.ADD_FRAC, clock=clock)
        self.bucket = TokenBucket(self.aimd.value,
                                  self._burst(self.aimd.value), clock)
        self._prev_age: Optional[float] = None
        self._srv = _Ewma()
        self._settle = False
        self.shed = 0

    def _burst(self, rate: float) -> float:
        return max(8.0, rate * self.BURST_S)

    def admit(self) -> bool:
        ok = self.bucket.take(1.0)
        if not ok:
            self.shed += 1
        return ok

    def observe_service_rate(self, served_per_s: float) -> None:
        """One tick's measured completion rate (requests/s)."""
        if served_per_s >= 0:
            self._srv.observe(served_per_s)

    def queue_bound(self) -> Optional[int]:
        """Congestion queue-depth bound (class docstring), or None
        before any service rate has been observed."""
        srv = self._srv.value
        if srv is None or srv <= 0:
            return None
        return max(self.QUEUE_MIN, int(srv * self.MIN_AGE_S))

    def tick(self, queue_age_s: float) -> Optional[float]:
        prev, self._prev_age = self._prev_age, queue_age_s
        if prev is None:
            return None
        if self._settle:
            # One settle tick after every adjustment: the queue age
            # needs a tick to respond to the new rate before the slope
            # means anything (same lag rule as the chunk controller).
            self._settle = False
            return None
        slope = queue_age_s - prev
        changed = None
        if queue_age_s < self.MIN_AGE_S or slope < -self.SLOPE_EPS:
            if self.aimd.increase():
                changed = self.aimd.value
        elif slope > self.SLOPE_EPS:
            srv = self._srv.value
            floor = srv * self.SRV_FLOOR_FRAC if srv else None
            if self.aimd.decrease_floored(floor):
                changed = self.aimd.value
        if changed is not None:
            self._settle = True
            self.bucket.set_rate(changed, self._burst(changed))
        return changed


class AdaptPlane:
    """The scheduler-mounted bundle of enabled controllers.

    Constructed only when ``AdaptParams.enabled`` — with the knob off
    the scheduler holds ``None`` and every hook is one attribute test
    (the bit-for-bit stock contract). The ``clock`` is injectable for
    a virtual clock and the tests' scripted series; the
    initial values are the live param blocks' statics, so an adaptive
    run STARTS at the static configuration and departs from it only on
    evidence.
    """

    def __init__(self, params: AdaptParams, metrics: Registry,
                 clock: Optional[Callable[[], float]] = None,
                 *, chunk_s: float = 1.0, small_s: float = 0.25,
                 trace_on: bool = False):
        clock = clock if clock is not None else _monotonic
        self.params = params
        self._clock = clock
        self._trace_on = trace_on
        self._last_apply = clock()
        self._served_prev: Optional[int] = None
        # A statically DISABLED plane (chunk_s/small_s <= 0 is the repo
        # 0-disables convention) stays disabled: the controllers tune
        # live knobs, they never re-enable what an operator turned off.
        self.chunk = (ChunkSizeController(
            chunk_s, params.force_s, params.band, clock,
            per_miner=params.per_miner)
            if params.chunk and chunk_s > 0 else None)
        self.window = (CoalesceWindowController(
            small_s, params.band, clock)
            if params.coalesce and small_s > 0 else None)
        self.admission = (AdmissionController(params.rate0, clock)
                          if params.admit else None)
        # Series exist only for MOUNTED controllers: registering a
        # gauge creates it in the snapshot, and a permanent
        # adapt_admit_rate=0.0 for an admission controller that does
        # not exist reads as "admission fully closed" to an operator.
        self._g_chunk = self._g_small = self._g_rate = None
        self._c_adjust: Dict[str, object] = {}
        self._c_shed = None
        if self.chunk is not None:
            self._g_chunk = metrics.gauge("adapt_chunk_s")
            self._c_adjust["chunk"] = metrics.counter(
                "adapt_adjust_chunk")
            self._g_chunk.set(self.chunk.aimd.value)
        if self.window is not None:
            self._g_small = metrics.gauge("adapt_small_s")
            self._c_adjust["window"] = metrics.counter(
                "adapt_adjust_window")
            self._g_small.set(self.window.aimd.value)
        if self.admission is not None:
            self._g_rate = metrics.gauge("adapt_admit_rate")
            self._c_adjust["admit"] = metrics.counter(
                "adapt_adjust_admit")
            self._c_shed = metrics.counter("adapt_admit_shed")
            self._g_rate.set(self.admission.aimd.value)

    # ------------------------------------------------------ observations

    def observe_chunk(self, service_s: Optional[float],
                      margin_frac: Optional[float],
                      span: Optional[dict] = None,
                      sized: bool = True,
                      miner: Optional[int] = None) -> None:
        """One popped chunk: scheduler-side service/margin plus the
        Result's span extension when it carried one (force_s feeds the
        chunk controller, gap_s the window controller). Span values are
        whitelisted numerics exactly like the trace fold.

        ``sized`` marks a chunk whose size was actually DERIVED from
        the controlled seconds-of-work knob (a chunked-mode grant):
        only those feed the sizing loop — a mouse's wholesale split is
        small because the REQUEST is small, and letting its
        milliseconds-scale latency into the EWMA walked the chunk size
        to its ceiling under pure mouse traffic, handing the next
        elephant a transient of maximal chunks (seen in the JAX
        package's adversarial runs). Gap spans feed the window controller from
        every pop either way."""
        force_s = gap_s = None
        if isinstance(span, dict):
            v = span.get("force_s")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                force_s = float(v)
            v = span.get("gap_s")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                gap_s = float(v)
        if self.chunk is not None and sized:
            self.chunk.observe(service_s, margin_frac, force_s,
                               miner=miner)
        if self.window is not None and gap_s is not None:
            self.window.observe_gap(gap_s)

    def forget_miner(self, miner: int) -> None:
        """Miner dropped: retire its per-miner controller state."""
        if self.chunk is not None:
            self.chunk.forget_miner(miner)

    def observe_arrival(self, small: bool) -> None:
        if self.window is not None:
            self.window.observe_arrival(small)

    def observe_wait(self, wait_s: float) -> None:
        if self.window is not None:
            self.window.observe_wait(wait_s)

    def admit(self) -> bool:
        """Congestion-admission gate at arrival; True when no admission
        controller is mounted."""
        if self.admission is None:
            return True
        ok = self.admission.admit()
        if not ok:
            self._c_shed.inc()
        return ok

    def effective_max_queued(self, static_bound: int) -> int:
        """The tighter of the static overload bound and the admission
        controller's congestion depth (capacity x age knee): what the
        scheduler's oldest-first overload shed trims to. The static
        bound's 0-means-unbounded convention is preserved when no
        congestion bound exists yet."""
        if self.admission is None:
            return static_bound
        bound = self.admission.queue_bound()
        if bound is None:
            return static_bound
        return min(static_bound, bound) if static_bound > 0 else bound

    # ------------------------------------------------------------- ticks

    def tick(self, queue_age_s: float,
             served_total: Optional[int] = None,
             rate_ratio: Optional[float] = None):
        """One sweep tick: rate-limited to ``params.tick_s``; returns
        the changed knob values for the scheduler to apply (empty dict
        = nothing moved). ``served_total`` is the scheduler's
        cumulative ``results_sent`` counter — the plane differentiates
        it into the service-rate anchor the admission controller
        floors itself on. ``rate_ratio`` is the pool's rate-EWMA
        max/min ratio (None below two measured miners) — the per-miner
        chunk controller's divergence gate; per-miner changes come
        back under the ``chunk_s_miner`` key as ``{conn: value}``."""
        now = self._clock()
        if now - self._last_apply < self.params.tick_s:
            return {}
        dt = max(1e-9, now - self._last_apply)
        self._last_apply = now
        if served_total is not None and self.admission is not None:
            if self._served_prev is not None:
                self.admission.observe_service_rate(
                    (served_total - self._served_prev) / dt)
            self._served_prev = served_total
        out: Dict[str, object] = {}
        if self.chunk is not None:
            self.chunk.note_rate_ratio(rate_ratio)
            v = self.chunk.tick()
            if v is not None:
                out["chunk_s"] = v
                self._g_chunk.set(v)
                self._c_adjust["chunk"].inc()
            per = self.chunk.tick_miners()
            if per:
                out["chunk_s_miner"] = per
                self._c_adjust["chunk"].inc(len(per))
            if self.chunk.unfork_pending():
                out["chunk_s_miner_clear"] = True
        if self.window is not None:
            v = self.window.tick()
            if v is not None:
                out["small_s"] = v
                self._g_small.set(v)
                self._c_adjust["window"].inc()
        if self.admission is not None:
            v = self.admission.tick(queue_age_s)
            if v is not None:
                self._g_rate.set(v)
                self._c_adjust["admit"].inc()
                out["admit_rate"] = v   # informational: applied in-plane
        if out and self._trace_on:
            _tracing.flight("adapt", **{
                k: (round(v, 6) if isinstance(v, float)
                    else {m: round(x, 6) for m, x in v.items()}
                    if isinstance(v, dict) else v)
                for k, v in out.items()})
        return out

    # ----------------------------------------------------------- queries

    def histories(self) -> Dict[str, Tuple[float, float, list]]:
        """``{controller: (floor, ceil, [(t, value), ...])}`` — the
        stability audit's view."""
        out: Dict[str, Tuple[float, float, list]] = {}
        for name, ctl in (("chunk", self.chunk), ("window", self.window),
                          ("admit", self.admission)):
            if ctl is not None:
                a = ctl.aimd
                out[name] = (a.floor, a.ceil, list(a.history))
        return out

    def state(self) -> dict:
        """Current values and adjustment counts (the scheduler logs
        them)."""
        out: dict = {}
        if self.chunk is not None:
            out["chunk_s"] = round(self.chunk.aimd.value, 6)
            out["chunk_adjustments"] = self.chunk.aimd.adjustments
        if self.window is not None:
            out["small_s"] = round(self.window.aimd.value, 6)
            out["window_adjustments"] = self.window.aimd.adjustments
        if self.admission is not None:
            out["admit_rate"] = round(self.admission.aimd.value, 3)
            out["admit_adjustments"] = self.admission.aimd.adjustments
            out["admit_shed"] = self.admission.shed
        return out
