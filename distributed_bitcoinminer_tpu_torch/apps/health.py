"""The membership and health plane of the replica tier.

Counterpart of the JAX package's ``apps/health.py``, transport-free: the
logic a router runs to turn heartbeats into membership. Each replica
beats a small state blob (:class:`Beat`: serving, its miner slice, its
queue depth, the membership epoch it has seen); a replica whose beat
``seq`` has not advanced for ``miss_k`` beats is declared dead, the
FENCING epoch bumps, and the new membership is published. The port's
in-process replica tier (``apps.replicas``) does not need it; the
multi-process tier that drives it over a state directory
(``apps.procs``) is still to port, beyond its state-file helpers.

- :class:`Beat`: one replica's heartbeat. ``seq`` advances every beat;
  a frozen ``seq`` is a missed beat whatever a file's timestamp says (a
  stopped process's file keeps its old ``seq``).
- :class:`SeqFreshness`: the seq-advance rule per key, which the rollup
  plane also applies to published snapshot blobs.
- :class:`BeatMonitor`: a replica whose ``seq`` has not advanced within
  ``miss_k * beat_s`` of the observer's clock is dead; a function of
  (observations, now).
- :class:`Membership`: the advertised ring and the fencing ledger.
  ``epoch`` bumps on every change; a replica declared dead has its
  ``(rid, incarnation)`` FENCED, is never admitted again (only a fresh
  incarnation of its rid is), and its cache writes are refused
  (:meth:`Membership.writer_fenced`).
- :class:`RouterState` and :func:`router_tick`: one detection tick.

The fencing contract: a replica that sees its own ``(rid,
incarnation)`` in ``fenced`` stops serving. Until it sees it, its late
answers land on connections its clients have abandoned, and every
answer is a function of its request, so the fence bounds waste and keeps
the cache tier clean; it patches no correctness hole.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

__all__ = ["Beat", "BeatMonitor", "Membership", "SeqFreshness"]


class SeqFreshness:
    """Generic seq-advance freshness tracking (the BeatMonitor core).

    Tracks, per arbitrary hashable key, the last ``(gen, seq)`` pair seen
    and WHEN it advanced: an observation advances iff the key is new, the
    generation changed (a restart is always fresh), or the seq grew
    within the same generation. ``stale(now)`` lists keys whose seq has
    been frozen past ``window_s`` of the observer's clock: re-reading an
    unchanged blob never refreshes the deadline, so a stopped writer's
    lingering file is a death, not a heartbeat. :class:`BeatMonitor`
    delegates here, and the rollup plane applies the same rule to
    published snapshot blobs, keyed by ``(role, rid)``.
    """

    def __init__(self, window_s: float):
        self.window_s = max(1e-3, window_s)
        self._last: Dict[object, tuple] = {}      # key -> (gen, seq)
        self._fresh_at: Dict[object, float] = {}  # key -> when it advanced

    def observe(self, key, gen, seq, now: float) -> bool:
        """Record one observation; True when it ADVANCED the key."""
        prev = self._last.get(key)
        advanced = (prev is None or gen != prev[0] or seq > prev[1])
        if advanced:
            self._last[key] = (gen, seq)
            self._fresh_at[key] = now
        return advanced

    def age_s(self, key, now: float) -> Optional[float]:
        """Seconds since the key last advanced, or None when unseen."""
        at = self._fresh_at.get(key)
        return None if at is None else max(0.0, now - at)

    def stale(self, now: float) -> List[object]:
        """Keys whose seq has been frozen past the window."""
        return [k for k, at in self._fresh_at.items()
                if now - at > self.window_s]

    def forget(self, key) -> None:
        self._last.pop(key, None)
        self._fresh_at.pop(key, None)


@dataclass
class Beat:
    """One replica heartbeat (the small state blob on the wire/file)."""

    rid: int
    incarnation: str        # unique per process start (pid + stamp)
    seq: int                # MUST advance every beat
    port: int = 0           # the replica's own LSP socket
    serving: bool = True
    miners: int = 0         # miner-slice size (agent placement hint)
    queue_depth: int = 0
    epoch_seen: int = 0     # membership epoch the replica last observed

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Beat":
        return cls(**{k: d[k] for k in
                      ("rid", "incarnation", "seq", "port", "serving",
                       "miners", "queue_depth", "epoch_seen") if k in d})


class BeatMonitor:
    """Missed-beat failure detection over observed :class:`Beat`\\ s.

    ``observe(beat, now)`` records a beat; ``dead(now)`` lists replicas
    whose seq has not advanced within ``miss_k * beat_s`` of ``now``.
    The deadline is re-anchored only when seq advances: a stale blob read
    again (the same seq) is not life, so a stopped process's lingering
    state file is a death, not a heartbeat.
    """

    def __init__(self, beat_s: float, miss_k: int):
        self.beat_s = max(1e-3, beat_s)
        self.miss_k = max(1, miss_k)
        self._last: Dict[int, Beat] = {}      # rid -> newest beat
        self._fresh = SeqFreshness(self.beat_s * self.miss_k)

    @property
    def window_s(self) -> float:
        """Seconds of seq silence that mean death."""
        return self._fresh.window_s

    def observe(self, beat: Beat, now: float) -> bool:
        """Record one beat; True when it ADVANCED the replica's seq
        (same-or-older seqs, e.g. a re-read of a stale file, do not
        refresh the death deadline)."""
        advanced = self._fresh.observe(beat.rid, beat.incarnation,
                                       beat.seq, now)
        if advanced:
            self._last[beat.rid] = beat
        return advanced

    def last(self, rid: int) -> Optional[Beat]:
        return self._last.get(rid)

    def beats(self) -> List[Beat]:
        return list(self._last.values())

    def dead(self, now: float) -> List[int]:
        """Replica ids whose seq has been frozen past the window."""
        return self._fresh.stale(now)

    def forget(self, rid: int) -> None:
        """Stop watching a declared-dead replica (it re-enters the
        watch when a fresh incarnation beats)."""
        self._last.pop(rid, None)
        self._fresh.forget(rid)


class Membership:
    """The advertised ring + fencing ledger the router publishes.

    ``live`` maps rid -> {port, incarnation}; ``epoch`` bumps on every
    membership change; ``fenced`` maps rid -> {incarnation, epoch} for
    the LAST fenced incarnation of that rid (one suffices: a rid has at
    most one live incarnation, and older fenced ones can never beat
    again without being re-fenced as stale by the incarnation check).
    """

    def __init__(self):
        self.epoch = 0
        self.live: Dict[int, dict] = {}
        self.fenced: Dict[int, dict] = {}

    # ------------------------------------------------------------ changes

    def admit(self, beat: Beat) -> bool:
        """Admit a beating replica: first sight of the rid, or a FRESH
        incarnation of a previously fenced/dead one. A fenced
        incarnation is never re-admitted — that is the fence. Returns
        True when membership changed."""
        fence = self.fenced.get(beat.rid)
        if fence is not None and fence["incarnation"] == beat.incarnation:
            return False        # the fenced incarnation itself: refused
        entry = self.live.get(beat.rid)
        if entry is not None and entry["incarnation"] == beat.incarnation:
            if entry.get("port") == beat.port:
                return False    # already live, nothing changed
        self.live[beat.rid] = {"port": beat.port,
                               "incarnation": beat.incarnation}
        self.epoch += 1
        return True

    def declare_dead(self, rid: int) -> bool:
        """Missed-beat death: drop the rid from the ring and FENCE its
        incarnation at the new epoch. Returns True when it was live."""
        entry = self.live.pop(rid, None)
        if entry is None:
            return False
        self.epoch += 1
        self.fenced[rid] = {"incarnation": entry["incarnation"],
                            "epoch": self.epoch}
        return True

    # ------------------------------------------------------------ queries

    def is_fenced(self, rid: int, incarnation: str) -> bool:
        """Has THIS incarnation of ``rid`` been declared dead? (What a
        replica checks about itself to decide to stop serving.)"""
        fence = self.fenced.get(rid)
        return fence is not None and fence["incarnation"] == incarnation

    def writer_fenced(self, rid: int, incarnation: str) -> bool:
        """Should a cache-spool line from this writer be dropped?
        Everything a fenced incarnation wrote is refused, its entries
        from before its death too: a cache miss only costs a recompute,
        and a fenced process's later writes must never spread."""
        return self.is_fenced(rid, incarnation)

    def to_dict(self) -> dict:
        return {"epoch": self.epoch,
                "live": {str(r): dict(v) for r, v in self.live.items()},
                "fenced": {str(r): dict(v)
                           for r, v in self.fenced.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "Membership":
        m = cls()
        m.epoch = int(d.get("epoch", 0))
        m.live = {int(r): dict(v)
                  for r, v in (d.get("live") or {}).items()}
        m.fenced = {int(r): dict(v)
                    for r, v in (d.get("fenced") or {}).items()}
        return m


@dataclass
class RouterState:
    """One router tick's working state (monitor and membership), which
    :func:`router_tick` advances."""

    monitor: BeatMonitor
    membership: Membership = field(default_factory=Membership)


def router_tick(state: RouterState, beats: List[Beat],
                now: float) -> bool:
    """One detection tick: feed the beats just read to the monitor,
    admit fresh serving incarnations, declare missed-beat deaths.
    Returns True when the membership changed (a router republishes only
    then)."""
    changed = False
    for beat in beats:
        advanced = state.monitor.observe(beat, now)
        if beat.serving:
            if state.membership.admit(beat):
                changed = True
        elif advanced:
            # Graceful leave: a live incarnation beating serving=False
            # fences itself immediately instead of burning the missed-
            # beat window.
            entry = state.membership.live.get(beat.rid)
            if entry is not None and \
                    entry["incarnation"] == beat.incarnation:
                state.membership.declare_dead(beat.rid)
                state.monitor.forget(beat.rid)
                changed = True
    for rid in state.monitor.dead(now):
        if state.membership.declare_dead(rid):
            changed = True
        state.monitor.forget(rid)
    return changed


__all__.extend(["RouterState", "router_tick"])
