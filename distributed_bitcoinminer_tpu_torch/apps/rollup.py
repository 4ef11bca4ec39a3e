"""Cluster metric rollup: per-process snapshot blobs merged into one.

Counterpart of the JAX package's ``apps/rollup.py``. Each process of a
cluster publishes a versioned snapshot blob of its metrics
:class:`~..utils.metrics.Registry` into the state directory
(:class:`RollupPublisher`; atomic like the beats and the membership,
stamped with role, rid, incarnation, a publish seq and the membership
epoch it has seen), and :func:`aggregate` merges the blobs into ONE
cluster snapshot. The in-process replica tier merges its replicas'
registries the same way (``ReplicaSet.cluster_rollup``).

Merge rules, by metric kind (:func:`merge_snapshots`):

- counters are summed per series key: the cluster's
  ``sched.results_sent`` is the sum of the processes';
- histograms are merged bucket by bucket when their bounds agree (every
  built-in family's do), else kept per source under a ``proc`` label;
- gauges stay per source under a ``proc`` label (a last value cannot be
  summed);
- EWMAs are combined weighted by their samples.

The ``proc`` label comes and goes with processes, so per-source series
are admitted through a :class:`SourceSet` bounded by
``DBMT_METRICS_MAX_SERIES``; a retired source frees its slot, and
overflow is counted in the merged snapshot's ``series_overflow``.

Staleness: a blob older than its publisher's advertised period times
``stale_k`` (:data:`STALE_K`, ``DBMT_ROLLUP_STALE_K``) is flagged
``stale`` and left out of the totals, a fenced replica incarnation's blob
is flagged ``fenced`` and left out too, and :func:`gc_stale_blobs`
removes blobs stale for many windows. The periods are parameters with
the JAX package's defaults (:data:`BEAT_S`, :data:`STALE_K`); the
processes of ``apps.procs`` and the console (:class:`RollupState`) read
them from the environment (``DBMT_HEALTH_BEAT_S``, :func:`stale_k`) and
pass them on. ``DBMT_ROLLUP=0`` (:func:`rollup_enabled`) stops those
processes publishing.

:class:`RollupState` is the console's long-lived view (``tools/dbmtop``):
over :func:`aggregate` it applies the seq-advance rule of the beats (a
blob re-read unchanged never stays fresh), keeps one :class:`SourceSet`
across refreshes, retiring sources fenced or stale for long, and the
membership epoch's timeline.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

from ..utils._env import int_env
from .health import Membership, SeqFreshness

__all__ = ["blob_path", "read_blobs", "RollupPublisher", "SourceSet",
           "merge_snapshots", "hist_quantile", "aggregate", "RollupState",
           "gc_stale_blobs", "rollup_enabled", "stale_k", "BEAT_S",
           "STALE_K", "RETIRE_K"]

#: Blob format version (readers skip versions they do not understand).
BLOB_V = 1

_PREFIX = "metrics_"


#: Staleness windows after which :func:`gc_stale_blobs` removes a blob.
RETIRE_K = 20


#: A publisher's default period (the replica tier's heartbeat period).
BEAT_S = 0.5

#: Publish periods of silence before a source's blob is flagged stale and
#: left out of the cluster totals (the heartbeat's missed-beat count).
STALE_K = 3


def rollup_enabled() -> bool:
    """``DBMT_ROLLUP`` (default 1): the processes of ``apps.procs``
    publish their snapshot blobs; 0 publishes none."""
    return int_env("DBMT_ROLLUP", 1) != 0


def stale_k() -> int:
    """``DBMT_ROLLUP_STALE_K`` (default ``DBMT_HEALTH_MISS_K``, else
    :data:`STALE_K`; at least 1)."""
    return max(1, int_env("DBMT_ROLLUP_STALE_K",
                          int_env("DBMT_HEALTH_MISS_K", STALE_K)))


def blob_path(statedir: str, role: str, rid) -> str:
    """State-plane path of one source's snapshot blob. Keyed by (role,
    rid) — NOT incarnation — so a respawned process overwrites its
    predecessor's blob instead of leaking one file per restart."""
    return os.path.join(statedir, f"{_PREFIX}{role}_{rid}.json")


def read_blobs(statedir: str) -> List[dict]:
    """Every well-formed snapshot blob in the state directory, sorted by
    (role, rid) for deterministic aggregation."""
    from .procs import read_json
    out = []
    try:
        names = os.listdir(statedir)
    except OSError:
        return out
    for name in names:
        if not (name.startswith(_PREFIX) and name.endswith(".json")):
            continue
        d = read_json(os.path.join(statedir, name))
        if (isinstance(d, dict) and d.get("v") == BLOB_V
                and isinstance(d.get("snapshot"), dict)
                and "role" in d and "rid" in d):
            out.append(d)
    out.sort(key=lambda d: (str(d["role"]), str(d["rid"])))
    return out


class RollupPublisher:
    """One process's side of the rollup plane: periodic atomic snapshot
    blobs into the state directory.

    ``publish()`` is called from the process's own beat loop: one
    registry snapshot and one small file write a beat. It never raises:
    a full disk costs observability, not service.
    """

    def __init__(self, statedir: str, role: str, rid, incarnation: str,
                 registry=None, beat_s: float = BEAT_S):
        from ..utils import metrics as _metrics
        self.statedir = statedir
        self.role = str(role)
        self.rid = rid
        self.incarnation = str(incarnation)
        self.registry = registry if registry is not None \
            else _metrics.registry()
        #: The advertised cadence: readers size the staleness window from
        #: the blob itself, whatever their own environment says.
        self.beat_s = max(0.01, float(beat_s))
        self.seq = 0
        self.path = blob_path(statedir, self.role, self.rid)

    def publish(self, epoch_seen: int = 0, final: bool = False) -> bool:
        """Write one blob (seq advances per call). True on success."""
        from .procs import write_json_atomic
        self.seq += 1
        doc = {"v": BLOB_V, "role": self.role, "rid": self.rid,
               "inc": self.incarnation, "seq": self.seq,
               "wall": time.time(), "beat_s": self.beat_s,
               "epoch_seen": int(epoch_seen), "final": bool(final),
               "snapshot": self.registry.snapshot()}
        try:
            write_json_atomic(self.path, doc)
            return True
        except OSError:
            return False


# ------------------------------------------------------------------ merging


class SourceSet:
    """Bounded admission of per-source (``proc``-labeled) series.

    The ``proc`` label's values come and go with processes, so it gets
    the registry's own cardinality bound: at most ``max_series``
    distinct label sets per family, further sets are refused and counted
    (``overflows``), and a retired source frees its slot
    (``retire_proc``).
    """

    def __init__(self, max_series: Optional[int] = None):
        self.max_series = (max_series if max_series is not None
                           else int_env("DBMT_METRICS_MAX_SERIES", 64))
        self._families: Dict[str, set] = {}
        self.overflows = 0

    @staticmethod
    def _key(labels: dict) -> Tuple[Tuple[str, str], ...]:
        return tuple(sorted((k, str(v)) for k, v in labels.items()))

    def proc_series(self, family: str, **labels) -> bool:
        """Admit one labeled series into ``family``; False (and counted)
        past the cardinality bound."""
        key = self._key(labels)
        admitted = self._families.setdefault(family, set())
        if key in admitted:
            return True
        if len(admitted) >= self.max_series:
            self.overflows += 1
            return False
        admitted.add(key)
        return True

    def retire_proc(self, family: str, **labels) -> None:
        """Free a retired source's slot (fenced replica / expired miner
        agent) — churn cycles slots instead of exhausting them."""
        self._families.get(family, set()).discard(self._key(labels))

    def sources(self, family: str) -> List[Tuple[Tuple[str, str], ...]]:
        return sorted(self._families.get(family, set()))


def _with_proc(series_key: str, proc: str) -> str:
    """``name`` -> ``name{proc=X}``; ``name{a=b}`` -> ``name{a=b,proc=X}``."""
    if series_key.endswith("}"):
        return f"{series_key[:-1]},proc={proc}}}"
    return f"{series_key}{{proc={proc}}}"


def merge_snapshots(sources: Iterable[Tuple[str, dict]],
                    source_set: Optional[SourceSet] = None) -> dict:
    """Merge per-process registry snapshots into one cluster snapshot.

    ``sources`` is ``(proc_key, snapshot)`` pairs (snapshot as produced
    by ``Registry.snapshot()``). A pure function of its inputs: merging
    the same blobs twice gives the same document. Counters sum;
    histograms merge
    elementwise when bucket bounds agree, else fall back to per-source;
    gauges stay per-source under a ``proc`` label; EWMAs combine
    sample-weighted. Per-source series go through ``source_set`` (a
    fresh bound when None) so ``proc`` cardinality is capped.
    """
    if source_set is None:
        source_set = SourceSet()
    out = {"counters": {}, "gauges": {}, "histograms": {}, "ewmas": {},
           "series_overflow": 0, "sources": 0}
    ewma_acc: Dict[str, list] = {}   # key -> [weighted_sum, samples]
    for proc, snap in sources:
        out["sources"] += 1
        out["series_overflow"] += int(snap.get("series_overflow", 0))
        admitted = source_set.proc_series("rollup_sources", proc=proc)
        for key, v in (snap.get("counters") or {}).items():
            out["counters"][key] = out["counters"].get(key, 0) + int(v)
        for key, v in (snap.get("gauges") or {}).items():
            if not admitted:
                out["series_overflow"] += 1
                continue
            out["gauges"][_with_proc(key, proc)] = v
        for key, h in (snap.get("histograms") or {}).items():
            cur = out["histograms"].get(key)
            if cur is not None and cur.get("le") == h.get("le"):
                cur["counts"] = [a + b for a, b in
                                 zip(cur["counts"], h["counts"])]
                cur["count"] += int(h.get("count", 0))
                cur["sum"] = round(cur["sum"] + float(h.get("sum", 0.0)),
                                   6)
            elif cur is None:
                out["histograms"][key] = {
                    "le": list(h.get("le") or []),
                    "counts": list(h.get("counts") or []),
                    "count": int(h.get("count", 0)),
                    "sum": float(h.get("sum", 0.0))}
            else:
                # Bucket-bound mismatch (custom buckets on one source):
                # summing would lie, so this source's copy stays
                # attributed under its proc label.
                if not admitted:
                    out["series_overflow"] += 1
                    continue
                out["histograms"][_with_proc(key, proc)] = dict(h)
        for key, e in (snap.get("ewmas") or {}).items():
            v, n = e.get("value"), int(e.get("samples", 0))
            acc = ewma_acc.setdefault(key, [0.0, 0])
            if v is not None and n > 0:
                acc[0] += float(v) * n
                acc[1] += n
    for key, (ws, n) in ewma_acc.items():
        out["ewmas"][key] = {
            "value": round(ws / n, 6) if n else None, "samples": n}
    # series_overflow counts the series dropped in THIS merge (per
    # skipped gauge or histogram), not SourceSet.overflows, which
    # accumulates over merges.
    for kind in ("counters", "gauges", "histograms", "ewmas"):
        out[kind] = dict(sorted(out[kind].items()))
    return out


def hist_quantile(h: Optional[dict], q: float) -> Optional[float]:
    """The ``q``-quantile upper bound from a cumulative-``le`` snapshot
    histogram (the bound of the first bucket covering ``q`` of the
    observations). None when empty/absent or when the quantile lies in
    the +Inf bucket — the caller renders that as ``>max_bound``."""
    if not h or not h.get("count"):
        return None
    target = q * h["count"]
    for bound, cum in zip(h.get("le") or [], h.get("counts") or []):
        if cum >= target:
            return float(bound)
    return None


# ---------------------------------------------------------------- aggregate


#: The headline stats of each source's row: family name -> row key.
#: Counters and gauges sum across the label sets of the family.
_DETAIL_COUNTERS = (("sched.results_sent", "results"),
                    ("sched.qos_shed", "shed"),
                    ("sched.leases_blown", "leases_blown"))
_DETAIL_GAUGES = (("sched.queue_depth", "queue"),
                  ("sched.pool_size", "pool"),
                  ("sched.lease_min_remaining_s", "lease_min_s"))


def _family_values(section: dict, family: str) -> List[float]:
    pref = family + "{"
    return [float(v) for k, v in section.items()
            if k == family or k.startswith(pref)
            if isinstance(v, (int, float))]


def _proc_detail(snap: dict) -> dict:
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    detail: dict = {}
    for family, out_key in _DETAIL_COUNTERS:
        vals = _family_values(counters, family)
        if vals:
            detail[out_key] = int(sum(vals))
    for family, out_key in _DETAIL_GAUGES:
        vals = _family_values(gauges, family)
        if vals:
            detail[out_key] = round(sum(vals), 3)
    trust = _family_values(gauges, "sched.miner_trust")
    if trust:
        detail["trust_min"] = round(min(trust), 3)
    p99 = hist_quantile((snap.get("histograms") or {})
                        .get("sched.queue_wait_s"), 0.99)
    if p99 is not None:
        detail["queue_wait_p99_s"] = p99
    for family in ("miner.nonces_per_s", "sched.pool_rate_nps"):
        e = (snap.get("ewmas") or {}).get(family) or \
            (snap.get("gauges") or {}).get(family)
        v = e.get("value") if isinstance(e, dict) else e
        if isinstance(v, (int, float)):
            detail["nps"] = round(float(v), 1)
            break
    return detail


def aggregate(statedir: str, *, now: Optional[float] = None,
              membership: Optional[Membership] = None,
              source_set: Optional[SourceSet] = None,
              stale_k: int = STALE_K) -> dict:
    """One cluster snapshot from the state directory's blobs.

    Per source: status ``fenced`` (a fenced replica incarnation: its
    numbers are left out), ``stale`` (its wall stamp older than ``beat_s
    * stale_k``: a frozen publisher is flagged, not averaged
    in), or ``fresh`` (merged into the cluster totals). A pure function
    of (files, now).
    """
    from .procs import read_membership
    if now is None:
        now = time.time()
    if membership is None:
        membership = read_membership(statedir)
    k = max(1, stale_k)
    procs_out: List[dict] = []
    fresh: List[Tuple[str, dict]] = []
    for blob in read_blobs(statedir):
        role, rid = str(blob["role"]), blob["rid"]
        inc = str(blob.get("inc", ""))
        window_s = max(0.01, float(blob.get("beat_s", 0.5))) * k
        age_s = max(0.0, now - float(blob.get("wall", 0.0)))
        if role == "replica" and membership is not None \
                and membership.is_fenced(int(rid), inc):
            status = "fenced"
        elif age_s > window_s:
            status = "stale"
        else:
            status = "fresh"
        proc_key = f"{role}{rid}"
        procs_out.append({
            "proc": proc_key, "role": role, "rid": rid, "inc": inc,
            "seq": int(blob.get("seq", 0)), "status": status,
            "age_s": round(age_s, 3), "window_s": round(window_s, 3),
            "epoch_seen": int(blob.get("epoch_seen", 0)),
            "detail": _proc_detail(blob["snapshot"])})
        if status == "fresh":
            fresh.append((proc_key, blob["snapshot"]))
    doc = {"v": BLOB_V, "event": "rollup", "at": now,
           "procs": procs_out,
           "cluster": merge_snapshots(fresh, source_set=source_set)}
    if membership is not None:
        doc["membership"] = membership.to_dict()
    return doc


class RollupState:
    """The console's long-lived aggregation (the module docstring):
    :meth:`refresh` is one frame, :func:`aggregate` with the seq-advance
    rule over it (a publisher whose wall stamp moves but whose seq does
    not, a replayed or copied blob, is stale), the retirement of sources
    fenced or stale for :data:`RETIRE_K` windows from the
    :class:`SourceSet`, and the membership epoch's changes (the last
    ``history``) for :meth:`epochs`. Each frame reads :func:`stale_k`."""

    def __init__(self, statedir: str, history: int = 32):
        self.statedir = statedir
        self.sources = SourceSet()
        self._fresh: Optional[SeqFreshness] = None
        self._epochs: List[Tuple[float, int]] = []   # (wall, epoch)
        self.history = history

    def epochs(self) -> List[Tuple[float, int]]:
        return list(self._epochs)

    def refresh(self, now: Optional[float] = None) -> dict:
        """One console frame. Without ``now`` the clock is read inside
        :func:`aggregate` (after its imports), so a first frame's ages are
        not cut short by the time a fresh console takes to load them."""
        doc = aggregate(self.statedir, now=now, source_set=self.sources,
                        stale_k=stale_k())
        now = doc["at"]
        window = max((p["window_s"] for p in doc["procs"]), default=1.0)
        if self._fresh is None:
            self._fresh = SeqFreshness(window)
        self._fresh.window_s = max(1e-3, window)
        for p in doc["procs"]:
            self._fresh.observe((p["role"], p["rid"]), p["inc"], p["seq"],
                                now)
        stale_keys = set(self._fresh.stale(now))
        for p in doc["procs"]:
            key = (p["role"], p["rid"])
            if p["status"] == "fresh" and key in stale_keys:
                p["status"] = "stale"
            if p["status"] != "fresh":
                age = self._fresh.age_s(key, now)
                if p["status"] == "fenced" or (
                        age is not None
                        and age > self._fresh.window_s * RETIRE_K):
                    self.sources.retire_proc("rollup_sources",
                                             proc=p["proc"])
        epoch = (doc.get("membership") or {}).get("epoch")
        if epoch is not None and (not self._epochs
                                  or self._epochs[-1][1] != epoch):
            self._epochs.append((now, int(epoch)))
            del self._epochs[:-self.history]
        return doc


def gc_stale_blobs(statedir: str, *, now: Optional[float] = None,
                   retire_k: int = RETIRE_K,
                   stale_k: int = STALE_K) -> int:
    """Unlink snapshot blobs dead past ``retire_k`` staleness windows.

    A process that just died keeps its blob (flagged, out of the
    totals: the death shows); a blob nobody has refreshed for many
    windows is left over from long-gone processes and is removed.
    Returns the blobs unlinked.
    """
    if now is None:
        now = time.time()
    removed = 0
    for blob in read_blobs(statedir):
        window_s = max(0.01, float(blob.get("beat_s", 0.5))) * max(
            1, stale_k)
        age_s = now - float(blob.get("wall", 0.0))
        if age_s > window_s * max(1, retire_k):
            try:
                os.unlink(blob_path(statedir, str(blob["role"]),
                                    blob["rid"]))
                removed += 1
            except OSError:
                pass
    return removed
