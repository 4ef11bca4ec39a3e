"""Declarative SLOs and multi-window burn-rate alerts over the rollup.

Counterpart of the JAX package's ``apps/slo.py``. The rollup plane
(``apps.rollup``) gives the cluster ONE snapshot; this module evaluates a
few service-level objectives over it, each with an error budget and
multi-window burn-rate alerting: an alert fires only while the budget
burns fast over BOTH a short and a long window (the short one shows the
pain is current, the long one keeps a brief blip from alerting).

The objectives:

- **reply_availability**: the share of decided requests answered rather
  than shed, ``results_sent / (results_sent + qos_shed)``; target
  ``DBMT_SLO_AVAIL`` (default 0.99, a budget of 1%).
- **queue_wait_p99**: the share of admitted requests that waited in the
  queue longer than ``DBMT_SLO_P99_S`` seconds (default 60), read from
  the merged cumulative ``sched.queue_wait_s`` buckets; a budget of 1%,
  as a p99 objective has.
- **shed_rate**: the share of admission decisions shed, ``qos_shed /
  (qos_grants + qos_shed)``, at most ``DBMT_SLO_SHED`` (default 0.25).

Each is a ratio of MONOTONIC counters (histogram buckets are cumulative
too), so a window's error share is a two-point difference: the tracker
keeps a short ring of ``(t, cumulative)`` samples and nothing a request.
The burn rate is the window's error share over the budget; an alert
fires on the move into "both windows at least ``DBMT_SLO_BURN``"
(default 4.0: the budget spent four times faster than allowed), names
the objective and the worst process (the highest error share of the
per-process rows), and is recorded in the flight recorder
(``utils.trace``). The long window is ``DBMT_SLO_WINDOW_S`` (default
300 s), the short one a twelfth of it.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..utils._env import float_env as _float_env

__all__ = ["Objective", "default_objectives", "SloTracker"]


class Objective:
    """One SLO: a name, an error budget, and how to read (bad, total)
    cumulative pairs out of a rollup document / per-proc row."""

    def __init__(self, name: str, budget: float,
                 cluster_fn: Callable[[dict], Tuple[float, float]],
                 proc_fn: Callable[[dict], Optional[Tuple[float, float]]],
                 describe: str = ""):
        self.name = name
        self.budget = max(1e-9, float(budget))
        self._cluster_fn = cluster_fn
        self._proc_fn = proc_fn
        self.describe = describe

    def cumulative(self, doc: dict) -> Tuple[float, float]:
        """(bad, total), both monotonic, from a rollup document."""
        try:
            bad, total = self._cluster_fn(doc)
            return max(0.0, float(bad)), max(0.0, float(total))
        except Exception:  # noqa: BLE001 — a torn doc must not kill it
            return 0.0, 0.0

    def proc_error_frac(self, proc_entry: dict) -> Optional[float]:
        """This process's lifetime error fraction (offender ranking)."""
        try:
            pair = self._proc_fn(proc_entry)
        except Exception:  # noqa: BLE001
            return None
        if pair is None:
            return None
        bad, total = pair
        return (bad / total) if total > 0 else None


def _counter_family(doc: dict, family: str) -> float:
    pref = family + "{"
    section = (doc.get("cluster") or {}).get("counters") or {}
    return float(sum(v for k, v in section.items()
                     if k == family or k.startswith(pref)))


def _avail_cluster(doc: dict) -> Tuple[float, float]:
    shed = _counter_family(doc, "sched.qos_shed")
    sent = _counter_family(doc, "sched.results_sent")
    return shed, shed + sent


def _avail_proc(p: dict) -> Optional[Tuple[float, float]]:
    d = p.get("detail") or {}
    if "results" not in d and "shed" not in d:
        return None
    shed = float(d.get("shed", 0))
    return shed, shed + float(d.get("results", 0))


def _shed_cluster(doc: dict) -> Tuple[float, float]:
    shed = _counter_family(doc, "sched.qos_shed")
    grants = _counter_family(doc, "sched.qos_grants")
    return shed, shed + grants


def _p99_threshold_pair(hist: Optional[dict],
                        limit_s: float) -> Tuple[float, float]:
    if not hist or not hist.get("count"):
        return 0.0, 0.0
    total = float(hist["count"])
    good = 0.0
    for bound, cum in zip(hist.get("le") or [], hist.get("counts") or []):
        if bound <= limit_s:
            good = float(cum)
        else:
            break
    return total - good, total


def _wait_cluster(doc: dict, limit_s: float) -> Tuple[float, float]:
    hist = ((doc.get("cluster") or {}).get("histograms") or {}) \
        .get("sched.queue_wait_s")
    return _p99_threshold_pair(hist, limit_s)


def _wait_proc(p: dict, limit_s: float) -> Optional[Tuple[float, float]]:
    # Per-proc rows carry the p99 headline, not full buckets: rank by
    # whether the process's own p99 bound clears the limit.
    d = p.get("detail") or {}
    p99 = d.get("queue_wait_p99_s")
    if p99 is None:
        return None
    return (1.0, 1.0) if (p99 > limit_s) else (0.0, 1.0)


def default_objectives() -> List[Objective]:
    """The built-in objective set, targets from ``DBMT_SLO_*`` knobs."""
    avail = min(1.0 - 1e-9, max(0.0, _float_env("DBMT_SLO_AVAIL", 0.99)))
    p99_s = max(1e-3, _float_env("DBMT_SLO_P99_S", 60.0))
    shed = max(1e-9, min(1.0, _float_env("DBMT_SLO_SHED", 0.25)))
    return [
        Objective("reply_availability", 1.0 - avail,
                  _avail_cluster, _avail_proc,
                  f"replies answered vs shed >= {avail:g}"),
        Objective("queue_wait_p99", 0.01,
                  lambda doc: _wait_cluster(doc, p99_s),
                  lambda p: _wait_proc(p, p99_s),
                  f"queue wait p99 <= {p99_s:g}s"),
        Objective("shed_rate", shed,
                  _shed_cluster, _avail_proc,
                  f"admission shed rate <= {shed:g}"),
    ]


class SloTracker:
    """Multi-window burn-rate tracking over successive rollup documents.

    Feed every rollup refresh to :meth:`observe`; it returns the alerts
    that FIRED on that observation (transitions into burning) and keeps
    :meth:`status` current for the console's budget bars. Long window =
    ``DBMT_SLO_WINDOW_S`` (default 300s), short window = long/12 (the
    5m:1h ratio of the classic fast-burn pair), alert threshold =
    ``DBMT_SLO_BURN`` (default 4.0x budget rate) on BOTH windows.
    """

    def __init__(self, objectives: Optional[List[Objective]] = None,
                 window_s: Optional[float] = None,
                 burn: Optional[float] = None, recorder=None):
        self.objectives = (objectives if objectives is not None
                           else default_objectives())
        self.window_s = max(1.0, window_s if window_s is not None
                            else _float_env("DBMT_SLO_WINDOW_S", 300.0))
        self.short_s = max(0.5, self.window_s / 12.0)
        self.burn = max(1.0, burn if burn is not None
                        else _float_env("DBMT_SLO_BURN", 4.0))
        self._recorder = recorder
        self._hist: deque = deque()       # (t, {name: (bad, total)})
        self._burning: Dict[str, bool] = {}
        self._status: List[dict] = []

    # ------------------------------------------------------------ windows

    def _window_frac(self, name: str, now: float,
                     span_s: float) -> Optional[float]:
        """Error fraction of the newest sample vs the oldest one inside
        ``span_s`` (None until the window has two samples or any
        traffic). Cumulative counters make this a pure two-point delta."""
        newest = self._hist[-1][1].get(name) if self._hist else None
        anchor = None
        for t, sample in self._hist:
            if now - t <= span_s + 1e-9:
                anchor = sample.get(name)
                break
        if newest is None or anchor is None or anchor is newest:
            return None
        d_bad = newest[0] - anchor[0]
        d_total = newest[1] - anchor[1]
        if d_total <= 0:
            return None
        return max(0.0, d_bad) / d_total

    def _worst_proc(self, obj: Objective, doc: dict) -> Optional[str]:
        worst, worst_frac = None, -1.0
        for p in doc.get("procs") or []:
            if p.get("status") == "fenced":
                continue
            frac = obj.proc_error_frac(p)
            if frac is not None and frac > worst_frac:
                worst, worst_frac = p.get("proc"), frac
        return worst

    # ------------------------------------------------------------ observe

    def observe(self, doc: dict,
                now: Optional[float] = None) -> List[dict]:
        """Fold in one rollup document; returns NEWLY-firing alerts."""
        if now is None:
            now = time.time()
        sample = {o.name: o.cumulative(doc) for o in self.objectives}
        self._hist.append((now, sample))
        while self._hist and now - self._hist[0][0] > self.window_s * 1.25:
            self._hist.popleft()
        alerts: List[dict] = []
        status: List[dict] = []
        for obj in self.objectives:
            f_short = self._window_frac(obj.name, now, self.short_s)
            f_long = self._window_frac(obj.name, now, self.window_s)
            b_short = (f_short / obj.budget) if f_short is not None \
                else None
            b_long = (f_long / obj.budget) if f_long is not None else None
            burning = (b_short is not None and b_long is not None
                       and b_short >= self.burn and b_long >= self.burn)
            entry = {"objective": obj.name, "describe": obj.describe,
                     "budget": obj.budget,
                     "error_frac_short": f_short,
                     "error_frac_long": f_long,
                     "burn_short": round(b_short, 3)
                     if b_short is not None else None,
                     "burn_long": round(b_long, 3)
                     if b_long is not None else None,
                     "burning": burning}
            if burning:
                entry["worst"] = self._worst_proc(obj, doc)
                if not self._burning.get(obj.name):
                    alert = dict(entry, event="slo_burn",
                                 window_s=self.window_s,
                                 short_s=self.short_s)
                    alerts.append(alert)
                    self._record(alert)
            self._burning[obj.name] = burning
            status.append(entry)
        self._status = status
        return alerts

    def _record(self, alert: dict) -> None:
        rec = self._recorder
        if rec is None:
            from ..utils.trace import flight_recorder
            rec = flight_recorder()
        try:
            rec.record("slo_burn", objective=alert["objective"],
                       worst=alert.get("worst"),
                       burn_short=alert.get("burn_short"),
                       burn_long=alert.get("burn_long"))
        except Exception:  # noqa: BLE001 — alerting must not crash hosts
            pass

    def status(self) -> List[dict]:
        """Latest per-objective budget state (console budget bars)."""
        return [dict(e) for e in self._status]
