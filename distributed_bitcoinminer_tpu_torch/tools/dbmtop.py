"""dbmtop: the live cluster console over the rollup plane.

Counterpart of the JAX package's ``scripts/dbmtop.py``. It renders the
process tier of ``apps.procs`` one screen at a time from the snapshot
blobs its processes publish into the state directory: the cluster's
totals, one row per process (role, rid, freshness, queue, pool, trust,
lease, shed, results, nonces/s), the SLO budget bars of ``apps.slo`` and
the membership epoch's timeline. Freshness is the rollup plane's rule
(the seq advancing within the publisher's beat period), so a stopped
replica shows ``STALE`` and a fenced one ``FENCED``, never summed into
the totals.

    python -m distributed_bitcoinminer_tpu_torch.tools.dbmtop <statedir>
        # the curses view (q quits), refreshed about once a beat
    python -m distributed_bitcoinminer_tpu_torch.tools.dbmtop --once <statedir>
        # the screen once, as text (no curses)
    python -m distributed_bitcoinminer_tpu_torch.tools.dbmtop --once --json <statedir>
        # one rollup document with the SLO status, as JSON

It reads files only: a live cluster, a dead one's state directory, or a
copy of one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..apps.rollup import RollupState, hist_quantile
from ..apps.slo import SloTracker

_STATUS_MARK = {"fresh": "ok", "stale": "STALE", "fenced": "FENCED"}


def one_doc(statedir: str, state=None, tracker=None) -> dict:
    """One rollup document with SLO status folded in (the JSON shape)."""
    state = state if state is not None else RollupState(statedir)
    tracker = tracker if tracker is not None else SloTracker()
    doc = state.refresh()
    tracker.observe(doc, now=doc["at"])
    doc["slo"] = tracker.status()
    doc["epochs"] = [{"at": round(t, 3), "epoch": e}
                     for t, e in state.epochs()]
    return doc


def _bar(frac: float, width: int = 20) -> str:
    frac = min(1.0, max(0.0, frac))
    fill = int(round(frac * width))
    return "#" * fill + "-" * (width - fill)


def _fmt(v, nd=1) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def render(doc: dict) -> list:
    """The screen as a list of plain-text lines (curses and --once share
    it; tests pin it without a terminal)."""
    lines = []
    cluster = doc.get("cluster") or {}
    counters = cluster.get("counters") or {}
    procs = doc.get("procs") or []
    fresh = sum(1 for p in procs if p["status"] == "fresh")
    mem = doc.get("membership") or {}

    def csum(family):
        pref = family + "{"
        return int(sum(v for k, v in counters.items()
                       if k == family or k.startswith(pref)))

    p99 = hist_quantile((cluster.get("histograms") or {})
                        .get("sched.queue_wait_s"), 0.99)
    lines.append(
        f"dbmtop — {doc.get('at', 0):.0f}  procs {fresh}/{len(procs)} "
        f"fresh  epoch {mem.get('epoch', '-')}  sources "
        f"{cluster.get('sources', 0)}  overflow "
        f"{cluster.get('series_overflow', 0)}")
    lines.append(
        f"cluster: results {csum('sched.results_sent')}  shed "
        f"{csum('sched.qos_shed')}  grants {csum('sched.qos_grants')}  "
        f"reissues {csum('sched.reissues')}  leases_blown "
        f"{csum('sched.leases_blown')}  queue-wait p99 "
        f"{_fmt(p99, 3)}s")
    lines.append("")
    lines.append(f"{'PROC':<12} {'STATUS':<7} {'AGE':>6} {'SEQ':>6} "
                 f"{'EPOCH':>5} {'QUEUE':>6} {'POOL':>5} {'TRUST':>6} "
                 f"{'LEASE_S':>8} {'SHED':>7} {'RESULTS':>8} "
                 f"{'NPS':>10}")
    for p in procs:
        d = p.get("detail") or {}
        lines.append(
            f"{p['proc']:<12} {_STATUS_MARK.get(p['status'], '?'):<7} "
            f"{p['age_s']:>6.2f} {p['seq']:>6d} {p['epoch_seen']:>5d} "
            f"{_fmt(d.get('queue'), 0):>6} {_fmt(d.get('pool'), 0):>5} "
            f"{_fmt(d.get('trust_min'), 2):>6} "
            f"{_fmt(d.get('lease_min_s'), 1):>8} "
            f"{_fmt(d.get('shed'), 0):>7} {_fmt(d.get('results'), 0):>8} "
            f"{_fmt(d.get('nps'), 0):>10}")
    lines.append("")
    for s in doc.get("slo") or []:
        frac = s.get("error_frac_long")
        used = 0.0 if frac is None else frac / s["budget"]
        mark = "BURN" if s.get("burning") else "ok"
        worst = s.get("worst")
        lines.append(
            f"slo {s['objective']:<19} [{_bar(1.0 - used)}] "
            f"budget left {max(0.0, 1.0 - used) * 100:5.1f}%  "
            f"burn {_fmt(s.get('burn_short'), 2)}x/"
            f"{_fmt(s.get('burn_long'), 2)}x  {mark}"
            + (f"  worst={worst}" if worst else ""))
    epochs = doc.get("epochs") or []
    if epochs:
        tail = epochs[-8:]
        stamps = "  ".join(f"e{e['epoch']}@{e['at'] % 1000:.1f}s"
                           for e in tail)
        lines.append("")
        lines.append(f"epochs: {stamps}")
    return lines


def _live(statedir: str, interval_s: float) -> int:
    import curses

    state, tracker = RollupState(statedir), SloTracker()

    def loop(scr):
        curses.curs_set(0)
        scr.nodelay(True)
        while True:
            doc = one_doc(statedir, state, tracker)
            scr.erase()
            maxy, maxx = scr.getmaxyx()
            for i, line in enumerate(render(doc)[:maxy - 1]):
                scr.addnstr(i, 0, line, maxx - 1)
            scr.refresh()
            t_next = time.monotonic() + interval_s
            while time.monotonic() < t_next:
                ch = scr.getch()
                if ch in (ord("q"), ord("Q")):
                    return 0
                time.sleep(0.05)

    return curses.wrapper(loop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="live cluster console over the rollup plane")
    ap.add_argument("statedir", help="cluster state directory")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (no curses)")
    ap.add_argument("--json", action="store_true",
                    help="with --once: print the rollup document as JSON")
    ap.add_argument("--interval", type=float, default=None,
                    help="refresh seconds (default: largest publisher "
                         "beat period seen, min 0.5)")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.statedir):
        print(f"dbmtop: no such state directory: {args.statedir}",
              file=sys.stderr)
        return 2
    if args.once:
        doc = one_doc(args.statedir)
        if args.json:
            print(json.dumps(doc, sort_keys=True))
        else:
            print("\n".join(render(doc)))
        return 0
    interval = args.interval
    if interval is None:
        # About one publisher beat: a window is beat * stale_k, and
        # stale_k defaults to 3.
        probe = one_doc(args.statedir)
        windows = [p["window_s"] for p in probe["procs"]]
        interval = max(0.5, (max(windows) / 3.0) if windows else 0.5)
    try:
        return _live(args.statedir, interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
