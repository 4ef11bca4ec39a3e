"""Perfetto export and summary of the port's request traces, the
counterpart of the JAX package's ``scripts/dbmtrace.py`` (its ``convert``
and ``summarize`` modes).

    python -m distributed_bitcoinminer_tpu_torch.tools.dbmtrace \\
        convert DUMP... -o trace.json
    python -m distributed_bitcoinminer_tpu_torch.tools.dbmtrace \\
        summarize DUMP_OR_CAPTURE_OR_ROLLUP... [--top N]

A DUMP is a file of lines: ``RequestTrace.to_dict()`` objects as JSON,
a Chrome trace written by ``Scheduler.export_trace`` (its slices are
read back as one trace a request), or log lines holding a ``trace dump
(...): {...}`` payload (the scheduler's age alarms write them to
``log.txt``). ``convert`` writes Chrome trace-event JSON that loads in
ui.perfetto.dev: one track per tenant and per miner, the requests'
slices, the fault events as instants and the miners' stitched phases.
``summarize`` also reads workload captures (``apps.capture``: their
``span`` and ``rep`` records), rollup documents (``dbmtop --once
--json``) and a state directory's snapshot blobs (``metrics_*.json``),
detected line by line; it prints the cluster's headline from the rollup
(results sent, sheds, re-issues, the queue wait's p99), each span phase's
count, p50, p90 and max, the verification tier's outcomes when any, and
the slowest requests with their slowest phase.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..utils import trace as tracing

_DUMP_MARK = "trace dump ("


def _iter_trace_dicts(path: str):
    """Trace dicts from one file of JSON lines or log lines."""
    with open(path, encoding="utf-8", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if _DUMP_MARK in line:
                at = line.find("): ", line.index(_DUMP_MARK))
                if at < 0:
                    continue
                line = line[at + 3:]
            if not line.startswith("{"):
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if isinstance(obj, dict) and "events" in obj:
                yield obj


def convert(paths: list, out: str) -> int:
    dicts = [d for p in paths for d in _iter_trace_dicts(p)]
    if not dicts:
        print(f"dbmtrace: no trace dicts found in {paths}", file=sys.stderr)
        return 1
    doc = tracing.to_chrome_trace(dicts)
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, sort_keys=True)
    print(f"dbmtrace: {len(dicts)} trace(s) -> {out} "
          f"({len(doc['traceEvents'])} events)")
    return 0


def _iter_records(path: str):
    """Every record of one file, by kind: ``("trace", dict)`` for a trace
    dict (and a ``trace dump`` log line), ``("capture", dict)`` for a
    workload capture's record, ``("rollup", dict)`` for a rollup document
    (``apps.rollup.aggregate``, ``dbmtop --once --json``) and ``("blob",
    dict)`` for a process's snapshot blob (a state directory's
    ``metrics_*.json``)."""
    with open(path, encoding="utf-8", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if _DUMP_MARK in line:
                at = line.find("): ", line.index(_DUMP_MARK))
                if at < 0:
                    continue
                line = line[at + 3:]
            if not line.startswith("{"):
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if not isinstance(obj, dict):
                continue
            if "events" in obj:
                yield "trace", obj
            elif "k" in obj:
                yield "capture", obj
            elif "cluster" in obj and "procs" in obj:
                yield "rollup", obj
            elif "snapshot" in obj and "role" in obj:
                yield "blob", obj


def _pctl(xs: list, q: float) -> float:
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _print_rollups(rollups: list, blobs: list) -> None:
    """The cluster's headline from the newest rollup document, else from
    the snapshot blobs merged here (so a state directory's blobs
    summarize without a running cluster)."""
    if not rollups and not blobs:
        return
    from ..apps.rollup import hist_quantile, merge_snapshots
    if rollups:
        doc = rollups[-1]
        cluster = doc.get("cluster", {})
        procs = doc.get("procs", [])
        fresh = sum(1 for p in procs if p.get("status") == "fresh")
        head = (f"{len(rollups)} rollup doc(s); last: {fresh}/"
                f"{len(procs)} procs fresh")
    else:
        cluster = merge_snapshots(
            (f"{b.get('role')}{b.get('rid')}", b["snapshot"])
            for b in blobs)
        head = f"{len(blobs)} snapshot blob(s) merged"
    counters = cluster.get("counters", {})

    def fam(family):
        return sum(v for k, v in counters.items()
                   if k == family or k.startswith(family + "{"))

    wait = cluster.get("histograms", {}).get("sched.queue_wait_s")
    p99 = hist_quantile(wait, 0.99) if wait else None
    print(f"rollup: {head}; cluster results_sent="
          f"{fam('sched.results_sent')} shed={fam('sched.qos_shed')} "
          f"reissues={fam('sched.reissues')} queue-wait p99="
          f"{'n/a' if p99 is None else f'{p99}s'}\n")


def summarize(paths: list, top: int) -> int:
    phases: dict = {}             # phase -> [seconds]
    slowest = []                  # (elapsed_s, label, detail)
    n_traces = n_spans = 0
    # The verification tier's outcomes, from the traces' event names; the
    # line prints only when one fired.
    verif = {"claim_failed": 0, "audit": 0, "audit_passed": 0,
             "audit_failed": 0, "audit_repair": 0}
    rollups, blobs = [], []
    for path in paths:
        for kind, obj in _iter_records(path):
            if kind == "rollup":
                rollups.append(obj)
                continue
            if kind == "blob":
                blobs.append(obj)
                continue
            if kind == "capture":
                k = obj.get("k")
                if k == "span":
                    n_spans += 1
                    for ph in tracing.SPAN_PHASES:
                        v = obj.get(ph)
                        if isinstance(v, (int, float)):
                            phases.setdefault(ph, []).append(float(v))
                elif k == "rep" and not obj.get("cached"):
                    slowest.append((float(obj.get("el", 0.0)),
                                    f"tenant {obj.get('ten')}",
                                    f"t={obj.get('t')}"))
                continue
            n_traces += 1
            events = obj.get("events", [])
            reply = next((e for e in events if e.get("event") == "reply"),
                         None)
            worst_phase, worst_v = None, 0.0
            for ev in events:
                name = ev.get("event")
                if name in verif:
                    verif[name] += 1
                elif name == "merge" and ev.get("audit_repair"):
                    verif["audit_repair"] += 1
                if name != "miner_span":
                    continue
                n_spans += 1
                for ph in tracing.SPAN_PHASES:
                    v = ev.get(ph)
                    if isinstance(v, (int, float)):
                        phases.setdefault(ph, []).append(float(v))
                        if v > worst_v:
                            worst_phase, worst_v = ph[:-2], float(v)
            if reply is not None and isinstance(reply.get("elapsed_s"),
                                                (int, float)):
                meta = obj.get("meta", {})
                label = f"{obj.get('key')} (tenant {meta.get('client')})"
                detail = (f"slowest phase {worst_phase} {worst_v:.4f}s"
                          if worst_phase else "no spans folded")
                slowest.append((float(reply["elapsed_s"]), label, detail))
    if not phases and not slowest and not rollups and not blobs:
        print("dbmtrace summarize: no spans, replies, or rollup "
              f"snapshots found in {paths}", file=sys.stderr)
        return 1
    print(f"{n_traces} trace(s), {n_spans} span(s), "
          f"{len(slowest)} replied request(s)\n")
    _print_rollups(rollups, blobs)
    if phases:
        print(f"{'phase':<10} {'count':>7} {'p50':>10} {'p90':>10} "
              f"{'max':>10}")
        for ph in tracing.SPAN_PHASES:
            xs = sorted(phases.get(ph, ()))
            if xs:
                print(f"{ph[:-2]:<10} {len(xs):>7} {_pctl(xs, 0.5):>10.6f} "
                      f"{_pctl(xs, 0.9):>10.6f} {xs[-1]:>10.6f}")
    if any(verif.values()):
        print(f"\nverification: {verif['claim_failed']} claim(s) "
              f"rejected, {verif['audit']} audit(s) issued "
              f"({verif['audit_passed']} passed, "
              f"{verif['audit_failed']} failed, "
              f"{verif['audit_repair']} repair merge(s))")
    if slowest:
        slowest.sort(key=lambda r: -r[0])
        print(f"\nslowest {min(top, len(slowest))} request(s):")
        for elapsed, label, detail in slowest[:top]:
            print(f"  {elapsed:>10.4f}s  {label}  [{detail}]")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dbmtrace", description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("convert", help="trace dumps -> Chrome JSON")
    c.add_argument("dumps", nargs="+")
    c.add_argument("-o", "--out", required=True)
    s = sub.add_parser("summarize", help="span phases, slow requests and "
                       "the rollup's headline")
    s.add_argument("dumps", nargs="+")
    s.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    if args.mode == "convert":
        return convert(args.dumps, args.out)
    return summarize(args.dumps, args.top)


if __name__ == "__main__":
    sys.exit(main())
