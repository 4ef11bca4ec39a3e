"""Perfetto export and summary of the port's request traces, the
counterpart of the JAX package's ``scripts/dbmtrace.py`` (its ``convert``
and ``summarize`` modes).

    python -m distributed_bitcoinminer_tpu_torch.tools.dbmtrace \\
        convert DUMP... -o trace.json
    python -m distributed_bitcoinminer_tpu_torch.tools.dbmtrace \\
        summarize DUMP... [--top N]

A DUMP is a file of lines: ``RequestTrace.to_dict()`` objects as JSON,
a Chrome trace written by ``Scheduler.export_trace`` (its slices are
read back as one trace a request), or log lines holding a ``trace dump
(...): {...}`` payload (the scheduler's age alarms write them to
``log.txt``). ``convert`` writes Chrome trace-event JSON that loads in
ui.perfetto.dev: one track per tenant and per miner, the requests'
slices, the fault events as instants and the miners' stitched phases.
``summarize`` prints each span phase's count, p50, p90 and max, and the
slowest requests with their slowest phase.
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


def _pctl(xs: list, q: float) -> float:
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def summarize(paths: list, top: int) -> int:
    phases: dict = {}             # phase -> [seconds]
    slowest = []                  # (elapsed_s, label, detail)
    n_traces = n_spans = 0
    for path in paths:
        for obj in _iter_trace_dicts(path):
            n_traces += 1
            events = obj.get("events", [])
            reply = next((e for e in events if e.get("event") == "reply"),
                         None)
            worst_phase, worst_v = None, 0.0
            for ev in events:
                if ev.get("event") != "miner_span":
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
    if not phases and not slowest:
        print(f"dbmtrace summarize: no spans or replies found in {paths}",
              file=sys.stderr)
        return 1
    print(f"{n_traces} trace(s), {n_spans} span(s), "
          f"{len(slowest)} replied request(s)\n")
    if phases:
        print(f"{'phase':<10} {'count':>7} {'p50':>10} {'p90':>10} "
              f"{'max':>10}")
        for ph in tracing.SPAN_PHASES:
            xs = sorted(phases.get(ph, ()))
            if xs:
                print(f"{ph[:-2]:<10} {len(xs):>7} {_pctl(xs, 0.5):>10.6f} "
                      f"{_pctl(xs, 0.9):>10.6f} {xs[-1]:>10.6f}")
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
    s = sub.add_parser("summarize", help="span phases and slow requests")
    s.add_argument("dumps", nargs="+")
    s.add_argument("--top", type=int, default=10)
    args = ap.parse_args(argv)
    if args.mode == "convert":
        return convert(args.dumps, args.out)
    return summarize(args.dumps, args.top)


if __name__ == "__main__":
    sys.exit(main())
