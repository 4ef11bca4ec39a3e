"""loadharness: the control plane's load harness from the command line.

Counterpart of the JAX package's ``scripts/loadharness.py``. One leg of
``apps.loadharness`` (a storm on detnet with instant miners, an
adversarial workload, a capture's replay, or the process tier over UDP),
printed as one JSON line:

    python -m distributed_bitcoinminer_tpu_torch.tools.loadharness \\
        --tenants 500 --assert-p99 30 --assert-series 256
    python -m distributed_bitcoinminer_tpu_torch.tools.loadharness \\
        --workload mice_stampede --adapt 1
    python -m distributed_bitcoinminer_tpu_torch.tools.loadharness \\
        --replay capture.jsonl --assert-fidelity
    python -m distributed_bitcoinminer_tpu_torch.tools.loadharness \\
        --procs --tenants 200 --replicas 2 --assert-rollup

The ``--assert-*`` flags make the run a gate, which exits 1 on a
violation: every request not shed must complete, the replies' p99 stay
under its ceiling, the process's metric series stay bounded (per-tenant
labels must collapse under the cardinality bound), and, per mode, the
completed share, the replay's fidelity or the cluster's rollup hold.
"""

from __future__ import annotations

import argparse
import json
import sys


def _series_count() -> int:
    from ..utils.metrics import registry
    snap = registry().snapshot()
    return sum(len(snap.get(family, {}))
               for family in ("counters", "gauges", "histograms", "ewmas"))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="loadharness", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tenants", type=int, default=None,
                    help="tenants (default 1000, or the workload's own "
                         "with --workload)")
    ap.add_argument("--replicas", type=int, default=None)
    ap.add_argument("--miners", type=int, default=None,
                    help="miners (default 4; a detnet --replay models the "
                         "pool from the capture unless this is given)")
    ap.add_argument("--requests-per-tenant", type=int, default=None)
    ap.add_argument("--nonces", type=int, default=None)
    ap.add_argument("--max-queued", type=int, default=None)
    ap.add_argument("--recv-batch", type=int, default=None)
    ap.add_argument("--trace-sample", type=float, default=None)
    ap.add_argument("--qos-lazy", type=int, choices=(0, 1), default=None,
                    help="pin the grant pump: 1 lazy, 0 eager (default: "
                         "the port's, eager)")
    ap.add_argument("--procs", action="store_true",
                    help="drive the process tier (router and replica "
                         "processes, instant agents, real UDP) instead of "
                         "detnet")
    ap.add_argument("--drivers", type=int, default=1,
                    help="shard the --procs driver over this many "
                         "processes")
    ap.add_argument("--workload", default=None,
                    choices=("mice_stampede", "tenant_churn",
                             "elephant_convoy"),
                    help="run one adversarial workload instead of the "
                         "uniform storm (--adapt picks the leg)")
    ap.add_argument("--adapt", type=int, choices=(0, 1), default=0,
                    help="with --workload: 1 the adapt plane's "
                         "controllers, 0 the static knobs")
    ap.add_argument("--capture-to", default=None, metavar="PATH",
                    help="write the storm's workload capture to PATH")
    ap.add_argument("--replay", default=None, metavar="PATH",
                    help="replay a capture instead of a storm; prints the "
                         "capture's baseline and the fidelity verdict")
    ap.add_argument("--replay-speed", type=float, default=None,
                    help="the --replay time warp (default "
                         "DBMT_REPLAY_SPEED, 1.0)")
    ap.add_argument("--assert-fidelity", action="store_true",
                    help="gate (--replay): the replay within the stated "
                         "fidelity bounds")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--assert-p99", type=float, default=None,
                    help="gate: the replies' p99 ceiling in seconds")
    ap.add_argument("--assert-complete", type=float, default=None,
                    help="gate (workloads, replays): the least completed "
                         "share of the requests")
    ap.add_argument("--assert-series", type=int, default=None,
                    help="gate: the most metric series after the run")
    ap.add_argument("--assert-rollup", action="store_true",
                    help="gate (--procs): every process published a fresh "
                         "rollup blob and the merged results_sent covers "
                         "the completed requests")
    return ap


def _refuse(ap, mode: str, why: str, flags) -> None:
    """A flag the mode does not read is an error, not silently dropped:
    the JSON would look as if it had been measured."""
    for flag, value in flags:
        if value is not None:
            ap.error(f"{flag} does not apply to {mode} runs ({why})")


def run_leg(ap, args) -> dict:
    from ..apps.loadharness import (run_adversarial, run_load,
                                    run_load_procs, run_replay,
                                    run_replay_procs)
    tenants = args.tenants if args.tenants is not None else 1000
    miners = args.miners if args.miners is not None else 4
    drivers = args.drivers if args.drivers != 1 else None
    if args.replay is not None:
        _refuse(ap, "--replay", "the capture owns the workload's shape", (
            ("--workload", args.workload), ("--tenants", args.tenants),
            ("--requests-per-tenant", args.requests_per_tenant),
            ("--nonces", args.nonces), ("--max-queued", args.max_queued),
            ("--capture-to", args.capture_to),
            ("--recv-batch", args.recv_batch),
            ("--trace-sample", args.trace_sample),
            ("--qos-lazy", args.qos_lazy), ("--drivers", drivers)))
        if args.procs:
            return run_replay_procs(
                args.replay,
                replicas=args.replicas if args.replicas is not None else 2,
                miners=miners, speed=args.replay_speed,
                timeout_s=args.timeout)
        if args.replicas is not None:
            ap.error("--replicas applies to --replay only with --procs "
                     "(the detnet replay is one replica)")
        return run_replay(args.replay, speed=args.replay_speed,
                          miners=args.miners, timeout_s=args.timeout)
    if args.workload is not None:
        _refuse(ap, "--workload", "the workload owns it", (
            ("--replicas", args.replicas),
            ("--requests-per-tenant", args.requests_per_tenant),
            ("--nonces", args.nonces), ("--max-queued", args.max_queued),
            ("--drivers", drivers), ("--procs", args.procs or None)))
        return run_adversarial(
            args.workload, adapt=bool(args.adapt), tenants=args.tenants,
            miners=miners, capture_path=args.capture_to,
            timeout_s=args.timeout)
    if args.procs:
        if args.capture_to is not None:
            ap.error("--capture-to does not apply to --procs runs (arm "
                     "DBMT_CAPTURE in the replica processes' environment)")
        return run_load_procs(
            tenants=tenants,
            replicas=args.replicas if args.replicas is not None else 1,
            miners=miners,
            requests_per_tenant=args.requests_per_tenant or 1,
            req_nonces=args.nonces or 256, drivers=args.drivers,
            timeout_s=args.timeout)
    return run_load(
        tenants=tenants,
        replicas=args.replicas if args.replicas is not None else 1,
        miners=miners,
        requests_per_tenant=args.requests_per_tenant or 1,
        req_nonces=args.nonces or 256,
        max_queued=args.max_queued if args.max_queued is not None
        else 4096,
        recv_batch=args.recv_batch, trace_sample=args.trace_sample,
        qos_lazy=None if args.qos_lazy is None else bool(args.qos_lazy),
        capture_path=args.capture_to, timeout_s=args.timeout)


def violations(args, leg: dict) -> list:
    """The gate's violations of one leg (empty: it passes)."""
    out = []
    if args.workload is not None or args.replay is not None:
        # These shed by design: every request is answered or shed with
        # its conn closed, and --assert-complete floors the answered.
        expected = leg["requests"] - leg.get("shed_requests", 0)
    else:
        expected = leg["requests"] \
            - leg["shed_tenants"] * (args.requests_per_tenant or 1)
    if args.replay is not None and args.assert_fidelity:
        fid = leg.get("fidelity", {})
        if not fid.get("within"):
            out.append(f"replay fidelity outside the stated bounds: "
                       f"{fid.get('violations')}")
    if leg.get("timed_out"):
        out.append("storm timed out")
    if leg["completed"] < expected:
        out.append(f"only {leg['completed']}/{expected} non-shed requests "
                   f"completed")
    if args.assert_complete is not None and leg["requests"] and \
            leg["completed"] / leg["requests"] < args.assert_complete:
        out.append(f"completed fraction "
                   f"{leg['completed'] / leg['requests']:.3f} under the "
                   f"{args.assert_complete} floor")
    if args.assert_p99 is not None and leg["p99_s"] is not None \
            and leg["p99_s"] > args.assert_p99:
        out.append(f"p99 {leg['p99_s']}s over the {args.assert_p99}s "
                   f"ceiling")
    after = leg["metric_series"]["after"]
    if args.assert_series is not None and after > args.assert_series:
        out.append(f"{after} metric series after the run (bound "
                   f"{args.assert_series}): unbounded label growth")
    if args.assert_rollup:
        ru = leg.get("rollup")
        want = 1 + leg.get("replicas", 0) + leg.get("miners", 0)
        if not isinstance(ru, dict) or "error" in ru:
            out.append(f"no rollup summary in the leg (DBMT_ROLLUP off, "
                       f"or the aggregate failed: {ru})")
        else:
            if ru.get("fresh", 0) < want:
                out.append(f"only {ru.get('fresh')}/{want} cluster "
                           f"processes published a fresh rollup blob: {ru}")
            if ru.get("results_sent", 0) < leg["completed"]:
                out.append(f"rollup results_sent {ru.get('results_sent')} "
                           f"under the {leg['completed']} completed "
                           f"requests")
    return out


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.assert_rollup and not args.procs:
        ap.error("--assert-rollup applies only to --procs runs")
    before = _series_count()
    leg = run_leg(ap, args)
    leg["metric_series"] = {"before": before, "after": _series_count()}
    print(json.dumps(leg, sort_keys=True), flush=True)
    bad = violations(args, leg)
    for line in bad:
        print(f"LOAD_GATE: {line}", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
