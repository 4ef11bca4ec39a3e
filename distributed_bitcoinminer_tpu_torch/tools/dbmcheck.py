"""dbmcheck CLI — deterministic interleaving exploration of the port's
control plane.

Usage:
    python -m distributed_bitcoinminer_tpu_torch.tools.dbmcheck     # all scenarios
    ... dbmcheck --scenario qos_shed --seeds 500
    ... dbmcheck --replay 'lease_reissue:rw:42'
    ... dbmcheck --replay 'qos_shed:tr:7:0.2.1'
    ... dbmcheck --fixtures         # prove the checker bites
    ... dbmcheck --list

Exit codes: 0 every explored schedule held every invariant, 1 at least
one violation (each printed with a DBMCHECK_REPRO= seed spec that
replays its schedule bit-for-bit; failing random walks are SHRUNK to a
minimal choice trace first), 2 usage.

Environment defaults (all routed through ``utils/_env``; see the knob
tables in the package README / utils/config.py):

- ``DBMT_CHECK_SEEDS``     random-walk seeds per scenario (default 200)
- ``DBMT_CHECK_BUDGET_S``  wall budget for the whole run (default 75)
- ``DBMT_CHECK_DFS``       bounded-DFS schedules per scenario (default
                           64; 0 disables the DFS pass)
- ``DBMT_CHECK_SCENARIOS`` comma-separated scenario subset (default: the
                           full real-scenario catalog)
- ``DBMT_CHECK_CAPTURE``   the capture ``replayed_storm`` replays

The process pins ``DBMT_METRICS_INTERVAL_S=0`` (no emitter thread racing
the virtual clock) and defaults ``DBMT_SANITIZE=1`` so the ownership /
off-loop counters are armed as schedule invariants.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..utils._env import float_env, int_env, str_env


def _arm():
    """Environment discipline BEFORE the control plane is imported (in
    ``main``, so importing this module changes nothing): the metrics
    emitter thread would tick on the patched virtual clock, and the
    sanitizer plane should be armed for every scenario scheduler.
    Returns the explorer."""
    os.environ["DBMT_METRICS_INTERVAL_S"] = "0"
    os.environ.setdefault("DBMT_SANITIZE", "1")
    from ..analysis import schedcheck
    return schedcheck


def _parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scenario", default=None,
                        help="comma-separated scenario subset")
    parser.add_argument("--seeds", type=int,
                        default=int_env("DBMT_CHECK_SEEDS", 200),
                        help="random-walk seeds per scenario")
    parser.add_argument("--seed0", type=int, default=0,
                        help="first seed (seed space offset)")
    parser.add_argument("--budget-s", type=float,
                        default=float_env("DBMT_CHECK_BUDGET_S", 75.0),
                        help="wall budget for the whole exploration")
    parser.add_argument("--dfs", type=int,
                        default=int_env("DBMT_CHECK_DFS", 64),
                        help="bounded-DFS schedules per scenario (0=off)")
    parser.add_argument("--dfs-depth", type=int, default=6,
                        help="choice points the DFS branches over")
    parser.add_argument("--replay", default=None, metavar="SPEC",
                        help="re-execute one seed spec and report")
    parser.add_argument("--fixtures", action="store_true",
                        help="explore the known-bad fixtures instead "
                             "(violations EXPECTED; rc reflects them)")
    parser.add_argument("--list", action="store_true",
                        help="list scenarios and exit")
    return parser.parse_args(argv)


def _report_failure(schedcheck, result, shrunk=None) -> None:
    print(f"\nVIOLATION in {result.scenario} "
          f"(seed {result.seed}, {len(result.steps)} steps):")
    for v in result.violations:
        print(f"  - {v}")
    print(f"  DBMCHECK_REPRO={schedcheck.format_spec(result)}")
    if shrunk is not None:
        print(f"  shrunk to {len([c for c in shrunk.choices if c])} "
              f"non-default choices over {len(shrunk.trace)} choice "
              f"points:")
        print(f"  DBMCHECK_REPRO={schedcheck.format_spec(shrunk, shrunk=True)}")


def main(argv=None) -> int:
    args = _parse_args(argv)
    schedcheck = _arm()
    if args.list:
        for name in schedcheck.SCENARIOS:
            print(f"{name:24s} (scenario)")
        for name in schedcheck.FIXTURES:
            print(f"{name:24s} (known-bad fixture)")
        return 0

    if args.replay:
        result = schedcheck.replay(args.replay)
        print(f"replayed {args.replay}: status={result.status} "
              f"steps={len(result.steps)} "
              f"choice_points={len(result.trace)}")
        if result.failed:
            _report_failure(schedcheck, result)
            return 1
        print("all invariants held")
        return 0

    if args.scenario:
        names = [n.strip() for n in args.scenario.split(",") if n.strip()]
    elif args.fixtures:
        names = list(schedcheck.FIXTURES)
    else:
        env_names = str_env("DBMT_CHECK_SCENARIOS", "")
        names = ([n.strip() for n in env_names.split(",") if n.strip()]
                 if env_names else list(schedcheck.SCENARIOS))
    for n in names:
        if n not in schedcheck.ALL:
            print(f"unknown scenario {n!r}; known: "
                  f"{sorted(schedcheck.ALL)}", file=sys.stderr)
            return 2

    stats = schedcheck.explore_scenarios(
        names, seeds=args.seeds, seed0=args.seed0,
        budget_s=args.budget_s, dfs_limit=args.dfs,
        dfs_depth=args.dfs_depth)

    total_explored = total_distinct = 0
    rc = 0
    for name, st in stats.items():
        s = st.summary()
        total_explored += s["explored"]
        total_distinct += s["distinct"]
        print(f"{name:24s} explored={s['explored']:5d} "
              f"distinct={s['distinct']:5d} "
              f"violations={s['violations']:3d} "
              f"elapsed={s['elapsed_s']:6.2f}s")
        for failure in st.failures:
            rc = 1
            shrunk = schedcheck.shrink(failure)
            _report_failure(schedcheck, failure, shrunk)
    print(f"DBMCHECK_EXPLORED={total_explored}")
    print(f"DBMCHECK_DISTINCT={total_distinct}")
    print(f"DBMCHECK_RC={rc}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
