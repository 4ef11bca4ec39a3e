"""dbmlint CLI — the port's AST invariant gate.

Usage:
    python -m distributed_bitcoinminer_tpu_torch.tools.dbmlint
    ... dbmlint --list          # print every finding
    ... dbmlint --analyzer X    # run one analyzer
    ... dbmlint --update-baseline [--force]

Exit codes: 0 clean (new findings: none), 1 new findings, 2 usage/setup.

Pure AST + text: imports neither torch nor the analyzed code, and runs
in seconds on any box.

Baseline workflow: ``distributed_bitcoinminer_tpu_torch/analysis/baseline.json``
holds the accepted findings by stable key. A finding not in the baseline
FAILS the run (fix it, or suppress it at the site with
``# dbmlint: ok[<analyzer>] <why>``, or — rarely — grow the baseline
with ``--update-baseline --force``). A baseline entry that stops firing
is STALE; ``--update-baseline`` flushes it, so the file shrinks
monotonically over the repo's life.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..analysis import compare, load_baseline, run_repo, save_baseline
from ..analysis.core import baseline_path

#: The repo root: this package's parent.
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=_REPO, help="repo root")
    parser.add_argument("--baseline", default=None,
                        help="baseline file (default: "
                             "analysis/baseline.json under --repo)")
    parser.add_argument("--analyzer", default=None,
                        help="run only this analyzer")
    parser.add_argument("--list", action="store_true",
                        help="print every finding (known ones included)")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline to the current "
                             "finding set (shrink-only without --force)")
    parser.add_argument("--force", action="store_true",
                        help="allow --update-baseline to ADD findings")
    args = parser.parse_args(argv)

    if args.update_baseline and args.analyzer:
        # A partial run sees only one analyzer's findings; rewriting the
        # baseline from it would flush every OTHER analyzer's accepted
        # entries as "stale" and corrupt the shrink-only workflow.
        print("dbmlint: --update-baseline requires a full run; drop "
              "--analyzer", file=sys.stderr)
        return 2

    bpath = args.baseline or baseline_path(args.repo)
    baseline = load_baseline(bpath)
    if args.analyzer:
        # Partial run: other analyzers' baseline entries are invisible
        # to it, not stale.
        baseline = {k: v for k, v in baseline.items()
                    if k.startswith(args.analyzer + ":")}
    findings = run_repo(args.repo, only=args.analyzer)
    new, known, stale = compare(findings, baseline)

    if args.list:
        for f in findings:
            mark = "NEW " if f.key not in baseline else "base"
            print(f"{mark} {f.render()}")

    if args.update_baseline:
        if new and not args.force:
            print(f"dbmlint: refusing to GROW the baseline by "
                  f"{len(new)} finding(s) without --force "
                  f"(fix or suppress them instead):", file=sys.stderr)
            for f in new:
                print("  " + f.render(), file=sys.stderr)
            return 1
        save_baseline(bpath, findings)
        print(f"dbmlint: baseline rewritten: {len(findings)} entr"
              f"{'y' if len(findings) == 1 else 'ies'} "
              f"({len(stale)} stale flushed, {len(new)} added)")
        return 0

    if new:
        print(f"dbmlint: {len(new)} NEW finding(s) "
              f"(not in {os.path.relpath(bpath, args.repo)}):",
              file=sys.stderr)
        for f in new:
            print("  " + f.render(), file=sys.stderr)
        return 1
    if stale:
        print(f"dbmlint: clean; {len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'} no longer fire — "
              f"flush with --update-baseline:")
        for k in stale:
            print("  " + k)
    n = len(findings)
    print(f"dbmlint: clean ({n} known finding(s) baselined, "
          f"0 new)" if n else "dbmlint: clean (no findings)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
