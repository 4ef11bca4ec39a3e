"""dbmcheck exploration engine: random walks, bounded DFS, shrinking.

Three exploration modes over one scenario:

- **Random walk** (``run_walks``): N seeds, each a fully deterministic
  (population, schedule) sample — the workhorse; distinct schedules are
  counted by hashing the executed step-label sequence.
- **Bounded exhaustive DFS** (``run_dfs``): systematic enumeration of
  the choice tree for SMALL scopes — the scenario's constants are
  pinned to one seed, the first ``depth`` choice points branch over
  every alternative (beyond them the FIFO default 0), and prefixes are
  re-executed from scratch (schedules are cheap and deterministic, so
  replay-based DFS needs no forking).
- **Replay** (``replay``): re-execute one SEED SPEC exactly — either a
  random-walk seed (``rw:<seed>``) or a shrunk explicit choice trace
  (``tr:<seed>:<c.c.c>``). The spec a failure prints IS its repro.

**Shrinking**: a failing random walk is first re-run through its
recorded choice trace (same schedule, explicit form), then minimized:
every choice is greedily replaced by the FIFO default 0 and the trace
truncated to the last non-default choice — each candidate re-executed,
kept only if it still fails. The result is the minimal-preemption
repro trace, the loom/Shuttle shape of "the race in three context
switches".
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

from .scenario import ScheduleResult, execute
from .scenarios import ALL

__all__ = ["run_walks", "run_dfs", "replay", "shrink", "format_spec",
           "parse_spec", "ExploreStats"]


class ExploreStats:
    """Per-scenario exploration tally."""

    def __init__(self, scenario: str):
        self.scenario = scenario
        self.explored = 0
        self.distinct: set = set()
        self.failures: List[ScheduleResult] = []
        self.elapsed_s = 0.0

    def record(self, result: ScheduleResult) -> None:
        self.explored += 1
        self.distinct.add(result.schedule_key())
        if result.failed:
            self.failures.append(result)

    def summary(self) -> dict:
        return {
            "scenario": self.scenario,
            "explored": self.explored,
            "distinct": len(self.distinct),
            "violations": len(self.failures),
            "elapsed_s": round(self.elapsed_s, 2),
        }


def _usage_error(msg: str):
    """Usage-shaped failure: exit 2, never 1 (the CLI contract reserves
    1 for a real invariant violation — a typo'd spec must not page)."""
    print(msg, file=sys.stderr)
    raise SystemExit(2)


def _scenario(name: str):
    try:
        return ALL[name]()
    except KeyError:
        _usage_error(f"unknown scenario {name!r}; known: {sorted(ALL)}")


def format_spec(result: ScheduleResult, shrunk: bool = False) -> str:
    """The replayable seed spec of one executed schedule. A result that
    was produced from an explicit choice trace (DFS, replay, shrink)
    always formats as ``tr:`` — its ``rw:`` seed would replay a
    DIFFERENT (random-walk) schedule."""
    if shrunk or result.explicit:
        choices = ".".join(str(c) for c in result.choices)
        return f"{result.scenario}:tr:{result.seed}:{choices}"
    return f"{result.scenario}:rw:{result.seed}"


def parse_spec(spec: str):
    """``(scenario, seed, choices_or_None)`` from a printed seed spec."""
    parts = spec.split(":")
    if len(parts) >= 3 and parts[1] == "rw":
        return parts[0], int(parts[2]), None
    if len(parts) >= 3 and parts[1] == "tr":
        choices = []
        if len(parts) > 3 and parts[3]:
            choices = [int(c) for c in parts[3].split(".")]
        return parts[0], int(parts[2]), choices
    _usage_error(f"malformed seed spec {spec!r} (want "
                 f"scenario:rw:<seed> or scenario:tr:<seed>:<c.c.c>)")


def replay(spec: str) -> ScheduleResult:
    name, seed, choices = parse_spec(spec)
    return execute(_scenario(name), seed, choices=choices)


def run_walks(name: str, seeds: int, seed0: int = 0,
              budget_s: Optional[float] = None,
              stats: Optional[ExploreStats] = None) -> ExploreStats:
    """``seeds`` random-walk schedules of one scenario (stopping early
    on budget exhaustion — a gate run is wall-bounded)."""
    st = stats if stats is not None else ExploreStats(name)
    t0 = time.perf_counter()
    for i in range(seeds):
        if budget_s is not None and time.perf_counter() - t0 > budget_s:
            break
        st.record(execute(_scenario(name), seed0 + i))
    st.elapsed_s += time.perf_counter() - t0
    return st


def run_dfs(name: str, seed: int = 0, depth: int = 6, limit: int = 200,
            budget_s: Optional[float] = None,
            stats: Optional[ExploreStats] = None) -> ExploreStats:
    """Bounded exhaustive DFS over the first ``depth`` choice points.

    Classic replay-based state-space walk: run a prefix of forced
    choices (0 beyond it), read how many alternatives each choice point
    actually had, and push every unexplored sibling of the first
    ``depth`` points. ``limit`` caps total schedules."""
    st = stats if stats is not None else ExploreStats(f"{name}[dfs]")
    t0 = time.perf_counter()
    seen_prefix: set = set()
    stack: List[List[int]] = [[]]
    ran = 0
    while stack and ran < limit:
        if budget_s is not None and time.perf_counter() - t0 > budget_s:
            break
        prefix = stack.pop()
        key = tuple(prefix)
        if key in seen_prefix:
            continue
        seen_prefix.add(key)
        result = execute(_scenario(name), seed, choices=prefix)
        ran += 1
        st.record(result)
        # Expand: for each choice point within bounds, the siblings of
        # the choice actually taken. Later points first (LIFO -> DFS).
        for pos in range(min(len(result.trace), depth) - 1, -1, -1):
            n_alt, taken = result.trace[pos]
            if pos < len(prefix):
                continue   # already forced; siblings queued elsewhere
            for alt in range(n_alt):
                if alt != taken:
                    stack.append(result.choices[:pos] + [alt])
    st.elapsed_s += time.perf_counter() - t0
    return st


def shrink(result: ScheduleResult, max_runs: int = 400) -> ScheduleResult:
    """Minimal-preemption repro of a failing schedule.

    Greedy: replay with the explicit trace; then left-to-right set each
    non-default choice to 0, keeping the change iff the violation
    persists; finally truncate trailing defaults (TracePicker pads with
    0). Every candidate is a full deterministic re-execution."""
    scen, seed = result.scenario, result.seed
    best = execute(_scenario(scen), seed, choices=result.choices)
    if not best.failed:
        # The trace replay no longer fails (should not happen — same
        # choices, same rng): fall back to the original result.
        return result
    runs = 0
    changed = True
    while changed and runs < max_runs:
        changed = False
        pos = 0
        # Bound re-read from the CURRENT best every iteration: a kept
        # candidate may have fewer choice points than the trace the
        # pass started from (zeroing one choice can cut whole task
        # chains), so a range frozen on the original length would walk
        # off the shorter trace.
        while pos < len(best.choices) and runs < max_runs:
            choices = list(best.choices)
            if choices[pos] != 0:
                cand = choices[:pos] + [0] + choices[pos + 1:]
                trial = execute(_scenario(scen), seed, choices=cand)
                runs += 1
                if trial.failed:
                    best = trial
                    changed = True
            pos += 1
    # Truncate trailing zeros: TracePicker's fallback supplies them.
    choices = list(best.choices)
    while choices and choices[-1] == 0:
        choices.pop()
    trial = execute(_scenario(scen), seed, choices=choices)
    if trial.failed:
        best = trial
        best.choices = choices   # canonical short form
    return best


def explore_scenarios(names: List[str], seeds: int, seed0: int,
                      budget_s: float, dfs_limit: int = 0,
                      dfs_depth: int = 6) -> Dict[str, ExploreStats]:
    """The gate's composition: random walks (plus an optional DFS pass)
    over each scenario, sharing one wall budget."""
    t0 = time.perf_counter()
    out: Dict[str, ExploreStats] = {}
    for name in names:
        remaining = budget_s - (time.perf_counter() - t0)
        if remaining <= 0:
            out[name] = ExploreStats(name)
            continue
        st = run_walks(name, seeds, seed0=seed0,
                       budget_s=remaining * 0.85 if dfs_limit else
                       remaining)
        if dfs_limit > 0:
            remaining = budget_s - (time.perf_counter() - t0)
            if remaining > 0:
                run_dfs(name, seed=seed0, depth=dfs_depth,
                        limit=dfs_limit, budget_s=remaining, stats=st)
        out[name] = st
    return out
