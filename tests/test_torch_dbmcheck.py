"""dbmcheck on the port: its explorer held against the JAX package's.

Layers, as the checker's own trust chain:

1. **DetLoop**: the controlled event loop replays a schedule bit for bit
   from its seed, explores distinct schedules across seeds, drives
   timers and ``time.monotonic`` from its virtual clock, and runs a
   ``to_thread`` hop off the loop.
2. **Fixtures**: each known-bad fixture fails at the same random-walk
   seeds and at the same first DFS spec as under the JAX explorer, and
   shrinks to the same trace; the CLI's printed specs replay.
3. **Lockstep**: for every scenario and seeds 0-9 the port's schedule
   gives the JAX schedule's replies (request, hash, nonce, per-tenant
   order) and its step labels, and neither side a violation. The JAX
   package's multi-scheduler scenarios leave their schedulers'
   verification tier to the environment (audits at ``DBM_AUDIT_P``,
   default 2%, from an unseeded stream), where the port's scenarios pin
   ``VerifyParams()``; the JAX side runs here with ``DBM_AUDIT_P=0`` so
   both explore the same schedules.
4. **Catalogue**: 25 seeds of every port scenario hold every invariant.
5. **Liveness**: a deadlock and a spinning scenario are reported.
6. **Card searcher**: ``chip_smoke.card_scenarios`` on the plain tier
   (``device="cpu"``) passes the miner-pipeline scenarios, each
   schedule the fake's step for step.

No sockets, no card, no wall-clock sleeps.
"""

import asyncio
import os
import re
import subprocess
import sys

import pytest

import distributed_bitcoinminer_tpu.analysis.schedcheck as jax_check
from distributed_bitcoinminer_tpu_torch.analysis import schedcheck
from distributed_bitcoinminer_tpu_torch.analysis.schedcheck import (
    ALL, FIXTURES, SCENARIOS, execute, format_spec, parse_spec, replay,
    run_dfs, run_walks, shrink)
from distributed_bitcoinminer_tpu_torch.analysis.schedcheck.detloop import (
    DetLoop, virtual_time)
from distributed_bitcoinminer_tpu_torch.analysis.schedcheck.scenario import (
    Ctx, Scenario)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "distributed_bitcoinminer_tpu_torch"


@pytest.fixture
def jax_audits_off(monkeypatch):
    """The JAX scenarios' environment-read verification tier with audits
    off, as the port's scenarios pin it (module docstring)."""
    monkeypatch.setenv("DBM_AUDIT_P", "0")


# ------------------------------------------------------------ detloop core

def test_detloop_virtual_clock_drives_timers_and_monotonic():
    loop = DetLoop()
    seen = []

    async def main():
        import time
        await asyncio.sleep(0.5)
        seen.append((loop.time(), time.monotonic()))

    with loop.running(), virtual_time(loop):
        t = loop.create_task(main())
        status = loop.run_until(t.done, 100, 10.0)
        loop.drain()
    loop.close()
    assert status == "done" and seen == [(0.5, 0.5)]
    assert not loop.exceptions


def test_detloop_to_thread_runs_off_loop():
    loop = DetLoop()
    out = {}

    def job():
        try:
            asyncio.get_running_loop()
            out["on_loop"] = True
        except RuntimeError:
            out["on_loop"] = False
        return 42

    async def main():
        out["result"] = await asyncio.to_thread(job)

    with loop.running(), virtual_time(loop):
        t = loop.create_task(main())
        assert loop.run_until(t.done, 100, 10.0) == "done"
        loop.drain()
    loop.close()
    assert out == {"on_loop": False, "result": 42}
    assert any(s.startswith("executor:") and s.endswith("job")
               for s in loop.steps)


@pytest.mark.parametrize("name", ["lease_reissue", "qos_shed",
                                  "pipelined_dispatch", "replica_takeover",
                                  "federation"])
def test_golden_replay_reproduces_the_step_sequence(name):
    """Same seed, same executed steps: across executions, through the
    printed spec and through the explicit choice trace."""
    first = execute(ALL[name](), 11)
    again = execute(ALL[name](), 11)
    via_spec = replay(f"{name}:rw:11")
    via_trace = execute(ALL[name](), 11, choices=first.choices)
    assert first.steps == again.steps == via_spec.steps == via_trace.steps
    assert first.trace == again.trace == via_spec.trace
    assert len(first.steps) > 20


def test_distinct_seeds_explore_distinct_schedules():
    keys = {execute(ALL["lease_reissue"](), seed).schedule_key()
            for seed in range(12)}
    assert len(keys) >= 10
    st = run_walks("lease_reissue", 15, seed0=100)
    assert st.explored == 15 and len(st.distinct) >= 13
    assert not st.failures


def test_spec_roundtrip():
    assert parse_spec("qos_shed:rw:42") == ("qos_shed", 42, None)
    assert parse_spec("qos_shed:tr:7:0.2.1") == ("qos_shed", 7, [0, 2, 1])
    assert parse_spec("qos_shed:tr:7:") == ("qos_shed", 7, [])


def test_the_catalogue_is_the_jax_packages():
    assert list(SCENARIOS) == list(jax_check.SCENARIOS)
    assert list(FIXTURES) == list(jax_check.FIXTURES)
    assert len(SCENARIOS) == 17 and len(FIXTURES) == 2


# ------------------------------------------------- known-bad sensitivity

@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_fixture_caught_at_the_jax_seeds_and_shrunk_alike(fixture):
    """Random walk: the same failing seeds in 30 as the JAX explorer;
    DFS: the same first failing spec; the first failure shrinks to the
    same trace and replays."""
    ours = [s for s in range(30) if execute(ALL[fixture](), s).failed]
    theirs = [s for s in range(30)
              if jax_check.execute(jax_check.ALL[fixture](), s).failed]
    assert ours and ours == theirs
    dfs = run_dfs(fixture, seed=0, depth=4, limit=40)
    jdfs = jax_check.run_dfs(fixture, seed=0, depth=4, limit=40)
    assert dfs.failures and format_spec(dfs.failures[0]) == \
        jax_check.format_spec(jdfs.failures[0])
    assert ":tr:" in format_spec(dfs.failures[0])
    small = shrink(execute(ALL[fixture](), ours[0]))
    jsmall = jax_check.shrink(jax_check.execute(jax_check.ALL[fixture](),
                                                ours[0]))
    assert small.failed and small.choices == jsmall.choices
    assert small.steps == jsmall.steps
    spec = format_spec(small, shrunk=True)
    assert spec == jax_check.format_spec(jsmall, shrunk=True)
    rr = replay(spec)
    assert rr.failed and rr.steps == small.steps


def test_shrink_survives_choice_point_collapse():
    """Zeroing one choice may cut whole task chains: the shrink walk
    must re-read its bound instead of indexing off the end."""
    class Collapsing(Scenario):
        name = "collapse_fixture"

        def build(self, ctx: Ctx) -> None:
            tasks = []

            async def worker(i):
                await asyncio.sleep(0)
                await asyncio.sleep(0)

            async def canceller():
                for t in tasks:
                    t.cancel()

            for i in range(3):
                tasks.append(ctx.spawn(worker(i), client=True))
            ctx.spawn(canceller(), client=True)

        def check(self, ctx: Ctx):
            return ["always fails (shrink-mechanics fixture)"]

    ALL["collapse_fixture"] = Collapsing
    try:
        for seed in range(6):
            small = shrink(execute(Collapsing(), seed))
            assert small.failed
    finally:
        del ALL["collapse_fixture"]


def _cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", f"{PORT}.tools.dbmcheck",
                           *args], env=env, capture_output=True, text=True,
                          cwd=REPO, timeout=300)


def test_cli_fixtures_fail_and_every_printed_spec_replays():
    r = _cli("--fixtures", "--seeds", "3", "--dfs", "4")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "DBMCHECK_RC=1" in r.stdout
    specs = sorted(set(re.findall(r"DBMCHECK_REPRO=(\S+)", r.stdout)))
    assert {s.split(":")[0] for s in specs} == set(FIXTURES)
    for spec in specs:
        rr = _cli("--replay", spec)
        assert rr.returncode == 1 and "VIOLATION" in rr.stdout, spec
        # Bit for bit: the CLI's replay is this process's replay.
        steps = int(re.search(r"steps=(\d+)", rr.stdout).group(1))
        assert steps == len(replay(spec).steps)


def test_cli_clean_catalogue_and_usage_errors():
    r = _cli("--seeds", "2", "--dfs", "0", "--budget-s", "120")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "DBMCHECK_RC=0" in r.stdout
    assert all(re.search(rf"^{n}\s+explored=\s*2 ", r.stdout, re.M)
               for n in SCENARIOS)
    assert _cli("--replay", "nope").returncode == 2
    assert _cli("--scenario", "no_such_scenario").returncode == 2
    listed = _cli("--list")
    assert listed.returncode == 0
    assert all(n in listed.stdout for n in ALL)


# ------------------------------------------------------ lockstep with JAX

def _run(pkg, name, seed):
    """One schedule with its population kept: (result, replies), the
    replies per tenant in order with their requests."""
    class Kept(pkg.ALL[name]):
        def check(self, ctx):
            self.kept = ctx
            return super().check(ctx)

    scen = Kept()
    result = pkg.execute(scen, seed)
    replies = [(c.name,
                [(r.data, r.lower, r.upper, r.target) for r in c.requests],
                [(m.hash, m.nonce) for m in c.replies])
               for c in scen.kept.clients]
    return result, replies


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_schedule_gives_the_jax_replies_and_steps(name, jax_audits_off):
    for seed in range(10):
        ours, our_replies = _run(schedcheck, name, seed)
        theirs, their_replies = _run(jax_check, name, seed)
        assert not ours.failed, (seed, ours.violations)
        assert not theirs.failed, (seed, theirs.violations)
        assert our_replies == their_replies, seed
        assert any(reps for _n, _q, reps in our_replies), seed
        assert ours.steps == theirs.steps, seed
        assert ours.trace == theirs.trace, seed


# ----------------------------------------------------- the port catalogue

@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_scenario_holds_every_invariant(name):
    for seed in range(25):
        result = execute(ALL[name](), seed)
        assert not result.failed, (
            f"{name} seed {seed}: {result.violations} "
            f"(repro: {format_spec(result)})")


# ------------------------------------------------------ liveness detection

def test_deadlocked_scenario_reported_as_liveness_violation():
    class Deadlock(Scenario):
        name = "deadlock_fixture"

        def build(self, ctx: Ctx) -> None:
            async def waits_forever():
                await asyncio.Future()

            ctx.spawn(waits_forever(), client=True)

    result = execute(Deadlock(), 0)
    assert result.failed and result.status == "deadlock"
    assert any("liveness" in v for v in result.violations)


def test_spinning_scenario_reported_as_liveness_violation():
    class Spin(Scenario):
        name = "spin_fixture"

        def build(self, ctx: Ctx) -> None:
            async def ticks_forever():
                while True:
                    await asyncio.sleep(60.0)

            ctx.spawn(ticks_forever(), client=True)

    result = execute(Spin(), 0)
    assert result.failed and result.status == "vtime"
    assert any("liveness" in v for v in result.violations)


# -------------------------------------------------------- the card searcher

def test_card_searcher_on_the_plain_tier_passes_the_pipeline_scenarios():
    """``chip_smoke``'s card searcher over ``NonceSearcher(data,
    device="cpu")``: every Result held to the oracle by the scenarios'
    checks, each schedule the fake's, batched dispatch exercised."""
    import chip_smoke
    out = chip_smoke.run_card_scenarios("cpu", 3)
    assert out["violations"] == []
    assert out["schedules"] == 6 and out["same_as_fake"] == 6
    assert out["answers"] > 0 and out["batches"] > 0
