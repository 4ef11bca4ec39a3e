"""The port's load harness (``apps/loadharness.py``), its CLI
(``tools/loadharness.py``) and ``tools/dbmtrace.py summarize`` on
captures and rollups, against the JAX package's.

``_fake_hash`` and ``WORKLOADS`` equal the JAX ones; a storm of 40
tenants on two replicas completes and reports the JAX leg's keys; an
over-capacity leg sheds with completed plus shed conserved; two
adversarial workloads, scaled down, likewise. A capture written by
either package gives the same ``replay_plan`` under both packages'
``load_capture``; ``run_replay`` of the port's capture reports the JAX
leg's keys within fidelity. The sharded process-tier driver merges its
shards; the CLI's gate exits 1 on a violation and 0 otherwise. The
summary ``dbmtrace summarize`` prints of a capture and of a ``dbmtop
--once --json`` document is the JAX script's, line for line.
"""

import contextlib
import importlib.util
import io
import json
import os

import pytest

from distributed_bitcoinminer_tpu.apps import capture as ref_capture
from distributed_bitcoinminer_tpu.apps import loadharness as ref_lh
from distributed_bitcoinminer_tpu_torch.apps import capture
from distributed_bitcoinminer_tpu_torch.apps import loadharness as lh
from distributed_bitcoinminer_tpu_torch.tools import dbmtrace
from distributed_bitcoinminer_tpu_torch.tools import loadharness as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fake_hash_equals_the_jax_one():
    for data, lower in (("t0#0", 0), ("t17#3", 12345), ("", 1 << 40),
                        ("x" * 100, (1 << 64) - 1)):
        assert lh._fake_hash(data, lower) == ref_lh._fake_hash(data, lower)


def test_workloads_equal_the_jax_ones():
    assert lh.WORKLOADS == ref_lh.WORKLOADS


def _keys(leg: dict) -> set:
    return set(leg) | {f"trace.{k}" for k in ("sampled_traces",)
                       if k in leg.get("trace", {})}


def test_run_load_on_two_replicas_completes_with_the_jax_keys():
    port = lh.run_load(tenants=40, replicas=2, miners=4, timeout_s=60)
    ref = ref_lh.run_load(tenants=40, replicas=2, miners=4, timeout_s=60)
    assert port["completed"] == port["requests"] == 40
    assert port["shed_tenants"] == 0 and not port.get("timed_out")
    assert _keys(port) == _keys(ref)
    assert port["trace"]["sampled_traces"] == 40
    assert set(port["trace"]) == set(ref["trace"])


@pytest.mark.parametrize("replicas", [1, 2])
def test_an_over_capacity_leg_sheds_and_conserves(replicas):
    leg = lh.run_load(tenants=40, replicas=replicas, miners=2,
                      max_queued=8, requests_per_tenant=2, timeout_s=60)
    assert leg["shed_tenants"] > 0
    assert leg["completed"] + 2 * leg["shed_tenants"] == leg["requests"] \
        == 80
    assert leg["shed_rate"] == round(1 - leg["completed"] / 80, 4)


@pytest.mark.parametrize("workload, adapt", [("mice_stampede", True),
                                             ("tenant_churn", False)])
def test_adversarial_workloads_conserve_with_the_jax_keys(workload, adapt):
    kw = dict(adapt=adapt, tenants=120, duration_s=0.3, timeout_s=60)
    port = lh.run_adversarial(workload, **kw)
    ref = ref_lh.run_adversarial(workload, **kw)
    assert port["completed"] + port["shed_requests"] == port["requests"] \
        == 120
    assert not port.get("timed_out")
    assert set(port) == set(ref)
    if adapt:
        assert set(port["adapt_state"]) == set(ref["adapt_state"])


def _plan(cap):
    return json.dumps(cap.replay_plan(cap.load_capture(PATH[0])),
                      sort_keys=True)


PATH = [None]


@pytest.fixture(scope="module")
def port_capture(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cap") / "port.jsonl")
    lh.run_load(tenants=30, requests_per_tenant=2, capture_path=path,
                timeout_s=60)
    return path


def test_capture_plans_agree_across_packages(port_capture, tmp_path):
    ref_path = str(tmp_path / "ref.jsonl")
    ref_lh.run_load(tenants=30, requests_per_tenant=2,
                    capture_path=ref_path, timeout_s=60)
    for path in (port_capture, ref_path):
        PATH[0] = path
        assert _plan(capture) == _plan(ref_capture)
        plan = capture.replay_plan(capture.load_capture(path))
        assert len(plan) == 30 and sum(len(p["reqs"]) for p in plan) == 60


def test_run_replay_reports_the_jax_keys_within_fidelity(port_capture):
    port = lh.run_replay(port_capture, timeout_s=60)
    ref = ref_lh.run_replay(port_capture, timeout_s=60)
    assert port["requests"] == port["completed"] == 60
    assert port["fidelity"]["within"], port["fidelity"]
    assert set(port) == set(ref)
    assert set(port["fidelity"]) == set(ref["fidelity"])


def test_replay_speed_reads_like_the_jax_reader(monkeypatch):
    for value, want in ((None, 1.0), ("4", 4.0), ("0", 1.0), ("-2", 1.0),
                        ("x", 1.0), ("0.5", 0.5)):
        for name in ("DBMT_REPLAY_SPEED", "DBM_REPLAY_SPEED"):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        assert capture.replay_speed() == ref_capture.replay_speed() == want


def test_sharded_driver_merges_its_shards():
    assert lh._merge_shards([
        {"latencies": [0.1, 0.2], "sheds": [], "timed_out": False},
        {}, {"latencies": [0.3], "sheds": [1], "timed_out": True}]) == (
        [0.1, 0.2, 0.3], [1], True)
    leg = lh.run_load_procs(tenants=12, replicas=1, miners=1, drivers=2,
                            timeout_s=60)
    assert leg["drivers"] == 2 and leg["topology"] == "procs"
    assert leg["completed"] == leg["requests"] == 12
    assert leg["rollup"]["results_sent"] >= 12
    assert leg["rollup"]["fresh"] == 3


def test_the_cli_gate_exits_1_on_a_violation_and_0_otherwise(capsys):
    assert cli.main(["--tenants", "30", "--assert-p99", "60",
                     "--assert-series", "100000"]) == 0
    leg = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert leg["completed"] == 30 and "metric_series" in leg
    assert cli.main(["--tenants", "30", "--assert-p99", "1e-9"]) == 1
    assert "LOAD_GATE: p99" in capsys.readouterr().err
    assert cli.main(["--tenants", "30", "--assert-series", "1"]) == 1
    assert cli.main(["--workload", "tenant_churn", "--tenants", "40",
                     "--assert-complete", "0.0"]) == 0
    for argv in (["--replay", "x.jsonl", "--tenants", "5"],
                 ["--workload", "mice_stampede", "--replicas", "2"],
                 ["--assert-rollup"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv)
        assert exc.value.code == 2


def _ref_dbmtrace():
    spec = importlib.util.spec_from_file_location(
        "_ref_dbmtrace", os.path.join(REPO, "scripts", "dbmtrace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args) -> tuple:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(*args)
    return rc, out.getvalue(), err.getvalue()


def _rollup_doc(tmp_path) -> str:
    """A ``dbmtop --once --json`` document of a state directory whose
    blobs carry this process's scheduler counters and queue waits."""
    from distributed_bitcoinminer_tpu_torch.apps.rollup import \
        RollupPublisher
    from distributed_bitcoinminer_tpu_torch.tools import dbmtop
    from distributed_bitcoinminer_tpu_torch.utils.metrics import Registry
    statedir = str(tmp_path / "state")
    os.makedirs(statedir)
    for rid, (sent, shed) in enumerate(((7, 1), (5, 0))):
        reg = Registry()
        reg.counter("sched.results_sent").inc(sent)
        reg.counter("sched.qos_shed").inc(shed)
        reg.counter("sched.reissues").inc(rid)
        for v in (0.01, 0.2, 0.03 * (rid + 1)):
            reg.histogram("sched.queue_wait_s").observe(v)
        RollupPublisher(statedir, "replica", rid, f"inc{rid}",
                        registry=reg).publish()
    path = str(tmp_path / "rollup.json")
    with open(path, "w") as fh:
        json.dump(dbmtop.one_doc(statedir), fh)
    return path


def test_dbmtrace_summarize_matches_the_jax_script(port_capture, tmp_path):
    ref = _ref_dbmtrace()
    rollup = _rollup_doc(tmp_path)
    for paths in ([port_capture], [rollup], [port_capture, rollup]):
        got = _printed(dbmtrace.summarize, paths, 5)
        assert got == _printed(ref.summarize, paths, 5)
        assert got[0] == 0
    rc, out, _ = _printed(dbmtrace.summarize, [rollup], 5)
    assert "rollup: 1 rollup doc(s); last: 2/2 procs fresh; cluster " \
           "results_sent=12 shed=1 reissues=1" in out
    rc, out, _ = _printed(dbmtrace.summarize, [port_capture], 5)
    assert out.startswith("0 trace(s), ") \
        and "span(s), 60 replied request(s)" in out
    assert "slowest 5 request(s):" in out
