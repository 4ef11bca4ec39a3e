"""The port's LSP runners (``runners/``) and transport bench
(``apps/transportbench.py``), against the JAX package's.

``normalize_go_flags`` and ``build_parser`` read the Go ``flag`` forms as
the JAX runners do; ``srunner`` and ``crunner`` echo a payload over
localhost as subprocesses (and the ``--qos-weight`` line names
``DBMT_QOS_WEIGHTS``); against the reference's Go ``srunner`` the echo
skips visibly without a ``go`` toolchain, as ``tests/test_go_interop.py``
does. One echo-storm leg at 0.5 s and the conn-memory probe at 1,000
conns report the JAX probe's keys; ``_net_stats`` and ``_hist_p99`` read
one snapshot as the JAX ones do.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import pytest

from distributed_bitcoinminer_tpu.apps import transportbench as ref_tb
from distributed_bitcoinminer_tpu.runners import srunner as ref_srunner
from distributed_bitcoinminer_tpu_torch.apps import transportbench as tb
from distributed_bitcoinminer_tpu_torch.runners import srunner
from tests.test_go_interop import REF_SRC

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GO = shutil.which("go")

GO_FORMS = (
    [],
    ["-port=9999"],
    ["-port", "7777", "-v"],
    ["--port", "1234", "-rdrop=5", "-wdrop", "7"],
    ["-elim=10", "-ems=200", "-wsize=4", "-maxbackoff=3"],
    ["-metrics=0.5", "--", "-port=1"],
    ["-port=-1"],
)


@pytest.mark.parametrize("argv", GO_FORMS)
@pytest.mark.parametrize("role", ["srunner", "crunner"])
def test_go_flag_forms_parse_like_the_jax_runners(role, argv):
    port_p, ref_p = srunner.build_parser(role), ref_srunner.build_parser(role)
    norm = srunner.normalize_go_flags(argv, port_p)
    assert norm == ref_srunner.normalize_go_flags(argv, ref_p)
    if "--" in argv:
        return
    assert vars(port_p.parse_args(norm)) == vars(ref_p.parse_args(norm))
    args = port_p.parse_args(norm)
    ref_params = ref_srunner.params_from_args(ref_p.parse_args(norm))
    assert srunner.params_from_args(args).__dict__ == ref_params.__dict__


def test_unknown_go_flags_pass_through_to_argparse_errors():
    p = srunner.build_parser("srunner")
    assert srunner.normalize_go_flags(["-nosuch=1"], p) == ["-nosuch=1"]
    with pytest.raises(SystemExit):
        p.parse_args(srunner.normalize_go_flags(["-nosuch=1"], p))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=REPO + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def _start_srunner(port: int):
    proc = subprocess.Popen(
        [sys.executable, "-m", "distributed_bitcoinminer_tpu_torch.runners."
         "srunner", f"-port={port}", "-ems", "200"], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    assert proc.stdout.readline().strip() == \
        f"Starting server on port {port}..."
    assert proc.stdout.readline().strip() == "Server waiting for clients..."
    return proc


def test_srunner_and_crunner_echo_over_localhost():
    port = _free_port()
    server = _start_srunner(port)
    try:
        out = subprocess.run(
            [sys.executable, "-m",
             "distributed_bitcoinminer_tpu_torch.runners.crunner",
             f"-port={port}", "--ems", "200", "--qos-weight", "2.5"],
            input="hello world\nfoo\n", capture_output=True, text=True,
            cwd=REPO, env=_env(), timeout=60)
    finally:
        server.terminate()
        server.wait(timeout=10)
    lines = out.stdout.splitlines()
    assert out.returncode == 0, out.stderr
    assert lines[0] == f"Connecting to server at '127.0.0.1:{port}'..."
    assert lines[1] == "Connected as tenant 1"
    assert lines[2] == ("QoS weight 2.5: export DBMT_QOS_WEIGHTS=1:2.5 on "
                        "the scheduler")
    echoed = [ln.split("Server: ", 1)[1] for ln in lines
              if "Server: " in ln]
    assert echoed == ["hello", "world", "foo"]
    assert lines[-1].endswith("Exiting...")


@pytest.mark.skipif(GO is None or not os.path.isdir(REF_SRC),
                    reason="no `go` toolchain on PATH: the reference's Go "
                           "srunner cannot be built (installing Go makes "
                           "this case live)")
def test_reference_go_srunner_echoes_the_port_crunner(tmp_path):
    gopath = tmp_path / "gopath"
    dst = gopath / "src" / "github.com" / "cmu440"
    shutil.copytree(REF_SRC, dst,
                    ignore=shutil.ignore_patterns("*.tar", "bin"))
    env = {**os.environ, "GOPATH": str(gopath), "GO111MODULE": "off"}
    exe = gopath / "srunner"
    subprocess.run([GO, "build", "-o", str(exe),
                    "github.com/cmu440/srunner"], env=env, cwd=str(gopath),
                   check=True, timeout=300)
    port = _free_port()
    server = subprocess.Popen([str(exe), f"-port={port}"],
                              stdout=subprocess.DEVNULL,
                              stderr=subprocess.DEVNULL)
    try:
        time.sleep(0.5)
        out = subprocess.run(
            [sys.executable, "-m",
             "distributed_bitcoinminer_tpu_torch.runners.crunner",
             f"-port={port}"], input="interop\n", capture_output=True,
            text=True, cwd=REPO, env=_env(), timeout=60)
    finally:
        server.kill()
        server.wait()
    assert "Server: interop" in out.stdout


SNAPSHOT = {
    "counters": {"net.syscalls{dir=recv}": 10, "net.syscalls{dir=send}": 7,
                 "net.datagrams{dir=recv}": 120,
                 "net.datagrams{dir=send}": 118,
                 "net.bytes{dir=recv}": 19000, "net.bytes{dir=send}": 18800},
    "histograms": {"lsp.msg_rtt_s": {
        "count": 200, "le": [0.001, 0.0025, 0.005, 0.01, 0.025],
        "counts": [50, 120, 190, 198, 200], "sum": 0.9},
        "empty": {"count": 0, "le": [1.0], "counts": [0]},
        "over": {"count": 10, "le": [1.0], "counts": [5]}},
}


def test_net_stats_and_hist_p99_read_a_snapshot_like_the_jax_ones():
    assert tb._net_stats(SNAPSHOT) == ref_tb._net_stats(SNAPSHOT)
    assert tb._net_stats({}) == ref_tb._net_stats({})
    for key in ("lsp.msg_rtt_s", "empty", "over", "missing"):
        assert tb._hist_p99(SNAPSHOT, key) == ref_tb._hist_p99(SNAPSHOT,
                                                               key)
    assert tb._hist_p99(SNAPSHOT, "lsp.msg_rtt_s") == 0.01


def test_an_echo_storm_leg_reports_the_jax_keys(monkeypatch):
    """The port's leg in this process (it closes its endpoints) and as
    its child CLI; the JAX leg as ``bench.py --transport-child``."""
    for pre in ("DBMT", "DBM"):
        monkeypatch.setenv(f"{pre}_BENCH_TRANSPORT_SECS", "0.5")
        monkeypatch.setenv(f"{pre}_BENCH_TRANSPORT_WARMUP_S", "0.1")
        monkeypatch.setenv(f"{pre}_BENCH_TRANSPORT_CONNS", "4")
    port = tb.echo_storm_child()
    child = tb._run_child(REPO, {"DBMT_MMSG": "0", "DBMT_WIRE_FAST": "0"})
    out = subprocess.run([sys.executable, "bench.py", "--transport-child"],
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(_env(), JAX_PLATFORMS="cpu"), timeout=60)
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(port) == set(child) == set(ref)
    assert port["throughput"] > 0 and port["conns"] == 4
    assert port["mmsg_active"] and not child["mmsg_active"]
    assert child["syscalls_per_msg"] == 1.0


def test_conn_memory_probe_reports_the_jax_keys():
    port = tb.conn_memory_probe((1_000,))
    assert set(port) == set(ref_tb.conn_memory_probe((1_000,)))
    assert port["window"] == 8 and "rss_per_conn_at_1000" in port
    child = tb._run_child(REPO, {}, args=("memory", "1000"))
    assert set(child) == set(port) and child["rss_per_conn_at_1000"] > 0


def test_bench_readers_default_and_clamp_like_the_jax_child(monkeypatch):
    for name in ("CONNS", "INFLIGHT", "PAYLOAD", "SECS", "WARMUP_S",
                 "ROUNDS"):
        monkeypatch.delenv(f"DBMT_BENCH_TRANSPORT_{name}", raising=False)
    assert tb.bench_transport_from_env() == {
        "conns": ref_tb._DEF_CONNS, "inflight": ref_tb._DEF_INFLIGHT,
        "payload": ref_tb._DEF_PAYLOAD, "measure_s": ref_tb._DEF_MEASURE_S,
        "warmup_s": ref_tb._DEF_WARMUP_S, "rounds": 3}
    monkeypatch.setenv("DBMT_BENCH_TRANSPORT_CONNS", "0")
    monkeypatch.setenv("DBMT_BENCH_TRANSPORT_ROUNDS", "-1")
    geo = tb.bench_transport_from_env()
    assert geo["conns"] == 1 and geo["rounds"] == 1
