"""Pods: several processes join the scheduler as ONE miner (the port's
``parallel/multihost.py`` over ``torch.distributed``).

The control frame against the JAX package's ``broadcast_job`` word for
word (its ``_broadcast_frame`` captured in this process); the row
exchange's backend from the ranks' device identities; a 2-rank ``gloo``
pod, each rank a CPU mesh of 2 shards, against the JAX
``MeshNonceSearcher`` over 4 of the conftest's virtual CPU devices and
the ``bitcoin.hash`` oracle (arg-min, a hit in rank 1's windows only,
no hit), on a range that crosses a 10^9 block boundary; then the CLI
shape of ``tests/test_multihost.py``: the port's server, a 2-rank pod
miner and the port's client (one JOIN, an arg-min and a difficulty
answer equal to the oracle, both ranks exiting 0 once the server dies),
and the follower-death drill (the owner exits 17 at once, a ``--device
cpu`` miner that joins afterwards serves the chunk exactly). Every
spawned process runs with a timeout.
"""

import json
import os
import socket
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from distributed_bitcoinminer_tpu.bitcoin.hash import scan_min, scan_until
from distributed_bitcoinminer_tpu.models import \
    MeshNonceSearcher as RefMeshSearcher
from distributed_bitcoinminer_tpu.parallel import make_mesh as ref_make_mesh
from distributed_bitcoinminer_tpu.parallel import multihost as ref_multihost
from distributed_bitcoinminer_tpu_torch.parallel import multihost
from distributed_bitcoinminer_tpu_torch.parallel.partition import \
    device_windows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
APPS = "distributed_bitcoinminer_tpu_torch.apps"
#: About 20,000 nonces across the 10^9 block boundary at 2 * 10^9.
RANGE = (2 * 10 ** 9 - 10_000, 2 * 10 ** 9 + 10_000)
#: Fast LSP epochs, so a dead connection is noticed in 4 s.
LSP_ENV = {"DBMT_EPOCH_MILLIS": "200", "DBMT_EPOCH_LIMIT": "20",
           "DBMT_WINDOW": "5"}

_RANK = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from distributed_bitcoinminer_tpu_torch.models import MeshNonceSearcher
from distributed_bitcoinminer_tpu_torch.parallel import multihost
from distributed_bitcoinminer_tpu_torch.utils.config import PodParams
pod = multihost.initialize_multihost(
    ["cpu", "cpu"], PodParams(sys.argv[2], 2, int(sys.argv[3])))
out = []
for data, lower, upper, target in json.loads(sys.argv[4]):
    s = MeshNonceSearcher(data, devices=["cpu", "cpu"], pod=pod)
    out.append(list(s.search_until(lower, upper, target)) if target
               else list(s.search(lower, upper)))
print(json.dumps({"out": out, "gathers": pod.gathers,
                  "backend": pod.backend, "scope": s.hit_scope}))
multihost.shutdown()
"""


def _free(kind) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=REPO, **LSP_ENV, **extra)
    return env


# ------------------------------------------------------- control frame


def _jax_frame(monkeypatch, call) -> list:
    sent = []
    monkeypatch.setattr(ref_multihost, "_broadcast_frame",
                        lambda frame: sent.append(frame.copy()) or frame)
    call()
    return [int(w) for w in sent[0]]


def _port_frame(monkeypatch, call) -> list:
    sent = []
    monkeypatch.setattr(multihost, "_broadcast_frame",
                        lambda frame: sent.append(frame.clone()) or frame)
    call()
    return sent[0].tolist()


@pytest.mark.parametrize("job", [
    ("argmin", "cmu440", 123, (1 << 40) + 7, 0),
    ("until", "a sixty-character message whose nonce digits cross a "
              "block..", (1 << 63) + 5, (1 << 64) - 1, (1 << 64) // 10 ** 8),
    ("stop",)])
def test_control_frame_equals_jax(monkeypatch, job):
    if job[0] == "stop":
        want = _jax_frame(monkeypatch, ref_multihost.broadcast_stop)
        got = _port_frame(monkeypatch, multihost.broadcast_stop)
    else:
        args = job[1:] if job[0] == "until" else job[1:4]
        want = _jax_frame(monkeypatch,
                          lambda: ref_multihost.broadcast_job(*args))
        got = _port_frame(monkeypatch, lambda: multihost.broadcast_job(*args))
    assert len(got) == len(want) == 1000
    assert got == want
    frame = torch.tensor(got, dtype=torch.int64)
    monkeypatch.setattr(multihost, "_broadcast_frame", lambda _f: frame)
    if job[0] == "stop":
        assert multihost._receive_job() is None
    else:
        want_job = tuple(job[1:]) if job[0] == "until" else (*job[1:4], 0)
        assert multihost._receive_job() == want_job


def test_frame_refuses_a_long_message():
    with pytest.raises(ValueError, match="too long"):
        multihost.job_frame(multihost.OP_ARGMIN, "x" * 993)


@pytest.mark.parametrize("uuids,backend", [
    ([["GPU-a"], ["GPU-a"]], "gloo"),                   # one card, 2 ranks
    ([["GPU-a", "GPU-b"], ["GPU-b", "GPU-c"]], "gloo"),  # one card shared
    ([["cpu", "cpu"], ["cpu", "cpu"]], "gloo"),          # CPU meshes
    ([["GPU-a"], ["GPU-b"]], "nccl"),
    ([["GPU-a", "GPU-a"], ["GPU-b", "GPU-b"]], "nccl"),  # repeats in a rank
    ([["GPU-a", "GPU-b"], ["GPU-c", "GPU-d"]], "nccl")])
def test_row_backend_from_the_layout(uuids, backend):
    assert multihost.row_backend(uuids)[0] == backend


class _Exited(Exception):
    pass


def test_bounded_pod_call_exits_on_a_peer_death_or_a_hang(monkeypatch):
    """A collective that fails because a peer died ends the process at
    once, a hung one at the bound (``_exit_pod``: exit code 17, which the
    drill below sees); any other error is raised."""
    def exit_pod(why):
        raise _Exited(why)
    monkeypatch.setattr(multihost, "_exit_pod", exit_pod)

    def peer_died():
        raise multihost.PodPeerError("connection closed by peer")
    t0 = time.monotonic()
    with pytest.raises(_Exited, match="a pod collective failed"):
        multihost.bounded_pod_call(peer_died, timeout_s=30)
    assert time.monotonic() - t0 < 5
    with pytest.raises(_Exited, match="outlived its bound of 0 s"):
        multihost.bounded_pod_call(lambda: time.sleep(2), timeout_s=0.2)
    with pytest.raises(ValueError, match="deterministic"):
        multihost.bounded_pod_call(
            lambda: (_ for _ in ()).throw(ValueError("deterministic")),
            timeout_s=10)
    assert multihost.bounded_pod_call(lambda: 41 + 1, timeout_s=10) == 42
    assert multihost.POD_EXIT == 17


def test_follower_resets_its_counters_and_stops(monkeypatch):
    """The follower runs each framed job on its cached searcher, restarts
    its launch counters and row gathers on the reset frame (sent after
    the rate probe, which it ran too), and returns on the stop frame."""
    from distributed_bitcoinminer_tpu_torch.ops import sha256_cuda
    from distributed_bitcoinminer_tpu_torch.utils.config import PodParams
    pod = multihost.Pod(PodParams("x:1", 1, 0), (torch.device("cpu"),),
                        "gloo")
    def gather(rows):
        pod.gathers += 1
        return rows
    monkeypatch.setattr(pod, "gather", gather)
    monkeypatch.setattr(multihost, "_pod", pod)
    frames = [multihost.job_frame(multihost.OP_ARGMIN, "probe", 0, 999),
              multihost.job_frame(multihost.OP_RESET),
              multihost.job_frame(multihost.OP_ARGMIN, "probe", 0, 999),
              multihost.job_frame(multihost.OP_UNTIL, "probe", 0, 999,
                                  1 << 60),
              multihost.job_frame(multihost.OP_STOP)]
    seen = []

    def receive(_frame):
        seen.append((sha256_cuda.total_launches(), pod.gathers))
        return frames.pop(0)
    monkeypatch.setattr(multihost, "_broadcast_frame", receive)
    sha256_cuda.launches["K1"] += 5          # as if the probe launched
    assert multihost.run_follower() == 3
    # [0, 999] is three blocks: a gather each (the CPU until chain skips
    # the blocks after its hit).
    gathers = [g for _, g in seen]
    assert gathers[:4] == [0, 3, 0, 3] and 3 < gathers[4] <= 6
    assert seen[1][0] == 5 and seen[2][0] == 0   # the reset
    assert multihost.is_lsp_owner()


# ------------------------------------------- a 2-rank pod against JAX


def _rank1_data() -> str:
    """A message whose arg-min over RANGE lies in rank 1's windows (the
    upper two of the four shards of its block), so that the target just
    above it is met in rank 1's windows only."""
    for i in range(64):
        data = f"pod{i}"
        _, nonce = scan_min(data, *RANGE)
        base = nonce // 10 ** 9 * 10 ** 9
        lo = max(RANGE[0], base) - base
        hi = min(RANGE[1], base + 10 ** 9 - 1) - base
        _, lo_d, hi_d, _ = device_windows(lo, hi, 4, 1)
        if int(lo_d[2]) <= nonce - base <= int(hi_d[3]):
            return data
    raise AssertionError("no message with its arg-min in rank 1")


def test_pod_of_two_cpu_meshes_equals_jax_mesh_and_oracle():
    data = _rank1_data()
    h_min, n_min = scan_min(data, *RANGE)
    hit_target = h_min + 1
    jobs = [(data, *RANGE, 0), (data, *RANGE, hit_target),
            (data, *RANGE, 1)]
    coord = f"127.0.0.1:{_free(socket.SOCK_STREAM)}"
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _RANK, REPO, coord, str(r), json.dumps(jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env()) for r in (0, 1)]
    try:
        # The JAX mesh over 4 virtual CPU devices, while the ranks run.
        ref = RefMeshSearcher(data, batch=256, mesh=ref_make_mesh(4),
                              tier="jnp", hoist=False)
        want_argmin = ref.search(*RANGE)
        with mock.patch.dict(os.environ, {"DBM_DEVLOOP_UNTIL": "1"}):
            want_hit = ref.search_until(*RANGE, hit_target)
            want_miss = ref.search_until(*RANGE, 1)
        outs = [p.communicate(timeout=120) for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for p, (out, err) in zip(ranks, outs):
        assert p.returncode == 0, err[-2000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    assert want_argmin == (h_min, n_min)
    assert want_hit == scan_until(data, *RANGE, hit_target) \
        == (h_min, n_min, True)
    assert want_miss == (h_min, n_min, False)
    for rank in got:
        assert rank["out"] == [list(want_argmin), list(want_hit),
                               list(want_miss)]
        # One gather a block: two blocks a job.
        assert rank["gathers"] == 2 * len(jobs)
        assert rank["backend"] == "gloo" and rank["scope"] == "rank"


# ----------------------------------------------------- the CLI shapes


def _spawn(args, env, log):
    return subprocess.Popen([sys.executable, "-m", *args], env=env,
                            stdout=open(log, "w"), stderr=subprocess.STDOUT,
                            cwd=os.path.dirname(log))


def _client(hostport, *args, timeout=90):
    out = subprocess.run([sys.executable, "-m", f"{APPS}.client", hostport,
                          *map(str, args)], env=_env(), capture_output=True,
                         text=True, timeout=timeout)
    return out.stdout.strip()


def _pod(tmp_path, hostport, **extra):
    coord = f"127.0.0.1:{_free(socket.SOCK_STREAM)}"
    env = _env(DBMT_COORDINATOR=coord, DBMT_NUM_PROCS="2",
               DBMT_MESH_DEVICES="cpu,cpu", **extra)
    return [_spawn([f"{APPS}.miner", hostport, "--device", "cpu"],
                   {**env, "DBMT_PROC_ID": str(r)},
                   str(tmp_path / f"rank{r}.log")) for r in (0, 1)]


def _read(path) -> str:
    with open(path, errors="replace") as f:
        return f.read()


def test_pod_joins_as_one_miner_and_matches_oracle(tmp_path):
    lsp = _free(socket.SOCK_DGRAM)
    hostport = f"127.0.0.1:{lsp}"
    server = _spawn([f"{APPS}.server", str(lsp)], _env(),
                    str(tmp_path / "server.out"))
    procs = [server]
    try:
        procs += _pod(tmp_path, hostport)
        owner, follower = procs[1:]
        assert _client(hostport, "podjob", 20000) == \
            "Result %d %d" % scan_min("podjob", 0, 20001), \
            _read(tmp_path / "rank0.log")[-2000:]
        target = 1 << 58
        want = scan_until("podjob", 0, 20001, target)
        assert want[2]
        assert _client(hostport, "podjob", 20000, target) == \
            f"Result {want[0]} {want[1]}"
        assert _read(tmp_path / "log.txt").count(" joined") == 1
        assert "rows over gloo (a CPU mesh)" in _read(tmp_path / "rank1.log")
        server.kill()
        server.wait(timeout=10)
        assert owner.wait(timeout=60) == 0, \
            _read(tmp_path / "rank0.log")[-2000:]
        assert follower.wait(timeout=30) == 0, \
            _read(tmp_path / "rank1.log")[-2000:]
        assert "follower done after 2 jobs" in _read(tmp_path / "rank1.log")
    finally:
        for p in procs:
            p.kill()
            p.wait()


def test_follower_death_mid_job_bounded_and_chunk_reexecutes(tmp_path):
    lsp = _free(socket.SOCK_DGRAM)
    hostport = f"127.0.0.1:{lsp}"
    server = _spawn([f"{APPS}.server", str(lsp)], _env(),
                    str(tmp_path / "server.out"))
    procs = [server]
    try:
        procs += _pod(tmp_path, hostport, DBMT_POD_TIMEOUT_S="20")
        owner, follower = procs[1:]
        # The request first: the pod, the only miner, takes all of it.
        client = subprocess.Popen(
            [sys.executable, "-m", f"{APPS}.client", hostport, "drill",
             "299999"], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        procs.append(client)
        deadline = time.monotonic() + 60
        while "follower job 1" not in _read(tmp_path / "rank1.log"):
            assert time.monotonic() < deadline and follower.poll() is None
            time.sleep(0.02)
        follower.kill()
        follower.wait()
        t_kill = time.monotonic()
        rc = owner.wait(timeout=20)
        assert rc == 17, _read(tmp_path / "rank0.log")[-2000:]
        assert time.monotonic() - t_kill < 20
        procs.append(_spawn([f"{APPS}.miner", hostport, "--device", "cpu"],
                            _env(), str(tmp_path / "spare.log")))
        out, err = client.communicate(timeout=90)
        assert out.strip() == "Result %d %d" % scan_min("drill", 0, 300000), \
            (out, err[-1000:])
        assert "a pod collective failed" in _read(tmp_path / "rank0.log")
        assert " served 'drill' [0, 300000]" in _read(tmp_path / "spare.log")
    finally:
        for p in procs:
            p.kill()
            p.wait()
