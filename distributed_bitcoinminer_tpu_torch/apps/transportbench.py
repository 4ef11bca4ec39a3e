"""The transport bench: the UDP datapath under an echo storm.

Counterpart of the JAX package's ``apps/transportbench.py``. It measures
the real datapath (``AsyncServer`` and ``AsyncClient`` over loopback,
the code production traffic takes): every client keeps a fixed number
of round trips in flight, the server echoes every payload, and a leg
reports application messages a second both ways and what the batched
syscalls (``DBMT_MMSG``) and the allocation-lean codec
(``DBMT_WIRE_FAST``) change:

- ``echo_storm.throughput``: messages a second both ways, fast datapath;
  ``echo_storm.speedup``: fast over stock (``DBMT_MMSG=0
  DBMT_WIRE_FAST=0``), medians over rounds in swapped order;
- ``syscalls_per_msg`` and ``bytes_per_msg``: the ``net.syscalls``,
  ``net.datagrams`` and ``net.bytes`` counters' deltas over the timed
  window;
- ``p99_ack_rtt_s``: send to ack, from the ``lsp.msg_rtt_s`` histogram
  (a bucket's upper bound);
- ``conn_memory``: resident bytes a live ``ConnCore`` pair at 10,000,
  50,000 and 100,000 conns (VmRSS deltas in a fresh process; no
  sockets).

Each leg runs in a process of its own (``python -m
distributed_bitcoinminer_tpu_torch.apps.transportbench child``), so the
knobs bind at import and endpoint creation as in production and the legs
share no allocator or loop. The child's geometry: ``DBMT_BENCH_TRANSPORT_
CONNS`` (32), ``_INFLIGHT`` (8), ``_PAYLOAD`` (128 bytes), ``_SECS`` (1.0
s timed), ``_WARMUP_S`` (0.3 s); ``DBMT_BENCH_TRANSPORT_ROUNDS`` (3) the
probe's rounds.
"""

from __future__ import annotations

import asyncio
import json
import os
import statistics
import subprocess
import sys
import time
from typing import List, Optional, Tuple

from ..lsp.params import Params
from ..utils._env import float_env, int_env

_DEF_CONNS = 32
_DEF_INFLIGHT = 8
_DEF_PAYLOAD = 128
_DEF_MEASURE_S = 1.0
_DEF_WARMUP_S = 0.3
_DEF_WINDOW = 64
_DEF_ROUNDS = 3

#: The checkout's root: the directory that holds the package.
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def bench_transport_from_env() -> dict:
    """The echo storm's geometry: ``DBMT_BENCH_TRANSPORT_CONNS``,
    ``_INFLIGHT``, ``_PAYLOAD`` (each at least 1), ``_SECS``,
    ``_WARMUP_S`` and ``_ROUNDS`` (at least 1)."""
    return {
        "conns": max(1, int_env("DBMT_BENCH_TRANSPORT_CONNS", _DEF_CONNS)),
        "inflight": max(1, int_env("DBMT_BENCH_TRANSPORT_INFLIGHT",
                                   _DEF_INFLIGHT)),
        "payload": max(1, int_env("DBMT_BENCH_TRANSPORT_PAYLOAD",
                                  _DEF_PAYLOAD)),
        "measure_s": float_env("DBMT_BENCH_TRANSPORT_SECS", _DEF_MEASURE_S),
        "warmup_s": float_env("DBMT_BENCH_TRANSPORT_WARMUP_S",
                              _DEF_WARMUP_S),
        "rounds": max(1, int_env("DBMT_BENCH_TRANSPORT_ROUNDS",
                                 _DEF_ROUNDS)),
    }


# --------------------------------------------------------------- child leg

def _counter(snap: dict, key: str) -> float:
    return float(snap.get("counters", {}).get(key, 0))


def _hist_p99(snap: dict, key: str) -> Optional[float]:
    """The p99 of a cumulative-``le`` histogram, as its bucket's upper
    bound."""
    h = snap.get("histograms", {}).get(key)
    if not h or not h.get("count"):
        return None
    want = 0.99 * h["count"]
    for bound, cum in zip(h["le"], h["counts"]):
        if cum >= want:
            return float(bound)
    return float("inf")


def _net_stats(snap: dict) -> dict:
    return {
        "sys_recv": _counter(snap, "net.syscalls{dir=recv}"),
        "sys_send": _counter(snap, "net.syscalls{dir=send}"),
        "dg_recv": _counter(snap, "net.datagrams{dir=recv}"),
        "dg_send": _counter(snap, "net.datagrams{dir=send}"),
        "bytes_recv": _counter(snap, "net.bytes{dir=recv}"),
        "bytes_send": _counter(snap, "net.bytes{dir=send}"),
    }


async def _echo_storm() -> dict:
    from ..lsp.client import new_async_client
    from ..lsp.errors import ConnectionClosed
    from ..lsp.server import new_async_server
    from ..utils.metrics import registry

    geo = bench_transport_from_env()
    payload = b"n" * geo["payload"]
    params = Params(window_size=_DEF_WINDOW)
    server = await new_async_server(0, params)

    async def echo() -> None:
        # One awaited read a burst, then drain: every payload turns round.
        try:
            item: Optional[Tuple[int, object]] = await server.read()
            while True:
                while item is not None:
                    cid, body = item
                    if isinstance(body, (bytes, bytearray)):
                        try:
                            server.write(cid, bytes(body))
                        except ConnectionClosed:
                            pass
                    item = server.read_nowait()
                item = await server.read()
        except (ConnectionClosed, asyncio.CancelledError):
            return

    loop = asyncio.get_running_loop()
    echo_task = loop.create_task(echo())
    clients = [await new_async_client(f"127.0.0.1:{server.port}", params)
               for _ in range(geo["conns"])]
    completed = [0]

    async def drive(client) -> None:
        try:
            for _ in range(geo["inflight"]):
                client.write(payload)
            while True:
                await client.read()
                completed[0] += 1
                client.write(payload)
        except (ConnectionClosed, asyncio.CancelledError):
            return

    tasks = [loop.create_task(drive(c)) for c in clients]
    await asyncio.sleep(geo["warmup_s"])
    snap0 = registry().snapshot()
    n0, t0 = completed[0], time.monotonic()
    await asyncio.sleep(geo["measure_s"])
    snap1 = registry().snapshot()
    n1, t1 = completed[0], time.monotonic()
    for task in tasks + [echo_task]:
        task.cancel()
    await asyncio.gather(*tasks, echo_task, return_exceptions=True)
    # Close every endpoint: no task outlives the leg.
    await asyncio.wait_for(asyncio.gather(
        *(c.close() for c in clients), return_exceptions=True), 10)
    await server.close()

    elapsed = max(t1 - t0, 1e-9)
    roundtrips = n1 - n0
    d0, d1 = _net_stats(snap0), _net_stats(snap1)
    delta = {k: d1[k] - d0[k] for k in d1}
    datagrams = delta["dg_recv"] + delta["dg_send"]
    syscalls = delta["sys_recv"] + delta["sys_send"]
    wire_bytes = delta["bytes_recv"] + delta["bytes_send"]
    return {
        # A round trip is one message each way.
        "throughput": round(2.0 * roundtrips / elapsed, 1),
        "roundtrips": roundtrips,
        "elapsed_s": round(elapsed, 4),
        "conns": geo["conns"],
        "inflight": geo["inflight"],
        "payload_bytes": len(payload),
        "syscalls_per_msg": (round(syscalls / datagrams, 4)
                             if datagrams else None),
        "bytes_per_msg": (round(wire_bytes / datagrams, 1)
                          if datagrams else None),
        "datagrams_per_s": round(datagrams / elapsed, 1),
        "p99_ack_rtt_s": _hist_p99(snap1, "lsp.msg_rtt_s"),
        "mmsg_active": int_env("DBMT_MMSG", 1) != 0,
        "wire_fast_active": int_env("DBMT_WIRE_FAST", 1) != 0,
    }


def echo_storm_child() -> dict:
    """One echo-storm leg in this process, with the environment's
    knobs."""
    return asyncio.run(_echo_storm())


# -------------------------------------------------------- conn-memory probe

def _vm_rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def conn_memory_probe(counts=(10_000, 50_000, 100_000),
                      window: int = 8) -> dict:
    """Resident bytes a live connection: bare ``ConnCore`` pairs (a
    server core and a client core a conn, as detnet and the load harness
    hold them), measured as VmRSS growth. No sockets, no loop."""
    import gc

    from ..lsp.core import ConnCore

    rss0 = _vm_rss_bytes()
    if rss0 is None:
        return {"error": "VmRSS unavailable"}
    params = Params(window_size=window)
    cores: List[ConnCore] = []
    out = {}
    for target in sorted(counts):
        while len(cores) < 2 * target:
            cid = len(cores) // 2 + 1
            cores.append(ConnCore(params, cid))
            cores.append(ConnCore(params, cid, connect=True))
        gc.collect()
        rss = _vm_rss_bytes()
        if rss is None:
            break
        out[f"rss_per_conn_at_{target}"] = round((rss - rss0) / target, 1)
    out["window"] = window
    return out


# ------------------------------------------------------------ orchestration

_FAST_ENV = {"DBMT_MMSG": "1", "DBMT_WIRE_FAST": "1"}
_STOCK_ENV = {"DBMT_MMSG": "0", "DBMT_WIRE_FAST": "0"}


def _run_child(repo_root: str, overrides: dict,
               timeout_s: float = 60.0, args=("child",)) -> dict:
    env = dict(os.environ)
    env.update(overrides)
    # A pure transport measurement: no metrics emitter in the window.
    env.setdefault("DBMT_METRICS_INTERVAL_S", "0")
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", f"{__package__}.transportbench", *args],
        capture_output=True, text=True, timeout=timeout_s, env=env,
        cwd=repo_root, check=False)
    for line in reversed(proc.stdout.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(
        f"transport child produced no JSON (rc={proc.returncode}): "
        f"{proc.stderr.strip()[-300:]}")


def transport_probe(repo_root: str = REPO_ROOT,
                    conn_counts=(10_000, 50_000, 100_000)) -> dict:
    """Echo-storm legs, fast and stock in turns (``DBMT_BENCH_TRANSPORT_
    ROUNDS`` rounds, the order swapped each round), their medians, and
    :func:`conn_memory_probe` at ``conn_counts``, in a fresh process of
    its own (the JAX probe runs it in the caller's, whose freed memory
    would hide the conns' growth)."""
    from ..lsp import _mmsg

    rounds = bench_transport_from_env()["rounds"]
    fast_legs: List[dict] = []
    stock_legs: List[dict] = []
    for i in range(rounds):
        order = [(_FAST_ENV, fast_legs), (_STOCK_ENV, stock_legs)]
        if i % 2:
            order.reverse()
        for overrides, legs in order:
            legs.append(_run_child(repo_root, overrides))

    def med(legs: List[dict], key: str) -> Optional[float]:
        vals = [leg[key] for leg in legs if leg.get(key) is not None]
        return round(statistics.median(vals), 4) if vals else None

    def side(legs: List[dict]) -> dict:
        return {k: med(legs, k) for k in ("syscalls_per_msg",
                                          "bytes_per_msg",
                                          "p99_ack_rtt_s")}

    fast_tp = med(fast_legs, "throughput") or 0.0
    stock_tp = med(stock_legs, "throughput") or 0.0
    return {
        "schema": "transport_datapath_v1",
        "mmsg_available": _mmsg.available(),
        "rounds": rounds,
        "echo_storm": {
            "throughput": fast_tp,
            "stock_msgs_per_s": stock_tp,
            "speedup": (round(fast_tp / stock_tp, 3) if stock_tp else None),
        },
        "fast": side(fast_legs),
        "stock": side(stock_legs),
        "conn_memory": _run_child(
            repo_root, {}, args=("memory", *map(str, conn_counts))),
        "samples": {"fast": fast_legs, "stock": stock_legs},
    }


def standalone_artifact(repo_root: str = REPO_ROOT) -> dict:
    """The probe as one headline document: the fast datapath's
    messages/s, the probe under ``detail.transport``."""
    probe = transport_probe(repo_root)
    return {
        "metric": "transport_datapath",
        "value": probe["echo_storm"]["throughput"],
        "unit": "msgs/sec",
        "detail": {"transport": probe},
    }


def main(argv=None) -> int:
    """``transportbench child``: one leg, one JSON line; ``transportbench
    memory [COUNT ...]``: :func:`conn_memory_probe`, one JSON line;
    ``transportbench probe``: the whole probe as one JSON line."""
    argv = sys.argv[1:] if argv is None else argv
    if argv == ["child"]:
        print(json.dumps(echo_storm_child()), flush=True)
        return 0
    if argv[:1] == ["memory"]:
        counts = tuple(int(a) for a in argv[1:]) or (10_000, 50_000,
                                                     100_000)
        print(json.dumps(conn_memory_probe(counts)), flush=True)
        return 0
    if argv == ["probe"]:
        print(json.dumps(standalone_artifact()), flush=True)
        return 0
    print("usage: transportbench child | memory [COUNT ...] | probe",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
