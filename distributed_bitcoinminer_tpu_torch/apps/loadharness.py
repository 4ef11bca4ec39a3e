"""The control plane's load harness: storms of thousands of tenants.

Counterpart of the JAX package's ``apps/loadharness.py``. The kernels are
measured by ``chip_smoke.py``; this harness measures what one scheduler
process costs a request as the tenants grow, with the compute taken out:

- The transport is :mod:`~..lspnet.detnet` without its logs
  (``DetServer(record=False)``): a message is a queue put, so 10,000
  conns cost 10,000 times one message, not sockets or epochs.
- The miners are INSTANT actors: each Request is answered at once with a
  cheap deterministic fake hash (:func:`_fake_hash`; verification is off
  in every leg so the claim check does not reject it), with an honest
  span of the actor's own seconds, so the trace medians stay filled.
- Each tenant is one ``DetChannel``: it writes its requests at the
  storm's start and reads until answered or shed (a shed closes its
  conn, which the tenant sees as the conn's death, as
  ``submit_with_retry`` would).

A leg reports completed and shed counts, the makespan, admitted/s
(completed over the makespan), the replies' p50/p99, CPU seconds a
completed request (``time.process_time`` over the leg) and the
scheduler's trace summary. Every leg pins the adapt plane, the result
cache and verification off; :func:`run_adversarial` runs the static and
the adaptive controllers in turns.

A leg of N replicas runs a :class:`~.replicas.ReplicaSet` with the queue's
capacity split among them (``max_queued / N`` each), so 1 and N replicas
shed alike and the difference is the sharding's.

:func:`run_replay` re-sends a capture (``apps.capture``) over detnet with
miners modelled from its pool snapshots; :func:`run_replay_procs` and
:func:`run_load_procs` drive the process tier (``apps.procs``) over real
localhost UDP with instant agents (``fake_miners``). The CLI is
``tools/loadharness.py``; ``python -m
distributed_bitcoinminer_tpu_torch.apps.loadharness driver ...`` is one
shard of a sharded process-tier storm (:func:`driver_main`).
"""

from __future__ import annotations

import asyncio
import logging
import time
from statistics import median
from typing import Optional

from ..bitcoin.message import Message, MsgType, new_join, new_request, \
    new_result
from ..lsp.errors import LspError
from ..lspnet.detnet import DetServer
from ..utils.config import AdaptParams, CacheParams, LeaseParams, \
    QosParams, VerifyParams
from ..utils.trace import SPAN_PHASES

__all__ = ["run_load", "load_curve", "run_adversarial",
           "adversarial_ab", "WORKLOADS", "run_replay",
           "run_replay_procs", "run_load_procs", "drive_ring_tenants"]

#: A 64-bit odd multiplier (splitmix64's finalizer constant): the fake
#: answer must be a deterministic function of the chunk, so a re-issued
#: chunk merges idempotently, and cheap (no SHA-256).
_MIX = 0xBF58476D1CE4E5B9
_MASK = (1 << 64) - 1

#: The logger tree whose shed warnings the shedding legs mute.
_LOG = logging.getLogger("dbmt")


def _fake_hash(data: str, lower: int) -> int:
    return (hash(data) * _MIX + lower * 0x9E3779B97F4A7C15) & _MASK


def _pct(latencies: list, q: float):
    """The q-quantile of sorted ``latencies`` (None when empty)."""
    if not latencies:
        return None
    return round(latencies[min(len(latencies) - 1,
                               int(q * len(latencies)))], 4)


def _rates(latencies: list, makespan: float) -> dict:
    """A leg's completed count, makespan, admitted/s, p50 and p99
    (``latencies`` sorted)."""
    completed = len(latencies)
    return {"completed": completed,
            "makespan_s": round(makespan, 3),
            "admitted_per_s": round(completed / makespan, 1)
            if makespan > 0 else None,
            "p50_s": _pct(latencies, 0.50),
            "p99_s": _pct(latencies, 0.99)}


def _cpu_per_request(cpu_s: float, completed: int):
    return round(cpu_s / completed, 6) if completed else None


async def _fake_miner(chan, trace_spans: bool,
                      rate: float = 0.0) -> None:
    """An instant miner: JOIN, then answer every Request with the fake
    hash, with a measured span when ``trace_spans``. ``rate > 0`` makes
    it rate-limited (``size / rate`` seconds of "compute" a chunk, one at
    a time), so a workload runs against a known service capacity."""
    chan.write(new_join().to_json())
    while True:
        try:
            payload = await chan.read()
        except LspError:
            return
        arrived = time.monotonic()
        msg = Message.from_json(payload)
        if msg.type != MsgType.REQUEST:
            continue
        if rate > 0:
            await asyncio.sleep((msg.upper - msg.lower + 1) / rate)
        h = _fake_hash(msg.data, msg.lower)
        span = None
        if trace_spans:
            done = time.monotonic()
            span = {"queue_s": 0.0, "dispatch_s": 0.0, "wait_s": 0.0,
                    "force_s": round(done - arrived, 9), "gap_s": 0.0}
        try:
            chan.write(new_result(h, msg.lower, msg.target,
                                  span=span).to_json())
        except LspError:
            return


async def _tenant(chan, data: str, count: int, nonces: int,
                  latencies: list, sheds: list) -> None:
    """One tenant: ``count`` distinct requests written at the storm's
    start, then its replies read; a dead conn is a shed."""
    stamps = []
    try:
        for i in range(count):
            stamps.append(time.monotonic())
            chan.write(new_request(f"{data}#{i}", 0, nonces - 1).to_json())
        got = 0
        while got < count:
            payload = await chan.read()
            msg = Message.from_json(payload)
            if msg.type == MsgType.RESULT:
                latencies.append(time.monotonic() - stamps[got])
                got += 1
    except LspError:
        sheds.append(len(stamps))


async def _start_miners(server, rates) -> list:
    """One fake miner a rate (0: instant) on ``server``, their JOINs
    landed before the storm."""
    tasks = [asyncio.create_task(_fake_miner(server.connect(),
                                             trace_spans=True, rate=r))
             for r in rates]
    for _ in range(4):
        await asyncio.sleep(0)
    return tasks


async def _run_storm(make_tenants, others: list, timeout_s: float):
    """Start the tenants (``make_tenants()``, a list of tasks) and wait at
    most ``timeout_s`` for them; then cancel them and ``others``. Returns
    the makespan, the process's CPU seconds over it and whether the time
    ran out."""
    cpu0 = time.process_time()
    t0 = time.monotonic()
    tenants = make_tenants()
    try:
        await asyncio.wait_for(asyncio.gather(*tenants), timeout_s)
        timed_out = False
    except asyncio.TimeoutError:
        timed_out = True
    makespan = time.monotonic() - t0
    cpu_s = time.process_time() - cpu0
    for task in tenants + others:
        task.cancel()
    return makespan, cpu_s, timed_out


def _harness_lease(tick_s: Optional[float] = None) -> LeaseParams:
    """Leases no instant miner blows, and no age alarm."""
    kw = {} if tick_s is None else {"tick_s": tick_s}
    return LeaseParams(grace_s=120.0, floor_s=60.0, queue_alarm_s=0.0,
                       **kw)


def run_load(tenants: int = 1000, replicas: int = 1, miners: int = 4,
             *, requests_per_tenant: int = 1, req_nonces: int = 256,
             max_queued: int = 4096, recv_batch: Optional[int] = None,
             trace_sample: Optional[float] = None,
             qos_lazy: Optional[bool] = None,
             capture_path: Optional[str] = None,
             timeout_s: float = 300.0) -> dict:
    """One storm leg; returns its measurement.

    ``qos_lazy`` pins the grant pump (None: the port's default, the
    eager one). ``capture_path`` arms the capture plane for the leg: the
    scheduler(s) write the storm's workload there (closed with the leg),
    an input of :func:`run_replay`."""
    # Made and closed outside the leg's coroutine, so a storm that raises
    # still closes its capture.
    cap = None
    if capture_path is not None:
        from .capture import WorkloadCapture
        cap = WorkloadCapture(path=capture_path)

    async def leg() -> dict:
        from .replicas import ReplicaSet
        from .scheduler import Scheduler
        server = DetServer(record=False)
        qos_kw = {} if qos_lazy is None else {"lazy": qos_lazy}
        qos = QosParams(enabled=True, max_queued=max(
            1, max_queued // max(1, replicas)), **qos_kw)
        # The adapt plane off: this leg measures the replica plane at
        # known static knobs (run_adversarial runs the controllers).
        kw = dict(lease=_harness_lease(), cache=CacheParams(enabled=False),
                  qos=qos, adapt=AdaptParams(enabled=False),
                  verify=VerifyParams(enabled=False),
                  recv_batch=recv_batch, trace_sample=trace_sample,
                  capture=cap)
        if replicas > 1:
            coord = ReplicaSet(server, replicas, **kw)
        else:
            coord = Scheduler(server, **kw)
        coord_task = asyncio.create_task(coord.run())
        miner_tasks = await _start_miners(server, [0.0] * miners)
        latencies: list = []
        sheds: list = []
        makespan, cpu_s, timed_out = await _run_storm(
            lambda: [asyncio.create_task(
                _tenant(server.connect(), f"t{t}", requests_per_tenant,
                        req_nonces, latencies, sheds))
                for t in range(tenants)],
            miner_tasks + [coord_task], timeout_s)
        total = tenants * requests_per_tenant
        latencies.sort()
        out = {
            "tenants": tenants,
            "replicas": replicas,
            "miners": miners,
            "requests": total,
            **_rates(latencies, makespan),
            "shed_tenants": len(sheds),
            "shed_rate": round(1 - len(latencies) / total, 4)
            if total else 0.0,
            "cpu_s_per_request": _cpu_per_request(cpu_s, len(latencies)),
            "trace": _trace_summary(coord),
        }
        if timed_out:
            out["timed_out"] = True
        return out

    try:
        return asyncio.run(leg())
    finally:
        if cap is not None:
            cap.close()


# --------------------------------------------------- adversarial workloads

#: The three adversarial workloads (the JAX package's). Tenants arrive
#: paced over ``duration_s``, the miners are rate-limited so the service
#: capacity is a known constant, and the floods are sized so the static
#: control plane is mis-tuned:
#:
#: - ``mice_stampede``: a small-request flood well past the pool's
#:   capacity; the static plane queues to ``max_queued`` and serves each
#:   admitted mouse a queue's worth of latency, the admission controller
#:   holds the intake near capacity;
#: - ``tenant_churn``: the same overload from short-lived tenants
#:   (connect, one request, disconnect): admission and the tenants' GC
#:   under churn;
#: - ``elephant_convoy``: a few tenants submitting chunked elephants one
#:   after another to a rate-limited pool, the chunk-size controller's
#:   ground.
WORKLOADS = {
    "mice_stampede": dict(tenants=1200, duration_s=5.0, nonces=4096,
                          requests_per_tenant=1, miner_rate=200_000.0,
                          wholesale_s=5.0, max_queued=256, churn=False,
                          sequential=False),
    "tenant_churn": dict(tenants=1200, duration_s=5.0, nonces=4096,
                         requests_per_tenant=1, miner_rate=200_000.0,
                         wholesale_s=5.0, max_queued=256, churn=True,
                         sequential=False),
    "elephant_convoy": dict(tenants=3, duration_s=0.0, nonces=1 << 21,
                            requests_per_tenant=2,
                            miner_rate=1_000_000.0, wholesale_s=0.3,
                            max_queued=256, churn=False,
                            sequential=True),
}


async def _paced_tenant(server, name: str, start_s: float, count: int,
                        nonces: int, latencies: list, sheds: list,
                        churn: bool, sequential: bool) -> None:
    """One tenant of an adversarial workload: wait for its arrival slot,
    connect, then write its requests at once (stampede, churn) or one
    after the other's reply (convoy); ``churn`` closes the conn after the
    last reply. A dead conn sheds every unanswered request of the tenant,
    written or not, and only those."""
    if start_s > 0:
        await asyncio.sleep(start_s)
    chan = server.connect()
    answered = 0
    try:
        if sequential:
            for i in range(count):
                t0 = time.monotonic()
                chan.write(new_request(f"{name}#{i}", 0,
                                       nonces - 1).to_json())
                while True:
                    msg = Message.from_json(await chan.read())
                    if msg.type == MsgType.RESULT:
                        latencies.append(time.monotonic() - t0)
                        answered += 1
                        break
        else:
            stamps = []
            for i in range(count):
                stamps.append(time.monotonic())
                chan.write(new_request(f"{name}#{i}", 0,
                                       nonces - 1).to_json())
            while answered < count:
                msg = Message.from_json(await chan.read())
                if msg.type == MsgType.RESULT:
                    latencies.append(time.monotonic() - stamps[answered])
                    answered += 1
        if churn:
            await chan.close()
    except LspError:
        lost = count - answered
        if lost > 0:
            sheds.append(lost)


def run_adversarial(workload: str, *, adapt: bool = False,
                    tenants: Optional[int] = None,
                    duration_s: Optional[float] = None,
                    miners: int = 4,
                    adapt_params: Optional[AdaptParams] = None,
                    capture_path: Optional[str] = None,
                    timeout_s: float = 120.0) -> dict:
    """One leg of an adversarial workload, with the static knobs
    (``adapt=False``) or the adapt plane's controllers. The transport,
    the miners and the arrivals are the same in both, so the pair
    isolates the controllers. The adaptive leg mounts the admission
    controller too, as the JAX leg does (the port's ``AdaptParams``
    leaves it off by default). Returns :func:`run_load`'s measurement and
    the controllers' last state."""
    spec = dict(WORKLOADS[workload])
    n_tenants = tenants if tenants is not None else spec["tenants"]
    duration = duration_s if duration_s is not None \
        else spec["duration_s"]
    cap = None
    if capture_path is not None:
        from .capture import WorkloadCapture
        cap = WorkloadCapture(path=capture_path)

    async def leg() -> dict:
        from .scheduler import Scheduler
        server = DetServer(record=False)
        # The controlled knobs start at their static defaults in both
        # legs; the workload's shape (wholesale bound, queue bound, the
        # sweep's period) is the same in both.
        qos = QosParams(enabled=True, wholesale_s=spec["wholesale_s"],
                        max_queued=spec["max_queued"])
        ap = adapt_params if adapt_params is not None else AdaptParams(
            enabled=True, tick_s=0.1, admit=True)
        coord = Scheduler(server, lease=_harness_lease(0.1),
                          cache=CacheParams(enabled=False), qos=qos,
                          adapt=ap if adapt
                          else AdaptParams(enabled=False),
                          verify=VerifyParams(enabled=False),
                          capture=cap)
        coord_task = asyncio.create_task(coord.run())
        miner_tasks = await _start_miners(server,
                                          [spec["miner_rate"]] * miners)
        latencies: list = []
        sheds: list = []
        makespan, cpu_s, timed_out = await _run_storm(
            lambda: [asyncio.create_task(
                _paced_tenant(server, f"t{t}",
                              (t / n_tenants) * duration if duration > 0
                              else 0.0,
                              spec["requests_per_tenant"], spec["nonces"],
                              latencies, sheds, spec["churn"],
                              spec["sequential"]))
                for t in range(n_tenants)],
            miner_tasks + [coord_task], timeout_s)
        total = n_tenants * spec["requests_per_tenant"]
        latencies.sort()
        out = {
            "workload": workload,
            "adapt": bool(adapt),
            "tenants": n_tenants,
            "miners": miners,
            "requests": total,
            **_rates(latencies, makespan),
            "shed_tenants": len(sheds),
            "shed_requests": sum(sheds),
            "shed_rate": round(1 - len(latencies) / total, 4) if total
            else 0.0,
            "cpu_s_per_request": _cpu_per_request(cpu_s, len(latencies)),
        }
        if adapt and coord.adapt_plane is not None:
            out["adapt_state"] = coord.adapt_plane.state()
        if timed_out:
            out["timed_out"] = True
        return out

    # Sheds are the workload here: muting the shed warnings keeps them
    # from slowing the leg that sheds more.
    prev_level = _LOG.level
    _LOG.setLevel(logging.CRITICAL)
    try:
        return asyncio.run(leg())
    finally:
        _LOG.setLevel(prev_level)
        if cap is not None:
            cap.close()


def adversarial_ab(workloads=None, rounds: int = 3, **kw) -> dict:
    """Each workload static and adaptive over ``rounds`` rounds, the
    order swapped each round; the legs' medians, and a comparison per
    workload."""
    workloads = list(workloads) if workloads is not None \
        else list(WORKLOADS)
    out: dict = {"rounds": rounds, "workloads": {}}
    keys = ("makespan_s", "admitted_per_s", "p50_s", "p99_s",
            "cpu_s_per_request", "shed_rate")
    for workload in workloads:
        legs: dict = {False: [], True: []}
        for rnd in range(max(1, rounds)):
            order = (False, True) if rnd % 2 == 0 else (True, False)
            for flag in order:
                legs[flag].append(
                    run_adversarial(workload, adapt=flag, **kw))
        entry: dict = {}
        for flag, name in ((False, "static"), (True, "adaptive")):
            med = _medians(legs[flag], keys)
            med["completed"] = int(median(
                [leg["completed"] for leg in legs[flag]]))
            entry[name] = med
        entry["adapt_state"] = legs[True][-1].get("adapt_state")
        s, a = entry["static"], entry["adaptive"]
        cmp: dict = {}
        if s["p99_s"] and a["p99_s"]:
            cmp["p99_speedup"] = round(s["p99_s"] / a["p99_s"], 3)
        if s["admitted_per_s"] and a["admitted_per_s"]:
            cmp["admitted_ratio"] = round(
                a["admitted_per_s"] / s["admitted_per_s"], 3)
        if s["makespan_s"] and a["makespan_s"]:
            cmp["makespan_ratio"] = round(
                a["makespan_s"] / s["makespan_s"], 3)
        entry["compare"] = cmp
        entry["samples"] = [
            {k: leg.get(k) for k in
             ("adapt", "completed", "shed_rate", "makespan_s",
              "admitted_per_s", "p50_s", "p99_s")}
            for flag in (False, True) for leg in legs[flag]]
        out["workloads"][workload] = entry
    return out


def _medians(legs: list, keys) -> dict:
    med = {}
    for key in keys:
        vals = [leg[key] for leg in legs if leg.get(key) is not None]
        med[key] = round(median(vals), 6) if vals else None
    return med


def _trace_summary(coord) -> dict:
    """The medians of each span phase over a finished leg's (sampled)
    traces, and of the scheduler's queue seconds (enqueue to dispatch)."""
    sched_queue, phases = [], {}
    traces = coord.traces.items()
    for _key, t in traces:
        events = t.to_dict()["events"]
        enq = next((e for e in events if e["event"] == "enqueue"), None)
        disp = next((e for e in events if e["event"] == "dispatch"), None)
        if enq is not None and disp is not None:
            sched_queue.append(disp["t"] - enq["t"])
        for e in events:
            if e["event"] != "miner_span":
                continue
            for ph in SPAN_PHASES:
                v = e.get(ph)
                if isinstance(v, (int, float)):
                    phases.setdefault(ph, []).append(float(v))
    out = {"sampled_traces": len(traces)}
    if sched_queue:
        out["sched_queue_s_p50"] = round(median(sched_queue), 6)
    for ph, xs in sorted(phases.items()):
        out[f"miner_{ph}_p50"] = round(median(xs), 6)
    return out


# ----------------------------------------------------------- capture replay

#: A captured rate EWMA above this is an instant miner's measured
#: throughput (microsecond answers read as 10^8 nonces/s and more): the
#: replay's miner stays instant rather than sleeping.
_REPLAY_RATE_CUTOFF = 5e6


def _replay_data(name: str, dc: int) -> str:
    """A replayed request's data, padded toward the captured pow2
    data-size class (at most 128 characters: the class keeps the mix of
    shapes, not the bytes)."""
    want = min(max(1, (1 << max(0, dc)) - 1), 128)
    return name + "x" * max(0, want - len(name))


def _replay_request(name: str, i: int, n: int, mode: str, dc: int) -> bytes:
    """Request ``i`` of a replayed tenant. A difficulty request replays
    with target 1: the scheduler runs its difficulty path while the fake
    answers practically never qualify, so the reply is the arg-min."""
    return new_request(_replay_data(f"{name}#{i}", dc), 0, max(1, n) - 1,
                       1 if mode == "diff" else 0).to_json()


async def _replay_conn(chan, name: str, reqs: list, latencies: list,
                       sheds: list) -> None:
    """Write tenant ``name``'s ``reqs`` (``(offset_s, nonces, mode,
    dc)``, offsets from now) on ``chan`` (the ``AsyncClient`` surface)
    from a writer task while reading the replies: a captured tenant may
    interleave its requests and replies. A dead conn sheds every
    unanswered request."""
    t0 = time.monotonic()
    stamps: list = []
    answered = 0
    total = len(reqs)

    async def writer() -> None:
        for i, (dt, n, mode, dc) in enumerate(reqs):
            wait = t0 + dt - time.monotonic()
            if wait > 0:
                await asyncio.sleep(wait)
            stamps.append(time.monotonic())
            try:
                chan.write(_replay_request(name, i, n, mode, dc))
            except LspError:
                return       # shed; the reader counts it

    wtask = asyncio.create_task(writer())
    try:
        while answered < total:
            msg = Message.from_json(await chan.read())
            if msg.type == MsgType.RESULT:
                latencies.append(time.monotonic() - stamps[answered])
                answered += 1
    except LspError:
        if total - answered > 0:
            sheds.append(total - answered)
    finally:
        wtask.cancel()


async def _replay_tenant(server, name: str, start_s: float, reqs: list,
                         latencies: list, sheds: list) -> None:
    """One replayed tenant on detnet: connect at its captured (warped)
    arrival, then send its requests at their captured offsets."""
    if start_s > 0:
        await asyncio.sleep(start_s)
    await _replay_conn(server.connect(), name, reqs, latencies, sheds)


def _replay_inputs(path: str, speed: Optional[float],
                   max_tenants: Optional[int]):
    """The capture, its replay plan, its baseline over the replayed
    tenants alone, and the speed (``DBMT_REPLAY_SPEED`` by default)."""
    from .capture import (capture_baseline, load_capture, replay_plan,
                          replay_speed)
    cap = load_capture(path)
    plan = replay_plan(cap, max_tenants=max_tenants)
    base = capture_baseline(cap, tenants={p["ten"] for p in plan})
    spd = speed if speed is not None else replay_speed()
    return cap, plan, base, spd


def _warped(plan_entry: dict, spd: float) -> list:
    return [(dt / spd, n, mode, dc)
            for dt, n, mode, dc in plan_entry["reqs"]]


def run_replay(path: str, *, speed: Optional[float] = None,
               miners: Optional[int] = None,
               max_tenants: Optional[int] = None,
               bounds: Optional[dict] = None,
               timeout_s: float = 300.0) -> dict:
    """Re-send a capture through the detnet harness (the ``replay``
    workload).

    Each hashed tenant's arrivals and the geometry mix (range size,
    arg-min or difficulty, data-size class) are the capture's; the miners
    are modelled from its pool snapshots (a rate EWMA becomes a
    rate-limited fake miner, an instant one stays instant). ``speed``
    warps both the arrivals and the rate-limited miners, so the load
    factor survives the warp. Returns :func:`run_load`'s measurement, the
    capture's own baseline (``capture``) and the ``fidelity`` verdict.
    A capture made over another transport (real LSP) replays with its
    p99 reported but not gated: the latency then differs by the
    transport's floor, not by the workload."""
    from .capture import fidelity
    cap, plan, base, spd = _replay_inputs(path, speed, max_tenants)
    if bounds is None and cap.cfg.get("transport") not in (None,
                                                          "DetServer"):
        bounds = {"p99_ratio": None}

    async def leg() -> dict:
        from .scheduler import Scheduler
        server = DetServer(record=False)
        qos = QosParams(
            enabled=bool(cap.cfg.get("qos", True)),
            max_queued=max(1, int(cap.cfg.get("max_queued", 4096))),
            wholesale_s=float(cap.cfg.get("wholesale_s", 5.0)))
        # Adapt off, as in every leg: fidelity compares shapes at known
        # static knobs. capture=False: a DBMT_CAPTURE=1 left in the
        # environment must not arm a capture that truncates the file
        # being replayed.
        coord = Scheduler(server, lease=_harness_lease(),
                          cache=CacheParams(enabled=False), qos=qos,
                          adapt=AdaptParams(enabled=False),
                          verify=VerifyParams(enabled=False),
                          capture=False)
        coord_task = asyncio.create_task(coord.run())
        rates = cap.pool_rates()
        n_miners = (miners if miners is not None
                    else min(16, len(rates)) if rates else 4)
        pool = []
        for i in range(max(1, n_miners)):
            rate = rates[i % len(rates)] if rates else 0.0
            pool.append(0.0 if rate <= 0 or rate > _REPLAY_RATE_CUTOFF
                        else rate * spd)
        miner_tasks = await _start_miners(server, pool)
        latencies: list = []
        sheds: list = []
        makespan, cpu_s, timed_out = await _run_storm(
            lambda: [asyncio.create_task(_replay_tenant(
                server, p["name"], p["start"] / spd, _warped(p, spd),
                latencies, sheds)) for p in plan],
            miner_tasks + [coord_task], timeout_s)
        total = sum(len(p["reqs"]) for p in plan)
        latencies.sort()
        out = {
            "workload": "replay",
            "source": path,
            "speed": spd,
            "tenants": len(plan),
            "replicas": 1,
            "miners": len(miner_tasks),
            "requests": total,
            **_rates(latencies, makespan),
            "shed_tenants": len(sheds),
            "shed_requests": sum(sheds),
            # Sheds over arrivals, the baseline's definition, so the
            # fidelity delta compares like with like.
            "shed_rate": round(sum(sheds) / total, 4) if total else 0.0,
            "cpu_s_per_request": _cpu_per_request(cpu_s, len(latencies)),
            "trace": _trace_summary(coord),
        }
        if timed_out:
            out["timed_out"] = True
        out["capture"] = base
        out["fidelity"] = fidelity(base, out, speed=spd, bounds=bounds)
        return out

    prev_level = _LOG.level
    _LOG.setLevel(logging.CRITICAL)
    try:
        return asyncio.run(leg())
    finally:
        _LOG.setLevel(prev_level)


async def _ring_client(statedir: str, params, name: str):
    """An LSP client to the replica that owns ``name`` on the advertised
    ring, or None when there is no ring or no connection."""
    from ..lsp.client import new_async_client
    from .procs import resolve_owner
    owner = resolve_owner(statedir, name)
    if owner is None:
        return None
    try:
        return await new_async_client(owner[1], params)
    except LspError:
        return None


async def _replay_ring_tenant(statedir: str, params, name: str,
                              start_s: float, reqs: list,
                              latencies: list, sheds: list) -> None:
    """:func:`_replay_tenant` over real UDP to the ring's owner."""
    if start_s > 0:
        await asyncio.sleep(start_s)
    client = await _ring_client(statedir, params, name)
    if client is None:
        sheds.append(len(reqs))
        return
    try:
        await _replay_conn(client, name, reqs, latencies, sheds)
    finally:
        await client.close()


def _proc_env(**extra) -> dict:
    """The process tier's children in a harness leg: a 0.25 s beat, LSP
    epochs of 0.5 s (8 to a loss), 1% of requests traced, the adapt plane
    off (known static knobs)."""
    return {"DBMT_HEALTH_BEAT_S": "0.25", "DBMT_HEALTH_MISS_K": "3",
            "DBMT_EPOCH_MILLIS": "500", "DBMT_EPOCH_LIMIT": "8",
            "DBMT_TRACE_SAMPLE": "0.01", "DBMT_ADAPT": "0", **extra}


def run_replay_procs(path: str, *, replicas: int = 2, miners: int = 4,
                     speed: Optional[float] = None,
                     max_tenants: Optional[int] = None,
                     bounds: Optional[dict] = None,
                     timeout_s: float = 180.0) -> dict:
    """Re-send a capture through the process tier: a router, replica
    processes on their own LSP sockets and instant agents
    (``fake_miners``), the arrivals over real localhost UDP at the
    captured pacing. The serving side is the cluster's own (the captured
    rates do not cross the process boundary), so by default fidelity
    gates only the arrivals and sheds; the latency and admitted ratios
    are reported ungated (``bounds=`` arms them)."""
    import shutil
    import tempfile

    from .capture import fidelity
    _cap, plan, base, spd = _replay_inputs(path, speed, max_tenants)
    if bounds is None:
        bounds = {"admitted_ratio": None, "p99_ratio": None}

    async def leg() -> dict:
        from .procs import ProcCluster
        statedir = tempfile.mkdtemp(prefix="dbmt_replayprocs_")
        # DBMT_CAPTURE=0 in the children: a replay must never arm a
        # capture that truncates its source or records its own traffic.
        cluster = ProcCluster(statedir, replicas=replicas, miners=miners,
                              env=_proc_env(DBMT_CAPTURE="0"),
                              fake_miners=True)
        cluster.start()
        params = _proc_params()
        latencies: list = []
        sheds: list = []
        timed_out = False
        try:
            await cluster.wait_live(replicas, timeout_s=30.0,
                                    miners=miners)
            t0 = time.monotonic()
            tasks = [asyncio.create_task(_replay_ring_tenant(
                statedir, params, p["name"], p["start"] / spd,
                _warped(p, spd), latencies, sheds)) for p in plan]
            try:
                await asyncio.wait_for(asyncio.gather(*tasks), timeout_s)
            except asyncio.TimeoutError:
                timed_out = True
            makespan = time.monotonic() - t0
            for task in tasks:
                task.cancel()
        finally:
            cluster.close()
            shutil.rmtree(statedir, ignore_errors=True)
        total = sum(len(p["reqs"]) for p in plan)
        latencies.sort()
        out = {
            "workload": "replay", "topology": "procs", "source": path,
            "speed": spd, "tenants": len(plan), "replicas": replicas,
            "miners": miners, "requests": total,
            **_rates(latencies, makespan),
            "shed_tenants": len(sheds), "shed_requests": sum(sheds),
            "shed_rate": round(sum(sheds) / total, 4) if total else 0.0,
            "trace": {"sampled_traces": 0},
        }
        if timed_out:
            out["timed_out"] = True
        out["capture"] = base
        out["fidelity"] = fidelity(base, out, speed=spd, bounds=bounds)
        return out

    return asyncio.run(leg())


def _children_cpu_s(pids) -> float:
    """The summed utime + stime of processes (``/proc/<pid>/stat``): the
    process tier's scheduler CPU is in its children."""
    import os
    tick = os.sysconf("SC_CLK_TCK")
    total = 0.0
    for pid in pids:
        try:
            with open(f"/proc/{pid}/stat", encoding="ascii") as fh:
                parts = fh.read().rsplit(") ", 1)[-1].split()
            total += (int(parts[11]) + int(parts[12])) / tick
        except (OSError, ValueError, IndexError):
            continue
    return total


async def _ring_tenant(statedir: str, params, name: str, count: int,
                       req_nonces: int, latencies: list,
                       sheds: list) -> None:
    """One tenant over real UDP to the ring's owner: ``count`` requests
    written at once, then the replies; a dead conn sheds the unanswered
    ones."""
    client = await _ring_client(statedir, params, name)
    if client is None:
        sheds.append(count)
        return
    stamps = []
    got = 0
    try:
        for i in range(count):
            stamps.append(time.monotonic())
            client.write(new_request(f"{name}#{i}", 0,
                                     req_nonces - 1).to_json())
        while got < count:
            msg = Message.from_json(await client.read())
            if msg.type == MsgType.RESULT:
                latencies.append(time.monotonic() - stamps[got])
                got += 1
    except LspError:
        if count - got > 0:
            sheds.append(count - got)
    finally:
        await client.close()


def _proc_params():
    from ..lsp.params import Params
    return Params(epoch_limit=8, epoch_millis=500, window_size=32,
                  max_backoff_interval=2)


async def drive_ring_tenants(statedir: str, start: int, count: int,
                             requests_per_tenant: int, req_nonces: int,
                             timeout_s: float) -> dict:
    """Drive tenants ``t<start>`` to ``t<start+count-1>`` against the ring
    at ``statedir``: one driver's share of a process-tier storm. Returns
    ``{"latencies": [...], "sheds": [...], "timed_out": bool}``."""
    params = _proc_params()
    latencies: list = []
    sheds: list = []
    tasks = [asyncio.create_task(
        _ring_tenant(statedir, params, f"t{start + i}",
                     requests_per_tenant, req_nonces, latencies, sheds))
        for i in range(count)]
    timed_out = False
    try:
        await asyncio.wait_for(asyncio.gather(*tasks), timeout_s)
    except asyncio.TimeoutError:
        timed_out = True
    for task in tasks:
        task.cancel()
    return {"latencies": latencies, "sheds": sheds,
            "timed_out": timed_out}


def _merge_shards(shards: list) -> tuple:
    """The drivers' latencies, sheds and timed-out flag, merged."""
    latencies: list = []
    sheds: list = []
    timed_out = False
    for out in shards:
        latencies.extend(out.get("latencies", []))
        sheds.extend(out.get("sheds", []))
        timed_out = timed_out or out.get("timed_out", False)
    return latencies, sheds, timed_out


async def _rollup_summary(statedir: str, answered: int) -> dict:
    """The cluster's own rollup while its processes live: each process's
    status and the summed ``results_sent`` and ``qos_shed``. A blob lags
    its counters by up to a beat, so it is read again (up to 8 times)
    until the totals cover the ``answered`` requests."""
    from .procs import health_beat_s
    from .rollup import aggregate

    def fam(doc, family):
        sec = doc["cluster"]["counters"]
        return int(sum(v for k, v in sec.items()
                       if k == family or k.startswith(family + "{")))

    beat = health_beat_s()
    doc = aggregate(statedir)
    for _ in range(8):
        if fam(doc, "sched.results_sent") + fam(doc, "sched.qos_shed") \
                >= answered:
            break
        await asyncio.sleep(max(0.05, beat / 2))
        doc = aggregate(statedir)
    statuses = [p["status"] for p in doc["procs"]]
    return {"procs": len(statuses), "fresh": statuses.count("fresh"),
            "stale": statuses.count("stale"),
            "fenced": statuses.count("fenced"),
            "results_sent": fam(doc, "sched.results_sent"),
            "qos_shed": fam(doc, "sched.qos_shed"),
            "series_overflow": doc["cluster"]["series_overflow"]}


def run_load_procs(tenants: int = 200, replicas: int = 2,
                   miners: int = 4, *, requests_per_tenant: int = 1,
                   req_nonces: int = 256, drivers: int = 1,
                   rollup: Optional[bool] = None,
                   timeout_s: float = 180.0) -> dict:
    """The process tier's storm: a router, one process a replica on its
    own LSP socket and instant agents, driven by tenants that resolve
    the ring and connect over real localhost UDP. Returns
    :func:`run_load`'s measurement; ``cpu_s_per_request`` sums the
    cluster's children's CPU (``/proc``), not the driver's.

    ``drivers > 1`` shards the driver over that many processes
    (``python -m ...apps.loadharness driver``), each an equal slice of
    the tenants printing one JSON line the parent merges: one driver's
    event loop saturates at a few hundred UDP conns. ``rollup`` pins
    ``DBMT_ROLLUP`` (None: the environment's); with it on, the leg also
    reports the cluster's own rollup (``rollup``)."""
    import shutil
    import tempfile

    async def leg() -> dict:
        from .procs import ProcCluster
        statedir = tempfile.mkdtemp(prefix="dbmt_loadprocs_")
        env = _proc_env()
        if rollup is not None:
            env["DBMT_ROLLUP"] = "1" if rollup else "0"
        cluster = ProcCluster(statedir, replicas=replicas, miners=miners,
                              env=env, fake_miners=True)
        cluster.start()
        rollup_summary = None
        try:
            await cluster.wait_live(replicas, timeout_s=30.0,
                                    miners=miners)
            pids = [p.pid for p in cluster.procs.values()]
            cpu0 = _children_cpu_s(pids)
            t0 = time.monotonic()
            if drivers <= 1:
                shards = [await drive_ring_tenants(
                    statedir, 0, tenants, requests_per_tenant,
                    req_nonces, timeout_s)]
            else:
                shards = await _drive_sharded(
                    statedir, tenants, drivers, requests_per_tenant,
                    req_nonces, timeout_s, cluster.env)
            latencies, sheds, timed_out = _merge_shards(shards)
            makespan = time.monotonic() - t0
            cpu_s = _children_cpu_s(pids) - cpu0
            if cluster.env.get("DBMT_ROLLUP", "1") != "0":
                try:
                    rollup_summary = await _rollup_summary(
                        statedir, len(latencies) + len(sheds))
                except (OSError, ValueError, KeyError) as exc:
                    rollup_summary = {"error": f"aggregate failed: {exc}"}
        finally:
            cluster.close()
            shutil.rmtree(statedir, ignore_errors=True)
        total = tenants * requests_per_tenant
        latencies.sort()
        out = {
            "tenants": tenants, "replicas": replicas, "miners": miners,
            "topology": "procs", "drivers": max(1, drivers),
            "requests": total,
            **_rates(latencies, makespan),
            "shed_tenants": len(sheds),
            "shed_rate": round(1 - len(latencies) / total, 4) if total
            else 0.0,
            "cpu_s_per_request": _cpu_per_request(cpu_s, len(latencies)),
            "trace": {"sampled_traces": 0},
        }
        if rollup_summary is not None:
            out["rollup"] = rollup_summary
        if timed_out:
            out["timed_out"] = True
        return out

    return asyncio.run(leg())


async def _drive_sharded(statedir: str, tenants: int, drivers: int,
                         requests_per_tenant: int, req_nonces: int,
                         timeout_s: float, env: dict) -> list:
    """Spawn ``drivers`` driver processes over equal slices of the tenants
    and collect their JSON lines. A driver that dies or prints no JSON
    gives an empty shard: its tenants count as incomplete, which the
    CLI's gate fails on."""
    import json
    import os
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    per = -(-tenants // max(1, drivers))
    procs = []
    for d in range(drivers):
        start = d * per
        count = min(per, tenants - start)
        if count <= 0:
            break
        procs.append(await asyncio.create_subprocess_exec(
            sys.executable, "-m", f"{__package__}.loadharness", "driver",
            statedir, "--start", str(start), "--count", str(count),
            "--requests-per-tenant", str(requests_per_tenant),
            "--nonces", str(req_nonces), "--timeout", str(timeout_s),
            cwd=repo, env=env, stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL))
    outs = []
    for proc in procs:
        try:
            stdout, _ = await asyncio.wait_for(proc.communicate(),
                                               timeout_s + 30.0)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()
            outs.append({})
            continue
        try:
            outs.append(json.loads(
                stdout.decode("utf-8").strip().splitlines()[-1]))
        except (ValueError, IndexError):
            outs.append({})
    return outs


def driver_main(argv=None) -> int:
    """``python -m distributed_bitcoinminer_tpu_torch.apps.loadharness
    driver <statedir> --count N [...]``: one shard of a sharded
    process-tier storm; prints one JSON line (latencies, sheds)."""
    import argparse
    import json
    import sys
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(prog="loadharness driver")
    ap.add_argument("role", choices=("driver",))
    ap.add_argument("statedir")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--count", type=int, required=True)
    ap.add_argument("--requests-per-tenant", type=int, default=1)
    ap.add_argument("--nonces", type=int, default=256)
    ap.add_argument("--timeout", type=float, default=180.0)
    args = ap.parse_args(argv)
    out = asyncio.run(drive_ring_tenants(
        args.statedir, args.start, args.count,
        args.requests_per_tenant, args.nonces, args.timeout))
    print(json.dumps(out), flush=True)
    return 0


def load_curve(points, replica_counts=(1, 4), rounds: int = 2,
               **kw) -> dict:
    """For each tenant count of ``points`` and each replica count,
    ``rounds`` legs (the order swapped each round) and their medians:
    ``{"points": [{"tenants": N, "r<k>": {...}}, ...], "samples":
    [...]}``."""
    samples = []
    curve = []
    for tenants in points:
        entry: dict = {"tenants": tenants}
        per_rep: dict = {n: [] for n in replica_counts}
        for rnd in range(max(1, rounds)):
            order = (list(replica_counts) if rnd % 2 == 0
                     else list(reversed(replica_counts)))
            for n in order:
                leg = run_load(tenants=tenants, replicas=n, **kw)
                per_rep[n].append(leg)
                samples.append(leg)
        for n, legs in per_rep.items():
            med = _medians(legs, ("makespan_s", "admitted_per_s", "p50_s",
                                  "p99_s", "cpu_s_per_request",
                                  "shed_rate"))
            med["completed"] = legs[0]["completed"]
            med["trace"] = legs[-1]["trace"]
            entry[f"r{n}"] = med
        curve.append(entry)
    return {"points": curve, "samples": samples}


if __name__ == "__main__":
    import sys
    sys.exit(driver_main())
