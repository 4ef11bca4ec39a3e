"""Scheduler server CLI — same contract as the reference binary.

Usage: ``python -m distributed_bitcoinminer_tpu_torch.apps.server <port>``
(ref: bitcoin/server/server.go:430-472; prints "Server listening on port N").
The scheduler takes its QoS plane, striping, result cache, lease plane
and verification tier from the environment (``qos_from_env``,
``stripe_from_env``, ``cache_from_env``, ``lease_from_env``,
``verify_from_env``): the ``DBMT_QOS_*`` knobs (chunking, depth, the
overload bound ``DBMT_QOS_MAX_QUEUED``, the admission buckets
``DBMT_QOS_RATE`` and ``DBMT_QOS_BURST``, the weights
``DBMT_QOS_WEIGHT_DEFAULT`` and ``DBMT_QOS_WEIGHTS``),
``DBMT_STRIPE_CHUNK_S``, ``DBMT_STRIPE_DEPTH``, ``DBMT_CACHE``,
``DBMT_CACHE_SIZE``, ``DBMT_COALESCE*``, ``DBMT_LEASE_*``,
``DBMT_QUEUE_ALARM_S``,
``DBMT_AUDIT_*``, ``DBMT_TRUST_*``, the adapt plane's ``DBMT_ADAPT*`` and
the tracing plane's ``DBMT_TRACE*`` (the port's README); its LSP
``Params`` from ``DBMT_EPOCH_LIMIT``, ``DBMT_EPOCH_MILLIS``,
``DBMT_WINDOW`` and ``DBMT_MAX_BACKOFF``. As the reference's scheduler
does, it logs to ``log.txt`` in its working directory, where the metrics
emitter (``DBMT_METRICS_INTERVAL_S``) writes its snapshots too.

With ``DBMT_TRACE_EXPORT=PATH`` the server writes its retained request
traces when it stops (SIGTERM, or the LSP server closing): the Perfetto
document of ``Scheduler.export_trace`` to PATH, and each trace's dict
(with its ``t0``) as a JSON line to ``PATH.jsonl``, the input of
``tools/dbmtrace.py``.

With ``DBMT_REPLICAS`` above 1 the server runs that many scheduler
replicas behind its one socket (``apps.replicas.ReplicaSet``: tenants
hashed onto replicas, miners in balanced slices, one shared result
cache), each with the settings above; the default, 1, runs the plain
single scheduler. ``DBMT_CAPTURE=1`` arms the workload capture plane
(``apps.capture``; ``DBMT_CAPTURE_PATH``, relative to the working
directory), shared by every replica.
"""

from __future__ import annotations

import asyncio
import json
import logging
import signal
import sys

from ..lsp.params import Params
from ..lsp.server import new_async_server
from ..utils._env import str_env
from ..utils.config import (cache_from_env, lease_from_env,
                            lsp_params_from_env, qos_from_env,
                            replicas_from_env, stripe_from_env,
                            verify_from_env)
from ..utils.logging import configure_logging
from ..utils.metrics import ensure_emitter
from .replicas import ReplicaSet
from .scheduler import Scheduler


def write_trace_export(scheduler, path: str) -> None:
    """The retained traces of the scheduler (or of every live replica
    of a ``ReplicaSet``): the Perfetto document to ``path`` and one trace
    dict a line to ``path + ".jsonl"``."""
    scheduler.export_trace(path)
    traces = scheduler.traces if isinstance(scheduler, ReplicaSet) \
        else scheduler.tenant_plane.traces
    with open(path + ".jsonl", "w", encoding="utf-8") as fh:
        for _key, t in traces.items():
            fh.write(json.dumps({**t.to_dict(), "t0": t.t0},
                                sort_keys=True) + "\n")


async def serve(port: int, params: Params | None = None) -> None:
    server = await new_async_server(port, params or lsp_params_from_env())
    print("Server listening on port", server.port, flush=True)
    settings = dict(qos=qos_from_env(), lease=lease_from_env(),
                    verify=verify_from_env(), stripe=stripe_from_env(),
                    cache=cache_from_env())
    n = replicas_from_env()
    scheduler = ReplicaSet(server, n, **settings) if n > 1 \
        else Scheduler(server, **settings)
    run = asyncio.ensure_future(scheduler.run())
    asyncio.get_running_loop().add_signal_handler(signal.SIGTERM,
                                                  run.cancel)
    try:
        await run
    except asyncio.CancelledError:
        if asyncio.current_task().cancelling():
            raise                       # serve itself was cancelled
        # SIGTERM cancelled the scheduler: stop, then export.
    finally:
        export = str_env("DBMT_TRACE_EXPORT", "")
        if export:
            write_trace_export(scheduler, export)
        await server.close()


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv if argv is None else argv
    if len(argv) != 2:
        print(f"Usage: ./{argv[0]} <port>", end="")
        return 1
    try:
        port = int(argv[1])
    except ValueError as exc:
        print("Port must be a number:", exc)
        return 1
    configure_logging(logging.INFO, logfile="log.txt")
    ensure_emitter()
    try:
        asyncio.run(serve(port))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
