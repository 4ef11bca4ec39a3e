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
``DBMT_CACHE_SIZE``, ``DBMT_COALESCE``, ``DBMT_LEASE_*``, ``DBMT_QUEUE_ALARM_S``,
``DBMT_AUDIT_*`` and ``DBMT_TRUST_*`` (the port's README).
"""

from __future__ import annotations

import asyncio
import logging
import sys

from ..lsp.params import Params
from ..lsp.server import new_async_server
from ..utils.config import (cache_from_env, lease_from_env, qos_from_env,
                            stripe_from_env, verify_from_env)
from .scheduler import Scheduler


async def serve(port: int, params: Params | None = None) -> None:
    server = await new_async_server(port, params or Params())
    print("Server listening on port", server.port, flush=True)
    try:
        await Scheduler(server, qos=qos_from_env(), lease=lease_from_env(),
                        verify=verify_from_env(), stripe=stripe_from_env(),
                        cache=cache_from_env()).run()
    finally:
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
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    try:
        asyncio.run(serve(port))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
