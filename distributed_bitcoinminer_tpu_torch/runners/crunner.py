"""Echo client runner: an interactive LSP exerciser.

Counterpart of the JAX package's ``runners/crunner.py``, flag-compatible
with the reference's ``crunner``: ``--host --port --rdrop --wdrop --elim
--ems --wsize --maxbackoff -v``, and Go ``flag`` spellings
(``srunner.normalize_go_flags``). It reads whitespace-separated tokens
from standard input and echoes each through the server.

    python -m distributed_bitcoinminer_tpu_torch.runners.crunner --port 9999
"""

from __future__ import annotations

import asyncio
import sys

from .. import lspnet
from ..lsp.client import new_async_client
from ..lsp.errors import LspError
from .srunner import (build_parser, normalize_go_flags, params_from_args,
                      start_observability)


async def run_client(args) -> None:
    lspnet.set_client_read_drop_percent(args.rdrop)
    lspnet.set_client_write_drop_percent(args.wdrop)
    # join_host_port brackets an IPv6 literal (--host ::1).
    hostport = lspnet.join_host_port(args.host, args.port)
    print(f"Connecting to server at '{hostport}'...", flush=True)
    try:
        client = await new_async_client(hostport, params_from_args(args))
    except LspError as exc:
        print(f"Failed to connect to server at {hostport}: {exc}")
        return
    # A tenant is the conn id the server gave this client (no wire
    # change); its weight is the scheduler's configuration, so
    # --qos-weight prints the DBMT_QOS_WEIGHTS entry to set there. Only
    # with the flag, so the default output is the reference's.
    if args.qos_weight > 0:
        print(f"Connected as tenant {client.conn_id()}", flush=True)
        print(f"QoS weight {args.qos_weight:g}: export "
              f"DBMT_QOS_WEIGHTS={client.conn_id()}:{args.qos_weight:g} "
              f"on the scheduler", flush=True)
    try:
        loop = asyncio.get_running_loop()
        while True:
            print("Client: ", end="", flush=True)
            line = await loop.run_in_executor(None, sys.stdin.readline)
            if not line:
                return
            for token in line.split():
                try:
                    client.write(token.encode("utf-8"))
                except LspError as exc:
                    print(f"Client {client.conn_id()} failed to write to "
                          f"server: {exc}", flush=True)
                    return
                try:
                    payload = await client.read()
                except LspError as exc:
                    print(f"Client {client.conn_id()} failed to read from "
                          f"server: {exc}", flush=True)
                    return
                print(f"Server: {payload.decode('utf-8', 'replace')}",
                      flush=True)
    finally:
        print("Exiting...", flush=True)


def main(argv=None) -> int:
    parser = build_parser("crunner")
    parser.add_argument("--host", type=str, default="127.0.0.1",
                        help="server host address")
    parser.add_argument("--qos-weight", type=float, default=0.0,
                        metavar="W", dest="qos_weight",
                        help="intended DRR weight for this tenant "
                             "(prints the scheduler-side DBMT_QOS_WEIGHTS "
                             "entry; 0 = unset)")
    args = parser.parse_args(normalize_go_flags(argv, parser))
    start_observability(args)
    try:
        asyncio.run(run_client(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
