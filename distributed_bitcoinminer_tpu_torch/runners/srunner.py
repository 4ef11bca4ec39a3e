"""Echo server runner: an interactive LSP exerciser.

Counterpart of the JAX package's ``runners/srunner.py``, flag-compatible
with the reference's ``srunner``: ``--port --rdrop --wdrop --elim --ems
--wsize --maxbackoff -v``, with the same standard-output lines, so shell
drivers written for the reference harness work. Go's ``flag`` spellings
are accepted too (``-port=9999``, ``-port 9999``, ``-v``).

    python -m distributed_bitcoinminer_tpu_torch.runners.srunner --port 9999
"""

from __future__ import annotations

import argparse
import asyncio
import re
import sys

from .. import lspnet
from ..lsp.errors import LspError
from ..lsp.params import (DEFAULT_EPOCH_LIMIT, DEFAULT_EPOCH_MILLIS,
                          DEFAULT_MAX_BACKOFF_INTERVAL, DEFAULT_WINDOW_SIZE,
                          Params)
from ..lsp.server import new_async_server


def build_parser(role: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog=role, allow_abbrev=False)
    p.add_argument("--port", type=int, default=9999, help="port number")
    p.add_argument("--rdrop", type=int, default=0,
                   help="network read drop percent")
    p.add_argument("--wdrop", type=int, default=0,
                   help="network write drop percent")
    p.add_argument("--elim", type=int, default=DEFAULT_EPOCH_LIMIT,
                   help="epoch limit")
    p.add_argument("--ems", type=int, default=DEFAULT_EPOCH_MILLIS,
                   help="epoch duration (ms)")
    p.add_argument("--wsize", type=int, default=DEFAULT_WINDOW_SIZE,
                   help="window size")
    p.add_argument("--maxbackoff", type=int,
                   default=DEFAULT_MAX_BACKOFF_INTERVAL,
                   help="maximum interval epoch")
    p.add_argument("-v", action="store_true", help="show runner logs")
    # Not in the reference: the metrics emitter at this period, one JSON
    # snapshot line a period through the ``dbmt`` logger (0: off, the
    # default, which keeps the reference's standard output).
    p.add_argument("--metrics", type=float, default=0.0, metavar="SECONDS",
                   help="metrics snapshot interval in seconds (0 = off)")
    return p


def normalize_go_flags(argv, parser: argparse.ArgumentParser) -> list:
    """Rewrite Go-``flag`` single-dash long options to argparse's form:
    ``-port=9999`` and ``-port 9999`` become ``--port ...``.

    Only a token whose name is one of ``parser``'s long options is
    rewritten, so values (negative numbers too) and unknown flags pass
    through to argparse's own errors. ``--`` ends the flags."""
    known = {opt for action in parser._actions
             for opt in action.option_strings if opt.startswith("--")}
    argv = list(sys.argv[1:] if argv is None else argv)
    out = []
    for i, arg in enumerate(argv):
        if arg == "--":
            out.extend(argv[i:])
            break
        m = re.match(r"^-([A-Za-z][A-Za-z0-9_]*)(=.*)?$", arg)
        if m and f"--{m.group(1)}" in known:
            arg = "-" + arg
        out.append(arg)
    return out


def params_from_args(args) -> Params:
    return Params(epoch_limit=args.elim, epoch_millis=args.ems,
                  window_size=args.wsize, max_backoff_interval=args.maxbackoff)


def start_observability(args) -> None:
    """``-v`` turns the transport's debug logs on; ``--metrics`` starts
    the emitter."""
    if args.v:
        lspnet.enable_debug_logs(True)
    if args.metrics > 0:
        from ..utils import ensure_emitter
        from ..utils.logging import configure_logging
        configure_logging()
        ensure_emitter(args.metrics)


async def run_server(args) -> None:
    lspnet.set_server_read_drop_percent(args.rdrop)
    lspnet.set_server_write_drop_percent(args.wdrop)
    print(f"Starting server on port {args.port}...", flush=True)
    try:
        server = await new_async_server(args.port, params_from_args(args))
    except OSError as exc:
        print(f"Failed to start Server on port {args.port}: {exc}")
        return
    print("Server waiting for clients...", flush=True)
    while True:
        try:
            conn_id, item = await server.read()
        except LspError:
            return
        if isinstance(item, Exception):
            print(f"Client {conn_id} has died: {item}", flush=True)
            continue
        try:
            server.write(conn_id, item)
        except LspError as exc:
            print(f"Server failed to write to connection {conn_id}: {exc}",
                  flush=True)


def main(argv=None) -> int:
    parser = build_parser("srunner")
    args = parser.parse_args(normalize_go_flags(argv, parser))
    start_observability(args)
    try:
        asyncio.run(run_server(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
