"""abci-cli — poke an ABCI application server from the command line.

Reference: abci/cmd/abci-cli (echo/info/deliver_tx/check_tx/commit/query
+ the `kvstore` demo server + interactive console). Speaks the framework's
length-framed socket protocol (abci/client.py), so it exercises the same
process boundary a production app server sits behind.
"""

from __future__ import annotations

import asyncio
import shlex
import sys

from .client import SocketClient, SocketServer


def _parse_hex_or_str(s: str) -> bytes:
    if s.startswith("0x"):
        return bytes.fromhex(s[2:])
    return s.encode()


async def _run_one(client: SocketClient, cmd: str, args: list[str]) -> int:
    if cmd == "echo":
        print(await client.echo(args[0] if args else ""))
    elif cmd == "info":
        r = await client.info()
        print(
            f"data={r.data} version={r.version} "
            f"last_block_height={r.last_block_height} "
            f"last_block_app_hash=0x{r.last_block_app_hash.hex()}"
        )
    elif cmd == "deliver_tx":
        r = await client.deliver_tx(_parse_hex_or_str(args[0]))
        print(f"code={r.code} log={r.log!r}")
    elif cmd == "check_tx":
        r = await client.check_tx(_parse_hex_or_str(args[0]))
        print(f"code={r.code} log={r.log!r}")
    elif cmd == "commit":
        r = await client.commit()
        print(f"data=0x{r.data.hex()}")
    elif cmd == "query":
        r = await client.query("/store", _parse_hex_or_str(args[0]), 0, False)
        print(
            f"code={r.code} key={r.key!r} value={r.value!r} "
            f"height={r.height}"
        )
    else:
        print(f"unknown command {cmd!r}", file=sys.stderr)
        return 1
    return 0


async def _amain(args) -> int:
    grpc_mode = getattr(args, "transport", "socket") == "grpc"
    if args.abci_cmd == "kvstore":
        from .kvstore import KVStoreApplication

        if grpc_mode:
            from .grpc_transport import GRPCServer

            srv = GRPCServer(KVStoreApplication(), port=args.port)
        else:
            srv = SocketServer(KVStoreApplication(), port=args.port)
        await srv.start()
        print(
            f"kvstore ABCI server listening on {srv.port} "
            f"({'grpc' if grpc_mode else 'socket'})",
            flush=True,
        )
        try:
            await asyncio.Event().wait()
        except (KeyboardInterrupt, asyncio.CancelledError):
            pass
        await srv.stop()
        return 0

    if grpc_mode:
        from .grpc_transport import GRPCClient

        client = GRPCClient(port=args.port)
    else:
        client = SocketClient(port=args.port)
    await client.connect()
    try:
        if args.abci_cmd == "console":
            print("ABCI console — echo/info/deliver_tx/check_tx/commit/query")
            loop = asyncio.get_running_loop()
            while True:
                line = (
                    await loop.run_in_executor(None, sys.stdin.readline)
                ).strip()
                if not line or line in ("exit", "quit"):
                    break
                parts = shlex.split(line)
                try:
                    await _run_one(client, parts[0], parts[1:])
                except Exception as e:
                    print(f"error: {e}", file=sys.stderr)
            return 0
        return await _run_one(client, args.abci_cmd, args.args)
    finally:
        await client.close()


def cmd_abci(args) -> int:
    from .client import ABCIClientError

    try:
        return asyncio.run(_amain(args))
    except (ConnectionError, ABCIClientError) as e:
        print(f"cannot reach ABCI server: {e}", file=sys.stderr)
        return 1


def register(sub) -> None:
    sp = sub.add_parser(
        "abci-cli", help="poke an ABCI app server (reference abci-cli)"
    )
    sp.add_argument(
        "abci_cmd",
        choices=[
            "echo",
            "info",
            "deliver_tx",
            "check_tx",
            "commit",
            "query",
            "console",
            "kvstore",
        ],
    )
    sp.add_argument("args", nargs="*")
    sp.add_argument("--port", type=int, default=26658)
    sp.add_argument(
        "--transport", choices=["socket", "grpc"], default="socket",
        help="ABCI transport (reference abci-cli --abci)",
    )
    sp.set_defaults(fn=cmd_abci)
