"""The port's verify service (``parallel/verify_service.py``) against the
contract of ``tests/test_verify_service.py``: the wire codec, the frame
cap, verdict alignment, rounds coalesced across client connections,
per-client FIFO, the ``bls_agg`` and ``secp_recover`` engines on the wire,
an unknown engine's fallback, the degradation contract (a service killed
with submissions in flight, then restarted on the same socket; a service
never reached), the thread surface, the STATS frame and HTTP surface, the
bounded tenant table, and a 4-validator net of the port that keeps
committing while its service is killed and restarted (``ChaosVerifyService``
of ``tests/torch_chaos_harness.py``). Beside them:

- the stop: a service with a client attached, or an idle connection to
  its stats port, stops inside 5 s, and the reference's ``stop``, bound
  onto the same server, does not; so does one whose connection was
  accepted just before the stop, its handler not yet started; a stop that
  ends after a successor bound the same path leaves the successor's socket
  (the reference's unlinks it); idle connections past the tenant table's
  bound leave no empty ``_closed`` row (the reference's prune makes one);
- interop in both directions on the same seeded items (a port client
  against a JAX-package service, and the other way round), the verdicts
  equal to the in-proc scheduler's and the codecs' bytes equal;
- parity: a blocksync window of 39 commits x 16 validators, one commit
  tampered by more than 1/3 of the power, judged through a port service on
  ``BatchVerifier(device="cpu")`` and by the JAX package's in-proc
  ``verify_commits_light`` on its host oracle: equal bitmaps.

Services run on ``device="cpu"``; protocol tests on the stub verifiers of
the reference's tests. The tests of the reference file that need the node,
the config, the CLI or ``tools/`` hold on the port's (a ``Node`` under
``[scheduler] remote_socket``, ``HealthConfig``'s ipc knob, ``python -m
tendermint_tpu_torch verify-service`` as a child process, the port's
``testnet_generator``, ``device_report`` and ``bench_trend``); the
multi-process bench harness waits for the port's
``tools/verify_service_bench.py`` (ROADMAP.md, item A6). Tolerance:
exact (verdicts, bytes).
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import tempfile
import threading
import time
import types

import numpy as np
import pytest

from tendermint_tpu_torch import obs
from tendermint_tpu_torch.crypto import batch_verifier as bv
from tendermint_tpu_torch.crypto.batch_verifier import SigItem
from tendermint_tpu_torch.parallel import scheduler as sched_mod
from tendermint_tpu_torch.parallel.scheduler import (
    VerifyScheduler,
    set_default_scheduler,
)
from tendermint_tpu_torch.parallel.verify_service import (
    DEGRADE_EVENT,
    MAX_FRAME,
    MSG_ERROR,
    MSG_STATS,
    MSG_STATS_RESULT,
    MSG_SUBMIT,
    RemoteVerifyScheduler,
    ServiceThread,
    WireError,
    _Cursor,
    _HDR,
    decode_fn_results,
    decode_submit,
    decode_submit_fn,
    decode_verdicts,
    encode_error,
    encode_fn_results,
    encode_submit,
    encode_submit_fn,
    encode_verdicts,
    read_frame,
    write_frame,
)

pytestmark = pytest.mark.verify_service


@pytest.fixture(autouse=True)
def cpu_default(monkeypatch):
    """The port's process verifier on the CPU and no default scheduler."""
    v = bv.BatchVerifier(device="cpu")
    monkeypatch.setattr(bv, "_default", v)
    monkeypatch.setattr(sched_mod, "_default_scheduler", None)
    return v


class SigTagVerifier:
    """Deterministic stub: verdict = sig starts with b'1' (per-item, so
    alignment bugs across coalesced slices are visible)."""

    def verify(self, items):
        return np.array(
            [it.sig[:1] == b"1" for it in items], dtype=bool
        )


class GateVerifier:
    """Blocks every round on an externally-held gate: submissions
    arriving while a round is in flight must coalesce into the next."""

    def __init__(self):
        self.gate = threading.Event()

    def verify(self, items):
        assert self.gate.wait(30), "gate never released"
        return np.ones(len(items), dtype=bool)


def sig_items(n: int, good=lambda i: True, item=SigItem) -> list:
    return [
        item(
            b"p" * 32,
            b"m%06d" % i + b"\x00" * 26,
            (b"1" if good(i) else b"0") + b"s" * 63,
        )
        for i in range(n)
    ]


def sock_path(tmp_path, name: str = "verify.sock") -> str:
    """`name` under tmp_path, or under a fresh short temporary directory
    where that path would pass the 107-byte limit of a UDS address."""
    os.makedirs(str(tmp_path), exist_ok=True)
    path = os.path.join(str(tmp_path), name)
    if len(path.encode()) > 100:
        path = os.path.join(tempfile.mkdtemp(prefix="vs"), name)
    return path


def service(tmp_path, verifier=None, **kw) -> ServiceThread:
    """ServiceThread on a fresh socket, on the CPU. verifier None = the
    SigTag stub (protocol tests); False = the process verifier (live-net
    tests, whose votes carry genuine signatures)."""
    if verifier is None:
        verifier = SigTagVerifier()
    sched = (
        VerifyScheduler()
        if verifier is False
        else VerifyScheduler(verifier=verifier)
    )
    svc = ServiceThread(sock_path(tmp_path), scheduler=sched, device="cpu", **kw)
    svc.start()
    return svc


async def connect(path, cls=RemoteVerifyScheduler, **kw):
    remote = cls(path, retry_base=0.02, **kw)
    await remote.start()
    deadline = time.monotonic() + 15
    while not remote.connected and time.monotonic() < deadline:
        await asyncio.sleep(0.01)
    assert remote.connected, "client never attached"
    return remote


# --- wire protocol ----------------------------------------------------------


def test_wire_codec_roundtrips():
    items = [
        SigItem(b"p" * 32, b"m" * 40, b"s" * 64),
        SigItem(b"q" * 33, b"", b"t" * 64, "secp256k1"),
    ]
    cur = _Cursor(encode_submit(7, items, "blocksync"))
    typ, req = _HDR.unpack(cur.take(_HDR.size))
    assert (typ, req) == (MSG_SUBMIT, 7)
    got, klass = decode_submit(cur)
    assert klass == "blocksync"
    assert [
        (i.pubkey, i.msg, i.sig, i.key_type) for i in got
    ] == [(i.pubkey, i.msg, i.sig, i.key_type) for i in items]

    verdicts = np.array([True, False, True, True, False] * 3)
    cur = _Cursor(encode_verdicts(9, verdicts))
    cur.take(_HDR.size)
    assert decode_verdicts(cur).tolist() == verdicts.tolist()
    cur = _Cursor(encode_verdicts(9, np.zeros(0, dtype=bool)))
    cur.take(_HDR.size)
    assert decode_verdicts(cur).size == 0

    fn_items = [(b"a" * 96, b"h" * 32, b"c" * 96), (b"d" * 32,)]
    cur = _Cursor(encode_submit_fn(3, "bls_agg", fn_items, "consensus"))
    cur.take(_HDR.size)
    engine, got_fn, klass = decode_submit_fn(cur)
    assert (engine, klass) == ("bls_agg", "consensus")
    assert got_fn == fn_items

    results = [True, False, None, b"addr-bytes"]
    cur = _Cursor(encode_fn_results(4, results))
    cur.take(_HDR.size)
    assert decode_fn_results(cur) == results

    cur = _Cursor(encode_error(5, "boom"))
    typ, req = _HDR.unpack(cur.take(_HDR.size))
    assert (typ, req) == (MSG_ERROR, 5)
    assert cur.bytes32() == b"boom"


def test_wire_codec_rejects_malformed():
    # truncated frame
    cur = _Cursor(encode_submit(1, sig_items(2), "consensus")[:-3])
    cur.take(_HDR.size)
    with pytest.raises(WireError):
        decode_submit(cur)
    # unknown fn-result tag
    cur = _Cursor(_HDR.pack(4, 1) + b"\x00\x00\x00\x01\x09")
    cur.take(_HDR.size)
    with pytest.raises(WireError):
        decode_fn_results(cur)


def test_read_frame_caps_oversized(tmp_path):
    """An over-cap length prefix errors the connection instead of
    allocating the attacker's buffer."""

    async def run():
        path = sock_path(tmp_path, "x.sock")

        async def handler(reader, writer):
            try:
                await read_frame(reader)
            except WireError:
                writer.write(b"CAPPED")
                await writer.drain()
            writer.close()

        server = await asyncio.start_unix_server(handler, path=path)
        reader, writer = await asyncio.open_unix_connection(path)
        writer.write((1 << 31).to_bytes(4, "big"))
        await writer.drain()
        got = await asyncio.wait_for(reader.read(16), 10)
        writer.close()
        server.close()
        await server.wait_closed()
        return got

    assert asyncio.run(run()) == b"CAPPED"


# --- submit path ------------------------------------------------------------


def test_submit_verdict_alignment(tmp_path):
    """Per-item verdicts come back aligned to the submission order."""
    svc = service(tmp_path)
    try:

        async def run():
            remote = await connect(svc.server.path)
            v = await remote.submit(
                sig_items(10, good=lambda i: i % 2 == 0), "consensus"
            )
            await remote.stop()
            return v

        v = asyncio.run(run())
        assert v.tolist() == [i % 2 == 0 for i in range(10)]
    finally:
        svc.stop()


def test_cross_client_coalescing(tmp_path):
    """Submissions from different client connections land in one round:
    round 1 blocks on the gate, clients B and C submit meanwhile, and the
    service's ledger shows a round carrying >= 2 submissions."""
    gate = GateVerifier()
    svc = service(tmp_path, verifier=gate)
    try:

        def submitted():
            return sum(s["submissions"] for s in svc.server.client_stats.values())

        async def until(n):
            deadline = time.monotonic() + 10
            while submitted() < n and time.monotonic() < deadline:
                await asyncio.sleep(0.01)

        async def run():
            a = await connect(svc.server.path)
            b = await connect(svc.server.path)
            c = await connect(svc.server.path)
            fut_a = asyncio.ensure_future(a.submit(sig_items(4), "consensus"))
            # A's round in flight server-side, then B and C land while the
            # gate holds it
            await until(1)
            fut_b = asyncio.ensure_future(b.submit(sig_items(3), "consensus"))
            fut_c = asyncio.ensure_future(c.submit(sig_items(5), "consensus"))
            await until(3)
            gate.gate.set()
            va, vb, vc = await asyncio.wait_for(
                asyncio.gather(fut_a, fut_b, fut_c), 30
            )
            for r in (a, b, c):
                await r.stop()
            return va, vb, vc

        va, vb, vc = asyncio.run(run())
        assert va.all() and vb.all() and vc.all()
        assert len(va) == 4 and len(vb) == 3 and len(vc) == 5
        entries = svc.server.scheduler.ledger.entries()
        coalesced = [e for e in entries if e["submissions"] >= 2]
        assert coalesced, f"no cross-client round in {entries}"
        # three tenants in the bill
        assert len(svc.server.client_stats) == 3
        assert all(s["rows"] > 0 for s in svc.server.client_stats.values())
    finally:
        svc.stop()


def test_per_client_fifo(tmp_path):
    """One client's submissions resolve in submission order even when
    the first round blocks and the rest queue behind it."""
    gate = GateVerifier()
    svc = service(tmp_path, verifier=gate)
    try:

        async def run():
            remote = await connect(svc.server.path)
            order = []

            async def one(i):
                await remote.submit(sig_items(2 + i), "consensus")
                order.append(i)

            tasks = [asyncio.ensure_future(one(i)) for i in range(5)]
            await asyncio.sleep(0.2)
            gate.gate.set()
            await asyncio.wait_for(asyncio.gather(*tasks), 30)
            await remote.stop()
            return order

        assert asyncio.run(run()) == [0, 1, 2, 3, 4]
    finally:
        svc.stop()


# --- wire fn lanes ----------------------------------------------------------


def test_fn_lane_bls_agg_real_keys(tmp_path):
    from tendermint_tpu_torch.crypto import bls_signatures as bls

    svc = service(tmp_path)
    try:
        h = b"h" * 32
        items = []
        for i in range(3):
            priv = 6007 + i
            items.append(
                (
                    bls.public_key_to_bytes(bls.pubkey_from_priv(priv)),
                    h,
                    bls.signer_for(priv)(h),
                )
            )
        # forged: valid point, wrong signer for this key
        items.append((items[0][0], h, items[1][2]))

        async def run():
            remote = await connect(svc.server.path)
            res = await remote.submit_wire_fn("bls_agg", items, "consensus")
            await remote.stop()
            return res

        assert asyncio.run(run()) == [True, True, True, False]
    finally:
        svc.stop()


def test_fn_lane_secp_recover(tmp_path):
    import hashlib

    from tendermint_tpu_torch.crypto import secp256k1 as secp

    svc = service(tmp_path)
    try:
        key = secp.PrivKey.from_secret(b"vs-sequencer-key")
        digest = hashlib.sha256(b"blockv2-sign-bytes").digest()
        sig = secp.eth_sign(digest, key.secret)
        addr = secp.eth_address(secp.decompress_point(key.public_key().data))

        async def run():
            remote = await connect(svc.server.path)
            res = await remote.submit_wire_fn(
                "secp_recover",
                [(digest, sig), (digest, b"\x00" * 65)],
                "sequencer",
            )
            await remote.stop()
            return res

        got = asyncio.run(run())
        assert got[0] == addr
        assert got[1] == b""
    finally:
        svc.stop()


def test_unknown_fn_engine_degrades_to_fallback(tmp_path):
    svc = service(tmp_path)
    try:

        async def run():
            tracer = obs.Tracer(enabled=True)
            remote = await connect(svc.server.path, tracer=tracer)
            res = await asyncio.wait_for(
                remote.submit_wire_fn(
                    "no_such_engine",
                    [(b"x" * 32,)],
                    "consensus",
                    fallback=lambda: ["local"],
                ),
                15,
            )
            stats = remote.ipc_stats()
            await remote.stop()
            events = [
                r for r in tracer.records() if r.name == "verify_service.degrade"
            ]
            return res, stats, events

        res, stats, events = asyncio.run(run())
        assert res == ["local"]
        assert stats["degrades"] == 1
        assert events and "service error" in (
            events[0].to_json()["fields"]["reason"]
        )
    finally:
        svc.stop()


# --- degradation contract ---------------------------------------------------


class LocalZeroVerifier:
    """Local fallback with a distinguishable verdict (all-False)."""

    def verify(self, items):
        return np.zeros(len(items), dtype=bool)


def test_kill_mid_flight_degrades_then_reattaches(tmp_path):
    """A service that dies with submissions in flight degrades them to the
    client's local verifier with a structured event (never a hang, never a
    dropped verdict), and the client re-attaches when the service returns
    on the same socket."""
    gate = GateVerifier()
    svc = service(tmp_path, verifier=gate)
    path = svc.server.path
    tracer = obs.Tracer(enabled=True)

    async def run():
        remote = await connect(path, verifier=LocalZeroVerifier(), tracer=tracer)
        fut = asyncio.ensure_future(remote.submit(sig_items(3), "consensus"))
        deadline = time.monotonic() + 10
        while (
            not svc.server.client_stats
            or not any(s["submissions"] for s in svc.server.client_stats.values())
        ) and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        svc.stop()  # mid-flight: the gate still holds the round
        v = await asyncio.wait_for(fut, 15)
        assert v.tolist() == [False, False, False]  # LOCAL verdicts
        stats1 = remote.ipc_stats()
        # while down, submissions run local without waiting
        v2 = await asyncio.wait_for(remote.submit(sig_items(2), "consensus"), 15)
        assert v2.tolist() == [False, False]
        # service returns on the same socket -> transparent re-attach
        svc2 = ServiceThread(
            path, scheduler=VerifyScheduler(verifier=SigTagVerifier()), device="cpu"
        )
        svc2.start()
        try:
            deadline = time.monotonic() + 15
            while not remote.connected and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
            assert remote.connected, "never re-attached"
            v3 = await asyncio.wait_for(remote.submit(sig_items(2), "consensus"), 15)
            assert v3.tolist() == [True, True]  # REMOTE verdicts again
            stats2 = remote.ipc_stats()
        finally:
            await remote.stop()
            svc2.stop()
        return stats1, stats2

    stats1, stats2 = asyncio.run(run())
    assert stats1["degrades"] == 1 and not stats1["connected"]
    assert stats2["degrades"] == 2
    assert stats2["reconnects"] == 2
    assert stats2["remote_submissions"] > stats1["remote_submissions"]
    events = [
        r.to_json() for r in tracer.records() if r.name == "verify_service.degrade"
    ]
    assert len(events) == 2
    assert events[0]["fields"]["reason"] == "connection lost mid-flight"
    assert events[1]["fields"]["reason"] == "service unreachable"


def test_unreachable_service_runs_local_without_hang(tmp_path):
    path = sock_path(tmp_path, "never-exists.sock")

    async def run():
        remote = RemoteVerifyScheduler(
            path, verifier=LocalZeroVerifier(), retry_base=0.02
        )
        await remote.start()
        v = await asyncio.wait_for(remote.submit(sig_items(4), "consensus"), 10)
        stats = remote.ipc_stats()
        await remote.stop()
        return v, stats

    v, stats = asyncio.run(run())
    assert v.tolist() == [False] * 4
    assert stats["degrades"] == 1 and stats["remote_submissions"] == 0


def test_sync_surface_from_worker_thread(tmp_path):
    """submit_sync / the classed adapter route worker-thread callers over
    the wire; on-loop callers degrade to direct local dispatch like the
    in-proc scheduler."""
    svc = service(tmp_path)
    try:

        async def run():
            remote = await connect(svc.server.path, verifier=LocalZeroVerifier())
            loop = asyncio.get_running_loop()
            classed = remote.classed("evidence")
            v_thread = await loop.run_in_executor(None, classed.verify, sig_items(3))
            # ON the loop thread: must not block the loop -> local path
            v_loop = remote.submit_sync(sig_items(2), "consensus")
            stats = remote.ipc_stats()
            await remote.stop()
            return v_thread, v_loop, stats

        v_thread, v_loop, stats = asyncio.run(run())
        assert v_thread.tolist() == [True] * 3  # remote stub verdicts
        assert v_loop.tolist() == [False] * 2  # local zero verifier
        assert stats["remote_submissions"] == 1
        per_class = svc.server.scheduler.ledger.summary()["per_class"]
        assert "evidence" in per_class
    finally:
        svc.stop()


# --- stats / dump surface ---------------------------------------------------


def test_stats_frame_and_http_surface(tmp_path):
    svc = service(tmp_path, stats_port=0)
    try:
        port = svc.server.stats_port
        assert port and port > 0

        async def run():
            remote = await connect(svc.server.path)
            await remote.submit(sig_items(5), "consensus")
            # raw STATS frame
            reader, writer = await asyncio.open_unix_connection(svc.server.path)
            write_frame(writer, _HDR.pack(MSG_STATS, 42))
            await writer.drain()
            frame = await asyncio.wait_for(read_frame(reader), 10)
            cur = _Cursor(frame)
            typ, req = _HDR.unpack(cur.take(_HDR.size))
            assert (typ, req) == (MSG_STATS_RESULT, 42)
            dump = json.loads(cur.bytes32())
            writer.close()

            # HTTP: /metrics + /dump_dispatch_ledger + 404
            async def http_get(target):
                r, w = await asyncio.open_connection("127.0.0.1", port)
                w.write(f"GET {target} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
                await w.drain()
                data = await asyncio.wait_for(r.read(), 10)
                w.close()
                head, _, body = data.partition(b"\r\n\r\n")
                return head.split(b" ", 2)[1], body

            code_m, metrics_body = await http_get("/metrics")
            code_d, dump_body = await http_get("/dump_dispatch_ledger")
            code_404, _ = await http_get("/nope")
            await remote.stop()
            return dump, code_m, metrics_body, code_d, dump_body, code_404

        dump, code_m, metrics_body, code_d, dump_body, code_404 = asyncio.run(run())
        assert dump["summary"]["rows_requested"] >= 5
        assert dump["per_client"]  # tenant table rides the dump
        assert dump["service"]["pid"] == os.getpid()
        assert code_m == b"200" and b"# TYPE" in metrics_body
        assert code_d == b"200"
        http_dump = json.loads(dump_body)
        assert http_dump["summary"]["rows_requested"] >= 5
        assert code_404 == b"404"
    finally:
        svc.stop()


def test_tenant_table_bounded(tmp_path):
    """A flapping client that never submits leaves no entry; past
    max_client_stats the oldest closed billable rows fold into one
    `_closed` aggregate, so the table stays bounded while no tenant's
    spend leaves the bill."""
    svc = service(tmp_path)
    try:
        svc.server.max_client_stats = 4

        async def run():
            # 5 idle connect/disconnect cycles: no residue
            for _ in range(5):
                reader, writer = await asyncio.open_unix_connection(svc.server.path)
                writer.close()
            await asyncio.sleep(0.2)
            idle_entries = len(svc.server.client_stats)
            # 8 sequential submitting clients: table stays bounded
            for _ in range(8):
                remote = await connect(svc.server.path)
                await remote.submit(sig_items(2), "consensus")
                await remote.stop()
                await asyncio.sleep(0.05)
            await asyncio.sleep(0.2)
            return idle_entries

        idle_entries = asyncio.run(run())
        assert idle_entries == 0
        table = svc.server.client_stats
        assert len(table) <= svc.server.max_client_stats + 2
        agg = table.get("_closed")
        live_rows = sum(v["rows"] for k, v in table.items() if k != "_closed")
        folded = agg["rows"] if agg else 0
        assert live_rows + folded == 16  # 8 clients x 2 rows, all billed
        if agg:
            assert agg["clients"] >= 1
    finally:
        svc.stop()


def _reference_prune():
    from tendermint_tpu.parallel.verify_service import VerifyServiceServer as Ref

    return Ref._prune_client_stats


@pytest.mark.parametrize("lines", ["port", "reference"])
def test_idle_connections_past_the_bound_leave_no_row(tmp_path, lines):
    """Five idle connections open at once, past a bound of 4, then closed:
    the table is empty again, no "_closed" row with nothing in it. The
    reference's `_prune_client_stats` makes that empty row whenever the
    live connections alone pass the bound (the race behind the reference
    test's intermittent idle count), and the row stays."""
    svc = service(tmp_path)
    if lines == "reference":
        svc.server._prune_client_stats = types.MethodType(_reference_prune(), svc.server)
    svc.server.max_client_stats = 4
    try:

        async def run():
            conns = [await asyncio.open_unix_connection(svc.server.path)
                     for _ in range(5)]
            deadline = time.monotonic() + 10
            while (len(svc.server._conn_tasks) < 5
                   and time.monotonic() < deadline):
                await asyncio.sleep(0.01)
            assert len(svc.server._conn_tasks) == 5
            for _, writer in conns:
                writer.close()
            deadline = time.monotonic() + 10
            while svc.server._conn_tasks and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            return dict(svc.server.client_stats)

        table = asyncio.run(run())
    finally:
        svc.stop()
    if lines == "port":
        assert table == {}
    else:
        assert list(table) == ["_closed"] and table["_closed"]["clients"] == 0


# --- chaos: kill/restart the service under a live net -----------------------


@pytest.mark.chaos
def test_chaos_net_survives_service_kill_and_restart(tmp_path):
    """A 4-validator net of the port whose verify plane rides a shared
    service keeps committing when the service is killed mid-net (every
    node degrades to local verify with structured events) and re-attaches
    when it returns."""
    from .torch_chaos_harness import (
        ChaosVerifyService,
        build_chaos_handles,
        start_mesh,
        stop_mesh,
    )

    # the process verifier: the net's votes carry genuine signatures
    chaos_svc = ChaosVerifyService(
        sock_path(tmp_path, "svc.sock"), device="cpu", scheduler=VerifyScheduler()
    )
    chaos_svc.start()
    tracer = obs.Tracer(enabled=True)
    handles = build_chaos_handles(4, device="cpu")

    async def run():
        remote = await connect(chaos_svc.path, verifier=None, tracer=tracer)
        set_default_scheduler(remote)
        try:
            await start_mesh(handles)
            await asyncio.gather(
                *(h.cs.wait_for_height(2, timeout=180) for h in handles)
            )
            sub_before = remote.ipc_stats()["remote_submissions"]
            assert sub_before > 0, "net never verified over the wire"
            # kill mid-net: liveness must not depend on the service
            chaos_svc.kill()
            base = max(h.cs.rs.height for h in handles)
            await asyncio.gather(
                *(h.cs.wait_for_height(base + 2, timeout=90) for h in handles)
            )
            stats_down = remote.ipc_stats()
            # service returns: the clients re-attach and resume
            chaos_svc.restart()
            deadline = time.monotonic() + 30
            while not remote.connected and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            assert remote.connected, "client never re-attached"
            base = max(h.cs.rs.height for h in handles)
            await asyncio.gather(
                *(h.cs.wait_for_height(base + 2, timeout=90) for h in handles)
            )
            stats_up = remote.ipc_stats()
            return stats_down, stats_up
        finally:
            await stop_mesh(handles)
            set_default_scheduler(None)
            await remote.stop()

    try:
        stats_down, stats_up = asyncio.run(run())
    finally:
        chaos_svc.kill()
    assert stats_down["degrades"] > 0, "kill never exercised degrade"
    assert stats_up["reconnects"] >= 2
    assert (
        stats_up["remote_submissions"] > stats_down["remote_submissions"]
    ), "no remote submissions after re-attach"
    events = [r for r in tracer.records() if r.name == "verify_service.degrade"]
    assert events, "degrades left no structured event"


# --- the stop with a client attached ----------------------------------------


def _reference_stop():
    from tendermint_tpu.parallel.verify_service import VerifyServiceServer as Ref

    return Ref.stop


@pytest.mark.parametrize("attached", ["uds", "stats"])
@pytest.mark.parametrize("lines", ["port", "reference"])
def test_stop_with_a_client_attached_ends_inside_5s(tmp_path, lines, attached):
    """A ServiceThread with one raw UDS client attached, or one idle TCP
    connection to its stats port (a prober that sent nothing, its handler
    blocked in readline()), stops inside 5 s and its thread is dead. With
    the reference's `stop` bound onto the same server (which awaits
    wait_closed() before it ends its connections, and since Python 3.12
    that waits for every connection) it is still running 5 s later, and
    ends once the client closes."""
    svc = service(tmp_path, stats_port=0)
    if lines == "reference":
        svc.server.stop = types.MethodType(_reference_stop(), svc.server)
    thread = svc._thread
    if attached == "uds":
        client = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        client.connect(svc.server.path)
    else:
        client = socket.create_connection(("127.0.0.1", svc.server.stats_port))
    try:
        deadline = time.monotonic() + 10
        while not svc.server._conn_tasks and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.server._conn_tasks, "the client was never attached"
        stopper = threading.Thread(target=svc.stop, daemon=True)
        t0 = time.monotonic()
        stopper.start()
        stopper.join(5)
        stopped = not thread.is_alive()
        wall = time.monotonic() - t0
    finally:
        client.close()
    stopper.join(30)
    assert not thread.is_alive()
    if lines == "port":
        assert stopped and wall < 5, wall
        assert not os.path.exists(svc.server.path)
    else:
        assert not stopped, "the reference's stop ended with a client attached"


def test_stop_ends_connections_accepted_just_before_it(tmp_path):
    """A connection the server accepted whose handler has not started yet
    when stop() closes the server still ends: for each number of loop
    passes between the connect and the stop (some land in that window),
    the stop returns inside 5 s."""
    path = sock_path(tmp_path, "race.sock")

    async def once(passes: int) -> bool:
        from tendermint_tpu_torch.parallel.verify_service import (
            VerifyServiceServer,
        )

        server = VerifyServiceServer(
            path, scheduler=VerifyScheduler(verifier=SigTagVerifier()),
            device="cpu", stats_port=0,
        )
        await server.start()
        client = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        client.connect(path)
        prober = socket.create_connection(("127.0.0.1", server.stats_port))
        try:
            for _ in range(passes):
                await asyncio.sleep(0)
            await asyncio.wait_for(server.stop(), 5)
            return True
        except asyncio.TimeoutError:
            return False
        finally:
            client.close()
            prober.close()

    async def run():
        return [await once(k) for k in range(8)]

    assert asyncio.run(run()) == [True] * 8


@pytest.mark.parametrize("lines", ["port", "reference"])
def test_a_late_stop_leaves_a_successors_socket(tmp_path, lines):
    """A service whose stop ends after a successor bound the same path (a
    restart that did not wait for it) leaves the successor's socket file
    in place, and clients still attach to the successor. The reference's
    `stop` unlinks whatever file is at the path."""
    first = service(tmp_path)
    if lines == "reference":
        first.server.stop = types.MethodType(_reference_stop(), first.server)
    second = ServiceThread(first.server.path, scheduler=VerifyScheduler(
        verifier=SigTagVerifier()), device="cpu")
    second.start()  # binds the path anew while the first still runs
    try:
        first.stop()
        kept = os.path.exists(second.server.path)

        async def run():
            remote = await connect(second.server.path)
            v = await remote.submit(sig_items(3, good=lambda i: i != 1), "consensus")
            await remote.stop()
            return v.tolist()

        if lines == "port":
            assert kept and asyncio.run(run()) == [True, False, True]
        else:
            assert not kept, "the reference's stop left the successor's socket"
    finally:
        second.stop()


# --- interop with the JAX package's service and client ----------------------


def _ref():
    from tendermint_tpu.crypto import batch_verifier as ref_bv
    from tendermint_tpu.parallel import scheduler as ref_sched
    from tendermint_tpu.parallel import verify_service as ref_vs

    return ref_bv, ref_sched, ref_vs


def _real_items(item_cls):
    """Three ed25519 rows (one forged) and two secp256k1 rows (one
    forged), seeded; five rows, under min_device_batch."""
    from tendermint_tpu_torch.crypto import ed25519, secp256k1

    rows = []
    for i in range(3):
        pk = ed25519.PrivKey.from_secret(b"interop-ed-%d" % i)
        msg = b"interop-vote-%d" % i + b"\x00" * 16
        sig = pk.sign(msg) if i != 1 else b"\x00" * 64
        rows.append(item_cls(pk.public_key().data, msg, sig))
    for i in range(2):
        pk = secp256k1.PrivKey.from_secret(b"interop-secp-%d" % i)
        msg = b"interop-secp-msg-%d" % i
        sig = pk.sign(msg)
        if i == 1:
            sig = sig[:10] + bytes([sig[10] ^ 1]) + sig[11:]
        rows.append(item_cls(pk.public_key().data, msg, sig, "secp256k1"))
    return rows


def _recover_items():
    import hashlib

    from tendermint_tpu_torch.crypto import secp256k1 as secp

    key = secp.PrivKey.from_secret(b"interop-sequencer")
    digest = hashlib.sha256(b"interop-blockv2").digest()
    return [(digest, secp.eth_sign(digest, key.secret)), (digest, b"\x00" * 65)]


def test_codec_bytes_equal_the_references():
    """Every frame the port encodes is the reference's byte for byte, and
    each package decodes the other's."""
    _, _, ref_vs = _ref()
    from tendermint_tpu.crypto.batch_verifier import SigItem as RefItem

    port_items = _real_items(SigItem) + sig_items(4)
    ref_items = _real_items(RefItem) + sig_items(4, item=RefItem)
    ctx = (12, 3, "node-a")
    assert encode_submit(5, port_items, "consensus", ctx=ctx) == ref_vs.encode_submit(
        5, ref_items, "consensus", ctx=ctx)
    assert encode_submit(6, port_items, "blocksync") == ref_vs.encode_submit(
        6, ref_items, "blocksync")
    verdicts = np.array([True, False, True, True, False, False, True, True, False])
    assert encode_verdicts(7, verdicts) == ref_vs.encode_verdicts(7, verdicts)
    fn_items = _recover_items()
    assert encode_submit_fn(8, "secp_recover", fn_items, "sequencer", ctx=ctx) == (
        ref_vs.encode_submit_fn(8, "secp_recover", fn_items, "sequencer", ctx=ctx))
    results = [True, False, None, b"\x01" * 20]
    assert encode_fn_results(9, results) == ref_vs.encode_fn_results(9, results)
    assert encode_error(10, "boom") == ref_vs.encode_error(10, "boom")
    cur = ref_vs._Cursor(encode_submit(5, port_items, "consensus", ctx=ctx))
    cur.take(_HDR.size)
    got, klass = ref_vs.decode_submit(cur)
    assert klass == "consensus"
    assert [(i.pubkey, i.msg, i.sig, i.key_type) for i in got] == [
        (i.pubkey, i.msg, i.sig, i.key_type) for i in port_items]
    assert ref_vs.decode_trace_ctx(cur, 5) == (12, 3, "node-a", 5)
    assert (ref_vs.MAX_FRAME, ref_vs.DEGRADE_EVENT) == (MAX_FRAME, DEGRADE_EVENT)


async def _in_proc(verifier, items, fn_items):
    sched = VerifyScheduler(verifier=verifier)
    await sched.start()
    try:
        v = await sched.submit(items, "consensus")
        f = await sched.submit_wire_fn("secp_recover", fn_items, "sequencer")
        return np.asarray(v).tolist(), f
    finally:
        await sched.stop()


@pytest.mark.parametrize("direction", ["port-client", "reference-client"])
def test_interop_with_the_reference(tmp_path, direction):
    """A port client against a JAX-package ServiceThread, and a
    JAX-package client against a port ServiceThread: the stub verifier's
    verdicts, one real round of ed25519 and secp256k1 rows (on the host
    oracle, under min_device_batch) and the secp_recover engine come back
    equal to the in-proc scheduler's on the same items."""
    ref_bv, ref_sched, ref_vs = _ref()
    from tendermint_tpu.crypto.batch_verifier import SigItem as RefItem

    port_cpu = bv.BatchVerifier(device="cpu")
    fn_items = _recover_items()
    want_stub = [i % 3 != 1 for i in range(9)]
    want_real, want_fn = asyncio.run(_in_proc(port_cpu, _real_items(SigItem), fn_items))
    assert want_real == [True, False, True, True, False]
    assert want_fn[0] and want_fn[1] == b""

    def ref_service(verifier):
        return ref_vs.ServiceThread(
            sock_path(tmp_path, "ref.sock"),
            scheduler=ref_sched.VerifyScheduler(verifier=verifier))

    def port_service(verifier):
        return ServiceThread(
            sock_path(tmp_path, "port.sock"),
            scheduler=VerifyScheduler(verifier=verifier), device="cpu")

    if direction == "port-client":
        make_service, cls, item = ref_service, RemoteVerifyScheduler, SigItem
        real_verifier = ref_bv.BatchVerifier(min_device_batch=1 << 30)
    else:
        make_service, cls, item = port_service, ref_vs.RemoteVerifyScheduler, RefItem
        real_verifier = port_cpu

    got = {}
    for name, verifier, items in (
        ("stub", SigTagVerifier(), sig_items(9, good=lambda i: i % 3 != 1, item=item)),
        ("real", real_verifier, _real_items(item)),
    ):
        svc = make_service(verifier)
        svc.start()
        try:

            async def run():
                remote = await connect(svc.server.path, cls=cls,
                                       verifier=LocalZeroVerifier())
                v = await remote.submit(items, "consensus")
                f = await remote.submit_wire_fn("secp_recover", fn_items, "sequencer")
                stats = remote.ipc_stats()
                await remote.stop()
                return np.asarray(v).tolist(), f, stats

            got[name] = asyncio.run(run())
        finally:
            svc.stop()
    assert got["stub"][0] == want_stub
    assert got["real"][0] == want_real
    for name in ("stub", "real"):
        assert got[name][1] == want_fn, name
        assert got[name][2]["degrades"] == 0 and got[name][2]["remote_submissions"] == 2


# --- parity: a blocksync window through the service -------------------------


def test_blocksync_window_through_a_port_service_matches_reference(
        tmp_path, monkeypatch):
    """39 commits x 16 validators (624 rows, the big tier), commit 20
    tampered by more than 1/3 of the power: the port's verify_commits_light
    through a RemoteVerifyScheduler to a port service on
    BatchVerifier(device="cpu") and the JAX package's in-proc
    verify_commits_light on its host oracle give the same bitmap."""
    import torch

    from tendermint_tpu.parallel import scheduler as ref_sched

    from .torch_chaos_harness import sign_commit
    from .test_torch_consensus import CHAIN_ID, PORT, REF, make_validators

    monkeypatch.setattr(ref_sched, "_default_scheduler", None)
    ref_verifier = REF.bv.BatchVerifier(min_device_batch=1 << 30)
    window = {}
    for ns in (PORT, REF):
        vs, pvs = make_validators(ns, 16, seed=b"vs-window")
        entries = []
        for h in range(1, 40):
            bid = ns.BlockID(bytes([h]) * 32, ns.PartSetHeader(1, bytes([h]) * 32))
            entries.append((bid, h, sign_commit(vs, pvs, h, 0, bid)))
        for i in range(6):  # 60 of 160: what is left is under 2/3
            entries[19][2].signatures[i].signature = b"\x00" * 64
        window[ns.root] = (vs, entries)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the plain versions are thousands of small ops
    svc = ServiceThread(sock_path(tmp_path), device="cpu")
    seq0 = max((e["seq"] for e in svc.server.scheduler.ledger.entries()), default=-1)
    try:
        assert svc.server.scheduler.verifier.device.type == "cpu"
        svc.start()

        async def run():
            remote = await connect(svc.server.path, verifier=LocalZeroVerifier())
            vs, entries = window[PORT.root]
            got = await asyncio.get_running_loop().run_in_executor(
                None, vs.verify_commits_light, CHAIN_ID, entries,
                remote.classed("blocksync"))
            stats = remote.ipc_stats()
            await remote.stop()
            return got, stats

        got, stats = asyncio.run(run())
    finally:
        svc.stop()
        torch.set_num_threads(threads)
    vs, entries = window[REF.root]
    want = vs.verify_commits_light(CHAIN_ID, entries, verifier=ref_verifier)
    assert want == [True] * 19 + [False] + [True] * 19
    assert got == want
    assert stats["remote_submissions"] == 1 and stats["degrades"] == 0
    rounds = [e for e in svc.server.scheduler.ledger.entries()
              if e["seq"] > seq0 and e["engine"] == "sig"]
    assert [e["requested"] for e in rounds] == [624]  # one round, the big tier
    assert rounds[0]["dispatched"] >= 1024


# --- node assembly, the CLI and the node's tools (A5e) -------------------------


def test_node_assembly_remote_socket(tmp_path):
    """A full Node under `[scheduler] remote_socket` builds the client,
    binds the ipc health seam, commits heights against the shared
    service, and its verify plane answers over the wire."""
    from tendermint_tpu_torch.node.node import init_files

    from .test_torch_node import Node, make_test_config

    # REAL verifier: the node's votes carry genuine signatures and the
    # service must accept them for the net to advance
    svc = service(tmp_path / "svc", verifier=False)
    try:
        cfg = make_test_config(tmp_path / "node")
        cfg.scheduler.remote_socket = svc.server.path
        init_files(cfg)
        node = Node(cfg)
        assert isinstance(node.verify_scheduler, RemoteVerifyScheduler)
        assert (
            node.health_monitor._remote_scheduler
            is node.verify_scheduler
        )

        from tendermint_tpu_torch.crypto import ed25519

        pk = ed25519.PrivKey.from_secret(b"node-remote-e2e")
        msg = b"explicit-item" + b"\x00" * 19
        good = SigItem(pk.public_key().data, msg, pk.sign(msg))
        forged = SigItem(pk.public_key().data, msg, b"\x00" * 64)

        async def run():
            await node.start()
            try:
                await node.consensus.wait_for_height(2, timeout=90)
                v = await asyncio.wait_for(
                    node.verify_scheduler.submit(
                        [good, forged, good], "consensus"
                    ),
                    60,
                )
                stats = node.verify_scheduler.ipc_stats()
            finally:
                await node.stop()
            return v, stats

        v, stats = asyncio.run(run())
        assert v.tolist() == [True, False, True]  # real verdicts, wire
        assert stats["remote_submissions"] >= 1
        assert stats["connected"]
    finally:
        set_default_scheduler(None)
        svc.stop()


def test_health_config_ipc_knob():
    from tendermint_tpu_torch.config.config import HealthConfig
    from tendermint_tpu_torch.obs.health import HealthMonitor

    hc = HealthConfig(ipc_drift_factor=7.0)
    hc.validate_basic()
    mon = HealthMonitor.from_config(hc, stall_ceiling_s=10.0)
    assert mon.ipc_round_trip.drift_factor == 7.0
    with pytest.raises(ValueError):
        HealthConfig(ipc_drift_factor=0.0).validate_basic()


def spawn_service(socket_path: str, max_batch: int, timeout: float = 120.0):
    """`python -m tendermint_tpu_torch --device cpu verify-service` as a
    child process, returned once its readiness line (--ready-fd) arrived
    (the reference's tools/verify_service_bench.py _spawn_service)."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rfd, wfd = os.pipe()
    log_path = socket_path + ".log"
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tendermint_tpu_torch", "--device", "cpu",
             "verify-service", "--socket", socket_path, "--max-batch",
             str(max_batch), "--ready-fd", str(wfd)],
            pass_fds=(wfd,), cwd=root, stderr=log,
        )
    os.close(wfd)
    os.set_blocking(rfd, False)
    ready = b""
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline and not ready:
            try:
                ready = os.read(rfd, 4096)
            except BlockingIOError:
                pass
            if proc.poll() is not None:
                break
            time.sleep(0.05)
    finally:
        os.close(rfd)
    if not ready:
        proc.terminate()
        with open(log_path, "rb") as f:
            tail = f.read()[-2000:].decode(errors="replace")
        raise RuntimeError(f"verify service never signaled ready (rc={proc.poll()}): {tail}")
    return proc


async def service_dump(socket_path: str) -> dict:
    """One STATS frame over the UDS: the service-side ledger summary and
    tenant table."""
    reader, writer = await asyncio.open_unix_connection(socket_path)
    try:
        write_frame(writer, _HDR.pack(MSG_STATS, 1))
        await writer.drain()
        frame = await asyncio.wait_for(read_frame(reader), timeout=30.0)
        cur = _Cursor(frame)
        typ, _ = _HDR.unpack(cur.take(_HDR.size))
        assert typ == MSG_STATS_RESULT, f"unexpected frame {typ}"
        return json.loads(cur.bytes32())
    finally:
        writer.close()


def test_cli_service_process_end_to_end(tmp_path):
    """`python -m tendermint_tpu_torch verify-service` across a REAL
    process boundary: readiness handshake, real ed25519 verdicts over the
    wire, and the service-side dump."""
    from tendermint_tpu_torch.crypto import ed25519

    sock = sock_path(tmp_path, "cli.sock")
    proc = spawn_service(sock, max_batch=256, timeout=120)
    try:

        async def run():
            remote = await connect(sock)
            pk = ed25519.PrivKey.from_secret(b"cli-e2e")
            msg = b"vote-bytes" + b"\x00" * 22
            good = SigItem(pk.public_key().data, msg, pk.sign(msg))
            bad = SigItem(pk.public_key().data, msg, b"\x00" * 64)
            v = await asyncio.wait_for(
                remote.submit([good, bad, good], "consensus"), 240
            )
            dump = await service_dump(sock)
            await remote.stop()
            return v, dump

        v, dump = asyncio.run(run())
        assert v.tolist() == [True, False, True]
        assert dump["summary"]["rows_requested"] >= 3
        assert dump["per_client"]
        assert dump["service"]["pid"] == proc.pid
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_testnet_generator_stamps_remote_socket(tmp_path):
    import socket as socket_mod

    from tendermint_tpu_torch.config import Config
    from tendermint_tpu_torch.tools.testnet_generator import (
        generate_manifest,
        materialize,
    )

    def free_ports(k):
        socks, ports = [], []
        for _ in range(k):
            s = socket_mod.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
        for s in socks:
            s.close()
        return ports

    manifest = generate_manifest(11, n_validators=2)
    layout = materialize(
        manifest,
        str(tmp_path / "net"),
        free_ports,
        verify_service="shared/verify.sock",
    )
    assert layout
    expect = os.path.abspath("shared/verify.sock")
    for spec in layout.values():
        cfg = Config.load(spec["home"])
        assert cfg.scheduler.remote_socket == expect


def test_device_report_renders_tenant_table():
    from tendermint_tpu_torch.tools.device_report import extract_summary, report_text

    dump = {
        "enabled": True,
        "service": {"socket": "/tmp/v.sock", "pid": 1},
        "summary": {
            "rounds": 10,
            "fn_rounds": 2,
            "sharded_rounds": 0,
            "rows_requested": 90,
            "rows_dispatched": 128,
            "padding_rows": 38,
            "fill_ratio_p50": 0.7,
            "fill_ratio_p95": 0.9,
            "requests_per_dispatch": 2.5,
            "device_seconds": 0.5,
            "queue_wait_seconds": 0.1,
            "host_prep_seconds": 0.01,
            "per_class": {
                "consensus": {
                    "rows": 90,
                    "device_seconds": 0.5,
                    "device_share": 1.0,
                    "rounds": 10,
                    "submissions": 25,
                    "queue_wait_seconds": 0.1,
                }
            },
            "by_bucket": {},
        },
        "per_client": {
            "client-1": {
                "submissions": 20,
                "rows": 70,
                "fn_submissions": 2,
                "fn_items": 8,
            },
            "client-2": {
                "submissions": 5,
                "rows": 20,
                "fn_submissions": 0,
                "fn_items": 0,
            },
        },
    }
    summary = extract_summary(dump)
    assert summary["per_client"]
    text = report_text(summary, name="service")
    assert "tenants (2 clients" in text
    assert "client-1" in text and "client-2" in text
    # biggest tenant first
    assert text.index("client-1") < text.index("client-2")


def test_bench_trend_ingests_verify_service_family(tmp_path):
    from tendermint_tpu_torch.tools.bench_trend import (
        TIER1_FAMILIES,
        build_groups,
        check_gate,
        direction_of,
        family_of,
        ingest,
    )

    assert family_of("verify_service_wall_per_height_n32") == (
        "verify_service"
    )
    assert "verify_service" in TIER1_FAMILIES
    assert (
        direction_of("verify_service_wall_per_height_n32", "ms/height")
        == "lower"
    )
    assert (
        direction_of(
            "verify_service_requests_per_dispatch_n32", "submissions"
        )
        == "higher"
    )

    def artifact(round_, wall):
        return {
            "metric": "verify_service_wall_per_height_n32",
            "value": wall,
            "unit": "ms/height",
            "meta": {"backend": "cpu", "device_count": 1},
            "extra_metrics": [
                {
                    "metric": "verify_service_requests_per_dispatch_n32",
                    "value": 3.0,
                    "unit": "submissions per round",
                }
            ],
        }

    p1 = tmp_path / "BENCH_r90.json"
    p2 = tmp_path / "BENCH_r91.json"
    p1.write_text(json.dumps(artifact(90, 1000.0)))
    p2.write_text(json.dumps(artifact(91, 1300.0)))  # 30% worse
    rows, skipped, _ = ingest([str(p1), str(p2)])
    assert not skipped
    groups = build_groups(rows)
    head = next(
        g
        for g in groups
        if g["metric"] == "verify_service_wall_per_height_n32"
    )
    assert head["family"] == "verify_service" and head["headline"]
    failures, _ = check_gate(groups, threshold=0.15)
    assert any(
        f["metric"] == "verify_service_wall_per_height_n32"
        for f in failures
    )
