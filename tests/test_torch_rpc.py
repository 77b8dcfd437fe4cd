"""The port's RPC (``rpc/{core,server,client,light_provider}.py``) and light
proxy (``light/proxy.py``) against the contracts of the reference's tests:
the six RPC tests of ``tests/test_lightserve.py`` (the proof routes and
their pagination, the ``validators`` route's pages past 100, the
``RPCProvider``'s bounded retries with backoff, its fallback to the legacy
routes and their pages, its bound on a hostile total) and, from
``tests/test_rpc_client.py``, the light proxy serving verified data, the
HTTP keep-alive, local and websocket clients (health, dump_health,
dump_dispatch_ledger, an event subscription) and the openapi document
against the route table, here over a hand-built node (the stores of a
driven in-process net, served by ``RPCServer``; the reference drives its
``Node``, which waits for ROADMAP.md item A5e). The contracts run one body
on both packages' roots (the JAX package's as the yardstick); the proxy
also across packages, a LightClient and proxy of one package in front of
the other's server. Beside them, the stops: an ``RPCServer`` and a
``LightProxy`` stop inside 5 s with a keep-alive client attached and with
a connection accepted just before the stop (the port's repaired
``RPCServer.on_stop``; the reference's lines leave the second hanging).
The nodes verify on the port's process verifier on ``device="cpu"`` (host
oracle: 4-row rounds) and the JAX package's on its host oracle.
Tolerance: exact (hashes, JSON).
"""

from __future__ import annotations

import asyncio
import importlib
import os
import re
import socket
import types
from types import SimpleNamespace

import pytest

from .test_torch_consensus import (  # noqa: F401 (cpu_verifier: autouse)
    PORT,
    REF,
    cpu_verifier,
    make_validators,
)
from .test_torch_light import (  # noqa: F401 (ref_host_verifier: a fixture)
    BLOCK_NS,
    CHAIN_ID as LIGHT_CHAIN_ID,
    LP,
    PERIOD,
    T0,
    MockProvider,
    make_chain,
    ref_host_verifier,
)
from .test_torch_lightserve import NS as SERVE, _drive_net, _metrics

ROOTS = [PORT.root, REF.root]


def rpc_ns(root: str) -> SimpleNamespace:
    """The RPC's names of one package, beside its serving plane's."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    client, lp = m("rpc.client"), m("rpc.light_provider")
    return SimpleNamespace(
        root=root,
        serve=SERVE[root],
        light=SERVE[root].light,
        net=SERVE[root].net,
        RPCCore=m("rpc.core").RPCCore,
        RPCError=m("rpc.server").RPCError,
        RPCServer=m("rpc.server").RPCServer,
        HTTPClient=client.HTTPClient,
        LocalClient=client.LocalClient,
        WSClient=client.WSClient,
        RPCClientError=client.RPCClientError,
        lp=lp,
        RPCProvider=lp.RPCProvider,
        LightProxy=m("light.proxy").LightProxy,
        EventBus=m("types.event_bus").EventBus,
        obs=m("obs"),
        HealthMonitor=m("obs.health").HealthMonitor,
        DispatchLedger=m("obs.ledger").DispatchLedger,
        openapi=os.path.join(os.path.dirname(m("rpc").__file__), "openapi.yaml"),
    )


NS = {root: rpc_ns(root) for root in ROOTS}
RP = NS[PORT.root]


@pytest.fixture(params=ROOTS, ids=["port", "ref"])
def r(request):
    """One package's RPC namespace; for the JAX package its process
    verifier on its host oracle and no default scheduler."""
    if request.param == REF.root:
        request.getfixturevalue("ref_host_verifier")
    return NS[request.param]


# --- rpc routes (tests/test_lightserve.py) -----------------------------------


def _fake_node(r, bs, ss, chain_id="test-chain"):
    plane = r.serve.LightServePlane(bs, ss, chain_id, metrics=_metrics(r.serve))
    return types.SimpleNamespace(
        block_store=bs,
        state_store=ss,
        lightserve=plane,
        config=types.SimpleNamespace(rpc=types.SimpleNamespace(unsafe=False)),
    )


def test_rpc_proof_routes_and_pagination(r):
    async def run():
        _cs, _app, _l2, bs, ss = await _drive_net(r.serve, 4)
        core = r.RPCCore(_fake_node(r, bs, ss))
        routes = core.routes()
        for name in ("light_block", "signed_header", "validator_set"):
            assert name in routes
        h = bs.height - 1
        res = core.light_block(height=h)
        lb = res["light_block"]
        assert lb["signed_header"]["header"]["height"] == h
        assert lb["signed_header"]["commit"]["height"] == h
        assert lb["validator_set"]["total"] == 1
        sh = core.signed_header(height=h)
        assert sh["signed_header"]["header"]["height"] == h
        vs = core.validator_set(height=h)
        assert vs["total"] == 1 and len(vs["validators"]) == 1
        # the second fetch of the same height is a cache hit
        assert core.node.lightserve.cache.hits >= 1
        # a route-less node serves no proof routes
        core2 = r.RPCCore(types.SimpleNamespace(
            lightserve=None,
            config=types.SimpleNamespace(rpc=types.SimpleNamespace(unsafe=False)),
        ))
        assert "light_block" not in core2.routes()
        # pagination contract on the legacy validators route
        with pytest.raises(r.RPCError):
            core.validators(height=h, page=99)

    asyncio.run(run())


def test_validators_route_paginates_large_sets(r):
    """>100 validators arrive across pages, never silently truncated."""
    vs, _pvs = make_validators(r.net, 130)

    class _SS:
        def load_validators(self, h):
            return vs

    node = types.SimpleNamespace(
        block_store=types.SimpleNamespace(height=5),
        state_store=_SS(),
        lightserve=None,
        config=types.SimpleNamespace(rpc=types.SimpleNamespace(unsafe=False)),
    )
    core = r.RPCCore(node)
    p1 = core.validators(height=5)
    assert p1["total"] == 130 and p1["count"] == 100 and p1["page"] == 1
    p2 = core.validators(height=5, page=2)
    assert p2["count"] == 30
    addrs = {v["address"] for v in p1["validators"] + p2["validators"]}
    assert len(addrs) == 130


# --- the rpc provider (tests/test_lightserve.py) -----------------------------


class _ScriptedClient:
    """Stub RPCClient: pops scripted (method -> outcome) responses."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = []

    async def call(self, method, **params):
        self.calls.append((method, params))
        for i, (m, outcome) in enumerate(self.script):
            if m == method:
                self.script.pop(i)
                if isinstance(outcome, BaseException):
                    raise outcome
                return outcome
        raise AssertionError(f"unscripted call {method}")

    async def close(self):
        pass


def _rpc_provider(r, script, **kw):
    sleeps = []

    async def fake_sleep(s):
        sleeps.append(s)

    p = r.RPCProvider("test-chain", "127.0.0.1:1", sleep=fake_sleep, **kw)
    p.client = _ScriptedClient(script)
    return p, sleeps


def _light_block_json(r, h=3, n_vals=4):
    """A consistent light_block RPC payload built from a signed chain."""
    chain = make_chain(h, n_vals=n_vals, ns=r.light)
    lb = chain[h - 1]
    core = r.RPCCore.__new__(r.RPCCore)  # json helpers only
    return {
        "light_block": {
            "signed_header": {
                "header": core._header_json(lb.header),
                "commit": core._commit_json(lb.commit),
            },
            "validator_set": {
                "validators": [core._validator_json(v) for v in lb.validators.validators],
                "total": lb.validators.size(),
            },
        }
    }, lb


def test_provider_retries_transient_failures_with_backoff(r):
    payload, lb = _light_block_json(r)

    async def run():
        p, sleeps = _rpc_provider(r, [
            ("light_block", ConnectionError("conn reset")),
            ("light_block", ConnectionError("conn reset")),
            ("light_block", payload),
        ])
        got = await p.light_block(3)
        assert got is not None and got.height == 3
        assert got.header.hash() == lb.header.hash()
        got.validate_basic("light-chain")
        assert p.retries == 2
        # exponential: second sleep doubles the first
        assert len(sleeps) == 2 and sleeps[1] == 2 * sleeps[0]

    asyncio.run(run())


def test_provider_gives_up_after_bounded_retries(r):
    async def run():
        p, sleeps = _rpc_provider(r, [("light_block", ConnectionError("down"))] * 5,
                                  max_retries=3)
        assert await p.light_block(3) is None
        assert len(sleeps) == 2  # 3 attempts -> 2 backoffs
        # a server dying mid-response body also reports "no block"
        p2, _ = _rpc_provider(
            r, [("light_block", asyncio.IncompleteReadError(b"partial", 100))] * 5,
            max_retries=3)
        assert await p2.light_block(3) is None

    asyncio.run(run())


def test_provider_falls_back_and_paginates_legacy_servers(r):
    """-32601 latches the legacy path; >100 validators fetched across
    pages and reassembled into a set that re-hashes correctly."""
    n_vals = 130
    chain = make_chain(2, n_vals=n_vals, ns=r.light)
    lb = chain[1]
    core = r.RPCCore.__new__(r.RPCCore)
    rows = [core._validator_json(v) for v in lb.validators.validators]
    commit_payload = {"signed_header": {"header": core._header_json(lb.header),
                                        "commit": core._commit_json(lb.commit)}}

    async def run():
        p, _sleeps = _rpc_provider(r, [
            ("light_block", r.RPCClientError(-32601, "not found")),
            ("commit", commit_payload),
            ("validators", {"validators": rows[:100], "total": n_vals}),
            ("validators", {"validators": rows[100:], "total": n_vals}),
        ])
        got = await p.light_block(2)
        assert got is not None
        assert got.validators.size() == n_vals
        got.validate_basic("light-chain")  # validators_hash matches
        assert p._has_light_block is False
        pages = [params for (m, params) in p.client.calls if m == "validators"]
        assert [pg["page"] for pg in pages] == [1, 2]

    asyncio.run(run())


def test_provider_bounds_hostile_validator_pagination(r):
    """Providers are untrusted: a malicious total must cost a bounded
    number of round trips, not a billion."""
    async def run():
        p, _ = _rpc_provider(r, [("validators", {"validators": [{"x": 1}], "total": 10**9})]
                             * 10_000)
        rows = await p._fetch_validator_rows(2)
        max_pages = -(-r.lp._VALS_MAX // r.lp._VALS_PAGE)
        assert len(p.client.calls) <= max_pages
        assert len(rows) <= max_pages

    asyncio.run(run())


# --- a hand-built node served over RPC (tests/test_rpc_client.py) ------------


async def _served_node(r, heights: int = 4):
    """An in-process net of `r`'s package driven to `heights`, its first
    node's stores, consensus, app and keys as a node namespace with a
    serving plane, a health monitor, a ledger-backed scheduler stand-in and
    an event bus, served by a started RPCServer on 127.0.0.1."""
    cs, app, _l2, bs, ss = await _drive_net(r.serve, heights)
    tracer = r.obs.Tracer(enabled=True)
    ledger = r.DispatchLedger()
    ledger.record_round(1.0, class_rows={"consensus": 3}, requested=3, dispatched=8,
                        device_s=0.001)
    node = types.SimpleNamespace(
        node_key=types.SimpleNamespace(id="a" * 40),
        _listen_addr=lambda: "127.0.0.1:26656",
        genesis=types.SimpleNamespace(chain_id=cs.state.chain_id),
        config=types.SimpleNamespace(base=types.SimpleNamespace(moniker="rpc-test"),
                                     rpc=types.SimpleNamespace(unsafe=False)),
        priv_validator=cs.priv_validator,
        consensus=cs,
        block_store=bs,
        state_store=ss,
        app=app,
        lightserve=r.serve.LightServePlane(bs, ss, cs.state.chain_id,
                                           metrics=_metrics(r.serve)),
        health_monitor=r.HealthMonitor(tracer=tracer),
        verify_scheduler=types.SimpleNamespace(ledger=ledger),
        event_bus=r.EventBus(),
        tracer=tracer,
    )
    server = r.RPCServer(node, port=0)
    await server.start()
    return node, server, f"127.0.0.1:{server.port}"


def test_http_ws_local_clients(r):
    async def run():
        node, server, addr = await _served_node(r)
        try:
            # --- HTTP keep-alive: several calls on one connection
            http = r.HTTPClient(addr)
            status = await http.status()
            assert int(status["sync_info"]["latest_block_height"]) >= 3
            block = await http.block(height=2)
            assert block["block"]["header"]["height"] == 2
            assert block["block_id"]["hash"] == node.block_store.load_block(2).hash().hex().upper()
            commit = await http.commit(height=2)
            assert commit["signed_header"]["commit"]["height"] == 2
            vals = await http.validators(height=2)
            assert vals["count"] >= 1
            with pytest.raises(r.RPCClientError):
                await http.call("nope_not_a_route")
            await http.close()

            # --- local client: same surface, no socket
            local = r.LocalClient(node)
            st2 = await local.status()
            assert st2["node_info"]["id"] == status["node_info"]["id"]

            # --- websocket: rpc over ws + event subscription
            ws = r.WSClient(addr)
            await ws.connect()
            h = await ws.call("health")
            assert h["node_id"] == status["node_info"]["id"]
            assert int(h["latest_block_height"]) >= 3
            assert h["monitored"] is True and h["status"] == "ok"
            dump = await ws.call("dump_health")
            assert dump["enabled"] is True
            assert "quorum_lag" in dump["subsystems"]["consensus"]["detectors"]
            led = await ws.call("dump_dispatch_ledger")
            assert led["enabled"] is True
            assert led["summary"]["rounds"] == 1
            assert "per_class" in led["summary"] and "fill_ratio_p50" in led["summary"]
            assert "device_dispatch_count" in led["shape_registry"]
            assert isinstance(led["entries"], list) and len(led["entries"]) == 1
            events = await ws.subscribe("tm.event = 'NewBlock'")
            await node.event_bus.publish_new_block(node.block_store.load_block(2))
            ev = await asyncio.wait_for(events.__anext__(), 30)
            assert ev["query"] == "tm.event = 'NewBlock'"
            assert int(ev["data"]["value"]["header"]["height"]) == 2
            await ws.unsubscribe("tm.event = 'NewBlock'")
            await ws.close()
        finally:
            await asyncio.wait_for(server.stop(), 5)

    asyncio.run(run())


@pytest.mark.parametrize("server_root,client_root", [
    (PORT.root, PORT.root), (REF.root, REF.root), (REF.root, PORT.root), (PORT.root, REF.root),
], ids=["port", "ref", "port-proxy-ref-node", "ref-proxy-port-node"])
def test_light_proxy_serves_verified_data(server_root, client_root, request):
    """LightProxy: /commit and /validators come from the light client's
    verification, /block is forwarded and its header re-hashed against the
    verified one, /abci_query forwards (reference light/proxy/routes.go);
    a proxy of one package in front of the other's node as well."""
    if REF.root in (server_root, client_root):
        request.getfixturevalue("ref_host_verifier")
    s, c = NS[server_root], NS[client_root]

    async def run():
        node, server, addr = await _served_node(s)
        try:
            chain_id = node.genesis.chain_id
            tip = node.block_store.load_block(node.block_store.height).header
            root_hash = node.block_store.load_block(1).hash()
            lc = c.light.LightClient(
                chain_id, c.light.TrustOptions(3600 * 10**9, 1, root_hash),
                c.RPCProvider(chain_id, addr), [c.RPCProvider(chain_id, addr)],
                c.light.LightStore(c.light.MemKV()),
                now_ns=lambda: tip.time_ns + 10**9,
            )
            proxy = c.LightProxy(lc, addr, listen_port=0)
            await proxy.start()
            pc = c.HTTPClient(f"127.0.0.1:{proxy.listen_port}")
            try:
                want = node.block_store.load_block(2).header
                commit = await pc.commit(height=2)
                assert commit["canonical"] is True
                hdr = commit["signed_header"]["header"]
                assert hdr["height"] == 2
                assert hdr["app_hash"] == want.app_hash.hex().upper()
                assert hdr["validators_hash"] == want.validators_hash.hex().upper()
                assert commit["signed_header"]["commit"]["block_id"]["hash"] == \
                    want.hash().hex().upper()
                vals = await pc.validators(height=2)
                assert vals["count"] >= 1
                assert [v["address"] for v in vals["validators"]] == [
                    v.address.hex().upper()
                    for v in node.state_store.load_validators(2).validators]
                blk = await pc.block(height=2)
                assert blk["block"]["header"]["height"] == 2
                assert blk["block"]["header"]["hash"] == want.hash().hex().upper()
                st = await pc.status()
                assert st["sync_info"]["latest_block_height"] >= 2
                q = await pc.abci_query("/key", b"no-such-key".hex())
                assert q["response"]["value"] == ""
                assert sorted(lc.store.heights())[-1] >= 2
            finally:
                await pc.close()
                await asyncio.wait_for(proxy.stop(), 5)
        finally:
            await asyncio.wait_for(server.stop(), 5)

    asyncio.run(run())


def test_openapi_doc_matches_route_table():
    """rpc/openapi.yaml must list exactly the live route table (the port's
    document against the port's table), and both packages' tables are the
    same."""
    class _N:
        lightserve = object()
        profiler = object()

        class config:
            class rpc:
                unsafe = True

    tables = {}
    for root, ns in NS.items():
        live = set(ns.RPCCore(_N()).routes())
        with open(ns.openapi) as f:
            doc = set(re.findall(r"^\s+- ([a-z_]+)\s+#", f.read(), re.M))
        assert live == doc, (root, sorted(live - doc), sorted(doc - live))
        tables[root] = live
    assert tables[PORT.root] == tables[REF.root]


# --- stops with clients attached ----------------------------------------------


def _bare_node():
    return types.SimpleNamespace(
        config=types.SimpleNamespace(rpc=types.SimpleNamespace(unsafe=False)))


def _reference_on_stop():
    from tendermint_tpu.rpc.server import RPCServer as Ref

    return Ref.on_stop


async def _stop_within(service, bound: float) -> bool:
    try:
        await asyncio.wait_for(service.stop(), bound)
        return True
    except asyncio.TimeoutError:
        return False


def test_rpc_server_stops_with_a_keepalive_client_attached():
    """An RPCServer with a keep-alive HTTP client attached (its
    connection idle after a call) stops inside 5 s, and the client's next
    call fails: the connection ended with the server."""
    async def run():
        server = RP.RPCServer(_bare_node(), port=0)
        await server.start()
        client = RP.HTTPClient(f"127.0.0.1:{server.port}")
        assert "health" in (await client.call("help"))["routes"]
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        stopped = await _stop_within(server, 5)
        wall = loop.time() - t0
        with pytest.raises(Exception):
            await asyncio.wait_for(client.call("help"), 5)
        await client.close()
        return stopped, wall

    stopped, wall = asyncio.run(run())
    assert stopped and wall < 5, wall


@pytest.mark.parametrize("lines", ["port", "reference"])
def test_rpc_server_stop_ends_connections_accepted_just_before_it(lines):
    """A connection the server accepted whose handler has not started yet
    when stop() closes the server still ends: for each number of loop
    passes between the connect and the stop (some land in that window)
    the port's stop returns inside 5 s. With the reference's on_stop,
    which closes the writers it knows once, at least one of them does not
    end (bounded at 2 s here)."""
    async def once(passes: int) -> bool:
        server = RP.RPCServer(_bare_node(), port=0)
        if lines == "reference":
            server.on_stop = types.MethodType(_reference_on_stop(), server)
        await server.start()
        client = socket.create_connection(("127.0.0.1", server.port))
        try:
            for _ in range(passes):
                await asyncio.sleep(0)
            return await _stop_within(server, 5 if lines == "port" else 2)
        finally:
            client.close()

    async def run():
        return [await once(k) for k in range(8)]

    ended = asyncio.run(run())
    if lines == "port":
        assert ended == [True] * 8, ended
    else:
        assert not all(ended), "the reference's stop ended every early connection"


def _proxy():
    chain = make_chain(3, ns=LP)
    lc = LP.LightClient(
        LIGHT_CHAIN_ID, LP.TrustOptions(PERIOD, 1, chain[0].header.hash()),
        MockProvider(chain), [MockProvider(chain, name="w")], LP.LightStore(LP.MemKV()),
        now_ns=lambda: T0 + 10 * BLOCK_NS,
    )
    return RP.LightProxy(lc, "127.0.0.1:1", listen_port=0)


def test_light_proxy_stops_with_clients_attached():
    """A LightProxy stops inside 5 s with a keep-alive client attached
    after a verified call, and with a connection it accepted just before
    the stop, for each number of loop passes between the two."""
    async def attached():
        proxy = _proxy()
        await proxy.start()
        client = RP.HTTPClient(f"127.0.0.1:{proxy.listen_port}")
        got = await client.commit(height=2)
        assert got["signed_header"]["header"]["height"] == 2
        stopped = await _stop_within(proxy, 5)
        await client.close()
        return stopped

    async def early(passes: int) -> bool:
        proxy = _proxy()
        await proxy.start()
        client = socket.create_connection(("127.0.0.1", proxy.listen_port))
        try:
            for _ in range(passes):
                await asyncio.sleep(0)
            return await _stop_within(proxy, 5)
        finally:
            client.close()

    async def run():
        return await attached(), [await early(k) for k in range(8)]

    assert asyncio.run(run()) == (True, [True] * 8)
