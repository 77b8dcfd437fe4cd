"""The port's p2p stack against the contract of ``tests/test_p2p.py``: the
secret connection (handshake, data, tampering, the ephemeral-key MITM),
``MConnection`` multiplexing and send-rate throttling, the switch
(routing, wrong network, wrong ID), the address book, PEX and the trust
metric. Each contract test runs on both packages' roots with one body.

Beside them, parity with the JAX package, on inputs made from a seed with
numpy: the same key, nonce and plaintext give the same ciphertext and tag
from both packages' ``aead`` (the port's native library and its pure-Python
RFC 8439 path too); the same scalars give the same ``x25519`` keys and
secrets; a port ``SecretConnection`` handshakes with a reference one over
a localhost socket and data passes both ways; a port ``MConnection`` talks
to a reference one. Tolerance: exact (bytes).
"""

from __future__ import annotations

import asyncio
import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

PORT_ROOT = "tendermint_tpu_torch"
REF_ROOT = "tendermint_tpu"
ROOTS = pytest.mark.parametrize("root", [PORT_ROOT, REF_ROOT], ids=["port", "ref"])
NETWORK = "p2p-test-chain"


def p2p(root: str) -> SimpleNamespace:
    """The p2p classes and modules of one package."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    mconn = m("p2p.mconn")
    transport = m("p2p.transport")
    switch = m("p2p.switch")
    return SimpleNamespace(
        aead=m("crypto.aead"),
        ed25519=m("crypto.ed25519"),
        x25519=m("crypto.x25519"),
        sc=m("p2p.secret_connection"),
        SecretConnection=m("p2p.secret_connection").SecretConnection,
        ChannelDescriptor=mconn.ChannelDescriptor,
        MConnection=mconn.MConnection,
        NodeKey=m("p2p.key").NodeKey,
        NodeInfo=m("p2p.node_info").NodeInfo,
        AddrBook=m("p2p.addrbook").AddrBook,
        PEXReactor=m("p2p.pex").PEXReactor,
        trust=m("p2p.trust"),
        Reactor=switch.Reactor,
        Switch=switch.Switch,
        MultiplexTransport=transport.MultiplexTransport,
        NetAddress=transport.NetAddress,
    )


PORT = p2p(PORT_ROOT)
REF = p2p(REF_ROOT)


async def _pipe_pair():
    """Two connected (reader, writer) pairs over localhost TCP."""
    accepted = asyncio.Queue()

    async def on_conn(r, w):
        await accepted.put((r, w))

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    r1, w1 = await asyncio.open_connection("127.0.0.1", port)
    r2, w2 = await accepted.get()
    return (r1, w1), (r2, w2), server


async def _secret_pair(ns1, ns2, k1=None, k2=None):
    """A SecretConnection of package ns1 facing one of package ns2."""
    (r1, w1), (r2, w2), server = await _pipe_pair()
    k1 = k1 or ns1.ed25519.PrivKey.generate()
    k2 = k2 or ns2.ed25519.PrivKey.generate()
    c1, c2 = await asyncio.gather(
        ns1.SecretConnection.make(r1, w1, k1),
        ns2.SecretConnection.make(r2, w2, k2),
    )
    return c1, c2, k1, k2, (w1, w2), server


# --- the contract of tests/test_p2p.py --------------------------------------


@ROOTS
def test_secret_connection_handshake_and_data(root):
    ns = p2p(root)

    async def run():
        c1, c2, k1, k2, _, server = await _secret_pair(ns, ns)
        assert c1.remote_pubkey.data == k2.public_key().data
        assert c2.remote_pubkey.data == k1.public_key().data
        await c1.write(b"hello")
        assert await c2.read_exactly(5) == b"hello"
        big = bytes(range(256)) * 20  # 5120 bytes -> 6 frames
        await c2.write(big)
        assert await c1.read_exactly(len(big)) == big
        c1.close(); c2.close(); server.close()

    asyncio.run(run())


@ROOTS
def test_secret_connection_rejects_tampering(root):
    ns = p2p(root)

    async def run():
        c1, c2, _, _, (w1, _), server = await _secret_pair(ns, ns)
        # a corrupted frame injected directly into the raw socket
        w1.write(b"\x00" * ns.sc.SEALED_FRAME_SIZE)
        await w1.drain()
        with pytest.raises(ValueError):
            await c2.read()
        c1.close(); c2.close(); server.close()

    asyncio.run(run())


@ROOTS
def test_secretconn_mitm_eph_substitution_fails(root):
    """Ephemeral-key-substitution MITM: the attacker completes a DH with
    each side on its own ephemeral keys, holds both legs' keys and
    re-encrypts the auth payloads across legs. Both honest sides reject:
    the relayed signature covers the other leg's challenge."""
    ns = p2p(root)
    sc, x25519, aead = ns.sc, ns.x25519, ns.aead

    async def run():
        (ra_a, wa_a), (ra_m, wa_m), srv_a = await _pipe_pair()
        (rb_m, wb_m), (rb_b, wb_b), srv_b = await _pipe_pair()
        ka, kb = ns.ed25519.PrivKey.generate(), ns.ed25519.PrivKey.generate()

        def leg_keys(e_priv, e_pub, peer_eph):
            s = x25519.shared_secret(e_priv, peer_eph)
            lo, hi = sorted([e_pub, peer_eph])
            m = sc._hkdf_sha256(s + lo + hi, sc.HKDF_INFO, 96)
            ka_, kb_ = m[:32], m[32:64]
            # the attacker's send key toward a side mirrors its recv key
            return (kb_, ka_) if peer_eph == lo else (ka_, kb_)

        async def mitm():
            e1_priv, e1_pub = x25519.generate_keypair()
            a_eph = await ra_m.readexactly(32)
            wa_m.write(e1_pub)
            await wa_m.drain()
            m_send1, m_recv1 = leg_keys(e1_priv, e1_pub, a_eph)
            e2_priv, e2_pub = x25519.generate_keypair()
            wb_m.write(e2_pub)
            await wb_m.drain()
            b_eph = await rb_m.readexactly(32)
            m_send2, m_recv2 = leg_keys(e2_priv, e2_pub, b_eph)

            async def relay(r, w, recv_key, send_key):
                rn, sn = sc._Nonce(), sc._Nonce()
                try:
                    while True:
                        sealed = await r.readexactly(sc.SEALED_FRAME_SIZE)
                        frame = aead.open_(recv_key, rn.use(), sealed)
                        w.write(aead.seal(send_key, sn.use(), frame))
                        await w.drain()
                except (asyncio.IncompleteReadError, ConnectionError):
                    pass

            await asyncio.gather(
                relay(ra_m, wb_m, m_recv1, m_send2),
                relay(rb_m, wa_m, m_recv2, m_send1),
                return_exceptions=True,
            )

        mt = asyncio.create_task(mitm())
        results = await asyncio.gather(
            ns.SecretConnection.make(ra_a, wa_a, ka),
            ns.SecretConnection.make(rb_b, wb_b, kb),
            return_exceptions=True,
        )
        mt.cancel()
        srv_a.close(); srv_b.close()
        return results

    for r in asyncio.run(run()):
        assert isinstance(r, ValueError), f"MITM not detected: {r!r}"
        assert "challenge auth failed" in str(r)


@ROOTS
def test_mconn_multiplexing_priorities(root):
    ns = p2p(root)

    async def run():
        c1, c2, _, _, _, server = await _secret_pair(ns, ns)
        got = asyncio.Queue()

        async def on_recv(ch, msg):
            await got.put((ch, msg))

        descs = [
            ns.ChannelDescriptor(id=0x20, priority=5),
            ns.ChannelDescriptor(id=0x21, priority=10),
        ]
        m1 = ns.MConnection(c1, descs, lambda ch, m: asyncio.sleep(0))
        m2 = ns.MConnection(c2, descs, on_recv)
        m1.start(); m2.start()
        big = b"B" * 5000  # multi-packet reassembly
        assert m1.send(0x20, b"small")
        assert m1.send(0x21, big)
        seen = {}
        for _ in range(2):
            ch, msg = await asyncio.wait_for(got.get(), 5)
            seen[ch] = msg
        assert seen[0x20] == b"small"
        assert seen[0x21] == big
        await m1.stop(); await m2.stop(); server.close()

    asyncio.run(run())


@ROOTS
def test_mconn_send_rate_throttling(root):
    """send_rate caps sustained throughput: ~3x the per-second budget takes
    measurably longer than an unthrottled send (the reference's bounds)."""
    ns = p2p(root)

    async def run():
        c1, c2, _, _, _, server = await _secret_pair(ns, ns)
        got = asyncio.Queue()

        async def on_recv(ch, msg):
            await got.put(msg)

        descs = [ns.ChannelDescriptor(id=0x20)]
        m1 = ns.MConnection(c1, descs, lambda ch, m: asyncio.sleep(0),
                            send_rate=20000)
        m2 = ns.MConnection(c2, descs, on_recv, recv_rate=0)
        m1.start(); m2.start()
        # 60 KB at 20 kB/s: the one-window burst (20 KB) goes at once, the
        # other 40 KB take >= ~2 s
        payload = b"T" * 60000
        t0 = time.monotonic()
        assert m1.send(0x20, payload)
        msg = await asyncio.wait_for(got.get(), 15)
        elapsed = time.monotonic() - t0
        assert msg == payload
        assert elapsed > 1.0, f"send not throttled ({elapsed:.2f}s)"
        st = m1.send_monitor.status()
        assert st.bytes_total >= len(payload)
        assert st.bytes_total <= 20000 * (elapsed + 1.5) + 20000
        await m1.stop(); await m2.stop(); server.close()

    asyncio.run(run())


def _make_switch(ns, name: str, reactors=None, network=NETWORK):
    nk = ns.NodeKey.generate()
    transport = None
    sw = None

    def node_info():
        return ns.NodeInfo(
            node_id=nk.id,
            listen_addr=f"127.0.0.1:{transport.listen_port}",
            network=network,
            moniker=name,
            channels=sw.channels() if sw else b"",
        )

    transport = ns.MultiplexTransport(nk, node_info)
    sw = ns.Switch(transport)
    for rname, r in (reactors or {}).items():
        sw.add_reactor(rname, r)
    return nk, transport, sw


def _echo_reactor(ns):
    class EchoReactor(ns.Reactor):
        CH = 0x31

        def __init__(self):
            super().__init__("echo")
            self.received = asyncio.Queue()

        def get_channels(self):
            return [ns.ChannelDescriptor(id=self.CH)]

        async def receive(self, channel_id, peer, msg):
            await self.received.put((peer.id, msg))

    return EchoReactor()


@ROOTS
def test_switch_connect_and_route(root):
    ns = p2p(root)

    async def run():
        e1, e2 = _echo_reactor(ns), _echo_reactor(ns)
        nk1, t1, sw1 = _make_switch(ns, "n1", {"echo": e1})
        nk2, t2, sw2 = _make_switch(ns, "n2", {"echo": e2})
        await t1.listen(); await t2.listen()
        await sw1.start(); await sw2.start()
        peer = await sw1.dial_peer(ns.NetAddress(nk2.id, "127.0.0.1", t2.listen_port))
        assert peer is not None
        for _ in range(50):  # the inbound side registers asynchronously
            if sw2.num_peers() == 1:
                break
            await asyncio.sleep(0.05)
        assert sw2.num_peers() == 1
        assert peer.send(e1.CH, b"ping over channel")
        pid, msg = await asyncio.wait_for(e2.received.get(), 5)
        assert pid == nk1.id and msg == b"ping over channel"
        sw2.broadcast(e1.CH, b"bcast")
        pid, msg = await asyncio.wait_for(e1.received.get(), 5)
        assert msg == b"bcast"
        await sw1.stop(); await sw2.stop()

    asyncio.run(run())


@ROOTS
def test_switch_rejects_wrong_network(root):
    ns = p2p(root)

    async def run():
        nk1, t1, sw1 = _make_switch(ns, "n1", network="chain-A")
        nk2, t2, sw2 = _make_switch(ns, "n2", network="chain-B")
        await t1.listen(); await t2.listen()
        await sw1.start(); await sw2.start()
        with pytest.raises(ValueError, match="network"):
            await sw1.dial_peer(ns.NetAddress(nk2.id, "127.0.0.1", t2.listen_port))
        assert sw1.num_peers() == 0
        await sw1.stop(); await sw2.stop()

    asyncio.run(run())


@ROOTS
def test_switch_detects_id_mismatch(root):
    ns = p2p(root)

    async def run():
        nk1, t1, sw1 = _make_switch(ns, "n1")
        nk2, t2, sw2 = _make_switch(ns, "n2")
        await t1.listen(); await t2.listen()
        await sw1.start(); await sw2.start()
        wrong_id = ns.NodeKey.generate().id
        with pytest.raises(ValueError, match="authenticated"):
            await sw1.dial_peer(ns.NetAddress(wrong_id, "127.0.0.1", t2.listen_port))
        await sw1.stop(); await sw2.stop()

    asyncio.run(run())


@ROOTS
def test_addrbook_persistence(root, tmp_path):
    ns = p2p(root)
    path = str(tmp_path / "addrbook.json")
    book = ns.AddrBook(path, our_id="f" * 40)
    a1 = ns.NetAddress("a" * 40, "10.0.0.1", 26656)
    a2 = ns.NetAddress("b" * 40, "10.0.0.2", 26656)
    assert book.add_address(a1)
    assert not book.add_address(a1)  # dup
    assert book.add_address(a2)
    assert not book.add_address(ns.NetAddress("f" * 40, "1.1.1.1", 1))  # self
    book.mark_good(a1.id)
    book.mark_attempt(a2.id)
    book.save()
    book2 = ns.AddrBook(path, our_id="f" * 40)
    assert book2.size() == 2
    assert book2.pick_address(exclude=set()) is not None
    assert len(book2.get_selection()) == 2


@ROOTS
def test_pex_gossip_discovers_peers(root):
    """n3 knows only n1; n1 knows n2; PEX spreads the addresses until n3
    connects to n2 as well."""
    ns = p2p(root)

    async def run():
        books = [ns.AddrBook() for _ in range(3)]
        pexes = [ns.PEXReactor(books[i], target_outbound=5) for i in range(3)]
        nodes = [_make_switch(ns, f"n{i}", {"pex": pexes[i]}) for i in range(3)]
        for i, (nk, t, sw) in enumerate(nodes):
            books[i]._our_id = nk.id
            await t.listen()
            await sw.start()
        (nk1, t1, sw1), (nk2, t2, sw2), (nk3, t3, sw3) = nodes
        books[0].add_address(ns.NetAddress(nk2.id, "127.0.0.1", t2.listen_port))
        books[2].add_address(ns.NetAddress(nk1.id, "127.0.0.1", t1.listen_port))
        for _ in range(100):
            if nk2.id in sw3.peers:
                break
            await asyncio.sleep(0.1)
        assert nk2.id in sw3.peers, "pex did not propagate n2's address to n3"
        for _, _, sw in nodes:
            await sw.stop()

    asyncio.run(run())


@ROOTS
def test_addrbook_hashed_buckets_and_promotion(root, tmp_path):
    """Hashed buckets: placement by keyed hash, mark_good promotes new to
    old, old entries survive floods, and the book round-trips through
    disk."""
    ns = p2p(root)
    path = str(tmp_path / "addrbook.json")
    book = ns.AddrBook(path, our_id="f" * 40)

    def addr(i, host="10.%d.%d.1"):
        nid = "%040x" % i
        return ns.NetAddress.parse(f"{nid}@{host % (i % 250, i % 200)}:26656")

    src = addr(9999, host="172.16.%d.%d")
    for i in range(200):
        assert book.add_address(addr(i), src=src)
    assert book.size() == 200
    assert book.n_new() == 200 and book.n_old() == 0
    used = sum(1 for b in book._new if b)
    assert used <= 32, f"one source spread over {used} buckets"
    assert not book.add_address(
        ns.NetAddress.parse(("f" * 40) + "@1.2.3.4:1"), src=src)
    for i in range(50):
        book.mark_good("%040x" % i)
    assert book.n_old() == 50
    for i in range(1000, 1400):
        book.add_address(addr(i), src=src)
    assert book.n_old() == 50  # the flood displaced no proven peer
    picked = book.pick_address(exclude=set(), bias_new=0)
    assert picked is not None and int(picked.id, 16) < 50
    book.save()
    book2 = ns.AddrBook(path, our_id="f" * 40)
    assert book2.size() == book.size()
    assert book2.n_old() == 50


@ROOTS
def test_trust_metric_pd_behavior(root):
    """PD trust metric: perfect history stays at 1.0, a bad burst drops
    the score at once, recovery is gradual; a paused metric is frozen."""
    trust = p2p(root).trust
    tm = trust.TrustMetric()
    for _ in range(10):
        tm.good_event()
        tm.tick()
    assert tm.value() > 0.99
    for _ in range(20):
        tm.bad_event()
    v_after_bad = tm.value()
    assert v_after_bad < 0.6
    tm.tick()
    vals = []
    for _ in range(6):
        for _ in range(5):
            tm.good_event()
        tm.tick()
        vals.append(tm.value())
    assert vals[-1] > vals[0] > v_after_bad
    assert vals[-1] < 1.0
    store = trust.TrustMetricStore()
    m = store.get_metric("peer1")
    m.bad_event()
    store.peer_disconnected("peer1")
    frozen = m.value()
    store.tick_all()
    assert m.value() == frozen


# --- parity with the JAX package ---------------------------------------------


def test_aead_bytes_match_reference():
    """Seeded keys, nonces, plaintexts and associated data (frame-sized and
    ragged): both packages seal to the same bytes, the port's pure-Python
    RFC 8439 path too, and each opens the other's."""
    rng = np.random.default_rng(20261017)
    assert PORT.aead.using_native()
    for n in (0, 1, 15, 16, 63, 64, 65, 1028, 1044, 5000):
        key, nonce = rng.bytes(32), rng.bytes(12)
        pt, ad = rng.bytes(n), rng.bytes(int(rng.integers(0, 40)))
        sealed = PORT.aead.seal(key, nonce, pt, ad)
        assert sealed == REF.aead.seal(key, nonce, pt, ad), n
        ct = PORT.aead._chacha20_xor(key, nonce, 1, pt)
        assert ct + PORT.aead._py_tag(key, nonce, ad, ct) == sealed, n
        assert REF.aead.open_(key, nonce, sealed, ad) == pt
        assert PORT.aead.open_(key, nonce, REF.aead.seal(key, nonce, pt, ad), ad) == pt
        bad = bytearray(sealed)
        bad[-1] ^= 1
        for ns in (PORT, REF):
            with pytest.raises(ValueError):
                ns.aead.open_(key, nonce, bytes(bad), ad)


def test_x25519_matches_reference():
    """Seeded scalars: the same public keys and shared secrets from both
    packages, across them too."""
    rng = np.random.default_rng(7748)
    for _ in range(4):
        a, b = rng.bytes(32), rng.bytes(32)
        pa = PORT.x25519.scalar_mult(a, PORT.x25519.BASEPOINT)
        pb = REF.x25519.scalar_mult(b, REF.x25519.BASEPOINT)
        assert pa == REF.x25519.scalar_mult(a, REF.x25519.BASEPOINT)
        assert pb == PORT.x25519.scalar_mult(b, PORT.x25519.BASEPOINT)
        s = PORT.x25519.shared_secret(a, pb)
        assert s == REF.x25519.shared_secret(b, pa)
        assert s == REF.x25519.shared_secret(a, pb)
        priv, pub = PORT.x25519.generate_keypair(rng=lambda n: a[:n])
        assert (priv, pub) == REF.x25519.generate_keypair(rng=lambda n: a[:n])
    for ns in (PORT, REF):
        with pytest.raises(ValueError, match="low-order"):
            ns.x25519.shared_secret(a, bytes(32))


def test_secret_connection_with_reference():
    """A port SecretConnection and a reference one handshake over a
    localhost socket (seeded identities), authenticate each other, and
    pass single- and multi-frame data both ways."""
    rng = np.random.default_rng(51)

    async def run():
        k_port = PORT.ed25519.PrivKey(rng.bytes(32))
        k_ref = REF.ed25519.PrivKey(rng.bytes(32))
        c_port, c_ref, _, _, _, server = await _secret_pair(PORT, REF, k_port, k_ref)
        assert c_port.remote_pubkey.data == k_ref.public_key().data
        assert c_ref.remote_pubkey.data == k_port.public_key().data
        small, big = rng.bytes(5), rng.bytes(5120)
        await c_port.write(small)
        assert await c_ref.read_exactly(len(small)) == small
        await c_ref.write(big)
        assert await c_port.read_exactly(len(big)) == big
        await c_port.write(big)
        assert await c_ref.read_exactly(len(big)) == big
        c_port.close(); c_ref.close(); server.close()

    asyncio.run(run())


def test_mconnection_with_reference():
    """A port MConnection talks to a reference one over their secret
    connections: two channels each way, a message over many packets."""
    rng = np.random.default_rng(52)

    async def run():
        c_port, c_ref, _, _, _, server = await _secret_pair(PORT, REF)
        got = {"port": asyncio.Queue(), "ref": asyncio.Queue()}

        def on_recv(side):
            async def put(ch, msg):
                await got[side].put((ch, msg))
            return put

        m_port = PORT.MConnection(c_port, [PORT.ChannelDescriptor(id=0x20, priority=5),
                                           PORT.ChannelDescriptor(id=0x21, priority=10)],
                                  on_recv("port"))
        m_ref = REF.MConnection(c_ref, [REF.ChannelDescriptor(id=0x20, priority=5),
                                        REF.ChannelDescriptor(id=0x21, priority=10)],
                                on_recv("ref"))
        m_port.start(); m_ref.start()
        small, big = rng.bytes(7), rng.bytes(5000)
        for sender, side in ((m_port, "ref"), (m_ref, "port")):
            assert sender.send(0x20, small)
            assert sender.send(0x21, big)
            seen = {}
            for _ in range(2):
                ch, msg = await asyncio.wait_for(got[side].get(), 5)
                seen[ch] = msg
            assert seen == {0x20: small, 0x21: big}, side
        await m_port.stop(); await m_ref.stop(); server.close()

    asyncio.run(run())
