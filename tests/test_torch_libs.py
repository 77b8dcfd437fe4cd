"""The port's leaf libraries against the contracts of ``tests/test_libs.py``,
``tests/test_libs_extra.py`` and ``tests/test_libs_json_sync.py``, each test
on both packages' roots with one body (protoio, bits, the pubsub query and
server, events, service, autofile; clist, flowrate, math, cmap, ethutil;
tmjson, HexBytes, rand, ThrottleTimer, the event-loop watchdog). Beside
them, parity with the JAX package on inputs seeded with numpy: the same
values give the same tmjson bytes, the same seed the same rand sequences,
the same RLP items and legacy transactions the same encodings and
recovered senders, the same queries and event maps the same matches, and
the same numbers the same fractions and checked int64 sums. Tolerance:
exact (bytes, values, verdicts). The ThrottleTimer and watchdog tests keep
the reference's waits."""

from __future__ import annotations

import asyncio
import dataclasses
import importlib
import time
from datetime import datetime, timezone
from io import BytesIO

import numpy as np
import pytest

ROOTS = pytest.mark.parametrize(
    "root", ["tendermint_tpu_torch", "tendermint_tpu"], ids=["port", "ref"])


def mod(root: str, name: str):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def tmjson_registries(monkeypatch):
    """Each test sees both packages' tmjson type registries without the
    "test/..." names other test modules of the process registered (the
    reference's tests/test_libs_json_sync.py registers its own _Car under
    "test/Car"), and leaves them as it found them: the registries are
    process-wide, and a worker may run those modules in either order."""
    for root in ("tendermint_tpu_torch", "tendermint_tpu"):
        tmjson = mod(root, "libs.tmjson")
        monkeypatch.setattr(tmjson, "_by_name", {
            k: v for k, v in tmjson._by_name.items() if not k.startswith("test/")})
        monkeypatch.setattr(tmjson, "_by_class", {
            k: v for k, v in tmjson._by_class.items() if not v.startswith("test/")})


# --- protoio (test_libs.py) ------------------------------------------------


@ROOTS
def test_uvarint_roundtrip(root):
    protoio = mod(root, "libs.protoio")
    for n in [0, 1, 127, 128, 300, 2**32, 2**63 - 1]:
        buf = BytesIO(protoio.write_uvarint(n))
        assert protoio.read_uvarint(buf) == n


@ROOTS
def test_delimited_roundtrip(root):
    protoio = mod(root, "libs.protoio")
    payload = b"canonical vote bytes"
    framed = protoio.marshal_delimited(payload)
    assert protoio.read_delimited(BytesIO(framed)) == payload


@ROOTS
def test_field_encoding_roundtrip(root):
    protoio = mod(root, "libs.protoio")
    msg = (
        protoio.field_varint(1, 42)
        + protoio.field_bytes(2, b"hash")
        + protoio.field_sfixed64(3, -7)
        + protoio.field_varint(4, 0)  # zero omitted
    )
    fields = protoio.decode_fields(msg)
    assert fields[1] == [42]
    assert fields[2] == [b"hash"]
    assert fields[3] == [-7]
    assert 4 not in fields


@ROOTS
def test_negative_varint_is_64bit_twos_complement(root):
    protoio = mod(root, "libs.protoio")
    data = protoio.write_varint(-1)
    assert protoio.read_uvarint(BytesIO(data)) == 2**64 - 1


# --- bits -------------------------------------------------------------------


@ROOTS
def test_bitarray_ops(root):
    bits = mod(root, "libs.bits")
    a = bits.BitArray.from_indices(10, [1, 3, 5])
    b = bits.BitArray.from_indices(10, [3, 4])
    assert a.get(3) and not a.get(2)
    assert a.or_(b).ones() == [1, 3, 4, 5]
    assert a.and_(b).ones() == [3]
    assert a.sub(b).ones() == [1, 5]
    assert a.not_().ones() == [0, 2, 4, 6, 7, 8, 9]
    assert a.num_set() == 3
    rt = bits.BitArray.from_bytes(10, a.to_bytes())
    assert rt == a
    idx, ok = a.pick_random()
    assert ok and idx in (1, 3, 5)
    assert not bits.BitArray(4).pick_random()[1]


@ROOTS
def test_bitarray_out_of_range(root):
    bits = mod(root, "libs.bits")
    a = bits.BitArray(4)
    assert not a.set(4, True)
    assert not a.get(-1)


# --- pubsub -----------------------------------------------------------------


@ROOTS
def test_query_matching(root):
    pubsub = mod(root, "libs.pubsub")
    q = pubsub.Query("tm.event = 'NewBlock' AND block.height > 5")
    assert q.matches({"tm.event": ["NewBlock"], "block.height": ["6"]})
    assert not q.matches({"tm.event": ["NewBlock"], "block.height": ["5"]})
    assert not q.matches({"tm.event": ["Tx"], "block.height": ["6"]})
    assert not q.matches({"tm.event": ["NewBlock"]})


@ROOTS
def test_query_exists_contains(root):
    pubsub = mod(root, "libs.pubsub")
    q = pubsub.Query("account.owner EXISTS AND tx.hash CONTAINS 'abc'")
    assert q.matches({"account.owner": ["x"], "tx.hash": ["zzabczz"]})
    assert not q.matches({"tx.hash": ["zzabczz"]})


@ROOTS
def test_pubsub_publish_subscribe(root):
    pubsub = mod(root, "libs.pubsub")

    async def run():
        srv = pubsub.PubSubServer()
        sub = srv.subscribe("client1", pubsub.Query("tm.event = 'Tx'"))
        await srv.publish("blk", {"tm.event": ["NewBlock"]})
        await srv.publish("tx1", {"tm.event": ["Tx"]})
        msg = await asyncio.wait_for(sub.next(), 1)
        assert msg.data == "tx1"
        srv.unsubscribe_all("client1")
        with pytest.raises(pubsub.SubscriptionCancelled):
            await sub.next()

    asyncio.run(run())


# --- events, service, autofile ----------------------------------------------


@ROOTS
def test_event_switch(root):
    sw = mod(root, "libs.events").EventSwitch()
    got = []
    sw.add_listener("l1", "step", got.append)
    sw.fire_event("step", 1)
    sw.remove_listener("l1")
    sw.fire_event("step", 2)
    assert got == [1]


@ROOTS
def test_service_lifecycle(root):
    Service = mod(root, "libs.service").Service

    async def run():
        class S(Service):
            started = stopped = False

            async def on_start(self):
                self.started = True

            async def on_stop(self):
                self.stopped = True

        s = S("test")
        await s.start()
        assert s.is_running and s.started
        with pytest.raises(RuntimeError):
            await s.start()
        await s.stop()
        assert s.stopped and not s.is_running
        await s.wait_stopped()

    asyncio.run(run())


@ROOTS
def test_autofile_rotation(root, tmp_path):
    autofile = mod(root, "libs.autofile")
    head = str(tmp_path / "wal")
    g = autofile.Group(head, head_size_limit=100)
    for _ in range(30):
        g.write(b"x" * 10)
        g.check_head_size_limit()
    g.sync()
    assert g.max_index() >= 0  # rotated at least once
    assert g.read_all() == b"x" * 300
    g.close()


@ROOTS
def test_autofile_total_size_prune(root, tmp_path):
    autofile = mod(root, "libs.autofile")
    head = str(tmp_path / "wal")
    g = autofile.Group(head, head_size_limit=50, total_size_limit=120)
    for _ in range(40):
        g.write(b"y" * 10)
        g.check_head_size_limit()
    assert len(g.read_all()) <= 170  # oldest chunks pruned
    g.close()


# --- clist, flowrate, math, cmap (test_libs_extra.py) -----------------------


@ROOTS
def test_clist_push_remove_iterate(root):
    CList = mod(root, "libs.clist").CList

    async def run():
        cl = CList()
        cl.push_back("a")
        e2 = cl.push_back("b")
        cl.push_back("c")
        assert list(cl) == ["a", "b", "c"]
        cl.remove(e2)
        assert list(cl) == ["a", "c"]
        assert len(cl) == 2
        # waiting cursor wakes when a next element arrives
        got = []

        async def reader():
            el = await cl.front_wait()
            while el is not None:
                got.append(el.value)
                if len(got) == 3:
                    return
                el = await el.next_wait()

        t = asyncio.create_task(reader())
        await asyncio.sleep(0.01)
        cl.push_back("d")
        await asyncio.wait_for(t, 2)
        assert got == ["a", "c", "d"]

    asyncio.run(run())


@ROOTS
def test_flowrate_tracks_rate(root):
    m = mod(root, "libs.flowrate").Monitor(sample_period=0.0)  # sample on every update
    m.update(1000)
    st = m.status()
    assert st.bytes_total == 1000
    assert st.avg_rate > 0
    assert m.limit(500, max_rate=0) == 500  # unlimited


@ROOTS
def test_safe_math_and_fraction(root):
    m = mod(root, "libs.math")
    assert m.safe_add_int64(1, 2) == 3
    with pytest.raises(m.ErrOverflow):
        m.safe_add_int64(m.MAX_INT64, 1)
    with pytest.raises(m.ErrOverflow):
        m.safe_mul_int64(m.MAX_INT64, 2)
    f = m.Fraction.parse("1/3")
    assert f.numerator == 1 and f.denominator == 3
    assert abs(float(f) - 1 / 3) < 1e-12
    with pytest.raises(ZeroDivisionError):
        m.Fraction(1, 0)


@ROOTS
def test_cmap(root):
    m = mod(root, "libs.cmap").CMap()
    m.set("a", 1)
    assert m.get("a") == 1 and m.has("a") and m.size() == 1
    m.delete("a")
    assert not m.has("a")


# --- ethutil ----------------------------------------------------------------


@ROOTS
def test_rlp_roundtrip(root):
    eth = mod(root, "ethutil")
    cases = [b"", b"\x01", b"dog", b"x" * 100, [b"cat", [b"a", b""]], []]
    for c in cases:
        enc = eth.rlp_encode(c)
        dec, rest = eth.rlp_decode(enc)
        assert rest == b""
        assert dec == c
    # canonical single-byte encoding
    assert eth.rlp_encode(b"\x05") == b"\x05"
    assert eth.rlp_encode(0) == b"\x80"
    assert eth.rlp_encode(1024) == b"\x82\x04\x00"


@ROOTS
def test_legacy_tx_sign_recover_roundtrip(root):
    eth = mod(root, "ethutil")
    secp256k1 = mod(root, "crypto.secp256k1")
    key = secp256k1.PrivKey.from_secret(b"eth-sender")
    addr = secp256k1.eth_address(secp256k1.decompress_point(key.public_key().data))

    tx = eth.LegacyTx(nonce=7, gas_price=10**9, gas=21000, to=b"\x11" * 20,
                      value=10**18, data=b"")
    tx.sign(key.secret, chain_id=2818)  # morph chain id
    assert tx.chain_id() == 2818
    assert tx.sender() == addr

    # wire roundtrip preserves sender recovery
    blob = eth.encode_transactions([tx, tx])
    txs = eth.decode_txs(blob)
    assert len(txs) == 2
    for t in txs:
        assert t.sender() == addr
        assert t.nonce == 7 and t.value == 10**18

    # tampered payload recovers a different sender
    bad = eth.decode_txs(blob)[0]
    bad.value = 5
    assert bad.sender() != addr


# --- tmjson and HexBytes (test_libs_json_sync.py) ---------------------------


@ROOTS
def test_int64_as_string_int32_as_number(root):
    tmjson = mod(root, "libs.tmjson")
    assert tmjson.marshal(64) == b'"64"'
    assert tmjson.marshal(tmjson.Int32(32)) == b"32"
    assert tmjson.unmarshal(b'"64"', int) == 64
    assert tmjson.unmarshal(b"32", tmjson.Int32) == 32


@ROOTS
def test_bytes_base64_hexbytes_hex(root):
    tmjson = mod(root, "libs.tmjson")
    HexBytes = mod(root, "libs.bytes").HexBytes
    assert tmjson.marshal(b"\x01\x02\x03") == b'"AQID"'
    assert tmjson.marshal(HexBytes(b"\xde\xad")) == b'"DEAD"'
    assert tmjson.unmarshal(b'"AQID"', bytes) == b"\x01\x02\x03"
    assert tmjson.unmarshal(b'"DEAD"', HexBytes) == b"\xde\xad"


@ROOTS
def test_time_rfc3339nano_utc(root):
    tmjson = mod(root, "libs.tmjson")
    t = datetime(2026, 1, 2, 3, 4, 5, 600000, tzinfo=timezone.utc)
    raw = tmjson.marshal(t)
    assert raw == b'"2026-01-02T03:04:05.600000Z"'
    assert tmjson.unmarshal(raw, datetime) == t


@dataclasses.dataclass
class _Car:
    wheels: int = 4
    name: str = ""


@dataclasses.dataclass
class _Garage:
    vehicle: object = None


@ROOTS
def test_interface_envelope_roundtrip(root):
    """Registered types wrap as {"type","value"} and decode back to the
    class from the envelope alone."""
    tmjson = mod(root, "libs.tmjson")
    tmjson.register_type(_Car, "test/Car")
    raw = tmjson.marshal(_Car(wheels=4, name="benz"))
    assert tmjson.unmarshal(raw) == _Car(wheels=4, name="benz")
    assert tmjson.unmarshal(raw, None).wheels == 4
    # nested inside an unregistered struct
    g = tmjson.unmarshal(tmjson.marshal(_Garage(vehicle=_Car(name="vw"))), _Garage)
    assert g.vehicle == _Car(name="vw")


@ROOTS
def test_register_conflict_rejected(root):
    tmjson = mod(root, "libs.tmjson")
    tmjson.register_type(_Car, "test/Car")  # the same class again is no conflict
    with pytest.raises(ValueError):
        tmjson.register_type(_Garage, "test/Car")


@ROOTS
def test_maps_require_string_keys(root):
    tmjson = mod(root, "libs.tmjson")
    assert tmjson.marshal({"a": 1}) == b'{"a":"1"}'
    with pytest.raises(TypeError):
        tmjson.marshal({True: 1})


@ROOTS
def test_hexbytes_str_and_fingerprint(root):
    h = mod(root, "libs.bytes").HexBytes(bytes.fromhex("deadbeef"))
    assert str(h) == "DEADBEEF"
    assert h.fingerprint() == bytes.fromhex("deadbeef0000")


# --- rand, ThrottleTimer, the watchdog --------------------------------------


@ROOTS
def test_rand_deterministic_after_seed(root):
    tmrand = mod(root, "libs.rand")
    tmrand.seed(42)
    a = (tmrand.rand_str(12), tmrand.rand_bytes(8), tmrand.rand_intn(100))
    tmrand.seed(42)
    b = (tmrand.rand_str(12), tmrand.rand_bytes(8), tmrand.rand_intn(100))
    assert a == b
    assert len(a[0]) == 12 and a[0].isalnum()
    assert sorted(tmrand.rand_perm(10)) == list(range(10))


@ROOTS
def test_throttle_timer_coalesces_burst(root):
    """A burst of set() calls fires once."""
    ThrottleTimer = mod(root, "libs.timer").ThrottleTimer
    fires = []

    async def run():
        async def cb():
            fires.append(asyncio.get_running_loop().time())

        t = ThrottleTimer("test", 0.05, cb)
        for _ in range(10):
            t.set()
        await asyncio.sleep(0.12)
        assert len(fires) == 1
        # a second burst fires again
        t.set()
        t.set()
        await asyncio.sleep(0.12)
        assert len(fires) == 2
        t.stop()
        t.set()
        await asyncio.sleep(0.08)
        assert len(fires) == 2  # stopped: no more fires

    asyncio.run(run())


@ROOTS
def test_watchdog_detects_blocked_loop(root, capsys):
    EventLoopWatchdog = mod(root, "libs.sync").EventLoopWatchdog

    async def run():
        wd = EventLoopWatchdog(interval=0.05, misses=2)
        wd.start()
        time.sleep(0.4)  # block the loop (the bug class being detected)
        await asyncio.sleep(0.1)
        wd.stop()

    asyncio.run(run())
    assert "event loop stalled" in capsys.readouterr().err


# --- parity with the JAX package on seeded inputs ---------------------------

PORT_ROOT, REF_ROOT = "tendermint_tpu_torch", "tendermint_tpu"


def _seeded_json_values(rng, HexBytes, Int32):
    """Ints (int64 as strings, Int32 as numbers), bytes, HexBytes, UTC
    datetimes, strings, floats, bools, None, and lists and string-keyed
    maps of them, from `rng`."""
    def leaf():
        kind = int(rng.integers(0, 9))
        if kind == 0:
            return int(rng.integers(-2**63, 2**63 - 1, dtype=np.int64))
        if kind == 1:
            return Int32(int(rng.integers(-2**31, 2**31 - 1)))
        if kind == 2:
            return rng.bytes(int(rng.integers(0, 40)))
        if kind == 3:
            return HexBytes(rng.bytes(int(rng.integers(0, 40))))
        if kind == 4:
            return datetime.fromtimestamp(int(rng.integers(0, 4_000_000_000)), timezone.utc
                                          ).replace(microsecond=int(rng.integers(0, 10**6)))
        if kind == 5:
            return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, size=int(rng.integers(0, 12))))
        if kind == 6:
            return float(rng.normal())
        if kind == 7:
            return bool(rng.integers(0, 2))
        return None

    def value(depth):
        kind = int(rng.integers(0, 4)) if depth < 3 else 0
        if kind == 1:
            return [value(depth + 1) for _ in range(int(rng.integers(0, 5)))]
        if kind == 2:
            return {f"k{int(rng.integers(0, 1000))}": value(depth + 1)
                    for _ in range(int(rng.integers(0, 5)))}
        return leaf()

    return [value(0) for _ in range(200)]


def test_tmjson_bytes_equal_on_seeded_values():
    """The same seeded values marshal to the same bytes in both packages
    (compact and indented), and each package unmarshals the other's bytes
    to the same value."""
    out = {}
    for root in (PORT_ROOT, REF_ROOT):
        tmjson = mod(root, "libs.tmjson")
        values = _seeded_json_values(np.random.default_rng(2026),
                                     mod(root, "libs.bytes").HexBytes, tmjson.Int32)
        tmjson.register_type(_Car, "test/Car")
        values.append(_Garage(vehicle=_Car(wheels=3, name="tri")))
        out[root] = [(tmjson.marshal(v), tmjson.marshal_indent(v)) for v in values]
    assert out[PORT_ROOT] == out[REF_ROOT]
    port, ref = mod(PORT_ROOT, "libs.tmjson"), mod(REF_ROOT, "libs.tmjson")
    for raw, _ in out[PORT_ROOT]:
        assert port.unmarshal(raw) == ref.unmarshal(raw)


def test_rand_sequences_equal_after_the_same_seed():
    seqs = {}
    for root in (PORT_ROOT, REF_ROOT):
        r = mod(root, "libs.rand")
        got = []
        for s in np.random.default_rng(7).integers(0, 2**31, size=8):
            r.seed(int(s))
            got.append((r.rand_str(16), r.rand_bytes(24), r.rand_intn(1000),
                        r.rand_uint64(), r.rand_perm(12), r.rand_float64()))
        seqs[root] = got
    assert seqs[PORT_ROOT] == seqs[REF_ROOT]


def _seeded_rlp_items(rng, n):
    def item(depth):
        kind = int(rng.integers(0, 4)) if depth < 3 else int(rng.integers(0, 2))
        if kind == 0:
            return rng.bytes(int(rng.choice([0, 1, 1, 2, 30, 55, 56, 60, 300])))
        if kind == 1:
            return int(rng.integers(0, 2**62))
        return [item(depth + 1) for _ in range(int(rng.integers(0, 6)))]

    return [item(0) for _ in range(n)]


def test_rlp_and_legacy_tx_parity_on_seeded_inputs():
    """Seeded RLP items, and legacy transactions signed by seeded keys
    under seeded chain ids, give the same encodings, decodings, signing
    hashes, tx hashes and recovered senders in both packages."""
    got = {}
    for root in (PORT_ROOT, REF_ROOT):
        eth = mod(root, "ethutil")
        secp = mod(root, "crypto.secp256k1")
        rng = np.random.default_rng(818)
        items = _seeded_rlp_items(rng, 60)
        enc = [eth.rlp_encode(it) for it in items]
        dec = [eth.rlp_decode(e) for e in enc]
        txs = []
        for i in range(6):
            key = secp.PrivKey.from_secret(b"eth-seed-%d" % i)
            tx = eth.LegacyTx(
                nonce=int(rng.integers(0, 2**40)), gas_price=int(rng.integers(1, 2**50)),
                gas=int(rng.integers(21000, 10**7)),
                to=rng.bytes(20) if i % 3 else b"", value=int(rng.integers(0, 2**62)),
                data=rng.bytes(int(rng.integers(0, 80))))
            tx.sign(key.secret, chain_id=int(rng.integers(1, 5000)))
            txs.append(tx)
        blob = eth.encode_transactions(txs)
        got[root] = {
            "enc": enc, "dec": dec, "blob": blob,
            "signing": [t.signing_hash() for t in txs], "hash": [t.hash() for t in txs],
            "senders": [t.sender() for t in eth.decode_txs(blob)],
            "fields": [dataclasses.astuple(t) for t in eth.decode_txs(blob)],
        }
    assert got[PORT_ROOT] == got[REF_ROOT]
    assert all(s is not None and len(s) == 20 for s in got[PORT_ROOT]["senders"])


def test_query_matches_agree_on_seeded_events():
    """Seeded queries of every operator, joined by AND, against seeded
    event maps: the same match verdicts in both packages."""
    rng = np.random.default_rng(99)
    keys = ["tm.event", "tx.height", "app.key", "block.height", "app.creator"]
    vals = ["NewBlock", "Tx", "kvstore", "tx-1-0", "1", "5", "64", "100", "2.5"]
    queries = []
    for _ in range(120):
        conds = []
        for _ in range(int(rng.integers(1, 4))):
            k = keys[int(rng.integers(0, len(keys)))]
            op = ["=", "<", "<=", ">", ">=", "EXISTS", "CONTAINS"][int(rng.integers(0, 7))]
            if op == "EXISTS":
                conds.append(f"{k} EXISTS")
            elif op in ("=", "CONTAINS") and rng.integers(0, 2):
                conds.append(f"{k} {op} '{vals[int(rng.integers(0, len(vals)))]}'")
            else:
                conds.append(f"{k} {op} {int(rng.integers(0, 120))}")
        queries.append(" AND ".join(conds))
    events = [{k: [vals[int(rng.integers(0, len(vals)))] for _ in range(int(rng.integers(1, 3)))]
               for k in keys if rng.integers(0, 3)} for _ in range(80)]
    verdicts = {}
    for root in (PORT_ROOT, REF_ROOT):
        Query = mod(root, "libs.pubsub").Query
        verdicts[root] = [[Query(q).matches(e) for e in events] for q in queries]
    assert verdicts[PORT_ROOT] == verdicts[REF_ROOT]
    flat = [v for row in verdicts[PORT_ROOT] for v in row]
    assert any(flat) and not all(flat)


def test_math_fractions_and_checked_int64_agree_on_seeded_numbers():
    rng = np.random.default_rng(5)
    nums = [int(x) for x in rng.integers(-2**63, 2**63 - 1, size=200, dtype=np.int64)]
    nums += [2**63 - 1, -2**63, 0, 1, -1]
    pairs = [(int(n), int(d) + 1) for n, d in rng.integers(0, 10**6, size=(50, 2))]
    out = {}
    for root in (PORT_ROOT, REF_ROOT):
        m = mod(root, "libs.math")

        def checked(fn, a, b):
            try:
                return fn(a, b)
            except m.ErrOverflow:
                return "overflow"

        row = []
        for a, b in zip(nums, nums[1:] + nums[:1]):
            row.append(tuple(checked(fn, a, b) for fn in (
                m.safe_add_int64, m.safe_sub_int64, m.safe_mul_int64)))
            row.append((m.safe_add_clip_int64(a, b), m.safe_sub_clip_int64(a, b)))
        for n, d in pairs:
            f = m.Fraction.parse(f"{n}/{d}")
            row.append((f.numerator, f.denominator, float(f), str(f)))
        out[root] = row
    assert out[PORT_ROOT] == out[REF_ROOT]
    assert ("overflow" in {x for r in out[PORT_ROOT][:400] for x in r})
