"""BLS signature scheme over BLS12-381 — the fork's L2 dual-signing crypto.

Mirrors the behavior of the reference's blssignatures package
(blssignatures/bls_signatures.go):

- secret keys: scalars mod r; public keys in G2 (pk = sk*G2gen);
  signatures in G1 (sig = sk * H(m)).
- H(m) = MapToCurve(16-byte padding || keccak256(m)); padding[0] = 1 in
  key-validation mode for domain separation (bls_signatures.go:179-188).
- proof-of-possession (Ristenpart–Yilek): the private key signs its own
  serialized public key under the tweaked hash (bls_signatures.go:66-75).
- verification: 2-pairing check e(H(m), pk) == e(sig, G2gen)
  (bls_signatures.go:114-127), implemented as a single product
  e(H(m), pk) * e(-sig, G2gen) == 1.
- aggregation: point sums of keys (G2) / signatures (G1)
  (bls_signatures.go:129-149); aggregate verification over distinct
  messages does n+1 pairings (bls_signatures.go:151-171).
- serialization: uncompressed big-endian — G1 96 bytes (x||y), G2 192
  bytes (x.c1||x.c0||y.c1||y.c0); infinity encodes as zeros. Public keys
  serialize as proof-length-prefixed proof+key (bls_signatures.go:195-213).

Unlike the reference (which trusts kilic's FromBytes on-curve check only),
deserialization here also subgroup-checks — defense in depth; documented
divergence.

Port of ``tendermint_tpu/crypto/bls_signatures.py``. Pairing checks
(``_pairing_is_one``), public-key and signature sums
(``aggregate_public_keys``, ``aggregate_signatures``) and the signer-key
sums of ``verify_qc_items`` run on the port's device: the CUDA kernels of
``ops/bls_g1.py``, ``ops/bls_g2.py`` and ``ops/bls_pairing.py`` on the
card, their plain versions when the process verifier
(``crypto/batch_verifier.default_verifier``) was built with
``device="cpu"``. The device is the process verifier's, CUDA by default;
a kernel that fails to build or launch raises. The native C++ library
(``crypto/bls_native.py``) serves only host work: subgroup checks, the
field steps of hash-to-G1, and scalar multiplications by random
coefficients and secret keys.
"""

from __future__ import annotations

import json
import os
import secrets
from dataclasses import dataclass

import numpy as np
import torch

from . import bls12_381 as c
from . import bls_native as native
from .keccak import keccak256


class BLSError(Exception):
    pass


# --- hash to curve --------------------------------------------------------


def hash_to_g1(message: bytes, key_validation_mode: bool = False):
    """16-byte padding || keccak256(msg), mapped to G1."""
    padding = bytearray(16)
    if key_validation_mode:
        padding[0] = 1
    return c.map_to_curve_g1(bytes(padding) + keccak256(message))


# --- serialization --------------------------------------------------------


def g1_to_bytes(p) -> bytes:
    a = c.g1_to_affine(p)
    if a is None:
        return b"\x00" * 96
    return a[0].to_bytes(48, "big") + a[1].to_bytes(48, "big")


def g1_from_bytes(b: bytes):
    if len(b) != 96:
        raise BLSError("G1 encoding must be 96 bytes")
    if b == b"\x00" * 96:
        return c.G1_INF
    ok = _native_check(native.g1_check, b)
    if ok is not None and not ok:
        raise BLSError("G1 point not on curve / not in subgroup")
    x = int.from_bytes(b[:48], "big")
    y = int.from_bytes(b[48:], "big")
    if x >= c.P or y >= c.P:
        raise BLSError("G1 coordinate out of range")
    p = (x, y, 1)
    if ok is None:
        if not c.g1_on_curve(p):
            raise BLSError("G1 point not on curve")
        if not c.g1_in_subgroup(p):
            raise BLSError("G1 point not in the prime-order subgroup")
    return p


def _native_check(fn, b: bytes):
    """Run a native point check: True/False verdict, None = no library;
    malformed encodings surface as BLSError like the python path."""
    try:
        return fn(b)
    except ValueError as e:
        raise BLSError(str(e)) from None


def g2_to_bytes(p) -> bytes:
    a = c.g2_to_affine(p)
    if a is None:
        return b"\x00" * 192
    (x0, x1), (y0, y1) = a
    return (
        x1.to_bytes(48, "big")
        + x0.to_bytes(48, "big")
        + y1.to_bytes(48, "big")
        + y0.to_bytes(48, "big")
    )


def g2_from_bytes(b: bytes):
    if len(b) != 192:
        raise BLSError("G2 encoding must be 192 bytes")
    if b == b"\x00" * 192:
        return c.G2_INF
    ok = _native_check(native.g2_check, b)
    if ok is not None and not ok:
        raise BLSError("G2 point not on curve / not in subgroup")
    vals = [int.from_bytes(b[i * 48 : (i + 1) * 48], "big") for i in range(4)]
    if any(v >= c.P for v in vals):
        raise BLSError("G2 coordinate out of range")
    x = (vals[1], vals[0])
    y = (vals[3], vals[2])
    p = (x, y, c.F2_ONE)
    if ok is None:
        if not c.g2_on_curve(p):
            raise BLSError("G2 point not on curve")
        if not c.g2_in_subgroup(p):
            raise BLSError("G2 point not in the prime-order subgroup")
    return p


# --- device and native primitives -----------------------------------------
# Point values stay python int tuples throughout (the wire format is the
# exchange format with the native library); the scalar-multiplication
# helpers fall back to the pure-python bls12_381 module when the C++
# library is unavailable.


def _device() -> torch.device:
    """The process verifier's device: CUDA unless it was built for the CPU."""
    from .batch_verifier import default_verifier

    return default_verifier().device


def _pairing_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1: the Miller-loop and final-exponentiation
    kernels on the card (their plain versions on the CPU)."""
    from ..ops import bls_pairing

    return bls_pairing.check_pairs(pairs, _device())


def _g1_mul_point(p, k: int):
    if native.native_lib() is not None:
        out = native.g1_mul(g1_to_bytes(p), (k % c.R).to_bytes(32, "big"))
        if out is not None:
            return _g1_parse_unchecked(out)
    return c.g1_mul(p, k)


def _g2_mul_point(p, k: int):
    if native.native_lib() is not None:
        out = native.g2_mul(g2_to_bytes(p), (k % c.R).to_bytes(32, "big"))
        if out is not None:
            return _g2_parse_unchecked(out)
    return c.g2_mul(p, k)


def _g1_parse_unchecked(b: bytes):
    """Wire bytes from the native library (already a group element)."""
    if b == b"\x00" * 96:
        return c.G1_INF
    return (int.from_bytes(b[:48], "big"), int.from_bytes(b[48:], "big"), 1)


def _g2_parse_unchecked(b: bytes):
    if b == b"\x00" * 192:
        return c.G2_INF
    v = [int.from_bytes(b[i * 48 : (i + 1) * 48], "big") for i in range(4)]
    return ((v[1], v[0]), (v[3], v[2]), c.F2_ONE)


# --- keys and signatures --------------------------------------------------


@dataclass(frozen=True)
class PublicKey:
    """G2 key + optional proof-of-possession (None => trusted source)."""

    key: tuple
    validity_proof: tuple | None = None

    def to_trusted(self) -> "PublicKey":
        return PublicKey(self.key, None)


def _pub_wire(pub: PublicKey) -> bytes:
    """Wire-format G2 bytes of a public key, cached on the instance —
    registry keys are serialized for every native MSM/pairing call, and
    the 4 int.to_bytes per call add up across 1k-member aggregates."""
    w = pub.__dict__.get("_wire")
    if w is None:
        w = g2_to_bytes(pub.key)
        object.__setattr__(pub, "_wire", w)
    return w


def generate_priv_key() -> int:
    return secrets.randbelow(c.R - 1) + 1


def pubkey_from_priv(priv: int) -> PublicKey:
    key = _g2_mul_point(c.G2_GEN, priv)
    proof = key_validity_proof(key, priv)
    pub = new_public_key(key, proof)
    return pub


def key_validity_proof(key, priv: int):
    """PoP: sign the serialized public key in key-validation mode."""
    return _sign2(priv, g2_to_bytes(key), key_validation_mode=True)


def new_public_key(key, validity_proof) -> PublicKey:
    pub = PublicKey(key, validity_proof)
    if not _verify2(validity_proof, g2_to_bytes(key), pub, key_validation_mode=True):
        raise BLSError("public key validation failed")
    return pub


def new_trusted_public_key(key) -> PublicKey:
    return PublicKey(key, None)


def sign(priv: int, message: bytes):
    """Signature = priv * H(message) in G1."""
    return _sign2(priv, message, key_validation_mode=False)


def _sign2(priv: int, message: bytes, key_validation_mode: bool):
    h = hash_to_g1(message, key_validation_mode)
    return _g1_mul_point(h, priv)


def verify(sig, message: bytes, pub: PublicKey) -> bool:
    return _verify2(sig, message, pub, key_validation_mode=False)


def _verify2(sig, message: bytes, pub: PublicKey, key_validation_mode: bool) -> bool:
    h = hash_to_g1(message, key_validation_mode)
    # e(H, pk) == e(sig, G2gen)  <=>  e(H, pk) * e(-sig, G2gen) == 1
    return _pairing_is_one(
        [(h, pub.key), (c.g1_neg(sig), c.G2_GEN)]
    )


def _on_device(n: int) -> bool:
    """Whether an n-point sum runs on the device: every sum of more than
    one point on the card; on the CPU the plain tree from
    DEVICE_AGGREGATE_MIN up, the exact host loop below it."""
    if n < 2:
        return False
    return _device().type == "cuda" or n >= DEVICE_AGGREGATE_MIN


def aggregate_public_keys(pubs: list[PublicKey]) -> PublicKey:
    """Point sum of N G2 public keys: the device tree reduction
    (ops/bls_g2, see _on_device), else the exact host loop."""
    if _on_device(len(pubs)):
        return new_trusted_public_key(_g2_sums([b"".join(_pub_wire(p) for p in pubs)])[0])
    acc = c.G2_INF
    for pk in pubs:
        acc = c.g2_add(acc, pk.key)
    return new_trusted_public_key(acc)


# the reference's host->device switchover (AggregateSignatures' N-point
# loop, bls_signatures.go:138-149); in the port it applies on the CPU
# only: below it the exact host loop, from it the plain tree of
# ops/bls_g1.py / ops/bls_g2.py
DEVICE_AGGREGATE_MIN = 64


def aggregate_signatures(sigs: list):
    """Point sum of N G1 signatures: the device tree reduction
    (ops/bls_g1, see _on_device), else the exact host loop."""
    if _on_device(len(sigs)):
        return aggregate_signatures_device(sigs)
    acc = c.G1_INF
    for s in sigs:
        acc = c.g1_add(acc, s)
    return acc


def aggregate_signatures_device(sigs: list):
    """Sum N G1 signatures as a log2(N)-level device tree reduction."""
    from ..ops import bls_g1 as dev

    pts = torch.stack([dev.g1_from_host(s) for s in sigs])
    return dev.g1_to_host(dev.g1_aggregate(pts.to(_device())))


def verify_aggregated_same_message(sig, message: bytes, pubs: list[PublicKey]) -> bool:
    return verify(sig, message, aggregate_public_keys(pubs))


# Batch verification coefficients: 128-bit random scalars make a forged
# batch pass with probability 2^-128 (the standard random-linear-combination
# argument; a plain unweighted sum would let two colluding validators submit
# sig+D and sig-D that cancel in aggregate but are individually invalid —
# poisoning the commit's L1-bound aggregate, which uses a different subset).
_BATCH_COEFF_BITS = 128


def verify_batch_same_message(
    message: bytes, pubs: list[PublicKey], sigs: list
) -> list[bool]:
    """Per-signature verdicts for N (pk_i, sig_i) over ONE message, in 2
    pairings for the all-valid case instead of 2N.

    Check: e(H(m), sum r_i*pk_i) == e(sum r_i*sig_i, G2gen) with random
    128-bit r_i. On failure, bisect to isolate the invalid indices —
    O(bad * log N) aggregate checks, each 2 pairings.

    This is the TPU-framework replacement for the reference's serial
    per-precommit L2 verify (consensus/state.go:2362-2379): the consensus
    workload verifies many signatures over the SAME batch hash each round,
    so the batch amortizes the pairing cost across the round's burst.
    """
    n = len(pubs)
    if n != len(sigs):
        raise BLSError("len(pubs) != len(sigs)")
    if n == 0:
        return []
    if n == 1:
        return [verify(sigs[0], message, pubs[0])]
    h = hash_to_g1(message, False)

    def check(idx: list[int]) -> bool:
        if len(idx) == 1:
            i = idx[0]
            # single item: plain 2-pairing verify, no coefficient needed
            return _pairing_is_one(
                [(h, pubs[i].key), (c.g1_neg(sigs[i]), c.G2_GEN)]
            )
        coeffs = [secrets.randbits(_BATCH_COEFF_BITS) | 1 for _ in idx]
        if native.native_lib() is not None:
            ks = b"".join(r.to_bytes(32, "big") for r in coeffs)
            pk_bytes = b"".join(_pub_wire(pubs[i]) for i in idx)
            sig_bytes = b"".join(g1_to_bytes(sigs[i]) for i in idx)
            acc_pk = _g2_parse_unchecked(native.g2_msm(pk_bytes, ks, len(idx)))
            acc_sig = _g1_parse_unchecked(
                native.g1_msm(sig_bytes, ks, len(idx))
            )
        else:
            acc_pk = c.G2_INF
            acc_sig = c.G1_INF
            for r, i in zip(coeffs, idx):
                acc_pk = c.g2_add(acc_pk, c.g2_mul(pubs[i].key, r))
                acc_sig = c.g1_add(acc_sig, c.g1_mul(sigs[i], r))
        return _pairing_is_one(
            [(h, acc_pk), (c.g1_neg(acc_sig), c.G2_GEN)]
        )

    out = [False] * n

    def solve(idx: list[int]) -> None:
        if check(idx):
            for i in idx:
                out[i] = True
            return
        if len(idx) == 1:
            return
        mid = len(idx) // 2
        solve(idx[:mid])
        solve(idx[mid:])

    solve(list(range(n)))
    return out


# signer-key parse cache for the QC engine: full deserialization
# (on-curve + SUBGROUP check) costs ~0.5 ms/key — linear in committee
# size, and it is exactly the cost the QC plane exists to flatten.
# Keys arrive from hash-committed validator sets, so the same 192-byte
# strings recur for every block of a catchup window: each distinct key
# pays the full check ONCE, then parses free. Bounded dict (insertion-
# ordered eviction) so a hostile stream of fabricated keys cannot grow
# it; thread-safe under the GIL (worst case a key is checked twice).
_QC_KEY_CACHE: dict = {}
_QC_KEY_CACHE_MAX = 8192


def _qc_signer_key(kb: bytes):
    p = _QC_KEY_CACHE.get(kb)
    if p is None:
        p = g2_from_bytes(kb)  # full check; raises BLSError on junk
        if len(_QC_KEY_CACHE) >= _QC_KEY_CACHE_MAX:
            _QC_KEY_CACHE.pop(next(iter(_QC_KEY_CACHE)))
        _QC_KEY_CACHE[kb] = p
    return p


_G2_ONE_LE = (1).to_bytes(48, "little") + bytes(48)


def _g2_sums(key_lists: list[bytes]) -> list:
    """Sum each item's signer keys (wire G2 bytes back to back, already
    checked) in ONE device launch: a [T, B, 3, 2, 48] stack of trees, the
    shorter lists padded at the end with the identity (which leaves every
    sum's value and representation as the JAX package's per-tree pad to
    the next power of two does)."""
    from ..ops import bls_g2 as dev

    width = max(len(kb) // 192 for kb in key_lists)
    ident = np.frombuffer(bytes(96) + _G2_ONE_LE + bytes(96), np.uint8)
    pts = np.tile(ident, (len(key_lists), width, 1))
    for t, kb in enumerate(key_lists):
        # wire x1||x0||y1||y0 big-endian -> (x0, x1), (y0, y1) little-endian;
        # the all-zero encoding is the point at infinity and stays identity
        w = np.frombuffer(kb, np.uint8).reshape(-1, 4, 48)[:, [1, 0, 3, 2], ::-1]
        finite = w.reshape(len(w), -1).any(axis=1)
        rows = np.flatnonzero(finite)
        pts[t, rows, :192] = w[finite].reshape(-1, 192)
        pts[t, rows, 192:] = np.frombuffer(_G2_ONE_LE, np.uint8)
    sums = dev.g2_aggregate(
        torch.from_numpy(pts.reshape(len(key_lists), width, 3, 2, 48)).to(_device())
    )
    return [dev.g2_to_host(s) for s in sums.cpu()]


def verify_qc_items(items: list[tuple]) -> list:
    """The `qc_verify` engine: per-item verdicts for quorum-certificate
    aggregate checks. Each item is wire-able bytes —
    (message, agg_sig_96, signer_pubkeys_concat) where the third part is
    the signers' uncompressed G2 keys back to back (192 bytes each, in
    bitset order) — so the same engine serves the in-proc scheduler's
    fn lane and the verify-service's cross-process wire table.

    One item costs 2 pairings + one G2 MSM regardless of signer count
    (the flat-in-committee-size property the QC plane exists for). A
    round of N items verifies as ONE random-linear-combination
    multi-pairing — N+1 pairings for the all-valid case instead of 2N —
    with bisection isolating invalid items on failure. Unparseable
    points are False verdicts, never an engine error (the bls_agg
    contract)."""
    n = len(items)
    if n == 0:
        return []
    from .shape_registry import default_shape_registry

    reg = default_shape_registry()
    reg.record_dispatch("qc_verify", reg.bucket_for(n))
    parsed: list = [None] * n  # (H(m), apk, sig) per parseable item
    out: list = [False] * n
    multi: list[int] = []  # items whose signer keys sum on the device
    for i, parts in enumerate(items):
        if len(parts) != 3:
            raise BLSError("qc_verify item needs (msg, agg_sig, pubkeys)")
        msg, sig_b, pks_b = parts
        if len(pks_b) == 0 or len(pks_b) % 192 != 0:
            continue
        try:
            sig = g1_from_bytes(sig_b)
            keys = [
                _qc_signer_key(pks_b[j : j + 192])
                for j in range(0, len(pks_b), 192)
            ]
        except BLSError:
            continue
        if len(keys) > 1:
            multi.append(i)
        parsed[i] = (hash_to_g1(msg, False), keys[0], sig)
    if multi:
        # the wire slices ARE the tree's leaves — no per-key
        # re-serialization on the aggregate path
        sums = _g2_sums([items[i][2] for i in multi])
        for i, apk in zip(multi, sums):
            parsed[i] = (parsed[i][0], apk, parsed[i][2])

    def check(idx: list[int]) -> bool:
        if len(idx) == 1:
            h, apk, sig = parsed[idx[0]]
            return _pairing_is_one([(h, apk), (c.g1_neg(sig), c.G2_GEN)])
        pairs = []
        acc_sig = c.G1_INF
        for i in idx:
            h, apk, sig = parsed[i]
            r = secrets.randbits(_BATCH_COEFF_BITS) | 1
            pairs.append((_g1_mul_point(h, r), apk))
            acc_sig = c.g1_add(acc_sig, _g1_mul_point(sig, r))
        pairs.append((c.g1_neg(acc_sig), c.G2_GEN))
        return _pairing_is_one(pairs)

    def solve(idx: list[int]) -> None:
        if check(idx):
            for i in idx:
                out[i] = True
            return
        if len(idx) == 1:
            return
        mid = len(idx) // 2
        solve(idx[:mid])
        solve(idx[mid:])

    live = [i for i in range(n) if parsed[i] is not None]
    if live:
        solve(live)
    return out


def verify_aggregated_different_messages(
    sig, messages: list[bytes], pubs: list[PublicKey]
) -> bool:
    """n+1 pairings: prod e(H(m_i), pk_i) * e(-sig, G2gen) == 1
    (bls_signatures.go:151-171)."""
    if len(messages) != len(pubs):
        raise BLSError("len(messages) != len(pub keys)")
    pairs = [
        (hash_to_g1(m, False), pk.key) for m, pk in zip(messages, pubs)
    ]
    pairs.append((c.g1_neg(sig), c.G2_GEN))
    return _pairing_is_one(pairs)


# --- byte-level public key (proof-prefixed, bls_signatures.go:195-258) ----


def public_key_to_bytes(pub: PublicKey) -> bytes:
    key_bytes = g2_to_bytes(pub.key)
    if pub.validity_proof is None:
        return b"\x00" + key_bytes
    sig_bytes = g1_to_bytes(pub.validity_proof)
    if len(sig_bytes) > 255:
        raise BLSError("validity proof too large to serialize")
    return bytes([len(sig_bytes)]) + sig_bytes + key_bytes


def public_key_from_bytes(data: bytes, trusted_source: bool) -> PublicKey:
    if not data:
        raise BLSError("tried to deserialize empty public key")
    proof_len = data[0]
    if proof_len == 0:
        if not trusted_source:
            raise BLSError(
                "tried to deserialize unvalidated public key from untrusted source"
            )
        return new_trusted_public_key(g2_from_bytes(data[1:]))
    if len(data) < 1 + proof_len:
        raise BLSError("invalid serialized public key")
    proof = g1_from_bytes(data[1 : 1 + proof_len])
    key = g2_from_bytes(data[1 + proof_len :])
    if trusted_source:
        return PublicKey(key, proof)
    return new_public_key(key, proof)


def priv_key_to_bytes(priv: int) -> bytes:
    # big.Int.Bytes() semantics: minimal big-endian, empty for zero
    n = (priv.bit_length() + 7) // 8
    return priv.to_bytes(n, "big")


def priv_key_from_bytes(data: bytes) -> int:
    return int.from_bytes(data, "big")


# --- key file (blssignatures/file.go) -------------------------------------


@dataclass
class FileBLSKey:
    pub_key: bytes
    priv_key: bytes

    def save(self, file_path: str) -> None:
        if not file_path:
            raise BLSError("cannot save bls key: filePath not set")
        data = json.dumps(
            {
                "pub_key": self.pub_key.hex(),
                "priv_key": self.priv_key.hex(),
            },
            indent=2,
        )
        tmp = file_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, file_path)


def gen_file_bls_key() -> FileBLSKey:
    priv = generate_priv_key()
    pub = pubkey_from_priv(priv)
    return FileBLSKey(
        pub_key=public_key_to_bytes(pub), priv_key=priv_key_to_bytes(priv)
    )


def load_bls_key(file_path: str) -> FileBLSKey:
    with open(file_path) as f:
        d = json.load(f)
    return FileBLSKey(
        pub_key=bytes.fromhex(d["pub_key"]), priv_key=bytes.fromhex(d["priv_key"])
    )


def load_or_gen_bls_key(file_path: str) -> FileBLSKey:
    if os.path.exists(file_path):
        return load_bls_key(file_path)
    k = gen_file_bls_key()
    k.save(file_path)
    return k


# --- consensus integration helpers ----------------------------------------


def signer_for(priv: int):
    """bls_signer callable for ConsensusState: batch_hash -> 96-byte G1 sig
    (the reference signs the raw BatchHash bytes — consensus/state.go:2560)."""

    def _sign(batch_hash: bytes) -> bytes:
        return g1_to_bytes(sign(priv, batch_hash))

    return _sign


class BLSKeyRegistry:
    """tm-validator-pubkey -> BLS public key mapping.

    Stands in for the L2 node's on-chain sequencer-set registry that backs
    l2Node.VerifySignature (the real Morph node resolves the tm key to a
    staked BLS key; reference call site consensus/state.go:2362-2379).
    """

    def __init__(self) -> None:
        self._by_tm: dict[bytes, PublicKey] = {}

    def register(self, tm_pubkey: bytes, pub: PublicKey) -> None:
        self._by_tm[bytes(tm_pubkey)] = pub

    def verifier(self):
        """(tm_pubkey, message, sig_bytes) -> bool|None, for MockL2Node.
        None = tm key not registered (registry lag for a newly added
        validator is not a cryptographic rejection — the relaying peer
        must not be punished for it)."""

        def _verify(tm_pubkey: bytes, message: bytes, sig_bytes: bytes):
            pub = self._by_tm.get(bytes(tm_pubkey))
            if pub is None:
                return None
            try:
                s = g1_from_bytes(bytes(sig_bytes))
            except BLSError:
                return False
            return verify(s, bytes(message), pub)

        return _verify

    def batch_verifier(self):
        """(tm_pubkeys, message, sig_bytes_list) -> list[bool] for
        MockL2Node.verify_signatures: one batched same-message check
        (2 pairings all-valid) instead of 2 per signature."""

        def _verify_batch(
            tm_pubkeys: list, message: bytes, sig_list: list
        ) -> list:
            out: list = [False] * len(tm_pubkeys)
            idx, pubs, sigs = [], [], []
            for i, (tk, sb) in enumerate(zip(tm_pubkeys, sig_list)):
                pub = self._by_tm.get(bytes(tk))
                if pub is None:
                    out[i] = None  # unknown key: not a crypto rejection
                    continue
                try:
                    s = g1_from_bytes(bytes(sb))
                except BLSError:
                    continue
                idx.append(i)
                pubs.append(pub)
                sigs.append(s)
            if idx:
                verdicts = verify_batch_same_message(bytes(message), pubs, sigs)
                for i, v in zip(idx, verdicts):
                    out[i] = v
            return out

        return _verify_batch
