"""The port's XChaCha20-Poly1305 and armored key-at-rest against the
contract of ``tests/test_xchacha.py`` (draft-irtf-cfrg-xchacha vectors, the
CRC24 armor, passphrase encryption), each test on both packages' roots
with one body; and parity with the JAX package on seeded inputs: the same
key, nonce, plaintext and associated data give the same ciphertext and tag,
the same HChaCha20 subkey, and each package opens and decrypts what the
other sealed and armored. Tolerance: exact (bytes)."""

from __future__ import annotations

import importlib

import numpy as np
import pytest

ROOTS = pytest.mark.parametrize(
    "root", ["tendermint_tpu_torch", "tendermint_tpu"], ids=["port", "ref"])


def xchacha(root: str):
    return importlib.import_module(f"{root}.crypto.xchacha")


PORT = xchacha("tendermint_tpu_torch")
REF = xchacha("tendermint_tpu")


@ROOTS
def test_hchacha20_draft_vector(root):
    # draft-irtf-cfrg-xchacha §2.2.1
    key = bytes.fromhex(
        "000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f")
    nonce = bytes.fromhex("000000090000004a0000000031415927")
    assert xchacha(root).hchacha20(key, nonce) == bytes.fromhex(
        "82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc")


@ROOTS
def test_xchacha_aead_draft_vector(root):
    # draft-irtf-cfrg-xchacha §A.3
    x = xchacha(root)
    key = bytes(range(0x80, 0xA0))
    nonce = bytes.fromhex("404142434445464748494a4b4c4d4e4f5051525354555657")
    ad = bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    pt = (b"Ladies and Gentlemen of the class of '99: If I could offer you "
          b"only one tip for the future, sunscreen would be it.")
    ct = x.seal(key, nonce, pt, ad)
    assert ct[-16:] == bytes.fromhex("c0875924c1c7987947deafd8780acf49")
    assert x.open_(key, nonce, ct, ad) == pt
    bad = ct[:5] + bytes([ct[5] ^ 1]) + ct[6:]
    with pytest.raises(Exception):
        x.open_(key, nonce, bad, ad)


@ROOTS
def test_armor_roundtrip_and_checksum(root):
    x = xchacha(root)
    payload = b"\x01\x02secret-material" * 5
    text = x.armor_encode(payload, {"kdf": "scrypt"})
    got, headers = x.armor_decode(text)
    assert got == payload and headers["kdf"] == "scrypt"
    # a corrupted base64 body character: CRC24 catches it
    lines = text.splitlines()
    body_i = next(i for i, ln in enumerate(lines)
                  if ln and ":" not in ln and not ln.startswith(("-", "=")))
    lines[body_i] = ("B" if lines[body_i][0] != "B" else "C") + lines[body_i][1:]
    with pytest.raises(ValueError):
        x.armor_decode("\n".join(lines))


@ROOTS
def test_encrypt_decrypt_key_at_rest(root):
    x = xchacha(root)
    priv = bytes(range(64))
    armored = x.encrypt_key(priv, "correct horse")
    assert "BEGIN TENDERMINT PRIVATE KEY" in armored
    assert x.decrypt_key(armored, "correct horse") == priv
    with pytest.raises(ValueError):
        x.decrypt_key(armored, "wrong pass")


def test_xchacha_bytes_match_reference():
    """Seeded keys, 24-byte nonces, plaintexts and associated data: equal
    subkeys, ciphertexts and tags; each package opens the other's."""
    rng = np.random.default_rng(20261017)
    for n in (0, 1, 64, 65, 300, 4096):
        key, nonce = rng.bytes(32), rng.bytes(24)
        pt, ad = rng.bytes(n), rng.bytes(int(rng.integers(0, 32)))
        assert PORT.hchacha20(key, nonce[:16]) == REF.hchacha20(key, nonce[:16])
        ct = PORT.seal(key, nonce, pt, ad)
        assert ct == REF.seal(key, nonce, pt, ad), n
        assert REF.open_(key, nonce, ct, ad) == pt
        assert PORT.open_(key, nonce, ct, ad) == pt


def test_armored_key_crosses_packages():
    """A key armored by one package decrypts in the other, both ways, and
    the armor of a seeded payload is the same text."""
    rng = np.random.default_rng(64)
    priv = rng.bytes(64)
    assert REF.decrypt_key(PORT.encrypt_key(priv, "pass"), "pass") == priv
    assert PORT.decrypt_key(REF.encrypt_key(priv, "pass"), "pass") == priv
    headers = {"kdf": "bcrypt", "salt": rng.bytes(16).hex().upper()}
    assert PORT.armor_encode(priv, headers) == REF.armor_encode(priv, headers)
