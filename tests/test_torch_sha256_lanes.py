"""Kernel 9's hash (``tm_sha256``) on the CPU.

The kernel runs only on the card, but its code is plain C++:
``sha256_warp`` and ``sha256_compress`` of ``ops/csrc/sha256_device.cuh``.
g++ builds that header with the host harness ``tests/sha256_lanes_host.cpp``
into ``tendermint_tpu_torch/_kbuild/``, where 32 host threads play a warp's
lanes over one staging buffer: each block is staged with the 16-byte
pieces of the card's coalesced loads, then each lane reads its row and
compresses; a barrier is ``__syncwarp``, and lanes that disagree on their
count of barriers fail the call. The digests are held against hashlib,
the port's plain version (``sha256.sha256_batch_plain``) and the JAX
package's jitted ``sha256_batch``, exactly: ragged rows of 0-1,100 bytes
(1-18 blocks inside one warp), the padding's edges (55, 56, 64, 119 and
120 bytes), block counts below 0 and above the buffer's (the plain
version's clamp), 1, 33 and 4,096 rows (a partial last warp), and the
merkle shapes: the L2 block's leaf batch (``Data.hash()``'s padded
buffer), ``merkle_leaf_hash``'s one-block leaves and
``merkle_inner_hash``'s two-block rows.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tendermint_tpu.ops import sha256 as jsha
from tendermint_tpu_torch.crypto import merkle
from tendermint_tpu_torch.ops import sha256

ROOT = pathlib.Path(__file__).resolve().parent.parent
HARNESS = ROOT / "tests" / "sha256_lanes_host.cpp"
HEADER = ROOT / "tendermint_tpu_torch" / "ops" / "csrc" / "sha256_device.cuh"
BUILD_DIR = ROOT / "tendermint_tpu_torch" / "_kbuild"

_J_SHA = jax.jit(jsha.sha256_batch)


def _gxx(src: pathlib.Path, out: pathlib.Path, opt: str = "-O2") -> None:
    subprocess.run(
        ["g++", opt, "-std=c++17", "-pthread", "-shared", "-fPIC",
         "-Wno-unknown-pragmas", "-o", str(out), str(src)],
        check=True, capture_output=True, timeout=120,
    )


@pytest.fixture(scope="module")
def lib():
    """The harness, built once per source content (g++, about a second)."""
    digest = hashlib.sha256(HARNESS.read_bytes() + HEADER.read_bytes()).hexdigest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"sha256_lanes_host.{digest[:16]}.so"
    if not so.exists():
        tmp = so.with_suffix(f".build.{os.getpid()}")
        _gxx(HARNESS, tmp)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tm_host_sha256.argtypes = [vp, i, vp, vp, i, i]
    lib.tm_host_sha256.restype = i
    return lib


def _aligned(a: np.ndarray) -> np.ndarray:
    """A C-contiguous copy of `a` whose data is 16-byte aligned, as the
    card's 16-byte loads and stores need."""
    raw = np.empty(a.nbytes + 16, dtype=np.uint8)
    off = (-raw.ctypes.data) % 16
    out = raw[off: off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def host_sha256(lib, buf: np.ndarray, cnt: np.ndarray, fault: int = 0):
    """The harness's tm_sha256 on [b, nblk * 64] u8 and [b] int32 ->
    ([b, 32] u8, return code)."""
    b, width = buf.shape
    buf = _aligned(buf)
    cnt = np.ascontiguousarray(cnt, dtype=np.int32)
    out = _aligned(np.full((b, 32), 0xAB, dtype=np.uint8))
    rc = lib.tm_host_sha256(buf.ctypes.data, width // 64, cnt.ctypes.data,
                            out.ctypes.data, b, fault)
    return np.array(out), rc


def lanes(lib, buf, cnt) -> np.ndarray:
    got, rc = host_sha256(lib, buf, cnt)
    assert rc == 0, "the 32 lanes fell out of lock-step"
    return got


def ragged(rng, b: int, max_len: int = 1100) -> list[bytes]:
    """b messages of 0..max_len random bytes (row 0's max_len, row 1's
    empty)."""
    lens = [max_len, 0] + rng.integers(0, max_len + 1, b).tolist()
    return [rng.bytes(int(n)) for n in lens[:b]]


def oracle(msgs) -> np.ndarray:
    return np.array([list(hashlib.sha256(m).digest()) for m in msgs], dtype=np.uint8)


def plain(buf, cnt) -> np.ndarray:
    return sha256.sha256_batch_plain(
        torch.from_numpy(buf), torch.from_numpy(np.asarray(cnt, dtype=np.int32))).numpy()


def jax_sha(buf, cnt) -> np.ndarray:
    return np.asarray(_J_SHA(jnp.asarray(buf), jnp.asarray(np.asarray(cnt, dtype=np.int32))))


@pytest.mark.parametrize("b", [1, 33, 4096])
def test_lanes_sha256_equals_hashlib_on_ragged_rows(lib, b):
    """Messages of 0-1,100 bytes, so rows of 1-18 blocks share a warp in an
    18-block buffer; 33 rows leave a warp of one live lane; 4,096 rows
    are the leaf batch's 128 warps. Equal to hashlib."""
    msgs = ragged(np.random.default_rng(2000 + b), b)
    buf, cnt = sha256.pad_messages(msgs)
    assert buf.shape[1] == 18 * 64
    np.testing.assert_array_equal(lanes(lib, buf, cnt), oracle(msgs))
    if b == 4096:
        assert set(cnt.tolist()) == set(range(1, 19)), "rows of 1-18 blocks"


def test_lanes_sha256_equals_plain_and_jax_on_ragged_rows(lib):
    """80 ragged rows (two full warps and a partial one): the plain version
    and the JAX package's jitted sha256_batch give the lanes' bytes."""
    msgs = ragged(np.random.default_rng(80), 80)
    buf, cnt = sha256.pad_messages(msgs)
    got = lanes(lib, buf, cnt)
    np.testing.assert_array_equal(got, oracle(msgs))
    np.testing.assert_array_equal(got, plain(buf, cnt))
    np.testing.assert_array_equal(got, jax_sha(buf, cnt))


def test_lanes_sha256_on_the_padding_edges(lib):
    """55 bytes (the last length of one block), 56 (the first of two), 64,
    119 and 120, with and without the leaf prefix, inside one warp with
    rows of 0-200 bytes: hashlib, the plain version and the JAX package."""
    rng = np.random.default_rng(55)
    edges = [rng.bytes(n) for n in (55, 56, 64, 119, 120, 0, 1, 63, 65)]
    msgs = edges + ragged(rng, 23, 200)
    for prefix in (b"", b"\x00"):
        buf, cnt = sha256.pad_messages(msgs, prefix=prefix)
        got = lanes(lib, buf, cnt)
        np.testing.assert_array_equal(got, oracle([prefix + m for m in msgs]))
        np.testing.assert_array_equal(got, plain(buf, cnt))
        np.testing.assert_array_equal(got, jax_sha(buf, cnt))


def _clamp_cases(rng, b: int, nblk: int, max_len: int):
    """b ragged rows in a buffer of at least nblk blocks with the counts
    of a third of the rows pushed below 0, to 0 or above the buffer's."""
    buf, cnt = sha256.pad_messages(ragged(rng, b, max_len))
    width = max(buf.shape[1], nblk * 64)
    buf = np.pad(buf, ((0, 0), (0, width - buf.shape[1])))
    cnt = cnt.copy()
    for i in range(0, b, 3):
        cnt[i] = (-5, 0, nblk + 3, -1, width // 64 + 100)[(i // 3) % 5]
    return buf, cnt


@pytest.mark.parametrize("nblk,max_len", [(1, 40), (18, 1100)])
def test_lanes_clamp_counts_as_plain_and_jax(lib, nblk, max_len):
    """Counts below 0 and above the buffer's block count are clamped to
    [0, nblk] (the plain version keeps the blocks below the count): 33
    rows in a buffer of 1 block and of 18, against the plain version and
    the JAX package's sha256_batch on the CPU."""
    buf, cnt = _clamp_cases(np.random.default_rng(nblk), 33, nblk, max_len)
    assert buf.shape[1] == nblk * 64
    got = lanes(lib, buf, cnt)
    np.testing.assert_array_equal(got, plain(buf, cnt))
    np.testing.assert_array_equal(got, jax_sha(buf, cnt))


def test_lanes_merkle_leaf_and_inner_shapes(lib):
    """merkle_leaf_hash's buffer (4,096 one-block rows, 0x00 || 32 bytes)
    and merkle_inner_hash's (2,048 two-block rows, 0x01 || l || r), built by
    the port's helpers' own buffers: the lanes equal hashlib's RFC 6962
    hashes and the JAX package's merkle helpers."""
    rng = np.random.default_rng(6962)
    leaves = rng.integers(0, 256, (4096, 32), dtype=np.uint8)
    buf = np.zeros((4096, 64), dtype=np.uint8)
    buf[:, 1:33] = leaves
    buf[:, 33] = 0x80
    buf[:, 56:64] = np.frombuffer((33 * 8).to_bytes(8, "big"), dtype=np.uint8)
    got = lanes(lib, buf, np.ones(4096, dtype=np.int32))
    assert [bytes(r) for r in got] == [merkle.leaf_hash(x.tobytes()) for x in leaves]
    np.testing.assert_array_equal(
        got[:64], np.asarray(jax.jit(jsha.merkle_leaf_hash)(jnp.asarray(leaves[:64]))))
    left, right = leaves[0::2], leaves[1::2]
    buf = np.zeros((2048, 128), dtype=np.uint8)
    buf[:, 0] = 1
    buf[:, 1:33] = left
    buf[:, 33:65] = right
    buf[:, 65] = 0x80
    buf[:, 120:128] = np.frombuffer((65 * 8).to_bytes(8, "big"), dtype=np.uint8)
    got = lanes(lib, buf, np.full(2048, 2, dtype=np.int32))
    assert [bytes(r) for r in got] == [
        merkle.inner_hash(x.tobytes(), y.tobytes()) for x, y in zip(left, right)]
    np.testing.assert_array_equal(got[:64], np.asarray(jax.jit(jsha.merkle_inner_hash)(
        jnp.asarray(left[:64]), jnp.asarray(right[:64]))))


def test_lanes_the_l2_leaf_batch(lib):
    """Data.hash()'s leaf batch as the device route builds it: 4,000
    transactions of 100-1,024 bytes and two payload leaves under the 0x00
    prefix, padded to the 4,096 bucket and the block axis (17 for the
    longest) to 32; equal to hashlib, and its first 160 rows (five warps)
    to the plain version."""
    rng = np.random.default_rng(4002)
    txs = [rng.bytes(int(k)) for k in rng.integers(100, 1025, 4000)]
    msgs = [b"\x00" + tx for tx in txs] + [b"\x01" + rng.bytes(256), b"\x02" + rng.bytes(128)]
    msgs += [b""] * (4096 - len(msgs))
    buf, cnt = sha256.pad_messages(msgs, prefix=b"\x00")
    nblk = buf.shape[1] // 64
    buf = np.pad(buf, ((0, 0), (0, ((1 << (nblk - 1).bit_length()) - nblk) * 64)))
    assert buf.shape == (4096, 32 * 64) and int(cnt.max()) == 17
    got = lanes(lib, buf, cnt)
    np.testing.assert_array_equal(got, oracle([b"\x00" + m for m in msgs]))
    np.testing.assert_array_equal(got[:160], plain(buf[:160], cnt[:160]))


def test_lanes_harness_fails_a_lane_out_of_lock_step(lib):
    """A lane that skips a barrier makes the call fail, so the equality
    tests above ran the lanes in lock-step."""
    buf, cnt = sha256.pad_messages(ragged(np.random.default_rng(5), 40))
    _, rc = host_sha256(lib, buf, cnt, fault=1)
    assert rc == -1


def test_chip_kernels_sha256_split_patches_fit_and_build(tmp_path):
    """chip_kernels.py's kernel 9 variants (the split builds and the block
    size): each variant's first alternative is the one that fits this
    tree's sources, and the patched sources still build with the harness
    (g++; the harness includes the header, so a patch of
    sha256_kernels.cu is checked to fit alone), so a chip call does not
    fail on them."""
    import chip_kernels

    csrc = HEADER.parent
    variants = {**chip_kernels.SHA256_SPLITS, **chip_kernels.SHA256_BLOCK_VARIANTS}
    for name, alternatives in variants.items():
        patches = chip_kernels.fitting_patches(str(ROOT), alternatives)
        assert patches == alternatives[0], name
        d = tmp_path / name.replace(" ", "_")
        out_csrc = d / "tendermint_tpu_torch" / "ops" / "csrc"
        out_csrc.mkdir(parents=True)
        for f in (HEADER.name, "sha256_kernels.cu"):
            (out_csrc / f).write_text((csrc / f).read_text())
        for fname, old, new in patches:
            path = out_csrc / fname
            text = path.read_text()
            assert text.count(old) == 1, name
            path.write_text(text.replace(old, new))
        tests = d / "tests"
        tests.mkdir()
        (tests / HARNESS.name).write_text(HARNESS.read_text())
        _gxx(tests / HARNESS.name, tests / "h.so", "-O1")
