"""Kernel 8's hash (``tm_challenge``) and ``tm_reduce_mod_l`` on the CPU.

The kernels run only on the card, but their code is plain C++:
``challenge_warp``, ``sha512_compress`` and ``sc_reduce`` of
``ops/csrc/sha512_device.cuh``. g++ builds that header with the host
harness ``tests/sha512_lanes_host.cpp`` into ``tendermint_tpu_torch/_kbuild/``,
where 32 host threads play a warp's lanes over one staging buffer: each
block is staged with the 16-byte pieces of the card's coalesced loads,
then each lane reads its row and compresses; a barrier is ``__syncwarp``,
and lanes that disagree on their count of barriers fail the call. The
challenges k = SHA-512(R || A || M) mod L are held against hashlib with
``% L``, the port's plain version (``sha512.challenge_batch_plain``) and
the JAX package's ``challenge_batch``, exactly: ragged rows of 0-1,000-byte
messages (1-9 blocks inside one warp), block counts below 0 and above the
buffer's (the plain version's clamp), buffers of 1 and 16 blocks, and 1,
33 and 2,048 rows (a partial last warp). The reduction alone is held
against ``int % L`` on digests SHA-512 cannot be made to give.
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

from tendermint_tpu.ops import sha512 as jsha
from tendermint_tpu_torch.crypto import ed25519 as host
from tendermint_tpu_torch.ops import sha512

ROOT = pathlib.Path(__file__).resolve().parent.parent
HARNESS = ROOT / "tests" / "sha512_lanes_host.cpp"
HEADER = ROOT / "tendermint_tpu_torch" / "ops" / "csrc" / "sha512_device.cuh"
BUILD_DIR = ROOT / "tendermint_tpu_torch" / "_kbuild"
L = host.L


@pytest.fixture(scope="module")
def lib():
    """The harness, built once per source content (g++, about a second)."""
    digest = hashlib.sha256(HARNESS.read_bytes() + HEADER.read_bytes()).hexdigest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"sha512_lanes_host.{digest[:16]}.so"
    if not so.exists():
        tmp = so.with_suffix(f".build.{os.getpid()}")
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-pthread", "-shared", "-fPIC",
             "-Wno-unknown-pragmas", "-o", str(tmp), str(HARNESS)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.tm_host_challenge.argtypes = [vp, i, vp, vp, i, i]
    lib.tm_host_challenge.restype = i
    lib.tm_host_reduce_mod_l.argtypes = [vp, vp, i]
    lib.tm_host_reduce_mod_l.restype = None
    return lib


def _aligned(a: np.ndarray) -> np.ndarray:
    """A C-contiguous copy of `a` whose data is 16-byte aligned, as the
    card's 16-byte loads and stores need."""
    raw = np.empty(a.nbytes + 16, dtype=np.uint8)
    off = (-raw.ctypes.data) % 16
    out = raw[off: off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def host_challenge(lib, buf: np.ndarray, cnt: np.ndarray, fault: int = 0):
    """The harness's tm_challenge on [b, nblk * 128] u8 and [b] int32 ->
    ([b, 32] u8, return code)."""
    b, width = buf.shape
    buf = _aligned(buf)
    cnt = np.ascontiguousarray(cnt, dtype=np.int32)
    out = _aligned(np.full((b, 32), 0xAB, dtype=np.uint8))
    rc = lib.tm_host_challenge(buf.ctypes.data, width // 128, cnt.ctypes.data,
                               out.ctypes.data, b, fault)
    return np.array(out), rc


def ragged_rows(rng, b: int, max_len: int = 1000):
    """b rows of R || A || M with M of 0..max_len random bytes (row 0's
    max_len, row 1's empty), padded by the port's pad_messages: (rows,
    buf, counts)."""
    lens = [max_len, 0] + rng.integers(0, max_len + 1, b).tolist()
    rows = [(rng.bytes(32), rng.bytes(32), rng.bytes(int(n))) for n in lens[:b]]
    buf, cnt = sha512.pad_messages([m for _, _, m in rows],
                                   prefix_pairs=[r + a for r, a, _ in rows])
    return rows, buf, cnt


def oracle(rows) -> np.ndarray:
    return np.array([
        list((int.from_bytes(hashlib.sha512(r + a + m).digest(), "little") % L)
             .to_bytes(32, "little")) for r, a, m in rows], dtype=np.uint8)


def plain(buf, cnt) -> np.ndarray:
    return sha512.challenge_batch_plain(
        torch.from_numpy(buf), torch.from_numpy(cnt.astype(np.int32))).numpy()


@pytest.mark.parametrize("b", [1, 33, 2048])
def test_lanes_challenge_equals_hashlib_on_ragged_rows(lib, b):
    """Messages of 0-1,000 bytes, so rows of 1-9 blocks share a warp in a
    16-block buffer (the 2,048 rows are the smoke's shape); 33 rows leave
    a warp of one live lane. Equal to hashlib with % L."""
    rows, buf, cnt = ragged_rows(np.random.default_rng(1000 + b), b)
    assert buf.shape[1] == 16 * 128
    got, rc = host_challenge(lib, buf, cnt)
    assert rc == 0, "the 32 lanes fell out of lock-step"
    np.testing.assert_array_equal(got, oracle(rows))
    if b == 2048:
        assert len(set(cnt.tolist())) == 9, "rows of 1-9 blocks"


def test_lanes_challenge_equals_plain_on_ragged_rows(lib):
    """The plain version on 80 ragged rows (two full warps and a partial
    one) gives the same bytes as the lanes."""
    rows, buf, cnt = ragged_rows(np.random.default_rng(80), 80)
    got, rc = host_challenge(lib, buf, cnt)
    assert rc == 0
    np.testing.assert_array_equal(got, plain(buf, cnt))
    np.testing.assert_array_equal(got, oracle(rows))


def _clamp_cases(rng, b: int, nblk: int, max_len: int):
    """b ragged rows in a buffer of at least nblk blocks with the counts
    of a third of the rows pushed below 0, to 0 or above the buffer's."""
    _, buf, cnt = ragged_rows(rng, b, max_len)
    width = max(buf.shape[1], nblk * 128)
    buf = np.pad(buf, ((0, 0), (0, width - buf.shape[1])))
    cnt = cnt.copy()
    for i in range(0, b, 3):
        cnt[i] = (-5, 0, nblk + 3, -1, width // 128 + 100)[(i // 3) % 5]
    return buf, cnt


@pytest.mark.parametrize("nblk,max_len", [(1, 40), (16, 1000)])
def test_lanes_clamp_counts_as_plain_and_jax(lib, nblk, max_len):
    """Counts below 0 and above the buffer's block count are clamped to
    [0, nblk] (the plain version keeps the blocks below the count): 33
    rows in a buffer of 1 block and of 16, against the plain version and
    the JAX package's challenge_batch on the CPU."""
    buf, cnt = _clamp_cases(np.random.default_rng(nblk), 33, nblk, max_len)
    assert buf.shape[1] == nblk * 128
    got, rc = host_challenge(lib, buf, cnt)
    assert rc == 0
    np.testing.assert_array_equal(got, plain(buf, cnt))
    jgot = np.asarray(jax.jit(jsha.challenge_batch)(jnp.asarray(buf), jnp.asarray(cnt)))
    np.testing.assert_array_equal(got, jgot)


def test_lanes_harness_fails_a_lane_out_of_lock_step(lib):
    """A lane that skips a barrier makes the call fail, so the equality
    tests above ran the lanes in lock-step."""
    _, buf, cnt = ragged_rows(np.random.default_rng(5), 40)
    _, rc = host_challenge(lib, buf, cnt, fault=1)
    assert rc == -1


DIGESTS = [2**512 - 1, L - 1, L, L + 1, 2 * L, 2 * L - 1, 2**252, 0, 1,
           2**256 - 1, (2**512 - 1) // L * L, (2**512 - 1) // L * L - 1]


def test_reduce_mod_l_on_edge_digests(lib):
    """sc_reduce of the smoke's digest list (2^512 - 1, L - 1, L, L + 1,
    2L, ...) and 52 random digests: int % L, the plain version and the
    JAX package's reduce_mod_l."""
    rng = np.random.default_rng(64)
    vals = DIGESTS + [int.from_bytes(rng.bytes(64), "little") for _ in range(52)]
    dig = np.array([list(v.to_bytes(64, "little")) for v in vals], dtype=np.uint8)
    out = _aligned(np.zeros((len(vals), 32), dtype=np.uint8))
    lib.tm_host_reduce_mod_l(np.ascontiguousarray(dig).ctypes.data, out.ctypes.data,
                             len(vals))
    assert [int.from_bytes(bytes(r), "little") for r in out] == [v % L for v in vals]
    np.testing.assert_array_equal(out, sha512.reduce_mod_l_plain(torch.from_numpy(dig)).numpy())
    np.testing.assert_array_equal(out, np.asarray(jax.jit(jsha.reduce_mod_l)(jnp.asarray(dig))))


def test_chip_kernels_split_patches_fit_and_build(tmp_path):
    """chip_kernels.py's kernel 8 split builds: each variant's patches fit
    this tree's sources, and the patched header still builds with the
    harness (g++), so a chip call does not fail on it."""
    import chip_kernels

    src = HEADER.read_text()
    for name, patches in chip_kernels.SHA_SPLITS.items():
        assert chip_kernels.fitting_patches(str(ROOT), [patches]) == patches, name
        text = src
        for fname, old, new in patches:
            assert fname == HEADER.name, name
            assert text.count(old) == 1, name
            text = text.replace(old, new)
        csrc = tmp_path / name.replace(" ", "_") / "tendermint_tpu_torch" / "ops" / "csrc"
        csrc.mkdir(parents=True)
        (csrc / HEADER.name).write_text(text)
        tests = csrc.parents[2] / "tests"
        tests.mkdir()
        (tests / HARNESS.name).write_text(HARNESS.read_text())
        subprocess.run(
            ["g++", "-O1", "-std=c++17", "-pthread", "-shared", "-fPIC",
             "-Wno-unknown-pragmas", "-o", str(tests / "h.so"), str(tests / HARNESS.name)],
            check=True, capture_output=True, timeout=120,
        )
