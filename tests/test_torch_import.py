"""The port stands alone: neither it nor ``chip_smoke.py`` and
``chip_kernels.py`` import JAX or the JAX package, and its verbatim copies
match their originals modulo the import root (and the few comment lines
listed in REWORDED and PATHLESS)."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tendermint_tpu_torch"
REF = ROOT / "tendermint_tpu"

VERBATIM = [
    "crypto/ed25519.py",
    "crypto/keccak.py",
    "crypto/bls12_381.py",
    "crypto/secp256k1.py",
    "crypto/secp_native.py",
    "crypto/merlin.py",
    "crypto/ristretto.py",
    "crypto/sr25519.py",
    "crypto/shape_registry.py",
    "crypto/tmhash.py",
    "libs/protoio.py",
    "libs/bits.py",
    "obs/tracer.py",
    "types/canonical.py",
    "types/block_id.py",
    "types/part_set.py",
    "types/validator.py",
    "types/vote.py",
    "types/block.py",
    "types/quorum_cert.py",
    "types/evidence.py",
    "types/validator_set.py",
    "libs/log.py",
    "libs/service.py",
    "libs/metrics.py",
    "obs/report.py",
    "obs/ledger.py",
    "parallel/scheduler.py",
    "consensus/microbatch.py",
    "consensus/vote_batcher.py",
    # the in-process consensus core
    "libs/events.py",
    "libs/fail.py",
    "libs/autofile.py",
    "obs/quantile.py",
    "types/params.py",
    "types/genesis.py",
    "types/proposal.py",
    "types/block_meta.py",
    "types/vote_set.py",
    "types/priv_validator.py",
    "types/block_v2.py",
    "abci/__init__.py",
    "abci/types.py",
    "abci/client.py",
    "abci/kvstore.py",
    "l2node/__init__.py",
    "l2node/l2node.py",
    "l2node/mock.py",
    "l2node/notifier.py",
    "store/__init__.py",
    "store/kv.py",
    "store/block_store.py",
    "state/__init__.py",
    "state/state.py",
    "state/store.py",
    "state/execution.py",
    "evidence/verify.py",
    "privval/__init__.py",
    "privval/file_pv.py",
    "privval/signer.py",
    "consensus/batch.py",
    "consensus/ticker.py",
    "consensus/messages.py",
    "consensus/height_vote_set.py",
    "consensus/wal.py",
    "consensus/pacing.py",
    "consensus/bls_batcher.py",
    "consensus/commit_pipeline.py",
    "consensus/replay.py",
    "consensus/state_machine.py",
    # the p2p stack and the consensus reactor
    "libs/flowrate.py",
    "crypto/x25519.py",
    "crypto/aead.py",
    "crypto/xchacha.py",
    "p2p/__init__.py",
    "p2p/key.py",
    "p2p/node_info.py",
    "p2p/secret_connection.py",
    "p2p/mconn.py",
    "p2p/transport.py",
    "p2p/switch.py",
    "p2p/addrbook.py",
    "p2p/trust.py",
    "p2p/pex.py",
    "p2p/upnp.py",
    "p2p/fuzz.py",
    "consensus/reactor.py",
]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import tendermint_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    tendermint_tpu_torch.__path__, "tendermint_tpu_torch.")]
for name in ("consensus.state_machine", "state.execution", "l2node.mock",
             "parallel.mesh", "ops.shard_reduce", "consensus.reactor",
             "p2p.switch", "p2p.upnp", "crypto.aead", "libs.flowrate"):
    assert "tendermint_tpu_torch." + name in names, name
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")  # the smoke script, without running it
leaked = sorted(m for m in sys.modules
                if m == "tendermint_tpu" or m.startswith("tendermint_tpu."))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 40  # every module of the port imported


# The reference's comments cite its own change history by number; the
# port's copies word these lines without the numbers. Every other byte
# must match.
REWORDED = {
    "libs/metrics.py": [(
        "the PR 9 event-loop-bound regime made visible",
        "the event-loop-bound regime made visible",
    )],
    "obs/ledger.py": [(
        "telemetry only — PR 8 already\nhit its 1024-cap reading stats from it;",
        "telemetry only — a reader of its stats\nhits its 1024-cap;",
    )],
    "parallel/scheduler.py": [(
        "(PR 8 hit\n        # the 1024-cap reading stats from this ring)",
        "(a reader\n        # of its stats hits the 1024-cap of this ring)",
    )],
    "state/execution.py": [
        ("the event loop (the PR 9 follow-up): the check runs in an",
         "the event loop: the check runs in an"),
        ("round (the vote path made this move in PR 3). `klass` is the",
         "round (as the vote path does). `klass` is the"),
    ],
    "consensus/pacing.py": [(
        "The cluster tracer (PR 5) already measures",
        "The cluster tracer already measures",
    )],
    "p2p/pex.py": [(
        "(addrbook.go:1-947); round 2's flat scored table is gone.",
        "(addrbook.go:1-947), not a flat scored table.",
    )],
    # the port builds its native libraries into its own _kbuild/
    "crypto/aead.py": [(
        "with g++ into the package directory and loaded via ctypes — the framework's\n"
        "native equivalent of x/crypto's assembly AEAD (SURVEY.md §2.2). The Python",
        "with g++ into the port's build directory, _kbuild/, and loaded via ctypes —\n"
        "the framework's native equivalent of x/crypto's assembly AEAD (SURVEY.md\n"
        "§2.2). The Python",
    )],
}


# Copies whose docstrings cite the reference source by its checkout path
# cite it as "reference <file>" or "the reference" instead.
PATHLESS = {
    "crypto/bls12_381.py",
    "crypto/keccak.py",
    "crypto/merlin.py",
    "crypto/ristretto.py",
    "crypto/sr25519.py",
}


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_matches_reference(rel):
    ref = (REF / rel).read_text().replace("tendermint_tpu", "tendermint_tpu_torch")
    if rel in PATHLESS:
        ref = re.sub(r"/\w+/reference/", "reference ", ref)
        ref = re.sub(r"/\w+/reference\)", "the reference)", ref)
    for old, new in REWORDED.get(rel, []):
        assert ref.count(old) == 1, old
        ref = ref.replace(old, new)
    assert (PORT / rel).read_text() == ref


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    [ROOT / "chip_smoke.py", ROOT / "chip_kernels.py"] + sorted(PORT.rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_import_statements(path):
    roots = _imported_roots(path)
    assert "jax" not in roots and "tendermint_tpu" not in roots, roots


def _lazy_imports(path: pathlib.Path):
    """(line, module path) of every relative import inside a function
    body, resolved against the file's package."""
    pkg = path.parent.relative_to(PORT).parts
    out = []

    def visit(node, nested):
        for ch in ast.iter_child_nodes(node):
            inner = nested or isinstance(ch, (ast.FunctionDef, ast.AsyncFunctionDef))
            if nested and isinstance(ch, ast.ImportFrom) and ch.level:
                base = list(pkg[: len(pkg) - (ch.level - 1)])
                mod = base + (ch.module.split(".") if ch.module else [])
                for alias in ch.names:
                    out.append((ch.lineno, mod, alias.name))
            visit(ch, inner)

    visit(ast.parse(path.read_text()), False)
    return out


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT))
)
def test_lazy_imports_resolve_inside_the_port(path):
    """Every `from ..x import y` inside a function body names a module (or
    a name of a package) of the port, so no lazy path reaches an unported
    module at run time."""
    for line, mod, name in _lazy_imports(path):
        target = PORT.joinpath(*mod)
        as_module = target.with_suffix(".py").is_file() or (target / "__init__.py").is_file()
        as_submodule = (target / f"{name}.py").is_file() or (target / name / "__init__.py").is_file()
        assert as_module or as_submodule, f"{path.name}:{line}: {'.'.join(mod)}.{name}"


def test_aead_builds_its_own_library_into_the_port():
    """The port's AEAD builds native/chacha20poly1305.cpp into its own
    _kbuild/ (with the source-hash sidecar) and loads that file, never the
    JAX package's tendermint_tpu/_tmcrypto.*.so."""
    from tendermint_tpu_torch.crypto import _native_build, aead

    lib = aead._native_lib()
    assert lib is not None and aead.using_native()
    path = pathlib.Path(lib._name).resolve()
    assert path.parent == PORT / "_kbuild", path
    assert path.name.startswith("_tmcrypto.") and path.suffix == ".so"
    assert REF.resolve() not in path.parents
    want = _native_build._src_hash(str(ROOT / "native" / "chacha20poly1305.cpp"))
    assert _native_build._stored_hash(str(path)) == want


_PRELOAD = r"""
import sys
sys.modules["jax"] = None
from tendermint_tpu_torch.crypto import _native_build, aead, bls_native, secp_native
t = _native_build.preload_in_background()
t.join(600)
assert not t.is_alive()
for mod in (bls_native, secp_native, aead):
    assert mod._loader._tried and mod._loader._lib is not None, mod.__name__
    print(mod._loader._lib._name)
"""


def test_preload_in_background_loads_all_three_native_libraries():
    out = subprocess.run(
        [sys.executable, "-c", _PRELOAD],
        cwd=ROOT, capture_output=True, text=True, timeout=660,
    )
    assert out.returncode == 0, out.stderr
    paths = [pathlib.Path(line).resolve() for line in out.stdout.split()]
    assert [p.name.split(".")[0] for p in paths] == ["_tmbls", "_tmsecp", "_tmcrypto"]
    assert all(p.parent == PORT / "_kbuild" for p in paths), paths
