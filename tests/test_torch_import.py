"""The port stands alone: it imports neither JAX nor the JAX package, and
its verbatim copies match their originals modulo the import root."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "tendermint_tpu_torch"
REF = ROOT / "tendermint_tpu"

VERBATIM = [
    "crypto/ed25519.py",
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
]

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import tendermint_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    tendermint_tpu_torch.__path__, "tendermint_tpu_torch.")]
for name in names:
    importlib.import_module(name)
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
    assert int(out.stdout.strip()) >= 20  # every module of the port imported


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_matches_reference(rel):
    ref = (REF / rel).read_text().replace("tendermint_tpu", "tendermint_tpu_torch")
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
    [ROOT / "chip_smoke.py"] + sorted(PORT.rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_import_statements(path):
    roots = _imported_roots(path)
    assert "jax" not in roots and "tendermint_tpu" not in roots, roots
