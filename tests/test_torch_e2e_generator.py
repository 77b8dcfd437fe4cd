"""The randomized-manifest e2e on the port: the contract of the reference's
``tests/test_e2e_generator.py`` (its 3 tests, their assertions unchanged).
The generator's determinism and topology constraints run on both packages'
generators (the port's ``tendermint_tpu_torch.tools.testnet_generator``,
the reference's ``tools/testnet_generator.py`` loaded by file path), a new
case holds the two to the same manifest for seeds 0-23, and one seeded
manifest (7, or ``TM_TPU_E2E_SEED``) is booted as port processes with the
reference's perturbation schedule, its deadlines and its agreement check.
Tolerance: exact (manifests, block hashes).
"""

import importlib.util
import os
import signal

import pytest

from tendermint_tpu_torch.tools import testnet_generator as port_gen

from .test_torch_e2e_multiprocess import (
    _free_ports,
    _height,
    _kill_all,
    _rpc,
    _spawn,
    _wait_heights,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_generator():
    """The reference's tools/testnet_generator.py as a module of its own
    name (its module level imports nothing of either package)."""
    path = os.path.join(REPO, "tools", "testnet_generator.py")
    spec = importlib.util.spec_from_file_location("_ref_testnet_generator", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GENERATORS = {"port": lambda: port_gen, "reference": _reference_generator}


@pytest.mark.parametrize("pkg", sorted(GENERATORS))
def test_manifest_determinism_and_constraints(pkg):
    gen = GENERATORS[pkg]()
    generate_manifest, TOPOLOGIES = gen.generate_manifest, gen.TOPOLOGIES
    for seed in range(24):
        m1 = generate_manifest(seed)
        m2 = generate_manifest(seed)
        assert m1 == m2, f"seed {seed} not deterministic"
        vals = [n for n in m1["nodes"] if n["mode"] == "validator"]
        assert len(vals) >= 4
        assert m1["topology"] in TOPOLOGIES
        # at most one perturbed validator (BFT margin of f=1 at 4-5 vals)
        assert sum(n["perturb"] != "none" for n in vals) <= 1
    # seeds actually vary the shapes
    shapes = {
        (
            generate_manifest(s)["topology"],
            len(generate_manifest(s)["nodes"]),
        )
        for s in range(24)
    }
    assert len(shapes) > 3, f"generator barely varies: {shapes}"


@pytest.mark.parametrize("pkg", sorted(GENERATORS))
def test_topologies_are_connected(pkg):
    """Every topology yields a connected peer graph (so gossip reaches
    everyone) for all generated sizes."""
    gen = GENERATORS[pkg]()
    for topo in gen.TOPOLOGIES:
        for n in (4, 5, 6, 7):
            adj = {i: set(gen.peer_indices(topo, i, n)) for i in range(n)}
            # persistent peers dial both ways: undirected closure
            for i, ps in list(adj.items()):
                for j in ps:
                    adj[j].add(i)
            seen = {0}
            stack = [0]
            while stack:
                for j in adj[stack.pop()]:
                    if j not in seen:
                        seen.add(j)
                        stack.append(j)
            assert seen == set(range(n)), f"{topo} n={n} disconnected"


def test_both_generators_give_equal_manifests():
    """A seed names one net whichever package generates it: manifests,
    topologies and peer lists equal for seeds 0-23."""
    ref = _reference_generator()
    assert port_gen.TOPOLOGIES == ref.TOPOLOGIES
    assert port_gen.PERTURBATIONS == ref.PERTURBATIONS
    for seed in range(24):
        m = port_gen.generate_manifest(seed)
        assert m == ref.generate_manifest(seed), f"seed {seed}"
        n = len(m["nodes"])
        for i in range(n):
            assert port_gen.peer_indices(m["topology"], i, n) == \
                ref.peer_indices(m["topology"], i, n)


def test_randomized_manifest_net_runs(tmp_path):
    seed = int(os.environ.get("TM_TPU_E2E_SEED", "7"))
    manifest = port_gen.generate_manifest(seed)
    layout = port_gen.materialize(manifest, str(tmp_path / "net"), _free_ports)

    procs = {}
    try:
        for name, spec in layout.items():
            procs[name] = _spawn(spec["home"])
        rpc_ports = [s["rpc_port"] for s in layout.values()]
        val_ports = [
            s["rpc_port"]
            for s in layout.values()
            if s["mode"] == "validator"
        ]
        _wait_heights(
            val_ports, manifest["initial_height_target"], deadline_s=180
        )

        # perturbation schedule
        for name, spec in layout.items():
            if spec["perturb"] == "kill_restart":
                os.kill(procs[name].pid, signal.SIGKILL)
                procs[name].wait(timeout=30)
                survivors = [
                    s["rpc_port"]
                    for n2, s in layout.items()
                    if n2 != name and s["mode"] == "validator"
                ]
                target = max(_height(p) for p in survivors) + 2
                _wait_heights(survivors, target, deadline_s=150)
                procs[name] = _spawn(spec["home"])
                catchup = max(_height(p) for p in survivors) + 1
                _wait_heights([spec["rpc_port"]], catchup, deadline_s=180)

        # everyone (validators AND full nodes) reaches a common height
        # and agrees on the block hash there
        target = max(_height(p) for p in val_ports)
        _wait_heights(rpc_ports, target, deadline_s=180)
        h = min(_height(p) for p in rpc_ports)
        hashes = {
            _rpc(p, "block", height=h)["block_id"]["hash"]
            for p in rpc_ports
        }
        assert len(hashes) == 1, (
            f"seed {seed} ({manifest['topology']}): fork at height {h}"
        )
    finally:
        _kill_all(procs.values())
