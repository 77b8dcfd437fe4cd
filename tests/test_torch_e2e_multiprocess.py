"""The port across real OS processes: the contract of the reference's
``tests/test_e2e_multiprocess.py`` (its 3 scenarios, the same N = 4, its
deadlines and assertions unchanged), every node a
``python -m tendermint_tpu_torch --home H start --device cpu`` child booted
from the port's own ``testnet`` output:

- one of 4 validators dies by SIGKILL (no flush, no goodbye), the
  survivors commit 2 more heights, the victim restarts from its possibly
  torn WAL and catches up, all agree on one block hash; then a fresh full
  node blocksyncs the chain and a statesync node bootstraps from a
  snapshot with no genesis-era blocks;
- the upgrade to sequencer mode across processes, read from the
  ``sequencer_mode`` / ``v2_height`` status fields;
- statesync into an external gRPC app process, that app the port's
  ``abci-cli kvstore --transport grpc`` or the reference's: the contract is
  bytes on the wire, so a port node restores its snapshot into either.

Only the reference app's child touches ``tendermint_tpu``. The children
verify on the host (``TM_TPU_MIN_DEVICE_BATCH`` past any batch, as the
reference's do) and run one OpenMP thread each (``OMP_NUM_THREADS=1``: a
test-only setting; a 4-validator net does no tensor work worth a pool).
Tolerance: exact (block hashes, heights).
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4  # BFT floor: killing 1 of 4 leaves >2/3 power (3 of 3 would not)
PKG = "tendermint_tpu_torch"


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _rpc(port: int, method: str, timeout: float = 3.0, **params):
    body = json.dumps(
        {"jsonrpc": "2.0", "method": method, "params": params, "id": 1}
    ).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/",
        data=body,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.loads(resp.read())
    if "error" in out and out["error"]:
        raise RuntimeError(str(out["error"]))
    return out["result"]


def _height(port: int) -> int:
    return int(_rpc(port, "status")["sync_info"]["latest_block_height"])


def _wait_heights(ports, target: int, deadline_s: float) -> None:
    t0 = time.monotonic()
    last = {}
    while time.monotonic() - t0 < deadline_s:
        done = 0
        for p in ports:
            try:
                last[p] = _height(p)
            except Exception:
                last[p] = last.get(p, -1)
            if last.get(p, -1) >= target:
                done += 1
        if done == len(ports):
            return
        time.sleep(1.0)
    raise TimeoutError(f"heights {last} never reached {target}")


def _child_env() -> dict:
    env = dict(os.environ)
    env["TM_TPU_SKIP_WARM"] = "1"
    # pure-host verification: a 4-validator net's batches never reach the
    # kernels' plain versions, and a blocksync window must not either
    env["TM_TPU_MIN_DEVICE_BATCH"] = str(1 << 30)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _popen(args, log_path: str, env: dict) -> subprocess.Popen:
    log = open(log_path, "ab")
    try:
        return subprocess.Popen(
            args,
            cwd=REPO,
            env=env,
            stdout=log,
            stderr=log,
            start_new_session=True,  # survives pytest's signal handling
        )
    finally:
        log.close()  # the child holds its own inherited descriptor


def _spawn(home: str):
    return _popen(
        [sys.executable, "-m", PKG, "--home", home, "start", "--device", "cpu"],
        os.path.join(home, "node.log"),
        _child_env(),
    )


def _kill_all(procs) -> None:
    for p in procs:
        if p is not None and p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def _boot_testnet(base, chain_id, configure_node=None):
    """Generate an N-node testnet with the port's CLI, rewrite its fixed
    ports to free ephemeral ones (parallel CI runs must not collide),
    apply the per-node `configure_node(i, cfg, homes)` hook, and return
    (homes, rpc_ports, peers)."""
    from tendermint_tpu_torch.config import Config
    from tendermint_tpu_torch.p2p.key import NodeKey

    rc = subprocess.run(
        [
            sys.executable,
            "-m",
            PKG,
            "testnet",
            "--v",
            str(N),
            "--output",
            base,
            "--chain-id",
            chain_id,
        ],
        cwd=REPO,
        capture_output=True,
        timeout=120,
    )
    assert rc.returncode == 0, rc.stderr.decode()

    ports = _free_ports(2 * N)
    p2p_ports = ports[:N]
    rpc_ports = ports[N:]
    homes = [os.path.join(base, f"node{i}") for i in range(N)]
    ids = [
        NodeKey.load_or_generate(os.path.join(h, "config", "node_key.json")).id
        for h in homes
    ]
    peers = ",".join(
        f"{ids[i]}@127.0.0.1:{p2p_ports[i]}" for i in range(N)
    )
    for i, h in enumerate(homes):
        cfg = Config.load(h)
        cfg.root_dir = h
        cfg.p2p.laddr = f"tcp://127.0.0.1:{p2p_ports[i]}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{rpc_ports[i]}"
        cfg.p2p.persistent_peers = peers
        if configure_node is not None:
            configure_node(i, cfg, homes)
        cfg.save()
    return homes, rpc_ports, peers


def _observer_home(base, name, genesis_from, peers, configure=None):
    """A fresh NON-validator node home (key not in genesis, empty store)
    joined to the live net; returns (home, rpc port)."""
    from tendermint_tpu_torch.config import Config

    home = os.path.join(base, name)
    cfg = Config()
    cfg.root_dir = home
    cfg.ensure_dirs()
    shutil.copy(
        os.path.join(genesis_from, "config", "genesis.json"),
        os.path.join(home, "config", "genesis.json"),
    )
    op2p, orpc = _free_ports(2)
    cfg.p2p.laddr = f"tcp://127.0.0.1:{op2p}"
    cfg.rpc.laddr = f"tcp://127.0.0.1:{orpc}"
    cfg.p2p.persistent_peers = peers
    if configure is not None:
        configure(cfg)
    cfg.save()
    return home, orpc


def _statesync_knobs(rpc_ports):
    """(trust height, configure): statesync from the survivors' RPC with
    a trust root three heights below node 0's tip."""
    trust_h = max(2, _height(rpc_ports[0]) - 3)
    commit = _rpc(rpc_ports[0], "commit", height=trust_h)
    trust_hash = commit["signed_header"]["commit"]["block_id"]["hash"]

    def configure(cfg):
        cfg.statesync.enable = True
        cfg.statesync.rpc_servers = (
            f"127.0.0.1:{rpc_ports[0]},127.0.0.1:{rpc_ports[1]}"
        )
        cfg.statesync.trust_height = trust_h
        cfg.statesync.trust_hash = trust_hash.lower()
        cfg.statesync.discovery_time = 3.0

    return trust_h, configure


def test_multiprocess_testnet_kill9_restart(tmp_path):
    base = str(tmp_path / "net")
    homes, rpc_ports, peers = _boot_testnet(base, "mp-e2e")

    procs = {i: _spawn(homes[i]) for i in range(N)}
    try:
        # all nodes commit (torch import + dial storms are slow on 1 core)
        _wait_heights(rpc_ports, 3, deadline_s=150)

        # perturb: SIGKILL the last validator — no flush, no goodbye
        victim = N - 1
        os.kill(procs[victim].pid, signal.SIGKILL)
        procs[victim].wait(timeout=30)

        # BFT with (N-1)/N: survivors keep committing
        survivors = rpc_ports[:victim]
        target = max(_height(p) for p in survivors) + 2
        _wait_heights(survivors, target, deadline_s=120)

        # restart the victim from its (possibly torn) on-disk state:
        # WAL replay + handshake + gossip catchup
        procs[victim] = _spawn(homes[victim])
        catchup = max(_height(p) for p in survivors) + 1
        _wait_heights([rpc_ports[victim]], catchup, deadline_s=150)

        # all agree on the chain at a common height
        h = min(_height(p) for p in rpc_ports)
        hashes = {
            _rpc(p, "block", height=h)["block_id"]["hash"]
            for p in rpc_ports
        }
        assert len(hashes) == 1, f"nodes diverged at height {h}"

        def spawn_observer(name, configure=None):
            home, orpc = _observer_home(base, name, homes[0], peers, configure)
            procs[name] = _spawn(home)
            return orpc

        # a FRESH full node joins and blocksyncs the whole chain from the
        # live net — the observer role (reference e2e "full" node mode)
        frpc = spawn_observer("fullnode")
        target = max(_height(p) for p in rpc_ports)
        _wait_heights([frpc], target, deadline_s=150)
        hf = _rpc(frpc, "block", height=h)["block_id"]["hash"]
        assert hf in hashes, "full node synced a different chain"

        # a STATESYNC node bootstraps from a snapshot (light-client trust
        # root over the survivors' RPC + chunks over p2p) instead of
        # replaying blocks — reference test/e2e statesync node mode
        _, cfg_statesync = _statesync_knobs(rpc_ports)
        srpc = spawn_observer("statesyncnode", cfg_statesync)
        target = max(_height(p) for p in rpc_ports)
        _wait_heights([srpc], target, deadline_s=180)
        # proof it STATE-synced: its store has no early blocks
        try:
            _rpc(srpc, "block", height=1)
            assert False, "statesync node has genesis-era blocks"
        except RuntimeError:
            pass  # -32000 no block — expected
    finally:
        _kill_all(procs.values())


def test_multiprocess_upgrade_switch_to_sequencer(tmp_path):
    """The Morph upgrade across real processes: a 4-validator net commits
    through switch_height, every node stops BFT, the keyed node becomes THE
    sequencer producing ECDSA-signed BlockV2s, and the other three follow
    via the broadcast reactor over p2p — asserted through the status RPC's
    sequencer fields."""
    from tendermint_tpu_torch.crypto import secp256k1
    from tendermint_tpu_torch.sequencer import LocalSigner

    seq_key = secp256k1.PrivKey.from_secret(b"mp-sequencer")
    seq_addr = LocalSigner(seq_key).address().hex()
    SWITCH = 4

    def configure(i, cfg, homes):
        cfg.consensus.switch_height = SWITCH
        cfg.sequencer.block_interval = 0.2
        cfg.sequencer.sequencer_addresses = seq_addr
        if i == 0:
            with open(
                os.path.join(homes[i], "config", "sequencer_key"), "w"
            ) as f:
                f.write(seq_key.bytes().hex())
            cfg.sequencer.sequencer_key_file = "config/sequencer_key"

    base = str(tmp_path / "net")
    homes, rpc_ports, peers = _boot_testnet(
        base, "mp-upgrade", configure_node=configure
    )

    procs = {i: _spawn(homes[i]) for i in range(N)}
    try:
        # BFT runs to the switch; then every node reports sequencer mode
        # and the V2 chain advances past the BFT head on ALL nodes
        t0 = time.monotonic()
        last = {}
        while time.monotonic() - t0 < 210:
            # a crashed node must not keep counting via stale samples
            assert all(
                pr.poll() is None for pr in procs.values()
            ), "a node process died during the switch"
            done = 0
            for p in rpc_ports:
                try:
                    si = _rpc(p, "status")["sync_info"]
                    last[p] = (
                        si["latest_block_height"],
                        si["sequencer_mode"],
                        si["v2_height"],
                    )
                except Exception:
                    last[p] = last.get(p, (0, False, 0))
                h_, seq, v2 = last[p]
                if seq and v2 >= SWITCH + 3:
                    done += 1
            if done == len(rpc_ports):
                break
            time.sleep(1.0)
        else:
            raise TimeoutError(f"sequencer switch never converged: {last}")

        # BFT stopped at the switch height everywhere
        for p in rpc_ports:
            assert last[p][0] <= SWITCH, last
    finally:
        _kill_all(procs.values())


# the external app's package: the port's CLI, or the reference's (its only
# use of tendermint_tpu here; the gRPC service name on the wire is one)
APPS = {"port": PKG, "reference": "tendermint_tpu"}


@pytest.mark.parametrize("app", sorted(APPS))
def test_multiprocess_statesync_external_grpc_app(tmp_path, app):
    """The reference's statesync shape — a fresh node bootstrapping from
    peers while its app is a SEPARATE process — run end-to-end: a
    4-validator net commits, a new node with proxy_app=tcp://... --abci
    grpc statesyncs a snapshot, the chunks are restored INTO the external
    `abci-cli kvstore --transport grpc` process (the port's or the
    reference's), and the node follows the live chain."""
    base = str(tmp_path / "net")
    homes, rpc_ports, peers = _boot_testnet(base, "mp-ss-grpc")

    procs = {i: _spawn(homes[i]) for i in range(N)}
    app_proc = None
    try:
        # snapshots exist once the chain commits a few heights
        _wait_heights(rpc_ports, 5, deadline_s=180)

        # the external ABCI app: its own OS process, empty state
        (app_port,) = _free_ports(1)
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["OMP_NUM_THREADS"] = "1"
        app_proc = _popen(
            [
                sys.executable,
                "-m",
                APPS[app],
                "abci-cli",
                "kvstore",
                "--transport",
                "grpc",
                "--port",
                str(app_port),
            ],
            os.path.join(base, "app.log"),
            env,
        )

        trust_h, cfg_statesync = _statesync_knobs(rpc_ports)

        def configure(cfg):
            cfg.base.proxy_app = f"tcp://127.0.0.1:{app_port}"
            cfg.base.abci = "grpc"
            cfg_statesync(cfg)

        home, orpc = _observer_home(base, "grpcstatesync", homes[0], peers,
                                    configure)
        procs["grpcstatesync"] = _spawn(home)

        target = max(_height(p) for p in rpc_ports)
        _wait_heights([orpc], target, deadline_s=240)

        # statesynced, not replayed: no genesis-era blocks
        try:
            _rpc(orpc, "block", height=1)
            assert False, "grpc statesync node has genesis-era blocks"
        except RuntimeError:
            pass

        # the EXTERNAL app process (started empty) now holds restored
        # state: its abci_info reports the post-snapshot height
        info = _rpc(orpc, "abci_info")["response"]
        assert info["data"] == "kvstore"
        assert int(info["last_block_height"]) >= trust_h, info

        # and the chain it serves matches the net — compare at a height
        # the statesync node actually stores (its store starts at the
        # snapshot base, above trust_h)
        ho = _height(orpc)
        got = _rpc(orpc, "block", height=ho)["block_id"]["hash"]
        _wait_heights(rpc_ports, ho, deadline_s=60)
        want = {
            _rpc(p, "block", height=ho)["block_id"]["hash"]
            for p in rpc_ports
        }
        assert got in want, "grpc statesync node on a different chain"
    finally:
        _kill_all([app_proc, *procs.values()])
