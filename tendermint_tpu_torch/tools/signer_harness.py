"""Remote-signer conformance harness.

Reference: tools/tm-signer-harness (test_harness.go) — connects a real
remote signer to a listener endpoint and drives the conformance checks:
1. the signer reports a pubkey matching the expected validator key,
2. it signs a proposal and a vote correctly,
3. it REFUSES to double-sign (same HRS, different block),
4. it re-signs the identical payload idempotently,
5. ping keeps the connection alive.

Usage (in-proc demo): python -m tendermint_tpu_torch.tools.signer_harness
Against an external signer: python -m tendermint_tpu_torch.tools.signer_harness --listen PORT
(then point the signer at 127.0.0.1:PORT).
"""

import argparse
import asyncio
import sys

sys.path.insert(0, ".")

from tendermint_tpu_torch.privval.signer import (  # noqa: E402
    RemoteSignerError,
    SignerClient,
    SignerListenerEndpoint,
    SignerServer,
)
from tendermint_tpu_torch.types.block_id import BlockID  # noqa: E402
from tendermint_tpu_torch.types.part_set import PartSetHeader  # noqa: E402
from tendermint_tpu_torch.types.proposal import Proposal  # noqa: E402
from tendermint_tpu_torch.types.vote import Vote, VoteType  # noqa: E402

CHAIN_ID = "harness-chain"


async def run_harness(endpoint: SignerListenerEndpoint, expected_pub=None):
    client = SignerClient(endpoint)
    passed = 0

    pub = await client.get_pub_key()
    assert pub is not None and len(pub.data) == 32, "bad pubkey"
    if expected_pub is not None:
        assert pub.data == expected_pub.data, "pubkey mismatch"
    print(f"1. pubkey ok: {pub.data.hex()[:16]}…")
    passed += 1

    bid = BlockID(b"\x01" * 32, PartSetHeader(1, b"\x01" * 32))
    prop = Proposal(height=10, round=0, pol_round=-1, block_id=bid,
                    timestamp_ns=1)
    await client.sign_proposal(CHAIN_ID, prop)
    assert prop.signature and pub.verify(
        prop.sign_bytes(CHAIN_ID), prop.signature
    ), "proposal signature invalid"
    print("2. proposal signing ok")
    passed += 1

    vote = Vote(
        type=VoteType.PRECOMMIT, height=10, round=0, block_id=bid,
        timestamp_ns=2, validator_address=pub.address(), validator_index=0,
    )
    await client.sign_vote(CHAIN_ID, vote)
    assert vote.signature and pub.verify(
        vote.sign_bytes(CHAIN_ID), vote.signature
    ), "vote signature invalid"
    print("3. vote signing ok")
    passed += 1

    conflicting = Vote(
        type=VoteType.PRECOMMIT, height=10, round=0,
        block_id=BlockID(b"\x02" * 32, PartSetHeader(1, b"\x02" * 32)),
        timestamp_ns=2, validator_address=pub.address(), validator_index=0,
    )
    try:
        await client.sign_vote(CHAIN_ID, conflicting)
        raise AssertionError("signer double-signed!")
    except RemoteSignerError:
        print("4. double-sign refused ok")
        passed += 1

    same = Vote(
        type=VoteType.PRECOMMIT, height=10, round=0, block_id=bid,
        timestamp_ns=2, validator_address=pub.address(), validator_index=0,
    )
    await client.sign_vote(CHAIN_ID, same)
    assert same.signature == vote.signature, "idempotent re-sign differs"
    print("5. idempotent re-sign ok")
    passed += 1

    assert await client.ping(), "ping failed"
    print("6. ping ok")
    passed += 1
    return passed


async def main_inproc():
    """Demo: harness against our own FilePV-backed SignerServer."""
    import tempfile

    from tendermint_tpu_torch.privval.file_pv import FilePV

    with tempfile.TemporaryDirectory() as d:
        pv = FilePV.generate(f"{d}/key.json", f"{d}/state.json")
        endpoint = SignerListenerEndpoint()
        await endpoint.start()
        server = SignerServer(pv, "127.0.0.1", endpoint.port)
        await server.start()
        await endpoint.wait_for_signer()
        n = await run_harness(endpoint, expected_pub=pv.get_pub_key())
        await server.stop()
        await endpoint.stop()
        print(f"PASSED {n}/6 conformance checks")


async def main_listen(port: int):
    endpoint = SignerListenerEndpoint(port=port)
    await endpoint.start()
    print(f"listening for a remote signer on 127.0.0.1:{endpoint.port}…")
    await endpoint.wait_for_signer(timeout=120)
    n = await run_harness(endpoint)
    await endpoint.stop()
    print(f"PASSED {n}/6 conformance checks")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--listen", type=int, default=0,
                    help="wait for an external signer on this port")
    args = ap.parse_args()
    if args.listen:
        asyncio.run(main_listen(args.listen))
    else:
        asyncio.run(main_inproc())
