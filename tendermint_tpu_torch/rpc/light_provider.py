"""RPC-backed light-block provider.

Reference: light/provider/http (provider over rpc/client/http). Fetches
the proof for a height from a node's RPC and assembles a LightBlock.
Against a lightserve-enabled node (tendermint_tpu_torch/lightserve) that is
ONE `light_block` round trip to the proof cache; against a legacy node
it falls back to `commit` + `validators`, paginating the validator set
(the route serves at most one 100-entry page — a >100 committee fetched
as a single page would silently truncate and never re-hash to
validators_hash). Transient transport failures retry with bounded
exponential backoff before the provider reports "no block".

The JSON-RPC transport is rpc/client.HTTPClient (one client
implementation package-wide); `RPCClient` remains as its historical
alias here.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from .client import HTTPClient as RPCClient, RPCClientError  # noqa: F401

# bounded retry-with-backoff on transient provider failures: attempts
# sleep base * 2^i between tries (the chain keeps producing while we
# wait, so give up fast — the client's primary-replacement logic is the
# real recovery path)
DEFAULT_RETRIES = 3
DEFAULT_BACKOFF_BASE_S = 0.05
DEFAULT_BACKOFF_MAX_S = 1.0

_VALS_PAGE = 100
# hard ceiling on rows accepted from one provider: providers are
# UNTRUSTED (a light client's whole threat model), and a malicious
# `total` must bound to a few hundred round trips, not a billion — any
# real committee fits, and an oversized set fails validators_hash anyway
_VALS_MAX = 20_000


def header_from_json(hdr: dict):
    """Parse a header from its RPC JSON form (rpc/core._header_json) and
    return a types.Header whose .hash() is recomputed locally — callers
    verifying untrusted responses must never trust a supplied hash."""
    from ..types.block import Header
    from ..types.block_id import BlockID
    from ..types.part_set import PartSetHeader

    return Header(
        chain_id=hdr["chain_id"],
        height=hdr["height"],
        time_ns=hdr["time"],
        last_block_id=BlockID(
            hash=bytes.fromhex(hdr["last_block_id"]["hash"]),
            part_set_header=PartSetHeader(
                hdr["last_block_id"]["parts"]["total"],
                bytes.fromhex(hdr["last_block_id"]["parts"]["hash"]),
            ),
        ),
        last_commit_hash=bytes.fromhex(hdr.get("last_commit_hash", "")),
        data_hash=bytes.fromhex(hdr.get("data_hash", "")),
        validators_hash=bytes.fromhex(hdr["validators_hash"]),
        next_validators_hash=bytes.fromhex(hdr["next_validators_hash"]),
        consensus_hash=bytes.fromhex(hdr["consensus_hash"]),
        app_hash=bytes.fromhex(hdr["app_hash"]),
        last_results_hash=bytes.fromhex(hdr["last_results_hash"]),
        evidence_hash=bytes.fromhex(hdr["evidence_hash"]),
        proposer_address=bytes.fromhex(hdr["proposer_address"]),
        batch_hash=bytes.fromhex(hdr.get("batch_hash", "")),
        **(
            {
                "version_block": int(hdr["version"]["block"]),
                "version_app": int(hdr["version"]["app"]),
            }
            if "version" in hdr
            else {}
        ),
    )


def commit_from_json(cm: dict):
    """Parse a commit from its RPC JSON form (rpc/core._commit_json)."""
    from ..types.block import BlockIDFlag, Commit, CommitSig  # noqa: F401
    from ..types.block_id import BlockID
    from ..types.part_set import PartSetHeader

    return Commit(
        height=cm["height"],
        round=cm["round"],
        block_id=BlockID(
            hash=bytes.fromhex(cm["block_id"]["hash"]),
            part_set_header=PartSetHeader(
                cm["block_id"]["parts"]["total"],
                bytes.fromhex(cm["block_id"]["parts"]["hash"]),
            ),
        ),
        signatures=[
            CommitSig(
                block_id_flag=s["block_id_flag"],
                validator_address=bytes.fromhex(s["validator_address"]),
                timestamp_ns=s["timestamp"],
                signature=bytes.fromhex(s["signature"]),
                bls_signature=bytes.fromhex(s.get("bls_signature", "")),
                qc_signature=bytes.fromhex(s.get("qc_signature", "")),
            )
            for s in cm["signatures"]
        ],
    )


def qc_from_json(q: dict):
    """Parse a QuorumCertificate from its RPC JSON form
    (rpc/core._qc_json)."""
    from ..libs.bits import BitArray
    from ..types.block_id import BlockID
    from ..types.part_set import PartSetHeader
    from ..types.quorum_cert import QuorumCertificate

    return QuorumCertificate(
        height=q["height"],
        round=q["round"],
        block_id=BlockID(
            hash=bytes.fromhex(q["block_id"]["hash"]),
            part_set_header=PartSetHeader(
                q["block_id"]["parts"]["total"],
                bytes.fromhex(q["block_id"]["parts"]["hash"]),
            ),
        ),
        signers=BitArray.from_bytes(
            int(q["signers_size"]), bytes.fromhex(q["signers"])
        ),
        agg_signature=bytes.fromhex(q["agg_signature"]),
    )


def validators_from_json(rows: list):
    """Parse validator rows from their RPC JSON form into a
    ValidatorSet (rpc/core._validator_json)."""
    from ..types.validator import Validator, pubkey_from_type
    from ..types.validator_set import ValidatorSet

    return ValidatorSet(
        [
            Validator(
                pubkey_from_type(
                    val.get("pub_key_type", "ed25519"),
                    bytes.fromhex(val["pub_key"]),
                ),
                val["voting_power"],
                val.get("proposer_priority", 0),
                bls_pub_key=bytes.fromhex(val.get("bls_pub_key", "")),
            )
            for val in rows
        ]
    )


class RPCProvider:
    """light.Provider over a node's RPC (reference light/provider/http)."""

    def __init__(
        self,
        chain_id: str,
        addr: str,
        max_retries: int = DEFAULT_RETRIES,
        backoff_base_s: float = DEFAULT_BACKOFF_BASE_S,
        backoff_max_s: float = DEFAULT_BACKOFF_MAX_S,
        sleep=asyncio.sleep,
    ):
        self.chain_id = chain_id
        self.client = RPCClient(addr)
        self._addr = addr
        self.max_retries = max(1, int(max_retries))
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._sleep = sleep
        # None = unknown; probed on first fetch, latched False against
        # pre-lightserve servers so every later fetch goes straight to
        # the commit+validators fallback
        self._has_light_block: Optional[bool] = None
        self.retries = 0  # transient retries performed (observability)

    def id(self) -> str:
        return self._addr

    async def _call_retry(self, method: str, **params):
        """One RPC call with bounded retry-with-backoff on TRANSIENT
        transport failures. Server-answered errors (RPCClientError:
        unknown method, no block at height) are not transient and
        surface immediately."""
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries):
            if attempt:
                self.retries += 1
                await self._sleep(
                    min(
                        self.backoff_base_s * (2 ** (attempt - 1)),
                        self.backoff_max_s,
                    )
                )
            try:
                return await self.client.call(method, **params)
            except RPCClientError:
                raise
            except (
                ConnectionError,
                OSError,
                asyncio.TimeoutError,
                asyncio.IncompleteReadError,
            ) as e:
                last = e
                # no close() here: HTTPClient already tears down dead
                # connections under ITS lock, and the provider is shared
                # by concurrent witness fetches — an unlocked close from
                # one call's retry path would kill a sibling's in-flight
                # connection
        raise last if last is not None else ConnectionError("rpc failed")

    async def _fetch_validator_rows(self, height) -> list:
        """Every page of the validator set (the route caps a response at
        100 rows; pre-pagination servers return everything and report
        total == len, terminating after one page)."""
        rows: list = []
        page = 1
        max_pages = -(-_VALS_MAX // _VALS_PAGE)
        while True:
            v = await self._call_retry(
                "validators",
                height=height,
                page=page,
                per_page=_VALS_PAGE,
            )
            got = v.get("validators", [])
            rows.extend(got)
            total = min(int(v.get("total", len(rows))), _VALS_MAX)
            if len(rows) >= total or not got or page >= max_pages:
                return rows
            page += 1

    async def light_block(self, height: int):
        from ..light.types import LightBlock

        try:
            if self._has_light_block is not False:
                try:
                    res = await self._call_retry(
                        "light_block", height=height if height else None
                    )
                    self._has_light_block = True
                    lb = res["light_block"]
                    cm = lb["signed_header"].get("commit")
                    return LightBlock(
                        header_from_json(lb["signed_header"]["header"]),
                        commit_from_json(cm) if cm else None,
                        validators_from_json(
                            lb["validator_set"]["validators"]
                        ),
                        qc=(
                            qc_from_json(lb["qc"]) if lb.get("qc") else None
                        ),
                    )
                except RPCClientError as e:
                    if e.code == -32601:  # legacy node: no serving plane
                        self._has_light_block = False
                    else:
                        return None  # answered: no block at that height
            c = await self._call_retry(
                "commit", height=height if height else None
            )
            rows = await self._fetch_validator_rows(
                height if height else c["signed_header"]["header"]["height"]
            )
        except RPCClientError:
            return None  # server answered: nothing at that height
        except (ConnectionError, RuntimeError, OSError, EOFError):
            # transport dead after retries (EOFError covers
            # asyncio.IncompleteReadError: a server dying mid-response
            # body must report "no block", not leak the exception)
            return None
        return LightBlock(
            header_from_json(c["signed_header"]["header"]),
            commit_from_json(c["signed_header"]["commit"]),
            validators_from_json(rows),
        )
