"""RPC core — the route table over node internals.

Reference: rpc/core/routes.go:10-43 (the morph fork's table: the mempool
broadcast routes are deleted along with the mempool) + rpc/core/*.go
handlers reading the node environment (node/node.go:1174-1200). Bytes are
hex-encoded in results (the reference mixes hex and base64; hex
throughout keeps the surface predictable).

No gRPC API route: the fork's rpc/grpc surface is Ping-only after the
mempool removal (rpc/grpc/api.go:10-13 — BroadcastTx went with the
mempool), and `health` over JSON-RPC/websocket is this framework's
equivalent liveness probe. The ABCI process boundary (the load-bearing
RPC in the reference) is covered by abci/client.py's socket protocol +
abci-cli.
"""

from __future__ import annotations

import json
from typing import Optional

from ..types.event_bus import Query


def _from_hex(value, what: str = "hash", required: bool = False) -> bytes:
    """Parse a hex string param (optional 0x prefix) into bytes, raising a
    clean JSON-RPC invalid-params error instead of a bare ValueError.
    `required` distinguishes a mandatory param (tx hash, evidence) from a
    genuinely optional one (header_by_hash's empty lookup)."""
    if not value:
        if required:
            from .server import RPCError

            raise RPCError(-32602, f"missing required param: {what}")
        return b""
    s = value[2:] if isinstance(value, str) and value.startswith("0x") else value
    try:
        return bytes.fromhex(s)
    except (ValueError, TypeError):
        from .server import RPCError

        raise RPCError(-32602, f"invalid {what}: not hex") from None


def _hex(b: bytes) -> str:
    return b.hex().upper()


def _seq_started(node) -> bool:
    return bool(
        getattr(
            getattr(node, "sequencer_reactor", None),
            "sequencer_started",
            False,
        )
    )


class RPCCore:
    def __init__(self, node):
        self.node = node

    # --- route table (reference routes.go:10-43) ----------------------------

    def routes(self) -> dict:
        return {
            # info
            "health": self.health,
            "status": self.status,
            "net_info": self.net_info,
            "blockchain": self.blockchain,
            "genesis": self.genesis,
            "genesis_chunked": self.genesis_chunked,
            "header": self.header,
            "header_by_hash": self.header_by_hash,
            "block": self.block,
            "block_by_hash": self.block_by_hash,
            "block_results": self.block_results,
            "commit": self.commit,
            "validators": self.validators,
            "consensus_state": self.consensus_state,
            "dump_consensus_state": self.dump_consensus_state,
            # light-client serving plane (tendermint_tpu_torch/lightserve):
            # cached proof routes, present when the node assembled one
            **(
                {
                    "light_block": self.light_block,
                    "signed_header": self.signed_header,
                    "validator_set": self.validator_set,
                }
                if getattr(self.node, "lightserve", None) is not None
                else {}
            ),
            "dump_traces": self.dump_traces,
            "dump_health": self.dump_health,
            "dump_dispatch_ledger": self.dump_dispatch_ledger,
            # on-demand profiling hooks (obs/profiler.py), present when
            # the node assembled a ProfileCapture
            **(
                {
                    "profile_start": self.profile_start,
                    "profile_stop": self.profile_stop,
                }
                if getattr(self.node, "profiler", None) is not None
                else {}
            ),
            "consensus_params": self.consensus_params,
            "tx": self.tx,
            "tx_search": self.tx_search,
            "block_search": self.block_search,
            # abci
            "abci_info": self.abci_info,
            "abci_query": self.abci_query,
            # evidence
            "broadcast_evidence": self.broadcast_evidence,
            # help
            "help": lambda: {"routes": sorted(self.routes())},
            # unsafe (gated on config rpc.unsafe, reference routes.go:46-50)
            **(
                {
                    "dial_seeds": self.dial_seeds,
                    "dial_peers": self.dial_peers,
                }
                if getattr(self.node.config.rpc, "unsafe", False)
                else {}
            ),
        }

    # --- handlers ------------------------------------------------------------

    def health(self) -> dict:
        """Liveness + health verdict (the reference's `health` returns
        `{}`; readiness tooling needs the verdict, not just an open
        socket). `status` is the monitor roll-up — "ok" when the live
        health plane is disabled, so probes against a minimal node
        don't read "disabled" as unhealthy; `monitored` disambiguates."""
        from ..obs.health import VERDICT_NAMES

        n = self.node
        monitor = getattr(n, "health_monitor", None)
        bs = n.block_store
        return {
            "node_id": getattr(getattr(n, "node_key", None), "id", ""),
            "latest_block_height": bs.height,
            "catching_up": not (
                n.consensus.is_running or _seq_started(n)
            ),
            "monitored": monitor is not None,
            "status": (
                VERDICT_NAMES[monitor.status()]
                if monitor is not None
                else "ok"
            ),
        }

    def dump_health(self) -> dict:
        """The full health-plane verdict: per-subsystem/per-detector
        SLO burn-rate state + the recent incident log (the structured
        form of the `health.incident` events in dump_traces)."""
        monitor = getattr(self.node, "health_monitor", None)
        if monitor is None:
            return {"enabled": False}
        out = monitor.verdict()
        out["enabled"] = True
        return out

    def dump_dispatch_ledger(self, entries=None, **_kw) -> dict:
        """Device-cost ledger (obs/ledger.py): per-class device-seconds
        and shares, fill-efficiency distribution, padding-waste totals,
        requests-per-dispatch amortization, plus the newest structured
        round entries (`entries` param, default 128) and the
        shape-registry counters the totals reconcile against."""
        from ..crypto.shape_registry import default_shape_registry
        from ..obs.ledger import default_ledger

        sched = getattr(self.node, "verify_scheduler", None)
        ledger = sched.ledger if sched is not None else default_ledger()
        try:
            n = int(entries) if entries is not None else 128
        except (TypeError, ValueError):
            from .server import RPCError

            raise RPCError(
                -32602, "invalid entries: not an integer"
            ) from None
        return {
            "enabled": sched is not None,
            "summary": ledger.summary(),
            # entries <= 0 means "summary only" (ledger.entries treats
            # limit 0 as unlimited, which is the opposite of what a
            # caller asking for zero entries wants)
            "entries": ledger.entries(limit=n) if n > 0 else [],
            "shape_registry": default_shape_registry().snapshot(),
        }

    def profile_start(self, label="", device=True, **_kw) -> dict:
        """Arm an on-demand profiling session: a torch.profiler trace
        (guarded, CPU-backend tolerant — unavailability is reported
        structurally inside `device_trace`, not an error) plus a
        sampled event-loop profile, both landing under data/profiles.
        A second start while one runs is a structured error."""
        from ..obs.profiler import ProfilerUnavailable

        try:
            started = self.node.profiler.start(
                label=str(label or ""),
                device=device not in (False, "false", "0", 0),
            )
        except ProfilerUnavailable as e:
            from .server import RPCError

            raise RPCError(-32000, f"profiler unavailable: {e}") from None
        return {"started": True, **started}

    def profile_stop(self, **_kw) -> dict:
        """Disarm the running session; returns artifact paths + the
        loop profile's hottest stacks. No session running is a
        structured error (the profiler-unavailable path)."""
        from ..obs.profiler import ProfilerUnavailable

        try:
            session = self.node.profiler.stop()
        except ProfilerUnavailable as e:
            from .server import RPCError

            raise RPCError(-32000, f"profiler unavailable: {e}") from None
        return {"stopped": True, **session}

    def status(self) -> dict:
        n = self.node
        bs = n.block_store
        latest_h = bs.height
        meta = bs.load_block_meta(latest_h) if latest_h else None
        pv_pub = n.priv_validator.get_pub_key()
        return {
            "node_info": {
                "id": n.node_key.id,
                "listen_addr": n._listen_addr(),
                "network": n.genesis.chain_id,
                "moniker": n.config.base.moniker,
            },
            "sync_info": {
                "latest_block_height": latest_h,
                "latest_block_hash": _hex(meta.block_id.hash) if meta else "",
                "latest_app_hash": _hex(meta.header.app_hash) if meta else "",
                "latest_block_time": meta.header.time_ns if meta else 0,
                # a post-upgrade sequencer-mode node is NOT catching up:
                # BFT is stopped by design (readiness tooling gates on
                # this — it must not drain every upgraded node forever)
                "catching_up": not (
                    n.consensus.is_running or _seq_started(n)
                ),
                # morph: post-upgrade sequencer mode (StateV2); height is
                # the V2 (L2) chain head this node has applied
                "sequencer_mode": _seq_started(n),
                "v2_height": (
                    n.state_v2.latest_height()
                    if getattr(n, "state_v2", None) is not None
                    else 0
                ),
            },
            "validator_info": {
                "address": _hex(pv_pub.address()),
                "pub_key": _hex(pv_pub.data),
                "voting_power": self._own_power(pv_pub),
            },
        }

    def _own_power(self, pub) -> int:
        vals = self.node.consensus.state.validators
        if vals is None:
            return 0
        _, val = vals.get_by_address(pub.address())
        return val.voting_power if val else 0

    def net_info(self) -> dict:
        sw = self.node.switch
        return {
            "listening": True,
            "n_peers": len(sw.peers),
            "peers": [
                {
                    "node_info": {
                        "id": p.id,
                        "listen_addr": p.node_info.listen_addr,
                        "moniker": p.node_info.moniker,
                    },
                    "is_outbound": p.outbound,
                    "remote_ip": p.socket_addr.host,
                }
                for p in sw.peers.values()
            ],
        }

    def blockchain(self, minHeight=None, maxHeight=None, **_kw) -> dict:
        bs = self.node.block_store
        max_h = int(maxHeight) if maxHeight else bs.height
        max_h = min(max_h, bs.height)
        min_h = max(int(minHeight) if minHeight else 1, bs.base)
        min_h = max(min_h, max_h - 19)  # reference caps at 20 metas
        metas = []
        for h in range(max_h, min_h - 1, -1):
            m = bs.load_block_meta(h)
            if m:
                metas.append(self._meta_json(m))
        return {"last_height": bs.height, "block_metas": metas}

    def genesis(self) -> dict:
        return {"genesis": self.node.genesis.to_json()}

    def dial_seeds(self, seeds=None, **_kw) -> dict:
        """Unsafe: dial the given seed addresses (reference routes.go:48)."""
        return self._dial(seeds or [], persistent=False)

    def dial_peers(self, peers=None, persistent=False, **_kw) -> dict:
        """Unsafe: dial the given peer addresses (reference routes.go:49)."""
        return self._dial(peers or [], persistent=bool(persistent))

    def _dial(self, addrs, persistent: bool) -> dict:
        from ..p2p.transport import NetAddress

        if isinstance(addrs, str):
            addrs = [a for a in addrs.split(",") if a]
        parsed = [NetAddress.parse(a) for a in addrs]
        self.node.switch.dial_peers_async(parsed, persistent=persistent)
        return {"log": f"dialing {len(parsed)} addresses"}

    def genesis_chunked(self, chunk=None, **_kw) -> dict:
        """Genesis split into base64 chunks (reference rpc/core/net.go
        GenesisChunked; routes.go:22) for large genesis documents."""
        import base64
        import json as _json

        data = _json.dumps(self.node.genesis.to_json()).encode()
        size = 16 * 1024
        chunks = [data[i : i + size] for i in range(0, len(data), size)] or [
            b""
        ]
        idx = int(chunk) if chunk is not None else 0
        if not (0 <= idx < len(chunks)):
            from .server import RPCError

            raise RPCError(
                -32000,
                f"chunk {idx} out of range (total {len(chunks)})",
            )
        return {
            "chunk": idx,
            "total": len(chunks),
            "data": base64.b64encode(chunks[idx]).decode(),
        }

    def header(self, height=None, **_kw) -> dict:
        """Block header only (reference routes.go:27)."""
        bs = self.node.block_store
        h = int(height) if height else bs.height
        meta = bs.load_block_meta(h)
        if meta is None:
            from .server import RPCError

            raise RPCError(-32000, f"no header at height {h}")
        return {"header": self._header_json(meta.header)}

    def header_by_hash(self, hash=None, **_kw) -> dict:
        """Block header by block hash (reference routes.go:28)."""
        bs = self.node.block_store
        h_bytes = _from_hex(hash)
        blk = bs.load_block_by_hash(h_bytes)
        if blk is None:
            from .server import RPCError

            raise RPCError(-32000, "header not found")
        return {"header": self._header_json(blk.header)}

    def block(self, height=None, **_kw) -> dict:
        bs = self.node.block_store
        h = int(height) if height else bs.height
        blk = bs.load_block(h)
        if blk is None:
            from .server import RPCError

            raise RPCError(-32000, f"no block at height {h}")
        meta = bs.load_block_meta(h)
        return {
            "block_id": self._bid_json(meta.block_id),
            "block": self._block_json(blk),
        }

    def block_by_hash(self, hash=None, **_kw) -> dict:
        bs = self.node.block_store
        h_bytes = _from_hex(hash)
        blk = bs.load_block_by_hash(h_bytes)
        if blk is None:
            from .server import RPCError

            raise RPCError(-32000, "block not found")
        meta = bs.load_block_meta(blk.header.height)
        return {
            "block_id": self._bid_json(meta.block_id),
            "block": self._block_json(blk),
        }

    def block_results(self, height=None, **_kw) -> dict:
        ss = self.node.state_store
        bs = self.node.block_store
        h = int(height) if height else bs.height
        raw = ss.load_abci_responses(h)
        if raw is None:
            from .server import RPCError

            raise RPCError(-32000, f"no results for height {h}")
        from ..state.execution import ABCIResponses

        resp = ABCIResponses.decode(raw)
        return {
            "height": h,
            "txs_results": [
                {"code": r.code, "data": _hex(r.data), "log": r.log,
                 "events": [
                     {"type": e.type, "attributes": e.attributes}
                     for e in r.events
                 ]}
                for r in resp.deliver_txs
            ],
        }

    def commit(self, height=None, **_kw) -> dict:
        bs = self.node.block_store
        h = int(height) if height else bs.height
        blk = bs.load_block(h)
        commit = bs.load_seen_commit(h) if h == bs.height else None
        if commit is None:
            nxt = bs.load_block(h + 1)
            commit = nxt.last_commit if nxt else bs.load_seen_commit(h)
        if blk is None or commit is None:
            from .server import RPCError

            raise RPCError(-32000, f"no commit at height {h}")
        return {
            "signed_header": {
                "header": self._header_json(blk.header),
                "commit": self._commit_json(commit),
            },
            "canonical": True,
        }

    # one page of validators per response (reference rpc/core/env.go
    # validatePerPage: per_page defaults to 30, capped at 100) — large
    # committees paginate instead of one unbounded response
    _VALS_PER_PAGE_DEFAULT = 100
    _VALS_PER_PAGE_MAX = 100

    def _paginate_validators(self, vals, h: int, page, per_page) -> dict:
        from .server import RPCError

        try:
            page = int(page) if page is not None else 1
            per_page = (
                int(per_page)
                if per_page is not None
                else self._VALS_PER_PAGE_DEFAULT
            )
        except (TypeError, ValueError):
            raise RPCError(-32602, "invalid page/per_page") from None
        per_page = max(1, min(per_page, self._VALS_PER_PAGE_MAX))
        total = vals.size()
        pages = max(1, -(-total // per_page))
        if not (1 <= page <= pages):
            raise RPCError(
                -32602, f"page {page} out of range (1..{pages})"
            )
        lo = (page - 1) * per_page
        window = vals.validators[lo : lo + per_page]
        return {
            "block_height": h,
            "validators": [self._validator_json(v) for v in window],
            "count": len(window),
            "total": total,
            "page": page,
            "per_page": per_page,
        }

    @staticmethod
    def _validator_json(v) -> dict:
        return {
            "address": _hex(v.address),
            "pub_key": _hex(v.pub_key.data),
            "pub_key_type": getattr(v.pub_key, "type_name", "ed25519"),
            "voting_power": v.voting_power,
            "proposer_priority": v.proposer_priority,
            **(
                {"bls_pub_key": _hex(v.bls_pub_key)}
                if v.bls_pub_key
                else {}
            ),
        }

    def validators(self, height=None, page=None, per_page=None, **_kw) -> dict:
        ss = self.node.state_store
        h = int(height) if height else self.node.block_store.height
        vals = ss.load_validators(h)
        if vals is None:
            from .server import RPCError

            raise RPCError(-32000, f"no validators at height {h}")
        return self._paginate_validators(vals, h, page, per_page)

    # --- light-client serving plane (tendermint_tpu_torch/lightserve) -------------

    def _lightserve_block(self, height, compressed=False):
        from .server import RPCError

        h = int(height) if height else 0
        cache = self.node.lightserve.cache
        lb = cache.get_compressed(h) if compressed else cache.get(h)
        if lb is None:
            raise RPCError(
                -32000, f"no light block at height {h or 'latest'}"
            )
        return lb

    def _signed_header_json(self, lb) -> dict:
        return {
            "header": self._header_json(lb.header),
            "commit": (
                self._commit_json(lb.commit)
                if lb.commit is not None
                else None
            ),
        }

    def light_block(self, height=None, proof=None, **_kw) -> dict:
        """The full proof for one height — signed header + validator set
        assembled once by the LightBlockCache and served to every
        client (one round trip instead of commit + validators).
        `proof="qc"` requests the QC-compressed shape: the N-CommitSig
        payload is dropped and the QuorumCertificate alone proves the
        header (capability negotiation at the RPC layer — legacy
        clients never send the param and keep the full commit; heights
        without a canonical QC fall back to the full proof)."""
        if proof not in (None, "", "full", "qc"):
            from .server import RPCError

            raise RPCError(-32602, f"unknown proof format {proof!r}")
        lb = self._lightserve_block(height, compressed=proof == "qc")
        return {
            "light_block": {
                "signed_header": self._signed_header_json(lb),
                **(
                    {"qc": self._qc_json(lb.qc)}
                    if lb.qc is not None
                    else {}
                ),
                # the FULL set, un-paginated: this IS the proof — a
                # partial set could never re-hash to validators_hash
                "validator_set": {
                    "validators": [
                        self._validator_json(v)
                        for v in lb.validators.validators
                    ],
                    "total": lb.validators.size(),
                },
            }
        }

    def signed_header(self, height=None, **_kw) -> dict:
        """Header + commit only (clients that track the set themselves)."""
        lb = self._lightserve_block(height)
        return {
            "signed_header": self._signed_header_json(lb),
            "canonical": True,
        }

    def validator_set(self, height=None, page=None, per_page=None,
                      **_kw) -> dict:
        """The validator set backing a light block, paginated — served
        from the proof cache (the `validators` route reads the state
        store per request instead)."""
        lb = self._lightserve_block(height)
        return self._paginate_validators(lb.validators, lb.height, page,
                                         per_page)

    def consensus_state(self) -> dict:
        cs = self.node.consensus
        rs = cs.rs
        return {
            "round_state": {
                "height": rs.height,
                "round": rs.round,
                "step": int(rs.step),
                "proposal": rs.proposal is not None,
                "locked_round": rs.locked_round,
                "valid_round": rs.valid_round,
            }
        }

    def dump_consensus_state(self) -> dict:
        out = self.consensus_state()
        out["peers"] = [
            {"node_address": p.id} for p in self.node.switch.peers.values()
        ]
        return out

    def dump_traces(self, format=None, heights=None, **_kw) -> dict:
        """Flight-recorder dump (tendermint_tpu_torch/obs). Formats:
        - default: the raw span ring + the last-N-heights flight view,
          plus the node's identity and per-peer clock table so
          tools/cluster_trace.py can merge dumps from several validators
          onto one timeline;
        - format=chrome: a Chrome trace_event JSON object — save
          `result.trace` to a file and load it in Perfetto."""
        from .. import obs

        # is-None check: an empty Tracer is falsy (it defines __len__),
        # so `or` would discard a node's injected-but-quiet ring and
        # dump the (possibly unrelated) process default instead — the
        # falsy-tracer bug class
        tracer = getattr(self.node, "tracer", None)
        if tracer is None:
            tracer = obs.default_tracer()
        records = tracer.records()
        if format == "chrome":
            return {
                "enabled": tracer.enabled,
                "trace": tracer.to_chrome_trace(records),
            }
        try:
            n = int(heights) if heights else 16
        except (TypeError, ValueError):
            from .server import RPCError

            raise RPCError(-32602, "invalid heights: not an integer") from None
        if n <= 0:
            n = 16  # flight_snapshot slices [-n:]; non-positive would
            # return everything instead of nothing
        recs = [r.to_json() for r in records]
        return {
            "enabled": tracer.enabled,
            "epoch_wall_ns": tracer.epoch_wall_ns,
            "node_id": getattr(
                getattr(self.node, "node_key", None), "id", ""
            ),
            "moniker": getattr(
                getattr(getattr(self.node, "config", None), "base", None),
                "moniker",
                "",
            ),
            "peer_clock": self._peer_clock(),
            "records": recs,
            "flight": {
                str(h): rows
                for h, rows in obs.flight_snapshot(records, n).items()
            },
            "attribution": obs.attribution(recs),
            # the per-height conservation audit: named buckets + the
            # dark_time residue the health plane alarms on
            "conservation": self._conservation_json(recs, n),
        }

    @staticmethod
    def _conservation_json(recs: list, n: int) -> dict:
        from .. import obs

        cons = obs.wall_conservation(recs, n)
        # string height keys like the flight view (JSON object keys)
        cons["heights"] = {
            str(h): row for h, row in cons["heights"].items()
        }
        return cons

    def _peer_clock(self) -> dict:
        sw = getattr(self.node, "switch", None)
        return sw.peer_clock_table() if sw is not None else {}

    def consensus_params(self, height=None, **_kw) -> dict:
        state = self.node.consensus.state
        cp = state.consensus_params
        return {
            "block_height": int(height) if height else state.last_block_height,
            "consensus_params": {
                "block": {"max_bytes": cp.block.max_bytes},
                "evidence": {
                    "max_age_num_blocks": cp.evidence.max_age_num_blocks,
                    "max_age_duration": cp.evidence.max_age_duration_ns,
                    "max_bytes": cp.evidence.max_bytes,
                },
                "batch": {
                    "blocks_interval": cp.batch.blocks_interval,
                    "timeout": cp.batch.timeout_ns,
                },
            },
        }

    def tx(self, hash=None, prove=False, **_kw) -> dict:
        idx = getattr(self.node, "indexer", None)
        if idx is None:
            from .server import RPCError

            raise RPCError(-32000, "tx indexing is disabled")
        res = idx.get_tx(_from_hex(hash, required=True))
        if res is None:
            from .server import RPCError

            raise RPCError(-32000, "tx not found")
        return self._tx_result_json(res, hash)

    def tx_search(self, query="", page=1, per_page=30, **_kw) -> dict:
        idx = getattr(self.node, "indexer", None)
        if idx is None:
            from .server import RPCError

            raise RPCError(-32000, "tx indexing is disabled")
        results = idx.search_txs(query, limit=int(per_page))
        return {
            "txs": [
                self._tx_result_json(r, None) for r in results
            ],
            "total_count": len(results),
        }

    def block_search(self, query="", page=1, per_page=30, **_kw) -> dict:
        idx = getattr(self.node, "indexer", None)
        if idx is None:
            from .server import RPCError

            raise RPCError(-32000, "tx indexing is disabled")
        heights = idx.search_blocks(query, limit=int(per_page))
        bs = self.node.block_store
        blocks = []
        for h in heights:
            m = bs.load_block_meta(h)
            if m:
                blocks.append(self._meta_json(m))
        return {"blocks": blocks, "total_count": len(blocks)}

    async def abci_info(self) -> dict:
        import asyncio as _aio

        info = self.node.app.info()
        if _aio.iscoroutine(info):  # external app via proxy connection
            info = await info
        return {
            "response": {
                "data": info.data,
                "version": info.version,
                "last_block_height": info.last_block_height,
                "last_block_app_hash": _hex(info.last_block_app_hash),
            }
        }

    async def abci_query(self, path="", data="", height=0, prove=False, **_kw):
        import asyncio as _aio

        res = self.node.app.query(
            path, _from_hex(data, "data"), int(height), bool(prove)
        )
        if _aio.iscoroutine(res):  # external app via proxy connection
            res = await res
        return {
            "response": {
                "code": res.code,
                "log": res.log,
                "key": _hex(res.key),
                "value": _hex(res.value),
                "height": res.height,
            }
        }

    def broadcast_evidence(self, evidence="", **_kw) -> dict:
        from ..types.evidence import decode_evidence

        ev = decode_evidence(_from_hex(evidence, "evidence", required=True))
        self.node.evidence_pool.add_evidence(ev)
        return {"hash": _hex(ev.hash())}

    # --- event subscriptions (websocket) -------------------------------------

    def subscribe_ws(self, client_id, query_str: str):
        return self.node.event_bus.subscribe(
            f"ws-{client_id}", Query(query_str)
        )

    def unsubscribe_ws(self, client_id, query_str: str) -> None:
        try:
            self.node.event_bus.unsubscribe(
                f"ws-{client_id}", Query(query_str)
            )
        except Exception:
            pass

    def encode_event(self, msg) -> dict:
        """Best-effort JSON encoding of a bus message's data payload."""
        data = msg.data
        from ..types.block import Block, Header

        if isinstance(data, Block):
            return {"type": "block", "value": self._block_json(data)}
        if isinstance(data, Header):
            return {"type": "header", "value": self._header_json(data)}
        if isinstance(data, tuple) and len(data) == 3:
            height, tx_hash, tx = data
            return {
                "type": "tx",
                "value": {
                    "height": height,
                    "hash": _hex(tx_hash),
                    "tx": _hex(tx),
                },
            }
        return {"type": type(data).__name__, "value": repr(data)}

    # --- json helpers ---------------------------------------------------------

    @staticmethod
    def _bid_json(bid) -> dict:
        return {
            "hash": _hex(bid.hash),
            "parts": {
                "total": bid.part_set_header.total,
                "hash": _hex(bid.part_set_header.hash),
            },
        }

    def _header_json(self, h) -> dict:
        return {
            "chain_id": h.chain_id,
            "height": h.height,
            "time": h.time_ns,
            "last_block_id": self._bid_json(h.last_block_id),
            "last_commit_hash": _hex(h.last_commit_hash),
            "data_hash": _hex(h.data_hash),
            "validators_hash": _hex(h.validators_hash),
            "next_validators_hash": _hex(h.next_validators_hash),
            "consensus_hash": _hex(h.consensus_hash),
            "app_hash": _hex(h.app_hash),
            "last_results_hash": _hex(h.last_results_hash),
            "evidence_hash": _hex(h.evidence_hash),
            "proposer_address": _hex(h.proposer_address),
            "batch_hash": _hex(h.batch_hash),
            "version": {"block": h.version_block, "app": h.version_app},
            "hash": _hex(h.hash()),
        }

    def _commit_json(self, c) -> dict:
        return {
            "height": c.height,
            "round": c.round,
            "block_id": self._bid_json(c.block_id),
            "signatures": [
                {
                    "block_id_flag": int(s.block_id_flag),
                    "validator_address": _hex(s.validator_address),
                    "timestamp": s.timestamp_ns,
                    "signature": _hex(s.signature),
                    "bls_signature": _hex(s.bls_signature),
                    "qc_signature": _hex(s.qc_signature),
                }
                for s in c.signatures
            ],
        }

    def _qc_json(self, qc) -> dict:
        return {
            "height": qc.height,
            "round": qc.round,
            "block_id": self._bid_json(qc.block_id),
            "signers_size": qc.signers.size,
            "signers": _hex(qc.signers.to_bytes()),
            "agg_signature": _hex(qc.agg_signature),
        }

    def _block_json(self, b) -> dict:
        return {
            "header": self._header_json(b.header),
            "data": {
                "txs": [_hex(tx) for tx in b.data.txs],
                "l2_block_meta": _hex(b.data.l2_block_meta),
                "l2_batch_header": _hex(b.data.l2_batch_header),
            },
            "evidence": [_hex(ev.encode()) for ev in b.evidence],
            "last_commit": self._commit_json(b.last_commit)
            if b.last_commit
            else None,
        }

    def _meta_json(self, m) -> dict:
        return {
            "block_id": self._bid_json(m.block_id),
            "block_size": m.block_size,
            "header": self._header_json(m.header),
            "num_txs": m.num_txs,
        }

    def _tx_result_json(self, r, tx_hash) -> dict:
        from ..crypto import tmhash

        return {
            "hash": tx_hash or _hex(tmhash.sum(r.tx)),
            "height": r.height,
            "index": r.index,
            "tx_result": {
                "code": r.code,
                "log": r.log,
                "events": [
                    {"type": t, "attributes": attrs} for t, attrs in r.events
                ],
            },
            "tx": _hex(r.tx),
        }
