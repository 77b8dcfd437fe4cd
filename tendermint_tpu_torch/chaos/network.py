"""ChaosNetwork — partitions, blackholes, and link policies over a
running p2p mesh.

Operates on live `p2p/switch.py` Switches through two seams added for
chaos (and usable by any test harness):

- `MultiplexTransport.conn_wrapper`: wraps every upgraded connection, so
  the link model shapes all reactor traffic without touching reactors.
- `Switch.conn_gate`: a predicate consulted before a peer is added; the
  controller installs one that enforces the current partition/blackhole
  view, covering both inbound accepts and outbound dials (including the
  persistent redial loop).

Partitions are NAMED so a scenario can apply/heal them declaratively:
`partition("split", [["n0","n1"],["n2","n3"]])` severs existing
cross-group connections and blocks new ones; `heal("split")` removes the
rule and kicks the persistent redial machinery so the mesh reconverges.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..libs.log import Logger, nop_logger
from ..obs import default_tracer
from .link import ChaosConn, FaultTrace, LinkPolicy, link_rng


class ChaosNetwork:
    def __init__(self, seed: int = 0, logger: Optional[Logger] = None):
        self.seed = seed
        self.logger = logger or nop_logger()
        self.trace = FaultTrace()
        self._nodes: dict[str, object] = {}  # name -> NodeHandle
        self._default_policy = LinkPolicy()
        # (src_name, dst_name) -> LinkPolicy, directional
        self._link_policies: dict[tuple[str, str], LinkPolicy] = {}
        self._partitions: dict[str, list[set[str]]] = {}  # name -> groups
        self._blackholes: set[str] = set()

    # --- installation -----------------------------------------------------

    def install(self, handle) -> None:
        """Attach chaos to one node BEFORE its transport starts accepting.
        `handle` is a chaos.scenario.NodeHandle."""
        self._nodes[handle.name] = handle
        handle.transport.conn_wrapper = self._make_wrapper(handle)
        handle.switch.conn_gate = self._make_gate(handle)
        # deterministic dial jitter: every retry schedule replays per seed
        handle.switch.dial_rng = link_rng(self.seed, "dial", handle.name)

    def _make_wrapper(self, handle):
        def wrap(peer_id: str, conn):
            src = handle.name
            dst = self._name_for(peer_id) or peer_id[:12]
            # always wrap (even when the current policy is a noop): the
            # policy is re-resolved per message, so a mid-scenario
            # set_link/set_default_policy reshapes LIVE connections
            return ChaosConn(
                conn,
                self._policy_for(src, dst),
                link_rng(self.seed, src, dst),
                link_id=f"{src}>{dst}",
                trace=self.trace,
                policy_fn=lambda: self._policy_for(src, dst),
            )

        return wrap

    def _make_gate(self, handle):
        def gate(peer_id: str) -> bool:
            other = self._name_for(peer_id)
            if other is None:
                return True  # not a chaos-managed node
            return self.allowed(handle.name, other)

        return gate

    def _name_for(self, node_id: str) -> Optional[str]:
        for name, h in self._nodes.items():
            if h.node_key.id == node_id:
                return name
        return None

    def _policy_for(self, src: str, dst: str) -> LinkPolicy:
        return self._link_policies.get((src, dst), self._default_policy)

    # --- link policies ----------------------------------------------------

    def set_default_policy(self, policy: LinkPolicy) -> None:
        """Policy for every link without an explicit override. Takes
        effect immediately, including on live connections (each wrapped
        conn re-resolves its policy per message)."""
        self._default_policy = policy

    def set_link_policy(
        self,
        a: str,
        b: str,
        policy: LinkPolicy,
        reverse: Optional[LinkPolicy] = None,
    ) -> None:
        """Shape a->b with `policy`; b->a gets `reverse` (or the same
        policy — pass LinkPolicy() for a clean return path)."""
        self._link_policies[(a, b)] = policy
        self._link_policies[(b, a)] = reverse if reverse is not None else policy

    # --- partitions / blackholes -----------------------------------------

    def allowed(self, a: str, b: str) -> bool:
        if a in self._blackholes or b in self._blackholes:
            return False
        for groups in self._partitions.values():
            ga = gb = None
            for i, g in enumerate(groups):
                if a in g:
                    ga = i
                if b in g:
                    gb = i
            if ga is not None and gb is not None and ga != gb:
                return False
        return True

    async def partition(self, name: str, groups: list[list[str]]) -> None:
        """Apply a named partition: nodes in different groups cannot
        communicate until `heal(name)`."""
        self._partitions[name] = [set(g) for g in groups]
        self.trace.add("net", "partition", name, sorted(map(sorted, groups)))
        # fault injections land in the same timeline as the step spans:
        # the flight recorder bins this into the height in progress
        default_tracer().event(
            "chaos.partition",
            name=name,
            groups="|".join(",".join(sorted(g)) for g in groups),
        )
        await self._enforce()

    async def blackhole(self, node: str) -> None:
        """Isolate one node from everyone (per-peer blackhole)."""
        self._blackholes.add(node)
        self.trace.add("net", "blackhole", node)
        default_tracer().event("chaos.blackhole", node=node)
        await self._enforce()

    async def heal(self, name: Optional[str] = None) -> None:
        """Remove one named partition (or all partitions and blackholes)
        and kick redials so the mesh reconverges."""
        if name is None:
            self._partitions.clear()
            self._blackholes.clear()
        else:
            self._partitions.pop(name, None)
            self._blackholes.discard(name)
        self.trace.add("net", "heal", name or "*")
        default_tracer().event("chaos.heal", name=name or "*")
        for h in self._nodes.values():
            if h.switch.is_running:
                h.switch.redial_persistent()

    async def _enforce(self) -> None:
        """Drop live connections that the current view forbids."""
        for name, h in self._nodes.items():
            if not h.switch.is_running:
                continue
            for peer in list(h.switch.peers.values()):
                other = self._name_for(peer.id)
                if other is not None and not self.allowed(name, other):
                    await h.switch.stop_peer_gracefully(peer)
        # let in-flight recv callbacks observe the closed conns
        await asyncio.sleep(0)
