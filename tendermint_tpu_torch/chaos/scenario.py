"""Declarative seeded chaos scenarios over in-proc multi-node networks.

A `Scenario` is a seed plus a timeline of `Step`s, each fired once when
its trigger (committed height or elapsed seconds) is reached:

    Scenario(seed=7, steps=[
        Step(at_height=2, action="partition",
             params={"name": "split", "groups": [["n0","n1"],["n2","n3"]]}),
        Step(at_time=6.0, action="heal", params={"name": "split"}),
        Step(at_height=5, action="clock_skew",
             params={"node": "n1", "scale": 1.5}),
    ])

`ScenarioRunner` executes the timeline against `NodeHandle`s (the in-proc
consensus + p2p bundles the test harness builds), with ALL randomness —
link shaping, dial jitter, randomized step parameters — derived from the
single scenario seed, so a failing CI run is replayed locally by seed
alone (README §chaos). The resolved timeline is logged to the shared
`FaultTrace` before execution starts; two runs with one seed produce a
byte-identical plan trace.

Env knobs: TM_TPU_CHAOS_SEED overrides the default seed used by
`default_seed()` (soak + CI entry points).
"""

from __future__ import annotations

import asyncio
import os
import random
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

from ..libs.log import Logger, nop_logger
from ..obs import default_tracer
from .link import LinkPolicy
from .network import ChaosNetwork


def default_seed() -> int:
    return int(os.environ.get("TM_TPU_CHAOS_SEED", "0"))


@dataclass
class NodeHandle:
    """One in-proc node as the scenario runner sees it."""

    name: str
    cs: object  # ConsensusState
    node_key: object  # p2p NodeKey
    transport: object  # MultiplexTransport
    switch: object  # Switch
    block_store: object = None
    alive: bool = True
    # rebuilds transport/switch/reactor for this handle after a kill and
    # reconnects it (harness-specific); awaited by the "restart" action
    restart_fn: Optional[Callable[["NodeHandle", ChaosNetwork], Awaitable[None]]] = None

    def height(self) -> int:
        bs = self.block_store
        if bs is None:
            bs = getattr(self.cs, "block_store", None)
        return bs.height if bs is not None else 0


@dataclass
class Step:
    action: str  # partition|heal|blackhole|kill|restart|set_link|clock_skew
    at_height: Optional[int] = None  # fire when any live node commits this
    at_time: Optional[float] = None  # or when this many seconds elapsed
    after: Optional[int] = None  # and only once step[after] has fired
    # with NO at_height/at_time the step is due immediately (gated only
    # by `after`, if set)
    params: dict = field(default_factory=dict)

    def resolved(self, idx: int) -> tuple:
        return (
            "plan",
            idx,
            self.action,
            self.at_height,
            self.at_time,
            self.after,
            sorted(self.params.items(), key=lambda kv: kv[0]),
        )


@dataclass
class Scenario:
    seed: int
    steps: list[Step] = field(default_factory=list)
    default_policy: Optional[LinkPolicy] = None


class ScenarioRunner:
    def __init__(
        self,
        nodes: list[NodeHandle],
        scenario: Scenario,
        logger: Optional[Logger] = None,
    ):
        self.nodes = {h.name: h for h in nodes}
        self.scenario = scenario
        self.logger = logger or nop_logger()
        self.net = ChaosNetwork(seed=scenario.seed, logger=self.logger)
        if scenario.default_policy is not None:
            self.net.set_default_policy(scenario.default_policy)
        for h in nodes:
            self.net.install(h)
        self._fired: set[int] = set()

    @property
    def trace(self):
        return self.net.trace

    def plan_jsonl(self) -> bytes:
        """The resolved scenario plan as canonical JSONL — the seeded,
        replayable part of the fault trace. Byte-identical across runs
        with the same seed (per-link message decisions additionally
        depend on live traffic volume and live in the full trace)."""
        import json

        return b"\n".join(
            json.dumps(list(e), separators=(",", ":")).encode()
            for e in self.trace.entries
            if e[0] in ("scenario", "plan")
        )

    def live_nodes(self) -> list[NodeHandle]:
        return [h for h in self.nodes.values() if h.alive]

    def max_height(self) -> int:
        return max((h.height() for h in self.live_nodes()), default=0)

    def height_trace(self) -> dict[str, list[int]]:
        """Per-node committed-height sequence (1..h). The determinism
        suite compares these across same-seed runs."""
        return {
            name: list(range(1, h.height() + 1))
            for name, h in sorted(self.nodes.items())
        }

    async def run(
        self, until_height: int, timeout: float = 120.0
    ) -> dict[str, list[int]]:
        """Execute the timeline until every LIVE node commits
        `until_height` (and all steps have fired), then return the
        committed-height trace. Raises TimeoutError on stall."""
        # log the fully resolved plan first: this is the replayable part
        # of the fault trace — byte-identical for a given seed
        self.trace.add("scenario", "seed", self.scenario.seed)
        for i, step in enumerate(self.scenario.steps):
            self.trace.add(*step.resolved(i))

        start = time.monotonic()
        while True:
            elapsed = time.monotonic() - start
            if elapsed > timeout:
                raise TimeoutError(
                    f"scenario stalled at height {self.max_height()} "
                    f"({len(self._fired)}/{len(self.scenario.steps)} steps "
                    f"fired, seed={self.scenario.seed})"
                )
            h = self.max_height()
            for i, step in enumerate(self.scenario.steps):
                if i in self._fired:
                    continue
                due = (
                    (step.at_height is not None and h >= step.at_height)
                    or (step.at_time is not None and elapsed >= step.at_time)
                    # trigger-less steps are due immediately (typically
                    # gated only by `after`)
                    or (step.at_height is None and step.at_time is None)
                )
                if step.after is not None and step.after not in self._fired:
                    due = False  # dependency hasn't fired yet
                if due:
                    self._fired.add(i)
                    self.trace.add("fire", i, step.action)
                    default_tracer().event(
                        f"chaos.fire.{step.action}", height=h, step=i
                    )
                    await self._execute(step)
            if len(self._fired) == len(self.scenario.steps):
                live = self.live_nodes()
                if live and all(n.height() >= until_height for n in live):
                    return self.height_trace()
            await asyncio.sleep(0.05)

    async def _execute(self, step: Step) -> None:
        p = step.params
        if step.action == "partition":
            await self.net.partition(p.get("name", "p"), p["groups"])
        elif step.action == "heal":
            await self.net.heal(p.get("name"))
        elif step.action == "blackhole":
            await self.net.blackhole(p["node"])
        elif step.action == "kill":
            h = self.nodes[p["node"]]
            h.alive = False
            await h.cs.stop()
            await h.switch.stop()
        elif step.action == "restart":
            h = self.nodes[p["node"]]
            if h.restart_fn is None:
                raise ValueError(f"node {h.name} has no restart_fn")
            await h.restart_fn(h, self.net)
            h.alive = True
        elif step.action == "set_link":
            policy = LinkPolicy(**p.get("policy", {}))
            if "a" in p:
                rev = p.get("reverse")
                self.net.set_link_policy(
                    p["a"],
                    p["b"],
                    policy,
                    LinkPolicy(**rev) if rev is not None else None,
                )
            else:
                self.net.set_default_policy(policy)
        elif step.action == "clock_skew":
            self.nodes[p["node"]].cs.ticker.set_scale(p["scale"])
        else:
            raise ValueError(f"unknown chaos action {step.action!r}")


def random_scenario(
    seed: int, node_names: list[str], max_heal_time: float = 8.0
) -> Scenario:
    """A bounded randomized scenario drawn entirely from `seed` — the
    soak loop's generator. Mixes a mild latency/drop storm with either a
    2|2-style partition/heal or a node blackhole/heal, so every iteration
    exercises divergence + reconvergence."""
    rng = random.Random(seed)
    storm = LinkPolicy(
        latency_s=rng.uniform(0.0, 0.02),
        jitter_s=rng.uniform(0.0, 0.03),
        drop=rng.uniform(0.0, 0.05),
        duplicate=rng.uniform(0.0, 0.05),
    )
    steps: list[Step] = []
    names = list(node_names)
    rng.shuffle(names)
    heal_at = rng.uniform(3.0, max_heal_time)
    if rng.random() < 0.5 and len(names) >= 4:
        half = len(names) // 2
        steps.append(
            Step(
                action="partition",
                at_height=rng.randint(1, 3),
                params={
                    "name": "soak-split",
                    "groups": [names[:half], names[half:]],
                },
            )
        )
        steps.append(
            Step(action="heal", at_time=heal_at, params={"name": "soak-split"})
        )
    else:
        steps.append(
            Step(
                action="blackhole",
                at_height=rng.randint(1, 3),
                params={"node": names[0]},
            )
        )
        steps.append(Step(action="heal", at_time=heal_at))
    if rng.random() < 0.3:
        steps.append(
            Step(
                action="clock_skew",
                at_height=rng.randint(2, 4),
                params={"node": names[-1], "scale": rng.uniform(0.8, 1.5)},
            )
        )
    return Scenario(seed=seed, steps=steps, default_policy=storm)
