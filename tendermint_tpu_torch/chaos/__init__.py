"""Deterministic chaos subsystem — seeded fault injection for the p2p
mesh plus graceful degradation for the accelerator backend.

The reference engine's e2e runner perturbs networks ad-hoc (kill,
disconnect, byte fuzzing); this package turns those hacks into an owned,
replayable subsystem:

- `link`    — seeded per-link network shaping (latency+jitter, drop,
              duplicate, reorder, bandwidth) interposed at the transport
              connection layer, so every reactor runs through it
              unmodified.
- `network` — a controller over running switches: named partitions,
              per-peer blackholes, link policy installation, heal.
- `scenario`— declarative seeded timelines (at height/time X: partition,
              kill, restart, skew clocks, heal) executed against in-proc
              multi-node networks; one seed replays the whole fault plan.
- `backend_guard` — a bounded-time CUDA probe in a child process, so
              perf capture degrades to a structured JSON artifact
              instead of hanging when the card or its driver is gone.

Env knobs: TM_TPU_CHAOS_SEED (default scenario seed),
TM_TPU_BACKEND_GUARD_TIMEOUT (probe bound, seconds).
"""

from .link import ChaosConn, FaultTrace, LinkPolicy, link_rng
from .network import ChaosNetwork
from .scenario import NodeHandle, Scenario, ScenarioRunner, Step, random_scenario
from .backend_guard import BackendStatus, fallback_artifact, probe_backend

__all__ = [
    "BackendStatus",
    "ChaosConn",
    "ChaosNetwork",
    "FaultTrace",
    "LinkPolicy",
    "NodeHandle",
    "Scenario",
    "ScenarioRunner",
    "Step",
    "fallback_artifact",
    "link_rng",
    "probe_backend",
    "random_scenario",
]
