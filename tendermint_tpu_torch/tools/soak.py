"""Chaos soak loop — randomized seeded scenarios for a bounded wall-clock.

Each iteration draws a scenario from `chaos.random_scenario(seed, ...)`
(partition/heal or blackhole/heal plus a latency/drop storm, all derived
from the seed), runs it on a fresh in-proc 4-validator mesh, and checks
that every live node reconverges on ONE chain at the target height. On
any divergence/stall the loop STOPS and dumps the failing seed plus the
resolved plan trace, so the failure replays locally with:

    TM_TPU_CHAOS_SEED=<seed> python -m tendermint_tpu_torch.tools.soak --iters 1

Usage:
    python -m tendermint_tpu_torch.tools.soak [--budget SECONDS] [--iters N] [--nodes N]
                         [--height H] [--seed S] [--device cuda|cpu]

Exit code: 0 if every completed iteration converged, 1 on the first
divergence (artifact JSON on stdout either way).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from tendermint_tpu_torch import obs
from tendermint_tpu_torch.chaos import ScenarioRunner, random_scenario
from tendermint_tpu_torch.chaos.scenario import default_seed


def _collect_dumps(handles, chaos_tracer) -> list[dict]:
    """Per-node dump_traces-shaped dicts, plus the process-wide ring's
    chaos/link annotations as a pseudo node."""
    from tests.torch_chaos_harness import node_dump

    dumps = [obs.normalize_dump(node_dump(h)) for h in handles]
    chaos_records = [r.to_json() for r in chaos_tracer.records()]
    if chaos_records:
        dumps.append(
            obs.normalize_dump(
                {
                    "node_id": "_chaos",
                    "moniker": "_chaos",
                    "epoch_wall_ns": chaos_tracer.epoch_wall_ns,
                    "records": chaos_records,
                    "peer_clock": {},
                }
            )
        )
    return dumps


def _health_statuses(handles) -> dict:
    """Per-node rolled-up health status — the one-line summary every
    iteration carries (a chaos run that degrades a subsystem without
    diverging still shows up here)."""
    return {
        h.name: obs.VERDICT_NAMES[h.cs.health.status()]
        for h in handles
        if getattr(h.cs, "health", None) is not None
    }


def _health_verdicts(handles) -> dict:
    """Full per-node health verdicts (detector SLO state + incident
    log) for the divergence artifact: next to the merged trace the
    verdict says WHICH plane degraded before the fork/stall."""
    return {
        h.name: h.cs.health.verdict()
        for h in handles
        if getattr(h.cs, "health", None) is not None
    }


def _ledger_summaries(handles) -> dict:
    """Per-node device-cost ledger summaries (obs/ledger.py) for the
    divergence artifact: next to the health verdicts (WHICH plane
    degraded) the ledger says what the DEVICE was doing — per-class
    device-seconds, fill efficiency, padding waste. Harness nodes whose
    verify path owns a scheduler report their own ledger; the process
    default ledger rides as "_process" either way (the in-proc mesh
    funnels any installed scheduler's rounds there), so a verify plane
    that did nothing shows zero rounds honestly instead of being
    absent."""
    from tests.torch_chaos_harness import node_ledger

    out = {}
    for h in handles:
        led = node_ledger(h)
        if led is not None:
            out[h.name] = led.summary()
    out["_process"] = obs.default_ledger().summary()
    return out


def _merge(dumps: list[dict]):
    """Rebase the dumps onto one timeline with explicit wall-anchor
    offsets — one process, one clock, so the anchors ARE ground truth
    and NTP estimation over chaos-delayed links would only import bias.
    Only run on the divergence path: the happy path's attribution never
    reads timestamps, so the rebase+sort would be wasted work there."""
    from tendermint_tpu_torch.obs.cluster import wall_anchor_offsets

    return obs.merge_records(dumps, offsets=wall_anchor_offsets(dumps))


async def run_one(seed: int, n_nodes: int, height: int, timeout: float,
                  device: str = "cuda") -> dict:
    from tests.torch_chaos_harness import (
        build_chaos_handles,
        chain_hashes,
        start_mesh,
        stop_mesh,
    )

    # flight recorder on for every iteration: a diverging seed ships
    # with its per-height step timeline, not just the scenario plan.
    # Each node gets its OWN ring (cluster tracing) so a divergence also
    # ships the merged cross-validator report; the process-wide default
    # ring keeps collecting the chaos/link annotations.
    tracer = obs.default_tracer()
    tracer.enabled = True
    tracer.clear()

    # each node also carries a live health plane: the quorum-lag /
    # round-churn / stall detectors watch the same run the chaos
    # scenario shapes, incidents land in the per-node rings (so the
    # divergence dump says WHY next to WHAT), and the final verdicts
    # ride the artifact
    handles = build_chaos_handles(
        n_nodes,
        tracer_factory=lambda name: obs.Tracer(enabled=True),
        ping_interval=1.0,
        device=device,
        health_factory=lambda name, node_tracer: obs.HealthMonitor(
            tracer=node_tracer
        ),
    )
    scenario = random_scenario(seed, [h.name for h in handles])
    runner = ScenarioRunner(handles, scenario)
    await start_mesh(handles)
    try:
        heights = await runner.run(until_height=height, timeout=timeout)
        hashes = await chain_hashes(handles, height - 1)
        converged = len(hashes) == 1 and all(
            seq[:height] == list(range(1, height + 1))
            for name, seq in heights.items()
            if runner.nodes[name].alive
        )
        dumps = _collect_dumps(handles, tracer)
        all_records = [r for d in dumps for r in d["records"]]
        out = {
            "seed": seed,
            "ok": converged,
            "heights": {k: (v[-1] if v else 0) for k, v in heights.items()},
            "forks": len(hashes),
            "latency_attribution": obs.attribution(all_records),
            "health": _health_statuses(handles),
            "plan": runner.plan_jsonl().decode(),
        }
        if not converged:
            merge = _merge(dumps)
            out["trace_report"] = obs.ascii_timeline(merge[2])
            out["cluster_report"] = obs.cluster_report(dumps, merge=merge)
            out["health_verdicts"] = _health_verdicts(handles)
            out["dispatch_ledger"] = _ledger_summaries(handles)
        return out
    except TimeoutError as e:
        dumps = _collect_dumps(handles, tracer)
        merge = _merge(dumps)
        return {
            "seed": seed,
            "ok": False,
            "error": str(e),
            "latency_attribution": obs.attribution(merge[2]),
            "trace_report": obs.ascii_timeline(merge[2]),
            "cluster_report": obs.cluster_report(dumps, merge=merge),
            "health": _health_statuses(handles),
            "health_verdicts": _health_verdicts(handles),
            "dispatch_ledger": _ledger_summaries(handles),
            "plan": runner.plan_jsonl().decode(),
        }
    finally:
        await stop_mesh(handles)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--budget", type=float, default=300.0,
                    help="wall-clock budget in seconds (default 300)")
    ap.add_argument("--iters", type=int, default=0,
                    help="max iterations (0 = budget-bound only)")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--height", type=int, default=4,
                    help="target committed height per iteration")
    ap.add_argument("--seed", type=int, default=None,
                    help="starting seed (default TM_TPU_CHAOS_SEED or 0)")
    ap.add_argument("--device", default="cuda",
                    help="device the nodes verify on: cuda (default) or cpu")
    args = ap.parse_args()

    seed = args.seed if args.seed is not None else default_seed()
    start = time.monotonic()
    results = []
    it = 0
    while True:
        if args.iters and it >= args.iters:
            break
        remaining = args.budget - (time.monotonic() - start)
        if remaining <= 0:
            break
        res = asyncio.run(
            run_one(seed + it, args.nodes, args.height,
                    timeout=min(120.0, max(10.0, remaining)),
                    device=args.device)
        )
        results.append({k: v for k, v in res.items() if k != "plan"})
        status = "ok" if res["ok"] else "DIVERGED"
        print(f"# iter {it} seed={res['seed']}: {status}", file=sys.stderr)
        if not res["ok"]:
            print(
                f"# REPLAY: TM_TPU_CHAOS_SEED={res['seed']} "
                f"python -m tendermint_tpu_torch.tools.soak --iters 1",
                file=sys.stderr,
            )
            if res.get("trace_report"):
                print(res["trace_report"], file=sys.stderr)
            if res.get("cluster_report"):
                print(obs.report_text(res["cluster_report"]), file=sys.stderr)
            print(json.dumps(res))
            return 1
        it += 1

    print(json.dumps({
        "ok": True,
        "iterations": it,
        "elapsed_s": round(time.monotonic() - start, 1),
        "results": results,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
