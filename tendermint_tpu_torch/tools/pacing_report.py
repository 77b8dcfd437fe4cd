"""Wall-per-height attribution: timeout floor vs gossip vs compute.

Reads trace dumps (the `dump_traces` RPC shape, a bare record list, or
several per-validator dump files) and answers the question PERF_ANALYSIS
§12 left open: now that the commit pipeline moved finalize compute off
the critical path, WHERE does a height's remaining wall clock go — the
static timeout floor (cs.new_height / *_wait step spans), waiting on
peers (cs.propose / cs.prevote / cs.precommit), or the decision itself
(cs.commit)?

When the dump carries `pacing.decision` events (consensus/pacing.py with
[consensus] adaptive_timeouts on), the report also shows per step what
the controller LEARNED from the live arrival tail vs the static config
schedule, and where its AIMD back-off level sits — the before/after of
the adaptive-pacing loop in one table.

For the consensus family the report also renders the wall-clock
CONSERVATION audit (obs.report.wall_conservation): every height's wall
decomposed into mutually-exclusive named buckets — floor / gossip /
compute plus the carved verify IPC/queue/device, WAL fsync and commit
pipeline slices — with the unowned residue called out as `dark_time`
instead of folded into `other`. This is the ground truth the ROADMAP
item-4 controller work consumes.

Usage:
    python -m tendermint_tpu_torch.tools.pacing_report dump.json [dump2.json ...] [--json]
    curl -s localhost:26657/dump_traces | python -m tendermint_tpu_torch.tools.pacing_report -
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from tendermint_tpu_torch.obs import (
    FAMILY_WALL_SPANS,
    conservation_table,
    pacing_decisions,
    wall_attribution,
    wall_conservation,
)
from tendermint_tpu_torch.tools.trace_report import extract_records


def _load(path: str):
    if path == "-":
        return json.load(sys.stdin)
    with open(path) as f:
        return json.load(f)


def report(
    records: list[dict], n_heights: int = 64, family: str = "consensus"
) -> dict:
    out = {
        "wall": wall_attribution(records, n_heights, family=family),
        "pacing": pacing_decisions(records),
    }
    if family == "consensus":
        # the exhaustive bucket audit rides the cs.* step spans, so it
        # only applies to the consensus-classified families — item 4's
        # controller work reads the verify/WAL/pipeline buckets (and
        # the dark residue) from here
        out["conservation"] = wall_conservation(records, n_heights)
    return out


def report_text(rep: dict, name: str = "") -> str:
    lines = []
    wall = rep["wall"]
    agg = wall.get("aggregate") or {}
    title = "wall-per-height attribution"
    if name:
        title += f" — {name}"
    lines.append(title)
    if not agg:
        lines.append("  (no height spans in dump)")
        return "\n".join(lines)
    lines.append(
        f"  {agg['n_heights']} heights, wall p50 {agg['wall_ms_p50']} ms, "
        f"p95 {agg['wall_ms_p95']} ms, max {agg['wall_ms_max']} ms"
    )
    lines.append(
        f"  shares: timeout floor {agg['floor_share']:.1%}, "
        f"gossip {agg['gossip_share']:.1%}, "
        f"compute {agg['compute_share']:.1%}"
    )
    lines.append(
        f"  {'height':>8} {'wall_ms':>9} {'floor_ms':>9} {'gossip_ms':>9} "
        f"{'compute_ms':>10} {'other_ms':>9}"
    )
    for h in sorted(wall["heights"]):
        v = wall["heights"][h]
        lines.append(
            f"  {h:>8} {v['wall_ms']:>9.2f} {v['floor_ms']:>9.2f} "
            f"{v['gossip_ms']:>9.2f} {v['compute_ms']:>10.2f} "
            f"{v['other_ms']:>9.2f}"
        )
    cons = rep.get("conservation")
    if cons is not None:
        lines.append(conservation_table(cons))
    pacing = rep["pacing"]
    if pacing:
        lines.append("pacing decisions (learned vs static)")
        lines.append(
            f"  {'step':<10} {'static_ms':>9} {'learned_ms':>10} "
            f"{'eff_p50':>9} {'eff_last':>9} {'backoff':>8} {'n':>5}"
        )
        for step in ("propose", "prevote", "precommit", "commit"):
            if step not in pacing:
                continue
            p = pacing[step]
            lines.append(
                f"  {step:<10} {p['static_ms']:>9.2f} "
                f"{p['learned_ms_last']:>10.2f} "
                f"{p['effective_ms_p50']:>9.2f} "
                f"{p['effective_ms_last']:>9.2f} "
                f"{p['backoff_last']:>8.3f} {p['decisions']:>5}"
            )
    else:
        lines.append(
            "pacing decisions: none recorded (adaptive_timeouts off or "
            "tracing disabled)"
        )
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser(
        description="wall-per-height attribution from trace dumps "
        "(timeout floor vs gossip vs compute + pacing decisions)"
    )
    ap.add_argument("dumps", nargs="+", help="dump file(s), or - for stdin")
    ap.add_argument(
        "--heights", type=int, default=64, help="max heights to report"
    )
    ap.add_argument(
        "--family",
        choices=sorted(FAMILY_WALL_SPANS),
        default="consensus",
        help="wall-attribution span classification: 'consensus' (cs.* "
        "step spans; also the committee_scale bench family) or "
        "'sequencer' (seq.* spans of the BlockV2 streaming plane, "
        "heights are V2 heights)",
    )
    ap.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    args = ap.parse_args()

    out = {}
    for path in args.dumps:
        doc = _load(path)
        name = (
            doc.get("moniker")
            if isinstance(doc, dict) and doc.get("moniker")
            else (os.path.splitext(os.path.basename(path))[0] if path != "-" else "stdin")
        )
        out[name] = report(
            extract_records(doc), args.heights, family=args.family
        )
    if args.json:
        print(json.dumps(out, indent=1, sort_keys=True))
    else:
        print(
            "\n\n".join(
                report_text(rep, name if len(out) > 1 else "")
                for name, rep in out.items()
            )
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
