"""Multi-process verify-service bench harness (bench.py --family
verify_service).

The missing measurement behind ROADMAP's verify-as-a-service item:
The committee-scale live nets stub signature verification above 32
validators because a single-process event loop cannot absorb 100 nodes'
device verifies — so the committee-crypto cost model from "Performance
of EdDSA and BLS Signatures in Committee-Based Consensus" (PAPERS.md)
had never been measured end-to-end on this stack. This harness measures
it on the production topology instead of a bigger event loop:

- ONE verify-service process (`python -m tendermint_tpu_torch
  verify-service`) owns the device plane: the scheduler, the
  BatchVerifier, the shape registry, the DispatchLedger;
- N "node" submission loops spread across real OS processes, each with
  its OWN RemoteVerifyScheduler connection, drive one committee round
  of REAL crypto per height: n ed25519 vote verifies (genuine
  signatures over per-validator vote bytes, verified by the service's
  real BatchVerifier) plus the round's n-signer BLS dual-sign aggregate
  group on the wire fn lane (`bls_agg`: real BLS12-381 keys, one
  random-linear-combination aggregate per group). A node's height
  completes when BOTH verdict sets return all-true — the verify
  critical path of a consensus round, without the gossip plane the
  committee_scale family already prices.

Per size the harness records wall-per-height, the service-side
DispatchLedger summary (requests-per-dispatch proves CROSS-PROCESS
coalescing: submissions from different OS processes landing in one
padded device round), client-side IPC round-trip stats, and the degrade
count (must be zero on a healthy run — the artifact is dishonest
otherwise and says so).

Worker mode (`--worker`) is how the parent spawns the node processes;
the committee fixture is deterministic (seeded keys), so every process
builds identical votes without any key-distribution channel.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
from typing import Optional
import subprocess
import sys
import tempfile
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO_ROOT)

# one committee round's BLS batch point: every validator dual-signs the
# same batch hash (consensus/state.go:2560 semantics)
BATCH_HASH = hashlib.sha256(b"verify-service-bench-batch-point").digest()

# service rounds cap: the reference harness's default, kept so a run of
# this harness merges rounds into the same buckets (the amortization
# curve is visible at 2048); a run on the card raises it to the 16384
# knee with --service-max-batch
DEFAULT_SERVICE_MAX_BATCH = 2048


def committee_fixture(n: int):
    """Deterministic committee: n ed25519 (pub, msg, sig) vote rows and
    n BLS (pub_bytes, BATCH_HASH, sig_bytes) aggregate-group items —
    identical in every process that builds it."""
    from tendermint_tpu_torch.crypto import bls_signatures as bls
    from tendermint_tpu_torch.crypto import ed25519
    from tendermint_tpu_torch.crypto.batch_verifier import SigItem

    ed_items = []
    bls_items = []
    for i in range(n):
        pk = ed25519.PrivKey.from_secret(b"vsbench-ed-%06d" % i)
        msg = b"vsbench-vote|v%06d|" % i + b"\x00" * 45  # 64B vote bytes
        ed_items.append(
            SigItem(pk.public_key().data, msg, pk.sign(msg))
        )
        priv = 90021 + i
        bls_items.append(
            (
                bls.public_key_to_bytes(bls.pubkey_from_priv(priv)),
                BATCH_HASH,
                bls.signer_for(priv)(BATCH_HASH),
            )
        )
    return ed_items, bls_items


def _local_bls_fallback(bls_items):
    """Degrade path for the wire fn lane: the same aggregate math the
    service runs, executed locally (verify_service.BUILTIN_ENGINES)."""
    from tendermint_tpu_torch.parallel.verify_service import _engine_bls_agg

    return _engine_bls_agg(bls_items)


# --- worker ------------------------------------------------------------------


class _HeightBarrier:
    """Per-worker height alignment (generation barrier): real
    validators enter a height together — consensus itself synchronizes
    them — so the harness's node loops align per height too; without
    it, drifted nodes interleave sig and fn submissions in the service
    queue and the measurement becomes arrival noise instead of the
    verify plane."""

    def __init__(self, parties: int):
        self.parties = parties
        self._count = 0
        self._ev = asyncio.Event()

    async def wait(self) -> None:
        ev = self._ev
        self._count += 1
        if self._count >= self.parties:
            self._count = 0
            self._ev = asyncio.Event()
            ev.set()
        else:
            await ev.wait()


async def _run_node(
    socket_path: str,
    node_idx: int,
    ed_items,
    bls_items,
    warm: int,
    heights: int,
    out: dict,
    barrier: Optional[_HeightBarrier] = None,
) -> None:
    """One validator node's submission loop over its own service
    connection: per height, the round's ed25519 votes + the BLS batch
    point, barriered on both verdict sets like a consensus round."""
    from tendermint_tpu_torch.parallel.verify_service import (
        RemoteVerifyScheduler,
    )

    remote = RemoteVerifyScheduler(socket_path)
    await remote.start()
    deadline = time.monotonic() + 60.0
    while not remote.connected and time.monotonic() < deadline:
        await asyncio.sleep(0.02)
    if not remote.connected:
        raise RuntimeError(f"node {node_idx}: service never attached")
    walls = []
    t_measure_start = None
    try:
        ipc_base = None
        for h in range(warm + heights):
            if barrier is not None:
                await barrier.wait()
            if h == warm:
                t_measure_start = time.monotonic()
                # measured-window IPC accounting: the warm heights pay
                # the service's one-off bucket compiles, and a
                # cumulative RTT mean would smear those stalls over
                # the steady-state rows
                ipc_base = remote.ipc_stats()
            t0 = time.monotonic()
            # phased like a consensus round: the round's votes verify
            # first, then the commit's BLS batch point. Phasing also
            # keeps the class queue un-interleaved — an fn round at a
            # class head ends the sig round being assembled, so a
            # node alternating sig/fn submissions would break up the
            # very cross-process coalescing this harness measures
            ed_v = await remote.submit(ed_items, "consensus")
            bls_v = await remote.submit_wire_fn(
                "bls_agg",
                bls_items,
                "consensus",
                fallback=lambda: _local_bls_fallback(bls_items),
            )
            if not all(bool(v) for v in ed_v):
                raise RuntimeError(
                    f"node {node_idx} h{h}: ed25519 verdicts not "
                    f"all-true ({int(sum(ed_v))}/{len(ed_v)})"
                )
            if not all(bool(v) for v in bls_v):
                raise RuntimeError(
                    f"node {node_idx} h{h}: BLS verdicts not all-true"
                )
            if h >= warm:
                walls.append(time.monotonic() - t0)
        final = remote.ipc_stats()
        base = ipc_base or {}
        out["nodes"].append(
            {
                "node": node_idx,
                "height_walls_s": walls,
                "t_measure_start": t_measure_start,
                "t_end": time.monotonic(),
                # measured-window deltas; degrades stays cumulative
                # (a degrade ANYWHERE in the run taints the row)
                "ipc": {
                    "rtt_count": final["rtt_count"]
                    - base.get("rtt_count", 0),
                    "rtt_sum_s": final["rtt_sum_s"]
                    - base.get("rtt_sum_s", 0.0),
                    "remote_submissions": final["remote_submissions"]
                    - base.get("remote_submissions", 0),
                    "degrades": final["degrades"],
                    "reconnects": final["reconnects"],
                    "connected": final["connected"],
                },
            }
        )
    finally:
        await remote.stop()


def run_worker(args) -> int:
    ed_items, bls_items = committee_fixture(args.validators)
    out = {"nodes": [], "error": None}

    async def run():
        barrier = _HeightBarrier(args.node_hi - args.node_lo)
        await asyncio.gather(
            *(
                _run_node(
                    args.socket,
                    idx,
                    ed_items,
                    bls_items,
                    args.warm,
                    args.heights,
                    out,
                    barrier=barrier,
                )
                for idx in range(args.node_lo, args.node_hi)
            )
        )

    try:
        asyncio.run(run())
    except Exception as e:  # structured failure, parent aggregates
        out["error"] = repr(e)
    print(json.dumps(out), flush=True)
    return 0 if out["error"] is None else 1


# --- parent orchestration ---------------------------------------------------


def _spawn_service(
    socket_path: str, max_batch: int, timeout: float = 120.0,
    device: str = "cuda",
):
    """The service process + its readiness line (ready_fd pipe); the
    service verifies on `device`."""
    rfd, wfd = os.pipe()
    log_path = socket_path + ".log"
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [
                sys.executable,
                "-m",
                "tendermint_tpu_torch",
                "verify-service",
                "--socket",
                socket_path,
                "--max-batch",
                str(max_batch),
                "--ready-fd",
                str(wfd),
                "--device",
                device,
            ],
            pass_fds=(wfd,),
            cwd=REPO_ROOT,
            stderr=log,
        )
    os.close(wfd)
    os.set_blocking(rfd, False)
    ready = b""
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            try:
                chunk = os.read(rfd, 4096)
            except BlockingIOError:
                chunk = None
            if chunk:
                ready += chunk
                break
            if chunk == b"" or proc.poll() is not None:
                break
            time.sleep(0.05)
    finally:
        os.close(rfd)
    if not ready:
        proc.terminate()
        try:
            with open(log_path, "rb") as f:
                tail = f.read()[-2000:].decode(errors="replace")
        except OSError:
            tail = ""
        raise RuntimeError(
            f"verify service never signaled ready "
            f"(rc={proc.poll()}): {tail}"
        )
    return proc


async def _service_dump(socket_path: str) -> dict:
    """One STATS frame over the UDS — the service-side ledger summary +
    tenant table, pulled while the service is still up."""
    from tendermint_tpu_torch.parallel.verify_service import (
        MSG_STATS,
        MSG_STATS_RESULT,
        _Cursor,
        _HDR,
        read_frame,
        write_frame,
    )

    reader, writer = await asyncio.open_unix_connection(socket_path)
    try:
        write_frame(writer, _HDR.pack(MSG_STATS, 1))
        await writer.drain()
        frame = await asyncio.wait_for(read_frame(reader), timeout=30.0)
        cur = _Cursor(frame)
        typ, _ = _HDR.unpack(cur.take(_HDR.size))
        assert typ == MSG_STATS_RESULT, f"unexpected frame {typ}"
        return json.loads(cur.bytes32())
    finally:
        writer.close()


def _split_nodes(n: int, procs: int) -> list[tuple[int, int]]:
    """Contiguous [lo, hi) node ranges, sizes differing by at most 1."""
    base, rem = divmod(n, procs)
    spans, lo = [], 0
    for p in range(procs):
        hi = lo + base + (1 if p < rem else 0)
        spans.append((lo, hi))
        lo = hi
    return [s for s in spans if s[1] > s[0]]


def run_size(
    n: int,
    heights: int = 2,
    warm: int = 2,
    max_procs: int = 8,
    service_max_batch: int = DEFAULT_SERVICE_MAX_BATCH,
    sock_dir: str = tempfile.gettempdir(),
    device: str = "cuda",
) -> dict:
    """One verify_service measurement row: a fresh service process on
    `device` + the n-validator committee split across min(n, max_procs)
    node processes."""
    socket_path = os.path.join(
        sock_dir, f"vsbench-{os.getpid()}-{n}.sock"
    )
    spans = _split_nodes(n, min(n, max_procs))
    service = _spawn_service(socket_path, service_max_batch, device=device)
    workers = []
    try:
        t_spawn = time.monotonic()
        for lo, hi in spans:
            workers.append(
                subprocess.Popen(
                    [
                        sys.executable,
                        os.path.abspath(__file__),
                        "--worker",
                        "--socket",
                        socket_path,
                        "--validators",
                        str(n),
                        "--node-lo",
                        str(lo),
                        "--node-hi",
                        str(hi),
                        "--heights",
                        str(heights),
                        "--warm",
                        str(warm),
                    ],
                    stdout=subprocess.PIPE,
                    text=True,
                    cwd=REPO_ROOT,
                )
            )
        # generous: cold worker first-height pays the service's bucket
        # compiles; CLOCK_MONOTONIC is host-wide so worker stamps merge
        timeout = 600 + n * 6 * (warm + heights)
        results, errors = [], []
        for w in workers:
            try:
                stdout, _ = w.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                w.kill()
                errors.append("worker timeout")
                continue
            try:
                doc = json.loads(stdout.strip().splitlines()[-1])
            except (ValueError, IndexError):
                errors.append(f"worker rc={w.returncode}: bad output")
                continue
            if doc.get("error"):
                errors.append(doc["error"])
            results.extend(doc.get("nodes", []))
        try:
            dump = asyncio.run(_service_dump(socket_path))
        except Exception as e:
            # a dead service is usually also WHY the workers errored —
            # the row must carry their errors, not just this one
            dump = {}
            errors.append(f"service dump failed: {e!r}")
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
        service.terminate()
        try:
            service.wait(timeout=30)
        except subprocess.TimeoutExpired:
            service.kill()
        try:
            os.unlink(socket_path)
        except OSError:
            pass

    if errors or len(results) != n:
        return {
            "n": n,
            "error": "; ".join(errors)
            or f"only {len(results)}/{n} node loops finished",
            "processes": len(spans),
        }
    # wall-per-height across the whole committee: first measured height
    # start to last node's finish (host-wide CLOCK_MONOTONIC)
    t_start = min(r["t_measure_start"] for r in results)
    t_end = max(r["t_end"] for r in results)
    wall_per_height = (t_end - t_start) / heights
    rtt_count = sum(r["ipc"]["rtt_count"] for r in results)
    rtt_sum = sum(r["ipc"]["rtt_sum_s"] for r in results)
    degrades = sum(r["ipc"]["degrades"] for r in results)
    summary = dump.get("summary", {})
    rounds = max(1, summary.get("rounds", 0))
    # cross-process coalescing on the SIG dispatch plane: the global
    # requests_per_dispatch is diluted by fn rounds, which are
    # one-submission-per-round by design (a BLS aggregate group is its
    # own engine round) — by_bucket covers sig rounds only
    by_bucket = summary.get("by_bucket") or {}
    sig_rounds = sum(b["rounds"] for b in by_bucket.values())
    sig_subs = sum(b["submissions"] for b in by_bucket.values())
    sig_rpd = round(sig_subs / sig_rounds, 3) if sig_rounds else 0.0
    # IPC overhead model (PERF_ANALYSIS §20): what the client pays on
    # top of the service-side work it waited for — mean RTT minus the
    # per-round device+prep mean and the per-submission queue wait
    subs = sum(
        c.get("submissions", 0)
        for c in (summary.get("per_class") or {}).values()
    )
    service_side_s = (
        summary.get("device_seconds", 0.0)
        + summary.get("host_prep_seconds", 0.0)
    ) / rounds + summary.get("queue_wait_seconds", 0.0) / max(1, subs)
    rtt_mean = rtt_sum / rtt_count if rtt_count else 0.0
    return {
        "n": n,
        "heights": heights,
        "processes": len(spans),
        "sig_verify": "real",  # ed25519 + BLS, no stub anywhere
        "wall_ms_per_height": round(wall_per_height * 1e3, 1),
        "requests_per_dispatch": sig_rpd,
        "requests_per_dispatch_all_rounds": summary.get(
            "requests_per_dispatch", 0.0
        ),
        "fill_ratio": summary.get("fill_ratio", 0.0),
        "fill_ratio_p50": summary.get("fill_ratio_p50", 0.0),
        "fill_ratio_p95": summary.get("fill_ratio_p95", 0.0),
        "ipc_rtt_mean_ms": round(rtt_mean * 1e3, 3),
        "ipc_overhead_ms": round(
            max(0.0, rtt_mean - service_side_s) * 1e3, 3
        ),
        "remote_submissions": sum(
            r["ipc"]["remote_submissions"] for r in results
        ),
        "degrades": degrades,
        "spawn_to_done_s": round(time.monotonic() - t_spawn, 1),
        "per_client_tenants": len(dump.get("per_client") or {}),
        "service_ledger": summary,
    }


def run_family(
    sizes=(4, 32, 100),
    heights: int = 2,
    warm: int = 2,
    max_procs: int = 8,
    service_max_batch: int = DEFAULT_SERVICE_MAX_BATCH,
    device: str = "cuda",
) -> dict:
    """The bench.py --family verify_service payload: one row per
    committee size, headline wall-per-height at 32 validators; the
    service verifies on `device`."""
    rows = []
    for n in sizes:
        try:
            rows.append(
                run_size(
                    n,
                    heights=heights,
                    warm=warm,
                    max_procs=max_procs,
                    service_max_batch=service_max_batch,
                    device=device,
                )
            )
        except Exception as e:
            rows.append({"n": n, "error": repr(e)})
        r = rows[-1]
        print(
            f"# verify_service n={n}: "
            + (
                f"wall {r['wall_ms_per_height']} ms/height, "
                f"reqs/dispatch {r['requests_per_dispatch']}, "
                f"rtt {r['ipc_rtt_mean_ms']} ms"
                if "error" not in r
                else f"FAILED {r['error']}"
            ),
            file=sys.stderr,
        )
    ok = [r for r in rows if "error" not in r]
    head = next(
        (r for r in ok if r["n"] == 32), ok[-1] if ok else None
    )
    # per-size extra_metrics rows are assembled by bench.py (the
    # artifact owner); this payload carries the raw rows
    head_n = head["n"] if head else 0
    return {
        "metric": f"verify_service_wall_per_height_n{head_n}",
        "value": head["wall_ms_per_height"] if head else 0.0,
        "unit": (
            f"ms/height: {head_n}-validator committee round of real "
            "ed25519 + BLS through ONE shared verify-service process "
            "over UDS IPC (cross-process coalesced rounds)"
        ),
        "vs_baseline": (
            head["requests_per_dispatch"] if head else 0.0
        ),
        "sizes": rows,
        "service_max_batch": service_max_batch,
        "max_procs": max_procs,
    }


def main() -> int:
    ap = argparse.ArgumentParser(
        description="multi-process verify-service bench harness"
    )
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--socket", default="")
    ap.add_argument("--validators", type=int, default=4)
    ap.add_argument("--node-lo", type=int, default=0)
    ap.add_argument("--node-hi", type=int, default=0)
    ap.add_argument("--heights", type=int, default=2)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--sizes", default="4,32,100")
    ap.add_argument("--max-procs", type=int, default=8)
    ap.add_argument(
        "--service-max-batch",
        type=int,
        default=DEFAULT_SERVICE_MAX_BATCH,
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="device the service verifies on: cuda (default) or cpu",
    )
    args = ap.parse_args()
    if args.worker:
        return run_worker(args)
    sizes = tuple(int(s) for s in args.sizes.split(",") if s.strip())
    print(
        json.dumps(
            run_family(
                sizes=sizes,
                heights=args.heights,
                warm=args.warm,
                max_procs=args.max_procs,
                service_max_batch=args.service_max_batch,
                device=args.device,
            )
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
