"""fsync microbenchmark — single vs group-commit WAL fsync throughput.

The commit pipeline's disk-side claim is that precommit-time `write_sync`
calls sharing one fsync (consensus/wal.GroupCommitWAL) beat one fsync
per record (the serial reference path, consensus/state.go:821-828). This
tool measures both on THIS box's filesystem so PERF_ANALYSIS §12 quotes a
stored run instead of an assumption.

Shapes measured:
  - serial_write_sync: N sequential write_sync on the plain WAL
    (one fsync each — the pre-pipeline behavior),
  - group_sequential: N sequential write_sync on GroupCommitWAL (the
    barrier still waits per call; coalescing only helps if the flush
    interval captures queued writers),
  - group_concurrent_cW: N records from W writer threads on
    GroupCommitWAL (the pipeline shape: the consensus loop + the
    background finalization + replay all barriering concurrently),
  - raw_fsync: bare os.fsync on an appended fd, the floor.

Run:  python -m tendermint_tpu_torch.tools.fsync_bench [records] [outdir]
Prints one JSON object (artifact shape like tools/bench_executor.py).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from tendermint_tpu_torch.consensus.wal import (  # noqa: E402
    WAL,
    GroupCommitWAL,
    WALMessage,
)

PAYLOAD = b"x" * 256  # ~ a consensus vote record


def _bench_serial(path: str, n: int) -> dict:
    wal = WAL(path)
    t0 = time.perf_counter()
    for i in range(n):
        wal.write_sync(WALMessage("consensus", PAYLOAD))
    dt = time.perf_counter() - t0
    fsyncs = wal.fsync_count
    wal.close()
    return {
        "records_per_s": round(n / dt, 1),
        "fsyncs": fsyncs,
        "ms_per_record": round(dt / n * 1e3, 4),
    }


def _bench_group_sequential(path: str, n: int, flush_interval: float) -> dict:
    wal = GroupCommitWAL(path, flush_interval=flush_interval)
    t0 = time.perf_counter()
    for i in range(n):
        wal.write_sync(WALMessage("consensus", PAYLOAD))
    dt = time.perf_counter() - t0
    fsyncs = wal.fsync_count
    wal.close()
    return {
        "records_per_s": round(n / dt, 1),
        "fsyncs": fsyncs,
        "ms_per_record": round(dt / n * 1e3, 4),
    }


def _bench_group_concurrent(
    path: str, n: int, writers: int, flush_interval: float
) -> dict:
    wal = GroupCommitWAL(path, flush_interval=flush_interval)
    per = n // writers
    start = threading.Barrier(writers + 1)

    def w():
        start.wait()
        for _ in range(per):
            wal.write_sync(WALMessage("consensus", PAYLOAD))

    threads = [threading.Thread(target=w) for _ in range(writers)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t0
    fsyncs = wal.fsync_count
    wal.close()
    total = per * writers
    return {
        "records_per_s": round(total / dt, 1),
        "fsyncs": fsyncs,
        "records_per_fsync": round(total / max(1, fsyncs), 2),
        "ms_per_record": round(dt / total * 1e3, 4),
    }


def _bench_raw_fsync(path: str, n: int) -> dict:
    f = open(path, "ab")
    t0 = time.perf_counter()
    for _ in range(n):
        f.write(PAYLOAD)
        f.flush()
        os.fsync(f.fileno())
    dt = time.perf_counter() - t0
    f.close()
    return {
        "fsyncs_per_s": round(n / dt, 1),
        "ms_per_fsync": round(dt / n * 1e3, 4),
    }


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    outdir = sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp(
        prefix="fsync_bench_"
    )
    os.makedirs(outdir, exist_ok=True)
    flush_interval = float(os.environ.get("TM_TPU_FSYNC_FLUSH", "0.002"))

    out = {
        "tool": "fsync_bench",
        "records": n,
        "flush_interval_s": flush_interval,
        "dir": outdir,
        "raw_fsync": _bench_raw_fsync(os.path.join(outdir, "raw"), n),
        "serial_write_sync": _bench_serial(
            os.path.join(outdir, "serial"), n
        ),
        "group_sequential": _bench_group_sequential(
            os.path.join(outdir, "group_seq"), n, flush_interval
        ),
    }
    for writers in (2, 4, 8):
        out[f"group_concurrent_c{writers}"] = _bench_group_concurrent(
            os.path.join(outdir, f"group_c{writers}"),
            n,
            writers,
            flush_interval,
        )
    serial = out["serial_write_sync"]["fsyncs"]
    c8 = out["group_concurrent_c8"]["fsyncs"]
    out["fsync_reduction_c8"] = round(serial / max(1, c8), 2)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
