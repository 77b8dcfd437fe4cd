"""Blocksync bulk-replay throughput: many blocks' commits, one device batch.

BASELINE config 4's shape ("blocksync replay, 10k blocks x 1k validators")
scaled to the harness: B blocks x V validators verified through
ValidatorSet.verify_commits_light (the windowed blocksync path) vs the
per-block loop. Usage: python -m tendermint_tpu_torch.tools.bench_replay [blocks] [validators]
[--device cuda|cpu] (the verifier's device, cuda by default).
"""

import sys
import time

sys.path.insert(0, ".")

from tests.torch_chaos_harness import CHAIN_ID, make_validators, sign_commit  # noqa: E402
from tendermint_tpu_torch.crypto.batch_verifier import BatchVerifier  # noqa: E402
from tendermint_tpu_torch.types.block_id import BlockID  # noqa: E402
from tendermint_tpu_torch.types.part_set import PartSetHeader  # noqa: E402

_ARGS = sys.argv[1:]
DEVICE = "cuda"
if "--device" in _ARGS:
    _i = _ARGS.index("--device")
    DEVICE = _ARGS[_i + 1]
    del _ARGS[_i:_i + 2]
BLOCKS = int(_ARGS[0]) if len(_ARGS) > 0 else 64
VALS = int(_ARGS[1]) if len(_ARGS) > 1 else 128


def main():
    print(f"# building {BLOCKS} commits x {VALS} validators...", flush=True)
    vs, pvs = make_validators(VALS)
    entries = []
    for h in range(1, BLOCKS + 1):
        hb = h.to_bytes(4, "big") * 8
        bid = BlockID(hb, PartSetHeader(1, hb))
        entries.append((bid, h, sign_commit(vs, pvs, h, 0, bid)))
    n_sigs = BLOCKS * VALS

    verifier = BatchVerifier(device=DEVICE)
    verifier.warm([v.pub_key.data for v in vs.validators], bulk=True)

    # warm the kernels for this batch bucket
    verdicts = vs.verify_commits_light(CHAIN_ID, entries, verifier=verifier)
    assert all(verdicts)

    t0 = time.perf_counter()
    verdicts = vs.verify_commits_light(CHAIN_ID, entries, verifier=verifier)
    dt_batch = time.perf_counter() - t0
    assert all(verdicts)

    t0 = time.perf_counter()
    for bid, h, commit in entries:
        vs.verify_commit_light(CHAIN_ID, bid, h, commit, verifier=verifier)
    dt_per_block = time.perf_counter() - t0

    print(
        f"windowed (1 device batch): {n_sigs/dt_batch:,.0f} sigs/s "
        f"({dt_batch*1e3:.0f} ms for {n_sigs} sigs)"
    )
    print(
        f"per-block (1 call/commit): {n_sigs/dt_per_block:,.0f} sigs/s "
        f"({dt_per_block*1e3:.0f} ms)"
    )
    print(f"speedup: {dt_per_block/dt_batch:.1f}x")


if __name__ == "__main__":
    main()
