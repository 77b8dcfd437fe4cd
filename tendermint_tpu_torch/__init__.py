"""tendermint-tpu on PyTorch and CUDA: the port of the ed25519 device plane
and the in-process consensus core.

The JAX package `tendermint_tpu` stays the reference; this package re-does
its commit-verification paths (one commit per height, blocksync's bulk
windows, quorum certificates, mixed-key sets) and the consensus state
machine that drives them, for an NVIDIA H100 (Hopper, sm_90a):

    crypto/    host oracles + signers, shape ladder, batch verifier (small
               and big tiers), BLS12-381 and secp256k1, convert
    ops/       plain PyTorch field/curve/hash code and the hand-written
               CUDA kernels (ops/csrc) with their wrappers
    parallel/  the verify dispatch scheduler and the fn-lane engine table
    consensus/ the state machine, WAL, replay, commit pipeline, pacing,
               the micro-batcher, the vote and BLS batchers
    state/     the block executor, the state and its store, the tx and
               block indexer and the SQL event sink
    store/     the KV stores and the block store
    abci/      the app interface, the local and socket clients, the
               kvstore app and the ABCI CLI
    l2node/    the L2 node interface and its in-memory mock
    privval/   the file and remote signers
    evidence/  evidence verification
    types/     chain types; ValidatorSet.verify_commit* run on this verifier;
               the event bus
    libs/      protoio, bits, log, service, metrics, events, pubsub, fail,
               autofile, flowrate, tmjson, math, clist, cmap, rand, timer,
               sync, cli
    obs/       the span tracer, the device-cost ledger and its report,
               the health plane, the cluster merge and the profiler
               (torch.profiler device trace, event-loop stack sampler)
    rpc/       the JSON-RPC server, its route table, the HTTP, websocket
               and local clients and the light client's RPC provider
    light/     the light client, its store and verifier, and the light
               proxy

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
each kernel's plain PyTorch version runs instead (see ``device.py``).
Imports neither ``jax`` nor anything of ``tendermint_tpu``.
"""

__version__ = "0.1.0"
