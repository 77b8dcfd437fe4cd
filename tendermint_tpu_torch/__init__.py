"""tendermint-tpu on PyTorch and CUDA: the port of the ed25519 device plane.

The JAX package `tendermint_tpu` stays the reference; this package re-does
its commit-verification paths (one commit per height, and blocksync's
bulk windows) for an NVIDIA H100 (Hopper, sm_90a):

    crypto/    host oracle + signer, shape ladder, batch verifier (small
               and big tiers), convert
    ops/       plain PyTorch field/curve/SHA-512 code and the hand-written
               CUDA kernels (ops/csrc) with their wrappers
    parallel/  the verify dispatch scheduler and the fn-lane engine table
    consensus/ the micro-batcher and the vote batcher
    types/     chain types; ValidatorSet.verify_commit* run on this verifier
    libs/      protoio, bits, log, service, metrics
    obs/       the span tracer, the device-cost ledger and its report

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
each kernel's plain PyTorch version runs instead (see ``device.py``).
Imports neither ``jax`` nor anything of ``tendermint_tpu``.
"""

__version__ = "0.1.0"
