"""tendermint-tpu on PyTorch and CUDA: the port of the ed25519 device plane.

The JAX package `tendermint_tpu` stays the reference; this package re-does
its commit-verification path for an NVIDIA H100 (Hopper, sm_90a):

    crypto/    host oracle + signer, shape ladder, batch verifier, convert
    ops/       plain PyTorch field/curve code and the hand-written CUDA
               kernels (ops/csrc) with their wrappers
    types/     chain types; ValidatorSet.verify_commit runs on this verifier
    libs/      protoio, bits
    obs/       the span tracer

Entry points run on CUDA unless the caller passes ``device="cpu"``, where
each kernel's plain PyTorch version runs instead (see ``device.py``).
Imports neither ``jax`` nor anything of ``tendermint_tpu``.
"""

__version__ = "0.1.0"
