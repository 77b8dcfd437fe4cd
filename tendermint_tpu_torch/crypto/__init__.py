"""Host cryptography of the port: the ed25519 oracle and signer, tmhash,
merkle, the shape ladder, and the batch verifier over the CUDA kernels."""

from tendermint_tpu_torch.crypto import ed25519  # noqa: F401
