"""Device plane of the port: plain PyTorch field/curve/SHA-512/BLS12-381/
secp256k1/SHA-256 code and the hand-written CUDA kernels (``csrc/``) of
the ed25519 verify paths, the quorum-certificate path, the secp256k1 rows
of mixed-key commits, the merkle leaf hashes and the mesh-wide BLS point
sums (``shard_reduce``).

``kernel_launches()`` reads the launch count of every kernel wrapper and
``reset_launches()`` zeroes them; a run that sets them to 0, drives the
main path and reads them shows which kernels the path went through.
"""


def _wrappers() -> dict:
    from .bls_g1 import g1_add, g1_aggregate
    from .bls_g2 import g2_add, g2_aggregate
    from .bls_pairing import final_exp, miller
    from .dbl_chain import dbl_chain
    from .ed25519_batch import (
        neg_pubkey_bigtable,
        neg_pubkey_table,
        verify_prehashed,
        verify_prehashed_bigcache,
        verify_prehashed_bigcache_mxu,
        verify_prehashed_table,
    )
    from .secp256k1_kernel import verify_prehashed as secp_verify_prehashed
    from .sha256 import sha256_batch
    from .sha512 import challenge_batch, reduce_mod_l

    return {
        "neg_pubkey_table": neg_pubkey_table,
        "verify_prehashed_table": verify_prehashed_table,
        "verify_prehashed": verify_prehashed,
        "dbl_chain": dbl_chain,
        "neg_pubkey_bigtable": neg_pubkey_bigtable,
        "verify_prehashed_bigcache": verify_prehashed_bigcache,
        "verify_prehashed_bigcache_mxu": verify_prehashed_bigcache_mxu,
        "challenge_batch": challenge_batch,
        "reduce_mod_l": reduce_mod_l,
        "g1_aggregate": g1_aggregate,
        "g2_aggregate": g2_aggregate,
        "g1_add": g1_add,
        "g2_add": g2_add,
        "miller": miller,
        "final_exp": final_exp,
        "secp_verify_prehashed": secp_verify_prehashed,
        "sha256_batch": sha256_batch,
    }


def kernel_launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
