"""Device plane of the port: plain PyTorch field/curve/SHA-512 code and the
hand-written CUDA kernels (``csrc/``) of the ed25519 verify paths.

``kernel_launches()`` reads the launch count of every kernel wrapper and
``reset_launches()`` zeroes them; a run that sets them to 0, drives the
main path and reads them shows which kernels the path went through.
"""


def _wrappers() -> dict:
    from .dbl_chain import dbl_chain
    from .ed25519_batch import (
        neg_pubkey_bigtable,
        neg_pubkey_table,
        verify_prehashed,
        verify_prehashed_bigcache,
        verify_prehashed_bigcache_mxu,
        verify_prehashed_table,
    )
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
    }


def kernel_launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launches() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
