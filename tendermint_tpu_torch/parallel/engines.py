"""Named fn-lane engines — the wire-able private-engine table.

Counterpart of ``tendermint_tpu/parallel/engines.py``: the one table that
``VerifyScheduler.submit_wire_fn(_sync)`` resolves engine names from. The
names and the table stay, so the scheduler's lookup and its fallback for
unknown engines behave as in the reference. The engines themselves run
BLS12-381 aggregation and pairings (``bls_agg``, ``qc_verify``) and
secp256k1 address recovery (``secp_recover``), whose kernels and modules
are not ported yet: each raises ``NotImplementedError`` naming the ROADMAP
item, rather than an ``ImportError`` at call time that would hide why.
"""

from __future__ import annotations

from typing import Callable

_ROADMAP_GATED = "ROADMAP gated kernels (rows 10-12: secp256k1, BLS)"


class WireError(Exception):
    """Malformed engine item (shared with the verify-service frame
    decoding contract)."""


def _unported(engine: str) -> Callable[[list], list]:
    def run(items: list) -> list:
        raise NotImplementedError(f"{engine} engine: {_ROADMAP_GATED}")

    run.__name__ = f"_engine_{engine}"
    return run


_engine_bls_agg = _unported("bls_agg")
_engine_secp_recover = _unported("secp_recover")
_engine_qc_verify = _unported("qc_verify")

BUILTIN_ENGINES: dict[str, Callable[[list], list]] = {
    "bls_agg": _engine_bls_agg,
    "secp_recover": _engine_secp_recover,
    "qc_verify": _engine_qc_verify,
}
