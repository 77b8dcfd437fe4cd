"""Named fn-lane engines — the wire-able private-engine table.

Counterpart of ``tendermint_tpu/parallel/engines.py``: the one table that
``VerifyScheduler.submit_wire_fn(_sync)`` resolves engine names from.
Every engine takes a list of wire-able items (tuples of bytes) and
returns aligned verdicts; unparseable inputs are False verdicts, never
connection errors. Engines additionally expose `internal_rows` (items ->
padded row count), which the scheduler books as the round's true bucket
on the fn plane's per-engine axis.

``bls_agg`` and ``qc_verify`` run through ``crypto/bls_signatures`` in
the JAX package's order of routes: pairing checks take the native C++
``pairing_check`` unless ``TM_TPU_BLS_PAIRING_DEVICE=1`` puts them on
the port's pairing kernels (the process verifier's device), and host
bigints without the library; point sums (the signer-key sums of a QC
among them) take the native MSM when the library is present, else the
port's G1/G2 sum kernels from ``DEVICE_AGGREGATE_MIN`` points (every
multi-key signer sum of a QC round) and the host loop below.
``secp_recover`` recovers each signer's Ethereum address on the host, as
the JAX package does.
"""

from __future__ import annotations

from typing import Callable

from ..crypto.shape_registry import default_shape_registry


class WireError(Exception):
    """Malformed engine item (shared with the verify-service frame
    decoding contract — re-exported there)."""


def _engine_bls_agg(items: list[tuple]) -> list:
    """(bls_pubkey_bytes, message, sig_bytes) triples -> per-item bool
    verdicts. Groups by message like BLSBatcher._verify_groups (a
    consensus round's dual-signs share one batch hash) and runs the
    real random-linear-combination aggregate — 2 pairings per all-valid
    group. Unparseable keys/sigs are False, never a connection error."""
    from ..crypto import bls_signatures as bls

    reg = default_shape_registry()
    groups: dict[bytes, list[int]] = {}
    for i, parts in enumerate(items):
        if len(parts) != 3:
            raise WireError("bls_agg item needs (pubkey, msg, sig)")
        groups.setdefault(parts[1], []).append(i)
    verdicts: list = [False] * len(items)
    for msg, idxs in groups.items():
        reg.record_dispatch("bls_agg", reg.bucket_for(len(idxs)))
        pubs, sigs, ok_idx = [], [], []
        for i in idxs:
            try:
                # both parse before either list grows, so a malformed
                # signature cannot desync pubs from sigs
                pub = bls.public_key_from_bytes(
                    items[i][0], trusted_source=True
                )
                sig = bls.g1_from_bytes(items[i][2])
            except bls.BLSError:
                continue  # verdict stays False
            pubs.append(pub)
            sigs.append(sig)
            ok_idx.append(i)
        if not ok_idx:
            continue
        for i, v in zip(
            ok_idx, bls.verify_batch_same_message(msg, pubs, sigs)
        ):
            verdicts[i] = bool(v)
    return verdicts


def _bls_agg_rows(items: list[tuple]) -> int:
    """True internal rows of a bls_agg round: each same-message group
    pads to its ladder bucket (the 256 rung is the 100-200 signer
    home)."""
    reg = default_shape_registry()
    groups: dict[bytes, int] = {}
    for parts in items:
        if len(parts) == 3:
            groups[parts[1]] = groups.get(parts[1], 0) + 1
    return sum(reg.bucket_for(n) for n in groups.values())


_engine_bls_agg.internal_rows = _bls_agg_rows


def _engine_secp_recover(items: list[tuple]) -> list:
    """(hash32, sig65) pairs -> recovered eth address bytes (empty on
    failure). The sequencer-set membership check stays client-side —
    the allowed set is the client's config, not the service's."""
    from ..crypto import secp256k1

    out: list = []
    for parts in items:
        if len(parts) != 2:
            raise WireError("secp_recover item needs (hash, sig)")
        h, sig = parts
        try:
            addr = secp256k1.eth_recover_address(h, sig) if sig else None
        except Exception:
            addr = None
        out.append(addr or b"")
    return out


def _engine_qc_verify(items: list[tuple]) -> list:
    """(message, agg_sig_96, signer_pubkeys_concat) -> per-item bool
    verdicts: one 2-pairing aggregate check per QC, a whole round as a
    single random-linear-combination multi-pairing (crypto/
    bls_signatures.verify_qc_items). The flat-in-committee-size commit
    verify the QC plane exists for."""
    from ..crypto.bls_signatures import BLSError, verify_qc_items

    try:
        return verify_qc_items(items)
    except BLSError as e:
        raise WireError(str(e)) from None


# qc items are not bucket-padded — each is one aggregate check whose
# pairing cost is independent of signer count
_engine_qc_verify.internal_rows = len


BUILTIN_ENGINES: dict[str, Callable[[list], list]] = {
    "bls_agg": _engine_bls_agg,
    "secp_recover": _engine_secp_recover,
    "qc_verify": _engine_qc_verify,
}
