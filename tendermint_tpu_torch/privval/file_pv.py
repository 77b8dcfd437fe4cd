"""FilePV — file-backed validator signer with double-sign protection.

Reference: privval/file.go — two files: the key (FilePVKey) and the
last-sign state (FilePVLastSignState :75-148). The HRS monotonic guard
(`CheckHRS` :92) refuses to sign at a lower (height, round, step); at the
SAME HRS it re-signs only if the sign-bytes differ solely by timestamp, in
which case it returns the PREVIOUS signature and timestamp
(:401-434 checkVotesOnlyDifferByTimestamp) — crash-safe idempotent signing.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Optional

from ..crypto import ed25519
from ..types import canonical
from ..types.proposal import Proposal
from ..types.vote import Vote, VoteType

STEP_PROPOSE = 1
STEP_PREVOTE = 2
STEP_PRECOMMIT = 3

_VOTE_STEP = {
    VoteType.PREVOTE: STEP_PREVOTE,
    VoteType.PRECOMMIT: STEP_PRECOMMIT,
}


class DoubleSignError(Exception):
    pass


def _atomic_write(path: str, data: str) -> None:
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


@dataclass
class LastSignState:
    height: int = 0
    round: int = 0
    step: int = 0
    signature: bytes = b""
    sign_bytes: bytes = b""

    def check_hrs(self, height: int, round_: int, step: int) -> bool:
        """Returns True if this exact HRS was already signed (caller must
        then check sign-bytes); raises on regression (reference CheckHRS
        privval/file.go:92)."""
        if self.height > height:
            raise DoubleSignError(f"height regression: {self.height} > {height}")
        if self.height == height:
            if self.round > round_:
                raise DoubleSignError(
                    f"round regression at height {height}: "
                    f"{self.round} > {round_}"
                )
            if self.round == round_:
                if self.step > step:
                    raise DoubleSignError(
                        f"step regression at {height}/{round_}: "
                        f"{self.step} > {step}"
                    )
                if self.step == step:
                    if not self.sign_bytes:
                        raise DoubleSignError("no sign bytes for same HRS")
                    return True
        return False


class FilePV:
    def __init__(
        self,
        priv_key: ed25519.PrivKey,
        key_path: str,
        state_path: str,
        last_state: Optional[LastSignState] = None,
    ):
        self.priv_key = priv_key
        self._key_path = key_path
        self._state_path = state_path
        self.last_state = last_state or LastSignState()

    # --- persistence ------------------------------------------------------

    @classmethod
    def generate(cls, key_path: str, state_path: str) -> "FilePV":
        pv = cls(ed25519.PrivKey.generate(), key_path, state_path)
        pv.save()
        return pv

    @classmethod
    def load_or_generate(cls, key_path: str, state_path: str) -> "FilePV":
        if os.path.exists(key_path):
            return cls.load(key_path, state_path)
        return cls.generate(key_path, state_path)

    @classmethod
    def load(cls, key_path: str, state_path: str) -> "FilePV":
        with open(key_path) as f:
            kd = json.load(f)
        priv = ed25519.PrivKey(bytes.fromhex(kd["priv_key"]))
        st = LastSignState()
        if os.path.exists(state_path):
            with open(state_path) as f:
                sd = json.load(f)
            st = LastSignState(
                height=sd["height"],
                round=sd["round"],
                step=sd["step"],
                signature=bytes.fromhex(sd.get("signature", "")),
                sign_bytes=bytes.fromhex(sd.get("sign_bytes", "")),
            )
        return cls(priv, key_path, state_path, st)

    def save(self) -> None:
        pub = self.priv_key.public_key()
        _atomic_write(
            self._key_path,
            json.dumps(
                {
                    "address": pub.address().hex(),
                    "pub_key": pub.data.hex(),
                    "priv_key": self.priv_key.seed.hex(),
                },
                indent=2,
            ),
        )
        self._save_state()

    def _save_state(self) -> None:
        st = self.last_state
        _atomic_write(
            self._state_path,
            json.dumps(
                {
                    "height": st.height,
                    "round": st.round,
                    "step": st.step,
                    "signature": st.signature.hex(),
                    "sign_bytes": st.sign_bytes.hex(),
                },
                indent=2,
            ),
        )

    # --- PrivValidator ----------------------------------------------------

    def get_pub_key(self) -> ed25519.PubKey:
        return self.priv_key.public_key()

    def sign_vote(self, chain_id: str, vote: Vote) -> None:
        step = _VOTE_STEP[vote.type]
        sign_bytes = vote.sign_bytes(chain_id)
        same_hrs = self.last_state.check_hrs(vote.height, vote.round, step)
        if same_hrs:
            if sign_bytes == self.last_state.sign_bytes:
                vote.signature = self.last_state.signature
                return
            prev_ts = _timestamp_from_vote_sign_bytes(
                self.last_state.sign_bytes
            )
            if (
                prev_ts is not None
                and _strip_vote_timestamp(sign_bytes)
                == _strip_vote_timestamp(self.last_state.sign_bytes)
            ):
                # differs only by timestamp: reuse previous sig + timestamp
                vote.timestamp_ns = prev_ts
                vote.signature = self.last_state.signature
                return
            raise DoubleSignError(
                "conflicting vote data at the same height/round/step"
            )
        sig = self.priv_key.sign(sign_bytes)
        self.last_state = LastSignState(
            vote.height, vote.round, step, sig, sign_bytes
        )
        self._save_state()  # persist BEFORE releasing the signature
        vote.signature = sig

    def sign_proposal(self, chain_id: str, proposal: Proposal) -> None:
        sign_bytes = proposal.sign_bytes(chain_id)
        same_hrs = self.last_state.check_hrs(
            proposal.height, proposal.round, STEP_PROPOSE
        )
        if same_hrs:
            if sign_bytes == self.last_state.sign_bytes:
                proposal.signature = self.last_state.signature
                return
            prev_ts = _timestamp_from_proposal_sign_bytes(
                self.last_state.sign_bytes
            )
            if (
                prev_ts is not None
                and _strip_proposal_timestamp(sign_bytes)
                == _strip_proposal_timestamp(self.last_state.sign_bytes)
            ):
                proposal.timestamp_ns = prev_ts
                proposal.signature = self.last_state.signature
                return
            raise DoubleSignError(
                "conflicting proposal data at the same height/round"
            )
        sig = self.priv_key.sign(sign_bytes)
        self.last_state = LastSignState(
            proposal.height, proposal.round, STEP_PROPOSE, sig, sign_bytes
        )
        self._save_state()
        proposal.signature = sig


# --- sign-bytes timestamp surgery -----------------------------------------
# Canonical votes/proposals are delimited proto messages; the timestamp is
# an embedded message field. To compare "same except timestamp" we re-encode
# with the timestamp field zeroed.

from io import BytesIO

from ..libs import protoio as pio


def _strip_field(sign_bytes: bytes, field_num: int) -> Optional[bytes]:
    try:
        body = pio.read_delimited(BytesIO(sign_bytes))
        out = b""
        for fnum, wt, val in pio.iter_fields(body):
            if fnum == field_num:
                continue
            if wt == pio.WIRE_BYTES:
                out += pio.field_message(fnum, val)
            elif wt == pio.WIRE_FIXED64:
                out += pio.field_sfixed64(fnum, val)
            else:
                out += pio.tag(fnum, wt) + pio.write_varint(val)
        return out
    except (EOFError, ValueError):
        return None


def _extract_ts(sign_bytes: bytes, field_num: int) -> Optional[int]:
    try:
        body = pio.read_delimited(BytesIO(sign_bytes))
        f = pio.decode_fields(body)
        if field_num not in f:
            return None
        return canonical.decode_timestamp(f[field_num][0])
    except (EOFError, ValueError):
        return None


def _strip_vote_timestamp(sb: bytes) -> Optional[bytes]:
    return _strip_field(sb, 5)  # CanonicalVote.timestamp = field 5


def _timestamp_from_vote_sign_bytes(sb: bytes) -> Optional[int]:
    return _extract_ts(sb, 5)


def _strip_proposal_timestamp(sb: bytes) -> Optional[bytes]:
    return _strip_field(sb, 6)  # CanonicalProposal.timestamp = field 6


def _timestamp_from_proposal_sign_bytes(sb: bytes) -> Optional[int]:
    return _extract_ts(sb, 6)
