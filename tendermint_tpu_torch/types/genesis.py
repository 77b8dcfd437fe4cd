"""GenesisDoc — the chain's origin document (reference types/genesis.go)."""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional

from ..crypto import tmhash
from .params import ConsensusParams
from .validator import Validator, pubkey_from_type
from .validator_set import ValidatorSet

MAX_CHAIN_ID_LEN = 50


@dataclass
class GenesisValidator:
    pub_key_type: str
    pub_key_data: bytes
    power: int
    name: str = ""
    # QC plane: uncompressed G2 BLS key (192 bytes) — committed into the
    # validator-set hash so quorum certificates verify against it
    bls_pub_key: bytes = b""

    def to_validator(self) -> Validator:
        return Validator(
            pub_key=pubkey_from_type(self.pub_key_type, self.pub_key_data),
            voting_power=self.power,
            bls_pub_key=self.bls_pub_key,
        )


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    initial_height: int = 1
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: dict = field(default_factory=dict)

    def validate_and_complete(self) -> None:
        if not self.chain_id or len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise ValueError("invalid chain_id")
        if self.initial_height < 0:
            raise ValueError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        self.consensus_params.validate()
        for v in self.validators:
            if v.power < 0:
                raise ValueError("genesis validator with negative power")
        if self.genesis_time_ns == 0:
            self.genesis_time_ns = time.time_ns()

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet([v.to_validator() for v in self.validators])

    def hash(self) -> bytes:
        return tmhash.sum(json.dumps(self.to_json(), sort_keys=True).encode())

    def to_json(self) -> dict:
        return {
            "chain_id": self.chain_id,
            "genesis_time": self.genesis_time_ns,
            "initial_height": self.initial_height,
            "consensus_params": self.consensus_params.to_json(),
            "validators": [
                {
                    "pub_key": {
                        "type": v.pub_key_type,
                        "value": v.pub_key_data.hex(),
                    },
                    "power": str(v.power),
                    "name": v.name,
                    **(
                        {"bls_pub_key": v.bls_pub_key.hex()}
                        if v.bls_pub_key
                        else {}
                    ),
                }
                for v in self.validators
            ],
            "app_hash": self.app_hash.hex(),
            "app_state": self.app_state,
        }

    @classmethod
    def from_json(cls, d: dict) -> "GenesisDoc":
        doc = cls(
            chain_id=d["chain_id"],
            genesis_time_ns=int(d.get("genesis_time", 0)),
            initial_height=int(d.get("initial_height", 1)),
            consensus_params=ConsensusParams.from_json(
                d.get("consensus_params", {})
            ),
            validators=[
                GenesisValidator(
                    pub_key_type=v["pub_key"]["type"],
                    pub_key_data=bytes.fromhex(v["pub_key"]["value"]),
                    power=int(v["power"]),
                    name=v.get("name", ""),
                    bls_pub_key=bytes.fromhex(v.get("bls_pub_key", "")),
                )
                for v in d.get("validators", [])
            ],
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state=d.get("app_state", {}),
        )
        doc.validate_and_complete()
        return doc

    def save_as(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def from_file(cls, path: str) -> "GenesisDoc":
        with open(path) as f:
            return cls.from_json(json.load(f))
