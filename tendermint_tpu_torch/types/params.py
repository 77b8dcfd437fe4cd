"""On-chain consensus parameters.

Reference: types/params.go — distinct from local node config; updatable by
the application (and, in the morph fork, the L2 node updates the Batch
params per block, state/execution.go:247,290-307).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

from ..crypto import tmhash

MAX_BLOCK_SIZE_BYTES = 104857600  # 100MB


@dataclass
class BlockParams:
    max_bytes: int = 22020096  # 21MB
    max_gas: int = -1
    time_iota_ms: int = 1000

    def validate(self) -> None:
        if not 0 < self.max_bytes <= MAX_BLOCK_SIZE_BYTES:
            raise ValueError("block.max_bytes out of range")
        if self.max_gas < -1:
            raise ValueError("block.max_gas < -1")


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100000
    max_age_duration_ns: int = 48 * 3600 * 1_000_000_000
    max_bytes: int = 1048576

    def validate(self) -> None:
        if self.max_age_num_blocks <= 0:
            raise ValueError("evidence.max_age_num_blocks must be positive")
        if self.max_age_duration_ns <= 0:
            raise ValueError("evidence.max_age_duration must be positive")


@dataclass
class ValidatorParams:
    pub_key_types: list[str] = field(default_factory=lambda: ["ed25519"])

    def validate(self) -> None:
        if not self.pub_key_types:
            raise ValueError("validator.pub_key_types must not be empty")
        for t in self.pub_key_types:
            if t not in ("ed25519", "secp256k1", "sr25519"):
                raise ValueError(f"unknown pubkey type {t!r}")


@dataclass
class VersionParams:
    app_version: int = 0

    def validate(self) -> None:
        pass


@dataclass
class BatchParams:
    """Morph L2 batch-point parameters (reference types/params.go Batch
    section; updatable by the L2 node per block per
    state/execution.go:290-307): seal a batch every `blocks_interval`
    blocks or after `timeout_ns` or when the batch exceeds `max_bytes`."""

    blocks_interval: int = 0  # 0 = batching disabled
    max_bytes: int = 0
    timeout_ns: int = 0
    max_chunks: int = 0

    def validate(self) -> None:
        if self.blocks_interval < 0:
            raise ValueError("batch.blocks_interval cannot be negative")


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)
    batch: BatchParams = field(default_factory=BatchParams)

    def validate(self) -> None:
        self.block.validate()
        self.evidence.validate()
        self.validator.validate()
        self.version.validate()
        self.batch.validate()

    def hash(self) -> bytes:
        """Deterministic hash committed in Header.consensus_hash."""
        blob = json.dumps(asdict(self), sort_keys=True).encode()
        return tmhash.sum(blob)

    def to_json(self) -> dict:
        return asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ConsensusParams":
        return cls(
            block=BlockParams(**d.get("block", {})),
            evidence=EvidenceParams(**d.get("evidence", {})),
            validator=ValidatorParams(**d.get("validator", {})),
            version=VersionParams(**d.get("version", {})),
            batch=BatchParams(**d.get("batch", {})),
        )

    def update(self, changes: dict) -> "ConsensusParams":
        d = asdict(self)
        for section, vals in changes.items():
            if section in d and isinstance(vals, dict):
                d[section].update(vals)
        params = ConsensusParams.from_json(d)
        params.validate()
        return params
