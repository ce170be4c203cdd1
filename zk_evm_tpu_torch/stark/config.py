"""Prover configuration.

Parameter twins of the reference's `StarkConfig::standard_fast_config()`
(rate_bits=1, cap_height=4, 84 FRI queries, 16-bit PoW, fold arity 2^4 to a
2^5-coefficient final polynomial; used at /root/reference/
evm_arithmetization/src/lib.rs:26) and of `TEST_STARK_CONFIG` (1 query
round; testing_utils.rs:41-52 — the reference's CI trick is a weakened FRI
config, not a mock, and we keep that strategy).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 1
    cap_height: int = 4
    proof_of_work_bits: int = 16
    num_query_rounds: int = 84
    arity_bits: int = 4          # fold 16 per commit-phase step
    final_poly_bits: int = 5     # stop folding at <= 2^5 coefficients

    def reduction_arity_bits(self, degree_bits: int) -> list[int]:
        """Fold schedule: arity_bits steps while the remaining degree stays
        above final_poly_bits (ConstantArityBits semantics)."""
        out = []
        rem = degree_bits
        while rem - self.arity_bits >= self.final_poly_bits:
            out.append(self.arity_bits)
            rem -= self.arity_bits
        return out


@dataclass(frozen=True)
class StarkConfig:
    security_bits: int = 100
    num_challenges: int = 2
    fri_config: FriConfig = field(default_factory=FriConfig)
    # Merkle commitment hasher: "poseidon" (device path, recursion-
    # friendly — the reference's PoseidonGoldilocksConfig), "keccak"
    # (the KeccakGoldilocksConfig outer-config twin used by the
    # reference's integration tests, tests/simple_transfer.rs:24,30 —
    # round 5: commitment trees hash ON DEVICE via the 2xu32-lane
    # keccak-f[1600] XLA kernel), or "keccak_host" (the numpy twin,
    # kept as bit-exactness ground truth).
    #
    # DECISION (r4 Missing #3, documented): the transcript challenger
    # stays the Poseidon duplex under every hasher config. The
    # reference's GenericConfig switches the challenger permutation
    # with the config (lib.rs:23); ours is already a documented
    # deviation from plonky2's Poseidon constants (challenger/), so
    # keeping ONE audited Fiat-Shamir permutation across configs is
    # both simpler and safer — digests are 4 GF elements either way,
    # and prover/verifier agree by construction.
    hasher: str = "poseidon"

    @property
    def rate_bits(self) -> int:
        return self.fri_config.rate_bits

    @property
    def cap_height(self) -> int:
        return self.fri_config.cap_height

    @staticmethod
    def standard_fast_config() -> "StarkConfig":
        return StarkConfig()

    @staticmethod
    def test_config() -> "StarkConfig":
        """Weak-FRI config for CI: same code paths, 1 query round, no PoW."""
        return StarkConfig(
            security_bits=1,
            fri_config=FriConfig(proof_of_work_bits=0, num_query_rounds=1),
        )
