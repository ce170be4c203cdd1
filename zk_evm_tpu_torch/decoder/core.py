"""The inputs of one batch proof.

Copies of the JAX package's `decoder/core.py` `TrieInputs` and
`GenerationInputs` (the reference's GenerationInputs, zk_evm's
evm_arithmetization/src/generation/mod.rs:82-128). The block decoder
itself (`entrypoint`, `middle`) is not ported: the in-repo fixtures
(`witness/testing_fixtures.py`) build these inputs directly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..stark.public_values import TrieRoots


@dataclass
class TrieInputs:
    """The minimal `before` tries a batch proof needs (core.rs's masked
    IntraBlockTries): touched paths kept, everything else hashed out."""
    state: object                 # mpt Trie
    storage: dict                 # hashed addr -> mpt Trie
    transactions: object
    receipts: object
    code: dict = field(default_factory=dict)


@dataclass
class GenerationInputs:
    """Everything one batch proof consumes (the reference's
    GenerationInputs, evm_arithmetization/src/generation/mod.rs:82-128).
    Feeds witness generation + the segment prover."""
    txn_number_before: int
    gas_used_before: int
    gas_used_after: int
    signed_txns: list
    withdrawals: list
    tries: TrieInputs
    trie_roots_after: TrieRoots
    checkpoint_state_trie_root: bytes
    checkpoint_consolidated_hash: tuple
    contract_code: dict
    block_metadata: object
    block_hashes: object
    # cdk_erigon only (generation/mod.rs:99-133): pre-block GER write
    # data (l1 root, l1 block hash) and the burn address
    ger_data: tuple | None = None
    burn_addr: bytes | None = None
