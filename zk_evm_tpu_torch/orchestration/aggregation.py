"""Batch- and block-level aggregation statements.

Host twin of the reference's recursive-aggregation public-value algebra
(zk_evm's evm_arithmetization/src/fixed_recursive_verifier.rs):

- batch aggregation (`create_batch_aggregation_circuit`, :1336-1446):
  adjacent transaction batches of one block chain their trie roots and
  txn/gas counters; the combined statement spans both.
- block statement (`create_block_circuit` + `connect_block_proof`,
  :1528-1621, :1916-1963): the batch-aggregation root is promoted to a
  block claim — initial counters are zero, the txn/receipt tries start
  empty, and the block's metadata gas equals the final gas counter.
- block wrapper (`create_block_wrapper_circuit`, :1753-1816 +
  proof.rs:154-310): exposes `FinalPublicValues` (chain id, checkpoint
  and new state roots, checkpoint/new consolidated hashes).

Every check here is replayed structurally over verified segment
AllProofs. Copy of the JAX package's `orchestration/aggregation.py` with
`device` passed through to the segment prover and the initial-cap
commitment. The checkpoint check and `FinalPublicValues.to_elements`
are what the recursion wrap (`recursion/aggregate.py`) is held to. The
parent-block link of `verify_block_chain`, the decoder path's
checkpoint restamping, the bounded multi-block loop and the two-to-one
mix wait for the decoder: the port proves one block at a time.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache

from ..hash import host_poseidon
from ..mpt.trie import EMPTY_TRIE_HASH
from ..stark.public_values import PublicValues, h256_limbs
from ..timing import timed
from .block import verify_segments


# ---------------------------------------------------------------------------
# Batch aggregation (PV algebra of create_batch_aggregation_circuit)
# ---------------------------------------------------------------------------

def check_batch_pair(a: PublicValues, b: PublicValues) -> None:
    """Adjacent txn batches of one block (connect_extra_public_values +
    the trie/metadata connections, fixed_recursive_verifier.rs:1353-1446,
    1635-1672)."""
    assert a.block_metadata == b.block_metadata, \
        "batch chain: block metadata differs"
    assert a.block_hashes == b.block_hashes, \
        "batch chain: block hashes differ"
    assert a.trie_roots_after == b.trie_roots_before, \
        "batch chain: trie roots do not chain"
    ea, eb = a.extra_block_data, b.extra_block_data
    assert ea.checkpoint_state_trie_root == eb.checkpoint_state_trie_root
    assert ea.checkpoint_consolidated_hash == eb.checkpoint_consolidated_hash
    assert ea.txn_number_after == eb.txn_number_before, \
        "batch chain: txn counter does not chain"
    assert ea.gas_used_after == eb.gas_used_before, \
        "batch chain: gas counter does not chain"


def combine_batch_pvs(a: PublicValues, b: PublicValues) -> PublicValues:
    """Combined statement spanning two adjacent batches (the batch-agg
    circuit's public values wiring)."""
    extra = replace(a.extra_block_data,
                    txn_number_after=b.extra_block_data.txn_number_after,
                    gas_used_after=b.extra_block_data.gas_used_after)
    return replace(a, trie_roots_after=b.trie_roots_after,
                   extra_block_data=extra,
                   registers_after=b.registers_after)


def batch_public_values(chain_proofs: list) -> PublicValues:
    """Statement of one verified segment chain: the shared block-batch
    statement with boundary registers (the segment-agg circuit's output
    publics, fixed_recursive_verifier.rs:1165-1334)."""
    first, last = chain_proofs[0].public_values, \
        chain_proofs[-1].public_values
    return replace(first, registers_after=last.registers_after)


# ---------------------------------------------------------------------------
# Block statement (connect_initial_values_block)
# ---------------------------------------------------------------------------

def consolidate_hashes(hashes: list[bytes]) -> tuple[int, int, int, int]:
    """Poseidon hash_no_pad over 256 H256s as 8-limb encodings
    (proof.rs:385-393) — the compact commitment to a block-hash window."""
    assert len(hashes) == 256, len(hashes)
    payload: list[int] = []
    for h in hashes:
        payload += h256_limbs(h)
    return tuple(host_poseidon.hash_no_pad(payload))


@lru_cache(maxsize=1)
def empty_consolidated_blockhash() -> tuple:
    """Consolidation of an all-zero hash window — the value a genesis-
    anchored chain claims as its checkpoint consolidated hash (the
    reference's EMPTY_CONSOLIDATED_BLOCKHASH, proof.rs:505-510, under
    our Poseidon parameterization)."""
    return consolidate_hashes([b"\x00" * 32] * 256)


def check_block_initial(pv: PublicValues) -> None:
    """Start-of-block invariants (connect_initial_values_block +
    connect_final_block_values_to_intermediary,
    fixed_recursive_verifier.rs:1998-2027)."""
    e = pv.extra_block_data
    assert e.txn_number_before == 0, "block must start at txn 0"
    assert e.gas_used_before == 0, "block must start at gas 0"
    assert pv.trie_roots_before.transactions_root == EMPTY_TRIE_HASH, \
        "txn trie must start empty"
    assert pv.trie_roots_before.receipts_root == EMPTY_TRIE_HASH, \
        "receipt trie must start empty"
    assert pv.block_metadata.block_gas_used == e.gas_used_after, \
        "header gas_used must equal the final gas counter"


def check_checkpoint_block(pv: PublicValues) -> None:
    """A block with no parent proof anchors at the checkpoint: its
    pre-state root IS the checkpoint root and the consolidated hash of
    its 256 previous block hashes matches the claimed checkpoint
    consolidation (connect_checkpoint_block, :1965-1996)."""
    e = pv.extra_block_data
    assert pv.trie_roots_before.state_root == \
        e.checkpoint_state_trie_root, \
        "checkpoint block pre-state root != checkpoint root"
    assert tuple(e.checkpoint_consolidated_hash) == \
        consolidate_hashes(list(pv.block_hashes.prev_hashes)), \
        "checkpoint consolidated hash mismatch"


# ---------------------------------------------------------------------------
# Block proof object + FinalPublicValues
# ---------------------------------------------------------------------------

@dataclass
class BlockProof:
    """One block's full proof: per-batch segment chains + the block
    statement derived from (and checked against) them."""
    batches: list                    # list[list[AllProof]]
    public_values: PublicValues      # block-level statement


@dataclass
class FinalPublicValues:
    """proof.rs:154-199 — the externally-consumed block statement."""
    chain_id: int
    checkpoint_state_trie_root: bytes
    new_state_trie_root: bytes
    checkpoint_consolidated_hash: tuple
    new_consolidated_hash: tuple

    @staticmethod
    def from_public_values(pv: PublicValues) -> "FinalPublicValues":
        payload = list(pv.block_hashes.prev_hashes[1:]) \
            + [pv.block_hashes.cur_hash]
        return FinalPublicValues(
            chain_id=pv.block_metadata.block_chain_id,
            checkpoint_state_trie_root=pv.trie_roots_before.state_root,
            new_state_trie_root=pv.trie_roots_after.state_root,
            checkpoint_consolidated_hash=tuple(
                pv.extra_block_data.checkpoint_consolidated_hash),
            new_consolidated_hash=consolidate_hashes(payload),
        )

    def to_elements(self) -> list[int]:
        return [self.chain_id] \
            + h256_limbs(self.checkpoint_state_trie_root) \
            + h256_limbs(self.new_state_trie_root) \
            + list(self.checkpoint_consolidated_hash) \
            + list(self.new_consolidated_hash)


def aggregate_block(batch_chains: list[list], kernel,
                    config=None, device=None) -> BlockProof:
    """Verify every batch's segment chain, chain the batches, and build
    the block statement (the host run of segment-agg -> batch-agg ->
    block promotion). The initial-cap commitment runs on `device` (CUDA
    when not given)."""
    assert batch_chains, "no batches"
    pvs = []
    for chain in batch_chains:
        verify_segments(chain, kernel, config, device=device)
        pvs.append(batch_public_values(chain))
    agg = pvs[0]
    for nxt in pvs[1:]:
        check_batch_pair(agg, nxt)
        agg = combine_batch_pvs(agg, nxt)
    check_block_initial(agg)
    return BlockProof(batches=batch_chains, public_values=agg)


# ---------------------------------------------------------------------------
# Block proving (the zero prover's per-block pipeline,
# zero/src/prover.rs:97-333: batches -> segment chains -> batch agg ->
# block statement)
# ---------------------------------------------------------------------------

def prove_block_batches(kernel, gis: list, config=None,
                        max_cpu_len_log: int | None = None,
                        device=None) -> BlockProof:
    """Prove every txn batch of one block (each batch = one kernel run
    segmented by zk-continuations), one batch after another, then
    aggregate to the block statement. Segments are proven on `device`
    (CUDA when not given); within a batch, the next segment's witness is
    generated while the current one proves (pipeline.py)."""
    from ..witness.segments import generate_segment_tables
    from .block import prove_block
    from .pipeline import prove_segments_pipelined

    chains = []
    for bi, gi in enumerate(gis):
        with timed(f"batch {bi}/{len(gis)}"):
            seg_iter = generate_segment_tables(
                kernel, gi, max_cpu_len_log=max_cpu_len_log)
            chains.append(prove_segments_pipelined(
                ((seg, gt) for seg, gt in seg_iter),
                lambda gt: prove_block(gt, config, device=device)))
    with timed("aggregate block (host verifier)"):
        return aggregate_block(chains, kernel, config, device=device)
