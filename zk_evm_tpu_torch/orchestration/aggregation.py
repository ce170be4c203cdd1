"""Batch- and block-level aggregation statements.

Host twin of the reference's recursive-aggregation public-value algebra
(zk_evm's evm_arithmetization/src/fixed_recursive_verifier.rs):

- batch aggregation (`create_batch_aggregation_circuit`, :1336-1446):
  adjacent transaction batches of one block chain their trie roots and
  txn/gas counters; the combined statement spans both.
- block statement (`create_block_circuit` + `connect_block_proof`,
  :1528-1621, :1916-1963): the batch-aggregation root is promoted to a
  block claim — initial counters are zero, the txn/receipt tries start
  empty, the block's metadata gas equals the final gas counter, and the
  parent link is either a previous block proof (state root, block
  number, timestamp, 256-deep hash chain) or the checkpoint root with a
  consolidated hash of the prior 256 block hashes
  (`connect_checkpoint_block`, :1965-2003).
- block wrapper (`create_block_wrapper_circuit`, :1753-1816 +
  proof.rs:154-310): exposes `FinalPublicValues` (chain id, checkpoint
  and new state roots, checkpoint/new consolidated hashes).
- two-to-one aggregation (`create_two_to_one_block_circuit`,
  :1818-1894): unrelated wrapped block proofs mix into one digest
  H(left_pis || right_pis).

Every check here is replayed structurally over verified segment
AllProofs. Copy of the JAX package's `orchestration/aggregation.py` with
`device` passed through to the segment prover and the initial-cap
commitment; the in-tape (L2) twin of the same algebra lives in
recursion/aggregate.py.
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
# Block statement (connect_block_proof + connect_initial_values_block)
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


def check_block_parent(parent: PublicValues, child: PublicValues) -> None:
    """Parent-block link (connect_block_proof, :1916-1963): only the
    STATE trie chains between blocks; block numbers increment; the
    timestamp is monotone; the 256-hash window slides by one."""
    assert parent.trie_roots_after.state_root == \
        child.trie_roots_before.state_root, \
        "parent post-state root != child pre-state root"
    pe, ce = parent.extra_block_data, child.extra_block_data
    assert pe.checkpoint_state_trie_root == ce.checkpoint_state_trie_root
    assert pe.checkpoint_consolidated_hash == \
        ce.checkpoint_consolidated_hash
    pm, cm = parent.block_metadata, child.block_metadata
    assert pm.block_number + 1 == cm.block_number, \
        "block numbers do not increment"
    assert 0 <= cm.block_timestamp - pm.block_timestamp < (1 << 32), \
        "block timestamp must be monotone"
    # hash window: child.prev[i] == parent.prev[i+1], child.prev[255] ==
    # parent.cur (connect_block_hashes, :1896-1914)
    assert tuple(child.block_hashes.prev_hashes[:255]) == \
        tuple(parent.block_hashes.prev_hashes[1:]), \
        "block hash window does not slide"
    assert child.block_hashes.prev_hashes[255] == \
        parent.block_hashes.cur_hash, \
        "parent block hash not recorded in child window"


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
    block promotion). The parent/checkpoint link is checked separately
    (verify_block_chain), mirroring the cyclic block circuit. The
    initial-cap commitment runs on `device` (CUDA when not given)."""
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


def verify_block_chain(blocks: list[BlockProof], kernel, config=None,
                       checkpoint_state_trie_root: bytes | None = None,
                       parent: PublicValues | None = None,
                       reverify: bool = True,
                       device=None) -> list[FinalPublicValues]:
    """Verify a chain of block proofs: block 0 anchors at the
    checkpoint (or at `parent`, a previously-proven block's public
    values — the reference's --previous-proof resume,
    zero/src/fs.rs:14-30), each subsequent block links to its parent;
    returns each block's FinalPublicValues (what the block wrapper
    exposes). A re-verification commits the initial cap on `device`."""
    assert blocks, "no blocks"
    finals = []
    for i, bp in enumerate(blocks):
        if reverify:
            rebuilt = aggregate_block(bp.batches, kernel, config,
                                      device=device)
            assert rebuilt.public_values == bp.public_values, \
                "claimed block statement does not match its batches"
        if i == 0 and parent is not None:
            check_block_parent(parent, bp.public_values)
        elif i == 0:
            check_checkpoint_block(bp.public_values)
            if checkpoint_state_trie_root is not None:
                assert bp.public_values.extra_block_data \
                    .checkpoint_state_trie_root \
                    == checkpoint_state_trie_root, \
                    "chain anchored at the wrong checkpoint"
        else:
            check_block_parent(blocks[i - 1].public_values,
                               bp.public_values)
        finals.append(FinalPublicValues.from_public_values(
            bp.public_values))
    return finals


def two_to_one_mix(left: FinalPublicValues,
                   right: FinalPublicValues) -> list[int]:
    """Digest of two unrelated wrapped block statements — the mix hash
    of create_two_to_one_block_circuit (:1818-1894). Children may
    themselves be mixes (pass their 4-element digests via MixNode)."""
    return host_poseidon.hash_no_pad(
        left.to_elements() + right.to_elements())


# ---------------------------------------------------------------------------
# Block proving driver (the zero prover's per-block pipeline,
# zero/src/prover.rs:97-333: batches -> segment chains -> batch agg ->
# block statement)
# ---------------------------------------------------------------------------

def rewrite_checkpoint_consolidation(gis_per_block: list[list]) -> tuple:
    """Recompute the chain's checkpoint consolidated hash under OUR
    hasher from the first block's previous-hash window (what zero's rpc
    layer computes at fetch time with plonky2's Poseidon,
    zero/src/rpc/mod.rs:321) and stamp it into every batch's inputs.
    Returns the consolidated hash."""
    first = gis_per_block[0][0]
    cch = consolidate_hashes(list(first.block_hashes.prev_hashes))
    for gis in gis_per_block:
        for i, gi in enumerate(gis):
            gis[i] = replace(gi, checkpoint_consolidated_hash=cch)
    return cch


def prove_blocks_bounded(kernel, gis_per_block: list[list], config=None,
                         max_cpu_len_log: int | None = None,
                         block_pool_size: int = 2,
                         prove_batches=None,
                         device=None) -> list[BlockProof]:
    """Prove several blocks with at most `block_pool_size` in flight —
    the reference's PARALLEL_BLOCK_PROVING_PERMIT_POOL semaphore
    (zero/src/prover.rs:53-59): witness generation and proving of later
    blocks overlaps earlier blocks, memory stays bounded, and the final
    parent-link chain check remains strictly sequential (the cyclic
    block circuit's order). Returns the BlockProofs in block order
    (chain-checked via verify_block_chain by the caller)."""
    from concurrent.futures import ThreadPoolExecutor
    assert block_pool_size >= 1
    prove = prove_batches or (lambda gis: prove_block_batches(
        kernel, gis, config=config, max_cpu_len_log=max_cpu_len_log,
        device=device))
    with ThreadPoolExecutor(max_workers=block_pool_size) as pool:
        futures = [pool.submit(prove, gis) for gis in gis_per_block]
        return [f.result() for f in futures]


def prove_block_batches(kernel, gis: list, config=None,
                        max_cpu_len_log: int | None = None,
                        batch_pool_size: int = 1,
                        prove_chain=None,
                        device=None) -> BlockProof:
    """Prove every txn batch of one block (each batch = one kernel run
    segmented by zk-continuations), then aggregate to the block
    statement. Segments are proven on `device` (CUDA when not given);
    within a batch, the next segment's witness is generated while the
    current one proves (pipeline.py).

    `batch_pool_size` > 1 proves up to that many batches concurrently —
    the reference fans txn batches out as independent paladin jobs
    (zero/src/prover.rs:72-118). Batches are independent until
    aggregation and results are collected in batch order, so the
    BlockProof is identical to the sequential one. As in the JAX
    package, a batch proved in a worker thread records no timing scopes
    (the ambient tree is the caller thread's), and a failing batch does
    not cancel the batches already running."""
    from ..witness.segments import generate_segment_tables
    from .block import prove_block
    from .pipeline import prove_segments_pipelined

    def one_batch(bi_gi):
        bi, gi = bi_gi
        with timed(f"batch {bi}/{len(gis)}"):
            seg_iter = generate_segment_tables(
                kernel, gi, max_cpu_len_log=max_cpu_len_log)
            return prove_segments_pipelined(
                ((seg, gt) for seg, gt in seg_iter),
                lambda gt: prove_block(gt, config, device=device))

    chains = prove_batch_chains(gis, prove_chain or one_batch,
                                batch_pool_size)
    with timed("aggregate block (host verifier)"):
        return aggregate_block(chains, kernel, config, device=device)


def prove_batch_chains(gis: list, prove, batch_pool_size: int) -> list:
    """Fan the per-batch prove over a bounded thread pool; results in
    batch order regardless of completion order."""
    assert batch_pool_size >= 1
    items = list(enumerate(gis))
    if batch_pool_size == 1 or len(items) <= 1:
        return [prove(it) for it in items]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=batch_pool_size) as pool:
        futures = [pool.submit(prove, it) for it in items]
        return [f.result() for f in futures]
