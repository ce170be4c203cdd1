"""Block-segment proving and verification: the top-level statement.

Twin of the JAX package's `orchestration/block.py` (the reference's
prover.rs prove() + verifier.rs verify_proof() pipeline): witness-generated
tables are proven under one transcript with the PublicValues observed, and
the verifier (a) replays every table proof, (b) recomputes the memory
table's public-value write sums itself (verifier.rs:319-512), and (c)
binds the kernel identity by recomputing the initial MemBefore Merkle cap
from the kernel bytes (verifier.rs:14-79 initial_memory_merkle_cap).

Proving and the initial-cap commitment run on `device` (CUDA unless the
caller names the CPU); the rest of the verifier is host code.
"""

from __future__ import annotations

from functools import lru_cache

from ..field import GF
from ..native import keccak256
from ..stark.config import StarkConfig
from ..stark.multi import AllProof, prove_all, verify_all
from ..stark.poly_batch import PolynomialBatch
from ..stark.prover import resolve_device
from ..stark.public_values import memory_extra_looking_values
from ..tables.all_stark import (Table, CDK_NUM_TABLES, CDK_OPTIONAL_TABLES,
                                OPTIONAL_TABLES, MEMORY_CTL_IDX,
                                all_cross_table_lookups, all_starks)
from ..tables.cpu import cpu_stark_for_kernel
from ..tables.memory_continuation import (generate_trace as _mc_trace,
                                          kernel_initial_memory_values)


def prove_block(generated, config: StarkConfig | None = None,
                device=None) -> AllProof:
    """Prove a witness-generated block segment (witness/traces.py
    GeneratedTables) with its PublicValues observed in the transcript,
    on `device` (CUDA when not given)."""
    config = config or StarkConfig()
    return prove_all(generated.starks, generated.traces,
                     all_cross_table_lookups(), config,
                     public_values=generated.public_values, device=device)


@lru_cache(maxsize=4)
def _initial_memory_cap(code: bytes, rate_bits: int, cap_height: int,
                        device: str):
    trace = _mc_trace(kernel_initial_memory_values(code))
    batch = PolynomialBatch.from_values(GF.from_u64(trace, device),
                                        rate_bits=rate_bits,
                                        cap_height=cap_height)
    return batch.cap_ints()


def starks_for_kernel(kernel, flavor: str = "eth_mainnet"):
    """Verifier-side Stark instances: defaults with the CpuStark built
    from the kernel's label offsets."""
    starks = all_starks(flavor)
    starks[Table.Cpu] = cpu_stark_for_kernel(kernel, flavor)
    return starks


def verify_block(all_proof: AllProof, kernel,
                 config: StarkConfig | None = None,
                 check_initial_cap: bool = True, device=None) -> None:
    """Verify a block-segment AllProof against a known kernel
    (an assembled Kernel: .code bytes + .global_labels).

    The claimed statement is all_proof.public_values; everything else is
    recomputed: the transcript encoding must match the PV struct, the
    memory extra looking sums are derived from PV + kernel identity, and
    (for a first segment) the MemBefore trace cap must equal the
    kernel's initial memory cap, committed on `device` (CUDA when not
    given). A proof of CDK_NUM_TABLES tables is a cdk_erigon proof."""
    config = config or StarkConfig()
    flavor = "cdk_erigon" if len(all_proof.proofs) == CDK_NUM_TABLES \
        else "eth_mainnet"
    starks = starks_for_kernel(kernel, flavor)
    kernel_code = bytes(kernel.code)
    pv = all_proof.public_values
    assert pv is not None, "block proof carries no public values"
    assert all_proof.public_inputs == pv.to_elements(), \
        "public_inputs do not encode the claimed public values"

    kernel_hash = int.from_bytes(keccak256(kernel_code), "big")
    extra = memory_extra_looking_values(pv, kernel_hash, len(kernel_code))

    mem_before_proof = all_proof.proofs[Table.MemBefore]
    assert mem_before_proof is not None, "MemBefore proof missing"
    if check_initial_cap:
        expected_cap = _initial_memory_cap(
            kernel_code, config.rate_bits, config.cap_height,
            str(resolve_device(device)))
        assert _cap_ints(mem_before_proof) == \
            [list(map(int, e)) for e in expected_cap], \
            "MemBefore cap does not bind the expected kernel"

    optional = CDK_OPTIONAL_TABLES if flavor == "cdk_erigon" \
        else OPTIONAL_TABLES
    verify_all(starks, all_proof, all_cross_table_lookups(flavor), config,
               extra_looking_values={MEMORY_CTL_IDX: extra},
               optional_tables=optional)


def _cap_ints(proof) -> list:
    return [list(map(int, e)) for e in proof.trace_cap]


def verify_segments(all_proofs: list[AllProof], kernel,
                    config: StarkConfig | None = None,
                    device=None) -> None:
    """Verify a chain of segment proofs for one block batch: each proof
    verifies on its own, segment 0's MemBefore binds the kernel, every
    consecutive pair chains MemAfter cap -> MemBefore cap and
    registers_after -> registers_before, the shared public values agree,
    and the final segment halted with an empty MemAfter (the
    consistency checks the reference performs in its segment
    aggregation circuit, fixed_recursive_verifier.rs:2298-2408 +
    verifier.rs:514-547)."""
    config = config or StarkConfig()
    assert all_proofs, "no segment proofs"
    for i, ap in enumerate(all_proofs):
        verify_block(ap, kernel, config, check_initial_cap=(i == 0),
                     device=device)

    pv0 = all_proofs[0].public_values
    assert pv0.registers_before.program_counter == \
        kernel.global_labels["main"], "first segment must start at main"
    assert all_proofs[-1].public_values.registers_after.program_counter \
        == kernel.global_labels["halt"], "last segment must halt"
    assert not all_proofs[-1].table_in_use[Table.MemAfter], \
        "final segment must leave no live memory"

    for a, b in zip(all_proofs, all_proofs[1:]):
        check_segment_pair(a, b)


def check_segment_pair(a: AllProof, b: AllProof) -> None:
    """Consistency of two adjacent segment proofs: register chaining,
    identical block statement, and the MemAfter -> MemBefore Merkle cap
    chain (what the reference's segment-aggregation circuit enforces,
    fixed_recursive_verifier.rs:2298-2408)."""
    pa, pb = a.public_values, b.public_values
    assert pa is not None and pb is not None, "missing public values"
    assert pa.registers_after == pb.registers_before, \
        "register chain broken between segments"
    # the shared block statement must be identical across segments
    assert pa.trie_roots_before == pb.trie_roots_before
    assert pa.trie_roots_after == pb.trie_roots_after
    assert pa.block_metadata == pb.block_metadata
    assert pa.block_hashes == pb.block_hashes
    assert pa.extra_block_data == pb.extra_block_data
    ma = a.proofs[Table.MemAfter]
    mb = b.proofs[Table.MemBefore]
    assert ma is not None and mb is not None, \
        "intermediate segment missing MemAfter/MemBefore"
    assert _cap_ints(ma) == _cap_ints(mb), \
        "MemAfter -> MemBefore cap chain broken"
