"""A real mainnet batch wrapped at the production config in the PyTorch
port against the JAX package: `b1033_batch0.zkproof.gz`, the JAX
package's standard-config proof of mainnet block 1033, txns 0-2 (two
segment AllProofs, the nine eth_mainnet tables at 84 FRI queries and
16-bit proof of work), verified in one `wrap_segment_chain` tape.
Tolerance 0.

Tier-1 reads the file with both packages' loaders and holds the chain's
boundary facts and the refusals of tampered children, which come within
the first table's verification (tens of thousands of ops). Building the
whole tape (22,343,757 ops, the kernel's memory cap committed with the
plain Poseidon) takes minutes on one CPU thread, so it is `slow`:

    python -m pytest tests/test_torch_b1033_wrap.py -m slow

It builds the tape with both packages and holds their public inputs,
op counts, chunks' boundary maps and chunk traces' sha256 to each other
and to chip_smoke.py's B1033_WRAP_TAPE_SHA256."""

import gzip
import json
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from zk_evm_tpu.recursion import aggregate as jagg
from zk_evm_tpu.recursion import continuation as jct
from zk_evm_tpu.recursion import vm as jvm
from zk_evm_tpu.stark import StarkConfig as JStarkConfig
from zk_evm_tpu.stark.serialization import (
    all_proof_from_json as jall_proof_from_json,
    proof_to_json as jproof_to_json)
from zk_evm_tpu.witness.assembler import combined_kernel as jkernel
from zk_evm_tpu_torch.hash import host_poseidon
from zk_evm_tpu_torch.recursion import aggregate as agg
from zk_evm_tpu_torch.recursion import continuation as ct
from zk_evm_tpu_torch.recursion import vm
from zk_evm_tpu_torch.recursion.tape_lib import sponge_hash
from zk_evm_tpu_torch.stark import StarkConfig
from zk_evm_tpu_torch.stark.serialization import (all_proof_from_dict,
                                                  proof_to_json)
from zk_evm_tpu_torch.tables.all_stark import Table
from zk_evm_tpu_torch.witness.kernel import combined_kernel
from test_rvm import sample_tape as jsample_tape
from test_torch_recursion import _sample_tape
import chip_smoke

B1033 = Path(__file__).resolve().parents[1] / "b1033_batch0.zkproof.gz"
# log2 rows of segment 0's tables, in Table order (Arithmetic, BytePacking,
# Cpu, Keccak, KeccakSponge, Logic, Memory, MemBefore, MemAfter)
SEGMENT0_DEGREE_BITS = [16, 11, 17, 12, 8, 11, 19, 17, 17]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread builds these tapes about as fast as many and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def segments():
    """b1033's segment proofs as each package loads them (`verify`'s
    loaders): (the port's, the JAX package's)."""
    with gzip.open(B1033) as f:
        dicts = json.loads(f.read())
    return ([all_proof_from_dict(d) for d in dicts],
            [jall_proof_from_json(json.dumps(d)) for d in dicts])


def test_b1033_segments_chain(segments):
    """Both loaders read the same two proofs; segment 0 uses all nine
    tables and segment 1 ends with no MemAfter; each segment's public
    inputs encode its public values; the registers after segment 0 are
    those before segment 1; the shared statement is block 1033's."""
    proofs, jproofs = segments
    assert len(proofs) == len(jproofs) == 2
    for ap, jap in zip(proofs, jproofs):
        assert proof_to_json(ap) == jproof_to_json(jap)
        assert list(ap.public_inputs) == ap.public_values.to_elements() \
            == jap.public_values.to_elements()
    assert all(proofs[0].table_in_use)
    assert [p.degree_bits for p in proofs[0].proofs] == SEGMENT0_DEGREE_BITS
    assert [i for i, used in enumerate(proofs[1].table_in_use)
            if not used] == [Table.MemAfter]
    pv0, pv1 = (ap.public_values for ap in proofs)
    assert pv0.registers_after == pv1.registers_before
    assert pv0.block_metadata == pv1.block_metadata
    assert pv0.block_metadata.block_number == chip_smoke.B1033_BLOCK


def _pv_only(ap):
    """block_gas_used + 1 in the public values, the public inputs left as
    they were."""
    pv = ap.public_values
    return replace(ap, public_values=replace(pv, block_metadata=replace(
        pv.block_metadata,
        block_gas_used=pv.block_metadata.block_gas_used + 1)))


def _refusal(module, tape, proofs, kernel, config, **kw):
    try:
        module.wrap_segment_chain(tape, proofs, kernel, config, **kw)
    except AssertionError as e:
        return str(e), len(tape.rows)
    return None


@pytest.mark.parametrize("tamper, reason", [
    (_pv_only, "public_inputs do not encode the claimed public values"),
    (chip_smoke.tampered_child, "tape assert_eq failed"),
    (chip_smoke.tampered_pow, "exceeds 48 bits"),
], ids=["public values only", "block_gas_used + 1", "pow_witness + 1"])
def test_tampered_child_refused_while_the_tape_is_built(segments, tamper,
                                                        reason):
    """A child whose public values no longer match its public inputs is
    refused before the tape has an op; one whose public inputs are
    re-encoded with block_gas_used + 1 fails segment 0's first table in
    the tape (the transcript moved, so the quotient check at zeta fails);
    one with its first table's pow_witness + 1 fails the in-tape
    proof-of-work check. Both packages refuse alike, after the same
    number of ops, with the same message."""
    proofs, jproofs = segments
    got = _refusal(agg, vm.Tape(npub=4), [tamper(proofs[0])] + proofs[1:],
                   combined_kernel(), StarkConfig.standard_fast_config(),
                   device="cpu")
    jgot = _refusal(jagg, jvm.Tape(npub=4),
                    [tamper(jproofs[0])] + jproofs[1:], jkernel(),
                    JStarkConfig.standard_fast_config())
    assert got is not None and got == jgot
    assert reason in got[0]
    assert got[1] < 100_000


def test_native_split_of_a_jax_tape_is_the_jax_split():
    """The slow test splits the JAX package's tape one chunk at a time
    with the port's NativeTape split (the JAX package's `split_tape`
    would hold all 22 chunks, about 22 GB): over a JAX NativeTape it
    gives the JAX split's chunks, and `chunks_sha256` hashes them as the
    port's own tape's."""
    jt = jsample_tape()
    assert isinstance(jt, jvm.NativeTape)
    jchunks = jct.split_tape(jt, 4)
    chunks = list(ct._split_tape_native(jt, 4))
    assert len(chunks) == len(jchunks) >= 2
    for c, jc in zip(chunks, jchunks):
        assert (c.index, c.clk_base, c.before, c.after) == \
            (jc.index, jc.clk_base, jc.before, jc.after)
        assert (c.rvm_trace == jc.rvm_trace).all()
        assert (c.ram_trace == jc.ram_trace).all()
        assert [o.input for o in c.pose_ops] == \
            [o.input for o in jc.pose_ops]
    own = ct.split_tape(_sample_tape(vm.Tape), 4)
    assert chip_smoke.chunks_sha256(chunks) == \
        chip_smoke.chunks_sha256(jchunks) == chip_smoke.chunks_sha256(own)


def _wrap_tape(module, tape, proofs, kernel, config, **kw):
    cells, _, _ = module.wrap_segment_chain(tape, proofs, kernel, config,
                                            **kw)
    for k, c in enumerate(sponge_hash(tape, cells)):
        tape.bind_public(c, k)
    return tape


@pytest.mark.slow
def test_b1033_wrap_tape_equals_jax(segments):
    """Both packages build the wrap of b1033's two segments at the
    standard config from the same file (segment 0's MemBefore cap held
    in the tape to the kernel's initial memory cap, committed on the CPU
    with the plain Poseidon): equal public inputs, the host `hash_no_pad`
    of segment 0's; equal op counts, B1033_WRAP_OPS; the same
    B1033_WRAP_CHUNKS chunks of 2^WRAP_CHUNK_LOG ops, with equal boundary
    maps chained one to the next; and every chunk's Rvm and RAM traces
    hashing to chip_smoke.py's B1033_WRAP_TAPE_SHA256 (both tapes split
    one chunk at a time by the port's NativeTape split, which the test
    above holds to the JAX package's `split_tape`)."""
    proofs, jproofs = segments
    t = _wrap_tape(agg, vm.Tape(npub=4), proofs, combined_kernel(),
                   StarkConfig.standard_fast_config(), device="cpu")
    jt = _wrap_tape(jagg, jvm.Tape(npub=4), jproofs, jkernel(),
                    JStarkConfig.standard_fast_config())
    assert t.public_inputs == jt.public_inputs == host_poseidon.hash_no_pad(
        [int(v) for v in proofs[0].public_inputs])
    assert len(t.rows) == len(jt.rows) == chip_smoke.B1033_WRAP_OPS
    digests = [chip_smoke.chunks_sha256(
        ct._split_tape_native(x, chip_smoke.WRAP_CHUNK_LOG))
        for x in (t, jt)]
    (digest, maps), (jdigest, jmaps) = digests
    assert maps == jmaps and len(maps) == chip_smoke.B1033_WRAP_CHUNKS
    chip_smoke.check_chunk_maps(maps)
    assert digest == jdigest == chip_smoke.B1033_WRAP_TAPE_SHA256
