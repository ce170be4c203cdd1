"""The recursion ladder's top rungs in the PyTorch port against the JAX
package: two wrap proofs aggregated two-to-one (`two_to_one_tape`), a
block statement wrapped (`block_statement_from_batch_pubs`,
`bind_block_publics`) and checked in constant size
(`verify_block_wrap_chain`), and add11's whole block wrapped
(`wrap_block`). Tolerance 0.

The children are tests/test_verify_tape.py's: 16-row Fibonacci proofs at
CHILD_KW, wrapped at OUTER_KW, `(a, b) = (1, 2)` and `(5, 11)`. Each wrap
takes about 20 s to prove on one CPU core with the plain Poseidon, and
the two-to-one tape's proof (Rvm 2^17 rows, RvmMem 2^19) many minutes,
so tier-1 reads the two wrap
proofs from tests/data/fib_wraps.json.gz (the port's `proof_to_json`,
pinned by sha256; the first is test_torch_recursion.py's FIB_WRAP_SHA256,
which tier-1 proves there) and holds the tapes it builds from them to
pinned sha256 constants. The `slow` tests prove what tier-1 pins, with
the port and with the JAX package:

    python -m pytest tests/test_torch_block_wrap.py -m slow

The block statements are synthetic: batch public values made from a
seeded generator, shaped as a chain-initial block A anchored at its
checkpoint (two batches) and its child B (one batch)."""

import gzip
import hashlib
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from zk_evm_tpu.recursion import aggregate as jagg
from zk_evm_tpu.recursion import vm as jvm
from zk_evm_tpu.stark.public_values import (
    public_values_from_dict as jpublic_values_from_dict)
from zk_evm_tpu_torch.challenger import Challenger
from zk_evm_tpu_torch.hash import host_poseidon
from zk_evm_tpu_torch.mpt.trie import EMPTY_TRIE_HASH
from zk_evm_tpu_torch.orchestration.aggregation import (
    FinalPublicValues, check_block_initial, check_checkpoint_block,
    combine_batch_pvs, consolidate_hashes)
from zk_evm_tpu_torch.recursion import aggregate as agg
from zk_evm_tpu_torch.recursion import ram, vm
from zk_evm_tpu_torch.recursion.system import prove_system, verify_system
from zk_evm_tpu_torch.recursion.verify_tape import verify_stark_tape
from zk_evm_tpu_torch.stark import prove_stark
from zk_evm_tpu_torch.stark import public_values as pvm
from zk_evm_tpu_torch.stark.serialization import (all_proof_from_json,
                                                  proof_to_json)
from zk_evm_tpu_torch.tables import poseidon as ps
from test_stark import fib_trace
from test_torch_recursion import (CHILD_KW, FIB_WRAP_SHA256, OUTER_KW,
                                  _cfg, _jcfg)
from test_torch_stark import FibStark
import chip_smoke

FIB_WRAPS = Path(__file__).parent / "data" / "fib_wraps.json.gz"
FIB_PAIRS = ((1, 2), (5, 11))
# sha256 of each wrap's proof_to_json, the port's and the JAX package's
FIB_WRAP_SHA256S = (
    FIB_WRAP_SHA256,
    "0453be5de465daea0234aa564b4c5c2f89ea3b4c4cfb6d4ca87b15cb6ce6ad10")
# sha256 over the Rvm trace's then the RAM trace's bytes of the
# two-to-one tape of the two wraps (chip_smoke.tape_sha256)
TWO_TO_ONE_TAPE_SHA256 = (
    "605df770586b3a59a4c855cc797328ef0f978473863af17eab3e8c6ebef5f966")
# sha256 of proof_to_json(prove_system(...)) of that tape at OUTER_KW
TWO_TO_ONE_PROOF_SHA256 = (
    "1aa646e8f5e15d0578e1f41d6e2fc3fc64e3201728f40dd583e9792d4f54a3db")
# sha256 of proof_to_json(prove_system(...)) of block A's wrap at OUTER_KW
BLOCK_A_WRAP_SHA256 = (
    "c41787c3846c2396f7173db03752a3d31d46756a4465acfa134156bfa833b07f")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread proves these small proofs about as fast as
    many and leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bind(t, cells):
    for k, c in enumerate(cells):
        t.bind_public(c, k)
    return t


def _fib_wrap_tape(a: int, b: int, tape_cls=vm.Tape):
    """The wrap tape of the (a, b) Fibonacci child, proved by the port on
    the CPU at CHILD_KW."""
    ccfg = _cfg(CHILD_KW)
    trace, pis = fib_trace(16, a=a, b=b)
    child = prove_stark(FibStark(), trace, ccfg, Challenger(),
                        public_inputs=pis, device="cpu")
    t = tape_cls(npub=3)
    return _bind(t, verify_stark_tape(t, FibStark(), child,
                                      ccfg).public_inputs)


def _system_starks(tape):
    return [tape.finalize()[0], ram.RvmMemStark(), ps.PoseidonStark()]


@pytest.fixture(scope="module")
def fib_wraps():
    """[(starks, AllProof, json text)] of the two pinned wraps; the Rvm
    stark (its program) comes from the port's own wrap tape."""
    with gzip.open(FIB_WRAPS) as f:
        texts = json.loads(f.read())
    return [(_system_starks(_fib_wrap_tape(a, b)),
             all_proof_from_json(text), text)
            for (a, b), text in zip(FIB_PAIRS, texts)]


def _two_to_one(wraps, cfg, tape_cls=vm.Tape, module=agg, **kw):
    t = tape_cls(npub=4)
    _bind(t, module.two_to_one_tape(t, wraps[0][:2], wraps[1][:2], cfg,
                                    **kw))
    return t


def _want_digest(wraps):
    return host_poseidon.hash_no_pad(
        [int(v) for w in wraps for v in w[1].public_inputs])


# ---- two-to-one of two Fibonacci wraps (tests/test_verify_tape.py:315) ----

def test_fib_wraps_are_pinned(fib_wraps):
    for (a, b), (_, proof, text), want in zip(FIB_PAIRS, fib_wraps,
                                              FIB_WRAP_SHA256S):
        assert hashlib.sha256(text.encode()).hexdigest() == want
        assert proof_to_json(proof) == text
        assert list(proof.public_inputs) == fib_trace(16, a=a, b=b)[1]


def test_two_to_one_tape_is_pinned(fib_wraps):
    t = _two_to_one(fib_wraps, _cfg(OUTER_KW), device="cpu")
    assert t.public_inputs == _want_digest(fib_wraps)
    _, rvm_trace, ram_trace, pose_ops, pub = t.finalize()
    assert pub == t.public_inputs
    assert (rvm_trace.shape[1], ram_trace.shape[1], len(pose_ops)) == \
        (1 << 17, 1 << 19, 1309)
    assert chip_smoke.tape_sha256(rvm_trace, ram_trace) == \
        TWO_TO_ONE_TAPE_SHA256


@pytest.mark.parametrize("side", [0, 1], ids=["left", "right"])
def test_two_to_one_tape_rejects_a_changed_child_opening(fib_wraps, side):
    wraps = [w[:2] for w in fib_wraps]
    wraps[side] = (wraps[side][0], chip_smoke.tampered_opening(wraps[side][1]))
    with pytest.raises(AssertionError):
        _two_to_one(wraps, _cfg(OUTER_KW), device="cpu")


@pytest.mark.slow
def test_two_to_one_proof_is_pinned_and_verifies(fib_wraps):
    """The two-to-one tape proved by the port on the CPU at OUTER_KW
    (many minutes): its proof is the JAX package's (pinned), its public
    inputs the digest of both wraps' publics; verify_system accepts it
    and rejects it with one FRI opening changed."""
    cfg = _cfg(OUTER_KW)
    t = _two_to_one(fib_wraps, cfg, device="cpu")
    starks, proof, pub = prove_system(t, cfg, device="cpu")
    want = _want_digest(fib_wraps)
    assert pub == want
    assert hashlib.sha256(proof_to_json(proof).encode()).hexdigest() == \
        TWO_TO_ONE_PROOF_SHA256
    verify_system(starks, proof, cfg, expected_public_inputs=want,
                  device="cpu")
    with pytest.raises(AssertionError, match="Merkle"):
        verify_system(starks, chip_smoke.tampered_opening(proof), cfg, device="cpu")


@pytest.mark.slow
def test_two_to_one_constants_are_jax():
    """The JAX package proves both Fibonacci wraps (their proofs are the
    pinned file's, byte for byte), builds the two-to-one tape from them
    (TWO_TO_ONE_TAPE_SHA256) and proves it (TWO_TO_ONE_PROOF_SHA256)."""
    from zk_evm_tpu.challenger import Challenger as JChallenger
    from zk_evm_tpu.recursion.system import prove_system as jprove_system
    from zk_evm_tpu.recursion.verify_tape import (
        verify_stark_tape as jverify_stark_tape)
    from zk_evm_tpu.stark import prove_stark as jprove_stark
    from zk_evm_tpu.stark.serialization import proof_to_json as jpj
    from test_stark import FibStark as JFibStark
    jccfg, jocfg = _jcfg(CHILD_KW), _jcfg(OUTER_KW)
    with gzip.open(FIB_WRAPS) as f:
        texts = json.loads(f.read())
    wraps = []
    for (a, b), text in zip(FIB_PAIRS, texts):
        trace, pis = fib_trace(16, a=a, b=b)
        child = jprove_stark(JFibStark(), trace, jccfg, JChallenger(),
                             public_inputs=pis)
        t = jvm.Tape(npub=3)
        _bind(t, jverify_stark_tape(t, JFibStark(), child,
                                    jccfg).public_inputs)
        starks, proof, _ = jprove_system(t, jocfg)
        assert jpj(proof) == text
        wraps.append((starks, proof))
    t = _two_to_one(wraps, jocfg, tape_cls=jvm.Tape, module=jagg)
    assert chip_smoke.tape_sha256(*t.finalize()[1:3]) == \
        TWO_TO_ONE_TAPE_SHA256
    _, proof, _ = jprove_system(t, jocfg)
    assert hashlib.sha256(jpj(proof).encode()).hexdigest() == \
        TWO_TO_ONE_PROOF_SHA256


# ---- a synthetic block wrap and verify_block_wrap_chain -------------------

def _h256(rng) -> bytes:
    return bytes(rng.integers(0, 256, size=32, dtype=np.uint8))


def _u(rng, bits: int) -> int:
    return int.from_bytes(_h256(rng)[:bits // 8], "big")


def _regs(rng):
    return pvm.RegistersData(
        program_counter=_u(rng, 24), is_kernel=1, stack_len=_u(rng, 8),
        stack_top=_u(rng, 256), context=_u(rng, 16), gas_used=_u(rng, 32))


def _roots(rng):
    return pvm.TrieRoots(_h256(rng), _h256(rng), _h256(rng))


def block_a_batches() -> list:
    """Two batch PublicValues of a chain-initial block anchored at its
    checkpoint: empty txn and receipt tries before, no txns or gas
    before, the batches chained, the block's gas the last batch's."""
    rng = np.random.default_rng(12)
    prev = tuple(_h256(rng) for _ in range(256))
    checkpoint = _h256(rng)
    md = pvm.BlockMetadata(
        block_beneficiary=_u(rng, 160), block_timestamp=1_700_000_000,
        block_number=1000, block_difficulty=_u(rng, 32),
        block_random=_h256(rng), block_gaslimit=_u(rng, 32),
        block_chain_id=_u(rng, 32), block_base_fee=_u(rng, 64),
        block_gas_used=2000, block_blob_gas_used=_u(rng, 64),
        block_excess_blob_gas=_u(rng, 64),
        parent_beacon_block_root=_h256(rng),
        block_bloom=tuple(_u(rng, 256) for _ in range(8)))
    mid = _roots(rng)
    a = pvm.PublicValues(
        trie_roots_before=pvm.TrieRoots(checkpoint, EMPTY_TRIE_HASH,
                                        EMPTY_TRIE_HASH),
        trie_roots_after=mid, block_metadata=md,
        block_hashes=pvm.BlockHashes(prev_hashes=prev,
                                     cur_hash=_h256(rng)),
        extra_block_data=pvm.ExtraBlockData(
            checkpoint_state_trie_root=checkpoint,
            checkpoint_consolidated_hash=consolidate_hashes(list(prev)),
            txn_number_before=0, txn_number_after=3, gas_used_before=0,
            gas_used_after=1500),
        registers_before=_regs(rng), registers_after=_regs(rng))
    b = replace(a, trie_roots_before=mid, trie_roots_after=_roots(rng),
                extra_block_data=replace(
                    a.extra_block_data, txn_number_before=3,
                    txn_number_after=5, gas_used_before=1500,
                    gas_used_after=2000),
                registers_before=_regs(rng), registers_after=_regs(rng))
    return [a, b]


def block_b_batches(parent: list, number: int = 1, pre_state=None,
                    window=None) -> list:
    """The one batch of the child of the block whose batches are
    `parent`: its pre-state root the parent's post-state root (or
    `pre_state`), its number the parent's + `number`, its hash window
    the parent's slid by one (or `window`)."""
    rng = np.random.default_rng(13)
    last = parent[-1]
    pmd = last.block_metadata
    hashes = last.block_hashes
    md = replace(pmd, block_number=pmd.block_number + number,
                 block_timestamp=pmd.block_timestamp + 12,
                 block_gas_used=0)
    prev = window or (hashes.prev_hashes[1:] + (hashes.cur_hash,))
    return [replace(
        last,
        trie_roots_before=pvm.TrieRoots(
            pre_state or last.trie_roots_after.state_root,
            EMPTY_TRIE_HASH, EMPTY_TRIE_HASH),
        trie_roots_after=pvm.TrieRoots(_h256(rng), EMPTY_TRIE_HASH,
                                       EMPTY_TRIE_HASH),
        block_metadata=md,
        block_hashes=pvm.BlockHashes(prev_hashes=tuple(prev),
                                     cur_hash=_h256(rng)),
        extra_block_data=replace(
            last.extra_block_data, txn_number_before=0,
            txn_number_after=0, gas_used_before=0, gas_used_after=0),
        registers_before=_regs(rng), registers_after=_regs(rng))]


def _block_tape(batches, tape_cls=vm.Tape, module=agg):
    t = tape_cls(npub=agg.NPUB_BLOCK)
    pubs = [[t.load(int(v)) for v in pv.to_elements()] for pv in batches]
    module.bind_block_publics(
        t, module.block_statement_from_batch_pubs(t, pubs))
    return t


def _jax_pv(pv):
    return jpublic_values_from_dict(pvm.public_values_to_dict(pv))


def _combined(batches):
    combined = batches[0]
    for nxt in batches[1:]:
        combined = combine_batch_pvs(combined, nxt)
    check_block_initial(combined)
    return combined


def _host_statement(batches) -> list:
    """The block wrap's 39 public inputs from the host twins: the
    FinalPublicValues, whose checkpoint root is the statement's checkpoint
    root (the host FinalPublicValues names the pre-state root there, which
    is the same on a checkpoint block: see
    test_host_final_public_values_name_the_pre_state_root), then the block
    number, timestamp, pre-state root and the window's consolidation."""
    combined = _combined(batches)
    md = combined.block_metadata
    final = FinalPublicValues.from_public_values(combined)
    final = replace(final, checkpoint_state_trie_root=combined
                    .extra_block_data.checkpoint_state_trie_root)
    return final.to_elements() \
        + [md.block_number, md.block_timestamp] \
        + pvm.h256_limbs(combined.trie_roots_before.state_root) \
        + list(consolidate_hashes(list(combined.block_hashes.prev_hashes)))


@pytest.mark.parametrize("block", ["A", "B"])
def test_block_statement_tape_equals_jax(block):
    """The block tape built by both packages from the same batch public
    values: program, Rvm and RAM traces, Poseidon inputs and public
    inputs equal; the public inputs are the host twins' statement, and
    A passes the checkpoint anchor."""
    a = block_a_batches()
    batches = a if block == "A" else block_b_batches(a)
    t = _block_tape(batches)
    assert isinstance(t, vm.NativeTape)
    jt = _block_tape([_jax_pv(pv) for pv in batches], jvm.PyTape, jagg)
    got, want = t.finalize(), jt.finalize()
    assert np.array_equal(got[0].known, want[0].known)
    for g, w in zip(got[1:3], want[1:3]):
        assert g.shape == w.shape and np.array_equal(g, w)
    assert [tuple(int(v) for v in o.input) for o in got[3]] == \
        [tuple(int(v) for v in o.input) for o in want[3]]
    assert t.public_inputs == jt.public_inputs == _host_statement(batches)
    if block == "A":
        check_checkpoint_block(_combined(a))
        assert t.public_inputs[:25] == FinalPublicValues.from_public_values(
            _combined(a)).to_elements()
        agg.check_wrap_checkpoint_anchor(t.public_inputs)
    else:
        agg.check_wrap_parent_link(_block_tape(a).public_inputs,
                                   t.public_inputs)


def test_host_final_public_values_name_the_pre_state_root():
    """A finding about the reference, copied so that the packages stay
    equal: the host FinalPublicValues (orchestration/aggregation.py
    `from_public_values`, in both packages) takes its checkpoint root from
    the pre-state root, while the block wrap's statement (the tape, in
    both packages) and the statement a chain is anchored by
    (`check_checkpoint_block`, `verify_block_chain`) take the checkpoint
    root the public values carry. The two agree on a checkpoint block
    (A) and differ on its child (B)."""
    from zk_evm_tpu.orchestration.aggregation import (
        FinalPublicValues as JFinalPublicValues)
    a = block_a_batches()
    for batches, same in ((a, True), (block_b_batches(a), False)):
        combined = _combined(batches)
        ebd_root = combined.extra_block_data.checkpoint_state_trie_root
        pre = combined.trie_roots_before.state_root
        host = FinalPublicValues.from_public_values(combined)
        jhost = JFinalPublicValues.from_public_values(_jax_pv(combined))
        assert host.to_elements() == jhost.to_elements()
        assert host.checkpoint_state_trie_root == pre
        assert (pre == ebd_root) is same
        cells = _block_tape(batches).public_inputs
        assert cells[agg.BP_CHECKPOINT_ROOT:agg.BP_CHECKPOINT_ROOT + 8] == \
            pvm.h256_limbs(ebd_root)


@pytest.mark.parametrize("broken", ["state", "txns", "gas", "block_gas"])
def test_block_statement_tape_refuses_broken_batches(broken):
    """A second batch that does not continue the first (its pre-state
    root, txn or gas counters), or a block whose gas is not its last
    batch's: both packages' tapes fail while they are built."""
    a, b = block_a_batches()
    ebd = b.extra_block_data
    if broken == "state":
        b = replace(b, trie_roots_before=replace(
            b.trie_roots_before, state_root=bytes(32)))
    elif broken == "txns":
        b = replace(b, extra_block_data=replace(
            ebd, txn_number_before=ebd.txn_number_before + 1))
    elif broken == "gas":
        b = replace(b, extra_block_data=replace(
            ebd, gas_used_before=ebd.gas_used_before + 1))
    else:
        md = replace(a.block_metadata, block_gas_used=1999)
        a, b = replace(a, block_metadata=md), replace(b, block_metadata=md)
    with pytest.raises(AssertionError):
        _block_tape([a, b])
    with pytest.raises(AssertionError):
        _block_tape([_jax_pv(a), _jax_pv(b)], jvm.PyTape, jagg)


def test_a_fib_wrap_is_not_a_block_wrap(fib_wraps):
    starks, proof, _ = fib_wraps[0]
    with pytest.raises(AssertionError, match="not a block wrap"):
        agg.verify_block_wrap_chain([(starks, proof)], _cfg(OUTER_KW),
                                    device="cpu")


def _reason(fn) -> str | None:
    """The AssertionError message of fn(), or None if it returned."""
    try:
        fn()
    except AssertionError as e:
        return str(e)
    return None


@pytest.mark.slow
def test_block_wrap_chain_equals_jax():
    """Block A's wrap and its child B's, each proved by the port on the
    CPU at OUTER_KW (A's proof pinned, and the JAX package's proof of the
    same tape equal to it), then `verify_block_wrap_chain` of both
    packages on the same proofs, accept and reject alike, with equal
    messages: A anchored at its checkpoint root; A against a wrong root;
    the chain A -> B; B with its block number, its pre-state root or its
    hash window changed (each a proof of its own)."""
    from zk_evm_tpu.recursion.system import prove_system as jprove_system
    from zk_evm_tpu.stark.serialization import (
        all_proof_from_json as jall_proof_from_json,
        proof_to_json as jpj)
    cfg, jcfg = _cfg(OUTER_KW), _jcfg(OUTER_KW)
    a = block_a_batches()
    rng = np.random.default_rng(14)
    blocks = {
        "A": a, "B": block_b_batches(a),
        "B number": block_b_batches(a, number=2),
        "B pre-state": block_b_batches(a, pre_state=_h256(rng)),
        "B window": block_b_batches(
            a, window=tuple(_h256(rng) for _ in range(256)))}
    wraps, jwraps = {}, {}
    for name, batches in blocks.items():
        t = _block_tape(batches)
        starks, proof, pub = prove_system(t, cfg, device="cpu")
        assert pub == _host_statement(batches)
        wraps[name] = (starks, proof)
        jt = _block_tape([_jax_pv(pv) for pv in batches], jvm.PyTape, jagg)
        jwraps[name] = (_system_starks_jax(jt),
                        jall_proof_from_json(proof_to_json(proof)))
    text = proof_to_json(wraps["A"][1])
    assert hashlib.sha256(text.encode()).hexdigest() == BLOCK_A_WRAP_SHA256
    _, jproof, _ = jprove_system(
        _block_tape([_jax_pv(pv) for pv in a], jvm.PyTape, jagg), jcfg)
    assert jpj(jproof) == text

    root = a[0].extra_block_data.checkpoint_state_trie_root
    cases = {
        "A anchored": (["A"], dict(checkpoint_state_trie_root=root)),
        "A wrong root": (["A"],
                         dict(checkpoint_state_trie_root=bytes(32))),
        "A -> B": (["A", "B"], {}),
        "A -> B number": (["A", "B number"], {}),
        "A -> B pre-state": (["A", "B pre-state"], {}),
        "A -> B window": (["A", "B window"], {}),
    }
    want = {"A anchored": None,
            "A wrong root": "chain anchored at the wrong checkpoint",
            "A -> B": None,
            "A -> B number": "block numbers do not increment",
            "A -> B pre-state":
                "parent post-state root != child pre-state root",
            "A -> B window": "block hash window does not slide"}
    for case, (names, kw) in cases.items():
        got = _reason(lambda: agg.verify_block_wrap_chain(
            [wraps[n] for n in names], cfg, device="cpu", **kw))
        jgot = _reason(lambda: jagg.verify_block_wrap_chain(
            [jwraps[n] for n in names], jcfg, **kw))
        assert got == jgot == want[case], case


def _system_starks_jax(tape):
    from zk_evm_tpu.recursion import ram as jram
    from zk_evm_tpu.tables import poseidon as jps
    return [tape.finalize()[0], jram.RvmMemStark(), jps.PoseidonStark()]


# ---- add11's block wrapped (chip_smoke.py's block-wrap tape) --------------

@pytest.mark.slow
def test_add11_block_wrap_tape_equals_jax():
    """add11's block (block A of build_witness_chain("add11")) decoded and
    its batches proved by the port on the CPU at the test config with
    chip_smoke.py's segments (max_cpu_len_log 15: two segments, then
    one), then wrapped by both packages' `wrap_block` from the same
    proofs (the JAX package reads the port's JSON): the tapes' public
    inputs equal aggregate_block's statement and their Rvm and RAM traces
    hash to chip_smoke.py's BLOCK_WRAP_TAPE_SHA256."""
    from zk_evm_tpu.stark import StarkConfig as JStarkConfig
    from zk_evm_tpu.stark.serialization import (
        block_proof_from_json as jblock_proof_from_json)
    from zk_evm_tpu.witness.assembler import combined_kernel as jkernel
    from zk_evm_tpu_torch.decoder import (entrypoint,
                                          parse_block_prover_input)
    from zk_evm_tpu_torch.orchestration.aggregation import (
        prove_block_batches, rewrite_checkpoint_consolidation)
    from zk_evm_tpu_torch.stark import StarkConfig
    from zk_evm_tpu_torch.stark.serialization import block_proof_to_json
    from zk_evm_tpu_torch.witness.kernel import combined_kernel
    from zk_evm_tpu_torch.witness.testing_fixtures import (
        build_witness_chain)
    witnesses, _ = build_witness_chain(chip_smoke.WITNESS_FIXTURE)
    gis = entrypoint(parse_block_prover_input(witnesses[0]))
    rewrite_checkpoint_consolidation([gis])
    kernel = combined_kernel()
    cfg = StarkConfig.test_config()
    bp = prove_block_batches(
        kernel, gis, config=cfg,
        max_cpu_len_log=chip_smoke.BLOCK_WRAP_SEGMENT_LOG, device="cpu")
    assert [len(c) for c in bp.batches] == chip_smoke.BLOCK_WRAP_SEGMENTS
    check_checkpoint_block(bp.public_values)
    jbp = jblock_proof_from_json(block_proof_to_json(bp))

    t = vm.Tape(npub=agg.NPUB_BLOCK)
    agg.bind_block_publics(t, agg.wrap_block(t, bp.batches, kernel, cfg,
                                             device="cpu"))
    jt = jvm.Tape(npub=agg.NPUB_BLOCK)
    jagg.bind_block_publics(jt, jagg.wrap_block(
        jt, jbp.batches, jkernel(), JStarkConfig.test_config()))
    assert t.public_inputs == jt.public_inputs == \
        _host_statement([bp.public_values])
    digests = [chip_smoke.tape_sha256(*x.finalize()[1:3]) for x in (t, jt)]
    assert digests == [chip_smoke.BLOCK_WRAP_TAPE_SHA256] * 2
