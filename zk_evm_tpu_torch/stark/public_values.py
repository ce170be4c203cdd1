"""Public values: the statement a block-segment proof commits to.

Twin of the reference's PublicValues (zk_evm's
evm_arithmetization/src/proof.rs:70-91) with the exact Fiat-Shamir
observation encoding of get_challenges.rs:202-227 (SURVEY.md Appendix A):
trie roots before/after as 8 u32 limbs each, block metadata (beneficiary
as 5 u256 limbs, u32 scalars, u64s as two elements, 8x8 bloom limbs),
256+1 block hashes, and the extra block data. registers_before/after and
the MemBefore/MemAfter caps are NOT observed here — they bind at the
aggregation layer.
"""

from __future__ import annotations

from dataclasses import dataclass, field


def h256_limbs(h) -> list[int]:
    """32-byte hash (bytes or int) -> 8 u32 limbs, low limb first."""
    v = int.from_bytes(h, "big") if isinstance(h, (bytes, bytearray)) \
        else int(h)
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def u256_limbs(v: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _u64_pair(v: int) -> list[int]:
    assert v < (1 << 64)
    return [v & 0xFFFFFFFF, v >> 32]


def _u32(v: int) -> int:
    assert v < (1 << 32), "scalar exceeds u32 in public values"
    return v


@dataclass
class TrieRoots:
    state_root: bytes = b"\x00" * 32
    transactions_root: bytes = b"\x00" * 32
    receipts_root: bytes = b"\x00" * 32

    def to_elements(self):
        return h256_limbs(self.state_root) \
            + h256_limbs(self.transactions_root) \
            + h256_limbs(self.receipts_root)


@dataclass
class BlockMetadata:
    block_beneficiary: int = 0          # 160-bit address
    block_timestamp: int = 0
    block_number: int = 0
    block_difficulty: int = 0
    block_random: bytes = b"\x00" * 32
    block_gaslimit: int = 0
    block_chain_id: int = 1
    block_base_fee: int = 0
    block_gas_used: int = 0
    block_blob_gas_used: int = 0
    block_excess_blob_gas: int = 0
    parent_beacon_block_root: bytes = b"\x00" * 32
    block_bloom: tuple = (0,) * 8       # 8 x u256

    def to_elements(self):
        out = u256_limbs(self.block_beneficiary)[:5]
        out += [_u32(self.block_timestamp), _u32(self.block_number),
                _u32(self.block_difficulty)]
        out += h256_limbs(self.block_random)
        out += [_u32(self.block_gaslimit), _u32(self.block_chain_id)]
        out += _u64_pair(self.block_base_fee)
        out += [_u32(self.block_gas_used)]
        # eth_mainnet: blob fields + parent beacon root
        out += _u64_pair(self.block_blob_gas_used)
        out += _u64_pair(self.block_excess_blob_gas)
        out += h256_limbs(self.parent_beacon_block_root)
        for word in self.block_bloom:
            out += u256_limbs(word)
        return out


@dataclass
class BlockHashes:
    prev_hashes: tuple = (b"\x00" * 32,) * 256
    cur_hash: bytes = b"\x00" * 32

    def to_elements(self):
        out = []
        for h in self.prev_hashes:
            out += h256_limbs(h)
        out += h256_limbs(self.cur_hash)
        return out


@dataclass
class ExtraBlockData:
    checkpoint_state_trie_root: bytes = b"\x00" * 32
    checkpoint_consolidated_hash: tuple = (0, 0, 0, 0)  # 4 field elements
    txn_number_before: int = 0
    txn_number_after: int = 0
    gas_used_before: int = 0
    gas_used_after: int = 0

    def to_elements(self):
        out = h256_limbs(self.checkpoint_state_trie_root)
        out += list(self.checkpoint_consolidated_hash)
        out += [_u32(self.txn_number_before), _u32(self.txn_number_after),
                _u32(self.gas_used_before), _u32(self.gas_used_after)]
        return out


@dataclass
class RegistersData:
    """Registers at a segment boundary (bound at the aggregation layer,
    not in the segment transcript)."""
    program_counter: int = 0
    is_kernel: int = 1
    stack_len: int = 0
    stack_top: int = 0
    context: int = 0
    gas_used: int = 0

    def to_elements(self):
        return [self.program_counter, self.is_kernel, self.stack_len] \
            + u256_limbs(self.stack_top) + [self.context, self.gas_used]


@dataclass
class PublicValues:
    trie_roots_before: TrieRoots = field(default_factory=TrieRoots)
    trie_roots_after: TrieRoots = field(default_factory=TrieRoots)
    block_metadata: BlockMetadata = field(default_factory=BlockMetadata)
    block_hashes: BlockHashes = field(default_factory=BlockHashes)
    extra_block_data: ExtraBlockData = field(default_factory=ExtraBlockData)
    registers_before: RegistersData = field(default_factory=RegistersData)
    registers_after: RegistersData = field(default_factory=RegistersData)
    # cdk_erigon only: the burn address, observed as 8 u32 limbs after
    # the extra block data (get_challenges.rs:147-161 observe_burn_addr,
    # cfg(cdk_erigon)); None (eth/polygon_pos flavors) adds nothing
    burn_addr: bytes | None = None

    def to_elements(self):
        """Transcript encoding (Appendix A order); registers and memory
        caps excluded by design."""
        out = self.trie_roots_before.to_elements() \
            + self.trie_roots_after.to_elements() \
            + self.block_metadata.to_elements() \
            + self.block_hashes.to_elements() \
            + self.extra_block_data.to_elements()
        if self.burn_addr is not None:
            out += h256_limbs(self.burn_addr)
        return out

    def observe(self, challenger):
        challenger.observe_elements(self.to_elements())


# ---------------------------------------------------------------------------
# Memory extra looking values (verifier.rs:319-512)
# ---------------------------------------------------------------------------

def _h2u(h) -> int:
    return int.from_bytes(h, "big") if isinstance(h, (bytes, bytearray)) \
        else int(h)


def memory_extra_looking_values(pv: PublicValues, kernel_hash: int,
                                kernel_len: int) -> list[list[int]]:
    """The memory-table rows written before execution that no table looks
    up: block metadata, trie digests, bloom, block hashes and the
    registers before/after — each as the Memory CTL tuple
    (is_read=0, ctx=0, segment, virt, 8 value limbs, timestamp=2),
    recomputed from public values alone so the verifier can add their
    logUp contribution to the looking side (verifier.rs:319-490,
    add_data_write :492-512)."""
    from ..witness.interpreter import _gm
    md = pv.block_metadata
    ebd = pv.extra_block_data
    fields = [
        ("BLOCK_BENEFICIARY", md.block_beneficiary),
        ("BLOCK_TIMESTAMP", md.block_timestamp),
        ("BLOCK_NUMBER", md.block_number),
        ("BLOCK_DIFFICULTY", md.block_difficulty),
        ("BLOCK_RANDOM", _h2u(md.block_random)),
        ("BLOCK_GAS_LIMIT", md.block_gaslimit),
        ("BLOCK_CHAIN_ID", md.block_chain_id),
        ("BLOCK_BASE_FEE", md.block_base_fee),
        ("BLOCK_CURRENT_HASH", _h2u(pv.block_hashes.cur_hash)),
        ("BLOCK_GAS_USED", md.block_gas_used),
        ("BLOCK_BLOB_GAS_USED", md.block_blob_gas_used),
        ("BLOCK_EXCESS_BLOB_GAS", md.block_excess_blob_gas),
        ("PARENT_BEACON_BLOCK_ROOT", _h2u(md.parent_beacon_block_root)),
        ("BLOCK_GAS_USED_BEFORE", ebd.gas_used_before),
        ("BLOCK_GAS_USED_AFTER", ebd.gas_used_after),
        ("TXN_NUMBER_BEFORE", ebd.txn_number_before),
        ("TXN_NUMBER_AFTER", ebd.txn_number_after),
        ("STATE_TRIE_DIGEST_BEFORE", _h2u(pv.trie_roots_before.state_root)),
        ("TXN_TRIE_DIGEST_BEFORE",
         _h2u(pv.trie_roots_before.transactions_root)),
        ("RECEIPT_TRIE_DIGEST_BEFORE",
         _h2u(pv.trie_roots_before.receipts_root)),
        ("STATE_TRIE_DIGEST_AFTER", _h2u(pv.trie_roots_after.state_root)),
        ("TXN_TRIE_DIGEST_AFTER",
         _h2u(pv.trie_roots_after.transactions_root)),
        ("RECEIPT_TRIE_DIGEST_AFTER",
         _h2u(pv.trie_roots_after.receipts_root)),
        ("KERNEL_HASH", kernel_hash),
        ("KERNEL_LEN", kernel_len),
    ]
    from ..tables.segments import Segment

    def row(seg, virt, val):
        return [0, 0, int(seg), virt] + u256_limbs(val) + [2]

    out = [row(Segment.GlobalMetadata, _gm(name), int(val))
           for name, val in fields]
    out += [row(Segment.GlobalBlockBloom, i, md.block_bloom[i])
            for i in range(8)]
    out += [row(Segment.BlockHashes, i, _h2u(pv.block_hashes.prev_hashes[i]))
            for i in range(256)]
    for base, regs in ((0, pv.registers_before), (6, pv.registers_after)):
        vals = [regs.program_counter, regs.is_kernel, regs.stack_len,
                regs.stack_top, regs.context, regs.gas_used]
        out += [row(Segment.RegistersStates, base + i, v)
                for i, v in enumerate(vals)]
    return out


# ---------------------------------------------------------------------------
# JSON persistence (proofs ship as JSON files, zero/src/fs.rs:8-12)
# ---------------------------------------------------------------------------

def _enc(v):
    if isinstance(v, (bytes, bytearray)):
        return "0x" + bytes(v).hex()
    if isinstance(v, tuple):
        return [_enc(x) for x in v]
    return v


def _dec(v):
    if isinstance(v, str) and v.startswith("0x"):
        return bytes.fromhex(v[2:])
    if isinstance(v, list):
        return tuple(_dec(x) for x in v)
    return v


def _dataclass_dict(obj):
    import dataclasses
    return {f.name: _enc(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _dataclass_from(cls, d):
    return cls(**{k: _dec(v) for k, v in d.items()})


def public_values_to_dict(pv: PublicValues) -> dict:
    return {
        "trie_roots_before": _dataclass_dict(pv.trie_roots_before),
        "trie_roots_after": _dataclass_dict(pv.trie_roots_after),
        "block_metadata": _dataclass_dict(pv.block_metadata),
        "block_hashes": _dataclass_dict(pv.block_hashes),
        "extra_block_data": _dataclass_dict(pv.extra_block_data),
        "registers_before": _dataclass_dict(pv.registers_before),
        "registers_after": _dataclass_dict(pv.registers_after),
        "burn_addr": pv.burn_addr.hex() if pv.burn_addr is not None
        else None,
    }


def public_values_from_dict(d: dict) -> PublicValues:
    return PublicValues(
        trie_roots_before=_dataclass_from(TrieRoots,
                                          d["trie_roots_before"]),
        trie_roots_after=_dataclass_from(TrieRoots, d["trie_roots_after"]),
        block_metadata=_dataclass_from(BlockMetadata, d["block_metadata"]),
        block_hashes=_dataclass_from(BlockHashes, d["block_hashes"]),
        extra_block_data=_dataclass_from(ExtraBlockData,
                                         d["extra_block_data"]),
        registers_before=_dataclass_from(RegistersData,
                                         d["registers_before"]),
        registers_after=_dataclass_from(RegistersData,
                                        d["registers_after"]),
        burn_addr=bytes.fromhex(d["burn_addr"])
        if d.get("burn_addr") else None)
