"""Kernel bytecode interpreter + witness-generation state machine.

Python twin of the reference's execution stack:
- decode / syscall / exception semantics:
  zk_evm's evm_arithmetization/src/witness/transition.rs:47-377
- per-op generators (syscall trap :722, exit_kernel :831, exception :983):
  zk_evm's evm_arithmetization/src/witness/operation.rs
- gas table: zk_evm's evm_arithmetization/src/witness/gas.rs
- memory model (preinitialized segments, get_with_init):
  zk_evm's evm_arithmetization/src/witness/memory.rs:157-260
- GenerationState + PROVER_INPUT oracles:
  zk_evm's evm_arithmetization/src/generation/{state.rs,
  prover_input.rs:47-341}
- interpreter initialization from GenerationInputs + final-register
  handling: zk_evm's evm_arithmetization/src/cpu/kernel/
  interpreter.rs:120-420,647

One class serves the reference's three roles: kernel-routine runs
(`run_kernel`: from a label with a crafted stack), jumpdest-analysis
pre-runs (is_jumpdest_analysis), and full block execution (init -> halt
-> exc_stop -> halt_final) driven by `GenerationInputs`, for the
eth_mainnet flavor only.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, replace
from functools import lru_cache as _lru_cache

from ..tables.segments import Segment, scaled
from ..native import keccak256
from .kernel import Kernel, load_constants

U256_MASK = (1 << 256) - 1
U256_MAX = (1 << 256) - 1
SIGN_BIT = 1 << 255
DEFAULT_HALT_OFFSET = 0xDEADBEEF
CONTEXT_SCALING_FACTOR = 64
MAX_USER_STACK_SIZE = 1024
MAX_CODE_SIZE = 0x6000          # eth_mainnet (constants/mod.rs:374-378)
MAX_CYCLES = 50_000_000

BN_BASE = 21888242871839275222246405745257275088696311157297823662689037894645226208583
SECP_BASE = (1 << 256) - (1 << 32) - 977
SECP_SCALAR = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
BLS_BASE = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# gas costs (witness/gas.rs)
G_BASE, G_VERYLOW, G_LOW, G_MID, G_HIGH, G_JUMPDEST = 2, 3, 5, 8, 10, 1

# exception codes (state.rs:255-263 handle_error / exception.asm jumptable)
EXC_OUT_OF_GAS = 0
EXC_INVALID_OPCODE = 1
EXC_STACK_UNDERFLOW = 2
EXC_INVALID_JUMP = 3
EXC_INVALID_JUMPI = 4
EXC_STACK_OVERFLOW = 5
EXC_STOP = 6

# Syscall table: opcode -> (stack_values_read, stack_len_increased)
# (transition.rs:47-180, the Operation::Syscall rows)
SYSCALLS = {
    0x00: (0, False), 0x05: (2, False), 0x07: (2, False), 0x0A: (2, False),
    0x0B: (2, False), 0x12: (2, False), 0x13: (2, False), 0x1D: (2, False),
    0x20: (2, False), 0x30: (0, True), 0x31: (1, False), 0x32: (0, True),
    0x33: (0, True), 0x34: (0, True), 0x35: (1, False), 0x36: (0, True),
    0x37: (3, False), 0x38: (0, True), 0x39: (3, False), 0x3A: (0, True),
    0x3B: (1, False), 0x3C: (4, False), 0x3D: (0, True), 0x3E: (3, False),
    0x3F: (1, False), 0x40: (1, False), 0x41: (0, True), 0x42: (0, True),
    0x43: (0, True), 0x44: (0, True), 0x45: (0, True), 0x46: (0, True),
    0x47: (0, True), 0x48: (0, True), 0x49: (1, False), 0x4A: (0, True),
    0x51: (1, False), 0x52: (2, False), 0x53: (2, False), 0x54: (1, False),
    0x55: (2, False), 0x59: (0, True), 0x5A: (0, True), 0x5C: (1, False),
    0x5D: (2, False), 0x5E: (3, False), 0xA0: (2, False), 0xA1: (3, False),
    0xA2: (4, False), 0xA3: (5, False), 0xA4: (6, False), 0xF0: (3, False),
    0xF1: (7, False), 0xF2: (7, False), 0xF3: (2, False), 0xF4: (6, False),
    0xF5: (4, False), 0xFA: (6, False), 0xFD: (2, False), 0xFF: (1, False),
}


def _signed(x):
    return x - (1 << 256) if x & SIGN_BIT else x


class ProgramError(Exception):
    """Recoverable user-mode error -> exception trap (errors.rs)."""

    def __init__(self, exc_code: int, msg: str = ""):
        super().__init__(msg or f"exc {exc_code}")
        self.exc_code = exc_code


class KernelPanic(Exception):
    pass


@_lru_cache(maxsize=1 << 16)
def _ff_op(p: int, op: str, x: int) -> int:
    """Pure field oracle (prover_input.rs ff inverse/sqrt). Memoized:
    the segment pre-run and its tracing re-run issue identical queries,
    and the 381/512-bit modexps dominate oracle time."""
    if op == "inverse":
        return pow(x, p - 2, p)
    if op == "sqrt":
        assert (p + 1) % 4 == 0
        return pow(x, (p + 1) // 4, p)
    raise KernelPanic(f"ff op {op}")


@_lru_cache(maxsize=4096)
def _fp12_inverse_cached(f: tuple) -> list:
    from .bn254 import fp12_inverse
    return fp12_inverse(list(f))


class MemoryState:
    """Sparse (context, segment, virtual) -> u256 store with
    preinitialized segment fallback (witness/memory.rs:157-260)."""

    def __init__(self):
        self.data: dict = {}        # (context, segment) -> {virt: value}
        self.preinit: dict = {}     # segment -> list[int]

    def get(self, ctx, seg, virt):
        d = self.data.get((ctx, seg))
        if d is not None:
            v = d.get(virt)
            if v is not None:
                return v
        p = self.preinit.get(seg)
        if p is not None and 0 <= virt < len(p):
            # Materialize the fallback hit: a touched preinitialized
            # address appears in the segment's MemAfter table rows, so
            # it must also appear in the next segment's MemBefore —
            # `data` is what active_values() snapshots.
            self.set(ctx, seg, virt, p[virt])
            return p[virt]
        return 0

    def is_set(self, ctx, seg, virt) -> bool:
        d = self.data.get((ctx, seg))
        return d is not None and virt in d

    def set(self, ctx, seg, virt, value):
        self.data.setdefault((ctx, seg), {})[virt] = value & U256_MASK

    def set_bytes(self, ctx, seg, virt0, data: bytes):
        d = self.data.setdefault((ctx, seg), {})
        for i, b in enumerate(data):
            d[virt0 + i] = b

    def read_bytes(self, ctx, seg, virt, n):
        return bytes(self.get(ctx, seg, virt + i) & 0xFF for i in range(n))

    def insert_preinitialized_segment(self, seg, content):
        self.preinit[seg] = list(content)

    def snapshot_all(self):
        """All (address, value) pairs currently set — zeros included for
        preinitialized segments, skipped elsewhere (the reference's
        get_all_memory_address_and_values, generation/mod.rs:466-488).
        This is the MemBefore content for the (first) segment."""
        out = []
        for seg in sorted(self.preinit):
            for v_i, val in enumerate(self.preinit_view(seg)):
                out.append(((0, seg, v_i), val))
        for (ctx, seg), d in sorted(self.data.items()):
            if ctx == 0 and seg in self.preinit:
                continue
            for virt in sorted(d):
                if d[virt]:
                    out.append(((ctx, seg, virt), d[virt]))
        return out

    def is_preinitialized_segment(self, seg) -> bool:
        return seg in self.preinit

    def preinit_view(self, seg) -> list[int]:
        """Merged preinit + context-0 content (get_preinit_memory,
        memory.rs:211-224). Read-only: does NOT materialize."""
        d = self.data.get((0, seg), {})
        p = self.preinit.get(seg, [])
        length = max(len(p), max(d.keys()) + 1 if d else 0)
        return [d.get(i, p[i] if i < len(p) else 0)
                for i in range(length)]

    def active_values(self, stale_contexts=()):
        """(address, value) pairs of the live memory — non-stale
        contexts, zeros kept only in the memory table's initialization-
        exempt segments — exactly the rows the Memory table exports as
        MemAfter (generation/mod.rs:466-488 + memory_stark.rs:270-280),
        so it chains as the next segment's MemBefore."""
        from ..tables.segments import PREINITIALIZED_SEGMENTS
        stale = set(stale_contexts)
        out = []
        for (ctx, seg), d in sorted(self.data.items()):
            if ctx in stale:
                continue
            keep_zeros = seg in PREINITIALIZED_SEGMENTS
            for virt in sorted(d):
                if d[virt] or keep_zeros:
                    out.append(((ctx, seg, virt), d[virt]))
        return out

    def deep_copy(self) -> "MemoryState":
        m = MemoryState()
        m.data = {k: dict(v) for k, v in self.data.items()}
        m.preinit = {k: list(v) for k, v in self.preinit.items()}
        return m

    # -- shared introspection API (native twin: native_vm.NativeMemory) --
    def preinit_len(self, seg) -> int:
        return len(self.preinit.get(seg, ()))

    def max_virt(self, ctx, seg) -> int:
        d = self.data.get((ctx, seg))
        return max(d.keys()) if d else -1

    def delete_context(self, ctx) -> None:
        for key in [k for k in self.data if k[0] == ctx]:
            del self.data[key]

    def segment_dict(self, ctx, seg) -> dict:
        return dict(self.data.get((ctx, seg), {}))


class SortedPtrs:
    """BTreeMap-lite over bisect: key -> ptr with predecessor queries
    (linked_list.rs LinkedListsPtrs usage in prover_input.rs:405-600)."""

    def __init__(self):
        self.keys: list = []
        self.map: dict = {}

    def pred_le(self, k):
        """Greatest (key, ptr) with key <= k, or None."""
        i = bisect.bisect_right(self.keys, k)
        if i == 0:
            return None
        key = self.keys[i - 1]
        return key, self.map[key]

    def pred_lt(self, k):
        i = bisect.bisect_left(self.keys, k)
        if i == 0:
            return None
        key = self.keys[i - 1]
        return key, self.map[key]

    def insert(self, k, ptr):
        if k not in self.map:
            bisect.insort(self.keys, k)
        self.map[k] = ptr

    def remove(self, k):
        if k not in self.map:
            raise KernelPanic(f"linked-list remove of absent key {k:#x}"
                              if isinstance(k, int) else
                              f"linked-list remove of absent key {k}")
        del self.map[k]
        self.keys.remove(k)

    def clear(self):
        self.keys.clear()
        self.map.clear()

    def copy(self):
        out = SortedPtrs()
        out.keys = list(self.keys)
        out.map = dict(self.map)
        return out


@dataclass
class Registers:
    program_counter: int = 0
    is_kernel: bool = True
    context: int = 0
    stack_len: int = 0
    gas_used: int = 0

    def code_context(self):
        return 0 if self.is_kernel else self.context


_CONSTS = None


def _consts():
    global _CONSTS
    if _CONSTS is None:
        _CONSTS = load_constants()
    return _CONSTS


def _gm(name: str) -> int:
    """Unscaled GlobalMetadata index from the extracted constants."""
    return _consts()[f"GLOBAL_METADATA_{name}"] - scaled(
        Segment.GlobalMetadata)


def _ctxm(name: str) -> int:
    return _consts()[f"CTX_METADATA_{name}"] - scaled(
        Segment.ContextMetadata)


class Interpreter:
    """Kernel interpreter with full witness-generation semantics."""

    def __init__(self, kernel: Kernel, initial_offset=0,
                 max_cycles=MAX_CYCLES):
        from . import native_vm
        self.kernel = kernel
        self.memory = native_vm.make_memory()
        self._nvm = None   # lazy native core handle (native_vm.ZvmHandle)
        self.registers = Registers(program_counter=initial_offset)
        self.clock = 0
        # (pc, opcode, is_kernel, context, stack-before) per step
        self.trace = []
        self.record_trace = True
        self.max_cycles = max_cycles
        self.halt_offsets = {DEFAULT_HALT_OFFSET}
        if "halt_final" in kernel.global_labels:
            self.halt_offsets.add(kernel.global_labels["halt_final"])
        self.halt_label = kernel.global_labels.get("halt")
        self.halt_context = None        # jumpdest-analysis early stop
        self.is_jumpdest_analysis = False
        self.jumpdest_collected: dict = {}   # ctx -> set(dst)
        self._final_registers = None
        self._final_exception_done = False
        self._last_kind = None
        # zk-continuations: stop the segment (via the exc_stop flow) once
        # clock reaches this bound (state.rs run_cpu cycle_limit)
        self.cycle_limit = None
        # registers claimed at segment start (PublicValues.registers_before)
        self.segment_registers_before = None
        self.segment_registers_before_vals = None

        # ---- GenerationState fields (state.rs:350-399) ------------------
        self.inputs = None
        self.next_txn_index = 0
        self.rlp_prover_inputs: list[int] = []
        self.withdrawal_prover_inputs: list[int] = []
        self.ger_prover_inputs: list[int] = [U256_MAX]
        self.bignum_modmul_result_limbs: list[int] = []
        self.trie_root_ptrs = {"state": 0, "txn": 0, "receipt": 0}
        self.jumpdest_table = None           # ctx -> [proof, addr, ...]
        self.jumpdest_regen_log = None       # pre-run: [(key, table)]
        self.jumpdest_regen_replay = None    # tracing run: deque of same
        self.access_lists_ptrs = {"accounts": SortedPtrs(),
                                  "storage": SortedPtrs()}
        self.state_ptrs = {"accounts": SortedPtrs(),
                           "storage": SortedPtrs()}
        self.contract_code: dict = {}        # keccak -> bytes
        self.stale_contexts: list[int] = []

        # phase-C recording hooks (filled by the tracer)
        self.on_keccak = None

        # coprocessor op logs for table generation (traces.rs): entries
        # are (step, payload) where step is the CPU trace row index
        self.arith_log = []     # (step, (kind,in0,in1,in2,opcode,result))
        self.logic_log = []     # (step, (op, in0, in1))
        self.sponge_log = []    # (step, (ctx, seg, virt), input bytes)
        self.bp_log = []        # (step, is_read, (ctx,seg,virt), bytes)
        self.metadata_ops = []  # (segment, virt, value) ts=2 writes

        # preload kernel code into context 0's Code segment (zero bytes
        # included: they are part of MemBefore and must round-trip
        # through active_values -> next segment's MemBefore)
        if hasattr(self.memory, "set_range_u64"):
            import numpy as np
            self.memory.set_range_u64(
                0, Segment.Code, 0,
                np.frombuffer(bytes(kernel.code),
                              dtype=np.uint8).astype(np.uint64))
            shift = np.zeros((256, 4), dtype=np.uint64)
            rows = np.arange(256)
            shift[rows, rows // 64] = np.uint64(1) << (rows % 64).astype(
                np.uint64)
            self.memory.set_range_u256(0, Segment.ShiftTable, 0, shift)
        else:
            for i, b in enumerate(kernel.code):
                self.memory.set(0, Segment.Code, i, b)
            # shift table: ShiftTable[i] = 2^i (the CPU shift module
            # reads it through channel 2; generation/mod.rs:447-461 puts
            # it in memory before execution so it lands in MemBefore)
            for i in range(256):
                self.memory.set(0, Segment.ShiftTable, i, 1 << i)
        self.code = kernel.code
        # MemBefore is exactly kernel code + shift table: the verifier
        # recomputes this trace's cap from the kernel identity
        # (verifier.rs:14-79); preinitialized trie segments are covered
        # by the Memory table's initialize_aux exemption instead.
        from ..tables.memory_continuation import kernel_initial_memory_values
        self.mem_before_values = kernel_initial_memory_values(kernel.code)

    # ------------------------------------------------------------------
    # GenerationInputs initialization (interpreter.rs:225-400)
    # ------------------------------------------------------------------
    def initialize_from_inputs(self, inputs, segment=None) -> None:
        """`inputs` is a decoder GenerationInputs (decoder/core.py).

        `segment` (a witness.segments.SegmentData) resumes a later
        segment instead: memory and oracle state are restored from the
        pre-run's snapshot rather than rebuilt from the tries
        (generate_traces, generation/mod.rs:503-530)."""
        from . import mpt_load
        from .rlp_inputs import (all_rlp_prover_inputs_reversed,
                                 all_withdrawals_prover_inputs_reversed)
        self.inputs = inputs
        self.registers = Registers(
            program_counter=self.registers.program_counter,
            is_kernel=self.registers.is_kernel)
        mem = self.memory

        if segment is not None:
            self.memory = mem = segment.memory.deep_copy()
            assert segment.mem_before_values is not None, \
                "segment MemBefore not chained yet (generate_segment_" \
                "tables chains it from the previous segment's mem_after)"
            self.mem_before_values = list(segment.mem_before_values)
            self.restore_extra(segment.extra)
        else:
            (root_ptrs, state_leaves, storage_leaves, trie_data,
             accounts_ptrs, storage_ptrs) = \
                mpt_load.load_linked_lists_and_txn_and_receipt_mpts(
                    _TrieInputsView(inputs.tries))
            self.trie_root_ptrs = root_ptrs
            for k, v in accounts_ptrs.items():
                self.state_ptrs["accounts"].insert(k, v)
            for k, v in storage_ptrs.items():
                self.state_ptrs["storage"].insert(k, v)
            mem.insert_preinitialized_segment(Segment.TrieData, trie_data)
            mem.insert_preinitialized_segment(Segment.AccountsLinkedList,
                                              state_leaves)
            mem.insert_preinitialized_segment(Segment.StorageLinkedList,
                                              storage_leaves)

            self.rlp_prover_inputs = \
                all_rlp_prover_inputs_reversed(inputs.signed_txns)
            self.withdrawal_prover_inputs = \
                all_withdrawals_prover_inputs_reversed(inputs.withdrawals)
            ger = getattr(inputs, "ger_data", None)
            if ger is not None:
                root, l1blockhash = ger
                # popped from the end: first PROVER_INPUT(ger) yields the
                # l1blockhash, the second the root (state.rs:794-800)
                self.ger_prover_inputs = [
                    int.from_bytes(root, "big"),
                    int.from_bytes(l1blockhash, "big")]
            else:
                self.ger_prover_inputs = [U256_MAX]
        self.contract_code = dict(inputs.contract_code)

        md = inputs.block_metadata
        bh = inputs.block_hashes

        def h2u(h):
            return int.from_bytes(h, "big") if isinstance(
                h, (bytes, bytearray)) else int(h)

        gm_writes = [
            ("BLOCK_BENEFICIARY", int(md.block_beneficiary)),
            ("BLOCK_TIMESTAMP", md.block_timestamp),
            ("BLOCK_NUMBER", md.block_number),
            ("BLOCK_DIFFICULTY", md.block_difficulty),
            ("BLOCK_RANDOM", h2u(md.block_random)),
            ("BLOCK_GAS_LIMIT", md.block_gaslimit),
            ("BLOCK_CHAIN_ID", md.block_chain_id),
            ("BLOCK_BASE_FEE", md.block_base_fee),
            ("BLOCK_CURRENT_HASH", h2u(bh.cur_hash)),
            ("BLOCK_GAS_USED", md.block_gas_used),
            ("BLOCK_BLOB_GAS_USED", md.block_blob_gas_used),
            ("BLOCK_EXCESS_BLOB_GAS", md.block_excess_blob_gas),
            ("PARENT_BEACON_BLOCK_ROOT", h2u(md.parent_beacon_block_root)),
            ("BLOCK_GAS_USED_BEFORE", inputs.gas_used_before),
            ("BLOCK_GAS_USED_AFTER", inputs.gas_used_after),
            ("TXN_NUMBER_BEFORE", inputs.txn_number_before),
            ("TXN_NUMBER_AFTER",
             inputs.txn_number_before + len(inputs.signed_txns)),
            ("STATE_TRIE_DIGEST_BEFORE",
             h2u(trie_root_hash(inputs.tries.state))),
            ("TXN_TRIE_DIGEST_BEFORE",
             h2u(trie_root_hash(inputs.tries.transactions))),
            ("RECEIPT_TRIE_DIGEST_BEFORE",
             h2u(trie_root_hash(inputs.tries.receipts))),
            ("STATE_TRIE_DIGEST_AFTER",
             h2u(inputs.trie_roots_after.state_root)),
            ("TXN_TRIE_DIGEST_AFTER",
             h2u(inputs.trie_roots_after.transactions_root)),
            ("RECEIPT_TRIE_DIGEST_AFTER",
             h2u(inputs.trie_roots_after.receipts_root)),
            ("KERNEL_HASH", int.from_bytes(self.kernel.code_hash, "big")),
            ("KERNEL_LEN", len(self.kernel.code)),
        ]
        for name, val in gm_writes:
            mem.set(0, Segment.GlobalMetadata, _gm(name), int(val))
            self.metadata_ops.append((Segment.GlobalMetadata, _gm(name),
                                      int(val)))
        for i in range(8):
            mem.set(0, Segment.GlobalBlockBloom, i, md.block_bloom[i])
            self.metadata_ops.append((Segment.GlobalBlockBloom, i,
                                      md.block_bloom[i]))
        for i in range(256):
            mem.set(0, Segment.BlockHashes, i, h2u(bh.prev_hashes[i]))
            self.metadata_ops.append((Segment.BlockHashes, i,
                                      h2u(bh.prev_hashes[i])))
        # registers_before are written by run_segment (RegistersStates
        # [0..6]); the first segment's default is pc=main, kernel=1.

    # -- stack ----------------------------------------------------------
    def push(self, v):
        r = self.registers
        self.memory.set(r.context, Segment.Stack, r.stack_len, v)
        r.stack_len += 1

    def push_checked(self, v):
        r = self.registers
        if not r.is_kernel and r.stack_len >= MAX_USER_STACK_SIZE:
            raise ProgramError(EXC_STACK_OVERFLOW)
        self.push(v)

    def pop(self):
        r = self.registers
        if r.stack_len <= 0:
            raise ProgramError(EXC_STACK_UNDERFLOW, "stack underflow")
        r.stack_len -= 1
        return self.memory.get(r.context, Segment.Stack, r.stack_len)

    def require_stack(self, n):
        if self.registers.stack_len < n:
            raise ProgramError(EXC_STACK_UNDERFLOW, "stack underflow")

    def stack(self):
        """Bottom-first list of current stack values."""
        r = self.registers
        return [self.memory.get(r.context, Segment.Stack, i)
                for i in range(r.stack_len)]

    def peek(self, i=0):
        self.require_stack(i + 1)
        r = self.registers
        return self.memory.get(r.context, Segment.Stack,
                               r.stack_len - 1 - i)

    # -- run loop --------------------------------------------------------
    def run(self):
        from . import native_vm
        if isinstance(self.memory, native_vm.NativeMemory):
            return native_vm.run_native(self)
        return self._run_py()

    def _run_py(self):
        r = self.registers
        for _ in range(self.max_cycles):
            pc = r.program_counter
            at_halt = (r.is_kernel and self.halt_label is not None
                       and pc == self.halt_label)
            at_limit = (self.cycle_limit is not None
                        and self.clock >= self.cycle_limit)
            if not self._final_exception_done and (at_halt or at_limit):
                # Reached `halt` (or the segment's cycle budget): record
                # final registers, write them to RegistersStates[6..12]
                # (interpreter.rs:647), and run the exc_stop epilogue
                # (state.rs:210-223 final_exception).
                self._final_registers = replace(r)
                self._write_final_registers(self._final_registers)
                self._final_exception_done = True
                if self.record_trace:
                    code_ctx = r.code_context()
                    if code_ctx == 0 and r.is_kernel:
                        opc = self.code[pc] if pc < len(self.code) else 0
                    else:
                        opc = self.memory.get(code_ctx, Segment.Code,
                                              pc) & 0xFF
                    self.trace.append(
                        [pc, opc, r.is_kernel, r.context,
                         tuple(self.stack()), r.gas_used,
                         ("exception", EXC_STOP)])
                self.exception(EXC_STOP)
                self.clock += 1
                continue
            if r.is_kernel and pc in self.halt_offsets:
                if (self.halt_context is None
                        or r.context == self.halt_context):
                    return self
            self.step()
            self.clock += 1
        raise RuntimeError("interpreter exceeded max_cycles")

    def run_segment(self, registers_before, cycle_limit=None):
        """Start (or resume) a segment: registers := registers_before
        with pc redirected to `init` (whose prologue restores and checks
        them, main.asm:1-62), RegistersStates[0..6] written, clock reset
        (interpreter.rs set_registers_and_run:125-153)."""
        self.segment_registers_before = replace(registers_before)
        self.registers = replace(registers_before,
                                 program_counter=self
                                 .kernel.global_labels["init"],
                                 is_kernel=True)
        self.clock = 0
        self._final_registers = None
        self._final_exception_done = False
        self.cycle_limit = cycle_limit
        self._write_registers_before(registers_before)
        return self.run()

    def _write_registers_before(self, regs):
        stack_top = 0
        if regs.stack_len > 0:
            stack_top = self.memory.get(regs.context, Segment.Stack,
                                        regs.stack_len - 1)
        vals = [regs.program_counter, int(regs.is_kernel), regs.stack_len,
                stack_top, regs.context, regs.gas_used]
        self.segment_registers_before_vals = list(vals)
        for i, v in enumerate(vals):
            self.memory.set(0, Segment.RegistersStates, i, v)
            self.metadata_ops.append((Segment.RegistersStates, i, v))

    @property
    def final_registers(self):
        return self._final_registers

    def _write_final_registers(self, fr: Registers):
        stack_top = 0
        if fr.stack_len > 0:
            stack_top = self.memory.get(fr.context, Segment.Stack,
                                        fr.stack_len - 1)
        vals = [fr.program_counter, int(fr.is_kernel), fr.stack_len,
                stack_top, fr.context, fr.gas_used]
        for i, v in enumerate(vals):
            self.memory.set(0, Segment.RegistersStates, 6 + i, v)
            self.metadata_ops.append((Segment.RegistersStates, 6 + i, v))

    def step(self):
        r = self.registers
        pc = r.program_counter
        code_ctx = r.code_context()
        if code_ctx == 0 and r.is_kernel:
            if pc >= len(self.code):
                raise KernelPanic(f"kernel pc {pc} out of code bounds")
            op = self.code[pc]
        else:
            op = self.memory.get(code_ctx, Segment.Code, pc) & 0xFF
        entry = None
        if self.record_trace:
            # [pc, opcode, is_kernel, context, stack-before, gas, kind]
            # kind: None (native) | "syscall" | ("exception", exc_code)
            entry = [pc, op, r.is_kernel, r.context,
                     tuple(self.stack()), r.gas_used, None]
            self.trace.append(entry)
        saved = replace(r)
        self._last_kind = None
        try:
            if self.is_jumpdest_analysis and r.is_kernel and \
                    pc == self.kernel.global_labels.get("jumpdest_analysis"):
                # Skip the in-kernel validation loop during the analysis
                # pre-run; set the bits directly (interpreter.rs
                # skip_if_necessary).
                self._set_jumpdest_bits_from_code()
                r.program_counter = \
                    self.kernel.global_labels["jumpdest_analysis_end"]
                return
            r.program_counter += 1
            self.execute(op)
            self._charge_gas(op)
            if entry is not None:
                entry[6] = self._last_kind
        except ProgramError as e:
            if saved.is_kernel:
                raise KernelPanic(
                    f"{e} in kernel at pc={pc} "
                    f"({self.kernel.offset_label(pc)}), "
                    f"stack={[hex(v) for v in self.stack()[-8:]]}") from e
            # roll the registers back in place (run() holds a reference)
            for f in ("program_counter", "is_kernel", "context",
                      "stack_len", "gas_used"):
                setattr(r, f, getattr(saved, f))
            if entry is not None:
                entry[6] = ("exception", e.exc_code)
            self.exception(e.exc_code)

    # -- gas (gas.rs + perform_state_op OOG check) -----------------------
    _GAS = {}
    for _op in (0x01, 0x03, 0x10, 0x11, 0x14, 0x15, 0x16, 0x17, 0x18,
                0x19, 0x1A, 0x1B, 0x1C):
        _GAS[_op] = G_VERYLOW
    for _op in (0x02, 0x04, 0x06):
        _GAS[_op] = G_LOW
    for _op in (0x08, 0x09, 0x56):
        _GAS[_op] = G_MID
    _GAS[0x57] = G_HIGH
    _GAS[0x50] = G_BASE
    _GAS[0x58] = G_BASE
    _GAS[0x5B] = G_JUMPDEST
    _GAS[0x5F] = G_BASE
    for _op in range(0x60, 0x80):
        _GAS[_op] = G_VERYLOW
    for _op in range(0x80, 0xA0):
        _GAS[_op] = G_VERYLOW
    del _op

    def _charge_gas(self, op):
        r = self.registers
        g = self._GAS.get(op, 0)
        if g:
            r.gas_used += g
        if not r.is_kernel:
            limit = self.memory.get(r.context, Segment.ContextMetadata,
                                    _ctxm("GAS_LIMIT"))
            if r.gas_used > limit:
                raise ProgramError(EXC_OUT_OF_GAS)

    # -- coprocessor op recording (witness/operation.rs) ------------------
    def _step_idx(self):
        return len(self.trace) - 1

    def _rec_arith(self, kind, in0, in1, in2=0, opcode=0, result=None):
        if not self.record_trace:
            return
        if self._nvm is not None:
            self._nvm.record_arith(kind, in0, in1, in2, opcode, result)
        else:
            self.arith_log.append(
                (self._step_idx(), (kind, in0, in1, in2, opcode, result)))

    def _rec_logic(self, op, in0, in1):
        if self.record_trace:
            self.logic_log.append((self._step_idx(), (op, in0, in1)))

    def _rec_bp(self, is_read, ctx, seg, virt, data):
        if not (self.record_trace and data):
            return
        if self._nvm is not None:
            self._nvm.record_bp(is_read, ctx, seg, virt, bytes(data))
        else:
            self.bp_log.append(
                (self._step_idx(), is_read, (ctx, seg, virt), bytes(data)))

    def _stack_top_or_zero(self):
        r = self.registers
        if r.stack_len <= 0:
            return 0
        return self.memory.get(r.context, Segment.Stack, r.stack_len - 1)

    # -- traps (operation.rs:722-831,983-1083) ---------------------------
    def _jumptable_target(self, table_label: str, index: int) -> int:
        base = self.kernel.global_labels[table_label] + 3 * index
        return int.from_bytes(bytes(self.code[base:base + 3]), "big")

    def syscall(self, op: int):
        r = self.registers
        n_read, grows = SYSCALLS[op]
        self.require_stack(n_read)
        if grows and not r.is_kernel and \
                r.stack_len >= MAX_USER_STACK_SIZE:
            raise ProgramError(EXC_STACK_OVERFLOW)
        new_pc = self._jumptable_target("syscall_jumptable", op)
        # pc was already incremented in step(): kexit pc = syscall pc + 1
        kexit_info = (r.program_counter
                      | (int(r.is_kernel) << 32)
                      | (r.gas_used << 192))
        # jumptable 3-byte read (BytePacking CTL) + gas range check
        # (operation.rs:748-807)
        jt = self.kernel.global_labels["syscall_jumptable"] + 3 * op
        self._rec_bp(True, 0, Segment.Code, jt,
                     bytes(self.code[jt:jt + 3]))
        self._rec_arith("range_check", self._stack_top_or_zero(), new_pc,
                        0, opcode=op, result=kexit_info)
        r.program_counter = new_pc
        r.is_kernel = True
        r.gas_used = 0
        self.push(kexit_info)
        self._last_kind = "syscall"

    def exception(self, exc_code: int):
        r = self.registers
        if r.is_kernel and exc_code != EXC_STOP:
            raise KernelPanic(f"exception {exc_code} in kernel mode")
        new_pc = self._jumptable_target("exception_jumptable", exc_code)
        exc_info = (r.program_counter
                    | (int(r.is_kernel) << 32)
                    | (r.gas_used << 192))
        # faulting opcode for the range-check (operation.rs:1041-1057)
        code_ctx = r.code_context()
        pc = r.program_counter
        if code_ctx == 0 and r.is_kernel:
            opc = self.code[pc] if pc < len(self.code) else 0
        else:
            opc = self.memory.get(code_ctx, Segment.Code, pc) & 0xFF
        jt = self.kernel.global_labels["exception_jumptable"] \
            + 3 * exc_code
        self._rec_bp(True, 0, Segment.Code, jt,
                     bytes(self.code[jt:jt + 3]))
        self._rec_arith("range_check", self._stack_top_or_zero(), new_pc,
                        0, opcode=opc, result=exc_info)
        r.program_counter = new_pc
        r.is_kernel = True
        r.gas_used = 0
        self.push(exc_info)

    # -- jumps (transition.rs:377-470) -----------------------------------
    def _observe_jump(self, dst: int):
        gl = self.kernel.global_labels
        if self.registers.stack_len == 0:
            return
        if dst == gl.get("observe_new_address"):
            pass  # debugging aid only (state.rs:505-513)
        elif dst == gl.get("observe_new_contract"):
            self._observe_contract()

    def _observe_contract(self):
        """Record newly created contract code (state.rs:516-539)."""
        codehash = self.peek(0).to_bytes(32, "big")
        if codehash in self.contract_code:
            return
        ctx = self.registers.context
        size = self.memory.get(ctx, Segment.ContextMetadata,
                               _ctxm("RETURNDATA_SIZE"))
        code = self.memory.read_bytes(ctx, Segment.Returndata, 0, size)
        assert keccak256(code) == codehash
        self.contract_code[codehash] = code

    def _check_jump_dest(self, dst: int, is_jumpi: bool):
        r = self.registers
        exc = EXC_INVALID_JUMPI if is_jumpi else EXC_INVALID_JUMP
        if dst >= (1 << 32):
            raise ProgramError(exc, "jump dest > u32")
        if not r.is_kernel and dst > MAX_CODE_SIZE:
            raise ProgramError(exc, "jump dest > MAX_CODE_SIZE")
        if self.is_jumpdest_analysis and not r.is_kernel:
            self.jumpdest_collected.setdefault(r.context, set()).add(dst)
            return
        if not r.is_kernel:
            bit = self.memory.get(r.context, Segment.JumpdestBits, dst)
            if bit != 1:
                raise ProgramError(exc, "not a jumpdest")

    def _set_jumpdest_bits_from_code(self):
        ctx = self.registers.context
        size = self.memory.get(ctx, Segment.ContextMetadata,
                               _ctxm("CODE_SIZE"))
        code = self.memory.read_bytes(ctx, Segment.Code, 0, size)
        i = 0
        while i < len(code):
            b = code[i]
            if b == 0x5B:
                self.memory.set(ctx, Segment.JumpdestBits, i, 1)
            i += 1 + (b - 0x5F if 0x60 <= b <= 0x7F else 0)

    # -- opcode semantics -------------------------------------------------
    def execute(self, op):
        r = self.registers
        push = self.push
        pop = self.pop

        if op in SYSCALLS:
            self.syscall(op)
        elif 0x5F <= op <= 0x7F:                    # PUSH0..PUSH32
            n = op - 0x5F
            self.require_stack(0)
            pc = r.program_counter
            code_ctx = r.code_context()
            if code_ctx == 0 and r.is_kernel:
                v = int.from_bytes(self.code[pc:pc + n], "big")
            else:
                data = self.memory.read_bytes(code_ctx, Segment.Code,
                                              pc, n)
                v = int.from_bytes(data, "big")
                # user PUSH immediates are verified via the BytePacking
                # CTL (operation.rs:490-494); kernel code is bound by
                # the MemBefore cap instead
                self._rec_bp(True, code_ctx, Segment.Code, pc, data)
            r.program_counter += n
            self.push_checked(v)
        elif 0x80 <= op <= 0x8F:                    # DUP1..16
            v = self.peek(op - 0x80)
            self.push_checked(v)
        elif 0x90 <= op <= 0x9F:                    # SWAP1..16
            d = op - 0x8F
            self.require_stack(d + 1)
            i0 = r.stack_len - 1
            a = self.memory.get(r.context, Segment.Stack, i0)
            b = self.memory.get(r.context, Segment.Stack, i0 - d)
            self.memory.set(r.context, Segment.Stack, i0, b)
            self.memory.set(r.context, Segment.Stack, i0 - d, a)
        elif op == 0x01:
            self.require_stack(2)
            a, b = pop(), pop()
            self._rec_arith("add", a, b)
            push((a + b) & U256_MASK)
        elif op == 0x02:
            self.require_stack(2)
            a, b = pop(), pop()
            self._rec_arith("mul", a, b)
            push((a * b) & U256_MASK)
        elif op == 0x03:
            self.require_stack(2)
            a, b = pop(), pop()
            self._rec_arith("sub", a, b)
            push((a - b) & U256_MASK)
        elif op == 0x04:
            self.require_stack(2)
            a, b = pop(), pop()
            self._rec_arith("div", a, b)
            push(0 if b == 0 else a // b)
        elif op == 0x06:
            self.require_stack(2)
            a, b = pop(), pop()
            self._rec_arith("mod", a, b)
            push(0 if b == 0 else a % b)
        elif op == 0x08:
            self.require_stack(3)
            a, b, n = pop(), pop(), pop()
            self._rec_arith("addmod", a, b, n)
            push(0 if n == 0 else (a + b) % n)
        elif op == 0x09:
            self.require_stack(3)
            a, b, n = pop(), pop(), pop()
            self._rec_arith("mulmod", a, b, n)
            push(0 if n == 0 else (a * b) % n)
        elif op == 0x0C and r.is_kernel:
            a, b = pop(), pop()
            self._rec_arith("addfp254", a, b)
            push((a + b) % BN_BASE)
        elif op == 0x0D and r.is_kernel:
            a, b = pop(), pop()
            self._rec_arith("mulfp254", a, b)
            push((a * b) % BN_BASE)
        elif op == 0x0E and r.is_kernel:
            a, b = pop(), pop()
            self._rec_arith("subfp254", a, b)
            push((a - b) % BN_BASE)
        elif op == 0x0F and r.is_kernel:            # SUBMOD
            a, b, n = pop(), pop(), pop()
            self._rec_arith("submod", a, b, n)
            push(0 if n == 0 else (a - b) % n)
        elif op == 0x10:
            self.require_stack(2)
            a, b = pop(), pop()
            self._rec_arith("lt", a, b)
            push(int(a < b))
        elif op == 0x11:
            self.require_stack(2)
            a, b = pop(), pop()
            self._rec_arith("gt", a, b)
            push(int(a > b))
        elif op == 0x14:
            self.require_stack(2)
            push(int(pop() == pop()))
        elif op == 0x15:
            push(int(pop() == 0))
        elif op == 0x16:
            self.require_stack(2)
            a, b = pop(), pop()
            self._rec_logic("and", a, b)
            push(a & b)
        elif op == 0x17:
            self.require_stack(2)
            a, b = pop(), pop()
            self._rec_logic("or", a, b)
            push(a | b)
        elif op == 0x18:
            self.require_stack(2)
            a, b = pop(), pop()
            self._rec_logic("xor", a, b)
            push(a ^ b)
        elif op == 0x19:
            push(pop() ^ U256_MASK)
        elif op == 0x1A:                            # BYTE
            self.require_stack(2)
            i, x = pop(), pop()
            self._rec_arith("byte", i, x)
            push(0 if i >= 32 else (x >> (8 * (31 - i))) & 0xFF)
        elif op == 0x1B:                            # SHL
            self.require_stack(2)
            s, x = pop(), pop()
            self._rec_arith("shl", s, x)
            push((x << s) & U256_MASK if s < 256 else 0)
        elif op == 0x1C:                            # SHR
            self.require_stack(2)
            s, x = pop(), pop()
            self._rec_arith("shr", s, x)
            push(x >> s if s < 256 else 0)
        elif op == 0x21 and r.is_kernel:            # KECCAK_GENERAL
            self.require_stack(2)
            addr, length = pop(), pop()
            ctx, seg, virt = _unpack_addr(addr)
            data = self.memory.read_bytes(ctx, seg, virt, length)
            digest = keccak256(data)
            if self.record_trace:
                self.sponge_log.append(
                    (self._step_idx(), (ctx, seg, virt), data))
            if self.on_keccak is not None:
                self.on_keccak((ctx, seg, virt), data, self.clock)
            push(int.from_bytes(digest, "big"))
        elif op == 0x50:
            pop()
        elif op == 0x56:                            # JUMP
            dst = pop()
            self._check_jump_dest(dst, is_jumpi=False)
            r.program_counter = dst
            self._observe_jump(dst)
        elif op == 0x57:                            # JUMPI
            self.require_stack(2)
            dst, cond = pop(), pop()
            if cond:
                self._check_jump_dest(dst, is_jumpi=True)
                r.program_counter = dst
                self._observe_jump(dst)
        elif op == 0x58:                            # PC
            self.push_checked(r.program_counter - 1)
        elif op == 0x5B:                            # JUMPDEST
            pass
        elif op == 0xA5 and r.is_kernel:            # PANIC
            raise KernelPanic(
                f"kernel PANIC at pc {r.program_counter - 1} "
                f"({self.kernel.offset_label(r.program_counter - 1)})")
        elif 0xC0 <= op <= 0xDF and r.is_kernel:    # MSTORE_32BYTES_1..32
            n = op - 0xC0 + 1
            self.require_stack(2)
            addr, value = pop(), pop()
            ctx, seg, virt = _unpack_addr(addr)
            bs = (value & ((1 << (8 * n)) - 1)).to_bytes(n, "big")
            self._rec_bp(False, ctx, seg, virt, bs)
            for i, b in enumerate(bs):
                self.memory.set(ctx, seg, virt + i, b)
            push(addr + n)
        elif op == 0xEE and r.is_kernel:            # PROVER_INPUT
            path = self.kernel.prover_inputs.get(r.program_counter - 1)
            old_top = self._stack_top_or_zero()
            v = self.prover_input(path)
            self._rec_arith("range_check", old_top, 0, 0, opcode=0xEE,
                            result=v)
            self.push(v)
        elif op == 0xF6 and r.is_kernel:            # GET_CONTEXT
            push(r.context << CONTEXT_SCALING_FACTOR)
        elif op == 0xF7 and r.is_kernel:            # SET_CONTEXT
            ctx_scaled = pop()
            new_ctx = ctx_scaled >> CONTEXT_SCALING_FACTOR
            # bit 0 of the popped word flags the old context as stale
            # (operation.rs:384-442 context pruning)
            if ctx_scaled & 1:
                self.stale_contexts.append(r.context)
            sp_field = _ctxm("STACK_SIZE")
            self.memory.set(r.context, Segment.ContextMetadata,
                            sp_field, r.stack_len)
            new_sp = self.memory.get(new_ctx, Segment.ContextMetadata,
                                     sp_field)
            r.context = new_ctx
            r.stack_len = new_sp
        elif op == 0xF8 and r.is_kernel:            # MLOAD_32BYTES
            self.require_stack(2)
            addr, length = pop(), pop()
            ctx, seg, virt = _unpack_addr(addr)
            data = self.memory.read_bytes(ctx, seg, virt, length)
            self._rec_bp(True, ctx, seg, virt, data)
            push(int.from_bytes(data, "big"))
        elif op == 0xF9 and r.is_kernel:            # EXIT_KERNEL
            kexit_info = pop()
            r.program_counter = kexit_info & 0xFFFFFFFF
            r.is_kernel = bool((kexit_info >> 32) & 1)
            r.gas_used = (kexit_info >> 192) & ((1 << 64) - 1)
            assert r.gas_used < (1 << 32), "gas limit error on exit"
        elif op == 0xFB and r.is_kernel:            # MLOAD_GENERAL
            addr = pop()
            ctx, seg, virt = _unpack_addr(addr)
            push(self.memory.get(ctx, seg, virt))
        elif op == 0xFC and r.is_kernel:            # MSTORE_GENERAL
            self.require_stack(2)
            value, addr = pop(), pop()
            ctx, seg, virt = _unpack_addr(addr)
            self.memory.set(ctx, seg, virt, value)
        else:
            raise ProgramError(EXC_INVALID_OPCODE,
                               f"invalid opcode {op:#x}")

    # ------------------------------------------------------------------
    # PROVER_INPUT oracles (generation/prover_input.rs:47-341)
    # ------------------------------------------------------------------
    def prover_input(self, path):
        if path is None:
            raise KernelPanic("unknown PROVER_INPUT site")
        kind = path[0]
        fn = getattr(self, f"_pi_{kind}", None)
        if fn is None:
            raise KernelPanic(f"PROVER_INPUT({'::'.join(path)}) "
                              "not implemented")
        return fn(path)

    def _pi_end_of_txns(self, path):
        self.jumpdest_table = None
        if self.inputs is None:
            return 1
        if self.next_txn_index == len(self.inputs.signed_txns):
            return 1
        self.next_txn_index += 1
        return 0

    def _pi_trie_ptr(self, path):
        from . import mpt_load
        what = path[1]
        if what == "initial_state":
            if self.trie_root_ptrs["state"] is not None:
                return self.trie_root_ptrs["state"]
            content = self.memory.preinit_view(Segment.TrieData)
            n = mpt_load.load_state_mpt(_TrieInputsView(self.inputs.tries),
                                        content)
            self.memory.insert_preinitialized_segment(Segment.TrieData,
                                                      content)
            self.trie_root_ptrs["state"] = n
            return n
        if what == "txn":
            return self.trie_root_ptrs["txn"]
        if what == "receipt":
            return self.trie_root_ptrs["receipt"]
        if what == "trie_data_size":
            length = self.memory.preinit_len(Segment.TrieData)
            mv = self.memory.max_virt(0, Segment.TrieData)
            return max(length, mv + 1)
        raise KernelPanic(f"trie_ptr::{what}")

    _FIELDS = {"bn254_base": BN_BASE, "secp256k1_base": SECP_BASE,
               "secp256k1_scalar": SECP_SCALAR, "bls381_base": BLS_BASE}

    def _pi_ff(self, path):
        p = self._FIELDS[path[1]]
        op = path[2]
        x = self.peek(0)
        assert x < p, "ff input out of range"
        return _ff_op(p, op, x)

    def _pi_sf(self, path):
        """Special 512-bit field ops for BLS381 base-field limbs
        (prover_input.rs:147-171,1039-1086). The `_lo` variants see the
        stack as [y1,x0,x1,y0], the `_hi` variants as [x0,x1,y0,y1]."""
        assert path[1] == "bls381_base"
        op = path[2]
        i0, i1, i2, i3 = (self.peek(i) for i in range(4))
        if op.endswith("_lo"):
            y1, x0, x1, y0 = i0, i1, i2, i3
        else:
            x0, x1, y0, y1 = i0, i1, i2, i3
        x = x0 + (x1 << 256)
        y = y0 + (y1 << 256)
        if op.startswith("add"):
            z = (x + y) % BLS_BASE
        elif op.startswith("sub"):
            z = (x - y) % BLS_BASE
        elif op.startswith("mul"):
            z = (x * y) % BLS_BASE
        else:
            raise KernelPanic(f"sf op {op}")
        return z & U256_MASK if op.endswith("_lo") else z >> 256

    def _pi_ffe(self, path):
        """BN254 Fp12 inverse components (prover_input.rs:174-190)."""
        from .bn254 import fp12_inverse
        n = int(path[2].split("_")[1])
        ptr = self.peek(11 - n)
        ctx = self.registers.context
        f = tuple(self.memory.get(ctx, Segment.BnPairing, ptr + i)
                  for i in range(12))
        return _fp12_inverse_cached(f)[n]

    def _pi_rlp(self, path):
        if not self.rlp_prover_inputs:
            raise KernelPanic("out of RLP data")
        return self.rlp_prover_inputs.pop()

    def _pi_blobbasefee(self, path):
        md = self.inputs.block_metadata
        MIN_BASE_FEE_PER_BLOB_GAS = 1
        BLOB_BASE_FEE_UPDATE_FRACTION = 3338477
        return _fake_exponential(MIN_BASE_FEE_PER_BLOB_GAS,
                                 md.block_excess_blob_gas,
                                 BLOB_BASE_FEE_UPDATE_FRACTION)

    def _pi_current_hash(self, path):
        h = self.inputs.block_hashes.cur_hash
        return int.from_bytes(h, "big") if isinstance(h, bytes) else int(h)

    def _pi_account_code(self, path):
        codehash = self.peek(0).to_bytes(32, "big")
        context = self.peek(1) >> CONTEXT_SCALING_FACTOR
        code = self.contract_code.get(codehash)
        if code is None:
            raise KernelPanic(f"code hash not found: {codehash.hex()}")
        self.memory.set_bytes(context, Segment.Code, 0, bytes(code))
        return len(code)

    def _pi_bignum_modmul(self, path):
        if not self.bignum_modmul_result_limbs:
            length = self.peek(2)
            a_loc, b_loc, m_loc = self.peek(3), self.peek(4), self.peek(5)
            ctx = self.registers.context
            read = lambda loc: [
                self.memory.get(ctx, Segment.KernelGeneral, loc + i)
                for i in range(length)]

            def to_int(limbs):
                v = 0
                for i, x in enumerate(limbs):
                    v |= x << (128 * i)
                return v

            a, b, m = (to_int(read(loc)) for loc in (a_loc, b_loc, m_loc))
            prod = a * b
            quo = 0 if m == 0 else prod // m
            rem = prod - m * quo

            def limbs_of(v, n):
                return [(v >> (128 * i)) & ((1 << 128) - 1)
                        for i in range(n)]

            out = limbs_of(rem, length) + limbs_of(quo, 2 * length)
            out.reverse()
            self.bignum_modmul_result_limbs = out
        return self.bignum_modmul_result_limbs.pop()

    def _pi_withdrawal(self, path):
        if not self.withdrawal_prover_inputs:
            raise KernelPanic("out of withdrawal data")
        return self.withdrawal_prover_inputs.pop()

    def _pi_ger(self, path):
        if not self.ger_prover_inputs:
            raise KernelPanic("out of GER data")
        return self.ger_prover_inputs.pop()

    def _pi_kzg_point_eval(self, path):
        """EIP-4844 point-evaluation precompile: the pairing check runs
        on the host (prover_input.rs:634-710); the kernel consumes the
        result nondeterministically (asm/core/precompiles/
        kzg_peval.asm:55)."""
        from .bls381 import kzg_point_eval
        return kzg_point_eval(
            self.peek(0), self.peek(1), self.peek(2), self.peek(3),
            self.peek(4), self.peek(5), self.peek(6))

    def _pi_kzg_point_eval_2(self, path):
        """Second word of the precompile's 64-byte return value
        (prover_input.rs:683-710)."""
        from .bls381 import R, FIELD_ELEMENTS_PER_BLOB
        if self.peek(0) != R:
            raise KernelPanic("kzg_point_eval_2 without a successful "
                              "point evaluation")
        return FIELD_ELEMENTS_PER_BLOB

    def _pi_num_bits(self, path):
        v = self.peek(0)
        assert v != 0, "num_bits of zero"
        return v.bit_length()

    # ---- jumpdest analysis (prover_input.rs:314-420) --------------------
    def _pi_jumpdest_table(self, path):
        what = path[1]
        if what == "next_address":
            ctx = self.peek(0) >> CONTEXT_SCALING_FACTOR
            if self.jumpdest_table is None:
                self._generate_jumpdest_table()
            tbl = self.jumpdest_table.get(ctx)
            if tbl:
                return tbl.pop() + 1
            self.jumpdest_table.pop(ctx, None)
            return 0
        if what == "next_proof":
            ctx = self.peek(1) >> CONTEXT_SCALING_FACTOR
            tbl = self.jumpdest_table.get(ctx)
            if not tbl:
                raise KernelPanic("invalid jumpdest simulation")
            return tbl.pop()
        if what == "non_jumpdest_proof":
            address = self.peek(0)
            code = self._current_code()
            addr = _closest_opcode_address(code, address)
            return 0 if addr < 32 else addr
        raise KernelPanic(f"jumpdest_table::{what}")

    def _current_code(self) -> bytes:
        ctx = self.registers.context
        size = self.memory.get(ctx, Segment.ContextMetadata,
                               _ctxm("CODE_SIZE"))
        return self.memory.read_bytes(ctx, Segment.Code, 0, size)

    def _generate_jumpdest_table(self):
        """Clone the state, re-run to terminate_common collecting user
        jumps, then compute proofs (interpreter.rs:73-109,
        prover_input.rs set_jumpdest_analysis_inputs).

        The segment pre-run records each generated table in
        `jumpdest_regen_log` (keyed by the triggering state); the tracing
        re-run of the same segment replays them from
        `jumpdest_regen_replay` instead of re-simulating — the runs are
        deterministic twins, and the simulation is the single most
        expensive oracle at mainnet scale."""
        key = (self.registers.context, self.next_txn_index,
               self.registers.program_counter)
        if self.jumpdest_regen_replay is not None \
                and self.jumpdest_regen_replay:
            rkey, table = self.jumpdest_regen_replay.popleft()
            assert rkey == key, (
                "jumpdest replay diverged from the pre-run", rkey, key)
            self.jumpdest_table = {k: list(v) for k, v in table.items()}
            return
        sim = self.soft_clone()
        sim.is_jumpdest_analysis = True
        sim.record_trace = False
        sim.halt_offsets = {self.kernel.global_labels["terminate_common"]}
        sim.halt_label = None
        sim.halt_context = self.registers.context
        # The first next_address request fires from the PROVER_INPUT that
        # sits exactly AT the `jumpdest_analysis` label, with the clone's
        # pc already incremented past it. Restart the sim ON the label so
        # the analysis-skip hook fires with the stack still
        # [ctx, code_len, retdest] (the reference clones pre-increment:
        # simulate_cpu_and_get_user_jumps, interpreter.rs:73-109).
        sim.registers.program_counter = \
            self.kernel.global_labels["jumpdest_analysis"]
        try:
            sim.run()
        except (KernelPanic, RuntimeError):
            pass  # partial tables are legal; the kernel verifies them
        table = {}
        for ctx, dsts in sim.jumpdest_collected.items():
            size = sim.memory.get(ctx, Segment.ContextMetadata,
                                  _ctxm("CODE_SIZE"))
            code = sim.memory.read_bytes(ctx, Segment.Code, 0, size)
            if dsts:
                table[ctx] = _proofs_and_jumpdests(code, max(dsts),
                                                   sorted(dsts))
            else:
                table[ctx] = []
        self.jumpdest_table = table
        if self.jumpdest_regen_log is not None:
            self.jumpdest_regen_log.append(
                (key, {k: list(v) for k, v in table.items()}))

    def capture_extra(self) -> dict:
        """Oracle/bookkeeping state a later segment resumes from (the
        reference's ExtraSegmentData, segments.rs:72-90)."""
        return {
            "next_txn_index": self.next_txn_index,
            "rlp_prover_inputs": list(self.rlp_prover_inputs),
            "withdrawal_prover_inputs":
                list(self.withdrawal_prover_inputs),
            "ger_prover_inputs": list(self.ger_prover_inputs),
            "bignum_modmul_result_limbs":
                list(self.bignum_modmul_result_limbs),
            "trie_root_ptrs": dict(self.trie_root_ptrs),
            "jumpdest_table": None if self.jumpdest_table is None
            else {k: list(v) for k, v in self.jumpdest_table.items()},
            "access_lists_ptrs": {
                k: v.copy() for k, v in self.access_lists_ptrs.items()},
            "state_ptrs": {k: v.copy()
                           for k, v in self.state_ptrs.items()},
        }

    def restore_extra(self, extra: dict) -> None:
        self.next_txn_index = extra["next_txn_index"]
        self.rlp_prover_inputs = list(extra["rlp_prover_inputs"])
        self.withdrawal_prover_inputs = \
            list(extra["withdrawal_prover_inputs"])
        self.ger_prover_inputs = list(extra["ger_prover_inputs"])
        self.bignum_modmul_result_limbs = \
            list(extra["bignum_modmul_result_limbs"])
        self.trie_root_ptrs = dict(extra["trie_root_ptrs"])
        jt = extra["jumpdest_table"]
        self.jumpdest_table = None if jt is None \
            else {k: list(v) for k, v in jt.items()}
        self.access_lists_ptrs = {
            k: v.copy() for k, v in extra["access_lists_ptrs"].items()}
        self.state_ptrs = {k: v.copy()
                           for k, v in extra["state_ptrs"].items()}

    def soft_clone(self) -> "Interpreter":
        """Clone everything needed for a simulation re-run; memory is
        deep-copied (the reference shares a cloned MemoryState too,
        state.rs soft_clone)."""
        sim = Interpreter.__new__(Interpreter)
        sim.kernel = self.kernel
        sim.code = self.code
        sim.memory = self.memory.deep_copy()
        sim._nvm = None
        sim.registers = replace(self.registers)
        sim.clock = 0
        sim.trace = []
        sim.record_trace = False
        sim.max_cycles = self.max_cycles
        sim.halt_offsets = set()
        sim.halt_label = None
        sim.halt_context = None
        sim.is_jumpdest_analysis = False
        sim.jumpdest_collected = {}
        sim._final_registers = None
        sim._final_exception_done = False
        sim._last_kind = None
        sim.cycle_limit = None
        sim.segment_registers_before = None
        sim.segment_registers_before_vals = None
        sim.inputs = self.inputs
        sim.next_txn_index = self.next_txn_index
        sim.rlp_prover_inputs = list(self.rlp_prover_inputs)
        sim.withdrawal_prover_inputs = list(self.withdrawal_prover_inputs)
        sim.ger_prover_inputs = list(self.ger_prover_inputs)
        sim.bignum_modmul_result_limbs = \
            list(self.bignum_modmul_result_limbs)
        sim.trie_root_ptrs = dict(self.trie_root_ptrs)
        sim.jumpdest_table = None
        sim.jumpdest_regen_log = None
        sim.jumpdest_regen_replay = None
        sim.access_lists_ptrs = {
            k: v.copy() for k, v in self.access_lists_ptrs.items()}
        sim.state_ptrs = {k: v.copy() for k, v in self.state_ptrs.items()}
        sim.contract_code = dict(self.contract_code)
        sim.stale_contexts = []
        sim.on_keccak = None
        sim.arith_log = []
        sim.logic_log = []
        sim.sponge_log = []
        sim.bp_log = []
        sim.metadata_ops = []
        return sim

    # ---- access lists (prover_input.rs:405-500) -------------------------
    def _pi_access_lists(self, path):
        what = path[1]
        al = self.access_lists_ptrs
        if what == "address_insert":
            addr = self.peek(0)
            pred = al["accounts"].pred_le(addr)
            pred_addr, ptr = pred if pred else (
                U256_MAX, scaled(Segment.AccessedAddresses))
            if pred_addr != addr:
                al["accounts"].insert(addr, self._read_gm(
                    "ACCESSED_ADDRESSES_LEN"))
            return ptr // 2
        if what == "address_remove":
            addr = self.peek(0)
            pred = al["accounts"].pred_lt(addr)
            _, ptr = pred if pred else (
                U256_MAX, scaled(Segment.AccessedAddresses))
            al["accounts"].remove(addr)
            return ptr // 2
        if what == "storage_insert":
            addr, key = self.peek(0), self.peek(1)
            pred = al["storage"].pred_le((addr, key))
            (pa, pk), ptr = pred if pred else (
                (U256_MAX, 0), scaled(Segment.AccessedStorageKeys))
            if pa != addr or pk != key:
                al["storage"].insert((addr, key), self._read_gm(
                    "ACCESSED_STORAGE_KEYS_LEN"))
            return ptr // 4
        if what == "storage_remove":
            addr, key = self.peek(0), self.peek(1)
            pred = al["storage"].pred_lt((addr, key))
            _, ptr = pred if pred else (
                (U256_MAX, 0), scaled(Segment.AccessedStorageKeys))
            al["storage"].remove((addr, key))
            return ptr // 4
        if what == "reset":
            al["accounts"].clear()
            al["storage"].clear()
            return 0
        raise KernelPanic(f"access_lists::{what}")

    def _read_gm(self, name) -> int:
        return self.memory.get(0, Segment.GlobalMetadata, _gm(name))

    # ---- state linked lists (prover_input.rs:503-600) -------------------
    def _pi_linked_list(self, path):
        from .mpt_load import (ACCOUNTS_LINKED_LIST_NODE_SIZE as ASZ,
                               STORAGE_LINKED_LIST_NODE_SIZE as SSZ)
        what = path[1]
        sp = self.state_ptrs
        if what in ("insert_account", "search_account"):
            addr = self.peek(0)
            pred = sp["accounts"].pred_le(addr)
            pred_addr, pred_ptr = pred if pred else (
                U256_MAX, scaled(Segment.AccountsLinkedList))
            if pred_addr != addr and what == "insert_account":
                sp["accounts"].insert(addr, self._read_gm(
                    "ACCOUNTS_LINKED_LIST_NEXT_AVAILABLE"))
            return pred_ptr // ASZ
        if what == "remove_account":
            addr = self.peek(0)
            pred = sp["accounts"].pred_lt(addr)
            _, ptr = pred if pred else (
                U256_MAX, scaled(Segment.AccountsLinkedList))
            sp["accounts"].remove(addr)
            return ptr // ASZ
        base = scaled(Segment.StorageLinkedList)
        if what in ("insert_slot", "search_slot"):
            addr, key = self.peek(0), self.peek(1)
            pred = sp["storage"].pred_le((addr, key))
            (pa, pk), pred_ptr = pred if pred else ((U256_MAX, 0), base)
            if (pa != addr or pk != key) and what == "insert_slot":
                sp["storage"].insert((addr, key), self._read_gm(
                    "STORAGE_LINKED_LIST_NEXT_AVAILABLE"))
            return (pred_ptr - base) // SSZ
        if what == "remove_slot":
            addr, key = self.peek(0), self.peek(1)
            pred = sp["storage"].pred_lt((addr, key))
            _, ptr = pred if pred else ((U256_MAX, 0), base)
            sp["storage"].remove((addr, key))
            return (ptr - base) // SSZ
        if what == "remove_address_slots":
            addr = self.peek(0)
            pred = sp["storage"].pred_lt((addr, 0))
            _, ptr = pred if pred else ((U256_MAX, 0), base)
            return (ptr - base) // SSZ
        raise KernelPanic(f"linked_list::{what}")


def trie_root_hash(t) -> bytes:
    """Root hash across raw Tries (.root_hash) and decoder wrappers
    (TransactionTrie/ReceiptTrie expose .root())."""
    return t.root_hash() if hasattr(t, "root_hash") else t.root()


class _TrieInputsView:
    """Adapter: decoder TrieInputs (state/storage/transactions/receipts)
    -> the field names mpt_load expects."""

    def __init__(self, tries):
        def unwrap(t):
            # decoder wraps txn/receipt tries (world.TransactionTrie);
            # mpt_load wants the raw node trie
            return t.trie if hasattr(t, "trie") else t
        self.state_trie = unwrap(tries.state)
        self.transactions_trie = unwrap(tries.transactions)
        self.receipts_trie = unwrap(tries.receipts)
        st = tries.storage
        self.storage_tries = list(st.items()) if isinstance(st, dict) \
            else list(st)


def _unpack_addr(addr):
    """(context, segment, virtual) from a packed kernel address word."""
    return addr >> 64, (addr >> 32) & 0xFFFFFFFF, addr & 0xFFFFFFFF


def _fake_exponential(factor, numerator, denominator):
    """EIP-4844 fake_exponential (prover_input.rs fake_exponential)."""
    i = 1
    output = 0
    acc = factor * denominator
    while acc > 0:
        output += acc
        acc = acc * numerator // (denominator * i)
        i += 1
    return output // denominator


def _closest_opcode_address(code: bytes, address: int) -> int:
    """Largest opcode (non-push-arg) position <= address
    (prover_input.rs:892-897)."""
    prev = 0
    i = 0
    while i < len(code) and i <= address:
        prev = i
        b = code[i]
        i += 1 + (b - 0x5F if 0x60 <= b <= 0x7F else 0)
    return prev


def _proofs_and_jumpdests(code: bytes, largest: int,
                          jumpdests: list[int]) -> list[int]:
    """[proof0, addr0, proof1, addr1, ...] ascending
    (prover_input.rs:858-889)."""
    jumpset = set(jumpdests)
    proofs = []
    last_proof = 0
    i = 0
    while i < len(code) and i <= largest:
        addr = i
        has_prefix = False
        if addr >= 32:
            has_prefix = all(
                byte > 0x7F or byte < 0x60 + k
                for byte, k in zip(code[addr - 32:addr][::-1], range(32)))
        if has_prefix:
            last_proof = addr - 32
        if addr in jumpset:
            proofs.append(last_proof)
            proofs.append(addr)
        b = code[i]
        i += 1 + (b - 0x5F if 0x60 <= b <= 0x7F else 0)
    return proofs


def run_kernel(kernel: Kernel, label: str, initial_stack):
    """Run a kernel routine: initial_stack is bottom-first, typically
    [0xDEADBEEF(retdest), ...args]. Returns the interpreter."""
    interp = Interpreter(kernel, kernel.global_labels[label])
    for v in initial_stack:
        interp.push(v)
    # RlpRaw[0] = 0x80, as the reference's test interpreter presets it
    # (interpreter.rs:499-503) — routine tests may read it unwritten
    interp.memory.set(0, Segment.RlpRaw, 0, 0x80)
    return interp.run()


def initial_registers(kernel: Kernel) -> Registers:
    """RegistersState::new(): pc=main, kernel mode (state.rs)."""
    return Registers(program_counter=kernel.global_labels["main"],
                     is_kernel=True)


def run_generation(kernel: Kernel, inputs, max_cycles=MAX_CYCLES):
    """Full witness run: initialize from GenerationInputs and execute
    init -> main -> ... -> halt -> exc_stop -> halt_final
    (the reference's simulate_cpu path, generation/mod.rs:640-668). A
    failing run writes a debug bundle (`debug.dump_error_artifacts`) and
    names it in a note on the exception."""
    interp = Interpreter(kernel, kernel.global_labels["init"],
                         max_cycles=max_cycles)
    interp.initialize_from_inputs(inputs)
    try:
        interp.run_segment(initial_registers(kernel))
    except Exception as err:
        from .debug import dump_error_artifacts
        err.add_note("witness debug artifacts: "
                     + dump_error_artifacts(interp, err))
        raise
    return interp
