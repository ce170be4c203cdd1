"""ctypes bridge to the native kernel-interpreter core (native/zvm.cpp).

The C++ core owns the sparse memory state, registers, per-step trace and
coprocessor logs, and executes every hot opcode; it yields back to python
for the cold paths — PROVER_INPUT oracles, jumpdest-analysis bit setting,
contract-code observation, the final-exception epilogue — which run the
EXISTING Interpreter methods against proxy objects. Equality with the
pure-python interpreter is asserted step-for-step in tests/test_zvm.py.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import native
from ..tables.arithmetic import ARITH_KINDS
from ..tables.segments import Segment

U64 = ctypes.c_uint64
I64 = ctypes.c_int64
U8P = ctypes.POINTER(ctypes.c_uint8)

# yield reasons (zvm.cpp)
Y_HALTED, Y_FINAL, Y_PROVER_INPUT, Y_OBSERVE_CONTRACT, Y_JD_ANALYSIS, \
    Y_MAX_CYCLES, Y_ERROR = range(7)

# error codes (zvm.cpp)
E_PC_OOB, E_KERNEL_EXC, E_PANIC, E_EXIT_GAS, E_KERNEL_EXC_TRAP, \
    E_BIG_CTX, E_BIG_LEN = range(1, 8)

ARITH_ID = {k: i for i, k in enumerate(ARITH_KINDS)}
LOGIC_OPS = ["and", "or", "xor"]
LOGIC_ID = {k: i for i, k in enumerate(LOGIC_OPS)}

_lib = None


def available() -> bool:
    return _load() is not None


def _load():
    global _lib
    if _lib is not None:
        return _lib or None
    lib = native.lib_handle()
    if not lib:
        _lib = False
        return None
    h = ctypes.c_void_p
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
    lib.zvm_mem_new.restype = h
    lib.zvm_mem_free.argtypes = [h]
    lib.zvm_mem_clone.restype = h
    lib.zvm_mem_clone.argtypes = [h]
    lib.zvm_mem_get.argtypes = [h, U64, U64, U64, u64p]
    lib.zvm_mem_is_set.restype = ctypes.c_int
    lib.zvm_mem_is_set.argtypes = [h, U64, U64, U64]
    lib.zvm_mem_set.argtypes = [h, U64, U64, U64, u64p]
    lib.zvm_mem_set_range.argtypes = [h, U64, U64, U64, u64p, U64]
    lib.zvm_mem_read_bytes.argtypes = [h, U64, U64, U64, U64, u8p]
    lib.zvm_mem_set_range4.argtypes = [h, U64, U64, U64, u64p, U64]
    lib.zvm_mem_preinit.argtypes = [h, U64, u64p, U64]
    lib.zvm_mem_preinit_len.restype = U64
    lib.zvm_mem_preinit_len.argtypes = [h, U64]
    lib.zvm_mem_has_preinit.restype = ctypes.c_int
    lib.zvm_mem_has_preinit.argtypes = [h, U64]
    lib.zvm_mem_preinit_get.argtypes = [h, U64, u64p, U64]
    lib.zvm_mem_len.restype = U64
    lib.zvm_mem_len.argtypes = [h]
    lib.zvm_mem_dump.argtypes = [h, u64p, u64p]
    lib.zvm_mem_max_virt.restype = I64
    lib.zvm_mem_max_virt.argtypes = [h, U64, U64]
    lib.zvm_mem_delete_context.argtypes = [h, U64]
    lib.zvm_mem_seg_len.restype = U64
    lib.zvm_mem_seg_len.argtypes = [h, U64, U64]
    lib.zvm_mem_seg_dump.argtypes = [h, U64, U64, u64p, u64p]

    lib.zvm_new.restype = h
    lib.zvm_new.argtypes = [h, u8p, U64, u64p, u64p, U64, U64, u8p, i8p,
                            u8p, u64p, I64, I64, I64, U64]
    lib.zvm_free.argtypes = [h]
    lib.zvm_set_mem.argtypes = [h, h]
    lib.zvm_set_flags.argtypes = [h, ctypes.c_uint8, ctypes.c_uint8,
                                  ctypes.c_uint8, I64, I64]
    lib.zvm_set_halt.argtypes = [h, I64, u64p, U64]
    lib.zvm_set_regs.argtypes = [h, U64, ctypes.c_uint8, U64, U64, U64,
                                 U64]
    lib.zvm_get_regs.argtypes = [h, u64p]
    lib.zvm_reset_iters.argtypes = [h]
    lib.zvm_run.restype = ctypes.c_int
    lib.zvm_run.argtypes = [h]
    lib.zvm_set_final_done.argtypes = [h]
    lib.zvm_last_dst.restype = U64
    lib.zvm_last_dst.argtypes = [h]
    lib.zvm_error_info.argtypes = [h, i64p]
    lib.zvm_record_arith.argtypes = [h, ctypes.c_uint8, u64p, u64p, u64p,
                                     ctypes.c_uint8, u64p, ctypes.c_uint8]
    lib.zvm_record_bp.argtypes = [h, ctypes.c_uint8, U64, U64, U64,
                                  ctypes.c_char_p, U64]
    lib.zvm_record_entry.argtypes = [h, U64, ctypes.c_uint8,
                                     ctypes.c_uint8, ctypes.c_uint8]
    for f in ("zvm_trace_len", "zvm_arith_len", "zvm_logic_len",
              "zvm_sponge_len", "zvm_sponge_bytes_len", "zvm_bp_len",
              "zvm_bp_bytes_len", "zvm_stale_len", "zvm_jd_len"):
        getattr(lib, f).restype = U64
        getattr(lib, f).argtypes = [h]
    lib.zvm_export_trace.argtypes = [h, u64p, u64p]
    lib.zvm_export_arith.argtypes = [h, u64p]
    lib.zvm_export_logic.argtypes = [h, u64p]
    lib.zvm_export_sponge.argtypes = [h, u64p, u8p]
    lib.zvm_export_bp.argtypes = [h, u64p, u8p]
    lib.zvm_export_stale.argtypes = [h, u64p]
    lib.zvm_export_jd.argtypes = [h, u64p]
    _lib = lib
    return lib


def _limbs(v: int) -> np.ndarray:
    return np.array([(v >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
                     for i in range(4)], dtype=np.uint64)


def _unlimb(w) -> int:
    return int(w[0]) | (int(w[1]) << 64) | (int(w[2]) << 128) \
        | (int(w[3]) << 192)


def _unlimb_list(w) -> int:
    """4 python-int limbs -> int, with a fast path for u64 values (the
    overwhelming majority of stack/log entries)."""
    if w[1] == 0 and w[2] == 0 and w[3] == 0:
        return w[0]
    return w[0] | (w[1] << 64) | (w[2] << 128) | (w[3] << 192)


class NativeMemory:
    """MemoryState-compatible sparse store backed by a zvm_mem handle
    (witness/memory.rs semantics; python twin in interpreter.py)."""

    def __init__(self, handle=None):
        self._lib = _load()
        self._h = handle if handle is not None else self._lib.zvm_mem_new()
        self._buf4 = np.zeros(4, dtype=np.uint64)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.zvm_mem_free(h)
            self._h = None

    def get(self, ctx, seg, virt):
        self._lib.zvm_mem_get(self._h, ctx, int(seg), virt, self._buf4)
        return _unlimb(self._buf4)

    def is_set(self, ctx, seg, virt) -> bool:
        return bool(self._lib.zvm_mem_is_set(self._h, ctx, int(seg), virt))

    def set(self, ctx, seg, virt, value):
        value &= (1 << 256) - 1
        self._lib.zvm_mem_set(self._h, ctx, int(seg), virt,
                              _limbs(value))

    def set_range_u64(self, ctx, seg, virt0, values: np.ndarray):
        values = np.ascontiguousarray(values, dtype=np.uint64)
        self._lib.zvm_mem_set_range(self._h, ctx, int(seg), virt0,
                                    values, len(values))

    def set_range_u256(self, ctx, seg, virt0, limbs: np.ndarray):
        limbs = np.ascontiguousarray(limbs, dtype=np.uint64)
        self._lib.zvm_mem_set_range4(self._h, ctx, int(seg), virt0,
                                     limbs, limbs.shape[0])

    def read_bytes(self, ctx, seg, virt, n):
        if n == 0:
            return b""
        out = np.empty(n, dtype=np.uint8)
        self._lib.zvm_mem_read_bytes(self._h, ctx, int(seg), virt, n, out)
        return out.tobytes()

    def set_bytes(self, ctx, seg, virt0, data: bytes):
        if not data:
            return
        self.set_range_u64(ctx, seg, virt0,
                           np.frombuffer(data, np.uint8).astype(np.uint64))

    def insert_preinitialized_segment(self, seg, content):
        vals = list(content)
        limbs = _values_to_limbs(vals)
        self._lib.zvm_mem_preinit(self._h, int(seg), limbs, len(vals))

    def is_preinitialized_segment(self, seg) -> bool:
        return bool(self._lib.zvm_mem_has_preinit(self._h, int(seg)))

    def preinit_len(self, seg) -> int:
        return int(self._lib.zvm_mem_preinit_len(self._h, int(seg)))

    def max_virt(self, ctx, seg) -> int:
        """Largest set virtual in (ctx, seg), or -1."""
        return int(self._lib.zvm_mem_max_virt(self._h, ctx, int(seg)))

    def delete_context(self, ctx) -> None:
        self._lib.zvm_mem_delete_context(self._h, ctx)

    def _seg_items(self, ctx, seg):
        n = int(self._lib.zvm_mem_seg_len(self._h, ctx, int(seg)))
        virts = np.zeros(n, dtype=np.uint64)
        vals = np.zeros((n, 4), dtype=np.uint64)
        if n:
            self._lib.zvm_mem_seg_dump(self._h, ctx, int(seg), virts, vals)
        return [(v, _unlimb_list(val4))
                for v, val4 in zip(virts.tolist(), vals.tolist())]

    def segment_dict(self, ctx, seg) -> dict:
        return dict(self._seg_items(ctx, seg))

    def preinit_view(self, seg) -> list[int]:
        """Merged preinit + context-0 content (read-only)."""
        n_pre = self.preinit_len(seg)
        pre = np.zeros((n_pre, 4), dtype=np.uint64)
        if n_pre:
            self._lib.zvm_mem_preinit_get(self._h, int(seg), pre, n_pre)
        d = self._seg_items(0, seg)
        length = max(n_pre, max((v for v, _ in d), default=-1) + 1)
        out = [_unlimb(pre[i]) if i < n_pre else 0 for i in range(length)]
        for v, val in d:
            out[v] = val
        return out

    def _dump(self):
        n = int(self._lib.zvm_mem_len(self._h))
        keys = np.zeros((n, 3), dtype=np.uint64)
        vals = np.zeros((n, 4), dtype=np.uint64)
        if n:
            self._lib.zvm_mem_dump(self._h, keys, vals)
        return keys, vals

    def _preinit_segs(self):
        from ..tables.segments import NUM_SEGMENTS
        return [s for s in range(NUM_SEGMENTS)
                if self.is_preinitialized_segment(s)]

    def snapshot_all(self):
        """Exactly MemoryState.snapshot_all (interpreter.py)."""
        out = []
        for seg in sorted(self._preinit_segs()):
            for v_i, val in enumerate(self.preinit_view(seg)):
                out.append(((0, seg, v_i), val))
        pre = set(self._preinit_segs())
        keys, vals = self._dump()
        unlimb = _unlimb_list
        for key, val4 in zip(keys.tolist(), vals.tolist()):
            ctx, seg, virt = key
            if ctx == 0 and seg in pre:
                continue
            val = unlimb(val4)
            if val:
                out.append(((ctx, seg, virt), val))
        return out

    def active_values(self, stale_contexts=()):
        from ..tables.segments import PREINITIALIZED_SEGMENTS
        stale = set(stale_contexts)
        keys, vals = self._dump()
        pre = set(PREINITIALIZED_SEGMENTS)
        unlimb = _unlimb_list
        out = []
        for key, val4 in zip(keys.tolist(), vals.tolist()):
            ctx, seg, virt = key
            if ctx in stale:
                continue
            val = unlimb(val4)
            if val or seg in pre:
                out.append(((ctx, seg, virt), val))
        return out

    def deep_copy(self) -> "NativeMemory":
        return NativeMemory(self._lib.zvm_mem_clone(self._h))


def _values_to_limbs(vals) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype=np.uint64).reshape(len(vals), 4).copy()


def make_memory():
    """NativeMemory when the host library is built, MemoryState
    otherwise."""
    if available():
        return NativeMemory()
    from .interpreter import MemoryState
    return MemoryState()


class _StackView:
    """Stack-before snapshot of one trace entry: full length, values for
    the top 17 positions (all the CPU table's witness filler reads —
    DUP16/SWAP16 reach depth 17, tables/cpu.py _fill_stack_witness)."""

    __slots__ = ("_len", "_top")

    def __init__(self, length: int, top: list[int]):
        self._len = length
        self._top = top  # last min(len, 17) values, bottom-first

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(self._len))]
        if i < 0:
            i += self._len
        if i < 0 or i >= self._len:
            raise IndexError(i)
        k = i - (self._len - len(self._top))
        if k < 0:
            raise IndexError(
                f"stack depth {self._len - i} exceeds the recorded "
                f"top-{len(self._top)} native snapshot")
        return self._top[k]

    def __iter__(self):
        if self._len > len(self._top):
            raise IndexError("full iteration of a truncated native "
                             "stack snapshot")
        return iter(self._top)

    def __eq__(self, other):
        try:
            if len(other) != self._len:
                return False
            return all(self[-1 - k] == other[-1 - k]
                       for k in range(min(self._len, len(self._top))))
        except (TypeError, IndexError):
            return NotImplemented


class ZvmHandle:
    """One native core bound to an Interpreter (config mirrors its
    kernel + run-mode fields)."""

    def __init__(self, interp):
        from .interpreter import SYSCALLS, BN_BASE, _ctxm
        self._lib = lib = _load()
        kernel = interp.kernel
        gl = kernel.global_labels
        code = np.frombuffer(bytes(kernel.code), dtype=np.uint8)
        seg_ids = np.array([int(Segment.Stack), int(Segment.Code),
                            int(Segment.ContextMetadata),
                            int(Segment.JumpdestBits)], dtype=np.uint64)
        ctxm_ids = np.array([_ctxm("GAS_LIMIT"), _ctxm("STACK_SIZE")],
                            dtype=np.uint64)
        sys_nread = np.zeros(256, dtype=np.uint8)
        sys_flag = np.full(256, -1, dtype=np.int8)
        for op, (n_read, grows) in SYSCALLS.items():
            sys_nread[op] = n_read
            sys_flag[op] = 1 if grows else 0
        gas_tab = np.zeros(256, dtype=np.uint8)
        for op, g in interp._GAS.items():
            gas_tab[op] = g
        self._h = lib.zvm_new(
            interp.memory._h, code, len(code), seg_ids, ctxm_ids,
            gl.get("syscall_jumptable", 0),
            gl.get("exception_jumptable", 0),
            sys_nread, sys_flag, gas_tab, _limbs(BN_BASE),
            gl.get("jumpdest_analysis", -1),
            gl.get("observe_new_address", -1),
            gl.get("observe_new_contract", -1),
            interp.max_cycles)
        self._buf4 = np.zeros(4, dtype=np.uint64)
        self._buf6 = np.zeros(6, dtype=np.uint64)
        self._stale_seen = 0
        self._jd_seen = 0

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.zvm_free(h)
            self._h = None

    # -- run control -------------------------------------------------------
    def sync_config(self, interp):
        """Mode/halt config: once per run() entry (python may retarget
        halt labels between runs, never mid-run)."""
        self._lib.zvm_set_mem(self._h, interp.memory._h)
        self._lib.zvm_set_flags(
            self._h, interp.is_jumpdest_analysis,
            interp.record_trace, interp._final_exception_done,
            -1 if interp.halt_context is None else interp.halt_context,
            -1 if interp.cycle_limit is None else interp.cycle_limit)
        halt_offsets = np.array(sorted(interp.halt_offsets),
                                dtype=np.uint64)
        self._lib.zvm_set_halt(
            self._h,
            -1 if interp.halt_label is None else interp.halt_label,
            halt_offsets, len(halt_offsets))

    def sync_in(self, interp):
        r = interp.registers
        self._lib.zvm_set_regs(self._h, r.program_counter,
                               int(r.is_kernel), r.context, r.stack_len,
                               r.gas_used, interp.clock)

    def sync_out(self, interp):
        out = self._buf6
        self._lib.zvm_get_regs(self._h, out)
        r = interp.registers
        r.program_counter = int(out[0])
        r.is_kernel = bool(out[1])
        r.context = int(out[2])
        r.stack_len = int(out[3])
        r.gas_used = int(out[4])
        interp.clock = int(out[5])

    def run(self) -> int:
        return int(self._lib.zvm_run(self._h))

    def reset_iters(self):
        self._lib.zvm_reset_iters(self._h)

    def set_final_done(self):
        self._lib.zvm_set_final_done(self._h)

    def error_info(self):
        out = np.zeros(3, dtype=np.int64)
        self._lib.zvm_error_info(self._h, out)
        return int(out[0]), int(out[1]), int(out[2])

    # -- recording hooks (python yield handlers) ----------------------------
    def record_arith(self, kind, in0, in1, in2, opcode, result):
        self._lib.zvm_record_arith(
            self._h, ARITH_ID[kind], _limbs(in0), _limbs(in1),
            _limbs(in2), opcode,
            _limbs(result if result is not None else 0),
            result is not None)

    def record_logic(self, op, in0, in1):
        raise NotImplementedError  # never recorded from python yields

    def record_bp(self, is_read, ctx, seg, virt, data: bytes):
        if data:
            self._lib.zvm_record_bp(self._h, is_read, ctx, int(seg),
                                    virt, bytes(data), len(data))

    def record_entry(self, pc, op, kind, exc):
        self._lib.zvm_record_entry(self._h, pc, op, kind, exc)

    def trace_len(self) -> int:
        return int(self._lib.zvm_trace_len(self._h))

    # -- exports -------------------------------------------------------------
    def export_trace(self) -> list:
        n = self.trace_len()
        meta = np.zeros((n, 5), dtype=np.uint64)
        tops = np.zeros((n, 17, 4), dtype=np.uint64)
        if n:
            self._lib.zvm_export_trace(self._h, meta, tops)
        ml = meta.tolist()        # python ints in one C pass
        tl = tops.tolist()
        out = []
        kinds = (None, "syscall")
        unlimb = _unlimb_list
        for i in range(n):
            pc, pk, ctx, gas, sl = ml[i]
            kind = ("exception", (pk >> 24) & 0xFF) \
                if (pk >> 16) & 0xFF == 2 else kinds[(pk >> 16) & 0xFF]
            k = sl if sl < 17 else 17
            row = tl[i]
            top = [unlimb(row[17 - k + j]) for j in range(k)]
            stack = tuple(top) if sl <= 17 else _StackView(sl, top)
            out.append([pc, pk & 0xFF, bool((pk >> 8) & 1), ctx,
                        stack, gas, kind])
        return out

    def export_arith_raw(self) -> np.ndarray:
        """(n, 20) uint64 [step, kind, opcode, has_result, in0[4],
        in1[4], in2[4], res[4]] — consumed directly by the vectorized
        arithmetic table generator."""
        n = int(self._lib.zvm_arith_len(self._h))
        a = np.zeros((n, 20), dtype=np.uint64)
        if n:
            self._lib.zvm_export_arith(self._h, a)
        return a

    def export_arith(self) -> list:
        a = self.export_arith_raw()
        al = a.tolist()
        out = []
        unlimb = _unlimb_list
        for row in al:
            res = unlimb(row[16:20]) if row[3] else None
            out.append((row[0],
                        (ARITH_KINDS[row[1]], unlimb(row[4:8]),
                         unlimb(row[8:12]), unlimb(row[12:16]),
                         row[2], res)))
        return out

    def export_logic(self) -> list:
        n = int(self._lib.zvm_logic_len(self._h))
        a = np.zeros((n, 10), dtype=np.uint64)
        if n:
            self._lib.zvm_export_logic(self._h, a)
        al = a.tolist()
        unlimb = _unlimb_list
        return [(row[0], (LOGIC_OPS[row[1]], unlimb(row[2:6]),
                          unlimb(row[6:10]))) for row in al]

    def _export_bytes(self, kind: str) -> list:
        n = int(getattr(self._lib, f"zvm_{kind}_len")(self._h))
        nb = int(getattr(self._lib, f"zvm_{kind}_bytes_len")(self._h))
        recs = np.zeros((n, 7), dtype=np.uint64)
        data = np.zeros(max(nb, 1), dtype=np.uint8)
        if n:
            getattr(self._lib, f"zvm_export_{kind}")(self._h, recs, data)
        blob = data.tobytes()
        out = []
        for i in range(n):
            step, is_read, ctx, seg, virt, off, ln = (int(x)
                                                      for x in recs[i])
            payload = blob[off:off + ln]
            if kind == "sponge":
                out.append((step, (ctx, seg, virt), payload))
            else:
                out.append((step, bool(is_read), (ctx, seg, virt),
                            payload))
        return out

    def export_sponge(self) -> list:
        return self._export_bytes("sponge")

    def export_bp(self) -> list:
        return self._export_bytes("bp")

    def export_new_stale(self) -> list[int]:
        n = int(self._lib.zvm_stale_len(self._h))
        out = np.zeros(max(n, 1), dtype=np.uint64)
        if n:
            self._lib.zvm_export_stale(self._h, out)
        new = [int(v) for v in out[self._stale_seen:n]]
        self._stale_seen = n
        return new

    def export_new_jumpdests(self) -> list[tuple[int, int]]:
        n = int(self._lib.zvm_jd_len(self._h))
        out = np.zeros(max(n, 1), dtype=np.uint64)
        if n:
            self._lib.zvm_export_jd(self._h, out)
        pairs = [(int(out[i]), int(out[i + 1]))
                 for i in range(self._jd_seen, n, 2)]
        self._jd_seen = n
        return pairs


def run_native(interp):
    """Drive the interpreter through the native core (the python run()
    loop's exact twin; interpreter.py run())."""
    from dataclasses import replace
    from .interpreter import EXC_STOP, KernelPanic
    z = interp._nvm
    if z is None:
        z = interp._nvm = ZvmHandle(interp)
    z.reset_iters()
    z.sync_config(interp)
    lbl = interp.kernel.offset_label
    gl = interp.kernel.global_labels
    try:
        while True:
            z.sync_in(interp)
            reason = z.run()
            z.sync_out(interp)
            r = interp.registers
            if reason == Y_HALTED:
                return interp
            if reason == Y_FINAL:
                interp._final_registers = replace(r)
                interp._write_final_registers(interp._final_registers)
                interp._final_exception_done = True
                z.set_final_done()
                if interp.record_trace:
                    pc = r.program_counter
                    if r.is_kernel:
                        opc = interp.code[pc] if pc < len(interp.code) \
                            else 0
                    else:
                        opc = interp.memory.get(r.code_context(),
                                                Segment.Code, pc) & 0xFF
                    z.record_entry(pc, opc, 2, EXC_STOP)
                interp.exception(EXC_STOP)
                interp.clock += 1
            elif reason == Y_PROVER_INPUT:
                # pc already advanced past the 0xEE byte
                path = interp.kernel.prover_inputs.get(
                    r.program_counter - 1)
                old_top = interp._stack_top_or_zero()
                v = interp.prover_input(path)
                if interp.record_trace:
                    z.record_arith("range_check", old_top, 0, 0, 0xEE, v)
                interp.push(v)
                interp.clock += 1
            elif reason == Y_OBSERVE_CONTRACT:
                interp._observe_contract()
            elif reason == Y_JD_ANALYSIS:
                interp._set_jumpdest_bits_from_code()
                r.program_counter = gl["jumpdest_analysis_end"]
                interp.clock += 1
            elif reason == Y_MAX_CYCLES:
                raise RuntimeError("interpreter exceeded max_cycles")
            elif reason == Y_ERROR:
                code, pc, info = z.error_info()
                if code == E_PC_OOB:
                    raise KernelPanic(f"kernel pc {pc} out of code bounds")
                if code == E_KERNEL_EXC:
                    raise KernelPanic(
                        f"exc {info} in kernel at pc={pc} ({lbl(pc)})")
                if code == E_PANIC:
                    raise KernelPanic(
                        f"kernel PANIC at pc {pc} ({lbl(pc)})")
                if code == E_EXIT_GAS:
                    raise AssertionError("gas limit error on exit")
                if code == E_KERNEL_EXC_TRAP:
                    raise KernelPanic(f"exception {info} in kernel mode")
                raise KernelPanic(f"native interpreter error {code} at "
                                  f"pc {pc} ({lbl(pc)})")
            else:
                raise RuntimeError(f"unknown zvm yield {reason}")
    finally:
        _export_state(interp, z)
    return interp


class LazyTrace:
    """Sequence view over the native per-step trace: len() costs nothing
    (the CPU-table rows are built natively off the same buffers, so most
    runs never touch the python-object form); iteration/indexing
    materializes once via export_trace."""

    def __init__(self, z):
        self._z = z
        self._n = z.trace_len()
        self._rows = None

    def _mat(self):
        if self._rows is None:
            self._rows = self._z.export_trace()
        return self._rows

    def __len__(self):
        return self._n

    def __bool__(self):
        return self._n > 0

    def __iter__(self):
        return iter(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]


def _export_state(interp, z):
    """Materialize the C++ trace/logs into the Interpreter's python
    fields (same formats the pure-python run produces). The per-step
    trace stays lazy — the native CPU-row generator reads the C++ buffers
    directly and the python-object export costs ~20 us/cycle."""
    if interp.record_trace or z.trace_len():
        interp.trace = LazyTrace(z)
        interp.arith_raw = z.export_arith_raw()
        interp.arith_log = z.export_arith()
        interp.logic_log = z.export_logic()
        interp.sponge_log = z.export_sponge()
        interp.bp_log = z.export_bp()
    interp.stale_contexts.extend(z.export_new_stale())
    for ctx, dst in z.export_new_jumpdests():
        interp.jumpdest_collected.setdefault(ctx, set()).add(dst)


# ---------------------------------------------------------------------------
# Native CPU-table rows (tables/cpu.py build_cpu_rows twin driven
# straight off the zvm trace buffers)
# ---------------------------------------------------------------------------

_CPU_TABLES = None


def _cpu_tables():
    global _CPU_TABLES
    if _CPU_TABLES is not None:
        return _CPU_TABLES
    from ..tables import cpu as cputab
    from ..tables import cpu_columns as cc
    flag_id = {name: i for i, name in enumerate(cc.OP_NAMES)}
    idx = np.array([
        cc.CONTEXT, cc.CODE_CONTEXT, cc.PROGRAM_COUNTER, cc.STACK_LEN,
        cc.IS_KERNEL_MODE, cc.GAS, cc.OP_START, cc.N_OP_FLAGS,
        cc.OPCODE_BITS[0], cc.GENERAL[0], cc.CLOCK,
        cc.MEM_CHANNELS[0].used, cc.MEM_CHANNELS[1].used,
        cc.MEM_CHANNELS[2].used, cc.PARTIAL_CHANNEL.used,
        cc.NUM_CPU_COLUMNS, cputab.STACK_SEGMENT,
        cputab.SHIFT_TABLE_SEGMENT, cputab.JUMPDEST_BITS_SEGMENT,
        cc.MAX_USER_STACK_SIZE], dtype=np.int32)
    flag_table = np.full(512, -1, dtype=np.int8)
    for kernel in (0, 1):
        for op in range(256):
            f = cputab.flag_for(op, bool(kernel))
            if f is not None:
                flag_table[kernel * 256 + op] = flag_id[f]
    n_flags = len(cc.OP_NAMES)
    beh_pops = np.zeros(n_flags, dtype=np.int8)
    beh_push = np.zeros(n_flags, dtype=np.int8)
    beh_has = np.zeros(n_flags, dtype=np.int8)
    for name, (pops, pushes, _) in cputab.STACK_BEHAVIORS.items():
        i = flag_id[name]
        beh_pops[i], beh_push[i], beh_has[i] = pops, pushes, 1
    might = np.zeros(n_flags, dtype=np.int8)
    for name in cputab.MIGHT_OVERFLOW:
        might[flag_id[name]] = 1
    from ..tables.arithmetic import BN_BASE
    bn = np.array([(BN_BASE >> (32 * j)) & 0xFFFFFFFF for j in range(8)],
                  dtype=np.uint64)
    lib = _load()
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
    lib.zvm_cpu_rows.restype = I64
    lib.zvm_cpu_rows.argtypes = [
        ctypes.c_void_p, u64p, U64, i32p, i8p, i8p, i8p, i8p, i8p,
        U64, U64, U64, U64, U64, U64, u64p]
    _CPU_TABLES = (idx, flag_table, beh_pops, beh_push, beh_has, might,
                   bn)
    return _CPU_TABLES


def cpu_rows_native(interp, n_rows=None) -> np.ndarray:
    """build_cpu_rows computed inside the native core (no python trace
    materialization). Same output contract as
    tables/cpu.py cpu_rows_from_run's matrix."""
    from ..tables import cpu_columns as cc
    idx, flag_table, beh_pops, beh_push, beh_has, might, bn = \
        _cpu_tables()
    z = interp._nvm
    n_ops = z.trace_len()
    n = max(n_ops, 2)
    if n_rows is None:
        n_rows = 1 << max(1, n.bit_length())
        if n_rows < n + 1:
            n_rows <<= 1
    gl = interp.kernel.global_labels
    r = interp.registers
    m = np.zeros((cc.NUM_CPU_COLUMNS, n_rows), dtype=np.uint64)
    rc = z._lib.zvm_cpu_rows(
        z._h, m, n_rows, idx, flag_table, beh_pops, beh_push, beh_has,
        might, r.program_counter, r.gas_used, r.context, r.stack_len,
        gl.get("syscall_jumptable", 0), gl.get("exception_jumptable", 0),
        bn)
    if rc == -2:
        raise ValueError(f"trace ({n_ops} rows) exceeds n_rows={n_rows}")
    if rc != 0:
        step = int(rc) - 1
        raise ValueError(
            f"executed opcode at step {step} has no decode flag")
    return m
