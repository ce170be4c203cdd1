"""ctypes bindings for the native host library (the repository's native/
zkhost.cpp, tapecore.cpp and zvm.cpp): host hashing, the batch inverse,
the Poseidon table's witness and the verifier VM's tape core.

The JAX package's loader runs `make -C native`; this one compiles the
same sources with g++, at first use, into `build/native/` at the root of
the checkout and never writes into `native/`. The library's file name
carries a hash of the sources and the flags, so an edited source
rebuilds. The flags name no `-march`, so a library built on one host runs
on another. `keccak256`, `gl_batch_inv` and `poseidon_permute_many` have
pure-python twins, so the package works without a toolchain; `require()`
raises instead, for callers that must not fall back (the CLI, whose
wall-clock would otherwise change by large factors unannounced).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "native"
SOURCES = ("zkhost.cpp", "tapecore.cpp", "zvm.cpp")
HEADERS = ("gl.h", "u256.h")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_lib = None
_load_error: Exception | None = None


def library_path() -> Path:
    blob = b"".join((NATIVE_DIR / f).read_bytes()
                    for f in SOURCES + HEADERS)
    tag = hashlib.sha256(blob + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libzkhost_{tag[:16]}.so"


def build() -> Path:
    """Compile the library if it is missing; raise if g++ fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
         *(str(NATIVE_DIR / f) for f in SOURCES)],
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on native/:\n{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib, _load_error
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
        lib.keccak256.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                  ctypes.c_char_p]
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C")
        lib.gl_batch_inv.argtypes = [u64p, u64p, ctypes.c_uint64]
        lib.poseidon_permute_many.argtypes = [
            u64p, u64p, u64p, ctypes.c_uint64, ctypes.c_uint64,
            u64p, ctypes.c_uint64]
        lib.poseidon_witness_batch.argtypes = [
            u64p, u64p, u64p, ctypes.c_uint64, ctypes.c_uint64,
            u64p, ctypes.c_uint64, u64p, u64p, u64p, u64p]
        _bind_tape(lib, u64p)
        _lib = lib
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _lib, _load_error = False, e
    return _lib


def _bind_tape(lib, u64p) -> None:
    """The tape core's entry points (recursion/vm.py NativeTape)."""
    h = ctypes.c_void_p
    i64, u64 = ctypes.c_int64, ctypes.c_uint64
    lib.tape_new.restype = h
    lib.tape_new.argtypes = [u64, u64p, u64, u64p, u64p, u64, u64]
    lib.tape_free.argtypes = [h]
    for f in ("tape_load", "tape_const"):
        getattr(lib, f).restype = i64
        getattr(lib, f).argtypes = [h, u64]
    lib.tape_arith.restype = i64
    lib.tape_arith.argtypes = [h, i64, i64, i64, u64, u64, u64]
    lib.tape_sel.restype = i64
    lib.tape_sel.argtypes = [h, i64, i64, i64]
    lib.tape_assert_eq.restype = i64
    lib.tape_assert_eq.argtypes = [h, i64, i64]
    lib.tape_pose.restype = i64
    lib.tape_pose.argtypes = [h, ctypes.POINTER(i64)]
    lib.tape_bind_public.restype = i64
    lib.tape_bind_public.argtypes = [h, i64, u64]
    lib.tape_value.restype = u64
    lib.tape_value.argtypes = [h, i64]
    for f in ("tape_n_rows", "tape_n_alloc", "tape_n_pose"):
        getattr(lib, f).restype = u64
        getattr(lib, f).argtypes = [h]
    lib.tape_get_publics.restype = u64
    lib.tape_get_publics.argtypes = [h, u64p]
    lib.tape_export_trace.argtypes = [h, u64, u64, u64p, u64]
    lib.tape_count_pose.restype = u64
    lib.tape_count_pose.argtypes = [h, u64, u64]
    lib.tape_export_pose.argtypes = [h, u64, u64, u64p]
    lib.tape_live_at.restype = u64
    lib.tape_live_at.argtypes = [h, i64, ctypes.c_void_p, ctypes.c_void_p]
    lib.tape_count_ops.restype = u64
    lib.tape_count_ops.argtypes = [h, u64, u64]
    lib.tape_export_ops.argtypes = [h, u64, u64, u64p]
    lib.tape_ram_size.restype = u64
    lib.tape_ram_size.argtypes = [h, u64, u64, u64p, u64, u64]
    lib.tape_ram_fill.restype = u64
    lib.tape_ram_fill.argtypes = [h, u64, u64, u64p, u64, u64,
                                  u64p, u64, u64p, u64]


def require():
    """Build and load the library, raising what failed instead of
    falling back to the python twins."""
    if not _load():
        raise RuntimeError("the native host library (native/*.cpp) did "
                           "not build or load") from _load_error
    return _lib


def available() -> bool:
    return bool(_load())


def lib_handle():
    """The raw ctypes library (None when unavailable) — for callers that
    hold a native-side handle (witness/native_vm.py)."""
    lib = _load()
    return lib if lib else None


def keccak256(data: bytes) -> bytes:
    lib = _load()
    if not lib:
        from .tables.keccak_sponge import keccak256 as py_keccak256
        return py_keccak256(data)
    out = ctypes.create_string_buffer(32)
    lib.keccak256(data, len(data), out)
    return out.raw


def gl_batch_inv(a: np.ndarray) -> np.ndarray:
    """Elementwise Goldilocks inverse (zeros map to zero) via the
    Montgomery batch trick; `np_field.inv` without the library."""
    a = np.ascontiguousarray(a, dtype=np.uint64)
    lib = _load()
    if not lib:
        from .field import np_field
        return np_field.inv(a)
    out = np.empty_like(a)
    lib.gl_batch_inv(a, out, len(a))
    return out


_POSEIDON_TABLES: dict = {}


def _poseidon_tables(params):
    """Flat (rc, circ, diag, half_full, n_partial) uint64 views of a
    PoseidonParams, cached per params object."""
    hit = _POSEIDON_TABLES.get(id(params))
    if hit is None:
        hit = (np.array(params.round_constants, dtype=np.uint64),
               np.array(params.mds_circ, dtype=np.uint64),
               np.array(params.mds_diag, dtype=np.uint64),
               params.half_full_rounds, params.n_partial_rounds)
        _POSEIDON_TABLES[id(params)] = hit
    return hit


def poseidon_permute_many(states: np.ndarray, params):
    """Batch Poseidon permutation over (n, 12) uint64 states (on a copy;
    returns the permuted array). None if the library is absent or the
    instance is not width-12 with x^7."""
    lib = _load()
    if not lib or params.width != 12 or params.sbox_exp != 7:
        return None
    rc, circ, diag, hf, npart = _poseidon_tables(params)
    states = np.array(states, dtype=np.uint64, order="C")
    lib.poseidon_permute_many(rc, circ, diag, hf, npart, states,
                              states.shape[0])
    return states


def poseidon_witness_batch(states: np.ndarray, params):
    """Per-permutation AIR witness: (round_states (n, n_rounds*12),
    cubes_full (n, 2*half_full*12), cubes_partial (n, n_partial),
    pinv (n, 4)). None when the library is absent."""
    lib = _load()
    if not lib or params.width != 12 or params.sbox_exp != 7:
        return None
    rc, circ, diag, hf, npart = _poseidon_tables(params)
    states = np.ascontiguousarray(states, dtype=np.uint64)
    n = states.shape[0]
    n_rounds = 2 * hf + npart
    rs = np.empty((n, n_rounds * 12), dtype=np.uint64)
    cf = np.empty((n, 2 * hf * 12), dtype=np.uint64)
    cp = np.empty((n, npart), dtype=np.uint64)
    pinv = np.empty((n, 4), dtype=np.uint64)
    lib.poseidon_witness_batch(rc, circ, diag, hf, npart, states, n,
                               rs, cf, cp, pinv)
    return rs, cf, cp, pinv
