"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source compiles with nvcc, at first use, into a shared library with a
plain C interface under `build/kernels/` at the root of the checkout, and
is loaded with ctypes. The library's file name carries a hash of the
source and the flags, so an edited `.cu` rebuilds and an unchanged one is
reused. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing, then load it."""
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        src = CSRC / f"{name}.cu"
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on csrc/{name}.cu:\n{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))
