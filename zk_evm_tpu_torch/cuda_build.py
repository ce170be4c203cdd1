"""Build and load the package's CUDA kernels (csrc/*.cu).

Each source compiles with nvcc, at first use, into a shared library with a
plain C interface under `build/kernels/` at the root of the checkout, and
is loaded with ctypes. The library's file name carries a hash of the
source, the shared headers (csrc/*.cuh) and the flags, so an edited
source rebuilds and an unchanged one is reused. `build_all` starts one
nvcc per source at once. ptxas's report of each kernel's registers,
shared memory and spills is kept beside its library (`ptxas_report`).
Nothing here runs at import time.

The kernels are used from several threads at once (`prove_all` with
`parallel_commits`): `FIRST_USE` serialises every first use (the build,
the load, a wrapper's constant upload to a device), and `count_launch`
keeps the wrappers' launch counts exact.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# held by every first use of a library; re-entrant, because a wrapper's
# constant upload loads its library under it
FIRST_USE = threading.RLock()
_COUNT_LOCK = threading.Lock()


def count_launch(counts: dict, key: str) -> None:
    """Add one to a wrapper's launch count; exact under threads."""
    with _COUNT_LOCK:
        counts[key] += 1


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    # the source, every shared header and the flags name the library
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def start_nvcc(src: Path, out: Path) -> subprocess.Popen:
    """Start nvcc with NVCC_FLAGS on one source into one library."""
    return subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_nvcc(proc: subprocess.Popen, src: Path, report: Path) -> None:
    """Wait for nvcc; raise with its errors, or keep its ptxas report."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{err}")
    report.write_text(out + err)


def report_path(so: Path) -> Path:
    """Where the ptxas report of a library is kept."""
    return so.with_name(f"{so.name}.ptxas.txt")


def _start_build(name: str):
    """Start nvcc on csrc/<name>.cu; returns (process, tmp, so), or None
    when the library already exists."""
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    return start_nvcc(CSRC / f"{name}.cu", tmp), tmp, so


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, so = started
    finish_nvcc(proc, CSRC / f"{name}.cu", report_path(so))
    os.replace(tmp, so)


def build_all(names) -> None:
    """Build the named libraries that are missing, all nvcc runs at once."""
    started = {name: _start_build(name) for name in names}
    errors = []
    for name, s in started.items():         # wait for every nvcc
        try:
            _finish_build(name, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def ptxas_report(name: str) -> str:
    """What ptxas printed when csrc/<name>.cu was built."""
    return report_path(library_path(name)).read_text()


def kernel_resources(report: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads"}}
    from a ptxas -v report (bytes for the spills)."""
    out = {}
    name = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu if its library is missing, then load it;
    one thread at a time."""
    with FIRST_USE:
        return _load(name)


@lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    _finish_build(name, _start_build(name))
    return ctypes.CDLL(str(library_path(name)))
