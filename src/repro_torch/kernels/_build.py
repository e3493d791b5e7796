"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on first use into
``<repo>/build/repro_torch/lib<name>-<hash>.so``, where the hash covers the
source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source or header rebuilds.  Nothing here runs at import time; a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "load", "build_all",
           "ptxas_log", "ptxas_usage"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    """The library path, hashed over the source, the shared headers and
    the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _start(name: str):
    """Start one nvcc build; returns (process, tmp path, final path) or
    None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    (out.with_suffix(".log")).write_text(log)
    return log


def build_all(names) -> float:
    """Build every named kernel library, one ``nvcc`` per source, all
    started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def ptxas_log(name: str) -> str:
    """What ``-Xptxas -v`` reported for the last build of ``name``
    (registers, shared memory, spills), or '' if not built here."""
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def ptxas_usage(name: str, entry: str):
    """Registers a thread and static shared memory a block of the kernel
    entries of ``name``'s last build whose (mangled) name contains
    ``entry``, the most over those entries: ``{"registers",
    "static_smem_bytes"}``, or None where the build log is absent or names
    no such entry."""
    lines = ptxas_log(name).splitlines()
    regs = smem = None
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line or entry not in line:
            continue
        for used in lines[i + 1:i + 8]:
            if "Compiling entry function" in used:
                break
            m = re.search(r"Used (\d+) registers", used)
            if m:
                sm = re.search(r"(\d+) bytes smem", used)
                regs = max(regs or 0, int(m.group(1)))
                smem = max(smem or 0, int(sm.group(1)) if sm else 0)
                break
    if regs is None:
        return None
    return {"registers": regs, "static_smem_bytes": smem}
