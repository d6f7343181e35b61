"""Build a kernel source with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, for ``ctypes`` to load.

No PyTorch headers are involved, so a build takes seconds.  The library
goes under ``build/`` beside this file, named after the source and keyed
by a hash of the source and the flags, so a later call with the same
source reuses it.  Nothing is built when a kernel module is imported:
each module builds at its first launch.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
import time
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path      # the shared library
    seconds: float  # nvcc wall time; 0.0 when an earlier build was reused
    log: str        # nvcc's output, with -Xptxas -v's registers and spills


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc "
                           "on PATH) to build the port's kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build(source: Path) -> Build:
    """Compile ``source`` unless a library of the same source and flags
    exists.  Safe under concurrent callers: each compiles to its own
    temporary file and renames it into place."""
    source = Path(source)
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}_{tag}.so"
    log = BUILD_DIR / f"lib{source.stem}_{tag}.log"
    if lib.exists() and log.exists():
        return Build(lib, 0.0, log.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.{time.monotonic_ns()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source.name} with code "
                           f"{proc.returncode}:\n{out}")
    log_tmp = tmp.with_suffix(".log")
    log_tmp.write_text(out)
    os.replace(log_tmp, log)
    os.replace(tmp, lib)
    return Build(lib, seconds, out)


def sass(lib: Path) -> str:
    """The library's machine code as ``cuobjdump -sass`` prints it, for
    counting the instructions a kernel was compiled to."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
