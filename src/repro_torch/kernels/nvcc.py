"""Build a kernel source with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, for ``ctypes`` to load.

No PyTorch headers are involved, so a build takes seconds.  The library
goes under ``build/`` beside this file, named after the source and keyed
by a hash of the source and the flags, so a later call with the same
source reuses it.  Nothing is built when a kernel module is imported:
each module builds at its first launch.  :func:`launch` is the launch
every kernel wrapper of the package goes through, after :func:`prepare`
where a kernel has set-up to do; :func:`check` holds a tensor to an
exact dtype and shape; :func:`counted` registers a wrapper's launch
count, so that code which captures launches into a CUDA graph can
account for them in one place, and :func:`count` adds a launch to it.
Both :func:`count` and :func:`prepare` hold a lock: the sweep driver
runs host-engine simulations on a thread pool, each of which launches.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
import threading
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
    """Compile ``source`` unless a library of the same source, the same
    headers beside it (``*.cuh``) and the same flags exists.  Safe under
    concurrent callers: each compiles to its own temporary file and
    renames it into place."""
    source = Path(source)
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    tag = hashlib.sha256(source.read_bytes() + headers
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


def check(device, **specs) -> None:
    """Raise unless every ``name=(tensor, dtype, shape)`` lies on
    ``device``, has that dtype and shape, and is contiguous."""
    for name, (t, dtype, shape) in specs.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}; all inputs must be on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# the kernel wrappers that a captured CUDA graph may hold (the device
# engine's), each counting its launches in ``fn.launches``
COUNTED: list = []


def counted(fn):
    """Give the kernel wrapper ``fn`` a launch count, ``fn.launches``, which
    it adds one to where it launches its kernel, and register it in
    :data:`COUNTED`: a capture, which runs nothing, takes back what it
    added, and each replay adds the launches it holds."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


_LOCK = threading.Lock()


def count(fn) -> None:
    """Add one launch to the wrapper ``fn``'s count, under a lock."""
    with _LOCK:
        fn.launches += 1


_PREPARED: set[tuple[str, int]] = set()
_PREPARE_LOCK = threading.Lock()


def prepare(fn, name: str, device) -> None:
    """Call the C function ``fn()``, a kernel's one-time set-up on a device
    (its opt-in shared memory), once per device before the first launch,
    and raise if it returned an error."""
    import torch
    index = device.index if device.index is not None else torch.cuda.current_device()
    if (name, index) in _PREPARED:
        return
    with _PREPARE_LOCK:
        if (name, index) in _PREPARED:
            return
        with torch.cuda.device(index):
            rc = fn()
        if rc != 0:
            raise RuntimeError(f"{name} set-up failed: CUDA error {rc}")
        _PREPARED.add((name, index))


def launch(fn, name: str, device, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` on ``device``'s current
    stream and raise if it returned an error.  Tensors are passed by their
    data pointers.  An entry point returns 0, a CUDA runtime error code,
    or 1000 plus a ``CUresult`` from encoding a TMA tensor map."""
    import torch
    index = device.index if device.index is not None else torch.cuda.current_device()
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        # the raw handle, without building a torch.cuda.Stream (several
        # microseconds per call)
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + (f"CUresult {rc - 1000}" if rc >= 1000 else f"CUDA error {rc}"))
