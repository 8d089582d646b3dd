"""Build the port's CUDA source with ``nvcc`` and load it with ``ctypes``.

``csrc/fused_mppi.cu`` is compiled on first use into a shared library with a
plain C interface, under ``build/kernels/`` beside the package (a directory
git ignores).  The library's name carries a hash of its source and flags, so
an edited source is rebuilt and an unchanged one is reused.  Nothing here
runs at import time: this module is imported on machines without ``nvcc``
or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCE = _PKG / "csrc" / "fused_mppi.cu"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"fused_mppi-{digest.hexdigest()[:16]}.so"


def build():
    """Compile the library if it is missing.  Returns ``(seconds, compiler
    output)``, or None when it was already built; raises with the
    compiler's output if ``nvcc`` fails."""
    out = library_path()
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    start = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: nvcc exited {proc.returncode}\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return time.perf_counter() - start, proc.stdout


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        _lib = ctypes.CDLL(str(library_path()))
    return _lib
