"""Build the port's CUDA source with ``nvcc`` and load it with ``ctypes``.

``csrc/fused_mppi.cu`` is compiled on first use into a shared library with a
plain C interface, under ``build/kernels/`` beside the package (a directory
git ignores).  The source builds as ``PARTS`` translation units (its
``FUSED_MPPI_PART`` macro selects one), one ``nvcc`` each, all started
together, then linked.  The library's name carries a hash of its source and
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCE = _PKG / "csrc" / "fused_mppi.cu"
PARTS = 19  # FUSED_MPPI_PART = 0 .. PARTS - 1 in fused_mppi.cu
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            + str(PARTS).encode())
    return BUILD_DIR / f"fused_mppi-{digest.hexdigest()[:16]}.so"


def _run(procs, seconds=None):
    """Wait for every process; raise with the first failure's output.  With
    a list ``seconds``, append each process's seconds from now to its end
    (the processes run together; each is drained in a thread of its own)."""
    start = time.perf_counter()

    def wait(p):
        out = p.communicate()[0]
        return out, time.perf_counter() - start

    with ThreadPoolExecutor(max_workers=len(procs)) as pool:
        done = list(pool.map(wait, procs))
    for p, (out, _) in zip(procs, done):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed: {p.args[0]} exited "
                               f"{p.returncode}\n{out}")
    if seconds is not None:
        seconds += [s for _, s in done]
    return [out for out, _ in done]


def build():
    """Compile the library if it is missing.  Returns ``(seconds, compiler
    output, each part's seconds)``, or None when it was already built;
    raises with the compiler's output if ``nvcc`` fails."""
    out = library_path()
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    parts = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"part{k}.o" for k in range(PARTS)]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, f"-DFUSED_MPPI_PART={k}", "-c",
                                   "-o", str(obj), str(SOURCE)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for k, obj in enumerate(objs)]
        logs = _run(procs, parts)
        tmp = Path(tmpdir) / out.name
        logs += _run([subprocess.Popen([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)])
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return time.perf_counter() - start, "".join(logs), parts


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        _lib = ctypes.CDLL(str(library_path()))
    return _lib


def generated_path(header: str, mask: int) -> Path:
    """The library of a generated model (``ops/batch_last.py``): named by a
    hash of its header, the variants' mask, ``fused_mppi.cu`` and the flags.
    The header holds no weights, so models that differ only in them share
    it."""
    digest = hashlib.sha256(header.encode() + str(mask).encode() + SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"generated-{digest.hexdigest()[:16]}.so"


def generated_command(nvcc: str, model: Path, mask: int, out: Path, extra=()) -> list:
    """The ``nvcc`` command that builds the library ``out`` of the header
    file ``model`` and the variants of ``mask`` (``extra``: more flags, such
    as ``--time``, which leave the library's name as it is)."""
    return [nvcc, *NVCC_FLAGS, *extra, f"-DFUSED_MPPI_GENERATED={int(mask)}",
            f'-DFUSED_MPPI_MODEL_HEADER="{model}"', "-shared", "-o", str(out), str(SOURCE)]


def build_generated(header: str, mask: int):
    """Compile ``fused_mppi.cu`` with a generated model's ``header`` (the
    struct ``Generated``) and the kernels of the variants of ``mask`` (bits
    ``1 << Variant``) into its own library, if it is missing: one ``nvcc``
    call.  Returns ``(seconds, compiler output)``, or None when it was
    already built; raises with the compiler's output if ``nvcc`` fails."""
    out = generated_path(header, mask)
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        model = Path(tmpdir) / "generated_model.cuh"
        model.write_text(header)
        tmp = Path(tmpdir) / out.name
        log = _run([subprocess.Popen(generated_command(nvcc, model, mask, tmp),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)])
        install_generated(header, mask, tmp, "".join(log))
    return time.perf_counter() - start, "".join(log)


def install_generated(header: str, mask: int, built: Path, log: str) -> Path:
    """Move the library ``built`` of ``header`` and ``mask`` where
    :func:`load_generated` finds it, its header and compiler output beside
    it; returns its path."""
    out = generated_path(header, mask)
    out.with_suffix(".cuh").write_text(header)
    out.with_suffix(".log").write_text(log)
    os.replace(built, out)  # atomic: a concurrent loader never sees half a file
    return out


def load_generated(header: str, mask: int):
    """``(library, build seconds or None)`` of a generated model, built
    first if needed."""
    built = build_generated(header, mask)
    return ctypes.CDLL(str(generated_path(header, mask))), None if built is None else built[0]
