"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file exposes a plain ``extern "C"`` interface and is
compiled on its own into a shared library for Hopper (``sm_90a``)::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so <source>

The library's name carries a hash of the source and the flags, so an edited
kernel is rebuilt at its first use and an unchanged one is loaded from
``BUILD_DIR``.  Each build bumps the ``kernel_build:<name>`` counter of
:mod:`repro_torch.telemetry.compilation`.  ptxas's report (registers, shared memory, spills) is kept
beside each library as ``<name>-<hash>.log``.  Nothing is built when a
module is imported: the first launch builds, or a caller builds several
sources at once, one ``nvcc`` process each, with :func:`compile_libraries`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence

from repro_torch.telemetry.compilation import note_compile

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "compile_libraries", "library_path",
           "load_library", "nvcc_path"]

#: Where built libraries go (listed in .gitignore).
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` on the PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(f"nvcc not found on PATH or at {candidate}; the "
                       f"port's CUDA kernels need the CUDA toolkit")


def library_path(source: Path) -> Path:
    """The built library of ``source``, named by a hash of its text and
    the flags."""
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def compile_libraries(sources: Sequence[Path]) -> List[Path]:
    """Build every source whose library is missing, one ``nvcc`` process
    per source, all started together; raise if any build fails."""
    outs = [library_path(s) for s in sources]
    jobs = []
    for src, out in zip(sources, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)        # atomic: a reader never sees half a file
        note_compile(f"kernel_build:{Path(src).stem}")
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return outs


def load_library(source: str) -> ctypes.CDLL:
    """Build ``source`` if needed and load its library."""
    return ctypes.CDLL(str(compile_libraries([Path(source)])[0]))
