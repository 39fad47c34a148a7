"""Build and load the package's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface.  It is
compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the repository
root on first use and loaded with ``ctypes``.  A library's file name holds
a hash of the source and the flags, so an edited source builds anew and an
unchanged one is never rebuilt.  Nothing here runs when a module is
imported: the CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (
        os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None,
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    """Where ``source``'s library lives: named by the source and a hash of
    its content and the compiler flags."""
    tag = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{tag}.so"


def build(source: Path) -> tuple[Path, str]:
    """Compile ``source`` into ``build/`` unless this exact source is
    already built there.  Returns the library path and the compiler's
    output (``-Xptxas -v``: registers, shared memory, spills), which is
    empty when nothing was compiled.  Raises on a failed build."""
    lib = library_path(source)
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib, log


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if need be;
    ``bind`` sets the C functions' argument and return types once."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path, _ = build(source)
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _libs[source] = lib
        return lib
