"""Native (C) code for control-plane hot loops: the strategy scan.

``strategy_scan.c`` is compiled with the system C compiler into ``build/``
at the repository root on first use (never when a module is imported) and
loaded with ``ctypes``.  The library's file name holds a hash of the
source and the flags, so an edited source builds anew and an unchanged one
is never rebuilt.

Where no C compiler is installed the loader returns None and the scheduler
picks with its Python scan.  Where one is, a failed build or load raises:
it is a fault, not a host without native code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from ..infra import logging as logx

SOURCE = Path(__file__).resolve().parent / "strategy_scan.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CC_FLAGS = ("-O2", "-shared", "-fPIC")
COMPILERS = ("cc", "gcc", "clang")

_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """A C compiler exists but the scan did not build or load."""


def compiler() -> Optional[str]:
    """The first C compiler on ``PATH``, or None."""
    for cc in COMPILERS:
        path = shutil.which(cc)
        if path:
            return path
    return None


def library_path(source: Optional[Path] = None) -> Path:
    """Where ``source``'s library (default :data:`SOURCE`'s) lives: named
    by a hash of its content and the compiler flags."""
    source = source or SOURCE
    tag = hashlib.sha256(source.read_bytes() + " ".join(CC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{tag}.so"


def build(cc: str, source: Path) -> Path:
    """Compile ``source`` into ``build/`` unless this exact source is
    already built there; raises :class:`NativeBuildError` on a failed
    build."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([cc, *CC_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True, timeout=120)
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"{cc} timed out on {source.name}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"{cc} failed on {source.name} ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.pick_worker.restype = ctypes.c_int32
    lib.pick_worker.argtypes = [
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint64),   # cap_bits
        ctypes.POINTER(ctypes.c_int32),    # pool_id
        ctypes.POINTER(ctypes.c_int32),    # topology_id
        ctypes.POINTER(ctypes.c_int32),    # chip_count
        ctypes.POINTER(ctypes.c_float),    # active_jobs
        ctypes.POINTER(ctypes.c_float),    # max_parallel
        ctypes.POINTER(ctypes.c_float),    # cpu_load
        ctypes.POINTER(ctypes.c_float),    # duty_cycle
        ctypes.POINTER(ctypes.c_uint8),    # healthy
        ctypes.c_uint64,                   # req_caps
        ctypes.POINTER(ctypes.c_int32),    # allowed_pools
        ctypes.c_int32,                    # n_pools
        ctypes.c_int32,                    # min_chips
        ctypes.c_int32,                    # req_topology_id
    ]


def load_strategy_scan(source: Optional[Path] = None) -> Optional[ctypes.CDLL]:
    """The compiled scan library of ``source`` (default :data:`SOURCE`);
    None only where no C compiler exists (callers then pick with the
    Python scan).  Raises :class:`NativeBuildError` when a compiler exists
    and the build or the load fails."""
    source = source or SOURCE
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        cc = compiler()
        if cc is None:
            logx.warn("native strategy scan unavailable (no C compiler)")
            return None
        path = build(cc, source)
        try:
            lib = ctypes.CDLL(str(path))
            _bind(lib)
        except (OSError, AttributeError) as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        _libs[source] = lib
        logx.info("native strategy scan loaded", lib=str(path))
        return lib
