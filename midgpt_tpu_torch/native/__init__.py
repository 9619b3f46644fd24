"""The native host batcher (counterpart of midgpt_tpu/native/__init__.py).

`batcher.c` is the port's copy of the JAX package's C source: one pass
per window, pthreads across windows. At first use it is built with the
system C compiler (`CC`, else `cc`; `-O3 -shared -fPIC -pthread`) into
`midgpt_tpu_torch/_build/libbatcher-<digest>.so` (listed in .gitignore,
never the package directory), the digest covering the source, the
compiler and its flags, so a stale build is never loaded. The library
is written under a per-process name and published with an atomic
rename: concurrent importers (pytest workers, a mesh's ranks) never load
a half-written file. It is loaded with ctypes.

The fallback hides nothing: `native_available()` says whether the
library loaded, `build_error()` why it did not (the compiler's output),
`library_path()` which file it is, and `PATHS` counts the windows'
gathers by path ("native", "numpy"; data/dataset.py `sample_batch`).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import typing as tp
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "batcher.c"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CC_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

# gathers by path since the process started (or the caller's reset)
PATHS: tp.Counter[str] = collections.Counter()

_lock = threading.Lock()
_lib: tp.Optional[ctypes.CDLL] = None
_path: tp.Optional[Path] = None
_error: tp.Optional[str] = None


def _compiler() -> tp.List[str]:
    return (os.environ.get("CC") or "cc").split()


def _lib_path(cc: tp.Sequence[str]) -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join([*cc, *CC_FLAGS]).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbatcher-{digest}.so"


def _load() -> tp.Optional[ctypes.CDLL]:
    """Build (once per source, compiler and flags) and load the library;
    None, with the reason kept, if that fails."""
    global _lib, _path, _error
    if _lib is not None or _error is not None:
        return _lib
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        cc = _compiler()
        try:
            if shutil.which(cc[0]) is None:
                raise RuntimeError(f"no C compiler {cc[0]!r} on PATH (set CC)")
            path = _lib_path(cc)
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
                p = subprocess.run([*cc, *CC_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, text=True,
                                   timeout=120)
                if p.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"{' '.join(cc)} exit {p.returncode}: {(p.stdout + p.stderr).strip()}")
                os.replace(tmp, path)  # atomic: no half-written library
            lib = ctypes.CDLL(str(path))
            lib.sample_windows.argtypes = [
                ctypes.c_void_p,  # data (uint16*)
                ctypes.c_int64,  # n_windows
                ctypes.c_int64,  # t
                ctypes.c_void_p,  # starts (int64*)
                ctypes.c_void_p,  # x_out (int32*)
                ctypes.c_void_p,  # y_out (int32*)
                ctypes.c_int64,  # n_threads
            ]
            lib.sample_windows.restype = None
            _lib, _path = lib, path
        except Exception as e:  # the reason stays readable: build_error()
            _error = f"{type(e).__name__}: {e}"
    return _lib


def native_available() -> bool:
    """Whether the library built and loaded (builds it on first call)."""
    return _load() is not None


def build_error() -> tp.Optional[str]:
    """Why the library is unavailable, or None (builds it on first call)."""
    _load()
    return _error


def library_path() -> tp.Optional[Path]:
    """The loaded library's file, or None."""
    _load()
    return _path


def sample_windows(
    data: np.ndarray,
    starts: np.ndarray,
    block_size: int,
    n_threads: tp.Optional[int] = None,
) -> tp.Optional[tp.Tuple[np.ndarray, np.ndarray]]:
    """(x, y) int32 windows of `data` (a uint16 stream) at `starts` via the
    C kernel, or None when the library is unavailable or the stream is not
    uint16 (the caller's numpy gather is the plain version). Out-of-bounds
    starts raise IndexError, as JAX's check (the C kernel does not check)."""
    lib = _load()
    if lib is None or data.dtype != np.uint16:
        return None
    data = data if data.flags.c_contiguous else np.ascontiguousarray(data)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n = int(starts.shape[0])
    if n and (starts.min() < 0 or int(starts.max()) + block_size >= len(data)):
        raise IndexError(
            f"window out of bounds: starts in [{starts.min()}, {starts.max()}] "
            f"+ {block_size} vs stream of {len(data)} tokens"
        )
    x = np.empty((n, block_size), np.int32)
    y = np.empty((n, block_size), np.int32)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    lib.sample_windows(
        data.ctypes.data_as(ctypes.c_void_p),
        n,
        block_size,
        starts.ctypes.data_as(ctypes.c_void_p),
        x.ctypes.data_as(ctypes.c_void_p),
        y.ctypes.data_as(ctypes.c_void_p),
        int(n_threads),
    )
    return x, y
