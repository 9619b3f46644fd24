"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface. At first use it is
compiled by nvcc for Hopper (`sm_90a`) into a shared library under
`midgpt_tpu_torch/_build/` (listed in .gitignore) and loaded with ctypes:
pointers and the stream travel as `c_void_p`, and every launch function
returns the `cudaError_t` of its launch, which the Python wrapper raises
on. The library's file name carries a hash of its source and flags, so a
stale build is never loaded. Nothing is compiled at import time: this
module only locates nvcc when a build is asked for.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import typing as tp
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills on stderr
)

_lock = threading.Lock()
_loaded: tp.Dict[str, ctypes.CDLL] = {}
# nvcc's output (the ptxas report) of each build, kept beside its library
build_logs: tp.Dict[str, str] = {}


class LaunchCounter:
    """Launches of one kernel, keyed by a launch variant (the split factor
    for the paged-attention kernel). The wrapper adds one exactly where it
    launches; a run that must show the kernel carried its path zeroes the
    counter, drives the path, and reads it.

    A wrapper called while a CUDA graph is captured launches nothing: its
    launch is recorded in the capturing graph's CaptureTally (if the
    capture opened one) and counted each time the graph is replayed."""

    def __init__(self, name: str):
        self.name = name
        self.by_variant: tp.Counter[tp.Any] = collections.Counter()

    @property
    def count(self) -> int:
        return sum(self.by_variant.values())

    def add(self, variant: tp.Any = None) -> None:
        # Only the CUDA wrappers call add, so the capture query is valid here.
        if torch.cuda.is_current_stream_capturing():
            tally = getattr(_capture, "tally", None)
            if tally is not None:
                tally.counts[(self, variant)] += 1
            return
        self.by_variant[variant] += 1

    def reset(self) -> None:
        self.by_variant.clear()


_capture = threading.local()  # .tally: the CaptureTally of the graph being captured


class CaptureTally:
    """The kernel launches a CUDA graph holds, recorded while it is captured
    (`with tally:` around the capture) and added to their LaunchCounters by
    `replayed()`, once per replay of the graph."""

    def __init__(self):
        self.counts: tp.Counter[tp.Tuple[LaunchCounter, tp.Any]] = collections.Counter()

    def __enter__(self) -> "CaptureTally":
        self._outer = getattr(_capture, "tally", None)
        _capture.tally = self
        return self

    def __exit__(self, *exc) -> None:
        _capture.tally = self._outer

    def replayed(self) -> None:
        for (counter, variant), n in self.counts.items():
            counter.by_variant[variant] += n


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.environ.get("NVCC")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the port's CUDA kernels are "
        "compiled from midgpt_tpu_torch/csrc at first use"
    )


def _lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: tp.Sequence[str]) -> tp.Dict[str, Path]:
    """Compile every named source that has no current build, all nvcc
    processes started together; returns {name: library path}. Raises with
    nvcc's output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    for n in names:  # a build made earlier left its ptxas report beside it
        if n not in todo and paths[n].with_suffix(".log").exists():
            build_logs[n] = paths[n].with_suffix(".log").read_text()
    if todo:
        nvcc = _nvcc()
        procs = {}
        for n in todo:
            tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_logs[n] = out
            if proc.returncode != 0:
                failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n{out}")
            else:
                paths[n].with_suffix(".log").write_text(out)
                os.replace(tmp, paths[n])  # atomic: no half-written library
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def ptxas_report(log: str) -> tp.List[tp.Dict[str, tp.Any]]:
    """Each kernel instantiation in an nvcc build's ptxas report (`-Xptxas
    -v`, `build_logs`), in order: {"kernel" (the mangled name), "C" and
    "causal" where the name carries them (the flash templates' head dim
    and causal flag, else None), "registers", "spill_stores",
    "spill_loads"}."""
    rows: tp.List[tp.Dict[str, tp.Any]] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            c, causal = re.search(r"Li(64|128)E", name), re.search(r"Lb([01])E", name)
            rows.append({"kernel": name, "C": int(c.group(1)) if c else None,
                         "causal": causal.group(1) == "1" if causal else None})
        elif rows:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                rows[-1]["spill_stores"], rows[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows[-1]["registers"] = int(m.group(1))
    return rows


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _loaded[name] = lib
        return lib
