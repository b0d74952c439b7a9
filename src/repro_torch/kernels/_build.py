"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``,
and keep the wrappers' launch counts.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/repro_torch_kernels/lib<name>-<hash>.so`` at the root of the
checkout, for ``sm_90a`` (Hopper). The file name carries a hash of the
source and of the ``csrc/`` headers it includes, so an edited source or
header is rebuilt and a stale library is never loaded.
Only the sources in the checkout are built; nothing is fetched.

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^#include "([^"]+)"', re.M)
_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of the CUDA sources in ``csrc/`` (without ``.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def inputs(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes
    (``#include "..."``, followed through the headers)."""
    files, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        todo += [CSRC / h for h in _INCLUDE.findall(path.read_text())]
    return files


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in inputs(name):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source into a temporary file; returns
    ``(process, tmp, out)``, or None if the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Compile every source that is not built yet, all ``nvcc`` processes
    started together. Returns ``{name: nvcc and ptxas output}`` for the
    sources compiled by this call."""
    with _LOCK:
        started = {name: _start(name) for name in sources()}
        return {name: _finish(name, s) for name, s in started.items()
                if s is not None}


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiled on first use."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib


# ---------------------------------------------------------------------------
# launch bookkeeping shared by the wrappers
# ---------------------------------------------------------------------------

_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` (a plain integer); called right after
    a kernel launch succeeded, nowhere else."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check_rc(rc: int, name: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def reset_counts(wrappers) -> None:
    with _COUNT_LOCK:
        for w in wrappers:
            w.launches = 0


def add_counts(wrappers, launched: dict) -> None:
    """Add launches counted in other processes (the PS runtime's process
    workers) to the wrappers' counts."""
    with _COUNT_LOCK:
        for w in wrappers:
            w.launches += launched.get(w.__name__, 0)


def counts(wrappers) -> dict:
    return {w.__name__: w.launches for w in wrappers}


def stream_of(t) -> int:
    """The current CUDA stream on ``t``'s device, as the C launchers take
    it."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
