"""Build the port's hand-written CUDA sources at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library for Hopper (``sm_90a``), loaded with
``ctypes``. Libraries land in ``src/repro_torch/_build/`` (git-ignored)
under a name keyed by a hash of the source, every ``csrc/`` header it
includes and the flags, so an edited source or header rebuilds and an
unchanged one is reused. :func:`build` starts one
``nvcc`` per source, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module of the
port on a machine that has no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> (seconds, nvcc's stderr: ptxas register / shared-memory report)
build_log: Dict[str, tuple] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                           "CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and every header it includes with quotes, at any
    depth (paths relative to ``csrc/``), in the order first reached."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path not in found:
            found.append(path)
            todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in _sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source whose library is missing, one ``nvcc``
    each, all started together. Returns the wall seconds per source
    (0.0 when it was already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    secs = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_log[name] = (secs[name], log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)      # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
