"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source, of every header of ``csrc/``
it includes (``#include "<header>"``, followed recursively) and of the
flags, so an edited source or header rebuilds and an unchanged one loads
from ``build/repro_torch/`` (a directory that ``.gitignore`` lists).  No
PyTorch headers and no ninja: a library builds in seconds.  Nothing builds at import; a kernel wrapper
calls :func:`load` at its first launch, and :func:`build` compiles several
sources at once, one nvcc process each, all started together.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_paths: dict[str, Path] = {}  # libraries that replace a build of csrc/<name>.cu


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed"
        )
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and the headers of ``csrc/`` it includes, directly
    or through another header, each once, in the order first met."""
    found: list[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            todo.append(CSRC / inc.decode())
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names, ptxas_verbose: bool = False) -> dict[str, dict]:
    """Compile each library of ``names`` that is not built yet, one nvcc
    per source, all started together.  Returns ``{name: {"seconds": s,
    "log": compiler output}}``; a library already built reports 0 seconds.
    Raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS,
               *(("-Xptxas", "-v") if ptxas_verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, proc, tmp, out, time.perf_counter()))
    failed = []
    for name, proc, tmp, out, t0 in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def use_library(name: str, path: Path) -> None:
    """From now on :func:`load` opens ``path`` for ``lib<name>`` instead of
    building ``csrc/<name>.cu``: a variant of the source, built elsewhere,
    runs through the kernel's own wrapper (``tools/kernel_variants.py``)."""
    with _lock:
        _paths[name] = Path(path)
        _libs.pop(name, None)


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``lib<name>``, built first if needed.  Every C
    function in ``signatures`` gets its ``argtypes`` and returns an ``int``
    (the CUDA error code of its launch, 0 on success)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _paths.get(name)
            if path is None:
                build([name])
                path = library_path(name)
            lib = ctypes.CDLL(str(path))
            for sym, argtypes in signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise when a launch returned a nonzero ``cudaGetLastError()``."""
    if code:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code} ({msg})")
